"""Matplotlib board renderer (port of ``placement_tpu/viz/grid.py``).

Re-implements the reference's ``render(height, width, components, actions)``
(``web_app/visualization_grid.py:72-203``): a grid with numbered component
rectangles (orientation-aware height/width swap, ``:124-129``) and pins drawn
as dots colored by net id with a net legend. Consumes the host-side
:class:`~placement_tpu_torch.viz.rollout.ComponentRecord` records that
``sample_rollout`` exports. NumPy and matplotlib only; matplotlib is
imported where a figure is drawn, so importing this module needs neither a
display nor matplotlib.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from placement_tpu_torch.viz.rollout import ComponentRecord


def _rotated_pin(rel_x: int, rel_y: int, h: int, w: int,
                 orientation: int) -> Tuple[int, int]:
    """0/90/180/270-degree relative-coordinate update
    (Component.place_component, dummy_env_rectangular_pin.py:156-204)."""
    if orientation == 0:
        return rel_x, rel_y
    if orientation == 1:
        return rel_y, h - rel_x - 1
    if orientation == 2:
        return h - rel_x - 1, w - rel_y - 1
    return w - rel_y - 1, rel_x


def _footprint(h: int, w: int, orientation: int) -> Tuple[int, int]:
    """Orientation-aware height/width (visualization_grid.py:124-129)."""
    return (h, w) if orientation % 2 == 0 else (w, h)


def render(height: int, width: int,
           components: Sequence[ComponentRecord],
           actions: Sequence[Tuple[int, int, int]],
           ax=None, show_pins: bool = True,
           title: Optional[str] = None) -> "matplotlib.figure.Figure":
    """Draw the board after replaying ``actions`` (one per component, in
    order). Returns the matplotlib figure."""
    import matplotlib
    import matplotlib.pyplot as plt
    from matplotlib import patches

    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 6))
    else:
        fig = ax.figure

    ax.set_xlim(0, width)
    ax.set_ylim(height, 0)  # row 0 on top like the grid arrays
    ax.set_xticks(np.arange(width + 1))
    ax.set_yticks(np.arange(height + 1))
    ax.grid(True, linewidth=0.5, color="0.85")
    ax.set_aspect("equal")
    ax.tick_params(length=0, labelsize=7)

    net_ids = sorted({p.net_id for c in components for p in c.pins})
    cmap = matplotlib.colormaps.get_cmap("viridis")
    net_color = {n: cmap(i / max(len(net_ids) - 1, 1))
                 for i, n in enumerate(net_ids)}

    for comp, action in zip(components, actions):
        o, x, y = action
        fh, fw = _footprint(comp.h, comp.w, o)
        ax.add_patch(patches.Rectangle(
            (y, x), fw, fh, linewidth=1.2, edgecolor="black",
            facecolor="tab:blue", alpha=0.35))
        ax.text(y + fw / 2, x + fh / 2, str(comp.comp_id),
                ha="center", va="center", fontsize=10, weight="bold")
        if show_pins:
            for pin in comp.pins:
                rx, ry = _rotated_pin(pin.relative_x, pin.relative_y,
                                      comp.h, comp.w, o)
                ax.plot(y + ry + 0.5, x + rx + 0.5, "o", markersize=7,
                        color=net_color.get(pin.net_id, "red"),
                        markeredgecolor="black", markeredgewidth=0.5)

    if net_ids and show_pins:
        handles = [plt.Line2D([], [], marker="o", linestyle="",
                              color=net_color[n], markeredgecolor="black",
                              label=f"net {n}") for n in net_ids]
        ax.legend(handles=handles, loc="upper left",
                  bbox_to_anchor=(1.02, 1.0), fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    return fig


def render_episode_frames(height: int, width: int,
                          components: Sequence[ComponentRecord],
                          actions: Sequence[Tuple[int, int, int]]) -> List:
    """One figure per placement step: the web app's 2 s/frame rollout
    animation (pages/2_…Train new agent.py)."""
    return [render(height, width, components[: t + 1], actions[: t + 1],
                   title=f"step {t + 1}/{len(actions)}")
            for t in range(len(actions))]


def plot_episode_returns(returns: Sequence[float], out_path: str,
                         title: str = "Random policy episode returns"
                         ) -> str:
    """Episode-return plot like experiments/results/*.png
    (run_policy_square.py:53-58); returns ``out_path``."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(np.arange(1, len(returns) + 1), returns, linewidth=0.8)
    ax.set_xlabel("episode")
    ax.set_ylabel("return")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
