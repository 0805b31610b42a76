"""Shared dataviz styling of the port's learning-curve plots (the port's
own copy of the JAX package's ``experiments/plot_style.py``).

One source of truth for the palette and the axis treatment used by
``learning_curve.py``, ``seed_sweep.py`` and ``reference_comparison.py``
(light mode; series colors are validated categorical hues, text/grid are
neutral inks).
"""

import importlib.util

# categorical series colors (first entry = single-series default)
C_SERIES = ["#2a78d6", "#cc4778", "#2a9d8f", "#e07b39"]
C_BASELINE = "#52514e"
C_TEXT = "#0b0b0b"
C_MUTED = "#52514e"
C_SURFACE = "#fcfcfb"
C_GRID = "#e7e6e2"


def style_axis(ax, title: str) -> None:
    """House axis treatment: left-aligned title, y-grid only, no spines."""
    ax.set_facecolor(C_SURFACE)
    ax.set_title(title, loc="left", fontsize=10.5, color=C_TEXT)
    ax.grid(True, axis="y", color=C_GRID, linewidth=0.8)
    for side in ("top", "right", "left"):
        ax.spines[side].set_visible(False)
    ax.spines["bottom"].set_color(C_GRID)
    ax.tick_params(colors=C_MUTED, labelsize=8.5, length=0)


def can_plot() -> bool:
    """Whether matplotlib is importable. Without it the runners write their
    tables and JSON and say that they draw no plot."""
    if importlib.util.find_spec("matplotlib") is not None:
        return True
    print("matplotlib is not installed: tables and JSON only, no plots",
          flush=True)
    return False
