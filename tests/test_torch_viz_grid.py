"""The port's board renderer (``placement_tpu_torch.viz.grid``) against the
JAX package's ``placement_tpu.viz.grid``.

``_rotated_pin`` and ``_footprint`` equal JAX's for every orientation over
a grid of component shapes and pin positions; both renderers draw the same
pixels for the same records; ports of ``tests/tooling/test_trainer.py``'s
``test_render_smoke`` (on a port rollout) and ``test_random_policy_plot``
(on the port's ``simulate``); one frame a placement.
"""

import dataclasses
import itertools
import os

import matplotlib
import numpy as np
import pytest
import torch

from placement_tpu.viz import grid as jax_grid
from placement_tpu.viz.rollout import ComponentRecord as JaxComponent
from placement_tpu.viz.rollout import PinRecord as JaxPin
from placement_tpu_torch.agent.policy import Policy, model_config_for
from placement_tpu_torch.agent.random_policy import simulate
from placement_tpu_torch.env.types import EnvParams, Variant
from placement_tpu_torch.utils.config import load_env_params
from placement_tpu_torch.viz import grid
from placement_tpu_torch.viz.rollout import sample_rollout

matplotlib.use("Agg")

SHAPES = list(itertools.product(range(1, 6), range(1, 6)))


@pytest.mark.parametrize("orientation", range(4))
def test_rotated_pin_and_footprint_equal_jax(orientation):
    for h, w in SHAPES:
        assert grid._footprint(h, w, orientation) == \
            jax_grid._footprint(h, w, orientation)
        for x, y in itertools.product(range(h), range(w)):
            got = grid._rotated_pin(x, y, h, w, orientation)
            assert got == jax_grid._rotated_pin(x, y, h, w, orientation)
            # a rotated pin stays inside the rotated footprint
            fh, fw = grid._footprint(h, w, orientation)
            assert 0 <= got[0] < fh and 0 <= got[1] < fw


def _rollout(samples=1, seed=1):
    """Greedy episodes of the flagship on the CPU, weights from a seed."""
    params = load_env_params("rectangle_pin")
    policy = Policy(params, model_config_for(params, "rectangle_pin"), "cpu")
    comps, actions, _ = sample_rollout(params, policy, num_samples=samples,
                                       seed=seed, device="cpu")
    return params, comps, actions


def _pixels(fig):
    import matplotlib.pyplot as plt
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def test_render_smoke():
    params, comps, actions = _rollout()
    fig = grid.render(params.height, params.width, comps[0], actions[0])
    assert fig is not None
    import matplotlib.pyplot as plt
    plt.close(fig)


def test_render_draws_what_jax_draws():
    """The same records through both renderers: the same image."""
    params, comps, actions = _rollout(seed=3)
    jax_comps = [JaxComponent(**{**dataclasses.asdict(c), "pins": [
        JaxPin(**dataclasses.asdict(p)) for p in c.pins]}) for c in comps[0]]
    got = _pixels(grid.render(params.height, params.width, comps[0],
                              actions[0], title="t"))
    want = _pixels(jax_grid.render(params.height, params.width, jax_comps,
                                   actions[0], title="t"))
    np.testing.assert_array_equal(got, want)


def test_render_episode_frames_one_frame_a_placement():
    params, comps, actions = _rollout()
    frames = grid.render_episode_frames(params.height, params.width,
                                        comps[0], actions[0])
    assert len(frames) == len(actions[0]) == params.max_components
    import matplotlib.pyplot as plt
    titles = [f.axes[0].get_title() for f in frames]
    for f in frames:
        plt.close(f)
    assert titles == [f"step {t}/{len(actions[0])}"
                      for t in range(1, len(actions[0]) + 1)]


def test_random_policy_plot(tmp_path):
    params = EnvParams(variant=Variant.SQUARE, height=5, width=5,
                       component_n=2).validate()
    returns = simulate(params, torch.Generator().manual_seed(0), 16,
                       device="cpu")
    out = grid.plot_episode_returns(returns.tolist(),
                                    str(tmp_path / "returns.png"))
    assert out == str(tmp_path / "returns.png") and os.path.exists(out)
