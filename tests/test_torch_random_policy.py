"""The port's random-policy baseline (``placement_tpu_torch.agent.
random_policy.simulate``) against the JAX package's, and the fixture that
holds the card to JAX's numbers.

The two random streams differ, so the baselines are compared by their mean
episode return: within 4 combined standard errors, on the square env and the
flagship (>= 1000 episodes each), each side at the same batch and episode
count, so both compute the same estimator (the first ``num_episodes``
episodes to end, in time order).

``tests/fixtures/torch_stepper_means.json`` holds JAX ``simulate``'s mean,
standard error and episode count for every config of ``chip_smoke.py``'s
``[stepper]`` phases (``STEPPER_CONFIGS``); ``PYTHONPATH=. python
tests/test_torch_core.py`` records it. Fixed-length episodes (five
placements on every pin config) give the same estimator at any batch;
square and rectangle are recorded at batch = episodes, the estimator the
card computes at its own batch.
"""

import json
import math
import pathlib

import jax
import numpy as np
import pytest
import torch

from placement_tpu.agent import random_policy as jax_policy
from placement_tpu.env import wrappers as jax_wrappers
from placement_tpu.utils.config import load_experiment
from placement_tpu_torch.agent import random_policy
from placement_tpu_torch.env import core, wrappers
from placement_tpu_torch.ops import fused_rollout
from placement_tpu_torch.utils.config import load_env_params

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_stepper_means.json")
#: name -> (model type, overrides, JAX batch, episodes); chip_smoke.py's
#: [stepper] configs: the flagship, the other env families, the web app's
#: Train-page default (2..6 pins per net) and the other two rewards
STEPPER_CONFIGS = {
    "flagship": ("rectangle_pin", {}, 256, 1024),
    "square": ("square", {}, 1024, 1024),
    "rectangle": ("rectangle", {}, 1024, 1024),
    "rectangle_spatial_pin": ("rectangle_spatial_pin", {}, 256, 1024),
    "varpin_web": ("rectangle_pin", {"min_num_pins_per_net": 2}, 256, 1024),
    "beam": ("rectangle_pin", {"reward_type": "beam"}, 256, 1024),
    "both": ("rectangle_pin", {"reward_type": "both"}, 256, 1024),
}
JAX_SEED = 0
N_SE = 4.0


def _stats(returns):
    r = np.asarray(returns, np.float64)
    return {"mean": float(r.mean()),
            "se": float(r.std(ddof=1) / math.sqrt(len(r))),
            "episodes": int(len(r))}


def jax_simulate(name):
    model_type, overrides, batch, episodes = STEPPER_CONFIGS[name]
    params = load_experiment(model_type)[0].replace(**overrides)
    return _stats(jax_policy.simulate(params, jax.random.PRNGKey(JAX_SEED),
                                      episodes, batch=batch))


def record_stepper_means():
    """Run JAX ``simulate`` on every config and write the fixture."""
    out = {}
    for name, (model_type, overrides, batch, _) in STEPPER_CONFIGS.items():
        out[name] = {"config": model_type, "overrides": overrides,
                     "batch": batch, "seed": JAX_SEED, **jax_simulate(name)}
    FIXTURE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    return out


@pytest.mark.parametrize("name", ["square", "flagship"])
def test_simulate_mean_matches_jax(name):
    """The port's mean return within 4 combined standard errors of JAX's
    ``simulate`` (its recorded run; ``test_stepper_fixture_is_fresh``
    re-runs JAX on square)."""
    model_type, overrides, batch, episodes = STEPPER_CONFIGS[name]
    want = json.loads(FIXTURE.read_text())[name]
    params = load_env_params(model_type).replace(**overrides)
    got = random_policy.simulate(params, torch.Generator().manual_seed(1),
                                 episodes, batch=batch, device="cpu")
    assert got.shape == (episodes,) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    got = _stats(got.numpy())
    se = math.hypot(want["se"], got["se"])
    assert abs(got["mean"] - want["mean"]) <= N_SE * se, (got, want)


def test_stepper_fixture_is_fresh():
    """Every config of the fixture is the current config file with its
    overrides, at the recorded batch, seed and episode count; JAX's
    ``simulate`` on square gives the recorded numbers again."""
    stored = json.loads(FIXTURE.read_text())
    assert set(stored) == set(STEPPER_CONFIGS)
    for name, (model_type, overrides, batch, episodes) in \
            STEPPER_CONFIGS.items():
        entry = stored[name]
        assert (entry["config"], entry["overrides"], entry["batch"],
                entry["episodes"], entry["seed"]) == (
            model_type, overrides, batch, episodes, JAX_SEED)
        assert math.isfinite(entry["mean"]) and entry["se"] > 0
        load_env_params(model_type).replace(**overrides).validate()
    fresh = jax_simulate("square")
    assert {k: stored["square"][k] for k in fresh} == fresh


def test_simulate_raises_when_too_few_episodes_end():
    params = load_env_params("square")
    with pytest.raises(ValueError, match="completed only"):
        random_policy.simulate(params, torch.Generator().manual_seed(0),
                               10_000, batch=4, device="cpu")


@pytest.mark.parametrize("name", ["square", "rectangle", "rectangle_pin"])
def test_flat_action_codecs_match_jax(name):
    """The wrappers' flat action ids (env/wrappers.py) decode, encode and
    flatten masks as the JAX package's do."""
    params, jp = load_env_params(name), load_experiment(name)[0]
    size = wrappers.flat_action_size(params)
    assert size == jax_wrappers.flat_action_size(jp)
    flat = np.arange(size, dtype=np.int32)
    got = wrappers.decode_flat_action(params, torch.as_tensor(flat))
    want = np.asarray(jax_wrappers.decode_flat_action(jp, flat))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        wrappers.encode_flat_action(params, got).numpy(), flat)
    mask = np.random.default_rng(0).random(
        (3,) + (() if name == "square" else (params.num_orientations,))
        + (params.height, params.width)) < 0.5
    np.testing.assert_array_equal(
        wrappers.flatten_mask(params, torch.as_tensor(mask)).numpy(),
        np.asarray(jax_wrappers.flatten_mask(jp, mask)))


def test_random_action_is_legal():
    params = load_env_params("rectangle_pin")
    reset_b, _, _ = core.make_batched(params, "cpu")
    state = reset_b(torch.Generator().manual_seed(0), 64)
    gen = torch.Generator().manual_seed(1)
    for _ in range(8):
        a = random_policy.random_action(gen, params, state.action_mask).long()
        assert state.action_mask[torch.arange(64), a[:, 0], a[:, 1],
                                 a[:, 2]].all()


@pytest.mark.parametrize("call", [
    lambda p, g: core.make_batched(p),
    lambda p, g: random_policy.simulate(p, g, 8, batch=8),
    lambda p, g: fused_rollout.init_leaves(p, g, 8),
])
def test_entry_points_default_to_the_card(call):
    """Without a card the stepper's entry points raise unless the CPU is
    asked for; they never fall back to it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params = load_env_params("rectangle_pin")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(params, torch.Generator().manual_seed(0))
