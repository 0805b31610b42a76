"""The port's model zoo (``placement_tpu_torch.models``) against the JAX
package's Flax ``PlacementModel``.

Every preset is initialized by Flax at a seed, its variables are carried
across with ``models/convert.py``, and both models read the same
observation dict: JAX's, as numpy (so the port's known ``pins_feature``
difference on duplicate keys never enters a model comparison). Logits,
value and, for the factorized presets, the encoding and the three factor
heads agree within 1e-5 absolute and 1e-5 relative (f32 sums in another
order). The presets run at the small sizes of
``tests/agent/test_models.py`` and the flagship at its published widths.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from placement_tpu.agent.policy import Policy as JaxPolicy
from placement_tpu.agent.policy import model_config_for as jax_model_config
from placement_tpu.agent.random_policy import random_action as jax_random
from placement_tpu.env.core import make_batched
from placement_tpu.models.zoo import PlacementModel as JaxModel
from placement_tpu.utils.config import load_experiment as jax_load
from placement_tpu_torch.models import MODEL_REGISTRY, ModelConfig, build_model
from placement_tpu_torch.models import convert
from placement_tpu_torch.models.zoo import init_parameters
from tests.agent.test_models import ENV_FOR, PIN

RTOL = ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_fns(params):
    return make_batched(params)


def jax_obs(params, b=8, seed=0, steps=2):
    """JAX states and observations (numpy) of ``b`` boards: reset, then
    ``steps`` random legal steps with auto-reset."""
    reset_b, step_b, obs_b = _jax_fns(params)
    key = jax.random.PRNGKey(seed)
    states = reset_b(jax.random.split(key, b))
    for i in range(steps):
        a = jax_random(jax.random.fold_in(key, i), params, states.action_mask)
        states, _, _, _ = step_b(states, a)
    return states, {k: np.asarray(v) for k, v in obs_b(states).items()}


def port_config(jax_cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def flax_variables(jax_cfg, params, obs, seed=0):
    """Flax ``init`` of the preset, as a numpy tree."""
    variables = JaxPolicy(params, jax_cfg).init(jax.random.PRNGKey(seed), obs)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def carried(jax_cfg, variables):
    """The port's module in eval mode with the Flax variables."""
    model = build_model(port_config(jax_cfg))
    model.load_state_dict(convert.state_dict_from_flax(
        variables, port_config(jax_cfg)), strict=True)
    return model.eval()


def torch_obs(obs):
    return {k: torch.as_tensor(v) for k, v in obs.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_same_model(jax_cfg, params, obs, variables):
    model = carried(jax_cfg, variables)
    want = JaxModel(jax_cfg).apply(variables, obs, train=False)
    with torch.no_grad():
        got = model(torch_obs(obs))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    if not jax_cfg.is_factorized:
        return
    enc = np.asarray(want["encoding"])
    b = enc.shape[0]
    rng = np.random.default_rng(1)
    onehot = np.eye(jax_cfg.num_orientations, dtype=np.float32)[
        rng.integers(jax_cfg.num_orientations, size=b)]
    xn = (rng.integers(jax_cfg.height, size=b) / jax_cfg.height
          ).astype(np.float32)
    yn = (rng.integers(jax_cfg.width, size=b) / jax_cfg.width
          ).astype(np.float32)
    m = JaxModel(jax_cfg)
    with torch.no_grad():
        t = torch.as_tensor
        _close(model.o_logits(t(enc), t(xn), t(yn)),
               m.apply(variables, enc, xn, yn, method=JaxModel.o_logits), "o")
        _close(model.x_logits(t(enc), t(onehot)),
               m.apply(variables, enc, onehot, method=JaxModel.x_logits), "x")
        _close(model.y_logits(t(enc), t(onehot), t(xn)),
               m.apply(variables, enc, onehot, xn, method=JaxModel.y_logits),
               "y")


@pytest.mark.parametrize("model_type", MODEL_REGISTRY)
def test_preset_matches_flax(model_type):
    params = ENV_FOR[model_type]
    jax_cfg = jax_model_config(params, model_type)
    _, obs = jax_obs(params)
    _assert_same_model(jax_cfg, params, obs,
                       flax_variables(jax_cfg, params, obs))


@pytest.mark.parametrize("model_type", ["rectangle_factorized_pin",
                                        "rectangle_pin_all_attn_factorized"])
def test_coordinates_factorization_matches_flax(model_type):
    jax_cfg = jax_model_config(PIN, model_type, factorization="coordinates")
    _, obs = jax_obs(PIN)
    _assert_same_model(jax_cfg, PIN, obs, flax_variables(jax_cfg, PIN, obs))


def test_flagship_at_published_widths_matches_flax():
    params, jax_cfg, _ = jax_load("rectangle_pin")
    _, obs = jax_obs(params, b=16, steps=3)
    _assert_same_model(jax_cfg, params, obs,
                       flax_variables(jax_cfg, params, obs, seed=3))


@pytest.mark.parametrize("model_type", ["rectangle", "rectangle_spatial_pin"])
def test_batch_norm_eval_mode_uses_batch_stats(model_type):
    """Non-trivial BatchNorm statistics and scales (the grid encoder's 2-D
    norms; the rectangle preset's 1-D ``flat_feature_norm``): eval mode
    normalizes by the carried ``batch_stats``."""
    params = ENV_FOR[model_type]
    jax_cfg = jax_model_config(params, model_type)
    _, obs = jax_obs(params)
    variables = flax_variables(jax_cfg, params, obs)
    rng = np.random.default_rng(2)

    def perturb(path, v):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return v

    variables = {c: jax.tree_util.tree_map_with_path(perturb, t)
                 for c, t in variables.items()}
    assert any("BatchNorm" in k or "norm" in k
               for k in convert.flatten(variables["batch_stats"]))
    _assert_same_model(jax_cfg, params, obs, variables)


def test_convert_rejects_a_wrong_tree():
    """A missing or extra variable, or a misshapen one, raises."""
    params = ENV_FOR["rectangle_pin"]
    jax_cfg = jax_model_config(params, "rectangle_pin")
    _, obs = jax_obs(params)
    flat = convert.flatten(flax_variables(jax_cfg, params, obs))
    cfg = port_config(jax_cfg)
    missing = {k: v for k, v in flat.items() if "value_head" not in k}
    with pytest.raises(ValueError, match="missing"):
        convert.state_dict_from_flax(convert.unflatten(missing), cfg)
    extra = dict(flat, **{"params/extra/bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        convert.state_dict_from_flax(convert.unflatten(extra), cfg)
    bad = dict(flat)
    k = "params/value_head/kernel"
    bad[k] = np.zeros((bad[k].shape[0] + 1, 1), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.state_dict_from_flax(convert.unflatten(bad), cfg)


def test_init_parameters_follow_flax_distributions():
    """The port's own initialization: every kernel within the truncated
    normal's two standard deviations with about Flax's spread, biases 0."""
    params, jax_cfg, _ = jax_load("rectangle_pin")
    model = init_parameters(build_model(port_config(jax_cfg)),
                            torch.Generator().manual_seed(0))
    w = model.logits_head.weight
    std = 1.0 / np.sqrt(w.shape[1])
    assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert float(model.logits_head.bias.abs().max()) == 0.0
