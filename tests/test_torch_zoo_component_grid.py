"""The spatial preset's component-grid encoder with pooling or VALID
padding, against the JAX package's Flax ``PlacementModel`` (helpers and
tolerances: ``test_torch_zoo_conv_edges.py``). The port refused these
settings before it took the grid's sides from the env: ``Policy`` passes
its env's (max_component_h, max_component_w) to the model, whose width
then follows Flax's shape rule. On the flagship spatial env (2x2
components) and on the 6x6 spatial env with 3x2 components.

``tests/fixtures/torch_zoo_edges.npz`` holds, for ``chip_smoke.py``'s
``[zoo edges]``, the Flax ``init`` variables (seed 0) of the two repaired
settings (``ZOO_EDGES``), 64 JAX observations of each env and JAX's
eval-mode logits and value on them; ``test_zoo_edges_fixture_is_fresh``
fails when it goes stale. Record it with ``PYTHONPATH=. JAX_PLATFORMS=cpu
python tests/test_torch_zoo_component_grid.py``.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from placement_tpu.agent.policy import Policy as JaxPolicy
from placement_tpu.agent.policy import model_config_for as jax_model_config
from placement_tpu.models.zoo import PlacementModel as JaxModel
from placement_tpu.utils.config import load_experiment as jax_load
from placement_tpu_torch.agent.policy import Policy
from placement_tpu_torch.models import convert
from placement_tpu_torch.models.zoo import ModelConfig, build_model
from tests.test_torch_core import port_params
from tests.test_torch_models import jax_obs, torch_obs
from tests.test_torch_zoo_conv_edges import (
    EMPTY_SETTING, assert_matches_flax, env_obs, seeded_variables)

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_zoo_edges.npz")
#: the fixture's settings: name -> (model type, model overrides)
ZOO_EDGES = {
    "flagship_empty": ("rectangle_pin", EMPTY_SETTING),
    "spatial_pool": ("rectangle_spatial_pin",
                     dict(max_pool_component_grid=True,
                          max_pool_kernel_size_component_grid=2)),
}
FIXTURE_BOARDS = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the spatial preset's component-grid encoder settings JAX accepts that
#: the port refused before the repair, and the two that empty it
SPATIAL_CASES = {
    "pool2": dict(max_pool_component_grid=True,
                  max_pool_kernel_size_component_grid=2),
    "pool3_empty": dict(max_pool_component_grid=True),
    "valid_k1": dict(conv_padding_component_grid="VALID",
                     conv_kernel_size_component_grid=1),
    "valid_k2": dict(conv_padding_component_grid="VALID",
                     conv_kernel_size_component_grid=2),
    "valid_k3_empty": dict(conv_padding_component_grid="VALID"),
}


@pytest.mark.parametrize("env", ["spatial", "spatial_3x2"])
@pytest.mark.parametrize("case", sorted(SPATIAL_CASES))
def test_component_grid_encoder_matches_flax(env, case):
    """Through ``Policy``, which gives the model its env's component
    sides: JAX's logits [B, 400] (or [B, 144]) and value [B], eval and
    train mode within 1e-5; without the sides the model refuses a width
    that the config cannot fix."""
    params, obs = env_obs(env)
    jax_cfg = jax_model_config(params, "rectangle_spatial_pin",
                               **SPATIAL_CASES[case])
    variables = seeded_variables(jax_cfg, params, obs)
    cfg = ModelConfig(**dataclasses.asdict(jax_cfg))
    policy = Policy(port_params(params), cfg, "cpu").load_flax(variables)
    want = variables["params"]["spatial_comp_attn"]["Dense_0"]["kernel"]
    assert tuple(policy.model.spatial_comp_attn.Dense_0.weight.shape) == \
        want.shape[::-1]
    assert_matches_flax(policy.model, jax_cfg, variables, obs,
                        f"{env} {case}")
    b = obs["grid"].shape[0]
    with torch.no_grad():
        out = policy.model(torch_obs(obs))
    assert tuple(out["logits"].shape) == (b, jax_cfg.num_actions)
    assert tuple(out["value"].shape) == (b,)
    with pytest.raises(ValueError, match="component_hw"):
        build_model(cfg)


def test_shipped_spatial_config_needs_no_sides():
    """The shipped spatial config ("SAME", no pool) keeps every cell, so
    ``build_model(cfg)`` alone still fixes the width."""
    cfg = ModelConfig(**dataclasses.asdict(jax_load(
        "rectangle_spatial_pin")[1]))
    assert build_model(cfg).spatial_comp_attn.Dense_0.in_features == \
        build_model(cfg, (2, 2)).spatial_comp_attn.Dense_0.in_features


def record_fixture():
    """{npz key: array} of the fixture: per setting ``<name>/var/...``
    (Flax ``init`` at seed 0), ``<name>/obs/...`` (64 JAX observations,
    seed 0, 3 random steps) and JAX's eval-mode ``<name>/logits`` and
    ``<name>/value``; ``meta`` the settings as JSON."""
    out = {"meta": np.asarray(json.dumps(ZOO_EDGES))}
    for name, (model_type, overrides) in ZOO_EDGES.items():
        params, _, _ = jax_load(model_type)
        cfg = jax_model_config(params, model_type, **overrides)
        _, obs = jax_obs(params, b=FIXTURE_BOARDS, steps=3)
        variables = jax.device_get(JaxPolicy(params, cfg).init(
            jax.random.PRNGKey(0), obs))
        want = jax.device_get(JaxModel(cfg).apply(variables, obs))
        out.update({f"{name}/var/{k}": np.asarray(v)
                    for k, v in convert.flatten(variables).items()})
        out.update({f"{name}/obs/{k}": v for k, v in obs.items()})
        out[f"{name}/logits"] = np.asarray(want["logits"])
        out[f"{name}/value"] = np.asarray(want["value"])
    return out


def test_zoo_edges_fixture_is_fresh():
    """The committed fixture equals a fresh recording, and the port on the
    CPU, its variables carried in through ``Policy``, gives its JAX
    logits and value within 1e-5."""
    have = dict(np.load(FIXTURE))
    want = record_fixture()
    assert set(have) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(have[k], v, err_msg=k)
    for name, (model_type, overrides) in ZOO_EDGES.items():
        params, _, _ = jax_load(model_type)
        cfg = ModelConfig(**dataclasses.asdict(
            jax_model_config(params, model_type, **overrides)))
        variables = convert.unflatten({
            k[len(name) + 5:]: v for k, v in have.items()
            if k.startswith(f"{name}/var/")})
        obs = {k[len(name) + 5:]: v for k, v in have.items()
               if k.startswith(f"{name}/obs/")}
        policy = Policy(port_params(params), cfg, "cpu").load_flax(variables)
        with torch.no_grad():
            got = policy.model(torch_obs(obs))
        for k in ("logits", "value"):
            np.testing.assert_allclose(got[k].numpy(), have[f"{name}/{k}"],
                                       rtol=1e-5, atol=1e-5, err_msg=name)


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **record_fixture())
    print(f"wrote {FIXTURE}")
