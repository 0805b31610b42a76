"""The port's conv encoders where Flax's shape rule empties a map, against
the JAX package's Flax ``PlacementModel``: the web app's Train-page conv
sliders on the flagship env, and what an empty map does to statistics,
checkpoints and gradients. ``test_torch_zoo_conv_edges_6x6.py`` runs the
sliders on the 6x6 test env and the spatial preset's component-grid
encoder, ``test_torch_zoo_sync_bn.py`` the synced batch norm; both use the
helpers here.

* The sliders (blocks 1-4 x kernel 2-5 x max pool off / 2 / 3 / 4,
  ``web_app/pages/2_Train_new_agent.py:58-63``): Flax's head widths;
  logits and value within 1e-5 in eval mode; in train mode the same
  outputs within 1e-4, finite, and the running statistics NaN exactly
  where Flax's are (a batch norm over an empty map), the others within
  1e-5.
* A checkpoint that holds those NaN statistics loads, applies as Flax's
  does, round-trips and trains on; the gradients of an empty-map model
  are NaN and finite where Flax's are.

The Flax variables have ``init``'s tree (traced by ``jax.eval_shape``:
Flax infers every width) with values drawn from a seed, non-trivial batch
statistics included; each setting's two Flax applies are one jit.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from placement_tpu.agent.policy import Policy as JaxPolicy
from placement_tpu.agent.policy import model_config_for as jax_model_config
from placement_tpu.models.zoo import PlacementModel as JaxModel
from placement_tpu.utils.config import load_experiment as jax_load
from placement_tpu_torch.agent.policy import Policy
from placement_tpu_torch.agent.ppo import PPOConfig
from placement_tpu_torch.agent.trainer import Trainer
from placement_tpu_torch.models import convert
from placement_tpu_torch.models.zoo import ModelConfig, build_model
from tests.agent.test_models import PIN, SPATIAL
from tests.test_torch_core import port_params
from tests.test_torch_models import jax_obs, torch_obs

TOL = 1e-5
#: train-mode outputs: each batch norm divides by the standard deviation of
#: 8 boards, which scales the convs' f32 rounding up; held as the learner's
#: train-mode results are (``tests/test_torch_mesh_learner.py``)
TRAIN_TOL = 1e-4
#: the Train page's conv sliders: (blocks, kernel, max-pool kernel or None)
SLIDERS = list(itertools.product((1, 2, 3, 4), (2, 3, 4, 5),
                                 (None, 2, 3, 4)))
#: the setting the re-anchoring review found (a (400, 192) logits head in
#: the port before the repair, Flax's (400, 180)): 10 -> 6 -> 2 -> empty
EMPTY_SETTING = dict(num_conv_blocks=3, conv_kernel_size=5, max_pool=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_OBS = {}


def env_obs(env):
    """(EnvParams of the JAX package, JAX observations as numpy) of 8
    boards after 2 random steps; one JAX stepper compile an env."""
    if env not in _OBS:
        params = {"flagship": lambda: jax_load("rectangle_pin")[0],
                  "6x6": lambda: PIN,
                  "spatial": lambda: jax_load("rectangle_spatial_pin")[0],
                  "spatial_3x2": lambda: SPATIAL.replace(
                      max_component_w=2)}[env]()
        _OBS[env] = (params, jax_obs(params, b=8)[1])
    return _OBS[env]


def slider_overrides(blocks, kernel, pool):
    return dict(num_conv_blocks=blocks, conv_kernel_size=kernel,
                max_pool=pool is not None, max_pool_kernel_size=pool or 2)


def seeded_variables(jax_cfg, params, obs, seed=0):
    """Flax ``init``'s variable tree for ``obs``, values from ``seed``:
    kernels N(0, 1/fan_in), biases N(0, 0.1), batch-norm scales and
    variances U(0.5, 2), means N(0, 0.5)."""
    shapes = jax.eval_shape(
        lambda o: JaxPolicy(params, jax_cfg).init(jax.random.PRNGKey(0), o),
        obs)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)), s.shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 2.0, s.shape)
        elif name == "mean":
            v = rng.normal(0.0, 0.5, s.shape)
        else:
            v = rng.normal(0.0, 0.1, s.shape)
        return v.astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, t)
            for c, t in shapes.items()}


def flax_eval_and_train(jax_cfg, variables, obs):
    """Flax's eval-mode outputs, train-mode outputs and updated batch
    statistics (numpy), in one jit."""
    model = JaxModel(jax_cfg)

    def both(v, o):
        ev = model.apply(v, o, train=False)
        tr, upd = model.apply(v, o, train=True, mutable=["batch_stats"])
        return ev, tr, upd["batch_stats"]

    return jax.device_get(jax.jit(both)(variables, obs))


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def assert_same_stats(got, want, what):
    """Running statistics: NaN exactly where Flax's are, the others within
    ``TOL``; ``got``/``want`` flat ``batch_stats/...`` dicts."""
    assert set(got) == set(want), what
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=f"{what}: NaN at {k}")
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   equal_nan=True, err_msg=f"{what}: {k}")


def batch_stats(model):
    return {k: v for k, v in convert.to_flax(model.state_dict()).items()
            if k.startswith("batch_stats/")}


def assert_matches_flax(model, jax_cfg, variables, obs, what):
    """``model`` (the port's, the Flax variables carried, eval mode)
    against Flax in eval and in train mode; leaves ``model`` in eval mode
    with its train-mode statistics."""
    ev, tr, stats = flax_eval_and_train(jax_cfg, variables, obs)
    t_obs = torch_obs(obs)
    with torch.no_grad():
        got = model(t_obs)
        for k in ev:
            _close(got[k], ev[k], f"{what}: eval {k}")
        model.train()
        try:
            got = model(t_obs)
        finally:
            model.eval()
    for k in tr:
        assert bool(torch.isfinite(got[k]).all()), f"{what}: train {k}"
        _close(got[k], tr[k], f"{what}: train {k}", TRAIN_TOL)
    want = {f"batch_stats/{k}": v
            for k, v in convert.flatten(stats).items()}
    assert_same_stats(batch_stats(model), want, what)
    return want


def carried(jax_cfg, variables, component_hw=None):
    model = build_model(ModelConfig(**dataclasses.asdict(jax_cfg)),
                        component_hw)
    model.load_state_dict(convert.state_dict_from_flax(
        variables, model.cfg, component_hw), strict=True)
    return model.eval()


def assert_slider_setting_matches_flax(env, blocks, kernel, pool):
    params, obs = env_obs(env)
    jax_cfg = jax_model_config(params, "rectangle_pin",
                               **slider_overrides(blocks, kernel, pool))
    variables = seeded_variables(jax_cfg, params, obs)
    model = carried(jax_cfg, variables)
    want = variables["params"]["logits_head"]["kernel"].shape
    assert tuple(model.logits_head.weight.shape) == want[::-1]
    assert_matches_flax(model, jax_cfg, variables, obs,
                        f"{env} {blocks}/{kernel}/{pool}")


SLIDER_IDS = [f"b{b}-k{k}-p{p or 0}" for b, k, p in SLIDERS]


@pytest.mark.parametrize("blocks,kernel,pool", SLIDERS, ids=SLIDER_IDS)
def test_train_page_conv_setting_matches_flax(blocks, kernel, pool):
    assert_slider_setting_matches_flax("flagship", blocks, kernel, pool)


def _empty_flagship():
    params, obs = env_obs("flagship")
    jax_cfg = jax_model_config(params, "rectangle_pin", **EMPTY_SETTING)
    return params, obs, jax_cfg, seeded_variables(jax_cfg, params, obs)


def test_empty_setting_gives_flax_widths():
    """The review's example: Flax's (400, 180) logits head; the grid
    encoder adds nothing."""
    params, _, jax_cfg, variables = _empty_flagship()
    model = carried(jax_cfg, variables)
    assert variables["params"]["logits_head"]["kernel"].shape == (180, 400)
    assert tuple(model.logits_head.weight.shape) == (400, 180)
    assert model.grid_conv.out_hw(params.height, params.width) == (0, 0)


def test_checkpoint_with_nan_statistics_loads_and_applies(tmp_path):
    """Flax's train step leaves NaN in BatchNorm_2's statistics: the port
    loads those variables, applies them as Flax does (finite outputs),
    hands them back unchanged, and its own checkpoint keeps them through a
    save and a restore, training on."""
    params, obs, jax_cfg, variables = _empty_flagship()
    _, _, stats = flax_eval_and_train(jax_cfg, variables, obs)
    nan_vars = {"params": variables["params"], "batch_stats": stats}
    flat = convert.flatten(nan_vars)
    assert np.isnan(flat["batch_stats/grid_conv/BatchNorm_2/mean"]).all()
    want = jax.device_get(JaxModel(jax_cfg).apply(nan_vars, obs))
    policy = Policy(port_params(params),
                    ModelConfig(**dataclasses.asdict(jax_cfg)),
                    "cpu").load_flax(nan_vars)
    with torch.no_grad():
        got = policy.model(torch_obs(obs))
    for k in want:
        assert bool(torch.isfinite(got[k]).all())
        _close(got[k], want[k], f"NaN statistics: {k}")
    back = convert.to_flax(policy.model.state_dict())
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    cfg = PPOConfig(num_envs=4, unroll_length=4, minibatch_size=8,
                    num_sgd_iter=2)
    trainer = Trainer("rectangle_pin", results_root=str(tmp_path),
                      ppo_config=cfg, model_overrides=EMPTY_SETTING,
                      device="cpu", use_tensorboard=False, run_name="nan")
    state = trainer.init_state(0, flax_variables=nan_vars)
    trainer.ckpt.save(1, state, force=True)
    restored = trainer.restore()
    got_sd = restored.model.state_dict()
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0,
                                   equal_nan=True)
    result = trainer.run(1, state=restored)
    trainer.close()
    assert all(np.isfinite(v) for v in result.final_metrics.values())
    stats_after = batch_stats(result.state.model)
    assert np.isnan(
        stats_after["batch_stats/grid_conv/BatchNorm_2/mean"]).all()
    assert np.isfinite(
        stats_after["batch_stats/grid_conv/BatchNorm_1/mean"]).all()


def test_empty_map_gradients_match_flax():
    """Train-mode gradients of value + legal logits: NaN exactly where
    Flax's are (the scale of a batch norm over an empty map: 0 times the
    NaN inverse deviation), 0 for the empty blocks' convs (none is None),
    the others within 1e-5 times max(1, the tensor's largest entry); the
    biases that feed a batch norm, whose gradient is rounding noise, below
    1e-5."""
    params, obs, jax_cfg, variables = _empty_flagship()
    model = JaxModel(jax_cfg)
    w = np.random.default_rng(4).normal(
        size=obs["action_mask"].reshape(8, -1).shape).astype(np.float32)
    legal = obs["action_mask"].reshape(8, -1) > 0

    def loss(p):
        out, _ = model.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             obs, train=True, mutable=["batch_stats"])
        return (out["value"].sum()
                + jnp.where(legal, out["logits"], 0.0).__mul__(w).sum())

    want = convert.flatten({"params": jax.device_get(
        jax.jit(jax.grad(loss))(variables["params"]))})
    port = carried(jax_cfg, variables).train()
    out = port(torch_obs(obs))
    (out["value"].sum() + (torch.where(torch.as_tensor(legal),
                                       out["logits"], 0.0)
                           * torch.as_tensor(w)).sum()).backward()
    got = convert.flax_grads(port)
    noise = convert.norm_fed_biases(want)
    assert set(got) == set(want)
    nan_leaves = {k for k, v in want.items() if np.isnan(v).any()}
    assert nan_leaves == {"params/grid_conv/BatchNorm_2/scale"}
    for k in want:
        g, v = got[k], want[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(v), err_msg=k)
        if k in nan_leaves:
            continue
        if k in noise:
            assert abs(g).max() <= TOL and abs(v).max() <= TOL, k
            continue
        scale = max(float(abs(v).max()), 1e-30)
        assert float(abs(g - v).max()) <= TOL * max(scale, 1.0), k
    for k in ("params/grid_conv/Conv_2/kernel",
              "params/grid_conv/Conv_2/bias"):
        assert not got[k].any() and not want[k].any(), k
