"""The port's learner (``placement_tpu_torch.agent.ppo``, ``Policy.evaluate``
and Flax's batch-norm rule in ``models/blocks.py``) against the JAX
package's, on the CPU.

Every comparison feeds both packages the same inputs: the Flax variables
(``init`` at a seed, batch statistics perturbed from a seed with numpy)
carried across with ``models/convert.py``, JAX's observations as numpy, and
numpy-made minibatches. Tolerances, each stated where it is used:

* batch norm in train mode: outputs and updated statistics within 1e-5
  relative of Flax's ``apply(..., mutable=["batch_stats"])``;
* ``evaluate``: logp, entropy, value and KL within 1e-5 (categorical); logp
  and value within 1e-5, the sampled entropy and KL by their mean over many
  draws (factorized);
* GAE within 1e-6;
* the loss and its aux within 1e-4 relative or 1e-6 absolute of
  ``jax.value_and_grad``, and every gradient tensor (through
  ``convert.flax_grads``) within 1e-4 of the tensor's largest entry plus
  1e-6: an entry where many terms cancel carries their rounding, so the
  bound is relative to the gradient, not to the entry;
* one ``update`` fed JAX's rollout and permutations: parameters, statistics,
  ``kl_coeff`` and the loss metrics within 1e-4 of JAX's ``train_step``.

A bias that feeds a train-mode batch norm has a gradient of exactly 0 in
exact arithmetic (``convert.norm_fed_biases``): both packages return rounding
noise, which Adam scales to steps of up to ``lr`` each. Those gradients are
held below ``CANCELLED_GRAD`` and those parameters within 2 * lr a step of
JAX's.

The rest ports ``tests/agent/test_ppo.py`` with its thresholds.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from placement_tpu.agent.policy import Policy as JaxPolicy
from placement_tpu.agent.policy import model_config_for as jax_model_config
from placement_tpu.agent.ppo import PPOConfig as JaxPPOConfig
from placement_tpu.agent.ppo import PPOLearner as JaxLearner
from placement_tpu.agent.ppo import Transition as JaxTransition
from placement_tpu.models.zoo import PlacementModel as JaxModel
from placement_tpu.utils.config import load_experiment as jax_load
from placement_tpu_torch.agent.policy import Policy, model_config_for
from placement_tpu_torch.agent.ppo import (
    PPOConfig, PPOLearner, Transition)
from placement_tpu_torch.env.types import EnvParams, Variant
from placement_tpu_torch.models import MODEL_REGISTRY, convert
from placement_tpu_torch.models.blocks import BatchNorm
from tests.agent.test_models import ENV_FOR, PIN
from tests.test_torch_core import port_params
from tests.test_torch_models import (
    carried, flax_variables, jax_obs, port_config, torch_obs)
from tests.test_torch_policy import fixture

BN_RTOL = 1e-5
EVAL_TOL = 1e-5
GAE_TOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
UPDATE_TOL = 1e-4
#: combined standard errors allowed between two sampled means
N_SE = 4.0
#: the gradient of a bias that feeds a train-mode batch norm is 0 in exact
#: arithmetic (the norm subtracts the batch mean): both packages return
#: rounding noise, held below this bound instead of to each other
CANCELLED_GRAD = 1e-5

BN_PRESETS = [t for t in MODEL_REGISTRY
              if t != "rectangle_pin_attn_all_no_grid"]
CATEGORICAL = [t for t in MODEL_REGISTRY
               if t not in ("rectangle_factorized", "rectangle_factorized_pin",
                            "rectangle_pin_all_attn_factorized")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, so PyTorch's thread
    pool only adds overhead, and the cores stay with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(variables, seed=2):
    """``variables`` with non-trivial batch statistics and BN scales (Flax
    ``init`` leaves them at 0, 1, 1)."""
    rng = np.random.default_rng(seed)

    def perturb(path, v):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return v

    return {c: jax.tree_util.tree_map_with_path(perturb, t)
            for c, t in variables.items()}


@functools.lru_cache(maxsize=None)
def _setup_cached(model_type, b, order):
    params = ENV_FOR[model_type]
    jax_cfg = jax_model_config(params, model_type, factorization=order)
    _, obs = jax_obs(params, b=b)
    variables = perturbed(flax_variables(jax_cfg, params, obs))
    return params, jax_cfg, obs, variables


def _setup(model_type, b=8, order="orientation"):
    """(params, JAX config, JAX observations, perturbed Flax variables) of
    a preset at its small size (numpy leaves, shared read-only between the
    tests of one preset)."""
    return _setup_cached(model_type, b, order)


def close_to_scale(got, want, rtol, atol, what):
    """max |got - want| <= rtol * max |want| + atol over the tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale + atol, (what, err, scale)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _stats(model):
    """The model's batch statistics at their Flax paths."""
    return {k: v for k, v in convert.to_flax(model.state_dict()).items()
            if k.startswith("batch_stats/")}


# ---------------------------------------------------------------------------
# Flax's batch norm in train mode
# ---------------------------------------------------------------------------

def _train_forward_vs_flax(model_type, swap_flat_norm=False):
    """(port outputs, Flax outputs, port statistics, Flax statistics) of
    one train-mode forward."""
    params, jax_cfg, obs, variables = _setup(model_type)
    want, updates = JaxModel(jax_cfg).apply(variables, obs, train=True,
                                            mutable=["batch_stats"])
    model = carried(jax_cfg, variables)
    if swap_flat_norm:
        old = model.flat_feature_norm
        plain = torch.nn.BatchNorm1d(old.weight.shape[0], eps=1e-3,
                                     momentum=0.01)
        plain.load_state_dict(old.state_dict())
        model.flat_feature_norm = plain
    model.train()
    with torch.no_grad():
        got = model(torch_obs(obs))
    want_stats = {f"batch_stats/{k}": v for k, v in convert.flatten(
        jax.device_get(updates["batch_stats"])).items()}
    return got, want, _stats(model), want_stats


@pytest.mark.parametrize("model_type", BN_PRESETS)
def test_batch_norm_train_mode_matches_flax(model_type):
    """Outputs and the moved statistics equal Flax's within 1e-5 relative
    (1e-7 absolute for entries near 0)."""
    got, want, got_stats, want_stats = _train_forward_vs_flax(model_type)
    for k in want:
        _close(got[k].numpy(), want[k], BN_RTOL, BN_RTOL, k)
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        _close(got_stats[k], want_stats[k], BN_RTOL, 1e-7, k)


def test_flat_feature_norm_fails_under_torch_batchnorm1d():
    """PyTorch's own ``BatchNorm1d`` moves the running variance by the
    unbiased batch variance: on the rectangle preset's ``flat_feature_norm``
    (n = 8 boards) that is n / (n - 1) off, far outside 1e-5."""
    _, _, got_stats, want_stats = _train_forward_vs_flax(
        "rectangle", swap_flat_norm=True)
    k = "batch_stats/flat_feature_norm/var"
    err = np.abs(got_stats[k] - want_stats[k]) / np.abs(want_stats[k])
    assert err.max() > 1e2 * BN_RTOL, err.max()


def test_batch_norm_eval_mode_is_torch_batchnorm_bit_for_bit():
    """Eval mode is ``nn.BatchNorm2d``'s, bit for bit (the module the zoo
    used before it followed Flax's train-mode rule)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((16, 3, 6, 6), generator=g)
    ours, plain = BatchNorm(3), torch.nn.BatchNorm2d(3, eps=1e-3,
                                                     momentum=0.01)
    with torch.no_grad():
        for t in (ours, plain):
            t.weight.copy_(torch.tensor([0.5, 1.0, 2.0]))
            t.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
            t.running_mean.copy_(torch.tensor([0.3, -1.0, 0.0]))
            t.running_var.copy_(torch.tensor([2.0, 0.5, 1.5]))
        assert torch.equal(ours.eval()(x), plain.eval()(x))
        assert set(ours.state_dict()) == set(plain.state_dict())


# ---------------------------------------------------------------------------
# Policy.evaluate
# ---------------------------------------------------------------------------

def _behaviour(jax_cfg, params, obs, variables, seed=5):
    """Actions JAX samples and the behaviour inputs of another policy (the
    batch statistics perturbed again), so that the KL is not 0."""
    jpol = JaxPolicy(params, jax_cfg)
    other = perturbed(variables, seed=seed)
    action, _, _, dist_inputs = jpol.act(other, obs, jax.random.PRNGKey(seed))
    return np.asarray(action), np.asarray(dist_inputs)


@pytest.mark.parametrize("model_type", CATEGORICAL)
def test_evaluate_categorical_matches_jax(model_type):
    """logp, entropy, value, KL and the moved statistics within 1e-5."""
    params, jax_cfg, obs, variables = _setup(model_type)
    action, behaviour = _behaviour(jax_cfg, params, obs, variables)
    want = JaxPolicy(params, jax_cfg).evaluate(
        variables, obs, action, behaviour, jax.random.PRNGKey(0))
    pol = Policy(port_params(params), port_config(jax_cfg), "cpu")
    pol.load_flax(variables)
    got = pol.evaluate(torch_obs(obs), torch.as_tensor(action),
                       torch.as_tensor(behaviour), torch.Generator())
    assert not pol.model.training
    for name, g, w in zip(("logp", "entropy", "value", "kl"), got, want):
        _close(g.detach().numpy(), w, EVAL_TOL, EVAL_TOL, name)
    want_stats = {f"batch_stats/{k}": v for k, v in convert.flatten(
        jax.device_get(want[4].get("batch_stats", {}))).items()}
    got_stats = _stats(pol.model)
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        _close(got_stats[k], want_stats[k], BN_RTOL, 1e-7, k)


@pytest.mark.parametrize("model_type,order", [
    ("rectangle_factorized_pin", "orientation"),
    ("rectangle_factorized_pin", "coordinates"),
    ("rectangle_factorized", "orientation")])
def test_evaluate_factorized_matches_jax(model_type, order):
    """logp and value within 1e-5; the sampled entropy and KL estimates:
    their means over 32 draws of each package within 4 combined standard
    errors."""
    params, jax_cfg, obs, variables = _setup(model_type, b=16, order=order)
    action, behaviour = _behaviour(jax_cfg, params, obs, variables)
    jpol = JaxPolicy(params, jax_cfg)
    jev = jax.jit(lambda k: jpol.evaluate(variables, obs, action, behaviour,
                                          k)[:4])
    pol = Policy(port_params(params), port_config(jax_cfg), "cpu")
    pol.load_flax(variables)
    gen = torch.Generator().manual_seed(0)
    draws = 32
    want = [jev(jax.random.PRNGKey(i)) for i in range(draws)]
    with torch.no_grad():
        got = [pol.evaluate(torch_obs(obs), torch.as_tensor(action),
                            torch.as_tensor(behaviour), gen)
               for _ in range(draws)]
    _close(got[0][0].numpy(), want[0][0], EVAL_TOL, EVAL_TOL, "logp")
    _close(got[0][2].numpy(), want[0][2], EVAL_TOL, EVAL_TOL, "value")
    for i, name in ((1, "entropy"), (3, "kl")):
        w = np.array([float(np.mean(x[i])) for x in want])
        g = np.array([float(x[i].mean()) for x in got])
        se = math.hypot(w.std(ddof=1), g.std(ddof=1)) / math.sqrt(draws)
        assert abs(g.mean() - w.mean()) <= N_SE * max(se, 1e-6), (
            name, g.mean(), w.mean(), se)
        assert (name != "kl") or w.mean() > 1e-4   # the draws see a KL


# ---------------------------------------------------------------------------
# GAE, loss and gradients
# ---------------------------------------------------------------------------

def _learners(model_type, params, jax_cfg, cfg_kw=None):
    kw = dict(num_envs=8, unroll_length=8, minibatch_size=16,
              num_sgd_iter=2)
    kw.update(cfg_kw or {})
    jl = JaxLearner(params, JaxPolicy(params, jax_cfg), JaxPPOConfig(**kw))
    pol = Policy(port_params(params), port_config(jax_cfg), "cpu")
    return jl, PPOLearner(port_params(params), pol, PPOConfig(**kw))


def test_gae_matches_jax():
    """Random [T, B] rewards, values and dones: advantages and value
    targets within 1e-6."""
    rng = np.random.default_rng(0)
    t, b = 12, 16
    reward = rng.normal(size=(t, b)).astype(np.float32)
    value = rng.normal(size=(t, b)).astype(np.float32)
    done = rng.random((t, b)) < 0.2
    last = rng.normal(size=(b,)).astype(np.float32)
    params = ENV_FOR["rectangle_pin"]
    jl, learner = _learners("rectangle_pin", params,
                            jax_model_config(params, "rectangle_pin"),
                            {"gae_lambda": 0.95})
    want = jl._gae(JaxTransition(None, None, None, jnp.asarray(value),
                                 jnp.asarray(reward), jnp.asarray(done),
                                 None), jnp.asarray(last))
    t_ = torch.as_tensor
    got = learner._gae(Transition(None, None, None, t_(value), t_(reward),
                                  t_(done), None), t_(last))
    for g, w, name in zip(got, want, ("advantages", "value_targets")):
        _close(g.numpy(), w, 0, GAE_TOL, name)


def _minibatch(jax_cfg, params, obs, variables, seed=0):
    """A fixed minibatch: JAX's sampled actions and behaviour inputs (of
    other statistics), their logp moved by noise, numpy-made advantages
    and value targets."""
    rng = np.random.default_rng(seed)
    action, behaviour = _behaviour(jax_cfg, params, obs, variables)
    b = action.shape[0]
    logp = np.asarray(JaxPolicy(params, jax_cfg).evaluate(
        variables, obs, action, behaviour, jax.random.PRNGKey(1),
        train=False)[0])
    return {"obs": obs, "action": action, "dist_inputs": behaviour,
            "logp": (logp + rng.normal(0, 0.2, b)).astype(np.float32),
            "advantages": rng.normal(size=b).astype(np.float32),
            "value_targets": rng.normal(0, 2.0, b).astype(np.float32)}


def _to_torch(mb):
    return {k: ({o: torch.as_tensor(x) for o, x in v.items()}
                if k == "obs" else torch.as_tensor(v)) for k, v in mb.items()}


@pytest.mark.parametrize("case", ["flagship", "factorized"])
def test_loss_and_gradients_match_jax(case):
    """``jax.value_and_grad(PPOLearner._loss, has_aux=True)`` on a fixed
    minibatch with the carried parameters: the loss, its aux and every
    gradient within 1e-4 relative or 1e-6 absolute. The flagship runs at
    its published widths on the fixture's 64 observations; the factorized
    preset with ``kl_coeff`` = ``entropy_coeff`` = 0, so that its sampled
    terms stay out of the loss and the gradients."""
    if case == "flagship":
        params, jax_cfg, _ = jax_load("rectangle_pin")
        variables, obs, _ = fixture()
        variables = perturbed(variables)
        kl_coeff, aux_keys = 0.2, ("policy_loss", "vf_loss", "entropy", "kl")
    else:
        params, jax_cfg, obs, variables = _setup("rectangle_factorized_pin",
                                                 b=32)
        kl_coeff, aux_keys = 0.0, ("policy_loss", "vf_loss")
    mb = _minibatch(jax_cfg, params, obs, variables)
    jl, learner = _learners(case, params, jax_cfg)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jl._loss, has_aux=True))(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        jax.tree_util.tree_map(jnp.asarray, mb), jnp.float32(kl_coeff),
        jax.random.PRNGKey(3))
    learner.policy.load_flax(variables)
    got_loss, got_aux = learner._loss(_to_torch(mb), torch.tensor(kl_coeff),
                                      torch.Generator().manual_seed(3))
    got_loss.backward()
    _close(float(got_loss.detach()), float(loss), GRAD_RTOL, GRAD_ATOL, "loss")
    for k in aux_keys:
        _close(float(got_aux[k].detach()), float(aux[k]), GRAD_RTOL,
               GRAD_ATOL, k)
    want_grads = {f"params/{k}": v for k, v in convert.flatten(
        jax.device_get(grads)).items()}
    got_grads = convert.flax_grads(learner.policy.model)
    assert set(got_grads) == set(want_grads)
    noise = convert.norm_fed_biases(want_grads)
    assert noise, "the presets' conv blocks feed batch norms"
    for k in want_grads:
        if k in noise:
            assert max(np.abs(got_grads[k]).max(),
                       np.abs(want_grads[k]).max()) <= CANCELLED_GRAD, k
        else:
            close_to_scale(got_grads[k], want_grads[k], GRAD_RTOL,
                           GRAD_ATOL, k)
    want_stats = {f"batch_stats/{k}": v for k, v in convert.flatten(
        jax.device_get(aux["bn_updates"]["batch_stats"])).items()}
    got_stats = _stats(learner.policy.model)
    for k in want_stats:
        _close(got_stats[k], want_stats[k], BN_RTOL, 1e-7, k)


# ---------------------------------------------------------------------------
# One update against JAX's train step
# ---------------------------------------------------------------------------

def test_update_matches_jax_train_step():
    """JAX's own rollout on the 6x6 ``PIN`` env of
    ``tests/agent/test_ppo.py`` and JAX's permutations of each epoch, fed
    through the port's ``update`` (``num_sgd_iter`` 2, 4 minibatches an
    epoch): parameters, batch statistics, ``kl_coeff`` and the loss
    metrics within 1e-4 of JAX's ``train_step``."""
    params = PIN.replace(reward_type="centroid")
    jax_cfg = jax_model_config(params, "rectangle_pin")
    jl, learner = _learners("rectangle_pin", params, jax_cfg)
    state = jl.init(jax.random.PRNGKey(0))
    rolled, traj, last_value, _ = jax.jit(jl._rollout)(state)
    _, k_sgd = jax.random.split(rolled.key)
    perms = [torch.as_tensor(np.asarray(jax.random.permutation(k, 64)))
             for k in jax.random.split(k_sgd, 2)]
    want_state, want = jax.jit(jl.train_step)(state)

    variables = jax.tree_util.tree_map(np.asarray,
                                       jax.device_get(state.variables))
    port_state = learner.init(torch.Generator().manual_seed(0), variables)
    t = jax.tree_util.tree_map(lambda x: torch.as_tensor(np.asarray(x)),
                               traj._asdict())
    port_state, got = learner.update(
        port_state, Transition(**t), torch.as_tensor(np.asarray(last_value)),
        perms=perms)
    for k in ("policy_loss", "vf_loss", "entropy", "kl", "kl_coeff"):
        _close(float(got[k]), float(want[k]), UPDATE_TOL, UPDATE_TOL, k)
    _close(float(port_state.kl_coeff), float(want_state.kl_coeff), 0, 0,
           "state kl_coeff")
    want_vars = convert.flatten(jax.device_get(want_state.variables))
    got_vars = convert.to_flax(learner.policy.model.state_dict())
    assert set(got_vars) == set(want_vars)
    noise = convert.norm_fed_biases(want_vars)
    adam_steps = 2 * 64 // 16
    for k in want_vars:
        tol = (2 * learner.cfg.lr * adam_steps if k in noise
               else UPDATE_TOL)
        _close(got_vars[k], want_vars[k], 0, tol, k)
    moved = convert.flatten(variables)
    assert any(not np.array_equal(moved[k], got_vars[k]) for k in moved)


# ---------------------------------------------------------------------------
# Ports of tests/agent/test_ppo.py
# ---------------------------------------------------------------------------

PORT_PIN = port_params(PIN.replace(reward_type="centroid"))


def small_cfg(**kw):
    base = dict(num_envs=8, unroll_length=8, minibatch_size=16,
                num_sgd_iter=2)
    base.update(kw)
    return PPOConfig(**base)


def _learner(params, model_type, cfg, **model_kw):
    pol = Policy(params, model_config_for(params, model_type, **model_kw),
                 "cpu")
    return PPOLearner(params, pol, cfg)


def test_train_step_runs():
    learner = _learner(PORT_PIN, "rectangle_pin", small_cfg())
    state = learner.init(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = learner.train_step(state)
    assert list(metrics) == sorted([
        "policy_loss", "vf_loss", "entropy", "kl", "kl_coeff",
        "episode_reward_mean", "episode_len_mean", "episodes_this_iter",
        "normalized_wirelengths_mean", "num_intersections_mean",
        "pool_wraps"])
    for k, v in metrics.items():
        assert bool(torch.isfinite(v).all()), k
    assert any(not torch.equal(before[k], v)
               for k, v in state.model.state_dict().items())
    state, _ = learner.train_step(state)
    assert state.steps == 2 * learner.cfg.train_batch


def test_route_budget_rollout_matches_eager():
    """``route_budget`` changes where the routing runs, not the rollout:
    from one state and one generator state, actions and dones equal,
    rewards and the window's sums within one f32 ulp (the wirelength's sum
    runs in another order), the bootstrap values equal."""
    eager = _learner(PORT_PIN, "rectangle_pin", small_cfg())
    gated = PPOLearner(PORT_PIN, eager.policy, small_cfg(route_budget=4))
    s0 = eager.init(torch.Generator().manual_seed(1))
    s1 = dataclasses.replace(
        s0, gen=torch.Generator().set_state(s0.gen.get_state()))
    _, tr_e, lv_e, m_e = eager.rollout(s0)
    _, tr_g, lv_g, m_g = gated.rollout(s1)
    assert torch.equal(tr_e.action, tr_g.action)
    assert torch.equal(tr_e.done, tr_g.done)
    assert bool(tr_e.done.any())
    torch.testing.assert_close(tr_e.reward, tr_g.reward, rtol=3e-7,
                               atol=1e-6)
    for k in m_e:
        torch.testing.assert_close(m_e[k], m_g[k], rtol=3e-7, atol=1e-6,
                                   msg=k)
    assert torch.equal(lv_e, lv_g)


def test_route_budget_validation():
    with pytest.raises(ValueError):
        small_cfg(route_budget=0)
    with pytest.raises(ValueError):
        small_cfg(num_sgd_iter=0)


def test_rollout_pool_never_wraps_on_shipped_configs(tmp_path):
    """The derived pool is deep enough that no board replays an instance
    on the shipped configs (three train steps each)."""
    from placement_tpu_torch.agent.trainer import Trainer
    for model_type in ("rectangle", "rectangle_pin",
                       "rectangle_spatial_pin"):
        tr = Trainer(model_type, ppo_config=small_cfg(unroll_length=16),
                     results_root=str(tmp_path), use_tensorboard=False,
                     device="cpu")
        try:
            learner = tr.learner
            state = learner.init(torch.Generator().manual_seed(0))
            for _ in range(3):
                state, metrics = learner.train_step(state)
                assert int(metrics["pool_wraps"]) == 0, model_type
                assert int(metrics["episodes_this_iter"]) > 0
        finally:
            tr.close()


def test_pool_wraps_detects_undersized_pool():
    """An undersized pool shows in ``pool_wraps``."""
    learner = _learner(PORT_PIN, "rectangle_pin",
                       small_cfg(unroll_length=16, reset_pool_size=2))
    state = learner.init(torch.Generator().manual_seed(0))
    wraps = 0
    for _ in range(3):
        state, metrics = learner.train_step(state)
        wraps += int(metrics["pool_wraps"])
    assert wraps > 0


def test_train_step_factorized():
    learner = _learner(PORT_PIN, "rectangle_factorized_pin", small_cfg())
    state = learner.init(torch.Generator().manual_seed(0))
    state, metrics = learner.train_step(state)
    assert math.isfinite(float(metrics["policy_loss"]))
    assert math.isfinite(float(metrics["kl"]))


def test_episode_returns_not_truncated_by_window():
    """Returns accumulate across rollout windows: a 10x10 square episode
    packs ~17-25 unit rewards, far more than the 8-step window, so the
    mean full-episode return and length exceed 12."""
    params = EnvParams(variant=Variant.SQUARE, height=10, width=10,
                       component_n=2)
    learner = _learner(params, "square", small_cfg(num_envs=16))
    state = learner.init(torch.Generator().manual_seed(0))
    means, counts, lens = [], [], []
    for _ in range(6):
        state, metrics = learner.train_step(state)
        means.append(float(metrics["episode_reward_mean"]))
        counts.append(int(metrics["episodes_this_iter"]))
        lens.append(float(metrics["episode_len_mean"]))
    total = sum(counts)
    assert total > 0
    assert sum(m * c for m, c in zip(means, counts)) / total > 12, (
        means, counts)
    assert sum(n * c for n, c in zip(lens, counts)) / total > 12, (
        lens, counts)


def test_ppo_learns_on_tiny_square():
    """40 iterations on the 6x6 square env lift the episode return from
    the ~6.2 random level toward the optimal 9 (JAX's thresholds)."""
    params = EnvParams(variant=Variant.SQUARE, height=6, width=6,
                       component_n=2)
    cfg = PPOConfig(num_envs=32, unroll_length=16, minibatch_size=64,
                    num_sgd_iter=8, lr=3e-4)
    learner = _learner(params, "square", cfg)
    state = learner.init(torch.Generator().manual_seed(0))
    rews = []
    for _ in range(40):
        state, m = learner.train_step(state)
        rews.append(float(m["episode_reward_mean"]))
    first, last = np.mean(rews[:5]), np.mean(rews[-5:])
    assert last > first + 1.0, (first, last)
    assert last > 7.5, rews[-5:]
