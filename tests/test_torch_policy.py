"""The port's policy (``placement_tpu_torch.agent.policy``), its config
loader and its entry point against the JAX package's, and the fixture that
holds the card to JAX's numbers.

* ``Policy.act`` with Flax weights carried across (``Policy.load_flax``):
  greedy actions equal JAX's, logp and value within 1e-5, for a joint-logit
  preset and the factorized one in both orders; sampled actions legal.
* The flagship model on the fixture's 64 JAX observations: logits, value,
  greedy actions and their logp as JAX recorded them (1e-5).
* The flagship policy (carried weights, sampling) acting through
  ``pooled.rollout_chunk``: its mean episode return within 4 combined
  standard errors of JAX's recorded one.
* ``load_experiment`` gives JAX's ``EnvParams`` and ``ModelConfig`` for every
  model type, and ``save_config`` JAX's JSON.

Running this file records ``tests/fixtures/torch_policy_flagship.npz``
(about 0.5 MB, most of it the logits
head's kernel): the Flax variables of the flagship model (seed
0), 64 JAX observations (reset, then 0-4 random steps), JAX's logits,
value, greedy actions and their logp on them, and the mean and standard
error of the episode return of that policy sampling its actions in JAX's
pooled rollout (``Policy.act`` -> ``pooled.step_autoreset_pooled``, 256
boards x 25 steps, 1280 episodes):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_policy.py
"""

import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from placement_tpu.agent.policy import Policy as JaxPolicy
from placement_tpu.agent.policy import model_config_for as jax_model_config
from placement_tpu.agent.ppo import default_pool_size
from placement_tpu.agent.random_policy import random_action as jax_random
from placement_tpu.env import core as jax_core
from placement_tpu.env import pooled as jax_pooled
from placement_tpu.utils import config as jax_config
from placement_tpu_torch import graft_entry
from placement_tpu_torch.agent.policy import Policy
from placement_tpu_torch.env import core, pooled
from placement_tpu_torch.models import convert
from placement_tpu_torch.utils import config
from tests.agent.test_models import PIN
from tests.test_torch_core import port_params
from tests.test_torch_models import (
    flax_variables, jax_obs, port_config, torch_obs)

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_policy_flagship.npz")
TOL = 1e-5
N_SE = 4.0
#: the fixture's recording: boards and random steps of the observations,
#: and the pooled rollout's boards and steps
OBS_BOARDS, ROLL_BOARDS, ROLL_STEPS = 64, 256, 25


def _flagship():
    params, cfg, _ = jax_config.load_experiment("rectangle_pin")
    return params, cfg


def fixture():
    """The fixture as (variables tree, obs dict, the rest) of numpy
    arrays."""
    data = dict(np.load(FIXTURE))
    variables = convert.unflatten({k[4:]: v for k, v in data.items()
                                   if k.startswith("var/")})
    obs = {k[4:]: v for k, v in data.items() if k.startswith("obs/")}
    rest = {k: v for k, v in data.items() if "/" not in k}
    return variables, obs, rest


def _fixture_obs(params):
    """The fixture's observations: ``OBS_BOARDS`` JAX boards from reset,
    board i after i % 5 random legal steps."""
    reset_b, step_b, obs_b = jax_core.make_batched(params)
    key = jax.random.PRNGKey(4)
    states = reset_b(jax.random.split(key, OBS_BOARDS))
    keep = states
    for i in range(4):
        a = jax_random(jax.random.fold_in(key, i), params,
                       states.action_mask)
        states, _, _, _ = step_b(states, a)
        take = (np.arange(OBS_BOARDS) % 5) == i + 1
        keep = jax.tree_util.tree_map(
            lambda n, o: jnp.where(take.reshape((-1,) + (1,) * (n.ndim - 1)),
                                   n, o), states, keep)
    return {k: np.asarray(v) for k, v in obs_b(keep).items()}


def _jax_rollout_returns(params, cfg, variables):
    """Episode returns of the policy sampling its actions through JAX's
    pooled auto-reset (the rollout of ``agent/ppo.py:179-247``)."""
    pol = JaxPolicy(params, cfg)
    pool_size = default_pool_size(params, ROLL_STEPS)
    key = jax.random.PRNGKey(6)
    states = jax.vmap(lambda k: jax_core.reset(params, k))(
        jax.random.split(key, ROLL_BOARDS))
    pool = jax_pooled.make_pool(params, jax.random.PRNGKey(7), pool_size,
                                ROLL_BOARDS)

    @jax.jit
    def step(states, counts, k):
        obs = jax.vmap(lambda s: jax_core.observe(params, s))(states)
        action, _, _, _ = pol.act(variables, obs, k)
        return jax_pooled.step_autoreset_pooled(
            params, states, action, pool, counts,
            route_budget=ROLL_BOARDS // 4)

    counts = jnp.zeros((ROLL_BOARDS,), jnp.int32)
    returns = []
    for t in range(ROLL_STEPS):
        states, counts, reward, done, _ = step(states, counts,
                                               jax.random.fold_in(key, t))
        # flagship rewards are terminal only: a done step's reward is the
        # episode's return
        returns.append(np.asarray(reward)[np.asarray(done)])
    assert int(np.sum(np.asarray(counts) > pool_size)) == 0
    return np.concatenate(returns)


def record():
    params, cfg = _flagship()
    obs = _fixture_obs(params)
    variables = flax_variables(cfg, params, obs, seed=0)
    pol = JaxPolicy(params, cfg)
    out = pol.model.apply(variables, obs, train=False)
    greedy, logp, _, _ = pol.act(variables, obs, jax.random.PRNGKey(0),
                                 deterministic=True)
    ret = _jax_rollout_returns(params, cfg, variables)
    np.savez_compressed(
        FIXTURE,
        **{f"var/{k}": v for k, v in convert.flatten(variables).items()},
        **{f"obs/{k}": v for k, v in obs.items()},
        logits=np.asarray(out["logits"]), value=np.asarray(out["value"]),
        greedy=np.asarray(greedy), greedy_logp=np.asarray(logp),
        rollout_mean=np.float64(ret.mean()),
        rollout_se=np.float64(ret.std(ddof=1) / math.sqrt(len(ret))),
        rollout_episodes=np.int64(len(ret)))
    return {"episodes": len(ret), "mean": float(ret.mean())}


# ---------------------------------------------------------------------------
# The fixture
# ---------------------------------------------------------------------------

def test_fixture_is_fresh():
    """Flax ``init`` at seed 0 on the stored observations gives the stored
    variables, and the JAX model on them the stored outputs."""
    params, cfg = _flagship()
    variables, obs, rest = fixture()
    assert obs["grid"].shape == (OBS_BOARDS, params.height, params.width)
    fresh = convert.flatten(flax_variables(cfg, params, obs, seed=0))
    stored = convert.flatten(variables)
    assert set(fresh) == set(stored)
    for k in fresh:
        np.testing.assert_array_equal(fresh[k], stored[k], err_msg=k)
    out = JaxPolicy(params, cfg).model.apply(variables, obs, train=False)
    np.testing.assert_allclose(np.asarray(out["logits"]), rest["logits"],
                               rtol=TOL, atol=TOL)
    assert int(rest["rollout_episodes"]) == ROLL_BOARDS * ROLL_STEPS // 5
    assert math.isfinite(float(rest["rollout_mean"]))
    assert 0 < float(rest["rollout_se"]) < 0.1


def test_flagship_policy_matches_the_fixture():
    params, cfg = _flagship()
    variables, obs, rest = fixture()
    pol = Policy(port_params(params), port_config(cfg), "cpu")
    pol.load_flax(variables)
    t_obs = torch_obs(obs)
    with torch.no_grad():
        out = pol.model(t_obs)
    np.testing.assert_allclose(out["logits"].numpy(), rest["logits"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out["value"].numpy(), rest["value"],
                               rtol=TOL, atol=TOL)
    action, logp, value, logits = pol.act(t_obs, torch.Generator(),
                                          deterministic=True)
    assert action.dtype == torch.int32
    np.testing.assert_array_equal(action.numpy(), rest["greedy"])
    np.testing.assert_allclose(logp.numpy(), rest["greedy_logp"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(value.numpy(), rest["value"], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("model_type,order", [
    ("rectangle_pin", "orientation"),
    ("rectangle_factorized_pin", "orientation"),
    ("rectangle_factorized_pin", "coordinates")])
def test_act_matches_jax(model_type, order):
    """Greedy ``act`` equals JAX's (actions exactly; logp, value and the
    distribution inputs within 1e-5); sampled actions are legal."""
    jax_cfg = jax_model_config(PIN, model_type, factorization=order)
    _, obs = jax_obs(PIN, b=16, steps=1)
    variables = flax_variables(jax_cfg, PIN, obs)
    jpol = JaxPolicy(PIN, jax_cfg)
    want = jpol.act(variables, obs, jax.random.PRNGKey(0), deterministic=True)
    pol = Policy(port_params(PIN), port_config(jax_cfg), "cpu")
    pol.load_flax(variables)
    got = pol.act(torch_obs(obs), torch.Generator(), deterministic=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    mask = obs["action_mask"]
    gen = torch.Generator().manual_seed(1)
    for _ in range(5):
        a = pol.act(torch_obs(obs), gen)[0].numpy()
        assert mask[np.arange(len(a)), a[:, 0], a[:, 1], a[:, 2]].all()


def test_flagship_policy_rollout_matches_jax():
    """The carried flagship policy sampling through ``pooled.rollout_chunk``
    (2 chunks of 50 steps x 128 boards, 2560 episodes): its mean episode
    return within 4 combined standard errors of the fixture's."""
    params, cfg = _flagship()
    variables, _, rest = fixture()
    p = port_params(params)
    pol = Policy(p, port_config(cfg), "cpu").load_flax(variables)
    gen = torch.Generator().manual_seed(8)
    states = core.reset(p, gen, 128, "cpu")
    fn = pooled.rollout_chunk(p, pol.policy_fn(), 50,
                              pooled.default_pool_size(p, 50),
                              route_budget=32, device="cpu")
    means = []
    for _ in range(2):
        states, r, d, wrapped = fn(states, gen)
        assert int(wrapped) == 0 and int(d) == 128 * 10
        means.append(float(r) / int(d))
    mean = float(np.mean(means))
    # chunk means are 1280 episodes each; their spread bounds the port's
    # standard error
    se = float(np.std(means, ddof=1) / math.sqrt(len(means)))
    both = math.hypot(se, float(rest["rollout_se"]))
    assert abs(mean - float(rest["rollout_mean"])) <= N_SE * both, (
        mean, se, float(rest["rollout_mean"]), float(rest["rollout_se"]))


# ---------------------------------------------------------------------------
# Config, entry point, devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", sorted(config.MODEL_TYPES))
def test_load_experiment_matches_jax(model_type, tmp_path):
    jp, jcfg, jraw = jax_config.load_experiment(model_type)
    p, cfg, raw = config.load_experiment(model_type)
    assert p == port_params(jp)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert raw == jraw
    config.save_config(str(tmp_path / "port.json"), p, cfg)
    jax_config.save_config(str(tmp_path / "jax.json"), jp, jcfg)
    port_json = json.loads((tmp_path / "port.json").read_text())
    jax_json = json.loads((tmp_path / "jax.json").read_text())
    assert port_json == jax_json


def test_entry_is_the_flagship_forward_step():
    fn, (model, obs) = graft_entry.entry("cpu")
    logits, value = fn(model, obs)
    assert logits.shape == (16, 400) and value.shape == (16,)
    assert torch.isfinite(value).all()
    legal = obs["action_mask"].reshape(16, -1) > 0
    assert torch.isfinite(logits[legal]).all()
    assert (logits[~legal] < -1e38).all()


def test_load_flax_rejects_another_presets_weights():
    params, cfg = _flagship()
    variables, _, _ = fixture()
    other = Policy(port_params(params),
                   port_config(cfg).__class__(
                       **{**dataclasses.asdict(port_config(cfg)),
                          "model_type": "rectangle_pin_attn_component"}),
                   "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        other.load_flax(variables)


@pytest.mark.parametrize("call", [
    lambda p, c: Policy(p, c),
    lambda p, c: graft_entry.entry(),
])
def test_policy_entry_points_default_to_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p, c, _ = config.load_experiment("rectangle_pin")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(p, c)


if __name__ == "__main__":
    print(record())
