"""The port's pooled auto-reset (``placement_tpu_torch.env.pooled``) against
the JAX package's (template: ``tests/tooling/test_pooled.py``).

* JAX's states and pool (``make_pool``) are carried across with
  ``state_from_numpy``; under the same explicit actions, with invalid ones
  mixed in so that episodes end at different steps, ``step_autoreset_pooled``
  equals JAX's field by field for 12 steps through several episode ends
  (integer fields, masks and counts exactly; rewards and info within 1e-5,
  f32 sums in another order), ungated and gated.
* Gated routing equals eager on the port: crossings exact, wirelength and
  reward within one f32 ulp, through the none-done, compacted and
  full-batch branches and at the budget extremes; a non-pin variant
  ignores the budget.
* ``rollout_chunk``'s wrap counter counts the boards that replayed a pool
  entry, as JAX's does.
* The random policy's mean return through ``rollout_chunk`` sits within 4
  combined standard errors of JAX ``simulate``'s
  (``tests/fixtures/torch_stepper_means.json``).
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from placement_tpu.agent import ppo as jax_ppo
from placement_tpu.env import core as jax_core
from placement_tpu.env import pooled as jax_pooled
from placement_tpu.utils.config import load_experiment
from placement_tpu_torch.agent.random_policy import random_action
from placement_tpu_torch.env import core, pooled
from placement_tpu_torch.env.types import (
    STATE_FIELDS, EnvState, state_from_numpy)
from tests.parity.test_reference_parity import PARAMS as PARITY
from tests.test_torch_core import _legal_actions, port_params
from tests.test_torch_random_policy import FIXTURE

N_SE = 4.0
#: JAX params of the cases: the flagship (centroid, 5-step episodes), the
#: parity config (2..5 pins per net, "both"), square (no pins)
CASES = {
    "flagship": lambda: load_experiment("rectangle_pin")[0],
    "parity_pin": lambda: PARITY["pin"],
    "square": lambda: load_experiment("square")[0],
}


def random_fn(gen, params, states):
    return random_action(gen, params, states.action_mask)


@functools.lru_cache(maxsize=None)
def _jax_fns(case, route_budget):
    p = CASES[case]()
    reset = jax.jit(jax.vmap(lambda k: jax_core.reset(p, k)))
    step = jax.jit(lambda s, a, pool, c: jax_pooled.step_autoreset_pooled(
        p, s, a, pool, c, route_budget=route_budget))
    return p, reset, step


def _numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}


def _legal_or_bad(rng, mask, t):
    """Legal actions, except one board a step plays off the board (an
    invalid action ends its episode early)."""
    a = _legal_actions(rng, mask)
    a[t % len(a)] = (0, -5, -5)
    return a


@pytest.mark.parametrize("case,route_budget", [
    ("flagship", None), ("flagship", 2), ("parity_pin", None),
    ("parity_pin", 3), ("square", None)])
def test_pooled_step_matches_jax_field_by_field(case, route_budget):
    jp, reset_j, step_j = _jax_fns(case, route_budget)
    params = port_params(jp)
    batch, k = 8, 4
    jstates = reset_j(jax.random.split(jax.random.PRNGKey(1), batch))
    jpool = jax_pooled.make_pool(jp, jax.random.PRNGKey(2), k, batch)
    jcounts = jnp.zeros((batch,), jnp.int32)
    states = state_from_numpy(_numpy(jstates), "cpu")
    pool = state_from_numpy(_numpy(jpool), "cpu")
    assert tuple(pool.grid.shape[:2]) == (k, batch)
    counts = torch.zeros((batch,), dtype=torch.int32)
    rng = np.random.default_rng(3)
    ended = 0
    for t in range(12):
        a = _legal_or_bad(rng, np.asarray(jstates.action_mask), t)
        jstates, jcounts, jr, jd, jinfo = step_j(jstates, jnp.asarray(a),
                                                 jpool, jcounts)
        states, counts, r, d, info = pooled.step_autoreset_pooled(
            params, states, torch.as_tensor(a), pool, counts, route_budget)
        want = _numpy(jstates)
        for f in STATE_FIELDS:
            got = getattr(states, f).numpy()
            if f.startswith("info_"):
                np.testing.assert_allclose(got, want[f], rtol=1e-5,
                                           atol=1e-5, err_msg=f)
            else:
                np.testing.assert_array_equal(got, want[f], err_msg=f)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-5)
        assert set(info) == set(jinfo)
        for key in info:
            np.testing.assert_allclose(info[key].numpy(),
                                       np.asarray(jinfo[key]), rtol=1e-5,
                                       atol=1e-5, err_msg=key)
        ended += int(d.sum())
    assert ended >= batch and int(counts.max()) >= 2


def _ulp_close(a, b):
    """Within one f32 ulp of the larger magnitude."""
    a, b = a.numpy(), b.numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()


@pytest.mark.parametrize("budget", [1, 2, 8])
def test_gated_routing_matches_eager(budget):
    """Through the none-done branch (pre-terminal steps), the compacted one
    (a lone invalid-action finisher) and the full-batch fallback (8 boards
    finishing in lockstep): dones, states and counts equal, crossings
    exact, wirelength and reward within one f32 ulp."""
    params = port_params(CASES["flagship"]())
    batch = 8
    gen = torch.Generator().manual_seed(10)
    start = core.reset(params, gen, batch, "cpu")
    pool = pooled.make_pool(params, gen, 6, batch)
    s_e = s_g = start
    c_e = c_g = torch.zeros((batch,), dtype=torch.int32)
    saw = set()
    for i in range(12):
        a = random_action(gen, params, s_e.action_mask)
        if i == 2:
            a[0] = torch.tensor([0, -5, -5])          # a lone finisher
        s_e, c_e, r_e, d_e, i_e = pooled.step_autoreset_pooled(
            params, s_e, a, pool, c_e)
        s_g, c_g, r_g, d_g, i_g = pooled.step_autoreset_pooled(
            params, s_g, a, pool, c_g, route_budget=budget)
        assert torch.equal(d_e, d_g) and torch.equal(c_e, c_g)
        for f in STATE_FIELDS:
            if f != "info_wirelength":
                assert torch.equal(getattr(s_e, f), getattr(s_g, f)), f
        assert torch.equal(i_e["num_intersections"], i_g["num_intersections"])
        _ulp_close(i_e["wirelength"], i_g["wirelength"])
        _ulp_close(s_e.info_wirelength, s_g.info_wirelength)
        _ulp_close(r_e, r_g)
        n = int(d_e.sum())
        saw.add("none" if n == 0 else "compact" if n <= budget else "full")
    assert "none" in saw and "compact" in saw
    assert "full" in saw or budget == batch


def test_gated_budget_extremes_reproduce_the_eager_chunk():
    """budget=1 (compaction nearly always falls back) and budget=batch
    (never falls back) reproduce the eager chunk's totals from the same
    generator state; a non-pin variant ignores route_budget."""
    params = port_params(CASES["flagship"]())
    batch, chunk = 8, 12
    states = core.reset(params, torch.Generator().manual_seed(20), batch,
                        "cpu")

    def run(budget):
        fn = pooled.rollout_chunk(params, random_fn, chunk, pool_size=4,
                                  route_budget=budget, device="cpu")
        return fn(states, torch.Generator().manual_seed(21))

    _, r0, d0, _ = run(None)
    for budget in (1, batch):
        _, r, d, _ = run(budget)
        np.testing.assert_allclose(float(r), float(r0), rtol=1e-6)
        assert int(d) == int(d0) == batch * 2     # two 5-step episodes

    sq = port_params(CASES["square"]())
    sq_states = core.reset(sq, torch.Generator().manual_seed(22), 4, "cpu")
    fn = pooled.rollout_chunk(sq, random_fn, 6, pool_size=2, route_budget=2,
                              device="cpu")
    _, r_sq, _, _ = fn(sq_states, torch.Generator().manual_seed(23))
    assert math.isfinite(float(r_sq))


def test_rollout_chunk_counts_episodes_and_wraps():
    """Flagship episodes are 5 placements: a 10-step chunk ends 2 a board
    with no wrap from a pool of 4; a 25-step chunk with a pool of 2
    replays entries on every board (JAX ``test_pooled.py:170``)."""
    params = port_params(CASES["flagship"]())
    batch = 4
    states = core.reset(params, torch.Generator().manual_seed(8), batch,
                        "cpu")
    fn = pooled.rollout_chunk(params, random_fn, 10, pool_size=4,
                              device="cpu")
    out, r, d, wrapped = fn(states, torch.Generator().manual_seed(9))
    assert isinstance(out, EnvState) and math.isfinite(float(r))
    assert int(d) == batch * 10 // 5 and int(wrapped) == 0
    fn = pooled.rollout_chunk(params, random_fn, 25, pool_size=2,
                              device="cpu")
    _, _, d, wrapped = fn(states, torch.Generator().manual_seed(9))
    assert int(d) == batch * 25 // 5
    assert int(wrapped) == batch


@pytest.mark.parametrize("name", ["square", "rectangle", "rectangle_pin",
                                  "rectangle_spatial_pin"])
def test_default_pool_size_is_jax_formula(name):
    jp = load_experiment(name)[0]
    for chunk in (8, 32, 50):
        assert pooled.default_pool_size(port_params(jp), chunk) == \
            jax_ppo.default_pool_size(jp, chunk)


def test_random_pooled_mean_return_matches_jax_simulate():
    """Four chunks of 50 steps x 128 boards (5120 flagship episodes):
    their mean return within 4 combined standard errors of JAX
    ``simulate``'s (the standard error of the port's from the chunk
    means)."""
    want = json.loads(FIXTURE.read_text())["flagship"]
    params = port_params(CASES["flagship"]())
    gen = torch.Generator().manual_seed(30)
    states = core.reset(params, gen, 128, "cpu")
    fn = pooled.rollout_chunk(params, random_fn, 50,
                              pooled.default_pool_size(params, 50),
                              route_budget=32, device="cpu")
    means = []
    for _ in range(4):
        states, r, d, wrapped = fn(states, gen)
        assert int(wrapped) == 0 and int(d) == 128 * 10
        means.append(float(r) / int(d))
    mean = float(np.mean(means))
    se = float(np.std(means, ddof=1) / math.sqrt(len(means)))
    both = math.hypot(se, want["se"])
    assert abs(mean - want["mean"]) <= N_SE * both, (mean, se, want)


def test_rollout_chunk_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params = port_params(CASES["flagship"]())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pooled.rollout_chunk(params, random_fn, 5, 2)
