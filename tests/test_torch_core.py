"""The port's batched stepper (``placement_tpu_torch.env.core``) against the
reference recordings and the JAX package.

1. Recorded-trajectory parity through the port alone: each
   ``tests/parity/fixtures/*.npz`` instance is injected with
   ``env/testing.set_components`` and replayed with
   ``route_dtype=torch.float64`` (the reference's rounding), as strictly as
   ``tests/parity/test_reference_parity.py:219-265``: grid, legal mask,
   placement mask, every recorded observation, reward, done and the
   terminal info. Five seeds per config and the ``pins_feature``
   duplicate-key seeds of ``pin.npz`` run in the fast tier, all 25 in the
   slow one.
2. The production f32 path's terminal rewards on the same recordings stay
   inside the envelope the JAX package measured
   (``test_reference_parity.py:282-328``).
3. JAX and port on the same boards: 32 JAX ``reset`` states per variant,
   carried across with ``state_from_numpy``, play every episode to its end
   through raw ``step`` (no auto-reset: fresh instances come from different
   random streams) under legal actions drawn with numpy. Every state field
   is equal after every step; rewards and info agree to 1e-5 (f32 sums in
   another order); ``observe`` is equal except ``area_ratio`` (1e-6).

Running this file records ``tests/fixtures/torch_stepper_means.json``, the
JAX ``simulate`` means that ``chip_smoke.py`` holds the card to:

    PYTHONPATH=. python tests/test_torch_core.py
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from placement_tpu.env import core as jax_core
from placement_tpu.utils.config import load_experiment
from placement_tpu_torch.env import core, testing
from placement_tpu_torch.env.types import (
    STATE_FIELDS, EnvParams, Variant, state_from_numpy, state_to_numpy)
from tests.parity.test_reference_parity import (
    _F32_MAX_TIE_SEEDS, _F32_TIE_ABS, _F32_TIGHT, _FLOAT_OBS, FIX, N_SEEDS,
    PARAMS, _get, _has, _mask_to_ref)

F32, F64 = torch.float32, torch.float64

#: seeds of pin.npz whose instance puts two pins at one (component,
#: chunk-local id): two nets' pins on one component share their ids, and
#: all_pins_num_feature keeps the pin written last
DUPLICATE_KEY_SEEDS = (1, 3, 7, 8, 9, 11, 12, 13, 15, 16, 17, 19, 20, 21,
                       22, 23, 24)
FAST_SEEDS = range(5)


def port_params(jax_params) -> EnvParams:
    """A JAX ``EnvParams`` as the port's (same fields and values)."""
    kw = {f.name: getattr(jax_params, f.name)
          for f in dataclasses.fields(jax_params)}
    return EnvParams(**{**kw, "variant": Variant(int(kw["variant"]))})


@functools.lru_cache(maxsize=None)
def _fixture(name):
    return dict(np.load(FIX / f"{name}.npz"))


def _cases():
    for name in PARAMS:
        fast = set(FAST_SEEDS)
        if name == "pin":
            fast |= set(DUPLICATE_KEY_SEEDS)
        for seed in range(N_SEEDS):
            marks = () if seed in fast else (pytest.mark.slow,)
            yield pytest.param(name, seed, marks=marks, id=f"{name}-{seed}")


# ---------------------------------------------------------------------------
# 1. Recorded-trajectory parity (f64)
# ---------------------------------------------------------------------------

def _inject(params: EnvParams, data, seed):
    """One board carrying the recorded instance (test_reference_parity.py
    ``_inject``)."""
    state = core.reset(params, torch.Generator().manual_seed(0), 1, "cpu")
    if params.variant == Variant.SQUARE:
        return state
    comps = [testing.ComponentSpec(int(h), int(w), i) for i, (h, w) in
             enumerate(zip(_get(data, seed, "comp_h"),
                           _get(data, seed, "comp_w")))]
    if params.has_pins:
        for rx, ry, pid, cid, nid in zip(
                *(_get(data, seed, k) for k in (
                    "pin_rel_x", "pin_rel_y", "pin_id", "pin_comp",
                    "pin_net"))):
            comps[int(cid)].pins.append(testing.PinSpec(
                int(rx), int(ry), int(pid), int(cid), int(nid)))
    state = testing.set_components(params, state, comps)
    if params.has_pins:
        state = state.replace(num_nets=torch.tensor(
            [int(_get(data, seed, "num_nets"))], dtype=torch.int32))
    return state


def _action(params, a):
    a = np.asarray(a, np.int32)
    if params.variant == Variant.SQUARE:
        a = np.array([0, a[0], a[1]], np.int32)
    return torch.as_tensor(a)[None]


def _assert_obs_parity(params, data, seed, tag, state):
    """The port's observe() against the recorded per-step observations
    (test_reference_parity.py ``_assert_obs_parity``)."""
    compared = 0
    for key, got in core.observe(params, state).items():
        rk = f"{key}@{tag}"
        if not _has(data, seed, rk):
            continue
        want = _get(data, seed, rk)
        got = got[0].numpy()
        msg = f"seed {seed} {rk}"
        if key == "component_grid":
            # rows past the episode's components are zero padding
            n = want.shape[0]
            assert got.shape[1:] == want.shape[1:] and got.shape[0] >= n, msg
            np.testing.assert_array_equal(got[:n].astype(want.dtype), want,
                                          err_msg=msg)
            assert not got[n:].any(), msg
        elif key in _FLOAT_OBS:
            assert got.shape == want.shape, msg
            np.testing.assert_allclose(got.astype(np.float64), want,
                                       rtol=1e-6, atol=1e-6, err_msg=msg)
        else:
            assert got.shape == want.shape, msg
            np.testing.assert_array_equal(got.astype(want.dtype), want,
                                          err_msg=msg)
        compared += 1
    if params.variant != Variant.SQUARE:
        assert compared >= 3, f"seed {seed} @{tag}: obs keys missing"
    return compared


@pytest.mark.parametrize("name,seed", list(_cases()))
def test_recorded_trajectory_parity(name, seed):
    params = port_params(PARAMS[name])
    data = _fixture(name)
    state = _inject(params, data, seed)
    np.testing.assert_array_equal(
        _mask_to_ref(params, state.action_mask[0].numpy()),
        _get(data, seed, "mask_reset"), err_msg="reset mask")
    _assert_obs_parity(params, data, seed, "reset", state)
    actions = _get(data, seed, "actions")
    rewards = _get(data, seed, "rewards")
    dones = _get(data, seed, "dones")
    for t in range(actions.shape[0]):
        state, reward, done, _ = core.step(params, state,
                                           _action(params, actions[t]),
                                           route_dtype=F64)
        np.testing.assert_array_equal(state.grid[0].numpy().astype(np.int8),
                                      _get(data, seed, f"grid{t}"),
                                      err_msg=f"grid@{t}")
        np.testing.assert_array_equal(
            _mask_to_ref(params, state.action_mask[0].numpy()),
            _get(data, seed, f"mask{t}"), err_msg=f"mask@{t}")
        assert bool(done[0]) == bool(dones[t]), f"done@{t}"
        assert np.isclose(float(reward[0]), rewards[t], rtol=1e-5,
                          atol=1e-5), (t, float(reward[0]), rewards[t])
        if _has(data, seed, f"pmask{t}"):
            np.testing.assert_array_equal(
                core.placement_mask(params, state)[0].numpy(),
                _get(data, seed, f"pmask{t}"), err_msg=f"pmask@{t}")
        _assert_obs_parity(params, data, seed, t, state)
    if _has(data, seed, "wirelength"):
        assert np.isclose(float(state.info_wirelength[0]),
                          _get(data, seed, "wirelength"), rtol=1e-5,
                          atol=1e-5)
        assert np.isclose(float(state.info_intersections[0]),
                          _get(data, seed, "intersections"), rtol=1e-5,
                          atol=1e-5)


def test_duplicate_key_seeds_are_named():
    """The seeds of pin.npz on which ``pins_feature`` meets two pins at one
    (component, chunk-local id) are exactly DUPLICATE_KEY_SEEDS, and on each
    the recorded observation keeps the later pin in table order, which the
    port's scatter must reproduce."""
    data = _fixture("pin")
    params = port_params(PARAMS["pin"])
    found = []
    for seed in range(N_SEEDS):
        state = _inject(params, data, seed)
        valid = state.pin_valid[0]
        keys = (state.pin_comp[0] * 100 + state.pin_local[0])[valid].tolist()
        if len(set(keys)) < len(keys):
            found.append(seed)
            num, _ = core.pins_feature(params, state)
            want = _get(data, seed, "all_pins_num_feature@reset")
            np.testing.assert_array_equal(num[0].numpy(), want)
    assert tuple(found) == DUPLICATE_KEY_SEEDS


# ---------------------------------------------------------------------------
# 2. The production f32 path's terminal-reward envelope
# ---------------------------------------------------------------------------

def _stack(states):
    return type(states[0])(**{f: torch.cat([getattr(s, f) for s in states])
                              for f in STATE_FIELDS})


@pytest.mark.parametrize("name", ["pin", "pin_centroid", "pin_spatial",
                                  "pin_beam", "pin_nonsquare", "pin_rot"])
def test_f32_terminal_reward_envelope(name):
    """All 25 recordings at once (a board each) on the f32 path: centroid
    rewards are rounding-tight; beam / "both" may flip near-tie routes on a
    few seeds, within the JAX package's measured envelope; where the reward
    is tight, the crossing count is exact."""
    params = port_params(PARAMS[name])
    data = _fixture(name)
    state = _stack([_inject(params, data, s) for s in range(N_SEEDS)])
    acts = [_get(data, s, "actions") for s in range(N_SEEDS)]
    last = np.array([len(a) - 1 for a in acts])
    final = np.zeros(N_SEEDS, np.float32)
    ints = np.zeros(N_SEEDS, np.float32)
    for t in range(int(last.max()) + 1):
        action = torch.as_tensor(np.stack([
            a[min(t, len(a) - 1)] for a in acts]).astype(np.int32))
        state, reward, _, _ = core.step(params, state, action)
        hit = last == t
        final[hit] = reward.numpy()[hit]
        ints[hit] = state.info_intersections.numpy()[hit]
    tie_seeds = []
    for s in range(N_SEEDS):
        dev = abs(float(final[s]) - float(_get(data, s, "rewards")[-1]))
        if dev <= _F32_TIGHT:
            if _has(data, s, "intersections"):
                assert np.isclose(ints[s], _get(data, s, "intersections"),
                                  atol=1e-6), s
            continue
        assert params.reward_type != "centroid", (s, dev)
        assert dev <= _F32_TIE_ABS, (s, dev)
        tie_seeds.append(s)
    assert len(tie_seeds) <= _F32_MAX_TIE_SEEDS, tie_seeds


# ---------------------------------------------------------------------------
# 3. JAX and port on the same boards, whole episodes
# ---------------------------------------------------------------------------

#: model type (shipped config) or parity config -> variant under test
SAME_BOARDS = {
    "square": "square",
    "rectangle": "rectangle",
    "rectangle_pin": "rectangle_pin",
    "rectangle_spatial_pin": "rectangle_spatial_pin",
    # 2..5 pins per net (capped multinomial), the "both" reward
    "parity_pin": "pin",
}
N_BOARDS = 32


def _jax_params(case):
    if case.startswith("parity_"):
        return PARAMS[SAME_BOARDS[case]]
    return load_experiment(SAME_BOARDS[case])[0]


@functools.lru_cache(maxsize=None)
def _jax_fns(case):
    p = _jax_params(case)
    return (jax.jit(jax.vmap(lambda k: jax_core.reset(p, k))),
            jax.jit(jax.vmap(lambda s, a: jax_core.step(p, s, a))),
            jax.jit(jax.vmap(lambda s: jax_core.observe(p, s))))


def _jax_state_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}


def _legal_actions(rng, mask):
    """One legal (o, x, y) per board of ``mask`` [B, O, H, W] drawn
    uniformly, (0, 0, 0) where none is legal."""
    out = np.zeros((mask.shape[0], 3), np.int32)
    for b, m in enumerate(mask):
        legal = np.argwhere(m)
        if len(legal):
            out[b] = legal[rng.integers(len(legal))]
    return out


def _assert_obs_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k == "all_components_feature":
            np.testing.assert_allclose(g[..., 4], w[..., 4], rtol=1e-6,
                                       atol=0, err_msg=k)
            g, w = np.delete(g, 4, axis=-1), np.delete(w, 4, axis=-1)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)


@pytest.mark.parametrize("case", list(SAME_BOARDS))
def test_same_boards_as_jax(case):
    jp = _jax_params(case)
    params = port_params(jp)
    reset_j, step_j, obs_j = _jax_fns(case)
    jstate = reset_j(jax.random.split(jax.random.PRNGKey(3), N_BOARDS))
    state = state_from_numpy(_jax_state_numpy(jstate), "cpu")
    _assert_obs_equal(core.observe(params, state), obs_j(jstate))
    rng = np.random.default_rng(5)
    steps = 0
    while not bool(np.asarray(jstate.done).all()):
        assert steps <= params.area, "episodes did not end"
        action = _legal_actions(rng, np.asarray(jstate.action_mask))
        jstate, jreward, jdone, jinfo = step_j(jstate, jnp.asarray(action))
        state, reward, done, info = core.step(params, state,
                                              torch.as_tensor(action))
        want = _jax_state_numpy(jstate)
        got = state_to_numpy(state)
        for f in STATE_FIELDS:
            if f.startswith("info_"):
                np.testing.assert_allclose(got[f], want[f], rtol=1e-5,
                                           atol=1e-5, err_msg=f)
            else:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_allclose(reward.numpy(), np.asarray(jreward),
                                   rtol=1e-5, atol=1e-5)
        assert np.array_equal(done.numpy(), np.asarray(jdone))
        assert set(info) == set(jinfo)
        _assert_obs_equal(core.observe(params, state), obs_j(jstate))
        steps += 1
    assert steps >= 3


def test_step_keeps_done_boards_and_counts_steps():
    """A finished board takes an invalid step: grid and cursor stay, done
    stays, ``steps`` still counts (JAX ``core.step``), and a pin board's
    reward is the worst-case penalty."""
    params = port_params(load_experiment("rectangle_pin")[0])
    state = core.reset(params, torch.Generator().manual_seed(1), 4, "cpu")
    state = state.replace(done=torch.tensor([True, False, True, False]))
    action = torch.zeros((4, 3), dtype=torch.int32)
    action[:, 1:] = torch.tensor([[0, 0]])
    legal = state.action_mask[:, 0, 0, 0]
    out, reward, done, info = core.step(params, state, action)
    assert done[0] and done[2]
    assert torch.equal(out.grid[0], state.grid[0])
    assert out.steps.tolist() == [1, 1, 1, 1]
    assert torch.equal(out.cursor[[0, 2]], state.cursor[[0, 2]])
    penalty = -(0.5 * params.max_wirelength / params.wirelength_normalizer
                + 0.5 * params.max_num_intersections
                / params.intersections_normalizer)
    assert np.allclose(reward[[0, 2]].numpy(), penalty, rtol=1e-6)
    assert bool(legal[1]) and out.cursor[1] == 1


# ---------------------------------------------------------------------------
# The card's fixture
# ---------------------------------------------------------------------------

if __name__ == "__main__":
    from tests.test_torch_random_policy import record_stepper_means
    print(record_stepper_means())
