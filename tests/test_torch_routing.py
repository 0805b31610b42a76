"""The port's routing reward (``placement_tpu_torch.env.routing``) against
the JAX package's ``placement_tpu.env.routing``.

* The routing goldens of ``tests/pin_environment/test_routing.py`` (the
  reference's test_env.py values) run against the port.
* 64 random terminal pin tables per geometry (the flagship, the parity
  recordings' ``_PIN_KW`` and the web app's 2..6 pins per net) go through one
  jitted JAX function per geometry that returns every piece: centroid and
  beam segments, crossings and wirelengths, and the terminal reward of each
  reward type. Segments (so the beam paths) and crossings are equal
  exactly; wirelength and reward agree to 1e-6 relative (the f32 terms are
  summed in another order; the worst seen is below 2.5e-7).
* The f64 path (``route_dtype=torch.float64``) equals the JAX module under
  ``jax.enable_x64``, the reference's rounding, exactly on segments and
  crossings.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from placement_tpu.env import routing as jax_routing
from placement_tpu.env.types import EnvParams as JaxParams
from placement_tpu.env.types import Variant as JaxVariant
from placement_tpu_torch.env import routing
from placement_tpu_torch.env.types import EnvParams, Variant

F32, F64 = torch.float32, torch.float64
REL_TOL = 1e-6

#: tests/parity/test_reference_parity.py's _PIN_KW (the recorded geometry)
PARITY_KW = dict(height=10, width=10, net_distribution=2, pin_spread=2,
                 min_component_w=2, max_component_w=3,
                 min_component_h=1, max_component_h=3,
                 max_num_components=6, min_num_components=3,
                 min_num_nets=2, max_num_nets=4,
                 max_num_pins_per_net=5, min_num_pins_per_net=2,
                 reward_beam_width=2,
                 weight_wirelength=0.5, weight_num_intersections=0.5)
FLAGSHIP_KW = dict(min_num_nets=3, max_num_nets=3, min_num_pins_per_net=6,
                   max_num_pins_per_net=6)
GEOMETRIES = {
    "flagship": FLAGSHIP_KW,
    "parity": PARITY_KW,
    "varpin_web": dict(FLAGSHIP_KW, min_num_pins_per_net=2),
}
REWARDS = ("centroid", "beam", "both")


def _params(kw, reward="both"):
    kw = dict(kw, reward_type=reward)
    return (EnvParams(variant=Variant.PIN, **kw),
            JaxParams(variant=JaxVariant.PIN, **kw))


# ---------------------------------------------------------------------------
# Goldens (tests/pin_environment/test_routing.py, reference test_env.py)
# ---------------------------------------------------------------------------

def _segs(nets):
    """nets: lists of ((x1, y1), (x2, y2)) -> ([1, N, S, 4], valid)."""
    n, s = len(nets), max(len(net) for net in nets)
    segs = torch.zeros((1, n, s, 4), dtype=F32)
    valid = torch.zeros((1, n, s), dtype=torch.bool)
    for i, net in enumerate(nets):
        for j, (a, b) in enumerate(net):
            segs[0, i, j] = torch.tensor([*a, *b], dtype=F32)
            valid[0, i, j] = True
    return segs, valid


@pytest.mark.parametrize("l1,l2,want", [
    (((1, 1), (3, 3)), ((1, 3), (1, 5)), False),   # test_env.py:40-44
    (((1, 1), (3, 3)), ((1, 3), (2, 1)), True),    # test_env.py:47-51
    (((0, 0), (1, 1)), ((1, 1), (2, 0)), True),    # shared endpoint
    (((0, 0), (1, 1)), ((0, 1), (1, 2)), False),   # parallel
])
def test_intersection_goldens(l1, l2, want):
    a = torch.tensor([*l1[0], *l1[1]], dtype=F32)
    b = torch.tensor([*l2[0], *l2[1]], dtype=F32)
    assert bool(routing._pairwise_intersect(a, b)) == want
    assert bool(routing._pairwise_intersect_ref_float(
        a.double(), b.double())) == want


FOUR_NETS = [[((1, 1), (3, 3))], [((2, 1), (0, 3))], [((2, 3), (0, 1))],
             [((3, 2), (1, 3))]]


@pytest.mark.parametrize("nets,want", [
    (FOUR_NETS, 4),                                        # test_env.py:54-68
    ([[((4, 4), (3, 5))], [((3, 4), (4, 5))]], 1),         # test_env.py:71-86
])
def test_crossing_count_goldens(nets, want):
    segs, valid = _segs(nets)
    assert routing.count_crossings(segs, valid).tolist() == [want]
    assert routing.count_crossings(segs.double(), valid).tolist() == [want]


def _table(params, pins):
    p = params.max_pins
    t = torch.full((3, 1, p), -1, dtype=torch.int32)
    for i, pin in enumerate(pins):
        t[:, 0, i] = torch.tensor(pin)
    return routing.net_pin_table(params, t[0], t[1], t[2])


PARAMS_10 = EnvParams(variant=Variant.PIN, height=10, width=10,
                      min_component_w=2, max_component_w=4,
                      min_component_h=2, max_component_h=4,
                      max_num_components=4, min_num_components=2,
                      min_num_nets=2, max_num_nets=2,
                      min_num_pins_per_net=2, max_num_pins_per_net=5)


def _segset(segs, valid):
    s, v = segs.reshape(-1, 4).tolist(), valid.reshape(-1).tolist()
    return {tuple(round(c, 5) for c in seg) for seg, ok in zip(s, v) if ok}


def test_route_pins_centroid_golden():
    # test_env.py:104-123
    pos, mask, _ = _table(PARAMS_10, [(0, 0, 0), (0, 1, 0), (2, 2, 1),
                                      (3, 3, 1), (4, 4, 1)])
    segs, valid, scaled, scale = routing.centroid_route(pos, mask)
    assert _segset(segs, valid) == {(0, 0, 0, 1), (2, 2, 3.0, 3.0),
                                    (3, 3, 3.0, 3.0), (4, 4, 3.0, 3.0)}
    assert _segset(scaled, valid) == {(0, 0, 0, 1), (6, 6, 9.0, 9.0),
                                      (9, 9, 9.0, 9.0), (12, 12, 9.0, 9.0)}
    assert scale[0].tolist() == [1.0, 3.0]


def test_pin_outlier_golden():
    # test_env.py:126-133
    pos, mask, _ = _table(PARAMS_10, [(0, 0, 0), (0, 1, 0), (1, 0, 0),
                                      (3, 3, 0)])
    idx = routing.pin_outlier_index(pos[:, 0], mask[:, 0])
    assert pos[0, 0, int(idx[0])].tolist() == [3.0, 3.0]


@pytest.mark.parametrize("bw,want", [
    (4, [(0, 0), (0, 1), (1, 0), (1, 1), (2, 2)]),     # test_env.py:136-144
    # heapq's lexicographic tie-break on equal path costs, :147-155
    (2, [(0, 0), (0, 1), (1, 1), (1, 0), (2, 2)]),
])
def test_beam_search_goldens(bw, want):
    pts = [(0, 0), (2, 2), (0, 1), (1, 0), (1, 1)]
    pos = torch.tensor([pts], dtype=F32)
    mask = torch.ones((1, len(pts)), dtype=torch.bool)
    path = routing.beam_search_net(pos, mask, bw, torch.zeros(1))
    assert [pts[i] for i in path[0].tolist() if i >= 0] == want


def test_beam_route_golden():
    # test_env.py:158-178
    pos, mask, _ = _table(PARAMS_10, [(3, 3, 0), (3, 4, 0), (0, 0, 1),
                                      (0, 1, 1), (1, 0, 1), (1, 1, 1),
                                      (2, 2, 1)])
    segs, valid = routing.beam_route(PARAMS_10, pos, mask, 2)
    assert _segset(segs, valid) == {(3, 3, 3, 4), (2, 2, 1, 1),
                                    (1, 1, 0, 1), (0, 1, 0, 0), (0, 0, 1, 0)}


def test_wirelength_golden():
    # test_env.py:181-183
    segs, valid = _segs([[((3, 1), (2, 2)), ((1, 2), (2, 2)),
                          ((3, 3), (2, 2))]])
    for dtype in (F32, F64):
        wl = float(routing.wirelength(segs.to(dtype), valid)[0])
        assert math.isclose(wl, 1 + 2 * math.sqrt(2), rel_tol=1e-6)


# ---------------------------------------------------------------------------
# Random terminal tables against the JAX module
# ---------------------------------------------------------------------------

def _tables(params, batch, seed):
    """Terminal pin tables (pax, pay, pnet) int32 [B, P] and a placed-all
    flag per board (False: the penalty branch): 2..max nets of
    min..max pins at random cells (so shared endpoints), some boards
    collinear, some with their pins in shuffled table order and padding in
    between (net_pin_table ranks pins by table order, not position)."""
    rng = np.random.default_rng(seed)
    n_max, p = params.max_num_nets, params.max_pins
    out = np.full((3, batch, p), -1, np.int32)
    for b in range(batch):
        nn = rng.integers(params.min_num_nets, n_max + 1)
        counts = rng.integers(params.min_num_pins_per_net,
                              params.max_num_pins_per_net + 1, nn)
        k = int(counts.sum())
        cells = np.stack([rng.integers(0, params.height, k),
                          rng.integers(0, params.width, k),
                          np.repeat(np.arange(nn), counts)])
        if b % 5 == 1:
            cells[1] = 3                            # all on one row
        if b % 5 == 2:
            cells[0] = 2 * (np.arange(k) % 2)       # two columns
        slots = np.arange(k)
        if b % 3 == 0:
            slots = np.sort(rng.choice(p, k, replace=False))
            cells = cells[:, rng.permutation(k)]
        out[:, b, slots] = cells
    return (*out, np.arange(batch) % 7 != 3)


def _jax_pieces(jp, pax, pay, pnet, placed):
    """One board's every routing piece (JAX), vmapped by the caller."""
    pos, mask, counts = jax_routing.net_pin_table(jp, pax, pay, pnet)
    c_segs, c_valid, c_scaled, c_scale = jax_routing.centroid_route(pos, mask)
    if c_segs.dtype == jnp.float64:
        c_int = jax_routing.count_crossings(c_segs, c_valid)
    else:
        c_int = jax_routing.count_crossings(c_scaled, c_valid, c_scale)
    b_segs, b_valid = jax_routing.beam_route(jp, pos, mask,
                                             jp.reward_beam_width)
    out = dict(pos=pos, mask=mask, counts=counts, c_segs=c_segs,
               c_valid=c_valid, c_scaled=c_scaled, c_scale=c_scale,
               c_int=c_int, c_wl=jax_routing.wirelength(c_segs, c_valid),
               b_segs=b_segs, b_valid=b_valid,
               b_int=jax_routing.count_crossings(b_segs, b_valid),
               b_wl=jax_routing.wirelength(b_segs, b_valid))
    for rt in REWARDS:
        out[rt] = jnp.stack(jax_routing.terminal_reward(
            dataclasses.replace(jp, reward_type=rt), pax, pay, pnet, placed))
    return out


@functools.lru_cache(maxsize=None)
def _jax_fn(geometry):
    _, jp = _params(GEOMETRIES[geometry])
    return jax.jit(jax.vmap(functools.partial(_jax_pieces, jp)))


def _port_pieces(tp, pax, pay, pnet, placed, dtype):
    pos, mask, counts = routing.net_pin_table(tp, pax, pay, pnet, dtype)
    c_segs, c_valid, c_scaled, c_scale = routing.centroid_route(pos, mask)
    if dtype == F64:
        c_int = routing.count_crossings(c_segs, c_valid)
    else:
        c_int = routing.count_crossings(c_scaled, c_valid, c_scale)
    b_segs, b_valid = routing.beam_route(tp, pos, mask, tp.reward_beam_width)
    out = dict(pos=pos, mask=mask, counts=counts, c_segs=c_segs,
               c_valid=c_valid, c_scaled=c_scaled, c_scale=c_scale,
               c_int=c_int, c_wl=routing.wirelength(c_segs, c_valid),
               b_segs=b_segs, b_valid=b_valid,
               b_int=routing.count_crossings(b_segs, b_valid),
               b_wl=routing.wirelength(b_segs, b_valid))
    for rt in REWARDS:
        out[rt] = torch.stack(routing.terminal_reward(
            tp.replace(reward_type=rt), pax, pay, pnet, placed, dtype), dim=1)
    return out


#: compared within REL_TOL; every other piece exactly
_SUMMED = ("c_wl", "b_wl") + REWARDS


def _compare(got, want, exact_sums=False):
    worst = 0.0
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        if k in _SUMMED:
            g = g.reshape(w.shape)
            if exact_sums:
                np.testing.assert_array_equal(g, w, err_msg=k)
            np.testing.assert_allclose(g, w, rtol=REL_TOL, atol=0, err_msg=k)
            nz = w != 0
            worst = max(worst, float(np.max(np.abs(g[nz] / w[nz] - 1),
                                            initial=0.0)))
        else:
            assert g.shape == w.shape, k
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
    return worst


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_random_tables_match_jax(geometry):
    tp, _ = _params(GEOMETRIES[geometry])
    tables = _tables(tp, 64, seed=len(geometry))
    want = _jax_fn(geometry)(*map(jnp.asarray, tables))
    got = _port_pieces(tp, *map(torch.as_tensor, tables), F32)
    worst = _compare(got, want)
    assert worst <= REL_TOL
    # the tables are not trivial: crossings happen, routes differ
    assert int(got["b_int"].sum()) > 0 and int(got["c_int"].sum()) > 0
    assert not torch.equal(got["centroid"], got["beam"])


def _reference_crossings(segs, valid):
    """Cross-net crossings per board by the reference's is_intersect
    (:687-739) evaluated literally in Python floats: the oracle of the f64
    path."""
    out = []
    for s, v in zip(np.asarray(segs, np.float64), np.asarray(valid)):
        n, m, _ = s.shape
        live = [(i, s[i, j].tolist()) for i in range(n) for j in range(m)
                if v[i, j]]
        count = 0
        for a, (na, (x1, y1, x2, y2)) in enumerate(live):
            for nb, (x3, y3, x4, y4) in live[a + 1:]:
                if na == nb:
                    continue
                if ((x1, y1) in ((x3, y3), (x4, y4))
                        or (x2, y2) in ((x3, y3), (x4, y4))):
                    count += 1
                    continue
                det = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
                if det == 0:
                    continue
                p = x1 * y2 - y1 * x2
                q = x3 * y4 - y3 * x4
                x = (p * (x3 - x4) - (x1 - x2) * q) / det
                y = (p * (y3 - y4) - (y1 - y2) * q) / det
                count += (min(x1, x2) <= x <= max(x1, x2)
                          and min(x3, x4) <= x <= max(x3, x4)
                          and min(y1, y2) <= y <= max(y1, y2)
                          and min(y3, y4) <= y <= max(y3, y4))
        out.append(count)
    return np.array(out)


def test_f64_path_matches_jax_x64():
    """``route_dtype=torch.float64`` is the JAX module under x64: the
    reference's float crossing predicate on raw coordinates and f64
    distances (the parity replay's path). Segments, beam paths and beam
    crossings equal JAX's exactly.

    The centroid crossings equal the reference's predicate evaluated
    literally (``_reference_crossings``). XLA contracts its products into
    fused multiply-adds, so on a touching crossing with a fractional
    centroid its f64 crossing point can land an ulp outside the box where
    the reference's lands inside (seen: ((3, 4), (4/3, 5)) x ((0, 1), (3.2,
    4.2)), crossing x = 2.9999999999999996 in the reference): there, and
    only there, the port keeps the reference's count."""
    tp, jp = _params(PARITY_KW)
    tables = _tables(tp, 64, seed=11)
    with jax.enable_x64(True):
        fn = jax.jit(jax.vmap(functools.partial(_jax_pieces, jp)))
        want = fn(*map(jnp.asarray, tables))
        want = {k: np.asarray(v) for k, v in want.items()}
    got = _port_pieces(tp, *map(torch.as_tensor, tables), F64)
    assert got["c_segs"].dtype == F64
    oracle = _reference_crossings(got["c_segs"], got["c_valid"])
    np.testing.assert_array_equal(got["c_int"].numpy(), oracle)
    np.testing.assert_array_equal(
        _reference_crossings(got["b_segs"], got["b_valid"]),
        got["b_int"].numpy())
    xla_off = want["c_int"] != oracle
    assert xla_off.sum() <= 4             # the touching cases are rare
    # where XLA's rounding agrees with the reference, everything is JAX's
    keep = ~xla_off
    _compare({k: v[torch.as_tensor(keep)] for k, v in got.items()},
             {k: v[keep] for k, v in want.items()})
    beam_only = [k for k in want if k.startswith(("b_", "beam", "pos",
                                                  "mask", "counts", "c_s",
                                                  "c_v", "c_wl"))]
    _compare({k: got[k] for k in beam_only}, {k: want[k] for k in beam_only})


def test_sqrt_f64_is_correctly_rounded():
    """The f64 path's square root equals NumPy's (IEEE, correctly rounded)
    where PyTorch's own CPU sqrt is one ulp off: on small integers (sums of
    squared integer offsets) and on random reals."""
    rng = np.random.default_rng(0)
    for x in (np.arange(0, 20000, dtype=np.float64),
              rng.random(200000) * 50,
              (rng.integers(0, 30, 200000) / 3.0) ** 2):
        np.testing.assert_array_equal(
            routing._sqrt_f64(torch.as_tensor(x)).numpy(), np.sqrt(x))
