"""The port's routing rewards against the JAX package's.

``placement_tpu.ops.fused_routing`` is plain ``jnp`` (no kernel, no
interpreter), so both sides run directly on the same numpy-seeded terminal
pin tables. The tables are net-grouped as the generator writes them, with
2-pin nets (direct pin-to-pin routes), shared endpoints (coordinates from a
small range collide often) and collinear segments (boards whose pins all lie
on one row or one column). The beam tables add a net without pins and nets
with fewer pins left than the beam is wide.

The JAX beam router is jitted once per beam width and table shape
(``_jax_fn``): its trace grows with about bw^3, so bw <= 3 on the small
tables and bw = 4 once, at the kernel's capacity shape.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from placement_tpu.ops import fused_routing as jax_routing
from placement_tpu.utils.config import load_experiment
from placement_tpu_torch.ops import fused_routing as torch_routing
from placement_tpu_torch.utils.config import load_env_params

# nets of 2..6 pins, 2..3 nets per board
JAX_PARAMS = dataclasses.replace(load_experiment("rectangle_pin")[0],
                                 min_num_pins_per_net=2, min_num_nets=2)
TORCH_PARAMS = load_env_params("rectangle_pin").replace(
    min_num_pins_per_net=2, min_num_nets=2)


def _tables(params, batch, seed, span):
    """Random terminal tables: (pax, pay, pnet, npin[B,1]) int32."""
    rng = np.random.default_rng(seed)
    N, M, P = params.max_num_nets, params.max_num_pins_per_net, params.max_pins
    pax = np.full((batch, P), -1, np.int32)
    pay = np.full((batch, P), -1, np.int32)
    pnet = np.full((batch, P), -1, np.int32)
    npin = np.zeros((batch, 1), np.int32)
    for b in range(batch):
        nn = rng.integers(params.min_num_nets, N + 1)
        counts = rng.integers(2, M + 1, size=nn)
        if b % 4 == 0:
            counts[0] = 2                       # a direct 2-pin route
        n_pins = int(counts.sum())
        pnet[b, :n_pins] = np.repeat(np.arange(nn), counts)
        pax[b, :n_pins] = rng.integers(0, span, n_pins)
        pay[b, :n_pins] = rng.integers(0, span, n_pins)
        if b % 5 == 1:
            pay[b, :n_pins] = 3                 # all collinear on one row
        if b % 5 == 2:
            pax[b, :n_pins] = 2 * (np.arange(n_pins) % 2)   # two columns
        npin[b, 0] = n_pins
    return pax, pay, pnet, npin


@pytest.mark.parametrize("seed,span", [(0, 4), (1, 4), (2, 10), (3, 10),
                                       (4, 3)])
def test_centroid_wl_int_matches_jax(seed, span):
    tables = _tables(JAX_PARAMS, 96, seed, span)
    want_wl, want_int = jax_routing.centroid_wl_int(
        JAX_PARAMS, *map(jnp.asarray, tables))
    got_wl, got_int = torch_routing.centroid_wl_int(
        TORCH_PARAMS, *map(torch.from_numpy, tables))
    # crossings are exact integer arithmetic on both sides
    np.testing.assert_array_equal(got_int.numpy(), np.asarray(want_int))
    assert float(got_int.sum()) > 0
    # wl sums <= P correctly rounded sqrt terms in another lane order:
    # a few f32 ulps of values up to ~100
    np.testing.assert_allclose(got_wl.numpy(), np.asarray(want_wl),
                               rtol=1e-6, atol=2e-5)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_reward_rows_matches_jax(seed):
    tables = _tables(JAX_PARAMS, 64, seed, 6)
    params_j = dataclasses.replace(JAX_PARAMS, reward_type="centroid")
    params_t = TORCH_PARAMS.replace(reward_type="centroid")
    want = jax_routing.reward_rows(params_j, *map(jnp.asarray, tables))
    got = torch_routing.reward_rows(params_t, *map(torch.from_numpy, tables))
    assert got.dtype == torch.float32 and tuple(got.shape) == (64, 1)
    # the wl difference above (<= 2e-5) scaled by lam_w / wl_norm = 1/40
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def _beam_tables(seed, span):
    """``_tables`` with corner cases: every 7th board's first net has no
    pins (its start is lane 0 and it routes nothing), and the 2-pin nets
    leave fewer pins than a beam of width 2 or 3 asks for, so the nearest
    pin search runs out of unvisited pins (cost BIG) and, once every lane
    is taken, of lanes (INF2)."""
    pax, pay, pnet, npin = _tables(JAX_PARAMS, 96, seed, span)
    for b in range(3, 96, 7):
        n_pins = int(npin[b, 0])
        pnet[b, :n_pins] = np.where(pnet[b, :n_pins] == 0, -1,
                                    pnet[b, :n_pins])
        keep = pnet[b] >= 0
        for arr in (pax, pay, pnet):
            arr[b] = np.concatenate([arr[b][keep], np.full(
                (~keep).sum(), -1, np.int32)])
        npin[b, 0] = int(keep.sum())
    return pax, pay, pnet, npin


@functools.lru_cache(maxsize=None)
def _jax_fn(name, reward_type, bw):
    params = dataclasses.replace(JAX_PARAMS, reward_type=reward_type,
                                 reward_beam_width=bw)
    return jax.jit(functools.partial(getattr(jax_routing, name), params))


@pytest.mark.parametrize("bw", [1, 2, 3])
@pytest.mark.parametrize("seed,span", [(0, 4), (2, 10), (4, 3)])
def test_beam_wl_int_matches_jax(seed, span, bw):
    tables = _beam_tables(seed, span)
    want_wl, want_int = _jax_fn("beam_wl_int", "beam", bw)(
        *map(jnp.asarray, tables))
    got_wl, got_int = torch_routing.beam_wl_int(
        TORCH_PARAMS.replace(reward_type="beam", reward_beam_width=bw),
        *map(torch.from_numpy, tables))
    np.testing.assert_array_equal(got_int.numpy(), np.asarray(want_int))
    assert float(got_int.sum()) > 0
    # bit-exact: the same correctly rounded sqrt terms, added in the same
    # order (nets outer, positions inner)
    np.testing.assert_array_equal(got_wl.numpy(), np.asarray(want_wl))


def test_beam_tables_hold_the_corner_cases():
    pax, pay, pnet, npin = _beam_tables(0, 4)
    counts = [(pnet[b, :npin[b, 0]] == 0).sum() for b in range(96)]
    assert any(c == 0 and npin[b, 0] > 0 for b, c in enumerate(counts))
    two_pin = [(pnet[b, :npin[b, 0]] == n).sum() == 2
               for b in range(96) for n in range(3)]
    assert any(two_pin)


@pytest.mark.parametrize("seed", [7, 8])
def test_beam_wider_than_a_net_matches_jax(seed):
    """Nets of 2 lanes under a beam of width 3: after the one unvisited pin
    (the nearest) and the visited start (cost BIG) every lane is taken, so
    the third candidate is lane 0 at cost BIG (the m >= INF2 path)."""
    jax_params = dataclasses.replace(JAX_PARAMS, max_num_pins_per_net=2,
                                     reward_type="beam", reward_beam_width=3)
    tables = _tables(jax_params, 96, seed, 5)
    want_wl, want_int = jax.jit(functools.partial(
        jax_routing.beam_wl_int, jax_params))(*map(jnp.asarray, tables))
    got_wl, got_int = torch_routing.beam_wl_int(
        TORCH_PARAMS.replace(max_num_pins_per_net=2, reward_type="beam",
                             reward_beam_width=3),
        *map(torch.from_numpy, tables))
    np.testing.assert_array_equal(got_int.numpy(), np.asarray(want_int))
    np.testing.assert_array_equal(got_wl.numpy(), np.asarray(want_wl))
    assert float(got_int.sum()) > 0


@pytest.mark.parametrize("seed,span", [(9, 10), (10, 5)])
def test_beam_at_capacity_matches_jax(seed, span):
    """The kernel's capacity shape: 16 pins per net (MAX_M), beam width 4
    (MAX_BW), three nets, so N * M = 48 > 32 and the warp kernel routes the
    nets in turns of two; the card tests hold it to this plain version."""
    over = dict(max_num_pins_per_net=16, reward_type="beam",
                reward_beam_width=4)
    jax_params = dataclasses.replace(JAX_PARAMS, **over)
    torch_params = TORCH_PARAMS.replace(**over)
    N, M = torch_params.max_num_nets, torch_params.max_num_pins_per_net
    assert (N * M > 32 and M == 16 and torch_params.max_pins == 48
            and torch_params.reward_beam_width == 4)
    tables = _tables(jax_params, 64, seed, span)
    want_wl, want_int = jax.jit(functools.partial(
        jax_routing.beam_wl_int, jax_params))(*map(jnp.asarray, tables))
    got_wl, got_int = torch_routing.beam_wl_int(
        torch_params, *map(torch.from_numpy, tables))
    np.testing.assert_array_equal(got_int.numpy(), np.asarray(want_int))
    np.testing.assert_array_equal(got_wl.numpy(), np.asarray(want_wl))
    assert float(got_int.sum()) > 0
    assert int(tables[3].max()) > 32     # pins in the second slot


@pytest.mark.parametrize("reward_type", ["beam", "both"])
@pytest.mark.parametrize("seed", [5, 6])
def test_reward_rows_beam_both_match_jax(reward_type, seed):
    tables = _beam_tables(seed, 6)
    want = _jax_fn("reward_rows", reward_type, 2)(*map(jnp.asarray, tables))
    got = torch_routing.reward_rows(
        TORCH_PARAMS.replace(reward_type=reward_type, reward_beam_width=2),
        *map(torch.from_numpy, tables))
    assert got.dtype == torch.float32 and tuple(got.shape) == (96, 1)
    if reward_type == "beam":
        # wl and crossings are bit-exact (above); jitted XLA may turn the
        # division by a normalizer constant into a product with its
        # reciprocal, one ulp apart
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=1)
    else:
        # the centroid route's wirelength sums its lanes in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)
