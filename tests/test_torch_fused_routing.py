"""The port's centroid routing reward against the JAX package's.

``placement_tpu.ops.fused_routing`` is plain ``jnp`` (no kernel, no
interpreter), so both sides run directly on the same numpy-seeded terminal
pin tables. The tables are net-grouped as the generator writes them, with
2-pin nets (direct pin-to-pin routes), shared endpoints (coordinates from a
small range collide often) and collinear segments (boards whose pins all lie
on one row or one column).
"""

import dataclasses

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


@pytest.mark.parametrize("reward_type", ["beam", "both"])
def test_unported_reward_types_raise(reward_type):
    tables = map(torch.from_numpy, _tables(JAX_PARAMS, 2, 0, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        torch_routing.reward_rows(
            TORCH_PARAMS.replace(reward_type=reward_type), *tables)
