"""The port's summed-area-table masks against the JAX package's.

``placement_tpu.ops.sat`` is plain ``jnp``; each function runs jitted and
``vmap``-ed over 200 random boards per variant (random occupancy densities,
per-board component sizes, anchors and sizes reaching past the grid) and
must equal ``placement_tpu_torch.ops.sat`` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from placement_tpu.ops import sat as jax_sat
from placement_tpu_torch.ops import sat as torch_sat

N_BOARDS = 200
#: (variant, grid height, width, max component side, orientations)
VARIANTS = {
    "square": (10, 10, 3, 1),
    "rect": (10, 10, 4, 2),
    "pin": (10, 10, 3, 4),
    "pin_nonsquare": (8, 12, 4, 4),
}


def _boards(name, seed):
    h, w, side, _ = VARIANTS[name]
    rng = np.random.default_rng(seed)
    density = rng.random((N_BOARDS, 1, 1))
    grid = (rng.random((N_BOARDS, h, w)) < density * 0.6).astype(np.int32)
    ph = rng.integers(1, side + 1, N_BOARDS).astype(np.int32)
    pw = rng.integers(1, side + 1, N_BOARDS).astype(np.int32)
    x = rng.integers(-1, h + 1, N_BOARDS).astype(np.int32)
    y = rng.integers(-1, w + 1, N_BOARDS).astype(np.int32)
    return grid, ph, pw, x, y


@functools.lru_cache(maxsize=None)
def _jax_fns(orientations):
    return {
        "sat": jax.jit(jax.vmap(jax_sat.occupancy_sat)),
        "free": jax.jit(jax.vmap(jax_sat.free_placement_mask)),
        "mask": jax.jit(jax.vmap(functools.partial(
            jax_sat.orientation_action_mask,
            num_orientations=orientations))),
        "paint": jax.jit(jax.vmap(jax_sat.paint_rectangle)),
    }


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sat_functions_match_jax(name):
    grid, ph, pw, x, y = _boards(name, 7)
    orientations = VARIANTS[name][3]
    fns = _jax_fns(orientations)
    t = {k: torch.as_tensor(v) for k, v in
         dict(grid=grid, ph=ph, pw=pw, x=x, y=y).items()}
    j = {k: jnp.asarray(v) for k, v in
         dict(grid=grid, ph=ph, pw=pw, x=x, y=y).items()}
    checks = {
        "occupancy_sat": (torch_sat.occupancy_sat(t["grid"]),
                          fns["sat"](j["grid"])),
        "free_placement_mask": (
            torch_sat.free_placement_mask(t["grid"], t["ph"], t["pw"]),
            fns["free"](j["grid"], j["ph"], j["pw"])),
        "orientation_action_mask": (
            torch_sat.orientation_action_mask(t["grid"], t["ph"], t["pw"],
                                              orientations),
            fns["mask"](j["grid"], j["ph"], j["pw"])),
        "paint_rectangle": (
            torch_sat.paint_rectangle(t["grid"], t["x"], t["y"], t["ph"],
                                      t["pw"]),
            fns["paint"](j["grid"], j["x"], j["y"], j["ph"], j["pw"])),
    }
    for what, (got, want) in checks.items():
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, what
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
    # the boards are not trivial: some anchors free, some blocked
    free = checks["free_placement_mask"][0]
    assert 0 < int(free.sum()) < free.numel()


def test_host_int_sizes_broadcast():
    """A host int size (the square variant's component_n) is the same size
    on every board."""
    grid, *_ = _boards("square", 3)
    g = torch.as_tensor(grid)
    n = torch.full((N_BOARDS,), 2, dtype=torch.int32)
    assert torch.equal(torch_sat.free_placement_mask(g, 2, 2),
                       torch_sat.free_placement_mask(g, n, n))
    assert torch.equal(torch_sat.orientation_action_mask(g, 2, 2, 1)[:, 0],
                       torch_sat.free_placement_mask(g, n, n))
