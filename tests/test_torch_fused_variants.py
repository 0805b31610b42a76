"""The port's beam, "both", SQUARE and RECT rollouts against the JAX kernel.

The JAX kernel runs under the Pallas TPU interpreter, as in
``test_torch_fused_rollout.py``; each distinct shape costs one compile
(about 15-20 s for beam and "both", 1-3 s for SQUARE and RECT), so every
JAX run sits in a module-scoped fixture and is shared. The port's plain
PyTorch version (what ``make_fused_rollout`` runs for CPU tensors) must give
exactly the JAX kernel's leaves and done counts; the reward sums of the pin
kernels may differ by the order in which boards and the centroid route's
terms are summed, those of SQUARE and RECT (integer +1 per placement) not
at all.

Fixtures, recorded from the JAX package, let ``chip_smoke.py`` hold the CUDA
kernels to the same numbers on a machine without JAX:

  * ``fixtures/torch_fused_init_k7_b128_{square,rectangle}.npz`` —
    ``init_leaves(PRNGKey(7), 128)`` of the SQUARE and RECT configs, the
    start states of their TPU hardware goldens (the pin goldens start from
    ``torch_fused_init_k7_b128.npz``, which is the same for every reward
    type);
  * ``fixtures/torch_fused_zero_b128_{beam,both,square,rect,spatial}.json``
    — per leaf sha256, reward sum and done count of the JAX kernel from 128
    zero boards, seed 1234, block 128 (``spatial`` runs the centroid kernel
    on the PIN_SPATIAL config, which has no TPU golden: its mean episode
    reward is the reference of the matrix's ``spatial`` row).

Re-record them with ``PYTHONPATH=. python tests/test_torch_fused_variants.py``;
``test_variant_fixtures_are_fresh`` fails when they go stale.
"""

import dataclasses
import hashlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from placement_tpu.ops import fused_rollout as jax_fused
from placement_tpu.utils.config import load_experiment
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils.config import load_env_params

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
INIT_K7_PIN = FIXTURES / "torch_fused_init_k7_b128.npz"
HW_GOLDENS = REPO / "experiments" / "results" / "fused_hw_validation.json"

#: boards' reward sums are summed in another order than the JAX kernel's
#: per-block sums (test_torch_fused_rollout.RSUM_TOL)
RSUM_TOL = 2e-3

#: golden -> (config, overrides, zero-start golden steps, hardware-golden
#: key and steps)
SPECS = {
    "beam": ("rectangle_pin", {"reward_type": "beam"}, 26, "beam", 25),
    "both": ("rectangle_pin", {"reward_type": "both"}, 26, "both", 25),
    "square": ("square", {}, 60, "square", 60),
    "rect": ("rectangle", {}, 30, "rectangle", 30),
    "spatial": ("rectangle_spatial_pin", {}, 26, None, None),
}
#: the kernel specialisations beside the centroid one
KERNELS = ("beam", "both", "square", "rect")
PIN = ("beam", "both", "spatial")


def init_k7_path(kernel):
    name = SPECS[kernel][0]
    if name in ("rectangle_pin", "rectangle_spatial_pin"):
        return INIT_K7_PIN
    return FIXTURES / f"torch_fused_init_k7_b128_{name}.npz"


def golden_path(kernel):
    return FIXTURES / f"torch_fused_zero_b128_{kernel}.json"


def _params(kernel):
    name, overrides = SPECS[kernel][:2]
    return (dataclasses.replace(load_experiment(name)[0], **overrides),
            load_env_params(name).replace(**overrides))


def _jax_run(params, leaves, seed, steps, block):
    """The JAX Pallas kernel under the TPU interpreter -> numpy."""
    batch = leaves["grid"].shape[0]
    fn = jax_fused.make_fused_rollout(params, batch, steps, block=block,
                                      interpret=True)
    out, rsum, dcnt = fn({k: jnp.asarray(v) for k, v in leaves.items()},
                         seed)
    return ({k: np.asarray(v) for k, v in out.items()}, float(rsum),
            int(dcnt))


def _port_run(params, leaves, seed, steps, block):
    batch = leaves["grid"].shape[0]
    fn = torch_fused.make_fused_rollout(params, batch, steps, block=block,
                                        device="cpu")
    out, rsum, dcnt = fn(torch_fused.leaves_from_numpy(leaves, "cpu"), seed)
    assert fn.launches == 0   # CPU tensors take the plain version
    return torch_fused.leaves_to_numpy(out), float(rsum), int(dcnt)


def _zero(params, batch):
    return torch_fused.leaves_to_numpy(
        torch_fused.zero_leaves(params, batch, "cpu"))


def _assert_leaves_equal(got, want):
    assert set(got) == set(want) == set(torch_fused._LEAVES)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_rsum(kernel, got, want):
    if kernel in PIN:
        assert abs(got - want) <= RSUM_TOL, (got, want)
    else:
        assert got == want


def k7_leaves(kernel):
    """A hardware golden's start state, from the JAX package."""
    params, _ = _params(kernel)
    leaves = jax_fused.init_leaves(params, jax.random.PRNGKey(7), 128)
    return {k: np.asarray(v) for k, v in leaves.items()}


def zero_golden(kernel, out, rsum, dcnt):
    name, overrides, steps = SPECS[kernel][:3]
    return {"config": name, "overrides": overrides, "batch": 128,
            "num_steps": steps, "seed": 1234, "block": 128,
            "reward_sum": rsum, "done_count": dcnt,
            "sha256": {k: leaf_sha256(out[k]) for k in torch_fused._LEAVES}}


def leaf_sha256(arr: np.ndarray) -> str:
    """sha256 of a leaf's little-endian bytes (f32 or i32)."""
    kind = "<f4" if arr.dtype.kind == "f" else "<i4"
    return hashlib.sha256(np.ascontiguousarray(arr, kind).tobytes()
                          ).hexdigest()


def _jax_zero_b128(kernel):
    params, t_params = _params(kernel)
    return _jax_run(params, _zero(t_params, 128), 1234, SPECS[kernel][2],
                    128)


@pytest.fixture(scope="module")
def jax_zero_b128():
    """kernel -> the JAX kernel's zero-start run (computed once each)."""
    cache = {}

    def get(kernel):
        if kernel not in cache:
            cache[kernel] = _jax_zero_b128(kernel)
        return cache[kernel]
    return get


# ---------------------------------------------------------------------------
# The plain version against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["beam", "both"])
def test_pin_chunk_matches_jax_kernel(kernel):
    """From a JAX reset state, 11 steps: pin rotation mid-episode, two
    episode ends per board, each routed by beam search."""
    params, t_params = _params(kernel)
    start = {k: np.asarray(v) for k, v in jax_fused.init_leaves(
        params, jax.random.PRNGKey(5), 16).items()}
    want, want_r, want_d = _jax_run(params, start, 77, 11, 16)
    got, got_r, got_d = _port_run(t_params, start, 77, 11, 16)
    _assert_leaves_equal(got, want)
    assert got_d == want_d == 32
    assert (got["cursor"] == 1).all()
    _assert_rsum(kernel, got_r, want_r)


@pytest.mark.parametrize("kernel,steps", [("square", 45), ("rect", 20)])
def test_nopin_chunk_matches_jax_kernel(kernel, steps):
    """From all-done zero boards: regeneration, one or two orientation
    planes, +1 per placement; episodes end when no footprint fits."""
    params, t_params = _params(kernel)
    start = _zero(t_params, 16)
    want, want_r, want_d = _jax_run(params, start, 77, steps, 16)
    got, got_r, got_d = _port_run(t_params, start, 77, steps, 16)
    _assert_leaves_equal(got, want)
    assert got_d == want_d > 2 * 16
    assert got_r == want_r
    assert (got["num_pins"] == 0).all() and (got["pin_net"] == -1).all()


def test_square_footprint_is_component_n():
    """SQUARE's footprint is (component_n, component_n), not the component
    ranges (which stay at their 2..2 defaults): with n = 3 the planes hold
    3x3 anchors, and the port equals the JAX kernel."""
    params, t_params = _params("square")
    params = dataclasses.replace(params, component_n=3)
    t_params = t_params.replace(component_n=3)
    assert (t_params.min_component_h, t_params.max_component_h) == (2, 2)
    start = _zero(t_params, 16)
    want, want_r, want_d = _jax_run(params, start, 91, 30, 16)
    got, got_r, got_d = _port_run(t_params, start, 91, 30, 16)
    _assert_leaves_equal(got, want)
    assert got_d == want_d > 16 and got_r == want_r
    assert (got["comp_h"] == 3).all()
    # 9 cells per placement, and no more than nine 3x3 squares fit 10x10
    assert (got["grid"].sum(axis=1) % 9 == 0).all()
    assert (got["cursor"] <= 9).all()


@pytest.mark.parametrize("kernel", KERNELS)
def test_port_reproduces_hardware_golden(kernel):
    """The TPU-measured rows of fused_hw_validation.json (k7 start, 128
    boards, seed 1234, block 128). SQUARE / RECT are exact; beam and "both"
    hold within 0.5 there because Mosaic's f32 division rounds differently
    (test_fused_rollout.py:252-256), and within RSUM_TOL of the JAX kernel
    under the interpreter."""
    params, t_params = _params(kernel)
    hw = json.loads(HW_GOLDENS.read_text())[SPECS[kernel][3]]
    steps = SPECS[kernel][4]
    start = dict(np.load(init_k7_path(kernel)))
    _, rsum, dcnt = _port_run(t_params, start, 1234, steps, 128)
    assert dcnt == hw["episodes"]
    if kernel in PIN:
        assert abs(rsum - hw["reward_sum"]) <= 0.5, (rsum, hw["reward_sum"])
        _, want_r, want_d = _jax_run(params, start, 1234, steps, 128)
        assert dcnt == want_d
        assert abs(rsum - want_r) <= RSUM_TOL, (rsum, want_r)
    else:
        assert rsum == hw["reward_sum"]


@pytest.mark.parametrize("kernel", sorted(SPECS))
def test_zero_start_matches_jax_kernel(kernel, jax_zero_b128):
    """The chip smoke's JAX golden: the port equals the JAX kernel on 128
    all-done zero boards."""
    _, t_params = _params(kernel)
    want, want_r, want_d = jax_zero_b128(kernel)
    got, got_r, got_d = _port_run(t_params, _zero(t_params, 128), 1234,
                                  SPECS[kernel][2], 128)
    _assert_leaves_equal(got, want)
    assert got_d == want_d
    _assert_rsum(kernel, got_r, want_r)


@pytest.mark.parametrize("kernel", sorted(SPECS))
def test_variant_fixtures_are_fresh(kernel, jax_zero_b128):
    """The committed fixtures equal what the JAX package records now."""
    if kernel in ("square", "rect"):
        stored = dict(np.load(init_k7_path(kernel)))
        _assert_leaves_equal(stored, k7_leaves(kernel))
    stored = json.loads(golden_path(kernel).read_text())
    fresh = zero_golden(kernel, *jax_zero_b128(kernel))
    # the leaves' bytes are exact; the f32 reward sum may move by summation
    # order between machines
    assert abs(stored.pop("reward_sum") - fresh.pop("reward_sum")) <= RSUM_TOL
    assert stored == fresh


# ---------------------------------------------------------------------------
# What the port covers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_specialisations_are_supported(kernel):
    _, t_params = _params(kernel)
    assert torch_fused.supports(t_params)
    assert torch_fused.kernel_name(t_params) == kernel
    fn = torch_fused.make_fused_rollout(t_params, 8, 3, block=8,
                                        device="cpu")
    assert fn.kernel == kernel
    out, rsum, dcnt = fn(torch_fused.zero_leaves(t_params, 8, "cpu"), 1)
    assert int(dcnt) >= 8 and fn.launches == 0


if __name__ == "__main__":
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for k in ("square", "rect"):
        np.savez_compressed(init_k7_path(k), **k7_leaves(k))
        print(f"wrote {init_k7_path(k)}")
    for k in SPECS:
        golden = zero_golden(k, *_jax_zero_b128(k))
        golden_path(k).write_text(
            json.dumps(golden, indent=1, sort_keys=True) + "\n")
        print(f"wrote {golden_path(k)}")
