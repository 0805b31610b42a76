"""The CUDA sources of the kernels, the reduced ones first, run on the CPU
under an emulated warp, against the plain PyTorch version.

There is no CUDA compiler or GPU where these tests run, so the ``.cu``
sources are compiled with g++ against ``tests/cuda_emu/cuda_runtime.h``
(lanes as fibers, warp intrinsics as meetings of lanes; see ``emu.py``) and
``fused_rollout_launch`` runs on host memory. That holds the kernels' code,
not the card: lane layout, masks, slots, the PRNG's logical block under a
partial CUDA block, the draw order. ``tests/test_torch_gpu.py`` holds the
compiled kernels on the card. Nothing in the package loads the emulated
library.

The sources are compiled once for the file (a few seconds); each case runs in
a child process with its own time limit. Skipped where g++ is missing.
"""

import numpy as np
import pytest

from placement_tpu_torch.ops import _build
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils.config import load_env_params
from tests.cuda_emu import emu

#: seconds a case's emulated chunks may take (they take one or two)
CASE_TIMEOUT = 120

#: label -> (config, overrides, boards, logical block, steps a chunk). 20
#: boards leave the last CUDA block partial; a logical block of 4 is not the
#: CUDA block's.
CASES = {
    "square": ("square", {}, 20, 4, 10),
    "rect": ("rectangle", {}, 20, 4, 10),
    # SQUARE's footprint is (component_n, component_n), not the ranges
    "square_n3": ("square", {"component_n": 3}, 12, 4, 10),
    # the second lane slot of the component tables, a cursor beyond 32
    "rect_64_components": ("rectangle", {
        "height": 12, "width": 12, "min_component_h": 1,
        "max_component_h": 1, "min_component_w": 1, "max_component_w": 2,
        "min_num_components": 40, "max_num_components": 64}, 6, 3, 40),
    # every lane holds a row; rows of 32 cells
    "rect_32x32": ("rectangle", {"height": 32, "width": 32}, 6, 6, 10),
}


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    if emu.compiler() is None:
        pytest.skip("needs g++ to compile the kernels for the emulated warp")
    return emu.build(_build.CSRC, tmp_path_factory.mktemp("cuda_emu"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_reduced_kernel_matches_plain_version(emulated_library,
                                                       case):
    name, overrides, batch, block, steps = CASES[case]
    params = load_env_params(name).replace(**overrides)
    seeds = [11, 12]                      # two chained chunks
    leaves = torch_fused.zero_leaves(params, batch, "cpu")
    got = emu.run_chunks(emulated_library, torch_fused._kernel_params(params),
                         torch_fused.leaves_to_numpy(leaves), seeds, steps,
                         block, CASE_TIMEOUT)
    placed = 0.0
    for seed, (new, rsum, dcnt) in zip(seeds, got):
        leaves, want_r, want_d = torch_fused.rollout_chunk_reference(
            params, leaves, seed, steps, block)
        want = torch_fused.leaves_to_numpy(leaves)
        for k in torch_fused._LEAVES:
            np.testing.assert_array_equal(new[k], want[k], err_msg=k)
        np.testing.assert_array_equal(dcnt, want_d.numpy())
        np.testing.assert_array_equal(rsum, want_r.numpy())
        placed += float(rsum.sum())
    assert placed > batch                 # the boards did place components
    if case == "rect_64_components":
        assert (want["cursor"] > 32).any()


@pytest.mark.parametrize("reward_type", ["centroid", "beam", "both"])
def test_emulated_pin_kernel_matches_plain_version(emulated_library,
                                                   reward_type):
    """The pin kernels share the reduced kernels' row helpers: 12 boards,
    logical block 4, two chained chunks of 11 steps (two episode ends a
    board and chunk, each routed)."""
    params = load_env_params("rectangle_pin").replace(
        reward_type=reward_type)
    batch, block, steps, seeds = 12, 4, 11, [11, 12]
    leaves = torch_fused.zero_leaves(params, batch, "cpu")
    got = emu.run_chunks(emulated_library, torch_fused._kernel_params(params),
                         torch_fused.leaves_to_numpy(leaves), seeds, steps,
                         block, CASE_TIMEOUT)
    for seed, (new, rsum, dcnt) in zip(seeds, got):
        leaves, want_r, want_d = torch_fused.rollout_chunk_reference(
            params, leaves, seed, steps, block)
        want = torch_fused.leaves_to_numpy(leaves)
        for k in torch_fused._LEAVES:
            np.testing.assert_array_equal(new[k], want[k], err_msg=k)
        np.testing.assert_array_equal(dcnt, want_d.numpy())
        assert (dcnt >= 2).all()
        if reward_type == "beam":
            np.testing.assert_array_equal(rsum, want_r.numpy())
        else:
            # the plain version adds a board's centroid wirelength terms
            # in another order
            np.testing.assert_allclose(rsum, want_r.numpy(), rtol=0,
                                       atol=1e-5)


def test_emulated_library_is_a_test_aid_only():
    """No module of the package names the emulation: the card's kernels
    are built by ``_build.py`` with nvcc and nothing else is ever loaded."""
    package = _build.CSRC.parents[1]
    for path in package.rglob("*.py"):
        text = path.read_text()
        assert "cuda_emu" not in text and "emu_launch" not in text, path
    assert "nvcc" in (package / "ops" / "_build.py").read_text()
