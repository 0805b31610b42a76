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
from tests.test_torch_fused_envelope import EDGES

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


#: the general instantiations (a board as its bit string over the lanes, up
#: to 24 nets and 48 pins per net): the envelope's edge configurations and
#: label -> (config, overrides) beside them. Each runs 12 boards (10 for the
#: reduced kernels: both leave a partial CUDA block), logical block 4, two
#: chained chunks of 11 steps.
GENERAL_CASES = {
    **EDGES,
    # the beam's pin keys and segments past coordinate 63, a 5-word board
    "beam_2x72": ("rectangle_pin", {"height": 2, "width": 72,
                                    "reward_type": "beam",
                                    "reward_beam_width": 3}),
    # the extra pins' water-fill over up to 12 nets, a beam of many nets
    "varpin_nets12_beam": ("rectangle_pin", {
        **EDGES["nets24_both"][1], "min_num_nets": 8, "max_num_nets": 12,
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 4,
        "reward_type": "beam"}),
    # a net's ranks and path positions on the second lane slot, varying
    "ppn40_varpin_both": ("rectangle_pin", {
        **EDGES["nets24_both"][1], "min_num_nets": 1, "max_num_nets": 1,
        "min_num_pins_per_net": 30, "max_num_pins_per_net": 40,
        "reward_type": "both", "reward_beam_width": 4}),
    # a 32-word board
    "pin_32x32_nets10": ("rectangle_pin", {
        "height": 32, "width": 32, "min_num_nets": 10, "max_num_nets": 10,
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 2}),
    "rect_1x144": ("rectangle", {
        "height": 1, "width": 144, "min_component_h": 1,
        "max_component_h": 1, "min_component_w": 1, "max_component_w": 3,
        "min_num_components": 10, "max_num_components": 40}),
}


@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_emulated_general_kernel_matches_plain_version(emulated_library,
                                                       case):
    config, overrides = GENERAL_CASES[case]
    params = load_env_params(config).replace(**overrides)
    assert torch_fused.supports(params) and torch_fused.needs_general(params)
    batch = 12 if params.has_pins else 10
    block, steps, seeds = 4, 11, [11, 12]
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
        if params.has_pins and params.reward_type != "beam":
            # the centroid route's terms are added in another order
            np.testing.assert_allclose(rsum, want_r.numpy(), rtol=0,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(rsum, want_r.numpy())
    assert (got[0][2] >= 1).all()         # every zero board regenerated
    if params.has_pins:
        # some episodes were routed, not all penalties
        assert (rsum != dcnt * np.float32(torch_fused._penalty(params))).any()


def test_emulated_library_is_a_test_aid_only():
    """No module of the package names the emulation: the card's kernels
    are built by ``_build.py`` with nvcc and nothing else is ever loaded."""
    package = _build.CSRC.parents[1]
    for path in package.rglob("*.py"):
        text = path.read_text()
        assert "cuda_emu" not in text and "emu_launch" not in text, path
    assert "nvcc" in (package / "ops" / "_build.py").read_text()
