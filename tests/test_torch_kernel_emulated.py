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
import torch

from placement_tpu_torch.ops import _build
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils.config import load_env_params
from tests.cuda_emu import emu
from tests.test_torch_fused_envelope import _ROOMY, EDGES

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
    # the beam route's segments: M = 16 pins, two segments a slot, the
    # third net alone in slot 1 beside a segment of no net (a side past 32
    # takes it to the general instantiation)
    "nets3_ppn16_beam_4x36": ("rectangle_pin", {
        **_ROOMY, "height": 4, "width": 36, "min_num_nets": 3,
        "max_num_nets": 3,
        "min_num_pins_per_net": 16, "max_num_pins_per_net": 16,
        "reward_type": "beam", "reward_beam_width": 2}),
    # M = 5: six segments a slot and two lanes of none; nine nets, three of
    # them in slot 1
    "nets9_ppn5_both": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 9, "max_num_nets": 9,
        "min_num_pins_per_net": 5, "max_num_pins_per_net": 5,
        "reward_type": "both", "reward_beam_width": 4}),
    # a net of 17-24 pins on each lane slot, width 3 (not a power of 2):
    # the two nets' rounds differ
    "ppn17_24_beam3": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 2, "max_num_nets": 2,
        "min_num_pins_per_net": 17, "max_num_pins_per_net": 24,
        "reward_type": "beam", "reward_beam_width": 3}),
    # the web app's 10 nets of 2..4 pins, beam width 4: bw > M on the
    # 2-pin nets, the nets' rounds differ
    "web_nets10_beam4": ("rectangle_pin", {
        **EDGES["web_nets10"][1], "reward_type": "beam",
        "reward_beam_width": 4}),
    # the web app's 10 nets of 2..4 pins on 8 components: every position
    # lane of the allocation taken, after the extra pins
    "web_nets10_c8": ("rectangle_pin", {
        **EDGES["web_nets10"][1], "min_num_components": 8,
        "max_num_components": 8}),
    # one net of 36 pins on 3-4 components of 6 cells: the net overflows
    # every component (not_enough, the water-fill's residue), and its ranks
    # 32.. take the second lane slot
    "net1_ppn36_overflow": ("rectangle_pin", {
        **_ROOMY, "min_component_h": 2, "max_component_h": 2,
        "min_component_w": 3, "max_component_w": 3, "min_num_components": 3,
        "max_num_components": 4, "min_num_nets": 1, "max_num_nets": 1,
        "min_num_pins_per_net": 36, "max_num_pins_per_net": 36,
        "pin_spread": 0}),
    "rect_1x144": ("rectangle", {
        "height": 1, "width": 144, "min_component_h": 1,
        "max_component_h": 1, "min_component_w": 1, "max_component_w": 3,
        "min_num_components": 10, "max_num_components": 40}),
    # the centroid route's per-net table full (24 nets), its 48 pins on
    # both lane slots; then 48 routed segments, whose pairs pass lane 31
    "nets24_ppn2_centroid": ("rectangle_pin", {
        **EDGES["nets24_both"][1], "reward_type": "centroid"}),
    "nets12_ppn4_centroid": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 12, "max_num_nets": 12,
        "min_num_pins_per_net": 4, "max_num_pins_per_net": 4}),
    # nets left with no pin (a few cells cap the net count) or one
    "nets_0_1_pins": ("rectangle_pin", {
        "height": 12, "width": 12, "min_component_h": 1,
        "max_component_h": 1, "min_component_w": 1, "max_component_w": 2,
        "min_num_components": 2, "max_num_components": 4,
        "min_num_nets": 6, "max_num_nets": 12, "min_num_pins_per_net": 1,
        "max_num_pins_per_net": 3}),
    "ppn1_both": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 10, "max_num_nets": 12,
        "min_num_pins_per_net": 1, "max_num_pins_per_net": 3,
        "reward_type": "both"}),
    # square and oblong footprints on one pin board: plane 1 copies plane 0
    # for the square ones
    "square_footprints_4x36": ("rectangle_pin", {
        "height": 4, "width": 36, "min_component_h": 2, "max_component_h": 3,
        "min_component_w": 2, "max_component_w": 3, "min_num_components": 6,
        "max_num_components": 8, "min_num_nets": 4, "max_num_nets": 4,
        "min_num_pins_per_net": 3, "max_num_pins_per_net": 3}),
    # widths about a word: the anchor mask's column pattern (W <= 32) and
    # its two runs (W > 32), the footprint's reach past 32 cells; on 4 x 33
    # the anchor rows (H - ph + 1) * W span 3 to 5 words
    "pin_4x31_nets10": ("rectangle_pin", {
        "height": 4, "width": 31, "min_num_nets": 10, "max_num_nets": 10,
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 2}),
    "pin_4x32_nets10": ("rectangle_pin", {
        "height": 4, "width": 32, "min_num_nets": 10, "max_num_nets": 10,
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 2}),
    # the beam route's crossings at 24 segments, one a net, width 4
    "nets24_ppn2_both_bw4": ("rectangle_pin", {
        **EDGES["nets24_both"][1], "reward_beam_width": 4}),
    # segments whose byte coordinates pass 31 (a side of 36)
    "nets8_varpin_beam_4x36": ("rectangle_pin", {
        **_ROOMY, "height": 4, "width": 36, "min_num_nets": 8,
        "max_num_nets": 8, "min_num_pins_per_net": 2,
        "max_num_pins_per_net": 6, "reward_type": "beam",
        "reward_beam_width": 3}),
    "rect_4x33": ("rectangle", {
        "height": 4, "width": 33, "min_component_h": 1, "max_component_h": 3,
        "min_component_w": 1, "max_component_w": 3, "min_num_components": 10,
        "max_num_components": 20}),
    # the segments' candidate search (chained minima here; the wide
    # file's BEAM_CASES hold the wide tier's rank counts): 48 pins on the
    # 48 cells of eight 2 x 3 components, so pins at equal distances from
    # a beam's last pin, whose keys the rank j orders
    "cells_2x3_nets12_ppn4_beam4": ("rectangle_pin", {
        "height": 12, "width": 12, "min_component_h": 2,
        "max_component_h": 2, "min_component_w": 3, "max_component_w": 3,
        "min_num_components": 8, "max_num_components": 8,
        "min_num_nets": 12, "max_num_nets": 12, "min_num_pins_per_net": 4,
        "max_num_pins_per_net": 4, "reward_type": "beam",
        "reward_beam_width": 4}),
    # width 4 on nets of 2 and 3 pins: beams take visited candidates
    "nets16_ppn2_3_beam4": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 16, "max_num_nets": 16,
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 3,
        "reward_type": "beam", "reward_beam_width": 4}),
    # M = 16: three full 16-lane segments, under "both" at width 4
    "nets3_ppn16_both4_36x4": ("rectangle_pin", {
        **_ROOMY, "height": 36, "width": 4, "min_num_nets": 3,
        "max_num_nets": 3, "min_num_pins_per_net": 16,
        "max_num_pins_per_net": 16, "reward_type": "both",
        "reward_beam_width": 4}),
    # M = 10: nets 0-2 on slot 0's three segments and lanes 30-31 past
    # them, net 3 on slot 1
    "nets4_ppn10_beam3_4x36": ("rectangle_pin", {
        **_ROOMY, "height": 4, "width": 36, "min_num_nets": 4,
        "max_num_nets": 4, "min_num_pins_per_net": 10,
        "max_num_pins_per_net": 10, "reward_type": "beam",
        "reward_beam_width": 3}),
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


#: the general square kernel (four boards a warp on 8-lane segments, the
#: plane updated by the placed square's reach): label -> overrides of the
#: square config. 10 boards leave both a warp's segments and the CUDA block
#: partial; logical block 3; two chained chunks of 40 steps (several
#: episodes where n > 1; 1 x 40 at n = 1 fills its board: placed_all)
SQUARE_CASES = {
    "36x4_n2": {"height": 36, "width": 4, "component_n": 2},
    "36x4_n4": {"height": 36, "width": 4, "component_n": 4},
    "144x1_n1": {"height": 144, "width": 1, "component_n": 1},
    "48x3_n3": {"height": 48, "width": 3, "component_n": 3},
    "4x36_n2": {"height": 4, "width": 36, "component_n": 2},
    "3x48_n3": {"height": 3, "width": 48, "component_n": 3},
    "1x144_n1": {"height": 1, "width": 144, "component_n": 1},
    "1x40_n1": {"height": 1, "width": 40, "component_n": 1},
}
SQUARE_BATCH, SQUARE_BLOCK, SQUARE_STEPS = 10, 3, 40


def _square_chunks(emulated_library, params, leaves, seeds,
                   steps=SQUARE_STEPS):
    """The emulated kernel's chained chunks from ``leaves`` held to the
    plain version's, leaf for leaf; returns the kernel's (leaves, done
    counts) of each."""
    got = emu.run_chunks(emulated_library, torch_fused._kernel_params(params),
                         torch_fused.leaves_to_numpy(leaves), seeds,
                         steps, SQUARE_BLOCK, CASE_TIMEOUT)
    for seed, (new, rsum, dcnt) in zip(seeds, got):
        leaves, want_r, want_d = torch_fused.rollout_chunk_reference(
            params, leaves, seed, steps, SQUARE_BLOCK)
        want = torch_fused.leaves_to_numpy(leaves)
        for k in torch_fused._LEAVES:
            np.testing.assert_array_equal(new[k], want[k], err_msg=k)
        np.testing.assert_array_equal(dcnt, want_d.numpy())
        np.testing.assert_array_equal(rsum, want_r.numpy())
    return [(new, d) for new, _, d in got]


@pytest.mark.parametrize("case", sorted(SQUARE_CASES))
def test_emulated_general_square_matches_plain_version(emulated_library,
                                                       case):
    params = load_env_params("square").replace(**SQUARE_CASES[case])
    assert torch_fused.needs_general(params)
    leaves = torch_fused.zero_leaves(params, SQUARE_BATCH, "cpu")
    dcnt = [d for _, d in _square_chunks(emulated_library, params, leaves,
                                         [11, 12])]
    assert (dcnt[0] >= 1).all()           # every zero board regenerated
    if params.component_n > 1 or case == "1x40_n1":
        assert (dcnt[0] + dcnt[1] >= 2).any()   # and an episode ended


def test_emulated_general_square_rebuilds_after_the_load(emulated_library):
    """Leaves whose plane0 disagrees with the grid: half the rows filled
    under the empty board's plane, and on half the boards a component under
    the cursor of another size. As JAX's kernel, the first step samples the
    loaded plane0, paints the loaded component and rebuilds the plane from
    the grid; an update of plane0 by the placed square's reach would keep
    the filled rows' anchors. One step, then two chunks on from it."""
    params = load_env_params("square").replace(height=36, width=4,
                                               component_n=2)
    H, W, n = params.height, params.width, params.component_n
    leaves = torch_fused.zero_leaves(params, SQUARE_BATCH, "cpu")
    grid = torch.zeros(SQUARE_BATCH, H, W)
    grid[:, : H // 2] = 1.0
    plane = torch.zeros(H, W)
    plane[: H - n + 1, : W - n + 1] = 1.0
    leaves["grid"] = grid.reshape(SQUARE_BATCH, -1).contiguous()
    leaves["plane0"] = plane.reshape(1, -1).repeat(SQUARE_BATCH, 1)
    leaves["plane1"] = leaves["plane0"].clone()
    leaves["cursor"][:] = 3
    leaves["num_components"][:] = H * W
    leaves["comp_h"][:] = n
    leaves["comp_w"][:] = n
    leaves["comp_h"][SQUARE_BATCH // 2:] = n + 1
    (new, dcnt), = _square_chunks(emulated_library, params, leaves, [21],
                                  steps=1)
    half = SQUARE_BATCH // 2
    plane = new["plane0"].reshape(SQUARE_BATCH, H, W)
    # an n x n component: no step ended, and the plane holds the free
    # anchors of the grid's lower rows alone
    assert (dcnt[:half] == 0).all()
    assert not plane[:half, : H // 2].any() and plane[:half].any()
    # another size: the first step painted it, then the board ended
    assert (dcnt[half:] == 1).all()
    leaves = torch_fused.leaves_from_numpy(new, "cpu")
    _square_chunks(emulated_library, params, leaves, [22, 23])


@pytest.mark.parametrize("case", sorted(GENERAL_CASES))
def test_general_row_stride_fits_the_warp(case):
    """The flat layout's row stride: a row a lane where both sides fit one,
    whole words a row for a row over 32 cells (no word all padding), rows
    end to end for a column over 32; the board's bits fit the warp's 32
    words, and the stride's reciprocal divides every bit index exactly."""
    config, overrides = GENERAL_CASES[case]
    params = load_env_params(config).replace(**overrides)
    H, W = params.height, params.width
    kp = torch_fused._kernel_params(params)
    S = kp.row_stride
    assert S == torch_fused._row_stride(params) and S >= W
    if H > 32:
        assert S == W
    else:
        assert S % 32 == 0 and S - W < 32
    assert H * S <= 32 * 32
    t = np.arange(H * S, dtype=np.int64)
    np.testing.assert_array_equal((t * kp.stride_recip) >> 22, t // S)
    assert (t * kp.stride_recip).max() < 2 ** 32


def test_emulated_library_is_a_test_aid_only():
    """No module of the package names the emulation: the card's kernels
    are built by ``_build.py`` with nvcc and nothing else is ever loaded."""
    package = _build.CSRC.parents[1]
    for path in package.rglob("*.py"):
        text = path.read_text()
        assert "cuda_emu" not in text and "emu_launch" not in text, path
    assert "nvcc" in (package / "ops" / "_build.py").read_text()
