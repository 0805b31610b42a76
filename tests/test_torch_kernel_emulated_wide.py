"""The wide instantiations of the pin kernels (two components and four
pins a lane, per-warp tables in shared memory) under the emulated warp,
against the plain PyTorch version.

``tests/test_torch_kernel_emulated.py`` holds the default and general
instantiations this way; these cases are past the general one's tables
and reach the corners of the wide one: more than 32 components with pins
(the second component slot), more than 64 and more than 96 pins (the
third and fourth pin slots, and two-pin routes whose far end is there),
25-cell components (one component's cells a warp pass), nets of more than 32 pins (the allocation's second rank
slot), 64 components, and nets that overflow the first k components. The
beam and "both" rewards route the board's nets in two halves on two lane
slots each (``BEAM_CASES``): the web app's largest boards at width 4, nets
whose pins fill all four pin slots, and the route's layouts of 17-32 pins
a net (a net a slot) and of more (a net over two slots); for the segments'
candidate search by rank counts, pins at equal distances, full 10- and
16-pin segments and beams wider than their nets. The wide6 instantiations
of the beam and "both" kernels, the same boards with a beam route of up to
six beams (``WIDE6_CASES``), run the web app's largest boards at widths 5
and 6 and the flagship at width 6. A file of its own, so that ``--dist
loadfile`` runs it beside the others.
"""

import numpy as np
import pytest

from placement_tpu_torch.ops import _build
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils.config import load_env_params
from tests.cuda_emu import emu

#: seconds a case's emulated chunks may take
CASE_TIMEOUT = 120

#: 33..36 components of 2..5 x 2..5 cells on a 28 x 28 board
_MANY = {"height": 28, "width": 28, "min_component_h": 2,
         "max_component_h": 5, "min_component_w": 2, "max_component_w": 5,
         "min_num_components": 33, "max_num_components": 36}

#: label -> (config, overrides, steps a chunk). Each runs 10 boards, logical
#: block 4, two chained chunks: the zero boards' regeneration, then at
#: least one placed and routed episode a board.
CASES = {
    # 12 nets of 8..10 pins: 96..120 pins, all four pin slots
    "pins120": ("rectangle_pin", {
        **_MANY, "min_num_nets": 12, "max_num_nets": 12,
        "min_num_pins_per_net": 8, "max_num_pins_per_net": 10}, 40),
    # 24 nets of 2..5 pins, their weights spread wide (net distribution
    # 1): two-pin nets past pin 63, whose second pin is on slot 2 or 3
    "nets24_two_pin_tail": ("rectangle_pin", {
        **_MANY, "min_num_nets": 24, "max_num_nets": 24,
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 5,
        "net_distribution": 1}, 40),
    # the web app's largest boards on the spatial variant
    "web_max_spatial": ("rectangle_spatial_pin", {
        "height": 30, "width": 30, "min_component_h": 2,
        "max_component_h": 5, "min_component_w": 2, "max_component_w": 5,
        "min_num_components": 40, "max_num_components": 40,
        "min_num_nets": 10, "max_num_nets": 10, "min_num_pins_per_net": 2,
        "max_num_pins_per_net": 10}, 45),
    # 3 nets of 40 pins: a net's ranks 32.. on the allocation's second slot
    "ppn40": ("rectangle_pin", {
        **_MANY, "min_num_nets": 3, "max_num_nets": 3,
        "min_num_pins_per_net": 40, "max_num_pins_per_net": 40}, 40),
    # up to 64 components of 1..2 x 1..3 cells: both component slots full
    "components64": ("rectangle_pin", {
        "height": 32, "width": 32, "min_component_h": 1,
        "max_component_h": 2, "min_component_w": 1, "max_component_w": 3,
        "min_num_components": 56, "max_num_components": 64,
        "min_num_nets": 6, "max_num_nets": 6, "min_num_pins_per_net": 4,
        "max_num_pins_per_net": 4}, 66),
    # a pin spread of 0 (k0 = 1): nets of 9..10 pins overflow the first k
    # components of 1..4 cells, and the water-fill takes the residue
    "not_enough": ("rectangle_pin", {
        "height": 24, "width": 24, "min_component_h": 1,
        "max_component_h": 2, "min_component_w": 1, "max_component_w": 2,
        "min_num_components": 20, "max_num_components": 24,
        "min_num_nets": 2, "max_num_nets": 6, "min_num_pins_per_net": 9,
        "max_num_pins_per_net": 10, "pin_spread": 0}, 22),
}


#: the web app's largest boards, spatial variant
_WEB_MAX = {"height": 30, "width": 30, "min_component_h": 2,
            "max_component_h": 5, "min_component_w": 2,
            "max_component_w": 5, "min_num_components": 40,
            "max_num_components": 40, "min_num_nets": 10,
            "max_num_nets": 10, "min_num_pins_per_net": 2,
            "max_num_pins_per_net": 10}
#: 40 components of 2..5 x 2..5 cells on a 32 x 32 board
_FORTY = {**_MANY, "height": 32, "width": 32, "min_num_components": 40,
          "max_num_components": 40}

#: label -> (config, overrides, steps a chunk) under the beam and "both"
#: rewards. Each runs 8 boards, logical block 4, two chained chunks: the
#: zero boards' regeneration, then a placed and routed episode a board.
BEAM_CASES = {
    # the web_max.beam cell's configuration and width: three nets of 10
    # pins a slot, nets 0-5 in the first half and 6-9 in the second
    "web_max_spatial_beam4": ("rectangle_spatial_pin", {
        **_WEB_MAX, "reward_type": "beam", "reward_beam_width": 4}, 45),
    "web_max_spatial_both2": ("rectangle_spatial_pin", {
        **_WEB_MAX, "reward_type": "both", "reward_beam_width": 2}, 45),
    # 16 nets of 6..8 pins, their weights spread wide: up to 128 pins, on
    # all four pin slots; four nets a slot, at width 3
    "nets16_all_slots_both3": ("rectangle_pin", {
        **_FORTY, "min_num_nets": 16, "max_num_nets": 16,
        "min_num_pins_per_net": 6, "max_num_pins_per_net": 8,
        "net_distribution": 1, "reward_type": "both",
        "reward_beam_width": 3}, 40),
    # SLOTS: 4 nets of 17..30 pins, a net a lane slot
    "slots_nets4_ppn30_beam4": ("rectangle_pin", {
        **_FORTY, "min_num_nets": 4, "max_num_nets": 4,
        "min_num_pins_per_net": 17, "max_num_pins_per_net": 30,
        "reward_type": "beam", "reward_beam_width": 4}, 40),
    # SPAN: 2 nets of 36..48 pins, a net over two lane slots
    "span_nets2_ppn48_both2": ("rectangle_pin", {
        **_FORTY, "min_num_nets": 2, "max_num_nets": 2,
        "min_num_pins_per_net": 36, "max_num_pins_per_net": 48,
        "reward_type": "both", "reward_beam_width": 2}, 40),
    # the segments' candidate search by rank counts (RANKS in beam_nets):
    # 40 1 x 1 components on a lattice: pins at equal distances from a
    # beam's last pin, whose keys the rank j orders; 10 nets of up to 10
    # pins (the board's 40 cells cap them), lanes 30-31 past each slot's
    # last segment
    "lattice_1x1_nets10_ppn10_beam4": ("rectangle_pin", {
        "height": 12, "width": 12, "min_component_h": 1,
        "max_component_h": 1, "min_component_w": 1, "max_component_w": 1,
        "min_num_components": 40, "max_num_components": 40,
        "min_num_nets": 10, "max_num_nets": 10, "min_num_pins_per_net": 2,
        "max_num_pins_per_net": 10, "reward_type": "beam",
        "reward_beam_width": 4}, 45),
    # M = 10, every net full, under "both" at width 3
    "nets10_ppn10_both3": ("rectangle_pin", {
        **_FORTY, "min_num_nets": 10, "max_num_nets": 10,
        "min_num_pins_per_net": 10, "max_num_pins_per_net": 10,
        "reward_type": "both", "reward_beam_width": 3}, 40),
    # M = 16: 8 nets of 16 pins, two full 16-lane segments a slot
    "nets8_ppn16_beam4": ("rectangle_pin", {
        **_FORTY, "min_num_nets": 8, "max_num_nets": 8,
        "min_num_pins_per_net": 16, "max_num_pins_per_net": 16,
        "reward_type": "beam", "reward_beam_width": 4}, 40),
    # width 4 on 24 nets of 2..5 pins: beams of 2- and 3-pin nets take
    # visited candidates (and the positions past a net's pins)
    "nets24_ppn2_5_beam4": ("rectangle_pin", {
        **_FORTY, "min_num_nets": 24, "max_num_nets": 24,
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 5,
        "reward_type": "beam", "reward_beam_width": 4}, 40),
}


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    if emu.compiler() is None:
        pytest.skip("needs g++ to compile the kernels for the emulated warp")
    return emu.build(_build.CSRC, tmp_path_factory.mktemp("cuda_emu"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_wide_centroid_kernel_matches_plain_version(
        emulated_library, case):
    config, overrides, steps = CASES[case]
    params = load_env_params(config).replace(
        reward_type="centroid", **overrides).validate()
    assert torch_fused.kernel_tier(params) == "wide"
    batch, block, seeds = 10, 4, [11, 12]
    leaves = torch_fused.zero_leaves(params, batch, "cpu")
    got = emu.run_chunks(emulated_library, torch_fused._kernel_params(params),
                         torch_fused.leaves_to_numpy(leaves), seeds, steps,
                         block, CASE_TIMEOUT)
    routed = 0
    penalty = np.float32(torch_fused._penalty(params))
    for seed, (new, rsum, dcnt) in zip(seeds, got):
        leaves, want_r, want_d = torch_fused.rollout_chunk_reference(
            params, leaves, seed, steps, block)
        want = torch_fused.leaves_to_numpy(leaves)
        for k in torch_fused._LEAVES:
            np.testing.assert_array_equal(new[k], want[k], err_msg=k)
        np.testing.assert_array_equal(dcnt, want_d.numpy())
        # the plain version adds a board's centroid wirelength terms in
        # another order
        np.testing.assert_allclose(rsum, want_r.numpy(), rtol=0, atol=5e-4)
        routed += int((rsum != dcnt * penalty).sum())
    assert (got[0][2] >= 1).all()         # every zero board regenerated
    assert routed >= 3                    # episodes were routed


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_emulated_wide_beam_kernel_matches_plain_version(emulated_library,
                                                         case):
    config, overrides, steps = BEAM_CASES[case]
    params = load_env_params(config).replace(**overrides).validate()
    assert torch_fused.kernel_tier(params) == "wide"
    assert torch_fused.beam_slots(params.max_num_nets,
                                  params.max_num_pins_per_net) == 4
    batch, block, seeds = 8, 4, [11, 12]
    leaves = torch_fused.zero_leaves(params, batch, "cpu")
    got = emu.run_chunks(emulated_library, torch_fused._kernel_params(params),
                         torch_fused.leaves_to_numpy(leaves), seeds, steps,
                         block, CASE_TIMEOUT)
    routed = 0
    penalty = np.float32(torch_fused._penalty(params))
    for seed, (new, rsum, dcnt) in zip(seeds, got):
        leaves, want_r, want_d = torch_fused.rollout_chunk_reference(
            params, leaves, seed, steps, block)
        want = torch_fused.leaves_to_numpy(leaves)
        for k in torch_fused._LEAVES:
            np.testing.assert_array_equal(new[k], want[k], err_msg=k)
        np.testing.assert_array_equal(dcnt, want_d.numpy())
        if params.reward_type == "beam":
            np.testing.assert_array_equal(rsum, want_r.numpy())
        else:
            # where the centroid route wins, the plain version adds its
            # wirelength terms in another order
            np.testing.assert_allclose(rsum, want_r.numpy(), rtol=0,
                                       atol=5e-4)
        routed += int((rsum != dcnt * penalty).sum())
    assert (got[0][2] >= 1).all()         # every zero board regenerated
    assert routed >= 3                    # episodes were routed


#: label -> (config, overrides, steps a chunk) on the wide6 instantiations.
#: Each runs 8 boards, logical block 4, one chunk from zero boards: their
#: regeneration, then a placed and routed episode a board (the plain
#: version's beam route at width 6 takes ~20 s a chunk of 8 web_max boards).
WIDE6_CASES = {
    # the web_max.beam6 cell's configuration and width: three nets of 10
    # pins a segment slot, six beams a net; and width 5 on the same
    # instantiation
    "web_max_spatial_beam6": ("rectangle_spatial_pin", {
        **_WEB_MAX, "reward_type": "beam", "reward_beam_width": 6}, 45),
    "web_max_spatial_beam5": ("rectangle_spatial_pin", {
        **_WEB_MAX, "reward_type": "beam", "reward_beam_width": 5}, 45),
    "web_max_spatial_both6": ("rectangle_spatial_pin", {
        **_WEB_MAX, "reward_type": "both", "reward_beam_width": 6}, 45),
    # the flagship (3 nets of 6 pins, within the default tables) at the
    # Train page's widest beam: beams as wide as their nets
    "flagship_beam6": ("rectangle_pin", {
        "reward_type": "beam", "reward_beam_width": 6}, 30),
}


@pytest.mark.parametrize("case", sorted(WIDE6_CASES))
def test_emulated_wide6_beam_kernel_matches_plain_version(emulated_library,
                                                          case):
    config, overrides, steps = WIDE6_CASES[case]
    params = load_env_params(config).replace(**overrides).validate()
    assert torch_fused.kernel_tier(params) == "wide6"
    batch, block, seed = 8, 4, 11
    leaves = torch_fused.zero_leaves(params, batch, "cpu")
    (new, rsum, dcnt), = emu.run_chunks(
        emulated_library, torch_fused._kernel_params(params),
        torch_fused.leaves_to_numpy(leaves), [seed], steps, block,
        CASE_TIMEOUT)
    leaves, want_r, want_d = torch_fused.rollout_chunk_reference(
        params, leaves, seed, steps, block)
    want = torch_fused.leaves_to_numpy(leaves)
    for k in torch_fused._LEAVES:
        np.testing.assert_array_equal(new[k], want[k], err_msg=k)
    np.testing.assert_array_equal(dcnt, want_d.numpy())
    if params.reward_type == "beam":
        np.testing.assert_array_equal(rsum, want_r.numpy())
    else:
        # where the centroid route wins, the plain version adds its
        # wirelength terms in another order
        np.testing.assert_allclose(rsum, want_r.numpy(), rtol=0, atol=5e-4)
    penalty = np.float32(torch_fused._penalty(params))
    assert (dcnt >= 1).all()                        # zero boards regenerated
    assert int((rsum != dcnt * penalty).sum()) >= 3  # episodes were routed
