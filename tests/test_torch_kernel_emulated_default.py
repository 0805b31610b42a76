"""The default pin instantiations' episode end (the centroid route and the
generator's per-net allocation, on per-warp shared scratch) under the
emulated warp, against the plain PyTorch version.

``tests/test_torch_kernel_emulated.py`` holds the flagship on the default
pin kernels and the envelope on the general ones; these cases stay within
the default instantiations' capacity (sides <= 32, up to 8 nets of up to 16
pins) and reach the corners of its episode end: two-pin routes, a pin table
of 48 on both lane slots, the widest nets, varying pins per net, the spatial
variant, and nets that overflow the first k components. A file of its own,
so that ``--dist loadfile`` runs it beside the other emulated file.
"""

import numpy as np
import pytest

from placement_tpu_torch.ops import _build
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils.config import load_env_params
from tests.cuda_emu import emu
from tests.test_torch_fused_envelope import _ROOMY

#: seconds a case's emulated chunks may take
CASE_TIMEOUT = 120

#: label -> (config, overrides). Each runs 12 boards, logical block 4, two
#: chained chunks of 11 steps.
CASES = {
    # every net a two-pin route (its far end the net's second pin)
    "nets8_ppn2": ("rectangle_pin", {
        "min_num_nets": 8, "max_num_nets": 8, "min_num_pins_per_net": 2,
        "max_num_pins_per_net": 2}),
    # 48 pins: the second lane slot, DEFAULT_N nets
    "nets8_ppn6": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 8, "max_num_nets": 8,
        "min_num_pins_per_net": 6, "max_num_pins_per_net": 6}),
    # DEFAULT_M pins a net
    "nets3_ppn16": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 3, "max_num_nets": 3,
        "min_num_pins_per_net": 16, "max_num_pins_per_net": 16}),
    # 2..6 pins a net: the extra pins, then each net's allocation
    "varpin_2_6": ("rectangle_pin", {
        "min_num_pins_per_net": 2, "max_num_pins_per_net": 6}),
    "spatial": ("rectangle_spatial_pin", {"pin_spread": 3}),
    # 2..5 components of 1..4 cells and a small pin spread: nets of 6 pins
    # overflow the first k components (not_enough), and the water-fill
    # takes the residue
    "not_enough": ("rectangle_pin", {
        "min_component_h": 1, "max_component_h": 2, "min_component_w": 1,
        "max_component_w": 2, "min_num_components": 2,
        "max_num_components": 5, "pin_spread": 0}),
    # "both": the centroid route beside the beam route, 5 nets a turn
    "nets8_ppn6_both": ("rectangle_pin", {
        **_ROOMY, "min_num_nets": 8, "max_num_nets": 8,
        "min_num_pins_per_net": 6, "max_num_pins_per_net": 6,
        "reward_type": "both"}),
}


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    if emu.compiler() is None:
        pytest.skip("needs g++ to compile the kernels for the emulated warp")
    return emu.build(_build.CSRC, tmp_path_factory.mktemp("cuda_emu"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_default_pin_episode_end_matches_plain_version(
        emulated_library, case):
    config, overrides = CASES[case]
    params = load_env_params(config).replace(**overrides)
    assert torch_fused.supports(params)
    assert not torch_fused.needs_general(params)
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
        # the plain version adds a board's centroid wirelength terms in
        # another order
        np.testing.assert_allclose(rsum, want_r.numpy(), rtol=0, atol=1e-5)
    assert (got[0][2] >= 1).all()         # every zero board regenerated
    # some episodes were routed, not all penalties
    assert (rsum != dcnt * np.float32(torch_fused._penalty(params))).any()
