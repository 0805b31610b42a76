"""The port's CUDA kernels against their plain PyTorch version, on the card.

This file imports no JAX, so it runs on a machine with a GPU and PyTorch
alone: ``python -m pytest tests/test_torch_gpu.py -q``. Without a CUDA
device every test skips (the kernel has no CPU mode).
"""

import pytest
import torch

from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils.config import load_env_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rectangle_pin", "rectangle_spatial_pin"])
def test_cuda_kernel_matches_plain_version(cuda, name):
    params = load_env_params(name)
    batch, block = 512, 256
    fn = torch_fused.make_fused_rollout(params, batch, 50, block=block,
                                        device=cuda)
    leaves = torch_fused.zero_leaves(params, batch, cuda)
    for seed in (1, 2):
        got, got_r, got_d = fn.per_board(leaves, seed)
        want, want_r, want_d = torch_fused.rollout_chunk_reference(
            params, leaves, seed, 50, block)
        torch.cuda.synchronize()
        for k in torch_fused._LEAVES:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got_d, want_d)
        # per board: one f32 sum of <= 10 episode rewards, each a sum of
        # <= 18 sqrt terms taken in another order
        torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-5)
        leaves = got
    assert fn.launches == 2


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_leaves(cuda):
    params = load_env_params("rectangle_pin")
    fn = torch_fused.make_fused_rollout(params, 128, 5, device=cuda)
    leaves = torch_fused.zero_leaves(params, 128, cuda)
    with pytest.raises(ValueError, match="plane0"):
        fn({**leaves, "plane0": leaves["plane0"].t().contiguous().t()}, 1)
    with pytest.raises(ValueError, match="grid"):
        fn({**leaves, "grid": leaves["grid"].cpu()}, 1)
    assert fn.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,overrides,block", [
    ("rectangle_pin", {"reward_type": "beam"}, 128),
    ("rectangle_pin", {"reward_type": "beam", "reward_beam_width": 4}, 128),
    # a beam wider than a net's lanes: every lane taken (the INF2 path)
    ("rectangle_pin", {"reward_type": "beam", "reward_beam_width": 4,
                       "min_num_pins_per_net": 3,
                       "max_num_pins_per_net": 3}, 128),
    ("rectangle_pin", {"reward_type": "both"}, 128),
    ("square", {}, 256),
    ("rectangle", {}, 512),
])
def test_cuda_specialisations_match_plain_version(cuda, name, overrides,
                                                  block):
    params = load_env_params(name).replace(**overrides)
    batch = 512
    fn = torch_fused.make_fused_rollout(params, batch, 50, block=block,
                                        device=cuda)
    leaves = torch_fused.zero_leaves(params, batch, cuda)
    for seed in (1, 2):
        got, got_r, got_d = fn.per_board(leaves, seed)
        want, want_r, want_d = torch_fused.rollout_chunk_reference(
            params, leaves, seed, 50, block)
        torch.cuda.synchronize()
        for k in torch_fused._LEAVES:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got_d, want_d)
        if params.has_pins and params.reward_type == "beam":
            # one correctly rounded sqrt per segment, added in one order
            assert torch.equal(got_r, want_r)
        elif params.has_pins:
            # "both": the centroid route's terms are summed in another order
            torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-5)
        else:
            assert torch.equal(got_r, want_r)     # +1 per placement
        leaves = got
    assert fn.launches == 2


@pytest.mark.gpu
def test_cuda_wrapper_rejects_over_capacity_before_launch(cuda):
    params = load_env_params("rectangle").replace(
        max_num_components=65, min_num_components=65)
    ok, reasons = torch_fused.envelope_report(params)
    assert not ok and "components_nopin=65 > 64" in reasons
    # make_fused_rollout refuses it: no wrapper exists that could launch
    with pytest.raises(ValueError, match="components_nopin"):
        torch_fused.make_fused_rollout(params, 128, 5, device=cuda)
