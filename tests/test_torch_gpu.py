"""The port's CUDA kernels against their plain PyTorch version, on the card.

This file imports no JAX, so it runs on a machine with a GPU and PyTorch
alone: ``python -m pytest tests/test_torch_gpu.py -q``. Without a CUDA
device every test skips (the kernel has no CPU mode).
"""

import json
import pathlib

import pytest
import torch

from placement_tpu_torch.ops import _build
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.parallel import mesh
from placement_tpu_torch.utils.config import load_env_params

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


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


def _varpin_params(name):
    """A varying-pins-per-net config of test_torch_fused_varpin.py, read
    from its golden (that file imports JAX)."""
    golden = json.loads((FIXTURES / f"torch_fused_zero_b128_varpin_{name}"
                         ".json").read_text())
    return load_env_params(golden["config"]).replace(**golden["overrides"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["web", "parity"])
def test_cuda_varpin_matches_plain_version(cuda, name):
    params = _varpin_params(name)
    assert params.max_num_pins_per_net > params.min_num_pins_per_net
    batch, block = 512, 128
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
        # centroid terms summed in another order (see above)
        torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-5)
        leaves = got
    npins = leaves["num_pins"]
    assert int(npins.min()) < int(npins.max())
    assert fn.launches == 2


@pytest.mark.gpu
def test_cuda_shard_fused_rollout_one_rank_is_the_kernel(cuda):
    """``shard_fused_rollout`` without a process group launches the kernel
    once per call and gives the unsharded kernel's leaves and totals."""
    params = _varpin_params("web")
    sharded = mesh.shard_fused_rollout(params, 1024, 50, block=256,
                                       device=cuda)
    plain = torch_fused.make_fused_rollout(params, 1024, 50, block=256,
                                           device=cuda)
    got = want = torch_fused.zero_leaves(params, 1024, cuda)
    for seed in (5, 6):
        got, got_r, got_d = sharded(got, seed)
        want, want_r, want_d = plain(want, seed)
        for k in torch_fused._LEAVES:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got_r, want_r) and torch.equal(got_d, want_d)
    assert sharded.local.launches == plain.launches == 2


@pytest.mark.gpu
def test_cuda_wrapper_rejects_over_capacity_before_launch(cuda):
    params = load_env_params("rectangle").replace(
        max_num_components=65, min_num_components=65)
    ok, reasons = torch_fused.envelope_report(params)
    assert not ok and "components_nopin=65 > 64" in reasons
    # make_fused_rollout refuses it: no wrapper exists that could launch
    with pytest.raises(ValueError, match="components_nopin"):
        torch_fused.make_fused_rollout(params, 128, 5, device=cuda)


def _held_to_plain(params, batch, block, device, seeds=(1, 2)):
    """Chained chunks of the kernel against the plain version: leaves and
    done counts equal, board sums equal under the beam reward and within
    1e-5 otherwise (the plain version adds a board's centroid wirelength
    terms in another order). Returns the wrapper."""
    fn = torch_fused.make_fused_rollout(params, batch, 50, block=block,
                                        device=device)
    leaves = torch_fused.zero_leaves(params, batch, device)
    for seed in seeds:
        got, got_r, got_d = fn.per_board(leaves, seed)
        want, want_r, want_d = torch_fused.rollout_chunk_reference(
            params, leaves, seed, 50, block)
        torch.cuda.synchronize()
        for k in torch_fused._LEAVES:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(got_d, want_d)
        if params.reward_type == "beam":
            assert torch.equal(got_r, want_r)
        else:
            torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-5)
        leaves = got
    assert fn.launches == len(seeds)
    return fn


@pytest.mark.gpu
def test_cuda_warp_kernel_varpin_web_at_4096_boards(cuda):
    """The one-warp-per-board centroid kernel on main path 3's config at
    its full batch: 512 CUDA blocks of 8 boards."""
    params = _varpin_params("web")
    fn = _held_to_plain(params, 4096, 256, cuda)
    assert fn.kernel == "centroid"


@pytest.mark.gpu
@pytest.mark.parametrize("batch,block", [(1004, 4), (20, 4)])
def test_cuda_warp_kernel_partial_cuda_block(cuda, batch, block):
    """A batch that is not a multiple of the 8 boards of a CUDA block: the
    last block's idle warps return whole, and the logical block (not the
    CUDA geometry) sets each board's random stream."""
    assert batch % 8
    _held_to_plain(load_env_params("rectangle_pin"), batch, block, cuda)


#: the kernel's capacity shape under the beam reward: 3 nets x 16 pins (48
#: pins, a second pin slot; N * M > 32, so the warp kernel routes the nets
#: in turns of two), beam width 4
BEAM_CAPACITY = {"reward_type": "beam", "reward_beam_width": 4,
                 "min_component_h": 3, "max_component_h": 3,
                 "min_component_w": 3, "max_component_w": 3,
                 "min_num_pins_per_net": 16, "max_num_pins_per_net": 16}


@pytest.mark.gpu
@pytest.mark.parametrize("overrides", [
    {"reward_type": "beam", "reward_beam_width": 1},
    {"reward_type": "beam", "reward_beam_width": 2},
    {"reward_type": "beam", "reward_beam_width": 3},
    {"reward_type": "beam", "reward_beam_width": 4},
    {"reward_type": "both"},
    BEAM_CAPACITY,
])
def test_cuda_warp_beam_kernels_match_plain_version(cuda, overrides):
    params = load_env_params("rectangle_pin").replace(**overrides)
    fn = _held_to_plain(params, 512, 128, cuda)
    assert fn.kernel == params.reward_type
    if params.max_pins > 32:
        assert int(fn(torch_fused.zero_leaves(params, 512, cuda), 9)[0][
            "num_pins"].max()) > 32


@pytest.mark.gpu
def test_cuda_warp_both_kernel_varpin_parity(cuda):
    """The "both" warp kernel on the parity geometry: 4 nets of 2..5 pins,
    episodes of 3..6 placements."""
    params = _varpin_params("parity")
    fn = _held_to_plain(params, 1024, 128, cuda, seeds=(1, 2, 3))
    assert fn.kernel == "both"


@pytest.mark.gpu
@pytest.mark.parametrize("reward_type", ["beam", "both"])
def test_cuda_warp_beam_kernels_partial_cuda_block(cuda, reward_type):
    _held_to_plain(load_env_params("rectangle_pin").replace(
        reward_type=reward_type), 1004, 4, cuda)


@pytest.mark.gpu
def test_cuda_centroid_has_only_the_warp_kernel(cuda):
    """The library holds the warp kernel's centroid, beam and "both"
    instantiations and no per-thread pin instantiation; square and rect
    are still per-thread templates."""
    torch_fused.kernel_library()
    log = _build.library_path().with_suffix(".log").read_text()
    for k in (0, 1, 2):
        assert f"fused_rollout_warp_kernelILi{k}E" in log
        assert f"fused_rollout_kernelILi{k}E" not in log
    for k in (3, 4):
        assert f"fused_rollout_kernelILi{k}E" in log
