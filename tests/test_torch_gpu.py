"""The port's CUDA kernels against their plain PyTorch version, on the card.

This file imports no JAX, so it runs on a machine with a GPU and PyTorch
alone: ``python -m pytest tests/test_torch_gpu.py -q``. Without a CUDA
device every test skips (the kernel has no CPU mode).
"""

import json
import pathlib
import re

import pytest
import torch

from placement_tpu_torch.agent import random_policy
from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import STATE_FIELDS, EnvState
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
def test_cuda_chunk_records_the_wrapper_spans(cuda):
    """A chunk on the card records its call, with the leaf checks, the
    outputs' allocation and the launch inside it, one launch span a
    counted launch."""
    from placement_tpu_torch.utils import profiling

    params = load_env_params("rectangle_pin")
    fn = torch_fused.make_fused_rollout(params, 128, 5, device=cuda)
    leaves = torch_fused.zero_leaves(params, 128, cuda)
    torch_fused.kernel_library()
    profiling.enable()
    try:
        fn.per_board(leaves, 1)
        got = [(n, p) for n, _, _, p in profiling.spans()]
    finally:
        profiling.disable()
        profiling.reset()
    torch.cuda.synchronize()
    assert got == [("fused_rollout.per_board", -1),
                   ("fused_rollout.check", 0), ("fused_rollout.alloc", 0),
                   ("fused_rollout.launch", 0)]
    assert fn.launches == 1


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
    done counts equal, board sums equal under the beam reward and on the
    reduced kernels (+1 per placement) and within 1e-5 otherwise (the
    plain version adds a board's centroid wirelength terms in another
    order). Returns the wrapper."""
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
        if not params.has_pins or params.reward_type == "beam":
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
@pytest.mark.parametrize("name,block", [("square", 256), ("rectangle", 512)])
def test_cuda_reduced_kernels_at_4096_boards(cuda, name, block):
    """The one-warp-per-board reduced kernels at the matrix rows' batch and
    logical block: 1024 CUDA blocks of 4 boards."""
    fn = _held_to_plain(load_env_params(name), 4096, block, cuda)
    assert fn.kernel == {"square": "square", "rectangle": "rect"}[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["square", "rectangle"])
@pytest.mark.parametrize("batch,block", [(1004, 4), (20, 4)])
def test_cuda_reduced_kernels_partial_cuda_block(cuda, name, batch, block):
    """A batch that is not a multiple of a CUDA block's boards, and a
    logical block that is not the CUDA block."""
    _held_to_plain(load_env_params(name), batch, block, cuda,
                   seeds=(1, 2, 3))


#: shapes of the reduced kernels at the edges of the lane layout
REDUCED_SHAPES = {
    # SQUARE's footprint is (component_n, component_n), not the ranges
    "square_n3": ("square", {"component_n": 3}),
    # the capacity: the second lane slot of the component tables
    "rect_64_components": ("rectangle", {"min_num_components": 40,
                                         "max_num_components": 64}),
    # a cursor beyond 32 entries
    "rect_64_small_components": ("rectangle", {
        "height": 12, "width": 12, "min_component_h": 1,
        "max_component_h": 1, "min_component_w": 1, "max_component_w": 2,
        "min_num_components": 40, "max_num_components": 64}),
    # every lane holds a row, rows of 32 cells
    "rect_32x32": ("rectangle", {"height": 32, "width": 32,
                                 "min_num_components": 40,
                                 "max_num_components": 64}),
    "square_32x32": ("square", {"height": 32, "width": 32,
                                "component_n": 5}),
    # rows that straddle the 32-cell runs of the loads and stores
    "rect_17x23": ("rectangle", {"height": 17, "width": 23}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(REDUCED_SHAPES))
def test_cuda_reduced_kernels_shapes(cuda, shape):
    name, overrides = REDUCED_SHAPES[shape]
    params = load_env_params(name).replace(**overrides)
    fn = _held_to_plain(params, 256, 64, cuda)
    if shape == "rect_64_small_components":
        out, _, _ = fn(torch_fused.zero_leaves(params, 256, cuda), 9)
        assert int(out["cursor"].max()) > 32


@pytest.mark.gpu
def test_cuda_reduced_kernels_pass_pin_leaves_through(cuda):
    """A board that is not regenerated keeps its pin leaves, whatever they
    hold; a regenerated one writes -1 and no pins."""
    params = load_env_params("square")
    fn = torch_fused.make_fused_rollout(params, 64, 1, block=64,
                                        device=cuda)
    leaves, _, _ = fn(torch_fused.zero_leaves(params, 64, cuda), 1)
    marked = {k: (torch.full_like(v, 7) if k.startswith("pin_") else v)
              for k, v in leaves.items()}
    marked["num_pins"] = torch.full_like(leaves["num_pins"], 3)
    got, _, dcnt = fn.per_board(marked, 2)     # one step: no board is done
    want, _, _ = torch_fused.rollout_chunk_reference(params, marked, 2, 1, 64)
    assert int(dcnt.sum()) == 0
    for k in torch_fused._LEAVES:
        assert torch.equal(got[k], want[k]), k
    assert int(got["pin_net"].min()) == 7 and int(got["num_pins"].min()) == 3


#: the web app's largest boards (bench_matrix's web_max_pooled row): 30 x 30,
#: 40 components of 2..5 x 2..5, 10 nets of 2..10 pins, spatial variant
WEB_MAX = dict(height=30, width=30, min_component_h=2, max_component_h=5,
               min_component_w=2, max_component_w=5, min_num_components=40,
               max_num_components=40, min_num_nets=10, max_num_nets=10,
               min_num_pins_per_net=2, max_num_pins_per_net=10)


@pytest.mark.gpu
def test_cuda_wide_kernel_web_max_at_4096_boards(cuda):
    """The wide instantiation of the centroid kernel on the web app's
    largest boards at 4096 boards, logical block 256: after three chunks
    that leave the boards mid-episode, a 10-step chunk (about a quarter of
    the boards end an episode) against the plain version: leaves and done
    counts equal, board rewards within 5e-4."""
    params = load_env_params("rectangle_spatial_pin").replace(**WEB_MAX)
    assert torch_fused.kernel_tier(params) == "wide"
    fn = torch_fused.make_fused_rollout(params, 4096, 50, block=256,
                                        device=cuda)
    leaves = torch_fused.zero_leaves(params, 4096, cuda)
    for seed in (1, 2, 3):
        leaves, _, _ = fn.per_board(leaves, seed)
    short = torch_fused.make_fused_rollout(params, 4096, 10, block=256,
                                           device=cuda)
    got, got_r, got_d = short.per_board(leaves, 4)
    want, want_r, want_d = torch_fused.rollout_chunk_reference(
        params, leaves, 4, 10, 256)
    torch.cuda.synchronize()
    for k in torch_fused._LEAVES:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got_d, want_d) and int(got_d.sum()) > 256
    torch.testing.assert_close(got_r, want_r, rtol=0, atol=5e-4)
    assert (fn.launches, short.launches) == (3, 1)


@pytest.mark.gpu
def test_cuda_wide_kernel_holds_many_boards_and_refuses_past_its_tables(
        cuda):
    """The wide instantiation keeps all 4096 boards resident at once on
    the card, and its limits are refused before any launch: 65 components
    with pins, or the beam reward past the general tables."""
    params = load_env_params("rectangle_spatial_pin").replace(**WEB_MAX)
    assert torch_fused.boards_per_sm(params, "wide") * \
        torch.cuda.get_device_properties(0).multi_processor_count >= 4096
    over = params.replace(min_num_components=65, max_num_components=65,
                          height=32, width=32, min_component_h=1,
                          max_component_h=2, min_component_w=1,
                          max_component_w=2)
    with pytest.raises(ValueError, match="components=65 > 64"):
        torch_fused.make_fused_rollout(over, 128, 5, device=cuda)
    with pytest.raises(ValueError, match="pins=100 > 48"):
        torch_fused.make_fused_rollout(params.replace(reward_type="beam"),
                                       128, 5, device=cuda)


@pytest.mark.gpu
def test_cuda_library_has_only_warp_kernels(cuda):
    """The library holds the pin kernels' centroid, beam and "both"
    instantiations and the reduced kernels' square and rect ones, all one
    warp per board; no one-thread-per-board instantiation is left, and the
    reduced kernels keep their board in registers."""
    torch_fused.kernel_library()
    log = _build.library_path().with_suffix(".log").read_text()
    for k in (0, 1, 2):
        assert f"fused_rollout_warp_kernelILi{k}E" in log
    for k in (3, 4):
        assert f"fused_rollout_reduced_kernelILi{k}E" in log
    assert "fused_rollout_kernelILi" not in log
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "fused_rollout_reduced_kernel" in line and "Compiling" in line:
            props = " ".join(lines[i + 1:i + 4])
            frame = int(re.search(r"(\d+) bytes stack frame",
                                  props).group(1))
            assert frame <= 64 and " 0 bytes spill stores" in props


# ---------------------------------------------------------------------------
# The general stepper (env/core.py) on the card
# ---------------------------------------------------------------------------

STEPPER_CASES = [("rectangle_pin", {}), ("rectangle_pin", {"reward_type": "both"}),
                 ("rectangle_pin", {"reward_type": "beam",
                                    "min_num_pins_per_net": 2}),
                 ("rectangle_spatial_pin", {}), ("square", {}),
                 ("rectangle", {})]


@pytest.mark.gpu
@pytest.mark.parametrize("name,overrides", STEPPER_CASES)
def test_cuda_step_and_observe_match_cpu(cuda, name, overrides):
    """From the same states and actions, ``step`` and ``observe`` on the card
    give the CPU's results: integer fields, masks, grids, done and the
    observations equal; rewards and info within 1e-5."""
    params = load_env_params(name).replace(**overrides)
    gen = torch.Generator(cuda).manual_seed(3)
    state = core.reset(params, gen, 256, cuda)
    for _ in range(8):
        action = random_policy.random_action(gen, params, state.action_mask)
        card, reward, done, _ = core.step(params, state, action)
        cpu, c_reward, c_done, _ = core.step(params, state.to("cpu"),
                                             action.cpu())
        for f in STATE_FIELDS:
            a, b = getattr(card, f).cpu(), getattr(cpu, f)
            if a.dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
            else:
                assert torch.equal(a, b), f
        torch.testing.assert_close(reward.cpu(), c_reward, rtol=0, atol=1e-5)
        assert torch.equal(done.cpu(), c_done)
        obs_card = core.observe(params, card)
        for k, v in core.observe(params, cpu).items():
            assert torch.equal(obs_card[k].cpu(), v), k
        state = EnvState.where(done, core.reset(params, gen, 256, cuda), card)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rectangle_pin", "rectangle_spatial_pin"])
def test_cuda_step_never_waits_for_the_card(cuda, name):
    """An auto-reset step and the random policy's action enqueue their work
    without a host sync (PyTorch's sync debug mode raises on one)."""
    params = load_env_params(name)
    reset_b, step_b, obs_b = core.make_batched(params, cuda)
    gen = torch.Generator(cuda).manual_seed(4)
    state = reset_b(gen, 512)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(6):
            action = random_policy.random_action(gen, params,
                                                 state.action_mask)
            state, reward, done, _ = step_b(state, action, gen)
            obs_b(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(reward).all())


@pytest.mark.gpu
@pytest.mark.parametrize("overrides,block", [({}, 256),
                                             ({"min_num_pins_per_net": 2}, 256),
                                             ({"reward_type": "both"}, 128)])
def test_cuda_init_leaves_feed_the_kernel(cuda, overrides, block):
    """``init_leaves`` on the card: fresh boards that the kernel runs from
    exactly as its plain version does."""
    params = load_env_params("rectangle_pin").replace(**overrides)
    leaves = torch_fused.init_leaves(params, torch.Generator(cuda)
                                     .manual_seed(5), 1024, cuda)
    assert int(leaves["cursor"].sum()) == 0
    assert bool((leaves["plane0"].sum(1) > 0).all())
    fn = torch_fused.make_fused_rollout(params, 1024, 50, block=block,
                                        device=cuda)
    got, got_r, got_d = fn.per_board(leaves, 1)
    want, want_r, want_d = torch_fused.rollout_chunk_reference(
        params, leaves, 1, 50, block)
    for k in torch_fused._LEAVES:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got_d, want_d)
    torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-5)
    assert fn.launches == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["square", "rectangle", "rectangle_pin"])
def test_cuda_simulate_returns_finite_episodes(cuda, name):
    params = load_env_params(name)
    returns = random_policy.simulate(params, torch.Generator(cuda)
                                     .manual_seed(0), 512, batch=512,
                                     device=cuda)
    assert returns.device.type == "cuda" and returns.shape == (512,)
    assert bool(torch.isfinite(returns).all())


# ---------------------------------------------------------------------------
# The policy path: Policy.act and the pooled engine on the card
# ---------------------------------------------------------------------------

def _flagship_policy(device):
    """The flagship policy with the fixture's Flax weights on ``device``,
    and the fixture's observations and JAX outputs."""
    import numpy as np
    from placement_tpu_torch.agent.policy import Policy
    from placement_tpu_torch.models import convert
    from placement_tpu_torch.utils.config import load_experiment
    data = dict(np.load(FIXTURES / "torch_policy_flagship.npz"))
    variables = convert.unflatten({k[4:]: v for k, v in data.items()
                                   if k.startswith("var/")})
    params, cfg, _ = load_experiment("rectangle_pin")
    policy = Policy(params, cfg, device).load_flax(variables)
    obs = {k[4:]: torch.as_tensor(v, device=device)
           for k, v in data.items() if k.startswith("obs/")}
    return params, policy, obs, data


@pytest.mark.gpu
def test_cuda_policy_matches_cpu_and_jax(cuda):
    """The carried flagship policy on the card, with cuDNN's TF32 off: its
    logits and value within 1e-4 relative of the CPU's and of JAX's
    recorded ones; greedy actions equal where JAX's top two logits are
    further apart than that."""
    import numpy as np
    params, card, obs, data = _flagship_policy(cuda)
    _, cpu, cpu_obs, _ = _flagship_policy("cpu")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = card.act(obs, torch.Generator(cuda), deterministic=True)
    want = cpu.act(cpu_obs, torch.Generator(), deterministic=True)
    logits = got[3].cpu()
    torch.testing.assert_close(logits, want[3], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), data["logits"], rtol=1e-4,
                               atol=1e-4)
    top2 = np.sort(data["logits"], axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4 * np.abs(top2[:, 1]) + 1e-4
    assert clear.sum() >= len(clear) // 2
    np.testing.assert_array_equal(got[0].cpu().numpy()[clear],
                                  data["greedy"][clear])


@pytest.mark.gpu
@pytest.mark.parametrize("route_budget", [None, 64])
def test_cuda_pooled_step_matches_cpu(cuda, route_budget):
    """From the same carried pool, states and actions, the pooled step on
    the card gives the CPU's results: integer fields, masks, counts and
    done equal; rewards and info within 1e-5."""
    from placement_tpu_torch.agent.random_policy import random_action
    from placement_tpu_torch.env import pooled
    params = load_env_params("rectangle_pin")
    gen = torch.Generator(cuda).manual_seed(6)
    states = core.reset(params, gen, 256, cuda)
    pool = pooled.make_pool(params, gen, 4, 256)
    counts = torch.zeros((256,), dtype=torch.int32, device=cuda)
    c_states, c_pool, c_counts = states.to("cpu"), pool.to("cpu"), \
        counts.cpu()
    for t in range(12):
        action = random_action(gen, params, states.action_mask)
        if t == 2:
            action[0] = torch.tensor([0, -5, -5], device=cuda)
        states, counts, r, d, info = pooled.step_autoreset_pooled(
            params, states, action, pool, counts, route_budget)
        c_states, c_counts, c_r, c_d, c_info = pooled.step_autoreset_pooled(
            params, c_states, action.cpu(), c_pool, c_counts, route_budget)
        for f in STATE_FIELDS:
            a, b = getattr(states, f).cpu(), getattr(c_states, f)
            if a.dtype == torch.float32:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
            else:
                assert torch.equal(a, b), f
        assert torch.equal(counts.cpu(), c_counts)
        assert torch.equal(d.cpu(), c_d)
        torch.testing.assert_close(r.cpu(), c_r, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_cuda_pooled_chunk_without_budget_never_waits(cuda):
    """A pooled chunk of the random policy without ``route_budget``
    enqueues its work without a host sync (the budget's finisher count is
    the one sync a step, and only when asked for)."""
    from placement_tpu_torch.env import pooled
    params = load_env_params("rectangle_pin")
    gen = torch.Generator(cuda).manual_seed(7)
    states = core.reset(params, gen, 512, cuda)
    fn = pooled.rollout_chunk(
        params, lambda g, p, s: random_policy.random_action(
            g, p, s.action_mask), 10, 4, device=cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, r, d, wrapped = fn(states, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(d) == 512 * 2 and int(wrapped) == 0


@pytest.mark.gpu
def test_cuda_policy_rollout_and_entry(cuda):
    """The carried policy acting through the pooled engine on the card, and
    the flagship forward step of ``graft_entry.entry``."""
    from placement_tpu_torch import graft_entry
    from placement_tpu_torch.env import pooled
    params, policy, _, data = _flagship_policy(cuda)
    gen = torch.Generator(cuda).manual_seed(8)
    states = core.reset(params, gen, 1024, cuda)
    fn = pooled.rollout_chunk(params, policy.policy_fn(), 50,
                              pooled.default_pool_size(params, 50),
                              route_budget=256, device=cuda)
    states, r, d, wrapped = fn(states, gen)
    assert int(d) == 1024 * 10 and int(wrapped) == 0
    assert abs(float(r) / int(d) - float(data["rollout_mean"])) < 0.1
    f, args = graft_entry.entry()
    logits, value = f(*args)
    assert logits.device.type == "cuda" and logits.shape == (16, 400)
    assert bool(torch.isfinite(value).all())


# ---------------------------------------------------------------------------
# The learner: Policy.evaluate, one PPO update and the Trainer on the card
# ---------------------------------------------------------------------------

def _close_to_scale(got, want, rtol, atol, what):
    """max |got - want| <= rtol * max |want| + atol over the tensor."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= rtol * scale + atol, (what, err, scale)


@pytest.mark.gpu
def test_cuda_evaluate_matches_cpu(cuda):
    """``Policy.evaluate`` of the carried flagship on the fixture's
    observations (the greedy actions, JAX's logits as the behaviour), TF32
    off: logp, entropy, value, KL and the moved batch statistics within
    1e-4 relative of the CPU's."""
    from placement_tpu_torch.models import convert
    _, card, obs, data = _flagship_policy(cuda)
    _, cpu, cpu_obs, _ = _flagship_policy("cpu")
    act, beh = torch.as_tensor(data["greedy"]), torch.as_tensor(
        data["logits"])
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = card.evaluate(obs, act.to(cuda), beh.to(cuda),
                            torch.Generator(cuda))
    want = cpu.evaluate(cpu_obs, act, beh, torch.Generator())
    for name, g, w in zip(("logp", "entropy", "value", "kl"), got, want):
        _close_to_scale(g, w, 1e-4, 1e-6, name)
    g_sd = convert.to_flax(card.model.state_dict())
    w_sd = convert.to_flax(cpu.model.state_dict())
    for k in w_sd:
        if k.startswith("batch_stats/"):
            _close_to_scale(torch.as_tensor(g_sd[k]),
                            torch.as_tensor(w_sd[k]), 1e-4, 1e-6, k)


@pytest.mark.gpu
def test_cuda_update_matches_cpu(cuda):
    """One ``update`` (2 epochs of 8 minibatches of 128) of the carried
    flagship on the card, fed the CPU's rollout window and permutations,
    TF32 off: parameters and batch statistics within 1e-4 of the CPU's
    (the biases that feed a batch norm within 2 * lr a step,
    ``convert.norm_fed_biases``), ``kl_coeff`` and the loss metrics within
    1e-4 relative."""
    from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu_torch.models import convert
    params, card, _, data = _flagship_policy(cuda)
    _, cpu, _, _ = _flagship_policy("cpu")
    variables = convert.unflatten({k[4:]: v for k, v in data.items()
                                   if k.startswith("var/")})
    cfg = PPOConfig(num_envs=128, unroll_length=8, num_sgd_iter=2)
    c_learner, g_learner = PPOLearner(params, cpu, cfg), \
        PPOLearner(params, card, cfg)
    c_state = c_learner.init(torch.Generator().manual_seed(0), variables)
    g_state = g_learner.init(torch.Generator(cuda).manual_seed(0),
                             variables)
    c_state, traj, last_value, _ = c_learner.rollout(c_state)
    perm_gen = torch.Generator().manual_seed(1)
    perms = [torch.randperm(cfg.train_batch, generator=perm_gen)
             for _ in range(cfg.num_sgd_iter)]
    c_state, want = c_learner.update(c_state, traj, last_value, perms)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        g_state, got = g_learner.update(g_state, traj.to(cuda),
                                        last_value.to(cuda), perms)
    for k in want:
        _close_to_scale(got[k], want[k], 1e-4, 1e-6, k)
    g_sd = convert.to_flax(card.model.state_dict())
    w_sd = convert.to_flax(cpu.model.state_dict())
    noise = convert.norm_fed_biases(w_sd)
    steps = cfg.num_sgd_iter * cfg.train_batch // cfg.minibatch_size
    for k in w_sd:
        tol = 2 * cfg.lr * steps if k in noise else 1e-4
        err = float(abs(g_sd[k] - w_sd[k]).max())
        assert err <= tol, (k, err)


@pytest.mark.gpu
def test_cuda_trainer_keeps_its_state_on_the_card(cuda, tmp_path):
    """One iteration of a ``Trainer`` on the card: every tensor of its
    ``TrainState`` (weights, statistics, optimizer state but Adam's step
    counts, boards, accumulators, ``kl_coeff``) lies on the card."""
    from placement_tpu_torch.agent.ppo import PPOConfig
    from placement_tpu_torch.agent.trainer import Trainer
    from placement_tpu_torch.env.types import STATE_FIELDS
    trainer = Trainer("rectangle_pin", results_root=str(tmp_path),
                      ppo_config=PPOConfig(num_envs=64, unroll_length=8,
                                           num_sgd_iter=2),
                      use_tensorboard=False, run_name="card")
    try:
        state = trainer.run(num_iterations=1).state
    finally:
        trainer.close()
    tensors = dict(state.model.state_dict())
    for i, s in state.optimizer.state_dict()["state"].items():
        tensors.update({f"opt/{i}/{k}": v for k, v in s.items()
                        if k != "step"})
    tensors.update({f: getattr(state.env_states, f) for f in STATE_FIELDS})
    tensors.update(kl_coeff=state.kl_coeff, ret=state.ep_return_acc,
                   len=state.ep_len_acc)
    assert state.gen.device.type == "cuda"
    off = [k for k, v in tensors.items() if v.device.type != "cuda"]
    assert not off, off
    assert state.steps == 512


def test_trainer_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from placement_tpu_torch.agent.trainer import Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer("rectangle_pin", results_root=str(tmp_path))


@pytest.mark.gpu
def test_cuda_train_step_never_waits_for_the_card(cuda):
    """A PPO iteration (rollout without ``route_budget``, then the update)
    enqueues its work without a host sync: only the caller's read of the
    metrics waits."""
    from placement_tpu_torch.agent.policy import Policy, model_config_for
    from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
    params = load_env_params("rectangle_pin")
    learner = PPOLearner(params, Policy(
        params, model_config_for(params, "rectangle_pin"), cuda),
        PPOConfig(num_envs=64, unroll_length=8, num_sgd_iter=2))
    state = learner.init(torch.Generator(cuda).manual_seed(0))
    state, _ = learner.train_step(state)           # warm-up
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = learner.train_step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _card_update_rank(rank, world, kw, traj, last_value, perms,
                      device="cuda"):
    """One rank of a sharded ``update`` on the card (a ``spawn_ranks``
    worker), TF32 off: the carried flagship fed this rank's boards of the
    window and the whole batch's permutations."""
    from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu_torch.agent.ppo import Transition
    from placement_tpu_torch.models import convert
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.rank_device(rank, device)
    params, policy, _, data = _flagship_policy(dev)
    variables = convert.unflatten({k[4:]: v for k, v in data.items()
                                   if k.startswith("var/")})
    learner = PPOLearner(params, policy, PPOConfig(**kw)).shard(
        mesh.make_mesh(world, dev))
    state = learner.place(learner.init(torch.Generator(dev).manual_seed(0),
                                       variables))
    rows = learner.mesh.rows(last_value.shape[0])
    t = {k: ({o: x[:, rows].to(dev) for o, x in v.items()} if k == "obs"
             else v[:, rows].to(dev)) for k, v in traj.items()}
    state, metrics = learner.update(state, Transition(**t),
                                    last_value[rows].to(dev), perms)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "vars": convert.to_flax(state.model.state_dict())}


@pytest.mark.gpu
def test_cuda_sharded_update_on_a_shared_card_matches_world_one(cuda):
    """Two ranks over gloo (sharing the card on a machine with one), each
    fed its boards of a CPU rollout of the carried flagship and
    the same permutations, against world 1's ``update`` on the card, TF32
    off: metrics within 1e-4 relative, parameters within 1e-4 (the biases
    that feed a batch norm within 2 * lr a step), both ranks equal."""
    import numpy as np
    from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
    from placement_tpu_torch.models import convert
    params, card, _, data = _flagship_policy(cuda)
    _, cpu, _, _ = _flagship_policy("cpu")
    variables = convert.unflatten({k[4:]: v for k, v in data.items()
                                   if k.startswith("var/")})
    kw = dict(num_envs=128, unroll_length=4, num_sgd_iter=2)
    cfg = PPOConfig(**kw)
    c_learner = PPOLearner(params, cpu, cfg)
    _, traj, last_value, _ = c_learner.rollout(
        c_learner.init(torch.Generator().manual_seed(0), variables))
    perm_gen = torch.Generator().manual_seed(1)
    perms = [torch.randperm(cfg.train_batch, generator=perm_gen)
             for _ in range(cfg.num_sgd_iter)]
    g_learner = PPOLearner(params, card, cfg)
    g_state = g_learner.init(torch.Generator(cuda).manual_seed(0), variables)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _, want = g_learner.update(g_state, traj.to(cuda),
                                   last_value.to(cuda), perms)
    w_sd = convert.to_flax(card.model.state_dict())
    ranks = mesh.spawn_ranks(
        _card_update_rank, 2, args=(kw, traj._asdict(), last_value, perms),
        backend="gloo")
    noise = convert.norm_fed_biases(w_sd)
    steps = cfg.num_sgd_iter * cfg.train_batch // cfg.minibatch_size
    for res in ranks:
        for k in want:
            _close_to_scale(torch.tensor(res["metrics"][k]), want[k], 1e-4,
                            1e-6, k)
        for k in w_sd:
            tol = 2 * cfg.lr * steps if k in noise else 1e-4
            err = float(np.abs(res["vars"][k] - w_sd[k]).max())
            assert err <= tol, (k, err)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for k in w_sd:
        np.testing.assert_array_equal(ranks[0]["vars"][k],
                                      ranks[1]["vars"][k])


def _zoo_edge_policy(name, device):
    """The ``torch_zoo_edges.npz`` setting ``name`` on ``device``: its
    policy with the fixture's Flax weights, and its observations."""
    import dataclasses
    import numpy as np
    from placement_tpu_torch.agent.policy import Policy
    from placement_tpu_torch.models import convert
    from placement_tpu_torch.utils.config import load_experiment
    data = dict(np.load(FIXTURES / "torch_zoo_edges.npz"))
    model_type, overrides = json.loads(str(data["meta"]))[name]
    params, cfg, _ = load_experiment(model_type)
    cfg = dataclasses.replace(cfg, **overrides)
    n = len(name) + 5
    variables = convert.unflatten({k[n:]: v for k, v in data.items()
                                   if k.startswith(f"{name}/var/")})
    policy = Policy(params, cfg, device).load_flax(variables)
    obs = {k[n:]: torch.as_tensor(v, device=device) for k, v in data.items()
           if k.startswith(f"{name}/obs/")}
    return policy, obs, data


@pytest.mark.gpu
def test_cuda_empty_conv_map_matches_cpu(cuda):
    """The flagship with 3 blocks of kernel 5 (the grid encoder's map
    empties), TF32 off: eval logits and value within 1e-4 relative of the
    CPU's; a train-mode ``evaluate`` leaves NaN statistics exactly where
    the CPU's are, the others within 1e-4, and finite outputs."""
    import numpy as np
    from placement_tpu_torch.models import convert
    card, obs, data = _zoo_edge_policy("flagship_empty", cuda)
    cpu, cpu_obs, _ = _zoo_edge_policy("flagship_empty", "cpu")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.no_grad():
        got = card.model(obs)
        want = cpu.model(cpu_obs)
    legal = cpu_obs["action_mask"].reshape(want["logits"].shape) > 0
    _close_to_scale(got["logits"].cpu()[legal], want["logits"][legal],
                    1e-4, 1e-6, "logits")
    _close_to_scale(got["value"], want["value"], 1e-4, 1e-6, "value")
    act = cpu.act(cpu_obs, torch.Generator(), True)[0]
    beh = want["logits"]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = card.evaluate(obs, act.to(cuda), beh.to(cuda),
                            torch.Generator(cuda))
    ref = cpu.evaluate(cpu_obs, act, beh, torch.Generator())
    for name, g, w in zip(("logp", "entropy", "value", "kl"), out, ref):
        assert bool(torch.isfinite(g).all()), name
        _close_to_scale(g, w, 1e-4, 1e-6, name)
    g_sd = convert.to_flax(card.model.state_dict())
    w_sd = convert.to_flax(cpu.model.state_dict())
    assert np.isnan(w_sd["batch_stats/grid_conv/BatchNorm_2/mean"]).all()
    for k in w_sd:
        if k.startswith("batch_stats/"):
            np.testing.assert_array_equal(np.isnan(g_sd[k]),
                                          np.isnan(w_sd[k]), err_msg=k)
            finite = ~np.isnan(w_sd[k])
            if finite.any():
                _close_to_scale(torch.as_tensor(g_sd[k][finite]),
                                torch.as_tensor(w_sd[k][finite]), 1e-4,
                                1e-6, k)
