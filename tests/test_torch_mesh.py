"""The port's sharded fused rollout against the JAX one.

``placement_tpu_torch.parallel.mesh.shard_fused_rollout`` runs on 2 and 4
spawned CPU ranks joined by gloo (``mesh.spawn_ranks``: a ``file://`` store
in a temporary directory, a time limit on the ranks); the JAX
``placement_tpu.parallel.mesh.shard_fused_rollout`` runs on a 2- and
4-device sub-mesh of the 8 virtual CPU devices, its kernel under the Pallas
TPU interpreter. Both start from the JAX ``init_leaves(params, PRNGKey(2),
batch)`` on ``dryrun_multichip``'s config (2..3 pins per net, so the
varying-pins generator runs) and chain seeds 11 and 12. Each rank's leaves
equal its JAX shard's exactly and the episode counts are equal; the reward
sums agree within 1e-4 (f32 sums of ~40 taken in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding

from placement_tpu.env import core as jax_core
from placement_tpu.ops import fused_rollout as jax_fused
from placement_tpu.parallel import mesh as jax_mesh
from placement_tpu.utils.config import load_experiment
from placement_tpu_torch import graft_entry
from placement_tpu_torch.env.types import STATE_FIELDS, state_from_numpy
from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.parallel import mesh

STEPS, SEEDS = 4, (11, 12)
RSUM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread_per_rank(monkeypatch):
    """Spawned ranks inherit the environment: one intra-op thread each, so
    four ranks beside the other test workers do not oversubscribe the
    cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@functools.lru_cache(maxsize=None)
def _jax_chain(world, batch, block):
    """The JAX sharded rollout's start (numpy) and, per seed, (leaves,
    reward_sum, done_count); each shape is compiled and run once."""
    params = dataclasses.replace(load_experiment("rectangle_pin")[0],
                                 **graft_entry.DRYRUN_OVERRIDES)
    jmesh = jax_mesh.make_mesh(world)
    fn, spec = jax_mesh.shard_fused_rollout(params, jmesh, batch, STEPS,
                                            block=block, interpret=True)
    leaves = jax_fused.init_leaves(params, jax.random.PRNGKey(2), batch)
    start = {k: np.asarray(v) for k, v in leaves.items()}
    leaves = {k: jax.device_put(v, NamedSharding(jmesh, spec[k]))
              for k, v in leaves.items()}
    runs = []
    for seed in SEEDS:
        leaves, rsum, dcnt = fn(leaves, jnp.asarray(seed, jnp.int32))
        runs.append(({k: np.asarray(v) for k, v in leaves.items()},
                     float(rsum), int(dcnt)))
    return start, runs


def _assert_ranks_match_jax(ranks, jax_runs, batch):
    want = jax_runs[-1][0]
    local = batch // len(ranks)
    for r, res in enumerate(ranks):
        assert res["launches"] == 0          # CPU ranks run the plain version
        for k in torch_fused._LEAVES:
            np.testing.assert_array_equal(
                res["leaves"][k],
                want[k].reshape(batch, -1)[r * local:(r + 1) * local],
                err_msg=f"rank {r} leaf {k}")
        for (got_r, got_d), (_, want_r, want_d) in zip(res["totals"],
                                                       jax_runs):
            assert got_d == want_d
            assert abs(got_r - want_r) <= RSUM_TOL, (got_r, want_r)


def _port_ranks(world, batch, block, seeds):
    return mesh.spawn_ranks(
        mesh.rollout_rank, world,
        args=(graft_entry.dryrun_params(), batch, STEPS, block, list(seeds),
              "cpu"))


def _start_rank(rank, world, batch, block, start):
    """A ``spawn_ranks`` worker: this rank's shard of ``start`` (all
    ``batch`` boards, numpy) through ``shard_fused_rollout``, the seeds
    chained."""
    local = batch // world
    fn = mesh.shard_fused_rollout(graft_entry.dryrun_params(), batch, STEPS,
                                  block, device="cpu")
    state = torch_fused.leaves_from_numpy(
        {k: v[rank * local:(rank + 1) * local] for k, v in start.items()},
        "cpu")
    return mesh.chain_chunks(fn, state, SEEDS)


# block > batch // world in both cases, and in the second block < batch: the
# leaves match only if each rank's logical block is min(block, batch // n)
@pytest.mark.parametrize("world,batch,block", [(2, 8, 128), (4, 16, 8)])
def test_sharded_rollout_matches_jax(world, batch, block):
    start, jax_runs = _jax_chain(world, batch, block)
    ranks = mesh.spawn_ranks(_start_rank, world,
                             args=(batch, block, start))
    _assert_ranks_match_jax(ranks, jax_runs, batch)


def test_sharded_rollout_from_carried_reset_states():
    """The JAX reset states behind ``init_leaves(PRNGKey(2))``, carried
    across field by field (``state_from_numpy``) and laid out by the port's
    ``leaves_from_states``, are the JAX leaves exactly; sharded over 2 CPU
    ranks they give the JAX ``shard_fused_rollout``'s leaves and totals."""
    world, batch, block = 2, 8, 128
    start, jax_runs = _jax_chain(world, batch, block)
    jp = dataclasses.replace(load_experiment("rectangle_pin")[0],
                             **graft_entry.DRYRUN_OVERRIDES)
    states = jax.vmap(lambda k: jax_core.reset(jp, k))(
        jax.random.split(jax.random.PRNGKey(2), batch))
    carried = torch_fused.leaves_from_states(
        graft_entry.dryrun_params(), state_from_numpy(
            {f: np.asarray(getattr(states, f)) for f in STATE_FIELDS},
            "cpu"))
    carried = torch_fused.leaves_to_numpy(carried)
    for k in torch_fused._LEAVES:
        np.testing.assert_array_equal(carried[k],
                                      start[k].reshape(batch, -1), err_msg=k)
    ranks = mesh.spawn_ranks(_start_rank, world,
                             args=(batch, block, carried))
    _assert_ranks_match_jax(ranks, jax_runs, batch)


def test_each_rank_runs_its_shard_with_seed_plus_rank():
    """Two ranks on identical all-done zero shards: each equals the
    unsharded rollout of its shard at seed + rank, so their streams differ,
    and the reduced totals are the sums of the ranks' own."""
    params = graft_entry.dryrun_params()
    world, batch, local = 2, 8, 4
    ranks = _port_ranks(world, batch, 128, [11])
    sums, counts = [], []
    for r, res in enumerate(ranks):
        fn = torch_fused.make_fused_rollout(params, local, STEPS, block=128,
                                            device="cpu")
        want, rsum, dcnt = fn(torch_fused.zero_leaves(params, local, "cpu"),
                              11 + r)
        for k in torch_fused._LEAVES:
            np.testing.assert_array_equal(res["leaves"][k], want[k].numpy(),
                                          err_msg=f"rank {r} leaf {k}")
        sums.append(float(rsum))
        counts.append(int(dcnt))
    assert any(not np.array_equal(ranks[0]["leaves"][k],
                                  ranks[1]["leaves"][k])
               for k in torch_fused._LEAVES)
    for res in ranks:
        got_r, got_d = res["totals"][0]
        assert got_d == sum(counts)
        assert abs(got_r - sum(sums)) <= RSUM_TOL


def test_batch_must_divide_over_ranks():
    with pytest.raises(Exception, match="batch 9 not divisible by 2 ranks"):
        _port_ranks(2, 9, 128, [11])


def test_one_process_is_the_unsharded_rollout():
    """Without a process group: world 1, the logical block clamped to the
    batch, the leaves of ``make_fused_rollout`` at the same seed."""
    mesh.initialize_distributed(world_size=1)
    assert not dist.is_initialized()
    params = graft_entry.dryrun_params()
    fn = mesh.shard_fused_rollout(params, 8, STEPS, block=128, device="cpu")
    assert (fn.rank, fn.world, fn.local.block) == (0, 1, 8)
    got, got_r, got_d = fn(torch_fused.zero_leaves(params, 8, "cpu"), 11)
    want, want_r, want_d = torch_fused.make_fused_rollout(
        params, 8, STEPS, device="cpu")(
        torch_fused.zero_leaves(params, 8, "cpu"), 11)
    for k in torch_fused._LEAVES:
        assert torch.equal(got[k], want[k]), k
    assert int(got_d) == int(want_d) and float(got_r) == float(want_r)


def test_logical_block_is_in_the_stream():
    """What the JAX comparison above rests on: the same boards and seed
    under another logical block give other leaves."""
    params = graft_entry.dryrun_params()
    leaves = torch_fused.zero_leaves(params, 8, "cpu")
    by_block = [torch_fused.make_fused_rollout(
        params, 8, STEPS, block=b, device="cpu")(leaves, 11)[0]
        for b in (4, 8)]
    assert any(not torch.equal(by_block[0][k], by_block[1][k])
               for k in torch_fused._LEAVES)


def test_dryrun_multigpu_runs_on_cpu_ranks():
    results = graft_entry.dryrun_multigpu(2, device="cpu")
    assert len(results) == 2
    for res in results:
        (reward, episodes), = res["totals"]
        assert np.isfinite(reward) and reward < 0 and episodes >= 8
        assert res["launches"] == 0
        assert res["leaves"]["grid"].shape == (4, 36)


def test_dryrun_multigpu_without_a_card_raises():
    """The entry point runs on the card unless the CPU is asked for: with
    no CUDA device it raises before spawning a rank."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multigpu(2)


def test_sharded_entry_points_default_to_the_card():
    """``shard_fused_rollout`` and ``rollout_rank`` run on the card unless
    the caller passes ``device="cpu"``: CPU leaves are refused."""
    params = graft_entry.dryrun_params()
    fn = mesh.shard_fused_rollout(params, 8, STEPS)
    assert fn.local.device.type == "cuda"
    with pytest.raises(ValueError, match="expected cuda"):
        fn(torch_fused.zero_leaves(params, 8, "cpu"), 11)
    defaults = mesh.rollout_rank.__defaults__
    assert defaults == ("cuda",)
