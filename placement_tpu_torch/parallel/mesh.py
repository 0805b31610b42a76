"""The fused rollout over several ranks (port of
``placement_tpu/parallel/mesh.py``: ``initialize_distributed`` and
``shard_fused_rollout``).

The JAX package runs one program over a device mesh: boards sharded on the
``dp`` axis under ``shard_map``, the kernel per device, a ``psum`` of the
chunk's two totals. Here each rank is a process of a ``torch.distributed``
group. A rank holds its own board shard (its leaves dict *is* the shard, so
``PartitionSpec`` has no counterpart), runs the same kernel on it with seed
``seed + rank``, and ``all_reduce``s the reward sum and the done count,
nothing else. Leaves never leave their rank.

Backends: NCCL where every rank has a GPU of its own, gloo for CPU ranks
and for ranks that share one card (``backend_for``). The backend only
carries the two totals; a CUDA rank runs the kernel or raises.

``make_mesh``, ``batch_sharding``, ``replicated``, ``shard_learner`` and
``shard_env_batch`` serve the learner and the general stepper and are not
ported yet (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import pathlib
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from placement_tpu_torch.env.types import EnvParams
from placement_tpu_torch.ops import fused_rollout


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: str = "gloo") -> None:
    """Join this process to a group of ``world_size`` ranks (e.g.
    ``init_method="tcp://localhost:29500"``). No-op for one process."""
    if world_size and world_size > 1:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)


def backend_for(device: str, world_size: int) -> str:
    """NCCL when every rank can have a GPU of its own, otherwise gloo."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


#: seconds the ranks of one ``spawn_ranks`` call may take
RANK_TIMEOUT = 300.0


class _ShardedRollout:
    """What ``shard_fused_rollout`` returns. ``local`` is the rank's
    ``FusedRollout`` (and its ``launches``)."""

    def __init__(self, params: EnvParams, batch: int, num_steps: int,
                 block: int, device: fused_rollout.Device):
        grouped = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if grouped else 0
        self.world = dist.get_world_size() if grouped else 1
        if batch % self.world:
            raise ValueError(f"batch {batch} not divisible by "
                             f"{self.world} ranks")
        self.local = fused_rollout.make_fused_rollout(
            params, batch // self.world, num_steps, block=block,
            device=device)

    def __call__(self, leaves: Dict[str, torch.Tensor], seed: int
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            torch.Tensor]:
        out, rsum, dcnt = self.local(
            leaves, (int(seed) + self.rank) & 0xFFFFFFFF)
        if self.world > 1:
            dist.all_reduce(rsum)
            dist.all_reduce(dcnt)
        return out, rsum, dcnt


def shard_fused_rollout(params: EnvParams, batch: int, num_steps: int,
                        block: int = 128,
                        device: fused_rollout.Device = "cuda"
                        ) -> _ShardedRollout:
    """The fused rollout over the ranks of the current process group (one
    rank without a group), the JAX ``shard_fused_rollout`` (:103-145):
    ``fn(local_leaves, seed) -> (leaves', reward_sum, done_count)`` on this
    rank's ``batch // world`` boards (``batch`` counts the boards of all
    ranks), the totals summed over the ranks. The logical block, which is
    in the PRNG salt, is the JAX wrapper's ``min(block, batch // world)``:
    ``make_fused_rollout`` clamps ``block`` to the rank's boards."""
    return _ShardedRollout(params, batch, num_steps, block, device)


# ---------------------------------------------------------------------------
# Running ranks: one spawned process each
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, tmp: str, backend: str,
               worker: Callable, args: Sequence[Any]) -> None:
    initialize_distributed(f"file://{tmp}/store", world, rank, backend)
    try:
        result = worker(rank, world, *args)
    finally:
        if world > 1:
            dist.destroy_process_group()
    pathlib.Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(result))


def spawn_ranks(worker: Callable, world: int, args: Sequence[Any] = (),
                backend: str = "gloo") -> List[Any]:
    """Run ``worker(rank, world, *args)`` (a module-level function) in
    ``world`` spawned processes joined into one group (a ``file://`` store
    in a temporary directory) and return its results by rank. Raises if a
    rank raises, dies or is still running after ``RANK_TIMEOUT`` seconds;
    no rank outlives the call."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(world, tmp, backend, worker, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.01)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{RANK_TIMEOUT} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        return [pickle.loads(pathlib.Path(tmp, f"rank{r}.pkl").read_bytes())
                for r in range(world)]


def chain_chunks(fn: _ShardedRollout, state: Dict[str, torch.Tensor],
                 seeds: Sequence[int]) -> Dict[str, Any]:
    """One chunk of ``fn`` per seed from ``state``, chained. Returns the
    rank's leaves (numpy), each chunk's reduced ``(reward_sum,
    done_count)`` and the rank's kernel launches."""
    totals = []
    for seed in seeds:
        state, rsum, dcnt = fn(state, seed)
        totals.append((float(rsum), int(dcnt)))
    return {"leaves": fused_rollout.leaves_to_numpy(state), "totals": totals,
            "launches": fn.local.launches}


def _rank_device(rank: int, device: str) -> str:
    """A CUDA rank's card: ``rank % device_count``, made current."""
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    return device


def rollout_rank(rank: int, world: int, params: EnvParams, batch: int,
                 num_steps: int, block: int, seeds: Sequence[int],
                 device: str = "cuda") -> Dict[str, Any]:
    """One rank of a sharded run (a ``spawn_ranks`` worker): this rank's
    ``batch // world`` all-done zero boards through ``shard_fused_rollout``
    (``chain_chunks``). A CUDA rank takes card ``rank % device_count``."""
    device = _rank_device(rank, device)
    fn = shard_fused_rollout(params, batch, num_steps, block, device)
    return chain_chunks(
        fn, fused_rollout.zero_leaves(params, batch // world, device), seeds)


def reset_rollout_rank(rank: int, world: int, params: EnvParams, batch: int,
                       num_steps: int, block: int, seeds: Sequence[int],
                       reset_seed: int, device: str = "cuda"
                       ) -> Dict[str, Any]:
    """``rollout_rank`` from reset boards: this rank's ``batch // world``
    fresh instances of the stepper's reset (``fused_rollout.init_leaves``,
    a generator on the rank's device seeded ``reset_seed + rank``)."""
    device = _rank_device(rank, device)
    fn = shard_fused_rollout(params, batch, num_steps, block, device)
    gen = torch.Generator(device).manual_seed(reset_seed + rank)
    return chain_chunks(
        fn, fused_rollout.init_leaves(params, gen, batch // world, device),
        seeds)
