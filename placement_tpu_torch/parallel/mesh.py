"""Data parallelism over ranks (port of ``placement_tpu/parallel/mesh.py``).

The JAX package runs one program over a 1-D device mesh: boards sharded on
the ``dp`` axis, parameters replicated, the PPO loss's reductions lowered by
GSPMD to ``psum`` collectives. Here each rank is a process of a
``torch.distributed`` group, and a ``Mesh`` is what that process knows of
it: the group, its rank, the world size and its device.

* **The learner** (``shard_learner``): a rank holds its own rows
  ``[rank * B / world, (rank + 1) * B / world)`` of the single-process
  board batch and episode accumulators; the model, optimizer, KL
  coefficient, generator and sample count are whole on every rank. Every
  rank advances one common ``torch.Generator`` as one process would,
  drawing each random tensor at the whole batch's shape and keeping its
  rows, so world n computes what world 1 computes (``agent/ppo.py``).
* **The fused rollout** (``shard_fused_rollout``): a rank runs the kernel
  on its board shard with seed ``seed + rank`` and ``all_reduce``s the
  chunk's reward sum and done count, nothing else.

Backends: NCCL where every rank has a GPU of its own, gloo for CPU ranks
and for ranks that share one card (``backend_for``). Gloo carries only
``broadcast`` and ``all_reduce`` for CUDA tensors, so an all-gather here
is an ``all_reduce`` of a zero-filled global buffer (``gather_rows``), on
either backend.
"""

from __future__ import annotations

import dataclasses
import pathlib
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import STATE_FIELDS, EnvParams, EnvState
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


# ---------------------------------------------------------------------------
# The learner half: the mesh, board rows, collectives, shard_learner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a data-parallel run as this process sees them (JAX's
    1-D ``dp`` mesh): ``group`` is the process group (None for one
    process), ``device`` this rank's device."""

    group: Any
    rank: int
    world: int
    device: torch.device

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows split over the ranks."""
        if n % self.world:
            raise ValueError(f"{n} rows not divisible by {self.world} ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (as is for one rank)."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t


def rank_device(rank: int, device: str) -> str:
    """A CUDA rank's card: ``rank % device_count``, made current."""
    if torch.device(device).type == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    return device


def make_mesh(n_ranks: Optional[int] = None,
              device: core.Device = "cuda") -> Mesh:
    """The mesh of the current process group (one rank without a group).
    ``n_ranks``, when given, must be the group's size: one process is one
    rank. A CUDA rank takes card ``rank % device_count`` (a card each when
    a host has as many cards as ranks); raises without a card unless the
    CPU is asked for."""
    core.check_device(device, "make_mesh")
    grouped = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"make_mesh({n_ranks}): this process group has "
                         f"{world} rank(s); one process is one rank")
    return Mesh(dist.group.WORLD if grouped else None, rank, world,
                torch.device(rank_device(rank, str(device))))


def batch_sharding(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> this rank's rows of x``: the leading (board) axis split over
    the ranks (JAX ``NamedSharding(mesh, P("dp"))``)."""
    return lambda x: x[mesh.rows(x.shape[0])]


def replicated(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> x``, raising unless ``x`` is bitwise the same on every rank
    (JAX ``NamedSharding(mesh, P())``, which holds one value for all
    devices). A collective: every rank calls it on the same tensors."""
    def check(x: torch.Tensor) -> torch.Tensor:
        if mesh.world > 1:
            raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
            ref = raw.clone()
            dist.broadcast(ref, 0, group=mesh.group)
            if not torch.equal(ref, raw):
                raise RuntimeError(f"rank {mesh.rank}: a replicated tensor "
                                   f"of shape {tuple(x.shape)} differs "
                                   f"from rank 0's")
        return x
    return check


def shard_env_batch(mesh: Mesh, states: EnvState) -> EnvState:
    """This rank's boards of a batched ``EnvState`` (each field's rows,
    copied)."""
    take = batch_sharding(mesh)
    return EnvState(**{f: take(getattr(states, f)).clone()
                       for f in STATE_FIELDS})


def gather_rows(mesh: Mesh, tensors: Sequence[torch.Tensor], dim: int = 0
                ) -> List[torch.Tensor]:
    """Every rank's ``tensors`` joined along ``dim`` in rank order: the
    global tensors, on every rank. One ``all_reduce`` of a zero-filled
    ``uint8`` buffer of all ranks' bytes, in which each rank fills its own
    row (a sum with one non-zero term is exact): gloo has no all-gather of
    CUDA tensors, so both backends take this one path."""
    if mesh.world == 1:
        return list(tensors)
    parts = [t.movedim(dim, 0).contiguous() for t in tensors]
    local = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])
    buf = torch.zeros((mesh.world, local.numel()), dtype=torch.uint8,
                      device=local.device)
    buf[mesh.rank] = local
    dist.all_reduce(buf, group=mesh.group)
    out, off = [], 0
    for p in parts:
        nbytes = p.numel() * p.element_size()
        whole = buf[:, off:off + nbytes].contiguous().view(p.dtype)
        out.append(whole.reshape((mesh.world * p.shape[0],) + p.shape[1:])
                   .movedim(0, dim))
        off += nbytes
    return out


def shard_learner(learner, mesh: Mesh) -> Tuple[Callable, Callable]:
    """A ``PPOLearner``'s train step over the mesh (JAX ``:51-89``).
    Returns ``(place, train_step)``: ``place`` cuts a freshly initialised
    single-process ``TrainState`` down to this rank's boards and episode
    accumulators (the rest stays whole); ``train_step`` is the sharded
    step, with one all-reduce of the gradients a minibatch step. Raises
    unless the ranks divide ``num_envs`` and ``minibatch_size``."""
    sharded = learner.shard(mesh)
    return sharded.place, sharded.train_step


# ---------------------------------------------------------------------------
# The fused rollout over the ranks
# ---------------------------------------------------------------------------

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

def _rank_main(local_rank: int, first_rank: int, world: int,
               init_method: Optional[str], tmp: str, backend: str,
               worker: Callable, args: Sequence[Any]) -> None:
    rank = first_rank + local_rank
    initialize_distributed(init_method or f"file://{tmp}/store", world,
                           rank, backend)
    try:
        result = worker(rank, world, *args)
    finally:
        if world > 1:
            dist.destroy_process_group()
    pathlib.Path(tmp, f"rank{local_rank}.pkl").write_bytes(
        pickle.dumps(result))


def spawn_ranks(worker: Callable, world: int, args: Sequence[Any] = (),
                backend: str = "gloo", *, local: Optional[int] = None,
                first_rank: int = 0, init_method: Optional[str] = None,
                timeout: Optional[float] = RANK_TIMEOUT) -> List[Any]:
    """Run ``worker(rank, world, *args)`` (a module-level function) in
    spawned processes joined into one group of ``world`` ranks and return
    its results by rank. By default all ``world`` ranks start here and
    meet at a ``file://`` store in a temporary directory; a host of a
    multi-host group starts its ``local`` ranks, ``first_rank`` onwards,
    and they meet the other hosts' at ``init_method`` (``tcp://host:port``).
    Raises if a rank raises, dies or is still running after ``timeout``
    seconds (None: no limit); no rank outlives the call."""
    local = world if local is None else local
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(first_rank, world, init_method, tmp, backend,
                              worker, args),
            nprocs=local, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=None if deadline is None else max(
                    deadline - time.monotonic(), 0.01)):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{local} ranks still running after "
                                       f"{timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        return [pickle.loads(pathlib.Path(tmp, f"rank{r}.pkl").read_bytes())
                for r in range(local)]


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


def rollout_rank(rank: int, world: int, params: EnvParams, batch: int,
                 num_steps: int, block: int, seeds: Sequence[int],
                 device: str = "cuda") -> Dict[str, Any]:
    """One rank of a sharded run (a ``spawn_ranks`` worker): this rank's
    ``batch // world`` all-done zero boards through ``shard_fused_rollout``
    (``chain_chunks``). A CUDA rank takes card ``rank % device_count``."""
    device = rank_device(rank, device)
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
    device = rank_device(rank, device)
    fn = shard_fused_rollout(params, batch, num_steps, block, device)
    gen = torch.Generator(device).manual_seed(reset_seed + rank)
    return chain_chunks(
        fn, fused_rollout.init_leaves(params, gen, batch // world, device),
        seeds)
