"""The fused rollout engine: ``placement_tpu_torch``'s main path, as users
drive it for random-policy baselines and as its throughput is quoted.

``make_fused_rollout(params, boards, steps, block=..., device=...)``'s
``per_board`` is called chunk after chunk, each chunk's output leaves the
next one's input, from all-done zero boards, with a fresh chunk seed drawn
from the run's seed. A device vector accumulates every chunk's per-board
reward sums; its fetch to the host ends a window, so the window holds all
the work it counts.

A traffic file names this engine (``"engine": "fused"``) and gives the
boards, the steps a chunk, the logical PRNG block and the reward
(``env_overrides``); a configuration file gives ``env_config``.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional

import torch

from portbench import reference, workmodel

_M32 = 0xFFFFFFFF
#: chunks run in set-up, after the library is loaded: fixed work, so
#: set-up is steady, and long enough for the card to reach its clocks
WARM_CHUNKS = 1000
#: chunks in the profiled window of a ``--trace 1`` run (the profiler's
#: events of a few thousand chunks are read back in seconds)
TRACED_CHUNKS = 3000
#: chunks enqueued while the card sleeps, a burst, to time the enqueue
#: without the launch queue's back-pressure; and the card's sleeps
ENQUEUE_CHUNKS = 200
ENQUEUE_BURSTS = 5
SLEEP_CYCLES = (4 * 10**8, 16 * 10**8)


def _splitmix32(x: int) -> int:
    """A 64-bit seed of any size -> a well-mixed 32-bit chunk-seed base."""
    z = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _M32


class Engine:
    """One cell's fused rollout on ``device``: set-up, the timed window,
    the profiled window, and the check of kept chunks against the plain
    reference."""

    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device: str, boards: Optional[int] = None,
                 warm_chunks: int = WARM_CHUNKS):
        from placement_tpu_torch.ops import fused_rollout
        from placement_tpu_torch.utils.config import env_params_from_config

        env = {**config["env_config"], **traffic["env_overrides"]}
        self.params = env_params_from_config(env)
        self.ref_params = reference.Params.from_env_config(env)
        self.boards = boards or traffic["boards"]
        self.steps = traffic["steps_per_chunk"]
        self.block = min(traffic["block"], self.boards)
        self.device = torch.device(device)
        self.fn = fused_rollout.make_fused_rollout(
            self.params, self.boards, self.steps, block=self.block,
            device=self.device)
        self.leaves = fused_rollout.zero_leaves(self.params, self.boards,
                                                self.device)
        self.acc = torch.zeros(self.boards, dtype=torch.float32,
                               device=self.device)
        self.seed_base = _splitmix32(seed)
        self.seed = seed
        self.chunks = 0
        self.kept: List[tuple] = []
        self.start: List[tuple] = []
        self.warm_chunks = warm_chunks
        self.first_chunk_s = 0.0

    # -- the chunk ---------------------------------------------------------

    def _chunk(self, keep_at: Optional[int] = None) -> None:
        chunk_seed = (self.seed_base + self.chunks) & _M32
        leaves_in = self.leaves
        self.leaves, rsum, dcnt = self.fn.per_board(leaves_in, chunk_seed)
        self.acc.add_(rsum)
        self.chunks += 1
        self._keep(keep_at, chunk_seed, leaves_in, rsum, dcnt)

    def _traced_chunk(self, keep_at: Optional[int] = None) -> None:
        """``_chunk`` with the program's call and the harness's accumulate
        each in a range of its own, for the profiler; apart from
        ``_chunk`` so that the timed window enters no range."""
        from torch.profiler import record_function

        from portbench import devtrace
        chunk_seed = (self.seed_base + self.chunks) & _M32
        leaves_in = self.leaves
        with record_function(devtrace.CHUNK):
            self.leaves, rsum, dcnt = self.fn.per_board(leaves_in,
                                                        chunk_seed)
        with record_function(devtrace.HARNESS):
            self.acc.add_(rsum)
        self.chunks += 1
        self._keep(keep_at, chunk_seed, leaves_in, rsum, dcnt)

    def _keep(self, keep_at, chunk_seed, leaves_in, rsum, dcnt) -> None:
        if keep_at is not None:
            kept = (chunk_seed, leaves_in, self.leaves, rsum, dcnt)
            if keep_at == len(self.kept):
                self.kept.append(kept)
            else:
                self.kept[keep_at] = kept

    def _sync(self) -> float:
        """Fetch the accumulated rewards: waits for every chunk enqueued."""
        return float(self.acc.sum())

    def warm(self, keep: int) -> None:
        """Set-up's work: the library's build or load on the first call,
        then ``warm_chunks`` chunks of the cell's one shape, keeping chunks
        as a window does, so the allocator holds the blocks a window
        needs and allocates nothing inside it."""
        pick = random.Random(self.seed)
        for i in range(self.warm_chunks):
            t0 = time.perf_counter()
            self._chunk(_reservoir(pick, i, keep))
            if i == 0:
                self.start = list(self.kept)
                self.first_chunk_s = time.perf_counter() - t0
        self._sync()

    # -- windows -----------------------------------------------------------

    def window(self, seconds: float, keep: int) -> Dict[str, float]:
        """Chunks for ``seconds`` of wall time, then the fetch that ends
        the window; ``keep`` of its chunks, drawn from the seed (a
        reservoir sample), are kept for the check."""
        pick = random.Random(self.seed ^ 0x5EED)
        self.kept = []
        first = self.chunks
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            i = self.chunks - first
            self._chunk(_reservoir(pick, i, keep))
            if time.perf_counter() >= deadline:
                break
        self._sync()
        wall = time.perf_counter() - t0
        n = self.chunks - first
        return {"seconds": wall, "chunks": n,
                "env_steps": n * self.boards * self.steps}

    def trace(self, keep: int) -> Dict[str, Any]:
        """The profiled window (``TRACED_CHUNKS`` chained chunks, kept as
        the timed window keeps them), then the enqueue bursts. Returns the
        reading the per-layer metrics take."""
        from portbench import devtrace

        pick = random.Random(self.seed ^ 0x5EED)
        self.kept = []
        first = self.chunks
        launches0 = self.fn.launches

        def chunk():
            self._traced_chunk(_reservoir(pick, self.chunks - first, keep))

        got = devtrace.profile(chunk, TRACED_CHUNKS, self._sync)
        got["program_launches"] = self.fn.launches - launches0
        episodes = sum(float(k[4].sum()) for k in self.kept) / len(self.kept)
        ms, by, ops, nbytes = workmodel.chunk_bound(
            self.ref_params, self.boards, self.steps, episodes, self.leaves)
        got["bound"] = {"ms": ms, "by": by, "operations": ops,
                        "bytes": nbytes, "episodes": episodes}
        got["enqueue_us"] = self._enqueue_us()
        return got

    def _enqueue_us(self) -> Optional[float]:
        """Mean host microseconds of a ``per_board`` call (no sync), from
        bursts enqueued while the card sleeps; None where the card caught
        up with the host in every try."""
        times: List[int] = []
        for _ in range(ENQUEUE_BURSTS):
            for cycles in SLEEP_CYCLES:
                start = torch.cuda.Event()
                burst = []
                torch.cuda._sleep(cycles)
                start.record()
                for _ in range(ENQUEUE_CHUNKS):
                    t0 = time.perf_counter_ns()
                    chunk_seed = (self.seed_base + self.chunks) & _M32
                    self.leaves, rsum, _ = self.fn.per_board(self.leaves,
                                                             chunk_seed)
                    burst.append(time.perf_counter_ns() - t0)
                    self.acc.add_(rsum)
                    self.chunks += 1
                ahead = not start.query()
                self._sync()
                if ahead:
                    times.extend(burst)
                    break
            else:
                return None
        return sum(times) / len(times) / 1e3

    # -- the check -----------------------------------------------------------

    def free(self) -> None:
        """Drop the program's state but the kept chunks."""
        self.leaves = self.acc = self.fn = None

    def check(self, against: Optional[torch.dtype] = None
              ) -> List[Dict[str, float]]:
        """Set-up's first chunk (from the all-done zero boards, whose first
        step takes the penalty path) and each chunk kept from the window:
        its input through the plain reference in float32, against the
        program's output (``against`` None) or against the reference in
        ``against`` put in the program's place (the control). Returns, a
        kept chunk each, the numbers compared: the leaf elements that
        differ, the largest gap of a board's done count, and of a board's
        reward sum."""
        out = []
        for chunk_seed, leaves_in, leaves_out, rsum, dcnt in (
                self.start + self.kept):
            want = reference.rollout_chunk(self.ref_params, leaves_in,
                                           chunk_seed, self.steps,
                                           self.block)
            got = (leaves_out, rsum, dcnt) if against is None else \
                reference.rollout_chunk(self.ref_params, leaves_in,
                                        chunk_seed, self.steps, self.block,
                                        against)
            out.append({
                "leaf_mismatch": float(sum(
                    int((got[0][n] != want[0][n]).sum())
                    for n in reference.LEAVES)),
                "done_gap": float(
                    (got[2].long() - want[2].long()).abs().max()),
                "reward_gap": float(
                    (got[1].double() - want[1].double()).abs().max())})
        return out


def _reservoir(pick: random.Random, i: int, keep: int) -> Optional[int]:
    """Where chunk ``i`` of a window goes in a ``keep``-slot uniform
    sample (None: not kept)."""
    if i < keep:
        return i
    j = pick.randrange(i + 1)
    return j if j < keep else None
