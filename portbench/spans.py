"""The program's own spans around the fused rollout's wrapper, read on the
card in two phases after a cell's set-up, both with the program's spans on
(``placement_tpu_torch.utils.profiling``):

  (a) ``enqueue_split``: bursts of chunks enqueued while the card sleeps,
      the method of ``engines/fused.py``'s enqueue reading, with no
      profiler; only bursts the card stayed ahead of count. It splits a
      ``per_board`` call into its leaf checks, its outputs' allocation, its
      launch and the rest (the call's self time).
  (b) ``idle_by_span``: a window of chunks under ``torch.profiler``, where
      each span is also a range among the profiler's events; each gap in
      the device's activity goes to the innermost ``fused_rollout.*``
      range around its middle, or to ``OUTSIDE``.

A reading is trusted only where the buffer dropped no span and the launch
spans match the launches ``FusedRollout.launches`` counted (``mean_us``).

    python -m portbench.spans --workload <name> --seed <n>

runs a cell's set-up with the spans on, then ``ROUNDS`` rounds of the
engine's own enqueue reading with them off and (a), in turns so that the
host's drift falls on both alike, then (b) with the profiler's own label
of each gap beside it (``devtrace``'s innermost host event); it prints one
JSON line. The harness's runs (``portbench/run.py``) leave the spans off.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from portbench import devtrace, manifest

PER_BOARD = "fused_rollout.per_board"
CHECK = "fused_rollout.check"
ALLOC = "fused_rollout.alloc"
LAUNCH = "fused_rollout.launch"
LIBRARY = "fused_rollout.library"
BUILD = "fused_rollout.build"
#: the label of an idle gap whose middle lies in no span of the program
OUTSIDE = "outside the program"
#: chunks of (b)'s profiled window
PROFILED_CHUNKS = 1000
#: rounds of the enqueue reading with the spans off and (a), in turns
ROUNDS = 10


def _split(records: List[Tuple[str, int, int, int]]) -> Dict[str, Any]:
    """Per span name: count and summed ns; and ``per_board``'s self time
    (the call less the spans directly under it)."""
    count: Dict[str, int] = defaultdict(int)
    total: Dict[str, int] = defaultdict(int)
    children = 0
    for name, start, end, parent in records:
        count[name] += 1
        total[name] += end - start
        if parent >= 0 and records[parent][0] == PER_BOARD:
            children += end - start
    if PER_BOARD in count:
        count["self"] = count[PER_BOARD]
        total["self"] = total[PER_BOARD] - children
    return {"count": dict(count), "ns": dict(total)}


def enqueue_split(engine, chunks: int = 200, bursts: int = 5,
                  cycles: Tuple[int, ...] = (4 * 10**8, 16 * 10**8)
                  ) -> Optional[Dict[str, Any]]:
    """(a): ``bursts`` bursts of ``chunks`` chained chunks enqueued while the
    card sleeps ``cycles``, the spans on; a burst the card caught up with
    is dropped and tried again on a longer sleep. Returns the spans' counts
    and summed ns over the kept bursts, ``per_board``'s self time
    (``self``), the launches counted over them and the spans dropped; None
    where every try of a burst was caught up with."""
    import torch

    from placement_tpu_torch.utils import profiling

    records: List[Tuple[str, int, int, int]] = []
    launches = dropped = 0
    profiling.enable()
    try:
        for _ in range(bursts):
            for sleep in cycles:
                profiling.reset()
                start = torch.cuda.Event()
                launches0 = engine.fn.launches
                torch.cuda._sleep(sleep)
                start.record()
                for _ in range(chunks):
                    engine._chunk()
                ahead = not start.query()
                engine._sync()
                if ahead:
                    base = len(records)
                    records += [(n, s, e, p + base if p >= 0 else p)
                                for n, s, e, p in profiling.spans()]
                    launches += engine.fn.launches - launches0
                    dropped += profiling.dropped()
                    break
            else:
                return None
    finally:
        profiling.disable()
        profiling.reset()
    return {**_split(records), "launches": launches, "dropped": dropped}


def _merged(splits: List[Optional[Dict[str, Any]]]
            ) -> Optional[Dict[str, Any]]:
    """Readings of (a) summed; None if any is None."""
    if any(s is None for s in splits):
        return None
    out: Dict[str, Any] = {"count": defaultdict(int), "ns": defaultdict(int),
                           "launches": 0, "dropped": 0}
    for s in splits:
        for k in ("count", "ns"):
            for name, v in s[k].items():
                out[k][name] += v
        out["launches"] += s["launches"]
        out["dropped"] += s["dropped"]
    return {**out, "count": dict(out["count"]), "ns": dict(out["ns"])}


def mean_us(split: Optional[Dict[str, Any]], name: str) -> Optional[float]:
    """Mean microseconds of span ``name`` (or ``self``) in a reading of
    (a); None where there is none, or the reading is not trusted: a span
    dropped, or the launch spans not the launches counted."""
    if not split or split["dropped"] or (
            split["count"].get(LAUNCH, 0) != split["launches"]):
        return None
    n = split["count"].get(name, 0)
    return split["ns"][name] / n / 1e3 if n else None


def profiled_window(engine, chunks: int = PROFILED_CHUNKS
                    ) -> List[Dict[str, Any]]:
    """(b)'s window: ``chunks`` chained chunks and the fetch that ends them,
    inside ``devtrace.WINDOW``, under the profiler with the spans on;
    returns the profiler's events as ``devtrace`` reads them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from placement_tpu_torch.utils import profiling

    engine._sync()
    profiling.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(devtrace.WINDOW):
                for _ in range(chunks):
                    engine._chunk()
                engine._sync()
        torch.cuda.synchronize()
    finally:
        profiling.disable()
        profiling.reset()
    return devtrace._events(prof.events())


def idle_by_span(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """(b)'s reading: the window's length, its idle time on the device, the
    idle time by the innermost ``fused_rollout.*`` range at each gap's
    middle (``OUTSIDE`` where none), and the share of the window idle
    inside a ``per_board`` range (``wrapper_idle_pct``). Seconds."""
    (window,) = [e for e in events if e["device"] == "cpu"
                 and e["name"] == devtrace.WINDOW]
    w0, w1 = window["start"], window["end"]
    cpu = [e for e in events if e["device"] == "cpu"]
    mirrors = {(e["id"], e["name"]) for e in cpu}
    busy = devtrace._union([
        (max(e["start"], w0), min(e["end"], w1)) for e in events
        if e["device"] == "cuda" and (e["id"], e["name"]) not in mirrors
        and e["end"] > w0 and e["start"] < w1])
    gaps, t = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    ranges = sorted((e for e in cpu if e["name"].startswith("fused_rollout.")),
                    key=lambda e: e["start"])
    starts = [e["start"] for e in ranges]
    calls = devtrace._Ranges(e for e in ranges if e["name"] == PER_BOARD)
    by: Dict[str, float] = defaultdict(float)
    in_calls = 0.0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label, best = OUTSIDE, None
        k = bisect.bisect_right(starts, mid)
        for r in ranges[max(0, k - 16):k]:
            if r["start"] <= mid <= r["end"] and (
                    best is None or r["start"] >= best["start"]):
                best = r
        if best is not None:
            label = best["name"]
        by[label] += (e - s) * 1e-6
        if calls.holds(mid):
            in_calls += (e - s) * 1e-6
    window_s = (w1 - w0) * 1e-6
    return {"window_s": window_s,
            "idle_s": sum((e - s) for s, e in gaps) * 1e-6,
            "idle_by_span": dict(sorted(by.items(), key=lambda x: -x[1])),
            "wrapper_idle_pct": 100.0 * in_calls / window_s}


def _median(values: List[Optional[float]]) -> Optional[float]:
    kept = [v for v in values if v is not None]
    return statistics.median(kept) if kept else None


def main(argv: Optional[List[str]] = None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from placement_tpu_torch.ops import fused_rollout
    from placement_tpu_torch.utils import profiling
    from portbench import run

    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    traffic = manifest.traffic(cell["traffic"])
    profiling.enable()
    engine = manifest.engine(traffic["engine"]).Engine(
        manifest.config(cell["config"]), traffic, args.seed, "cuda")
    engine.warm(manifest.cell(args.workload)["compared_chunks"])
    setup = {"setup_s": time.perf_counter() - t0,
             "library": [(n, (e - s) * 1e-9) for n, s, e, _ in
                         profiling.spans() if n in (LIBRARY, BUILD)],
             "library_seconds": fused_rollout.library_seconds()}
    profiling.disable()
    profiling.reset()
    off, splits = [], []
    for _ in range(ROUNDS):
        off.append(engine._enqueue_us())
        splits.append(enqueue_split(engine))
    split = _merged(splits)
    events = profiled_window(engine)
    reading = idle_by_span(events)
    reading["host_at_gaps"] = devtrace.summarize(
        events, PROFILED_CHUNKS)["breakdown"]["idle_gaps"]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "card": run._power_limit(), **setup,
        "enqueue_us_off": off,
        "per_board_us_on": [mean_us(s, PER_BOARD) for s in splits],
        "medians_us": {"off": _median(off), "on": _median(
            [mean_us(s, PER_BOARD) for s in splits])},
        "split_us": {k: mean_us(split, k) for k in (
            PER_BOARD, CHECK, ALLOC, LAUNCH, "self")},
        "split": split, **reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
