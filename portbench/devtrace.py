"""The profiled window of a ``--trace 1`` run, read from ``torch.profiler``.

The window runs chained chunks under the profiler (CPU and CUDA
activities), each chunk's program call inside a ``portbench.chunk`` range
and the harness's own accumulate inside ``portbench.harness``, then the
fetch that waits for the card, all inside ``portbench.window``. From the
trace it takes what the per-layer metrics read: the window's length, the
time in which something ran on the device (the union of the device
activities inside the window), the device time of the chunk's kernels and
of the harness's, the launches, and the breakdown: the device operations that took most time
and the longest idle gaps by what the host was doing.

A trace without device activity raises: this path needs the card.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

WINDOW = "portbench.window"
CHUNK = "portbench.chunk"
HARNESS = "portbench.harness"
#: entries of each breakdown list
TOP = 10


def profile(chunk: Callable[[], None], n: int,
            sync: Callable[[], Any]) -> Dict[str, Any]:
    """Run ``chunk`` ``n`` times under the profiler, then ``sync``; return
    the reading of the trace (``summarize``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function

    sync()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                chunk()
            sync()
    torch.cuda.synchronize()
    return summarize(_events(prof.events()), n)


def _events(function_events) -> List[Dict[str, Any]]:
    """The profiler's events as plain records: name, device ("cpu" or
    "cuda"), start and end in microseconds, and the id: a device activity
    shares it with the runtime call that launched it (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``), a range's mirror on the device with the range."""
    return [{"name": e.name,
             "device": "cuda" if "cuda" in str(e.device_type).lower()
             else "cpu",
             "start": e.time_range.start, "end": e.time_range.end,
             "id": e.id} for e in function_events]


class _Ranges:
    """Disjoint time ranges of one name, to ask which holds a time."""

    def __init__(self, events):
        self.spans = sorted((e["start"], e["end"]) for e in events)
        self.starts = [s for s, _ in self.spans]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def summarize(events: List[Dict[str, Any]], chunks: int) -> Dict[str, Any]:
    """The reading of a trace of ``chunks`` chunks (see the module's
    docstring). Times in seconds."""
    windows = [e for e in events if e["device"] == "cpu"
               and e["name"] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"{len(windows)} '{WINDOW}' ranges in the trace")
    w0, w1 = windows[0]["start"], windows[0]["end"]
    cpu = [e for e in events if e["device"] == "cpu"]
    ranges_on_device = {(e["id"], e["name"]) for e in cpu}
    device = [e for e in events if e["device"] == "cuda"
              and (e["id"], e["name"]) not in ranges_on_device
              and e["end"] > w0 and e["start"] < w1]
    if not device:
        raise RuntimeError("the profiler saw no device activity in the "
                           "window: no card, or no CUDA tracing")
    busy = _union([(max(e["start"], w0), min(e["end"], w1)) for e in device])

    # each device activity's runtime call, and the range that call ran in
    runtime = {e["id"]: e for e in cpu if e["name"].startswith("cu")}
    ranges = {name: _Ranges(e for e in cpu if e["name"] == name)
              for name in (CHUNK, HARNESS)}
    kernels = []
    for e in device:
        call = runtime.get(e["id"])
        owner = "unlinked" if call is None else next(
            (name for name, r in ranges.items() if r.holds(call["start"])),
            "other")
        kernels.append({"name": e["name"], "owner": owner,
                        "seconds": (e["end"] - e["start"]) * 1e-6})

    per_op: Dict[str, float] = defaultdict(float)
    for k in kernels:
        per_op[k["name"]] += k["seconds"]
    return {
        "chunks": chunks,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": kernels,
        "launches": len(kernels),
        "unlinked": sum(1 for k in kernels if k["owner"] == "unlinked"),
        "breakdown": {
            "device_ops": sorted(([n, s] for n, s in per_op.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": _idle_gaps(busy, cpu, w0, w1),
        },
    }


def _idle_gaps(busy: List[Tuple[float, float]], cpu: List[Dict[str, Any]],
               w0: float, w1: float) -> List[List[Any]]:
    """The window's idle time on the device, summed by what the host was
    doing at each gap's middle (the innermost CPU event there), longest
    first."""
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    inner = sorted((e for e in cpu if e["name"] != WINDOW),
                   key=lambda e: e["start"])
    starts = [e["start"] for e in inner]
    by_host: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label, best = "no host event", None
        k = bisect.bisect_right(starts, mid)
        for ev in inner[max(0, k - 64):k]:
            if ev["start"] <= mid <= ev["end"] and (
                    best is None or ev["start"] >= best["start"]):
                best = ev
        if best is not None:
            label = best["name"]
        by_host[label] += (e - s) * 1e-6
    return sorted(([n, v] for n, v in by_host.items()),
                  key=lambda x: -x[1])[:TOP]
