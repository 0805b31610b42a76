"""Timing helpers of the port's profilers (``train_profile``,
``pooled_profile``, ``price_exact_sampling``).

Every timed window ends in a read of a scalar that depends on all of the
window's work (``float(acc)``), so the host's clock includes the device's
time; the first call is timed alone and reported apart.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


def time_calls(call: Callable, state, budget_s: float, max_calls: int,
               min_calls: int = 2) -> Tuple[float, float, int]:
    """(first call's seconds, seconds a call, calls timed) of
    ``call(state, acc) -> (state, acc)``: ``acc`` starts as 0.0 and comes
    back a 0-d device tensor that every call's work feeds. After the first
    call, as many calls as ``budget_s`` allows at the first call's pace,
    ``min_calls`` to ``max_calls`` (the JAX tools' sizing), in one
    window."""
    t0 = time.perf_counter()
    state, acc = call(state, 0.0)
    float(acc)
    first = time.perf_counter() - t0
    n = max(min_calls, min(max_calls, int(budget_s / max(first, 1e-4))))
    acc = 0.0
    t0 = time.perf_counter()
    for _ in range(n):
        state, acc = call(state, acc)
    float(acc)
    return first, (time.perf_counter() - t0) / n, n


def time_in_turns(calls: Dict[str, Tuple[Callable, object]],
                  budget_s: float, max_calls: int, rounds: int = 4
                  ) -> Dict[str, Tuple[float, List[float], int]]:
    """{name: (first call's seconds, seconds a call in each round, calls a
    window)} of several ``call(state, acc)`` (as ``time_calls``), ``calls``
    {name: (call, state)}, timed in turns: each runs once alone, then
    ``rounds`` rounds of one window each, the order reversed every round
    (a b, b a, ...), so that a drift in the host's or the card's pace falls
    on all of them alike. A window takes as many calls as ``budget_s /
    rounds`` allows at the first call's pace, 2 to ``max_calls``."""
    first, states = {}, {}
    for name, (call, state) in calls.items():
        t0 = time.perf_counter()
        states[name], acc = call(state, 0.0)
        float(acc)
        first[name] = time.perf_counter() - t0
    n = {name: max(2, min(max_calls, int(budget_s / rounds
                                         / max(f, 1e-4))))
         for name, f in first.items()}
    per: Dict[str, List[float]] = {name: [] for name in calls}
    order = list(calls)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            call, acc = calls[name][0], 0.0
            t0 = time.perf_counter()
            for _ in range(n[name]):
                states[name], acc = call(states[name], acc)
            float(acc)
            per[name].append((time.perf_counter() - t0) / n[name])
    return {name: (first[name], per[name], n[name]) for name in calls}


def profile_once(fn: Callable[[], object], device: torch.device
                 ) -> Dict[str, Optional[float]]:
    """Kernel launches and device-busy ms of one ``fn()`` under
    ``torch.profiler`` (the device idle before and after), with its wall
    ms; on the CPU, or where the profiler records no device events, the
    launches and busy time are None ("not measured")."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"launches": len(kernels) if kernels else None,
            "device_busy_ms": (sum(e.device_time_total for e in kernels)
                               / 1e3 if kernels else None),
            "wall_ms": wall}


def reduced(args: argparse.Namespace, jax_defaults: Dict[str, object]
            ) -> List[str]:
    """The cuts of this run against the JAX tool's defaults: one line for
    each flag set below (or apart from) the JAX tool's value."""
    return [f"--{k.replace('_', '-')} {getattr(args, k)} (the JAX tool's "
            f"default: {v})" for k, v in jax_defaults.items()
            if getattr(args, k) != v]


def finish(result: Dict, out: Optional[str]) -> Dict:
    """Print ``result`` as one JSON line; write it to ``out`` if given."""
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result
