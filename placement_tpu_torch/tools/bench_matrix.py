"""Per-configuration throughput of the rollout engines (port of
``tools/bench_matrix.py``).

    python -m placement_tpu_torch.tools.bench_matrix            # fused rows
    python -m placement_tpu_torch.tools.bench_matrix --configs web_max_pooled
    python -m placement_tpu_torch.tools.bench_matrix --out rows.json

Measures env-steps/s for every environment variant and reward type the repo
ships, with the JAX tool's method (the batched equivalent of the
reference's random-policy loop): all-done zero boards
(``bench.py:125-133``), one warm-up chunk, then 50-step chunks chained
output to input, the number of timed chunks sized from one timed chunk,
synced by fetching an accumulated reward scalar so that asynchronous launches
cannot hide execution. A configuration inside the fused kernel's envelope
runs on the kernel; one outside it, the web app's slider maximum
(``web_max_pooled``), runs on the pooled engine (``env/pooled.py``) with
the JAX tool's tuning and reports the pool wraps, warning when a row
wrapped. Each row names the device it ran on and, on a GPU, the card's name
and power limit; a row that fails raises. It prints one JSON line of rows
and writes a file only when ``--out`` is given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, Tuple

import torch

from placement_tpu_torch.agent.random_policy import random_action
from placement_tpu_torch.env import core, pooled
from placement_tpu_torch.env.types import STATE_FIELDS, EnvParams, EnvState
from placement_tpu_torch.ops import fused_rollout
from placement_tpu_torch.utils.config import load_env_params

BATCH = 4096
INNER = 50
#: timed chunks: as many as 30% of this budget allows, 2 to 40 (the JAX
#: tool's sizing against its run budget)
BUDGET_S = 60.0
MAX_CALLS = 40

#: the rows the fused kernel runs, in the JAX tool's order
FUSED_ROWS = ("square", "rect", "pin_centroid", "pin_beam", "pin_both",
              "spatial")

#: logical PRNG block per row (the JAX tool's FUSED_TUNING blocks; the
#: beam and "both" rows keep the default 128). The block sets the random
#: stream, as on the TPU; the CUDA launch geometry does not depend on it.
FUSED_TUNING = {
    "square": dict(block=256),
    "rect": dict(block=512),
    "pin_centroid": dict(block=256),
    "spatial": dict(block=256),
}


#: the pooled engine's tuning per row (the JAX tool's POOLED_TUNING):
#: episodes of ~40 placements fill a 2-deep pool in 50 steps with headroom,
#: and the routing is gated to the boards that finish
POOLED_TUNING = {
    "web_max_pooled": dict(inner=50, pool_size=2, slice_size=2,
                           route_budget=64, batch=1024),
}


def _configs() -> Dict[str, Tuple[EnvParams, str]]:
    """name -> (EnvParams, reference anchor note), as the JAX tool's."""
    square = load_env_params("square")
    rect = load_env_params("rectangle")
    pin = load_env_params("rectangle_pin")
    spatial = load_env_params("rectangle_spatial_pin")
    web_max = spatial.replace(
        height=30, width=30,
        min_component_h=2, max_component_h=5,
        min_component_w=2, max_component_w=5,
        min_num_components=40, max_num_components=40,
        min_num_nets=10, max_num_nets=10,
        min_num_pins_per_net=2, max_num_pins_per_net=10).validate()
    return {
        "square": (square, "dummy_env_square.py"),
        "rect": (rect, "dummy_env_rectangular.py"),
        "pin_centroid": (pin, "rectangle_pin config (bench.py headline)"),
        "pin_beam": (pin.replace(reward_type="beam"),
                     "find_reward beam arm :951-975"),
        "pin_both": (pin.replace(reward_type="both"),
                     "find_reward 'both' arm :951-975"),
        "spatial": (spatial, "rectangle_spatial_pin config"),
        "web_max_pooled": (web_max,
                           "web-app slider maximum — outside the fused "
                           "envelope; pooled path only"),
    }


def device_info(device: torch.device) -> Dict[str, str]:
    """The device a row ran on: for a GPU its name and the card's name and
    power limit as ``nvidia-smi`` reports them."""
    if device.type != "cuda":
        return {"device": str(device)}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(index),
            "card": smi[index].strip()}


def bench_fused(env_params: EnvParams, batch: int, block: int,
                device: torch.device, inner: int = INNER) -> dict:
    """Chained fused chunks from all-done zero boards; returns the rate,
    the call and launch counts, the episode accounting and the final
    leaves."""
    fn = fused_rollout.make_fused_rollout(env_params, batch, inner,
                                          block=block, device=device)
    leaves = fused_rollout.zero_leaves(env_params, batch, device)
    counter = 1

    def call(leaves, racc, dacc):
        nonlocal counter
        leaves, rsum, dcnt = fn(leaves, counter)
        counter += 1
        return leaves, racc + rsum, dacc + dcnt

    zero_r = torch.zeros((), dtype=torch.float32, device=device)
    zero_d = torch.zeros((), dtype=torch.int64, device=device)
    # warm-up chunk (regenerates every zero board), then one timed chunk
    # that sizes the run
    leaves, racc, _ = call(leaves, zero_r, zero_d)
    float(racc)
    t0 = time.perf_counter()
    leaves, racc, _ = call(leaves, zero_r, zero_d)
    float(racc)
    per_call = time.perf_counter() - t0
    n_calls = max(2, min(MAX_CALLS, int(BUDGET_S * 0.3
                                        / max(per_call, 1e-4))))
    racc, dacc = zero_r, zero_d
    t0 = time.perf_counter()
    for _ in range(n_calls):
        leaves, racc, dacc = call(leaves, racc, dacc)
    reward_sum = float(racc)    # the sync: needs every chunk's output
    seconds = time.perf_counter() - t0
    episodes = int(dacc)
    return {"rate": batch * inner * n_calls / seconds, "seconds": seconds,
            "calls": n_calls + 2, "launches": fn.launches, "kernel": fn.kernel,
            "episodes": episodes, "reward_sum": reward_sum,
            "leaves": leaves}


def dummy_states(params: EnvParams, batch: int, device) -> EnvState:
    """All-done zero boards (JAX ``_dummy_states``): the first step ends
    every episode, and each board takes a fresh instance."""
    shapes = core.reset(params, torch.Generator(device).manual_seed(0), 1,
                        device)
    states = EnvState(**{f: torch.zeros((batch,) + getattr(shapes, f)
                                        .shape[1:], dtype=getattr(shapes, f)
                                        .dtype, device=device)
                         for f in STATE_FIELDS})
    return states.replace(done=torch.ones_like(states.done))


def bench_pooled(env_params: EnvParams, batch: int, device: torch.device,
                 inner: int, pool_size: int, slice_size: int,
                 route_budget: int) -> dict:
    """Chained pooled chunks of the random policy from all-done zero
    boards (JAX ``_bench_pooled``). Returns the rate, the chunk count, the
    pool wraps of every chunk and the episode accounting of the timed
    ones."""
    chunk = pooled.rollout_chunk(
        env_params, lambda g, p, s: random_action(g, p, s.action_mask),
        inner, pool_size, slice_size, route_budget, device)
    gen = torch.Generator(device).manual_seed(7)
    wraps = []

    def call(states):
        states, r, d, wrapped = chunk(states, gen)
        wraps.append(wrapped)
        return states, r, d

    states, r, _ = call(dummy_states(env_params, batch, device))
    float(r)                                     # warm-up: every board fresh
    t0 = time.perf_counter()
    states, r, _ = call(states)
    float(r)
    per_call = time.perf_counter() - t0
    n_calls = max(2, min(MAX_CALLS, int(BUDGET_S * 0.3 / max(per_call, 1e-4))))
    racc = torch.zeros((), dtype=torch.float32, device=device)
    dacc = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        states, r, d = call(states)
        racc, dacc = racc + r, dacc + d
    reward_sum = float(racc)    # the sync: needs every chunk's output
    seconds = time.perf_counter() - t0
    return {"rate": batch * inner * n_calls / seconds, "seconds": seconds,
            "calls": n_calls + 2, "wraps": int(sum(int(w) for w in wraps)),
            "episodes": int(dacc), "reward_sum": reward_sum,
            "states": states}


def measure_pooled(name: str, env_params: EnvParams, anchor: str,
                   device="cuda", **tuning) -> dict:
    """One pooled row of the matrix (``POOLED_TUNING``'s keys as
    keywords)."""
    device = core.check_device(device, "bench_matrix")
    batch = tuning.pop("batch")
    t0 = time.monotonic()
    run = bench_pooled(env_params, batch, device, **tuning)
    if run["wraps"]:
        # pool reuse biases the sample stream (a board replays an instance)
        print(f"[matrix] {name}: WARNING: {run['wraps']} pool wrap(s) - "
              "enlarge pool_size", file=sys.stderr, flush=True)
    return {
        "engine": "pooled_torch",
        "steps_per_sec": run["rate"],
        "batch": batch,
        "variant": int(env_params.variant),
        "reward_type": (env_params.reward_type if env_params.has_pins
                        else None),
        "grid": [env_params.height, env_params.width],
        "chunk_steps": tuning["inner"],
        "pool_size": tuning["pool_size"],
        "route_budget": tuning["route_budget"],
        "calls": run["calls"],
        "wraps": run["wraps"],
        "timed_seconds": run["seconds"],
        "episodes": run["episodes"],
        "reward_sum": run["reward_sum"],
        "mean_episode_reward": run["reward_sum"] / max(run["episodes"], 1),
        "measure_seconds": time.monotonic() - t0,
        "reference_anchor": anchor,
        **device_info(device),
    }


def measure(name: str, env_params: EnvParams, anchor: str, batch: int,
            device="cuda", inner: int = INNER, block: int = 128
            ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """One fused row of the matrix and the final leaves of its run."""
    if not fused_rollout.supports(env_params):
        raise ValueError(f"{name}: outside the fused kernel's envelope; it "
                         "runs on the pooled engine (measure_pooled)")
    device = core.check_device(device, "bench_matrix")
    t0 = time.monotonic()
    run = bench_fused(env_params, batch, min(block, batch), device, inner)
    engine = "fused_cuda" if device.type == "cuda" else "fused_plain"
    row = {
        "engine": engine,
        "kernel": run["kernel"],
        "steps_per_sec": run["rate"],
        "batch": batch,
        "block": min(block, batch),
        "variant": int(env_params.variant),
        "reward_type": (env_params.reward_type if env_params.has_pins
                        else None),
        "grid": [env_params.height, env_params.width],
        "chunk_steps": inner,
        "calls": run["calls"],
        "launches": run["launches"],
        "timed_seconds": run["seconds"],
        "episodes": run["episodes"],
        "reward_sum": run["reward_sum"],
        "mean_episode_reward": run["reward_sum"] / max(run["episodes"], 1),
        "measure_seconds": time.monotonic() - t0,
        "reference_anchor": anchor,
        **device_info(device),
    }
    return row, run["leaves"]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", nargs="+", default=list(FUSED_ROWS))
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--inner", type=int, default=INNER,
                   help="steps per chunk")
    p.add_argument("--out", default=None,
                   help="also write the rows to this JSON file")
    args = p.parse_args(argv)

    table = _configs()
    rows = {}
    for name in args.configs:
        if name not in table:
            raise SystemExit(f"unknown config {name!r}; "
                             f"one of {sorted(table)}")
        env_params, anchor = table[name]
        if name in POOLED_TUNING:
            rows[name] = measure_pooled(name, env_params, anchor,
                                        **POOLED_TUNING[name])
            continue
        block = FUSED_TUNING.get(name, {}).get("block", 128)
        rows[name], _ = measure(name, env_params, anchor, args.batch,
                                inner=args.inner, block=block)
    payload = {"metric": "env_steps_per_sec", "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
    print(json.dumps(payload), flush=True)
    return payload


if __name__ == "__main__":
    main()
