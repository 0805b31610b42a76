"""Phase split of the pooled engine at the web app's slider maximum (port
of the JAX package's ``tools/pooled_profile.py``).

The matrix row ``web_max_pooled`` (30x30 grid, 40 components, 10 nets x
<= 10 pins, pin-spatial: ``web_app/pages/2_Train_new_agent.py:29-44``)
runs on ``env/pooled.py``. This tool times four pieces of it apart, with
the random policy, from all-done zero boards:

  pool_gen      ``pooled.make_pool`` alone (instance generation, drawn once
                a chunk)
  step_full     ``--inner`` pooled steps with a pool drawn beforehand (no
                generation), the terminal routing computed eagerly for
                every board every step
  step_noroute  the same steps with ``routing.terminal_reward`` replaced by
                a constant: what that routing costs
  chunk_shipped ``pooled.rollout_chunk`` (generation inside), as the matrix
                row runs it but without the gated routing

    python -m placement_tpu_torch.tools.pooled_profile \\
        [--batch 4096] [--inner 10] [--pool 4] [--slice-size 4] [--out f]

Each phase: one call timed alone (``first_call_s``), then as many calls as
``--budget-s`` allows at that call's pace, 2 to 30, in one window that
ends in a read of an accumulated scalar. Prints one JSON line (the JAX artifact's
keys, the device and the card's name and power limit, and ``reduced``: the
flags set below the JAX tool's defaults) and writes it to ``--out`` if
given.
"""

import argparse
from typing import Dict

import torch

from placement_tpu_torch.agent.random_policy import random_action
from placement_tpu_torch.env import core, pooled, routing
from placement_tpu_torch.tools import bench_matrix
from placement_tpu_torch.tools._timing import finish, reduced, time_calls

#: the JAX tool's defaults (``tools/pooled_profile.py:112-116``)
JAX_DEFAULTS = {"batch": 4096, "inner": 10, "pool": 4, "slice_size": 4}
MAX_CALLS = 30


def _noroute(params, abs_x, abs_y, net, placed_all, route_dtype=None):
    """``routing.terminal_reward`` replaced by a constant: the penalty
    where a board did not place every component, else 0."""
    z = torch.zeros(placed_all.shape, dtype=torch.float32,
                    device=placed_all.device)
    return torch.where(placed_all, z, -1.0), z + 1.0, z + 1.0


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=JAX_DEFAULTS["batch"])
    p.add_argument("--inner", type=int, default=JAX_DEFAULTS["inner"],
                   help="steps a chunk")
    p.add_argument("--pool", type=int, default=JAX_DEFAULTS["pool"],
                   help="pool entries a board")
    p.add_argument("--slice-size", type=int,
                   default=JAX_DEFAULTS["slice_size"])
    p.add_argument("--budget-s", type=float, default=60.0,
                   help="seconds of timed calls a phase, about")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the card (default; raises without one) or 'cpu'")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    device = core.check_device(args.device, "pooled_profile")
    params, _ = bench_matrix._configs()["web_max_pooled"]
    batch, inner = args.batch, args.inner
    gen = torch.Generator(device).manual_seed(args.seed)
    result = {"batch": batch, "inner": inner, "pool_size": args.pool,
              "slice_size": args.slice_size,
              "grid": [params.height, params.width], "phases": {},
              "reduced": reduced(args, JAX_DEFAULTS),
              **bench_matrix.device_info(device)}

    def record(name, first, per_call, n_calls, steps_per_call):
        row = {"first_call_s": first, "steady_s_per_call": per_call,
               "n_calls": n_calls}
        if steps_per_call:
            row["steps_per_sec"] = batch * steps_per_call / per_call
        result["phases"][name] = row
        return row

    def call_pool(state, acc):
        pool = pooled.make_pool(params, gen, args.pool, batch,
                                args.slice_size)
        return state, acc + pool.comp_h.sum().to(torch.float32)

    row = record("pool_gen", *time_calls(call_pool, None, args.budget_s,
                                         MAX_CALLS), 0)
    row["boards_per_call"] = args.pool * batch
    row["us_per_board"] = row["steady_s_per_call"] * 1e6 / (args.pool
                                                            * batch)

    pool = pooled.make_pool(params, gen, args.pool, batch, args.slice_size)

    def call_steps(states, acc):
        counts = torch.zeros((batch,), dtype=torch.int32, device=device)
        for _ in range(inner):
            actions = random_action(gen, params, states.action_mask)
            states, counts, reward, _, _ = pooled.step_autoreset_pooled(
                params, states, actions, pool, counts)
            acc = acc + reward.sum()
        return states, acc

    zero = bench_matrix.dummy_states(params, batch, device)
    record("step_full", *time_calls(call_steps, zero, args.budget_s,
                                    MAX_CALLS), inner)
    real = routing.terminal_reward
    routing.terminal_reward = _noroute
    try:
        record("step_noroute", *time_calls(call_steps, zero, args.budget_s,
                                           MAX_CALLS), inner)
    finally:
        routing.terminal_reward = real

    chunk = pooled.rollout_chunk(
        params, lambda g, q, s: random_action(g, q, s.action_mask), inner,
        args.pool, args.slice_size, device=device)

    def call_shipped(states, acc):
        states, r, _, _ = chunk(states, gen)
        return states, acc + r

    record("chunk_shipped", *time_calls(call_shipped, zero, args.budget_s,
                                        MAX_CALLS), inner)
    return finish(result, args.out)


if __name__ == "__main__":
    main()
