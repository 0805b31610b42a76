"""What ``exact_sampling=True`` costs on the port (counterpart of the JAX
package's ``tools/price_exact_sampling.py``).

The sampling-fidelity check (``env/fidelity.py``) tells users whose pin
config is cap-bound to set ``exact_sampling=True``: the reference's
per-trial truncated multinomial and per-net redraw rounds
(``env/generator.py::_capped_multinomial_exact``, ``_exact_rounds``: one
batched round a trial) in place of the fast draw-clip-waterfill rounds.
This tool prices both modes, with the random policy, from all-done zero
boards:

  * instance generation alone (``pooled.make_pool``): us a board;
  * a pooled rollout chunk (generation and 50 steps): env-steps/s;

on the flagship ``rectangle_pin`` config (18 pins over ~20 cells, the
regime the check is about; pool 12) and at the web app's maximum (pool 2,
slice 2, the routing gated at 256 finishers a step), as the JAX tool
does.

    python -m placement_tpu_torch.tools.price_exact_sampling [--batch 1024]

The two modes are timed in turns (one call of each alone,
``*_first_call_s``; then 4 rounds of one window a mode, the order
reversed every round, each window as many calls as a quarter of
``--budget-s`` allows, 2 to 25, ending in a read of an accumulated
scalar): the rates are the rounds' medians, and ``*_slowdown_x_rounds``
each round's ratio, so the spread of the host's pace shows. Prints one JSON line (the JAX
artifact's keys, the device and the card's name and power limit,
``reduced``: ``--batch`` if set below the JAX tool's) and writes it to
``--out`` if given.
"""

import argparse
import statistics
from typing import Dict, Optional

import torch

from placement_tpu_torch.agent.random_policy import random_action
from placement_tpu_torch.env import core, pooled
from placement_tpu_torch.env.types import EnvParams
from placement_tpu_torch.tools import bench_matrix
from placement_tpu_torch.tools._timing import finish, reduced, time_in_turns
from placement_tpu_torch.utils.config import load_env_params

#: the JAX tool's defaults (``tools/price_exact_sampling.py:157-160``)
JAX_DEFAULTS = {"batch": 1024}
MAX_CALLS = 25
CHUNK = 50


def measure_config(params: EnvParams, batch: int, pool_size: int,
                   device: torch.device, gen: torch.Generator,
                   budget_s: float, route_budget: Optional[int] = None,
                   slice_size: int = 4) -> Dict:
    """Both modes' generation and rollout rates on one config, each pair
    timed in turns (``time_in_turns``: the medians of 4 rounds), and the
    slowdowns exact / fast, with each round's."""
    modes = {m: params.replace(exact_sampling=(m == "exact")).validate()
             for m in ("fast", "exact")}

    def call_pool(p):
        def call(state, acc):
            pool = pooled.make_pool(p, gen, pool_size, batch, slice_size)
            return state, acc + pool.comp_h.sum().to(torch.float32)
        return call, None

    def call_chunk(p):
        chunk = pooled.rollout_chunk(
            p, lambda g, q, s: random_action(g, q, s.action_mask), CHUNK,
            pool_size, slice_size, route_budget, device)

        def call(states, acc):
            states, r, _, _ = chunk(states, gen)
            return states, acc + r
        return call, bench_matrix.dummy_states(p, batch, device)

    gen_t = time_in_turns({m: call_pool(p) for m, p in modes.items()},
                          budget_s, MAX_CALLS)
    roll_t = time_in_turns({m: call_chunk(p) for m, p in modes.items()},
                           budget_s, MAX_CALLS)
    row = {"batch": batch, "pool_size": pool_size, "chunk_steps": CHUNK}
    for m in modes:
        row[f"gen_{m}_us_per_board"] = (statistics.median(gen_t[m][1])
                                        * 1e6 / (pool_size * batch))
        row[f"gen_{m}_first_call_s"] = gen_t[m][0]
        row[f"rollout_{m}_steps_per_sec"] = (
            batch * CHUNK / statistics.median(roll_t[m][1]))
    row["gen_slowdown_x"] = (row["gen_exact_us_per_board"]
                             / row["gen_fast_us_per_board"])
    row["rollout_slowdown_x"] = (row["rollout_fast_steps_per_sec"]
                                 / row["rollout_exact_steps_per_sec"])
    row["gen_slowdown_x_rounds"] = [
        e / f for f, e in zip(gen_t["fast"][1], gen_t["exact"][1])]
    row["rollout_slowdown_x_rounds"] = [
        e / f for f, e in zip(roll_t["fast"][1], roll_t["exact"][1])]
    return row


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=JAX_DEFAULTS["batch"],
                    help="boards of every row")
    ap.add_argument("--budget-s", type=float, default=20.0,
                    help="seconds of timed calls a timing, about")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or 'cpu'")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    device = core.check_device(args.device, "price_exact_sampling")
    gen = torch.Generator(device).manual_seed(args.seed)
    web_max, _ = bench_matrix._configs()["web_max_pooled"]
    configs = {
        # flagship: 5-step episodes, a training-like pool depth
        "rectangle_pin": measure_config(
            load_env_params("rectangle_pin"), args.batch, 12, device, gen,
            args.budget_s),
        "web_max": measure_config(
            web_max, args.batch, 2, device, gen, args.budget_s,
            route_budget=256, slice_size=2),
    }
    return finish({"configs": configs, "reduced": reduced(args,
                                                          JAX_DEFAULTS),
                   **bench_matrix.device_info(device)}, args.out)


if __name__ == "__main__":
    main()
