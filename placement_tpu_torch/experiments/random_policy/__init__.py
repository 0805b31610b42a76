"""Random-policy baselines of the port (counterparts of the JAX package's
``experiments/random_policy/*.py``): one module a env family, each with
the JAX runner's flags and defaults plus ``--device`` and ``--out-dir``.

    python -m placement_tpu_torch.experiments.random_policy.run_policy_square
    python -m placement_tpu_torch.experiments.random_policy.\\
run_policy_rectangular_pin --spatial --device cpu --n_episodes 64

Each module's ``run(args)`` plays the episodes through
``agent/random_policy.py::simulate`` on the device and returns the episode
returns (a tensor there); ``main`` adds the returns plot, written under
``--out-dir``, and prints the mean.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from placement_tpu_torch.agent.random_policy import simulate
from placement_tpu_torch.agent.trainer import DEFAULT_RESULTS_ROOT
from placement_tpu_torch.env import core
from placement_tpu_torch.env.types import EnvParams

#: where the plots go by default: beside the port's training runs
DEFAULT_OUT_DIR = os.path.join(DEFAULT_RESULTS_ROOT, "random_policy")


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags every runner shares: episodes, seed, device, out dir."""
    p.add_argument("--n_episodes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the card (default; raises without one) or 'cpu'")
    p.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                   help="directory of the returns plot")
    return p


def simulate_returns(params: EnvParams, args: argparse.Namespace
                     ) -> torch.Tensor:
    """``args.n_episodes`` random-policy episode returns on
    ``args.device``, drawn from a generator there seeded ``args.seed``."""
    device = core.check_device(args.device, "random policy")
    gen = torch.Generator(device).manual_seed(args.seed)
    return simulate(params, gen, args.n_episodes, device=device)


def plot_and_report(returns: torch.Tensor, args: argparse.Namespace,
                    stem: str, title: str, seconds: float) -> str:
    """Write the returns plot ``<out-dir>/<stem>_random_policy_episode_
    returns.png`` and print the mean return; returns the plot's path."""
    from placement_tpu_torch.viz.grid import plot_episode_returns
    os.makedirs(args.out_dir, exist_ok=True)
    values = returns.double().cpu()
    out = plot_episode_returns(
        values.tolist(),
        os.path.join(args.out_dir,
                     f"{stem}_random_policy_episode_returns.png"),
        title=title)
    print(f"mean return {float(values.mean()):.3f} over {len(values)} "
          f"episodes on {args.device} in {seconds:.2f} s -> {out}")
    return out


def timed(run, args: argparse.Namespace):
    """``run(args)`` and its seconds, the device synced at the end (the
    returns are read back by ``simulate`` itself)."""
    t0 = time.perf_counter()
    returns = run(args)
    return returns, time.perf_counter() - t0
