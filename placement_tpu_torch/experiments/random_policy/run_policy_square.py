"""Random-policy baseline on the square env (port of the JAX package's
``experiments/random_policy/run_policy_square.py``; reference
``experiments/random_policy/run_policy_square.py:38-58``: 10x10 grid, 2x2
components, 1000 episodes, the returns plotted).

    python -m placement_tpu_torch.experiments.random_policy.run_policy_square
"""

import argparse

import torch

from placement_tpu_torch.env.types import EnvParams, Variant
from placement_tpu_torch.experiments.random_policy import (
    add_common_args, plot_and_report, simulate_returns, timed)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--height", type=int, default=10)
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--component_n", type=int, default=2)
    return add_common_args(p)


def params_from(args: argparse.Namespace) -> EnvParams:
    return EnvParams(variant=Variant.SQUARE, height=args.height,
                     width=args.width,
                     component_n=args.component_n).validate()


def run(args: argparse.Namespace) -> torch.Tensor:
    """The episode returns, on ``args.device``."""
    return simulate_returns(params_from(args), args)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    returns, seconds = timed(run, args)
    plot_and_report(returns, args, "square_env",
                    "Square env random policy episode returns", seconds)


if __name__ == "__main__":
    main()
