"""Random-policy baseline on the rectangular env (port of the JAX
package's ``experiments/random_policy/run_policy_rectangular.py``;
reference ``experiments/random_policy/run_policy_rectangular.py:48-98``).

    python -m placement_tpu_torch.experiments.random_policy.\
run_policy_rectangular
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
    p.add_argument("--min_component_h", type=int, default=2)
    p.add_argument("--max_component_h", type=int, default=4)
    p.add_argument("--min_component_w", type=int, default=2)
    p.add_argument("--max_component_w", type=int, default=4)
    p.add_argument("--min_num_components", type=int, default=20)
    p.add_argument("--max_num_components", type=int, default=20)
    return add_common_args(p)


def params_from(args: argparse.Namespace) -> EnvParams:
    return EnvParams(
        variant=Variant.RECT, height=args.height, width=args.width,
        min_component_h=args.min_component_h,
        max_component_h=args.max_component_h,
        min_component_w=args.min_component_w,
        max_component_w=args.max_component_w,
        min_num_components=args.min_num_components,
        max_num_components=args.max_num_components).validate()


def run(args: argparse.Namespace) -> torch.Tensor:
    """The episode returns, on ``args.device``."""
    return simulate_returns(params_from(args), args)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    returns, seconds = timed(run, args)
    plot_and_report(returns, args, "rect_env",
                    "Rectangular env random policy episode returns",
                    seconds)


if __name__ == "__main__":
    main()
