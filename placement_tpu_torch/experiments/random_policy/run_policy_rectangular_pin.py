"""Random-policy baseline on the rectangular-pin env (port of the JAX
package's ``experiments/random_policy/run_policy_rectangular_pin.py``).

The reference's pin runner (``run_policy_rectangular_pin.py:79-186``)
passes a constructor signature its env no longer accepts (SURVEY §2.3), so
this runner, as the JAX package's, targets the current pin-env signature
(``dummy_env_rectangular_pin.py:396-416``) with the routing-reward knobs
exposed; ``--spatial`` takes the pin-spatial variant.

    python -m placement_tpu_torch.experiments.random_policy.\
run_policy_rectangular_pin [--spatial]
"""

import argparse

import torch

from placement_tpu_torch.env.types import EnvParams, Variant
from placement_tpu_torch.experiments.random_policy import (
    add_common_args, plot_and_report, simulate_returns, timed)

#: flags that are not ``EnvParams`` fields
_RUN_FLAGS = ("spatial", "n_episodes", "seed", "device", "out_dir")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--height", type=int, default=10)
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--min_component_h", type=int, default=2)
    p.add_argument("--max_component_h", type=int, default=2)
    p.add_argument("--min_component_w", type=int, default=2)
    p.add_argument("--max_component_w", type=int, default=2)
    p.add_argument("--min_num_components", type=int, default=5)
    p.add_argument("--max_num_components", type=int, default=5)
    p.add_argument("--min_num_nets", type=int, default=3)
    p.add_argument("--max_num_nets", type=int, default=3)
    p.add_argument("--min_num_pins_per_net", type=int, default=2)
    p.add_argument("--max_num_pins_per_net", type=int, default=6)
    p.add_argument("--net_distribution", type=int, default=9)
    p.add_argument("--pin_spread", type=int, default=9)
    p.add_argument("--reward_type", default="centroid",
                   choices=["beam", "centroid", "both"])
    p.add_argument("--reward_beam_width", type=int, default=2)
    p.add_argument("--weight_wirelength", type=float, default=0.5)
    p.add_argument("--weight_num_intersections", type=float, default=0.5)
    p.add_argument("--spatial", action="store_true",
                   help="use the pin-spatial variant")
    return add_common_args(p)


def params_from(args: argparse.Namespace) -> EnvParams:
    variant = Variant.PIN_SPATIAL if args.spatial else Variant.PIN
    kw = {k: v for k, v in vars(args).items() if k not in _RUN_FLAGS}
    return EnvParams(variant=variant, **kw).validate()


def run(args: argparse.Namespace) -> torch.Tensor:
    """The episode returns, on ``args.device``."""
    return simulate_returns(params_from(args), args)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    returns, seconds = timed(run, args)
    name = "rect_pin_spatial" if args.spatial else "rect_pin"
    plot_and_report(returns, args, f"{name}_env",
                    f"{name} env random policy episode returns", seconds)


if __name__ == "__main__":
    main()
