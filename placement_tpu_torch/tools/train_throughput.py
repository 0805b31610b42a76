"""Whole PPO train-iteration throughput of the port over ranks (counterpart
of the JAX package's ``tools/train_throughput.py``): env-steps/s per card
of the complete iteration (rollout, GAE, minibatched update) for a
shipped config, the learner sharded over ``--world`` ranks
(``parallel.mesh.shard_learner``).

    python -m placement_tpu_torch.tools.train_throughput \\
        --type rectangle_pin --iterations 20 --world 4

Each rank runs one untimed iteration, then ``--iterations`` timed on the
host's clock; each iteration's metrics are read to the host (a
data-dependent scalar: the sync point), on every rank. The ranks take a
card each over NCCL when there are as many cards, else share them over
gloo; ``--device cpu`` runs gloo ranks on the CPU. Prints one JSON line:
the JAX tool's keys (``value``: env-steps/s per card, the iterations'
env-steps over the slowest rank's seconds and the cards used) with the
world size, the backend, the cards and the card's name.
"""

import argparse
import json
import time
from typing import Dict

import torch

from placement_tpu_torch.agent.policy import Policy, model_config_for
from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner
from placement_tpu_torch.env import core
from placement_tpu_torch.parallel import mesh
from placement_tpu_torch.utils.config import load_experiment


def _config(args: argparse.Namespace) -> PPOConfig:
    return PPOConfig(num_envs=args.num_envs,
                     unroll_length=args.unroll_length,
                     minibatch_size=min(128, args.num_envs
                                        * args.unroll_length),
                     num_sgd_iter=args.num_sgd_iter)


def measure_rank(rank: int, world: int, args: argparse.Namespace
                 ) -> Dict[str, float]:
    """One rank of the measurement (a ``spawn_ranks`` worker): the warm-up
    iteration's and the timed iterations' seconds and the pool wraps."""
    dev = mesh.rank_device(rank, args.device)
    env_params, _, _ = load_experiment(args.type)
    learner = PPOLearner(env_params, Policy(
        env_params, model_config_for(env_params, args.type), dev),
        _config(args))
    place, step = mesh.shard_learner(learner, mesh.make_mesh(world, dev))
    state = place(learner.init(torch.Generator(dev).manual_seed(args.seed)))
    t0 = time.perf_counter()
    state, metrics = step(state)
    float(metrics["episode_reward_mean"])          # the sync point
    warm = time.perf_counter() - t0
    wraps = 0
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        state, metrics = step(state)
        wraps += int(metrics["pool_wraps"])        # the sync point
    return {"warm_seconds": warm, "seconds": time.perf_counter() - t0,
            "pool_wraps": wraps}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", default="rectangle_pin")
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--num-envs", type=int, default=128,
                   help="boards of all ranks together")
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--num-sgd-iter", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--world", type=int, default=1, help="ranks")
    p.add_argument("--device", default="cuda",
                   help="the cards (default) or 'cpu'")
    args = p.parse_args(argv)
    core.check_device(args.device, "train_throughput")
    cuda = torch.device(args.device).type == "cuda"
    backend = mesh.backend_for(args.device, args.world)
    if args.world == 1:
        ranks = [measure_rank(0, 1, args)]
    else:
        ranks = mesh.spawn_ranks(measure_rank, args.world, args=(args,),
                                 backend=backend, timeout=None)
    cfg = _config(args)
    dt = max(r["seconds"] for r in ranks)
    cards = min(args.world, torch.cuda.device_count()) if cuda else args.world
    print(json.dumps({
        "metric": "train_step_env_steps_per_sec_per_card",
        "type": args.type,
        "num_envs": cfg.num_envs, "unroll_length": cfg.unroll_length,
        "iterations": args.iterations,
        "seconds": dt,
        "iter_seconds": dt / args.iterations,
        "value": args.iterations * cfg.train_batch / dt / cards,
        "pool_wraps": ranks[0]["pool_wraps"],
        "world": args.world, "cards": cards,
        "backend": backend if args.world > 1 else None,
        "warm_seconds": max(r["warm_seconds"] for r in ranks),
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
    }), flush=True)


if __name__ == "__main__":
    main()
