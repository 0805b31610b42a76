"""PPO training entry point of the port (counterpart of the JAX package's
``experiments/ppo.py``; reference ``experiments/PPO/PPO.py``): pick a model
type, train with a checkpoint each iteration (keep 5), and, for pin model
types, export greedy rollouts and the config CSV afterwards.

    python -m placement_tpu_torch.experiments.ppo --type rectangle_pin \\
        --iterations 1                       # on the card
    python -m placement_tpu_torch.experiments.ppo --type rectangle_pin \\
        --iterations 2 --num-envs 8 --unroll-length 8 --device cpu

Data-parallel (``parallel/mesh.py``: boards split over the ranks,
gradients all-reduced; every rank computes what one process would):

    # one rank per card of this host (NCCL)
    python -m placement_tpu_torch.experiments.ppo --type rectangle_pin \\
        --data-parallel
    # two gloo ranks on the CPU
    python -m placement_tpu_torch.experiments.ppo --type rectangle_pin \\
        --data-parallel --local-ranks 2 --device cpu --num-envs 8
    # host i of P: its ranks join one group at the coordinator, numbered
    # host by host (global rank = process id * local ranks + local rank)
    python -m placement_tpu_torch.experiments.ppo --type rectangle_pin \\
        --data-parallel --coordinator host0:29500 --num-processes P \\
        --process-id i --run-name shared

Without ``--data-parallel``, a process of a multi-process run is one rank.
"""

import argparse
import json
import sys

import torch
import torch.distributed as dist

from placement_tpu_torch.agent.ppo import PPOConfig
from placement_tpu_torch.agent.trainer import Trainer
from placement_tpu_torch.parallel import mesh
from placement_tpu_torch.utils.config import MODEL_TYPES
from placement_tpu_torch.viz.rollout import generate_rollouts


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a PPO placement agent")
    p.add_argument("--type", required=True, choices=sorted(MODEL_TYPES),
                   help="model type (experiments/PPO/PPO.py:29-35)")
    p.add_argument("--iterations", type=int, default=1,
                   help="training iterations (reference default: 1)")
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--num-sgd-iter", type=int, default=30,
                   help="SGD epochs per iteration (RLlib-parity default 30)")
    p.add_argument("--route-budget", type=int, default=None,
                   help="gated terminal routing: per-step finisher budget "
                        "(pin variants; rewards match eager to one f32 ulp)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restore", type=str, default=None,
                   help="run dir to restore the newest checkpoint from")
    p.add_argument("--no-rollouts", action="store_true",
                   help="skip post-training rollout export")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the boards over ranks on this host, one per "
                        "local card (the ranks must divide --num-envs and "
                        "the minibatch)")
    p.add_argument("--local-ranks", type=int, default=None,
                   help="ranks on this host with --data-parallel: by "
                        "default one per local card; required with "
                        "--device cpu, where there is no card to count "
                        "(ranks beyond the cards share them over gloo)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of iterations "
                        "2-3 (rank 0's) into this directory")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process: host:port where the ranks meet "
                        "(rank 0's host)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process: processes (hosts) in the run")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process: this process's number, from 0")
    p.add_argument("--run-name", type=str, default=None,
                   help="fixed run-dir name (required for multi-process "
                        "runs so every process shares one run directory)")
    p.add_argument("--results-root", type=str, default=None,
                   help="results root (default ~/placement_tpu_results)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; 'cpu' to run on "
                        "the CPU)")
    return p


def train_rank(rank: int, world: int, args: argparse.Namespace) -> dict:
    """One rank's run (for one process, the whole run); returns the last
    iteration's metrics row. Rank 0 alone prints the run and exports the
    rollouts; every rank prints its final metrics."""
    cfg = PPOConfig(num_envs=args.num_envs,
                    unroll_length=args.unroll_length,
                    minibatch_size=min(128, args.num_envs
                                       * args.unroll_length),
                    num_sgd_iter=args.num_sgd_iter,
                    route_budget=args.route_budget)
    extra = {}
    if args.results_root:
        extra["results_root"] = args.results_root
    data_parallel = world > 1 or args.data_parallel
    trainer = Trainer(args.type, ppo_config=cfg,
                      profile_dir=args.profile_dir, run_name=args.run_name,
                      mesh=(mesh.make_mesh(world, args.device)
                            if data_parallel else None),
                      device=args.device, **extra)
    main = trainer.is_main_process
    tag = f"rank {rank}: " if world > 1 else ""
    try:
        state = None
        if args.restore:
            state = trainer.restore(run_dir=args.restore, seed=args.seed)

        def report(it, row):
            if main:
                print(f"iter {it}: reward_mean="
                      f"{row.get('episode_reward_mean'):.4f} "
                      f"kl={row.get('kl', float('nan')):.5f}", flush=True)

        result = trainer.run(num_iterations=args.iterations, seed=args.seed,
                             state=state, on_iteration=report)
        if main:
            print("run dir:", result.run_dir)
        # rollout export for pin types only (experiments/PPO/PPO.py:49-54);
        # one writer in data-parallel runs
        if not args.no_rollouts and "pin" in args.type and main:
            generate_rollouts(trainer, state=result.state)
            print("rollouts exported to", result.run_dir)
        # one write of the whole line: the ranks share the parent's pipe,
        # and print's separate write of the newline lets their lines mix
        sys.stdout.write(f"{tag}final metrics: "
                         f"{json.dumps(result.final_metrics, sort_keys=True)}"
                         "\n")
        sys.stdout.flush()
        return result.final_metrics
    finally:
        trainer.close()


def _local_ranks(args: argparse.Namespace, p: argparse.ArgumentParser
                 ) -> int:
    if not args.data_parallel:
        return 1
    if args.local_ranks is not None:
        return args.local_ranks
    if torch.device(args.device).type != "cuda":
        p.error("--data-parallel on the CPU needs --local-ranks")
    return max(torch.cuda.device_count(), 1)


def main(argv=None) -> None:
    p = _parser()
    args = p.parse_args(argv)
    procs = args.num_processes or 1
    if procs > 1 and not args.run_name:
        p.error("--run-name is required with --num-processes > 1 "
                "(timestamped names would differ across processes)")
    if procs > 1 and (args.coordinator is None or args.process_id is None):
        p.error("--coordinator and --process-id are required with "
                "--num-processes > 1")
    local = _local_ranks(args, p)
    world = procs * local
    first = (args.process_id or 0) * local
    init = f"tcp://{args.coordinator}" if procs > 1 else None
    backend = ("nccl" if torch.device(args.device).type == "cuda"
               and torch.cuda.device_count() >= local else "gloo")
    if local == 1:              # this process is the rank
        mesh.initialize_distributed(init, world, first, backend)
        try:
            train_rank(first, world, args)
        finally:
            if world > 1:
                dist.destroy_process_group()
        return
    mesh.spawn_ranks(train_rank, world, args=(args,), backend=backend,
                     local=local, first_rank=first, init_method=init,
                     timeout=None)


if __name__ == "__main__":
    main()
