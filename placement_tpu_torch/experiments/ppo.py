"""PPO training entry point of the port (counterpart of the JAX package's
``experiments/ppo.py``; reference ``experiments/PPO/PPO.py``): pick a model
type, train with a checkpoint each iteration (keep 5), and, for pin model
types, export greedy rollouts and the config CSV afterwards.

    python -m placement_tpu_torch.experiments.ppo --type rectangle_pin \\
        --iterations 1                       # on the card
    python -m placement_tpu_torch.experiments.ppo --type rectangle_pin \\
        --iterations 2 --num-envs 8 --unroll-length 8 --device cpu

The JAX CLI's data-parallel and multi-host flags wait for the learner half
of ``parallel/mesh.py``.
"""

import argparse

from placement_tpu_torch.agent.ppo import PPOConfig
from placement_tpu_torch.agent.trainer import Trainer
from placement_tpu_torch.utils.config import MODEL_TYPES
from placement_tpu_torch.viz.rollout import generate_rollouts


def main(argv=None) -> None:
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
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of iterations "
                        "2-3 into this directory")
    p.add_argument("--run-name", type=str, default=None,
                   help="fixed run-dir name")
    p.add_argument("--results-root", type=str, default=None,
                   help="results root (default ~/placement_tpu_results)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; 'cpu' to run on "
                        "the CPU)")
    args = p.parse_args(argv)

    cfg = PPOConfig(num_envs=args.num_envs,
                    unroll_length=args.unroll_length,
                    minibatch_size=min(128, args.num_envs
                                       * args.unroll_length),
                    num_sgd_iter=args.num_sgd_iter,
                    route_budget=args.route_budget)
    extra = {}
    if args.results_root:
        extra["results_root"] = args.results_root
    trainer = Trainer(args.type, ppo_config=cfg,
                      profile_dir=args.profile_dir, run_name=args.run_name,
                      device=args.device, **extra)
    try:
        state = None
        if args.restore:
            state = trainer.restore(run_dir=args.restore, seed=args.seed)

        def report(it, row):
            print(f"iter {it}: reward_mean="
                  f"{row.get('episode_reward_mean'):.4f} "
                  f"kl={row.get('kl', float('nan')):.5f}")

        result = trainer.run(num_iterations=args.iterations, seed=args.seed,
                             state=state, on_iteration=report)
        print("run dir:", result.run_dir)
        # rollout export for pin types only (experiments/PPO/PPO.py:49-54)
        if not args.no_rollouts and "pin" in args.type:
            generate_rollouts(trainer, state=result.state)
            print("rollouts exported to", result.run_dir)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
