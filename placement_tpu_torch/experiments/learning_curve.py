"""PPO learning curve of one model type (port of the JAX package's
``experiments/learning_curve.py``).

Trains the named model type (default: the flagship spatial-observation
config ``rectangle_spatial_pin``) for N iterations, computes the
random-policy baseline on the same environment, and writes the evidence
the reference publishes as a figure (docs/source/_figures/
rect_pin_rewards_weights.png, docs/source/usage.rst:414-418) under
``--out-dir``:

  * ``<type><tag>_progress.csv``       — the run's full metric table
  * ``<type><tag>_learning_curve.png`` — reward / normalized wirelength /
    intersections against the iteration, with the random-policy mean as a
    reference line

    python -m placement_tpu_torch.experiments.learning_curve --iterations 150
    python -m placement_tpu_torch.experiments.learning_curve \\
        --iterations 2 --num-envs 8 --unroll-length 8 --device cpu

The last line printed is one JSON object: the baseline, the mean reward of
the last 10 iterations, their difference, the run dir and the plot.
``--restore <run_dir>`` goes on from a run cut short (``--iterations`` is
the total; the table holds the restored run's rows, then the new run's).
"""

import argparse
import csv
import json
import os

import torch

from placement_tpu_torch.experiments.plot_style import (
    C_BASELINE, C_MUTED, C_SURFACE, C_TEXT, can_plot, style_axis)
from placement_tpu_torch.experiments.plot_style import C_SERIES as _SERIES
from placement_tpu_torch.agent.trainer import DEFAULT_RESULTS_ROOT
from placement_tpu_torch.experiments.seed_sweep import DEFAULT_OUT_DIR

C_SERIES = _SERIES[0]


def plot_curves(rows, baseline_reward, out_png, model_type):
    """Three stacked panels (one measure each — never dual axes)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    it = [r["training_iteration"] for r in rows]
    panels = [
        ("episode_reward_mean", "Episode reward (mean)", baseline_reward,
         "random policy"),
        ("custom_metrics/normalized_wirelengths_mean",
         "Normalized wirelength (mean)", None, None),
        ("custom_metrics/num_intersections_mean",
         "Wire crossings (mean)", None, None),
    ]
    fig, axes = plt.subplots(3, 1, figsize=(7.2, 7.8), sharex=True)
    fig.patch.set_facecolor(C_SURFACE)
    for ax, (col, title, base, base_label) in zip(axes, panels):
        ys = [r.get(col, float("nan")) for r in rows]
        ax.plot(it, ys, color=C_SERIES, linewidth=2)
        if base is not None:
            ax.axhline(base, color=C_BASELINE, linewidth=1.2,
                       linestyle=(0, (4, 3)))
            ax.annotate(f"{base_label}: {base:.3f}", xy=(it[-1], base),
                        xytext=(-4, 5), textcoords="offset points",
                        ha="right", fontsize=8.5, color=C_MUTED)
        style_axis(ax, title)
    axes[-1].set_xlabel("training iteration", fontsize=9.5, color=C_MUTED)
    fig.suptitle(f"PPO on {model_type} — learning curve",
                 x=0.125, ha="left", fontsize=12, color=C_TEXT)
    fig.tight_layout(rect=(0, 0, 1, 0.97))
    fig.savefig(out_png, dpi=144, facecolor=C_SURFACE)
    plt.close(fig)


def _read_progress(run_dir):
    """A run's progress.csv rows, as written (strings)."""
    with open(os.path.join(run_dir, "progress.csv"), newline="") as f:
        return list(csv.DictReader(f))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", default="rectangle_spatial_pin")
    p.add_argument("--iterations", type=int, default=150)
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--baseline-episodes", type=int, default=512)
    p.add_argument("--results-root", default=DEFAULT_RESULTS_ROOT,
                   help="root of the training runs' directories")
    p.add_argument("--device", default="cuda",
                   help="the card (default; raises without one) or 'cpu'")
    p.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                   help="directory of the progress table and the plot")
    p.add_argument("--restore", default=None,
                   help="a run dir of this runner's to go on from: its "
                        "newest checkpoint is restored, its rows up to it "
                        "kept, and training goes on to --iterations in all")
    p.add_argument("--tag", default="",
                   help="file-name suffix after the type, e.g. _h100")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)

    from placement_tpu_torch.agent.ppo import PPOConfig
    from placement_tpu_torch.agent.random_policy import simulate
    from placement_tpu_torch.agent.trainer import Trainer
    from placement_tpu_torch.env import core
    from placement_tpu_torch.utils.config import load_experiment

    device = core.check_device(args.device, "learning_curve")
    env_params, _, _ = load_experiment(args.type)
    base_returns = simulate(
        env_params, torch.Generator(device).manual_seed(args.seed + 1),
        args.baseline_episodes, device=device)
    baseline = float(base_returns.mean())
    print(f"random-policy baseline: {baseline:.4f} "
          f"(n={args.baseline_episodes})", flush=True)

    cfg = PPOConfig(num_envs=args.num_envs,
                    unroll_length=args.unroll_length,
                    minibatch_size=min(128,
                                       args.num_envs * args.unroll_length))
    trainer = Trainer(args.type, ppo_config=cfg,
                      results_root=args.results_root, device=device)
    rows = []

    def report(it, row):
        rows.append(dict(row))
        if it % 10 == 0 or it == 1:
            wl = row.get("custom_metrics/normalized_wirelengths_mean",
                         float("nan"))
            crossings = row.get("custom_metrics/num_intersections_mean",
                                float("nan"))
            print(f"iter {it}: reward={row.get('episode_reward_mean'):.4f} "
                  f"wl={wl:.4f} int={crossings:.4f}", flush=True)

    try:
        state, kept = None, []
        if args.restore:
            state = trainer.restore(run_dir=args.restore, seed=args.seed)
            done = state.steps // cfg.train_batch
            kept = _read_progress(args.restore)[:done]
            if len(kept) != done:
                raise ValueError(f"{args.restore}: progress.csv has "
                                 f"{len(kept)} rows, its checkpoint {done} "
                                 "iterations")
            rows.extend({k: float(v) if v else float("nan")
                         for k, v in r.items()} for r in kept)
        result = trainer.run(num_iterations=args.iterations - len(kept),
                             seed=args.seed, state=state,
                             on_iteration=report)
    finally:
        trainer.close()

    stem = os.path.join(args.out_dir, f"{args.type}{args.tag}")
    os.makedirs(args.out_dir, exist_ok=True)
    table = kept + _read_progress(result.run_dir)
    with open(f"{stem}_progress.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(table[0]))
        wr.writeheader()
        wr.writerows(table)
    out_png = None
    if can_plot():
        out_png = f"{stem}_learning_curve.png"
        plot_curves(rows, baseline, out_png, args.type)

    last10 = rows[-10:]
    final = sum(r["episode_reward_mean"] for r in last10) / len(last10)
    summary = {
        "type": args.type, "iterations": args.iterations,
        "random_baseline_reward": round(baseline, 4),
        "final_reward_mean_last10": round(final, 4),
        "improvement": round(final - baseline, 4),
        "run_dir": result.run_dir, "plot": out_png,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
