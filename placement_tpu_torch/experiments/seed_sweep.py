"""Multi-seed learning curves and an intersection-weight sweep (port of
the JAX package's ``experiments/seed_sweep.py``).

The reference's published PPO evidence is a multi-curve figure of reward
for several ``weight_num_intersections`` values (docs/source/_figures/
rect_pin_rewards_weights.png, docs/source/usage.rst:414-418). This runner
produces both evidence axes on the flagship spatial config, under
``--out-dir``:

  * seed sweep — N seeds on the unmodified config; artifact =
    ``<type>_seed_sweep<tag>.csv`` + a mean/min-max band plot against the
    random-policy baseline (``<type>_seed_band<tag>.png``)
  * weight sweep — reward curves for several intersection weights
    (wirelength weight fixed, as in the reference figure); artifact =
    ``<type>_weight_sweep<tag>.csv`` + overlay plot
    (``<type>_weight_sweep<tag>.png``)

    python -m placement_tpu_torch.experiments.seed_sweep --seeds 0 1 2
    python -m placement_tpu_torch.experiments.seed_sweep --seeds 0 1 2 \\
        --num-sgd-iter 10 --skip-weights --tag _sgd10

Each sweep's CSV is rewritten after every run, so a sweep cut short keeps
the runs it finished, and ``--resume`` goes on from them. The last line
printed is one JSON object: the baseline and each run's mean reward over
its last 10 iterations.
"""

import argparse
import csv
import json
import os

import torch

from placement_tpu_torch.agent.trainer import DEFAULT_RESULTS_ROOT
from placement_tpu_torch.experiments.plot_style import (
    C_BASELINE, C_MUTED, C_SERIES, C_SURFACE, can_plot,
    style_axis as _style)

#: where the learning-curve runners write by default: beside the port's
#: training runs, never into the JAX package's ``experiments/results/``
DEFAULT_OUT_DIR = os.path.join(DEFAULT_RESULTS_ROOT, "learning_curve")
#: the random-policy baseline's generator seed (JAX ``PRNGKey(1001)``)
BASELINE_SEED = 1001

C_BAND = C_SERIES[0]


def _train_once(model_type, iterations, seed, num_envs, unroll,
                env_overrides=None, num_sgd_iter=None, device="cuda",
                results_root=DEFAULT_RESULTS_ROOT):
    """One training run's metric rows, one per iteration."""
    from placement_tpu_torch.agent.ppo import PPOConfig
    from placement_tpu_torch.agent.trainer import Trainer

    kw = {} if num_sgd_iter is None else {"num_sgd_iter": num_sgd_iter}
    cfg = PPOConfig(num_envs=num_envs, unroll_length=unroll,
                    minibatch_size=min(128, num_envs * unroll), **kw)
    trainer = Trainer(model_type, ppo_config=cfg,
                      env_overrides=env_overrides or {},
                      use_tensorboard=False, results_root=results_root,
                      device=device)
    rows = []

    def keep(it, row):
        rows.append(dict(row))
        if it % 25 == 0 or it == 1:
            print(f"  iter {it}: reward="
                  f"{row.get('episode_reward_mean'):.4f}", flush=True)

    try:
        trainer.run(num_iterations=iterations, seed=seed, on_iteration=keep)
    finally:
        trainer.close()
    return rows


def plot_seed_band(per_seed, baseline, out_png, model_type):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_it = min(len(r) for r in per_seed.values())
    it = list(range(1, n_it + 1))
    series = [[r[i]["episode_reward_mean"] for r in per_seed.values()]
              for i in range(n_it)]
    mean = [sum(v) / len(v) for v in series]
    lo = [min(v) for v in series]
    hi = [max(v) for v in series]

    fig, ax = plt.subplots(figsize=(7.2, 4.2))
    fig.patch.set_facecolor(C_SURFACE)
    ax.fill_between(it, lo, hi, color=C_BAND, alpha=0.18, linewidth=0,
                    label=f"min–max over {len(per_seed)} seeds")
    ax.plot(it, mean, color=C_BAND, linewidth=2, label="mean")
    ax.axhline(baseline, color=C_BASELINE, linewidth=1.2,
               linestyle=(0, (4, 3)))
    ax.annotate(f"random policy: {baseline:.3f}", xy=(it[-1], baseline),
                xytext=(-4, 5), textcoords="offset points", ha="right",
                fontsize=8.5, color=C_MUTED)
    _style(ax, f"PPO on {model_type} — episode reward, "
               f"{len(per_seed)} seeds")
    ax.set_xlabel("training iteration", fontsize=9.5, color=C_MUTED)
    ax.legend(frameon=False, fontsize=8.5, loc="lower right",
              labelcolor=C_MUTED)
    fig.tight_layout()
    fig.savefig(out_png, dpi=144, facecolor=C_SURFACE)
    plt.close(fig)


def plot_weight_sweep(per_weight, out_png, model_type):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7.2, 4.2))
    fig.patch.set_facecolor(C_SURFACE)
    for i, (w, rows) in enumerate(sorted(per_weight.items())):
        it = [r["training_iteration"] for r in rows]
        ys = [r["episode_reward_mean"] for r in rows]
        ax.plot(it, ys, color=C_SERIES[i % len(C_SERIES)], linewidth=2,
                label=f"intersection weight {w}")
    _style(ax, f"PPO on {model_type} — reward for varied intersection "
               f"weights (wirelength weight fixed)")
    ax.set_xlabel("training iteration", fontsize=9.5, color=C_MUTED)
    ax.legend(frameon=False, fontsize=8.5, loc="lower right",
              labelcolor=C_MUTED)
    fig.tight_layout()
    fig.savefig(out_png, dpi=144, facecolor=C_SURFACE)
    plt.close(fig)


def _write_csv(path, rows, extra_cols):
    cols = list(extra_cols) + ["training_iteration", "episode_reward_mean",
                               "normalized_wirelengths_mean",
                               "num_intersections_mean"]
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=cols)
        wr.writeheader()
        for r in rows:
            wr.writerow({c: r.get(c, "") for c in cols})


def slim(rows, **tags):
    """A run's metric rows cut to the sweep CSV's columns, with ``tags``."""
    return [{
        **tags,
        "training_iteration": int(r["training_iteration"]),
        "episode_reward_mean": r["episode_reward_mean"],
        "normalized_wirelengths_mean":
            r.get("custom_metrics/normalized_wirelengths_mean"),
        "num_intersections_mean":
            r.get("custom_metrics/num_intersections_mean"),
    } for r in rows]


def load_runs(path, key):
    """-> {value of ``key``: [row, ...]} of a sweep table written by
    ``_write_csv`` (numbers as floats, empty cells None); {} without
    one."""
    runs = {}
    if not os.path.exists(path):
        return runs
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            row = {k: float(v) if v else None for k, v in r.items()}
            row["training_iteration"] = int(row["training_iteration"])
            runs.setdefault(row[key], []).append(row)
    return runs


def _final(rows):
    return round(sum(r["episode_reward_mean"] for r in rows[-10:]) / 10, 4)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", default="rectangle_spatial_pin")
    p.add_argument("--iterations", type=int, default=150)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--weights", type=float, nargs="+",
                   default=[0.1, 0.5, 0.9])
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--unroll-length", type=int, default=32)
    p.add_argument("--skip-weights", action="store_true")
    p.add_argument("--skip-seeds", action="store_true")
    p.add_argument("--num-sgd-iter", type=int, default=None,
                   help="override PPOConfig.num_sgd_iter (the RLlib-parity "
                        "default is 30; 10 is the documented throughput "
                        "preset)")
    p.add_argument("--tag", default="",
                   help="artifact filename suffix, e.g. _sgd10")
    p.add_argument("--resume", action="store_true",
                   help="reuse the runs whose rows in --out-dir's tables "
                        "already cover --iterations (a sweep cut short "
                        "goes on where it stopped)")
    p.add_argument("--baseline-episodes", type=int, default=512,
                   help="random-policy episodes of the baseline")
    p.add_argument("--results-root", default=DEFAULT_RESULTS_ROOT,
                   help="root of the training runs' directories")
    p.add_argument("--device", default="cuda",
                   help="the card (default; raises without one) or 'cpu'")
    p.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                   help="directory of the sweep tables and plots")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)

    from placement_tpu_torch.agent.random_policy import simulate
    from placement_tpu_torch.env import core
    from placement_tpu_torch.utils.config import load_experiment

    device = core.check_device(args.device, "seed_sweep")
    os.makedirs(args.out_dir, exist_ok=True)
    env_params, _, _ = load_experiment(args.type)
    baseline = float(simulate(
        env_params, torch.Generator(device).manual_seed(BASELINE_SEED),
        args.baseline_episodes, device=device).mean())
    print(f"random-policy baseline: {baseline:.4f}", flush=True)
    summary = {"type": args.type, "iterations": args.iterations,
               "random_baseline_reward": round(baseline, 4)}

    def out(name, ext):
        return os.path.join(args.out_dir,
                            f"{args.type}_{name}{args.tag}.{ext}")

    def sweep(name, key, values, train):
        """{value: slim rows} of one run per value of ``key``, the table
        rewritten after each; with ``--resume``, a value whose rows in
        the table cover ``--iterations`` is reused."""
        path = out(name, "csv")
        done = load_runs(path, key) if args.resume else {}
        runs, flat = {}, []
        for v in values:
            kept = done.get(float(v), [])
            if len(kept) >= args.iterations:
                print(f"{key} {v}: reusing {len(kept)} iterations of "
                      f"{path}", flush=True)
                runs[v] = [{**r, key: v} for r in kept]
            else:
                print(f"{key} {v}:", flush=True)
                runs[v] = slim(train(v), **{key: v})
            flat.extend(runs[v])
            _write_csv(path, flat, [key])
        return runs

    def train(seed, **kw):
        return _train_once(args.type, args.iterations, seed, args.num_envs,
                           args.unroll_length, num_sgd_iter=args.num_sgd_iter,
                           device=device, results_root=args.results_root,
                           **kw)

    if not args.skip_seeds:
        per_seed = sweep("seed_sweep", "seed", args.seeds, train)
        if can_plot():
            plot_seed_band(per_seed, baseline, out("seed_band", "png"),
                           args.type)
        summary["final_reward_by_seed"] = {
            s: _final(rows) for s, rows in per_seed.items()}

    if not args.skip_weights:
        per_weight = sweep(
            "weight_sweep", "weight_num_intersections", args.weights,
            lambda w: train(args.seeds[0], env_overrides={
                "weight_num_intersections": w}))
        if can_plot():
            plot_weight_sweep(per_weight, out("weight_sweep", "png"),
                              args.type)
        summary["final_reward_by_weight"] = {
            w: _final(rows) for w, rows in per_weight.items()}

    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
