"""Plot a training run's learning curve (port of the JAX package's
``tools/plot_learning_curve.py``).

    python -m placement_tpu_torch.tools.plot_learning_curve <run_dir> [out.png]

Reads the run's progress.csv (``placement_tpu_torch.utils.metrics``'s
format — the same columns as the reference's Ray Tune output) and draws
episode_reward_mean plus the custom wirelength/intersection metrics, the
quantities the reference plots in docs/source/_figures/
rect_pin_rewards_weights.png (docs/source/usage.rst:414-418). The plot goes
to ``out.png``, by default ``learning_curve.png`` in the learning-curve
runners' default directory. It reads a file and draws on the host: no
device is used.
"""

import argparse
import os
import pathlib

from placement_tpu_torch.experiments.seed_sweep import DEFAULT_OUT_DIR
from placement_tpu_torch.utils.metrics import read_progress


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir", help="a run directory holding progress.csv")
    p.add_argument("out", nargs="?",
                   default=os.path.join(DEFAULT_OUT_DIR,
                                        "learning_curve.png"),
                   help="the PNG to write")
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = read_progress(args.run_dir)
    it = cols["training_iteration"]

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].plot(it, cols["episode_reward_mean"])
    axes[0].set_title("episode_reward_mean")
    axes[1].plot(it, cols["custom_metrics/normalized_wirelengths_mean"])
    axes[1].set_title("normalized wirelength (mean)")
    axes[2].plot(it, cols["custom_metrics/num_intersections_mean"])
    axes[2].set_title("intersections (mean)")
    for ax in axes:
        ax.set_xlabel("training iteration")
        ax.grid(alpha=0.3)
    fig.suptitle(pathlib.Path(args.run_dir).name)
    fig.tight_layout()
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print("saved", args.out)
    return args.out


if __name__ == "__main__":
    main()
