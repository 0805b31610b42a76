"""Run discovery and curve loading for the port's web app (port of
``placement_tpu/webapp/data.py``), over the run directories that the
port's ``Trainer`` writes under the same ``DEFAULT_RESULTS_ROOT``.

Mirrors what the reference's Streamlit pages read from ``~/ray_results/PPO``:
the Trained-agents page lists runs by timestamp and shows the input-param CSV
plus ``progress.csv`` stats (``web_app/pages/1_…Trained agents.py:33-120``);
the Comparison page overlays ``episode_reward_mean`` /
``custom_metrics/normalized_wirelengths_mean`` /
``custom_metrics/num_intersections_mean`` across runs
(``web_app/pages/3_…Comparison analysis.py:31-80``). This module is pure
data (no Streamlit import) so it is unit-testable headless.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from placement_tpu_torch.agent.trainer import DEFAULT_RESULTS_ROOT

CURVE_COLUMNS = (
    "episode_reward_mean",
    "custom_metrics/normalized_wirelengths_mean",
    "custom_metrics/num_intersections_mean",
)


@dataclasses.dataclass
class RunSummary:
    name: str
    path: str
    model_type: str
    mtime: float
    num_iterations: int
    final_reward_mean: Optional[float]
    has_rollouts: bool
    env_config: Dict
    input_params: Dict[str, str]


def _read_progress(run_dir: str) -> List[Dict[str, str]]:
    path = os.path.join(run_dir, "progress.csv")
    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _read_input_csv(run_dir: str) -> Dict[str, str]:
    """The 1-row <model_type>.csv written by save_config_to_csv."""
    for name in os.listdir(run_dir):
        if name.endswith(".csv") and name != "progress.csv":
            with open(os.path.join(run_dir, name), newline="") as f:
                rows = list(csv.DictReader(f))
            return rows[0] if rows else {}
    return {}


def load_run(run_dir: str) -> RunSummary:
    params_path = os.path.join(run_dir, "params.json")
    params = {}
    if os.path.exists(params_path):
        with open(params_path) as f:
            params = json.load(f)
    rows = _read_progress(run_dir)
    final = (float(rows[-1]["episode_reward_mean"])
             if rows and rows[-1].get("episode_reward_mean") else None)
    return RunSummary(
        name=os.path.basename(run_dir),
        path=run_dir,
        model_type=params.get("model_type", "unknown"),
        mtime=os.path.getmtime(run_dir),
        num_iterations=len(rows),
        final_reward_mean=final,
        has_rollouts=os.path.exists(os.path.join(run_dir, "actions.pkl")),
        env_config=params.get("env_config", {}),
        input_params=_read_input_csv(run_dir),
    )


def list_runs(results_root: Optional[str] = None) -> List[RunSummary]:
    """All runs, newest first (Trained-agents page ordering).

    ``results_root`` resolves at call time (this module's attribute, not a
    bound default) so tests can repoint ``DEFAULT_RESULTS_ROOT``."""
    ppo_root = os.path.join(results_root or DEFAULT_RESULTS_ROOT, "PPO")
    if not os.path.isdir(ppo_root):
        return []
    runs = [load_run(os.path.join(ppo_root, d))
            for d in os.listdir(ppo_root)
            if os.path.isdir(os.path.join(ppo_root, d))]
    return sorted(runs, key=lambda r: r.mtime, reverse=True)


def comparison_curves(run_dirs: List[str]
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """{run name: {column: values over iterations}} for the overlay plots."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for run_dir in run_dirs:
        rows = _read_progress(run_dir)
        if not rows:
            continue
        curves = {"training_iteration": np.array(
            [float(r["training_iteration"]) for r in rows])}
        for col in CURVE_COLUMNS:
            if col in rows[0]:
                curves[col] = np.array(
                    [float(r[col]) if r[col] else np.nan for r in rows])
        out[os.path.basename(run_dir)] = curves
    return out
