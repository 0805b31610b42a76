"""Run metrics: progress.csv and TensorBoard events (port of
``placement_tpu/utils/metrics.py``).

Ray Tune writes both into every run directory, and the reference's callback
adds ``normalized_wirelengths`` / ``num_intersections`` episode metrics
(``utils/agent/callbacks.py:8-42``). The learner's metrics carry those
(``agent/ppo.py``), and this logger writes the JAX package's columns, so
the comparison tooling (``web_app/pages/3_…Comparison analysis.py:31-80``)
reads either package's runs: ``training_iteration``, ``timesteps_total``,
``time_total_s``, the metrics in the learner's order, the two custom ones
under ``custom_metrics/``.

TensorBoard goes through ``torch.utils.tensorboard`` where its package is
installed; without it the logger writes the CSV alone, and says once which
sinks it writes.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Any, Dict

import numpy as np
import torch

log = logging.getLogger(__name__)

# Columns promoted to the "custom_metrics/" namespace for parity with the
# RLlib callback output (utils/agent/callbacks.py:35-42).
_CUSTOM = ("normalized_wirelengths_mean", "num_intersections_mean")


def _scalars(metrics: Dict[str, Any]) -> Dict[str, float]:
    """The metrics as Python floats, the device's tensors read in one copy
    (one sync) rather than one each."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().reshape(())
                            .to(torch.float64) for k in keys]).cpu().tolist()
        out.update(zip(keys, vals))
    return {k: out[k] for k in metrics}


class MetricsLogger:
    """Writes one row per training iteration to progress.csv + TensorBoard."""

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        self.logdir = os.path.abspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)
        self._csv_path = os.path.join(self.logdir, "progress.csv")
        self._csv_file = None
        self._csv_writer = None
        self._fieldnames = None
        self._t0 = time.time()
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                log.warning("%s: TensorBoard is not installed (%s); writing "
                            "progress.csv only", self.logdir, e)
            else:
                self._tb = SummaryWriter(self.logdir)
        if self._tb is not None or not use_tensorboard:
            log.info("%s: writing progress.csv%s", self.logdir,
                     " and TensorBoard events" if self._tb is not None
                     else " only")

    def _row(self, iteration: int, timesteps_total: int,
             metrics: Dict[str, Any]) -> Dict[str, float]:
        row: Dict[str, float] = {
            "training_iteration": iteration,
            "timesteps_total": timesteps_total,
            "time_total_s": time.time() - self._t0,
        }
        for k, v in _scalars(metrics).items():
            name = f"custom_metrics/{k}" if k in _CUSTOM else k
            row[name] = v
        return row

    def log(self, iteration: int, timesteps_total: int,
            metrics: Dict[str, Any]) -> Dict[str, float]:
        row = self._row(iteration, timesteps_total, metrics)

        if self._csv_writer is None:
            self._fieldnames = list(row)
            self._csv_file = open(self._csv_path, "w", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file,
                                              fieldnames=self._fieldnames)
            self._csv_writer.writeheader()
        self._csv_writer.writerow({k: row.get(k, "") for k in self._fieldnames})
        self._csv_file.flush()

        if self._tb is not None:
            for k, v in row.items():
                if k != "training_iteration":
                    self._tb.add_scalar(k, v, iteration)
            self._tb.flush()
        return row

    def close(self) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = None
            self._csv_writer = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class NullMetricsLogger(MetricsLogger):
    """Identical row computation (shared ``_row``), no file output: for the
    ranks other than 0 of a run over several processes, which compute the
    same rows."""

    def __init__(self) -> None:
        self._t0 = time.time()
        self._tb = None
        self._csv_file = None
        self._csv_writer = None

    def log(self, iteration: int, timesteps_total: int,
            metrics: Dict[str, Any]) -> Dict[str, float]:
        return self._row(iteration, timesteps_total, metrics)


def read_progress(logdir: str) -> Dict[str, np.ndarray]:
    """Load progress.csv back as column arrays (comparison-page reader)."""
    path = os.path.join(logdir, "progress.csv")
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    return {k: np.array([float(r[k]) if r[k] != "" else np.nan for r in rows])
            for k in rows[0]}
