"""Training orchestration: the ``tune.run("PPO", ...)`` replacement (port of
``placement_tpu/agent/trainer.py``).

The reference trains through Ray Tune (``experiments/PPO/PPO.py:36-47``):
build a PPO config from ``agent/config/<type>.json``, run N iterations with
a checkpoint each (keep 5), then export rollouts. Here that lifecycle is a
loop around ``PPOLearner.train_step`` on one device; the host resolves the
config, reads the metrics once an iteration, logs them and saves the
checkpoints.

Run-dir layout as the reference documents it (``docs/source/usage.rst:
284-311``) and the JAX package writes it: ``<results_root>/PPO/
PPO_<type>_<ts>/`` with ``progress.csv``, TensorBoard events (where
TensorBoard is installed), ``params.json`` (the full run config) and
``checkpoints/checkpoint_<iter>/``.

Data-parallel training (``mesh``, a ``parallel.mesh.Mesh`` of this rank):
every rank builds the same ``Trainer`` and trains through
``parallel.mesh.shard_learner``; rank 0 is the main process and alone
writes ``params.json``, ``progress.csv`` and TensorBoard (the metrics are
the same on every rank), the others log to a ``NullMetricsLogger``; every
rank takes part in each checkpoint save, which rank 0 writes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from placement_tpu_torch.agent.policy import Policy, model_config_for
from placement_tpu_torch.agent.ppo import PPOConfig, PPOLearner, TrainState
from placement_tpu_torch.env import core
from placement_tpu_torch.env.fidelity import (
    GENERATION_FIELDS, check_sampling_fidelity)
from placement_tpu_torch.parallel.mesh import Mesh
from placement_tpu_torch.utils.checkpoint import (
    CheckpointManager, find_latest_run)
from placement_tpu_torch.utils.config import MODEL_TYPES, load_experiment
from placement_tpu_torch.utils.metrics import MetricsLogger, NullMetricsLogger

log = logging.getLogger(__name__)

DEFAULT_RESULTS_ROOT = os.path.expanduser("~/placement_tpu_results")

#: the model fields that follow the env's geometry (JAX ``:85-99``)
_GEOMETRY_FIELDS = ("height", "width", "num_orientations",
                    "max_num_components", "max_num_nets",
                    "max_num_pins_per_component",
                    "component_feature_vector_width",
                    "pin_feature_vector_width")


def _run_name(model_type: str) -> str:
    return "PPO_{}_{}".format(model_type,
                              time.strftime("%Y-%m-%d_%H-%M-%S"))


@dataclasses.dataclass
class TrainResult:
    run_dir: str
    checkpoint_dir: str
    final_metrics: Dict[str, float]
    state: TrainState


class Trainer:
    """Config-driven PPO training on ``device`` (the card unless the CPU is
    asked for; raises without a card), with checkpoints, metric logging
    and, given ``profile_dir``, a profiler trace of iterations 2-3 (rank
    0's). With a ``mesh``, this rank's part of a data-parallel run on the
    mesh's device."""

    def __init__(self, model_type: str,
                 config_dir: Optional[str] = None,
                 results_root: str = DEFAULT_RESULTS_ROOT,
                 ppo_config: Optional[PPOConfig] = None,
                 env_overrides: Optional[Dict[str, Any]] = None,
                 model_overrides: Optional[Dict[str, Any]] = None,
                 keep_checkpoints: int = 5,
                 checkpoint_freq: int = 1,
                 use_tensorboard: bool = True,
                 run_name: Optional[str] = None,
                 mesh: Optional[Mesh] = None,
                 profile_dir: Optional[str] = None,
                 device: core.Device = "cuda"):
        if model_type not in MODEL_TYPES:
            raise KeyError(f"unknown model type {model_type!r}; "
                           f"one of {sorted(MODEL_TYPES)}")
        self.device = core.check_device(
            device if mesh is None else mesh.device, "Trainer")
        self.mesh = mesh
        self.is_main_process = mesh is None or mesh.rank == 0
        self.model_type = model_type
        env_params, model_cfg, raw = load_experiment(model_type, config_dir)
        if env_overrides:
            env_params = env_params.replace(**env_overrides).validate()
            # user-supplied generation parameters (web-app sliders, API
            # overrides) can move a pin config into a cap-bound sampling
            # regime that the shipped configs' evidence does not cover:
            # measure it and warn (env/fidelity.py), on one rank
            if (GENERATION_FIELDS & set(env_overrides)
                    and self.is_main_process):
                check_sampling_fidelity(
                    env_params,
                    context=f"Trainer(model_type={model_type!r}, "
                            f"env_overrides=...)")
            # re-derive the geometry-coupled model fields so that env
            # overrides cannot desync the model's heads from the env (the
            # reference rebuilds the model from env_config on every run,
            # utils.py:262-314)
            geom = model_config_for(env_params, model_type)
            model_cfg = dataclasses.replace(
                model_cfg, **{f: getattr(geom, f) for f in _GEOMETRY_FIELDS})
        if model_overrides:
            model_cfg = dataclasses.replace(model_cfg, **model_overrides)
        self.env_params = env_params
        self.model_cfg = model_cfg
        self.raw_config = raw
        self.policy = Policy(env_params, model_cfg, self.device)
        self.ppo_config = ppo_config or PPOConfig()
        self.learner = PPOLearner(env_params, self.policy, self.ppo_config)
        if mesh is not None:
            # the learner behind parallel.mesh.shard_learner(learner, mesh),
            # whose (place, train_step) are its methods
            self.learner = self.learner.shard(mesh)

        self.run_dir = os.path.join(results_root, "PPO",
                                    run_name or _run_name(model_type))
        os.makedirs(self.run_dir, exist_ok=True)
        self.checkpoint_dir = os.path.join(self.run_dir, "checkpoints")
        self.ckpt = CheckpointManager(self.checkpoint_dir,
                                      max_to_keep=keep_checkpoints,
                                      save_interval=checkpoint_freq,
                                      mesh=mesh)
        self.logger = (MetricsLogger(self.run_dir,
                                     use_tensorboard=use_tensorboard)
                       if self.is_main_process else NullMetricsLogger())
        self._profiler = None
        if profile_dir and self.is_main_process:
            from placement_tpu_torch.utils.profiling import trace_iterations
            self._profiler = trace_iterations(profile_dir)
        if self.is_main_process:
            self._write_params()

    # -- persistence ---------------------------------------------------------

    def _write_params(self) -> None:
        """params.json: the full run config, in the JAX trainer's layout."""
        payload = {
            "model_type": self.model_type,
            "ppo": dataclasses.asdict(self.ppo_config),
            "env_config": {**{f.name: getattr(self.env_params, f.name)
                              for f in dataclasses.fields(self.env_params)},
                           "variant": int(self.env_params.variant)},
            "model_config": dataclasses.asdict(self.model_cfg),
            "raw_config": self.raw_config,
        }
        with open(os.path.join(self.run_dir, "params.json"), "w") as f:
            json.dump(payload, f, indent=2, default=str)

    # -- lifecycle -------------------------------------------------------------

    def init_state(self, seed: int = 0,
                   flax_variables: Optional[Mapping] = None) -> TrainState:
        """A fresh state from a generator on the device seeded ``seed``;
        the weights carried from the JAX package's Flax variables (numpy
        leaves) when given. Over a mesh: this rank's rows of it."""
        gen = torch.Generator(self.device).manual_seed(seed)
        return self.learner.place(self.learner.init(gen, flax_variables))

    def restore(self, run_dir: Optional[str] = None,
                step: Optional[int] = None, seed: int = 0) -> TrainState:
        """Restore the newest checkpoint of ``run_dir`` (default: this run's
        directory) into a freshly initialised state."""
        ckpt = self.ckpt if run_dir is None else CheckpointManager(
            os.path.join(run_dir, "checkpoints"), mesh=self.mesh)
        return ckpt.restore(self.init_state(seed), step=step)

    def run(self, num_iterations: int = 1, seed: int = 0,
            state: Optional[TrainState] = None,
            on_iteration: Optional[Callable[[int, Dict[str, float]], None]]
            = None) -> TrainResult:
        """Train ``num_iterations`` iterations (reference default:
        ``stop={"training_iteration": 1}``, experiments/PPO/PPO.py:42);
        iteration numbers continue from ``state.steps``."""
        if state is None:
            state = self.init_state(seed)
        start = state.steps // max(self.ppo_config.train_batch, 1)
        row: Dict[str, float] = {}
        wrap_windows = 0       # consecutive windows with pool exhaustion
        wrapped_boards = 0     # cumulative boards that replayed an instance
        for it in range(start + 1, start + num_iterations + 1):
            if self._profiler is not None:
                self._profiler.maybe_start(it - start)
            state, metrics = self.learner.train_step(state)
            row = self.logger.log(it, state.steps, metrics)
            wraps = int(row.get("pool_wraps", 0))
            if wraps > 0:
                # escalate sustained exhaustion: warn on the 1st and every
                # 10th consecutive window, at ERROR once it has lasted 10
                wrap_windows += 1
                wrapped_boards += wraps
                if wrap_windows == 1 or wrap_windows % 10 == 0:
                    level = (logging.ERROR if wrap_windows >= 10
                             else logging.WARNING)
                    log.log(
                        level,
                        "iteration %d: %d board(s) exhausted the reset pool "
                        "and replayed an instance this window (%d boards "
                        "over %d consecutive windows) — sampling is biased; "
                        "raise PPOConfig.reset_pool_size (episodes are "
                        "ending faster than the derived pool assumed)",
                        it, wraps, wrapped_boards, wrap_windows)
            else:
                wrap_windows = 0
            if self._profiler is not None:
                self._profiler.maybe_stop(it - start)
            self.ckpt.save(it, state)
            if on_iteration is not None:
                on_iteration(it, row)
        # checkpoint_at_end=True parity (skip if the loop already saved it)
        if self.ckpt.latest_step() != start + num_iterations:
            self.ckpt.save(start + num_iterations, state, force=True)
        self.ckpt.wait()
        return TrainResult(run_dir=self.run_dir,
                           checkpoint_dir=self.checkpoint_dir,
                           final_metrics=row, state=state)

    def close(self) -> None:
        if self._profiler is not None:
            self._profiler.close()
        self.logger.close()
        self.ckpt.close()


def latest_run_dir(model_type: str,
                   results_root: str = DEFAULT_RESULTS_ROOT) -> str:
    """Newest run dir for a model type — generate_rollouts' lookup
    (utils/agent/utils.py:165-178)."""
    return find_latest_run(os.path.join(results_root, "PPO"),
                           prefix=f"PPO_{model_type}")
