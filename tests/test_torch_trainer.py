"""The port's run management on the CPU: checkpoints
(``utils/checkpoint.py``), metrics (``utils/metrics.py``), profiling
(``utils/profiling.py``), the ``Trainer`` (``agent/trainer.py``),
``viz/rollout.py::generate_rollouts`` and the training CLI
(``python -m placement_tpu_torch.experiments.ppo``), against the JAX
package's where it writes the same files.

* ``progress.csv``'s header equals the JAX ``Trainer``'s on the same tiny
  config, and the rows carry JAX's ``custom_metrics/`` columns.
* A run of N + M iterations equals N iterations, a checkpoint, a restore
  into a fresh trainer and M more, bit for bit: weights, batch statistics,
  optimizer state, boards, generator and metrics.
* The exported pickles load with the JAX package's ``load_pickle``.
"""

import csv
import glob
import json
import logging
import os
import warnings

import numpy as np
import pytest
import torch

from placement_tpu.agent.ppo import PPOConfig as JaxPPOConfig
from placement_tpu.agent.trainer import Trainer as JaxTrainer
from placement_tpu.viz.rollout import load_pickle as jax_load_pickle
from placement_tpu_torch.agent.ppo import PPOConfig
from placement_tpu_torch.agent.trainer import Trainer, latest_run_dir
from placement_tpu_torch.env import fidelity
from placement_tpu_torch.env.types import STATE_FIELDS
from placement_tpu_torch.experiments import ppo as cli
from placement_tpu_torch.parallel.mesh import make_mesh
from placement_tpu_torch.utils import profiling
from placement_tpu_torch.utils.checkpoint import CheckpointManager
from placement_tpu_torch.utils.metrics import (
    MetricsLogger, NullMetricsLogger, read_progress)
from placement_tpu_torch.viz.rollout import generate_rollouts

TINY = dict(num_envs=4, unroll_length=4, minibatch_size=8, num_sgd_iter=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, so PyTorch's thread
    pool only adds overhead, and the cores stay with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(root, model_type="rectangle_pin", name="run", **kw):
    kw.setdefault("use_tensorboard", False)
    return Trainer(model_type, results_root=str(root),
                   ppo_config=PPOConfig(**TINY), run_name=name,
                   device="cpu", **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("results")
    trainer = _trainer(root, name="PPO_rectangle_pin_test",
                       use_tensorboard=True)
    result = trainer.run(num_iterations=2, seed=0)
    yield trainer, result, root
    trainer.close()


def test_run_dir_contents(run):
    trainer, result, root = run
    assert result.run_dir == os.path.join(str(root), "PPO",
                                          "PPO_rectangle_pin_test")
    assert latest_run_dir("rectangle_pin", str(root)) == result.run_dir
    for name in ("progress.csv", "params.json", "checkpoints"):
        assert os.path.exists(os.path.join(result.run_dir, name)), name
    assert glob.glob(os.path.join(result.run_dir, "events.out.tfevents*"))
    with open(os.path.join(result.run_dir, "params.json")) as f:
        payload = json.load(f)
    assert payload["model_type"] == "rectangle_pin"
    assert payload["ppo"]["num_envs"] == TINY["num_envs"]
    assert payload["env_config"]["height"] == trainer.env_params.height
    cols = read_progress(result.run_dir)
    assert list(cols["training_iteration"]) == [1, 2]
    assert cols["timesteps_total"][-1] == 2 * 16
    assert trainer.ckpt.all_steps() == [1, 2]
    assert result.state.steps == 2 * 16


def _header(run_dir):
    with open(os.path.join(run_dir, "progress.csv"), newline="") as f:
        return next(csv.reader(f))


def test_progress_csv_header_equals_jax_trainers(run, tmp_path):
    _, result, _ = run
    jt = JaxTrainer("rectangle_pin", results_root=str(tmp_path),
                    ppo_config=JaxPPOConfig(**TINY), use_tensorboard=False,
                    run_name="jax")
    try:
        jr = jt.run(num_iterations=1, seed=0)
    finally:
        jt.close()
    want = _header(jr.run_dir)
    assert _header(result.run_dir) == want
    assert "custom_metrics/normalized_wirelengths_mean" in want


def test_keeps_five_checkpoints(tmp_path):
    trainer = _trainer(tmp_path, "square", name="keep")
    try:
        trainer.run(num_iterations=7, seed=0)
        assert trainer.ckpt.all_steps() == [3, 4, 5, 6, 7]
        assert sorted(os.listdir(trainer.checkpoint_dir)) == [
            f"checkpoint_{i}" for i in (3, 4, 5, 6, 7)]
    finally:
        trainer.close()


def _state_tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": torch.as_tensor(v)
                    for k, v in s.items()})
    out.update({f"env/{f}": getattr(state.env_states, f)
                for f in STATE_FIELDS})
    out.update(kl_coeff=state.kl_coeff, gen=state.gen.get_state(),
               ret=state.ep_return_acc, len=state.ep_len_acc,
               steps=torch.tensor(state.steps))
    return out


def test_restore_continues_bit_for_bit(tmp_path):
    """2 + 2 iterations across a save and a restore into a new trainer
    equal 4 uninterrupted ones, bit for bit, and the iteration numbers
    continue."""
    straight = _trainer(tmp_path, name="straight")
    rows = []
    want = straight.run(num_iterations=4, seed=3,
                        on_iteration=lambda it, row: rows.append(row))
    want_state = _state_tensors(want.state)
    straight.close()

    first = _trainer(tmp_path, name="split")
    first.run(num_iterations=2, seed=3)
    first.close()
    second = _trainer(tmp_path, name="split")
    state = second.restore()
    assert state.steps == 2 * 16
    got_rows = []
    got = second.run(num_iterations=2, state=state,
                     on_iteration=lambda it, row: got_rows.append((it, row)))
    second.close()
    assert [it for it, _ in got_rows] == [3, 4]
    got_state = _state_tensors(got.state)
    assert set(got_state) == set(want_state)
    for k in want_state:
        assert torch.equal(got_state[k], want_state[k]), k
    for (_, g), w in zip(got_rows, rows[2:]):
        assert {k: v for k, v in g.items() if k != "time_total_s"} == {
            k: v for k, v in w.items() if k != "time_total_s"}


def test_checkpoint_manager_interval_and_missing(tmp_path, run):
    _, result, _ = run
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2,
                            save_interval=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(result.state)
    assert not mgr.save(1, result.state)
    assert mgr.save(1, result.state, force=True)
    assert mgr.save(2, result.state)
    assert mgr.latest_step() == 2 and mgr.all_steps() == [1, 2]
    assert not glob.glob(str(tmp_path / "ck" / "*" / "*.tmp"))


def test_metrics_logger_reads_tensors_and_prefixes_custom(tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        logger = MetricsLogger(str(tmp_path), use_tensorboard=False)
    assert "progress.csv only" in caplog.text
    metrics = {"kl": torch.tensor(0.25), "episodes_this_iter":
               torch.tensor(7, dtype=torch.int32),
               "normalized_wirelengths_mean": 1.5}
    row = logger.log(1, 16, metrics)
    logger.close()
    assert row["kl"] == 0.25 and row["episodes_this_iter"] == 7.0
    assert row["custom_metrics/normalized_wirelengths_mean"] == 1.5
    cols = read_progress(str(tmp_path))
    assert list(cols)[:3] == ["training_iteration", "timesteps_total",
                              "time_total_s"]
    null = NullMetricsLogger().log(1, 16, metrics)
    assert set(null) == set(row)


def test_profiler_writes_a_trace(tmp_path):
    window = profiling.trace_iterations(str(tmp_path / "ctx"), 1, 1)
    profiling.enable()
    try:
        window.maybe_start(1)
        with profiling.span("fused_rollout.per_board"):
            torch.ones(8).sum()
        window.maybe_stop(1)
    finally:
        profiling.disable()
        profiling.reset()
    (ctx,) = glob.glob(str(tmp_path / "ctx" / "trace_*.json"))
    with open(ctx) as f:
        assert "fused_rollout.per_board" in {
            e.get("name") for e in json.load(f)["traceEvents"]}
    prof = tmp_path / "iters"
    trainer = _trainer(tmp_path, "square", name="prof",
                       profile_dir=str(prof))
    try:
        trainer.run(num_iterations=3, seed=0)
    finally:
        trainer.close()
    traces = glob.glob(str(prof / "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_generate_rollouts_load_in_jax(run):
    trainer, result, _ = run
    run_dir = generate_rollouts(trainer, state=result.state)
    params, actions, comps = jax_load_pickle(run_dir)
    assert params["model_type"] == "rectangle_pin"
    assert len(actions) == len(comps) == 5
    assert all(type(v) is int for a in actions for step in a for v in step)
    assert all(type(c.h) is int and type(c.pins[0].net_id) is int
               for episode in comps for c in episode)
    assert os.path.exists(os.path.join(run_dir, "rectangle_pin.csv"))


def test_trainer_env_overrides_rederive_the_model(tmp_path, monkeypatch):
    """An override of generation fields re-derives the model's geometry
    and runs the ported sampling-fidelity check on the new parameters,
    which this faithful override passes without a warning."""
    checked = []

    def report(params, n_samples=512, seed=0):
        checked.append(params)
        return real(params, n_samples, seed)

    real = fidelity.deviation_report
    monkeypatch.setattr(fidelity, "deviation_report", report)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        trainer = _trainer(tmp_path, name="override",
                           env_overrides={"height": 8, "width": 8})
    trainer.close()
    assert trainer.model_cfg.height == 8 and trainer.model_cfg.width == 8
    assert [(p.height, p.width) for p in checked] == [(8, 8)]
    assert checked[0] == trainer.env_params


def test_trainer_refuses_a_mesh(tmp_path):
    """``Trainer(mesh=...)`` trains: a mesh of one process is the
    single-process trainer, bit for bit (the sharded worlds are
    tests/test_torch_mesh_learner.py's)."""
    plain = _trainer(tmp_path, name="plain")
    want = plain.run(num_iterations=1, seed=5).final_metrics
    plain.close()
    meshed = _trainer(tmp_path, name="meshed", mesh=make_mesh(1, "cpu"))
    assert meshed.is_main_process and meshed.learner.mesh.world == 1
    got = meshed.run(num_iterations=1, seed=5).final_metrics
    meshed.close()
    drop = {"time_total_s"}
    assert {k: v for k, v in got.items() if k not in drop} == {
        k: v for k, v in want.items() if k not in drop}


def test_cli_trains_two_iterations_on_the_cpu(tmp_path, capsys):
    cli.main(["--type", "rectangle_pin", "--iterations", "2",
              "--num-envs", "4", "--unroll-length", "4",
              "--num-sgd-iter", "2", "--device", "cpu",
              "--results-root", str(tmp_path), "--run-name", "cli"])
    out = capsys.readouterr().out
    assert "iter 2:" in out and "rollouts exported" in out
    run_dir = tmp_path / "PPO" / "cli"
    assert len(read_progress(str(run_dir))["training_iteration"]) == 2
    assert (run_dir / "components.pkl").exists()
    assert np.isfinite(read_progress(str(run_dir))["kl"]).all()
