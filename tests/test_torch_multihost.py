"""The port's training CLI over several processes, on the CPU
(``python -m placement_tpu_torch.experiments.ppo``), as
``tests/parallel/test_multihost.py`` runs the JAX CLI: two processes that
meet at a ``tcp://`` coordinator, each one rank, against one run
directory; and one process that spawns its gloo ranks
(``--data-parallel --local-ranks 2``). Every rank prints its final
metrics; they agree, and rank 0 alone writes the run's files.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

from placement_tpu_torch.utils.metrics import read_progress

REPO = str(pathlib.Path(__file__).resolve().parents[1])
TINY = ["--type", "rectangle_pin", "--iterations", "1", "--num-envs", "4",
        "--unroll-length", "8", "--num-sgd-iter", "2", "--device", "cpu"]
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _cli(args):
    return subprocess.Popen(
        [sys.executable, "-m", "placement_tpu_torch.experiments.ppo", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=_env())


def _finish(procs):
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (
                f"process {i} rc={p.returncode}\n"
                f"{err.decode(errors='replace')[-4000:]}")
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _final_metrics(out):
    """{rank: metrics row} from the lines ``rank r: final metrics: {...}``."""
    rows = {}
    for line in out.splitlines():
        if "final metrics: " in line:
            tag, row = line.split("final metrics: ")
            rows[int(tag.split()[1].rstrip(":"))] = json.loads(row)
    return rows


def _same_metrics(rows):
    drop = "time_total_s"
    first = {k: v for k, v in rows[0].items() if k != drop}
    for row in rows.values():
        assert {k: v for k, v in row.items() if k != drop} == first
    assert first["episodes_this_iter"] > 0 and first["pool_wraps"] == 0


def _one_writer(run_dir):
    assert list(read_progress(str(run_dir))["training_iteration"]) == [1]
    assert (run_dir / "params.json").exists()
    assert (run_dir / "checkpoints" / "checkpoint_1").exists()


def test_two_process_training_cli(tmp_path):
    """``--num-processes 2 --process-id i --coordinator 127.0.0.1:<port>
    --run-name r``: two processes, one rank each, one tiny iteration."""
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = _finish([_cli(TINY + [
        "--coordinator", coordinator, "--num-processes", "2",
        "--process-id", str(i), "--run-name", "multihost",
        "--results-root", str(tmp_path)]) for i in range(2)])
    rows = {**_final_metrics(outs[0]), **_final_metrics(outs[1])}
    assert sorted(rows) == [0, 1]
    _same_metrics(rows)
    assert "rollouts exported" in outs[0] and "rollouts exported" not in outs[1]
    assert "iter 1:" in outs[0] and "iter 1:" not in outs[1]
    run_dir = tmp_path / "PPO" / "multihost"
    _one_writer(run_dir)
    assert (run_dir / "components.pkl").exists()


def test_data_parallel_cli_spawns_local_ranks(tmp_path):
    """``--data-parallel --local-ranks 2 --device cpu``: one process, two
    spawned gloo ranks; without --local-ranks on the CPU it refuses."""
    outs = _finish([_cli(TINY + [
        "--data-parallel", "--local-ranks", "2", "--no-rollouts",
        "--run-name", "dp", "--results-root", str(tmp_path)])])
    rows = _final_metrics(outs[0])
    assert sorted(rows) == [0, 1]
    _same_metrics(rows)
    _one_writer(tmp_path / "PPO" / "dp")
    bad = subprocess.run(
        [sys.executable, "-m", "placement_tpu_torch.experiments.ppo", *TINY,
         "--data-parallel"], capture_output=True, cwd=REPO, env=_env(),
        timeout=TIMEOUT)
    assert bad.returncode == 2 and b"--local-ranks" in bad.stderr
