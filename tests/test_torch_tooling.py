"""The port's random-policy runners and profilers on the CPU
(``placement_tpu_torch.experiments.random_policy``,
``placement_tpu_torch.tools.{train_profile,pooled_profile,
price_exact_sampling}``).

* ``--help`` of each through ``python -m`` (as
  ``tests/tooling/test_cli_help.py`` does for the JAX scripts);
* each runs at its defaults only on a card: here it raises;
* each runner at ``--device cpu`` with few episodes, its plot written
  under ``--out-dir``;
* each profiler at ``--device cpu`` at a tiny size: its JSON holds every
  key of the JAX tool's committed artifact
  (``experiments/results/{train_step_profile,pooled_profile_web_max,
  exact_sampling_price}.json``), and its ``reduced`` list names the cuts;
* the square runner's mean return at 1024 episodes within 4 combined
  standard errors of JAX ``simulate``'s (``tests/fixtures/
  torch_stepper_means.json``).
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from placement_tpu_torch.experiments.random_policy import (
    run_policy_rectangular, run_policy_rectangular_pin, run_policy_square)
from placement_tpu_torch.tools import (
    pooled_profile, price_exact_sampling, train_profile)

REPO = pathlib.Path(__file__).resolve().parents[1]
RESULTS = REPO / "experiments" / "results"
FIXTURE = REPO / "tests" / "fixtures" / "torch_stepper_means.json"
RUNNERS = {
    "run_policy_square": (run_policy_square, []),
    "run_policy_rectangular": (run_policy_rectangular, []),
    # a 6x6 board: 38 steps a simulate, not 102
    "run_policy_rectangular_pin": (run_policy_rectangular_pin, [
        "--height", "6", "--width", "6", "--min_num_components", "3",
        "--max_num_components", "3", "--spatial"]),
}
TOOLS = {
    "train_profile": (train_profile, "train_step_profile.json", [
        "--num-envs", "4", "--unroll-length", "4", "--components"]),
    "pooled_profile": (pooled_profile, "pooled_profile_web_max.json", [
        "--batch", "4", "--inner", "2", "--pool", "2", "--slice-size",
        "2"]),
    "price_exact_sampling": (price_exact_sampling,
                             "exact_sampling_price.json", ["--batch", "4"]),
}
CLIS = ([f"placement_tpu_torch.experiments.random_policy.{n}"
         for n in RUNNERS] + [f"placement_tpu_torch.tools.{n}"
                              for n in TOOLS])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("module", CLIS, ids=lambda m: m.split(".")[-1])
def test_cli_help_exits_zero(module):
    r = subprocess.run([sys.executable, "-m", module, "--help"],
                       capture_output=True, timeout=120, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-2000:]
    assert b"usage" in r.stdout.lower() and b"--device" in r.stdout


@pytest.mark.parametrize("name", list(RUNNERS) + list(TOOLS))
def test_defaults_need_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    module = (RUNNERS.get(name) or TOOLS[name])[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


@pytest.mark.parametrize("name", list(RUNNERS))
def test_runner_on_the_cpu_writes_its_plot(name, tmp_path, capsys):
    module, extra = RUNNERS[name]
    args = module.parser().parse_args(
        extra + ["--n_episodes", "24", "--device", "cpu", "--out-dir",
                 str(tmp_path)])
    returns = module.run(args)
    assert returns.shape == (24,) and bool(torch.isfinite(returns).all())
    module.main(extra + ["--n_episodes", "24", "--device", "cpu",
                         "--out-dir", str(tmp_path)])
    pngs = list(tmp_path.glob("*_random_policy_episode_returns.png"))
    assert len(pngs) == 1
    assert "mean return" in capsys.readouterr().out


def _key_paths(tree, prefix=()):
    for k, v in tree.items():
        yield prefix + (k,)
        if isinstance(v, dict):
            yield from _key_paths(v, prefix + (k,))


@pytest.mark.parametrize("name", list(TOOLS))
def test_profiler_json_has_the_jax_artifact_keys(name, tmp_path):
    module, artifact, argv = TOOLS[name]
    out = tmp_path / "out.json"
    result = module.main(argv + ["--device", "cpu", "--budget-s", "0.01",
                                 "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    want = json.loads((RESULTS / artifact).read_text())
    have = set(_key_paths(result))
    missing = [p for p in _key_paths(want) if p not in have]
    assert not missing, missing
    assert result["device"] == "cpu" and result["reduced"]
    for path in _key_paths(result):
        node = result
        for k in path:
            node = node[k]
        if isinstance(node, float):
            assert math.isfinite(node), path


def test_square_runner_mean_within_four_se_of_jax():
    want = json.loads(FIXTURE.read_text())["square"]
    args = run_policy_square.parser().parse_args(
        ["--n_episodes", str(want["episodes"]), "--device", "cpu"])
    r = run_policy_square.run(args).double()
    mean, se = float(r.mean()), float(r.std() / math.sqrt(len(r)))
    assert abs(mean - want["mean"]) <= 4 * math.hypot(se, want["se"]), \
        (mean, se, want)
