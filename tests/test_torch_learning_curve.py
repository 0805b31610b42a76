"""The port's learning-curve runners on the CPU
(``placement_tpu_torch.experiments.{learning_curve,seed_sweep,
reference_comparison}``, ``placement_tpu_torch.tools.plot_learning_curve``).

* the sweep tables' reader and writers and ``summarize`` equal the JAX
  package's functions (its modules loaded from their files, as
  ``tests/agent/test_learning_artifact.py`` loads ``learning_curve.py``)
  on the committed ``experiments/results/`` sweeps;
* every plot function renders a PNG from synthetic rows;
* ``--help`` of each runner and of the plot tool through ``python -m``;
  each runner at its default device raises without a card;
* each runner for 2 iterations at ``--device cpu`` on a tiny batch writes
  the JAX runner's columns and prints its JSON keys; ``learning_curve``
  on every preset the card trains, a factorized run cut and restored,
  ``seed_sweep`` on a non-spatial preset;
* ``tools/learning_runs`` runs two of them at once, each in its process;
* none of these modules imports JAX, the JAX package or the top-level
  ``experiments/``.
"""

import csv
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from placement_tpu_torch.experiments import (
    learning_curve, plot_style, reference_comparison, seed_sweep)
from placement_tpu_torch.models import MODEL_REGISTRY
from placement_tpu_torch.tools import learning_runs, plot_learning_curve

REPO = pathlib.Path(__file__).resolve().parents[1]
RESULTS = REPO / "experiments" / "results"
WEIGHT_SWEEP = RESULTS / "rectangle_spatial_pin_weight_sweep.csv"
SEED_SWEEPS = ("rectangle_spatial_pin_seed_sweep.csv",
               "rectangle_spatial_pin_seed_sweep_sgd10.csv")
MODULES = {
    "learning_curve": learning_curve,
    "seed_sweep": seed_sweep,
    "reference_comparison": reference_comparison,
}
CLIS = ([f"placement_tpu_torch.experiments.{n}" for n in MODULES]
        + ["placement_tpu_torch.tools.plot_learning_curve",
           "placement_tpu_torch.tools.learning_runs"])
#: the presets whose curves the card trains one by one: every preset but
#: the spatial flagship, which (a) covers
PRESETS = [t for t in MODEL_REGISTRY if t != "rectangle_spatial_pin"]
#: a 2-iteration run on 8 boards x 8 steps, 2 baseline episodes
TINY = ["--iterations", "2", "--num-envs", "8", "--unroll-length", "8"]
#: the keys of the JSON line ``experiments/learning_curve.py`` prints
#: (``:119-125``)
CURVE_KEYS = {"type", "iterations", "random_baseline_reward",
              "final_reward_mean_last10", "improvement", "run_dir", "plot"}
#: those of ``experiments/seed_sweep.py``'s line (``:165-227``)
SWEEP_KEYS = {"type", "iterations", "random_baseline_reward",
              "final_reward_by_seed", "final_reward_by_weight"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_module(name):
    """The JAX package's ``experiments/<name>.py``, loaded from its file
    (its imports are the standard library and ``experiments/``)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_load_sweep_csv_matches_jax():
    jax_rc = _jax_module("reference_comparison")
    got = reference_comparison.load_sweep_csv(str(WEIGHT_SWEEP))
    assert got == jax_rc.load_sweep_csv(str(WEIGHT_SWEEP))
    assert sorted(got) == [0.0, 0.1, 0.5, 0.9]
    assert reference_comparison.load_sweep_csv(str(RESULTS / "none")) == {}


def test_summarize_matches_jax():
    """On the committed sweep, the port's summary is JAX's, and JAX's is
    the committed comparison JSON."""
    jax_rc = _jax_module("reference_comparison")
    per = jax_rc.load_sweep_csv(str(WEIGHT_SWEEP))
    got = reference_comparison.summarize(per, "rectangle_spatial_pin", 150)
    assert got == jax_rc.summarize(per, "rectangle_spatial_pin", 150)
    committed = json.loads(
        (RESULTS / "weight_sweep_reference_comparison.json").read_text())
    assert json.loads(json.dumps(got)) == committed


def test_write_sweep_csv_matches_jax(tmp_path):
    jax_rc = _jax_module("reference_comparison")
    per = jax_rc.load_sweep_csv(str(WEIGHT_SWEEP))
    per[0.5][3]["num_intersections_mean"] = None     # an empty cell
    reference_comparison._write_sweep_csv(str(tmp_path / "port.csv"), per)
    jax_rc._write_sweep_csv(str(tmp_path / "jax.csv"), per)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    assert reference_comparison.load_sweep_csv(
        str(tmp_path / "port.csv")) == per


@pytest.mark.parametrize("name", SEED_SWEEPS)
def test_write_csv_matches_jax(tmp_path, name):
    """The seed sweep's writer on a committed sweep's rows, with a row
    missing a column, writes JAX's bytes (and the committed file's
    columns)."""
    jax_ss = _jax_module("seed_sweep")
    with open(RESULTS / name, newline="") as f:
        rows = list(csv.DictReader(f))
    del rows[1]["num_intersections_mean"]
    seed_sweep._write_csv(str(tmp_path / "port.csv"), rows, ["seed"])
    jax_ss._write_csv(str(tmp_path / "jax.csv"), rows, ["seed"])
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    assert _header(tmp_path / "port.csv") == _header(RESULTS / name)


def test_slim_keeps_the_sweep_columns():
    rows = [{"training_iteration": 3.0, "episode_reward_mean": -1.5,
             "custom_metrics/normalized_wirelengths_mean": 2.0,
             "custom_metrics/num_intersections_mean": 0.5, "kl": 0.1}]
    assert seed_sweep.slim(rows, seed=4) == [{
        "seed": 4, "training_iteration": 3, "episode_reward_mean": -1.5,
        "normalized_wirelengths_mean": 2.0, "num_intersections_mean": 0.5}]


def test_plot_style_is_jax_s():
    jax_style = _jax_module("plot_style")
    for name in ("C_SERIES", "C_BASELINE", "C_TEXT", "C_MUTED", "C_SURFACE",
                 "C_GRID"):
        assert getattr(plot_style, name) == getattr(jax_style, name), name


def _rows(n=30, **tags):
    return [{**tags, "training_iteration": i,
             "episode_reward_mean": -2.0 + i * 0.01 * (1 + len(tags)),
             "normalized_wirelengths_mean": 2.5 - i * 0.01,
             "num_intersections_mean": 0.7,
             "custom_metrics/normalized_wirelengths_mean": 2.5 - i * 0.01,
             "custom_metrics/num_intersections_mean": 0.7}
            for i in range(1, n + 1)]


def _reference_png(path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(4, 3))
    ax.plot([0, 1], [0, 1])
    fig.savefig(path, dpi=72)
    plt.close(fig)
    return str(path)


PLOTS = {
    "plot_curves": lambda out, tmp: learning_curve.plot_curves(
        _rows(), -2.13, out, "synthetic"),
    "plot_seed_band": lambda out, tmp: seed_sweep.plot_seed_band(
        {s: _rows(seed=s) for s in range(3)}, -2.13, out, "synthetic"),
    "plot_weight_sweep": lambda out, tmp: seed_sweep.plot_weight_sweep(
        {w: _rows(weight=w) for w in (0.1, 0.5)}, out, "synthetic"),
    "plot_comparison": lambda out, tmp: reference_comparison.plot_comparison(
        {w: _rows(weight=w) for w in (0.0, 0.9)}, out, "synthetic"),
    "plot_comparison_with_reference":
        lambda out, tmp: reference_comparison.plot_comparison(
            {w: _rows(weight=w) for w in (0.0, 0.9)}, out, "synthetic",
            _reference_png(tmp / "reference.png")),
}


@pytest.mark.parametrize("name", PLOTS)
def test_plot_renders(tmp_path, name):
    out = tmp_path / "plot.png"
    PLOTS[name](str(out), tmp_path)
    assert out.stat().st_size > 10_000


def test_plot_tool_renders_a_progress_table(tmp_path):
    run = tmp_path / "PPO_synthetic"
    run.mkdir()
    rows = _rows()
    cols = ["training_iteration", "episode_reward_mean",
            "custom_metrics/normalized_wirelengths_mean",
            "custom_metrics/num_intersections_mean"]
    with open(run / "progress.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
        wr.writeheader()
        wr.writerows(rows)
    out = tmp_path / "out" / "curve.png"
    assert plot_learning_curve.main([str(run), str(out)]) == str(out)
    assert out.stat().st_size > 10_000


@pytest.mark.parametrize("module", CLIS, ids=lambda m: m.split(".")[-1])
def test_cli_help_exits_zero(module):
    r = subprocess.run([sys.executable, "-m", module, "--help"],
                       capture_output=True, timeout=120, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-2000:]
    assert b"usage" in r.stdout.lower()
    if "experiments" in module:
        assert b"--device" in r.stdout and b"--out-dir" in r.stdout


@pytest.mark.parametrize("name", MODULES)
def test_default_device_needs_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MODULES[name].main(TINY + ["--out-dir", str(tmp_path),
                                   "--results-root", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def _cpu(tmp_path):
    return ["--device", "cpu", "--out-dir", str(tmp_path / "out"),
            "--results-root", str(tmp_path / "runs")]


def test_learning_curve_cpu_run(tmp_path, capsys):
    summary = learning_curve.main(
        TINY + _cpu(tmp_path) + ["--baseline-episodes", "2", "--tag", "_t"])
    assert _last_json(capsys.readouterr().out) == summary
    assert set(summary) == CURVE_KEYS
    assert summary["iterations"] == 2
    out = tmp_path / "out"
    progress = out / "rectangle_spatial_pin_t_progress.csv"
    assert set(_header(progress)) == set(
        _header(RESULTS / "rectangle_spatial_pin_progress.csv"))
    with open(progress, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(float(r["training_iteration"])) for r in rows] == [1, 2]
    final = sum(float(r["episode_reward_mean"]) for r in rows) / 2
    assert summary["final_reward_mean_last10"] == round(final, 4)
    assert summary["run_dir"].startswith(str(tmp_path / "runs"))
    assert progress.read_bytes() == (
        pathlib.Path(summary["run_dir"]) / "progress.csv").read_bytes()
    assert (out / "rectangle_spatial_pin_t_learning_curve.png"
            ).stat().st_size > 10_000
    # --restore goes on from the run's checkpoint to 3 iterations in all;
    # the table keeps the first run's rows
    first = progress.read_text().splitlines()
    again = learning_curve.main(
        ["--iterations", "3", "--num-envs", "8", "--unroll-length", "8"]
        + _cpu(tmp_path) + ["--baseline-episodes", "2", "--tag", "_t",
                            "--restore", summary["run_dir"]])
    lines = progress.read_text().splitlines()
    assert lines[:3] == first and len(lines) == 4
    assert int(lines[3].split(",")[0]) == 3
    assert again["run_dir"] != summary["run_dir"]


def _progress_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("model_type", PRESETS)
def test_learning_curve_cpu_run_of_every_preset(model_type, tmp_path):
    """Each preset trains 2 iterations: its table has the JAX trainer's
    columns, in order, as JAX's committed run of the preset has them, and
    finite rewards."""
    summary = learning_curve.main(
        TINY + _cpu(tmp_path) + ["--type", model_type,
                                 "--baseline-episodes", "2", "--tag", "_t"])
    assert summary["type"] == model_type
    progress = tmp_path / "out" / f"{model_type}_t_progress.csv"
    assert _header(progress) == _header(
        RESULTS / f"{model_type}_progress.csv")
    rewards = [float(r["episode_reward_mean"])
               for r in _progress_rows(progress)]
    assert len(rewards) == 2 and all(map(math.isfinite, rewards)), rewards


def test_learning_curve_restores_a_cut_factorized_run(tmp_path):
    """A factorized preset's run cut after 1 iteration goes on with
    ``--restore`` to 2: the table holds both rows."""
    args = ["--num-envs", "8", "--unroll-length", "8", "--type",
            "rectangle_factorized", "--baseline-episodes", "2", "--tag",
            "_t"] + _cpu(tmp_path)
    cut = learning_curve.main(["--iterations", "1"] + args)
    learning_curve.main(["--iterations", "2", "--restore", cut["run_dir"]]
                        + args)
    rows = _progress_rows(tmp_path / "out"
                          / "rectangle_factorized_t_progress.csv")
    assert [int(float(r["training_iteration"])) for r in rows] == [1, 2]


def test_seed_sweep_cpu_run_of_a_preset(tmp_path):
    """``seed_sweep --skip-weights`` on a non-spatial preset: the seed
    table has JAX's columns, one finite row an iteration."""
    summary = seed_sweep.main(
        TINY + _cpu(tmp_path) + ["--type", "rectangle_factorized",
                                 "--seeds", "0", "--skip-weights",
                                 "--num-sgd-iter", "2",
                                 "--baseline-episodes", "2", "--tag", "_t"])
    assert summary["type"] == "rectangle_factorized"
    path = tmp_path / "out" / "rectangle_factorized_seed_sweep_t.csv"
    assert _header(path) == _header(RESULTS / SEED_SWEEPS[0])
    rewards = [float(r["episode_reward_mean"]) for r in _progress_rows(path)]
    assert len(rewards) == 2 and all(map(math.isfinite, rewards)), rewards


def test_learning_runs_share_a_device(tmp_path):
    """Two runs at once on one device, each in its own process: both end,
    each summary is its runner's JSON line with the layout beside it."""
    out = learning_runs.main(
        ["--types", "square", "rectangle_factorized_pin", "--per-card",
         "2", "--tag", "_t"] + _cpu(tmp_path)
        + ["--"] + TINY + ["--baseline-episodes", "2"])
    assert [r["type"] for r in sorted(out["runs"], key=lambda r: r["type"])
            ] == ["rectangle_factorized_pin", "square"]
    for run in out["runs"]:
        assert run["rc"] == 0 and not run["cut"], run
        assert run["runs_at_once"] == 2 and run["card"] == "cpu"
        summary = json.loads((tmp_path / "out" / f"{run['type']}_t_summary"
                              ".json").read_text())
        assert CURVE_KEYS <= set(summary) and summary["type"] == run["type"]
        assert summary["s_per_iteration"] > 0
    # the figures again from the tables alone, as for a card's run
    pngs = sorted((tmp_path / "out").glob("*.png"))
    assert len(pngs) == 2
    for png in pngs:
        png.unlink()
    drawn = learning_runs.main(
        ["--plot-only", "--types", "square", "rectangle_factorized_pin",
         "--tag", "_t", "--out-dir", str(tmp_path / "out")])["plots"]
    assert sorted(map(pathlib.Path, drawn)) == pngs
    assert all(p.stat().st_size > 10_000 for p in pngs)


def test_learning_runs_stop_at_the_deadline_and_resume(tmp_path):
    """``--deadline-s`` stops a run (no summary); ``--resume`` restores a
    cut run from its newest checkpoint to the iterations asked, and skips
    a type whose summary exists."""
    tool = ["--types", "square", "--tag", "_t"] + _cpu(tmp_path)
    rest = ["--", "--num-envs", "8", "--unroll-length", "8",
            "--baseline-episodes", "2"]
    out = learning_runs.main(tool + ["--deadline-s", "0"] + rest
                             + ["--iterations", "2"])
    assert [r["cut"] for r in out["runs"]] == [True]
    summary = tmp_path / "out" / "square_t_summary.json"
    assert not summary.exists()
    # a run cut after its first iteration, where the tool keeps its runs
    learning_curve.main(["--type", "square", "--iterations", "1", "--tag",
                         "_t", "--device", "cpu", "--out-dir",
                         str(tmp_path / "cut"), "--results-root",
                         str(tmp_path / "runs" / "square_t")] + rest[1:])
    out = learning_runs.main(tool + ["--resume"] + rest
                             + ["--iterations", "2"])
    assert [(r["rc"], r["cut"]) for r in out["runs"]] == [(0, False)]
    rows = _progress_rows(tmp_path / "out" / "square_t_progress.csv")
    assert [int(float(r["training_iteration"])) for r in rows] == [1, 2]
    assert json.loads(summary.read_text())["iterations"] == 2
    assert learning_runs.main(tool + ["--resume"] + rest)["runs"] == []


def test_learning_runs_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        learning_runs.main(["--types", "square", "--out-dir",
                            str(tmp_path / "o"), "--results-root",
                            str(tmp_path / "r")])


def test_seed_sweep_cpu_run(tmp_path, capsys):
    summary = seed_sweep.main(
        TINY + _cpu(tmp_path) + ["--seeds", "0", "1", "--weights", "0.5",
                                 "--baseline-episodes", "2",
                                 "--num-sgd-iter", "2", "--tag", "_t"])
    assert _last_json(capsys.readouterr().out) == json.loads(
        json.dumps(summary))
    assert set(summary) == SWEEP_KEYS
    assert sorted(summary["final_reward_by_seed"]) == [0, 1]
    assert list(summary["final_reward_by_weight"]) == [0.5]
    out = tmp_path / "out"
    for name, committed, n in (
            ("seed_sweep", "rectangle_spatial_pin_seed_sweep.csv", 4),
            ("weight_sweep", "rectangle_spatial_pin_weight_sweep.csv", 2)):
        path = out / f"rectangle_spatial_pin_{name}_t.csv"
        assert _header(path) == _header(RESULTS / committed)
        with open(path, newline="") as f:
            assert len(list(csv.DictReader(f))) == n
    for name in ("seed_band", "weight_sweep"):
        assert (out / f"rectangle_spatial_pin_{name}_t.png"
                ).stat().st_size > 10_000


def test_seed_sweep_resumes(tmp_path, capsys):
    """With ``--resume`` a seed whose rows in the table cover the
    iterations is reused, the others trained, and the table holds both."""
    out = tmp_path / "out"
    out.mkdir()
    path = out / "rectangle_spatial_pin_seed_sweep_t.csv"
    kept = seed_sweep.slim(_rows(2), seed=0)
    seed_sweep._write_csv(str(path), kept, ["seed"])
    summary = seed_sweep.main(
        TINY + _cpu(tmp_path) + ["--seeds", "0", "1", "--skip-weights",
                                 "--baseline-episodes", "2", "--resume",
                                 "--num-sgd-iter", "2", "--tag", "_t"])
    assert f"seed 0: reusing 2 iterations of {path}" in \
        capsys.readouterr().out
    runs = seed_sweep.load_runs(str(path), "seed")
    assert sorted(runs) == [0.0, 1.0] and len(runs[1.0]) == 2
    assert [r["episode_reward_mean"] for r in runs[0.0]] == \
        [r["episode_reward_mean"] for r in kept]
    assert summary["final_reward_by_seed"][0] == seed_sweep._final(kept)


def test_reference_comparison_cpu_run(tmp_path, capsys):
    """Trains the weights missing from the sweep table in ``--out-dir``,
    reuses the others, and writes JAX's JSON keys."""
    out = tmp_path / "out"
    out.mkdir()
    jax_rc = _jax_module("reference_comparison")
    committed = jax_rc.load_sweep_csv(str(WEIGHT_SWEEP))
    reference_comparison._write_sweep_csv(
        str(out / "rectangle_spatial_pin_weight_sweep.csv"),
        {0.9: committed[0.9][:2]})
    summary = reference_comparison.main(
        TINY + _cpu(tmp_path) + ["--weights", "0", "0.9",
                                 "--num-sgd-iter", "2"])
    printed = capsys.readouterr().out
    assert "weight 0.9: reusing 2 committed iterations" in printed
    assert _last_json(printed) == summary
    want = json.loads(
        (RESULTS / "weight_sweep_reference_comparison.json").read_text())
    assert set(summary) == set(want)
    assert list(summary["final_reward_by_weight"]) == ["0.0", "0.9"]
    assert json.loads((out / "weight_sweep_reference_comparison.json"
                       ).read_text()) == summary
    per = reference_comparison.load_sweep_csv(
        str(out / "rectangle_spatial_pin_weight_sweep.csv"))
    assert per[0.9] == committed[0.9][:2] and len(per[0.0]) == 2
    assert _header(out / "rectangle_spatial_pin_weight_sweep.csv") == \
        _header(WEIGHT_SWEEP)
    assert (out / "weight_sweep_reference_comparison.png"
            ).stat().st_size > 10_000


def test_reference_comparison_without_matplotlib(tmp_path, capsys,
                                                 monkeypatch):
    """Where matplotlib is missing the runner reuses the committed weights,
    writes its JSON, says so and draws nothing."""
    out = tmp_path / "out"
    out.mkdir()
    jax_rc = _jax_module("reference_comparison")
    committed = jax_rc.load_sweep_csv(str(WEIGHT_SWEEP))
    reference_comparison._write_sweep_csv(
        str(out / "rectangle_spatial_pin_weight_sweep.csv"), committed)
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else find_spec(name, *a)))
    summary = reference_comparison.main(_cpu(tmp_path))
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert summary == jax_rc.summarize(committed, "rectangle_spatial_pin",
                                       150)
    assert sorted(p.name for p in out.iterdir()) == [
        "rectangle_spatial_pin_weight_sweep.csv",
        "weight_sweep_reference_comparison.json"]


def test_runners_import_no_jax():
    """In a fresh process the five modules import no JAX, no module of
    the JAX package and nothing of the top-level ``experiments/``."""
    mods = ([f"placement_tpu_torch.experiments.{n}"
             for n in (*MODULES, "plot_style")]
            + ["placement_tpu_torch.tools.plot_learning_curve",
               "placement_tpu_torch.tools.learning_runs"])
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'placement_tpu', 'experiments'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
