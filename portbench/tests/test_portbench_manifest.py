"""``BENCHMARK.json`` keeps to the benchmark's contract, every name it holds
resolves to its files, and a configuration, a traffic mix, a cell and a
metric can be added as new files and a manifest entry alone."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from portbench import manifest

ROOT = manifest.HERE.parent
BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def _text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_text_ok(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries_keep_their_keys_names_and_text(kind):
    entries = BENCH[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        required = KEYS[kind] - {"workloads"}
        assert required <= set(e) <= KEYS[kind], e["name"]
        assert NAME.match(e["name"])
        for k in TEXT_KEYS:
            if k in e:
                assert _text_ok(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                            "higher")


def test_metric_names_are_unique_across_kinds_and_sources_fit():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert {m["source"] for m in e2e} <= {"host_clock", "device_trace"}
    assert {m["source"] for m in per} <= {"device_trace", "program_span",
                                          "program_counter", "host_clock"}
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in e2e}
    for m in per:
        assert m["moves"] in moves
        assert "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves_its_files_and_reports_enough():
    workloads = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert c["source"].startswith("https://")
        assert manifest.config(c["name"])["source"] == c["source"]
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        traffic = manifest.traffic(w["traffic"])
        engine = manifest.engine(traffic["engine"])
        assert hasattr(engine, "Engine")
        cell = manifest.cell(w["name"])
        assert cell["compared_chunks"] >= 1 and cell["limits"]
        e2e = manifest.metrics(BENCH, w["name"], "end_to_end")
        per = manifest.metrics(BENCH, w["name"], "per_layer")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per
        for m in e2e + per:
            assert callable(manifest.reader(m["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", workloads)) <= workloads


def _copy_bench(tmp_path):
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    return tmp_path


def _env(*paths):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(str(p) for p in paths)
    return env


def test_a_cell_config_mix_and_metric_are_added_as_files(tmp_path):
    """A new configuration (the flagship with 2..6 pins a net), a new mix
    (the centroid reward at block 128), their cell and a new end-to-end
    metric, as new files and manifest entries: the copy runs the new cell
    on the CPU and reports the new metric, and no file it had changed."""
    root = _copy_bench(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    config = manifest.config("rectangle_pin")
    config["env_config"].update(min_num_pins_per_net=2,
                                max_num_pins_per_net=6)
    (root / "portbench/configs/varpin.json").write_text(json.dumps(config))
    mix = manifest.traffic("fused_centroid")
    mix["block"] = 128
    (root / "portbench/traffic/centroid128.json").write_text(
        json.dumps(mix))
    cell = manifest.cell("rectangle_pin.centroid")
    (root / "portbench/cells/varpin.centroid128.json").write_text(
        json.dumps(cell))
    (root / "portbench/metrics/chunks_per_s.py").write_text(
        "def read(record):\n"
        "    w = record.get('window')\n"
        "    return w and w['chunks'] / w['seconds']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "varpin", "source": config["source"],
                             "file": "portbench/configs/varpin.json",
                             "reduced": [], "why": "varying pins a net"})
    bench["workloads"].append({"name": "varpin.centroid128",
                               "config": "varpin",
                               "traffic": "centroid128", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "chunks_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["varpin.centroid128"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time\n"
            "from portbench import manifest, run\n"
            "r = run.run_cell(manifest.load(), 'varpin.centroid128', 3,"
            " 0.2, False, 'cpu', time.perf_counter(), boards=8,"
            " warm_chunks=1)\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=_env(root, ROOT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s",
                                      "chunks_per_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "rectangle_pin.centroid", "--seed", str(2**31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, env=_env(ROOT),
        capture_output=True, text=True, timeout=300)
    if "available: True" in out.stderr:
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with ``BENCHMARK.json`` and ``portbench/`` alone (no
    program) exits non-zero and prints no result."""
    root = _copy_bench(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "rectangle_pin.centroid", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=root, env=_env(root), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
