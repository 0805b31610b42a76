"""No module that the benchmark loads is JAX's or the JAX package's,
compared by whole top-level name; the yardstick imports nothing of the
program."""

import ast
import json
import os
import subprocess
import sys

from portbench import manifest, run

ROOT = manifest.HERE.parent


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "placement_tpu_torch_like", sys)
    assert "placement_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "placement_tpu.ops", sys)
    assert "placement_tpu" in run.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    """A fresh process imports every module of the benchmark and every
    metric reader, runs a cell on the CPU and checks the loaded modules."""
    code = (
        "import json, sys, time, pkgutil, importlib, portbench\n"
        "from portbench import manifest, run\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "b = manifest.load()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    manifest.reader(m['name'])\n"
        "run.run_cell(b, 'rectangle_pin.centroid', 5, 0.2, False, 'cpu',"
        " time.perf_counter(), boards=8, warm_chunks=1)\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    loaded = set(json.loads(lines[-1]))
    assert not loaded & set(run.FORBIDDEN)
    assert "placement_tpu_torch" in loaded


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "workmodel.py"):
        got = set(_imports(manifest.HERE / name))
        assert got <= {"__future__", "dataclasses", "enum", "math",
                       "typing", "torch", "portbench"}, (name, got)
