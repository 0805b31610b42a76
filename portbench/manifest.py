"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own: ``configs/<config>.json``,
``traffic/<traffic>.json``; the cell's correctness limits in
``cells/<workload>.json``; the engine a traffic mix names in
``engines/<engine>.py``; each metric's reader in ``metrics/<metric>.py``.
Adding a configuration, a mix, a cell or a metric adds files and a
manifest entry, and edits no file here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Any, Callable, Dict, List

HERE = pathlib.Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"


def _json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load() -> Dict[str, Any]:
    return _json(MANIFEST)


def workload(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {MANIFEST.name}")


def config(name: str) -> Dict[str, Any]:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> Dict[str, Any]:
    return _json(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> Dict[str, Any]:
    return _json(HERE / "cells" / f"{name}.json")


def engine(name: str):
    return importlib.import_module(f"portbench.engines.{name}")


def reader(metric: str) -> Callable[[Dict[str, Any]], Any]:
    """``metrics/<metric>.py``'s ``read(record) -> number or None``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics(manifest: Dict[str, Any], workload_name: str,
            kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload_name``
    reports: those without a ``workloads`` list, and those whose list
    names it."""
    return [m for m in manifest[kind]
            if workload_name in m.get("workloads", [workload_name])]
