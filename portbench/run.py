"""Run one cell of the benchmark of ``placement_tpu_torch`` and print its
result as one JSON line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for. ``--trace 0`` times the window and reports the cell's end-to-end
metrics; ``--trace 1`` profiles a window and reports its per-layer
metrics. Either way set-up's first chunk and the chunks kept from the
window are held to the plain reference (``portbench/reference.py``) once
the window has closed, and ``correct`` says whether every number compared
is within its limit (``portbench/cells/<workload>.json``). Without the cards, or with a
module of JAX or of the JAX package loaded, it exits non-zero and prints
no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

from portbench import manifest  # noqa: E402

#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "placement_tpu")
#: kernel caches the run may make, at a fixed path inside the checkout
CUDA_CACHE = manifest.HERE.parent / "build" / "portbench" / "cuda_cache"
#: Python's bytecode cache, at a fixed path inside the checkout: where the
#: environment forbids writing it beside the sources
#: (``PYTHONDONTWRITEBYTECODE``), every run would compile torch's modules
#: anew; so only a checkout's first run compiles them
PYCACHE = manifest.HERE.parent / "build" / "portbench" / "pycache"


def forbidden_modules() -> List[str]:
    """Forbidden top-level names among the loaded modules, compared whole
    (``placement_tpu_torch`` is not ``placement_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run_cell(bench: Dict[str, Any], name: str, seed: int, seconds: float,
             trace: bool, device: str, t0: float,
             boards: Optional[int] = None,
             warm_chunks: Optional[int] = None,
             control: Any = None) -> Dict[str, Any]:
    """One run of cell ``name``; returns the result line's object.
    ``boards`` and ``warm_chunks`` shrink a run for the CPU tests.
    ``control`` (a dtype) judges the plain reference in that precision,
    put in the program's place, instead of the program's output: the
    control that ``portbench.calibrate`` reads; a benchmark run never
    sets it."""
    import torch

    cell = manifest.workload(bench, name)
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.cell(name)
    engine_module = manifest.engine(traffic["engine"])
    extra = {} if warm_chunks is None else {"warm_chunks": warm_chunks}
    t_imports = time.perf_counter()
    engine = engine_module.Engine(manifest.config(cell["config"]), traffic,
                                  seed, device, boards, **extra)
    t_engine = time.perf_counter()
    keep = limits["compared_chunks"]
    engine.warm(keep)
    t_setup = time.perf_counter()
    record: Dict[str, Any] = {"setup_s": t_setup - t0}
    print(f"portbench: set-up {t_setup - t0!r} s: imports "
          f"{t_imports - t0!r}, engine {t_engine - t_imports!r}, warm-up "
          f"{t_setup - t_engine!r} (its first chunk {engine.first_chunk_s!r})",
          file=sys.stderr)
    if trace:
        record["trace"] = engine.trace(keep)
        attempted = record["trace"]["chunks"]
    else:
        record["window"] = engine.window(seconds, keep)
        attempted = record["window"]["chunks"]

    on_card = torch.device(device).type == "cuda"
    dev: Dict[str, Any] = {"platform": "gpu" if on_card else "cpu",
                           "kind": torch.cuda.get_device_name(0)
                           if on_card else "cpu",
                           "count": cell["chips"],
                           "memory_peak_bytes":
                           torch.cuda.max_memory_allocated()
                           if on_card else 0}
    if trace:
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
    if on_card:
        dev["card"] = _power_limit()

    engine.free()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checked = engine.check(against=control)
    print(f"portbench: check {time.perf_counter() - t_check!r} s, "
          f"{len(checked)} chunks", file=sys.stderr)
    bounds = limits["limits"]
    compared = {k: {"value": max(c[k] for c in checked) if checked else None,
                    "limit": limit} for k, limit in bounds.items()}
    failed = sum(1 for c in checked
                 if any(not c[k] <= limit for k, limit in bounds.items()))
    due = 1 + min(keep, attempted)
    correct = not failed and len(checked) == due

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics(bench, name, kind):
        value = manifest.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result: Dict[str, Any] = {
        "correct": correct, "attempted": attempted,
        "failed": failed, "metrics": metrics,
        "device": dev}
    if trace:
        result["breakdown"] = record["trace"]["breakdown"]
        result["trace_detail"] = {
            k: record["trace"][k] for k in (
                "program_launches", "launches", "unlinked",
                "enqueue_us", "bound")}
    result["compared"] = {**compared, "chunks_short": {
        "value": due - len(checked), "limit": 0}}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest.load()
    need = manifest.workload(bench, args.workload)["chips"]
    os.environ.setdefault("CUDA_CACHE_PATH", str(CUDA_CACHE))
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", _T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    shares = ", ".join(f"{k} {v['value']!r}" for k, v in
                       result["metrics"].items() if v["unit"] == "%")
    if shares:
        print(f"portbench: {shares} on {result['device']['card']}",
              file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"portbench: compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
