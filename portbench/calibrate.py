"""Read the two readings that a cell's correctness limits are set from.

    python -m portbench.calibrate --workload <name> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

On the card, in one process, at the cell's own size and load: each seed is
a whole run of ``portbench.run.run_cell``. For each of ``--seeds`` the
program's output is judged, as a benchmark run judges it: the largest
readings are the lower ones. For each of ``--control-seeds`` the control,
the plain reference in bfloat16 put in the program's place, is judged by
the same comparison and the same limits, so its ``correct`` must come out
false: its smallest readings are the upper ones. One JSON line a seed,
then the extremes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from portbench import manifest, run


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    bench = manifest.load()
    runs = [(s, None) for s in args.seeds] + [
        (s, torch.bfloat16) for s in args.control_seeds]
    readings = {"program": [], "control": []}
    for seed, control in runs:
        result = run.run_cell(bench, args.workload, seed, args.seconds,
                              False, "cuda", time.perf_counter(),
                              control=control)
        torch.cuda.empty_cache()
        side = "program" if control is None else "control"
        worst = {k: c["value"] for k, c in result["compared"].items()}
        readings[side].append(worst)
        print(json.dumps({"workload": args.workload, "side": side,
                          "seed": seed, "correct": result["correct"],
                          "failed": result["failed"],
                          "chunks": result["attempted"], **worst}),
              flush=True)
    summary = {"workload": args.workload, "card": run._power_limit()}
    for side, rows in readings.items():
        for k in rows[0] if rows else ():
            vals = [r[k] for r in rows]
            summary[f"{side}.{k}"] = [min(vals), max(vals)]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
