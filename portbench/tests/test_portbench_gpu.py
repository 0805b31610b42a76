"""The benchmark on the card: one short run of the main path's cell, timed
and traced, each correct and with its metrics. Skips without a card.

    python -m pytest portbench/tests/test_portbench_gpu.py -q
"""

import json
import subprocess
import sys

import pytest

from portbench import manifest

ROOT = manifest.HERE.parent


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_main_path_cell_runs_correct_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "rectangle_pin.centroid", "--seed", str(2**33 + trace),
         "--seconds", "2", "--trace", str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in manifest.metrics(
        manifest.load(), "rectangle_pin.centroid", kind)}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu"
