"""The port's throughput matrix tool (``tools/bench_matrix.py``'s port).

On CPU tensors the tool runs the fused rollout's plain version, so every
fused row runs here at a small size (16 boards, 5-step chunks); the card runs
it at 4096 boards (``chip_smoke.py``). The configurations must be the JAX
tool's, field for field.
"""

import ast
import dataclasses
import functools
import json
import math
import pathlib

import pytest
import torch

from placement_tpu_torch.tools import bench_matrix

JAX_TOOL = (pathlib.Path(__file__).resolve().parents[1] / "tools"
            / "bench_matrix.py")


def _jax_matrix_tool():
    """``_configs``, ``FUSED_TUNING`` and ``POOLED_TUNING`` of
    ``tools/bench_matrix.py``, taken from its source alone: importing the
    tool would run its module-level set-up (``sys.path``, JAX's persistent
    compilation cache)."""
    wanted = [node for node in ast.parse(JAX_TOOL.read_text()).body
              if getattr(node, "name", None) == "_configs"
              or [getattr(t, "id", None) for t in getattr(node, "targets", ())]
              in (["FUSED_TUNING"], ["POOLED_TUNING"])]
    ns = {}
    exec(compile(ast.Module(wanted, []), str(JAX_TOOL), "exec"), ns)
    return ns["_configs"], ns["FUSED_TUNING"], ns["POOLED_TUNING"]


@pytest.fixture(scope="module")
def configs():
    return bench_matrix._configs()


def test_configs_match_the_jax_tool(configs):
    jax_configs, jax_tuning, jax_pooled = _jax_matrix_tool()
    want = jax_configs()
    assert list(configs) == list(want)
    for name, (params, anchor) in configs.items():
        jparams, janchor = want[name]
        assert anchor == janchor
        for f in dataclasses.fields(jparams):
            got, exp = getattr(params, f.name), getattr(jparams, f.name)
            if f.name == "variant":
                assert int(got) == int(exp), name
            else:
                assert got == exp, (name, f.name)
    assert set(bench_matrix.FUSED_ROWS) == set(want) - {"web_max_pooled"}
    # the JAX tuning's blocks are the logical PRNG blocks
    assert bench_matrix.FUSED_TUNING == {
        k: {"block": v["block"]} for k, v in jax_tuning.items()}
    assert bench_matrix.POOLED_TUNING == jax_pooled


@pytest.mark.parametrize("name", bench_matrix.FUSED_ROWS)
def test_fused_row_runs_on_cpu_tensors(name, configs, monkeypatch):
    monkeypatch.setattr(bench_matrix, "MAX_CALLS", 2)
    params, anchor = configs[name]
    row, leaves = bench_matrix.measure(name, params, anchor, 16, "cpu",
                                       inner=5)
    assert row["engine"] == "fused_plain" and row["device"] == "cpu"
    assert row["launches"] == 0            # CPU tensors: no kernel
    assert row["calls"] == 4               # warm-up, sizing, 2 timed
    assert row["batch"] == 16 and row["block"] == 16
    assert row["steps_per_sec"] > 0 and math.isfinite(row["steps_per_sec"])
    assert row["episodes"] > 0 and math.isfinite(row["reward_sum"])
    if params.has_pins:
        # flagship episodes are exactly 5 placements: 2 timed chunks of 5
        # steps end 2 episodes per board
        assert row["episodes"] == 32
        assert -3.0 < row["mean_episode_reward"] < 0.0
    else:
        assert row["mean_episode_reward"] > 1.0
    for k, t in leaves.items():
        assert t.shape[0] == 16 and t.device.type == "cpu"
        assert torch.isfinite(t.float()).all(), k
    json.dumps(row)


def test_web_max_row_raises_naming_the_pooled_engine(configs, monkeypatch):
    """The fused measure refuses a configuration outside the kernels'
    envelope, naming the pooled engine: the web app's maximum under a beam
    wider than the kernels' 6 (the wide6 instantiations hold up to 6).
    The ``web_max_pooled`` row stays the pooled engine's: ``main`` runs it
    there (on the card: here it raises without one)."""
    params, anchor = configs["web_max_pooled"]
    assert "web_max_pooled" not in bench_matrix.FUSED_ROWS
    with pytest.raises(ValueError, match="pooled engine"):
        bench_matrix.measure("web_max_pooled",
                             params.replace(reward_type="beam",
                                            reward_beam_width=7), anchor, 16,
                             "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_matrix.main(["--configs", "web_max_pooled"])


def test_web_max_runs_on_the_fused_engine(configs, monkeypatch):
    """The web app's maximum under the centroid reward is inside the
    envelope (the pin kernels' wide instantiation): the fused measure
    runs it, here on the plain version."""
    monkeypatch.setattr(bench_matrix, "MAX_CALLS", 2)
    params, anchor = configs["web_max_pooled"]
    row, leaves = bench_matrix.measure("web_max", params, anchor, 8, "cpu",
                                       inner=5)
    assert row["engine"] == "fused_plain" and row["kernel"] == "centroid"
    assert row["calls"] == 4 and math.isfinite(row["steps_per_sec"])
    # the zero boards were regenerated as web_max instances, mid-episode
    assert (leaves["num_components"] == 40).all()
    assert (leaves["num_pins"] >= 20).all() and (leaves["cursor"] > 0).all()


def test_web_max_row_runs_on_the_pooled_engine(configs, monkeypatch):
    """The pooled row at a small size on CPU tensors: the JAX tool's tuning
    but 4 boards and 5-step chunks; rate, wraps and the episode
    accounting."""
    monkeypatch.setattr(bench_matrix, "MAX_CALLS", 2)
    params, anchor = configs["web_max_pooled"]
    tuning = dict(bench_matrix.POOLED_TUNING["web_max_pooled"], batch=4,
                  inner=5)
    row = bench_matrix.measure_pooled("web_max_pooled", params, anchor,
                                      "cpu", **tuning)
    assert row["engine"] == "pooled_torch" and row["device"] == "cpu"
    assert row["calls"] == 4 and row["batch"] == 4
    assert row["wraps"] == 0 and row["pool_size"] == 2
    assert row["steps_per_sec"] > 0 and math.isfinite(row["reward_sum"])
    # 40 components on 30x30: no episode ends in 10 steps after the
    # warm-up chunk's fresh boards
    assert row["episodes"] == 0
    json.dumps(row)


def test_main_prints_rows_and_writes_only_when_asked(tmp_path, capsys,
                                                     monkeypatch):
    # main measures on the card; here its rows run on CPU tensors
    monkeypatch.setattr(bench_matrix, "measure", functools.partial(
        bench_matrix.measure, device="cpu"))
    payload = bench_matrix.main(["--batch", "8", "--inner", "2",
                                 "--configs", "square"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == payload and list(payload["rows"]) == ["square"]
    out = tmp_path / "rows.json"
    bench_matrix.main(["--batch", "8", "--inner", "2", "--configs", "rect",
                       "--out", str(out)])
    assert list(json.loads(out.read_text())["rows"]) == ["rect"]


def test_cuda_rows_need_a_card(configs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, anchor = configs["square"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_matrix.measure("square", params, anchor, 16, "cuda")
