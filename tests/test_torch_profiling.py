"""The port's spans (``utils/profiling.py``) and where the fused rollout's
wrapper and kernel library record them, on the CPU."""

import contextlib
import pathlib
import time
import tracemalloc
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from placement_tpu_torch.ops import fused_rollout as torch_fused
from placement_tpu_torch.utils import profiling
from placement_tpu_torch.utils.config import load_env_params
from portbench import devtrace
from tests.test_torch_fused_rollout import stub_nvcc


@pytest.fixture(autouse=True)
def off_after():
    yield
    profiling.disable()
    profiling.reset()


def _names():
    return [s[0] for s in profiling.spans()]


def _live_in_profiling(snapshot) -> int:
    keep = [tracemalloc.Filter(True, profiling.__file__)]
    return len(snapshot.filter_traces(keep).traces)


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(
        monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert profiling.span("a") is profiling.span("b") is profiling._OFF
    tracemalloc.start()
    try:
        with profiling.span("a"):
            with profiling.span("b"):
                off = _live_in_profiling(tracemalloc.take_snapshot())
        monkeypatch.undo()
        profiling.enable(8)
        with profiling.span("a"):
            on = _live_in_profiling(tracemalloc.take_snapshot())
    finally:
        tracemalloc.stop()
    assert off == 0 and on > 0
    assert _names() == ["a"]
    profiling.disable()
    profiling.reset()
    with profiling.span("c"):
        pass
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_on_nests_parents_counts_drops_and_resets():
    profiling.enable(4)
    with profiling.span("root"):
        with profiling.span("a"):
            with profiling.span("a1"):
                pass
        with profiling.span("b"):
            pass
        with profiling.span("c"):        # the fifth: no room
            with profiling.span("c1"):   # nor here
                pass
    got = profiling.spans()
    assert [(n, p) for n, _, _, p in got] == [
        ("root", -1), ("a", 0), ("a1", 1), ("b", 0)]
    assert profiling.dropped() == 2
    for name, start, end, parent in got:
        assert 0 < start <= end
        if parent >= 0:
            assert got[parent][1] <= start and end <= got[parent][2]
    with profiling.span("after"):        # the root closed: top level again
        pass
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0
    with profiling.span("d"):
        pass
    assert profiling.spans()[0][0] == "d" and profiling.spans()[0][3] == -1
    profiling.disable()
    with profiling.span("e"):
        pass
    assert _names() == ["d"]


def test_spans_mirror_into_the_profilers_ranges():
    profiling.enable()
    with profiling.span("outside"):      # no profiler: no mirror
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
    events = devtrace._events(prof.events())
    ranges = {e["name"]: e for e in events if e["device"] == "cpu"}
    assert "outside" not in ranges
    outer, inner = ranges["outer"], ranges["inner"]
    assert outer["start"] <= inner["start"] <= inner["end"] <= outer["end"]
    assert _names() == ["outside", "outer", "inner"]


def test_per_board_on_the_cpu_records_the_call_around_its_checks():
    params = load_env_params("rectangle_pin")
    fn = torch_fused.make_fused_rollout(params, 8, 2, device="cpu")
    leaves = torch_fused.zero_leaves(params, 8, "cpu")
    profiling.enable()
    fn.per_board(leaves, 1)
    assert [(n, p) for n, _, _, p in profiling.spans()] == [
        ("fused_rollout.per_board", -1), ("fused_rollout.check", 0)]


def test_launch_records_alloc_and_launch_once_per_launch(monkeypatch):
    """``_launch`` with the kernel library and the CUDA device calls
    stubbed: one ``alloc`` and one ``launch`` span a launch, as many launch
    spans as ``launches`` counts, and nothing while off."""
    calls = []
    lib = types.SimpleNamespace(
        fused_rollout_launch=lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(torch_fused, "kernel_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    params = load_env_params("rectangle_pin")
    fn = torch_fused.make_fused_rollout(params, 8, 2, device="cpu")
    leaves = torch_fused.zero_leaves(params, 8, "cpu")
    fn._launch(leaves, 1)
    assert profiling.spans() == []
    profiling.enable()
    with profiling.span("fused_rollout.per_board"):
        with profiling.span("fused_rollout.check"):
            fn._check_leaves(leaves)
        out, _, _ = fn._launch(leaves, 2)
    fn._launch(out, 3)
    names = _names()
    assert names == ["fused_rollout.per_board", "fused_rollout.check",
                     "fused_rollout.alloc", "fused_rollout.launch",
                     "fused_rollout.alloc", "fused_rollout.launch"]
    assert [p for _, _, _, p in profiling.spans()] == [-1, 0, 0, 0, -1, -1]
    assert fn.launches == 3 == len(calls)
    assert names.count("fused_rollout.launch") == fn.launches - 1


def test_kernel_library_records_its_load_once_and_the_build_under_it(
        tmp_path, monkeypatch):
    """The library's first call in a process is the ``library`` span, with
    ``build`` under it only when nvcc ran; the load's seconds are kept
    whether spans are on or off."""
    stub_nvcc(tmp_path, monkeypatch)
    monkeypatch.setattr(torch_fused, "load_kernel_library",
                        lambda path: types.SimpleNamespace(path=path))
    monkeypatch.setattr(torch_fused, "_library_s", None)
    torch_fused.kernel_library.cache_clear()
    try:
        profiling.enable()
        lib = torch_fused.kernel_library()
        assert torch_fused.kernel_library() is lib
        assert [(n, p) for n, _, _, p in profiling.spans()] == [
            ("fused_rollout.library", -1), ("fused_rollout.build", 0)]
        (_, start, end, _), (_, b0, b1, _) = profiling.spans()
        assert start <= b0 <= b1 <= end
        assert torch_fused.library_seconds() == pytest.approx(
            (end - start) * 1e-9, abs=1e-3)
        torch_fused.kernel_library.cache_clear()     # another process
        profiling.reset()
        torch_fused.kernel_library()
        assert _names() == ["fused_rollout.library"]  # built: a load
        torch_fused.kernel_library.cache_clear()
        profiling.disable()
        profiling.reset()
        torch_fused.kernel_library()
        assert profiling.spans() == []
        assert torch_fused.library_seconds() > 0
    finally:
        torch_fused.kernel_library.cache_clear()


def test_only_the_profiling_module_opens_profiler_ranges():
    """Every range the port opens goes through ``span``, so it is one of
    the program's spans and is off by default."""
    root = pathlib.Path(torch_fused.__file__).resolve().parents[1]
    callers = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                     if "record_function" in p.read_text())
    assert callers == [str(pathlib.Path("utils", "profiling.py"))]
