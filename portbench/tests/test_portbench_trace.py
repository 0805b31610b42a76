"""The reading of a profiler trace and the per-layer metrics' readers, on
a trace written by hand (a CPU run has no device trace)."""

import pytest

from portbench import devtrace, manifest

BENCH = manifest.load()


def _ev(name, device, start, end, id_):
    return {"name": name, "device": device, "start": start, "end": end,
            "id": id_}


def _trace():
    """Two chunks in a 100 us window: each a range holding an allocation
    and the program's launch, then the harness's add in its range; kernels
    of 30 us and adds of 2 us, each sharing its id with the runtime call
    that launched it; the ranges' mirrors on the device share theirs with
    the range."""
    return [
        _ev(devtrace.WINDOW, "cpu", 0, 100, 1),
        _ev(devtrace.CHUNK, "cpu", 0, 10, 2),
        _ev("aten::empty_like", "cpu", 1, 3, 3),
        _ev("cudaLaunchKernel", "cpu", 8, 9, 101),
        _ev(devtrace.HARNESS, "cpu", 10, 14, 4),
        _ev("aten::add_", "cpu", 11, 13, 5),
        _ev("cudaLaunchKernel", "cpu", 12, 13, 102),
        _ev(devtrace.CHUNK, "cpu", 20, 30, 6),
        _ev("cudaLaunchKernel", "cpu", 28, 29, 103),
        _ev(devtrace.HARNESS, "cpu", 30, 34, 7),
        _ev("aten::add_", "cpu", 31, 33, 8),
        _ev("cudaLaunchKernel", "cpu", 32, 33, 104),
        _ev("cudaStreamSynchronize", "cpu", 40, 99, 105),
        _ev("fused_kernel", "cuda", 12, 42, 101),
        _ev(devtrace.CHUNK, "cuda", 12, 42, 2),
        _ev("add_kernel", "cuda", 42, 44, 102),
        _ev("fused_kernel", "cuda", 50, 80, 103),
        _ev("add_kernel", "cuda", 80, 82, 104),
        _ev(devtrace.WINDOW, "cuda", 80, 82, 1),
    ]


def test_summarize_reads_window_busy_owners_and_gaps():
    got = devtrace.summarize(_trace(), 2)
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(64e-6)
    assert got["unlinked"] == 0 and got["launches"] == 4
    owners = [k["owner"] for k in got["kernels"]]
    assert owners == [devtrace.CHUNK, devtrace.HARNESS] * 2
    ops = dict(got["breakdown"]["device_ops"])
    assert set(ops) == {"fused_kernel", "add_kernel"}
    assert ops["fused_kernel"] == pytest.approx(60e-6)
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps[devtrace.CHUNK] == pytest.approx(12e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(24e-6)
    assert sum(gaps.values()) == pytest.approx(36e-6)


def test_a_trace_without_device_activity_raises():
    with pytest.raises(RuntimeError):
        devtrace.summarize([e for e in _trace() if e["device"] == "cpu"], 2)


def test_per_layer_readers_on_the_trace():
    trace = devtrace.summarize(_trace(), 2)
    trace.update(program_launches=2, enqueue_us=9.5,
                 bound={"ms": 0.0003})
    record = {"setup_s": 4.0, "trace": trace}
    read = {m["name"]: manifest.reader(m["name"])(record)
            for m in BENCH["per_layer"]}
    assert read["kernel_ms.rollout"] == pytest.approx(0.030)
    assert read["launches_per_chunk.rollout"] == pytest.approx(2.0)
    assert read["idle_pct.rollout"] == pytest.approx(36.0)
    assert read["kernel_roofline_pct.rollout"] == pytest.approx(1.0)
    assert read["rollout_mfu"] == pytest.approx(0.6)
    assert read["enqueue_us.rollout"] == 9.5
    assert manifest.reader("env_steps_per_s")(record) is None


def test_readers_return_nothing_where_nothing_is_read():
    trace = devtrace.summarize(_trace(), 2)
    for k in trace["kernels"]:
        k["owner"] = "other"
    trace.update(program_launches=2, enqueue_us=None,
                 bound={"ms": 0.0003})
    record = {"trace": trace}
    for name in ("kernel_ms.rollout", "kernel_roofline_pct.rollout",
                 "launches_per_chunk.rollout", "enqueue_us.rollout"):
        assert manifest.reader(name)(record) is None, name
