"""The reading of the program's spans (``portbench/spans.py``) and the
reader of ``library_s.setup``, on records and a trace written by hand (a
CPU run has no device trace)."""

import pytest

from placement_tpu_torch.ops import fused_rollout
from portbench import devtrace, manifest, spans

BENCH = manifest.load()


def _ev(name, device, start, end, id_):
    return {"name": name, "device": device, "start": start, "end": end,
            "id": id_}


def _call(t, id_):
    """A ``per_board`` range at ``t`` us holding its three spans."""
    return [_ev(spans.PER_BOARD, "cpu", t, t + 10, id_),
            _ev(spans.CHECK, "cpu", t, t + 2, id_ + 1),
            _ev(spans.ALLOC, "cpu", t + 2, t + 5, id_ + 2),
            _ev(spans.LAUNCH, "cpu", t + 5, t + 9, id_ + 3)]


def _trace():
    """A 100 us window holding two calls (at 0 and 20 us); the device busy
    3-7, 9.5-22, 24-50 and 60-95 us, so idle in the first call's checks
    (0-3) and launch (7-9.5), the second's allocation (22-24), and outside
    the program (50-60, 95-100); the first call's mirror on the device
    shares its id and covers gaps, and counts as no activity."""
    return [_ev(devtrace.WINDOW, "cpu", 0, 100, 1), *_call(0, 10),
            *_call(20, 20),
            _ev("cudaStreamSynchronize", "cpu", 40, 99, 30),
            _ev(spans.PER_BOARD, "cuda", 3, 60, 10),
            _ev("k", "cuda", 3, 7, 101), _ev("k", "cuda", 9.5, 22, 102),
            _ev("k", "cuda", 24, 50, 103), _ev("k", "cuda", 60, 95, 104)]


def test_idle_gaps_go_to_the_innermost_span_or_outside():
    got = spans.idle_by_span(_trace())
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["idle_s"] == pytest.approx(22.5e-6)
    by = got["idle_by_span"]
    assert set(by) == {spans.CHECK, spans.LAUNCH, spans.ALLOC, spans.OUTSIDE}
    assert by[spans.CHECK] == pytest.approx(3e-6)
    assert by[spans.LAUNCH] == pytest.approx(2.5e-6)
    assert by[spans.ALLOC] == pytest.approx(2e-6)
    assert by[spans.OUTSIDE] == pytest.approx(15e-6)
    assert sum(by.values()) == pytest.approx(got["idle_s"])
    assert got["wrapper_idle_pct"] == pytest.approx(7.5)


def _records(calls):
    """``calls`` calls of 100 ns: checks 20, allocation 40, launch 30."""
    out = []
    for i in range(calls):
        t, root = 1000 * i, len(out)
        out += [(spans.PER_BOARD, t, t + 100, -1),
                (spans.CHECK, t + 1, t + 21, root),
                (spans.ALLOC, t + 21, t + 61, root),
                (spans.LAUNCH, t + 61, t + 91, root)]
    return out


def test_the_split_and_its_means():
    split = {**spans._split(_records(3)), "launches": 3, "dropped": 0}
    assert split["count"] == {spans.PER_BOARD: 3, spans.CHECK: 3,
                              spans.ALLOC: 3, spans.LAUNCH: 3, "self": 3}
    want = {spans.PER_BOARD: 0.1, spans.CHECK: 0.02, spans.ALLOC: 0.04,
            spans.LAUNCH: 0.03, "self": 0.01}
    for name, us in want.items():
        assert spans.mean_us(split, name) == pytest.approx(us)
    assert spans.mean_us(split, spans.LIBRARY) is None
    two = spans._merged([split, {**spans._split(_records(1)),
                                 "launches": 1, "dropped": 0}])
    assert two["count"][spans.CHECK] == 4 and two["launches"] == 4
    for name, us in want.items():
        assert spans.mean_us(two, name) == pytest.approx(us)
    assert spans._merged([split, None]) is None


@pytest.mark.parametrize("fault", ["dropped", "launch_count"])
def test_an_untrusted_split_reads_nothing(fault):
    split = {**spans._split(_records(3)), "launches": 3, "dropped": 0}
    if fault == "dropped":
        split["dropped"] = 1
    else:
        split["launches"] = 4
    for name in (spans.PER_BOARD, spans.CHECK, spans.ALLOC, spans.LAUNCH,
                 "self"):
        assert spans.mean_us(split, name) is None
    assert spans.mean_us(None, spans.CHECK) is None


def test_library_reader_reads_the_programs_load(monkeypatch):
    read = manifest.reader("library_s.setup")
    assert "library_s.setup" in {m["name"] for m in BENCH["per_layer"]}
    monkeypatch.setattr(fused_rollout, "_library_s", None)
    assert read({"setup_s": 5.0}) is None
    monkeypatch.setattr(fused_rollout, "_library_s", 0.125)
    assert read({"setup_s": 5.0}) == 0.125
    monkeypatch.delattr(fused_rollout, "library_seconds")  # the parent's
    assert read({"setup_s": 5.0}) is None
