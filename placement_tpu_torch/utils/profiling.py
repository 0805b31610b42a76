"""Profiling of the port: the program's own spans, and a ``torch.profiler``
window (port of ``placement_tpu/utils/profiling.py``).

Spans. ``with span(name):`` marks a stretch of the program's host code.
Off (the default) it costs one test of a module flag and returns one shared
object that does nothing: no allocation, no clock read. After
``enable(capacity)`` each span records ``(name, start_ns, end_ns, parent)``
on ``time.perf_counter_ns()`` into a buffer of ``capacity`` records made at
``enable``; ``parent`` is the index of the innermost span open around it
(-1 at the top), so every span under one call shares that call's span as its
root. A span past the buffer's capacity is dropped and counted
(``dropped()``); ``end_ns`` stays 0 while a span is open. While a
``torch.profiler`` records, each span also opens
``torch.profiler.record_function(name)``, so its range lies among the
profiler's events on the clock of the device's activities. One thread
records at a time. ``spans()`` reads the records, ``disable()`` stops
recording and keeps them, ``reset()`` empties the buffer.

Window. ``trace_iterations(logdir, first, last)``: the trainer calls
``maybe_start(it)`` / ``maybe_stop(it)`` around each iteration to trace a
few steady-state ones (the first warms up the card's caches) into a Chrome
trace (``trace_<pid>_<ns>.json``, for Perfetto or ``chrome://tracing``), with
the card's kernels where a card is present, and the spans while they are on.
It never throws: a profiler failure becomes a warning, so it can never end a
training run.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Tuple

import torch

log = logging.getLogger(__name__)

#: records a buffer holds unless ``enable`` is given another capacity
CAPACITY = 1 << 16

Span = Tuple[str, int, int, int]


class _Off:
    """What ``span`` returns while recording is off: one shared object."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Buffer:
    """Fixed-capacity span records, columns made once."""

    def __init__(self, capacity: int):
        self.names: List[Optional[str]] = [None] * capacity
        self.starts = [0] * capacity
        self.ends = [0] * capacity
        self.parents = [-1] * capacity
        self.count = 0
        self.dropped = 0
        self.innermost = -1


class _On:
    """One span while recording is on."""

    __slots__ = ("buf", "name", "index", "mirror")

    def __init__(self, buf: _Buffer, name: str):
        self.buf = buf
        self.name = name

    def __enter__(self) -> None:
        buf = self.buf
        self.mirror = None
        if torch.autograd._profiler_enabled():
            self.mirror = torch.profiler.record_function(self.name)
            self.mirror.__enter__()
        i = buf.count
        if i == len(buf.names):
            buf.dropped += 1
            self.index = -1
            return
        buf.count = i + 1
        buf.names[i] = self.name
        buf.parents[i] = buf.innermost
        buf.innermost = self.index = i
        buf.starts[i] = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        buf, i = self.buf, self.index
        if i >= 0:
            buf.ends[i] = time.perf_counter_ns()
            buf.innermost = buf.parents[i]
        if self.mirror is not None:
            self.mirror.__exit__(*exc)


#: the buffer of the last ``enable``; ``_recording`` is it while on, None
#: while off: the one flag ``span`` tests
_buffer: Optional[_Buffer] = None
_recording: Optional[_Buffer] = None


def span(name: str):
    """``with span(name):`` records the block as a span while recording is
    on; does nothing while it is off."""
    buf = _recording
    if buf is None:
        return _OFF
    return _On(buf, name)


def enable(capacity: int = CAPACITY) -> None:
    """Start recording into a new, empty buffer of ``capacity`` records."""
    global _buffer, _recording
    _buffer = _recording = _Buffer(capacity)


def disable() -> None:
    """Stop recording; the records stay readable."""
    global _recording
    _recording = None


def reset() -> None:
    """Empty the buffer (records and drop count), on or off."""
    if _buffer is not None:
        _buffer.count = _buffer.dropped = 0
        _buffer.innermost = -1


def spans() -> List[Span]:
    """The records, ``(name, start_ns, end_ns, parent)`` in the order the
    spans opened."""
    b = _buffer
    if b is None:
        return []
    return list(zip(b.names[:b.count], b.starts[:b.count],
                    b.ends[:b.count], b.parents[:b.count]))


def dropped() -> int:
    """Spans the buffer had no room for since it was made or reset."""
    return 0 if _buffer is None else _buffer.dropped


def _start(logdir: str):
    """A started profiler, or None (with a warning) when it fails."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        os.makedirs(logdir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof
    except Exception as e:  # noqa: BLE001 - profiling must never kill a run
        log.warning("profiler trace failed to start: %s", e)
        return None


def _stop(prof, logdir: str) -> None:
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
    except Exception as e:  # noqa: BLE001 - profiling must never kill a run
        log.warning("profiler trace failed to stop: %s", e)


class trace_iterations:
    """Trace the inclusive iteration window ``[first, last]``.

    Call ``maybe_start(it)`` before an iteration and ``maybe_stop(it)``
    after it; the trace spans iterations ``first..last`` inclusive.
    """

    def __init__(self, logdir: str, first: int = 2, last: int = 3):
        self.logdir = logdir
        self.first = first
        self.last = last
        self._prof = None

    def maybe_start(self, iteration: int) -> None:
        if iteration == self.first and self._prof is None:
            self._prof = _start(self.logdir)

    def maybe_stop(self, iteration: int) -> None:
        if iteration >= self.last and self._prof is not None:
            _stop(self._prof, self.logdir)
            self._prof = None

    def close(self) -> None:
        self.maybe_stop(self.last)
