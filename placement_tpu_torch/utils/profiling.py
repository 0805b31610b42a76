"""Profiling harness over ``torch.profiler`` (port of
``placement_tpu/utils/profiling.py``).

Two entry points, as in the JAX package:

  * ``trace(logdir)``: a context manager; traces everything inside.
  * ``trace_iterations(logdir, first, last)``: the trainer calls
    ``maybe_start(it)`` / ``maybe_stop(it)`` around each iteration to trace
    a few steady-state ones (the first warms up the card's caches).

Each writes a Chrome trace (``trace_<pid>_<ns>.json``, for Perfetto or
``chrome://tracing``) into ``logdir``, with the card's kernels where a card
is present. Neither throws: a profiler failure becomes a warning, so it
can never end a training run.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger(__name__)


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


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir):`` — write a profiler trace of the block into
    ``dir``."""
    prof = _start(logdir)
    try:
        yield
    finally:
        if prof is not None:
            _stop(prof, logdir)


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
