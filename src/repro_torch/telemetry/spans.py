"""Host-side timing spans and profiler hooks.

Two annotation layers:

* inside a round, ``torch.profiler.record_function`` labels the round
  phases (``Engine.step`` and the host round loop wrap select / train /
  attack / compress / aggregate / account): the labels show in
  ``torch.profiler`` traces and cost a few microseconds of host time a
  label when no profiler runs;
* on the host, :func:`span` wraps a block in ``record_function`` AND
  times it with ``perf_counter``, optionally emitting a ``span`` event —
  this is how drivers separate the first round (kernel builds at first
  use) from steady-state execution.

Where a span ends on the card: PyTorch queues kernels and returns, so a
host span ends when its block has *issued* its work, not when the card
has run it. A span around ``FLServer.run_round`` still covers the
round's device time, because the round reads its delivered mask on the
host, and with telemetry on also ``RoundOut.params_l2`` — a read that
waits for the round's last kernel. No span adds a synchronization of
its own.

:func:`trace` is the opt-in capture: wrap any driver call, and a Chrome
trace of it (host ops, the round labels and, on a CUDA run, the device
kernels) lands in the directory, for ``ui.perfetto.dev``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the capture in progress (start_trace .. stop_trace) and its directory
_active: Optional[tuple] = None


class SpanTimer:
    """Mutable result handle yielded by :func:`span` (``seconds`` is
    populated when the block exits)."""

    def __init__(self, name: str):
        self.name = name
        self.seconds: float = 0.0


@contextmanager
def span(name: str, context: Optional[Any] = None, *,
         phase: Optional[str] = None,
         t: Optional[int] = None) -> Iterator[SpanTimer]:
    """Time a host-side block under a profiler ``record_function``.

    ``context`` — an optional ``schema.RunContext``: when given, a
    ``span`` event is emitted on exit (even if the block raised, so a
    crashing round still records how far it got)."""
    timer = SpanTimer(name)
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield timer
    finally:
        timer.seconds = time.perf_counter() - t0
        if context is not None:
            context.span(name, timer.seconds, phase=phase, t=t)


def start_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` capture for ``logdir``: host activity,
    and device activity when a CUDA device is present."""
    global _active
    if _active is not None:
        raise RuntimeError("a trace is already being captured")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _active = (prof, Path(logdir))


def stop_trace() -> Path:
    """End the capture and write it as ``<logdir>/trace.json`` (Chrome
    trace format); returns that path."""
    global _active
    if _active is None:
        raise RuntimeError("no trace is being captured")
    prof, logdir = _active
    _active = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / "trace.json"
    prof.export_chrome_trace(str(path))
    return path


@contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a Chrome trace of the ``with`` body into ``logdir``."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()
