"""Observability: per-stage wall timers and torch.profiler traces.

Counterpart of fennec_tpu/utils/profiling.py.  The reference's only
timing surface is the CLI wall-clock print (cmd/fennec/main.go:116-127)
and Go benchmarks; the port adds a composable stage timer (the CLI's -v
report, FENNEC_DEBUG_BATCH in the batch engines) and device-aware traces
through torch.profiler.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch
# The profiler's own flag, read at each stage (a module attribute, set
# while any torch.profiler or autograd profiler runs).
import torch.autograd.profiler as _autograd_profiler


class StageTimer:
    """Accumulates wall time per named stage.  Thread-safe: the batch
    engines record the stages of their worker threads into the same
    timer.

    with timer.stage("resize"): ...
    print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - start)

    def add(self, name: str, seconds: float) -> None:
        """Record one pass of `name` that took `seconds`."""
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        with self._lock:  # workers may still be recording stages
            totals = dict(self.totals)
            counts = dict(self.counts)
        lines = []
        for name in sorted(totals, key=totals.get, reverse=True):
            t = totals[name]
            n = counts[name]
            lines.append(f"{name:24s} {t * 1000:9.1f} ms  ({n}×, "
                         f"{t / n * 1000:.1f} ms avg)")
        return "\n".join(lines)


# Ambient timer: production paths call `stage("name")` unconditionally;
# it is a no-op unless a caller (the CLI's -v) installed a StageTimer via
# use_timer().  A ContextVar (not a module global) keeps concurrent
# compress calls on other threads from recording into, or clobbering, an
# unrelated caller's timer; engine code that wants worker-thread stages
# in one report passes the timer object explicitly.
_active: "contextvars.ContextVar[Optional[StageTimer]]" = \
    contextvars.ContextVar("fennec_stage_timer", default=None)


@contextlib.contextmanager
def use_timer(timer: StageTimer) -> Iterator[StageTimer]:
    """Install `timer` as the ambient stage timer for the block."""
    token = _active.set(timer)
    try:
        yield timer
    finally:
        _active.reset(token)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time a named stage on the ambient timer, and mark it as a host
    range in a running torch.profiler trace, on the profiler's own clock,
    so that each kernel and copy lies under the stage that launched it.
    A no-op without either.

    The range is a RecordFunction of function scope, not a
    `record_function` (user scope): the profiler copies each user-scope
    range that launched device work onto the device's timeline as an
    event of the device, which readers of the trace would count as
    device time.

    A stage measures host time only: it adds no synchronise and no event.
    A stage that ends in a blocking copy holds the device work queued
    before the copy; one that only launches work holds the launch."""
    timer = _active.get()
    if _autograd_profiler._is_profiler_enabled:
        with torch._C._profiler._RecordFunctionFast(name):
            if timer is None:
                yield
            else:
                with timer.stage(name):
                    yield
        return
    if timer is None:
        yield
        return
    with timer.stage(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Wrap a block in a torch.profiler trace when log_dir is given;
    no-op otherwise.  The host's activity is traced always, the card's
    when PyTorch sees one; at the end of the block the trace is written
    into log_dir as a Chrome trace (trace.<pid>.<ns>.json; open it in
    chrome://tracing or Perfetto)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def nan_check(name: str, *arrays) -> None:
    """Debug guard: raise if any tensor or array holds NaN or Inf
    (torch.isfinite on tensors, on their device; numpy on the rest).

    The analogue of the reference's -race discipline (Makefile:25): the
    numeric failure mode worth guarding is NaN propagation."""
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            finite = bool(torch.isfinite(a).all())
        else:
            finite = bool(np.isfinite(np.asarray(a)).all())
        if not finite:
            raise FloatingPointError(
                f"fennec: non-finite values in {name}[{i}]")
