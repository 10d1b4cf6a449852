"""A traced slice of the measured window: torch.profiler over the first
requests of the window, reduced to what the per-layer metrics and the
`breakdown` read.

Host spans are the program's own stages, recorded by the
harness as (name, start, end) on the host clock while the slice runs
(StageSpans), and the harness's own request spans.  The trace's clock is
tied to the host clock by one marker recorded at a known host time.  An
idle gap of the card is named by the innermost span open on the host at
its middle, under the benchmark's span names.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

# The program's stage and counter names → the benchmark's span names.
SPAN_NAMES = {"open + decode": "decode", "orient": "orient",
              "jpeg quality search": "search", "write": "write",
              "prep": "prep", "device": "chunk", "encode": "encode",
              "request": "request"}
OUTSIDE = "between_requests"
MARKER = "gpubench.clock"


class StageSpans:
    """Host spans, thread-safe: record(name, start, end) on the
    perf_counter clock."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    def record(self, name: str, start: float, end: float) -> None:
        with self._lock:
            self.spans.append((name, start, end))


class Summary:
    """What a traced slice shows: busy_s (the union of the card's kernels,
    copies and sets), window_s (the slice), kernel_s (the kernels' summed
    time), device_ops and idle_gaps (the breakdown's lists), bound_s (the
    least time of the slice's work, set by the driver)."""

    def __init__(self) -> None:
        self.busy_s = 0.0
        self.window_s = 0.0
        self.kernel_s = 0.0
        self.device_ops: List[list] = []
        self.idle_gaps: List[list] = []
        self.bound_s: Optional[float] = None


def _profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm_up() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, seconds) is not inside the window."""
    prof = _profile()
    prof.start()
    torch.zeros(1).add_(1)
    prof.stop()


class Slice:
    """torch.profiler around the slice; start() and stop() bracket it."""

    def __init__(self) -> None:
        self.prof = _profile()
        self.spans = StageSpans()
        self.t0 = self.t1 = 0.0
        self.marker_host = 0.0

    def start(self) -> None:
        self.prof.start()
        self.marker_host = time.perf_counter()
        with torch.profiler.record_function(MARKER):
            pass
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> Summary:
        out = Summary()
        events = self.prof.events()
        marker = [e for e in events if e.name == MARKER]
        # Trace microseconds of a host perf_counter time.
        base = (marker[0].time_range.start - self.marker_host * 1e6
                if marker else 0.0)
        lo, hi = self.t0 * 1e6 + base, self.t1 * 1e6 + base
        out.window_s = self.t1 - self.t0
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name: Dict[str, float] = defaultdict(float)
        ivals = []
        for e in dev:
            s, t = e.time_range.start, e.time_range.end
            if t <= s:
                continue
            ivals.append((s, t))
            by_name[e.name] += (t - s) / 1e6
            if not e.name.startswith(("Memcpy", "Memset")):
                out.kernel_s += (t - s) / 1e6
        out.device_ops = [[n, v] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        busy = []
        for s, t in sorted(ivals):
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], t)
            else:
                busy.append([s, t])
        out.busy_s = sum(t - s for s, t in busy) / 1e6
        gaps, edge = [], lo
        for s, t in busy:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, t)
        if hi > edge:
            gaps.append((edge, hi))
        spans = [(n, s * 1e6 + base, t * 1e6 + base)
                 for n, s, t in self.spans.spans]
        idle: Dict[str, float] = defaultdict(float)
        for s, t in gaps:
            idle[_name_at((s + t) / 2, spans)] += (t - s) / 1e6
        out.idle_gaps = [[n, v] for n, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10]]
        return out


def _name_at(t: float, spans) -> str:
    """The benchmark's name of the innermost host span open at trace time
    t."""
    best, width = OUTSIDE, float("inf")
    for n, s, e in spans:
        if s <= t <= e and e - s < width:
            best, width = SPAN_NAMES.get(n, n), e - s
    return best
