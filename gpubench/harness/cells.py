"""The system under test, and the window every cell shares.

A traffic file names its entry point ("entry"), its number of clients
("clients") and its parameters.  The driver of an entry is the class
`Driver` of gpubench/entries/<entry>.py (found by name, spec.py): it
makes the inputs from the seed and the configuration, makes request i
and tells the reference what each input was.  Everything else is here:
the warm-up, the measured window (each client a closed loop, requests
handed out in order), the sample of results drawn from the seed
(reservoir sampling over every result of the window), and the judging.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import random
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from . import reference, trace


class Program:
    """fennec_tpu_torch with the configuration's Options: program.<entry>(
    *args) calls fennec_tpu_torch.<entry>(None, *args, options,
    device=...), so any entry point of the port can be driven by name."""

    def __init__(self, device, options: dict):
        import fennec_tpu_torch as fennec

        self.fennec = fennec
        self.device = str(device)
        self.options = options

    def opts(self):
        o = self.fennec.Options()
        for key, value in self.options.items():
            cur = getattr(o, key)
            if isinstance(cur, enum.Enum):
                value = type(cur)[str(value).upper()]
            setattr(o, key, value)
        return o

    def __getattr__(self, entry: str):
        fn = getattr(self.fennec, entry)

        def call(*args, **kwargs):
            return fn(None, *args, self.opts(), device=self.device, **kwargs)

        return call

    @contextlib.contextmanager
    def recording(self):
        """The program's stage timer and batch counters for the block, as
        a Recorder."""
        from fennec_tpu_torch.engine.batched import counters
        from fennec_tpu_torch.utils.profiling import StageTimer, use_timer

        rec = Recorder()

        class Timer(StageTimer):
            @contextlib.contextmanager
            def stage(self, name: str):
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    t1 = time.perf_counter()
                    self.add(name, t1 - t0)
                    if rec.spans is not None:
                        rec.spans.record(name, t0, t1)

        timer = Timer()
        rec.totals, rec.snapshot = timer.totals, counters.snapshot
        counters.reset()
        with use_timer(timer):
            yield rec


class Recorder:
    """What the program records while a Program.recording() block runs:
    `totals` (seconds per stage), `snapshot()` (the batch counters), and
    host spans into `spans` while the window's traced slice runs."""

    spans: Optional[trace.StageSpans] = None


def _valid(res) -> bool:
    """A result that can be judged: quality 1..100 and a JPEG's bytes."""
    data = getattr(res, "compressed_data", None) or b""
    return (1 <= int(getattr(res, "jpeg_quality", 0)) <= 100
            and data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9")


class Driver:
    """One cell's traffic over one system.  An entry's driver subclasses
    it and gives setup(), call(i), bound_s(key, result) and case(key)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 system):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.system = seed, torch.device(device), \
            system
        self.target = float(config["target_ssim"])
        self.clients = int(traffic.get("clients", 1))
        self.latencies = []
        self.attempted = self.failed = 0
        self.images = 0
        self.window_s = 0.0
        self.sample = []
        self.keep = int(traffic["check"])
        self.rng = random.Random(seed * 1_000_003 + 17)
        self.stages = {}
        self.counters = None
        self.readings_requests = self.readings_images = 0
        self.summary: Optional[trace.Summary] = None
        self.notes = {}  # extra keys of the result's line
        self.tmp = tempfile.mkdtemp(prefix="gpubench-")
        self._seen = 0
        self._errors_shown = 0
        self._lock = threading.Lock()

    # Results are kept by reservoir sampling, so that the sample is drawn
    # from the seed over every result of the window.
    def _offer(self, key, res) -> None:
        self._seen += 1
        if len(self.sample) < self.keep:
            self.sample.append((key, res))
        else:
            j = self.rng.randrange(self._seen)
            if j < self.keep:
                self.sample[j] = (key, res)

    def _error(self, text: str) -> None:
        self.failed += 1
        if self._errors_shown < 3:
            self._errors_shown += 1
            print(text, file=sys.stderr, end="")

    def setup(self) -> None:
        raise NotImplementedError

    def call(self, i: int):
        """Request i → [(key, result)], key naming the input judged."""
        raise NotImplementedError

    def bound_s(self, key, res) -> float:
        """The least time the card could take for the result's work."""
        raise NotImplementedError

    def case(self, key) -> reference.Case:
        raise NotImplementedError

    def request_items(self) -> int:
        """Results a request carries (counted as failed when it raises)."""
        return 1

    def warmup(self) -> None:
        for i in range(int(self.traffic["warmup"])):
            self.call(i)

    def measure(self, seconds: float, trace_seconds: float = 0.0) -> None:
        """The window: each client sends its next request as soon as its
        last one returns, while the clock is inside the window; with
        trace_seconds, the requests of the window's first trace_seconds
        are traced."""
        tracing = trace_seconds > 0
        with (self.system.recording() if tracing
              else contextlib.nullcontext()) as rec:
            self._rec, self._trace_s = rec, trace_seconds
            self._slice = trace.Slice() if tracing else None
            self._base = None
            self._bound = 0.0
            if tracing:
                self._slice.start()
                rec.spans = self._slice.spans
            self._next = 0
            self._t0 = self._end = time.perf_counter()
            self._seconds = seconds
            if self.clients == 1:
                self._client()
            else:
                threads = [threading.Thread(
                    target=contextvars.copy_context().run,
                    args=(self._client,)) for _ in range(self.clients)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            self.window_s = self._end - self._t0
            if tracing:
                self._close_slice()
                self._after_slice(rec.totals, rec.snapshot())
                self.summary = self._slice.summary()
                self.summary.bound_s = self._bound

    def _client(self) -> None:
        rec = self._rec
        while time.perf_counter() - self._t0 < self._seconds:
            with self._lock:
                i = self._next
                self._next += 1
            r0 = time.perf_counter()
            try:
                out, error = self.call(i), None
            except Exception:  # noqa: BLE001 — every failure is counted
                out, error = None, traceback.format_exc()
            end = time.perf_counter()
            with self._lock:
                self._end = max(self._end, end)
                self.latencies.append(end - r0)
                if out is None:
                    self.attempted += self.request_items()
                    self._error(error)
                    out = []
                for key, res in out:
                    self.attempted += 1
                    if _valid(res):
                        self._offer(key, res)
                        if rec is not None and rec.spans is not None:
                            self._bound += self.bound_s(key, res)
                    else:
                        self.failed += 1
                self.images += len(out)
                if rec is not None and rec.spans is not None:
                    rec.spans.record("request", r0, end)
                    if end - self._slice.t0 >= self._trace_s:
                        self._close_slice()

    def _close_slice(self) -> None:
        """Stop the traced slice once, and note what the window had done
        by then."""
        rec = self._rec
        if rec.spans is None:
            return
        self._slice.stop()
        rec.spans = None
        self._base = (len(self.latencies), self.images, dict(rec.totals),
                      rec.snapshot())

    def _after_slice(self, totals: dict, counters: dict) -> None:
        """Stage seconds, counters, requests and images of the window
        after the traced slice, so that the profiler's own cost is not in
        the per-layer readings."""
        n, images, stages0, counters0 = self._base
        self.readings_requests = len(self.latencies) - n
        self.readings_images = self.images - images
        self.stages = {k: v - stages0.get(k, 0.0) for k, v in totals.items()}
        secs0 = counters0["stage_seconds"]
        self.counters = {
            "stage_seconds": {k: v - secs0.get(k, 0.0) for k, v in
                              counters["stage_seconds"].items()},
            "chunk_items": counters["chunk_items"][
                len(counters0["chunk_items"]):]}

    def end_to_end(self) -> dict:
        lat = np.array(self.latencies) * 1e3
        out = {"images_per_s": self.images / self.window_s
               if self.window_s > 0 else 0.0}
        if len(lat):
            out["latency_p50_ms"] = float(np.percentile(lat, 50))
            out["latency_p95_ms"] = float(np.percentile(lat, 95))
        return out

    def judge(self) -> dict:
        """The largest of each number over the sampled results."""
        worst = {}
        for key, res in self.sample:
            for name, value in reference.judge(self.case(key), res,
                                               self.target,
                                               self.device).items():
                worst[name] = max(worst.get(name, 0.0), value)
        return worst

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)
