"""The 12 MP request's stages inside the port, on the CPU.

Every entry point of one JPEG records the same stages, each sub-stage
inside its parent: "open + decode" holds "huffman decode", "blocks up"
and "image down"; "validate" and "nrgba" stand alone; "jpeg quality
search" holds "image up", "device search" and "emit".  `stage()` makes
no profiler call without a running profiler, and inside `device_trace`
each stage is a host range (function scope) of the written Chrome trace.  The benchmark's
readers of these stages (gpubench/metrics) read per-request ms.
"""

import contextlib
import importlib.util
import io
import json
import os
import time
import types

import pytest
import torch

from conftest import make_noise_image
from fennec_tpu.exif import write_exif_orientation
import fennec_tpu_torch as T
from fennec_tpu_torch.codecs.jpeg import decode_jpeg
from fennec_tpu_torch.utils import profiling as tprof

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures")

# Each stage of a standard-mode JPEG request and the stage it lies in
# (None: top level).
DECODE = {"open + decode": None, "huffman decode": "open + decode",
          "blocks up": "open + decode", "image down": "open + decode"}
PASSES = {"validate": None, "nrgba": None}
SEARCH = {"jpeg quality search": None, "image up": "jpeg quality search",
          "device search": "jpeg quality search",
          "emit": "jpeg quality search"}
REQUEST = {**DECODE, **PASSES, **SEARCH}
FILE = {**REQUEST, "orient": None, "write": None}


class Recording(tprof.StageTimer):
    """A StageTimer that also keeps each stage's (name, start, end), as
    the benchmark harness's timer does."""

    def __init__(self):
        super().__init__()
        self.spans = []

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.add(name, t1 - t0)
            self.spans.append((name, t0, t1))


def parents(spans):
    """Each span's name → the names of the innermost spans that hold it
    (None for a span inside no other)."""
    out = {}
    for n, s, e in spans:
        holders = [(e2 - s2, n2) for n2, s2, e2 in spans
                   if (n2, s2, e2) != (n, s, e) and s2 <= s and e <= e2]
        out.setdefault(n, set()).add(min(holders)[1] if holders else None)
    return out


@pytest.fixture(scope="module")
def rotated_jpeg():
    """A small JPEG with EXIF orientation 6."""
    img = make_noise_image(64, 48, seed=3)
    data = T.encode_to_bytes(img, T.JPEG, 92, device=CPU)
    return data[:2] + write_exif_orientation(6) + data[2:]


def run_entry(entry, data, tmp_path):
    if entry == "compress_file":
        src = tmp_path / "in.jpg"
        src.write_bytes(data)
        return T.compress_file(None, str(src), str(tmp_path / "out.jpg"),
                               T.Options(), device=CPU)
    if entry == "compress_bytes":
        return T.compress_bytes(None, data, T.Options(), device=CPU)
    return T.compress(None, io.BytesIO(data), T.Options(), device=CPU)


# ── The stages each entry point records ─────────────────────────────────────


@pytest.mark.parametrize("entry,want", [
    ("compress_file", FILE),
    ("compress_bytes", REQUEST),
    ("compress", REQUEST),
])
def test_entry_records_its_stages_nested(entry, want, rotated_jpeg,
                                         tmp_path):
    timer = Recording()
    with tprof.use_timer(timer):
        res = run_entry(entry, rotated_jpeg, tmp_path)
    assert res.compressed_data[:2] == b"\xff\xd8"
    assert set(timer.counts) == set(want)
    assert all(n == 1 for n in timer.counts.values()), timer.counts
    assert parents(timer.spans) == {n: {p} for n, p in want.items()}


def test_progressive_decode_has_the_decode_stages():
    with open(os.path.join(FIXTURES, "progressive_1280x720.jpg"),
              "rb") as f:
        data = f.read()
    timer = Recording()
    with tprof.use_timer(timer), tprof.stage("open + decode"):
        img = decode_jpeg(data, CPU)
    assert img.shape == (720, 1280, 4)
    assert parents(timer.spans) == {n: {p} for n, p in DECODE.items()}


def test_substages_lie_inside_their_parents_spans(rotated_jpeg, tmp_path):
    """Each sub-stage's span is held by one span of its parent, and the
    top-level stages do not overlap."""
    timer = Recording()
    with tprof.use_timer(timer):
        for _ in range(2):
            run_entry("compress_file", rotated_jpeg, tmp_path)
    spans = timer.spans
    for n, s, e in spans:
        parent = FILE[n]
        if parent is not None:
            assert sum(1 for n2, s2, e2 in spans
                       if n2 == parent and s2 <= s and e <= e2) == 1, n
    top = sorted((s, e) for n, s, e in spans if FILE[n] is None)
    assert all(e1 <= s2 for (_, e1), (s2, _) in zip(top, top[1:]))


# ── stage() and the profiler ────────────────────────────────────────────────


@pytest.mark.parametrize("with_timer", [False, True])
def test_stage_makes_no_profiler_call_when_none_runs(monkeypatch,
                                                     rotated_jpeg,
                                                     with_timer):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    timer = tprof.StageTimer()
    installed = tprof.use_timer(timer) if with_timer else \
        contextlib.nullcontext()
    with installed, tprof.stage("outer"):
        res = T.compress_bytes(None, rotated_jpeg, T.Options(), device=CPU)
    assert res.jpeg_quality > 0
    assert set(timer.counts) == (set(REQUEST) | {"outer"} if with_timer
                                 else set())


def test_stage_opens_a_range_while_a_profiler_runs(monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    timer = tprof.StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tprof.use_timer(timer), tprof.stage("timed"):
            pass
        with tprof.stage("untimed"):
            pass
    with tprof.stage("after"):
        pass
    assert entered == ["timed", "untimed"]
    assert timer.counts == {"timed": 1}


def test_device_trace_holds_a_host_range_for_each_stage(rotated_jpeg,
                                                        tmp_path):
    """Each stage is a host range of function scope ("cpu_op"): a user
    annotation would also be copied onto a card's timeline as a device
    event."""
    out = tmp_path / "trace"
    timer = tprof.StageTimer()
    with tprof.use_timer(timer), tprof.device_trace(str(out)):
        run_entry("compress_file", rotated_jpeg, tmp_path)
    assert set(timer.counts) == set(FILE)
    (path,) = out.glob("trace.*.json")
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in FILE:
            assert e["cat"] == "cpu_op", e
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    assert set(ranges) == set(FILE)
    for name, parent in FILE.items():
        if parent is not None:
            (s, e), = ranges[name]
            (ps, pe), = ranges[parent]
            assert ps <= s and e <= pe, name


# ── The benchmark's readers of the stages ───────────────────────────────────


def reader(metric):
    """gpubench/metrics/<metric>.py's read, loaded by path as the
    benchmark's Spec.reader loads it."""
    path = os.path.join(ROOT, "gpubench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metrics_" + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


STAGES = {"huffman decode": 2.0, "blocks up": 0.3, "image up": 0.5,
          "image down": 0.9, "validate": 0.1, "nrgba": 0.6,
          "open + decode": 4.0}


@pytest.mark.parametrize("metric,want", [
    ("huffman_ms", 2.0 / 40 * 1e3),
    ("upload_ms", (0.3 + 0.5) / 40 * 1e3),
    ("download_ms", 0.9 / 40 * 1e3),
    ("nrgba_ms", (0.1 + 0.6) / 40 * 1e3),
])
def test_reader_gives_ms_per_request(metric, want):
    read = reader(metric)
    got = read(types.SimpleNamespace(stages=dict(STAGES), requests=40))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric,part,want", [
    ("upload_ms", {"blocks up": 0.3}, 0.3 / 40 * 1e3),
    ("upload_ms", {"image up": 0.5}, 0.5 / 40 * 1e3),
    ("nrgba_ms", {"nrgba": 0.6}, 0.6 / 40 * 1e3),
])
def test_reader_sums_the_stages_it_finds(metric, part, want):
    got = reader(metric)(types.SimpleNamespace(stages=part, requests=40))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", ["huffman_ms", "upload_ms",
                                    "download_ms", "nrgba_ms"])
def test_reader_is_none_without_its_stages_or_requests(metric):
    read = reader(metric)
    assert read(types.SimpleNamespace(
        stages={"open + decode": 4.0, "orient": 1.0}, requests=40)) is None
    assert read(types.SimpleNamespace(stages=dict(STAGES),
                                      requests=0)) is None
