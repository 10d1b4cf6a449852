"""The benchmark's batch500.pixels cell at a tiny size on the CPU: the
seeded comparison of the port's batch engine (compress_images) with the
benchmark's plain reference, the cell's six per-layer readers, and the
faults and the control that have to read not correct.

Each run is gpubench.harness.main.run(device="cpu") in a child process,
since a benchmark run refuses to print its line once JAX is loaded, and
this suite's conftest loads it.  The cell runs six 60x44 photos a call
(padded to 64x48 inside the engine), one chunk; an untraced window is a
call or two, and every result of it is judged.
"""

import importlib.util
import json
import os
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "batch500.pixels"
SEED = 2**31 + 2026
TINY = {"width": 60, "height": 44, "batch": 6, "check": 64,
        "trace_seconds": 0.3}
STAGE_READERS = ["prepare_ms_per_image", "fill_ms_per_image",
                 "chunk_device_ms", "encode_ms_per_image"]
# The photo cells' readers of the card's trace, which read this cell too.
TRACE_READERS = ["device_idle_pct.latency", "kernel_roofline_pct.latency"]
READERS = TRACE_READERS + STAGE_READERS

# argv: root, seed, the overrides as JSON, then one run a word:
# <system>:<traced> with system program, quality, swap, raises, short or
# control.  Prints one JSON line a run: {"run", "rc", "line"}.
CHILD = r"""
import copy, io, json, sys, time
from contextlib import redirect_stdout

root, seed, overrides = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
sys.path.insert(0, root)
from gpubench.harness import cells, main
from gpubench.entries.compress_images import Control


class Broken:
    def __init__(self, program, fault):
        self.program, self.fault = program, fault

    def recording(self):
        return self.program.recording()

    def compress_images(self, images):
        return self.fault(list(self.program.compress_images(images)))


def quality(results):
    r = copy.copy(results[2])
    r.jpeg_quality += 1
    return results[:2] + [r] + results[3:]


def swap(results):
    a, b = copy.copy(results[0]), copy.copy(results[1])
    a.compressed_data, b.compressed_data = b.compressed_data, a.compressed_data
    return [a, b] + results[2:]


def raises(results):
    raise RuntimeError("a failed call")


def short(results):
    return results[:-1]


FAULTS = {"quality": quality, "swap": swap, "raises": raises, "short": short}
for run in sys.argv[4:]:
    who, traced = run.split(":")
    program = cells.Program("cpu", {"quality": "balanced"})
    system = (program if who == "program" else
              Control("cpu", 0.94) if who == "control" else
              Broken(program, FAULTS[who]))
    # A call that raises in the warm-up ends the run: those start at once.
    ov = dict(overrides, warmup=0) if who in ("raises", "short") \
        else overrides
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main.run("batch500.pixels", seed, 3.0 if traced == "1" else 0.02,
                      traced == "1", time.perf_counter(), device="cpu",
                      system=system, overrides=ov, root=root)
    lines = out.getvalue().strip().splitlines()
    print(json.dumps({"run": run, "rc": rc,
                      "line": json.loads(lines[-1]) if lines else None}),
          flush=True)
"""

RUNS = ["program:0", "program:1", "quality:0", "swap:0", "raises:0",
        "short:0", "control:0"]


@pytest.fixture(scope="module")
def lines():
    """{run: (exit code, the run's line)} of one child process."""
    out = subprocess.run(
        [sys.executable, "-c", CHILD, ROOT, str(SEED), json.dumps(TINY)]
        + RUNS, capture_output=True, text=True, cwd=ROOT, timeout=600)
    got = {}
    for text in out.stdout.splitlines():
        if text.startswith('{"run"'):
            r = json.loads(text)
            got[r["run"]] = (r["rc"], r["line"])
    assert set(got) == set(RUNS), out.stderr[-3000:]
    return got


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_cell_is_declared_with_its_metrics():
    b = bench()
    cell = next(w for w in b["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "batch500", "pixels", 1)
    p50 = next(m for m in b["end_to_end"] if m["name"] == "latency_p50_ms")
    assert CELL in p50["workloads"]
    mine = [m["name"] for m in b["per_layer"]
            if CELL in m.get("workloads", [])]
    assert mine == READERS
    for name in READERS:
        assert os.path.exists(os.path.join(ROOT, "gpubench", "metrics",
                                           f"{name}.py"))


def test_the_untraced_line_is_correct_with_its_end_to_end_metrics(lines):
    rc, line = lines["program:0"]
    assert rc == 0
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == line["sampled"]
    assert line["attempted"] > 0 and line["attempted"] % TINY["batch"] == 0
    assert set(line["metrics"]) == {"latency_p50_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == {"search_gap", "coef_mismatch_ppm"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_traced_line_reads_the_batch_stages(lines):
    """On the CPU the stage readers read; the two readers of the card's
    trace find no device time and leave their metrics out."""
    rc, line = lines["program:1"]
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == set(STAGE_READERS)
    assert all(line["metrics"][m]["value"] > 0 for m in STAGE_READERS)
    assert all(line["metrics"][m]["unit"] == "ms" for m in STAGE_READERS)
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    named = {name for name, _ in line["breakdown"]["idle_gaps"]}
    assert named & {"batch prepare", "prep", "chunk", "encode"}


@pytest.mark.parametrize("run", ["quality:0", "swap:0"])
def test_a_wrong_answer_is_not_correct(lines, run):
    """One image's quality off by one, or two images' files swapped."""
    rc, line = lines[run]
    assert rc == 0
    assert line["correct"] is False and line["failed"] == 0
    assert line["sampled"] == line["attempted"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("run", ["raises:0", "short:0"])
def test_a_call_that_fails_or_drops_an_image_is_not_correct(lines, run):
    """A call that raises, or returns fewer results than images, fails:
    each counts a whole call's images attempted, and no result of it is
    judged."""
    rc, line = lines[run]
    assert rc == 0
    assert line["correct"] is False
    assert line["failed"] > 0 and line["sampled"] == 0
    assert line["attempted"] > 0 and line["attempted"] % TINY["batch"] == 0


def test_the_control_is_not_correct(lines):
    """The reference in TF32 in the program's place fails at least one of
    the cell's numbers."""
    rc, line = lines["control:0"]
    assert rc == 0
    assert line["correct"] is False and line["failed"] == 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


# ── The readers, on readings made by hand ───────────────────────────────────


def reader(metric):
    """gpubench/metrics/<metric>.py's read, loaded by path as the
    benchmark's Spec.reader loads it."""
    path = os.path.join(ROOT, "gpubench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metrics_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readings(**kw):
    base = dict(stages={"batch prepare": 0.8, "prep": 0.2, "device": 0.5,
                        "encode": 1.6, "jpeg quality search": 9.0},
                requests=2, images=1024,
                counters={"chunk_items": [64] * 16,
                          "stage_seconds": {}},
                trace=types.SimpleNamespace(window_s=5.0, busy_s=0.5,
                                            kernel_s=0.25, bound_s=0.05))
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("metric,want", [
    ("prepare_ms_per_image", 0.8 / 1024 * 1e3),
    ("fill_ms_per_image", 0.2 / 1024 * 1e3),
    ("chunk_device_ms", 0.5 / 16 * 1e3),
    ("encode_ms_per_image", 1.6 / 1024 * 1e3),
    ("device_idle_pct.latency", 90.0),
    ("kernel_roofline_pct.latency", 20.0),
])
def test_reader_gives_its_value(metric, want):
    assert reader(metric)(readings()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", READERS)
def test_reader_is_none_where_the_parent_has_nothing_to_read(metric):
    """The parent's port has no batch stages, and an empty slice has no
    device time: each reader reads None and does not raise."""
    read = reader(metric)
    none = readings(stages={"jpeg quality search": 9.0},
                    trace=types.SimpleNamespace(window_s=5.0, busy_s=0.0,
                                                kernel_s=0.0, bound_s=0.0))
    assert read(none) is None
    assert read(readings(images=0, counters={"chunk_items": []},
                         trace=None)) is None
