"""The port's profiling surface against the JAX package's, on the CPU.

utils/profiling: StageTimer's report is the JAX one's string for the same
totals, the ambient `stage` records nothing without a timer and nothing
into another thread's, nan_check raises the JAX message on NaN and Inf in
tensors and arrays, and device_trace writes a Chrome trace on the CPU.
The CLI's -v prints a `Stages:` report with the JAX CLI's stage names and
the port's own sub-stages on the same file, and FENNEC_DEBUG_BATCH makes the batch engines print
their stage report and the traceback of a failed chunk.  The batch
engines record "batch prepare", "batch format", "prep", "device" and
"encode" on the caller's ambient timer, from its own thread, the prep
thread and the encode pool alike, and leave their counters as they were.
"""

import contextvars
import json
import threading

import numpy as np
import pytest
import torch

from conftest import make_noise_image
from fennec_tpu import cli as jcli
from fennec_tpu.exif import write_exif_orientation
from fennec_tpu.utils import profiling as jprof
import fennec_tpu_torch as T
from fennec_tpu_torch import cli as tcli
from fennec_tpu_torch.codecs.png import encode_png_rgba
from fennec_tpu_torch.engine import batched as tbatched
from fennec_tpu_torch.utils import profiling as tprof

CPU = "cpu"


@pytest.fixture(autouse=True)
def no_jax_compile_cache(monkeypatch):
    """The JAX CLI points jax's compile cache at the user's home; keep
    this test process on the suite's cache."""
    import fennec_tpu.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda *a, **k: None)


def photo(w, h, seed):
    img = make_noise_image(w, h, seed=seed).astype(np.int16)
    img[..., :3] = np.clip(img[..., :3] // 3 + 90, 0, 255)
    return img.astype(np.uint8)


# ── StageTimer, stage, use_timer ────────────────────────────────────────────


@pytest.mark.parametrize("totals,counts", [
    ({}, {}),
    ({"open + decode": 0.0123}, {"open + decode": 1}),
    ({"write": 0.0004, "jpeg quality search": 0.2567, "resize": 0.031},
     {"write": 1, "jpeg quality search": 1, "resize": 3}),
])
def test_report_is_the_jax_string(totals, counts):
    ours, theirs = tprof.StageTimer(), jprof.StageTimer()
    for t in (ours, theirs):
        t.totals.update(totals)
        t.counts.update(counts)
    assert ours.report() == theirs.report()


def test_stage_records_on_the_timer():
    timer = tprof.StageTimer()
    with tprof.use_timer(timer):
        for _ in range(3):
            with tprof.stage("resize"):
                pass
    with tprof.stage("resize"):  # no timer installed any more
        pass
    assert timer.counts == {"resize": 3}
    assert timer.report().startswith("resize ")


def test_stage_without_a_timer_does_nothing():
    with tprof.stage("orient"):
        value = 1
    assert value == 1 and tprof._active.get() is None


def test_threads_do_not_share_a_timer():
    """The ambient timer is per context: a thread started inside
    use_timer records nothing into it, and its own timer gets only its
    own stages."""
    mine, theirs = tprof.StageTimer(), tprof.StageTimer()
    ready, done = threading.Event(), threading.Event()

    def other():
        with tprof.stage("not mine"):
            pass
        with tprof.use_timer(theirs):
            ready.set()
            done.wait(timeout=30)
            with tprof.stage("theirs"):
                pass

    with tprof.use_timer(mine):
        t = threading.Thread(target=other)
        t.start()
        assert ready.wait(timeout=30)
        with tprof.stage("mine"):
            pass
        done.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert mine.counts == {"mine": 1}
    assert theirs.counts == {"theirs": 1}


def test_timer_survives_concurrent_stages():
    timer = tprof.StageTimer()

    def work():
        for _ in range(500):
            with timer.stage("encode"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert timer.counts == {"encode": 4000}


# ── nan_check, device_trace ─────────────────────────────────────────────────


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("kind", ["tensor", "array"])
def test_nan_check_raises_the_jax_message(bad, kind):
    good = np.ones((3, 4), np.float32)
    arr = good.copy()
    arr[1, 2] = bad
    arg = torch.from_numpy(arr) if kind == "tensor" else arr
    with pytest.raises(FloatingPointError) as ours:
        tprof.nan_check("probe", good, arg)
    with pytest.raises(FloatingPointError) as theirs:
        jprof.nan_check("probe", good, arr)
    assert str(ours.value) == str(theirs.value) == \
        "fennec: non-finite values in probe[1]"


def test_nan_check_passes_finite_values():
    tprof.nan_check("ok", torch.zeros(5), np.arange(4), [1.0, 2.0])


@pytest.mark.parametrize("log_dir", [None, ""])
def test_device_trace_without_a_directory_does_nothing(log_dir):
    with tprof.device_trace(log_dir):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    out = tmp_path / "trace"
    with tprof.device_trace(str(out)):
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    files = list(out.glob("trace.*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


# ── The CLI's -v and FENNEC_DEBUG_BATCH ─────────────────────────────────────


def stage_names(stderr: str):
    """The stage names of a `  Stages:` report (a name fills the first 24
    columns of its line)."""
    lines = stderr.splitlines()
    start = lines.index("  Stages:") + 1
    return sorted(line[:24].strip() for line in lines[start:]
                  if line.endswith("ms avg)"))


# The port's stages beyond the JAX CLI's: the decode's, the host passes'
# and the quality search's sub-stages.
DECODE_STAGES = ["blocks up", "huffman decode", "image down"]
PASS_STAGES = ["nrgba", "validate"]
SEARCH_STAGES = ["device search", "emit", "image up"]


@pytest.mark.parametrize("flags,want,more", [
    (["--max-width", "40"], ["jpeg quality search", "open + decode",
                             "orient", "resize", "write"],
     DECODE_STAGES + PASS_STAGES + SEARCH_STAGES),
    (["--format", "png"], ["open + decode", "orient", "png encode",
                           "write"], DECODE_STAGES + PASS_STAGES),
    (["--target-size", "3KB"], ["open + decode", "orient",
                                "target-size search", "write"],
     DECODE_STAGES + PASS_STAGES),
])
def test_cli_verbose_prints_the_jax_stages(tmp_path, capsys, flags, want,
                                           more):
    """The port's report names the JAX CLI's stages and the port's own
    sub-stages, nothing else."""
    data = T.encode_to_bytes(photo(64, 48, 5), T.JPEG, 92, device=CPU)
    src = tmp_path / "in.jpg"
    src.write_bytes(data[:2] + write_exif_orientation(6) + data[2:])
    assert jcli.main([str(src), str(tmp_path / "j.out"), "-v"] + flags) == 0
    jax_err = capsys.readouterr().err
    assert tcli.main([str(src), str(tmp_path / "t.out"), "-v", "--device",
                      "cpu"] + flags) == 0
    port_err = capsys.readouterr().err
    assert stage_names(jax_err) == want
    assert stage_names(port_err) == sorted(want + more)


def test_cli_without_verbose_prints_no_stages(tmp_path, capsys):
    src = tmp_path / "in.png"
    src.write_bytes(encode_png_rgba(photo(32, 24, 1)))
    assert tcli.main([str(src), str(tmp_path / "o.jpg"), "--device",
                      "cpu"]) == 0
    assert "Stages:" not in capsys.readouterr().err


def test_debug_batch_prints_a_stage_report(monkeypatch, capsys):
    imgs = [photo(40, 32, s) for s in range(3)]
    monkeypatch.setenv("FENNEC_DEBUG_BATCH", "1")
    tbatched.compress_images_batched(None, imgs, T.Options(format=T.JPEG),
                                     device=CPU)
    err = capsys.readouterr().err
    assert "fennec: pixel batch stage breakdown:" in err
    names = {line[:24].strip() for line in err.splitlines()
             if line.endswith("ms avg)")}
    assert names == {"prep", "device", "encode"}


def test_debug_batch_unset_prints_nothing(monkeypatch, capsys):
    monkeypatch.delenv("FENNEC_DEBUG_BATCH", raising=False)
    tbatched.compress_images_batched(None, [photo(40, 32, 1)] * 2,
                                     T.Options(format=T.JPEG), device=CPU)
    assert capsys.readouterr().err == ""


def test_debug_batch_prints_a_failed_chunks_traceback(monkeypatch, capsys):
    def broken(*args):
        raise torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered")

    monkeypatch.setenv("FENNEC_DEBUG_BATCH", "1")
    monkeypatch.setattr(tbatched, "batched_quality_search_quantize", broken)
    with pytest.raises(tbatched.FusedChunkError) as exc_info:
        tbatched.compress_images_batched(
            None, [photo(40, 32, s) for s in range(2)],
            T.Options(format=T.JPEG), device=CPU)
    assert exc_info.value.wedged
    err = capsys.readouterr().err
    assert "fennec: chunk marked failed:" in err
    assert "Traceback" in err and "in broken" in err
    assert "illegal memory access" in err


# ── The batch engines' stages on the caller's timer ─────────────────────────


class ThreadTimer(tprof.StageTimer):
    """A StageTimer that also notes the thread each stage ran on."""

    def __init__(self):
        super().__init__()
        self.threads = {}

    def stage(self, name):
        with self._lock:
            self.threads.setdefault(name, set()).add(
                threading.current_thread().name)
        return super().stage(name)


def rgb_images(n):
    return [photo(40, 32, s)[..., :3].copy() for s in range(n)]


def compress_five(chunk_size=2):
    """Five images in chunks of two: three chunks."""
    return tbatched.compress_images_batched(
        None, rgb_images(5), T.Options(format=T.JPEG), chunk_size=chunk_size,
        device=CPU)


def test_compress_images_records_its_stages_on_the_callers_timer():
    timer = ThreadTimer()
    with tprof.use_timer(timer):
        results = compress_five()
    assert len(results) == 5
    assert timer.counts == {"batch prepare": 1, "batch format": 1,
                            "prep": 3, "device": 3, "encode": 5}
    main = threading.current_thread().name
    for name in ("batch prepare", "batch format", "device"):
        assert timer.threads[name] == {main}, name
    assert main not in timer.threads["prep"]
    assert main not in timer.threads["encode"]


def test_compress_images_in_another_context_records_nothing():
    """The stages go to the ambient timer of the call's own context: a
    call made in a fresh context records nothing into the caller's."""
    timer = tprof.StageTimer()
    with tprof.use_timer(timer):
        results = contextvars.Context().run(compress_five)
    assert len(results) == 5 and timer.counts == {}
    assert tprof._active.get() is None


def test_the_timer_leaves_the_batch_counters_as_they_were():
    snaps = []
    for timer in (None, tprof.StageTimer()):
        tbatched.counters.reset()
        if timer is None:
            compress_five()
        else:
            with tprof.use_timer(timer):
                compress_five()
        snaps.append(tbatched.counters.snapshot())
    off, on = snaps
    for key in ("routes", "chunk_items", "uploaded_bytes", "events"):
        assert off[key] == on[key], key
    assert off["chunk_items"] == [2, 2, 1]
    assert set(off["stage_seconds"]) == set(on["stage_seconds"]) == {
        "prep", "device", "encode"}


def test_compress_batch_records_the_coefficient_pipelines_stages(tmp_path):
    datas = [T.encode_to_bytes(photo(48, 32, s), T.JPEG, 92, device=CPU)
             for s in range(4)]
    items = []
    for i, data in enumerate(datas):
        src = tmp_path / f"in{i}.jpg"
        src.write_bytes(data)
        items.append(T.BatchItem(src=str(src),
                                 dst=str(tmp_path / f"out{i}.jpg")))
    timer = ThreadTimer()
    tbatched.counters.reset()
    with tprof.use_timer(timer):
        res = T.compress_batch(None, items, T.BatchOptions(
            fused=True, default_opts=T.Options(format=T.JPEG)), device=CPU)
    assert all(r.err is None for r in res)
    snap = tbatched.counters.snapshot()
    assert snap["routes"] == {"coefficient": 4}
    chunks = len(snap["chunk_items"])
    assert timer.counts == {"prep": chunks, "device": chunks, "encode": 4}
    assert threading.current_thread().name not in timer.threads["encode"]


def test_a_profiler_sees_the_batch_stages_on_their_threads():
    """A profiler that traces every thread holds each stage as a host
    range on the thread that ran it."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        compress_five()
    threads = {}
    for e in prof.events():
        threads.setdefault(e.name, set()).add(e.thread)
    for name in ("batch prepare", "batch format", "prep", "device",
                 "encode"):
        assert name in threads, name
    assert threads["prep"].isdisjoint(threads["batch prepare"])
    assert threads["encode"].isdisjoint(threads["batch prepare"])
