"""Target-size mode of the PyTorch port against the JAX package, on the
CPU.

hit_target_size runs on the JAX tests' images and targets, chosen so that
each of S1, S2, S3, S4 and the fallback wins at least once: the port
must give the same format, JPEG quality and output geometry, SSIM within
1e-4, and the same bytes or the JAX package's own equivalence contract
(tests/test_targetsize_batched.py:28-42: a Lanczos resize may round one
pixel tie differently, which moves the entropy-coded size by a few
bytes).  The JAX results are computed once per module.

The lockstep engine is held to the port's per-image engine under the
same contract, and the routing of compress_images / compress_batch /
the CLI to the reference's overshoot bound.  Two faults of the JAX
lockstep engine are fixed in the port and pinned here: the context is
checked before every bisection round, and FENNEC_TS_SPEC is clamped.
"""

import os

import numpy as np
import pytest
import torch

from conftest import (
    make_noise_image,
    make_test_image,
    make_test_image_with_alpha,
)
import fennec_tpu as J
import fennec_tpu_torch as T
from fennec_tpu.engine.targetsize import hit_target_size as jax_hit
from fennec_tpu.engine.targetsize import probe_geometry as jax_probe_geom
from fennec_tpu.ops.ssim import compute_ssim_nrgba as jax_compute_ssim
from fennec_tpu.ops.ssim import pixel_ssim as jax_pixel_ssim
from fennec_tpu.ops.ssim import ssim_fast as jax_ssim_fast
from fennec_tpu_torch import cli as tcli
from fennec_tpu_torch.codecs.png import encode_png_rgba
from fennec_tpu_torch.engine import batched as tbatched
from fennec_tpu_torch.engine import targetsize as tts
from fennec_tpu_torch.engine import targetsize_batched as ttsb
from fennec_tpu_torch.image import to_nrgba
from fennec_tpu_torch.ops import resize as tresize
from fennec_tpu_torch.ops import ssim as tssim
from test_torch_slice import photo_image

torch.set_num_threads(1)

SSIM_ATOL = 1e-4
CPU = torch.device("cpu")


def photo(w, h, seed):
    """tests/test_targetsize_batched.py's generator."""
    rng = np.random.default_rng(seed)
    img = make_noise_image(w, h, seed=seed).astype(np.int16)
    img[..., :3] = np.clip(img[..., :3] // 3 + 80 + rng.integers(-5, 5),
                           0, 255)
    img[..., 3] = 255
    return img.astype(np.uint8)


def assert_equivalent(got, want, target):
    """tests/test_targetsize_batched.py:28-42, with SSIM within 1e-4."""
    assert got.format == want.format
    assert got.quality == want.quality
    assert (got.final_w, got.final_h) == (want.final_w, want.final_h)
    assert got.ssim == pytest.approx(want.ssim, abs=SSIM_ATOL)
    if got.data != want.data:
        assert abs(len(got.data) - len(want.data)) <= 8
        assert (len(got.data) <= target) == (len(want.data) <= target)


# name → (image, target bytes, format, the strategy that wins)
CASES = {
    "s1_photo_jpeg": (lambda: photo_image(120, 90, seed=3), 3000, "JPEG",
                      "s1"),
    "s3_grad_auto": (lambda: make_test_image(80, 64), 2000, "AUTO", "s3"),
    "s2_alpha_auto": (lambda: make_test_image_with_alpha(64, 64), 3000,
                      "AUTO", "s2"),
    "s3_noise_jpeg": (lambda: make_noise_image(120, 90, 3), 1200, "JPEG",
                      "s3"),
    "s3_photo_jpeg": (lambda: photo(96, 80, 1), 2500, "JPEG", "s3"),
    "s4_alpha_png": (lambda: make_test_image_with_alpha(96, 96), 300, "PNG",
                     "s4"),
    "fallback_jpeg": (lambda: photo(64, 64, 0), 50, "JPEG", "fallback"),
}


def strategy_of(r, w, h, target):
    """Which strategy produced a SizeResult, from what it looks like."""
    if r.format == J.JPEG and r.quality == 1 and r.ssim == 1.0:
        return "fallback"
    if (r.final_w, r.final_h) != (w, h):
        return "s3" if r.format == J.JPEG else "s4"
    if r.format == J.JPEG:
        return "s1"
    return "s2" if len(r.data) <= target else "fallback"


@pytest.fixture(scope="module")
def jax_results():
    cache = {}

    def get(name):
        if name not in cache:
            make, target, fmt, _ = CASES[name]
            img = make()
            opts = J.Options(format=getattr(J, fmt), target_size=target)
            cache[name] = (img, jax_hit(None, img, target, opts))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_hit_target_size_matches_jax(jax_results, name):
    _, target, fmt, strategy = CASES[name]
    img, want = jax_results(name)
    got = tts.hit_target_size(
        None, img, target, T.Options(format=getattr(T, fmt),
                                     target_size=target), device="cpu")
    assert_equivalent(got, want, target)
    h, w = img.shape[:2]
    assert strategy_of(got, w, h, target) == strategy
    if strategy != "fallback":
        assert len(got.data) <= target
    if got.img is not None:
        assert got.img.shape[:2] == (got.final_h, got.final_w)


def test_every_strategy_wins_once():
    assert {c[3] for c in CASES.values()} == {"s1", "s2", "s3", "s4",
                                              "fallback"}


def test_s1_is_maximal_at_source_geometry(jax_results):
    """The S1 winner's quality is the highest that fits: q + 1 overshoots
    (the same check chip_smoke.py makes on the card)."""
    img, want = jax_results("s1_photo_jpeg")
    target = CASES["s1_photo_jpeg"][1]
    sizer = tts._JpegSizer(img, CPU)
    assert len(sizer.encode(want.quality)) <= target
    assert len(sizer.encode(want.quality + 1)) > target


# ── Probe lattice and the scale prober (tests/test_targetsize_batched.py:
#    170-216) ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("w,h", [(500, 500), (1920, 1080), (37, 23),
                                 (16, 16)])
def test_probe_lattice(w, h):
    lattice = tts.PROBE_LATTICE
    geoms = set()
    for k in range(1, 200):
        scale = 0.05 + (k / 200) * 0.95
        nw, nh = tts.probe_geometry(w, h, int(w * scale), int(h * scale))
        assert (nw, nh) == jax_probe_geom(w, h, int(w * scale),
                                          int(h * scale))
        assert nw % lattice == 0 or nw == w
        assert nh % lattice == 0 or nh == h
        assert lattice <= nw <= max(w, lattice)
        assert lattice <= nh <= max(h, lattice)
        geoms.add((nw, nh))
    assert len({g[0] for g in geoms}) <= w // lattice + 1
    assert len({g[1] for g in geoms}) <= h // lattice + 1


def test_probe_snap_is_monotone():
    prev = 0
    for nw in range(8, 500, 7):
        got, _ = tts.probe_geometry(500, 500, nw, nw)
        assert got >= prev
        prev = got


def test_prober_memoizes(monkeypatch):
    calls = []
    real = tts.box_probe

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tts, "box_probe", spy)
    prober = tts._ScaleProber(photo(64, 64, 3), CPU)
    r1 = prober.probe(33, 33, 1500)
    r2 = prober.probe(37, 37, 1500)  # the same lattice point (32, 32)
    assert r1 == r2
    assert len(calls) == 1


# ── SSIMFast on host images ─────────────────────────────────────────────────


@pytest.mark.parametrize("w,h", [(700, 300), (160, 120), (7, 20), (8, 40),
                                 (600, 4)])
def test_ssim_fast_and_pixel_ssim_match_jax(w, h):
    a = make_test_image(w, h)
    rng = np.random.default_rng(w)
    b = np.clip(a.astype(np.int32) + rng.integers(-25, 25, a.shape), 0,
                255).astype(np.uint8)
    b[..., 3] = 255
    assert T.ssim_fast(a, b, device="cpu") == pytest.approx(
        jax_ssim_fast(a, b), abs=SSIM_ATOL)
    assert T.pixel_ssim(a, b, device="cpu") == pytest.approx(
        jax_pixel_ssim(a, b), abs=SSIM_ATOL)


def test_compute_ssim_nrgba_resizes_like_jax():
    a = photo_image(300, 200, seed=1)
    small = photo_image(150, 100, seed=2)
    assert tssim.compute_ssim_nrgba(a, small, device="cpu") == \
        pytest.approx(jax_compute_ssim(a, small), abs=SSIM_ATOL)


def test_weights_are_cached_per_geometry():
    a = tresize.lanczos_weights_device(300, 200, 150, 100, CPU)
    assert tresize.lanczos_weights_device(300, 200, 150, 100, CPU) is a
    b = tresize.box_weights_device(300, 200, 150, 100, CPU)
    assert b is not a and not torch.equal(a[0], b[0])


def test_box_downsample_matches_jax():
    from fennec_tpu.ops.resize import box_downsample as jax_box

    img = make_noise_image(130, 75, seed=4)
    np.testing.assert_array_equal(tresize.box_downsample(img, 61, 33, CPU),
                                  jax_box(img, 61, 33))


# ── The lockstep engine against the per-image engine ───────────────────────


BUCKETS = {
    "divergence": (lambda: [make_test_image(120, 90),
                            make_noise_image(120, 90, 3),
                            photo(120, 90, 11)], 1200, "JPEG"),
    "mixed_alpha": (lambda: [make_test_image_with_alpha(64, 64),
                             photo(64, 64, 5)], 3000, "AUTO"),
    "fallback": (lambda: [photo(64, 64, s) for s in range(2)], 50, "JPEG"),
    "jpeg": (lambda: [photo(96, 80, s) for s in range(4)], 2500, "JPEG"),
}


def run_bucket(name):
    make, target, fmt = BUCKETS[name]
    imgs = [to_nrgba(im) for im in make()]
    opts = T.Options(format=getattr(T, fmt), target_size=target)
    return imgs, target, opts, ttsb.hit_target_size_batched(
        None, imgs, target, opts, device="cpu")


@pytest.mark.parametrize("name", list(BUCKETS))
def test_batched_matches_per_image(name):
    imgs, target, opts, got = run_bucket(name)
    for img, g in zip(imgs, got):
        want = tts.hit_target_size(None, img, target, opts, device="cpu")
        assert_equivalent(g, want, target)
        assert g.img is not None


def test_spec_depth_changes_no_result(monkeypatch):
    """FENNEC_TS_SPEC only changes how far each wave measures ahead."""
    results, waves = [], []
    for spec in ("0", "1", "3"):
        monkeypatch.setenv("FENNEC_TS_SPEC", spec)
        tbatched.counters.reset()
        _, target, _, got = run_bucket("divergence")
        results.append([(r.format, r.quality, r.final_w, r.final_h, r.data,
                         r.ssim) for r in got])
        waves.append(tbatched.counters.snapshot()["events"]["ts_waves"])
    assert results[0] == results[1] == results[2]
    assert waves[0] > waves[1] >= waves[2]


@pytest.mark.parametrize("raw,want", [("99", 3), ("3", 3), ("0", 0),
                                      ("-4", 0), (None, 1)])
def test_spec_is_clamped(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("FENNEC_TS_SPEC", raising=False)
    else:
        monkeypatch.setenv("FENNEC_TS_SPEC", raw)
    assert ttsb.ts_spec() == want


class CancelAfter(T.Context):
    """A context that reports done from its (n+1)-th done() call on."""

    def __init__(self, n):
        super().__init__()
        self.n = n
        self.calls = 0

    def done(self):
        self.calls += 1
        return self.calls > self.n


@pytest.mark.parametrize("n", [1, 2])
def test_context_checked_every_round(monkeypatch, n):
    """With three levels of speculation a wave covers four rounds; the
    JAX engine would run all four after one check, the port stops at the
    next round and skips the fixed grid and the final groups."""
    import concurrent.futures

    monkeypatch.setenv("FENNEC_TS_SPEC", "3")
    imgs = [to_nrgba(im) for im in BUCKETS["divergence"][0]()]
    stack = torch.from_numpy(np.stack(imgs))
    tbatched.counters.reset()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        out = ttsb._s3_batched(CancelAfter(n), pool, stack, imgs, 90, 120,
                               1200, [0, 1, 2])
    events = tbatched.counters.snapshot()["events"]
    assert events["ts_s3_rounds"] == n
    assert out == [None, None, None]


# ── Routing: compress_images, compress_batch, the CLI ──────────────────────


@pytest.fixture(autouse=True)
def fresh_counters():
    tbatched.counters.reset()
    yield


def test_compress_images_routes_buckets():
    imgs = [photo(96, 80, s) for s in range(4)] + [photo(48, 48, 9)]
    target = 2200
    opts = T.Options(format=T.JPEG, target_size=target)
    chunks = []
    out = T.compress_images(None, imgs, opts, device="cpu")
    tbatched.compress_images_batched(None, imgs[:2], opts, device="cpu",
                                     on_chunk=chunks.append, chunk_size=1)
    assert tbatched.counters.snapshot()["routes"] == {"target-size": 7}
    assert [[i for i, _ in c] for c in chunks] == [[0], [1]]
    for img, r in zip(imgs, out):
        want = T.compress_image(None, img, opts, device="cpu")
        assert (r.format, r.jpeg_quality, r.final_dimensions) == (
            want.format, want.jpeg_quality, want.final_dimensions)
        if r.compressed_data != want.compressed_data:
            assert abs(r.compressed_size - want.compressed_size) <= 8
        assert r.compressed_size <= 2 * target
        assert r.ssim == pytest.approx(want.ssim, abs=SSIM_ATOL)


def test_compress_images_resize_then_target():
    out = T.compress_images(None, [photo(128, 96, 1), photo(128, 96, 2)],
                            T.Options(format=T.JPEG, target_size=2000,
                                      max_width=64), device="cpu")
    for r in out:
        assert r.final_dimensions[0] <= 64
        assert 0 < r.compressed_size <= 4000


def test_cancelled_context_raises():
    ctx = T.Context()
    ctx.cancel()
    with pytest.raises(T.CanceledError):
        T.compress_images(ctx, [photo(32, 32, 1), photo(32, 32, 2)],
                          T.Options(format=T.JPEG, target_size=1000),
                          device="cpu")


def oom_above(real, limit, calls):
    """A target-size engine that runs out of memory above `limit`
    images."""
    def fn(ctx, images, *args):
        calls.append(len(images) if isinstance(images, list) else 1)
        if calls[-1] > limit:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(ctx, images, *args)
    return fn


def test_oom_retries_at_half_chunk(monkeypatch):
    imgs = [photo(48, 48, s) for s in range(5)]
    opts = T.Options(format=T.JPEG, target_size=1500)
    want = T.compress_images(None, imgs, opts, device="cpu")
    calls = []
    monkeypatch.setattr(ttsb, "hit_target_size_batched",
                        oom_above(ttsb.hit_target_size_batched, 2, calls))
    tbatched.counters.reset()
    got = T.compress_images(None, imgs, opts, device="cpu")
    # 5 → 2 + 3 → 2 + (1 + 2); a chunk of one takes the per-image engine.
    assert calls == [5, 2, 3, 2]
    assert tbatched.counters.snapshot()["chunk_items"] == [2, 1, 2]
    assert [r.compressed_data for r in got] == \
        [r.compressed_data for r in want]


def test_oom_of_one_image_fails_only_it(monkeypatch):
    calls = []
    monkeypatch.setattr(ttsb, "hit_target_size_batched",
                        oom_above(ttsb.hit_target_size_batched, 0, calls))
    monkeypatch.setattr(tts, "hit_target_size",
                        oom_above(tts.hit_target_size, 0, calls))
    imgs = [photo(32, 32, 1), photo(32, 32, 2), photo(40, 40, 3)]
    errors, finished = {}, []
    with pytest.raises(tbatched.FusedChunkError) as exc_info:
        tbatched.compress_images_batched(
            None, imgs, T.Options(format=T.JPEG, target_size=900),
            device="cpu", on_error=errors.__setitem__,
            on_chunk=finished.extend)
    assert calls == [2, 1, 1, 1]
    assert sorted(errors) == [0, 1, 2] and not exc_info.value.wedged
    assert not finished
    assert all(isinstance(e, torch.cuda.OutOfMemoryError)
               for e in errors.values())


def test_sticky_cuda_error_wedges_the_batch(monkeypatch):
    """A sticky CUDA error in the second chunk: the first chunk's items
    finish, every other item fails with it, and no later chunk runs."""
    real, calls = ttsb.hit_target_size_batched, []

    def fn(ctx, images, *args):
        calls.append(len(images))
        if len(calls) == 2:
            raise torch.AcceleratorError(
                "CUDA error: an illegal memory access was encountered")
        return real(ctx, images, *args)

    monkeypatch.setattr(ttsb, "hit_target_size_batched", fn)
    imgs = [photo(32, 32, s) for s in range(6)]
    errors, finished = {}, []
    with pytest.raises(tbatched.FusedChunkError) as exc_info:
        tbatched.compress_images_batched(
            None, imgs, T.Options(format=T.JPEG, target_size=900),
            device="cpu", chunk_size=2, on_error=errors.__setitem__,
            on_chunk=finished.extend)
    assert exc_info.value.wedged and calls == [2, 2]
    assert sorted(i for i, _ in finished) == [0, 1]
    assert sorted(errors) == [2, 3, 4, 5]


def test_compress_batch_overshoot_bound(tmp_path):
    items = []
    for i in range(8):
        p = tmp_path / f"in_{i}.png"
        p.write_bytes(encode_png_rgba(photo(80, 64, i)))
        items.append(T.BatchItem(src=str(p), dst=str(tmp_path / f"o{i}.jpg")))
    target = 2000
    res = T.compress_batch(None, items, T.BatchOptions(
        default_opts=T.Options(format=T.JPEG, target_size=target)),
        device="cpu")
    assert T.summarize(res).succeeded == 8
    assert tbatched.counters.snapshot()["routes"] == {"target-size": 8}
    for r in res:
        assert r.err is None
        data = open(r.item.dst, "rb").read()
        assert data == r.result.compressed_data
        # ≤2× overshoot (reference fennec_test.go:284-298)
        assert 0 < r.result.compressed_size <= 2 * target


def test_compress_batch_jpeg_files_take_pixel_path(tmp_path):
    """Target-size JPEG files skip the coefficient path (JAX
    batch.py:224) and give compress_file's result."""
    items = []
    for i in range(8):
        p = tmp_path / f"in_{i}.jpg"
        p.write_bytes(T.encode_to_bytes(photo(64, 48, i), T.JPEG, 95,
                                        device="cpu"))
        items.append(T.BatchItem(src=str(p), dst=str(tmp_path / f"o{i}.jpg")))
    opts = T.Options(format=T.JPEG, target_size=1500)
    res = T.compress_batch(None, items, T.BatchOptions(default_opts=opts),
                           device="cpu")
    assert tbatched.counters.snapshot()["routes"] == {"target-size": 8}
    want = T.compress_file(None, items[3].src, str(tmp_path / "one.jpg"),
                           opts, device="cpu")
    assert res[3].result.jpeg_quality == want.jpeg_quality
    assert res[3].result.final_dimensions == want.final_dimensions


def test_cli_target_size(tmp_path, capsys):
    src = tmp_path / "in.png"
    src.write_bytes(encode_png_rgba(photo_image(160, 120, seed=2)))
    out = tmp_path / "out.jpg"
    rc = tcli.main(["--target-size", "3KB", "--format", "jpeg", "--device",
                    "cpu", str(src), str(out)])
    assert rc == 0
    assert 0 < os.path.getsize(out) <= 3 * 1024
    assert "JPEG" in capsys.readouterr().out


def test_target_size_needs_the_named_device(monkeypatch):
    """No device named → CUDA; without a card it raises, no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.compress_image(None, photo(32, 32, 1), T.Options(target_size=900))
