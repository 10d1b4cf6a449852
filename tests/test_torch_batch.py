"""The batch engines and compress_batch of the PyTorch port against the
JAX package, on the CPU.

Pixel path (compress_images): against the JAX package's
compress_images_batched with device entropy off (its CPU default), the
same quality, SSIM within 1e-5 and the same bytes except at forward-DCT
rounding ties (tests/test_torch_slice.py explains them; the JAX package's
pixel batch on the CPU uploads RGB too, engine/batched.py:92-102).
Inside the port, a batch gives each image the bytes compress_image gives
it.

Coefficient path (compress_jpeg_bytes_batched): held to the JAX
package's contract for it (tests/test_coef_fastpath.py:60-97), against
both the JAX function and the port's own compress_bytes: the same
quality, SSIM within 1e-5 (1e-4 with max_width), size within 16 bytes,
decoded pixels within 3 levels.

compress_batch follows tests/test_fused_batch.py; the fault-isolation
cases replace the chunk's device function to inject an out-of-memory or
a sticky CUDA error and require that no item is lost.
"""

import io
import os
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from conftest import make_noise_image, make_test_image_with_alpha
import fennec_tpu as J
import fennec_tpu_torch as T
from fennec_tpu.engine import batched as jbatched
from fennec_tpu_torch.codecs import jpeg as tjpeg
from fennec_tpu_torch.codecs.png import encode_png_rgba
from fennec_tpu_torch.engine import batched as tbatched
from fennec_tpu_torch.ops import dct as tdct
from fennec_tpu_torch.ops.ssim_cuda import ssim_window
from test_multiscan import build_multiscan_jpeg
from test_torch_slice import tie_coefficients

torch.set_num_threads(1)

SSIM_ATOL = 1e-5
RESIZE_SSIM_ATOL = 1e-4
SIZE_ATOL = 16
PIXEL_ATOL = 3
CPU = "cpu"


def photo(w, h, seed):
    """Noisy but compressible: the tests/test_fused_batch.py generator."""
    rng = np.random.default_rng(seed)
    img = make_noise_image(w, h, seed=seed).astype(np.int16)
    img[..., :3] = np.clip(img[..., :3] // 3 + 80 + rng.integers(-5, 5),
                           0, 255)
    img[..., 3] = 255
    return img.astype(np.uint8)


def jpeg_bytes(w, h, seed, quality=92, subsample=True):
    return J.codecs.jpeg.encode_jpeg(photo(w, h, seed), quality,
                                     subsample=subsample)


@pytest.fixture(autouse=True)
def fresh_counters():
    tbatched.counters.reset()
    yield


# ── Pixel path ──────────────────────────────────────────────────────────────


def pixel_images():
    imgs = [photo(64, 48, s) for s in range(4)] + [photo(32, 32, 7)]
    alpha = make_test_image_with_alpha(64, 48)
    alpha[..., 3] = np.maximum(alpha[..., 3], 40)
    return imgs + [alpha]


def test_pixel_batch_matches_jax():
    imgs = pixel_images()
    rj = jbatched.compress_images_batched(
        None, imgs, J.Options(format=J.JPEG, device_entropy=False))
    rt = T.compress_images(None, imgs, T.Options(format=T.JPEG),
                           device=CPU)
    for img, a, b in zip(imgs, rj, rt):
        assert b.format == a.format == T.JPEG
        assert b.jpeg_quality == a.jpeg_quality
        assert abs(b.ssim - a.ssim) <= SSIM_ATOL
        assert b.final_dimensions == a.final_dimensions
        if b.compressed_data != a.compressed_data:
            ties = tie_coefficients(a.compressed_data, b.compressed_data,
                                    img, a.jpeg_quality, True)
            assert 0 < len(ties) <= 8, ties


@pytest.mark.parametrize("kw", [
    {"format": 1}, {}, {"format": 1, "max_width": 40},
    {"format": 1, "subsample": False},
    {"format": 1, "optimize_huffman": False, "quality": 2},
], ids=["jpeg", "auto", "resize", "444", "std-tables-ultra"])
def test_pixel_batch_matches_per_image(kw):
    imgs = pixel_images() + [make_noise_image(48, 48, seed=3)]
    batch = T.compress_images(None, imgs, T.Options(**kw), device=CPU)
    for img, got in zip(imgs, batch):
        want = T.compress_image(None, img, T.Options(**kw), device=CPU)
        assert got.format == want.format
        assert got.jpeg_quality == want.jpeg_quality
        assert got.ssim == want.ssim
        assert got.final_dimensions == want.final_dimensions
        assert got.compressed_data == want.compressed_data


def test_chunk_size_does_not_change_bytes():
    imgs = [photo(48, 48, s) for s in range(5)]
    opts = T.Options(format=T.JPEG)
    whole = tbatched.compress_images_batched(None, imgs, opts, device=CPU)
    pairs = []
    split = tbatched.compress_images_batched(
        None, imgs, opts, device=CPU, chunk_size=2, on_chunk=pairs.extend)
    assert tbatched.counters.snapshot()["chunk_items"][-3:] == [2, 2, 1]
    assert sorted(i for i, _ in pairs) == list(range(5))
    assert [r.compressed_data for r in split] == \
        [r.compressed_data for r in whole]


def test_auto_routing_and_png_stream_first():
    imgs = [make_test_image_with_alpha(40, 40), make_noise_image(64, 64, 9),
            np.full((32, 32, 4), 200, np.uint8)]
    groups = []
    out = tbatched.compress_images_batched(None, imgs, T.Options(),
                                           device=CPU, on_chunk=groups.append)
    assert [r.format for r in out] == [T.PNG, T.JPEG, T.PNG]
    assert [i for i, _ in groups[0]] == [0, 2]
    assert tbatched.counters.snapshot()["routes"] == {"png": 2, "pixel": 1}


def test_empty_and_unported_options():
    assert T.compress_images(None, [], T.Options(), device=CPU) == []
    # Target-size mode runs (tests/test_torch_targetsize.py): one image
    # takes the per-image engine and gives compress_image's result.
    opts = T.Options(format=T.JPEG, target_size=1000)
    got = T.compress_images(None, [photo(40, 40, 1)], opts, device=CPU)[0]
    want = T.compress_image(None, photo(40, 40, 1), opts, device=CPU)
    assert got.compressed_data == want.compressed_data
    assert got.compressed_size <= 1000
    # device_entropy=True, once refused, codes on the device (K3's plain
    # version on the CPU) and writes the host encoder's bytes.
    on, off = (T.compress_images(None, [photo(16, 16, 1)],
                                 T.Options(format=T.JPEG,
                                           device_entropy=setting),
                                 device=CPU)[0].compressed_data
               for setting in (True, False))
    assert on == off


def test_workers_passthrough():
    imgs = [photo(48, 48, s) for s in range(3)]
    opts = T.Options(format=T.JPEG)
    base = T.compress_images(None, imgs, opts, device=CPU)
    narrow = T.compress_images(None, imgs, opts, workers=1, device=CPU)
    assert [r.compressed_data for r in base] == \
        [r.compressed_data for r in narrow]


@pytest.mark.parametrize("n", [1, 3, 72])
def test_block_transform_rows_do_not_depend_on_batch(n):
    """A block's DCT is the same alone and inside any batch (the GEMM row
    padding of ops/dct.py; a product of one row takes another path)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(0, 60, (5, n, 64)).astype(np.float32))
    batched = tdct.dct2d_blocks(x)
    for i in range(5):
        assert torch.equal(tdct.dct2d_blocks(x[i]), batched[i])
        assert torch.equal(tdct.idct2d_blocks(x[i]),
                           tdct.idct2d_blocks(x)[i])


def test_an_input_without_alpha_goes_up_as_rgb():
    """An RGB input's chunk goes up as RGB, and its results are those of
    the same pixels given as opaque RGBA."""
    rgba = [photo(40, 32, s) for s in range(3)]
    rgb = [x[..., :3].copy() for x in rgba]
    opts = T.Options(format=T.JPEG)
    tbatched.counters.reset()
    want = tbatched.compress_images_batched(None, rgba, opts, device=CPU)
    assert tbatched.counters.snapshot()["uploaded_bytes"] == 3 * 32 * 40 * 3
    tbatched.counters.reset()
    got = tbatched.compress_images_batched(None, rgb, opts, device=CPU)
    assert tbatched.counters.snapshot()["uploaded_bytes"] == 3 * 32 * 40 * 3
    for g, w in zip(got, want):
        assert g.compressed_data == w.compressed_data
        assert np.array_equal(g.image, w.image)


def test_a_transparent_input_goes_up_with_its_alpha():
    imgs = [photo(40, 32, s)[..., :3].copy() for s in range(2)]
    clear = photo(40, 32, 7)
    clear[:4, :4, 3] = 0
    tbatched.counters.reset()
    res = tbatched.compress_images_batched(None, imgs + [clear],
                                           T.Options(format=T.JPEG),
                                           device=CPU)
    assert len(res) == 3
    assert tbatched.counters.snapshot()["uploaded_bytes"] == 3 * 32 * 40 * 4


# ── Coefficient path ────────────────────────────────────────────────────────


def decoded(data):
    return T.codecs.decode_image(data, device=CPU).astype(int)


@pytest.mark.parametrize("kw,subsample", [
    ({}, True), ({"max_width": 32}, True), ({}, False),
    ({"optimize_huffman": False, "subsample": False}, True),
], ids=["420", "resize", "444-input", "444-output-std-tables"])
def test_coefficient_batch_contract(kw, subsample):
    datas = [jpeg_bytes(64, 48, s, subsample=subsample) for s in range(3)]
    atol = RESIZE_SSIM_ATOL if "max_width" in kw else SSIM_ATOL
    rt = tbatched.compress_jpeg_bytes_batched(
        None, datas, T.Options(format=T.JPEG, **kw), device=CPU)
    rj = jbatched.compress_jpeg_bytes_batched(
        None, datas, J.Options(format=J.JPEG, **kw))
    assert rt is not None and rj is not None
    for data, got, jax_r in zip(datas, rt, rj):
        one = T.compress_bytes(None, data, T.Options(format=T.JPEG, **kw),
                               device=CPU)
        for want in (jax_r, one):
            assert got.final_dimensions == want.final_dimensions
            assert got.jpeg_quality == want.jpeg_quality
            assert abs(got.ssim - want.ssim) <= atol
            assert abs(got.compressed_size - want.compressed_size) \
                <= SIZE_ATOL
            assert np.abs(decoded(got.compressed_data)
                          - decoded(want.compressed_data)).max() \
                <= PIXEL_ATOL
        assert got.image is None
    assert tbatched.counters.snapshot()["routes"] == {"coefficient": 3}


def adobe_rgb_jpeg():
    """A 3-component baseline file whose Adobe APP14 marker says RGB
    (transform 0) instead of the JFIF APP0 that forces YCbCr."""
    data = jpeg_bytes(48, 32, 5)
    app0_len = int.from_bytes(data[4:6], "big")
    adobe = (b"\xff\xee\x00\x0eAdobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
    return data[:2] + adobe + data[4 + app0_len:]


def pil_jpeg(img, **kw):
    from PIL import Image

    buf = io.BytesIO()
    mode = "L" if img.ndim == 2 else "RGB"
    Image.fromarray(img if img.ndim == 2 else img[..., :3], mode).save(
        buf, "JPEG", **kw)
    return buf.getvalue()


QUALIFY_INPUTS = {
    "420": lambda: jpeg_bytes(40, 24, 1),
    "444": lambda: jpeg_bytes(40, 24, 1, subsample=False),
    "422": lambda: pil_jpeg(photo(40, 24, 2), subsampling=1),
    "gray": lambda: pil_jpeg(photo(40, 24, 3)[..., 0]),
    "progressive": lambda: pil_jpeg(photo(40, 24, 4), progressive=True),
    "multiscan": lambda: build_multiscan_jpeg(photo(40, 24, 5)),
    "png": lambda: encode_png_rgba(photo(40, 24, 6)),
    "garbage": lambda: b"\xff\xd8\xff\xdbgarbage-not-a-real-jpeg",
    "truncated": lambda: jpeg_bytes(40, 24, 7)[:300],
}


@pytest.mark.parametrize("name", sorted(QUALIFY_INPUTS))
def test_qualify_routes_like_jax(name):
    data = QUALIFY_INPUTS[name]()
    assert tbatched.qualify_jpeg_bytes(data) == \
        jbatched.qualify_jpeg_bytes(data)


def test_qualify_keeps_adobe_rgb_off_the_coefficient_path():
    """The JAX package sends an Adobe RGB file down its coefficient path,
    which reconstructs every file as YCbCr: its colours then differ from
    the JAX package's own per-image decode.  The port's qualify refuses
    it, so the file takes the pixel path and its decode."""
    data = adobe_rgb_jpeg()
    assert tjpeg.jpeg_color_mode(tjpeg.parse_jpeg(data)) == "rgb"
    assert jbatched.qualify_jpeg_bytes(data) == (48, 32, True)
    assert tbatched.qualify_jpeg_bytes(data) is None
    opts = J.Options(format=J.JPEG)
    via_coefs = jbatched.compress_jpeg_bytes_batched(None, [data], opts)[0]
    per_image = J.compress_bytes(None, data, opts)
    assert np.abs(decoded(via_coefs.compressed_data)
                  - decoded(per_image.compressed_data)).max() > 50


def test_coefficient_path_refusals():
    opts = T.Options(format=T.JPEG)
    png = [encode_png_rgba(photo(32, 32, 1))]
    assert tbatched.compress_jpeg_bytes_batched(None, png, opts,
                                                device=CPU) is None
    assert tbatched.compress_jpeg_bytes_batched(
        None, [jpeg_bytes(32, 32, 1)], T.Options(), device=CPU) is None
    assert tbatched.compress_jpeg_bytes_batched(
        None, [jpeg_bytes(32, 32, 1), jpeg_bytes(48, 32, 2)], opts,
        device=CPU) is None
    assert tbatched.compress_jpeg_bytes_batched(None, [], opts,
                                                device=CPU) == []


def test_coefficient_load_image_decodes_on_demand():
    rs = tbatched.compress_jpeg_bytes_batched(
        None, [jpeg_bytes(40, 32, 3)], T.Options(format=T.JPEG), device=CPU)
    assert rs[0].image is None
    img = rs[0].load_image(device=CPU)
    assert img.shape == (32, 40, 4) and img.dtype == np.uint8
    assert rs[0].image is img


def test_corrupt_scan_fails_alone():
    """A file whose header qualifies but whose scan is corrupt fails
    alone; the rest of its chunk still compresses."""
    good = [jpeg_bytes(48, 48, s) for s in range(3)]
    hdr = tjpeg.parse_jpeg(good[0])
    bad = good[0][:hdr.scan_offset] + b"\xfe" * 300 + b"\xff\xd9"
    errors = {}
    with pytest.raises(tbatched.FusedChunkError) as exc_info:
        tbatched.compress_jpeg_bytes_batched(
            None, [good[0], bad, good[1], good[2]],
            T.Options(format=T.JPEG), device=CPU,
            on_error=errors.__setitem__)
    assert list(errors) == [1] and exc_info.value.failed_ids == [1]
    assert not exc_info.value.wedged
    assert isinstance(errors[1], ValueError)
    assert tbatched.counters.snapshot()["routes"] == {"coefficient": 3}


# ── compress_batch ──────────────────────────────────────────────────────────


def write_files(tmp_path, datas, ext=".jpg", tag="f"):
    items = []
    for i, data in enumerate(datas):
        src = tmp_path / f"{tag}{i}{ext}"
        src.write_bytes(data)
        items.append(T.BatchItem(src=str(src),
                                 dst=str(tmp_path / f"{tag}{i}.out.jpg")))
    return items


def test_fused_matches_pool_and_jax(tmp_path):
    pngs = [encode_png_rgba(photo(48, 48, i)) for i in range(8)]
    opts = T.Options(format=T.JPEG)
    fused = T.compress_batch(None, write_files(tmp_path, pngs, ".png", "a"),
                             T.BatchOptions(default_opts=opts, fused=True),
                             device=CPU)
    assert tbatched.counters.snapshot()["routes"] == {"pixel": 8}
    pooled = T.compress_batch(None, write_files(tmp_path, pngs, ".png", "b"),
                              T.BatchOptions(default_opts=opts, fused=False),
                              device=CPU)
    jax_items = write_files(tmp_path, pngs, ".png", "c")
    jax_res = J.compress_batch(None, [J.BatchItem(it.src, it.dst)
                                      for it in jax_items],
                               J.BatchOptions(default_opts=J.Options(
                                   format=J.JPEG), fused=True))
    for a, b, c in zip(fused, pooled, jax_res):
        assert a.err is None and b.err is None and c.err is None
        assert a.result.jpeg_quality == b.result.jpeg_quality \
            == c.result.jpeg_quality
        assert a.result.compressed_size == b.result.compressed_size
        assert a.result.original_size == b.result.original_size
        assert open(a.item.dst, "rb").read() == a.result.compressed_data


def test_fused_jpeg_batch_takes_coefficient_path(tmp_path):
    items = write_files(tmp_path, [jpeg_bytes(48, 48, i) for i in range(4)])
    res = T.compress_batch(None, items, T.BatchOptions(
        fused=True, default_opts=T.Options(format=T.JPEG)), device=CPU)
    assert all(r.err is None for r in res)
    assert tbatched.counters.snapshot()["routes"] == {"coefficient": 4}


def test_bad_file_captured(tmp_path):
    items = write_files(tmp_path, [encode_png_rgba(photo(32, 32, 0))],
                        ".png")
    items.append(T.BatchItem(src=str(tmp_path / "missing.png"),
                             dst=str(tmp_path / "x.jpg")))
    res = T.compress_batch(None, items, T.BatchOptions(fused=True),
                           device=CPU)
    assert res[0].err is None and res[1].err is not None


def test_progress_ticks_errored_items(tmp_path):
    items = write_files(tmp_path, [encode_png_rgba(photo(32, 32, i))
                                   for i in range(3)], ".png")
    (tmp_path / "corrupt.png").write_bytes(b"definitely not an image")
    items.append(T.BatchItem(src=str(tmp_path / "corrupt.png"),
                             dst=str(tmp_path / "obad.jpg")))
    items.append(T.BatchItem(src=str(tmp_path / "missing.png"),
                             dst=str(tmp_path / "omiss.jpg")))
    seen = []
    res = T.compress_batch(None, items, T.BatchOptions(
        fused=True, on_item=lambda c, t: seen.append((c, t))), device=CPU)
    n = len(items)
    assert sorted(c for c, _ in seen) == list(range(1, n + 1))
    assert all(t == n for _, t in seen)
    assert [r.err is None for r in res] == [True, True, True, False, False]


@pytest.mark.parametrize("auto_orient,want", [(True, (32, 48)),
                                              (False, (48, 32))])
def test_exif_oriented_jpeg(tmp_path, auto_orient, want):
    from fennec_tpu.exif import write_exif_orientation

    data = jpeg_bytes(48, 32, 3)
    tagged = data[:2] + write_exif_orientation(6) + data[2:]
    items = write_files(tmp_path, [tagged] * 3)
    res = T.compress_batch(None, items, T.BatchOptions(
        fused=True, default_opts=T.Options(format=T.JPEG,
                                           auto_orient=auto_orient)),
        device=CPU)
    assert all(r.err is None and r.result.final_dimensions == want
               for r in res)
    route = "pixel" if auto_orient else "coefficient"
    assert tbatched.counters.snapshot()["routes"] == {route: 3}


def test_mixed_jpeg_and_png(tmp_path):
    items = (write_files(tmp_path, [jpeg_bytes(48, 48, 1)])
             + write_files(tmp_path, [encode_png_rgba(photo(48, 48, 2))],
                           ".png", "p"))
    res = T.compress_batch(None, items, T.BatchOptions(
        fused=True, default_opts=T.Options(format=T.JPEG)), device=CPU)
    assert all(r.err is None and r.result.compressed_size > 0 for r in res)
    assert tbatched.counters.snapshot()["routes"] == {"coefficient": 1,
                                                      "pixel": 1}


def test_mixed_sizes_grouped(tmp_path):
    sizes = [(64, 48), (48, 48), (64, 48), (32, 32), (48, 48)]
    datas = [jpeg_bytes(w, h, i) for i, (w, h) in enumerate(sizes)]
    opts = T.Options(format=T.JPEG)
    fused = T.compress_batch(None, write_files(tmp_path, datas, tag="m"),
                             T.BatchOptions(fused=True, default_opts=opts),
                             device=CPU)
    pooled = T.compress_batch(None, write_files(tmp_path, datas, tag="p"),
                              T.BatchOptions(fused=False, default_opts=opts),
                              device=CPU)
    for (w, h), a, b in zip(sizes, fused, pooled):
        assert a.err is None and b.err is None
        assert a.result.final_dimensions == (w, h)
        assert a.result.jpeg_quality == b.result.jpeg_quality
        assert abs(a.result.compressed_size - b.result.compressed_size) \
            <= SIZE_ATOL


def test_cancel_marks_pending_without_warning(tmp_path, monkeypatch):
    monkeypatch.setattr(tbatched, "MAX_CHUNK", 2)
    items = write_files(tmp_path, [encode_png_rgba(photo(32, 32, i))
                                   for i in range(12)], ".png")
    ctx = T.Context()

    def on_item(c, t):
        if c == 1:
            ctx.cancel()

    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        res = T.compress_batch(ctx, items, T.BatchOptions(
            fused=True, on_item=on_item), device=CPU)
    canceled = [r for r in res if isinstance(r.err, T.CanceledError)]
    finished = [r for r in res if r.err is None and r.result is not None]
    assert canceled, "cancellation did not mark any pending item"
    assert len(canceled) + len(finished) == len(items)


def test_streams_writes_per_chunk(tmp_path, monkeypatch):
    monkeypatch.setattr(tbatched, "MAX_CHUNK", 4)
    items = write_files(tmp_path, [encode_png_rgba(photo(32, 32, i))
                                   for i in range(10)], ".png")
    on_disk = []

    def on_item(c, t):
        on_disk.append(sum(os.path.exists(it.dst) for it in items))

    res = T.compress_batch(None, items, T.BatchOptions(
        fused=True, on_item=on_item), device=CPU)
    assert all(r.err is None for r in res)
    assert all(d >= k + 1 for k, d in enumerate(on_disk))
    assert on_disk[0] < len(items)


@pytest.mark.parametrize("fused", [True, False])
def test_skip_existing(tmp_path, fused):
    items = write_files(tmp_path, [jpeg_bytes(32, 32, i) for i in range(2)])
    with open(items[0].dst, "wb") as f:
        f.write(b"placeholder")
    res = T.compress_batch(None, items, T.BatchOptions(
        fused=fused, skip_existing=True,
        default_opts=T.Options(format=T.JPEG)), device=CPU)
    assert res[0].err is None and res[0].result is None
    assert open(items[0].dst, "rb").read() == b"placeholder"
    assert res[1].err is None and res[1].result.compressed_size > 0
    assert T.summarize(res).succeeded == 2


def test_summary():
    ok = T.BatchResult(item=None, result=T.Result(
        original_size=1000, compressed_size=400, ssim=0.95))
    bad = T.BatchResult(item=None, err=ValueError("x"))
    s = T.summarize([ok, bad])
    assert (s.total, s.succeeded, s.failed, s.total_saved) == (2, 1, 1, 600)
    assert s.avg_ssim == pytest.approx(0.95)
    assert str(s).startswith("Batch: 1/2 succeeded")


# ── Fault isolation ─────────────────────────────────────────────────────────


def oom_when_larger_than(real, limit):
    """A device function that runs out of memory above `limit` images."""
    sizes = []

    def fn(imgs, *rest):
        sizes.append(imgs.shape[0])
        if imgs.shape[0] > limit:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(imgs, *rest)

    return fn, sizes


def test_oom_retries_at_half_chunk(monkeypatch):
    imgs = [photo(48, 48, s) for s in range(5)]
    opts = T.Options(format=T.JPEG)
    want = T.compress_images(None, imgs, opts, device=CPU)
    fn, sizes = oom_when_larger_than(tbatched.batched_quality_search_quantize,
                                     2)
    monkeypatch.setattr(tbatched, "batched_quality_search_quantize", fn)
    tbatched.counters.reset()
    got = T.compress_images(None, imgs, opts, device=CPU)
    assert sizes == [5, 2, 3, 1, 2]
    assert tbatched.counters.snapshot()["chunk_items"] == [2, 1, 2]
    assert [r.compressed_data for r in got] == \
        [r.compressed_data for r in want]


def test_oom_of_one_image_fails_only_it(monkeypatch):
    fn, _ = oom_when_larger_than(tbatched.batched_quality_search_quantize, 0)
    monkeypatch.setattr(tbatched, "batched_quality_search_quantize", fn)
    errors = {}
    with pytest.raises(tbatched.FusedChunkError) as exc_info:
        tbatched.compress_images_batched(
            None, [photo(32, 32, 1), photo(32, 32, 2)],
            T.Options(format=T.JPEG), device=CPU,
            on_error=errors.__setitem__)
    assert sorted(errors) == [0, 1] and not exc_info.value.wedged
    assert all(isinstance(e, torch.cuda.OutOfMemoryError)
               for e in errors.values())


def sticky_on_call(real, bad_call):
    calls = []

    def fn(*args):
        calls.append(args[0].shape[0])
        if len(calls) == bad_call:
            raise torch.AcceleratorError(
                "CUDA error: an illegal memory access was encountered")
        return real(*args)

    return fn, calls


def test_sticky_cuda_error_wedges_the_batch(tmp_path, monkeypatch):
    """The second chunk hits a sticky CUDA error: the first chunk's items
    are on disk, every other item fails with that error, the device is
    never called again, and nothing goes to the per-file pool."""
    import fennec_tpu_torch.parallel.batched as pb

    monkeypatch.setattr(tbatched, "MAX_CHUNK", 2)
    fn, calls = sticky_on_call(pb.batched_decode_resize_search_quantize, 2)
    monkeypatch.setattr(pb, "batched_decode_resize_search_quantize", fn)
    items = write_files(tmp_path, [jpeg_bytes(48, 48, i) for i in range(7)])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = T.compress_batch(None, items, T.BatchOptions(
            fused=True, default_opts=T.Options(format=T.JPEG)), device=CPU)
    assert len(calls) == 2
    assert any("device unusable" in str(x.message) for x in w)
    assert [r.err is None for r in res] == [True, True] + [False] * 5
    assert all("illegal memory access" in str(r.err) for r in res[2:])
    assert all(os.path.exists(it.dst) for it in items[:2])
    assert "pool" not in tbatched.counters.snapshot()["routes"]


def test_host_fault_falls_back_to_pool(tmp_path, monkeypatch):
    def broken(*args):
        raise ValueError("host bug in the chunk")

    monkeypatch.setattr(tbatched, "batched_quality_search_quantize", broken)
    items = write_files(tmp_path, [encode_png_rgba(photo(32, 32, i))
                                   for i in range(3)], ".png")
    seen = []
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = T.compress_batch(None, items, T.BatchOptions(
            fused=True, default_opts=T.Options(format=T.JPEG),
            on_item=lambda c, t: seen.append(c)), device=CPU)
    assert any("fused batch path failed" in str(x.message) for x in w)
    assert all(r.err is None for r in res)
    assert sorted(seen) == [1, 2, 3]
    assert tbatched.counters.snapshot()["routes"] == {"pool": 3}


def test_counters_survive_concurrent_updates():
    """EngineCounters and K1's launch count are shared by worker threads:
    no update may be lost."""
    counters = tbatched.EngineCounters()
    start = ssim_window.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                counters.add_route("pixel")
                counters.add_chunk(1, 3)
                ssim_window.count_launch()

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = counters.snapshot()
    assert snap["routes"] == {"pixel": 16000}
    assert snap["uploaded_bytes"] == 48000
    assert ssim_window.launches - start == 16000
    ssim_window.launches = start
