"""The pixel batch path's YCbCr 4:2:0 wire (FENNEC_PIXEL_WIRE=yuv420) in
the PyTorch port against the JAX package, on the CPU.

The host conversion: the port's numpy _yuv420_wire_host equals the JAX
package's numpy conversion exactly; the C++ entries (the batch
rgb_to_yuv420 and the per-image rgba_to_yuv420_into the engine uses)
equal the JAX package's C++ output exactly and the numpy conversion
within 1 LSB; rgba_to_yuv420_into raises ValueError on a wrong row
length, dtype, shape or stride.

The search over the wire: the port's batched_quality_search_quantize_
yuv420 against JAX's on the same wire rows: the same quality, SSIM
within 1e-5, and the quantized blocks equal except at forward-DCT
rounding ties (a coefficient within 1e-3 of k + 1/2 quantization steps:
matmul summation order, tests/test_torch_slice.py).

The engine: the wire is opt-in (the default "rgb" keeps batch bytes equal
to per-image bytes), engages only for opaque 4:2:0 chunks coded on the
device, and its results meet their targets (or are the Q100 fallback)
with JAX's engine's qualities on the same inputs.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import fennec_tpu as J
import fennec_tpu.engine.batched as jeb
import fennec_tpu_torch as T
from fennec_tpu_torch import native
from fennec_tpu_torch.engine import batched as tbatched
from fennec_tpu_torch.engine import compress as tcompress
from fennec_tpu_torch.ops import dct as tdct
from fennec_tpu_torch.parallel import batched as pb

torch.set_num_threads(1)

CPU = "cpu"
SSIM_ATOL = 1e-5
TIE_ATOL = 1e-3


def photo(w, h, seed, sigma=8.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.empty((h, w, 4), np.uint8)
    base = np.stack([x * 255 / w, y * 255 / h,
                     (x + y) * 255 / (w + h)], axis=-1)
    img[..., :3] = np.clip(base + rng.normal(0, sigma, (h, w, 3)), 0, 255)
    img[..., 3] = 255
    return img


SIZES = [(52, 36), (64, 48), (17, 9), (33, 70)]


@pytest.mark.parametrize("w,h", SIZES)
def test_numpy_conversion_equals_jax(monkeypatch, w, h):
    import fennec_tpu.native as jnat

    stack = np.stack([photo(w, h, s)[..., :3] for s in range(3)])
    monkeypatch.setattr(jnat, "rgb_to_yuv420", lambda x: None)
    want = jeb._yuv420_wire_host(stack, h, w)
    got = tbatched._yuv420_wire_host(stack, h, w)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h", SIZES)
def test_native_conversion_equals_jax_and_numpy_within_1_lsb(w, h):
    import fennec_tpu.native as jnat

    stack = np.clip(np.random.default_rng(w * h).normal(
        120, 60, (3, h, w, 3)), 0, 255).astype(np.uint8)
    got = native.rgb_to_yuv420(stack)
    want = jnat.rgb_to_yuv420(stack)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    ref = tbatched._yuv420_wire_host(stack, h, w)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1
    assert (d > 0).mean() < 0.01
    assert got.shape[1] == native.yuv420_wire_size(h, w)


def test_per_image_entry_equals_batch_entry():
    img = np.random.default_rng(5).integers(0, 256, (52, 36, 4),
                                            dtype=np.uint8)
    batch = native.rgb_to_yuv420(np.ascontiguousarray(img[None, ..., :3]))
    row = np.empty(batch.shape[1], np.uint8)
    for layout in (img, np.ascontiguousarray(img[..., :3]), img[..., :3]):
        row[:] = 0
        native.rgba_to_yuv420_into(layout, row)
        np.testing.assert_array_equal(row, batch[0])


@pytest.mark.parametrize("bad", ["short_row", "long_row", "row_dtype",
                                 "row_2d", "flipped", "two_channels",
                                 "img_dtype", "column_view", "readonly"])
def test_rgba_to_yuv420_into_checks_sizes(bad):
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 4),
                                            dtype=np.uint8)
    n = native.yuv420_wire_size(20, 30)
    row = np.zeros(n, np.uint8)
    if bad == "short_row":
        row = row[:-1]
    elif bad == "long_row":
        row = np.zeros(n + 1, np.uint8)
    elif bad == "row_dtype":
        row = row.astype(np.int16)
    elif bad == "row_2d":
        row = row.reshape(1, n)
    elif bad == "flipped":
        img = img[::-1]
    elif bad == "two_channels":
        img = np.ascontiguousarray(img[..., :2])
    elif bad == "img_dtype":
        img = img.astype(np.int32)
    elif bad == "column_view":
        img = img[:, ::2]
    else:
        row.flags.writeable = False
    with pytest.raises(ValueError):
        native.rgba_to_yuv420_into(img, row)


def wire_of(imgs):
    h, w = imgs[0].shape[:2]
    rows = np.zeros((len(imgs), native.yuv420_wire_size(h, w)), np.uint8)
    for j, im in enumerate(imgs):
        native.rgba_to_yuv420_into(im, rows[j])
    return rows


def tie_positions(diff_idx, rows, h, w, qualities):
    """For each differing packed coefficient, how far its unquantized
    value sits from k + 1/2 quantization steps (the port's forward DCT of
    the wire)."""
    yp, cbp, crp = pb._split_yuv420_wire(torch.from_numpy(rows), h, w)
    coefs = [tdct.dct2d_blocks(tdct.to_blocks(p.to(torch.float32) - 128.0))
             for p in (yp, cbp, crp)]
    flat = torch.cat(coefs, dim=1).numpy()
    ny = coefs[0].shape[1]
    tables = tdct.all_quality_tables()
    out = []
    for b, n, k in zip(*diff_idx):
        q = tables[qualities[b]][0 if n < ny else 1][k]
        s = abs(flat[b, n, k] / q)
        out.append(abs(s - np.floor(s) - 0.5))
    return np.array(out)


@pytest.mark.parametrize("w,h", [(64, 48), (52, 36), (130, 100),
                                 (600, 208)])
def test_search_matches_jax_on_the_same_wire(w, h):
    import jax.numpy as jnp

    from fennec_tpu.engine.compress import \
        batched_quality_search_quantize_yuv420 as jax_search

    imgs = [photo(w, h, s, sigma) for s, sigma in ((1, 4.0), (2, 8.0),
                                                    (3, 14.0))]
    rows = wire_of(imgs)
    targets = [0.94, 0.97, 0.90]
    q, s, f, blocks = tcompress.batched_quality_search_quantize_yuv420(
        *pb._split_yuv420_wire(torch.from_numpy(rows), h, w), targets, h, w)
    jrows = jnp.asarray(rows)
    jq, js, jf, jblocks = jax_search(
        *jeb_split(jrows, h, w), jnp.asarray(targets, jnp.float32), h, w)
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(f, np.asarray(jf))
    np.testing.assert_allclose(s, np.asarray(js), atol=SSIM_ATOL, rtol=0)
    jblocks = np.asarray(jblocks)
    diff = np.nonzero(blocks != jblocks)
    assert np.all(np.abs(blocks[diff].astype(np.int32)
                         - jblocks[diff]) == 1)
    final = np.where(f, q, 100)
    assert np.all(tie_positions(diff, rows, h, w, final) < TIE_ATOL)


def jeb_split(rows, h, w):
    from fennec_tpu.parallel.batched import _split_yuv420_wire

    return _split_yuv420_wire(rows, h, w)


# ── The engine ──────────────────────────────────────────────────────────────


@pytest.fixture(autouse=True)
def fresh_counters(monkeypatch):
    monkeypatch.delenv("FENNEC_PIXEL_WIRE", raising=False)
    tbatched.counters.reset()
    yield


def wire_events():
    return {k: v for k, v in tbatched.counters.snapshot()["events"].items()
            if k.startswith("upload_")}


OPTS = dict(format=T.JPEG, device_entropy=True)


def test_default_is_the_rgb_wire():
    imgs = [photo(64, 48, s) for s in range(3)]
    got = T.compress_images(None, imgs, T.Options(**OPTS), device=CPU)
    assert wire_events() == {"upload_rgb": 1}
    for im, r in zip(imgs, got):
        want = T.compress_image(None, im, T.Options(**OPTS), device=CPU)
        assert r.compressed_data == want.compressed_data


def test_yuv420_route_meets_targets_with_jax_qualities(monkeypatch):
    imgs = [photo(64, 48, s, sigma) for s, sigma in
            ((0, 4.0), (1, 8.0), (2, 12.0), (3, 20.0))]
    monkeypatch.setenv("FENNEC_PIXEL_WIRE", "yuv420")
    opts = T.Options(**OPTS)
    got = T.compress_images(None, imgs, opts, device=CPU)
    assert wire_events() == {"upload_yuv420": 1}
    monkeypatch.setattr(jeb, "PIXEL_WIRE", "yuv420")
    want = jeb.compress_images_batched(
        None, imgs, J.Options(format=J.JPEG, device_entropy=True))
    monkeypatch.setenv("FENNEC_PIXEL_WIRE", "rgb")
    rgb = T.compress_images(None, imgs, opts, device=CPU)
    target = opts.quality.target_ssim()

    def error(r, im):
        dec = Image.open(io.BytesIO(r.compressed_data))
        assert dec.size == (64, 48)
        return np.abs(np.asarray(dec.convert("RGB"), np.float32)
                      - im[..., :3].astype(np.float32)).mean()

    for im, r, j, c in zip(imgs, got, want, rgb):
        assert r.jpeg_quality == j.jpeg_quality
        assert abs(r.ssim - j.ssim) <= SSIM_ATOL
        assert r.ssim >= target or (r.jpeg_quality, r.ssim) == (100, 1.0)
        # The wire's u8 planes cost at most a level of mean error against
        # the RGB wire's output.
        assert error(r, im) <= error(c, im) + 1.0


@pytest.mark.parametrize("case", ["alpha", "444", "host_encoder"])
def test_yuv420_engages_only_where_it_applies(monkeypatch, case):
    monkeypatch.setenv("FENNEC_PIXEL_WIRE", "yuv420")
    imgs = [photo(48, 48, s) for s in range(2)]
    kw = dict(OPTS)
    if case == "alpha":
        imgs[1][..., 3] = 200
    elif case == "444":
        kw["subsample"] = False
    else:
        kw["device_entropy"] = False
    opts = T.Options(**kw)
    got = T.compress_images(None, imgs, opts, device=CPU)
    assert wire_events() == {"upload_rgb": 1}
    for im, r in zip(imgs, got):
        assert r.compressed_data == T.compress_image(
            None, im, opts, device=CPU).compressed_data


def test_yuv420_two_shard_mesh_equals_one_device(monkeypatch):
    monkeypatch.setenv("FENNEC_PIXEL_WIRE", "yuv420")
    imgs = [photo(64, 48, s) for s in range(5)]
    opts = T.Options(**OPTS)
    one = T.compress_images(None, imgs, opts, device=CPU)
    two = T.compress_images(None, imgs, opts, device=[CPU, CPU])
    assert [r.compressed_data for r in two] == \
        [r.compressed_data for r in one]
    assert wire_events() == {"upload_yuv420": 2}
