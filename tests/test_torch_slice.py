"""The single-image main path of the PyTorch port against the JAX package.

compress_image, compress_bytes and compress_file on the conftest
generators and on a 600×400 JPEG (over 512 px, so the SSIMFast box-down
runs) must give the same format and quality, SSIM within 1e-5 and
identical bytes.

Stated exceptions, each with its reason:

- Rounding ties.  The forward DCT and the Lanczos resize are float32
  matmuls in both packages, summed in different orders.  Where the exact
  value is k + 0.5 (a DC term of integer-sum pixels, a resampled pixel),
  one package can land a few ulps below the tie and the other above it,
  and the two round to neighbours.  Bytes may then differ; the test
  requires every differing coefficient or pixel to be off by one at such
  a tie: within 1e-4 of the half-step for a coefficient (the JAX value),
  within 1e-3 for a pixel (the float64 value; the premultiplied sum
  reaches 65025, whose float32 rounding is about 5e-3 before the
  division by alpha).
- A flat image.  SSIM computes sigma = E[x^2] - mu^2 in float32, as the
  reference does; for a flat image that difference cancels to rounding
  noise of order eps * mu^2 (about 2e-3) against C2 = 58.5, so its SSIM
  is reproducible only to a few 1e-5.  The JAX package's own jitted and
  eager windowed SSIM differ by 4e-5 on solid_32 forced to JPEG, which
  is therefore held to 1e-4.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (
    make_noise_image,
    make_solid_image,
    make_striped_image,
    make_test_image,
    make_test_image_with_alpha,
)
import fennec_tpu as J
import fennec_tpu_torch as T
from fennec_tpu.codecs.jpeg import encode_jpeg as jax_encode_jpeg
from fennec_tpu.codecs.jpeg import forward_dct_device
from fennec_tpu.ops.dct import all_quality_tables, dct_matrix
from fennec_tpu_torch.codecs.jpeg import decode_jpeg_to_coefs
from fennec_tpu_torch.ops.resize import lanczos_resize
from fennec_tpu_torch.ops.ssim_cuda import ssim_window

torch.set_num_threads(1)

SSIM_ATOL = 1e-5
FLAT_SSIM_ATOL = 1e-4
TIE_ATOL = 1e-4
PIXEL_TIE_ATOL = 1e-3


def photo_image(w, h, seed=0):
    """Gradient plus low-frequency noise: a smooth, photo-like image."""
    rng = np.random.default_rng(seed)
    img = make_test_image(w, h)
    noise = rng.normal(0, 12, (h // 8 + 1, w // 8 + 1, 3))
    noise = np.kron(noise, np.ones((8, 8, 1)))[:h, :w]
    img[..., :3] = np.clip(img[..., :3] + noise, 0, 255).astype(np.uint8)
    return img


IMAGES = {
    "gradient_64x48": lambda: make_test_image(64, 48),
    "gradient_256x192": lambda: make_test_image(256, 192),
    "noise_120x90": lambda: make_noise_image(120, 90),
    "striped_128": lambda: make_striped_image(128, 128),
    "alpha_64x48": lambda: make_test_image_with_alpha(64, 48),
    "solid_32": lambda: make_solid_image(32, 32, 200, 100, 50),
    "tiny_7x5": lambda: make_noise_image(7, 5),
    "strip_8x40": lambda: make_noise_image(8, 40),
    "photo_600x400": lambda: photo_image(600, 400),
}

# (image, Options kwargs, SSIM tolerance): AUTO format everywhere; JPEG
# forced where AUTO would pick PNG, so the tiny-image and flat cases run.
CASES = [(name, {}, SSIM_ATOL) for name in IMAGES] + [
    ("solid_32", {"format": 1}, FLAT_SSIM_ATOL),
    ("tiny_7x5", {"format": 1}, SSIM_ATOL),
    ("striped_128", {"format": 1, "quality": 3}, SSIM_ATOL),
    ("gradient_64x48", {"target_ssim": 1.0}, SSIM_ATOL),
    ("noise_120x90", {"target_ssim": 1.0}, SSIM_ATOL),
    ("strip_8x40", {"target_ssim": 1.0, "subsample": False}, SSIM_ATOL),
    # Q95: the luma DC terms of blocks 2318 and 2752 are exact ties (117
    # and 153 over a step of 2); the two float32 sums can land on either
    # side, and the bytes may differ there.
    ("photo_600x400", {"target_ssim": 1.0}, SSIM_ATOL),
]


def tie_coefficients(data_jax: bytes, data_port: bytes, img, quality: int,
                     subsample: bool):
    """(component, block, k) of every quantized coefficient that differs;
    asserts each is a rounding tie (see the module docstring)."""
    _, cj = decode_jpeg_to_coefs(data_jax)
    _, ct = decode_jpeg_to_coefs(data_port)
    coefs = forward_dct_device(jnp.asarray(img, dtype=jnp.float32),
                               subsample)
    tabs = all_quality_tables()[quality]
    ties = []
    for comp, (a, b) in enumerate(zip(cj, ct)):
        for blk, k in np.argwhere(a != b):
            assert abs(int(a[blk, k]) - int(b[blk, k])) == 1
            s = float(np.asarray(coefs[comp])[blk, k]) / \
                tabs[0 if comp == 0 else 1][k]
            assert abs(abs(s) % 1.0 - 0.5) < TIE_ATOL, (comp, blk, k, s)
            ties.append((comp, int(blk), int(k)))
    return ties


def assert_pixel_ties(got, want, exact):
    """Assert two uint8 images differ only by one, at pixels whose
    float64 value `exact` (H, W, C) is within 1e-3 of a half-step."""
    diff = np.argwhere(got != want)
    if len(diff):
        assert np.abs(got.astype(int) - want.astype(int)).max() == 1
        frac = np.abs(exact[tuple(diff.T)] % 1.0 - 0.5)
        assert frac.max() < PIXEL_TIE_ATOL, (diff, exact[tuple(diff.T)])
    return len(diff)


def decode_exact(data):
    """float64 RGB of a baseline 4:2:0 JPEG before rounding: dequantize,
    IDCT, upsample, YCbCr→RGB."""
    hdr, coefs = decode_jpeg_to_coefs(data)
    kron = np.kron(dct_matrix(), dct_matrix())
    planes = []
    for i, c in enumerate(hdr.comps):
        qt = hdr.qtables[c["tq"]].astype(np.float64)
        bh = -(-hdr.height // 16) * c["v"]
        bw = -(-hdr.width // 16) * c["h"]
        pix = (coefs[i].astype(np.float64) * qt) @ kron + 128.0
        plane = pix.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)
        rep = 2 // c["h"]
        plane = np.repeat(np.repeat(plane, rep, axis=0), rep, axis=1)
        planes.append(plane[:hdr.height, :hdr.width])
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    return np.stack([y + 1.402 * cr,
                     y - 0.344136286 * cb - 0.714136286 * cr,
                     y + 1.772 * cb], axis=-1)


def lanczos_exact(src, w, h):
    """float64 Lanczos resize of an opaque image before rounding."""
    from fennec_tpu.ops.resize import resize_weights

    wh, wv = (m.astype(np.float64) for m in
              resize_weights(src.shape[1], src.shape[0], w, h))
    tmp = np.tensordot(src.astype(np.float64), wh, axes=([1], [1]))
    return np.tensordot(wv, tmp, axes=([1], [0])).transpose(0, 2, 1)


def assert_same(rj, rt, img=None, ssim_atol=SSIM_ATOL):
    """Same format, quality, SSIM within ssim_atol, and the same bytes
    unless every difference is a rounding tie of the forward DCT."""
    assert rt.format == rj.format
    assert rt.jpeg_quality == rj.jpeg_quality
    assert abs(rt.ssim - rj.ssim) <= ssim_atol, (rt.ssim, rj.ssim)
    assert rt.final_dimensions == rj.final_dimensions
    if rt.compressed_data != rj.compressed_data:
        assert img is not None and rt.format == T.JPEG
        ties = tie_coefficients(rj.compressed_data, rt.compressed_data, img,
                                rj.jpeg_quality, True)
        assert 0 < len(ties) <= 8, ties


@pytest.mark.parametrize("name,kw,ssim_atol", CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'auto'}"
                              for n, k, _ in CASES])
def test_compress_image_matches_jax(name, kw, ssim_atol):
    img = IMAGES[name]()
    rj = J.compress_image(None, img, J.Options(**kw))
    before = ssim_window.launches
    rt = T.compress_image(None, img, T.Options(**kw), device="cpu")
    assert ssim_window.launches == before  # CPU tensors: no kernel launch
    assert_same(rj, rt, img, ssim_atol)


@pytest.fixture(scope="module")
def photo_jpeg():
    """A 600×400 baseline 4:2:0 JPEG made by the JAX package."""
    return jax_encode_jpeg(photo_image(600, 400), 92)


@pytest.mark.parametrize("kw", [{}, {"target_ssim": 1.0}],
                         ids=["balanced", "target1"])
def test_compress_bytes_matches_jax(photo_jpeg, kw):
    rj = J.compress_bytes(None, photo_jpeg, J.Options(**kw))
    rt = T.compress_bytes(None, photo_jpeg, T.Options(**kw), device="cpu")
    assert_same(rj, rt, rj.image)


def test_compress_bytes_resized_matches_jax(photo_jpeg):
    """max_width, stage by stage: the decode and the Lanczos resize may
    differ at rounding ties only, and the search and encode of the JAX
    package's resized image match; end to end, quality and SSIM match."""
    kw = {"quality": 2, "max_width": 300}
    rj = J.compress_bytes(None, photo_jpeg, J.Options(**kw))
    rt = T.compress_bytes(None, photo_jpeg, T.Options(**kw), device="cpu")
    assert rt.final_dimensions == rj.final_dimensions == (300, 200)
    assert rt.jpeg_quality == rj.jpeg_quality
    assert abs(rt.ssim - rj.ssim) <= SSIM_ATOL

    src_j = J.codecs.decode_image(photo_jpeg)
    src_t = T.codecs.decode_image(photo_jpeg, device="cpu")
    assert assert_pixel_ties(src_t[..., :3], src_j[..., :3],
                             decode_exact(photo_jpeg)) <= 8
    resized = lanczos_resize(src_j, 300, 200, device="cpu")
    assert assert_pixel_ties(resized[..., :3], rj.image[..., :3],
                             lanczos_exact(src_j, 300, 200)) <= 8
    same_src = T.compress_image(None, rj.image, T.Options(quality=2),
                                device="cpu")
    assert_same(rj, same_src, rj.image)


def test_compress_file_matches_jax(photo_jpeg, tmp_path):
    src = tmp_path / "in.jpg"
    src.write_bytes(photo_jpeg)
    rj = J.compress_file(None, str(src), str(tmp_path / "jax.jpg"))
    rt = T.compress_file(None, str(src), str(tmp_path / "port.jpg"),
                         device="cpu")
    assert_same(rj, rt, rj.image)
    assert (tmp_path / "port.jpg").read_bytes() == rt.compressed_data
    assert rt.original_size == len(photo_jpeg)
    out = T.codecs.decode_image(rt.compressed_data, device="cpu")
    assert out.shape == (400, 600, 4)


def with_orientation(data: bytes, orient: int) -> bytes:
    from fennec_tpu.exif import write_exif_orientation

    return data[:2] + write_exif_orientation(orient) + data[2:]


def pil_progressive_jpeg(img, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img[..., :3], "RGB").save(buf, "JPEG", quality=quality,
                                              progressive=True)
    return buf.getvalue()


@pytest.mark.parametrize("orient", [2, 3, 4, 5, 6, 7, 8])
def test_compress_file_applies_exif_orientation(tmp_path, orient):
    """The JPEG comes out of its decode upright (compress_file decodes it
    so), the JAX package's result, and the stored pixels turned by
    apply_orientation bit for bit."""
    from fennec_tpu_torch.exif import apply_orientation

    data = jax_encode_jpeg(photo_image(96, 64, seed=orient), 90)
    src = tmp_path / "in.jpg"
    src.write_bytes(with_orientation(data, orient))
    rj = J.compress_file(None, str(src), str(tmp_path / "jax.jpg"))
    rt = T.compress_file(None, str(src), str(tmp_path / "port.jpg"),
                         device="cpu")
    want_dims = (64, 96) if orient >= 5 else (96, 64)
    assert rt.final_dimensions == rt.original_dimensions == want_dims
    assert_same(rj, rt, rj.image)
    stored = T.open_image(str(src), device="cpu")
    np.testing.assert_array_equal(rt.image, apply_orientation(stored, orient))


@pytest.mark.parametrize("orient", [5, 6])
def test_compress_file_orients_a_progressive_jpeg(tmp_path, orient):
    """A progressive file takes the same upright decode."""
    from fennec_tpu_torch.exif import apply_orientation

    data = pil_progressive_jpeg(photo_image(88, 56, seed=orient))
    assert T.codecs.jpeg.is_progressive_jpeg(data)
    src = tmp_path / "in.jpg"
    src.write_bytes(with_orientation(data, orient))
    rj = J.compress_file(None, str(src), str(tmp_path / "jax.jpg"))
    rt = T.compress_file(None, str(src), str(tmp_path / "port.jpg"),
                         device="cpu")
    assert rt.final_dimensions == rt.original_dimensions == (56, 88)
    assert_same(rj, rt, rj.image)
    stored = T.open_image(str(src), device="cpu")
    np.testing.assert_array_equal(rt.image, apply_orientation(stored, orient))


def test_compress_file_without_auto_orient_keeps_the_stored_pixels(
        tmp_path):
    """auto_orient=False: the stored pixels, unturned, as the JAX
    package compresses them; no frame decoded at another orientation."""
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon

    data = jax_encode_jpeg(photo_image(96, 64, seed=11), 90)
    src = tmp_path / "in.jpg"
    src.write_bytes(with_orientation(data, 6))
    before = decode_recon.oriented
    rj = J.compress_file(None, str(src), str(tmp_path / "jax.jpg"),
                         J.Options(auto_orient=False))
    rt = T.compress_file(None, str(src), str(tmp_path / "port.jpg"),
                         T.Options(auto_orient=False), device="cpu")
    assert decode_recon.oriented == before
    assert rt.final_dimensions == rt.original_dimensions == (96, 64)
    assert_same(rj, rt, rj.image)
    np.testing.assert_array_equal(rt.image,
                                  T.open_image(str(src), device="cpu"))


def test_open_with_orientation_returns_the_stored_pixels(tmp_path):
    """open_with_orientation and open_image read the orientation but turn
    nothing: the pixels of the file without its EXIF segment."""
    data = jax_encode_jpeg(photo_image(96, 64, seed=12), 90)
    src = tmp_path / "in.jpg"
    src.write_bytes(with_orientation(data, 6))
    img, orient, size = T.open_with_orientation(str(src), device="cpu")
    assert int(orient) == 6 and size == src.stat().st_size
    assert img.shape == (64, 96, 4)
    plain = T.codecs.decode_image(data, device="cpu")
    np.testing.assert_array_equal(img, plain)
    np.testing.assert_array_equal(T.open_image(str(src), device="cpu"), plain)


def test_oriented_counts_only_frames_decoded_at_another_orientation(
        tmp_path):
    """decode_recon.oriented: one for each compress_file of a rotated
    JPEG; none for an upright file, for compress_bytes of a rotated one,
    or for a PNG."""
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon

    data = jax_encode_jpeg(photo_image(64, 48, seed=13), 90)
    files = {}
    for name, payload in (("up.jpg", data),
                          ("flip.jpg", with_orientation(data, 2)),
                          ("rot.jpg", with_orientation(data, 6)),
                          ("normal.jpg", with_orientation(data, 1)),
                          ("img.png", T.encode_to_bytes(
                              photo_image(64, 48, seed=13), T.PNG, 0))):
        files[name] = tmp_path / name
        files[name].write_bytes(payload)
    before = decode_recon.oriented
    for name in ("up.jpg", "normal.jpg", "img.png"):
        T.compress_file(None, str(files[name]), str(tmp_path / "o"),
                        device="cpu")
    T.compress_bytes(None, with_orientation(data, 6), device="cpu")
    assert decode_recon.oriented == before
    for name in ("flip.jpg", "rot.jpg", "rot.jpg"):
        T.compress_file(None, str(files[name]), str(tmp_path / "o"),
                        device="cpu")
    assert decode_recon.oriented == before + 3


def test_png_alpha_roundtrip_via_compress():
    img = make_test_image_with_alpha(50, 30)
    data = io.BytesIO(T.encode_to_bytes(img, T.PNG, 0))
    rt = T.compress(None, data, T.Options(), device="cpu")
    assert rt.format == T.PNG and rt.ssim == 1.0
    np.testing.assert_array_equal(
        T.codecs.decode_image(rt.compressed_data, device="cpu"), img)


def test_target_size_not_ported():
    """Target-size mode runs through compress_image: the JAX package's
    format, quality, geometry and bytes (tests/test_torch_targetsize.py
    holds every strategy to it)."""
    img = photo_image(96, 64, seed=4)
    opts = dict(format=J.JPEG, target_size=3000)
    rj = J.compress_image(None, img, J.Options(**opts))
    rt = T.compress_image(None, img, T.Options(**opts), device="cpu")
    assert (rt.format, rt.jpeg_quality, rt.final_dimensions) == (
        rj.format, rj.jpeg_quality, rj.final_dimensions)
    assert rt.compressed_size <= 3000
    assert rt.compressed_data == rj.compressed_data
    assert rt.ssim == pytest.approx(rj.ssim, abs=1e-4)


def test_device_entropy_not_ported():
    """device_entropy=True, once refused, codes on the device: the plain
    version of kernel K3 on the CPU, the same bytes as the host encoder
    and as the JAX package's device emission."""
    img = photo_image(64, 48)
    on = T.compress_image(None, img, T.Options(format=T.JPEG,
                                               device_entropy=True),
                          device="cpu")
    off = T.compress_image(None, img, T.Options(format=T.JPEG,
                                                device_entropy=False),
                           device="cpu")
    jax_on = J.compress_image(None, img, J.Options(format=J.JPEG,
                                                   device_entropy=True))
    assert on.compressed_data == off.compressed_data
    assert on.compressed_data == jax_on.compressed_data


def test_default_device_is_cuda(monkeypatch):
    """No device named → CUDA, and no silent CPU fallback without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.compress_image(None, photo_image(64, 48))
