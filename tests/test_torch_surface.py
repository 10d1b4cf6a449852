"""The rest of the public surface of the PyTorch port against the JAX
package, on the CPU: ssim, ms_ssim and batched_ssim, the effects, the
file I/O functions, and the top-level names.

Tolerances, each with its reason:

- ssim, ms_ssim and batched_ssim within 1e-5 (ROADMAP.md's parity rule,
  the bound the JAX package holds its Pallas kernel to): the window sums
  are the same float32 operations, and the means and logs are taken in
  another order.
- the effects in uint8: equal, except that the Gaussian blur's JAX
  version is an XLA convolution that sums its taps in its own order, so a
  value at a rounding tie (k + 0.5) can land one level away; such
  values are off by 1 and at most 1e-5 of all values.
- open_and_orient, save and encode: equal arrays and bytes.
"""

import importlib
import io
import types

import numpy as np
import pytest
import torch

from conftest import make_noise_image, make_test_image_with_alpha
import fennec_tpu as J
import fennec_tpu_torch as T
from fennec_tpu.exif import write_exif_orientation
from fennec_tpu.ops import effects as jeffects
from fennec_tpu.parallel import batched as jpar
from fennec_tpu_torch.ops import effects as teffects
from fennec_tpu_torch.ops import ssim as tssim
from fennec_tpu_torch.ops.ssim_cuda import ssim_window
from fennec_tpu_torch.parallel import batched as tpar
from test_torch_slice import photo_image

# fennec_tpu.ops re-exports the function ssim under the module's name.
jssim = importlib.import_module("fennec_tpu.ops.ssim")
torch.set_num_threads(1)
CPU = "cpu"
SSIM_ATOL = 1e-5
TIE_SHARE = 1e-5


def noisy(img, seed, spread=10):
    rng = np.random.default_rng(seed)
    out = np.clip(img.astype(np.int32)
                  + rng.integers(-spread, spread + 1, img.shape), 0, 255)
    out[..., 3] = img[..., 3]
    return out.astype(np.uint8)


PAIRS = {
    "photo_97x61": (97, 61, 97, 61),
    "photo_600x400": (600, 400, 600, 400),
    "photo_700x530": (700, 530, 700, 530),
    "resized_120x90_from_100x70": (120, 90, 100, 70),
    "tiny_7x5": (7, 5, 7, 5),
    "strip_8x40": (8, 40, 8, 40),
    "strip_40x9": (40, 9, 40, 9),
    "small_40x30": (40, 30, 40, 30),
}


@pytest.fixture(scope="module", params=sorted(PAIRS))
def pair(request):
    w, h, w2, h2 = PAIRS[request.param]
    a = photo_image(w, h, seed=w)
    b = noisy(photo_image(w2, h2, seed=w), seed=h)
    return a, b


def test_ssim_matches_jax(pair):
    a, b = pair
    assert tssim.ssim(a, b, device=CPU) == pytest.approx(
        jssim.ssim(a, b), abs=SSIM_ATOL)


def test_ms_ssim_matches_jax(pair):
    a, b = pair
    assert tssim.ms_ssim(a, b, device=CPU) == pytest.approx(
        jssim.ms_ssim(a, b), abs=SSIM_ATOL)


@pytest.mark.parametrize("w,h", [(16, 16), (40, 30), (7, 5), (600, 400),
                                 (1000, 9), (3000, 2000)])
def test_msssim_plan_matches_jax(w, h):
    assert tssim.msssim_plan(w, h) == jssim._msssim_plan(w, h)


def test_identical_images_score_one():
    a = photo_image(90, 70, seed=3)
    assert tssim.ssim(a, a.copy(), device=CPU) == pytest.approx(1.0,
                                                                abs=1e-6)
    assert tssim.ms_ssim(a, a.copy(), device=CPU) == pytest.approx(
        1.0, abs=1e-6)
    assert tssim.ms_ssim(a[:0], a[:0], device=CPU) == 1.0


def test_ssim_runs_k1_wrapper(monkeypatch):
    """ssim scores through K1's wrapper (the plain version on a CPU
    tensor), at the image's full size."""
    shapes = []
    real = ssim_window.__class__.__call__

    def spy(self, a, b):
        shapes.append(tuple(a.shape))
        return real(self, a, b)

    monkeypatch.setattr(ssim_window.__class__, "__call__", spy)
    a = photo_image(120, 80, seed=1)
    tssim.ssim(a, noisy(a, 2), device=CPU)
    assert shapes == [(1, 80, 120)]


@pytest.mark.parametrize("shape", [(3, 40, 50), (2, 9, 20), (2, 8, 20),
                                   (1, 64, 33)])
def test_batched_ssim_matches_jax(shape):
    bsz, h, w = shape
    a = np.stack([photo_image(w, h, seed=k) for k in range(bsz)])
    b = np.stack([noisy(x, k) for k, x in enumerate(a)])
    got = tpar.batched_ssim(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jpar.batched_ssim(a, b))
    np.testing.assert_allclose(got.numpy(), want, atol=SSIM_ATOL, rtol=0)


# ── Effects ─────────────────────────────────────────────────────────────────

EFFECTS = [("sharpen", 0.7), ("sharpen", 1.5), ("adaptive_sharpen", 0.6),
           ("adaptive_sharpen", 1.0), ("gaussian_blur", 1.3),
           ("gaussian_blur", 3.0), ("gaussian_blur", 0.4)]
EFFECT_IMAGES = {
    "photo_97x61": lambda: photo_image(97, 61, seed=5),
    "noise_64x48": lambda: make_noise_image(64, 48, seed=6),
    "alpha_50x30": lambda: make_test_image_with_alpha(50, 30),
    "photo_530x700": lambda: photo_image(530, 700, seed=7),
    "side_3x5": lambda: make_noise_image(3, 5, seed=8),
}


@pytest.mark.parametrize("image", sorted(EFFECT_IMAGES))
@pytest.mark.parametrize("name,arg", EFFECTS,
                         ids=[f"{n}_{a}" for n, a in EFFECTS])
def test_effects_match_jax(image, name, arg):
    img = EFFECT_IMAGES[image]()
    want = np.asarray(getattr(jeffects, name)(img, arg))
    got = getattr(teffects, name)(img, arg, device=CPU)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if name != "gaussian_blur":
        assert not diff.any()
        return
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= TIE_SHARE * diff.size
    np.testing.assert_array_equal(got[..., 3], img[..., 3])


@pytest.mark.parametrize("name,arg", [("sharpen", 0.0), ("sharpen", -1.0),
                                      ("adaptive_sharpen", 0.0),
                                      ("gaussian_blur", 0.0),
                                      ("gaussian_blur", -2.0)])
def test_effects_no_op_returns_the_same_object(name, arg):
    img = photo_image(20, 10, seed=1)
    assert getattr(teffects, name)(img, arg, device=CPU) is img


@pytest.mark.parametrize("name", ["sharpen", "adaptive_sharpen"])
def test_sharpen_small_sides_and_borders(name):
    small = make_noise_image(2, 9, seed=2)
    assert getattr(teffects, name)(small, 0.5, device=CPU) is small
    img = make_noise_image(30, 20, seed=3)
    out = getattr(teffects, name)(img, 0.8, device=CPU)
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(out[edge], img[edge])
    np.testing.assert_array_equal(out[..., 3], img[..., 3])


# ── I/O ─────────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("orient", [1, 3, 6, 8])
def test_open_and_orient_matches_jax(tmp_path, orient):
    data = J.codecs.jpeg.encode_jpeg(photo_image(48, 32, seed=orient), 90)
    src = tmp_path / "in.jpg"
    src.write_bytes(data[:2] + write_exif_orientation(orient) + data[2:])
    want = J.open_and_orient(str(src))
    got = T.open_and_orient(str(src), device=CPU)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".png"])
def test_save_matches_jax(tmp_path, ext):
    img = photo_image(64, 48)
    J.save(img, str(tmp_path / f"j{ext}"))
    T.save(img, str(tmp_path / f"t{ext}"), device=CPU)
    assert (tmp_path / f"t{ext}").read_bytes() == \
        (tmp_path / f"j{ext}").read_bytes()


def test_save_refuses_other_extensions(tmp_path):
    with pytest.raises(T.UnsupportedFormatError):
        T.save(photo_image(8, 8), str(tmp_path / "x.gif"), device=CPU)


@pytest.mark.parametrize("fmt,opts", [
    ("JPEG", {}), ("JPEG", {"target_ssim": 0.97}),
    ("JPEG", {"optimize_huffman": False}), ("PNG", {})],
    ids=["jpeg", "jpeg-ssim", "jpeg-std", "png"])
def test_encode_matches_jax(fmt, opts):
    img = photo_image(64, 48)
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    J.encode(jbuf, img, getattr(J, fmt), J.Options(**opts))
    T.encode(tbuf, img, getattr(T, fmt), T.Options(**opts), device=CPU)
    assert tbuf.getvalue() == jbuf.getvalue()
    with pytest.raises(T.UnsupportedFormatError):
        T.encode(io.BytesIO(), img, T.AUTO, device=CPU)


def test_port_exports_every_jax_name():
    names = [n for n, v in vars(J).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    missing = [n for n in names if not hasattr(T, n)]
    assert not missing, missing
    for n in ("ssim", "ms_ssim", "sharpen", "adaptive_sharpen",
              "gaussian_blur", "lanczos_resize", "smart_resize",
              "box_downsample", "encode", "save", "open_and_orient"):
        assert callable(getattr(T, n)), n
