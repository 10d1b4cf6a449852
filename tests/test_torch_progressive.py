"""Progressive and multi-scan JPEG decode of the PyTorch port against the
JAX package.

Inputs are made here from numpy seeds: progressive files by PIL, as
tests/test_progressive.py makes them, and baseline multi-scan files by
tests/test_multiscan.py's build_multiscan_jpeg.  The entropy decode
gives both packages the same coefficients, which the tests hold to
exact equality.  Both then run the same float32 dequantize → IDCT →
colour model, but XLA's dot and torch's GEMM sum the IDCT products in
another order: where a pixel's exact value is a rounding tie, the two
can round to neighbours.  Decoded pixels must therefore be equal or
differ by one level, at no more than 1 value in 100 000 (the small
inputs come out equal; the 1280×720 fixtures differ at 2 of 3.7 million
values).  compress_bytes on these inputs must choose the same quality
with SSIM within 1e-5.
"""

import io
import pathlib
import struct

import numpy as np
import pytest
import torch

from conftest import make_noise_image, make_striped_image, make_test_image
from fennec_tpu.codecs import jpeg as jjpeg
from fennec_tpu.codecs import progressive as jprog
import fennec_tpu as J
import fennec_tpu_torch as T
from fennec_tpu_torch import native as tnative
from fennec_tpu_torch.codecs import jpeg as tjpeg
from fennec_tpu_torch.codecs import progressive as tprog
from fennec_tpu_torch.types import UnsupportedFormatError
from test_multiscan import build_multiscan_jpeg

torch.set_num_threads(1)

SSIM_ATOL = 1e-5
FIXTURES = pathlib.Path(__file__).resolve().parent / "torch_fixtures"
# libjpeg (PIL) decodes with an integer IDCT and fixed-point colour
# conversion; the float32 decode of both packages lands within a few
# levels of it (measured on the fixtures: at most 5, mean 0.28).
PIL_MAX_DIFF = 8
PIL_MEAN_DIFF = 0.5
TIE_SHARE = 1e-5  # of the decoded values that may differ by one level


def assert_same_decode(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert np.count_nonzero(diff) <= TIE_SHARE * diff.size


def pil_progressive(img, quality=90, subsampling=2, gray=False) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    if gray:
        Image.fromarray(img[..., 0], "L").save(
            buf, "JPEG", quality=quality, progressive=True)
    else:
        Image.fromarray(img[..., :3], "RGB").save(
            buf, "JPEG", quality=quality, progressive=True,
            subsampling=subsampling)
    return buf.getvalue()


INPUTS = {
    "prog_420": lambda: pil_progressive(make_test_image(96, 64)),
    "prog_444": lambda: pil_progressive(make_noise_image(70, 46, seed=90),
                                        subsampling=0),
    "prog_422": lambda: pil_progressive(make_noise_image(48, 40, seed=4),
                                        subsampling=1),
    "prog_gray": lambda: pil_progressive(make_test_image(40, 40), gray=True),
    "prog_odd": lambda: pil_progressive(make_noise_image(53, 37, seed=5),
                                        quality=92),
    "prog_q30": lambda: pil_progressive(make_striped_image(64, 64), 30),
    "multi_48": lambda: build_multiscan_jpeg(make_noise_image(48, 48,
                                                              seed=48)),
    "multi_40x24": lambda: build_multiscan_jpeg(make_noise_image(40, 24,
                                                                 seed=40)),
    "multi_33x17": lambda: build_multiscan_jpeg(make_noise_image(33, 17,
                                                                 seed=33)),
    "multi_grad": lambda: build_multiscan_jpeg(make_test_image(64, 48), 90),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decode_matches_jax(name):
    data = INPUTS[name]()
    assert tjpeg.is_progressive_jpeg(data) == jjpeg.is_progressive_jpeg(data)
    assert_same_decode(tjpeg.decode_jpeg(data, device="cpu"),
                       jjpeg.decode_jpeg(data))


@pytest.mark.parametrize("name", ["prog_420", "prog_444", "prog_gray",
                                  "prog_q30"])
def test_progressive_coefficients_match_jax(name):
    data = INPUTS[name]()
    _, got = tprog.decode_progressive_to_coefs(data)
    _, want = jprog.decode_progressive_to_coefs(data)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_python_scan_decoder_matches_native(monkeypatch):
    """A scan the C++ decoder rejects is rerun by the Python decoder from
    the same state; forced for every scan, it gives the same
    coefficients."""
    data = INPUTS["prog_444"]()
    fast = tprog.ProgressiveDecoder(data).decode()

    def reject(*args, **kwargs):
        raise ValueError("fennec native: corrupt progressive scan")

    monkeypatch.setattr(tnative, "jpeg_decode_progressive_scan", reject)
    slow = tprog.ProgressiveDecoder(data).decode()
    for a, b in zip(fast.coefs, slow.coefs):
        np.testing.assert_array_equal(a, b)


def test_native_binding_restores_coefs_on_corrupt_scan():
    """The C++ decoder writes the first block of this DC scan, then meets
    a code its table lacks: the binding raises and puts the
    coefficients back as they were."""
    coefs = [np.arange(1, 4 * 64 + 1, dtype=np.int32).reshape(4, 64)]
    before = coefs[0].copy()
    data = b"\x7f" + b"\xfe" * 16  # '0' (size 0), then only 1-bits
    spec = ([1] + [0] * 15, [0])  # one 1-bit code: '0' → size 0
    with pytest.raises(ValueError):
        tnative.jpeg_decode_progressive_scan(
            data, 0, coefs, [2], [1], [1], 2, 2, [2], [2], 0, 0, 0, 0,
            [spec], None, 0)
    np.testing.assert_array_equal(coefs[0], before)


@pytest.mark.parametrize("name", ["prog_420", "prog_odd", "multi_48",
                                  "multi_grad"])
def test_compress_bytes_matches_jax(name):
    data = INPUTS[name]()
    rj = J.compress_bytes(None, data, J.Options(format=J.JPEG))
    rt = T.compress_bytes(None, data, T.Options(format=T.JPEG),
                          device="cpu")
    assert rt.jpeg_quality == rj.jpeg_quality
    assert abs(rt.ssim - rj.ssim) <= SSIM_ATOL
    assert rt.final_dimensions == rj.final_dimensions


def test_interleaved_progressive_ac_scan_rejected():
    """A progressive AC scan that declares 2 components must raise, not
    desynchronize (tests/test_codec_hardening.py:141, PARITY.md:116-119)."""
    data = pil_progressive(make_test_image(32, 32), quality=80)
    i, patched = 2, None
    while i < len(data) - 3:
        if data[i] == 0xFF and data[i + 1] == 0xDA:
            ln = struct.unpack(">H", data[i + 2:i + 4])[0]
            body = bytearray(data[i + 4:i + 2 + ln + 2])
            ns, ss = body[0], body[1 + body[0] * 2]
            if ns == 1 and ss > 0:
                newbody = (bytes([2]) + bytes(body[1:3]) * 2
                           + bytes(body[3:]))
                seg = struct.pack(">H", len(newbody) + 2) + newbody
                patched = data[:i + 2] + seg + data[i + 4 + ln - 2:]
                break
            i += 2 + ln
        else:
            i += 1
    assert patched is not None, "no AC scan found to patch"
    with pytest.raises((ValueError, UnsupportedFormatError)):
        tprog.decode_progressive_to_coefs(patched)
    with pytest.raises((ValueError, UnsupportedFormatError)):
        jprog.decode_progressive_to_coefs(patched)


def test_parse_jpeg_refuses_progressive():
    with pytest.raises(UnsupportedFormatError, match="progressive decoder"):
        tjpeg.parse_jpeg(INPUTS["prog_420"]())


@pytest.mark.parametrize("name", ["progressive_1280x720.jpg",
                                  "multiscan_1280x720.jpg"])
def test_card_fixture_decodes(name):
    """The committed fixtures the card check decodes: the port's decode
    matches the JAX package's and stays within libjpeg's rounding of
    PIL's decode."""
    from PIL import Image

    data = (FIXTURES / name).read_bytes()
    assert tjpeg.is_progressive_jpeg(data) == name.startswith("progressive")
    got = tjpeg.decode_jpeg(data, device="cpu")
    assert got.shape == (720, 1280, 4)
    assert_same_decode(got, jjpeg.decode_jpeg(data))
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    diff = np.abs(got.astype(int) - pil.astype(int))
    assert diff.max() <= PIL_MAX_DIFF and diff.mean() <= PIL_MEAN_DIFF


def test_multiscan_fixture_is_reproducible():
    from torch_fixtures.make_fixtures import SEED, H, W, photo

    data = (FIXTURES / "multiscan_1280x720.jpg").read_bytes()
    assert data == build_multiscan_jpeg(photo(W, H, SEED + 1), 85)
