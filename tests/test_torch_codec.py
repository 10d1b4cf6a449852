"""Codecs of the PyTorch port against the JAX package.

PNG encode, the JPEG container, Huffman specs and the JPEG entropy
encode must be byte-identical given the same inputs.  decode_jpeg must
give the JAX package's pixels on JPEGs this test makes itself.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (
    make_noise_image,
    make_striped_image,
    make_test_image,
    make_test_image_with_alpha,
)
from fennec_tpu import native as jnative
from fennec_tpu.codecs import huffopt as jhuff
from fennec_tpu.codecs import jpeg as jjpeg
from fennec_tpu.codecs import png as jpng
from fennec_tpu.engine.compress import compress_png as jax_compress_png
from fennec_tpu.ops.dct import all_quality_tables
from fennec_tpu_torch import native as tnative
from fennec_tpu_torch.codecs import huffopt as thuff
from fennec_tpu_torch.codecs import jpeg as tjpeg
from fennec_tpu_torch.codecs import png as tpng
from fennec_tpu_torch.engine.compress import compress_png
from fennec_tpu_torch.types import UnsupportedFormatError
from test_cmyk import _encode_4comp
from test_multiscan import build_multiscan_jpeg

torch.set_num_threads(1)


def pil_jpeg(img, quality=90, subsampling=2, progressive=False, mode="RGB"):
    from PIL import Image

    buf = io.BytesIO()
    src = img[..., 0] if mode == "L" else img[..., :3]
    Image.fromarray(src, mode).save(buf, "JPEG", quality=quality,
                                    subsampling=subsampling,
                                    progressive=progressive)
    return buf.getvalue()


class TestPng:
    @pytest.mark.parametrize("make", [
        lambda: make_test_image_with_alpha(37, 23),
        lambda: make_striped_image(64, 16),
        lambda: make_noise_image(20, 30),
        lambda: np.repeat(make_test_image(33, 17)[..., :1], 4, axis=2),
    ], ids=["rgba", "palette", "noise", "gray"])
    def test_compress_png_identical(self, make):
        img = make()
        img[..., 3] = np.maximum(img[..., 3], 1)
        assert compress_png(img) == jax_compress_png(img)

    @pytest.mark.parametrize("encode", ["encode_png_rgba",
                                        "encode_png_gray"])
    def test_encoders_identical(self, encode):
        img = make_noise_image(19, 11)
        arg = img[..., 0] if encode == "encode_png_gray" else img
        assert getattr(tpng, encode)(arg) == getattr(jpng, encode)(arg)

    def test_decode_matches(self):
        img = make_test_image_with_alpha(31, 29)
        data = jpng.encode_png_rgba(img)
        np.testing.assert_array_equal(tpng.decode_png(data),
                                      jpng.decode_png(data))


class TestJpegContainer:
    def test_segments(self):
        qt = all_quality_tables()[77]
        assert tjpeg._dqt_segment(qt) == jjpeg._dqt_segment(qt)
        assert tjpeg._dht_segment() == jjpeg._dht_segment()
        for ncomp, sub in ((1, False), (3, True), (3, False)):
            assert (tjpeg._sof0_segment(123, 45, ncomp, sub)
                    == jjpeg._sof0_segment(123, 45, ncomp, sub))
            assert tjpeg._sos_segment(ncomp) == jjpeg._sos_segment(ncomp)

    def test_assemble(self):
        qt = all_quality_tables()[31]
        scan = bytes(range(200))
        assert (tjpeg.assemble_jpeg(64, 48, qt, scan, True)
                == jjpeg.assemble_jpeg(64, 48, qt, scan, True))


def jax_coefs(img, subsample):
    """The JAX forward DCT's blocks: one input for both encoders."""
    c = jjpeg.forward_dct_device(jnp.asarray(img, dtype=jnp.float32),
                                 subsample)
    return [np.asarray(x) for x in c]


class TestJpegEncode:
    @pytest.mark.parametrize("optimize", [False, True])
    @pytest.mark.parametrize("subsample", [True, False])
    @pytest.mark.parametrize("quality", [1, 50, 92, 100])
    def test_encode_from_coefs_identical(self, optimize, subsample, quality):
        img = make_noise_image(45, 29, seed=quality)
        coefs = jax_coefs(img, subsample)
        want = jjpeg.encode_jpeg_from_coefs(
            [jnp.asarray(c) for c in coefs], 45, 29, quality, subsample,
            optimize=optimize)
        got = tjpeg.encode_jpeg_from_coefs(
            [torch.tensor(c) for c in coefs], 45, 29, quality,
            subsample, optimize=optimize)
        assert got == want

    def test_huffman_specs_identical(self):
        img = make_test_image(64, 48)
        coefs = jax_coefs(img, True)
        qt = all_quality_tables()[85]
        q = [np.asarray(x, dtype=np.int32)
             for x in jjpeg.quantize_coefs_device(
                 [jnp.asarray(c) for c in coefs], jnp.asarray(qt), True)]
        comps = jjpeg._build_comps(*q, 64, 48, True)
        dc, ac = jnative.jpeg_count_symbols(comps)
        tdc, tac = tnative.jpeg_count_symbols(tjpeg._build_comps(
            *q, 64, 48, True))
        np.testing.assert_array_equal(tdc, dc)
        np.testing.assert_array_equal(tac, ac)
        assert (thuff.specs_from_frequencies(dc, ac)
                == jhuff.specs_from_frequencies(dc, ac))


class TestJpegDecode:
    @pytest.mark.parametrize("make", [
        lambda: pil_jpeg(make_test_image(67, 45), 90, subsampling=2),
        lambda: pil_jpeg(make_noise_image(40, 33), 75, subsampling=0),
        lambda: pil_jpeg(make_noise_image(50, 20), 60, subsampling=1),
        lambda: pil_jpeg(make_test_image(30, 26), 85, mode="L"),
        lambda: jjpeg.encode_jpeg(make_noise_image(48, 40, seed=5), 92),
        lambda: _encode_4comp([make_test_image(32, 24)[..., i]
                               for i in (0, 1, 2, 2)], 32, 24, 95, 0),
        lambda: _encode_4comp([make_test_image(32, 24)[..., i]
                               for i in (0, 1, 2, 2)], 32, 24, 95, 2),
    ], ids=["420", "444", "422", "gray", "own", "cmyk", "ycck"])
    def test_matches_jax_decode(self, make):
        data = make()
        got = tjpeg.decode_jpeg(data, device="cpu")
        want = jjpeg.decode_jpeg(data)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)

    def test_port_encode_decodes_in_jax(self):
        img = make_noise_image(36, 28, seed=9)
        data = tjpeg.encode_jpeg(img, 88, device="cpu")
        assert data == jjpeg.encode_jpeg(img, 88)
        np.testing.assert_array_equal(tjpeg.decode_jpeg(data, device="cpu"),
                                      jjpeg.decode_jpeg(data))

    def test_progressive_raises(self):
        data = pil_jpeg(make_test_image(32, 32), progressive=True)
        with pytest.raises(UnsupportedFormatError, match="later slice"):
            tjpeg.decode_jpeg(data, device="cpu")

    def test_multiscan_raises(self):
        data = build_multiscan_jpeg(make_noise_image(24, 16))
        with pytest.raises(UnsupportedFormatError, match="later slice"):
            tjpeg.decode_jpeg(data, device="cpu")
