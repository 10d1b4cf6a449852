"""Tensor ops and host tables of the PyTorch port against the JAX package.

Same numpy inputs to both.  Float planes agree within 1e-4 (the two
frameworks sum matmuls in different orders); values rounded to integers
must be equal.  Every constant table (the system's only weights) must be
equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (
    make_noise_image,
    make_test_image,
    make_test_image_with_alpha,
)
from fennec_tpu.codecs import tables as jtables
from fennec_tpu.codecs.jpeg import forward_dct_device
from fennec_tpu.engine import compress as jcomp
from fennec_tpu.ops import color as jcolor
from fennec_tpu.ops import dct as jdct
from fennec_tpu.ops import filters as jfilters
from fennec_tpu.ops.resize import lanczos_resize as jax_lanczos_resize
from fennec_tpu.ops.resize import smart_resize_dims as jax_smart_resize_dims
from fennec_tpu_torch.codecs import tables as ttables
from fennec_tpu_torch.codecs.jpeg import forward_dct
from fennec_tpu_torch.engine import compress as tcomp
from fennec_tpu_torch.engine import size_search as tsize
from fennec_tpu_torch.ops import color as tcolor
from fennec_tpu_torch.ops import dct as tdct
from fennec_tpu_torch.ops import filters as tfilters
from fennec_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)

FLOAT_ATOL = 1e-4


def rgb_f32(w=40, h=24, seed=0):
    return make_noise_image(w, h, seed=seed).astype(np.float32)


def t(x):
    return torch.tensor(np.asarray(x))


class TestTablesExact:
    @pytest.mark.parametrize("name", [
        "STD_LUMA_QUANT", "STD_CHROMA_QUANT", "ZIGZAG"])
    def test_dct_module_arrays(self, name):
        np.testing.assert_array_equal(getattr(tdct, name),
                                      getattr(jdct, name))

    @pytest.mark.parametrize("fn", ["all_quality_tables", "dct_matrix",
                                    "dct_kron"])
    def test_dct_tables(self, fn):
        a, b = getattr(tdct, fn)(), getattr(jdct, fn)()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("on, fn", [
        (tdct._kron_on, "dct_kron"), (tcomp._dmat_on, "dct_matrix"),
        (tsize.quality_tables_on, "all_quality_tables")],
        ids=["dct_kron", "dct_matrix", "quality_tables"])
    def test_device_constants_are_the_jax_tables_uploaded_once(self, on, fn):
        """The tables every call reads are JAX's, in float32, made once per
        device and shared by threads (device.constant_on)."""
        from concurrent.futures import ThreadPoolExecutor

        dev = torch.device("cpu")
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda _: on(dev), range(16)))
        assert all(x is got[0] for x in got) and got[0] is on(dev)
        assert got[0].dtype == torch.float32
        np.testing.assert_array_equal(
            got[0].numpy(), getattr(jdct, fn)().astype(np.float32))

    @pytest.mark.parametrize("q", [1, 30, 50, 92, 100])
    def test_scale_quant_table(self, q):
        for base in (jdct.STD_LUMA_QUANT, jdct.STD_CHROMA_QUANT):
            np.testing.assert_array_equal(tdct.scale_quant_table(base, q),
                                          jdct.scale_quant_table(base, q))

    @pytest.mark.parametrize("name", [
        "DC_LUMA_BITS", "DC_LUMA_VALS", "DC_CHROMA_BITS", "DC_CHROMA_VALS",
        "AC_LUMA_BITS", "AC_LUMA_VALS", "AC_CHROMA_BITS", "AC_CHROMA_VALS"])
    def test_huffman_tables(self, name):
        assert getattr(ttables, name) == getattr(jtables, name)

    @pytest.mark.parametrize("args", [(8, 1.5), (11, 2.0)])
    def test_gaussian_window(self, args):
        np.testing.assert_array_equal(tfilters.gaussian_window_1d(*args),
                                      jfilters.gaussian_window_1d(*args))

    @pytest.mark.parametrize("fn", ["box_weights", "lanczos_weights"])
    @pytest.mark.parametrize("sizes", [(512, 4032), (384, 3024), (37, 120),
                                       (120, 37), (1920, 4032)])
    def test_resample_weights(self, fn, sizes):
        np.testing.assert_array_equal(getattr(tfilters, fn)(*sizes),
                                      getattr(jfilters, fn)(*sizes))


class TestColor:
    def test_rgb_to_ycbcr(self):
        x = rgb_f32()[..., :3]
        np.testing.assert_allclose(
            tcolor.rgb_to_ycbcr(t(x)).numpy(),
            np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(x))),
            atol=FLOAT_ATOL)

    def test_ycbcr_to_rgb(self):
        x = rgb_f32(seed=1)[..., :3]
        np.testing.assert_allclose(
            tcolor.ycbcr_to_rgb(t(x)).numpy(),
            np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(x))),
            atol=FLOAT_ATOL)

    def test_luminance(self):
        x = rgb_f32(seed=2)
        np.testing.assert_allclose(
            tcolor.luminance(t(x)).numpy(),
            np.asarray(jcolor.luminance_device(jnp.asarray(x))),
            atol=FLOAT_ATOL)

    def test_clamp_u8_rounds_half_away(self):
        x = np.array([-3.0, -0.5, 0.49, 0.5, 1.5, 2.5, 127.5, 254.5, 255.4,
                      300.0], np.float32)
        got = tcolor.clamp_u8(t(x)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jcolor.clamp_u8_device(jnp.asarray(x))))
        np.testing.assert_array_equal(
            got, [0, 0, 0, 1, 2, 3, 128, 255, 255, 255])


class TestDct:
    @pytest.mark.parametrize("subsample", [True, False])
    @pytest.mark.parametrize("wh", [(40, 24), (37, 21)])
    def test_forward_dct(self, subsample, wh):
        img = make_test_image_with_alpha(*wh).astype(np.float32)
        got = forward_dct(t(img), subsample)
        want = forward_dct_device(jnp.asarray(img), subsample)
        for g, w in zip(got, want):
            # Coefficients reach ~1000: a few float32 ulps of the sum.
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=FLOAT_ATOL, rtol=1e-6)

    def test_blocks_roundtrip_and_layout(self):
        p = np.arange(16 * 24, dtype=np.float32).reshape(16, 24)
        got = tdct.to_blocks(t(p)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jdct.to_blocks(jnp.asarray(p))))
        np.testing.assert_array_equal(
            tdct.from_blocks(t(got), 16, 24).numpy(), p)

    def test_dct_idct_blocks(self):
        b = rgb_f32(16, 16)[..., 0].reshape(-1, 64) - 128.0
        np.testing.assert_allclose(
            tdct.dct2d_blocks(t(b)).numpy(),
            np.asarray(jdct.dct2d_blocks(jnp.asarray(b))),
            atol=FLOAT_ATOL, rtol=1e-6)
        np.testing.assert_allclose(
            tdct.idct2d_blocks(t(b)).numpy(),
            np.asarray(jdct.idct2d_blocks(jnp.asarray(b))),
            atol=FLOAT_ATOL, rtol=1e-6)

    def test_quantize_dequantize_exact(self):
        rng = np.random.default_rng(3)
        c = rng.normal(0, 200, (30, 64)).astype(np.float32)
        c[0, :4] = [-3.0, 3.0, -1.5, 1.5]  # ties round away from zero
        q = jdct.all_quality_tables()[50][0]
        got = tdct.quantize_blocks(t(c), t(q)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jdct.quantize_blocks(jnp.asarray(c), jnp.asarray(q))))
        np.testing.assert_array_equal(
            tdct.dequantize_blocks(t(got), t(q)).numpy(),
            np.asarray(jdct.dequantize_blocks(jnp.asarray(got),
                                              jnp.asarray(q))))

    def test_pad_and_420(self):
        p = rgb_f32(21, 13)[..., 0]
        padded = tdct.pad_to_multiple(t(p), 16, 16)
        np.testing.assert_array_equal(padded.numpy(), np.asarray(
            jdct.pad_to_multiple(jnp.asarray(p), 16, 16)))
        np.testing.assert_allclose(
            tdct.downsample_420(padded).numpy(),
            np.asarray(jdct.downsample_420(jnp.asarray(padded.numpy()))),
            atol=FLOAT_ATOL)
        np.testing.assert_array_equal(
            tdct.upsample_420(t(p)).numpy(),
            np.asarray(jdct.upsample_420(jnp.asarray(p))))


def coef_plane(seed=0, h=32, w=48):
    img = make_noise_image(w, h, seed=seed).astype(np.float32)
    coefs = forward_dct_device(jnp.asarray(img), False)
    return np.asarray(jdct.from_blocks(coefs[0], h, w))


class TestProbeOps:
    def test_qd_plane_exact(self):
        cp = coef_plane()
        q88 = jdct.all_quality_tables()[40][0].reshape(8, 8)
        q88 = q88.astype(np.float32)
        np.testing.assert_array_equal(
            tcomp._qd_plane(t(cp), t(q88)).numpy(),
            np.asarray(jcomp._qd_plane(jnp.asarray(cp), jnp.asarray(q88))))

    def test_blockwise_idct_matches_kronecker(self):
        cp = coef_plane(seed=1)
        q88 = jdct.all_quality_tables()[70][0].reshape(8, 8)
        qd = np.asarray(jcomp._qd_plane(jnp.asarray(cp),
                                        jnp.asarray(q88.astype(np.float32))))
        dmat = t(jdct.dct_matrix().astype(np.float32))
        got = tcomp._idct_plane(t(qd)[None], dmat)[0].numpy()
        want = np.asarray(jcomp._idct_plane(jnp.asarray(qd)))
        np.testing.assert_allclose(got, want, atol=FLOAT_ATOL)

    def test_reconstruct_rgb_planes(self):
        img = make_test_image(40, 24).astype(np.float32)
        ycoefs = forward_dct_device(jnp.asarray(img), True)
        planes = (jdct.from_blocks(ycoefs[0], 32, 48)[None],
                  jdct.from_blocks(ycoefs[1], 16, 24)[None],
                  jdct.from_blocks(ycoefs[2], 16, 24)[None])
        qtab = jdct.all_quality_tables()[60].astype(np.float32)[None]
        want = jcomp._reconstruct_rgb_planes(*planes, jnp.asarray(qtab),
                                             True, 24, 40)
        dmat = t(jdct.dct_matrix().astype(np.float32))
        got = tcomp._reconstruct_rgb_planes(
            *(t(np.asarray(p)) for p in planes), t(qtab), dmat, True, 24, 40)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_box_down_plane(self):
        p = rgb_f32(130, 70, seed=4)[..., 1]
        wh, wv = tresize.box_resize_weights(130, 70, 40, 21)
        got = tcomp._box_down_plane(t(p), t(wh), t(wv)).numpy()
        want = np.asarray(jcomp._box_down_plane(
            jnp.asarray(p), jnp.asarray(wh), jnp.asarray(wv)))
        np.testing.assert_array_equal(got, want)

    def test_seed_lo(self):
        for target in (0.999, 0.99, 0.98, 0.97, 0.95, 0.94, 0.9, 0.85, 0.0):
            assert tcomp._seed_lo(target) == jcomp._seed_lo(target)


class TestResize:
    @pytest.mark.parametrize("dst", [(30, 20), (97, 61)])
    def test_lanczos_matches(self, dst):
        img = make_test_image_with_alpha(64, 40)
        got = tresize.lanczos_resize(img, *dst, device="cpu")
        want = jax_lanczos_resize(img, *dst)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("args", [(4032, 3024, 1920, 0),
                                      (1000, 500, 0, 300),
                                      (640, 480, 800, 600),
                                      (333, 777, 100, 100)])
    def test_smart_resize_dims(self, args):
        assert (tresize.smart_resize_dims(*args)
                == jax_smart_resize_dims(*args))

    def test_smart_resize_no_op_returns_input(self):
        img = make_test_image(32, 16)
        assert tresize.smart_resize(img, 64, 64, device="cpu") is img
