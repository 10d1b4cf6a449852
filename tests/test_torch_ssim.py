"""Windowed SSIM in the PyTorch port against the JAX package.

The plain torch version (fennec_tpu_torch/ops/ssim.py) is held against
the JAX windowed SSIM and the Pallas kernel in interpret mode, on the
same numpy inputs, at the bound the JAX package holds its own kernel to
(atol 1e-5, tests/test_ssim_pallas.py).  The K1 wrapper's CPU route and
its input checks run here; the kernel itself is tested on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_noise_image, make_test_image
from fennec_tpu.ops.ssim import (
    ssim_fast_dims as jax_ssim_fast_dims,
    ssim_map_device,
    windowed_ssim_device,
)
from fennec_tpu.ops.ssim_pallas import batched_ssim_pallas
from fennec_tpu_torch.ops import ssim as tssim
from fennec_tpu_torch.ops.ssim_cuda import WindowedSsimKernel, ssim_window

torch.set_num_threads(1)


def lum_np(images):
    """float32 BT.601 luminance, computed once in numpy for both sides."""
    a = np.stack(images).astype(np.float32)
    return (np.float32(0.299) * a[..., 0] + np.float32(0.587) * a[..., 1]
            + np.float32(0.114) * a[..., 2]).astype(np.float32)


def noise_pairs(h, w, n=3):
    a = [make_noise_image(w, h, seed=i) for i in range(n)]
    b = [np.clip(x.astype(int) + (i + 1) * 5, 0, 255).astype(np.uint8)
         for i, x in enumerate(a)]
    return lum_np(a), lum_np(b)


class TestPlainAgainstJax:
    @pytest.mark.parametrize("shape", [(32, 32), (64, 48), (130, 100)])
    def test_matches_jnp_and_pallas(self, shape):
        la, lb = noise_pairs(*shape)
        got = tssim.batched_ssim_plain(torch.from_numpy(la),
                                       torch.from_numpy(lb)).numpy()
        want = np.asarray([windowed_ssim_device(
            jnp.asarray(la[i]), jnp.asarray(lb[i])) for i in range(3)])
        pallas = np.asarray(batched_ssim_pallas(jnp.asarray(la),
                                                jnp.asarray(lb), True))
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, pallas, atol=1e-5)

    def test_map_matches_jnp(self):
        la, lb = noise_pairs(40, 56, n=1)
        got = tssim.ssim_map(torch.from_numpy(la[0]),
                             torch.from_numpy(lb[0])).numpy()
        want = np.asarray(ssim_map_device(jnp.asarray(la[0]),
                                          jnp.asarray(lb[0])))
        assert got.shape == want.shape == (32, 48)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_premaps_split_is_exact(self):
        """The hoisted a-side stats give the same numbers as ssim_map."""
        la, lb = noise_pairs(30, 45, n=2)
        a, b = torch.from_numpy(la), torch.from_numpy(lb)
        full = tssim.ssim_map(a, b)
        split = tssim.ssim_map_pre(tssim.ssim_premaps(a), a, b)
        assert torch.equal(full, split)

    def test_identical_is_one(self):
        la = lum_np([make_test_image(40, 40)])
        t = torch.from_numpy(la)
        got = tssim.batched_ssim_plain(t, t).numpy()
        np.testing.assert_allclose(got, 1.0, atol=1e-5)

    @pytest.mark.parametrize("shape", [(8, 40), (40, 8), (8, 8)])
    def test_exactly_8px_guard(self, shape):
        la, lb = noise_pairs(*shape, n=1)
        got = float(tssim.windowed_ssim(torch.from_numpy(la[0]),
                                        torch.from_numpy(lb[0])))
        want = float(windowed_ssim_device(jnp.asarray(la[0]),
                                          jnp.asarray(lb[0])))
        assert got == want == 1.0

    @pytest.mark.parametrize("wh", [(64, 48), (512, 512), (513, 100),
                                    (4032, 3024), (1920, 1080),
                                    (10000, 9), (3000, 40)])
    def test_ssim_fast_dims(self, wh):
        assert tssim.ssim_fast_dims(*wh) == jax_ssim_fast_dims(*wh)


class TestKernelWrapper:
    def test_cpu_route_is_plain(self):
        la, lb = noise_pairs(33, 47)
        a, b = torch.from_numpy(la), torch.from_numpy(lb)
        k = WindowedSsimKernel()
        got = k(a, b)
        assert torch.equal(got, tssim.batched_ssim_plain(a, b))
        assert k.launches == 0  # the plain route launches nothing

    @pytest.mark.parametrize("bad", [
        lambda a, b: (a.double(), b.double()),
        lambda a, b: (a[0], b[0]),
        lambda a, b: (a[:, :8], b[:, :8]),
        lambda a, b: (a[:, :, :8], b[:, :, :8]),
        lambda a, b: (a.transpose(1, 2), b.transpose(1, 2)),
        lambda a, b: (a, b[:, 1:]),
        lambda a, b: (a.numpy(), b.numpy()),
    ], ids=["float64", "2d", "h8", "w8", "noncontig", "mismatch", "numpy"])
    def test_rejects_bad_inputs(self, bad):
        la, lb = noise_pairs(20, 24, n=2)
        a, b = bad(torch.from_numpy(la), torch.from_numpy(lb))
        with pytest.raises((TypeError, ValueError)):
            ssim_window(a, b)
