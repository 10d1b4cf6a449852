"""Kernel K1 and the main path on a CUDA card (skipped without one).

This file imports neither jax nor tests/conftest.py (which imports jax),
so it runs on the machine with the card, where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -o addopts= --noconftest

K1 is held to its plain PyTorch version on the same card within 1e-5,
the bound the JAX package holds its Pallas kernel to.
"""

import numpy as np
import pytest
import torch

import fennec_tpu_torch as T
from fennec_tpu_torch.ops.ssim import batched_ssim_plain
from fennec_tpu_torch.ops.ssim_cuda import ssim_window

pytestmark = pytest.mark.requires_cuda

ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def noise_pair(shape, seed, device):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255).astype(np.float32)
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


@pytest.mark.parametrize("shape", [(3, 32, 32), (3, 64, 48), (3, 130, 100),
                                   (1, 384, 512), (4, 288, 512),
                                   (2, 9, 300)])
def test_kernel_matches_plain(cuda_device, shape):
    a, b = noise_pair(shape, sum(shape), cuda_device)
    before = ssim_window.launches
    got = ssim_window(a, b)
    ones = ssim_window(a, a.clone())
    torch.cuda.synchronize()
    assert ssim_window.launches == before + 2
    torch.testing.assert_close(got, batched_ssim_plain(a, b), atol=ATOL,
                               rtol=0)
    torch.testing.assert_close(ones, torch.ones_like(ones), atol=ATOL,
                               rtol=0)


def test_kernel_is_deterministic(cuda_device):
    a, b = noise_pair((2, 1080, 1920), 7, cuda_device)
    first = ssim_window(a, b)
    assert all(torch.equal(first, ssim_window(a, b)) for _ in range(5))


def test_kernel_rejects_bad_inputs_on_card(cuda_device):
    a, b = noise_pair((1, 40, 40), 1, cuda_device)
    with pytest.raises(TypeError):
        ssim_window(a.half(), b.half())
    with pytest.raises(ValueError):
        ssim_window(a[:, :8], b[:, :8])


def test_main_path_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    img = np.full((240, 320, 4), 255, np.uint8)
    img[..., :3] = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    before = ssim_window.launches
    r_gpu = T.compress_image(None, img, T.Options(), device=cuda_device)
    assert ssim_window.launches == before + 7
    r_cpu = T.compress_image(None, img, T.Options(), device="cpu")
    assert r_gpu.format == r_cpu.format == T.JPEG
    assert r_gpu.jpeg_quality == r_cpu.jpeg_quality
    assert abs(r_gpu.ssim - r_cpu.ssim) <= ATOL
