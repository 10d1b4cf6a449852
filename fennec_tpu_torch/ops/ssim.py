"""Windowed SSIM, the plain PyTorch version of kernel K1.

Counterpart of fennec_tpu/ops/ssim.py (device half).  Window semantics
are the reference's (ssim.go:73-166): an 8×8 Gaussian window (σ = 1.5)
over the half-open offset range [-4, 4), centres y ∈ [4, h-4) and
x ∈ [4, w-4), constants C1 = (0.01·255)² and C2 = (0.03·255)².

The separable window is eight slice-multiply-adds per axis, horizontal
pass first, taps added in order k = 0..7: the arithmetic of the JAX
package, op for op.  Not conv2d: cuDNN would run it in TF32 by default.
This module is what the CPU runs and what the CUDA kernel
(ops/ssim_cuda.py) is held against on the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .filters import gaussian_window_1d

SSIM_K1 = 0.01
SSIM_K2 = 0.03
SSIM_L = 255.0
SSIM_C1 = (SSIM_K1 * SSIM_L) ** 2
SSIM_C2 = (SSIM_K2 * SSIM_L) ** 2
WINDOW_SIZE = 8
GAUSS_SIGMA = 1.5


def gaussian_taps(device: torch.device) -> torch.Tensor:
    """The 8 window taps as a float32 tensor on `device`."""
    g = gaussian_window_1d(WINDOW_SIZE, GAUSS_SIGMA)
    return torch.tensor(g, dtype=torch.float32, device=device)


def _window_sum(x: torch.Tensor, g: torch.Tensor, dim: int,
                out_len: int) -> torch.Tensor:
    """Weighted sum of 8 shifted slices along `dim`, taps in order."""
    out = None
    for k in range(WINDOW_SIZE):
        term = x.narrow(dim, k, out_len) * g[k]
        out = term if out is None else out + term
    return out


def _sep_window(maps: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Separable windowed sums of (..., H, W) → (..., H-8, W-8)."""
    h, w = maps.shape[-2], maps.shape[-1]
    x = _window_sum(maps, g, -1, w - WINDOW_SIZE)
    return _window_sum(x, g, -2, h - WINDOW_SIZE)


def _ssim_formula(mu_a, mu_b, raw_aa, raw_bb, raw_ab) -> torch.Tensor:
    # σ = E[x²] − μ² in float32, as the reference kernel computes it.
    sig_aa = raw_aa - mu_a * mu_a
    sig_bb = raw_bb - mu_b * mu_b
    sig_ab = raw_ab - mu_a * mu_b
    num = (2.0 * mu_a * mu_b + SSIM_C1) * (2.0 * sig_ab + SSIM_C2)
    den = (mu_a * mu_a + mu_b * mu_b + SSIM_C1) * (sig_aa + sig_bb + SSIM_C2)
    return num / den


def ssim_map(lum_a: torch.Tensor, lum_b: torch.Tensor) -> torch.Tensor:
    """Per-window SSIM map: (..., H, W) float32 pairs, H, W > 8 →
    (..., H-8, W-8)."""
    g = gaussian_taps(lum_a.device)
    a, b = lum_a, lum_b
    stats = _sep_window(torch.stack([a, b, a * a, b * b, a * b]), g)
    return _ssim_formula(*stats)


def ssim_premaps(lum_a: torch.Tensor) -> torch.Tensor:
    """Loop-invariant a-side windowed stats (mu_a, raw_aa), shape
    (2, ..., H-8, W-8).  The quality search scores every probe against
    the same original, so these are computed once; each map's window sum
    is independent, so the split gives the same numbers as ssim_map."""
    g = gaussian_taps(lum_a.device)
    return _sep_window(torch.stack([lum_a, lum_a * lum_a]), g)


def ssim_map_pre(pre_a: torch.Tensor, lum_a: torch.Tensor,
                 lum_b: torch.Tensor) -> torch.Tensor:
    """ssim_map with the a-side stats precomputed by ssim_premaps."""
    g = gaussian_taps(lum_a.device)
    mu_b, raw_bb, raw_ab = _sep_window(
        torch.stack([lum_b, lum_b * lum_b, lum_a * lum_b]), g)
    return _ssim_formula(pre_a[0], mu_b, pre_a[1], raw_bb, raw_ab)


def batched_ssim_plain(lum_a: torch.Tensor,
                       lum_b: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float32 pairs, H, W > 8 → (B,) mean windowed SSIM."""
    return ssim_map(lum_a, lum_b).mean(dim=(-2, -1))


def windowed_ssim(lum_a: torch.Tensor, lum_b: torch.Tensor) -> torch.Tensor:
    """Mean windowed SSIM of one (H, W) pair (reference ssim.go:73-166).
    A side of 8 px or less has no window position; the reference then
    returns 1.0 (ssim.go:162-164)."""
    if lum_a.shape[-2] <= WINDOW_SIZE or lum_a.shape[-1] <= WINDOW_SIZE:
        return torch.ones((), dtype=torch.float32, device=lum_a.device)
    return ssim_map(lum_a, lum_b).mean()


def ssim_fast_dims(w: int, h: int, max_dim: int = 512) -> Tuple[int, int]:
    """Downsample target for SSIMFast (reference ssim.go:52-60)."""
    if w <= max_dim and h <= max_dim:
        return w, h
    scale = max_dim / max(w, h)
    new_w = int(max(8, math.floor(w * scale + 0.5)))
    new_h = int(max(8, math.floor(h * scale + 0.5)))
    return new_w, new_h
