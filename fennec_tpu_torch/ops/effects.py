"""Image effects: unsharp-mask sharpen, edge-aware sharpen, separable
Gaussian blur, in torch.

Counterpart of fennec_tpu/ops/effects.py (reference effects.go), with
its semantics:

  - sharpen:          amount = 1 + 1.5·strength (effects.go:10-45)
  - adaptive_sharpen: amount = 1 + 2·strength, scaled per pixel by the
                      Sobel edge strength over 400, clipped to [0, 1]
                      (effects.go:49-112)
  - gaussian_blur:    separable, radius = ceil(3σ), edges clamped, RGB
                      only (effects.go:146-220)
  - the 3×3 effects leave a 1 px border untouched, as the reference's
    interior loops do (effects.go:70, 122); alpha passes through;
  - strength <= 0 (σ <= 0 for the blur), and for the sharpens a side
    under 3 px, return the very object given (fennec_test.go:632-639).

Every pass is float32 slice arithmetic on the device, in the JAX
package's order: the blur's taps are added in order k = 0..2r, not a
conv2d (cuDNN would run it in TF32).  Pixels round half away from zero
(ops/color.clamp_u8), never torch.round's half to even.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..image import to_nrgba_ref
from .color import clamp_u8, luminance
from .filters import gaussian_blur_kernel


def _blur3x3_rgb(img: torch.Tensor) -> torch.Tensor:
    """3×3 binomial blur of the RGB channels of (H, W, 4) float32, each
    blurred texel rounded; the border keeps the source values
    (effects.go:116-141)."""
    rgb = img[..., :3]
    hsum = (rgb[:, :-2] + 2.0 * rgb[:, 1:-1] + rgb[:, 2:]) * 0.25
    inner = (hsum[:-2] + 2.0 * hsum[1:-1] + hsum[2:]) * 0.25
    out = rgb.clone()
    out[1:-1, 1:-1] = clamp_u8(inner)
    return out


def _sobel_edge_strength(lum: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude / 400 clipped to [0, 1] on the interior
    (effects.go:93-112): (H, W) → (H-2, W-2)."""
    tl, tc, tr = lum[:-2, :-2], lum[:-2, 1:-1], lum[:-2, 2:]
    ml, mr = lum[1:-1, :-2], lum[1:-1, 2:]
    bl, bc, br = lum[2:, :-2], lum[2:, 1:-1], lum[2:, 2:]
    gx = -tl + tr - 2.0 * ml + 2.0 * mr - bl + br
    gy = -tl - 2.0 * tc - tr + bl + 2.0 * bc + br
    return torch.clamp(torch.sqrt(gx * gx + gy * gy) / 400.0, 0.0, 1.0)


def _amount(strength: float, per_unit: float) -> float:
    """1 + per_unit·min(1, strength), rounded as float32 arithmetic."""
    s = np.float32(min(1.0, float(strength)))
    return float(np.float32(1.0) + s * np.float32(per_unit))


def _pixels(arr: np.ndarray, device: _device.DeviceLike) -> torch.Tensor:
    return torch.from_numpy(arr).to(_device.resolve(device)).to(
        torch.float32)


def _to_host(rgb: torch.Tensor, src: torch.Tensor) -> np.ndarray:
    """Round the RGB, put the source alpha back, (H, W, 4) uint8."""
    out = torch.cat([clamp_u8(rgb), src[..., 3:4]], dim=-1)
    return out.to(torch.uint8).cpu().numpy()


def sharpen(img, strength: float, device: _device.DeviceLike = None):
    """Unsharp-mask sharpening, strength in [0, 1] (effects.go:10-45)."""
    if strength <= 0:
        return img
    arr = to_nrgba_ref(np.asarray(img))
    h, w = arr.shape[:2]
    if w < 3 or h < 3:
        return img
    x = _pixels(arr, device)
    rgb = x[..., :3]
    out = rgb + _amount(strength, 1.5) * (rgb - _blur3x3_rgb(x))
    return _to_host(out, x)


def adaptive_sharpen(img, strength: float,
                     device: _device.DeviceLike = None):
    """Edge-aware sharpening that leaves smooth areas untouched
    (effects.go:49-90)."""
    if strength <= 0:
        return img
    arr = to_nrgba_ref(np.asarray(img))
    h, w = arr.shape[:2]
    if w < 3 or h < 3:
        return img
    x = _pixels(arr, device)
    rgb = x[..., :3]
    blurred = _blur3x3_rgb(x)
    local = (_amount(strength, 2.0)
             * _sobel_edge_strength(luminance(x)))[..., None]
    mid = rgb[1:-1, 1:-1]
    out = rgb.clone()
    out[1:-1, 1:-1] = clamp_u8(mid + local * (mid - blurred[1:-1, 1:-1]))
    return _to_host(out, x)


def _blur_axis(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    """Edge-clamped 1-D blur of (H, W, C) along `dim`, taps added in
    order."""
    r = taps.shape[0] // 2
    n = x.shape[dim]
    edge = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    padded = x.index_select(dim, edge)
    out = None
    for k in range(taps.shape[0]):
        term = padded.narrow(dim, k, n) * taps[k]
        out = term if out is None else out + term
    return out


def gaussian_blur(img, sigma: float, device: _device.DeviceLike = None):
    """Gaussian blur with the given σ (effects.go:146-220): horizontal
    pass, then vertical, edges clamped; alpha passes through."""
    if sigma <= 0:
        return img
    arr = to_nrgba_ref(np.asarray(img))
    x = _pixels(arr, device)
    taps = torch.from_numpy(gaussian_blur_kernel(float(sigma)).astype(
        np.float32)).to(x.device)
    rgb = _blur_axis(_blur_axis(x[..., :3], taps, 1), taps, 0)
    return _to_host(rgb, x)
