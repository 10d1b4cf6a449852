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

It also holds the host APIs (JAX ops/ssim.py:239-404): ssim at full
resolution, SSIMFast on images (ssim_fast_images, ssim_fast: box-
downsample to at most 512 px, luminance, then windowed SSIM), ms_ssim
over five scales, pixel_ssim and compute_ssim_nrgba.  Windowed scores go
through K1's wrapper, which launches the kernel on CUDA tensors and takes
batched_ssim_plain on CPU tensors.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import device as _device
from ..image import to_nrgba_ref
from .color import luminance
from .filters import gaussian_window_1d
from .resize import (
    box_downsample_device,
    box_weights_device,
    lanczos_resize,
    lanczos_resize_device,
    lanczos_weights_device,
)

SSIM_K1 = 0.01
SSIM_K2 = 0.03
SSIM_L = 255.0
SSIM_C1 = (SSIM_K1 * SSIM_L) ** 2
SSIM_C2 = (SSIM_K2 * SSIM_L) ** 2
WINDOW_SIZE = 8
GAUSS_SIGMA = 1.5
MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


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


def pixel_ssim_lum(lum_a: torch.Tensor, lum_b: torch.Tensor) -> torch.Tensor:
    """Global-moment SSIM of (B, H, W) luminance pairs, for images under
    8 px (reference ssim.go:169-204) → (B,)."""
    mu_a = lum_a.mean(dim=(1, 2))
    mu_b = lum_b.mean(dim=(1, 2))
    da = lum_a - mu_a[:, None, None]
    db = lum_b - mu_b[:, None, None]
    num = (2 * mu_a * mu_b + SSIM_C1) * (2 * (da * db).mean(dim=(1, 2))
                                         + SSIM_C2)
    den = ((mu_a ** 2 + mu_b ** 2 + SSIM_C1)
           * ((da * da).mean(dim=(1, 2)) + (db * db).mean(dim=(1, 2))
              + SSIM_C2))
    return num / den


def ssim_fast_images(imgs_a: torch.Tensor, imgs_b: torch.Tensor,
                     max_dim: int = 512) -> torch.Tensor:
    """SSIMFast of (B, H, W, C>=3) image pairs of one shape → (B,)
    float32 on their device (reference ssim.go:48-70; the routing of
    JAX parallel/batched.py:1306-1334 and ops/ssim.py:263-281).

    Over max_dim the RGB channels are box-downsampled and rounded, then
    scored as luminance; a side of exactly 8 px has no window position
    (1.0, ssim.go:162-164), a side under 8 px takes the global-moment
    SSIM, and windowed SSIM goes through K1's wrapper."""
    from .ssim_cuda import ssim_window

    bsz, h, w = imgs_a.shape[:3]
    dev = imgs_a.device
    a = imgs_a[..., :3].to(torch.float32)
    b = imgs_b[..., :3].to(torch.float32)
    new_w, new_h = ssim_fast_dims(w, h, max_dim)
    if (new_w, new_h) != (w, h):
        wh, wv = box_weights_device(w, h, new_w, new_h, dev)
        a = box_downsample_device(a, wh, wv)
        b = box_downsample_device(b, wh, wv)
        w, h = new_w, new_h
    ones = torch.ones((bsz,), dtype=torch.float32, device=dev)
    if w < WINDOW_SIZE or h < WINDOW_SIZE:
        if w * h == 0:
            return ones
        return pixel_ssim_lum(luminance(a), luminance(b))
    if w == WINDOW_SIZE or h == WINDOW_SIZE:
        return ones
    return ssim_window(luminance(a).contiguous(), luminance(b).contiguous())


def _image_tensor(img, dev: torch.device) -> torch.Tensor:
    """An (H, W, C) image (numpy, or a tensor) as float32 NRGBA on dev."""
    if isinstance(img, torch.Tensor):
        return img.to(dev, torch.float32)
    arr = to_nrgba_ref(np.asarray(img))
    return torch.from_numpy(arr).to(dev).to(torch.float32)


def pixel_ssim(img_a, img_b, device: _device.DeviceLike = None) -> float:
    """Global-moment SSIM of two images (reference ssim.go:169-204)."""
    dev = _device.resolve(device)
    a, b = _image_tensor(img_a, dev), _image_tensor(img_b, dev)
    if a.shape[0] * a.shape[1] == 0:
        return 1.0
    return float(pixel_ssim_lum(luminance(a)[None], luminance(b)[None])[0])


def ssim_fast(img1, img2, max_dim: int = 512,
              device: _device.DeviceLike = None) -> float:
    """SSIM on box-downsampled inputs capped at max_dim px (reference
    ssim.go:48-70).  Inputs must share dimensions."""
    dev = _device.resolve(device)
    a, b = _image_tensor(img1, dev), _image_tensor(img2, dev)
    return float(ssim_fast_images(a[None], b[None], max_dim)[0])


def compute_ssim_nrgba(a, b, device: _device.DeviceLike = None) -> float:
    """SSIMFast with b Lanczos-resized to a's dimensions first
    (reference targetsize.go:563-568).  The resize stays on the device:
    its output is integral, so it scores as the uint8 image would."""
    dev = _device.resolve(device)
    ta, tb = _image_tensor(a, dev), _image_tensor(b, dev)
    h, w = ta.shape[:2]
    if tb.shape[:2] != (h, w):
        wh, wv = lanczos_weights_device(tb.shape[1], tb.shape[0], w, h, dev)
        tb = lanczos_resize_device(tb, wh, wv)
    return float(ssim_fast_images(ta[None], tb[None])[0])


def ssim(img1, img2, device: _device.DeviceLike = None) -> float:
    """Structural similarity at full resolution (reference ssim.go:24-43;
    JAX :246-260): img2 is Lanczos-resized to img1's size first when they
    differ; under 8 px the global-moment SSIM, at exactly 8 px 1.0, else
    the mean windowed SSIM of the luminance, one K1 call on a CUDA
    device."""
    from .ssim_cuda import ssim_window

    dev = _device.resolve(device)
    a = to_nrgba_ref(np.asarray(img1))
    b = to_nrgba_ref(np.asarray(img2))
    h, w = a.shape[:2]
    if b.shape[:2] != (h, w):
        b = lanczos_resize(b, w, h, dev)
    if w < WINDOW_SIZE or h < WINDOW_SIZE:
        return pixel_ssim(a, b, dev)
    if w == WINDOW_SIZE or h == WINDOW_SIZE:
        return 1.0  # no window position (ssim.go:162-164)
    la = luminance(_image_tensor(a, dev))[None].contiguous()
    lb = luminance(_image_tensor(b, dev))[None].contiguous()
    return float(ssim_window(la, lb)[0])


def msssim_plan(w: int, h: int):
    """(weights, per-level dims) of MS-SSIM at w×h (JAX _msssim_plan,
    :284-305): the levels stop at the first side under 8 px and the
    weights that remain are renormalised (ssim.go:327-342)."""
    weights = list(MSSSIM_WEIGHTS)
    ww, hh = w, h
    for i in range(len(weights) - 1):
        if min(ww, hh) < WINDOW_SIZE:
            weights = weights[: i + 1]
            total = sum(weights)
            weights = [x / total for x in weights]
            break
        ww //= 2
        hh //= 2
    dims = [(w, h)]
    for _ in range(len(weights) - 1):
        nw, nh = dims[-1][0] // 2, dims[-1][1] // 2
        if nw < WINDOW_SIZE or nh < WINDOW_SIZE:
            break
        dims.append((nw, nh))
    return weights, dims


def ms_ssim(img1, img2, device: _device.DeviceLike = None) -> float:
    """Multi-scale SSIM over five scales (reference ssim.go:313-365; JAX
    :308-395): at each level SSIMFast of the pair, then a box
    downsample to half size rounded to uint8 values, as the reference's
    level images are; the float32 sum of weight · log(max(s, 1e-10)),
    exponentiated.  img2 is Lanczos-resized to img1's size first when
    they differ.  Each level's windowed score is one K1 call on a CUDA
    device."""
    dev = _device.resolve(device)
    a = to_nrgba_ref(np.asarray(img1))
    b = to_nrgba_ref(np.asarray(img2))
    h, w = a.shape[:2]
    if w <= 0 or h <= 0:
        return 1.0
    if b.shape[:2] != (h, w):
        b = lanczos_resize(b, w, h, dev)
    weights, dims = msssim_plan(w, h)
    cur_a, cur_b = _image_tensor(a, dev)[None], _image_tensor(b, dev)[None]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (lw, lh) in enumerate(dims):
        s = ssim_fast_images(cur_a, cur_b)[0]
        total = total + torch.log(torch.clamp(s, min=1e-10)) * float(
            np.float32(weights[i]))
        if i + 1 < len(dims):
            wh, wv = box_weights_device(lw, lh, *dims[i + 1], dev)
            cur_a = box_downsample_device(cur_a, wh, wv)
            cur_b = box_downsample_device(cur_b, wh, wv)
    return float(torch.exp(total))
