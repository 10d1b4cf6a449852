"""Lanczos-3 resize and box downsample as float32 weight matmuls, in torch.

Counterpart of fennec_tpu/ops/resize.py.  A separable resample is two
torch.matmul calls with host-built (dst, src) weight matrices
(ops/filters.py).  Lanczos filters RGB premultiplied by alpha and
un-premultiplies after (reference resize.go:96-113); box downsample
averages each channel on its own and rounds to integral values, as the
reference's SSIMFast scores uint8 images (ssim.go:244-309).  TF32 stays
off (device.py), so both products are full float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import device as _device
from ..image import to_nrgba_ref
from .color import clamp_u8
from .filters import box_weights, lanczos_weights


def resize_weights(src_w: int, src_h: int, dst_w: int,
                   dst_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """float32 (dst_w, src_w) and (dst_h, src_h) Lanczos weight matrices."""
    return (lanczos_weights(dst_w, src_w).astype(np.float32),
            lanczos_weights(dst_h, src_h).astype(np.float32))


def box_resize_weights(src_w: int, src_h: int, dst_w: int,
                       dst_h: int) -> Tuple[np.ndarray, np.ndarray]:
    return (box_weights(dst_w, src_w).astype(np.float32),
            box_weights(dst_h, src_h).astype(np.float32))


def weights_on(pair, device: torch.device):
    """Host weight matrices → float32 tensors on `device`."""
    return tuple(torch.from_numpy(w).to(device) for w in pair)


def separable_resample(planes: torch.Tensor, wh: torch.Tensor,
                       wv: torch.Tensor) -> torch.Tensor:
    """(..., H, W) planes → (..., H', W'): horizontal pass with wh (W', W),
    then vertical with wv (H', H)."""
    return torch.matmul(wv, torch.matmul(planes, wh.T))


def lanczos_resize_device(img: torch.Tensor, wh: torch.Tensor,
                          wv: torch.Tensor) -> torch.Tensor:
    """Resize (H, W, 4) float32 [0,255] → (H', W', 4) float32 integral
    values, premultiplied-alpha filtering (reference resize.go:96-113)."""
    img = img.to(torch.float32)
    alpha = img[..., 3:4]
    premul = torch.cat([img[..., :3] * alpha, alpha], dim=-1)
    out = separable_resample(premul.permute(2, 0, 1), wh, wv)
    out = out.permute(1, 2, 0)
    a = out[..., 3:4]
    keep = a > 0.5
    rgb = torch.where(keep, out[..., :3] / torch.where(keep, a, 1.0), 0.0)
    a_out = torch.where(keep, a, 0.0)
    return clamp_u8(torch.cat([rgb, a_out], dim=-1))


def lanczos_resize(img, dst_w: int, dst_h: int,
                   device: _device.DeviceLike = None) -> np.ndarray:
    """Lanczos-3 resize (reference resize.go:34-53): (H, W, 4) uint8 →
    (dst_h, dst_w, 4) uint8, computed on `device`."""
    arr = to_nrgba_ref(np.asarray(img))
    src_h, src_w = arr.shape[:2]
    if src_w <= 0 or src_h <= 0 or dst_w <= 0 or dst_h <= 0:
        return np.zeros((max(dst_h, 0), max(dst_w, 0), 4), dtype=np.uint8)
    if src_w == dst_w and src_h == dst_h:
        return arr.copy()
    dev = _device.resolve(device)
    wh, wv = weights_on(resize_weights(src_w, src_h, dst_w, dst_h), dev)
    x = torch.from_numpy(arr).to(dev)
    out = lanczos_resize_device(x, wh, wv)
    return out.to(torch.uint8).cpu().numpy()


def smart_resize_dims(src_w: int, src_h: int, max_w: int,
                      max_h: int) -> Tuple[int, int]:
    """Aspect-preserving fit-within dims; never enlarges
    (reference resize.go:12-32)."""
    if max_w <= 0:
        max_w = src_w
    if max_h <= 0:
        max_h = src_h
    if src_w <= max_w and src_h <= max_h:
        return src_w, src_h
    ratio = min(max_w / src_w, max_h / src_h)
    dst_w = int(max(1, round_half_away_py(src_w * ratio)))
    dst_h = int(max(1, round_half_away_py(src_h * ratio)))
    return dst_w, dst_h


def round_half_away_py(x: float) -> float:
    """math.Round semantics (half away from zero) for host policy code."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def smart_resize(img, max_w: int, max_h: int,
                 device: _device.DeviceLike = None) -> np.ndarray:
    """Resize to fit within max_w × max_h, preserving aspect ratio; returns
    the input object unchanged if it already fits (reference
    resize.go:12-32)."""
    arr = to_nrgba_ref(np.asarray(img))
    src_h, src_w = arr.shape[:2]
    dst_w, dst_h = smart_resize_dims(src_w, src_h, max_w, max_h)
    if (dst_w, dst_h) == (src_w, src_h):
        return img
    return lanczos_resize(arr, dst_w, dst_h, device)
