"""Lanczos-3 resize and box downsample as float32 weight matmuls, in torch.

Counterpart of fennec_tpu/ops/resize.py.  A separable resample is two
torch.matmul calls with host-built (dst, src) weight matrices
(ops/filters.py).  Lanczos filters RGB premultiplied by alpha and
un-premultiplies after (reference resize.go:96-113); box downsample
averages each channel on its own and rounds to integral values, as the
reference's SSIMFast scores uint8 images (ssim.go:244-309).  TF32 stays
off (device.py), so both products are full float32.

Weight matrices on the device are cached per (kind, source, destination,
device), bounded by bytes (box_weights_device, lanczos_weights_device):
the target-size search resamples one source at many probe geometries,
and a 12 MP pair is megabytes.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Tuple

import numpy as np
import torch

from .. import device as _device
from ..image import to_nrgba_ref
from .color import clamp_u8
from .filters import box_bounds, box_cover, box_weights, lanczos_weights


def resize_weights(src_w: int, src_h: int, dst_w: int,
                   dst_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """float32 (dst_w, src_w) and (dst_h, src_h) Lanczos weight matrices."""
    return (lanczos_weights(dst_w, src_w).astype(np.float32),
            lanczos_weights(dst_h, src_h).astype(np.float32))


def box_resize_weights(src_w: int, src_h: int, dst_w: int,
                       dst_h: int) -> Tuple[np.ndarray, np.ndarray]:
    return (box_weights(dst_w, src_w).astype(np.float32),
            box_weights(dst_h, src_h).astype(np.float32))


def box_rectangles(src_w: int, src_h: int, dst_w: int,
                   dst_h: int) -> Tuple[np.ndarray]:
    """The box downsample's rectangles as kernel K2 reads them, one int32
    array: y0, y1 (dst_h each), x0, x1 (dst_w each), then for every
    source row the first and one-past-last rectangle that holds it
    (src_h each), then the same for every source column (src_w each).
    In a 1-tuple, for the weight cache."""
    rows, cols = box_cover(dst_h, src_h), box_cover(dst_w, src_w)
    return (np.concatenate([*box_bounds(dst_h, src_h),
                            *box_bounds(dst_w, src_w), *rows, *cols]),)


def weights_on(pair, device: torch.device):
    """Host weight arrays → tensors of their type on `device`."""
    return tuple(torch.from_numpy(w).to(device) for w in pair)


WEIGHT_CACHE_BYTES = 128 * 1024 * 1024  # of device memory, per process
_weight_cache: "collections.OrderedDict" = collections.OrderedDict()
_weight_cache_lock = threading.Lock()


def _cached_weights(kind: str, make, src_w: int, src_h: int, dst_w: int,
                    dst_h: int, device: torch.device):
    """(wh, wv) for one geometry on `device`, built on first use.  The
    least recently used pairs leave once the cache holds more than
    WEIGHT_CACHE_BYTES.  The batch engines call this from worker
    threads, hence the lock; a concurrent duplicate build is harmless."""
    key = (kind, src_w, src_h, dst_w, dst_h, str(device))
    with _weight_cache_lock:
        hit = _weight_cache.get(key)
        if hit is not None:
            _weight_cache.move_to_end(key)
            return hit
    pair = weights_on(make(src_w, src_h, dst_w, dst_h), device)
    with _weight_cache_lock:
        _weight_cache[key] = pair
        total = sum(w.nbytes for p in _weight_cache.values() for w in p)
        while len(_weight_cache) > 1 and total > WEIGHT_CACHE_BYTES:
            _, old = _weight_cache.popitem(last=False)
            total -= sum(w.nbytes for w in old)
    return pair


def box_weights_device(src_w: int, src_h: int, dst_w: int, dst_h: int,
                       device: torch.device):
    """Box weights (counterpart of box_weights_device, JAX :141)."""
    return _cached_weights("box", box_resize_weights, src_w, src_h, dst_w,
                           dst_h, device)


def box_rectangles_device(src_w: int, src_h: int, dst_w: int, dst_h: int,
                          device: torch.device) -> torch.Tensor:
    """box_rectangles on `device`, cached like the weights."""
    return _cached_weights("box_rectangles", box_rectangles, src_w, src_h,
                           dst_w, dst_h, device)[0]


def lanczos_weights_device(src_w: int, src_h: int, dst_w: int, dst_h: int,
                           device: torch.device):
    """Lanczos-3 weights (counterpart of lanczos_weights_device,
    JAX :148)."""
    return _cached_weights("lanczos", resize_weights, src_w, src_h, dst_w,
                           dst_h, device)


def separable_resample(planes: torch.Tensor, wh: torch.Tensor,
                       wv: torch.Tensor) -> torch.Tensor:
    """(..., H, W) planes → (..., H', W'): horizontal pass with wh (W', W),
    then vertical with wv (H', H)."""
    return torch.matmul(wv, torch.matmul(planes, wh.T))


def lanczos_resize_device(img: torch.Tensor, wh: torch.Tensor,
                          wv: torch.Tensor) -> torch.Tensor:
    """Resize (..., H, W, 4) float32 [0,255] → (..., H', W', 4) float32
    integral values, premultiplied-alpha filtering (reference
    resize.go:96-113).  Leading batch dimensions broadcast."""
    img = img.to(torch.float32)
    alpha = img[..., 3:4]
    premul = torch.cat([img[..., :3] * alpha, alpha], dim=-1)
    out = separable_resample(premul.movedim(-1, -3), wh, wv)
    out = out.movedim(-3, -1)
    a = out[..., 3:4]
    keep = a > 0.5
    rgb = torch.where(keep, out[..., :3] / torch.where(keep, a, 1.0), 0.0)
    a_out = torch.where(keep, a, 0.0)
    return clamp_u8(torch.cat([rgb, a_out], dim=-1))


def box_downsample_device(img: torch.Tensor, wh: torch.Tensor,
                          wv: torch.Tensor) -> torch.Tensor:
    """Box-filter downsample (..., H, W, C) → (..., H', W', C), channels
    averaged on their own (reference ssim.go:244-309), rounded to
    integral float32 values."""
    planes = img.to(torch.float32).movedim(-1, -3)
    return clamp_u8(separable_resample(planes, wh, wv)).movedim(-3, -1)


def box_downsample(img, dst_w: int, dst_h: int,
                   device: _device.DeviceLike = None) -> np.ndarray:
    """Box-filter downsample (reference ssim.go:243-284): (H, W, 4) uint8
    → (dst_h, dst_w, 4) uint8, computed on `device`."""
    arr = to_nrgba_ref(np.asarray(img))
    src_h, src_w = arr.shape[:2]
    if src_w <= 0 or src_h <= 0 or dst_w <= 0 or dst_h <= 0:
        return np.zeros((max(dst_h, 0), max(dst_w, 0), 4), dtype=np.uint8)
    dev = _device.resolve(device)
    wh, wv = box_weights_device(src_w, src_h, dst_w, dst_h, dev)
    out = box_downsample_device(torch.from_numpy(arr).to(dev), wh, wv)
    return out.to(torch.uint8).cpu().numpy()


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
    wh, wv = lanczos_weights_device(src_w, src_h, dst_w, dst_h, dev)
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
