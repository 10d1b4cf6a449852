"""Host-side filter weight construction (jax-free copy of
fennec_tpu/ops/filters.py).

Instead of per-output-pixel weight *lists* walked by scalar loops
(reference resize.go:164-197, ssim.go:244-284), resampling is baked into
dense (dst, src) weight matrices so that a resize or box-downsample is
two matmuls.  Weights are computed on the host
in float64 (matching the reference's float64 math exactly), cached by
(dst, src) shape, and shipped to device as float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np

LANCZOS_A = 3.0


def lanczos_kernel(x: float) -> float:
    """Lanczos-3 kernel (reference resize.go:57-69)."""
    if x == 0:
        return 1.0
    x = abs(x)
    if x >= LANCZOS_A:
        return 0.0
    xpi = x * math.pi
    return (LANCZOS_A * math.sin(xpi) * math.sin(xpi / LANCZOS_A)) / (xpi * xpi)


@functools.lru_cache(maxsize=512)
def lanczos_weights(dst_size: int, src_size: int) -> np.ndarray:
    """(dst_size, src_size) float64 row-normalized Lanczos-3 weight matrix.

    Semantics match precomputeWeights (reference resize.go:164-197):
    center = (d + 0.5) * ratio - 0.5; support widens by the ratio when
    downscaling; taps outside the image are clamped off (not reflected);
    each row is normalized to sum 1.
    """
    ratio = src_size / dst_size
    support = LANCZOS_A * ratio if ratio > 1 else LANCZOS_A
    filter_scale = max(ratio, 1.0)

    w = np.zeros((dst_size, src_size), dtype=np.float64)
    for d in range(dst_size):
        center = (d + 0.5) * ratio - 0.5
        left = max(0, math.ceil(center - support))
        right = min(src_size - 1, math.floor(center + support))
        wsum = 0.0
        for s in range(left, right + 1):
            val = lanczos_kernel((s - center) / filter_scale)
            if val != 0.0:
                w[d, s] = val
                wsum += val
        if wsum != 0.0:
            w[d, left:right + 1] /= wsum
    return w


@functools.lru_cache(maxsize=512)
def box_bounds(dst_size: int, src_size: int):
    """(s0, s1) int32 arrays of length dst_size: output d averages source
    indices [s0[d], s1[d]).

    Boundaries match boxDownsample (reference ssim.go:244-284):
    s0 = floor(d * ratio), s1 = floor((d+1) * ratio), clamped, with the
    degenerate-box fixups.  Both are non-decreasing; a rectangle may be
    empty (s0 == s1 == 0, when the source is scaled up)."""
    ratio = src_size / dst_size
    s0 = np.zeros(dst_size, dtype=np.int32)
    s1 = np.zeros(dst_size, dtype=np.int32)
    for d in range(dst_size):
        a = int(d * ratio)
        b = int((d + 1) * ratio)
        if b > src_size:
            b = src_size
        if a >= b:
            a = b - 1
        if a < 0:
            a = 0
        s0[d], s1[d] = a, b
    s0.setflags(write=False)  # cached + shared
    s1.setflags(write=False)
    return s0, s1


def box_cover(dst_size: int, src_size: int):
    """(lo, hi) int32 arrays of length src_size: source index s lies in
    the rectangles [lo[s], hi[s]) of box_bounds (usually one; none where
    the rectangles leave a gap, several where the source is scaled up)."""
    return cover(*box_bounds(dst_size, src_size), src_size)


def cover(s0, s1, src_size: int):
    """box_cover of any rectangles [s0[d], s1[d]) with s0 and s1
    non-decreasing, over source indices 0 .. src_size - 1."""
    src = np.arange(src_size)
    lo = np.searchsorted(s1, src, side="right")  # rectangles ended by s
    hi = np.searchsorted(s0, src, side="right")  # rectangles begun by s
    return lo.astype(np.int32), hi.astype(np.int32)


@functools.lru_cache(maxsize=512)
def box_weights(dst_size: int, src_size: int) -> np.ndarray:
    """(dst_size, src_size) float64 box-filter weight matrix: each row
    holds 1/count over its rectangle of box_bounds."""
    w = np.zeros((dst_size, src_size), dtype=np.float64)
    for d, (s0, s1) in enumerate(zip(*box_bounds(dst_size, src_size))):
        count = int(s1) - int(s0)
        if count > 0:
            w[d, s0:s1] = 1.0 / count
    return w


@functools.lru_cache(maxsize=64)
def gaussian_window_1d(size: int = 8, sigma: float = 1.5) -> np.ndarray:
    """1D factor of the SSIM Gaussian window, normalized to sum 1.

    The reference builds a 2D window over the half-open offset range
    [-size/2, size/2) (ssim.go:223-241); that window is separable, and
    normalizing each 1D factor reproduces the 2D normalization exactly
    (sum2d = sum1d²).
    """
    half = size // 2
    xs = np.arange(-half, half, dtype=np.float64)
    g = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return g / g.sum()


@functools.lru_cache(maxsize=64)
def gaussian_blur_kernel(sigma: float) -> np.ndarray:
    """1D Gaussian blur kernel with radius ceil(3σ), normalized
    (reference effects.go:153-165)."""
    radius = int(math.ceil(sigma * 3))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return k / k.sum()
