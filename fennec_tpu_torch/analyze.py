"""Image analysis: stats, entropy, edge density and recommendations.

Counterpart of fennec_tpu/analyze.py (reference analyze.go:9-230).  The
luminance plane, its 256-bin histogram, the mean brightness, the
grid-sampled contrast and the grid-sampled Sobel edge density are torch
ops on `device`; the colour census and the rule tables stay on the host.
Sampling grids mirror the reference (contrast ~100×100 grid, edges
~200×200 grid, threshold 30).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import device as _device
from .image import sampled_color_census, to_nrgba_ref
from .ops.color import luminance
from .types import Format, Quality


@dataclasses.dataclass
class ImageStats:
    """Analysis results (reference analyze.go:9-22)."""

    width: int = 0
    height: int = 0
    has_alpha: bool = False
    is_grayscale: bool = False
    unique_colors: int = 0
    entropy: float = 0.0
    edge_density: float = 0.0
    mean_brightness: float = 0.0
    contrast: float = 0.0
    recommended_format: Format = Format.AUTO
    recommended_quality: Quality = Quality.BALANCED
    estimated_compression: float = 0.0


def _analyze_device(img: torch.Tensor, step_cx: int, step_cy: int,
                    step_ex: int, step_ey: int):
    """(histogram[256], mean_brightness, contrast, edge_density,
    has_alpha, all_gray) of an (H, W, 4) float32 image."""
    lum = luminance(img)
    h, w = lum.shape
    bins = torch.clamp(torch.floor(lum + 0.5), 0, 255).to(torch.int64)
    hist = torch.bincount(bins.reshape(-1), minlength=256)
    mean_b = lum.mean()
    has_alpha = (img[..., 3] < 255.0).any()
    all_gray = ((img[..., 0] == img[..., 1]).all()
                & (img[..., 1] == img[..., 2]).all())

    # Contrast: fixed-grid sampled stddev around the global mean
    # (reference analyze.go:87-107).
    d = lum[::step_cy, ::step_cx] - mean_b
    contrast = torch.sqrt((d * d).mean())

    # Edge density: Sobel magnitude > 30 on a sampled interior grid
    # (reference analyze.go:139-176).
    if h >= 3 and w >= 3:
        tl = lum[0:h - 2:step_ey, 0:w - 2:step_ex]
        tc = lum[0:h - 2:step_ey, 1:w - 1:step_ex]
        tr = lum[0:h - 2:step_ey, 2:w:step_ex]
        ml = lum[1:h - 1:step_ey, 0:w - 2:step_ex]
        mr = lum[1:h - 1:step_ey, 2:w:step_ex]
        bl = lum[2:h:step_ey, 0:w - 2:step_ex]
        bc = lum[2:h:step_ey, 1:w - 1:step_ex]
        br = lum[2:h:step_ey, 2:w:step_ex]
        gx = tr - tl + 2.0 * mr - 2.0 * ml + br - bl
        gy = bl - tl + 2.0 * bc - 2.0 * tc + br - tr
        mag = torch.sqrt(gx * gx + gy * gy)
        edge_density = (mag > 30.0).to(torch.float32).mean()
    else:
        edge_density = torch.zeros((), dtype=torch.float32,
                                   device=img.device)
    return hist, mean_b, contrast, edge_density, has_alpha, all_gray


def compute_entropy(histogram: np.ndarray, total: float) -> float:
    """Shannon entropy of a luminance histogram (reference
    analyze.go:124-136)."""
    if total == 0:
        return 0.0
    p = histogram[histogram > 0] / total
    return float(-(p * np.log2(p)).sum())


def analyze(img, device: _device.DeviceLike = None) -> ImageStats:
    """Comprehensive image analysis (reference analyze.go:26-121), the
    device statistics on `device`."""
    arr = to_nrgba_ref(np.asarray(img))
    h, w = arr.shape[:2]
    stats = ImageStats(width=w, height=h)
    if w == 0 or h == 0:
        return stats

    step_cx = max(1, math.ceil(w / 100))
    step_cy = max(1, math.ceil(h / 100))
    step_ex = max(1, w // 200)
    step_ey = max(1, h // 200)

    x = torch.from_numpy(arr).to(_device.resolve(device)).to(torch.float32)
    hist, mean_b, contrast, edge_density, has_alpha, all_gray = \
        _analyze_device(x, step_cx, step_cy, step_ex, step_ey)
    # One device→host copy for the five scalars.
    scalars = torch.stack([mean_b, contrast, edge_density,
                           has_alpha.to(torch.float32),
                           all_gray.to(torch.float32)]).cpu().tolist()
    stats.mean_brightness, stats.contrast, stats.edge_density = scalars[:3]
    stats.has_alpha = bool(scalars[3])
    stats.is_grayscale = bool(scalars[4])
    # float32 counts, as the JAX package's histogram holds them.
    stats.entropy = compute_entropy(hist.cpu().numpy().astype(np.float32),
                                    float(w * h))

    # Sampled color census, capped at 1024 (reference analyze.go:43-79).
    _, ncolors = sampled_color_census(arr, 50000)
    stats.unique_colors = min(ncolors, 1024)

    stats.recommended_format = recommend_format(stats)
    stats.recommended_quality = recommend_quality(stats)
    stats.estimated_compression = estimate_compression(stats)
    return stats


def recommend_format(stats: ImageStats) -> Format:
    # reference analyze.go:183-194
    if stats.has_alpha:
        return Format.PNG
    if stats.unique_colors <= 256:
        return Format.PNG
    if stats.edge_density > 0.3 and stats.unique_colors < 1000:
        return Format.PNG
    return Format.JPEG


def recommend_quality(stats: ImageStats) -> Quality:
    # reference analyze.go:196-207
    if stats.entropy > 6 and stats.edge_density < 0.15:
        return Quality.BALANCED
    if stats.entropy < 4:
        return Quality.AGGRESSIVE
    if stats.edge_density > 0.25:
        return Quality.HIGH
    return Quality.BALANCED


def estimate_compression(stats: ImageStats) -> float:
    # reference analyze.go:209-230
    if stats.recommended_format == Format.PNG:
        if stats.unique_colors <= 256:
            return 5.0 + (256 - stats.unique_colors) / 50
        if stats.is_grayscale:
            return 3.0
        return 2.0
    base = 10.0
    if stats.entropy > 7:
        base = 5.0
    elif stats.entropy > 5:
        base = 8.0
    if stats.edge_density > 0.2:
        base *= 0.7
    return base
