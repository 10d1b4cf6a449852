"""Median-cut colour quantization: host box splitting, device palette map.

Counterpart of fennec_tpu/ops/quantize.py.  median_cut_levels,
median_cut and palette_to_nrgba are its jax-free numpy, copied as they
are: box splitting (reference targetsize.go:422-486) over a strided
~100k-pixel sample (stride = total // 100k, the reference's policy).

The nearest-palette map (targetsize.go:488-527) is a torch argmin on the
device.  The score |p|² − 2·r·p has the argmin of the squared RGB
distance (|r|² is constant per pixel) and is exact in int32; torch.argmin
returns the first minimum, the reference's scan-order tie-break.  The
(pixels × palette) score matrix is built in chunks of at most
PALETTE_CHUNK_ROWS pixels: unchunked it is 12.5 GB at 12 MP.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device

PALETTE_CHUNK_ROWS = 1 << 20


def _box_score(px: np.ndarray) -> int:
    if px.shape[0] < 2:
        return -1
    mins = px.min(axis=0)
    maxs = px.max(axis=0)
    volume = int(np.prod(maxs - mins + 1))
    return volume * px.shape[0]


def _palette_of(boxes) -> np.ndarray:
    palette = np.zeros((len(boxes), 4), dtype=np.uint8)
    for i, b in enumerate(boxes):
        if b.shape[0] == 0:
            palette[i] = (0, 0, 0, 255)
        else:
            mean = b.sum(axis=0) // b.shape[0]  # integer mean like Go
            palette[i, :3] = mean.astype(np.uint8)
            palette[i, 3] = 255
    return palette


def median_cut_levels(img: np.ndarray, levels) -> dict:
    """Median-cut palettes for SEVERAL target sizes in one greedy run.

    The split sequence (largest volume×population box, longest RGB axis,
    pixel median; reference targetsize.go:422-486) is greedy and
    independent of the stop count, so the box state at L boxes is
    exactly median_cut(img, L)'s — one run snapshots every level the
    target-size engine probes (256→16) instead of five from-scratch
    runs.  Box scores are maintained incrementally (only a split's two
    children are rescored), not recomputed for every box per iteration.

    Returns {level: (N≤level, 4) uint8 RGBA palette}.
    """
    flat = img.reshape(-1, 4)[:, :3]
    total = flat.shape[0]
    max_samples = 100000
    step = max(1, total // max_samples) if total > max_samples else 1
    pixels = flat[::step].astype(np.int32)
    targets = sorted(set(int(x) for x in levels))
    if pixels.size == 0:
        pal = np.array([[0, 0, 0, 255]], dtype=np.uint8)
        return {t: pal for t in targets}

    boxes = [pixels]
    scores = [_box_score(pixels)]
    out = {}
    remaining = list(targets)
    while remaining:
        if len(boxes) >= remaining[0]:
            out[remaining.pop(0)] = _palette_of(boxes)
            continue
        best = int(np.argmax(scores))
        if scores[best] <= -1:
            break
        px = boxes[best]
        spans = px.max(axis=0) - px.min(axis=0)
        # Longest axis, ties resolved R ≥ G ≥ B like the reference
        # (targetsize.go:387-398).
        if spans[0] >= spans[1] and spans[0] >= spans[2]:
            axis = 0
        elif spans[1] >= spans[2]:
            axis = 1
        else:
            axis = 2
        order = np.argsort(px[:, axis], kind="stable")
        px = px[order]
        mid = px.shape[0] // 2
        boxes[best] = px[:mid]
        boxes.append(px[mid:])
        scores[best] = _box_score(boxes[best])
        scores.append(_box_score(boxes[-1]))
    for t in remaining:
        out[t] = _palette_of(boxes)
    return out


def median_cut(img: np.ndarray, max_colors: int) -> np.ndarray:
    """Build an (N≤max_colors, 4) uint8 RGBA palette via median cut
    (reference targetsize.go:422-486)."""
    return median_cut_levels(img, (max_colors,))[max_colors]


def palette_indices(rgb: torch.Tensor, palette: torch.Tensor,
                    chunk_rows: int = PALETTE_CHUNK_ROWS) -> torch.Tensor:
    """(N, 3) int32 pixels × (P, 3) int32 palette → (N,) int64 index of
    the nearest entry (squared RGB distance, first minimum), on their
    device, PALETTE_CHUNK_ROWS pixels at a time."""
    pal_sq = (palette * palette).sum(dim=-1, dtype=torch.int32)
    out = torch.empty(rgb.shape[0], dtype=torch.int64, device=rgb.device)
    for start in range(0, rgb.shape[0], chunk_rows):
        r = rgb[start:start + chunk_rows]
        score = r[:, 0:1] * palette[:, 0]
        score += r[:, 1:2] * palette[:, 1]
        score += r[:, 2:3] * palette[:, 2]
        score.mul_(-2).add_(pal_sq)
        out[start:start + r.shape[0]] = score.argmin(dim=1)
    return out


def apply_palette(img: np.ndarray, palette: np.ndarray,
                  device: _device.DeviceLike = None,
                  chunk_rows: int = PALETTE_CHUNK_ROWS) -> np.ndarray:
    """Map every pixel to its nearest palette entry (reference
    targetsize.go:488-527) on `device`.  Returns (H, W) uint8 indices."""
    dev = _device.resolve(device)
    h, w = img.shape[:2]
    rgb = torch.from_numpy(np.ascontiguousarray(
        img.reshape(-1, 4)[:, :3])).to(dev).to(torch.int32)
    pal = torch.from_numpy(np.ascontiguousarray(
        palette[:, :3])).to(dev).to(torch.int32)
    idx = palette_indices(rgb, pal, chunk_rows)
    return idx.to(torch.uint8).cpu().numpy().reshape(h, w)


def palette_to_nrgba(indices: np.ndarray,
                     palette: np.ndarray) -> np.ndarray:
    """Expand indices back to NRGBA (reference targetsize.go:529-545)."""
    return palette[indices]
