"""8×8 block DCT / IDCT and JPEG quantization, in torch.

Counterpart of fennec_tpu/ops/dct.py.  The host tables (Annex-K
quantization tables with libjpeg quality scaling, zigzag order, the DCT
matrix) are copied as they are: they are this system's only weights.
The block transforms are one (N, 64) × (64, 64) float32 matmul with the
Kronecker-flattened basis, as in the reference; the probe loop's blockwise
IDCT of coefficient planes lives in engine/compress.py.  Every op takes
leading batch dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ── Quantization tables (JPEG Annex K) and libjpeg-style quality scaling ────

# Standard luminance / chrominance base tables, natural (row-major) order.
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)

STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)


def scale_quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling (also used by Go's stdlib encoder):
    scale = 5000/q for q<50 else 200-2q; entries clamped to [1, 255]."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    t = (base * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.int32)


@functools.lru_cache(maxsize=4)
def all_quality_tables() -> np.ndarray:
    """(101, 2, 64) int32: quant tables for qualities 0..100 (0 unused),
    [luma, chroma]."""
    out = np.zeros((101, 2, 64), dtype=np.int32)
    for q in range(1, 101):
        out[q, 0] = scale_quant_table(STD_LUMA_QUANT, q)
        out[q, 1] = scale_quant_table(STD_CHROMA_QUANT, q)
    out[0] = out[1]
    out.setflags(write=False)  # cached + shared: in-place edits would
    return out                 # corrupt every later encode


# Zigzag scan order: ZIGZAG[i] = natural index of the i-th zigzag element.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)


@functools.lru_cache(maxsize=4)
def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D (float64): coef = D @ x."""
    n = 8
    d = np.zeros((n, n), dtype=np.float64)
    for k in range(n):
        c = np.sqrt(1.0 / n) if k == 0 else np.sqrt(2.0 / n)
        for i in range(n):
            d[k, i] = c * np.cos((2 * i + 1) * k * np.pi / (2 * n))
    d.setflags(write=False)  # cached + shared
    return d


@functools.lru_cache(maxsize=4)
def dct_kron() -> np.ndarray:
    """(64, 64) float32 M with vec(D·B·Dᵀ) = M @ vec(B) (row-major vec)."""
    d = dct_matrix()
    m = np.kron(d, d).astype(np.float32)
    m.setflags(write=False)  # cached + shared
    return m


def _kron_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(dct_kron())).to(device)


# Every block transform multiplies a row count padded up to a multiple of
# this, so a block's coefficients do not depend on how many other blocks
# share the product.  GEMM libraries pick their kernel by shape, and the
# kernels for small row counts sum in another order (measured on an H100
# 80GB: products of 72 rows differ from the same rows inside 4 608 by up
# to 4.9e-4; on the CPU a product of one row takes the matrix-vector
# path).  From a few thousand rows on, every row came out bit-identical,
# so an image's bytes are the same alone and inside a batch.
GEMM_ROW_MULTIPLE = 4096


def _blocks_matmul(blocks: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 64) @ (64, 64) with the row count padded as above."""
    lead = blocks.shape[:-1]
    rows = blocks.reshape(-1, 64)
    n = rows.shape[0]
    pad = (-n) % GEMM_ROW_MULTIPLE if n else 0
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, 64))])
    return torch.matmul(rows, m)[:n].reshape(*lead, 64)


# ── Tensor ops (leading batch dimensions broadcast) ─────────────────────────


def to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (..., H/8 * W/8, 64) row-major blocks; H, W
    multiples of 8."""
    h, w = plane.shape[-2:]
    x = plane.reshape(*plane.shape[:-2], h // 8, 8, w // 8, 8)
    return x.transpose(-3, -2).reshape(*plane.shape[:-2], -1, 64)


def from_blocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., H/8 * W/8, 64) → (..., H, W)."""
    lead = blocks.shape[:-2]
    x = blocks.reshape(*lead, h // 8, w // 8, 8, 8).transpose(-3, -2)
    return x.reshape(*lead, h, w)


def dct2d_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Forward DCT of (..., N, 64) level-shifted pixel blocks → coefs."""
    return _blocks_matmul(blocks, _kron_on(blocks.device).T)


def idct2d_blocks(coefs: torch.Tensor) -> torch.Tensor:
    """Inverse DCT of (..., N, 64) coefficient blocks → pixels."""
    return _blocks_matmul(coefs, _kron_on(coefs.device))


def quantize_blocks(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Quantize float coefficients by a (64,) table (broadcast over the
    last axis), rounding half away from zero like Go's encoder div().
    Returns float32 integral values."""
    scaled = coefs / qtable.to(torch.float32)
    return torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)


def dequantize_blocks(qcoefs: torch.Tensor,
                      qtable: torch.Tensor) -> torch.Tensor:
    return qcoefs * qtable.to(torch.float32)


def pad_to_multiple(plane: torch.Tensor, mult_h: int,
                    mult_w: int) -> torch.Tensor:
    """Edge-replicate pad (..., H, W) up to multiples of (mult_h,
    mult_w)."""
    h, w = plane.shape[-2:]
    ph = (-h) % mult_h
    pw = (-w) % mult_w
    if ph == 0 and pw == 0:
        return plane
    rows = torch.arange(h + ph, device=plane.device).clamp_(max=h - 1)
    cols = torch.arange(w + pw, device=plane.device).clamp_(max=w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


def downsample_420(plane: torch.Tensor) -> torch.Tensor:
    """2×2 mean chroma downsample (..., H, W), H and W even."""
    h, w = plane.shape[-2:]
    x = plane.reshape(*plane.shape[:-2], h // 2, 2, w // 2, 2)
    return x.mean(dim=(-3, -1))


def upsample_420(plane: torch.Tensor) -> torch.Tensor:
    """2×2 replication chroma upsample (matches Go stdlib's decoder)."""
    return plane.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
