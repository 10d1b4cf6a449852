"""Quality → size bisection for the target-size engine, on the device.

Counterpart of fennec_tpu/engine/size_search.py (size_bisect_traceable).
The reference runs one full host encode per bisection step
(targetsize.go:146-166); here each of the 7 steps re-quantizes cached
forward-DCT coefficients at the step's quality and counts the exact scan
bits with the size oracle: on a CUDA device one launch of kernel K3a
(ops/jpeg_emit_cuda.py) over the packed int16 blocks, its per-image
total under the standard tables; on the CPU ops/jpeg_size.scan_bits, the
same count in plain torch.  The loop runs over 0-d or (B,) tensors with
no host sync inside it, like engine/compress.py's _bisect_device_batch:
the caller copies (best_q, found) back once.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..ops import dct as dct_ops
from ..ops.jpeg_emit import layout_on, std_tables_on
from ..ops.jpeg_emit_cuda import oracle_stats
from ..ops.jpeg_size import scan_bits

MAX_STEPS = 7  # binary search over [1, 100]

IntLike = Union[int, torch.Tensor]

_tables: dict = {}


def quality_tables_on(device: torch.device) -> torch.Tensor:
    """The (101, 2, 64) float32 quality tables on `device` (built once)."""
    key = str(device)
    got = _tables.get(key)
    if got is None:
        got = torch.from_numpy(
            dct_ops.all_quality_tables().astype(np.float32)).to(device)
        _tables[key] = got
    return got


def quantize_at(coefs: Sequence[torch.Tensor], quality: torch.Tensor):
    """Quantize (y, cb, cr) coefficient blocks (..., N, 64) at per-image
    qualities (...,) (or one 0-d quality) → three float32 tensors."""
    tables = quality_tables_on(coefs[0].device)
    qt = tables[quality.clamp(0, 100)].unsqueeze(-3)  # (..., 1, 2, 64)
    return (dct_ops.quantize_blocks(coefs[0], qt[..., 0, :]),
            dct_ops.quantize_blocks(coefs[1], qt[..., 1, :]),
            dct_ops.quantize_blocks(coefs[2], qt[..., 1, :]))


def quantize_packed(coefs: Sequence[torch.Tensor],
                    qtabs: torch.Tensor) -> torch.Tensor:
    """(B, NT, 64) int16 blocks, y|cb|cr, of (B, N, 64) coefficient
    blocks quantized at (B, 2, 64) [luma, chroma] tables: what the
    emission kernels and the size oracle take.  Baseline coefficients
    stay below 2^11 at any table, so the cast is exact."""
    return torch.cat([
        dct_ops.quantize_blocks(coefs[0], qtabs[:, None, 0]),
        dct_ops.quantize_blocks(coefs[1], qtabs[:, None, 1]),
        dct_ops.quantize_blocks(coefs[2], qtabs[:, None, 1])],
        dim=1).to(torch.int16)


def scan_bytes_at(coefs, quality: torch.Tensor, padded_h: int,
                  padded_w: int, subsample: bool) -> torch.Tensor:
    """ceil(scan bits / 8) at `quality`: the scan size before 0xFF
    stuffing.  (N, 64) components with a 0-d quality are one image."""
    dev = coefs[0].device
    if dev.type == "cuda":
        single = coefs[0].dim() == 2
        if single:
            coefs = [c[None] for c in coefs]
        qtabs = quality_tables_on(dev)[quality.clamp(0, 100).reshape(-1)]
        packed = quantize_packed(coefs, qtabs)
        bits = oracle_stats(packed, layout_on(padded_h, padded_w, subsample,
                                              dev),
                            std_tables_on(dev)).totals
        if single:
            bits = bits[0]
    else:
        bits = scan_bits(*quantize_at(coefs, quality), padded_h, padded_w,
                         subsample)
    return torch.div(bits + 7, 8, rounding_mode="floor")


def size_bisect(coefs, padded_h: int, padded_w: int, subsample: bool,
                target_bytes: IntLike, lo0: IntLike, hi0: IntLike):
    """Highest quality in [lo0, hi0] whose scan fits target_bytes (the
    container header already subtracted by the caller).

    coefs: (y, cb, cr) unquantized blocks, (N, 64) for one image or
    (B, N, 64) for B images of one geometry; target_bytes, lo0 and hi0
    are ints or tensors broadcasting to the image shape.  Returns
    (best_q int64, found bool) on the coefficients' device, 0-d or (B,).
    Sizes are exact bit counts / 8, stuffing excluded, so callers verify
    a winner's real bytes."""
    dev = coefs[0].device
    shape = coefs[0].shape[:-2]

    def as_tensor(x: IntLike) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int64,
                               device=dev).expand(shape).clone()

    lo, hi, target = as_tensor(lo0), as_tensor(hi0), as_tensor(target_bytes)
    best_q = torch.zeros(shape, dtype=torch.int64, device=dev)
    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    for _ in range(MAX_STEPS):
        active = lo <= hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        fits = scan_bytes_at(coefs, mid, padded_h, padded_w,
                             subsample) <= target
        ok = active & fits
        best_q = torch.where(ok, mid, best_q)
        found = found | ok
        lo = torch.where(ok, mid + 1, lo)
        hi = torch.where(active & ~ok, mid - 1, hi)
    return best_q, found
