"""Quality → size bisection for the target-size engine, on the device.

Counterpart of fennec_tpu/engine/size_search.py (size_bisect_traceable).
The reference runs one full host encode per bisection step
(targetsize.go:146-166); here each of the 7 steps re-quantizes cached
forward-DCT coefficients at the step's quality and counts the exact scan
bits with the size oracle: on a CUDA device one launch of kernel K4
(ops/jpeg_emit_cuda.quantize_count), which reads the float32 coefficients
once, quantizes them as it stages them and sums the bits per image under
the standard tables; on the CPU ops/jpeg_size.scan_bits, the same count
in plain torch.  The loop runs over 0-d or (B,) tensors with no host sync
inside it, like engine/compress.py's _bisect_device_batch: the caller
copies (best_q, found) back once.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..ops import dct as dct_ops
from ..ops.jpeg_emit import layout_on, quantize_packed, std_tables_on
from ..ops.jpeg_emit_cuda import check_coefs, quantize_count
from ..ops.jpeg_size import scan_bits

__all__ = ["MAX_STEPS", "quality_tables_on", "quantize_at",
           "quantize_packed", "scan_bytes_at", "size_bisect"]

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


class _CardOracle:
    """The size oracle's inputs on a CUDA device, checked once for all
    the steps of a bisection: contiguous (B, N, 64) coefficients (one
    image's (N, 64) gets a batch axis), the geometry's scan layout, the
    standard code tables and the quality tables."""

    def __init__(self, coefs, padded_h: int, padded_w: int,
                 subsample: bool) -> None:
        dev = coefs[0].device
        self.single = coefs[0].dim() == 2
        if self.single:
            coefs = [c[None] for c in coefs]
        self.coefs = [c.contiguous() for c in coefs]
        self.lay = layout_on(padded_h, padded_w, subsample, dev)
        self.std = std_tables_on(dev)
        self.qtables = quality_tables_on(dev)
        check_coefs(self.coefs, self.qtables, self.lay, self.std)

    def scan_bytes(self, quality: torch.Tensor) -> torch.Tensor:
        """One launch of K4 (it clamps the quality itself), then
        ceil(bits / 8)."""
        bits = quantize_count.launch(self.coefs, self.qtables,
                                     quality.reshape(-1).to(torch.int64),
                                     self.lay, self.std)
        if self.single:
            bits = bits[0]
        return torch.div(bits + 7, 8, rounding_mode="floor")


def scan_bytes_at(coefs, quality: torch.Tensor, padded_h: int,
                  padded_w: int, subsample: bool) -> torch.Tensor:
    """ceil(scan bits / 8) at `quality` (clamped to [0, 100]): the scan
    size before 0xFF stuffing.  (N, 64) components with a 0-d quality are
    one image."""
    if coefs[0].device.type == "cuda":
        return _CardOracle(coefs, padded_h, padded_w,
                           subsample).scan_bytes(quality)
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
    if dev.type == "cuda":
        scan_bytes = _CardOracle(coefs, padded_h, padded_w,
                                 subsample).scan_bytes
    else:
        def scan_bytes(q: torch.Tensor) -> torch.Tensor:
            return scan_bytes_at(coefs, q, padded_h, padded_w, subsample)
    for _ in range(MAX_STEPS):
        active = lo <= hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        fits = scan_bytes(mid) <= target
        ok = active & fits
        best_q = torch.where(ok, mid, best_q)
        found = found | ok
        lo = torch.where(ok, mid + 1, lo)
        hi = torch.where(active & ~ok, mid - 1, hi)
    return best_q, found
