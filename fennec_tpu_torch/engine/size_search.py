"""Quality → size bisection for the target-size engine, on the device.

Counterpart of fennec_tpu/engine/size_search.py (size_bisect_device).
The reference runs one full host encode per bisection step
(targetsize.go:146-166); here each of the 7 steps re-quantizes cached
forward-DCT coefficients at the step's quality and counts the exact scan
bits under the standard tables.  On a CUDA device the whole bisection is
one launch of kernel K4's bisection (ops/jpeg_emit_cuda.size_bisect), as
the JAX package's is one XLA program; on the CPU it is the step loop
size_bisect_steps, each step ops/jpeg_size.scan_bits in plain torch.  The
step loop on a card, one launch of K4's step per step, is the yardstick
the one launch is held and timed against.  No host sync inside: the
caller copies (best_q, found) back once.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..ops import dct as dct_ops
from ..ops.jpeg_emit import (
    bisect_steps,
    layout_on,
    quantize_packed,
    std_tables_on,
)
from ..ops.jpeg_emit_cuda import check_coefs, quantize_count
from ..ops.jpeg_emit_cuda import size_bisect as size_bisect_kernel
from ..ops.jpeg_size import scan_bits

__all__ = ["MAX_STEPS", "quality_tables_on", "quantize_at",
           "quantize_packed", "scan_bytes_at", "size_bisect",
           "size_bisect_steps"]

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

    def scan_bits(self, quality: torch.Tensor) -> torch.Tensor:
        """One launch of K4's step (it clamps the quality itself)."""
        bits = quantize_count.launch(self.coefs, self.qtables,
                                     quality.reshape(-1).to(torch.int64),
                                     self.lay, self.std)
        return bits[0] if self.single else bits

    def scan_bytes(self, quality: torch.Tensor) -> torch.Tensor:
        """ceil(scan bits / 8) at `quality`."""
        return torch.div(self.scan_bits(quality) + 7, 8,
                         rounding_mode="floor")

    def bisect(self, bounds: torch.Tensor):
        """One launch of K4's bisection over (3, ...) int64 bounds
        (target, lo0, hi0) → (best_q, found, table), 0-d and (MAX_STEPS,)
        for one image."""
        best_q, found, table = size_bisect_kernel.launch(
            self.coefs, self.qtables, self.lay, self.std,
            bounds.reshape(3, -1), MAX_STEPS)
        if self.single:
            return best_q[0], found[0], table[:, 0]
        return best_q, found, table


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


def _bounds(coefs, target_bytes: IntLike, lo0: IntLike,
            hi0: IntLike) -> torch.Tensor:
    """(3, *image shape) int64 on the coefficients' device: target, lo0
    and hi0 broadcast.  Built on the host and sent in one copy unless a
    value already lies on the device."""
    dev = coefs[0].device
    shape = coefs[0].shape[:-2]
    values = (target_bytes, lo0, hi0)
    if any(isinstance(v, torch.Tensor) and v.device != torch.device("cpu")
           for v in values):
        return torch.stack([torch.as_tensor(v, dtype=torch.int64,
                                            device=dev).expand(shape)
                            for v in values])
    host = torch.stack([torch.as_tensor(v, dtype=torch.int64).expand(shape)
                        for v in values])
    if dev.type == "cpu":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def size_bisect_steps(coefs, padded_h: int, padded_w: int, subsample: bool,
                      target_bytes: IntLike, lo0: IntLike, hi0: IntLike):
    """size_bisect as a loop of MAX_STEPS steps of the size oracle: one
    launch of K4's step a step on a CUDA device, scan_bits on the CPU.
    Returns (best_q, found, table), table (MAX_STEPS, ...) int64 the bits
    each step counted, -1 where the image's range was already empty."""
    target, lo, hi = _bounds(coefs, target_bytes, lo0, hi0)
    if coefs[0].device.type == "cuda":
        count = _CardOracle(coefs, padded_h, padded_w, subsample).scan_bits
    else:
        def count(q: torch.Tensor) -> torch.Tensor:
            return scan_bits(*quantize_at(coefs, q), padded_h, padded_w,
                             subsample)
    return bisect_steps(count, target, lo, hi, MAX_STEPS)


def size_bisect(coefs, padded_h: int, padded_w: int, subsample: bool,
                target_bytes: IntLike, lo0: IntLike, hi0: IntLike):
    """Highest quality in [lo0, hi0] whose scan fits target_bytes (the
    container header already subtracted by the caller).

    coefs: (y, cb, cr) unquantized blocks, (N, 64) for one image or
    (B, N, 64) for B images of one geometry; target_bytes, lo0 and hi0
    are ints or tensors broadcasting to the image shape.  Returns
    (best_q int64, found bool) on the coefficients' device, 0-d or (B,):
    on a CUDA device one launch of K4's bisection, on the CPU the step
    loop.  Sizes are exact bit counts / 8, stuffing excluded, so callers
    verify a winner's real bytes."""
    if coefs[0].device.type == "cuda":
        best_q, found, _ = _CardOracle(coefs, padded_h, padded_w,
                                       subsample).bisect(
            _bounds(coefs, target_bytes, lo0, hi0))
        return best_q, found
    best_q, found, _ = size_bisect_steps(coefs, padded_h, padded_w,
                                         subsample, target_bytes, lo0, hi0)
    return best_q, found
