"""The coefficient batch path's compact upload layouts, unpacked on the
device: the plain PyTorch version of kernel K6.

Counterpart of the XLA programs of fennec_tpu/parallel/batched.py that
rebuild a chunk's blocks from what the host uploaded instead of int16
blocks: _coo_to_natural (:570), _i8_zigzag_to_natural (:542) and
_csr_to_slots (:732).  Each function here returns the (B, NT, 64) int16
blocks in natural order that parallel/batched.
batched_decode_resize_search_quantize takes, the integers the host C++
decoder gives codecs/jpeg.decode_jpeg_to_coefs (y, cb, cr concatenated):

  coo_to_natural  DC plane (B, NT) int8, and per block R (zigzag
                  position, int8 value) pairs of its AC nonzeros in
                  scan order, position 0 padding;
  i8_to_natural   (B, NT, K) int8 blocks in zigzag order, cut after the
                  chunk's largest nonzero zigzag extent K;
  csr_to_natural  DC plane, each block's count of pairs (B, NT) uint8,
                  and each image's pairs as one row of (B, M) streams:
                  a block's pairs start at the sum of the counts before
                  it in its image.

Every layout carries the values it cannot hold (|v| > 127, and a COO
block's pairs past R) as exceptions: exc_off (B, E) int32 offsets into
the image's zigzag layout, exc_val (B, E) int16, exc_n (B,) int32 the
rows of each image that are live; a dead row or an offset outside the
image is dropped.  COO and CSR offsets index the NT × 64 layout and are
set after the dense rebuild; i8 offsets index its NT × K layout (the host
remaps them, (o // 64) * K + o % 64) and are set before the zero pad to
64.  Then the zigzag → natural permutation.  Offsets are image-local, so
they stay int32 at any chunk size (JAX engine/batched.py:942-945).

The JAX package keeps its exceptions and CSR streams as flat lists over
the chunk with an image index per row; every section here leads with the
image, so a chunk halves and shards by slicing its rows.

This module is the CPU's route and what K6 (ops/coef_wire_cuda.py) is held
against on the card, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .dct import ZIGZAG

Exceptions = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _index_on(dev: torch.device) -> torch.Tensor:
    """natural[ZIGZAG[k]] = zigzag[k] as one gather: index[n] = the zigzag
    position of natural index n."""
    inv = torch.empty(64, dtype=torch.long)
    inv[torch.from_numpy(ZIGZAG).long()] = torch.arange(64)
    return inv.to(dev)


def check_exceptions(exc_off: torch.Tensor, exc_val: torch.Tensor,
                     exc_n: torch.Tensor, bsz: int, dev: torch.device) -> None:
    """Raise unless (exc_off (B, E) int32, exc_val (B, E) int16, exc_n (B,)
    int32) are contiguous on `dev`."""
    e = exc_off.shape[1] if exc_off.dim() == 2 else -1
    for t, dtype, shape, name in ((exc_off, torch.int32, (bsz, e), "exc_off"),
                                  (exc_val, torch.int16, (bsz, e), "exc_val"),
                                  (exc_n, torch.int32, (bsz,), "exc_n")):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"fennec: {name} must be contiguous {dtype} "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check(t: torch.Tensor, dtype, dims: int, name: str,
           dev: torch.device) -> None:
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype
            or t.dim() != dims or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"fennec: {name} must be a contiguous {dims}-d "
                         f"{dtype} tensor on {dev}, got "
                         f"{getattr(t, 'dtype', type(t))} "
                         f"{tuple(getattr(t, 'shape', ()))}")


def check_coo(dc, pos, val, exc_off, exc_val, exc_n) -> None:
    """The COO layout's contract: dc (B, NT) int8, pos (B, NT, R) uint8 and
    val (B, NT, R) int8 with 1 <= R <= 63, the exceptions as
    check_exceptions; all contiguous on one device."""
    dev = dc.device
    _check(dc, torch.int8, 2, "dc", dev)
    _check(pos, torch.uint8, 3, "pos", dev)
    _check(val, torch.int8, 3, "val", dev)
    bsz, nt = dc.shape
    if (pos.shape[:2] != (bsz, nt) or val.shape != pos.shape
            or not 1 <= pos.shape[2] <= 63):
        raise ValueError(f"fennec: COO pos / val {tuple(pos.shape)} / "
                         f"{tuple(val.shape)} do not fit dc {(bsz, nt)}")
    check_exceptions(exc_off, exc_val, exc_n, bsz, dev)


def check_i8(i8, exc_off, exc_val, exc_n) -> None:
    """The dense int8 layout's contract: (B, NT, K) int8 with 1 <= K <=
    64, the exceptions as check_exceptions; all contiguous on one
    device."""
    _check(i8, torch.int8, 3, "i8", i8.device)
    if not 1 <= i8.shape[2] <= 64:
        raise ValueError(f"fennec: int8 blocks {tuple(i8.shape)}: K must be "
                         f"1..64")
    check_exceptions(exc_off, exc_val, exc_n, i8.shape[0], i8.device)


def check_csr(dc, counts, spos, sval, exc_off, exc_val, exc_n) -> None:
    """The CSR layout's contract: dc and counts (B, NT) int8 / uint8, the
    streams spos (B, M) uint8 and sval (B, M) int8, the exceptions as
    check_exceptions; all contiguous on one device.  Each image's counts
    must sum to at most M (not checked: it needs the data)."""
    dev = dc.device
    _check(dc, torch.int8, 2, "dc", dev)
    _check(counts, torch.uint8, 2, "counts", dev)
    _check(spos, torch.uint8, 2, "spos", dev)
    _check(sval, torch.int8, 2, "sval", dev)
    bsz = dc.shape[0]
    if (counts.shape != dc.shape or spos.shape[0] != bsz
            or sval.shape != spos.shape):
        raise ValueError(f"fennec: CSR counts / streams {tuple(counts.shape)}"
                         f" / {tuple(spos.shape)} / {tuple(sval.shape)} do not"
                         f" fit dc {tuple(dc.shape)}")
    check_exceptions(exc_off, exc_val, exc_n, bsz, dev)


def _set_exceptions(zz: torch.Tensor, exc: Exceptions) -> None:
    """Set the live exception rows of (B, N, W) int16 zigzag blocks in
    place at their image-local offsets into the N × W layout."""
    exc_off, exc_val, exc_n = exc
    bsz, e = exc_off.shape
    if e == 0:
        return
    flat = zz.view(bsz, -1)
    off = exc_off.to(torch.long)
    live = ((torch.arange(e, device=zz.device)[None, :] < exc_n[:, None])
            & (off >= 0) & (off < flat.shape[1]))
    rows = torch.arange(bsz, device=zz.device)[:, None].expand(bsz, e)
    flat[rows[live], off[live]] = exc_val[live]


def _natural(zz: torch.Tensor) -> torch.Tensor:
    return zz.index_select(2, _index_on(zz.device)).contiguous()


def coo_to_natural(dc: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
                   exc_off: torch.Tensor, exc_val: torch.Tensor,
                   exc_n: torch.Tensor) -> torch.Tensor:
    """COO wire → (B, NT, 64) int16 natural-order blocks (JAX
    _coo_to_natural): the pairs scattered into zigzag blocks, the DC
    plane set, the exceptions set, the permutation."""
    check_coo(dc, pos, val, exc_off, exc_val, exc_n)
    bsz, nt, _ = pos.shape
    zz = torch.zeros((bsz, nt, 64), dtype=torch.int16, device=dc.device)
    live = pos != 0
    p = pos.to(torch.long)
    blk = torch.arange(bsz * nt, device=dc.device).view(bsz, nt, 1)
    zz.view(-1, 64)[blk.expand_as(p)[live], p[live]] = \
        val[live].to(torch.int16)
    zz[:, :, 0] = dc.to(torch.int16)
    _set_exceptions(zz, (exc_off, exc_val, exc_n))
    return _natural(zz)


def i8_to_natural(i8: torch.Tensor, exc_off: torch.Tensor,
                  exc_val: torch.Tensor, exc_n: torch.Tensor) -> torch.Tensor:
    """Dense int8 wire → (B, NT, 64) int16 natural-order blocks (JAX
    _i8_zigzag_to_natural): the exceptions set in the NT × K layout, the
    zero pad to 64, the permutation."""
    check_i8(i8, exc_off, exc_val, exc_n)
    bsz, nt, k = i8.shape
    zz = i8.to(torch.int16)
    _set_exceptions(zz, (exc_off, exc_val, exc_n))
    if k < 64:
        zz = torch.nn.functional.pad(zz, (0, 64 - k))
    return _natural(zz)


def csr_slots(counts: torch.Tensor, spos: torch.Tensor, sval: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR streams → the COO slots (B, NT, R) uint8 / int8, R the largest
    count: block n of image b holds the pairs at row b of the streams
    from the exclusive prefix sum of its image's counts; slots at or past
    its count are padding (position 0).  Integer indexing (the JAX
    package's grouped window gathers and one-hot products are TPU gather
    workarounds)."""
    bsz, nt = counts.shape
    cnt = counts.to(torch.long)
    r = int(cnt.max()) if cnt.numel() else 0
    pos = torch.zeros((bsz, nt, max(r, 1)), dtype=torch.uint8,
                      device=counts.device)
    val = torch.zeros(pos.shape, dtype=torch.int8, device=counts.device)
    if r == 0:
        return pos, val
    start = torch.cumsum(cnt, dim=1) - cnt
    slot = torch.arange(r, device=counts.device)
    idx = start[:, :, None] + slot
    live = slot < cnt[:, :, None]
    rows = torch.arange(bsz, device=counts.device)[:, None, None].expand(
        idx.shape)
    pos[live] = spos[rows[live], idx[live]]
    val[live] = sval[rows[live], idx[live]]
    return pos, val


def csr_to_natural(dc: torch.Tensor, counts: torch.Tensor,
                   spos: torch.Tensor, sval: torch.Tensor,
                   exc_off: torch.Tensor, exc_val: torch.Tensor,
                   exc_n: torch.Tensor) -> torch.Tensor:
    """CSR wire → (B, NT, 64) int16 natural-order blocks (JAX
    _csr_to_slots, then _coo_to_natural)."""
    check_csr(dc, counts, spos, sval, exc_off, exc_val, exc_n)
    pos, val = csr_slots(counts, spos, sval)
    return coo_to_natural(dc, pos, val, exc_off, exc_val, exc_n)
