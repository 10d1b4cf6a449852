"""Optimal Huffman tables on the device (ITU T.81 Annex K.2): the plain
PyTorch version of kernel K5.

Counterpart of fennec_tpu/ops/huffbuild.py (build_tables_device :169).
From the symbol histograms of a batch it builds every image's four
length-limited tables [dc-luma, dc-chroma, ac-luma, ac-chroma], bit for
bit those of the host builders (codecs/huffopt.optimal_spec and the C++
fennec_build_optimal_specs):

  - the K.2 merge loop in lockstep over all B·4 tables: every symbol
    carries the label of its tree's root, a merge adds 1 to the code size
    of both trees' members and relabels the absorbed tree (the linked
    lists of the host builder become two compares per symbol).  v1 is
    the largest index among the least-frequent live chains, v2 the
    largest among the least of the rest: one argmin each over the key
    frequency · 512 + (511 - index).  The reserved symbol has frequency
    1 at index 256; DC tables are padded to 257 symbols, so that it
    orders above every real symbol as at index 16 in the host builder.
    An empty class codes symbol 0;
  - the K.3 redistribution of lengths above 16 bits (Figure K.3) as
    masked loops over the (33,) length counts, then the reserved slot
    dropped;
  - the canonical order (pre-limit code size, symbol), the canonical
    codes and the packed tables (code << 5 | length at the symbol's
    entry: K3's table layout), scattered by integer indexing (the JAX
    package's one-hot float32 matmul is a workaround for the TPU's
    scatter).

A code size above 32 bits (the host builder raises ValueError) flags the
image.  K5's contract (build_plain) adds what the emission needs: a
flagged image gets the standard tables and a zeroed header, so that K3b
still codes the batch and the image is redone alone on the host
builder, which raises the error; and the scans' bits under the final
tables (scan_bits), from the raw histograms.  Its header (OPT_HDR int32
words per image, the layout below) is the one small pull of an optimal
emission; split_opt_header and specs_from_opt_header read it on the
host.

This module is the CPU's route and what K5 (ops/huffbuild_cuda.py) is
held against on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SYMBOLS = 257  # 256 real symbol slots and the reserved one
_BIG = 1 << 62  # a key above every live chain's
_KEY_SHIFT = 9  # key = frequency << 9 | (511 - index)

# K5's header, int32 words per image: the scan bits (int64, little-endian
# words 0 and 1), the overflow flag, nvals (4), the DHT BITS lists
# (4, 16), the DHT VALS bytes dc-luma[16] dc-chroma[16] ac-luma[256]
# ac-chroma[256] packed four to a word, and a pad word (rows of an even
# number of words keep the int64 aligned).
HDR_BITS = 0
HDR_OVERFLOW = 2
HDR_NVALS = 3
HDR_BITS16 = 7
HDR_VALS = 71
VALS_BYTES = 2 * 16 + 2 * 256
OPT_HDR = HDR_VALS + VALS_BYTES // 4 + 1  # 208
VALS_AT = (0, 16, 32, 288)  # each table's first VALS byte


def _merge_codesizes(freq: torch.Tensor) -> torch.Tensor:
    """K.2's merge loop for T tables in lockstep.  freq (T, 257) int64,
    the reserved symbol (frequency 1) at 256; returns the code sizes
    (T, 257) int64 (0 for a symbol never coded)."""
    t, n = freq.shape
    dev = freq.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    rows = torch.arange(t, device=dev)
    f = freq.clone()
    codesize = torch.zeros_like(f)
    group = idx.expand(t, n).clone()
    tie = (2 ** _KEY_SHIFT - 1) - idx
    while True:
        key = torch.where(f > 0, (f << _KEY_SHIFT) | tie, _BIG)
        k1, v1 = key.min(dim=1)
        key[rows, v1] = _BIG
        k2, v2 = key.min(dim=1)
        active = k2 < _BIG  # a second live chain
        if not bool(active.any()):
            return codesize
        act = active[:, None]
        g1 = group[rows, v1][:, None]
        g2 = group[rows, v2][:, None]
        in2 = group == g2
        codesize += ((group == g1) | in2) & act
        group = torch.where(in2 & act, g1, group)
        f2 = torch.where(active, k2 >> _KEY_SHIFT, 0)
        f[rows, v1] += f2
        f[rows, v2] = torch.where(active, 0, f[rows, v2])


def _limit_16(bits33: torch.Tensor) -> torch.Tensor:
    """K.2 Figure K.3 on (T, 33) int64 length counts: lengths above 16
    redistributed, then the reserved symbol's slot dropped from the
    longest length left."""
    b = bits33.clone()
    idx = torch.arange(33, device=b.device)
    for i in range(32, 16, -1):
        while True:
            active = b[:, i] > 0
            if not bool(active.any()):
                break
            j = torch.where((idx <= i - 2) & (b > 0), idx, -1).max(dim=1)[0]
            delta = (-2 * (idx == i).to(b.dtype) + (idx == i - 1)
                     + 2 * (idx == (j + 1)[:, None])
                     - (idx == j[:, None]).to(b.dtype))
            b = torch.where(active[:, None], b + delta, b)
    imax = torch.where((idx >= 1) & (idx <= 16) & (b > 0), idx, -1).max(
        dim=1)[0]
    return b - (idx == imax[:, None]).to(b.dtype)


def _canonical_packed(bits16: torch.Tensor, vals: torch.Tensor,
                      nvals: torch.Tensor, size: int) -> torch.Tensor:
    """(T, size) int32 packed canonical tables (code << 5 | length at
    each coded symbol's entry, else 0) of T specs: bits16 (T, 16), vals
    (T, V) in canonical order, nvals (T,).  The k-th code is the
    exclusive sum of 2^(16 - L_j) over j < k, shifted down by 16 - L_k
    (exact: lengths do not decrease)."""
    t, v = vals.shape
    k = torch.arange(v, device=vals.device)
    cum = torch.cumsum(bits16, dim=1)
    lens = 1 + (k[None, None, :] >= cum[:, :, None]).sum(dim=1)
    valid = k[None, :] < nvals[:, None]
    # Only a flagged image's table can ask for a length above 16; its
    # table is replaced, so its shift is only kept defined.
    shift = (16 - lens).clamp(min=0)
    kraft = torch.where(valid, torch.ones_like(lens) << shift, 0)
    pre = torch.cumsum(kraft, dim=1) - kraft
    packed = torch.where(valid, ((pre >> shift) << 5) | lens, 0)
    out = torch.zeros((t, size + 1), dtype=torch.int64, device=vals.device)
    out.scatter_(1, torch.where(valid, vals, size), packed)
    return out[:, :size].to(torch.int32)


def build_tables_device(dc_freq: torch.Tensor, ac_freq: torch.Tensor):
    """Per-image optimal Huffman specs and packed code tables, the JAX
    build_tables_device's outputs in order and dtype.  dc_freq (B, 2, 16)
    and ac_freq (B, 2, 256) integer counts, classes [luma, chroma].
    Returns:

    - tables (B, 2, 272) int32: per class 16 DC then 256 AC entries,
      code << 5 | length (K3's layout);
    - bits16 (B, 4, 16) int32: the DHT BITS lists, tables [dc-luma,
      dc-chroma, ac-luma, ac-chroma];
    - vals (B, 4, 256) int32: the DHT VALS in canonical order,
      zero-padded;
    - nvals (B, 4) int32;
    - overflow (B,) bool: some code size above 32 bits before the K.3
      limit (the host builder raises ValueError there)."""
    dc = torch.as_tensor(dc_freq).to(torch.int64)
    ac = torch.as_tensor(ac_freq).to(torch.int64)
    b = dc.shape[0]
    dev = dc.device
    freq = torch.zeros((b, 4, SYMBOLS), dtype=torch.int64, device=dev)
    freq[:, :2, :16] = dc
    freq[:, 2:, :256] = ac
    # Empty classes code symbol 0 (huffopt.py:108-111).
    freq[:, :, 0] += freq.sum(dim=2) == 0
    freq[:, :, 256] = 1  # the reserved symbol

    codesize = _merge_codesizes(freq.reshape(b * 4, SYMBOLS))
    overflow = (codesize > 32).reshape(b, 4 * SYMBOLS).any(dim=1)

    cs_clip = codesize.clamp(max=32)
    bits33 = torch.zeros((b * 4, 33), dtype=torch.int64, device=dev)
    bits33.scatter_add_(1, cs_clip, (codesize > 0).to(torch.int64))
    bits16 = _limit_16(bits33)[:, 1:17]

    # Canonical order: (pre-limit code size, symbol); the reserved and
    # uncoded symbols sort to the end.
    sym = torch.arange(SYMBOLS, device=dev)
    real = (sym < 256) & (codesize > 0)
    skey = torch.where(real, cs_clip * 256 + sym, _BIG).sort(dim=1)[0]
    nvals = real.sum(dim=1)
    vals = torch.where(sym < nvals[:, None], skey & 255, 0)[:, :256]

    dc_t = _canonical_packed(bits16.view(b, 4, 16)[:, :2].reshape(-1, 16),
                             vals.view(b, 4, 256)[:, :2].reshape(-1, 256),
                             nvals.view(b, 4)[:, :2].reshape(-1), 16)
    ac_t = _canonical_packed(bits16.view(b, 4, 16)[:, 2:].reshape(-1, 16),
                             vals.view(b, 4, 256)[:, 2:].reshape(-1, 256),
                             nvals.view(b, 4)[:, 2:].reshape(-1), 256)
    tables = torch.cat([dc_t.view(b, 2, 16), ac_t.view(b, 2, 256)], dim=2)
    return (tables, bits16.view(b, 4, 16).to(torch.int32),
            vals.view(b, 4, 256).to(torch.int32),
            nvals.view(b, 4).to(torch.int32), overflow)


def scan_bits(dc_freq: torch.Tensor, ac_freq: torch.Tensor,
              tables: torch.Tensor) -> torch.Tensor:
    """(B,) int64 scan bits under packed tables (1 or B, 2, 272), from
    the raw histograms (B, 2, 16) and (B, 2, 256): each symbol's count
    times its code length plus its magnitude bits (the DC symbol's value,
    the AC symbol's low nibble).  The counterpart of
    parallel/batched.hist_bits."""
    lens = (tables & 31).to(torch.int64)
    extra = torch.arange(256, dtype=torch.int64, device=tables.device)
    return ((dc_freq.to(torch.int64) * (lens[:, :, :16] + extra[:16])).sum(
        dim=(1, 2)) + (ac_freq.to(torch.int64)
                       * (lens[:, :, 16:] + (extra & 15))).sum(dim=(1, 2)))


class Built(NamedTuple):
    """K5's outputs on the histograms' device: tables (B, 2, 272) int32
    for K3b, and the header (B, OPT_HDR) int32 the host pulls."""

    tables: torch.Tensor
    header: torch.Tensor


def pack_header(bits: torch.Tensor, overflow: torch.Tensor,
                bits16: torch.Tensor, vals: torch.Tensor,
                nvals: torch.Tensor) -> torch.Tensor:
    """(B, OPT_HDR) int32 header of (B,) int64 scan bits, (B,) bool
    overflow flags and the specs build_tables_device returns."""
    b = bits.shape[0]
    hdr = torch.zeros((b, OPT_HDR), dtype=torch.int32, device=bits.device)
    hdr[:, HDR_BITS:HDR_BITS + 2] = bits.to(torch.int64).reshape(
        b, 1).view(torch.int32)
    hdr[:, HDR_OVERFLOW] = overflow.to(torch.int32)
    hdr[:, HDR_NVALS:HDR_NVALS + 4] = nvals
    hdr[:, HDR_BITS16:HDR_VALS] = bits16.reshape(b, 64)
    vals8 = torch.cat([vals[:, 0, :16], vals[:, 1, :16], vals[:, 2],
                       vals[:, 3]], dim=1).to(torch.uint8)
    hdr[:, HDR_VALS:OPT_HDR - 1] = vals8.view(torch.int32)
    return hdr


def build_plain(hist: torch.Tensor, std: torch.Tensor) -> Built:
    """K5's plain version: from K3a's (B, 544) histograms (dc (2, 16)
    then ac (2, 256) per image) and the standard tables (1, 2, 272), each
    image's optimal tables and its header: the scan bits under the
    tables, the overflow flag and the specs.  A flagged image gets the
    standard tables, bits under them and zero specs."""
    b = hist.shape[0]
    dc = hist[:, :32].reshape(b, 2, 16)
    ac = hist[:, 32:].reshape(b, 2, 256)
    tables, bits16, vals, nvals, overflow = build_tables_device(dc, ac)
    keep = ~overflow
    tables = torch.where(overflow[:, None, None], std, tables)
    hdr = pack_header(scan_bits(dc, ac, tables), overflow,
                      bits16 * keep[:, None, None],
                      vals * keep[:, None, None], nvals * keep[:, None])
    return Built(tables.contiguous(), hdr)


def split_opt_header(hdr: np.ndarray):
    """A pulled (B, OPT_HDR) int32 header of K5 (JAX parallel/batched.py
    :377) → (bits (B,) int64, overflow (B,) bool, bits16 (B, 4, 16),
    nvals (B, 4), vals (B, 544) uint8 in VALS_AT's order)."""
    hdr = np.ascontiguousarray(hdr, dtype=np.int32)
    b = hdr.shape[0]
    bits = np.ascontiguousarray(hdr[:, HDR_BITS:HDR_BITS + 2]).view(
        np.int64)[:, 0]
    return (bits, hdr[:, HDR_OVERFLOW] != 0,
            hdr[:, HDR_BITS16:HDR_VALS].reshape(b, 4, 16),
            hdr[:, HDR_NVALS:HDR_NVALS + 4], np.ascontiguousarray(
                hdr[:, HDR_VALS:OPT_HDR - 1]).view(np.uint8))


def specs_from_opt_header(bits16: np.ndarray, nvals: np.ndarray,
                          vals: np.ndarray, j: int):
    """Image j's (dc_specs, ac_specs) for its DHT segment from the pulled
    header's arrays (JAX parallel/batched.py :394)."""
    specs = [(bits16[j, t].tolist(),
              vals[j, VALS_AT[t]:VALS_AT[t] + nvals[j, t]].tolist())
             for t in range(4)]
    return specs[:2], specs[2:]
