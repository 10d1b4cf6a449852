"""Huffman emission of baseline JPEG scans on the device: the plain
PyTorch version of kernel K3.

Counterpart of fennec_tpu/ops/jpeg_emit.py (_scan_layout, _symbols,
scan_symbol_hist_device, emit_scan_device, finalize_scan_host).  From
quantized blocks (B, NT, 64) (natural order; y, cb, cr rasters on
MCU-padded grids, one geometry per call) it computes, per scan slot in
MCU order:

  block_stats  each block's bit count under the code tables it is given,
               their sum per image (the scan's bits: under the standard
               tables the size oracle's count), and the per-image symbol
               histograms (2, 16) DC and (2, 256) AC [luma, chroma] that
               optimal tables are built from (T.81 K.2);
  deposit      the entropy-coded words, big-endian uint32 bit patterns in
               int32 storage, of a whole batch in one buffer: image b
               owns words [word_base[b], word_base[b+1]), exactly
               ceil(bits_b / 32) of them, and each block writes its
               fields at word_base[b]·32 + its exclusive bit offset, the
               bits of the image's blocks before it in slot order.

The symbols are the C++ encoder's (entropy.cpp encode_block): the DC
difference against the previous block of the same component in MCU
order; each nonzero AC coefficient after r zeros costs r // 16 ZRLs and
the symbol (r % 16) << 4 | size; EOB exactly when zigzag position 63 is
zero.  Byte stuffing and the final 1-padding stay on the host
(finalize_scan_host), on the scan's ≈ file-size bytes.

The JAX package's TPU workarounds are not carried over: one-hot matmul
lookups and histograms, per-block local buffers with an optimistic width
and an overflow redo, matmul assembly and power-of-two word buffers.
Lookups are indexing, histograms and the deposit are integer index_add_
(exact in any order: bit ranges are disjoint, so adding the fields of a
word ORs them), and the word buffer is sized from the exact bit count.

Code tables are (T, 2, 272) int32, T = 1 (shared) or B, per class
[luma, chroma]: 16 DC entries then 256 AC entries, each code << 5 |
length (0 for an absent symbol), the layout of the JAX package's
huffopt.code_tables_batch.  Coefficients are baseline's: a size
category above 15 indexes the DC table at 15, in K3 and here alike.

This module is what the CPU runs and what K3 (ops/jpeg_emit_cuda.py) is
held against on the card.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codecs import tables as std_tables
from .dct import ZIGZAG, quantize_blocks
from .jpeg_size import mcu_order

TABLE = 16 + 256  # entries per class: DC then AC
HIST = 2 * 16 + 2 * 256  # histogram columns per image: DC then AC
ZRL, EOB = 0xF0, 0x00


def code_arrays(bits, values, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, lengths) int32 arrays indexed by symbol; length 0 = absent
    (the canonical walk of T.81 C.2)."""
    codes = np.zeros(size, dtype=np.int32)
    lens = np.zeros(size, dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = code
            lens[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lens


def pack_tables(dc_specs, ac_specs) -> np.ndarray:
    """(2, 272) int32 packed code tables of [luma, chroma] (BITS, VALS)
    specs."""
    out = np.zeros((2, TABLE), dtype=np.int32)
    for cls in range(2):
        c, ln = code_arrays(*dc_specs[cls], 16)
        out[cls, :16] = (c << 5) | ln
        c, ln = code_arrays(*ac_specs[cls], 256)
        out[cls, 16:] = (c << 5) | ln
    return out


@functools.lru_cache(maxsize=1)
def std_tables_packed() -> np.ndarray:
    """The Annex-K tables, (1, 2, 272) int32 packed."""
    return pack_tables(
        [(std_tables.DC_LUMA_BITS, std_tables.DC_LUMA_VALS),
         (std_tables.DC_CHROMA_BITS, std_tables.DC_CHROMA_VALS)],
        [(std_tables.AC_LUMA_BITS, std_tables.AC_LUMA_VALS),
         (std_tables.AC_CHROMA_BITS, std_tables.AC_CHROMA_VALS)])[None]


class ScanLayout(NamedTuple):
    """One geometry's interleaved scan: for scan slot g (MCU order: four
    Y blocks then Cb then Cr in 4:2:0, Y Cb Cr in 4:4:4), slot_row[g] is
    its row of the (NT, 64) y|cb|cr block stack and prev_row[g] the row
    of the previous block of the same component in MCU order (-1 for a
    component's first), prev_slot[g] that block's slot (-1 likewise;
    always below g).  Rows below ny are luma."""

    slot_row: np.ndarray
    prev_row: np.ndarray
    ny: int
    prev_slot: np.ndarray


@functools.lru_cache(maxsize=64)
def scan_layout(padded_h: int, padded_w: int, subsample: bool) -> ScanLayout:
    """The layout of JAX _scan_layout / _slot_permutation, as arrays."""
    by, bx = padded_h // 8, padded_w // 8
    if subsample:
        y_order = mcu_order(bx, by, 2, 2)
        c_order = mcu_order(bx // 2, by // 2, 1, 1)
        per_mcu = 4
    else:
        y_order = mcu_order(bx, by, 1, 1)
        c_order = y_order
        per_mcu = 1
    ny, nc = y_order.size, c_order.size
    width = per_mcu + 2
    slot_row = np.empty(ny + 2 * nc, dtype=np.int64)
    prev_row = np.empty_like(slot_row)
    y_rows = y_order.reshape(nc, per_mcu)
    y_prev = np.concatenate([[-1], y_order[:-1]]).reshape(nc, per_mcu)
    c_prev = np.concatenate([[-1], c_order[:-1]])
    for j in range(per_mcu):
        slot_row[j::width] = y_rows[:, j]
        prev_row[j::width] = y_prev[:, j]
    for k, base in ((per_mcu, ny), (per_mcu + 1, ny + nc)):
        slot_row[k::width] = base + c_order
        prev_row[k::width] = np.where(c_prev >= 0, base + c_prev, -1)
    slot_of = np.empty_like(slot_row)
    slot_of[slot_row] = np.arange(slot_row.size)
    prev_slot = np.where(prev_row >= 0, slot_of[np.maximum(prev_row, 0)], -1)
    return ScanLayout(slot_row.astype(np.int32), prev_row.astype(np.int32),
                      ny, prev_slot.astype(np.int32))


_layouts: Dict[tuple, ScanLayout] = {}
_std_on: Dict[str, torch.Tensor] = {}
_cache_lock = threading.Lock()


def layout_on(padded_h: int, padded_w: int, subsample: bool,
              device: torch.device) -> ScanLayout:
    """scan_layout with its arrays as int32 tensors on `device` (cached
    per geometry and device)."""
    key = (padded_h, padded_w, subsample, str(device))
    with _cache_lock:
        got = _layouts.get(key)
    if got is None:
        lay = scan_layout(padded_h, padded_w, subsample)
        got = ScanLayout(torch.from_numpy(lay.slot_row).to(device),
                         torch.from_numpy(lay.prev_row).to(device), lay.ny,
                         torch.from_numpy(lay.prev_slot).to(device))
        with _cache_lock:
            if len(_layouts) >= 64:
                _layouts.clear()
            _layouts[key] = got
    return got


def std_tables_on(device: torch.device) -> torch.Tensor:
    """std_tables_packed() as a (1, 2, 272) int32 tensor on `device`."""
    key = str(device)
    with _cache_lock:
        got = _std_on.get(key)
    if got is None:
        got = torch.from_numpy(std_tables_packed()).to(device)
        with _cache_lock:
            _std_on[key] = got
    return got


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Magnitude bits of |v| (0 for 0), int32: frexp's exponent, exact
    for |v| < 2^24."""
    return torch.frexp(v.abs().to(torch.float32)).exponent.to(torch.int32)


def _magnitude(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """The size low bits T.81 F.1.2.1 writes for v: v, or v + 2^size - 1
    when negative."""
    return torch.where(v >= 0, v, v + (1 << size) - 1)


def _symbols(packed: torch.Tensor, lay: ScanLayout, tables: torch.Tensor):
    """Every field of the scan, in slot order, for (B, NT, 64) blocks.
    Returns a dict of (B, NT) and (B, NT, 63) int32 tensors."""
    bsz = packed.shape[0]
    dev = packed.device
    rows = lay.slot_row.long()
    prev = lay.prev_row.long()
    zig = torch.from_numpy(ZIGZAG.astype(np.int64)).to(dev)
    zz = packed.index_select(1, rows).index_select(2, zig).to(torch.int32)
    pdc = packed[:, prev.clamp(min=0), 0].to(torch.int32) * (prev >= 0)
    cls = (rows >= lay.ny).long()  # (NT,)

    tab = tables.expand(bsz, 2, TABLE)
    lens, codes = tab & 31, tab >> 5
    b_ix = torch.arange(bsz, device=dev)[:, None]

    diff = zz[..., 0] - pdc
    s_dc = _bit_length(diff)
    dc_sym = s_dc.clamp(max=15).long()
    ac = zz[..., 1:]
    nz = ac != 0
    pos = torch.arange(1, 64, dtype=torch.int32, device=dev)
    seen = torch.cummax(torch.where(nz, pos, 0), dim=-1).values
    last = torch.cat([torch.zeros_like(seen[..., :1]), seen[..., :-1]], -1)
    run = pos - last - 1
    s_ac = _bit_length(ac)
    sym = (((run & 15) << 4) | s_ac) & 255
    ac_ix = (16 + sym).long()
    cls_ac = cls[None, :, None]
    return {
        "cls": cls, "s_dc": s_dc, "dc_sym": dc_sym,
        "dc_len": lens[b_ix, cls[None], dc_sym],
        "dc_code": codes[b_ix, cls[None], dc_sym],
        "dc_mag": _magnitude(diff, s_dc),
        "nz": nz, "s_ac": s_ac, "sym": sym, "zrl": run >> 4,
        "ac_len": lens[b_ix[..., None], cls_ac, ac_ix],
        "ac_code": codes[b_ix[..., None], cls_ac, ac_ix],
        "ac_mag": _magnitude(ac, s_ac),
        "zrl_len": lens[b_ix, cls[None], 16 + ZRL],
        "zrl_code": codes[b_ix, cls[None], 16 + ZRL],
        "eob": zz[..., 63] == 0,
        "eob_len": lens[b_ix, cls[None], 16 + EOB],
        "eob_code": codes[b_ix, cls[None], 16 + EOB],
    }


def _block_bits(s) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B, NT) int32 block bits, (B, NT, 63) int32 AC field bits)."""
    contrib = torch.where(s["nz"], s["zrl"] * s["zrl_len"][..., None]
                          + s["ac_len"] + s["s_ac"], 0)
    bits = (s["dc_len"] + s["s_dc"] + contrib.sum(-1, dtype=torch.int32)
            + torch.where(s["eob"], s["eob_len"], 0))
    return bits.to(torch.int32), contrib


class BlockStats(NamedTuple):
    """What K3a computes: (B, NT) int32 bits per block in slot order under
    the tables given and (B, 544) int32 histograms (DC [luma, chroma]
    × 16, then AC × 256), each None unless asked for, and (B,) int64
    scan bits per image, the sum of the block bits."""

    bits: Optional[torch.Tensor]
    hist: Optional[torch.Tensor]
    totals: torch.Tensor


def block_stats_plain(packed: torch.Tensor, lay: ScanLayout,
                      tables: torch.Tensor, want_bits: bool = False,
                      want_hist: bool = False) -> BlockStats:
    """K3a's function (see BlockStats)."""
    s = _symbols(packed, lay, tables)
    bits = _block_bits(s)[0]
    totals = bits.sum(dim=1, dtype=torch.int64)
    hist = None
    if want_hist:
        bsz, nt = s["s_dc"].shape
        dev = packed.device
        img = torch.arange(bsz, device=dev)[:, None] * HIST
        acc = torch.zeros(bsz * HIST, dtype=torch.int64, device=dev)
        dc_ix = img + s["cls"][None] * 16 + s["dc_sym"]
        acc.index_add_(0, dc_ix.reshape(-1),
                       torch.ones(bsz * nt, dtype=torch.int64, device=dev))
        ac_base = img + 32 + s["cls"][None] * 256  # (B, NT)
        nz = s["nz"]
        ac_ix = (ac_base[..., None] + s["sym"])[nz]
        acc.index_add_(0, ac_ix, torch.ones_like(ac_ix))
        zrls = torch.where(nz, s["zrl"], 0).sum(-1, dtype=torch.int64)
        acc.index_add_(0, (ac_base + ZRL).reshape(-1), zrls.reshape(-1))
        acc.index_add_(0, (ac_base + EOB).reshape(-1),
                       s["eob"].to(torch.int64).reshape(-1))
        hist = acc.reshape(bsz, HIST).to(torch.int32)
    return BlockStats(bits if want_bits else None, hist, totals)


def quantize_packed(coefs: Sequence[torch.Tensor],
                    qtabs: torch.Tensor) -> torch.Tensor:
    """(B, NT, 64) int16 blocks, y|cb|cr, of (B, N, 64) coefficient
    blocks quantized at (B, 2, 64) [luma, chroma] tables: what the
    emission kernels take.  Baseline coefficients stay below 2^11 at any
    table, so the cast is exact."""
    return torch.cat([
        quantize_blocks(coefs[0], qtabs[:, None, 0]),
        quantize_blocks(coefs[1], qtabs[:, None, 1]),
        quantize_blocks(coefs[2], qtabs[:, None, 1])],
        dim=1).to(torch.int16)


def quantize_count_plain(coefs: Sequence[torch.Tensor],
                         qtables: torch.Tensor, quality: torch.Tensor,
                         lay: ScanLayout, tables: torch.Tensor
                         ) -> torch.Tensor:
    """K4's function, the size oracle's step: (B,) int64 scan bits under
    `tables` of (B, N, 64) float32 coefficient blocks (y, cb, cr)
    quantized at the (101, 2, 64) tables' entries for (B,) int64
    qualities, clamped to [0, 100]: the packed quantize, then K3a's
    totals."""
    packed = quantize_packed(coefs, qtables[quality.clamp(0, 100)])
    return block_stats_plain(packed, lay, tables).totals


def bisect_steps(count_bits: Callable[[torch.Tensor], torch.Tensor],
                 target: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 steps: int):
    """The size bisection's rule (fennec_tpu/engine/size_search.py:41-53)
    as a loop of `steps` steps over int64 tensors of one shape: at each
    step count_bits(mid) gives every image's scan bits at its mid, and an
    image fits when ceil(bits / 8) <= target.  Returns (best_q int64,
    found bool, table): the highest quality in [lo, hi] that fits (0,
    False when none does) and the (steps, ...) int64 bits each step
    counted, -1 where the image's range was already empty.  K4's
    bisection replays this rule from its table on the card."""
    best_q = torch.zeros_like(lo)
    found = torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    rows = []
    for _ in range(steps):
        active = lo <= hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        bits = count_bits(mid)
        ok = active & (torch.div(bits + 7, 8, rounding_mode="floor")
                       <= target)
        best_q = torch.where(ok, mid, best_q)
        found = found | ok
        lo = torch.where(ok, mid + 1, lo)
        hi = torch.where(active & ~ok, mid - 1, hi)
        rows.append(torch.where(active, bits, -1))
    return best_q, found, torch.stack(rows)


def size_bisect_plain(coefs: Sequence[torch.Tensor], qtables: torch.Tensor,
                      lay: ScanLayout, tables: torch.Tensor,
                      bounds: torch.Tensor, steps: int):
    """K4's bisection's function: bisect_steps over K4's step
    (quantize_count_plain) for (B, N, 64) coefficient blocks and (3, B)
    int64 bounds (target bytes, lo0, hi0) → (best_q, found, table)."""
    target, lo, hi = bounds
    return bisect_steps(
        lambda q: quantize_count_plain(coefs, qtables, q, lay, tables),
        target, lo, hi, steps)


def deposit_plain(packed: torch.Tensor, lay: ScanLayout,
                  tables: torch.Tensor, word_base: torch.Tensor,
                  block_off: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3b's function: the scan words of every image.  word_base (B+1,)
    int64; a block starts at the exclusive sum of the bits of its
    image's blocks before it in slot order, as K3b finds it, unless
    block_off (B, NT) int64 gives the offsets.  Returns
    (word_base[-1] + 1,) int32: the words, then a flag that is 1 when
    some field fell outside its image's words (the bit counts and the
    word counts disagree)."""
    s = _symbols(packed, lay, tables)
    bits, contrib = _block_bits(s)
    if block_off is None:
        block_off = torch.cumsum(bits, dim=1, dtype=torch.int64) - bits
    dev = packed.device
    n_words = int(word_base[-1])
    start = word_base[:-1, None] * 32 + block_off  # (B, NT) global bits
    pos = (start + s["dc_len"] + s["s_dc"])[..., None] + (
        torch.cumsum(contrib, -1, dtype=torch.int64) - contrib)
    nz = s["nz"]
    zl = s["zrl_len"][..., None].expand_as(nz)
    zc = s["zrl_code"][..., None].expand_as(nz)
    z = s["zrl"]
    lo = word_base[:-1][:, None].expand_as(start)
    hi = word_base[1:][:, None].expand_as(start)

    off, val, ln, first, end = [], [], [], [], []

    def field(mask, o, v, n, blk_lo, blk_hi):
        off.append(o[mask])
        val.append(v[mask].to(torch.int64))
        ln.append(n[mask].to(torch.int64))
        first.append(blk_lo[mask])
        end.append(blk_hi[mask])

    every = torch.ones_like(bits, dtype=torch.bool)
    lo3, hi3 = lo[..., None].expand_as(nz), hi[..., None].expand_as(nz)
    field(every, start, (s["dc_code"].to(torch.int64) << s["s_dc"])
          | s["dc_mag"], s["dc_len"] + s["s_dc"], lo, hi)
    for j in range(3):
        field(nz & (z > j), pos + j * zl, zc, zl, lo3, hi3)
    field(nz, pos + z * zl, (s["ac_code"].to(torch.int64) << s["s_ac"])
          | s["ac_mag"], s["ac_len"] + s["s_ac"], lo3, hi3)
    field(s["eob"], start + bits - s["eob_len"], s["eob_code"],
          s["eob_len"], lo, hi)
    off, val, ln = torch.cat(off), torch.cat(val), torch.cat(ln)
    first, end = torch.cat(first), torch.cat(end)
    live = ln > 0
    off, val, ln, first, end = (t[live] for t in (off, val, ln, first, end))

    word = off >> 5
    placed = val << (64 - (off & 31) - ln)
    top = (placed >> 32) & 0xFFFFFFFF
    low = placed & 0xFFFFFFFF
    last = (off + ln - 1) >> 5
    bad = bool(((word < first) | (last >= end)).any())
    ok = (word >= 0) & (last < n_words)
    acc = torch.zeros(n_words + 1, dtype=torch.int64, device=dev)
    acc.index_add_(0, word[ok], top[ok])
    two = ok & (low != 0)
    acc.index_add_(0, word[two] + 1, low[two])
    acc[n_words] = int(bad)
    return (acc - ((acc >> 31) << 32)).to(torch.int32)


def finalize_scan_host(words: np.ndarray, total_bits: int) -> bytes:
    """Trim to the scan's bytes, 1-pad the last one and 0xFF-stuff: pure
    numpy (JAX finalize_scan_host, :658).  words: big-endian uint32 bit
    patterns (any 32-bit dtype)."""
    nbytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words).view(np.uint32).astype(
        ">u4").tobytes()[:nbytes]
    buf = bytearray(raw)
    rem = int(total_bits) % 8
    if rem:
        buf[-1] |= (1 << (8 - rem)) - 1
    arr = np.frombuffer(bytes(buf), dtype=np.uint8)
    ff = np.nonzero(arr == 0xFF)[0]
    if ff.size:
        arr = np.insert(arr, ff + 1, np.uint8(0))
    return arr.tobytes()
