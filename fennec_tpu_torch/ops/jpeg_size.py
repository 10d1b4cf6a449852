"""The JPEG size oracle: exact Huffman bit count of a baseline scan, in
torch.

Counterpart of fennec_tpu/ops/jpeg_size.py (mcu_order, _bitlen,
component_scan_bits, scan_bits_device).  From quantized coefficient
blocks it counts the bits the host encoder would write with the Annex-K
tables, vectorized over blocks (T.81 F.1.2):

  DC: the difference to the previous block in MCU scan order → size
      category s, bits = len(dc_code[s]) + s;
  AC: for each nonzero coefficient at zigzag position p, r zeros after
      the previous nonzero (an exclusive running max of nonzero
      positions, torch.cummax): bits = (r // 16)·len(ZRL)
      + len(ac_code[(r % 16, s)]) + s, plus EOB when a block ends in
      zeros.

The JAX package looks up code lengths with a one-hot float32 dot (a TPU
workaround for slow gathers); here they are plain indexing into the
length tables.  Counts are integer sums, exact in any order.  The count
excludes 0xFF byte stuffing, so callers verify a winner's real bytes.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..codecs import tables as std_tables
from .dct import ZIGZAG

# |v| of a baseline coefficient or DC difference stays below 2^11; the
# JAX package counts at most 12 magnitude bits, and so does this table.
_BITLEN_SIZE = 1 << 12


def _code_lengths(bits: List[int], values: List[int],
                  size: int) -> np.ndarray:
    """(size,) code lengths per symbol; 0 for absent symbols."""
    out = np.zeros(size, dtype=np.int32)
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[values[k]] = length
            k += 1
    return out


@functools.lru_cache(maxsize=1)
def _host_tables() -> Tuple[np.ndarray, ...]:
    """(dc_luma, ac_luma, dc_chroma, ac_chroma) code lengths, the
    size-category table bitlen[a] = min(bit_length(a), 12) and the zigzag
    order."""
    bitlen = np.array([min(int(a).bit_length(), 12)
                       for a in range(_BITLEN_SIZE)], dtype=np.int32)
    return (_code_lengths(std_tables.DC_LUMA_BITS,
                          std_tables.DC_LUMA_VALS, 16),
            _code_lengths(std_tables.AC_LUMA_BITS,
                          std_tables.AC_LUMA_VALS, 256),
            _code_lengths(std_tables.DC_CHROMA_BITS,
                          std_tables.DC_CHROMA_VALS, 16),
            _code_lengths(std_tables.AC_CHROMA_BITS,
                          std_tables.AC_CHROMA_VALS, 256),
            bitlen, ZIGZAG.astype(np.int64))


_device_tables: dict = {}
_device_orders: dict = {}


def _tables_on(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """_host_tables() as tensors on `device` (built once per device)."""
    key = str(device)
    got = _device_tables.get(key)
    if got is None:
        got = tuple(torch.from_numpy(t).to(device) for t in _host_tables())
        _device_tables[key] = got
    return got


@functools.lru_cache(maxsize=256)
def mcu_order(bw: int, bh: int, h: int, v: int) -> np.ndarray:
    """Raster block index for each MCU-scan position."""
    mx, my = bw // h, bh // v
    m_y, m_x, dy, dx = np.meshgrid(np.arange(my), np.arange(mx),
                                   np.arange(v), np.arange(h),
                                   indexing="ij")
    order = (m_y * v + dy) * bw + (m_x * h + dx)
    return order.reshape(-1).astype(np.int64)


def _order_on(bw: int, bh: int, h: int, v: int,
              device: torch.device) -> torch.Tensor:
    """mcu_order as an int64 tensor on `device` (cached per geometry)."""
    key = (bw, bh, h, v, str(device))
    got = _device_orders.get(key)
    if got is None:
        got = torch.from_numpy(mcu_order(bw, bh, h, v)).to(device)
        if len(_device_orders) >= 256:
            _device_orders.clear()
        _device_orders[key] = got
    return got


def _bitlen(v: torch.Tensor, bitlen: torch.Tensor) -> torch.Tensor:
    """Size category of integer v: magnitude bits of |v| (0 for 0)."""
    return bitlen[v.abs().clamp_(max=_BITLEN_SIZE - 1)]


def component_scan_bits(qblocks: torch.Tensor, order: torch.Tensor,
                        dc_len: torch.Tensor, ac_len: torch.Tensor,
                        bitlen: torch.Tensor,
                        zigzag: torch.Tensor) -> torch.Tensor:
    """Scan bits of one component's (..., N, 64) quantized blocks
    (natural order, raster; `order` maps MCU-scan position → raster
    index).  Leading dimensions are images; returns (...,) int64."""
    zz = qblocks.index_select(-1, zigzag).to(torch.int32)

    # DC: first difference along MCU order.
    dc = zz[..., 0].index_select(-1, order)
    diff = dc.clone()
    diff[..., 1:] -= dc[..., :-1]
    s_dc = _bitlen(diff, bitlen)
    dc_bits = (dc_len[s_dc] + s_dc).sum(dim=-1, dtype=torch.int64)

    # AC: runs from the exclusive running max of nonzero positions; the
    # DC slot counts as nonzero so the first run counts from 1.
    nz = zz != 0
    idx = torch.arange(64, dtype=torch.int32, device=zz.device)
    marked = torch.where(nz, idx, 0)
    last = torch.cummax(marked, dim=-1).values
    prev_nz = torch.zeros_like(last)
    prev_nz[..., 1:] = last[..., :-1]
    gap = idx - prev_nz - 1
    s_ac = _bitlen(zz, bitlen)
    zrl = torch.div(gap, 16, rounding_mode="floor")
    rem = gap - zrl * 16
    sym_bits = ac_len[rem * 16 + s_ac] + s_ac + zrl * ac_len[0xF0]
    nz[..., 0] = False
    ac_bits = torch.where(nz, sym_bits, 0).sum(dim=(-2, -1),
                                               dtype=torch.int64)

    # EOB for every block whose last zigzag coefficient is zero.
    eob = (zz[..., 63] == 0).sum(dim=-1, dtype=torch.int64) * ac_len[0x00]
    return dc_bits + ac_bits + eob


def bits_std_from_hist(dc_freq: torch.Tensor,
                       ac_freq: torch.Tensor) -> torch.Tensor:
    """Exact standard-table scan bits from symbol histograms (JAX
    :165-188): a DC symbol s costs len(dc_code[s]) + s bits, an AC symbol
    rs costs len(ac_code[rs]) + (rs & 15), and ZRL and EOB carry no
    magnitude bits, so the total is one dot product.  dc_freq
    (..., 2, 16), ac_freq (..., 2, 256) → (...,) int64."""
    dc_l, ac_l, dc_c, ac_c = (torch.from_numpy(t) for t in
                              _host_tables()[:4])
    extra = torch.arange(256, dtype=torch.int64)
    dc_cost = (torch.stack([dc_l, dc_c]) + extra[:16]).to(dc_freq.device)
    ac_cost = (torch.stack([ac_l, ac_c]) + (extra & 15)).to(ac_freq.device)
    return ((dc_freq.to(torch.int64) * dc_cost).sum(dim=(-2, -1))
            + (ac_freq.to(torch.int64) * ac_cost).sum(dim=(-2, -1)))


def scan_bits(qy: torch.Tensor, qcb: torch.Tensor, qcr: torch.Tensor,
              padded_h: int, padded_w: int, subsample: bool) -> torch.Tensor:
    """Exact entropy-coded bits (stuffing excluded) of a 3-component
    interleaved scan of (..., N, 64) quantized blocks → (...,) int64."""
    dev = qy.device
    dc_l, ac_l, dc_c, ac_c, bitlen, zigzag = _tables_on(dev)
    by, bx = padded_h // 8, padded_w // 8
    if subsample:
        cby, cbx = padded_h // 16, padded_w // 16
        y_order = _order_on(bx, by, 2, 2, dev)
    else:
        cby, cbx = by, bx
        y_order = _order_on(bx, by, 1, 1, dev)
    c_order = _order_on(cbx, cby, 1, 1, dev)
    return (component_scan_bits(qy, y_order, dc_l, ac_l, bitlen, zigzag)
            + component_scan_bits(qcb, c_order, dc_c, ac_c, bitlen, zigzag)
            + component_scan_bits(qcr, c_order, dc_c, ac_c, bitlen, zigzag))
