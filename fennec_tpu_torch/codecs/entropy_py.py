"""Scan-component descriptors for the native entropy coder, and the
Python Huffman decoder the progressive scan decoder falls back to.

Copied from fennec_tpu/codecs/entropy_py.py: the two spec classes the
native façade (fennec_tpu_torch/native.py) reads, and the decode half
(canonical decode tables, the bit reader, _decode_huffman, _extend) that
codecs/progressive.py uses for a scan the C++ decoder rejects.  The JAX
package's pure-Python baseline scan coder is not carried over: baseline
scans have no Python fallback in the port.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ComponentSpec:
    """One scan component to encode: quantized coefficients + geometry.
    `chroma` selects the luma or chroma table class."""

    def __init__(self, qcoefs: np.ndarray, blocks_w: int, blocks_h: int,
                 h: int, v: int, chroma: bool = False):
        self.qcoefs = qcoefs  # (nblocks, 64) int, natural order, raster
        self.bw = blocks_w
        self.bh = blocks_h
        self.h = h
        self.v = v
        self.chroma = chroma


class DecodeComponentSpec:
    """One scan component to decode: geometry + raw Huffman (BITS, VALS)
    specs as parsed from DHT segments."""

    def __init__(self, blocks_w: int, blocks_h: int, h: int, v: int,
                 dc_spec: Tuple[list, list], ac_spec: Tuple[list, list]):
        self.bw = blocks_w
        self.bh = blocks_h
        self.h = h
        self.v = v
        self.dc_spec = dc_spec
        self.ac_spec = ac_spec


# ── Decoding ────────────────────────────────────────────────────────────────


def build_decode_table(bits: List[int], values: List[int]):
    """(mincode, maxcode, valptr, values) arrays for canonical decoding."""
    mincode = [0] * 17
    maxcode = [-1] * 17
    valptr = [0] * 17
    code = 0
    k = 0
    for length in range(1, 17):
        if bits[length - 1] > 0:
            valptr[length] = k
            mincode[length] = code
            code += bits[length - 1]
            k += bits[length - 1]
            maxcode[length] = code - 1
        else:
            maxcode[length] = -1
        code <<= 1
    return mincode, maxcode, valptr, list(values)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.marker_hit: Optional[int] = None

    def _fill(self) -> None:
        while self.nbits <= 24:
            if self.pos >= len(self.data):
                self.acc = (self.acc << 8) | 0
                self.nbits += 8
                continue
            b = self.data[self.pos]
            if b == 0xFF:
                nxt = (self.data[self.pos + 1]
                       if self.pos + 1 < len(self.data) else 0xD9)
                if nxt == 0x00:
                    self.pos += 2
                    self.acc = (self.acc << 8) | 0xFF
                    self.nbits += 8
                    continue
                # A real marker: stop feeding bits.
                self.marker_hit = nxt
                self.acc = (self.acc << 8) | 0
                self.nbits += 8
                continue
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.nbits += 8

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def align_to_marker(self) -> Optional[int]:
        """Discard buffered bits and consume an RSTn marker if present."""
        self.acc = 0
        self.nbits = 0
        self.marker_hit = None
        while self.pos + 1 < len(self.data):
            if self.data[self.pos] == 0xFF and \
                    self.data[self.pos + 1] != 0x00:
                if self.data[self.pos + 1] == 0xFF:
                    self.pos += 1  # legal fill byte (T.81 B.1.1.2)
                    continue
                m = self.data[self.pos + 1]
                self.pos += 2
                return m
            self.pos += 1
        return None


def _decode_huffman(r: BitReader, table) -> int:
    mincode, maxcode, valptr, values = table
    code = r.read_bit()
    for length in range(1, 17):
        if maxcode[length] >= 0 and code <= maxcode[length]:
            return values[valptr[length] + code - mincode[length]]
        code = (code << 1) | r.read_bit()
    raise ValueError("fennec: corrupt JPEG: bad Huffman code")


def _extend(v: int, size: int) -> int:
    if size == 0:
        return 0
    if v < (1 << (size - 1)):
        return v - (1 << size) + 1
    return v
