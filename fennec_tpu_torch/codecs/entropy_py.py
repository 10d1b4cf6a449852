"""Scan-component descriptors handed to the native entropy coder.

The two classes of fennec_tpu/codecs/entropy_py.py that the native
façade (fennec_tpu_torch/native.py) reads.  The JAX package's pure-Python
Huffman coder is not carried over: the port has no Python fallback.
"""

from __future__ import annotations

from typing import Tuple

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
