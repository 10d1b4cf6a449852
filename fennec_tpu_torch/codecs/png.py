"""PNG codec: encoder with palette/gray/RGBA modes, full baseline decoder.

Host-side (PNG is DEFLATE + byte filters — entropy work, not array math);
a jax-free copy of fennec_tpu/codecs/png.py.  Scanline filtering runs
through the native C++ helpers (fennec_tpu_torch/native.py), which have no
Python fallback.

Encoder parity targets (reference compress.go:90-153, Go png
BestCompression): zlib level 9, per-row adaptive filter heuristic, palette
images packed at 1/2/4/8 bits per pixel, grayscale as 8-bit gray (~3×
smaller than RGBA), tRNS emitted only when the palette has transparency.

Decoder: color types 0/2/3/4/6, bit depths 1/2/4/8/16 (16 → high byte),
interlace methods 0 and Adam7.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from .. import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Adam7 pass layout: (x_start, y_start, x_step, y_step)
_ADAM7 = [
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
]


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


# ── Encoding ────────────────────────────────────────────────────────────────


def encode_png_rgba(img: np.ndarray, level: int = 9) -> bytes:
    """(H, W, 4) uint8 → PNG color type 6 (RGBA, 8-bit)."""
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    raw = native.png_filter(
        np.ascontiguousarray(img).reshape(h, w * 4), bpp=4)
    idat = zlib.compress(raw, level)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def encode_png_gray(gray: np.ndarray, level: int = 9) -> bytes:
    """(H, W) uint8 → PNG color type 0 (8-bit grayscale)."""
    h, w = gray.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    raw = native.png_filter(np.ascontiguousarray(gray).reshape(h, w),
                            bpp=1)
    idat = zlib.compress(raw, level)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def encode_png_paletted(indices: np.ndarray, palette: np.ndarray,
                        level: int = 9) -> bytes:
    """(H, W) uint8 indices + (N, 4) uint8 RGBA palette → color type 3.

    Bit depth is the smallest of 1/2/4/8 that fits the palette (Go's
    encoder does the same, which matters for the target-size strategy's
    candidate ranking)."""
    h, w = indices.shape[:2]
    n = palette.shape[0]
    if n <= 2:
        depth = 1
    elif n <= 4:
        depth = 2
    elif n <= 16:
        depth = 4
    else:
        depth = 8
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 3, 0, 0, 0)
    plte = palette[:, :3].astype(np.uint8).tobytes()
    out = _SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"PLTE", plte)
    alpha = palette[:, 3]
    if np.any(alpha < 255):
        # tRNS can be truncated after the last non-opaque entry.
        last = int(np.max(np.nonzero(alpha < 255)[0]))
        out += _chunk(b"tRNS", alpha[:last + 1].astype(np.uint8).tobytes())
    if depth == 8:
        raw = native.png_filter(
            np.ascontiguousarray(indices).reshape(h, w), bpp=1)
    else:
        packed = _pack_bits(indices, depth)
        raw = b"".join(b"\x00" + packed[y].tobytes()
                       for y in range(h))
    idat = zlib.compress(raw, level)
    return out + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def _pack_bits(indices: np.ndarray, depth: int) -> np.ndarray:
    """Pack (H, W) small ints into PNG big-endian bit rows."""
    h, w = indices.shape
    per_byte = 8 // depth
    padded_w = -(-w // per_byte) * per_byte
    buf = np.zeros((h, padded_w), dtype=np.uint8)
    buf[:, :w] = indices
    buf = buf.reshape(h, padded_w // per_byte, per_byte)
    out = np.zeros((h, padded_w // per_byte), dtype=np.uint8)
    for i in range(per_byte):
        out |= buf[:, :, i] << (8 - depth * (i + 1))
    return out


# ── Decoding ────────────────────────────────────────────────────────────────


class PngInfo:
    def __init__(self) -> None:
        self.width = 0
        self.height = 0
        self.depth = 8
        self.color_type = 6
        self.interlace = 0
        self.palette: Optional[np.ndarray] = None  # (N, 4)
        self.trns: Optional[bytes] = None


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray:
    """Decode a PNG to (H, W, 4) uint8 NRGBA."""
    if data[:8] != _SIGNATURE:
        raise ValueError("fennec: not a PNG")
    info = PngInfo()
    idat: List[bytes] = []
    pos = 8
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            (info.width, info.height, info.depth, info.color_type,
             comp, filt, info.interlace) = struct.unpack(">IIBBBBB",
                                                         payload)
            if comp != 0 or filt != 0:
                raise ValueError("fennec: bad PNG compression/filter method")
            if info.depth not in (1, 2, 4, 8, 16):
                raise ValueError(f"fennec: bad PNG bit depth {info.depth}")
        elif tag == b"PLTE":
            n = len(payload) // 3
            pal = np.frombuffer(payload[:n * 3],
                                dtype=np.uint8).reshape(n, 3)
            info.palette = np.concatenate(
                [pal, np.full((n, 1), 255, dtype=np.uint8)], axis=1)
        elif tag == b"tRNS":
            info.trns = payload
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if info.palette is not None and info.trns is not None:
        a = np.frombuffer(info.trns, dtype=np.uint8)
        info.palette = info.palette.copy()
        info.palette[:len(a), 3] = a

    raw = zlib.decompress(b"".join(idat))
    if info.interlace == 0:
        pixels = _decode_pass(raw, info, info.width, info.height)[1]
    elif info.interlace == 1:
        pixels = _decode_adam7(raw, info)
    else:
        raise ValueError("fennec: bad PNG interlace method")
    return _to_rgba(pixels, info)


def _row_bytes(info: PngInfo, width: int) -> Tuple[int, int]:
    ch = _CHANNELS[info.color_type]
    bits = ch * info.depth
    stride = -(-width * bits // 8)
    bpp = max(1, bits // 8)
    return stride, bpp


def _decode_pass(raw: bytes, info: PngInfo, width: int,
                 height: int) -> Tuple[int, np.ndarray]:
    """Unfilter + unpack one (sub)image; returns (consumed, (H, W, ch))."""
    ch = _CHANNELS[info.color_type]
    stride, bpp = _row_bytes(info, width)
    consumed = (stride + 1) * height
    if height == 0 or width == 0:
        return consumed, np.zeros((height, width, ch), dtype=np.uint8)
    if len(raw) < consumed:
        # The native unfilter has no input-length parameter and would
        # read past a truncated IDAT stream.
        raise ValueError("fennec: truncated PNG image data")
    rows = native.png_unfilter(raw[:consumed], height, stride, bpp)
    if info.depth == 8:
        px = rows.reshape(height, stride)[:, :width * ch]
        px = px.reshape(height, width, ch)
    elif info.depth == 16:
        px = rows.reshape(height, -1)[:, :width * ch * 2]
        px = px.reshape(height, width, ch, 2)[..., 0]  # high byte
    else:
        px = _unpack_bits(rows, width, info.depth)
        if info.color_type == 0:
            # scale to 8-bit
            maxv = (1 << info.depth) - 1
            px = (px.astype(np.uint16) * 255 // maxv).astype(np.uint8)
        px = px.reshape(height, width, 1)
    return consumed, px


def _unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    h = rows.shape[0]
    per_byte = 8 // depth
    vals = np.zeros((h, rows.shape[1] * per_byte), dtype=np.uint8)
    mask = (1 << depth) - 1
    for i in range(per_byte):
        vals[:, i::per_byte] = (rows >> (8 - depth * (i + 1))) & mask
    return vals[:, :width]


def _decode_adam7(raw: bytes, info: PngInfo) -> np.ndarray:
    ch = _CHANNELS[info.color_type]
    out = np.zeros((info.height, info.width, ch), dtype=np.uint8)
    pos = 0
    for (x0, y0, dx, dy) in _ADAM7:
        pw = max(0, -(-(info.width - x0) // dx))
        ph = max(0, -(-(info.height - y0) // dy))
        if pw == 0 or ph == 0:
            continue
        consumed, px = _decode_pass(raw[pos:], info, pw, ph)
        pos += consumed
        out[y0::dy, x0::dx] = px
    return out


def _to_rgba(px: np.ndarray, info: PngInfo) -> np.ndarray:
    h, w = px.shape[:2]
    out = np.zeros((h, w, 4), dtype=np.uint8)
    ct = info.color_type
    if ct == 0:  # gray
        g = px[..., 0]
        out[..., 0] = out[..., 1] = out[..., 2] = g
        out[..., 3] = 255
        if info.trns and len(info.trns) >= 2:
            # px was normalized by _decode_pass: depth<8 samples are
            # scaled to 0..255, depth-16 keeps the HIGH byte — the key
            # must be mapped through the same transform before comparing.
            key = struct.unpack(">H", info.trns[:2])[0]
            if info.depth == 16:
                key >>= 8
            elif info.depth == 8:
                key &= 0xFF
            else:
                maxv = (1 << info.depth) - 1
                key = ((key & maxv) * 255) // maxv
            out[..., 3] = np.where(px[..., 0] == key, 0, 255)
    elif ct == 2:  # rgb
        out[..., :3] = px
        out[..., 3] = 255
        if info.trns and len(info.trns) >= 6:
            # 6-byte RGB color key (2 bytes per sample); samples were
            # byte-normalized like the pixels above.
            kr, kg, kb = struct.unpack(">HHH", info.trns[:6])
            shift = 8 if info.depth == 16 else 0
            mask = 0xFF if info.depth == 8 else 0xFFFF
            keys = [(k & mask) >> shift for k in (kr, kg, kb)]
            hit = ((px[..., 0] == keys[0]) & (px[..., 1] == keys[1])
                   & (px[..., 2] == keys[2]))
            out[..., 3] = np.where(hit, 0, 255)
    elif ct == 3:  # palette
        if info.palette is None:
            raise ValueError("fennec: PNG palette image without PLTE")
        out[:] = info.palette[px[..., 0]]
    elif ct == 4:  # gray + alpha
        out[..., 0] = out[..., 1] = out[..., 2] = px[..., 0]
        out[..., 3] = px[..., 1]
    elif ct == 6:  # rgba
        out[:] = px
    else:
        raise ValueError(f"fennec: bad PNG color type {ct}")
    return out
