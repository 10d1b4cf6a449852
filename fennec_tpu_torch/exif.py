"""Minimal EXIF orientation reader and applier (jax-free copy of
fennec_tpu/exif.py).

Host-side byte parsing (orientation metadata never touches the device).
Parses only the JPEG APP1/TIFF orientation tag 0x0112, both endiannesses,
SHORT type — the same minimal surface as the reference (exif.go:47-174).
Orientation application composes rotate/flip primitives
(reference exif.go:178-203).
"""

from __future__ import annotations

import enum
import io
import struct
from typing import BinaryIO, Union

import numpy as np

from . import image as fimage


class Orientation(enum.IntEnum):
    """EXIF orientation tag values (reference exif.go:12-21)."""

    NORMAL = 1
    FLIP_H = 2
    ROTATE_180 = 3
    FLIP_V = 4
    TRANSPOSE = 5  # rotate 270 CW + flip H
    ROTATE_90_CW = 6
    TRANSVERSE = 7  # rotate 90 CW + flip H
    ROTATE_270_CW = 8

    def __str__(self) -> str:
        return {
            Orientation.NORMAL: "Normal",
            Orientation.FLIP_H: "FlipHorizontal",
            Orientation.ROTATE_180: "Rotate180",
            Orientation.FLIP_V: "FlipVertical",
            Orientation.TRANSPOSE: "Transpose",
            Orientation.ROTATE_90_CW: "Rotate90CW",
            Orientation.TRANSVERSE: "Transverse",
            Orientation.ROTATE_270_CW: "Rotate270CW",
        }.get(self, "Unknown")


def read_orientation(r: Union[bytes, BinaryIO]) -> Orientation:
    """Read the EXIF orientation tag from a JPEG stream or bytes.

    Returns Orientation.NORMAL if absent or not a JPEG
    (reference exif.go:51-103).
    """
    if isinstance(r, (bytes, bytearray, memoryview)):
        r = io.BytesIO(bytes(r))
    soi = r.read(2)
    if len(soi) != 2 or soi[0] != 0xFF or soi[1] != 0xD8:
        return Orientation.NORMAL

    while True:
        marker = r.read(2)
        if len(marker) != 2 or marker[0] != 0xFF:
            return Orientation.NORMAL
        m1 = marker[1]
        # Skip fill bytes.
        while m1 == 0xFF:
            b = r.read(1)
            if len(b) != 1:
                return Orientation.NORMAL
            m1 = b[0]
        len_buf = r.read(2)
        if len(len_buf) != 2:
            return Orientation.NORMAL
        seg_len = struct.unpack(">H", len_buf)[0] - 2
        if seg_len < 0:
            return Orientation.NORMAL
        if m1 == 0xE1:  # APP1
            o = _parse_app1(r, seg_len)
            if o is not None:
                return o
            continue  # non-Exif APP1 (e.g. XMP) — keep scanning
        if m1 == 0xDA:  # SOS — no more metadata
            return Orientation.NORMAL
        try:
            r.seek(seg_len, io.SEEK_CUR)
        except OSError:
            return Orientation.NORMAL


def _parse_app1(r: BinaryIO, seg_len: int):
    """Parse one APP1 segment.  Returns an Orientation when the segment
    is an Exif block, or None for other APP1 payloads (XMP etc.) so the
    caller keeps scanning — some editors write XMP before Exif
    (reference exif.go:106-121 stops at the first APP1)."""
    if seg_len < 14:
        r.read(max(seg_len, 0))
        return None
    data = r.read(seg_len)
    if len(data) != seg_len:
        return Orientation.NORMAL  # truncated file: stop scanning
    if len(data) < 6 or data[:4] != b"Exif" or data[4] != 0 or data[5] != 0:
        return None
    return _parse_tiff_orientation(data[6:])


def _parse_tiff_orientation(tiff: bytes) -> Orientation:
    # reference exif.go:123-148
    if len(tiff) < 8:
        return Orientation.NORMAL
    if tiff[:2] == b"II":
        endian = "<"
    elif tiff[:2] == b"MM":
        endian = ">"
    else:
        return Orientation.NORMAL
    if struct.unpack(endian + "H", tiff[2:4])[0] != 42:
        return Orientation.NORMAL
    ifd_offset = struct.unpack(endian + "I", tiff[4:8])[0]
    if ifd_offset < 8 or ifd_offset + 2 > len(tiff):
        return Orientation.NORMAL
    return _scan_ifd(tiff, ifd_offset, endian)


def _scan_ifd(tiff: bytes, ifd_offset: int, endian: str) -> Orientation:
    # reference exif.go:150-174
    entry_count = struct.unpack(endian + "H",
                                tiff[ifd_offset:ifd_offset + 2])[0]
    ifd_offset += 2
    for i in range(entry_count):
        off = ifd_offset + i * 12
        if off + 12 > len(tiff):
            break
        tag = struct.unpack(endian + "H", tiff[off:off + 2])[0]
        if tag == 0x0112:  # Orientation
            dtype = struct.unpack(endian + "H", tiff[off + 2:off + 4])[0]
            if dtype != 3:  # SHORT
                return Orientation.NORMAL
            val = struct.unpack(endian + "H", tiff[off + 8:off + 10])[0]
            if 1 <= val <= 8:
                return Orientation(val)
            return Orientation.NORMAL
    return Orientation.NORMAL


def apply_orientation(img: np.ndarray, orient: Orientation) -> np.ndarray:
    """Apply EXIF orientation, yielding an upright image
    (reference exif.go:178-203)."""
    o = Orientation(orient) if orient else Orientation.NORMAL
    if o == Orientation.NORMAL:
        return img
    if o == Orientation.FLIP_H:
        return fimage.flip_horizontal(img)
    if o == Orientation.ROTATE_180:
        return fimage.rotate180(img)
    if o == Orientation.FLIP_V:
        return fimage.flip_vertical(img)
    # Deliberate deviation from the reference: exif.go:188-197 swaps the
    # corrections for orientations 5 and 7 (its "transpose" is the
    # anti-transpose).  The EXIF standard (and PIL's exif_transpose)
    # corrects 5 with a pure transpose = flipH∘rot90CW and 7 with the
    # transverse = flipH∘rot270CW; pinned against PIL in tests/test_exif.
    if o == Orientation.TRANSPOSE:
        return fimage.flip_horizontal(fimage.rotate90_cw(img))
    if o == Orientation.ROTATE_90_CW:
        return fimage.rotate90_cw(img)
    if o == Orientation.TRANSVERSE:
        return fimage.flip_horizontal(fimage.rotate270_cw(img))
    if o == Orientation.ROTATE_270_CW:
        return fimage.rotate270_cw(img)
    return img
