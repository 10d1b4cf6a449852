"""File I/O with EXIF orientation (reference io.go); counterpart of
fennec_tpu/io.py for the paths the port has (open, compress_file's read,
the plain encode)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import device as _device
from .codecs import decode_image
from .codecs import png as png_codec
from .codecs.jpeg import encode_jpeg
from .exif import Orientation, read_orientation
from .image import to_nrgba_ref
from .types import Format, UnsupportedFormatError


def open_image(filename: str,
               device: _device.DeviceLike = None) -> np.ndarray:
    """Load an image file into (H, W, 4) uint8 NRGBA; EXIF orientation is
    read but NOT applied (reference io.go:17-29).  JPEG transforms run on
    `device`."""
    with open(filename, "rb") as f:
        data = f.read()
    return decode_image(data, device)


def open_with_orientation(filename: str, device: _device.DeviceLike = None
                          ) -> Tuple[np.ndarray, Orientation, int]:
    """(image, orientation, file size) — used by compress_file
    (reference io.go:65-88).  JPEG transforms run on `device`."""
    with open(filename, "rb") as f:
        data = f.read()
    orient = read_orientation(data)
    # len(data) is the authoritative size of the bytes actually
    # compressed (a separate stat would race concurrent writers).
    return decode_image(data, device), orient, len(data)


def encode_to_bytes(img: np.ndarray, fmt: Format, quality: int,
                    device: _device.DeviceLike = None) -> bytes:
    """Plain (non-optimizing) encode at a fixed quality
    (reference io.go:131-149)."""
    src = to_nrgba_ref(np.asarray(img))
    if fmt == Format.JPEG:
        return encode_jpeg(src, quality if quality > 0 else 75,
                           device=device)
    if fmt == Format.PNG:
        return png_codec.encode_png_rgba(src)
    raise UnsupportedFormatError()
