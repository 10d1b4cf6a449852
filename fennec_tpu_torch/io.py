"""File I/O with EXIF orientation (reference io.go); counterpart of
fennec_tpu/io.py: open (with or without orientation), save and encode
with fennec's optimization, and the plain fixed-quality encode.  Every
function takes `device` for its device work."""

from __future__ import annotations

import os
from typing import BinaryIO, Optional, Tuple

import numpy as np

from . import device as _device
from .codecs import decode_image
from .codecs import png as png_codec
from .codecs.jpeg import encode_jpeg
from .exif import Orientation, apply_orientation, read_orientation
from .image import to_nrgba, to_nrgba_ref
from .types import Format, Options, UnsupportedFormatError


def open_image(filename: str,
               device: _device.DeviceLike = None) -> np.ndarray:
    """Load an image file into (H, W, 4) uint8 NRGBA; EXIF orientation is
    read but NOT applied (reference io.go:17-29).  JPEG transforms run on
    `device`."""
    with open(filename, "rb") as f:
        data = f.read()
    return decode_image(data, device)


def open_and_orient(filename: str,
                    device: _device.DeviceLike = None) -> np.ndarray:
    """Load an image and correct its EXIF orientation (reference
    io.go:34-61).  JPEG transforms run on `device`."""
    with open(filename, "rb") as f:
        data = f.read()
    orient = read_orientation(data)
    img = decode_image(data, device)
    if orient <= Orientation.NORMAL:
        return img
    return apply_orientation(to_nrgba(img), orient)


def open_with_orientation(filename: str, device: _device.DeviceLike = None
                          ) -> Tuple[np.ndarray, Orientation, int]:
    """(image, orientation, file size), the pixels as stored (reference
    io.go:65-88; api.compress_file reads a file so, but decodes a JPEG
    that it orients upright).  JPEG transforms run on `device`."""
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


def save(img: np.ndarray, filename: str, opts: Optional[Options] = None,
         device: _device.DeviceLike = None) -> None:
    """Save with the format from the extension, .jpg/.jpeg or .png
    (reference io.go:91-110)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext in (".jpg", ".jpeg"):
        fmt = Format.JPEG
    elif ext == ".png":
        fmt = Format.PNG
    else:
        raise UnsupportedFormatError(
            f"fennec: unsupported extension {ext!r} (use .jpg or .png)")
    with open(filename, "wb") as f:
        encode(f, img, fmt, opts, device)


def encode(w: BinaryIO, img: np.ndarray, fmt: Format,
           opts: Optional[Options] = None,
           device: _device.DeviceLike = None) -> None:
    """Write img to w in the given format with fennec's optimization
    (reference io.go:113-129): the SSIM-guided quality search for JPEG,
    the PNG optimizer for PNG."""
    from .engine.compress import compress_jpeg_optimal, compress_png

    opts = opts if opts is not None else Options()
    src = to_nrgba_ref(np.asarray(img))
    if fmt == Format.JPEG:
        target = opts.quality.target_ssim()
        if opts.target_ssim > 0:
            target = opts.target_ssim
        _, _, data = compress_jpeg_optimal(src, target, opts, device)
        w.write(data)
    elif fmt == Format.PNG:
        w.write(compress_png(src, opts))
    else:
        raise UnsupportedFormatError(
            "fennec: unsupported format for encode (use JPEG or PNG)")
