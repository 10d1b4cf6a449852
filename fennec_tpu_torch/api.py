"""Public compression entry points (reference fennec.go:30-104);
counterpart of fennec_tpu/api.py.  Each takes an optional `device`
(None → "cuda"; see device.py)."""

from __future__ import annotations

from typing import BinaryIO, Optional, Union

import numpy as np

from . import device as _device
from .codecs import decode_image
from .engine.pipeline import compress_image_internal
from .exif import Orientation
from .io import encode_to_bytes, open_with_orientation
from .types import Context, Options, ProgressStage, Result


def compress_file(ctx: Optional[Context], src: str, dst: str,
                  opts: Optional[Options] = None,
                  device: _device.DeviceLike = None) -> Result:
    """Compress an image file and write the result to dst
    (reference fennec.go:30-76).  Reads EXIF orientation and auto-rotates
    when opts.auto_orient."""
    opts = opts if opts is not None else Options()
    opts.validate()
    opts.report_progress(ctx, ProgressStage.ANALYZING, 0.0)

    img, orient, file_size = open_with_orientation(src, device)
    result = compress_image_internal(ctx, img, orient, opts, device)
    result.original_size = file_size
    result.compute_stats()

    opts.report_progress(ctx, ProgressStage.WRITING, 0.9)

    data = result.compressed_data
    if not data:
        data = encode_to_bytes(result.image, result.format,
                               result.jpeg_quality, device)
        result.compressed_data = data
        result.compressed_size = len(data)
        result.compute_stats()

    with open(dst, "wb") as f:
        f.write(data)

    opts.report_progress(ctx, ProgressStage.WRITING, 1.0)
    return result


def compress_image(ctx: Optional[Context], img: np.ndarray,
                   opts: Optional[Options] = None,
                   device: _device.DeviceLike = None) -> Result:
    """Compress an already-decoded image (reference fennec.go:80-85)."""
    opts = opts if opts is not None else Options()
    opts.validate()
    return compress_image_internal(ctx, img, Orientation.NORMAL, opts,
                                   device)


def compress(ctx: Optional[Context], r: Union[BinaryIO, bytes],
             opts: Optional[Options] = None,
             device: _device.DeviceLike = None) -> Result:
    """Read an image from a reader and return the compressed version
    (reference fennec.go:89-98)."""
    opts = opts if opts is not None else Options()
    opts.validate()
    data = r if isinstance(r, (bytes, bytearray)) else r.read()
    img = decode_image(bytes(data), device)
    return compress_image_internal(ctx, img, Orientation.NORMAL, opts,
                                   device)


def compress_bytes(ctx: Optional[Context], data: bytes,
                   opts: Optional[Options] = None,
                   device: _device.DeviceLike = None) -> Result:
    """bytes → compressed bytes; the common server-side API
    (reference fennec.go:102-104)."""
    return compress(ctx, data, opts, device)
