"""Public compression entry points (reference fennec.go:30-104);
counterpart of fennec_tpu/api.py.  Each takes an optional `device`
(None → "cuda"; see device.py)."""

from __future__ import annotations

from typing import BinaryIO, Optional, Union

import numpy as np

from . import device as _device
from .codecs import decode_image
from .codecs.jpeg import decode_jpeg
from .engine.pipeline import compress_image_internal
from .exif import Orientation, read_orientation
from .io import encode_to_bytes
from .types import Context, Options, ProgressStage, Result
from .utils.profiling import stage


def compress_file(ctx: Optional[Context], src: str, dst: str,
                  opts: Optional[Options] = None,
                  device: _device.DeviceLike = None) -> Result:
    """Compress an image file and write the result to dst
    (reference fennec.go:30-76).  Reads EXIF orientation and auto-rotates
    when opts.auto_orient: a JPEG comes out of its decode upright."""
    opts = opts if opts is not None else Options()
    opts.validate()
    opts.report_progress(ctx, ProgressStage.ANALYZING, 0.0)

    with stage("open + decode"):
        img, orient, file_size = _open_upright(src, opts.auto_orient,
                                               device)
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

    with stage("write"):
        with open(dst, "wb") as f:
            f.write(data)

    opts.report_progress(ctx, ProgressStage.WRITING, 1.0)
    return result


def _open_upright(filename: str, auto_orient: bool,
                  device: _device.DeviceLike):
    """(image, orientation, file size) of a file, as
    io.open_with_orientation reads it, except that with auto_orient a
    JPEG with an orientation of 2-8 (read_orientation finds one only in a
    JPEG stream) is decoded upright: the decode's device stage stores
    each pixel at its upright place."""
    with open(filename, "rb") as f:
        data = f.read()
    orient = read_orientation(data)
    if auto_orient and orient > Orientation.NORMAL:
        return decode_jpeg(data, device, int(orient)), orient, len(data)
    return decode_image(data, device), orient, len(data)


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
    with stage("open + decode"):
        img = decode_image(bytes(data), device)
    return compress_image_internal(ctx, img, Orientation.NORMAL, opts,
                                   device)


def compress_bytes(ctx: Optional[Context], data: bytes,
                   opts: Optional[Options] = None,
                   device: _device.DeviceLike = None) -> Result:
    """bytes → compressed bytes; the common server-side API
    (reference fennec.go:102-104)."""
    return compress(ctx, data, opts, device)


def compress_images(ctx: Optional[Context], images,
                    opts: Optional[Options] = None, workers: int = 0,
                    device: _device.MeshLike = None) -> list:
    """Compress many decoded images with shared options, device-batched
    (fennec_tpu/api.py:76; the reference's CompressBatch works on files).
    Same-shape images share lockstep chunks; results keep input order.
    workers sizes the host encode pool (0 = auto).  `device` may be a
    sequence of devices, whose shards split every chunk; None on a node
    with two or more cards uses all of them (FENNEC_MESH=0: one)."""
    from .engine.batched import compress_images_batched

    opts = opts if opts is not None else Options()
    return compress_images_batched(ctx, list(images), opts,
                                   workers=workers, device=device)
