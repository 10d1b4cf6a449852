"""Shared compression pipeline (reference fennec.go:107-205).

Counterpart of fennec_tpu/engine/pipeline.py: validate → NRGBA → EXIF
orient → smart resize → standard mode (SSIM-guided JPEG search or
optimized PNG).  Target-size mode is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import device as _device
from ..exif import Orientation, apply_orientation
from ..image import analyze_format, to_nrgba, validate_image
from ..ops.resize import smart_resize
from ..types import (
    Context,
    Format,
    Options,
    ProgressStage,
    Result,
    UnsupportedFormatError,
)
from .compress import compress_jpeg_optimal, compress_png


def compress_image_internal(ctx: Optional[Context], img: np.ndarray,
                            orient: Orientation, opts: Options,
                            device: _device.DeviceLike = None) -> Result:
    """The shared pipeline behind every compress entry point
    (reference fennec.go:107-141)."""
    arr = validate_image(img)
    h, w = arr.shape[:2]
    result = Result(original_dimensions=(w, h))
    src = to_nrgba(arr)

    if opts.auto_orient and int(orient) > int(Orientation.NORMAL):
        src = apply_orientation(src, orient)
        result.original_dimensions = (src.shape[1], src.shape[0])

    opts.report_progress(ctx, ProgressStage.RESIZING, 0.1)

    if opts.max_width > 0 or opts.max_height > 0:
        src = smart_resize(src, opts.max_width, opts.max_height, device)
    result.image = src
    result.final_dimensions = (src.shape[1], src.shape[0])

    opts.report_progress(ctx, ProgressStage.COMPRESSING, 0.2)

    if opts.target_size > 0:
        raise NotImplementedError(
            "fennec: target-size mode is not ported to PyTorch yet")
    return _handle_standard_mode(ctx, src, opts, result, device)


def _handle_standard_mode(ctx: Optional[Context], src: np.ndarray,
                          opts: Options, result: Result,
                          device: _device.DeviceLike) -> Result:
    # reference fennec.go:162-205
    fmt = opts.format
    if fmt == Format.AUTO:
        fmt = analyze_format(src)
    result.format = fmt

    opts.report_progress(ctx, ProgressStage.OPTIMIZING, 0.3)

    if fmt == Format.PNG:
        result.compressed_data = compress_png(src, opts)
        result.ssim = 1.0
    elif fmt == Format.JPEG:
        target = opts.quality.target_ssim()
        if 0.0 < opts.target_ssim <= 1.0:
            target = opts.target_ssim
        quality, ssim_val, data = compress_jpeg_optimal(src, target, opts,
                                                        device)
        result.jpeg_quality = quality
        result.ssim = ssim_val
        result.compressed_data = data
    else:
        raise UnsupportedFormatError()

    opts.report_progress(ctx, ProgressStage.ENCODING, 0.9)
    result.compressed_size = len(result.compressed_data)
    result.compute_stats()
    return result
