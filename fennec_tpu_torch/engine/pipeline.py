"""Shared compression pipeline (reference fennec.go:107-205).

Counterpart of fennec_tpu/engine/pipeline.py: validate → NRGBA → EXIF
orient → smart resize → target-size mode (engine/targetsize.py) or
standard mode (SSIM-guided JPEG search or optimized PNG).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import device as _device
from ..exif import Orientation
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
from ..utils.profiling import stage
from .compress import compress_jpeg_optimal, compress_png


def compress_image_internal(ctx: Optional[Context], img: np.ndarray,
                            orient: Orientation, opts: Options,
                            device: _device.DeviceLike = None) -> Result:
    """The shared pipeline behind every compress entry point
    (reference fennec.go:107-141).  `img` is upright: a file with an EXIF
    orientation comes out of its decode turned (api.compress_file, when
    opts.auto_orient), so the orient stage only records the dimensions."""
    with stage("validate"):
        arr = validate_image(img)
    h, w = arr.shape[:2]
    result = Result(original_dimensions=(w, h))
    with stage("nrgba"):
        src = to_nrgba(arr)

    if opts.auto_orient and int(orient) > int(Orientation.NORMAL):
        with stage("orient"):
            result.original_dimensions = (src.shape[1], src.shape[0])

    opts.report_progress(ctx, ProgressStage.RESIZING, 0.1)

    if opts.max_width > 0 or opts.max_height > 0:
        with stage("resize"):
            src = smart_resize(src, opts.max_width, opts.max_height,
                               device)
    result.image = src
    result.final_dimensions = (src.shape[1], src.shape[0])

    opts.report_progress(ctx, ProgressStage.COMPRESSING, 0.2)

    if opts.target_size > 0:
        return _handle_target_size_mode(ctx, src, opts, result, device)
    return _handle_standard_mode(ctx, src, opts, result, device)


def _handle_target_size_mode(ctx: Optional[Context], src: np.ndarray,
                             opts: Options, result: Result,
                             device: _device.DeviceLike) -> Result:
    # reference fennec.go:143-160
    from .targetsize import hit_target_size

    with stage("target-size search"):
        sr = hit_target_size(ctx, src, opts.target_size, opts, device)
    apply_size_result(result, sr)
    return result


def apply_size_result(result: Result, sr) -> None:
    """Copy a target-size SizeResult into the caller's Result."""
    result.compressed_data = sr.data
    result.format = sr.format
    result.jpeg_quality = sr.quality
    result.ssim = sr.ssim
    result.final_dimensions = (sr.final_w, sr.final_h)
    if sr.img is not None:
        result.image = sr.img
    result.compressed_size = len(sr.data)
    result.compute_stats()


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
        with stage("png encode"):
            result.compressed_data = compress_png(src, opts)
        result.ssim = 1.0
    elif fmt == Format.JPEG:
        target = opts.quality.target_ssim()
        if 0.0 < opts.target_ssim <= 1.0:
            target = opts.target_ssim
        with stage("jpeg quality search"):
            quality, ssim_val, data = compress_jpeg_optimal(src, target,
                                                            opts, device)
        result.jpeg_quality = quality
        result.ssim = ssim_val
        result.compressed_data = data
    else:
        raise UnsupportedFormatError()

    opts.report_progress(ctx, ProgressStage.ENCODING, 0.9)
    result.compressed_size = len(result.compressed_data)
    result.compute_stats()
    return result
