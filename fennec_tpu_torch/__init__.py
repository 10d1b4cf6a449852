"""fennec_tpu_torch — the PyTorch/CUDA port of fennec-tpu, for NVIDIA Hopper.

It sits beside the JAX package (fennec_tpu), which stays the reference,
and imports neither jax nor fennec_tpu.  It has the JAX package's whole
public surface: the single-image path (decode of baseline, multi-scan and
progressive JPEG and of PNG, orient, resize, the SSIM-guided JPEG quality
search with windowed SSIM in the CUDA kernel csrc/ssim_window.cu, Huffman
coding on the device in the CUDA kernel csrc/jpeg_emit.cu or on the host
C++ encoder, the PNG optimizer), target-file-size mode
(Options(target_size=...), per image and in lockstep batches), the batch
engines behind compress_images and compress_batch, ssim, ssim_fast,
ms_ssim and pixel_ssim, Lanczos-3 resize and box downsample, the effects
(sharpen, adaptive_sharpen, gaussian_blur), file I/O (open_image,
open_and_orient, save, encode), analyze, and the CLI (python -m
fennec_tpu_torch).

Every entry point takes `device`; None means "cuda", and a missing card
raises (device.py).  Quick start::

    import fennec_tpu_torch as fennec

    result = fennec.compress_file(None, "in.jpg", "out.jpg",
                                  fennec.Options(quality=fennec.BALANCED),
                                  device="cuda")
    results = fennec.compress_batch(
        None, [fennec.BatchItem(src, dst) for src, dst in pairs],
        fennec.BatchOptions(default_opts=fennec.Options(format=fennec.JPEG)),
        device="cuda")
"""

from .analyze import ImageStats, analyze  # noqa: F401
from .api import (  # noqa: F401
    compress,
    compress_bytes,
    compress_file,
    compress_image,
    compress_images,
)
from .batch import (  # noqa: F401
    BatchItem,
    BatchOptions,
    BatchResult,
    BatchSummary,
    compress_batch,
    summarize,
)
from .exif import Orientation, apply_orientation, read_orientation  # noqa
from .io import (  # noqa: F401
    encode,
    encode_to_bytes,
    open_and_orient,
    open_image,
    open_with_orientation,
    save,
)
from .ops.effects import adaptive_sharpen, gaussian_blur, sharpen  # noqa
from .ops.resize import box_downsample, lanczos_resize, smart_resize  # noqa
from .ops.ssim import ms_ssim, pixel_ssim, ssim, ssim_fast  # noqa: F401
from .types import (  # noqa: F401
    AGGRESSIVE,
    AUTO,
    BALANCED,
    HIGH,
    JPEG,
    LOSSLESS,
    MAXIMUM,
    PNG,
    ULTRA,
    VERSION,
    CanceledError,
    Context,
    EmptyImageError,
    FennecError,
    Format,
    NilImageError,
    NoCompressedDataError,
    Options,
    ProgressStage,
    Quality,
    Result,
    UnsupportedFormatError,
    ValidationError,
    default_options,
    human_bytes,
)

__version__ = VERSION
