"""fennec_tpu_torch — the PyTorch/CUDA port of fennec-tpu, for NVIDIA Hopper.

It sits beside the JAX package (fennec_tpu), which stays the reference,
and imports neither jax nor fennec_tpu.  This slice ports the
single-image main path: decode, orient, resize, the SSIM-guided JPEG
quality search (windowed SSIM in the CUDA kernel csrc/ssim_window.cu) and
the host C++ Huffman encode, plus the PNG optimizer.

Every entry point takes `device`; None means "cuda", and a missing card
raises (device.py).  Quick start::

    import fennec_tpu_torch as fennec

    result = fennec.compress_file(None, "in.jpg", "out.jpg",
                                  fennec.Options(quality=fennec.BALANCED),
                                  device="cuda")
"""

from .api import (  # noqa: F401
    compress,
    compress_bytes,
    compress_file,
    compress_image,
)
from .exif import Orientation, apply_orientation, read_orientation  # noqa
from .io import encode_to_bytes, open_with_orientation  # noqa: F401
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
