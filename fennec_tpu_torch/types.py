"""Core types: formats, quality presets, options, results, errors.

A jax-free copy of fennec_tpu/types.py (that package's __init__ imports
jax, so the port cannot import it).  Same semantics as the reference's
type system (types.go:17-297): images are numpy arrays of shape
(H, W, 4) uint8 (NRGBA layout), and options follow the
zero-value-is-default design (Balanced is the default Quality;
reference types.go:57-91).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, Optional

import numpy as np

VERSION = "1.0.0"


# ── Errors ───────────────────────────────────────────────────────────────────
# Sentinel error analogues (reference types.go:17-30). Python callers use
# ``isinstance`` / ``except`` where Go callers used errors.Is().


class FennecError(Exception):
    """Base class for all fennec-tpu errors."""


class NilImageError(FennecError):
    """Raised when a None image is passed to a compression function."""

    def __init__(self, msg: str = "fennec: nil image"):
        super().__init__(msg)


class EmptyImageError(FennecError):
    """Raised when the image has zero width or height."""

    def __init__(self, msg: str = "fennec: empty image"):
        super().__init__(msg)


class NoCompressedDataError(FennecError):
    """Raised when write_to is called on a Result with no compressed data."""

    def __init__(self, msg: str = "fennec: no compressed data available"):
        super().__init__(msg)


class UnsupportedFormatError(FennecError):
    """Raised when an unknown format is specified."""

    def __init__(self, msg: str = "fennec: unsupported format"):
        super().__init__(msg)


class ValidationError(FennecError, ValueError):
    """Raised when Options contain out-of-range values."""


class CanceledError(FennecError):
    """Raised when an operation is canceled via a Context."""

    def __init__(self, msg: str = "fennec: context canceled"):
        super().__init__(msg)


class DeadlineExceededError(CanceledError):
    """Raised when an operation exceeds a Context deadline."""

    def __init__(self, msg: str = "fennec: context deadline exceeded"):
        super().__init__(msg)


# ── Context (cancellation) ──────────────────────────────────────────────────
# The reference threads context.Context through all long-running operations
# (reference fennec.go:30, batch.go:58, targetsize.go:26). This package's
# analogue is a small cooperative cancellation token checked between pipeline
# stages on the host; device-resident loops are not interruptible mid-flight
# (in-flight work finishes, matching the reference batch semantics
# batch.go:89-99).


class Context:
    """Cooperative cancellation token, analogous to Go's context.Context."""

    def __init__(self, deadline: Optional[float] = None):
        self._event = threading.Event()
        self._err: Optional[Exception] = None
        self._deadline = deadline
        self._lock = threading.Lock()

    @staticmethod
    def background() -> "Context":
        return Context()

    def with_cancel(self) -> "Context":
        """Return a child context; canceling the child does not affect self."""
        child = Context(self._deadline)
        child._parent = self  # noqa: SLF001
        return child

    def with_timeout(self, seconds: float) -> "Context":
        child = self.with_cancel()
        child._deadline = time.monotonic() + seconds
        return child

    def cancel(self, err: Optional[Exception] = None) -> None:
        with self._lock:
            if self._err is None:
                self._err = err if err is not None else CanceledError()
        self._event.set()

    def err(self) -> Optional[Exception]:
        """Return the cancellation error, or None if still live."""
        parent = getattr(self, "_parent", None)
        if parent is not None:
            perr = parent.err()
            if perr is not None:
                return perr
        if self._deadline is not None and time.monotonic() > self._deadline:
            with self._lock:
                if self._err is None:
                    self._err = DeadlineExceededError()
                self._event.set()
        with self._lock:
            return self._err

    def done(self) -> bool:
        return self.err() is not None

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until canceled (the Go <-ctx.Done() analogue).  Returns
        True when canceled, False on timeout.  Deadline-only expiry is
        still observed by polling err(); this wakes on explicit cancel."""
        return self._event.wait(timeout)

    def raise_if_done(self) -> None:
        e = self.err()
        if e is not None:
            raise e


BACKGROUND = Context.background()


# ── Format ──────────────────────────────────────────────────────────────────


class Format(enum.IntEnum):
    """Output image format (reference types.go:33-53)."""

    AUTO = 0  # let fennec choose based on image analysis
    JPEG = 1  # photographs and complex images
    PNG = 2  # transparency, text, sharp edges

    def __str__(self) -> str:
        if self is Format.JPEG:
            return "JPEG"
        if self is Format.PNG:
            return "PNG"
        return "Auto"


# Convenience aliases matching the reference's exported names.
AUTO = Format.AUTO
JPEG = Format.JPEG
PNG = Format.PNG


# ── Quality presets ─────────────────────────────────────────────────────────


class Quality(enum.IntEnum):
    """Quality presets; the zero value is BALANCED (reference types.go:57-72)."""

    BALANCED = 0  # SSIM >= 0.94 — great quality, strong compression (default)
    LOSSLESS = 1  # preserves every pixel (PNG only)
    ULTRA = 2  # SSIM >= 0.99 — visually identical
    HIGH = 3  # SSIM >= 0.97 — excellent quality
    AGGRESSIVE = 4  # SSIM >= 0.90 — maximum compression
    MAXIMUM = 5  # SSIM >= 0.85 — extreme compression

    def target_ssim(self) -> float:
        # reference types.go:74-91
        return {
            Quality.LOSSLESS: 1.0,
            Quality.ULTRA: 0.99,
            Quality.HIGH: 0.97,
            Quality.BALANCED: 0.94,
            Quality.AGGRESSIVE: 0.90,
            Quality.MAXIMUM: 0.85,
        }.get(self, 0.94)

    def __str__(self) -> str:
        return {
            Quality.LOSSLESS: "Lossless",
            Quality.ULTRA: "Ultra",
            Quality.HIGH: "High",
            Quality.BALANCED: "Balanced",
            Quality.AGGRESSIVE: "Aggressive",
            Quality.MAXIMUM: "Maximum",
        }.get(self, "Unknown")


BALANCED = Quality.BALANCED
LOSSLESS = Quality.LOSSLESS
ULTRA = Quality.ULTRA
HIGH = Quality.HIGH
AGGRESSIVE = Quality.AGGRESSIVE
MAXIMUM = Quality.MAXIMUM


# ── Progress reporting ──────────────────────────────────────────────────────


class ProgressStage(str, enum.Enum):
    """What the compressor is currently doing (reference types.go:116-123)."""

    ANALYZING = "analyzing"
    RESIZING = "resizing"
    COMPRESSING = "compressing"
    OPTIMIZING = "optimizing"
    ENCODING = "encoding"
    WRITING = "writing"


# ProgressFunc receives (stage, percent in [0,1]).  Returning a non-None
# exception instance, or raising, aborts the operation (reference
# types.go:125-128 — "Return a non-nil error to abort").
ProgressFunc = Callable[[ProgressStage, float], Optional[Exception]]


# ── Options ─────────────────────────────────────────────────────────────────


@dataclasses.dataclass
class Options:
    """Compression configuration (reference types.go:131-180).

    The zero value of every field is its default: ``Options()`` is equivalent
    to ``default_options()`` except for subsample/auto_orient which default
    True (as in the reference's DefaultOptions, types.go:173-180).
    """

    quality: Quality = Quality.BALANCED
    format: Format = Format.AUTO
    max_width: int = 0  # 0 = no constraint; aspect ratio always preserved
    max_height: int = 0
    # Chroma subsampling for JPEG. Unlike the reference (whose stdlib encoder
    # is fixed at 4:2:0, types.go:146-153), the fennec-tpu encoder honors it:
    # True → 4:2:0, False → 4:4:4.
    subsample: bool = True
    target_ssim: float = 0.0  # overrides quality preset when in (0, 1]
    target_size: int = 0  # target file size in bytes; 0 = no target
    auto_orient: bool = True  # apply EXIF orientation
    on_progress: Optional[ProgressFunc] = None
    # Build per-image optimal Huffman tables at final encode (~3-8%
    # smaller files at identical pixels).  Beyond the reference, whose
    # stdlib encoder is fixed to the Annex-K tables.
    optimize_huffman: bool = True
    # Assemble the entropy bitstream on the device.  The port has no
    # device Huffman emission yet: True raises NotImplementedError; None
    # and False use the host C++ encoder.
    device_entropy: Optional[bool] = None

    def validate(self) -> None:
        # reference types.go:185-202
        if self.max_width < 0:
            raise ValidationError(
                f"fennec: MaxWidth must be >= 0, got {self.max_width}")
        if self.max_height < 0:
            raise ValidationError(
                f"fennec: MaxHeight must be >= 0, got {self.max_height}")
        if not (0.0 <= self.target_ssim <= 1.0):
            raise ValidationError(
                f"fennec: TargetSSIM must be in [0.0, 1.0], got {self.target_ssim}")
        if self.target_size < 0:
            raise ValidationError(
                f"fennec: TargetSize must be >= 0, got {self.target_size}")
        if not isinstance(self.format, Format):
            try:
                self.format = Format(self.format)
            except ValueError:
                raise ValidationError(f"fennec: invalid Format {self.format}")
        if not isinstance(self.quality, Quality):
            try:
                self.quality = Quality(self.quality)
            except ValueError:
                raise ValidationError(f"fennec: invalid Quality {self.quality}")

    def report_progress(self, ctx: Optional[Context], stage: ProgressStage,
                        percent: float) -> None:
        """Check cancellation and invoke the progress callback.

        Raises the context error or any error returned/raised by the
        callback (reference types.go:206-218).
        """
        if ctx is not None:
            ctx.raise_if_done()
        if self.on_progress is not None:
            err = self.on_progress(stage, percent)
            if isinstance(err, Exception):
                raise err


def default_options() -> Options:
    """Sensible defaults for general use (reference types.go:173-180)."""
    return Options(quality=Quality.BALANCED, format=Format.AUTO,
                   subsample=True, auto_orient=True)


# ── Result ──────────────────────────────────────────────────────────────────


@dataclasses.dataclass
class Result:
    """Compression results and statistics (reference types.go:221-255)."""

    image: Optional[np.ndarray] = None  # final processed (H, W, 4) uint8
    compressed_data: bytes = b""
    format: Format = Format.AUTO
    original_size: int = 0
    compressed_size: int = 0
    ssim: float = 0.0
    jpeg_quality: int = 0  # 0 if PNG
    ratio: float = 0.0
    savings_percent: float = 0.0
    original_dimensions: tuple = (0, 0)  # (width, height)
    final_dimensions: tuple = (0, 0)

    def write_to(self, w) -> int:
        """Write the compressed bytes to a binary file-like object.

        Raises NoCompressedDataError when empty (reference types.go:261-267).
        """
        if not self.compressed_data:
            raise NoCompressedDataError()
        return w.write(self.compressed_data)

    def load_image(self, device=None) -> np.ndarray:
        """The final image as (H, W, 4) uint8.

        On the standard pixel pipeline this is the processed pre-encode
        image (`self.image`, reference types.go:224).  On the fused
        coefficient fast path pixels never reach the host by design, so
        `image` is None — this accessor then decodes `compressed_data`
        on demand, on `device` (None → cuda; identical dimensions; pixel
        values are the encoded output, i.e. they include the final
        quantization).
        """
        if self.image is not None:
            return self.image
        if not self.compressed_data:
            raise NoCompressedDataError()
        from .codecs import decode_image
        self.image = decode_image(self.compressed_data, device)
        return self.image

    def bytes(self) -> bytes:
        return self.compressed_data

    def __str__(self) -> str:
        # reference types.go:275-289
        q = ""
        if self.format == Format.JPEG and self.jpeg_quality > 0:
            q = f" Q={self.jpeg_quality} |"
        ow, oh = self.original_dimensions
        fw, fh = self.final_dimensions
        return (
            f"Fennec Result: {self.format} |{q} {ow}x{oh} → {fw}x{fh} | "
            f"{human_bytes(self.original_size)} → "
            f"{human_bytes(self.compressed_size)} | "
            f"SSIM: {self.ssim:.4f} | Saved: {self.savings_percent:.1f}%"
        )

    def compute_stats(self) -> None:
        # reference types.go:292-297
        if self.original_size > 0 and self.compressed_size > 0:
            self.ratio = self.original_size / self.compressed_size
            self.savings_percent = (
                1 - self.compressed_size / self.original_size) * 100


def human_bytes(b: int) -> str:
    """Format a byte count for human reading (reference convert.go:161-176)."""
    if b == 0:
        return "0 B"
    units = ["B", "KB", "MB", "GB"]
    i = 0
    bf = float(b)
    while bf >= 1024 and i < len(units) - 1:
        bf /= 1024
        i += 1
    if i == 0:
        return f"{int(b)} B"
    return f"{bf:.1f} {units[i]}"
