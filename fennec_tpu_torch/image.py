"""Pixel substrate: NRGBA array conversion, geometry, and format analysis.

A jax-free copy of fennec_tpu/image.py: the analogue of the reference's
pixel layer (convert.go).  Instead of pixel structs, an image is a numpy
array of shape (H, W, 4), dtype uint8, in non-premultiplied RGBA order.
Device compute (ops/*) lifts these to float32 torch tensors; this module
is the host-side boundary.

Reference semantics reproduced here:
  - to_nrgba / to_nrgba_ref        convert.go:12-30
  - is_grayscale                   convert.go:77-84
  - to_gray                        convert.go:87-100
  - analyze_format                 convert.go:105-146
  - rotate/flip primitives         convert.go:186-256
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from .types import EmptyImageError, Format, NilImageError

ImageArray = np.ndarray  # (H, W, 4) uint8


def _as_uint8(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.uint8:
        return arr
    if np.issubdtype(arr.dtype, np.floating):
        # Floats are interpreted as [0, 1] if max <= 1, else [0, 255].
        a = np.asarray(arr, dtype=np.float64)
        if a.size and a.max() <= 1.0:
            a = a * 255.0
        return np.clip(np.round(a), 0, 255).astype(np.uint8)
    return np.clip(arr, 0, 255).astype(np.uint8)


def to_nrgba(img: Union[np.ndarray, "np.generic"]) -> ImageArray:
    """Convert any array image to (H, W, 4) uint8 NRGBA, always copying.

    Accepts (H, W), (H, W, 1) grayscale, (H, W, 3) RGB, or (H, W, 4) RGBA
    in uint8 or float.  Mirrors toNRGBA (reference convert.go:12-20): use
    when the caller will mutate the result.
    """
    if img is None:
        raise NilImageError()
    # Materialize once: device arrays transfer a single time and the
    # aliasing check below reuses the same host buffer (a second
    # np.asarray would re-transfer the whole image just to compare
    # against a copy that can never alias).
    src = np.asarray(img)
    out = to_nrgba_ref(src)
    # Identity alone misses buffer aliasing (memoryview/memmap inputs
    # where np.asarray returns a distinct wrapper over the same memory).
    if out.size and np.may_share_memory(out, src):
        out = out.copy()
    return out


def to_nrgba_ref(img) -> ImageArray:
    """Convert to (H, W, 4) uint8 NRGBA without copying when already
    conforming (reference convert.go:25-30).  Callers must not mutate."""
    if img is None:
        raise NilImageError()
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError(
            f"fennec: expected (H, W[, C]) image with C in (1, 3, 4); "
            f"got shape {arr.shape}")
    arr = _as_uint8(arr)
    h, w, c = arr.shape
    if c == 4:
        if arr is img and arr.flags.c_contiguous:
            return arr
        return np.ascontiguousarray(arr)
    out = np.empty((h, w, 4), dtype=np.uint8)
    if c == 1:
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = arr[:, :, 0]
    else:
        out[:, :, :3] = arr
    out[:, :, 3] = 255
    return out


def validate_image(img: ImageArray) -> ImageArray:
    """Raise NilImageError / EmptyImageError for invalid inputs
    (reference fennec.go:108-114)."""
    if img is None:
        raise NilImageError()
    arr = to_nrgba_ref(img)
    h, w = arr.shape[:2]
    if h <= 0 or w <= 0:
        raise EmptyImageError()
    return arr


def is_grayscale(img: ImageArray) -> bool:
    """True if all pixels have R == G == B (reference convert.go:77-84)."""
    a = to_nrgba_ref(img)
    return bool(np.all(a[:, :, 0] == a[:, :, 1]) and
                np.all(a[:, :, 1] == a[:, :, 2]))


def to_gray(img: ImageArray) -> np.ndarray:
    """Extract the R channel as (H, W) gray (reference convert.go:87-100:
    assumes is_grayscale already holds, so R == G == B)."""
    return to_nrgba_ref(img)[:, :, 0].copy()


def sampled_color_census(a: ImageArray, max_samples: int
                         ) -> Tuple[bool, int]:
    """(has_alpha, distinct sampled colors) on a uniform pixel stride —
    the shared census behind analyze_format and the analyzer
    (reference convert.go:105-146 / analyze.go:43-79).  Packing is
    explicit-shift, endian-stable."""
    total = a.shape[0] * a.shape[1]
    step = max(1, total // max_samples) if total > max_samples else 1
    flat = a.reshape(-1, 4)[::step]
    has_alpha = bool(np.any(flat[:, 3] < 255))
    as_u32 = (flat[:, 0].astype(np.uint32) << 24 |
              flat[:, 1].astype(np.uint32) << 16 |
              flat[:, 2].astype(np.uint32) << 8 |
              flat[:, 3].astype(np.uint32))
    return has_alpha, int(np.unique(as_u32).size)


def analyze_format(img: ImageArray) -> Format:
    """Pick the best output format by sampled census
    (reference convert.go:105-146).

    Transparency → PNG; < 256 sampled colors → PNG; else JPEG.  Sampling:
    at most ~10k pixels on a uniform stride (the reference additionally
    caps its census loop at 512 colors; unique() over the bounded sample
    is equivalent for the <256 decision).
    """
    a = to_nrgba_ref(img)
    has_alpha, ncolors = sampled_color_census(a, 10000)
    if has_alpha:
        return Format.PNG
    if ncolors < 256:
        return Format.PNG
    return Format.JPEG


# ── Geometry (orientation primitives) ────────────────────────────────────────
# These are host-side numpy; the same transforms exist on device as jnp.rot90
# / jnp.flip inside jitted pipelines.  reference convert.go:186-256.


def rotate90_cw(img: ImageArray) -> ImageArray:
    return np.ascontiguousarray(np.rot90(to_nrgba_ref(img), k=-1))


def rotate180(img: ImageArray) -> ImageArray:
    return np.ascontiguousarray(np.rot90(to_nrgba_ref(img), k=2))


def rotate270_cw(img: ImageArray) -> ImageArray:
    return np.ascontiguousarray(np.rot90(to_nrgba_ref(img), k=1))


def flip_horizontal(img: ImageArray) -> ImageArray:
    return np.ascontiguousarray(to_nrgba_ref(img)[:, ::-1])


def flip_vertical(img: ImageArray) -> ImageArray:
    return np.ascontiguousarray(to_nrgba_ref(img)[::-1])
