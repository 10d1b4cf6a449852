"""Target-file-size engine: four search strategies and candidate ranking.

Counterpart of fennec_tpu/engine/targetsize.py (reference semantics,
targetsize.go:26-348).  The forward DCT of an image is computed once on
the device; every quality probe re-quantizes it there and counts the
exact scan bits (engine/size_search.py), and the host encodes only the
candidates whose real bytes must be checked (0xFF stuffing is not in the
count).  Every SSIM is SSIMFast through K1's wrapper (ops/ssim.py).

Strategies, in order (all candidates ranked by better_fit):
  S1 jpeg_quality_search   — binary search on quality, BPP-seeded bounds
  S2 quantize_strategy     — median-cut palette PNG at 256/128/64/32/16
  S3 jpeg_quality_scale_search — joint scale (binary + fixed grid) × quality
  S4 scale_search          — pure scale bisection (only if S1–S3 failed)
  fallback                 — Q=1 JPEG or best-effort PNG

As in the JAX package the search encodes 4:2:0 whatever Options.subsample
says: the reference's stdlib encoder is fixed 4:2:0 (io.go:157-169).
Every function takes the torch device the work runs on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..codecs import png as png_codec
from ..codecs.jpeg import assemble_jpeg, encode_jpeg_from_coefs, forward_dct
from ..image import is_opaque, to_nrgba_ref
from ..ops.dct import all_quality_tables
from ..ops.quantize import apply_palette, median_cut_levels, palette_to_nrgba
from ..ops.resize import (
    box_downsample,
    box_downsample_device,
    box_weights_device,
    lanczos_resize,
)
from ..ops.ssim import compute_ssim_nrgba
from ..types import Context, Format, Options
from .compress import compress_png
from .size_search import size_bisect

MIN_JPEG_QUALITY = 20  # reference targetsize.go:14
PALETTE_LEVELS = (256, 128, 64, 32, 16)  # reference targetsize.go:180-206


@dataclasses.dataclass
class SizeResult:
    data: bytes
    format: Format
    quality: int = 0
    ssim: float = 0.0
    final_w: int = 0
    final_h: int = 0
    img: Optional[np.ndarray] = None
    # Deferred pixel fetch: the batched engine keeps candidate images on
    # the device and copies only the ranking winner's to the host.
    img_fetch: "Optional[object]" = None

    def materialize(self) -> "SizeResult":
        if self.img is None and self.img_fetch is not None:
            self.img = self.img_fetch()
        self.img_fetch = None
        return self


def _ctx_err(ctx: Optional[Context]) -> bool:
    return ctx is not None and ctx.done()


@contextlib.contextmanager
def stage_clock(name: str):
    """Add the host-clock seconds of the block to engine/batched.counters
    as stage "ts_<name>": a strategy ("s1".."s4"), the host JPEG encodes
    that verify sizes ("encode") or the PNG deflates of S2 ("png")."""
    from .batched import counters

    t0 = time.perf_counter()
    try:
        yield
    finally:
        counters.add_time(f"ts_{name}", time.perf_counter() - t0)


def _bpp_bounds(target_bytes: int, pixels: int) -> Tuple[int, int]:
    """Bits-per-pixel-seeded quality bounds (reference
    targetsize.go:131-143)."""
    target_bpp = target_bytes * 8 / max(1, pixels)
    lo, hi = 1, 100
    if target_bpp < 0.5:
        hi = 40
    elif target_bpp < 1.0:
        lo, hi = 10, 70
    elif target_bpp < 2.0:
        lo, hi = 30, 90
    elif target_bpp > 4.0:
        lo = 60
    return lo, hi


PROBE_LATTICE = 16


def probe_geometry(src_w: int, src_h: int, new_w: int,
                   new_h: int) -> Tuple[int, int]:
    """Snap a scale-probe geometry to a /16 lattice (capped at the source
    dims, floored at 16).

    The JAX package added the lattice to bound its XLA programs, but probe
    answers depend on it, so the port keeps it: probes are
    approximations (a box downsample), and the winner is re-searched at
    its exact geometry with real encodes."""
    def snap(v: int, cap: int) -> int:
        return min(cap, max(PROBE_LATTICE,
                            round(v / PROBE_LATTICE) * PROBE_LATTICE))

    return snap(new_w, src_w), snap(new_h, src_h)


@functools.lru_cache(maxsize=4096)
def _header_len(w: int, h: int) -> int:
    """JFIF container overhead of a 3-component 4:2:0 file (the
    DQT/DHT/SOF/SOS lengths are fixed)."""
    return len(assemble_jpeg(w, h, all_quality_tables()[50], b"", True))


def box_probe(src: torch.Tensor, wh: torch.Tensor, wv: torch.Tensor,
              target_bytes: int, lo: int, hi: int):
    """One scale probe of (..., H, W, 4) images: box downsample with the
    shared weights, forward DCT (4:2:0) and the size bisection against
    target_bytes minus the container header.  Returns (q, found) on the
    device, one per image."""
    img = box_downsample_device(src, wh, wv)
    h, w = int(img.shape[-3]), int(img.shape[-2])
    coefs = forward_dct(img, True)
    budget = max(0, target_bytes - _header_len(w, h))
    return size_bisect(coefs, h + (-h) % 16, w + (-w) % 16, True, budget,
                       lo, hi)


class _ScaleProber:
    """Scale probing for the joint scale × quality search: the source
    goes to the device once, each probe is box downsample → DCT →
    bisection (box_probe) and one copy back.  Probes judge fit by exact
    scan bits plus container bytes (stuffing excluded); the winning
    scale is re-searched and verified against real bytes by
    jpeg_quality_search, which keeps the under-target guarantee."""

    def __init__(self, arr: np.ndarray, dev: torch.device):
        self.h, self.w = arr.shape[:2]
        self.dev = dev
        self.src = torch.from_numpy(to_nrgba_ref(arr)).to(dev)
        self._memo: dict = {}

    def probe(self, new_w: int, new_h: int,
              target_bytes: int) -> Tuple[bool, int]:
        """(fits, quality) for encoding at ~new_w×new_h within
        target_bytes.  The geometry snaps to the probe lattice; a repeat
        is answered from the memo."""
        new_w, new_h = probe_geometry(self.w, self.h, new_w, new_h)
        key = (new_w, new_h, target_bytes)
        if key in self._memo:
            return self._memo[key]
        wh, wv = box_weights_device(self.w, self.h, new_w, new_h, self.dev)
        lo, hi = _bpp_bounds(target_bytes, new_w * new_h)
        q, found = box_probe(self.src, wh, wv, target_bytes, lo, hi)
        q, found = torch.stack([q, found.to(torch.int64)]).tolist()
        self._memo[key] = (bool(found), int(q))
        return self._memo[key]


class _JpegSizer:
    """Cached forward DCT + the size oracle for one image.

    The reference re-encodes per bisection step (targetsize.go:146-166);
    here the quality → size bisection runs on the device with the exact
    bit count, and the host encodes only to verify real bytes (stuffing
    adds a data-dependent handful on top of the bit count)."""

    def __init__(self, src: np.ndarray, dev: torch.device,
                 optimize: bool = True):
        arr = to_nrgba_ref(src)
        self.h, self.w = arr.shape[:2]
        self.optimize = optimize
        self.coefs = forward_dct(
            torch.from_numpy(arr).to(dev).to(torch.float32), True)

    def encode(self, quality: int) -> bytes:
        with stage_clock("encode"):
            return encode_jpeg_from_coefs(self.coefs, self.w, self.h,
                                          quality, True,
                                          optimize=self.optimize)

    def search(self, target_bytes: int, lo: int, hi: int
               ) -> Tuple[Optional[bytes], int]:
        """Highest quality in [lo, hi] whose encoded size fits
        target_bytes; returns (bytes, quality) or (None, 0)."""
        ph, pw = self.h + (-self.h) % 16, self.w + (-self.w) % 16
        best_q, found = size_bisect(
            self.coefs, ph, pw, True,
            max(0, target_bytes - _header_len(self.w, self.h)), lo, hi)
        q, found = torch.stack([best_q, found.to(torch.int64)]).tolist()
        if not found:
            return None, 0
        # Verify against real bytes (stuffing); step down if needed.
        data = None
        while q >= lo:
            data = self.encode(q)
            if len(data) <= target_bytes:
                break
            q -= 1
            data = None
        if data is None:
            return None, 0
        # Optimized Huffman shrinks files below the standard-table
        # oracle, so a higher quality may fit: probe up.
        while q < hi:
            nxt = self.encode(q + 1)
            if len(nxt) > target_bytes:
                break
            data, q = nxt, q + 1
        return data, q


def hit_target_size(ctx: Optional[Context], original: np.ndarray,
                    target_bytes: int, opts: Options,
                    device: _device.DeviceLike = None) -> SizeResult:
    """Try all applicable strategies, rank by better_fit (reference
    targetsize.go:26-75)."""
    dev = _device.resolve(device)
    want_png = opts.format == Format.PNG
    want_jpeg = opts.format == Format.JPEG
    can_use_jpeg = not want_png and is_opaque(original)

    candidates: List[SizeResult] = []

    if (can_use_jpeg or want_jpeg) and not _ctx_err(ctx):
        with stage_clock("s1"):
            r = jpeg_quality_search(original, target_bytes, dev)
        if r is not None and r.quality >= MIN_JPEG_QUALITY:
            candidates.append(r)

    if not want_jpeg and not _ctx_err(ctx):
        with stage_clock("s2"):
            r = quantize_strategy(original, target_bytes, dev)
        if r is not None:
            candidates.append(r)

    if (can_use_jpeg or want_jpeg) and not _ctx_err(ctx):
        with stage_clock("s3"):
            r = jpeg_quality_scale_search(ctx, original, target_bytes, dev)
        if r is not None:
            candidates.append(r)

    if not candidates and not _ctx_err(ctx):
        fmt = opts.format
        if fmt == Format.AUTO:
            fmt = Format.JPEG if can_use_jpeg else Format.PNG
        with stage_clock("s4"):
            r = scale_search(ctx, original, target_bytes, fmt, dev)
        if r is not None:
            candidates.append(r)

    if not candidates:
        return _fallback_encode(original, target_bytes,
                                can_use_jpeg or want_jpeg, opts, dev)

    best = candidates[0]
    for c in candidates[1:]:
        if better_fit(c, best, target_bytes):
            best = c
    return best


def _fallback_encode(original: np.ndarray, target: int, use_jpeg: bool,
                     opts: Options, dev: torch.device) -> SizeResult:
    # reference targetsize.go:77-90
    h, w = original.shape[:2]
    if use_jpeg:
        data = _JpegSizer(original, dev).encode(1)
        # The reference scores SSIM(original, original) here, a constant
        # ~1.0 (targetsize.go:77-90).
        return SizeResult(data=data, format=Format.JPEG, quality=1,
                          ssim=1.0, final_w=w, final_h=h, img=original)
    data = compress_png(original, opts)
    return SizeResult(data=data, format=Format.PNG, ssim=1.0,
                      final_w=w, final_h=h, img=original)


def better_fit(candidate: SizeResult, current: SizeResult,
               target: int) -> bool:
    """Under-target first, then higher SSIM, then higher quality, else
    smaller (reference targetsize.go:92-113)."""
    c_size, b_size = len(candidate.data), len(current.data)
    c_under, b_under = c_size <= target, b_size <= target
    if c_under and not b_under:
        return True
    if not c_under and b_under:
        return False
    if c_under and b_under:
        if candidate.ssim != current.ssim:
            return candidate.ssim > current.ssim
        return candidate.quality > current.quality
    return c_size < b_size


# ── Strategy 1: quality-only binary search ──────────────────────────────────


def jpeg_quality_search(src: np.ndarray, target_bytes: int,
                        dev: torch.device, skip_ssim: bool = False,
                        sizer: Optional[_JpegSizer] = None
                        ) -> Optional[SizeResult]:
    """Binary search the highest quality fitting target_bytes, with
    bits-per-pixel-seeded bounds (reference targetsize.go:125-176)."""
    from ..codecs.jpeg import decode_jpeg

    arr = to_nrgba_ref(src)
    h, w = arr.shape[:2]
    lo, hi = _bpp_bounds(target_bytes, w * h)

    if sizer is None:
        sizer = _JpegSizer(arr, dev)
    best_buf, best_q = sizer.search(target_bytes, lo, hi)
    if best_buf is None:
        return None

    best_ssim = 0.0
    if not skip_ssim:
        best_ssim = compute_ssim_nrgba(arr, decode_jpeg(best_buf, dev), dev)

    return SizeResult(data=best_buf, format=Format.JPEG, quality=best_q,
                      ssim=best_ssim, final_w=w, final_h=h, img=arr)


# ── Strategy 2: palette quantization ────────────────────────────────────────


def quantize_strategy(src: np.ndarray, target_bytes: int,
                      dev: torch.device) -> Optional[SizeResult]:
    """Median-cut indexed PNG at descending palette sizes (reference
    targetsize.go:180-206).  One greedy median-cut run gives every
    level's palette (ops/quantize.median_cut_levels)."""
    arr = to_nrgba_ref(src)
    h, w = arr.shape[:2]
    palettes = median_cut_levels(arr, PALETTE_LEVELS)
    for max_colors in PALETTE_LEVELS:
        palette = palettes[max_colors]
        indices = apply_palette(arr, palette, dev)
        with stage_clock("png"):
            data = png_codec.encode_png_paletted(indices, palette)
        if len(data) <= target_bytes:
            quantized = palette_to_nrgba(indices, palette)
            return SizeResult(data=data, format=Format.PNG, quality=0,
                              ssim=compute_ssim_nrgba(arr, quantized, dev),
                              final_w=w, final_h=h, img=quantized)
    return None


# ── Strategy 3: joint quality × scale search ────────────────────────────────


@dataclasses.dataclass
class _ScaleCandidate:
    scale: float
    quality: int
    size: int


FIXED_SCALES = (0.75, 0.50, 0.375, 0.25)  # reference targetsize.go:264


def jpeg_quality_scale_search(ctx: Optional[Context], src: np.ndarray,
                              target_bytes: int, dev: torch.device
                              ) -> Optional[SizeResult]:
    # reference targetsize.go:210-232
    arr = to_nrgba_ref(src)
    orig_h, orig_w = arr.shape[:2]
    prober = _ScaleProber(arr, dev)
    best = _find_best_scale_binary(ctx, prober, orig_w, orig_h,
                                   target_bytes)
    best = _find_best_scale_fixed(ctx, prober, orig_w, orig_h,
                                  target_bytes, best)
    if best is None:
        return None
    final_w = int(orig_w * best.scale)
    final_h = int(orig_h * best.scale)
    final_scaled = lanczos_resize(arr, final_w, final_h, dev)
    r = jpeg_quality_search(final_scaled, target_bytes, dev, skip_ssim=True)
    if r is None or r.quality < MIN_JPEG_QUALITY:
        return None
    r.ssim = compute_ssim_nrgba(arr, final_scaled, dev)
    r.final_w, r.final_h = final_w, final_h
    r.img = final_scaled
    return r


def _find_best_scale_binary(ctx, prober: _ScaleProber, orig_w, orig_h,
                            target_bytes):
    # reference targetsize.go:240-262
    best = None
    lo_scale, hi_scale = 0.05, 1.0
    for _ in range(10):
        if _ctx_err(ctx):
            break
        mid = (lo_scale + hi_scale) / 2
        new_w, new_h = int(orig_w * mid), int(orig_h * mid)
        if new_w < 8 or new_h < 8:
            lo_scale = mid
            continue
        fits, q = prober.probe(new_w, new_h, target_bytes)
        if fits and q >= MIN_JPEG_QUALITY:
            best = _ScaleCandidate(mid, q, 0)
            lo_scale = mid
        else:
            hi_scale = mid
    return best


def _find_best_scale_fixed(ctx, prober: _ScaleProber, orig_w, orig_h,
                           target_bytes, best):
    # reference targetsize.go:264-281
    for scale in FIXED_SCALES:
        if _ctx_err(ctx):
            break
        new_w, new_h = int(orig_w * scale), int(orig_h * scale)
        if new_w < 8 or new_h < 8:
            continue
        fits, q = prober.probe(new_w, new_h, target_bytes)
        if fits and q >= MIN_JPEG_QUALITY:
            if best is None or scale > best.scale:
                best = _ScaleCandidate(scale, q, 0)
    return best


# ── Strategy 4: pure scale search ───────────────────────────────────────────


def scale_search(ctx: Optional[Context], src: np.ndarray, target_bytes: int,
                 fmt: Format, dev: torch.device) -> Optional[SizeResult]:
    # reference targetsize.go:285-313
    arr = to_nrgba_ref(src)
    orig_h, orig_w = arr.shape[:2]
    lo, hi, best_scale, best_q = 0.05, 1.0, 0.0, 0
    prober = _ScaleProber(arr, dev) if fmt == Format.JPEG else None

    for _ in range(12):
        if _ctx_err(ctx):
            break
        mid = (lo + hi) / 2
        new_w, new_h = int(orig_w * mid), int(orig_h * mid)
        if new_w < 1 or new_h < 1:
            lo = mid
            continue
        if prober is not None and new_w >= 8 and new_h >= 8:
            ok, q = prober.probe(new_w, new_h, target_bytes)
            fits = ok and q >= MIN_JPEG_QUALITY
        else:
            fits, q = _test_scale_fits(
                box_downsample(arr, new_w, new_h, dev), target_bytes, fmt,
                dev)
        if fits:
            best_scale, best_q, lo = mid, q, mid
        else:
            hi = mid

    if best_scale == 0:
        return None
    final_w = int(orig_w * best_scale)
    final_h = int(orig_h * best_scale)
    return _execute_final_scale_encode(arr, fmt, best_q, final_w, final_h,
                                       target_bytes, dev)


def _test_scale_fits(scaled: np.ndarray, target_bytes: int, fmt: Format,
                     dev: torch.device) -> Tuple[bool, int]:
    # reference targetsize.go:315-328
    if fmt == Format.JPEG:
        r = jpeg_quality_search(scaled, target_bytes, dev, skip_ssim=True)
        if (r is not None and len(r.data) <= target_bytes
                and r.quality >= MIN_JPEG_QUALITY):
            return True, r.quality
        return False, 0
    data = png_codec.encode_png_rgba(scaled)
    return len(data) <= target_bytes, 0


def _execute_final_scale_encode(src: np.ndarray, fmt: Format, best_q: int,
                                final_w: int, final_h: int,
                                target_bytes: int, dev: torch.device
                                ) -> Optional[SizeResult]:
    # reference targetsize.go:330-348
    scaled = lanczos_resize(src, final_w, final_h, dev)
    if fmt == Format.JPEG:
        # One sizer serves the re-search and the fallback encode.
        sizer = _JpegSizer(to_nrgba_ref(scaled), dev)
        r = jpeg_quality_search(scaled, target_bytes, dev, skip_ssim=True,
                                sizer=sizer)
        if r is not None:
            return SizeResult(data=r.data, format=Format.JPEG,
                              quality=r.quality,
                              ssim=compute_ssim_nrgba(src, scaled, dev),
                              final_w=final_w, final_h=final_h, img=scaled)
        data = sizer.encode(best_q)
    else:
        data = png_codec.encode_png_rgba(scaled)
    return SizeResult(data=data, format=fmt, quality=best_q,
                      ssim=compute_ssim_nrgba(src, scaled, dev),
                      final_w=final_w, final_h=final_h, img=scaled)
