"""SSIM-guided JPEG quality search on the device, and the PNG optimizer.

Counterpart of fennec_tpu/engine/compress.py.  The reference runs encode →
decode → SSIM on the host per bisection step (compress.go:21-87).  Here:

  1. the forward DCT runs once per image (quality-independent);
  2. a 7-step Python loop over (B,) tensors runs the bisection on the
     device: each probe re-quantizes the cached coefficient planes at its
     quality, IDCTs them blockwise, converts colour, box-downsamples and
     scores windowed SSIM against the cached downsampled original (kernel
     K1 on CUDA tensors, ops/ssim_cuda.py).  No value leaves the device
     inside the loop; one copy to the host follows it;
  3. one host C++ Huffman encode writes the winning quality.

Search semantics match compress.go: lo seeded by target (≥0.99→75,
≥0.97→50, ≥0.94→30, ≥0.90→15), target 1.0 clamped to 0.999, accept when
SSIM ≥ target, Q=100 / SSIM 1.0 when nothing qualifies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..codecs import png as png_codec
from ..codecs.jpeg import encode_jpeg_from_coefs, forward_dct
from ..image import is_grayscale, to_gray, to_nrgba_ref
from ..ops import dct as dct_ops
from ..ops.color import clamp_u8
from ..ops.resize import box_resize_weights, separable_resample, weights_on
from ..ops.ssim import (
    SSIM_C1,
    SSIM_C2,
    WINDOW_SIZE,
    ssim_fast_dims,
    ssim_map_pre,
    ssim_premaps,
)
from ..ops.ssim_cuda import ssim_window
from ..types import Options

MAX_BISECT_STEPS = 7  # ceil(log2(100)) — covers any [lo, hi] ⊆ [1, 100]


def _seed_lo(target: float) -> int:
    """Quality lower-bound fast path (reference compress.go:35-43)."""
    if target >= 0.99:
        return 75
    if target >= 0.97:
        return 50
    if target >= 0.94:
        return 30
    if target >= 0.90:
        return 15
    return 1


def _qd_plane(cp: torch.Tensor, q88: torch.Tensor) -> torch.Tensor:
    """Quantize+dequantize a coefficient plane (..., H, W) at (..., 8, 8)
    tables, rounding half away from zero."""
    h, w = cp.shape[-2], cp.shape[-1]
    x = cp.reshape(*cp.shape[:-2], h // 8, 8, w // 8, 8)
    q = q88[..., None, :, None, :]
    s = x / q
    r = torch.sign(s) * torch.floor(torch.abs(s) + 0.5)
    return (r * q).reshape(cp.shape)


def _idct_plane(qd: torch.Tensor, dmat: torch.Tensor) -> torch.Tensor:
    """Blockwise 8×8 IDCT of a coefficient plane (..., H, W): X = Dᵀ·C·D
    for every block, as two float32 products with the 8×8 DCT matrix on
    the (..., H/8, 8, W/8, 8) view.

    The JAX package multiplies the plane by kron(I, D) on both sides to
    feed the TPU's matrix unit (about 172 GFLOP per 12 MP luma plane);
    this computes the same eight nonzero terms per output for about
    0.4 GFLOP."""
    h, w = qd.shape[-2], qd.shape[-1]
    x = qd.reshape(*qd.shape[:-2], h // 8, 8, w // 8, 8)  # (…, I, u, J, v)
    t = torch.matmul(x, dmat)                              # (…, I, u, J, j)
    t = torch.matmul(t.transpose(-3, -1), dmat)            # (…, I, j, J, i)
    return t.transpose(-3, -1).reshape(qd.shape)


def _reconstruct_rgb_planes(cp_y, cp_cb, cp_cr, qtab: torch.Tensor,
                            dmat: torch.Tensor, subsample: bool,
                            h: int, w: int):
    """Decode-model reconstruction (r, g, b) planes (B, h, w) from
    coefficient planes quantized at (B, 2, 64) [luma, chroma] tables."""
    lead = qtab.shape[:-2]
    y = _idct_plane(_qd_plane(cp_y, qtab[..., 0, :].reshape(*lead, 8, 8)),
                    dmat) + 128.0
    qc = qtab[..., 1, :].reshape(*lead, 8, 8)
    cb = _idct_plane(_qd_plane(cp_cb, qc), dmat) + 128.0
    cr = _idct_plane(_qd_plane(cp_cr, qc), dmat) + 128.0
    if subsample:
        cb = dct_ops.upsample_420(cb)
        cr = dct_ops.upsample_420(cr)
    y = y[..., :h, :w]
    cbc = cb[..., :h, :w] - 128.0
    crc = cr[..., :h, :w] - 128.0
    r = clamp_u8(y + 1.402 * crc)
    g = clamp_u8(y - 0.344136286 * cbc - 0.714136286 * crc)
    b = clamp_u8(y + 1.772 * cbc)
    return r, g, b


def _box_down_plane(plane: torch.Tensor, wh: torch.Tensor,
                    wv: torch.Tensor) -> torch.Tensor:
    """Box-downsample (..., H, W) planes with weight matrices, rounded to
    integral values (SSIMFast scores uint8 pixels; reference
    ssim.go:48-70)."""
    out = separable_resample(plane, wh, wv)
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)


def _luminance(r, g, b):
    return 0.299 * r + 0.587 * g + 0.114 * b


@dataclasses.dataclass
class SearchInputs:
    """Everything the probes of one search read, resident on the device.

    cplanes: coefficient planes (B, ph, pw), (B, ch, cw), (B, ch, cw);
    lum_orig: the original's SSIMFast luminance (B, dh, dw); box_wh/box_wv:
    the SSIMFast box weights, None when no downsample is needed; tables:
    the (101, 2, 64) quality tables; dmat: the 8×8 DCT matrix."""

    cplanes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    lum_orig: torch.Tensor
    box_wh: Optional[torch.Tensor]
    box_wv: Optional[torch.Tensor]
    tables: torch.Tensor
    dmat: torch.Tensor
    subsample: bool
    h: int
    w: int


def prepare_search(img: torch.Tensor, subsample: bool):
    """(H, W, 4) float32 image on the device → (SearchInputs with B = 1,
    its forward-DCT coefficient blocks)."""
    dev = img.device
    h, w = int(img.shape[0]), int(img.shape[1])
    coefs = forward_dct(img, subsample)
    ds_w, ds_h = ssim_fast_dims(w, h)
    box_wh = box_wv = None
    planes = img[..., :3].permute(2, 0, 1)  # (3, H, W) r, g, b
    if (ds_w, ds_h) != (w, h):
        box_wh, box_wv = weights_on(box_resize_weights(w, h, ds_w, ds_h),
                                    dev)
        planes = _box_down_plane(planes, box_wh, box_wv)
    lum_orig = _luminance(planes[0], planes[1], planes[2])[None]

    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ch, cw = (ph // 2, pw // 2) if subsample else (ph, pw)
    cplanes = (dct_ops.from_blocks(coefs[0], ph, pw)[None],
               dct_ops.from_blocks(coefs[1], ch, cw)[None],
               dct_ops.from_blocks(coefs[2], ch, cw)[None])
    tables = torch.from_numpy(
        dct_ops.all_quality_tables().astype(np.float32)).to(dev)
    dmat = torch.from_numpy(dct_ops.dct_matrix().astype(np.float32)).to(dev)
    inp = SearchInputs(cplanes, lum_orig, box_wh, box_wv, tables, dmat,
                       subsample, h, w)
    return inp, coefs


def probe_luminance(inp: SearchInputs, quality: torch.Tensor) -> torch.Tensor:
    """SSIMFast luminance (B, dh, dw) of the decode-model reconstruction
    at (B,) int64 qualities."""
    qtabs = inp.tables[quality]  # (B, 2, 64)
    r, g, b = _reconstruct_rgb_planes(*inp.cplanes, qtabs, inp.dmat,
                                      inp.subsample, inp.h, inp.w)
    if inp.box_wh is not None:
        r, g, b = (_box_down_plane(p, inp.box_wh, inp.box_wv)
                   for p in (r, g, b))
    return _luminance(r, g, b)


def _pixel_ssim(lum_a: torch.Tensor, lum_b: torch.Tensor) -> torch.Tensor:
    """Global-moment SSIM of (B, H, W) pairs, for images under 8 px
    (reference ssim.go:169-204)."""
    mu_a = lum_a.mean(dim=(1, 2))
    mu_b = lum_b.mean(dim=(1, 2))
    da = lum_a - mu_a[:, None, None]
    db = lum_b - mu_b[:, None, None]
    num = (2 * mu_a * mu_b + SSIM_C1) * (2 * (da * db).mean(dim=(1, 2))
                                         + SSIM_C2)
    den = ((mu_a ** 2 + mu_b ** 2 + SSIM_C1)
           * ((da * da).mean(dim=(1, 2)) + (db * db).mean(dim=(1, 2))
              + SSIM_C2))
    return num / den


def _bisect_device_batch(inp: SearchInputs, targets: torch.Tensor,
                         lo0: torch.Tensor):
    """Quality bisection, all B images in lockstep: MAX_BISECT_STEPS
    probes over (B,) tensors with no host sync.  targets (B,) float32,
    lo0 (B,) int64.  Returns (best_q, best_ssim, found), each (B,), on
    the device."""
    ds_h, ds_w = inp.lum_orig.shape[1], inp.lum_orig.shape[2]
    use_windowed = ds_h > WINDOW_SIZE and ds_w > WINDOW_SIZE
    # Exactly-8px dims: the reference's window set is empty and
    # windowedSSIM returns 1.0 (ssim.go:162-164) — every quality accepts.
    constant_one = (min(ds_h, ds_w) == WINDOW_SIZE)
    use_kernel = inp.lum_orig.is_cuda
    if use_windowed and not use_kernel:
        pre_a = ssim_premaps(inp.lum_orig)

    def score(mid: torch.Tensor) -> torch.Tensor:
        lum = probe_luminance(inp, mid)
        if use_windowed:
            if use_kernel:
                return ssim_window(inp.lum_orig, lum)
            return ssim_map_pre(pre_a, inp.lum_orig, lum).mean(dim=(-2, -1))
        if constant_one:
            return torch.ones_like(targets)
        return _pixel_ssim(inp.lum_orig, lum)

    bsz = targets.shape[0]
    dev = targets.device
    lo = lo0
    hi = torch.full((bsz,), 100, dtype=torch.int64, device=dev)
    best_q = hi.clone()
    best_ssim = torch.ones((bsz,), dtype=torch.float32, device=dev)
    found = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    for _ in range(MAX_BISECT_STEPS):
        active = lo <= hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        s = score(mid)
        ok = active & (s >= targets)
        best_q = torch.where(ok, mid, best_q)
        best_ssim = torch.where(ok, s, best_ssim)
        found = found | ok
        hi = torch.where(active & ok, mid - 1, hi)
        lo = torch.where(active & ~ok, mid + 1, lo)
    return best_q, best_ssim, found


def compress_jpeg_optimal(src: np.ndarray, target_ssim: float, opts: Options,
                          device: _device.DeviceLike = None
                          ) -> Tuple[int, float, bytes]:
    """Find the lowest JPEG quality meeting the target SSIM (reference
    compress.go:21-87).  Returns (quality, ssim, jpeg bytes)."""
    if opts.device_entropy:
        raise NotImplementedError(
            "fennec: device Huffman emission is not ported to PyTorch yet; "
            "use device_entropy=None or False for the host C++ encoder")
    dev = _device.resolve(device)
    arr = to_nrgba_ref(np.asarray(src))
    h, w = arr.shape[:2]
    if target_ssim >= 1.0:
        target_ssim = 0.999  # JPEG can't hit SSIM 1.0 (compress.go:24-26)
    subsample = bool(opts.subsample)
    img = torch.from_numpy(arr).to(dev).to(torch.float32)
    inp, coefs = prepare_search(img, subsample)
    best_q, best_ssim, found = _bisect_device_batch(
        inp, torch.full((1,), target_ssim, dtype=torch.float32, device=dev),
        torch.full((1,), _seed_lo(target_ssim), dtype=torch.int64,
                   device=dev))
    # The one device→host copy of the search.
    q, s, f = torch.stack([best_q.to(torch.float32), best_ssim,
                           found.to(torch.float32)]).cpu()[:, 0].tolist()
    quality, ssim_val = int(q), s
    if not f:
        # Nothing met the target: the reference encodes at the initial hi
        # (Q=100) and reports bestSSIM=1.0 (compress.go:29-32,82-86).
        quality, ssim_val = 100, 1.0
    data = encode_jpeg_from_coefs(coefs, w, h, quality, subsample,
                                  optimize=opts.optimize_huffman)
    return quality, ssim_val, data


# ── PNG optimizer ───────────────────────────────────────────────────────────


def try_palettize(img: np.ndarray,
                  max_colors: int = 256) -> Optional[Tuple[np.ndarray,
                                                           np.ndarray]]:
    """Exact color census: (indices, palette) if the image has at most
    max_colors distinct RGBA colors, else None (reference
    compress.go:112-153)."""
    arr = to_nrgba_ref(np.asarray(img))
    h, w = arr.shape[:2]
    flat = arr.reshape(-1, 4)
    as_u32 = flat.view(np.uint32).reshape(-1)
    uniq, inverse = np.unique(as_u32, return_inverse=True)
    if uniq.size > max_colors:
        return None
    palette = uniq.view(np.uint8).reshape(-1, 4)
    return inverse.reshape(h, w).astype(np.uint8), palette


def compress_png(img: np.ndarray, opts: Optional[Options] = None) -> bytes:
    """PNG-specific optimizations (reference compress.go:90-108):
    palettize when ≤256 colors, grayscale when R==G==B, else full RGBA —
    always at maximum compression."""
    arr = to_nrgba_ref(np.asarray(img))
    pal = try_palettize(arr, 256)
    if pal is not None:
        indices, palette = pal
        return png_codec.encode_png_paletted(indices, palette)
    if is_grayscale(arr):
        return png_codec.encode_png_gray(to_gray(arr))
    return png_codec.encode_png_rgba(arr)
