"""SSIM-guided JPEG quality search on the device, and the PNG optimizer.

Counterpart of fennec_tpu/engine/compress.py.  The reference runs encode →
decode → SSIM on the host per bisection step (compress.go:21-87).  Here:

  1. the forward DCT runs once per image (quality-independent);
  2. a 7-step Python loop over (B,) tensors runs the bisection on the
     device: each probe re-quantizes the cached coefficient planes at its
     quality, IDCTs them blockwise, converts colour and box-downsamples
     (on CUDA tensors all of it is kernel K2, ops/probe_recon_cuda.py;
     probe_luminance_plain is its plain version) and scores windowed
     SSIM against the cached downsampled original (kernel K1 on CUDA
     tensors, ops/ssim_cuda.py).  No value leaves the device inside the
     loop; one copy to the host follows it;
  3. the winning quality is Huffman-coded on the device (kernel K3,
     parallel/batched.emit_scans) or by the host C++ encoder, as
     Options.device_entropy says (device_entropy_on).

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
from ..ops.color import clamp_u8, ycbcr_to_rgb
from ..ops.probe_recon_cuda import probe_recon
from ..ops.resize import (
    BoxBand,
    band_box_device,
    box_rectangles_device,
    box_weights_device,
    separable_resample,
)
from ..ops.ssim import (
    WINDOW_SIZE,
    pixel_ssim_lum,
    ssim_fast_dims,
    ssim_map_pre,
    ssim_premaps,
)
from ..ops.ssim_cuda import ssim_window
from ..types import Options
from .size_search import quality_tables_on, quantize_packed

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
    the SSIMFast box weights and box_rectangles the same rectangles as
    kernel K2 reads them (ops/resize.box_rectangles), None when no
    downsample is needed; tables: the (101, 2, 64) quality tables; dmat:
    the 8×8 DCT matrix; band: the rows of a row-split image these inputs
    hold (band_inputs), None for whole images."""

    cplanes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    lum_orig: torch.Tensor
    box_wh: Optional[torch.Tensor]
    box_wv: Optional[torch.Tensor]
    tables: torch.Tensor
    dmat: torch.Tensor
    subsample: bool
    h: int
    w: int
    box_rectangles: Optional[torch.Tensor] = None
    # One band of a row-split image (band_inputs): h is the rows it reads,
    # lum_orig and the probes its owned output rows.
    band: Optional[BoxBand] = None
    # Kernel K2's checked launch state, made at the search's first probe
    # on the card (ops/probe_recon_cuda.ProbeReconKernel.prepare); a copy
    # made with dataclasses.replace starts without it.
    k2_state: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)


def prepare_search(imgs: torch.Tensor, subsample: bool):
    """(B, H, W, 4) float32 images on the device → (SearchInputs, their
    forward-DCT coefficient blocks (y, cb, cr), each (B, N, 64))."""
    coefs = forward_dct(imgs, subsample)
    return search_inputs(imgs, coefs, subsample), coefs


def search_inputs(imgs: torch.Tensor, coefs, subsample: bool
                  ) -> SearchInputs:
    """SearchInputs of (B, H, W, 4) float32 images whose forward-DCT
    blocks `coefs` are already computed."""
    dev = imgs.device
    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    ds_w, ds_h = ssim_fast_dims(w, h)
    box_wh = box_wv = rectangles = None
    planes = imgs[..., :3].permute(0, 3, 1, 2)  # (B, 3, H, W) r, g, b
    if (ds_w, ds_h) != (w, h):
        box_wh, box_wv = box_weights_device(w, h, ds_w, ds_h, dev)
        rectangles = box_rectangles_device(w, h, ds_w, ds_h, dev)
        planes = _box_down_plane(planes, box_wh, box_wv)
    lum_orig = _luminance(planes[:, 0], planes[:, 1], planes[:, 2])

    return SearchInputs(coef_planes(coefs, h, w, subsample),
                        lum_orig.contiguous(), box_wh, box_wv,
                        quality_tables_on(dev), _dmat_on(dev), subsample, h,
                        w, rectangles)


def coef_planes(coefs, h: int, w: int, subsample: bool):
    """Forward-DCT blocks (y, cb, cr) of (B,) h × w images → their
    coefficient planes (B, ph, pw), (B, ch, cw), (B, ch, cw) on the MCU-
    padded grids."""
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ch, cw = (ph // 2, pw // 2) if subsample else (ph, pw)
    return (dct_ops.from_blocks(coefs[0], ph, pw),
            dct_ops.from_blocks(coefs[1], ch, cw),
            dct_ops.from_blocks(coefs[2], ch, cw))


def _dmat_on(dev: torch.device) -> torch.Tensor:
    """The 8×8 DCT matrix on `dev`."""
    return _device.constant_on(
        "dct_matrix", lambda: dct_ops.dct_matrix().astype(np.float32), dev)


def band_inputs(pix: torch.Tensor, band: BoxBand, planes, halo,
                subsample: bool) -> SearchInputs:
    """SearchInputs of one band of rows of an image whose rows are split
    over a spatial mesh (parallel/batched.quality_search_spatial_sharded).

    pix: (1, band.rows, W, 4) float32 pixel rows [start, end) of the
    image, its own and the halo past them; planes: coef_planes of the
    forward-DCT blocks of its own rows [start, stop) (whole MCU rows, so
    they are the whole image's blocks of those rows); halo: the
    coefficient planes' rows [stop, end), from the next bands, three
    (1, rows, width) tensors.  The original's luminance and every probe
    cover the output rows [d0, d1) the band owns: the box mean (or,
    without a downsample, the pixels) of those rows, from the same
    float32 products as search_inputs' over the band's source rows."""
    dev = pix.device
    w = int(pix.shape[2])
    ds_w, ds_h = ssim_fast_dims(w, band.src_h)
    rgb = pix[..., :3].permute(0, 3, 1, 2)
    box_wh = box_wv = rectangles = None
    if (ds_w, ds_h) != (w, band.src_h):
        box_wh, box_wv, rectangles = band_box_device(w, ds_w, band, dev)
        rgb = _box_down_plane(rgb, box_wh, box_wv)
    else:
        rgb = rgb[..., :band.stop - band.start, :]
    lum_orig = _luminance(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    cplanes = tuple(torch.cat([p, x], dim=-2) if x.shape[-2] else p
                    for p, x in zip(planes, halo))
    return SearchInputs(cplanes, lum_orig.contiguous(), box_wh, box_wv,
                        quality_tables_on(dev), _dmat_on(dev), subsample,
                        band.rows, w, rectangles, band)


def probe_luminance(inp: SearchInputs, quality: torch.Tensor) -> torch.Tensor:
    """SSIMFast luminance (B, dh, dw) of the decode-model reconstruction
    at (B,) int64 qualities: kernel K2 on CUDA planes, its plain version
    probe_luminance_plain on CPU planes."""
    return probe_recon(inp, quality)


def probe_luminance_plain(inp: SearchInputs,
                          quality: torch.Tensor) -> torch.Tensor:
    """K2's function in plain torch ops, on the planes' device: what the
    CPU runs and what K2 is held against on the card."""
    qtabs = inp.tables[quality]  # (B, 2, 64)
    r, g, b = _reconstruct_rgb_planes(*inp.cplanes, qtabs, inp.dmat,
                                      inp.subsample, inp.h, inp.w)
    if inp.box_wh is not None:
        r, g, b = (_box_down_plane(p, inp.box_wh, inp.box_wv)
                   for p in (r, g, b))
    return _luminance(r, g, b)


def _bisect_device_batch(inp: SearchInputs, targets: torch.Tensor,
                         lo0: torch.Tensor):
    """Quality bisection of one SearchInputs: bisect with its probes."""
    return bisect(inp.lum_orig, lambda q: probe_luminance(inp, q), targets,
                  lo0)


def bisect(lum_orig: torch.Tensor, probe, targets: torch.Tensor,
           lo0: torch.Tensor):
    """Quality bisection, all B images in lockstep: MAX_BISECT_STEPS
    probes over (B,) tensors with no host sync.  lum_orig (B, dh, dw) the
    original's SSIMFast luminance, probe(quality) the reconstruction's at
    (B,) int64 qualities; targets (B,) float32, lo0 (B,) int64.  Every
    probe is scored with K1 on a CUDA device.  Returns (best_q,
    best_ssim, found), each (B,), on the device."""
    ds_h, ds_w = lum_orig.shape[1], lum_orig.shape[2]
    use_windowed = ds_h > WINDOW_SIZE and ds_w > WINDOW_SIZE
    # Exactly-8px dims: the reference's window set is empty and
    # windowedSSIM returns 1.0 (ssim.go:162-164) — every quality accepts.
    constant_one = (min(ds_h, ds_w) == WINDOW_SIZE)
    use_kernel = lum_orig.is_cuda
    if use_windowed and not use_kernel:
        pre_a = ssim_premaps(lum_orig)

    def score(mid: torch.Tensor) -> torch.Tensor:
        lum = probe(mid)
        if use_windowed:
            if use_kernel:
                return ssim_window(lum_orig, lum)
            return ssim_map_pre(pre_a, lum_orig, lum).mean(dim=(-2, -1))
        if constant_one:
            return torch.ones_like(targets)
        return pixel_ssim_lum(lum_orig, lum)

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


def _search_targets(targets, dev: torch.device):
    """Per-image targets → ((B,) float32 targets, (B,) int64 seeds), each
    clamped as the single-image search clamps it (compress.go:24-26; the
    JAX package's batched search also floors at 0, compress.py:355)."""
    t = [0.999 if float(x) >= 1.0 else max(float(x), 0.0) for x in targets]
    return (torch.tensor(t, dtype=torch.float32, device=dev),
            torch.tensor([_seed_lo(x) for x in t], dtype=torch.int64,
                         device=dev))


def device_entropy_on(opts: Options, dev: torch.device) -> bool:
    """Whether JPEGs are Huffman-coded on the device: JAX's rule "auto =
    the accelerator" (engine/compress.py:663-666).  None → kernel K3 on a
    CUDA device, the host C++ encoder on the CPU; True → device emission
    (K3 on CUDA, its plain version on the CPU); False → the host C++
    encoder.  Both write the same bytes."""
    if opts.device_entropy is None:
        return dev.type == "cuda"
    return bool(opts.device_entropy)


def compress_jpeg_optimal(src: np.ndarray, target_ssim: float, opts: Options,
                          device: _device.DeviceLike = None
                          ) -> Tuple[int, float, bytes]:
    """Find the lowest JPEG quality meeting the target SSIM (reference
    compress.go:21-87).  Returns (quality, ssim, jpeg bytes)."""
    dev = _device.resolve(device)
    arr = to_nrgba_ref(np.asarray(src))
    h, w = arr.shape[:2]
    subsample = bool(opts.subsample)
    img = torch.from_numpy(arr).to(dev).to(torch.float32)
    inp, coefs = prepare_search(img[None], subsample)
    best_q, best_ssim, found = _bisect_device_batch(
        inp, *_search_targets([target_ssim], dev))
    # The one device→host copy of the search.
    q, s, f = torch.stack([best_q.to(torch.float32), best_ssim,
                           found.to(torch.float32)]).cpu()[:, 0].tolist()
    quality, ssim_val = int(q), s
    if not f:
        # Nothing met the target: the reference encodes at the initial hi
        # (Q=100) and reports bestSSIM=1.0 (compress.go:29-32,82-86).
        quality, ssim_val = 100, 1.0
    if device_entropy_on(opts, dev):
        data = _encode_from_coefs_device(coefs, w, h, quality, subsample,
                                         opts.optimize_huffman)
    else:
        data = encode_jpeg_from_coefs([c[0] for c in coefs], w, h, quality,
                                      subsample,
                                      optimize=opts.optimize_huffman)
    return quality, ssim_val, data


def _encode_from_coefs_device(coefs, w: int, h: int, quality: int,
                              subsample: bool, optimize: bool) -> bytes:
    """One image's file with device Huffman emission (JAX :676-734):
    quantize at `quality` on the device and emit with the standard or
    the image's optimal tables; what comes to the host is the histograms
    and the scan's words, not the blocks.  The same bytes as the host
    C++ encoder."""
    from ..parallel.batched import emit_scans

    qtab = quality_tables_on(coefs[0].device)[quality][None]
    packed = quantize_packed(coefs, qtab).contiguous()
    return emit_scans(packed, h, w, subsample, optimize).jpeg(
        0, w, h, quality, subsample)


# ── Batch counterparts (engine/batched.py drives them) ──────────────────────


def decode_jpeg_image(blocks: torch.Tensor, qtabs: torch.Tensor, h: int,
                      w: int, in_subsample: bool) -> torch.Tensor:
    """Reconstruct a batch of YCbCr JPEGs from their quantized blocks
    (counterpart of decode_jpeg_image_device, compress.py:556).

    blocks: (B, NT, 64) integer blocks, natural order, y then cb then cr
    on MCU-padded grids; qtabs: (B, 2, 64) [luma, chroma] tables.
    Returns (B, h, w, 4) float32 integral pixels on the blocks' device,
    the same values codecs/jpeg.decode_jpeg gives each file."""
    bsz = blocks.shape[0]
    mult = 16 if in_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ch, cw = (ph // 2, pw // 2) if in_subsample else (ph, pw)
    ny = (ph // 8) * (pw // 8)
    nc = (ch // 8) * (cw // 8)
    x = blocks.to(torch.float32)
    qt = qtabs.to(torch.float32)[:, :, None, :]  # (B, 2, 1, 64)

    def plane(part, table, hh, ww):
        return dct_ops.from_blocks(dct_ops.idct2d_blocks(
            dct_ops.dequantize_blocks(part, table)), hh, ww) + 128.0

    y = plane(x[:, :ny], qt[:, 0], ph, pw)
    cb = plane(x[:, ny:ny + nc], qt[:, 1], ch, cw)
    cr = plane(x[:, ny + nc:ny + 2 * nc], qt[:, 1], ch, cw)
    if in_subsample:
        cb = dct_ops.upsample_420(cb)
        cr = dct_ops.upsample_420(cr)
    ycc = torch.stack([y[:, :h, :w], cb[:, :h, :w], cr[:, :h, :w]], dim=-1)
    rgb = clamp_u8(ycbcr_to_rgb(ycc))
    alpha = torch.full((bsz, h, w, 1), 255.0, dtype=torch.float32,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def _search_chunk(imgs: torch.Tensor, targets, subsample: bool):
    """The lockstep search of (B, H, W, 4) float32 images (an opaque
    (B, H, W, 3) stack gets alpha 255) at B per-image targets →
    (SearchInputs, forward-DCT blocks, (best_q, best_ssim, found))."""
    if imgs.shape[-1] == 3:
        imgs = torch.cat([imgs, torch.full_like(imgs[..., :1], 255.0)],
                         dim=-1)
    t, lo0 = _search_targets(targets, imgs.device)
    inp, coefs = prepare_search(imgs, subsample)
    return inp, coefs, _bisect_device_batch(inp, t, lo0)


def batched_quality_search(imgs: torch.Tensor, targets,
                           subsample: bool = True):
    """(B, H, W, 4) float32 images on the device + B per-image targets →
    (quality int64, ssim float32, found bool), each (B,), on the device:
    the lockstep bisection alone (counterpart of
    batched_quality_search_device, compress.py:395)."""
    return _search_chunk(imgs, targets, subsample)[2]


def batched_quality_search_quantize(imgs: torch.Tensor, targets,
                                    subsample: bool, emit: bool = False,
                                    optimize: bool = True):
    """The lockstep search for a whole chunk (counterpart of
    batched_quality_search_quantize_device and _batched_search_core,
    compress.py:348-429).

    imgs: (B, H, W, 4) float32 on the device (an (B, H, W, 3) opaque
    stack gets alpha 255); targets: B per-image SSIM targets.  Every
    probe scores the whole chunk with one K1 call on a CUDA device.
    Returns host arrays (q (B,) int, ssim (B,) float32, found (B,) bool,
    then the blocks (B, NT, 64) int16 quantized at each image's final
    quality: the search's quality, or 100 where nothing met the target).
    Without `emit` the blocks come back with the rest in one device→host
    copy; with it they stay on the device, are Huffman-coded there
    (parallel/batched.emit_scans, optimal tables when `optimize`) and
    the fourth output is the emitted scans (a HostScans)."""
    bsz, h, w = imgs.shape[:3]
    inp, coefs, (best_q, best_ssim, found) = _search_chunk(imgs, targets,
                                                           subsample)
    blocks = quantize_packed(coefs, inp.tables[torch.where(found, best_q,
                                                            100)])
    head = torch.cat([best_q.to(torch.int16)[:, None],
                      found.to(torch.int16)[:, None],
                      best_ssim.contiguous().view(torch.int16).reshape(
                          bsz, 2)], dim=1)
    if emit:
        from ..parallel.batched import emit_scans

        scans = emit_scans(blocks.contiguous(), h, w, subsample, optimize)
        out = head.cpu().numpy()
        ssim = np.ascontiguousarray(out[:, 2:4]).view(np.float32)[:, 0]
        return out[:, 0].astype(np.int64), ssim, out[:, 1] != 0, scans
    wire = torch.cat([head, blocks.reshape(bsz, -1)], dim=1)
    host = torch.empty(wire.shape, dtype=torch.int16,
                       pin_memory=wire.is_cuda)
    host.copy_(wire, non_blocking=wire.is_cuda)
    if wire.is_cuda:
        torch.cuda.current_stream(wire.device).synchronize()
    out = host.numpy()
    ssim = np.ascontiguousarray(out[:, 2:4]).view(np.float32)[:, 0]
    return (out[:, 0].astype(np.int64), ssim, out[:, 1] != 0,
            out[:, 4:].reshape(bsz, -1, 64))


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
