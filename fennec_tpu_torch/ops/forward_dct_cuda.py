"""Kernel K8: the forward DCT and the original's SSIMFast luminance in CUDA
C++ (csrc/forward_dct.cu), and its two wrappers.

Replaces the XLA programs forward_dct_device (fennec_tpu/codecs/jpeg.py
:52) and, for the quality search's inputs, _box_down_plane
(fennec_tpu/engine/compress.py :166) with the luminance after it.  At
first use on a CUDA tensor the source is compiled with nvcc for sm_90a
into fennec_tpu_torch/_build/ and loaded with ctypes, as K1-K7 are.  Two
entries over the same (B, H, W, 4) float32 images, each with its count:

  forward_dct(img, subsample)
      the three (B, N, 64) float32 coefficient blocks, as
      codecs/jpeg.forward_dct_plain gives them (an (H, W, 4) image gives
      (N, 64) blocks);
  original_luminance(imgs, box_wh, box_wv, rectangles, rows)
      the original's SSIMFast luminance (B, dh, dw), as
      engine/compress.lum_orig_plain gives it: with the downsample
      (rectangles, from ops/resize.box_rectangles or band_rectangles),
      the box means rounded as K2 rounds its probes
      (ops/probe_recon_cuda.box_mean_exact); without one, the first
      `rows` rows of pixels.

CPU tensors go to the plain versions and count in `plain_calls`; CUDA
tensors launch the kernel or raise, one launch per call, counted in
`launches`.  A call on the card checks its inputs, allocates its outputs
with torch.empty and launches on the current stream without
synchronising.  Any image whose rows are contiguous will do: a band of
rows of a batch is a view.

tile_mcus, stage_rows, kmajor_index, register_tile and lum_columns are
the kernel's plan in plain Python: the wrapper launches with the first,
and the CPU tests walk tiles with all of them.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from .dct import _kron_on
from .jpeg_emit_cuda import BUILD_DIR, _Counted, _stream
from .ssim_cuda import NVCC_FLAGS, compile_library, is_current

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "forward_dct.cu")
_SO = os.path.join(BUILD_DIR, "libforward_dct.so")
TILE_BLOCKS = 64  # blocks of a DCT tile (csrc kTileBlocks)
THREADS = 256  # consumer threads of a DCT CTA (kConsumers)
WARP_BLOCKS = TILE_BLOCKS // (THREADS // 32)  # a warp's blocks (kWarpBlocks)
STAGE_BYTES = 16 * 160 * 16  # bytes of a pixel stage (kStageBytes)
LUM_COLS = 32  # output columns of a luminance CTA (kLumCols)
MAX_BATCH = 65535


def tile_mcus(subsample: bool, mcus_x: int,
              tile_blocks: int = TILE_BLOCKS) -> int:
    """MCUs of a DCT tile: as many as hold at most tile_blocks blocks (the
    kernel's TILE_BLOCKS; 6 an MCU in 4:2:0, 3 in 4:4:4), at most a
    row's.  At TILE_BLOCKS a tile's pixels (16 bytes each) fit a stage:
    10 MCUs of 4:2:0, 21 of 4:4:4."""
    return max(1, min(tile_blocks // (6 if subsample else 3), mcus_x))


def stage_rows(h: int, w: int, subsample: bool, img_stride: int, img: int,
               my: int, mx0: int, tile: int):
    """The TMA bulk copies of one tile, as thread 0 issues them: (source
    byte offset in the images, bytes, stage byte offset).  One per pixel
    row of the tile that lies inside the image (rows past h are the edge
    replicate's, read from row h - 1), cut at w; row r lands at r * tile
    * mcu pixels of 16 bytes."""
    mcu = 16 if subsample else 8
    mcus_x = -(-w // mcu)
    nm = min(tile, mcus_x - mx0)
    x0 = mx0 * mcu
    nbytes = min(nm * mcu, w - x0) * 16
    return [((img * img_stride + ((my * mcu + r) * w + x0) * 4) * 4, nbytes,
             r * tile * mcu * 16) for r in range(min(mcu, h - my * mcu))]


def kmajor_index(p: int, blk: int) -> int:
    """Where sample p of a tile's block sits in the k-major buffer: row p
    of TILE_BLOCKS floats, rotated by 4 (p mod 8) so that a conversion
    store of a warp spreads over the banks."""
    return p * TILE_BLOCKS + ((blk + 4 * (p & 7)) & (TILE_BLOCKS - 1))


def register_tile(warp: int, lane: int):
    """(blocks, coefficients) whose sums the lane holds in the product:
    four of the warp's WARP_BLOCKS blocks and four coefficients (4 og..4
    og+3)."""
    og = lane >> 1
    blk0 = warp * WARP_BLOCKS + (lane & 1) * 4
    return [blk0 + i for i in range(4)], [4 * og + j for j in range(4)]


def lum_columns(dw: int):
    """The output columns [d0, d1) of each luminance CTA of a row."""
    return [(d0, min(d0 + LUM_COLS, dw)) for d0 in range(0, dw, LUM_COLS)]


def _image(img: torch.Tensor) -> torch.Tensor:
    """Raise unless img is (B, H, W, 4) float32 with 1 <= B <= 65535, H, W
    >= 1, rows contiguous; returns it at a 16-byte aligned address (a
    copy if it is not)."""
    if not isinstance(img, torch.Tensor) or img.dtype != torch.float32:
        raise TypeError(f"fennec: K8 takes float32 images, got "
                        f"{getattr(img, 'dtype', type(img))}")
    if (img.dim() != 4 or img.shape[3] != 4 or min(img.shape[1:3]) < 1
            or not 1 <= img.shape[0] <= MAX_BATCH):
        raise ValueError(f"fennec: K8 takes (B, H, W, 4) images, 1 <= B <= "
                         f"{MAX_BATCH}, got {tuple(img.shape)}")
    _, h, w, _ = img.shape
    if img.stride()[1:] != (w * 4, 4, 1) or img.stride(0) % 4:
        img = img.contiguous()
    return img if img.data_ptr() % 16 == 0 else img.clone()


class K8Library:
    """Builds and loads the K8 library once per process; `build_log` holds
    nvcc's report of the last build, `tile_blocks` the blocks a DCT tile
    of its source holds (tile_mcus' bound)."""

    tile_blocks = TILE_BLOCKS

    def __init__(self, source: str = SOURCE, library: str = _SO) -> None:
        self.source = source
        self.library = library
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        self._ctas = {}  # device index -> DCT CTAs the card holds at once

    def build(self, force: bool = False) -> str:
        if force or not is_current(self.library, self.source):
            self.build_log = compile_library(self.source, self.library,
                                             NVCC_FLAGS)
        return self.library

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
                lib.fennec_fdct_error_string.restype = ctypes.c_char_p
                lib.fennec_fdct_error_string.argtypes = [i]
                lib.fennec_fdct_ctas_per_sm.restype = i
                lib.fennec_fdct_ctas_per_sm.argtypes = []
                lib.fennec_fdct.restype = i
                lib.fennec_fdct.argtypes = [p, ll, i, i, i, i, p, i, i, p, p,
                                            p, p]
                lib.fennec_lum_box.restype = i
                lib.fennec_lum_box.argtypes = [p, ll, i, i, i, p, i, i, p, p]
                lib.fennec_lum_pixels.restype = i
                lib.fennec_lum_pixels.argtypes = [p, ll, i, i, i, p, p]
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.load().fennec_fdct_error_string(err).decode()
            raise RuntimeError(f"fennec: K8 {what} launch failed: CUDA error "
                               f"{err}: {msg}")

    def ctas(self, dev: torch.device) -> int:
        """DCT CTAs the card holds at once: its occupancy times its SMs,
        asked once per device."""
        found = self._ctas.get(dev.index)
        if found is None:
            per_sm = self.load().fennec_fdct_ctas_per_sm()
            if per_sm <= 0:
                self.check(-per_sm or 1, "occupancy query")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            found = self._ctas[dev.index] = per_sm * sms
        return found


library = K8Library()


class _Entry(_Counted):
    """A K8 entry: the plain version on the CPU (counted in
    `plain_calls`), the kernel of `lib` (default: K8's library) on a
    card."""

    def __init__(self, lib: K8Library = None) -> None:
        super().__init__()
        self.plain_calls = 0
        self.library = lib or library

    def _count_plain(self) -> None:
        with self._count_lock:
            self.plain_calls += 1

    def _on_card(self, dev: torch.device) -> None:
        if dev.type != "cuda":
            raise ValueError(f"fennec: K8 takes CPU or CUDA tensors, got "
                             f"{dev}")


class ForwardDct(_Entry):
    """The forward DCT: (B, H, W, 4) or (H, W, 4) float32 → (y, cb, cr)
    coefficient blocks, each (B, N, 64) or (N, 64)."""

    def __call__(self, img: torch.Tensor, subsample: bool):
        if img.device.type == "cpu":
            from ..codecs.jpeg import forward_dct_plain

            self._count_plain()
            return forward_dct_plain(img, subsample)
        self._on_card(img.device)
        if img.dim() == 3:
            return tuple(c[0] for c in self(img[None], subsample))
        x = _image(img)
        dev = x.device
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(img, subsample)
        bsz, h, w, _ = x.shape
        mcu = 16 if subsample else 8
        mcus_x, mcus_y = -(-w // mcu), -(-h // mcu)
        nc = mcus_x * mcus_y
        ny = nc * (4 if subsample else 1)
        outs = tuple(torch.empty((bsz, n, 64), dtype=torch.float32,
                                 device=dev) for n in (ny, nc, nc))
        lib = self.library.load()
        err = lib.fennec_fdct(
            x.data_ptr(), x.stride(0), bsz, h, w, int(subsample),
            _kron_on(dev).data_ptr(),
            tile_mcus(subsample, mcus_x, self.library.tile_blocks),
            self.library.ctas(dev), *(o.data_ptr() for o in outs),
            _stream(dev))
        self.library.check(err, "DCT")
        self.count_launch()
        return outs


class OriginalLuminance(_Entry):
    """The original's SSIMFast luminance of (B, H, W, 4) float32 integral
    images: box_wh / box_wv the SSIMFast weights and rectangles their
    rectangles (both None without a downsample), rows the source rows
    that the output covers without one."""

    def __call__(self, imgs: torch.Tensor, box_wh: Optional[torch.Tensor],
                 box_wv: Optional[torch.Tensor],
                 rectangles: Optional[torch.Tensor],
                 rows: int) -> torch.Tensor:
        if imgs.device.type == "cpu":
            from ..engine.compress import lum_orig_plain

            self._count_plain()
            return lum_orig_plain(imgs, box_wh, box_wv, rows)
        self._on_card(imgs.device)
        x = _image(imgs)
        dev = x.device
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(imgs, box_wh, box_wv, rectangles, rows)
        bsz, h, w, _ = x.shape
        lib = self.library.load()
        if box_wh is None:
            if not 1 <= rows <= h:
                raise ValueError(f"fennec: K8 luminance of {rows} rows of "
                                 f"{h}")
            out = torch.empty((bsz, rows, w), dtype=torch.float32,
                              device=dev)
            err = lib.fennec_lum_pixels(x.data_ptr(), x.stride(0), bsz, rows,
                                        w, out.data_ptr(), _stream(dev))
        else:
            ndh, dw = box_wv.shape[0], box_wh.shape[0]
            want = 2 * (ndh + dw + h + w)
            if (not isinstance(rectangles, torch.Tensor)
                    or rectangles.dtype != torch.int32
                    or tuple(rectangles.shape) != (want,)
                    or not rectangles.is_contiguous()
                    or rectangles.device != dev
                    or tuple(box_wv.shape) != (ndh, h)
                    or tuple(box_wh.shape) != (dw, w)):
                raise ValueError(f"fennec: K8 takes ({want},) int32 "
                                 f"rectangles for {ndh}x{dw} of {h}x{w} on "
                                 f"{dev}")
            out = torch.empty((bsz, ndh, dw), dtype=torch.float32,
                              device=dev)
            err = lib.fennec_lum_box(x.data_ptr(), x.stride(0), bsz, h, w,
                                     rectangles.data_ptr(), ndh, dw,
                                     out.data_ptr(), _stream(dev))
        self.library.check(err, "luminance")
        self.count_launch()
        return out


# The instances the engines launch and chip_smoke.py counts.
forward_dct = ForwardDct()
original_luminance = OriginalLuminance()
