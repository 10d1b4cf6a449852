"""Kernel K7: the decode's device stage (dequantize, IDCT, upsample,
colour) in CUDA C++ (csrc/decode_recon.cu), and its wrapper.

Replaces the XLA programs _decode_plane_device and _combine_planes_device
(fennec_tpu/codecs/jpeg.py :702, :715) and decode_jpeg_image_device
(fennec_tpu/engine/compress.py :556).  At first use on a CUDA tensor the
source is compiled with nvcc for sm_90a into fennec_tpu_torch/_build/ and
loaded with ctypes, as K1-K6 are.  Two entries:

  decode_recon.frame(blocks, tables, comps, hmax, vmax, h, w, mode,
                     orientation=1)
      one frame's components (codecs/jpeg._reconstruct) → (h, w, 4) uint8,
      stored upright for the EXIF orientation ((w, h, 4) for 5-8);
  decode_recon.batch(blocks, qtabs, h, w, in_subsample)
      a (B, NT, 64) chunk of YCbCr JPEGs (engine/compress
      .decode_jpeg_image) → (B, h, w, 4) float32.

CPU tensors go to the plain versions (codecs/jpeg.reconstruct_plain and
engine/compress.decode_jpeg_image_plain) and count in `plain_calls`; CUDA
tensors launch the kernel or raise, one launch per call, counted in
`launches`.  `oriented` counts the frames decoded at an orientation other
than 1, on either route.  A call on the card checks its inputs, allocates
its output with one torch.empty and launches on the current stream without
synchronising.

tile_plan, stage_copies, conversion_lanes, kmajor_index, register_tile,
pixel_index, sample_offsets, store_map and colour_units are the kernel's
plan in plain Python: the wrapper launches with the first and store_map's
shape, and the CPU tests walk tiles with all of them.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Sequence, Tuple

import torch

from ..types import UnsupportedFormatError
from .dct import _kron_on
from .jpeg_emit_cuda import BUILD_DIR, _Counted, _stream
from .ssim_cuda import NVCC_FLAGS, compile_library, is_current

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "decode_recon.cu")
_SO = os.path.join(BUILD_DIR, "libdecode_recon.so")
TILE_BLOCKS = 128  # blocks of a tile, all components (csrc kTileBlocks)
MAX_TILE_COLS = 1024  # pixel columns of a tile (kMaxCols)
MAX_COMPS = 4
THREADS = 256  # threads of a CTA (kThreads)
WARP_BLOCKS = TILE_BLOCKS // (THREADS // 32)  # a warp's slots (kWarpBlocks)
PIX_STRIDE = 72  # floats between blocks of the pixel buffer (kPixStride)
MAX_BATCH = 65535
MODES = {"gray": 0, "rgb": 1, "ycbcr": 2, "cmyk": 3, "ycck": 4}
COMPONENTS = {"gray": 1, "rgb": 3, "ycbcr": 3, "cmyk": 4, "ycck": 4}


class Component(NamedTuple):
    """One component's sampling factors and block grid (bw x bh blocks,
    the MCU-padded grid)."""

    h: int
    v: int
    bw: int
    bh: int


def tile_plan(comps: Sequence[Component], mcus_x: int,
              tile_blocks: int = TILE_BLOCKS) -> Tuple[int, int]:
    """(MCUs a tile, tiles per MCU row): as many whole MCUs as hold at most
    tile_blocks blocks of every component (the kernel's TILE_BLOCKS), at
    most a row's."""
    per_mcu = sum(c.h * c.v for c in comps)
    tile = max(1, min(tile_blocks // per_mcu, mcus_x))
    return tile, -(-mcus_x // tile)


def slot_base(comps: Sequence[Component], nm: int) -> list:
    """The first slot of each component's run in a tile of nm MCUs (the
    kernel's nm * pre_c); the last entry is the tile's blocks."""
    base = [0]
    for c in comps:
        base.append(base[-1] + nm * c.h * c.v)
    return base


def stage_copies(comps: Sequence[Component], img_strides: Sequence[int],
                 tsel: Sequence[int], tab_stride: int, img: int, my: int,
                 mx0: int, nm: int):
    """The TMA bulk copies of one tile, as thread 0 issues them: (source,
    source byte offset, bytes, stage byte offset), source "tables" or a
    component's index.  Component c's block row by of the tile's nm MCUs
    is one span (its blocks are contiguous in device memory) landing at
    slot nm * (pre_c + by * h_c), 128 bytes a slot; the image's table
    rows 0..max(tsel) follow the TILE_BLOCKS slots."""
    ntab = max(tsel) + 1
    copies = [("tables", img * tab_stride * 4, ntab * 256, TILE_BLOCKS * 128)]
    base = slot_base(comps, nm)
    for c, comp in enumerate(comps):
        for by in range(comp.v):
            block = (img * img_strides[c] + (my * comp.v + by) * comp.bw
                     + mx0 * comp.h)
            copies.append((c, block * 128, nm * comp.h * 128,
                           (base[c] + by * nm * comp.h) * 128))
    return copies


def conversion_lanes(warp: int, step: int):
    """(slot, part) of each lane of `warp` at conversion step `step` (0-3):
    four slots of the warp's WARP_BLOCKS, eight 16-byte parts each."""
    return [(warp * WARP_BLOCKS + step * 4 + (lane >> 3), lane & 7)
            for lane in range(32)]


def kmajor_index(k: int, slot: int) -> int:
    """Where coefficient k of a tile's slot sits in the k-major buffer:
    row k of 128 floats, rotated by 4 (k // 8) so that a conversion
    store of a warp hits 32 banks."""
    return k * TILE_BLOCKS + ((slot + 4 * (k >> 3)) & (TILE_BLOCKS - 1))


def register_tile(warp: int, lane: int):
    """(slots, outputs) whose sums the lane holds in the product: four
    slots of the warp's WARP_BLOCKS and eight outputs (4 og..4 og+3 and
    32+4 og..32+4 og+3)."""
    og = lane >> 2
    blk0 = warp * WARP_BLOCKS + (lane & 3) * 4
    return ([blk0 + i for i in range(4)],
            [4 * og + j for j in range(4)] + [32 + 4 * og + j
                                              for j in range(4)])


def pixel_index(slot: int, pos: int) -> int:
    """Where output pos (row-major in the 8x8 block) of a slot sits in the
    block-major pixel buffer."""
    return slot * PIX_STRIDE + pos


def sample_offsets(comp: Component, hmax: int, vmax: int, nm: int):
    """(rows, cols) of one component as the kernel computes them for a
    tile of nm MCUs: pixel (ly, lx) of the tile reads the component's
    sample at base + rows[ly] + cols[lx] of the pixel buffer, base =
    nm * pre_c * PIX_STRIDE (its run starts at slot nm * pre_c; block row
    by at slot nm * (pre_c + by * h), the row's blocks in order).  The
    kernel keeps cols for every component of a column in one 64-bit word
    of 16-bit fields (its colx table), so each is below 2 ** 16."""
    ry, rx = vmax // comp.v, hmax // comp.h
    rows = [nm * ((ly // ry) >> 3) * comp.h * PIX_STRIDE
            + ((ly // ry) & 7) * 8 for ly in range(8 * vmax)]
    cols = [((lx // rx) >> 3) * PIX_STRIDE + ((lx // rx) & 7)
            for lx in range(nm * 8 * hmax)]
    return rows, cols


# EXIF orientation → (transposes, mirrors the output rows, mirrors its
# columns): what exif.apply_orientation does to a stored image.
ORIENTATIONS = {1: (False, False, False), 2: (False, False, True),
                3: (False, True, True), 4: (False, True, False),
                5: (True, False, False), 6: (True, False, True),
                7: (True, True, True), 8: (True, True, False)}
IDENTITY, FLIP, TRANSPOSE = 0, 1, 2  # the kernel's store paths (csrc Store)


class StoreMap(NamedTuple):
    """Where K7 stores a frame's pixels: pixel (y, x) of the stored h x w
    image at c0 + y * sy + x * sx of the upright (oh, ow) one; `kind` the
    kernel's store path."""

    kind: int
    c0: int
    sy: int
    sx: int
    oh: int
    ow: int


def store_map(orientation: int, h: int, w: int) -> StoreMap:
    """The kernel's store_map: orientation 1 the identity, 2-4 flips (rows
    stored coalesced at mirrored addresses), 5-8 transposing."""
    if orientation not in ORIENTATIONS:
        raise ValueError(f"fennec: EXIF orientation 1-8, got {orientation}")
    tr, frow, fcol = ORIENTATIONS[orientation]
    oh, ow = (w, h) if tr else (h, w)
    c0 = (oh - 1) * ow * frow + (ow - 1) * fcol
    ra, rb = -ow if frow else ow, -1 if fcol else 1
    kind = IDENTITY if orientation == 1 else TRANSPOSE if tr else FLIP
    return StoreMap(kind, c0, rb if tr else ra, ra if tr else rb, oh, ow)


def colour_units(kind: int, trows: int, tcols: int, warp: int):
    """The pixels (ly, lx) of a tile of trows x tcols that warp `warp`'s
    lanes colour and store, one list of 32 a warp store (None for an idle
    lane), in order.  Identity and flips: a pixel row a warp, adjacent
    columns a lane.  Transposing: units of 8 rows (group g) by 4 columns
    (cg), lane (8 g + (lane & 7), 4 cg + (lane >> 3)), so that each 8
    lanes of a column store 8 adjacent pixels of one output row."""
    warps = THREADS // 32
    out = []
    if kind != TRANSPOSE:
        for ly in range(warp, trows, warps):
            for lx0 in range(0, tcols, 32):
                out.append([(ly, lx0 + lane) if lx0 + lane < tcols else None
                            for lane in range(32)])
        return out
    ng = -(-trows // 8)
    for u in range(warp, ng * -(-tcols // 4), warps):
        g = u % ng
        lanes = [(8 * g + (lane & 7), 4 * (u // ng) + (lane >> 3))
                 for lane in range(32)]
        out.append([p if p[0] < trows and p[1] < tcols else None
                    for p in lanes])
    return out


def orient_plain(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """An (h, w, ...) image upright for its EXIF orientation, as
    exif.apply_orientation turns it: transposed, then its rows and / or
    columns mirrored (torch.transpose and torch.flip), contiguous."""
    tr, frow, fcol = ORIENTATIONS[orientation]
    if tr:
        img = img.transpose(0, 1)
    dims = [d for d, on in ((0, frow), (1, fcol)) if on]
    return (img.flip(dims) if dims else img).contiguous()


def check_frame(blocks, tables, comps, hmax: int, vmax: int, h: int, w: int,
                mode: str) -> None:
    """Raise unless the frame is one K7 takes: a mode of MODES with its
    number of components, sampling factors 1-4 that divide the largest
    (hmax, vmax), each component's blocks (bw * bh, 64) int16 on one
    device with bw = mcus_x * h and bh = mcus_y * v, the tables (ncomp,
    64) integers there, and h, w >= 1."""
    if mode not in MODES or len(comps) != COMPONENTS[mode]:
        raise ValueError(f"fennec: K7 takes a mode of {sorted(MODES)} with "
                         f"its components, got {mode} with {len(comps)}")
    if (len(blocks) != len(comps) or tables.is_floating_point()
            or tuple(tables.shape) != (len(comps), 64)
            or tables.device != blocks[0].device):
        raise ValueError("fennec: K7 takes blocks per component and "
                         "(ncomp, 64) integer tables on their device")
    if h < 1 or w < 1:
        raise ValueError(f"fennec: K7 takes a frame of at least 1x1, got "
                         f"{h}x{w}")
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    dev = blocks[0].device
    for c, b in zip(comps, blocks):
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or hmax % c.h or vmax % c.v:
            raise UnsupportedFormatError(
                f"fennec: sampling {c.h}x{c.v} does not divide {hmax}x{vmax}")
        if (c.bw, c.bh) != (mcus_x * c.h, mcus_y * c.v):
            raise ValueError(f"fennec: K7 component grid {c.bw}x{c.bh}, "
                             f"want {mcus_x * c.h}x{mcus_y * c.v}")
        if (b.dtype != torch.int16 or tuple(b.shape) != (c.bw * c.bh, 64)
                or b.device != dev):
            raise ValueError(f"fennec: K7 blocks {tuple(b.shape)} {b.dtype} "
                             f"on {b.device}, want ({c.bw * c.bh}, 64) int16 "
                             f"on {dev}")


def check_batch(blocks, qtabs, h: int, w: int, in_subsample: bool) -> None:
    """Raise unless blocks is (B, NT, 64) int16 with NT the blocks of an
    h x w YCbCr image's padded grids, 1 <= B <= 65535, and qtabs (B, 2,
    64) integers on its device."""
    if not isinstance(blocks, torch.Tensor) or blocks.dtype != torch.int16:
        raise TypeError(f"fennec: K7 takes int16 blocks, got "
                        f"{getattr(blocks, 'dtype', type(blocks))}")
    mult = 16 if in_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    nt = (ph // 8) * (pw // 8) * (3 if not in_subsample else 1)
    if in_subsample:
        nt += 2 * (ph // 16) * (pw // 16)
    if (blocks.dim() != 3 or blocks.shape[1:] != (nt, 64)
            or not 1 <= blocks.shape[0] <= MAX_BATCH or h < 1 or w < 1):
        raise ValueError(f"fennec: K7 takes (B, {nt}, 64) blocks for "
                         f"{h}x{w}, 1 <= B <= {MAX_BATCH}, got "
                         f"{tuple(blocks.shape)}")
    if (not isinstance(qtabs, torch.Tensor) or qtabs.is_floating_point()
            or tuple(qtabs.shape) != (blocks.shape[0], 2, 64)
            or qtabs.device != blocks.device):
        raise ValueError(f"fennec: K7 takes (B, 2, 64) integer tables on "
                         f"{blocks.device}, got "
                         f"{tuple(getattr(qtabs, 'shape', ()))}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class DecodeReconKernel(_Counted):
    """Builds, loads and launches K7; `build_log` holds nvcc's report of
    the last build."""

    def __init__(self, source: str = SOURCE, library: str = _SO) -> None:
        super().__init__()
        self.source = source
        self.library = library
        self.build_log = ""
        self.plain_calls = 0
        self.oriented = 0
        self._lib = None
        self._lock = threading.Lock()
        self._ctas = {}  # device index -> CTAs the card holds at once

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
                p, i = ctypes.c_void_p, ctypes.c_int
                ints = ctypes.POINTER(ctypes.c_int)
                lib.fennec_decode_recon_error_string.restype = \
                    ctypes.c_char_p
                lib.fennec_decode_recon_error_string.argtypes = [i]
                lib.fennec_decode_recon_ctas_per_sm.restype = i
                lib.fennec_decode_recon_ctas_per_sm.argtypes = []
                lib.fennec_decode_recon.restype = i
                lib.fennec_decode_recon.argtypes = [
                    ctypes.POINTER(p), ctypes.POINTER(ctypes.c_longlong),
                    ints, ints, ints, ints, i, p, i, p, i, i, i, i, i, i, i,
                    i, i, i, i, p, i, p]
                # A first build (bench_sources/) has no oriented entry.
                if hasattr(lib, "fennec_decode_recon_oriented"):
                    lib.fennec_decode_recon_oriented.restype = i
                    lib.fennec_decode_recon_oriented.argtypes = (
                        lib.fennec_decode_recon.argtypes[:-1] + [i, p])
                self._lib = lib
            return self._lib

    def check(self, err: int) -> None:
        if err != 0:
            msg = self.load().fennec_decode_recon_error_string(err).decode()
            raise RuntimeError(f"fennec: K7 launch failed: CUDA error {err}: "
                               f"{msg}")

    def ctas(self, dev: torch.device) -> int:
        """CTAs of K7 the card holds at once: its occupancy times its SMs,
        asked once per device."""
        found = self._ctas.get(dev.index)
        if found is None:
            per_sm = self.load().fennec_decode_recon_ctas_per_sm()
            if per_sm <= 0:
                self.check(-per_sm or 1)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            found = self._ctas[dev.index] = per_sm * sms
        return found

    def _plain(self, kind: str, *args):
        with self._count_lock:
            self.plain_calls += 1
        if kind == "frame":
            from ..codecs.jpeg import reconstruct_plain

            return reconstruct_plain(*args)
        from ..engine.compress import decode_jpeg_image_plain

        return decode_jpeg_image_plain(*args)

    def frame(self, blocks: Sequence[torch.Tensor], tables: torch.Tensor,
              comps: Sequence[Component], hmax: int, vmax: int, h: int,
              w: int, mode: str, orientation: int = 1) -> torch.Tensor:
        """One frame: component c's (bw * bh, 64) int16 blocks and row c
        of the (ncomp, 64) integer tables → (h, w, 4) uint8 RGBA on their
        device, upright for the EXIF `orientation` ((w, h, 4) for 5-8):
        exif.apply_orientation of the image at orientation 1, bit for
        bit."""
        comps = [Component(*c) for c in comps]
        dev = blocks[0].device
        smap = store_map(orientation, h, w)
        if dev.type == "cpu":
            out = self._plain("frame", blocks, tables, comps, hmax, vmax, h,
                              w, mode, orientation)
        else:
            check_frame(blocks, tables, comps, hmax, vmax, h, w, mode)
            out = torch.empty((smap.oh, smap.ow, 4), dtype=torch.uint8,
                              device=dev)
            self._launch(dev, [_aligned(b) for b in blocks],
                         [0] * len(comps), comps, list(range(len(comps))),
                         _aligned(tables.to(torch.int32)), 64, hmax, vmax, h,
                         w, MODES[mode], 1, out, False, orientation)
        if orientation != 1:
            with self._count_lock:
                self.oriented += 1
        return out

    def batch(self, blocks: torch.Tensor, qtabs: torch.Tensor, h: int,
              w: int, in_subsample: bool) -> torch.Tensor:
        """(B, NT, 64) int16 YCbCr blocks (y, cb, cr on the MCU-padded
        grids) and (B, 2, 64) [luma, chroma] tables → (B, h, w, 4)
        float32 integral RGBA on their device."""
        dev = blocks.device
        if dev.type == "cpu":
            return self._plain("batch", blocks, qtabs, h, w, in_subsample)
        check_batch(blocks, qtabs, h, w, in_subsample)
        bsz, nt = blocks.shape[:2]
        s = 2 if in_subsample else 1
        mcus_x, mcus_y = -(-w // (8 * s)), -(-h // (8 * s))
        comps = [Component(s, s, mcus_x * s, mcus_y * s),
                 Component(1, 1, mcus_x, mcus_y),
                 Component(1, 1, mcus_x, mcus_y)]
        blocks = _aligned(blocks)
        ny = comps[0].bw * comps[0].bh
        nc = mcus_x * mcus_y
        parts = [blocks, blocks[:, ny:], blocks[:, ny + nc:]]
        out = torch.empty((bsz, h, w, 4), dtype=torch.float32, device=dev)
        self._launch(dev, parts, [nt] * 3, comps, [0, 1, 1],
                     _aligned(qtabs.to(torch.int32)), 128, s, s, h, w,
                     MODES["ycbcr"], bsz, out, True)
        return out

    def _launch(self, dev, parts, strides, comps, tsel, tabs, tab_stride,
                hmax, vmax, h, w, mode, nimg, out, out_f32,
                orientation: int = 1) -> None:
        if dev.type != "cuda":
            raise ValueError(f"fennec: K7 takes CPU or CUDA tensors, got "
                             f"{dev}")
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self._launch(dev, parts, strides, comps, tsel, tabs,
                                    tab_stride, hmax, vmax, h, w, mode, nimg,
                                    out, out_f32, orientation)
        lib = self.load()
        n = len(comps)
        mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        tile, tiles_x = tile_plan(comps, mcus_x)

        def arr(ctype, vals):
            return (ctype * MAX_COMPS)(*vals, *[0] * (MAX_COMPS - n))

        args = (
            arr(ctypes.c_void_p, [p.data_ptr() for p in parts]),
            arr(ctypes.c_longlong, strides),
            arr(ctypes.c_int, [c.bw for c in comps]),
            arr(ctypes.c_int, [c.h for c in comps]),
            arr(ctypes.c_int, [c.v for c in comps]),
            arr(ctypes.c_int, tsel), n, tabs.data_ptr(), tab_stride,
            _kron_on(dev).data_ptr(), hmax, vmax, mcus_x, mcus_y, h, w, mode,
            nimg, tile, tiles_x, self.ctas(dev), out.data_ptr(),
            int(out_f32))
        if orientation == 1:
            err = lib.fennec_decode_recon(*args, _stream(dev))
        else:
            err = lib.fennec_decode_recon_oriented(*args, orientation,
                                                   _stream(dev))
        self.check(err)
        self.count_launch()


# The one instance the codec and the batch engine launch and chip_smoke.py
# counts.
decode_recon = DecodeReconKernel()
