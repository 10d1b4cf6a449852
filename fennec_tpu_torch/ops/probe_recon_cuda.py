"""Kernel K2: the fused probe reconstruction in CUDA C++
(csrc/probe_recon.cu), and its wrapper.

Replaces the XLA programs of one probe of the JAX package's quality
search (fennec_tpu/engine/compress.py: _qd_plane :96, _idct_plane :126,
_reconstruct_rgb_planes :140, _box_down_plane :166 and the luminance).
At first use on a CUDA tensor the source is compiled with nvcc for sm_90a
into fennec_tpu_torch/_build/ and loaded with ctypes, as K1 and K3 are.
The plain version is engine/compress.probe_luminance_plain: CPU planes go
to it; CUDA planes launch the kernel or raise.

A call is one launch of persistent CTAs and one torch.empty (the
luminance), on the current stream, without synchronising, so calls from
several threads and streams share nothing.  The inputs of a search are
checked once, at its first probe (prepare, cached on the SearchInputs);
a probe checks its quality tensor only.  With the SSIMFast downsample,
box_plan cuts the output into units of whole rectangles (bands of rows by
strips of columns) whose source pixels the kernel reconstructs in
chunks; it is plain numpy, cached per geometry, and uploaded once per
device.  One band of a row-split image (parallel/batched
.quality_search_spatial_sharded) is a SearchInputs of its own: its
coefficient rows and a halo of whole MCU rows past them, its owned
rectangles in its own rows (ops/resize.band_rectangles) and band_plan's
units, cached by the band.  The kernel is the same: the box sums are
integers, so a band's output rows are bit-equal to the same rows of the
whole image's.

box_mean_exact is the kernel's rounding rule for the box mean, in plain
torch on integers: what the CPU tests and chip_smoke.py hold the plain
version's float32 matrix products against.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from .filters import box_bounds, cover
from .resize import BoxBand, _cached_weights
from .ssim_cuda import compile_library, is_current

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "probe_recon.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libprobe_recon.so")
# --fmad=false: the colour maths and the luminance are the plain
# version's unfused multiplies and adds; the IDCT's fused multiply-adds
# are written out as fmaf in the source.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
MAX_BATCH = 65535  # images per call
CHUNK_W = 128  # pixel columns of a chunk (csrc kChunkW)
MAX_CELLS = 960  # output rectangles of a unit (kMaxCells)
MAX_UNIT_ROWS = 272  # output rows of a unit (kMaxUnitRows)
MAX_UNIT_COLS = 128  # output columns of a unit (kMaxUnitCols)


def chunk_rows(subsample: bool) -> int:
    """Pixel rows of a chunk of 96 blocks: 32 in 4:2:0, 16 in 4:4:4."""
    return 32 if subsample else 16


def mcu(subsample: bool) -> int:
    """Pixels of an MCU's side: where a chunk may start."""
    return 16 if subsample else 8


def axis_plan(s0, s1, align: int, chunk: int, span: int,
              max_out: int) -> np.ndarray:
    """(n, 4) int32 groups (o0, o1, a, chunks) of one axis: consecutive
    outputs [o0, o1) whose rectangles [s0, s1) lie in the chunks from a =
    s0[o0] rounded down to `align`, each `chunk` long; a group grows while
    its rectangles end within `span` of a and it holds under max_out
    outputs.  A rectangle longer than `span` makes a group of its own with
    as many chunks as it needs."""
    starts, ends = s0.tolist(), s1.tolist()
    out = []
    o, n_out = 0, len(starts)
    while o < n_out:
        a = starts[o] // align * align
        # s1 never decreases: the rectangles ending within the span are a
        # prefix of the outputs.
        fits = bisect.bisect_right(ends, a + span)
        e = max(o + 1, min(fits, o + max_out, n_out))
        out.append((o, e, a, max(1, -(-(ends[e - 1] - a) // chunk))))
        o = e
    return np.array(out, dtype=np.int32).reshape(-1, 4)


def chunk_ranges(groups: np.ndarray, s0, s1, src: int,
                 chunk: int) -> np.ndarray:
    """(chunks, 4) int32 records (d0, d1, r0, nr) of one axis, the chunks
    of every group in order: the outputs [d0, d1) of the group whose
    rectangles [s0, s1) meet the chunk's source indices [c0, c0 + chunk)
    ∩ [0, src) (filters.cover), and the source indices [r0, r0 + nr) that
    those rectangles hold in the chunk; all 0 where none does."""
    lo, hi = cover(s0, s1, src)
    out = []
    for o0, o1, a, n in groups.tolist():
        for i in range(n):
            c0 = a + i * chunk
            c1 = min(c0 + chunk, src)
            d0, d1 = max(int(lo[c0]), o0), min(int(hi[c1 - 1]), o1)
            if d1 > d0:
                r0 = max(int(s0[d0]), c0)
                out.append((d0, d1, r0, min(int(s1[d1 - 1]), c1) - r0))
            else:
                out.append((0, 0, 0, 0))
    return np.array(out, dtype=np.int32).reshape(-1, 4)


def busiest(chunks_per_unit: np.ndarray, bsz: int, ctas: int, sms: int):
    """(the most chunks one SM walks, the most one CTA walks) when `ctas`
    persistent CTAs, CTA c on SM c mod `sms`, take the bsz copies of these
    units in turn, as the kernel does."""
    units = np.tile(chunks_per_unit.ravel(), bsz)
    grid = min(ctas, units.size)
    per_cta = np.bincount(np.arange(units.size) % grid, weights=units,
                          minlength=grid)
    per_sm = np.bincount(np.arange(grid) % sms, weights=per_cta)
    return int(per_sm.max()), int(per_cta.max())


@functools.lru_cache(maxsize=256)
def box_plan(w: int, h: int, dw: int, dh: int, subsample: bool, bsz: int,
             ctas: int, sms: int):
    """K2's units for an h × w image box-downsampled to dh × dw: (plan,
    nbands, nstrips).  plan is int32 records of four, as
    csrc/probe_recon.cu reads them: two for each band (axis_plan of the
    rows: (o0, o1, a, n), then (first, 0, 0, 0)), two for each strip (of
    the columns), then the chunk_ranges of the bands' chunks and of the
    strips', a group's from record `first` on.  A unit reconstructs its
    rectangles' source pixels from the MCU that holds the first, so every
    seam between units costs up to one MCU row or column twice, and the
    chunks past a unit's last rectangle are spent too: long units waste
    less, many units share the card more evenly.  Of strips 1 to 3 chunks wide and bands 1 to 10 chunks high,
    the plan takes the one that leaves the least work on the busiest SM
    of a card of `sms` SMs running `ctas` CTAs, then on the busiest CTA
    (its chunks run one after another), then the least work."""
    return unit_plan(box_bounds(dh, h), h, box_bounds(dw, w), w, subsample,
                     bsz, ctas, sms)


@functools.lru_cache(maxsize=256)
def band_plan(w: int, dw: int, band: BoxBand, subsample: bool, bsz: int,
              ctas: int, sms: int):
    """box_plan for one band of a row-split image (ops/resize.box_band):
    the units of its owned rectangles over the band.rows source rows it
    reads, cached by the band, not by its shape alone."""
    return unit_plan(band.bounds(), band.rows, box_bounds(dw, w), w,
                     subsample, bsz, ctas, sms)


def unit_plan(rows, h: int, cols, w: int, subsample: bool, bsz: int,
              ctas: int, sms: int):
    """box_plan for the rectangles rows = (y0, y1) over h source rows and
    cols = (x0, x1) over w source columns."""
    align, chunk_h = mcu(subsample), chunk_rows(subsample)
    best = None
    for across in (1, 2, 3):
        strips = axis_plan(*cols, align, CHUNK_W, across * CHUNK_W,
                           MAX_UNIT_COLS)
        widest = int((strips[:, 1] - strips[:, 0]).max())
        for depth in range(1, 11):
            bands = axis_plan(*rows, align, chunk_h, depth * chunk_h,
                              min(MAX_CELLS // widest, MAX_UNIT_ROWS))
            chunks = bands[:, 3, None] * strips[None, :, 3]
            cost = (*busiest(chunks, bsz, ctas, sms), bsz * chunks.sum())
            if best is None or cost < best[0]:
                best = (cost, bands, strips)
    _, bands, strips = best
    rows_at = chunk_ranges(bands, *rows, h, chunk_h)
    cols_at = chunk_ranges(strips, *cols, w, CHUNK_W)
    groups = np.concatenate([bands, strips])
    counts = np.concatenate([bands[:, 3], strips[:, 3]])
    heads = np.zeros((len(groups), 2, 4), dtype=np.int32)
    heads[:, 0] = groups
    heads[:, 1, 0] = 2 * len(groups) + np.cumsum(counts) - counts
    plan = np.concatenate([heads.ravel(), rows_at.ravel(),
                           cols_at.ravel()]).astype(np.int32)
    plan.setflags(write=False)  # cached + shared
    return plan, len(bands), len(strips)


def box_mean_exact(planes: torch.Tensor, y0, y1, x0, x1) -> torch.Tensor:
    """The box mean as K2 rounds it: (..., H, W) integral planes →
    (..., len(y0), len(x0)) float32, floor((2·sum + n) / (2·n)) over the
    rectangle [y0, y1) × [x0, x1) of n pixels in integers (the exact
    mean rounded half up), 0 for an empty rectangle.  y0, y1, x0, x1:
    integer sequences (ops/filters.box_bounds)."""
    dev = planes.device
    y0, y1, x0, x1 = (torch.tensor([int(i) for i in v], dtype=torch.int64,
                                   device=dev) for v in (y0, y1, x0, x1))
    table = torch.zeros((*planes.shape[:-2], planes.shape[-2] + 1,
                         planes.shape[-1] + 1), dtype=torch.int64,
                        device=dev)
    table[..., 1:, 1:] = planes.to(torch.int64).cumsum(-2).cumsum(-1)
    rows_hi, rows_lo = table.index_select(-2, y1), table.index_select(-2, y0)
    sums = (rows_hi.index_select(-1, x1) - rows_hi.index_select(-1, x0)
            - rows_lo.index_select(-1, x1) + rows_lo.index_select(-1, x0))
    n = (y1 - y0)[:, None] * (x1 - x0)[None, :]
    mean = torch.div(2 * sums + n, 2 * n.clamp(min=1),
                     rounding_mode="floor")
    return torch.where(n > 0, mean, 0).to(torch.float32)


def check_inputs(cplanes, quality: Optional[torch.Tensor],
                 tables: torch.Tensor, dmat: torch.Tensor, subsample: bool,
                 h: int, w: int, rectangles, out_hw) -> None:
    """Raise unless cplanes are three (B, ph, pw) / (B, ch, cw) float32
    contiguous, 16-byte aligned planes of one device with the padded
    geometry of an h × w image, 1 <= B <= 65535; quality (B,) int64
    (not looked at when None: a search's probes check their own);
    tables (101, 2, 64) and dmat (8, 8) float32; and, when the output
    (dh, dw) differs from (h, w) or rectangles are given, rectangles the
    int32 array of ops/resize.box_rectangles (or band_rectangles) for
    it; all contiguous on that device."""
    if len(cplanes) != 3 or not all(isinstance(p, torch.Tensor)
                                    for p in cplanes):
        raise TypeError("fennec: K2 takes three coefficient planes")
    dev = cplanes[0].device
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    chw = (ph // 2, pw // 2) if subsample else (ph, pw)
    if h < 1 or w < 1 or cplanes[0].dim() != 3:
        raise ValueError(f"fennec: K2 takes (B, ph, pw) planes of an image "
                         f"of at least 1x1, got {tuple(cplanes[0].shape)} "
                         f"for {h}x{w}")
    bsz = cplanes[0].shape[0]
    if not 1 <= bsz <= MAX_BATCH:
        raise ValueError(f"fennec: K2 batch must be 1..{MAX_BATCH}, got "
                         f"{bsz}")
    for p, want in zip(cplanes, ((ph, pw), chw, chw)):
        if p.dtype != torch.float32:
            raise TypeError(f"fennec: K2 takes float32 planes, got "
                            f"{p.dtype}")
        if tuple(p.shape) != (bsz, *want) or p.device != dev:
            raise ValueError(f"fennec: K2 plane {tuple(p.shape)} on "
                             f"{p.device}, want {(bsz, *want)} on {dev}")
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError("fennec: K2 takes contiguous, 16-byte aligned "
                             "planes")
    dh, dw = out_hw
    wanted = [("tables", tables, torch.float32, (101, 2, 64)),
              ("dmat", dmat, torch.float32, (8, 8))]
    if quality is not None:
        wanted.append(("quality", quality, torch.int64, (bsz,)))
    if rectangles is not None or (dh, dw) != (h, w):
        wanted.append(("rectangles", rectangles, torch.int32,
                       (2 * (dh + dw + h + w),)))
    for name, t, dtype, shape in wanted:
        if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"fennec: K2 {name} must be {shape} {dtype} "
                             f"contiguous on {dev}, got "
                             f"{tuple(getattr(t, 'shape', ()))} "
                             f"{getattr(t, 'dtype', type(t))}")


class LaunchState(NamedTuple):
    """What every probe of one search launches with, made once per
    SearchInputs by ProbeReconKernel.prepare after check_inputs passed."""

    device: torch.device
    bsz: int
    out_hw: tuple
    plan: Optional[torch.Tensor]  # box_plan on the device, None without
    nbands: int
    nstrips: int
    ctas: int
    dmat: ctypes.Array  # the DCT matrix in host memory, for the launch


class ProbeReconKernel:
    """Builds, loads and launches K2.  `launches` counts launches (one per
    call on CUDA planes); `build_log` holds nvcc's report of the last
    build.  `source` and `library` name another build of the same
    interface, for timing one against the other."""

    def __init__(self, source: str = SOURCE, library: str = _SO) -> None:
        self.source = source
        self.library = library
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._cards = {}  # (device index, subsample) -> (CTAs, SMs)

    def build(self, force: bool = False) -> str:
        if force or not is_current(self.library, self.source):
            self.build_log = compile_library(self.source, self.library,
                                             NVCC_FLAGS)
        return self.library

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.fennec_probe_recon_error_string.restype = ctypes.c_char_p
                lib.fennec_probe_recon_error_string.argtypes = [i]
                lib.fennec_probe_recon_ctas_per_sm.restype = i
                lib.fennec_probe_recon_ctas_per_sm.argtypes = [i]
                lib.fennec_probe_recon.restype = i
                lib.fennec_probe_recon.argtypes = [
                    p, p, p, i, i, i, i, i, i, i, i, p, p, p, i, i, p, p, i,
                    i, i, p, p]
                self._lib = lib
            return self._lib

    def card(self, dev: torch.device, subsample: bool):
        """(CTAs of K2 the card holds at once, its SMs): the occupancy the
        card reports times its SMs, asked once per device and sampling."""
        key = (dev.index, bool(subsample))
        found = self._cards.get(key)
        if found is None:
            lib = self.load()
            with torch.cuda.device(dev):
                per_sm = lib.fennec_probe_recon_ctas_per_sm(int(subsample))
            if per_sm <= 0:
                msg = lib.fennec_probe_recon_error_string(-per_sm).decode()
                raise RuntimeError(f"fennec: K2 occupancy query failed: "
                                   f"{msg}")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            found = self._cards[key] = (sms * per_sm, sms)
        return found

    def prepare(self, inp, ctas: int, sms: int) -> LaunchState:
        """check_inputs on a search's inputs, then its launch state for a
        card of `sms` SMs that holds `ctas` CTAs at once."""
        y = inp.cplanes[0]
        out_hw = tuple(inp.lum_orig.shape[1:])
        check_inputs(inp.cplanes, None, inp.tables, inp.dmat,
                     inp.subsample, inp.h, inp.w, inp.box_rectangles, out_hw)
        bsz, rows = y.shape[0], chunk_rows(inp.subsample)
        # The one copy from the device of a search: 64 floats that every
        # launch then carries in its parameters.
        dmat = (ctypes.c_float * 64)(*inp.dmat.reshape(-1).tolist())
        if inp.box_rectangles is None:
            return LaunchState(y.device, bsz, out_hw, None,
                               -(-inp.h // rows), -(-inp.w // CHUNK_W), ctas,
                               dmat)
        dh, dw = out_hw
        key = f"k2_plan/{int(inp.subsample)}/{bsz}/{ctas}/{sms}"
        if inp.band is None:
            host, nbands, nstrips = box_plan(inp.w, inp.h, dw, dh,
                                             inp.subsample, bsz, ctas, sms)
        else:  # one band of a row-split image: keyed by the band
            host, nbands, nstrips = band_plan(inp.w, dw, inp.band,
                                              inp.subsample, bsz, ctas, sms)
            key += f"/band{tuple(inp.band)}"
        plan = _cached_weights(key, lambda *_: (host.copy(),), inp.w, inp.h,
                               dw, dh, y.device)[0]
        return LaunchState(y.device, bsz, out_hw, plan, nbands, nstrips,
                           ctas, dmat)

    def __call__(self, inp, quality: torch.Tensor) -> torch.Tensor:
        """SSIMFast luminance (B, dh, dw) float32 of the reconstruction
        of `inp` (an engine/compress.SearchInputs) at (B,) int64
        qualities, clamped to [0, 100]."""
        dev = inp.cplanes[0].device
        if dev.type == "cpu":
            from ..engine.compress import probe_luminance_plain

            return probe_luminance_plain(inp, quality)
        if dev.type != "cuda":
            raise ValueError(f"fennec: K2 takes CPU or CUDA tensors, got "
                             f"{dev}")
        state = inp.k2_state
        if state is None:
            state = self.prepare(inp, *self.card(dev, inp.subsample))
            inp.k2_state = state
        quality = quality.to(torch.int64).reshape(-1)
        if (quality.shape[0] != state.bsz or quality.device != dev
                or not quality.is_contiguous()):
            raise ValueError(f"fennec: K2 quality must be ({state.bsz},) "
                             f"int64 contiguous on {dev}, got "
                             f"{tuple(quality.shape)} on {quality.device}")
        return self._launch(inp, quality, state)

    def _launch(self, inp, quality: torch.Tensor,
                state: LaunchState) -> torch.Tensor:
        dev = state.device
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self._launch(inp, quality, state)
        lib = self.load()
        y, cb, cr = inp.cplanes
        dh, dw = state.out_hw
        lum = torch.empty((state.bsz, dh, dw), dtype=torch.float32,
                          device=dev)
        box = state.plan is not None
        err = lib.fennec_probe_recon(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), state.bsz,
            y.shape[1], y.shape[2], cb.shape[1], cb.shape[2], inp.h, inp.w,
            int(inp.subsample), inp.tables.data_ptr(), quality.data_ptr(),
            ctypes.addressof(state.dmat), dh, dw,
            inp.box_rectangles.data_ptr() if box else None,
            state.plan.data_ptr() if box else None, state.nbands,
            state.nstrips, state.ctas, lum.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
        if err != 0:
            msg = lib.fennec_probe_recon_error_string(err).decode()
            raise RuntimeError(f"fennec: K2 launch failed: CUDA error "
                               f"{err}: {msg}")
        with self._count_lock:  # the batch engines launch from threads
            self.launches += 1
        return lum


# The one instance the engines launch and chip_smoke.py counts.
probe_recon = ProbeReconKernel()
