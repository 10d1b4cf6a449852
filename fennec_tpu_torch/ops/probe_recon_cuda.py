"""Kernel K2: the fused probe reconstruction in CUDA C++
(csrc/probe_recon.cu), and its wrapper.

Replaces the XLA programs of one probe of the JAX package's quality
search (fennec_tpu/engine/compress.py: _qd_plane :96, _idct_plane :126,
_reconstruct_rgb_planes :140, _box_down_plane :166 and the luminance).
At first use on a CUDA tensor the source is compiled with nvcc for sm_90a
into fennec_tpu_torch/_build/ and loaded with ctypes, as K1 and K3 are.
The plain version is engine/compress.probe_luminance_plain: CPU planes go
to it; CUDA planes launch the kernel or raise.

A call is one launch of the reconstruction kernel and, when the image is
downsampled for SSIMFast, one of the small kernel that rounds the box
means and forms the luminance.  Each call allocates what it writes with
one torch.empty (the luminance and, behind it, the int32 rectangle sums,
zeroed by the C entry on the stream) and launches on the current stream
without synchronising, so calls from several threads and streams share
nothing.

box_mean_exact is the kernel's rounding rule for the box mean, in plain
torch on integers: what the CPU tests and chip_smoke.py hold the plain
version's float32 matrix products against.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

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
MAX_BATCH = 65535  # the grid's z extent


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


def check_inputs(cplanes, quality: torch.Tensor, tables: torch.Tensor,
                 dmat: torch.Tensor, subsample: bool, h: int, w: int,
                 rectangles, out_hw) -> None:
    """Raise unless cplanes are three (B, ph, pw) / (B, ch, cw) float32
    contiguous, 16-byte aligned planes of one device with the padded
    geometry of an h × w image, 1 <= B <= 65535; quality (B,) int64;
    tables (101, 2, 64) and dmat (8, 8) float32; and, when the output
    (dh, dw) differs from (h, w), rectangles the int32 array of
    ops/resize.box_rectangles for it; all contiguous on that device."""
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
    wanted = [("quality", quality, torch.int64, (bsz,)),
              ("tables", tables, torch.float32, (101, 2, 64)),
              ("dmat", dmat, torch.float32, (8, 8))]
    if (dh, dw) != (h, w):
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


class ProbeReconKernel:
    """Builds, loads and launches K2.  `launches` counts launches of the
    reconstruction kernel (one per call on CUDA planes), `finish_launches`
    those of the kernel that rounds the box means (one per call that
    downsamples); `build_log` holds nvcc's report of the last build."""

    def __init__(self, source: str = SOURCE, library: str = _SO) -> None:
        self.source = source
        self.library = library
        self.launches = 0
        self.finish_launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()

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
                lib.fennec_probe_recon.restype = i
                lib.fennec_probe_recon.argtypes = [
                    p, p, p, i, i, i, i, i, i, i, i, p, p, p, i, i, p, p, p,
                    p]
                self._lib = lib
            return self._lib

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
        quality = quality.to(torch.int64).reshape(-1).contiguous()
        out_hw = tuple(inp.lum_orig.shape[1:])
        check_inputs(inp.cplanes, quality, inp.tables, inp.dmat,
                     inp.subsample, inp.h, inp.w, inp.box_rectangles, out_hw)
        return self._launch(inp, quality, out_hw)

    def _launch(self, inp, quality: torch.Tensor, out_hw) -> torch.Tensor:
        y, cb, cr = inp.cplanes
        dev = y.device
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self._launch(inp, quality, out_hw)
        lib = self.load()
        bsz, ph, pw = y.shape
        dh, dw = out_hw
        box = out_hw != (inp.h, inp.w)
        cells = bsz * dh * dw
        # One buffer: the luminance, then the int32 sums of r, g, b over
        # every output rectangle (the C entry zeroes them on the stream).
        buf = torch.empty(cells * (4 if box else 1), dtype=torch.float32,
                          device=dev)
        err = lib.fennec_probe_recon(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), bsz, ph, pw,
            cb.shape[1], cb.shape[2], inp.h, inp.w, int(inp.subsample),
            inp.tables.data_ptr(), quality.data_ptr(), inp.dmat.data_ptr(),
            dh, dw, inp.box_rectangles.data_ptr() if box else None,
            buf.data_ptr(), buf.data_ptr() + 4 * cells if box else None,
            torch._C._cuda_getCurrentRawStream(dev.index))
        if err != 0:
            msg = lib.fennec_probe_recon_error_string(err).decode()
            raise RuntimeError(f"fennec: K2 launch failed: CUDA error "
                               f"{err}: {msg}")
        with self._count_lock:  # the batch engines launch from threads
            self.launches += 1
            self.finish_launches += int(box)
        return buf[:cells].view(bsz, dh, dw)


# The one instance the engines launch and chip_smoke.py counts.
probe_recon = ProbeReconKernel()
