"""Kernel K1: windowed SSIM in CUDA C++ (csrc/ssim_window.cu), and its
wrapper.

Replaces fennec_tpu/ops/ssim_pallas.py:batched_ssim_pallas.  At first use
on a CUDA tensor the source is compiled with nvcc for sm_90a into
fennec_tpu_torch/_build/ and loaded with ctypes (plain extern "C" entry
points that return a cudaError_t).  A CPU tensor goes to the plain
version in ops/ssim.py; a CUDA tensor launches the kernel or raises.

A call is one launch.  launch_plan cuts it into CTAs: strips of 128
output columns, and bands of rows whose height follows from the shape and
from how many CTAs the card holds at once.  Each call allocates its own
scratch (the means, one ticket per image, zeroed on the stream before the
launch, and the partial sums), so calls from several threads and streams
share nothing.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import threading
from typing import NamedTuple

import torch

from .filters import gaussian_window_1d
from .ssim import (
    GAUSS_SIGMA,
    SSIM_C1,
    SSIM_C2,
    WINDOW_SIZE,
    batched_ssim_plain,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ssim_window.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libssim_window.so")
# --fmad=false: no multiply and add is contracted into an FMA, so the
# window sums round as the plain version's do.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

STRIP = 128  # output columns per CTA (csrc/ssim_window.cu kStrip)
BLOCK_ROWS = 4  # output rows per partial sum (kBlockRows), whole in a band
WARPS = 2  # warps per CTA, one partial sum each per block (kWarps)
H100_SMS = 132
H100_CTAS_PER_SM = 6  # K1's occupancy on an H100 (168 registers a thread)


class LaunchPlan(NamedTuple):
    """Grid (strips, bands, batch); each band covers band_rows output rows
    (the last may cover fewer); `partials` partial sums per image."""

    strips: int
    bands: int
    band_rows: int
    partials: int


@functools.lru_cache(maxsize=1024)
def launch_plan(bsz: int, h: int, w: int, sms: int = H100_SMS,
                ctas_per_sm: int = H100_CTAS_PER_SM) -> LaunchPlan:
    """How K1 covers a (bsz, h, w) call on a card of `sms` SMs that holds
    `ctas_per_sm` of its CTAs at once: as many bands as one resident wave
    of CTAs holds, so that every SM is busy to the end and no second,
    part-filled wave follows.  Large shapes get tall bands (few halo rows
    read again), small ones short bands (more CTAs in flight).  The
    partial sums follow blocks of the image's rows, not the bands, so the
    plan changes no bit of the result."""
    oh, ow = h - WINDOW_SIZE, w - WINDOW_SIZE
    strips = -(-ow // STRIP)
    wave = max(1, sms * ctas_per_sm // (bsz * strips))
    band_rows = -(-oh // min(wave, oh))
    band_rows = -(-band_rows // BLOCK_ROWS) * BLOCK_ROWS
    return LaunchPlan(strips, -(-oh // band_rows), band_rows,
                      -(-oh // BLOCK_ROWS) * strips * WARPS)


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise FileNotFoundError("fennec: nvcc not found (PATH, CUDA_HOME, "
                            "/usr/local/cuda/bin)")


def compile_library(source: str, library: str, flags) -> str:
    """nvcc `source` into the shared library `library` (written under a
    temporary name, then moved into place, so a concurrent loader never
    sees half a file); returns nvcc's report.  Raises when nvcc fails."""
    os.makedirs(os.path.dirname(library), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
    os.close(fd)
    try:
        cmd = [find_nvcc(), *flags, "-o", tmp, source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"fennec: nvcc failed ({proc.returncode}):\n"
                               f"{log}")
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return log


def is_current(library: str, source: str) -> bool:
    """The library exists and is not older than its source."""
    return (os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source))


class WindowedSsimKernel:
    """Builds, loads and launches K1.  `launches` counts kernel launches
    (one per call on CUDA tensors; see count_launch); `build_log` holds
    nvcc's report (registers, shared memory, spills) of the last build.
    `source` and `library` name another build of the same interface, for
    timing one against the other."""

    def __init__(self, source: str = SOURCE, library: str = _SO) -> None:
        self.source = source
        self.library = library
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._cards = {}  # device index -> (SMs, CTAs per SM)
        self._taps = (ctypes.c_float * WINDOW_SIZE)(
            *gaussian_window_1d(WINDOW_SIZE, GAUSS_SIGMA))
        self._taps_ptr = ctypes.cast(self._taps, ctypes.c_void_p)

    def build(self, force: bool = False) -> str:
        """Compile the source into the build directory; returns the path.
        Skips the compile when the library is newer than the source."""
        if force or not is_current(self.library, self.source):
            self.build_log = compile_library(self.source, self.library,
                                             NVCC_FLAGS)
        return self.library

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                lib.fennec_cuda_error_string.restype = ctypes.c_char_p
                lib.fennec_cuda_error_string.argtypes = [ctypes.c_int]
                lib.fennec_ssim_window_ctas_per_sm.restype = ctypes.c_int
                lib.fennec_ssim_window_ctas_per_sm.argtypes = []
                lib.fennec_ssim_window_partials_per_image.restype = \
                    ctypes.c_int
                lib.fennec_ssim_window_partials_per_image.argtypes = [
                    ctypes.c_int, ctypes.c_int]
                lib.fennec_ssim_window.restype = ctypes.c_int
                lib.fennec_ssim_window.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
                if (lib.fennec_ssim_window_partials_per_image(2161, 3839)
                        != launch_plan(1, 2161, 3839).partials):
                    raise RuntimeError("fennec: K1 library and wrapper "
                                       "disagree on the partial sums")
                self._lib = lib
            return self._lib

    def __call__(self, lum_a: torch.Tensor,
                 lum_b: torch.Tensor) -> torch.Tensor:
        """(B, H, W) float32 contiguous pairs, H, W > 8 → (B,) mean
        windowed SSIM."""
        check_inputs(lum_a, lum_b)
        if lum_a.device.type == "cpu":
            return batched_ssim_plain(lum_a, lum_b)
        if lum_a.device.type != "cuda":
            raise ValueError(f"fennec: K1 takes CPU or CUDA tensors, got "
                             f"{lum_a.device}")
        return self._launch(lum_a, lum_b)

    def card(self, dev: torch.device):
        """(SMs, CTAs of K1 per SM) of a CUDA device, asked once."""
        found = self._cards.get(dev.index)
        if found is None:
            lib = self.load()
            with torch.cuda.device(dev):
                per_sm = lib.fennec_ssim_window_ctas_per_sm()
            if per_sm <= 0:
                msg = lib.fennec_cuda_error_string(-per_sm).decode()
                raise RuntimeError(f"fennec: K1 occupancy query failed: "
                                   f"{msg}")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            found = self._cards[dev.index] = (sms, per_sm)
        return found

    def _launch(self, lum_a: torch.Tensor,
                lum_b: torch.Tensor) -> torch.Tensor:
        dev = lum_a.device
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self._launch(lum_a, lum_b)
        lib = self.load()
        bsz, h, w = lum_a.shape
        plan = launch_plan(bsz, h, w, *self.card(dev))
        scratch = torch.empty(bsz * (2 + plan.partials),
                              dtype=torch.float32, device=dev)
        # The raw handle of the current stream: torch.cuda.current_stream
        # builds a Python object, several µs per call.
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = lib.fennec_ssim_window(
            lum_a.data_ptr(), lum_b.data_ptr(), bsz, h, w, plan.strips,
            plan.bands, plan.band_rows, self._taps_ptr, SSIM_C1, SSIM_C2,
            scratch.data_ptr(), stream)
        if err != 0:
            msg = lib.fennec_cuda_error_string(err).decode()
            raise RuntimeError(f"fennec: K1 launch failed: CUDA error "
                               f"{err}: {msg}")
        self.count_launch()
        return scratch[:bsz]

    def count_launch(self) -> None:
        """Add one to `launches`, under a lock: the batch engines launch
        from worker threads."""
        with self._count_lock:
            self.launches += 1


def check_inputs(lum_a: torch.Tensor, lum_b: torch.Tensor) -> None:
    """Raise unless both are (B, H, W) float32 contiguous tensors of one
    shape on one device, with H, W > 8 and 1 <= B <= 65535."""
    for t in (lum_a, lum_b):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fennec: K1 takes tensors, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"fennec: K1 takes float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"fennec: K1 takes (B, H, W), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("fennec: K1 takes contiguous tensors")
    if lum_a.shape != lum_b.shape or lum_a.device != lum_b.device:
        raise ValueError(f"fennec: K1 pair mismatch: {tuple(lum_a.shape)} "
                         f"on {lum_a.device} vs {tuple(lum_b.shape)} on "
                         f"{lum_b.device}")
    bsz, h, w = lum_a.shape
    if h <= WINDOW_SIZE or w <= WINDOW_SIZE:
        raise ValueError(f"fennec: K1 needs H, W > {WINDOW_SIZE}, got "
                         f"{h}x{w}")
    if not 1 <= bsz <= 65535:
        raise ValueError(f"fennec: K1 batch must be 1..65535, got {bsz}")


# The one instance the engine launches and chip_smoke.py counts.
ssim_window = WindowedSsimKernel()
