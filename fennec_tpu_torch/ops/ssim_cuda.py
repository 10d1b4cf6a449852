"""Kernel K1: windowed SSIM in CUDA C++ (csrc/ssim_window.cu), and its
wrapper.

Replaces fennec_tpu/ops/ssim_pallas.py:batched_ssim_pallas.  At first use
on a CUDA tensor the source is compiled with nvcc for sm_90a into
fennec_tpu_torch/_build/ and loaded with ctypes (plain extern "C" entry
points that return a cudaError_t).  A CPU tensor goes to the plain
version in ops/ssim.py; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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


class WindowedSsimKernel:
    """Builds, loads and launches K1.  `launches` counts kernel launches
    (one per call on CUDA tensors; see count_launch); `build_log` holds
    nvcc's report (registers, shared memory, spills) of the last build."""

    def __init__(self) -> None:
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()

    def build(self, force: bool = False) -> str:
        """Compile the source into the build directory; returns the path.
        Skips the compile when the library is newer than the source."""
        if (not force and os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(SOURCE)):
            return _SO
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"fennec: nvcc failed ({proc.returncode})"
                                   f":\n{self.build_log}")
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return _SO

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                lib.fennec_cuda_error_string.restype = ctypes.c_char_p
                lib.fennec_cuda_error_string.argtypes = [ctypes.c_int]
                lib.fennec_ssim_window_partials_per_image.restype = \
                    ctypes.c_int
                lib.fennec_ssim_window_partials_per_image.argtypes = [
                    ctypes.c_int, ctypes.c_int]
                lib.fennec_ssim_window.restype = ctypes.c_int
                lib.fennec_ssim_window.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]
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

    def _launch(self, lum_a: torch.Tensor,
                lum_b: torch.Tensor) -> torch.Tensor:
        lib = self.load()
        bsz, h, w = lum_a.shape
        dev = lum_a.device
        per_image = lib.fennec_ssim_window_partials_per_image(h, w)
        partials = torch.empty((bsz, per_image), dtype=torch.float32,
                               device=dev)
        out = torch.empty((bsz,), dtype=torch.float32, device=dev)
        taps = (ctypes.c_float * WINDOW_SIZE)(
            *gaussian_window_1d(WINDOW_SIZE, GAUSS_SIGMA))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fennec_ssim_window(
                lum_a.data_ptr(), lum_b.data_ptr(), bsz, h, w,
                ctypes.cast(taps, ctypes.c_void_p), SSIM_C1, SSIM_C2,
                partials.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            msg = lib.fennec_cuda_error_string(err).decode()
            raise RuntimeError(f"fennec: K1 launch failed: CUDA error "
                               f"{err}: {msg}")
        self.count_launch()
        return out

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
