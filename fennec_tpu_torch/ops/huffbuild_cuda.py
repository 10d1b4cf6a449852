"""Kernel K5: optimal Huffman tables on the device in CUDA C++
(csrc/huffbuild.cu), and its wrapper.

Replaces the XLA program build_tables_device of
fennec_tpu/ops/huffbuild.py (:169).  At first use on a CUDA tensor the
source is compiled with nvcc for sm_90a into fennec_tpu_torch/_build/ and
loaded with ctypes, as K1-K4 are.  `build_tables(hist)` takes K3a's
(B, 544) int32 histograms and returns a Built (ops/huffbuild.py): the
(B, 2, 272) int32 tables K3b codes with, and the (B, OPT_HDR) int32
header the host pulls (scan bits, overflow flag, DHT specs).  A CPU
tensor goes to the plain version, ops/huffbuild.build_plain, and counts
in `plain_calls`; a CUDA tensor launches the kernel, one launch counted
in `launches`, or raises.  The call allocates what it writes with one
torch.empty on the histograms' device and launches on that device's
current stream without synchronising.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .huffbuild import OPT_HDR, Built, build_plain
from .jpeg_emit import HIST, TABLE
from .jpeg_emit_cuda import BUILD_DIR, NVCC_FLAGS, _Counted, _stream
from .ssim_cuda import compile_library, is_current

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "huffbuild.cu")
_SO = os.path.join(BUILD_DIR, "libhuffbuild.so")


class HuffLibrary:
    """Builds and loads the K5 library once per process; `build_log`
    holds nvcc's report of the last build."""

    def __init__(self, source: str = SOURCE, library: str = _SO) -> None:
        self.source = source
        self.library = library
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

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
                lib.fennec_huff_error_string.restype = ctypes.c_char_p
                lib.fennec_huff_error_string.argtypes = [i]
                lib.fennec_huff_build.restype = i
                lib.fennec_huff_build.argtypes = [p, i, p, p, p, p]
                self._lib = lib
            return self._lib


library = HuffLibrary()


def check_hist(hist: torch.Tensor, std: torch.Tensor) -> None:
    """Raise unless hist is (B, 544) int32 contiguous with 1 <= B < 2^31
    on the CPU or a CUDA device, and std the (1, 2, 272) int32 standard
    tables, contiguous on the same device."""
    if not isinstance(hist, torch.Tensor) or hist.dtype != torch.int32:
        raise TypeError(f"fennec: K5 takes int32 histograms, got "
                        f"{getattr(hist, 'dtype', type(hist))}")
    if (hist.dim() != 2 or hist.shape[1] != HIST
            or not 1 <= hist.shape[0] < 1 << 31 or not hist.is_contiguous()):
        raise ValueError(f"fennec: K5 takes contiguous (B, {HIST}) "
                         f"histograms, got {tuple(hist.shape)}")
    if hist.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fennec: K5 takes CPU or CUDA tensors, got "
                         f"{hist.device}")
    if (not isinstance(std, torch.Tensor) or std.dtype != torch.int32
            or tuple(std.shape) != (1, 2, TABLE) or not std.is_contiguous()
            or std.device != hist.device):
        raise ValueError(f"fennec: K5 takes (1, 2, {TABLE}) int32 standard "
                         f"tables on {hist.device}")


class BuildTablesKernel(_Counted):
    """K5: each image's optimal tables and header from its histograms;
    one launch per call on a CUDA device."""

    def __init__(self) -> None:
        super().__init__()
        self.plain_calls = 0

    def __call__(self, hist: torch.Tensor, std: torch.Tensor) -> Built:
        """hist (B, 544) int32, std (1, 2, 272) int32 on its device."""
        check_hist(hist, std)
        dev = hist.device
        if dev.type == "cpu":
            with self._count_lock:
                self.plain_calls += 1
            return build_plain(hist, std)
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(hist, std)
        lib = library.load()
        bsz = hist.shape[0]
        # One buffer: the tables, then the header (8-byte aligned rows).
        out = torch.empty(bsz * (2 * TABLE + OPT_HDR), dtype=torch.int32,
                          device=dev)
        tables = out[:bsz * 2 * TABLE].view(bsz, 2, TABLE)
        header = out[bsz * 2 * TABLE:].view(bsz, OPT_HDR)
        err = lib.fennec_huff_build(hist.data_ptr(), bsz, std.data_ptr(),
                                    tables.data_ptr(), header.data_ptr(),
                                    _stream(dev))
        if err != 0:
            msg = lib.fennec_huff_error_string(err).decode()
            raise RuntimeError(f"fennec: K5 launch failed: CUDA error "
                               f"{err}: {msg}")
        self.count_launch()
        return Built(tables, header)


# The instance the emission launches and chip_smoke.py counts.
build_tables = BuildTablesKernel()
