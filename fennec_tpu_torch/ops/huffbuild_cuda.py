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
in `launches`, or raises.  The call checks the histograms every time and
each standard-tables tensor once per device (std_tables_on hands the same
tensor to every call), allocates the tables and the header in one
new_empty on the histograms' device and launches on that device's
current stream without synchronising.  pull_header brings a header to
the host through a pinned buffer.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
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
        if self._lib is not None:
            return self._lib
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


def _check_hist_only(hist: torch.Tensor) -> None:
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


def _check_std(std: torch.Tensor, device: torch.device) -> None:
    if (not isinstance(std, torch.Tensor) or std.dtype != torch.int32
            or tuple(std.shape) != (1, 2, TABLE) or not std.is_contiguous()
            or std.device != device):
        raise ValueError(f"fennec: K5 takes (1, 2, {TABLE}) int32 standard "
                         f"tables on {device}")


def check_hist(hist: torch.Tensor, std: torch.Tensor) -> None:
    """Raise unless hist is (B, 544) int32 contiguous with 1 <= B < 2^31
    on the CPU or a CUDA device, and std the (1, 2, 272) int32 standard
    tables, contiguous on the same device."""
    _check_hist_only(hist)
    _check_std(std, hist.device)


class BuildTablesKernel(_Counted):
    """K5: each image's optimal tables and header from its histograms;
    one launch per call on a CUDA device."""

    def __init__(self) -> None:
        super().__init__()
        self.plain_calls = 0
        self._std_checked = {}  # device: the standard tables checked there

    def check(self, hist: torch.Tensor, std: torch.Tensor) -> None:
        """check_hist, the standard tables once per device and tensor."""
        _check_hist_only(hist)
        dev = hist.device
        if self._std_checked.get(dev) is not std:
            _check_std(std, dev)
            self._std_checked[dev] = std

    @staticmethod
    def outputs(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(tables, header) for these histograms, uninitialised: one
        buffer, the tables then the header (8-byte aligned rows)."""
        bsz = hist.shape[0]
        out = hist.new_empty(bsz * (2 * TABLE + OPT_HDR))
        return (out.as_strided((bsz, 2, TABLE), (2 * TABLE, TABLE, 1)),
                out.as_strided((bsz, OPT_HDR), (OPT_HDR, 1),
                               bsz * 2 * TABLE))

    def __call__(self, hist: torch.Tensor, std: torch.Tensor) -> Built:
        """hist (B, 544) int32, std (1, 2, 272) int32 on its device."""
        self.check(hist, std)
        dev = hist.device
        if dev.type == "cpu":
            with self._count_lock:
                self.plain_calls += 1
            return build_plain(hist, std)
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(hist, std)
        lib = library.load()
        tables, header = self.outputs(hist)
        err = lib.fennec_huff_build(hist.data_ptr(), hist.shape[0],
                                    std.data_ptr(), tables.data_ptr(),
                                    header.data_ptr(), _stream(dev))
        if err != 0:
            msg = lib.fennec_huff_error_string(err).decode()
            raise RuntimeError(f"fennec: K5 launch failed: CUDA error "
                               f"{err}: {msg}")
        self.count_launch()
        return Built(tables, header)


_pinned = threading.local()  # per thread: (pinned tensor, its array)


def pull_header(header: torch.Tensor) -> np.ndarray:
    """K5's (B, OPT_HDR) int32 header as a new host array.  A CUDA header
    is copied (waiting for its launch) into a pinned buffer that the
    calling thread keeps for its last row count, then out of it."""
    if header.device.type != "cuda":
        return header.numpy().copy()
    buf = getattr(_pinned, "buf", None)
    if buf is None or buf[0].shape[0] != header.shape[0]:
        pinned = torch.empty(header.shape, dtype=torch.int32,
                             pin_memory=True)
        buf = _pinned.buf = (pinned, pinned.numpy())
    buf[0].copy_(header)
    return buf[1].copy()


# The instance the emission launches and chip_smoke.py counts.
build_tables = BuildTablesKernel()
