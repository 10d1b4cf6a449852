"""Kernel K3: Huffman emission in CUDA C++ (csrc/jpeg_emit.cu), and its
two wrappers.

Replaces the XLA programs of fennec_tpu/ops/jpeg_emit.py
(scan_symbol_hist_device :306, emit_scan_device :587).  At first use on
a CUDA tensor the source is compiled with nvcc for sm_90a into
fennec_tpu_torch/_build/ and loaded with ctypes, as K1 is
(ops/ssim_cuda.py).  Two entry points, each with its wrapper and its
launch count:

  block_stats (K3a)  bits per block under given tables, and the
                     per-image symbol histograms;
  deposit (K3b)      the scan words at exclusive bit offsets (a torch
                     cumsum of K3a's bits, taken between the launches).

A CPU tensor goes to the plain version in ops/jpeg_emit.py; a CUDA tensor
launches the kernel or raises.  Each call allocates its outputs with
torch.empty on the blocks' device and launches on the current stream
without synchronising; the C entry points zero what they accumulate into
on that stream, so calls from several threads and streams share
nothing.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from .jpeg_emit import (
    HIST,
    TABLE,
    ScanLayout,
    block_stats_plain,
    deposit_plain,
)
from .ssim_cuda import compile_library, is_current

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "jpeg_emit.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libjpeg_emit.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_IMAGES = 65535  # grid.y


class EmitLibrary:
    """Builds and loads the K3 library once per process; `build_log`
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
                p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
                lib.fennec_jpeg_emit_error_string.restype = ctypes.c_char_p
                lib.fennec_jpeg_emit_error_string.argtypes = [i]
                lib.fennec_jpeg_block_stats.restype = i
                lib.fennec_jpeg_block_stats.argtypes = [
                    p, i, i, p, p, i, p, i, p, p, p]
                lib.fennec_jpeg_deposit.restype = i
                lib.fennec_jpeg_deposit.argtypes = [
                    p, i, i, p, p, i, p, i, p, p, p, ll, p]
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.load().fennec_jpeg_emit_error_string(err).decode()
            raise RuntimeError(f"fennec: {what} launch failed: CUDA error "
                               f"{err}: {msg}")


library = EmitLibrary()


class _Counted:
    """A `launches` count under a lock: the batch engines launch from
    worker threads."""

    def __init__(self) -> None:
        self.launches = 0
        self._count_lock = threading.Lock()

    def count_launch(self) -> None:
        with self._count_lock:
            self.launches += 1


def _stream(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index)


def check_inputs(packed: torch.Tensor, lay: ScanLayout,
                 tables: torch.Tensor) -> None:
    """Raise unless packed is (B, NT, 64) int16 contiguous (16-byte
    aligned, 1 <= B <= 65535), the layout's arrays are (NT,) int32 and
    tables (1 or B, 2, 272) int32, all contiguous on packed's device."""
    if not isinstance(packed, torch.Tensor) or packed.dtype != torch.int16:
        raise TypeError(f"fennec: K3 takes int16 blocks, got "
                        f"{getattr(packed, 'dtype', type(packed))}")
    if packed.dim() != 3 or packed.shape[2] != 64:
        raise ValueError(f"fennec: K3 takes (B, NT, 64) blocks, got "
                         f"{tuple(packed.shape)}")
    bsz, nt = packed.shape[:2]
    if not 1 <= bsz <= MAX_IMAGES or nt < 1:
        raise ValueError(f"fennec: K3 batch must be 1..{MAX_IMAGES} images "
                         f"of >= 1 block, got {tuple(packed.shape)}")
    if not packed.is_contiguous() or packed.data_ptr() % 16:
        raise ValueError("fennec: K3 takes contiguous, 16-byte aligned "
                         "blocks")
    for name, t, shape in (("slot_row", lay.slot_row, (nt,)),
                           ("prev_row", lay.prev_row, (nt,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != packed.device):
            raise ValueError(f"fennec: K3 layout {name} must be {shape} "
                             f"int32 on {packed.device}")
    if (tables.dtype != torch.int32 or tables.dim() != 3
            or tables.shape[0] not in (1, bsz)
            or tuple(tables.shape[1:]) != (2, TABLE)
            or not tables.is_contiguous()
            or tables.device != packed.device):
        raise ValueError(f"fennec: K3 tables must be (1 or {bsz}, 2, "
                         f"{TABLE}) int32 on {packed.device}, got "
                         f"{tuple(tables.shape)} {tables.dtype}")


def _on_card(dev: torch.device) -> bool:
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"fennec: K3 takes CPU or CUDA tensors, got {dev}")
    return True


class BlockStatsKernel(_Counted):
    """K3a: ((B, NT) int32 bits per block under `tables`, (B, 544) int32
    histograms), each None unless asked for."""

    def __call__(self, packed: torch.Tensor, lay: ScanLayout,
                 tables: torch.Tensor, want_bits: bool = True,
                 want_hist: bool = True
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        check_inputs(packed, lay, tables)
        if not _on_card(packed.device):
            return block_stats_plain(packed, lay, tables, want_bits,
                                     want_hist)
        dev = packed.device
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(packed, lay, tables, want_bits, want_hist)
        lib = library.load()
        bsz, nt = packed.shape[:2]
        bits = (torch.empty((bsz, nt), dtype=torch.int32, device=dev)
                if want_bits else None)
        hist = (torch.empty((bsz, HIST), dtype=torch.int32, device=dev)
                if want_hist else None)
        err = lib.fennec_jpeg_block_stats(
            packed.data_ptr(), bsz, nt, lay.slot_row.data_ptr(),
            lay.prev_row.data_ptr(), lay.ny, tables.data_ptr(),
            0 if tables.shape[0] == 1 else 2 * TABLE,
            None if bits is None else bits.data_ptr(),
            None if hist is None else hist.data_ptr(), _stream(dev))
        library.check(err, "K3a")
        self.count_launch()
        return bits, hist


class DepositKernel(_Counted):
    """K3b: (word_base[-1] + 1,) int32 — every image's scan words (image
    b owns [word_base[b], word_base[b+1])), then a flag word, nonzero
    when some block's bits fell outside its image's words."""

    def __call__(self, packed: torch.Tensor, lay: ScanLayout,
                 tables: torch.Tensor, block_off: torch.Tensor,
                 word_base: torch.Tensor, n_words: int) -> torch.Tensor:
        """n_words = word_base[-1], known to the caller on the host."""
        check_inputs(packed, lay, tables)
        bsz, nt = packed.shape[:2]
        if (block_off.dtype != torch.int64
                or tuple(block_off.shape) != (bsz, nt)
                or not block_off.is_contiguous()
                or word_base.dtype != torch.int64
                or tuple(word_base.shape) != (bsz + 1,)
                or not word_base.is_contiguous()
                or block_off.device != packed.device
                or word_base.device != packed.device):
            raise ValueError(f"fennec: K3b takes ({bsz}, {nt}) int64 block "
                             f"offsets and ({bsz + 1},) int64 word bases "
                             f"on {packed.device}")
        if not _on_card(packed.device):
            return deposit_plain(packed, lay, tables, block_off, word_base)
        dev = packed.device
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(packed, lay, tables, block_off, word_base,
                            n_words)
        lib = library.load()
        words = torch.empty(n_words + 1, dtype=torch.int32, device=dev)
        err = lib.fennec_jpeg_deposit(
            packed.data_ptr(), bsz, nt, lay.slot_row.data_ptr(),
            lay.prev_row.data_ptr(), lay.ny, tables.data_ptr(),
            0 if tables.shape[0] == 1 else 2 * TABLE,
            block_off.data_ptr(), word_base.data_ptr(), words.data_ptr(),
            n_words, _stream(dev))
        library.check(err, "K3b")
        self.count_launch()
        return words


# The instances the engines launch and chip_smoke.py counts.
block_stats = BlockStatsKernel()
deposit = DepositKernel()
