"""Kernel K3: Huffman emission in CUDA C++ (csrc/jpeg_emit.cu), and its
two wrappers.

Replaces the XLA programs of fennec_tpu/ops/jpeg_emit.py
(scan_symbol_hist_device :306, emit_scan_device :587) and, through
K3a's per-image totals, the size oracle's bit count
(fennec_tpu/ops/jpeg_size.py component_scan_bits :102, scan_bits_device
:138).  At first use on a CUDA tensor the source is compiled with nvcc
for sm_90a into fennec_tpu_torch/_build/ and loaded with ctypes, as K1 is
(ops/ssim_cuda.py).  Four entry points, each with its wrapper and its
launch count:

  size_bisect (K4)   the size oracle's whole bisection in one launch, the
                     counterpart of the XLA program size_bisect_device
                     (fennec_tpu/engine/size_search.py:61);
  quantize_count (K4) the size oracle's step in one launch: K3a's totals
                     from the unquantized float32 coefficients and a
                     (B,) quality on the device, the quantization done
                     where the kernel stages its blocks;
  block_stats (K3a)  the scan's bits per image under given tables and,
                     when asked for, the per-image symbol histograms and
                     the bits of every block; `oracle_stats` is the same
                     kernel under a count of its own, for the size
                     oracle's launches;
  deposit (K3b)      the scan words; it finds its blocks' bit offsets
                     itself.

A CPU tensor goes to the plain version in ops/jpeg_emit.py; a CUDA tensor
launches the kernel or raises.  Each call allocates what it writes with
one torch.empty on the blocks' device and launches on the current stream
without synchronising; the C entry points zero what they accumulate into
on that stream, so calls from several threads and streams share
nothing.  Calling a wrapper checks its inputs; its `launch` method does
not, for a flow that has run check_inputs once for all its launches.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import torch

from .jpeg_emit import (
    HIST,
    TABLE,
    BlockStats,
    ScanLayout,
    block_stats_plain,
    deposit_plain,
    quantize_count_plain,
    size_bisect_plain,
)
from .ssim_cuda import compile_library, is_current

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "jpeg_emit.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libjpeg_emit.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_BLOCKS = 1 << 31
MAX_BISECT_STEPS = 8  # the kernel's kMaxSteps


class EmitLibrary:
    """Builds and loads the K3 library once per process; `build_log`
    holds nvcc's report of the last build."""

    def __init__(self, source: str = SOURCE, library: str = _SO) -> None:
        self.source = source
        self.library = library
        self.build_log = ""
        self.segment_blocks = 0  # slots per look-back segment of K3b
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
                lib.fennec_jpeg_segment_blocks.restype = i
                lib.fennec_jpeg_segment_blocks.argtypes = []
                lib.fennec_jpeg_resident_ctas.restype = i
                lib.fennec_jpeg_resident_ctas.argtypes = [i]
                lib.fennec_jpeg_block_stats.restype = i
                lib.fennec_jpeg_block_stats.argtypes = [
                    p, i, i, p, p, p, i, p, i, p, i, p, p]
                lib.fennec_jpeg_quantize_count.restype = i
                lib.fennec_jpeg_quantize_count.argtypes = [
                    p, p, p, i, i, i, p, p, p, p, p, p, p, p]
                lib.fennec_jpeg_size_bisect.restype = i
                lib.fennec_jpeg_size_bisect.argtypes = [
                    p, p, p, i, i, i, p, p, p, p, p, p, i, p, p]
                lib.fennec_jpeg_deposit.restype = i
                lib.fennec_jpeg_deposit.argtypes = [
                    p, i, i, p, p, p, i, p, i, p, p, ll, ll, p]
                self.segment_blocks = lib.fennec_jpeg_segment_blocks()
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
    aligned, B >= 1, fewer than 2^31 blocks), the layout's arrays are
    (NT,) int32 and tables (1 or B, 2, 272) int32, all contiguous on
    packed's device."""
    if not isinstance(packed, torch.Tensor) or packed.dtype != torch.int16:
        raise TypeError(f"fennec: K3 takes int16 blocks, got "
                        f"{getattr(packed, 'dtype', type(packed))}")
    if packed.dim() != 3 or packed.shape[2] != 64:
        raise ValueError(f"fennec: K3 takes (B, NT, 64) blocks, got "
                         f"{tuple(packed.shape)}")
    bsz, nt = packed.shape[:2]
    if bsz < 1 or nt < 1 or bsz * nt >= MAX_BLOCKS:
        raise ValueError(f"fennec: K3 takes >= 1 image of >= 1 block and "
                         f"fewer than 2^31 blocks, got "
                         f"{tuple(packed.shape)}")
    if not packed.is_contiguous() or packed.data_ptr() % 16:
        raise ValueError("fennec: K3 takes contiguous, 16-byte aligned "
                         "blocks")
    for name, t in (("slot_row", lay.slot_row), ("prev_row", lay.prev_row),
                    ("prev_slot", lay.prev_slot)):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                or tuple(t.shape) != (nt,) or not t.is_contiguous()
                or t.device != packed.device):
            raise ValueError(f"fennec: K3 layout {name} must be ({nt},) "
                             f"int32 on {packed.device}")
    check_tables(tables, bsz, packed.device)


def check_tables(tables: torch.Tensor, bsz: int,
                 device: torch.device) -> None:
    """Raise unless tables is (1 or bsz, 2, 272) int32 contiguous on
    `device`."""
    if (not isinstance(tables, torch.Tensor) or tables.dtype != torch.int32
            or tables.dim() != 3 or tables.shape[0] not in (1, bsz)
            or tuple(tables.shape[1:]) != (2, TABLE)
            or not tables.is_contiguous() or tables.device != device):
        raise ValueError(f"fennec: K3 tables must be (1 or {bsz}, 2, "
                         f"{TABLE}) int32 on {device}, got "
                         f"{tuple(getattr(tables, 'shape', ()))} "
                         f"{getattr(tables, 'dtype', type(tables))}")


def check_word_base(word_base: Optional[torch.Tensor], n_words: int,
                    bsz: int, device: torch.device) -> None:
    """Raise unless n_words is an int >= 0 and word_base is (bsz + 1,)
    int64 contiguous on `device`, or None for a single image that owns
    all n_words."""
    if not isinstance(n_words, int) or n_words < 0:
        raise ValueError(f"fennec: K3b takes n_words >= 0 as an int, got "
                         f"{n_words!r}")
    if word_base is None:
        if bsz != 1:
            raise ValueError(f"fennec: K3b needs the word bases of a batch "
                             f"of {bsz} images")
        return
    if (not isinstance(word_base, torch.Tensor)
            or word_base.dtype != torch.int64
            or tuple(word_base.shape) != (bsz + 1,)
            or not word_base.is_contiguous() or word_base.device != device):
        raise ValueError(f"fennec: K3b takes ({bsz + 1},) int64 word bases "
                         f"on {device}")


def _on_card(dev: torch.device) -> bool:
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"fennec: K3 takes CPU or CUDA tensors, got {dev}")
    return True


class BlockStatsKernel(_Counted):
    """K3a: a BlockStats of (B, NT, 64) int16 blocks under `tables`: the
    (B,) int64 scan bits per image always, the block bits and the
    histograms when asked for."""

    def __call__(self, packed: torch.Tensor, lay: ScanLayout,
                 tables: torch.Tensor, want_bits: bool = False,
                 want_hist: bool = False) -> BlockStats:
        check_inputs(packed, lay, tables)
        return self.launch(packed, lay, tables, want_bits, want_hist)

    def launch(self, packed: torch.Tensor, lay: ScanLayout,
               tables: torch.Tensor, want_bits: bool = False,
               want_hist: bool = False) -> BlockStats:
        """The call without its checks (check_inputs has passed)."""
        dev = packed.device
        if not _on_card(dev):
            return block_stats_plain(packed, lay, tables, want_bits,
                                     want_hist)
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self.launch(packed, lay, tables, want_bits,
                                   want_hist)
        lib = library.load()
        bsz, nt = packed.shape[:2]
        # One buffer: the totals (int64), the histograms, the block bits.
        n_hist = bsz * HIST if want_hist else 0
        out = torch.empty(2 * bsz + n_hist + (bsz * nt if want_bits else 0),
                          dtype=torch.int32, device=dev)
        bits = (out[2 * bsz + n_hist:].view(bsz, nt) if want_bits else None)
        err = lib.fennec_jpeg_block_stats(
            packed.data_ptr(), bsz, nt, lay.slot_row.data_ptr(),
            lay.prev_row.data_ptr(), lay.prev_slot.data_ptr(), lay.ny,
            tables.data_ptr(), 0 if tables.shape[0] == 1 else 2 * TABLE,
            out.data_ptr(), int(want_hist),
            None if bits is None else bits.data_ptr(), _stream(dev))
        library.check(err, "K3a")
        self.count_launch()
        hist = (out[2 * bsz:2 * bsz + n_hist].view(bsz, HIST)
                if want_hist else None)
        return BlockStats(bits, hist, out[:2 * bsz].view(torch.int64))


class DepositKernel(_Counted):
    """K3b: (n_words + 1,) int32 — every image's scan words (image b owns
    [word_base[b], word_base[b+1]); a single image may pass None and
    owns all n_words), then a flag word, nonzero when some block's bits
    fell outside its image's words."""

    def __call__(self, packed: torch.Tensor, lay: ScanLayout,
                 tables: torch.Tensor, word_base: Optional[torch.Tensor],
                 n_words: int) -> torch.Tensor:
        """n_words = word_base[-1], known to the caller on the host."""
        check_inputs(packed, lay, tables)
        check_word_base(word_base, n_words, packed.shape[0], packed.device)
        return self.launch(packed, lay, tables, word_base, n_words)

    def launch(self, packed: torch.Tensor, lay: ScanLayout,
               tables: torch.Tensor, word_base: Optional[torch.Tensor],
               n_words: int) -> torch.Tensor:
        """The call without its checks (check_inputs and check_word_base
        have passed)."""
        dev = packed.device
        if not _on_card(dev):
            if word_base is None:
                word_base = torch.tensor([0, n_words], dtype=torch.int64)
            return deposit_plain(packed, lay, tables, word_base)
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self.launch(packed, lay, tables, word_base, n_words)
        lib = library.load()
        bsz, nt = packed.shape[:2]
        # One buffer: the words, the flag word, then the kernel's ticket
        # and a 64-bit status word per look-back segment, 8-byte aligned.
        segments = bsz * (-(-nt // library.segment_blocks))
        size = ((n_words + 2) & ~1) + 2 + 2 * segments
        buf = torch.empty(size, dtype=torch.int32, device=dev)
        err = lib.fennec_jpeg_deposit(
            packed.data_ptr(), bsz, nt, lay.slot_row.data_ptr(),
            lay.prev_row.data_ptr(), lay.prev_slot.data_ptr(), lay.ny,
            tables.data_ptr(), 0 if tables.shape[0] == 1 else 2 * TABLE,
            None if word_base is None else word_base.data_ptr(),
            buf.data_ptr(), n_words, size, _stream(dev))
        library.check(err, "K3b")
        self.count_launch()
        return buf[:n_words + 1]


def check_coefs(coefs: Sequence[torch.Tensor], qtables: torch.Tensor,
                lay: ScanLayout, tables: torch.Tensor) -> None:
    """Raise unless coefs are (B, ny, 64), (B, nc, 64), (B, nc, 64)
    float32 contiguous, 16-byte aligned tensors of one device (B >= 1,
    fewer than 2^31 blocks) that fill the layout, qtables is (101, 2,
    64) float32 and tables (1, 2, 272) int32, all contiguous there."""
    if len(coefs) != 3 or not all(isinstance(c, torch.Tensor)
                                  for c in coefs):
        raise TypeError("fennec: K4 takes (y, cb, cr) coefficient tensors")
    y, cb, cr = coefs
    dev = y.device
    for c in coefs:
        if c.dtype != torch.float32:
            raise TypeError(f"fennec: K4 takes float32 coefficients, got "
                            f"{c.dtype}")
        if c.dim() != 3 or c.shape[2] != 64 or c.shape[0] != y.shape[0] \
                or c.device != dev:
            raise ValueError(f"fennec: K4 takes (B, N, 64) coefficients on "
                             f"one device, got {tuple(c.shape)} on "
                             f"{c.device}")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError("fennec: K4 takes contiguous, 16-byte aligned "
                             "coefficients")
    bsz, ny = y.shape[:2]
    nt = ny + 2 * cb.shape[1]
    if cb.shape != cr.shape or ny != lay.ny or bsz < 1 or ny < 1 \
            or cb.shape[1] < 1 or bsz * nt >= MAX_BLOCKS:
        raise ValueError(f"fennec: K4 coefficients {tuple(y.shape)}, "
                         f"{tuple(cb.shape)}, {tuple(cr.shape)} do not fill "
                         f"a layout of {lay.ny} luma blocks")
    for name, t in (("slot_row", lay.slot_row), ("prev_row", lay.prev_row),
                    ("prev_slot", lay.prev_slot)):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                or tuple(t.shape) != (nt,) or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"fennec: K4 layout {name} must be ({nt},) "
                             f"int32 on {dev}")
    if (not isinstance(qtables, torch.Tensor)
            or qtables.dtype != torch.float32
            or tuple(qtables.shape) != (101, 2, 64)
            or not qtables.is_contiguous() or qtables.device != dev):
        raise ValueError(f"fennec: K4 quality tables must be (101, 2, 64) "
                         f"float32 on {dev}")
    check_tables(tables, 1, dev)


class QuantizeCountKernel(_Counted):
    """K4: the (B,) int64 scan bits under `tables` of (y, cb, cr)
    float32 coefficient blocks quantized at (B,) int64 qualities on
    their device (clamped to [0, 100]): the size oracle's step, one
    launch, no host sync."""

    def __call__(self, coefs: Sequence[torch.Tensor], qtables: torch.Tensor,
                 quality: torch.Tensor, lay: ScanLayout,
                 tables: torch.Tensor) -> torch.Tensor:
        check_coefs(coefs, qtables, lay, tables)
        return self.launch(coefs, qtables, quality, lay, tables)

    def launch(self, coefs: Sequence[torch.Tensor], qtables: torch.Tensor,
               quality: torch.Tensor, lay: ScanLayout,
               tables: torch.Tensor) -> torch.Tensor:
        """The call without check_coefs (it has passed: a bisection
        checks once for its seven steps)."""
        y, cb, cr = coefs
        dev = y.device
        bsz = y.shape[0]
        if (quality.dtype != torch.int64 or tuple(quality.shape) != (bsz,)
                or quality.device != dev or not quality.is_contiguous()):
            raise ValueError(f"fennec: K4 takes ({bsz},) int64 qualities "
                             f"on {dev}, got {tuple(quality.shape)} "
                             f"{quality.dtype} on {quality.device}")
        if not _on_card(dev):
            return quantize_count_plain(coefs, qtables, quality, lay, tables)
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self.launch(coefs, qtables, quality, lay, tables)
        lib = library.load()
        totals = torch.empty(bsz, dtype=torch.int64, device=dev)
        err = lib.fennec_jpeg_quantize_count(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), bsz, y.shape[1],
            cb.shape[1], lay.slot_row.data_ptr(), lay.prev_row.data_ptr(),
            lay.prev_slot.data_ptr(), qtables.data_ptr(), quality.data_ptr(),
            tables.data_ptr(), totals.data_ptr(), _stream(dev))
        library.check(err, "K4")
        self.count_launch()
        return totals


def check_bounds(bounds: torch.Tensor, bsz: int, steps: int,
                 device: torch.device) -> None:
    """Raise unless bounds is (3, bsz) int64 contiguous on `device` and
    steps an int in [1, MAX_BISECT_STEPS]."""
    if (not isinstance(bounds, torch.Tensor) or bounds.dtype != torch.int64
            or tuple(bounds.shape) != (3, bsz) or not bounds.is_contiguous()
            or bounds.device != device):
        raise ValueError(f"fennec: K4's bisection takes (3, {bsz}) int64 "
                         f"bounds (target, lo0, hi0) on {device}, got "
                         f"{tuple(getattr(bounds, 'shape', ()))} "
                         f"{getattr(bounds, 'dtype', type(bounds))} on "
                         f"{getattr(bounds, 'device', None)}")
    if not isinstance(steps, int) or not 1 <= steps <= MAX_BISECT_STEPS:
        raise ValueError(f"fennec: K4's bisection takes 1 to "
                         f"{MAX_BISECT_STEPS} steps, got {steps!r}")


class SizeBisectKernel(_Counted):
    """K4's bisection: for (y, cb, cr) float32 coefficient blocks of B
    images and (3, B) int64 bounds on their device (each image's target
    scan bytes, lo0, hi0), the highest quality in [lo0, hi0] whose
    ceil(bits / 8) under `tables` fits the target, in `steps` steps:
    (best_q (B,) int64, found (B,) bool, table (steps, B) int64 of the
    bits each step counted, -1 where the image's range was already
    empty).  One launch, no host sync."""

    def __call__(self, coefs: Sequence[torch.Tensor], qtables: torch.Tensor,
                 lay: ScanLayout, tables: torch.Tensor, bounds: torch.Tensor,
                 steps: int):
        check_coefs(coefs, qtables, lay, tables)
        return self.launch(coefs, qtables, lay, tables, bounds, steps)

    def launch(self, coefs: Sequence[torch.Tensor], qtables: torch.Tensor,
               lay: ScanLayout, tables: torch.Tensor, bounds: torch.Tensor,
               steps: int):
        """The call without check_coefs (it has passed)."""
        y, cb, cr = coefs
        dev = y.device
        bsz = y.shape[0]
        check_bounds(bounds, bsz, steps, dev)
        if not _on_card(dev):
            return size_bisect_plain(coefs, qtables, lay, tables, bounds,
                                     steps)
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self.launch(coefs, qtables, lay, tables, bounds,
                                   steps)
        lib = library.load()
        # One buffer: the barrier words, the table, best_q, found's bytes.
        table_at, best_at = 1, 1 + steps * bsz
        out = torch.empty(best_at + bsz + (bsz + 7) // 8, dtype=torch.int64,
                          device=dev)
        err = lib.fennec_jpeg_size_bisect(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), bsz, y.shape[1],
            cb.shape[1], lay.slot_row.data_ptr(), lay.prev_row.data_ptr(),
            lay.prev_slot.data_ptr(), qtables.data_ptr(), tables.data_ptr(),
            bounds.data_ptr(), steps, out.data_ptr(), _stream(dev))
        library.check(err, "K4's bisection")
        self.count_launch()
        found = out[best_at + bsz:].view(torch.uint8)[:bsz].view(torch.bool)
        return (out[best_at:best_at + bsz], found,
                out[table_at:best_at].view(steps, bsz))


# The instances the engines launch and chip_smoke.py counts: emission's,
# the size oracle's step (scan_bytes_at) and bisection
# (engine/size_search.py), and K3a's totals as the oracle's count over
# packed blocks, counted apart.
block_stats = BlockStatsKernel()
oracle_stats = BlockStatsKernel()
deposit = DepositKernel()
quantize_count = QuantizeCountKernel()
size_bisect = SizeBisectKernel()
