"""Kernel K6: the compact upload layouts of the coefficient batch path
unpacked on the device in CUDA C++ (csrc/coef_wire.cu), and its three
wrappers.

Replaces the XLA programs _coo_to_natural, _i8_zigzag_to_natural and
_csr_to_slots of fennec_tpu/parallel/batched.py (:570, :542, :732).  At
first use on a CUDA tensor the source is compiled with nvcc for sm_90a
into fennec_tpu_torch/_build/ and loaded with ctypes, as K1-K5 are.  One
wrapper per layout, each with its own count:

  unpack_coo(dc, pos, val, exc_off, exc_val, exc_n)
  unpack_i8(i8, exc_off, exc_val, exc_n)
  unpack_csr(dc, counts, spos, sval, exc_off, exc_val, exc_n)

each returning the (B, NT, 64) int16 natural-order blocks (the layouts
and the exceptions' rules: ops/coef_wire.py).  A CPU tensor goes to the
plain version there and counts in `plain_calls`; a CUDA tensor launches
the kernel or raises, and counts one in `launches` per call.  A call is
one to three device operations: the rebuild's launch (persistent CTAs
over tiles of TILE blocks), for CSR a scan launch before it (and its
scratch's torch.empty), and the exceptions' launch when the chunk has
exception rows (E > 0).  Each call checks its inputs, allocates its
output with one torch.empty on their device and launches on that
device's current stream without synchronising.  Any contiguous tensor
will do, a row slice at any address included.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .coef_wire import (
    check_coo,
    check_csr,
    check_i8,
    coo_to_natural,
    csr_to_natural,
    i8_to_natural,
)
from .jpeg_emit_cuda import BUILD_DIR, NVCC_FLAGS, _Counted, _stream
from .ssim_cuda import compile_library, is_current

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "coef_wire.cu")
_SO = os.path.join(BUILD_DIR, "libcoef_wire.so")
TILE = 64  # blocks per tile of the rebuild (csrc/coef_wire.cu kTile)


class WireLibrary:
    """Builds and loads the K6 library once per process; `build_log`
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
                p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
                lib.fennec_wire_error_string.restype = ctypes.c_char_p
                lib.fennec_wire_error_string.argtypes = [i]
                lib.fennec_wire_csr_tiles.restype = i
                lib.fennec_wire_csr_tiles.argtypes = [i]
                lib.fennec_wire_coo.restype = i
                lib.fennec_wire_coo.argtypes = [p, p, p, i, i, i, p, p, p, i,
                                                p, p]
                lib.fennec_wire_i8.restype = i
                lib.fennec_wire_i8.argtypes = [p, i, i, i, p, p, p, i, p, p]
                lib.fennec_wire_csr.restype = i
                lib.fennec_wire_csr.argtypes = [p, p, p, p, ll, i, i, p, p, p,
                                                p, i, p, p]
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.load().fennec_wire_error_string(err).decode()
            raise RuntimeError(f"fennec: K6 {what} launch failed: CUDA error "
                               f"{err}: {msg}")


library = WireLibrary()


def _exc_args(exc_off, exc_val, exc_n):
    return (exc_off.data_ptr(), exc_val.data_ptr(), exc_n.data_ptr(),
            exc_off.shape[1])


class _Unpack(_Counted):
    """One layout's wrapper: the plain version on the CPU, the kernel of
    `lib` (default: K6's library) on a card (launch(lib, out, *tensors)
    returns the C entry's error)."""

    what = ""

    def __init__(self, check, plain, lib: WireLibrary = None) -> None:
        super().__init__()
        self.plain_calls = 0
        self.library = lib or library
        self._check = check
        self._plain = plain

    def __call__(self, *tensors: torch.Tensor) -> torch.Tensor:
        self._check(*tensors)
        first = tensors[0]
        dev = first.device
        if dev.type == "cpu":
            with self._count_lock:
                self.plain_calls += 1
            return self._plain(*tensors)
        if dev.type != "cuda":
            raise ValueError(f"fennec: K6 takes CPU or CUDA tensors, got "
                             f"{dev}")
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(*tensors)
        bsz, nt = first.shape[:2]
        out = torch.empty((bsz, nt, 64), dtype=torch.int16, device=dev)
        if bsz and nt:
            self.library.check(self.launch(self.library.load(), out,
                                           *tensors), self.what)
            self.count_launch()
        return out


class UnpackCoo(_Unpack):
    what = "COO"

    def __init__(self, lib: WireLibrary = None) -> None:
        super().__init__(check_coo, coo_to_natural, lib)

    @staticmethod
    def launch(lib, out, dc, pos, val, exc_off, exc_val, exc_n) -> int:
        bsz, nt, r = pos.shape
        return lib.fennec_wire_coo(
            dc.data_ptr(), pos.data_ptr(), val.data_ptr(), r, bsz, nt,
            *_exc_args(exc_off, exc_val, exc_n), out.data_ptr(),
            _stream(out.device))


class UnpackI8(_Unpack):
    what = "int8"

    def __init__(self, lib: WireLibrary = None) -> None:
        super().__init__(check_i8, i8_to_natural, lib)

    @staticmethod
    def launch(lib, out, i8, exc_off, exc_val, exc_n) -> int:
        bsz, nt, k = i8.shape
        return lib.fennec_wire_i8(
            i8.data_ptr(), k, bsz, nt, *_exc_args(exc_off, exc_val, exc_n),
            out.data_ptr(), _stream(out.device))


class UnpackCsr(_Unpack):
    what = "CSR"

    def __init__(self, lib: WireLibrary = None) -> None:
        super().__init__(check_csr, csr_to_natural, lib)

    @staticmethod
    def launch(lib, out, dc, counts, spos, sval, exc_off, exc_val,
               exc_n) -> int:
        bsz, nt = dc.shape
        scratch = torch.empty(bsz * lib.fennec_wire_csr_tiles(nt),
                              dtype=torch.int32, device=out.device)
        return lib.fennec_wire_csr(
            dc.data_ptr(), counts.data_ptr(), spos.data_ptr(),
            sval.data_ptr(), spos.shape[1], bsz, nt, scratch.data_ptr(),
            *_exc_args(exc_off, exc_val, exc_n), out.data_ptr(),
            _stream(out.device))


# The instances the engine launches and chip_smoke.py counts.
unpack_coo = UnpackCoo()
unpack_i8 = UnpackI8()
unpack_csr = UnpackCsr()
