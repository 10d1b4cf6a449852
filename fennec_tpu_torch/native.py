"""The host C++ runtime (JPEG entropy coding, PNG scanline filters).

At first use this compiles the repository's one C++ source,
fennec_tpu/native/entropy.cpp, read in place by path (it is a file, not
an import: nothing of the JAX package is imported), with the command
fennec_tpu/native/build.py uses, into fennec_tpu_torch/_build/.  It is a
ctypes façade over exactly the entry points the single-image path calls.
There is no pure-Python fallback: a failed build or a failed call raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "fennec_tpu", "native",
                      "entropy.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "libfennec_entropy.so")

_lock = threading.Lock()
_lib = None


def build(force: bool = False) -> str:
    """Compile entropy.cpp into the build directory; returns the .so path.
    Skips the compile when the library is newer than the source."""
    if not os.path.exists(SOURCE):
        raise FileNotFoundError(f"fennec: native source missing: {SOURCE}")
    if (not force and os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(SOURCE)):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    # mkstemp + replace: concurrent builders never load a half-written .so.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               "-fno-exceptions", "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"fennec: g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def _declare(lib: ctypes.CDLL) -> None:
    i, l, p = ctypes.c_int, ctypes.c_long, ctypes.c_void_p
    pi = ctypes.POINTER(ctypes.c_int)
    pp = ctypes.POINTER(ctypes.c_void_p)
    comp_geom = [i, pp, pi, pi, pi, pi, pi, i]
    lib.fennec_jpeg_encode_scan.restype = l
    lib.fennec_jpeg_encode_scan.argtypes = comp_geom + [p, l]
    lib.fennec_jpeg_count_symbols.restype = l
    lib.fennec_jpeg_count_symbols.argtypes = comp_geom + [p, p]
    lib.fennec_jpeg_encode_scan_custom.restype = l
    lib.fennec_jpeg_encode_scan_custom.argtypes = comp_geom + [
        p, p, pi, p, p, pi, p, l]
    lib.fennec_jpeg_decode_scan.restype = l
    lib.fennec_jpeg_decode_scan.argtypes = [
        p, l, l, i, pp, pi, pi, pi, pi, p, p, pi, pi, p, p, pi, pi, i]
    lib.fennec_png_unfilter.restype = i
    lib.fennec_png_unfilter.argtypes = [p, i, i, i, p]
    lib.fennec_png_filter.restype = l
    lib.fennec_png_filter.argtypes = [p, i, i, i, i, p]


def load() -> ctypes.CDLL:
    """Build (once per process) and load the library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def _ints(vals) -> "ctypes.Array":
    vals = list(vals)
    return (ctypes.c_int * len(vals))(*vals)


def _comp_geometry(comps):
    arrays = [np.ascontiguousarray(c.qcoefs, dtype=np.int32) for c in comps]
    for a, c in zip(arrays, comps):
        if a.shape != (c.bw * c.bh, 64):
            raise ValueError(
                f"fennec: component coefs {a.shape} do not match its "
                f"{c.bw}x{c.bh} block grid")
    ptrs = (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
    geom = (len(comps), ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
            _ints(c.bw for c in comps), _ints(c.bh for c in comps),
            _ints(c.h for c in comps), _ints(c.v for c in comps),
            _ints(1 if c.chroma else 0 for c in comps))
    # arrays and ptrs must outlive the C call: return them with geom.
    return geom, (arrays, ptrs)


def _scan_capacity(comps) -> int:
    return sum(c.bw * c.bh for c in comps) * 64 * 4 + 65536


# ── JPEG ────────────────────────────────────────────────────────────────────


def jpeg_encode_scan(comps, restart_interval: int = 0) -> bytes:
    """Entropy-code an interleaved baseline scan with the Annex-K tables."""
    lib = load()
    geom, _keep = _comp_geometry(comps)
    cap = _scan_capacity(comps)
    out = ctypes.create_string_buffer(cap)
    written = lib.fennec_jpeg_encode_scan(*geom, restart_interval, out, cap)
    if written < 0:
        raise RuntimeError("fennec native: encode_scan failed")
    return out.raw[:written]


def jpeg_count_symbols(comps, restart_interval: int = 0):
    """((2, 16), (2, 256)) int64 DC/AC symbol frequencies [luma, chroma]."""
    lib = load()
    geom, _keep = _comp_geometry(comps)
    dc_freq = np.zeros((2, 16), dtype=np.int64)
    ac_freq = np.zeros((2, 256), dtype=np.int64)
    rc = lib.fennec_jpeg_count_symbols(
        *geom, restart_interval, dc_freq.ctypes.data_as(ctypes.c_void_p),
        ac_freq.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError("fennec native: count_symbols failed")
    return dc_freq, ac_freq


def jpeg_encode_scan_custom(comps, dc_specs, ac_specs,
                            restart_interval: int = 0) -> bytes:
    """Encode with per-class (BITS, VALS) Huffman specs ([luma, chroma])."""
    lib = load()
    geom, _keep = _comp_geometry(comps)
    dc_bits = b"".join(bytes(s[0]) for s in dc_specs)
    ac_bits = b"".join(bytes(s[0]) for s in ac_specs)
    dc_vals = b"".join(bytes(s[1]) for s in dc_specs)
    ac_vals = b"".join(bytes(s[1]) for s in ac_specs)
    cap = _scan_capacity(comps)
    out = ctypes.create_string_buffer(cap)
    written = lib.fennec_jpeg_encode_scan_custom(
        *geom, restart_interval,
        dc_bits, dc_vals, _ints(len(s[1]) for s in dc_specs),
        ac_bits, ac_vals, _ints(len(s[1]) for s in ac_specs), out, cap)
    if written < 0:
        raise RuntimeError("fennec native: encode_scan_custom failed")
    return out.raw[:written]


def _spec_arrays(specs):
    """Concatenated BITS, VALS, per-component counts and offsets."""
    vals = [bytes(s[1]) for s in specs]
    offs = np.cumsum([0] + [len(v) for v in vals[:-1]]).tolist()
    return (b"".join(bytes(s[0]) for s in specs), b"".join(vals),
            _ints(len(v) for v in vals), _ints(offs))


def jpeg_decode_scan(data: bytes, pos: int, comps,
                     restart_interval: int = 0) -> List[np.ndarray]:
    """Decode one interleaved baseline scan: per component an
    (bw*bh, 64) int16 array of quantized coefficients, natural order."""
    lib = load()
    n = len(comps)
    outs = [np.zeros((c.bw * c.bh, 64), dtype=np.int16) for c in comps]
    out_ptrs = (ctypes.c_void_p * n)(
        *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
    rc = lib.fennec_jpeg_decode_scan(
        data, len(data), pos, n,
        ctypes.cast(out_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        _ints(c.bw for c in comps), _ints(c.bh for c in comps),
        _ints(c.h for c in comps), _ints(c.v for c in comps),
        *_spec_arrays([c.dc_spec for c in comps]),
        *_spec_arrays([c.ac_spec for c in comps]),
        restart_interval)
    if rc < 0:
        raise ValueError("fennec native: corrupt JPEG scan")
    return outs


# ── PNG ─────────────────────────────────────────────────────────────────────


def png_unfilter(raw: bytes, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Undo PNG per-row filtering; raw holds height*(1+stride) bytes.
    Returns (height, stride) uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError("fennec: truncated PNG image data")
    out = np.zeros((height, stride), dtype=np.uint8)
    rc = load().fennec_png_unfilter(raw, height, stride, bpp,
                                    out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError("fennec native: bad PNG filter type")
    return out


def png_filter(data: np.ndarray, bpp: int, heuristic: bool = True) -> bytes:
    """Per-row PNG filtering with the minimum-sum-of-absolute-differences
    heuristic.  data: (height, stride) uint8."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    h, stride = data.shape
    out = ctypes.create_string_buffer(h * (stride + 1))
    written = load().fennec_png_filter(
        data.ctypes.data_as(ctypes.c_void_p), h, stride, bpp,
        1 if heuristic else 0, out)
    if written < 0:
        raise RuntimeError("fennec native: png_filter failed")
    return out.raw[:written]
