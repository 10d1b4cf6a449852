"""The host C++ runtime (JPEG entropy coding, PNG scanline filters).

At first use this compiles the repository's one C++ source,
fennec_tpu/native/entropy.cpp, read in place by path (it is a file, not
an import: nothing of the JAX package is imported), with the command
fennec_tpu/native/build.py uses, into fennec_tpu_torch/_build/.  It is a
ctypes façade over exactly the entry points the port calls.  There is no
pure-Python fallback: a failed build or a failed call raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Tuple

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
    lib.fennec_jpeg_decode_progressive_scan.restype = l
    lib.fennec_jpeg_decode_progressive_scan.argtypes = [
        p, l, l, i, pp, pi, pi, pi, i, i, pi, pi, i, i, i, i,
        p, p, pi, pi, p, p, i, i]
    # The batch engines' compact upload routes (engine/batched.py).
    ll, pi32 = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int32)
    lib.fennec_jpeg_decode_scan_i8.restype = l
    lib.fennec_jpeg_decode_scan_i8.argtypes = [
        p, l, l, i, p, pi, pi, pi, pi, p, p, pi, pi, p, p, pi, pi, i, ll, p,
        p, l, pi32]
    lib.fennec_jpeg_decode_scan_coo.restype = l
    lib.fennec_jpeg_decode_scan_coo.argtypes = [
        p, l, l, i, p, p, p, i, pi, pi, pi, pi, p, p, pi, pi, p, p, pi, pi,
        i, p, p, l, p, pi32]
    lib.fennec_int16_to_int8_exc.restype = l
    lib.fennec_int16_to_int8_exc.argtypes = [p, l, p, p, p, l]
    lib.fennec_rgb_to_yuv420.restype = i
    lib.fennec_rgb_to_yuv420.argtypes = [p, l, i, i, p]
    lib.fennec_rgba_to_yuv420_one.restype = i
    lib.fennec_rgba_to_yuv420_one.argtypes = [p, i, i, i, p]
    lib.fennec_build_optimal_specs.restype = l
    lib.fennec_build_optimal_specs.argtypes = [l, p, p, p, p, p]
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


def jpeg_build_optimal_specs(dc_freq: np.ndarray, ac_freq: np.ndarray):
    """T.81 K.2 optimal tables for B images in one C call: (B, 2, 16) DC
    and (B, 2, 256) AC symbol frequencies [luma, chroma] → (bits (B, 4,
    16) uint8, vals (B, 4, 256) uint8, nvals (B, 4) int32), tables
    dc-luma, dc-chroma, ac-luma, ac-chroma; an empty class gets a minimal
    valid table.  Raises ValueError like the Python builder
    (codecs/huffopt.optimal_spec) when any image's code would exceed 32
    bits."""
    dcf = np.ascontiguousarray(dc_freq, dtype=np.int64)
    acf = np.ascontiguousarray(ac_freq, dtype=np.int64)
    n = dcf.shape[0]
    if dcf.shape != (n, 2, 16) or acf.shape != (n, 2, 256):
        raise ValueError(f"fennec: frequencies {dcf.shape} / {acf.shape}")
    bits = np.zeros((n, 4, 16), dtype=np.uint8)
    vals = np.zeros((n, 4, 256), dtype=np.uint8)
    nvals = np.zeros((n, 4), dtype=np.int32)
    rc = load().fennec_build_optimal_specs(
        n, dcf.ctypes.data_as(ctypes.c_void_p),
        acf.ctypes.data_as(ctypes.c_void_p),
        bits.ctypes.data_as(ctypes.c_void_p),
        vals.ctypes.data_as(ctypes.c_void_p),
        nvals.ctypes.data_as(ctypes.c_void_p))
    if rc == 2:
        raise ValueError(
            "fennec: optimal Huffman code length exceeds 32 bits")
    if rc != 0:
        raise RuntimeError("fennec native: build_optimal_specs failed")
    return bits, vals, nvals


def _spec_arrays(specs):
    """Concatenated BITS, VALS, per-component counts and offsets."""
    vals = [bytes(s[1]) for s in specs]
    offs = np.cumsum([0] + [len(v) for v in vals[:-1]]).tolist()
    return (b"".join(bytes(s[0]) for s in specs), b"".join(vals),
            _ints(len(v) for v in vals), _ints(offs))


def jpeg_decode_scan(data: bytes, pos: int, comps,
                     restart_interval: int = 0
                     ) -> Tuple[List[np.ndarray], int]:
    """Decode one baseline scan: per component an (bw*bh, 64) int16
    array of quantized coefficients, natural order, and the byte offset
    just past the scan (where a multi-scan file's next marker search
    starts)."""
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
    return outs, int(rc)


def jpeg_decode_progressive_scan(data: bytes, pos: int,
                                 coefs: List[np.ndarray], bw, hs, vs,
                                 mcus_x: int, mcus_y: int, nbw, nbh,
                                 ss: int, se: int, ah: int, al: int,
                                 dc_specs, ac_spec,
                                 restart_interval: int) -> int:
    """Apply one progressive (SOF2) scan in place to the per-scan-
    component int32 coefficient arrays; returns the byte offset past the
    scan.  On corrupt data it raises ValueError and leaves `coefs` as
    they were (a snapshot is restored), so the caller can rerun the scan
    with the Python decoder (codecs/progressive.py)."""
    lib = load()
    n = len(coefs)
    for c in coefs:
        if c.dtype != np.int32 or not c.flags.c_contiguous:
            raise ValueError("fennec: coefs must be contiguous int32")
    ptrs = (ctypes.c_void_p * n)(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in coefs])
    if ss == 0 and ah == 0:
        dc_bits, dc_vals, dc_nvals, dc_voff = _spec_arrays(dc_specs)
    else:
        dc_bits, dc_vals = bytes(16 * n), b""
        dc_nvals, dc_voff = _ints([0] * n), _ints([0] * n)
    if ss > 0:
        ac_bits, ac_vals = bytes(ac_spec[0]), bytes(ac_spec[1])
    else:
        ac_bits, ac_vals = bytes(16), b""
    snapshot = [c.copy() for c in coefs]
    rc = lib.fennec_jpeg_decode_progressive_scan(
        data, len(data), pos, n,
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        _ints(bw), _ints(hs), _ints(vs), mcus_x, mcus_y, _ints(nbw),
        _ints(nbh), ss, se, ah, al, dc_bits, dc_vals, dc_nvals, dc_voff,
        ac_bits, ac_vals, len(ac_vals), restart_interval)
    if rc < 0:
        for c, snap in zip(coefs, snapshot):
            np.copyto(c, snap)
        raise ValueError("fennec native: corrupt progressive scan")
    return int(rc)


# ── Compact upload layouts of the coefficient batch path ────────────────────
#
# Every output buffer is checked against the scan's block grid before its
# pointer reaches C: the decoders write sum(bw * bh) blocks.


def _scan_blocks(comps) -> int:
    return sum(c.bw * c.bh for c in comps)


def _check_out(arr: np.ndarray, dtype, shape, what: str) -> None:
    if (not isinstance(arr, np.ndarray) or arr.dtype != dtype
            or arr.shape != shape or not arr.flags.c_contiguous
            or not arr.flags.writeable):
        raise ValueError(
            f"fennec: {what} must be a writeable C-contiguous {np.dtype(dtype)}"
            f" array of shape {shape}, got "
            f"{getattr(arr, 'dtype', type(arr))} {getattr(arr, 'shape', '')}")


class ScanRejected(ValueError):
    """The C++ decoder rejected a scan for a compact layout: corrupt data,
    or more exceptions than the caller allowed."""


def _decode_status(ne: int, what: str) -> None:
    if ne == -1:
        raise ScanRejected("fennec native: corrupt JPEG scan")
    if ne == -2:
        raise ScanRejected(f"fennec native: too many {what} exceptions")


def jpeg_decode_scan_i8(data: bytes, pos: int, comps, restart_interval: int,
                        out: np.ndarray, max_exc: int = 16384):
    """Decode an interleaved baseline scan straight into (NT, 64) int8
    blocks in ZIGZAG order (`out`, every entry written), |v| > 127 stored
    as 0 and listed as exceptions (offsets into the image's flat NT * 64
    zigzag layout).  Returns (exc_idx int32, exc_val int16, the largest
    nonzero zigzag extent).  ScanRejected on corrupt data or past max_exc
    exceptions."""
    n = len(comps)
    _check_out(out, np.int8, (_scan_blocks(comps), 64), "out")
    exc_idx = np.empty(max_exc, dtype=np.int32)
    exc_val = np.empty(max_exc, dtype=np.int16)
    maxk = ctypes.c_int32(64)
    ne = load().fennec_jpeg_decode_scan_i8(
        data, len(data), pos, n, out.ctypes.data_as(ctypes.c_void_p),
        _ints(c.bw for c in comps), _ints(c.bh for c in comps),
        _ints(c.h for c in comps), _ints(c.v for c in comps),
        *_spec_arrays([c.dc_spec for c in comps]),
        *_spec_arrays([c.ac_spec for c in comps]),
        restart_interval, 0, exc_idx.ctypes.data_as(ctypes.c_void_p),
        exc_val.ctypes.data_as(ctypes.c_void_p), max_exc,
        ctypes.byref(maxk))
    _decode_status(ne, "int8")
    return exc_idx[:ne].copy(), exc_val[:ne].copy(), int(maxk.value)


def jpeg_decode_scan_coo(data: bytes, pos: int, comps, restart_interval: int,
                         out_dc: np.ndarray, out_pos: np.ndarray,
                         out_val: np.ndarray, max_exc: int = 16384):
    """Decode an interleaved baseline scan straight into the sparse COO
    layout: out_dc (NT,) int8, out_pos (NT, R) uint8 and out_val (NT, R)
    int8, each block's AC nonzeros as (zigzag position, value) pairs in
    scan order, position 0 padding.  |v| > 127 and the pairs past R are
    exceptions (offsets into the image's flat NT * 64 zigzag layout).
    Returns (exc_idx int32, exc_val int16, cnt_hist (65,) int32: blocks
    by their count of AC nonzeros within int8, the largest nonzero zigzag
    extent).  ScanRejected on corrupt data or past max_exc exceptions."""
    n, nt = len(comps), _scan_blocks(comps)
    rcap = out_pos.shape[-1] if isinstance(out_pos, np.ndarray) else 0
    if not 1 <= rcap <= 63:
        raise ValueError(f"fennec: COO slots per block must be 1..63, got "
                         f"{rcap}")
    _check_out(out_dc, np.int8, (nt,), "out_dc")
    _check_out(out_pos, np.uint8, (nt, rcap), "out_pos")
    _check_out(out_val, np.int8, (nt, rcap), "out_val")
    exc_idx = np.empty(max_exc, dtype=np.int32)
    exc_val = np.empty(max_exc, dtype=np.int16)
    cnt_hist = np.zeros(65, dtype=np.int32)
    maxk = ctypes.c_int32(64)
    ne = load().fennec_jpeg_decode_scan_coo(
        data, len(data), pos, n, out_dc.ctypes.data_as(ctypes.c_void_p),
        out_pos.ctypes.data_as(ctypes.c_void_p),
        out_val.ctypes.data_as(ctypes.c_void_p), rcap,
        _ints(c.bw for c in comps), _ints(c.bh for c in comps),
        _ints(c.h for c in comps), _ints(c.v for c in comps),
        *_spec_arrays([c.dc_spec for c in comps]),
        *_spec_arrays([c.ac_spec for c in comps]),
        restart_interval, exc_idx.ctypes.data_as(ctypes.c_void_p),
        exc_val.ctypes.data_as(ctypes.c_void_p), max_exc,
        cnt_hist.ctypes.data_as(ctypes.c_void_p), ctypes.byref(maxk))
    _decode_status(ne, "COO")
    return (exc_idx[:ne].copy(), exc_val[:ne].copy(), cnt_hist,
            int(maxk.value))


def int16_to_int8_exc(arr: np.ndarray, out: np.ndarray):
    """int16 values → `out` (int8, same shape, |v| > 127 stored as 0) and
    those values as exceptions: (flat index int32, value int16)."""
    src = np.ascontiguousarray(arr, dtype=np.int16)
    _check_out(out, np.int8, src.shape, "out")
    exc_idx = np.empty(src.size, dtype=np.int32)
    exc_val = np.empty(src.size, dtype=np.int16)
    ne = load().fennec_int16_to_int8_exc(
        src.ctypes.data_as(ctypes.c_void_p), src.size,
        out.ctypes.data_as(ctypes.c_void_p),
        exc_idx.ctypes.data_as(ctypes.c_void_p),
        exc_val.ctypes.data_as(ctypes.c_void_p), src.size)
    if ne < 0:
        raise RuntimeError("fennec native: int16_to_int8_exc failed")
    return exc_idx[:ne].copy(), exc_val[:ne].copy()


def yuv420_wire_size(h: int, w: int) -> int:
    """Bytes of one h × w image on the YCbCr 4:2:0 pixel wire: Y on the
    16-padded grid, then Cb and Cr at half its width and height."""
    ph, pw = h + (-h) % 16, w + (-w) % 16
    return ph * pw + 2 * (ph // 2) * (pw // 2)


def rgb_to_yuv420(rgb: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 RGB → (B, yuv420_wire_size(H, W)) uint8 wire
    rows (engine/batched._yuv420_wire_host's layout and rounding, to 1
    LSB: 16.16 fixed point)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 4 or rgb.shape[3] != 3 or 0 in rgb.shape[1:3]:
        raise ValueError(f"fennec: rgb_to_yuv420 takes (B, H, W, 3), got "
                         f"{rgb.shape}")
    b, h, w, _ = rgb.shape
    out = np.empty((b, yuv420_wire_size(h, w)), np.uint8)
    rc = load().fennec_rgb_to_yuv420(rgb.ctypes.data_as(ctypes.c_void_p), b,
                                     h, w, out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError("fennec native: rgb_to_yuv420 failed")
    return out


def rgba_to_yuv420_into(img: np.ndarray, out_row: np.ndarray) -> None:
    """ONE (H, W, C >= 3) uint8 image → its wire row, written into
    out_row in place.  The image's rows must be packed pixels of 3 or 4
    bytes (an NRGBA array or its [..., :3] view), and out_row a writeable
    contiguous uint8 row of exactly yuv420_wire_size(H, W) bytes; anything
    else raises ValueError (the JAX binding checks neither,
    fennec_tpu/native/build.py:526)."""
    if (not isinstance(img, np.ndarray) or img.dtype != np.uint8
            or img.ndim != 3 or img.shape[2] < 3 or 0 in img.shape[:2]):
        raise ValueError(f"fennec: rgba_to_yuv420_into takes an (H, W, C>=3)"
                         f" uint8 image, got {getattr(img, 'dtype', '')} "
                         f"{getattr(img, 'shape', type(img))}")
    h, w = img.shape[:2]
    ps = img.strides[1]
    if ps not in (3, 4) or img.strides[2] != 1 or img.strides[0] != w * ps:
        raise ValueError(f"fennec: rgba_to_yuv420_into takes rows of packed "
                         f"3- or 4-byte pixels, got strides {img.strides}")
    _check_out(out_row, np.uint8, (yuv420_wire_size(h, w),), "out_row")
    rc = load().fennec_rgba_to_yuv420_one(
        img.ctypes.data_as(ctypes.c_void_p), h, w, ps,
        out_row.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError("fennec native: rgba_to_yuv420 failed")


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
