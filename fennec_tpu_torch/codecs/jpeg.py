"""Baseline JPEG codec: device transforms in torch, host containers and
native entropy coding.

Counterpart of fennec_tpu/codecs/jpeg.py.
  encode: host uint8 → device [colour convert → 4:2:0 subsample → block
          DCT → quantize] → host C++ Huffman coding (native.py).
  decode: host marker parse + C++ Huffman decode → quantized coefficients →
          device [dequantize → IDCT → chroma upsample → YCbCr→RGB → clamp].

Decode covers gray, YCbCr, Adobe RGB, CMYK and YCCK frames: baseline
sequential in one interleaved scan or in several scans (one component
each, T.81 A.2.2), and progressive (codecs/progressive.py).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as _device
from .. import native
from ..ops import dct as dct_ops
from ..ops import forward_dct_cuda
from ..ops.decode_recon_cuda import decode_recon, orient_plain
from ..ops.color import clamp_u8, rgb_to_ycbcr, ycbcr_to_rgb
from ..types import UnsupportedFormatError
from ..utils.profiling import stage
from .entropy_py import ComponentSpec, DecodeComponentSpec
from .tables import (
    AC_CHROMA_BITS,
    AC_CHROMA_VALS,
    AC_LUMA_BITS,
    AC_LUMA_VALS,
    DC_CHROMA_BITS,
    DC_CHROMA_VALS,
    DC_LUMA_BITS,
    DC_LUMA_VALS,
)

# ── Device transforms ───────────────────────────────────────────────────────


def forward_dct(img: torch.Tensor, subsample: bool):
    """(H, W, 4) float32 → unquantized DCT coefficient blocks
    (coef_y (Ny, 64), coef_cb (Nc, 64), coef_cr (Nc, 64)), alpha
    composited on black (Go RGBA semantics); leading batch dimensions
    give (B, N, 64) blocks.  Quality-independent.  Kernel K8 on a CUDA
    image (ops/forward_dct_cuda.py), forward_dct_plain on a CPU one."""
    return forward_dct_cuda.forward_dct(img, subsample)


def forward_dct_plain(img: torch.Tensor, subsample: bool):
    """forward_dct in plain torch ops, on the image's device: what the CPU
    runs and what K8 is held against on the card."""
    alpha = img[..., 3:4] * (1.0 / 255.0)
    ycc = rgb_to_ycbcr(img[..., :3] * alpha)
    mult = 16 if subsample else 8
    y = dct_ops.pad_to_multiple(ycc[..., 0], mult, mult)
    cb = dct_ops.pad_to_multiple(ycc[..., 1], mult, mult)
    cr = dct_ops.pad_to_multiple(ycc[..., 2], mult, mult)
    if subsample:
        cb = dct_ops.downsample_420(cb)
        cr = dct_ops.downsample_420(cr)
    return tuple(dct_ops.dct2d_blocks(dct_ops.to_blocks(p - 128.0))
                 for p in (y, cb, cr))


def quantize_coefs(coefs, qtables: torch.Tensor):
    """Quantize (y, cb, cr) coefficient blocks with (2, 64) [luma, chroma]
    tables.  Returns float32 integral tensors."""
    y, cb, cr = coefs
    return (dct_ops.quantize_blocks(y, qtables[0]),
            dct_ops.quantize_blocks(cb, qtables[1]),
            dct_ops.quantize_blocks(cr, qtables[1]))


# ── Container assembly ──────────────────────────────────────────────────────


def _marker(m: int, payload: bytes = b"") -> bytes:
    if payload:
        return struct.pack(">BBH", 0xFF, m, len(payload) + 2) + payload
    return struct.pack(">BB", 0xFF, m)


def _dqt_segment(tables: np.ndarray) -> bytes:
    """DQT with tables 0 (luma) and 1 (chroma) in zigzag order."""
    payload = b""
    for tid in range(tables.shape[0]):
        zz = tables[tid][dct_ops.ZIGZAG]
        payload += bytes([tid]) + bytes(int(v) for v in zz)
    return _marker(0xDB, payload)


def _dht_segment() -> bytes:
    payload = b""
    for tc_th, bits, vals in (
        (0x00, DC_LUMA_BITS, DC_LUMA_VALS),
        (0x10, AC_LUMA_BITS, AC_LUMA_VALS),
        (0x01, DC_CHROMA_BITS, DC_CHROMA_VALS),
        (0x11, AC_CHROMA_BITS, AC_CHROMA_VALS),
    ):
        payload += bytes([tc_th]) + bytes(bits) + bytes(vals)
    return _marker(0xC4, payload)


def _dht_segment_custom(dc_specs, ac_specs, ncomp: int = 3) -> bytes:
    """DHT for per-image optimized tables ([luma, chroma] spec pairs)."""
    entries = [(0x00, dc_specs[0]), (0x10, ac_specs[0])]
    if ncomp > 1:
        entries += [(0x01, dc_specs[1]), (0x11, ac_specs[1])]
    payload = b""
    for tc_th, (bits, vals) in entries:
        payload += bytes([tc_th]) + bytes(bits) + bytes(vals)
    return _marker(0xC4, payload)


def _sof0_segment(w: int, h: int, ncomp: int, subsample: bool) -> bytes:
    payload = struct.pack(">BHHB", 8, h, w, ncomp)
    if ncomp == 1:
        payload += bytes([1, 0x11, 0])
    else:
        ys = 0x22 if subsample else 0x11
        payload += bytes([1, ys, 0])
        payload += bytes([2, 0x11, 1])
        payload += bytes([3, 0x11, 1])
    return _marker(0xC0, payload)


def _sos_segment(ncomp: int) -> bytes:
    payload = bytes([ncomp])
    if ncomp == 1:
        payload += bytes([1, 0x00])
    else:
        payload += bytes([1, 0x00, 2, 0x11, 3, 0x11])
    payload += bytes([0, 63, 0])
    return _marker(0xDA, payload)


_APP0_JFIF = _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def assemble_jpeg(w: int, h: int, qtables: np.ndarray,
                  scan_data: bytes, subsample: bool,
                  ncomp: int = 3,
                  dht: Optional[bytes] = None) -> bytes:
    """Wrap an entropy-coded scan in a JFIF container (standard Huffman
    tables unless a custom DHT segment is supplied)."""
    return (_marker(0xD8) + _APP0_JFIF + _dqt_segment(qtables)
            + _sof0_segment(w, h, ncomp, subsample)
            + (dht if dht is not None else _dht_segment())
            + _sos_segment(ncomp) + scan_data + _marker(0xD9))


# ── Host encode ─────────────────────────────────────────────────────────────


def _build_comps(qy, qcb, qcr, padded_h: int, padded_w: int,
                 subsample: bool):
    by, bx = padded_h // 8, padded_w // 8
    if subsample:
        cby, cbx = padded_h // 16, padded_w // 16
        yh = yv = 2
    else:
        cby, cbx = by, bx
        yh = yv = 1
    return [
        ComponentSpec(qy, bx, by, yh, yv, chroma=False),
        ComponentSpec(qcb, cbx, cby, 1, 1, chroma=True),
        ComponentSpec(qcr, cbx, cby, 1, 1, chroma=True),
    ]


def encode_jpeg_from_coefs(coefs, w: int, h: int, quality: int,
                           subsample: bool,
                           optimize: bool = False) -> bytes:
    """Quantize precomputed DCT coefficients at `quality` on their device
    and entropy-code them on the host.  optimize=True builds per-image
    optimal Huffman tables (two host passes; ~3-8% smaller files)."""
    quality = min(100, max(1, int(quality)))
    qtables = dct_ops.all_quality_tables()[quality]
    qt = torch.from_numpy(np.array(qtables)).to(coefs[0].device)
    qy, qcb, qcr = (q.to(torch.int32).cpu().numpy()
                    for q in quantize_coefs(coefs, qt))
    return encode_quantized(qy, qcb, qcr, w, h, quality, subsample,
                            optimize)


def encode_quantized(qy: np.ndarray, qcb: np.ndarray, qcr: np.ndarray,
                     w: int, h: int, quality: int, subsample: bool,
                     optimize: bool = False) -> bytes:
    """Entropy-code blocks already quantized at `quality` (natural order,
    raster, MCU-padded grids) on the host and wrap the container."""
    from .huffopt import specs_from_frequencies

    qtables = dct_ops.all_quality_tables()[quality]
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    comps = _build_comps(qy, qcb, qcr, ph, pw, subsample)
    if optimize:
        dc_freq, ac_freq = native.jpeg_count_symbols(comps)
        dc_specs, ac_specs = specs_from_frequencies(dc_freq, ac_freq)
        scan = native.jpeg_encode_scan_custom(comps, dc_specs, ac_specs)
        dht = _dht_segment_custom(dc_specs, ac_specs, ncomp=len(comps))
        return assemble_jpeg(w, h, qtables, scan, subsample, dht=dht)
    scan = native.jpeg_encode_scan(comps)
    return assemble_jpeg(w, h, qtables, scan, subsample)


def encode_jpeg(img: np.ndarray, quality: int, subsample: bool = True,
                device: _device.DeviceLike = None) -> bytes:
    """Encode an (H, W, 4) uint8 NRGBA image as baseline JPEG at a fixed
    quality (standard Huffman tables), transforms on `device`."""
    from ..image import to_nrgba_ref

    arr = to_nrgba_ref(np.asarray(img))
    h, w = arr.shape[:2]
    x = torch.from_numpy(arr).to(_device.resolve(device)).to(torch.float32)
    coefs = forward_dct(x, bool(subsample))
    return encode_jpeg_from_coefs(coefs, w, h, quality, subsample)


# ── Host decode ─────────────────────────────────────────────────────────────


class JpegHeader:
    """Parsed JPEG structure up to (and including) the SOS header."""

    def __init__(self) -> None:
        self.width = 0
        self.height = 0
        self.ncomp = 0
        self.comps: List[dict] = []  # id, h, v, tq
        self.qtables: Dict[int, np.ndarray] = {}  # natural order
        self.dc_tables: Dict[int, tuple] = {}
        self.ac_tables: Dict[int, tuple] = {}
        self.restart_interval = 0
        self.scan_comps: List[dict] = []  # comp idx, dc table id, ac table id
        self.scan_offset = 0
        # Adobe APP14 color transform: None = no marker; 0 = none
        # (RGB/CMYK by component count), 1 = YCbCr, 2 = YCCK.
        self.adobe_transform: "int | None" = None
        self.jfif = False  # APP0 'JFIF' seen (forces YCbCr, like Go)


def parse_jpeg(data: bytes) -> JpegHeader:
    """Parse baseline JPEG markers through SOS (T.81 B.2)."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("fennec: not a JPEG")
    hdr = JpegHeader()
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xD9:
            break
        seg_len = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + seg_len]
        if marker == 0xDB:  # DQT
            _parse_dqt(seg, hdr)
        elif marker == 0xC4:  # DHT
            _parse_dht(seg, hdr)
        elif marker == 0xDD:  # DRI
            hdr.restart_interval = struct.unpack(">H", seg[:2])[0]
        elif marker in (0xC0, 0xC1):  # SOF0 / SOF1 (baseline)
            _parse_sof(seg, hdr)
        elif marker == 0xC2:
            # Progressive: codecs/progressive.py (decode_jpeg dispatches
            # there before calling parse_jpeg).
            raise UnsupportedFormatError(
                "fennec: progressive JPEG requires the progressive decoder")
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise UnsupportedFormatError(
                f"fennec: unsupported JPEG SOF marker 0x{marker:02X}")
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":  # APP0
            hdr.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe":  # APP14
            # 'Adobe' + version(2) + flags0(2) + flags1(2) + transform(1)
            if len(seg) >= 12:
                hdr.adobe_transform = seg[11]
        elif marker == 0xDA:  # SOS
            _parse_sos(seg, hdr)
            hdr.scan_offset = pos + 2 + seg_len
            return hdr
        pos += 2 + seg_len
    raise ValueError("fennec: corrupt JPEG: no SOS marker")


def _parse_dqt(seg: bytes, hdr: JpegHeader) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 0x0F
        i += 1
        if pq == 0:
            vals = np.frombuffer(seg[i:i + 64], dtype=np.uint8).astype(
                np.int32)
            i += 64
        else:
            vals = np.frombuffer(seg[i:i + 128], dtype=">u2").astype(
                np.int32)
            i += 128
        nat = np.zeros(64, dtype=np.int32)
        nat[dct_ops.ZIGZAG] = vals
        hdr.qtables[tq] = nat


def _parse_dht(seg: bytes, hdr: JpegHeader) -> None:
    i = 0
    while i < len(seg):
        tc, th = seg[i] >> 4, seg[i] & 0x0F
        i += 1
        bits = list(seg[i:i + 16])
        i += 16
        n = sum(bits)
        # T.81 C.2: at most 256 values; a crafted BITS array can claim
        # 16*255 — reject here so the decoder never sees an oversized or
        # truncated spec (Go stdlib errors identically).
        if n > 256:
            raise ValueError("fennec: corrupt JPEG: DHT declares >256 values")
        vals = list(seg[i:i + n])
        if len(vals) < n:
            raise ValueError("fennec: corrupt JPEG: truncated DHT")
        i += n
        if tc == 0:
            hdr.dc_tables[th] = (bits, vals)
        else:
            hdr.ac_tables[th] = (bits, vals)


def _parse_sof(seg: bytes, hdr: JpegHeader) -> None:
    precision, h, w, ncomp = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise UnsupportedFormatError("fennec: only 8-bit JPEG supported")
    hdr.height, hdr.width, hdr.ncomp = h, w, ncomp
    for c in range(ncomp):
        cid, hv, tq = seg[6 + c * 3:9 + c * 3]
        hdr.comps.append({"id": cid, "h": hv >> 4, "v": hv & 0x0F,
                          "tq": tq})


def _parse_sos(seg: bytes, hdr: JpegHeader) -> None:
    ns = seg[0]
    for i in range(ns):
        cs, tables = seg[1 + i * 2], seg[2 + i * 2]
        idx = next((j for j, c in enumerate(hdr.comps) if c["id"] == cs),
                   None)
        if idx is None:
            raise ValueError(
                "fennec: corrupt JPEG: SOS names unknown component")
        hdr.scan_comps.append({"comp": idx, "td": tables >> 4,
                               "ta": tables & 0x0F})


def _build_decode_specs(hdr: JpegHeader):
    """MCU grid geometry + per-scan-component decode specs."""
    hmax = max(c["h"] for c in hdr.comps)
    vmax = max(c["v"] for c in hdr.comps)
    mcus_x = -(-hdr.width // (8 * hmax))
    mcus_y = -(-hdr.height // (8 * vmax))
    specs = []
    for sc in hdr.scan_comps:
        c = hdr.comps[sc["comp"]]
        if sc["td"] not in hdr.dc_tables or sc["ta"] not in hdr.ac_tables:
            raise ValueError(
                "fennec: corrupt JPEG: scan references missing DHT")
        specs.append(DecodeComponentSpec(
            mcus_x * c["h"], mcus_y * c["v"], c["h"], c["v"],
            hdr.dc_tables[sc["td"]], hdr.ac_tables[sc["ta"]]))
    return mcus_x, mcus_y, hmax, vmax, specs


def decode_jpeg_to_coefs(data: bytes):
    """Decode a baseline JPEG to quantized coefficients.

    Returns (hdr, coefs): coefs[i] is an (nblocks, 64) int16 array in
    natural order for component i of the frame; block grids tile the MCU
    lattice.  Handles the common single interleaved scan and multi-scan
    files (one scan per component, as Go's stdlib also decodes), both
    through the C++ scan decoder.
    """
    hdr = parse_jpeg(data)
    mcus_x, mcus_y, hmax, vmax, specs = _build_decode_specs(hdr)
    if len(hdr.scan_comps) != hdr.ncomp:
        return _decode_multiscan_to_coefs(data, hdr, mcus_x, mcus_y,
                                          hmax, vmax)
    coefs, _ = native.jpeg_decode_scan(data, hdr.scan_offset, specs,
                                       hdr.restart_interval)
    return hdr, coefs


def _single_scan_specs(data: bytes, nt: int):
    """(header, decode specs) of a single-scan baseline JPEG whose block
    grid has `nt` blocks, or (header, None) for a multi-scan file.  A
    grid of another size raises ValueError."""
    hdr = parse_jpeg(data)
    if len(hdr.scan_comps) != hdr.ncomp:
        return hdr, None
    specs = _build_decode_specs(hdr)[4]
    got = sum(s.bw * s.bh for s in specs)
    if got != nt:
        raise ValueError(f"fennec: JPEG block grid of {got} blocks, the "
                         f"buffer holds {nt}")
    return hdr, specs


def decode_jpeg_to_coefs_i8(data: bytes, out: np.ndarray,
                            max_exc: int = 16384):
    """Decode a single-scan baseline JPEG straight into `out`, (NT, 64)
    int8 blocks in ZIGZAG order, with |v| > 127 as an exception list of
    image-local offsets into the NT * 64 layout (JAX
    codecs/jpeg.py:470; an offset into a whole chunk would pass int32 at
    about 24 MP x 64 images).  One C++ pass.

    Returns (hdr, exc_idx int32, exc_val int16, largest nonzero zigzag
    extent), or None when this route does not apply: a multi-scan file,
    or data the C++ decoder rejects (corrupt, or more than max_exc
    exceptions).  The caller then decodes with decode_jpeg_to_coefs,
    which raises the precise error."""
    hdr, specs = _single_scan_specs(data, out.shape[0])
    if specs is None:
        return None
    try:
        exc_idx, exc_val, maxk = native.jpeg_decode_scan_i8(
            data, hdr.scan_offset, specs, hdr.restart_interval, out, max_exc)
    except native.ScanRejected:
        return None
    return hdr, exc_idx, exc_val, maxk


def decode_jpeg_to_coefs_coo(data: bytes, out_dc: np.ndarray,
                             out_pos: np.ndarray, out_val: np.ndarray,
                             max_exc: int = 16384):
    """Decode a single-scan baseline JPEG straight into the sparse COO
    layout (JAX codecs/jpeg.py:495): out_dc (NT,) int8, out_pos / out_val
    (NT, R) uint8 / int8, each block's AC nonzeros as (zigzag position,
    value) pairs, position 0 padding; |v| > 127 and the pairs past R ride
    the exception list as image-local offsets into the NT * 64 zigzag
    layout.  One C++ pass.

    Returns (hdr, exc_idx, exc_val, cnt_hist, largest nonzero zigzag
    extent), or None when this route does not apply (as
    decode_jpeg_to_coefs_i8); the caller takes the dense route."""
    hdr, specs = _single_scan_specs(data, out_dc.shape[0])
    if specs is None:
        return None
    try:
        got = native.jpeg_decode_scan_coo(data, hdr.scan_offset, specs,
                                          hdr.restart_interval, out_dc,
                                          out_pos, out_val, max_exc)
    except native.ScanRejected:
        return None
    return (hdr, *got)


def _decode_multiscan_to_coefs(data: bytes, hdr: JpegHeader,
                               mcus_x: int, mcus_y: int,
                               hmax: int, vmax: int):
    """Baseline multi-scan decode: one (or a subset of) component(s) per
    SOS.  Non-interleaved scans cover only the component's own
    ceil(dim/8) block grid (T.81 A.2.2); results land in the MCU-padded
    grids the device reconstruction expects."""
    out = []
    for c in hdr.comps:
        bw, bh = mcus_x * c["h"], mcus_y * c["v"]
        out.append(np.zeros((bw * bh, 64), dtype=np.int16))

    pos = hdr.scan_offset
    scan_comps = hdr.scan_comps
    while True:
        if len(scan_comps) == 1:
            sc = scan_comps[0]
            c = hdr.comps[sc["comp"]]
            comp_w = -(-hdr.width * c["h"] // hmax)
            comp_h = -(-hdr.height * c["v"] // vmax)
            nbw, nbh = -(-comp_w // 8), -(-comp_h // 8)
            spec = DecodeComponentSpec(nbw, nbh, 1, 1,
                                       hdr.dc_tables[sc["td"]],
                                       hdr.ac_tables[sc["ta"]])
            blocks, pos = native.jpeg_decode_scan(
                data, pos, [spec], hdr.restart_interval)
            # Copy the component grid rows into the MCU-padded grid.
            bw = mcus_x * c["h"]
            dst = out[sc["comp"]].reshape(-1, 64)
            src = blocks[0]
            for by in range(nbh):
                dst[by * bw:by * bw + nbw] = src[by * nbw:(by + 1) * nbw]
        else:
            specs = []
            for sc in scan_comps:
                c = hdr.comps[sc["comp"]]
                specs.append(DecodeComponentSpec(
                    mcus_x * c["h"], mcus_y * c["v"], c["h"], c["v"],
                    hdr.dc_tables[sc["td"]], hdr.ac_tables[sc["ta"]]))
            blocks, pos = native.jpeg_decode_scan(
                data, pos, specs, hdr.restart_interval)
            for sc, blk in zip(scan_comps, blocks):
                out[sc["comp"]][:] = blk

        # Advance to the next SOS (tables may appear between scans).
        scan_comps = None
        while pos + 4 <= len(data):
            if data[pos] != 0xFF or data[pos + 1] == 0x00:
                pos += 1
                continue
            marker = data[pos + 1]
            if 0xD0 <= marker <= 0xD7:
                pos += 2
                continue
            if marker == 0xD9:
                break
            seg_len = struct.unpack(">H", data[pos + 2:pos + 4])[0]
            seg = data[pos + 4:pos + 2 + seg_len]
            if marker == 0xC4:
                _parse_dht(seg, hdr)
            elif marker == 0xDB:
                _parse_dqt(seg, hdr)
            elif marker == 0xDD:
                hdr.restart_interval = struct.unpack(">H", seg[:2])[0]
            elif marker == 0xDA:
                hdr.scan_comps = []
                _parse_sos(seg, hdr)
                scan_comps = hdr.scan_comps
                pos = pos + 2 + seg_len
                break
            pos += 2 + seg_len
        if scan_comps is None:
            break
    # Downstream consumers iterate hdr.scan_comps zipped with coefs;
    # normalize to frame order covering every component.
    hdr.scan_comps = [{"comp": i, "td": 0, "ta": 0}
                      for i in range(hdr.ncomp)]
    return hdr, out


def is_progressive_jpeg(data: bytes) -> bool:
    """True when the stream's frame header is SOF2 (progressive DCT)."""
    if len(data) < 4 or data[:2] != b"\xFF\xD8":
        return False
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0x01,) or 0xD0 <= marker <= 0xD9:
            pos += 2
            continue
        if marker == 0xC2:
            return True
        if marker in (0xC0, 0xC1, 0xDA):
            return False
        seg_len = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        pos += 2 + seg_len
    return False


def jpeg_color_mode(hdr: JpegHeader) -> str:
    """Frame color model, following Go stdlib's heuristics (reference
    io.go:82 decodes via image/jpeg, whose reader treats a 3-component
    frame as RGB when the Adobe APP14 transform is 0 or the component IDs
    are 'R','G','B', and a 4-component frame as YCCK when the transform
    is 2, else Adobe-inverted CMYK)."""
    if hdr.ncomp == 1:
        return "gray"
    if hdr.ncomp == 3:
        # Go image/jpeg isRGB: a JFIF APP0 forces YCbCr even with
        # 'R','G','B' component IDs; Adobe transform 0 or RGB IDs
        # (without JFIF) mean RGB.
        ids = [c["id"] for c in hdr.comps]
        if not hdr.jfif and (
                hdr.adobe_transform == 0 or ids == [0x52, 0x47, 0x42]):
            return "rgb"
        return "ycbcr"
    if hdr.ncomp == 4:
        if hdr.adobe_transform is None:
            # Go image/jpeg: "unknown color model: 4-component JPEG" —
            # inventing an interpretation risks silent wrong colors.
            raise UnsupportedFormatError(
                "fennec: 4-component JPEG without Adobe APP14 marker")
        return "ycck" if hdr.adobe_transform == 2 else "cmyk"
    raise UnsupportedFormatError(
        f"fennec: unsupported {hdr.ncomp}-component JPEG")


def decode_jpeg(data: bytes, device: _device.DeviceLike = None,
                orientation: int = 1) -> np.ndarray:
    """Decode a baseline or progressive JPEG to (H, W, 4) uint8 NRGBA,
    the transforms on `device`, upright for the EXIF `orientation` (1-8;
    (W, H, 4) for 5-8: exif.apply_orientation of the stored image, done
    by the device stage's stores).  Handles grayscale, YCbCr, Adobe RGB
    and 4-component Adobe CMYK/YCCK frames."""
    dev = _device.resolve(device)
    if is_progressive_jpeg(data):
        return _decode_progressive(data, dev, orientation)
    with stage("huffman decode"):
        hdr, coefs = decode_jpeg_to_coefs(data)
    hmax = max(c["h"] for c in hdr.comps)
    vmax = max(c["v"] for c in hdr.comps)
    mcus_x = -(-hdr.width // (8 * hmax))
    mcus_y = -(-hdr.height // (8 * vmax))
    comps = []
    for sc in hdr.scan_comps:
        c = hdr.comps[sc["comp"]]
        comps.append(dict(c, bw=mcus_x * c["h"], bh=mcus_y * c["v"]))
    return _reconstruct(comps, hdr.qtables, coefs, hmax, vmax, hdr,
                        dev, orientation)


def _decode_progressive(data: bytes, dev: torch.device,
                        orientation: int = 1) -> np.ndarray:
    from .progressive import decode_progressive_to_coefs

    with stage("huffman decode"):
        dec, coefs = decode_progressive_to_coefs(data)
    return _reconstruct(dec.comps, dec.qtables, coefs, dec.hmax, dec.vmax,
                        dec, dev, orientation)


def _reconstruct(comps, qtables, coefs, hmax: int, vmax: int, frame,
                 dev: torch.device, orientation: int = 1) -> np.ndarray:
    """Quantized coefficients of every component (dicts with h, v, tq,
    bw, bh) → (H, W, 4) uint8 on the host, upright for the EXIF
    `orientation`, the transforms on `dev` (kernel K7 on a card,
    reconstruct_plain on the CPU).  `frame` carries the dimensions and
    colour markers (a JpegHeader or a ProgressiveDecoder).

    Stages: "blocks up" is the blocks' and tables' copy to `dev`;
    "image down" is K7's launch and the copy of its image to the host,
    which waits for K7, so K7's device time falls inside it."""
    for c in comps:
        if c["tq"] not in qtables:
            raise ValueError("fennec: corrupt JPEG: missing DQT")
    mode = jpeg_color_mode(frame)
    tabs = np.stack([qtables[c["tq"]] for c in comps]).astype(np.int32)
    with stage("blocks up"):
        blocks = [torch.from_numpy(q).to(dev) for q in coefs]
        tables = torch.from_numpy(tabs).to(dev)
    with stage("image down"):
        out = decode_recon.frame(
            blocks, tables,
            [(c["h"], c["v"], c["bw"], c["bh"]) for c in comps],
            hmax, vmax, frame.height, frame.width, mode, orientation)
        return out.cpu().numpy()


def reconstruct_plain(blocks, tables, comps, hmax: int, vmax: int, h: int,
                      w: int, mode: str, orientation: int = 1
                      ) -> torch.Tensor:
    """K7's function for one frame in plain torch ops, on the blocks'
    device: component c's quantized blocks and tables[c], comps (h, v, bw,
    bh) each → (h, w, 4) uint8, turned upright for the EXIF `orientation`
    (decode_recon_cuda.orient_plain).  What the CPU runs and what K7 is
    held against on the card."""
    planes = [_decode_plane(q.to(torch.float32), qt, c[3] * 8, c[2] * 8,
                            hmax // c[0], vmax // c[1])
              for c, q, qt in zip(comps, blocks, tables)]
    return orient_plain(_combine_planes(planes, h, w, mode).to(torch.uint8),
                        orientation)


def _decode_plane(qcoefs: torch.Tensor, qtable: torch.Tensor, ph: int,
                  pw: int, rep_x: int, rep_y: int) -> torch.Tensor:
    plane = dct_ops.from_blocks(
        dct_ops.idct2d_blocks(dct_ops.dequantize_blocks(qcoefs, qtable)),
        ph, pw) + 128.0
    if rep_y > 1:
        plane = plane.repeat_interleave(rep_y, dim=0)
    if rep_x > 1:
        plane = plane.repeat_interleave(rep_x, dim=1)
    return plane


def _combine_planes(planes, h: int, w: int, mode: str) -> torch.Tensor:
    crop = [p[:h, :w] for p in planes]
    if mode == "gray":
        y = torch.clamp(torch.floor(crop[0] + 0.5), 0, 255)
        rgb = torch.stack([y, y, y], dim=-1)
    elif mode == "rgb":
        rgb = clamp_u8(torch.stack(crop[:3], dim=-1))
    elif mode in ("cmyk", "ycck"):
        # Adobe 4-component frames store INVERTED ink values; Go stdlib
        # inverts all four planes into image.CMYK and color.CMYKToRGB
        # then computes r = (255-C)(255-K)/255 — the two inversions
        # cancel, leaving rgb = base * k_raw / 255 (floor division on
        # uint8-rounded planes) with base = the raw CMY samples (cmyk)
        # or the YCbCr→RGB conversion of the first three planes (ycck).
        if mode == "ycck":
            base = clamp_u8(ycbcr_to_rgb(torch.stack(crop[:3], dim=-1)))
        else:
            base = clamp_u8(torch.stack(crop[:3], dim=-1))
        k = clamp_u8(crop[3])[..., None]
        # Integer division keeps Go's exact x*k/255 semantics (a float
        # divide can land at 254.9999 and floor one unit low).
        rgb = torch.div(base.to(torch.int32) * k.to(torch.int32), 255,
                        rounding_mode="floor").to(torch.float32)
    else:  # ycbcr
        rgb = clamp_u8(ycbcr_to_rgb(torch.stack(crop[:3], dim=-1)))
    alpha = torch.full((h, w, 1), 255.0, dtype=torch.float32,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)
