"""Baseline JPEG files for the benchmark, written and read apart from the
program under test.

write() codes the levels of plain.forward / plain.quantize as a baseline
4:2:0 JFIF with the standard Huffman tables (Annex K.3), optionally with
an EXIF orientation, entirely in vectorised torch ops on the levels'
device.  read() parses a baseline file (any sampling factors, any
Huffman tables) and decodes its levels in plain Python with a 16-bit
lookup per symbol: it is the reference's view of what a coded file
holds.
"""

from __future__ import annotations

import struct
from array import array
from typing import Dict, List, Optional

import numpy as np
import torch

from . import plain

DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def canonical_codes(bits, vals) -> Dict[int, tuple]:
    """{symbol: (code, length)} of a table given as BITS and HUFFVAL
    (Annex C)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _segment(marker: int, payload: bytes = b"") -> bytes:
    if not payload:
        return bytes([0xFF, marker])
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def exif_orientation(orientation: int) -> bytes:
    """An APP1 segment holding an EXIF IFD0 with one Orientation tag."""
    tiff = (b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(">I", 0))
    return _segment(0xE1, b"Exif\x00\x00" + tiff)


def _headers(w: int, h: int, quality: int,
             orientation: Optional[int]) -> bytes:
    tables = plain.quality_table(quality).reshape(2, 64)
    dqt = b"".join(bytes([t]) + bytes(int(tables[t, z]) for z in plain.ZIGZAG)
                   for t in (0, 1))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1,
                                                    3, 0x11, 1])
    dht = b"".join(bytes([cls]) + bytes(bits) + bytes(vals)
                   for cls, (bits, vals) in ((0x00, DC_LUMA), (0x10, AC_LUMA),
                                             (0x01, DC_CHROMA),
                                             (0x11, AC_CHROMA)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (_segment(0xD8)
            + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + (exif_orientation(orientation) if orientation else b"")
            + _segment(0xDB, dqt) + _segment(0xC0, sof) + _segment(0xC4, dht)
            + _segment(0xDA, sos))


def _code_tensors(device):
    """(2, 256) code and length tensors of the DC and AC tables, [luma,
    chroma]."""
    out = []
    for tabs in ((DC_LUMA, DC_CHROMA), (AC_LUMA, AC_CHROMA)):
        code = torch.zeros((2, 256), dtype=torch.int64)
        length = torch.zeros((2, 256), dtype=torch.int64)
        for t, (bits, vals) in enumerate(tabs):
            for sym, (c, n) in canonical_codes(bits, vals).items():
                code[t, sym], length[t, sym] = c, n
        out += [code.to(device), length.to(device)]
    return out


def _size(v: torch.Tensor) -> torch.Tensor:
    """JPEG's magnitude category: the bit length of |v|."""
    a = v.abs()
    s = torch.zeros_like(a)
    while bool((a > 0).any()):
        s += (a > 0).to(s.dtype)
        a = a >> 1
    return s


def _magnitude(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, v + (1 << s) - 1)


def _mcu_blocks(levels):
    """4:2:0 level planes (y, cb, cr) → (N, 64) zigzag blocks in MCU order
    (Y00 Y01 Y10 Y11 Cb Cr) and each block's table (0 luma, 1 chroma) and
    component."""
    y, cb, cr = levels
    mh, mw = cb.shape[0], cb.shape[1]
    yb = y.reshape(mh, 2, mw, 2, 64).permute(0, 2, 1, 3, 4).reshape(-1, 4, 64)
    blocks = torch.cat([yb, cb.reshape(-1, 1, 64), cr.reshape(-1, 1, 64)],
                       dim=1).reshape(-1, 64)
    zz = torch.tensor(plain.ZIGZAG, device=blocks.device)
    comp = torch.tensor([0, 0, 0, 0, 1, 2],
                        device=blocks.device).repeat(mh * mw)
    return blocks[:, zz], (comp > 0).to(torch.int64), comp


def scan_bytes(levels) -> bytes:
    """The entropy-coded scan of 4:2:0 levels (y, cb, cr), each (BH, BW,
    8, 8) int64, with the standard tables, byte-stuffed."""
    dev = levels[0].device
    zz, table, comp = _mcu_blocks([lv.reshape(*lv.shape[:2], 64)
                                   for lv in levels])
    n = zz.shape[0]
    dc_code, dc_len, ac_code, ac_len = _code_tensors(dev)
    # DC: the difference from the previous block of the same component.
    dc = zz[:, 0]
    diff = torch.empty_like(dc)
    for c in range(3):
        idx = (comp == c).nonzero().squeeze(1)
        d = dc[idx]
        diff[idx] = d - torch.cat([d.new_zeros(1), d[:-1]])
    s = _size(diff)
    val = (dc_code[table, s] << s) | _magnitude(diff, s)
    fields = [val]
    lens = [dc_len[table, s] + s]
    # AC: each nonzero with the zero run before it (ZRLs for runs of 16).
    ac = zz[:, 1:]
    nz = ac != 0
    pos = torch.arange(1, 64, device=dev).expand(n, 63)
    last = torch.cummax(torch.where(nz, pos, torch.zeros_like(pos)),
                        dim=1).values
    prev = torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], dim=1)
    run = pos - prev - 1
    s = _size(ac)
    sym = (run % 16) * 16 + s
    tab = table[:, None].expand(n, 63)
    zrl_code, zrl_len = ac_code[tab, 0xF0], ac_len[tab, 0xF0]
    val = torch.zeros_like(ac)
    length = torch.zeros_like(ac)
    for i in range(3):
        has = run >= 16 * (i + 1)
        val = torch.where(has, (val << zrl_len) | zrl_code, val)
        length = torch.where(has, length + zrl_len, length)
    val = (((val << ac_len[tab, sym]) | ac_code[tab, sym]) << s) \
        | _magnitude(ac, s)
    length = length + ac_len[tab, sym] + s
    fields.append(torch.where(nz, val, torch.zeros_like(val)))
    lens.append(torch.where(nz, length, torch.zeros_like(length)))
    eob = last[:, -1] < 63
    fields.append(torch.where(eob, ac_code[table, 0], 0))
    lens.append(torch.where(eob, ac_len[table, 0], 0))
    vals = torch.cat([fields[0][:, None], fields[1], fields[2][:, None]],
                     dim=1).reshape(-1)
    lengths = torch.cat([lens[0][:, None], lens[1], lens[2][:, None]],
                        dim=1).reshape(-1)
    keep = lengths > 0
    vals, lengths = vals[keep], lengths[keep]
    offs = torch.cumsum(lengths, 0) - lengths
    total = int(lengths.sum())
    bits = torch.ones(total + (-total) % 8, dtype=torch.uint8, device=dev)
    for j in range(int(lengths.max())):
        m = lengths > j
        bits[offs[m] + j] = ((vals[m] >> (lengths[m] - 1 - j)) & 1).to(
            torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev,
                           dtype=torch.int64)
    data = (bits.reshape(-1, 8).to(torch.int64) * weights).sum(1)
    reps = 1 + (data == 0xFF).to(torch.int64)
    out = torch.repeat_interleave(data, reps)
    stuffed = torch.cumsum(reps, 0)[reps == 2] - 1
    out[stuffed] = 0
    return out.to(torch.uint8).cpu().numpy().tobytes()


def write(levels, w: int, h: int, quality: int,
          orientation: Optional[int] = None) -> bytes:
    """A baseline 4:2:0 JFIF of levels quantized at `quality`."""
    return _headers(w, h, quality, orientation) + scan_bytes(levels) \
        + _segment(0xD9)


# ── Reading ─────────────────────────────────────────────────────────────────


class JpegFile:
    """What read() finds in a baseline file: width, height, components
    (id, h, v, tq) in frame order, quantization tables {tq: (64,) natural
    order}, the EXIF orientation (1 without one) and each component's
    levels, (BH, BW, 64) int64 in natural order."""

    def __init__(self) -> None:
        self.width = self.height = 0
        self.comps: List[tuple] = []
        self.qtables: Dict[int, np.ndarray] = {}
        self.orientation = 1
        self.levels: List[np.ndarray] = []


def _lookup(bits, vals) -> list:
    """65536 entries: for each 16-bit window, (symbol << 5) | code length
    of the code it starts with, -1 where none does."""
    lut = np.full(1 << 16, -1, dtype=np.int64)
    for sym, (code, n) in canonical_codes(bits, vals).items():
        lut[code << (16 - n):(code + 1) << (16 - n)] = (sym << 5) | n
    return lut.tolist()


def _orientation(payload: bytes) -> Optional[int]:
    if payload[:6] != b"Exif\x00\x00":
        return None
    tiff = payload[6:]
    end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if end is None:
        return None
    ifd = struct.unpack(end + "I", tiff[4:8])[0]
    count = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
    for i in range(count):
        tag, typ, _, val = struct.unpack(end + "HHIH",
                                         tiff[ifd + 2 + 12 * i:
                                              ifd + 12 + 12 * i])
        if tag == 0x0112 and typ == 3:
            return val
    return None


def read(data: bytes) -> JpegFile:
    """Parse and decode a baseline sequential JPEG.  Raises ValueError on
    anything else or on a scan that does not decode to its end."""
    f = JpegFile()
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    dc, ac, pos, scan = {}, {}, 2, None
    while scan is None:
        if data[pos] != 0xFF:
            raise ValueError("bad marker")
        marker = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                if seg[i] >> 4:
                    raise ValueError("16-bit quantization table")
                zz = np.frombuffer(seg[i + 1:i + 65], dtype=np.uint8)
                nat = np.zeros(64, np.int64)
                nat[list(plain.ZIGZAG)] = zz
                f.qtables[seg[i] & 15] = nat
                i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                bits = list(seg[i + 1:i + 17])
                vals = list(seg[i + 17:i + 17 + sum(bits)])
                (ac if seg[i] >> 4 else dc)[seg[i] & 15] = _lookup(bits, vals)
                i += 17 + sum(bits)
        elif marker == 0xC0:
            f.height, f.width = struct.unpack(">HH", seg[1:5])
            f.comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                        seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                       for c in range(seg[5])]
        elif marker == 0xE1:
            o = _orientation(seg)
            if o is not None:
                f.orientation = o
        elif marker == 0xDA:
            ids = [c[0] for c in f.comps]
            scan = [(ids.index(seg[1 + 2 * k]), seg[2 + 2 * k] >> 4,
                     seg[2 + 2 * k] & 15) for k in range(seg[0])]
        elif marker in (0xC1, 0xC2, 0xC3, 0xDD) or 0xC5 <= marker <= 0xCF:
            raise ValueError(f"unsupported frame marker {marker:#x}")
    if [s[0] for s in scan] != list(range(len(f.comps))):
        raise ValueError("not one interleaved scan of every component")
    raw = np.frombuffer(data, dtype=np.uint8)[pos:]
    ff = np.flatnonzero(raw[:-1] == 0xFF)
    ends = ff[raw[ff + 1] != 0]
    if not len(ends) or raw[ends[0] + 1] != 0xD9 or ends[0] + 2 != len(raw):
        raise ValueError("the scan does not end at EOI")
    body = np.delete(raw[:ends[0]], ff[raw[ff + 1] == 0] + 1)
    _decode(f, body, [(dc[td], ac[ta]) for _, td, ta in scan])
    return f


def _decode(f: JpegFile, body: np.ndarray, luts) -> None:
    hmax = max(c[1] for c in f.comps)
    vmax = max(c[2] for c in f.comps)
    mx = -(-f.width // (8 * hmax))
    my = -(-f.height // (8 * vmax))
    total = len(body) * 8
    bits = np.concatenate([np.unpackbits(body), np.ones(32, np.uint8)])
    win = np.zeros(total + 16, dtype=np.uint16)
    for j in range(16):
        win |= bits[j:j + total + 16].astype(np.uint16) << (15 - j)
    win = memoryview(win)
    zz = plain.ZIGZAG
    grids = [(my * vs, mx * hs) for (_, hs, vs, _) in f.comps]
    # One MCU: (component, its tables, and its block's offset as
    # row * a + col * b + c in the component's (BH, BW, 64) levels).
    layout = [(c, luts[c][0], luts[c][1], vs * gw * 64, hs * 64,
               (dy * gw + dx) * 64)
              for c, ((_, hs, vs, _), (_, gw)) in enumerate(zip(f.comps,
                                                                grids))
              for dy in range(vs) for dx in range(hs)]
    out = [array("q", bytes(8 * 64 * gh * gw)) for gh, gw in grids]
    preds = [0] * len(f.comps)
    p = 0
    for row in range(my):
        for col in range(mx):
            for c, dl, al, a, b, off in layout:
                blk = out[c]
                base = row * a + col * b + off
                e = dl[win[p]]
                if e < 0:
                    raise ValueError("bad DC code")
                p += e & 31
                s = e >> 5
                if s:
                    v = win[p] >> (16 - s)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    preds[c] += v
                blk[base] = preds[c]
                k = 1
                while k < 64:
                    e = al[win[p]]
                    if e < 0:
                        raise ValueError("bad AC code")
                    p += e & 31
                    rs = e >> 5
                    s = rs & 15
                    if not s:
                        if rs != 0xF0:
                            break
                        k += 16
                        continue
                    k += rs >> 4
                    if k > 63:
                        raise ValueError("AC run past the block")
                    v = win[p] >> (16 - s)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    blk[base + zz[k]] = v
                    k += 1
    if p > total:
        raise ValueError("the scan ends inside its last code")
    f.levels = [np.frombuffer(o, dtype=np.int64).reshape(gh, gw, 64)
                for o, (gh, gw) in zip(out, grids)]
