"""Progressive JPEG (SOF2) decoding — host entropy layer.

A jax-free copy of fennec_tpu/codecs/progressive.py with its imports
rewritten.  Spectral-selection + successive-approximation scan decoding
per ITU T.81 G.2.  Output is the same quantized-coefficient
representation as the baseline decoder, so the device reconstruction
(dequant → IDCT → upsample → YCbCr→RGB) is shared with codecs/jpeg.py.

Each scan goes through the C++ decoder (native.py); a scan it rejects as
corrupt is rerun by the Python scan decoder below from the same state,
as in the JAX package, so the two packages agree on damaged files too.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from ..ops.dct import ZIGZAG
from ..types import UnsupportedFormatError
from .entropy_py import BitReader, _decode_huffman, _extend, build_decode_table


class ProgressiveDecoder:
    """Accumulates coefficients across the scans of one SOF2 image."""

    def __init__(self, data: bytes):
        self.data = data
        self.width = 0
        self.height = 0
        self.comps: List[dict] = []
        self.qtables: Dict[int, np.ndarray] = {}
        self.dc_specs: Dict[int, tuple] = {}
        self.ac_specs: Dict[int, tuple] = {}
        self.restart_interval = 0
        self.coefs: List[np.ndarray] = []
        self.eobrun = 0
        self.ncomp = 0
        # Adobe APP14 color transform, as in JpegHeader: None = no
        # marker; 0 = none (RGB/CMYK); 1 = YCbCr; 2 = YCCK.
        self.adobe_transform: "int | None" = None
        self.jfif = False  # APP0 'JFIF' seen (forces YCbCr, like Go)

    # ── Marker loop ─────────────────────────────────────────────────────

    def decode(self):
        data = self.data
        if data[:2] != b"\xFF\xD8":
            raise ValueError("fennec: not a JPEG")
        pos = 2
        while pos + 4 <= len(data):
            if data[pos] != 0xFF:
                pos += 1
                continue
            marker = data[pos + 1]
            if marker == 0xFF:
                pos += 1
                continue
            if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
                pos += 2
                continue
            if marker == 0xD9:
                break
            seg_len = struct.unpack(">H", data[pos + 2:pos + 4])[0]
            seg = data[pos + 4:pos + 2 + seg_len]
            nxt = pos + 2 + seg_len
            if marker == 0xDB:
                self._dqt(seg)
            elif marker == 0xC4:
                self._dht(seg)
            elif marker == 0xDD:
                self.restart_interval = struct.unpack(">H", seg[:2])[0]
            elif marker == 0xE0 and seg[:5] == b"JFIF\x00":  # APP0
                self.jfif = True
            elif marker == 0xEE and seg[:5] == b"Adobe":  # APP14
                if len(seg) >= 12:
                    self.adobe_transform = seg[11]
            elif marker == 0xC2:
                self._sof(seg)
            elif marker in (0xC0, 0xC1):
                raise ValueError("fennec: baseline JPEG fed to the "
                                 "progressive decoder")
            elif marker == 0xDA:
                nxt = self._scan(seg, nxt)
            pos = nxt
        return self

    def _dqt(self, seg: bytes) -> None:
        i = 0
        while i < len(seg):
            pq, tq = seg[i] >> 4, seg[i] & 0x0F
            i += 1
            if pq == 0:
                vals = np.frombuffer(seg[i:i + 64], np.uint8).astype(np.int32)
                i += 64
            else:
                vals = np.frombuffer(seg[i:i + 128], ">u2").astype(np.int32)
                i += 128
            nat = np.zeros(64, dtype=np.int32)
            nat[ZIGZAG] = vals
            self.qtables[tq] = nat

    def _dht(self, seg: bytes) -> None:
        i = 0
        while i < len(seg):
            tc, th = seg[i] >> 4, seg[i] & 0x0F
            i += 1
            bits = list(seg[i:i + 16])
            i += 16
            n = sum(bits)
            if n > 256:  # T.81 C.2 bound; see codecs/jpeg._parse_dht
                raise ValueError(
                    "fennec: corrupt JPEG: DHT declares >256 values")
            vals = list(seg[i:i + n])
            if len(vals) < n:
                raise ValueError("fennec: corrupt JPEG: truncated DHT")
            i += n
            if tc == 0:
                self.dc_specs[th] = (bits, vals)
            else:
                self.ac_specs[th] = (bits, vals)

    def _sof(self, seg: bytes) -> None:
        precision, h, w, ncomp = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise UnsupportedFormatError("fennec: only 8-bit JPEG supported")
        self.height, self.width = h, w
        self.ncomp = ncomp
        for c in range(ncomp):
            cid, hv, tq = seg[6 + c * 3:9 + c * 3]
            self.comps.append({"id": cid, "h": hv >> 4, "v": hv & 0x0F,
                               "tq": tq})
        hmax = max(c["h"] for c in self.comps)
        vmax = max(c["v"] for c in self.comps)
        self.mcus_x = -(-w // (8 * hmax))
        self.mcus_y = -(-h // (8 * vmax))
        self.hmax, self.vmax = hmax, vmax
        for c in self.comps:
            bw, bh = self.mcus_x * c["h"], self.mcus_y * c["v"]
            c["bw"], c["bh"] = bw, bh
            # Non-interleaved scans cover only the component's own blocks:
            # ceil(ceil(dim * sampling / max_sampling) / 8)  (T.81 A.1.1).
            comp_w = -(-w * c["h"] // hmax)
            comp_h = -(-h * c["v"] // vmax)
            c["nbw"] = -(-comp_w // 8)
            c["nbh"] = -(-comp_h // 8)
            self.coefs.append(np.zeros((bw * bh, 64), dtype=np.int32))

    # ── Scan decoding ───────────────────────────────────────────────────

    def _scan(self, seg: bytes, pos: int) -> int:
        ns = seg[0]
        scomps = []
        for i in range(ns):
            cs, tables = seg[1 + i * 2], seg[2 + i * 2]
            idx = next((j for j, c in enumerate(self.comps)
                        if c["id"] == cs), None)
            if idx is None:
                raise ValueError(
                    "fennec: corrupt JPEG: SOS names unknown component")
            scomps.append({"comp": idx, "td": tables >> 4,
                           "ta": tables & 0x0F})
        ss, se, a = seg[1 + ns * 2], seg[2 + ns * 2], seg[3 + ns * 2]
        ah, al = a >> 4, a & 0x0F
        if ss > 0 and ns != 1:
            # T.81 G.1.1.1.1: progressive AC scans are single-component;
            # decoding scomps[0] against an interleaved stream would
            # silently desynchronize.
            raise ValueError(
                "fennec: corrupt JPEG: interleaved progressive AC scan")

        end = self._scan_native(scomps, ss, se, ah, al, pos)
        if end is None:
            r = BitReader(self.data, pos)
            self.eobrun = 0
            if ss == 0:
                self._dc_scan(r, scomps, ah, al)
            else:
                self._ac_scan(r, scomps[0], ss, se, ah, al)
            end = r.pos
        return self._resync(end)

    def _scan_native(self, scomps, ss, se, ah, al, pos):
        """C++ decoder for one scan; None → use the Python decoder."""
        from .. import native

        try:
            dc_specs = None
            ac_spec = None
            if ss == 0 and ah == 0:
                dc_specs = [self.dc_specs[sc["td"]] for sc in scomps]
            if ss > 0:
                ac_spec = self.ac_specs[scomps[0]["ta"]]
        except KeyError:
            return None  # missing table: let the Python path raise
        cs = [self.comps[sc["comp"]] for sc in scomps]
        try:
            return native.jpeg_decode_progressive_scan(
                self.data, pos, [self.coefs[sc["comp"]] for sc in scomps],
                [c["bw"] for c in cs], [c["h"] for c in cs],
                [c["v"] for c in cs], self.mcus_x, self.mcus_y,
                [c["nbw"] for c in cs], [c["nbh"] for c in cs],
                ss, se, ah, al, dc_specs, ac_spec, self.restart_interval)
        except ValueError:
            return None  # corrupt scan: the coefs are untouched

    def _resync(self, p: int) -> int:
        """Advance from byte offset p to the next real marker."""
        while p + 1 < len(self.data):
            if self.data[p] == 0xFF and self.data[p + 1] != 0x00 and \
                    not (0xD0 <= self.data[p + 1] <= 0xD7):
                return p
            p += 1
        return len(self.data)

    def _restart(self, r: BitReader, preds: List[int]) -> None:
        r.align_to_marker()
        for i in range(len(preds)):
            preds[i] = 0
        self.eobrun = 0

    def _dc_scan(self, r: BitReader, scomps, ah: int, al: int) -> None:
        tables = {}
        for sc in scomps:
            if ah == 0:
                tables[sc["comp"]] = build_decode_table(
                    *self.dc_specs[sc["td"]])
        preds = [0] * len(scomps)
        mcu_count = 0
        interleaved = len(scomps) > 1
        if interleaved:
            mx, my = self.mcus_x, self.mcus_y
        else:
            c = self.comps[scomps[0]["comp"]]
            mx, my = c["nbw"], c["nbh"]
        for m_y in range(my):
            for m_x in range(mx):
                if self.restart_interval and \
                        mcu_count == self.restart_interval:
                    self._restart(r, preds)
                    mcu_count = 0
                for si, sc in enumerate(scomps):
                    c = self.comps[sc["comp"]]
                    arr = self.coefs[sc["comp"]]
                    reps = [(dy, dx) for dy in range(c["v"])
                            for dx in range(c["h"])] if interleaved \
                        else [(0, 0)]
                    for dy, dx in reps:
                        if interleaved:
                            by, bx = m_y * c["v"] + dy, m_x * c["h"] + dx
                        else:
                            by, bx = m_y, m_x
                        bi = by * c["bw"] + bx
                        if ah == 0:
                            size = _decode_huffman(r, tables[sc["comp"]])
                            diff = _extend(r.read_bits(size), size)
                            preds[si] += diff
                            arr[bi, 0] = preds[si] << al
                        else:
                            if r.read_bit():
                                arr[bi, 0] |= (1 << al)
                mcu_count += 1

    def _ac_scan(self, r: BitReader, sc, ss: int, se: int,
                 ah: int, al: int) -> None:
        c = self.comps[sc["comp"]]
        arr = self.coefs[sc["comp"]]
        table = build_decode_table(*self.ac_specs[sc["ta"]])
        zz = ZIGZAG
        nbw, nbh = c["nbw"], c["nbh"]
        mcu_count = 0
        for by in range(nbh):
            for bx in range(nbw):
                if self.restart_interval and \
                        mcu_count == self.restart_interval:
                    r.align_to_marker()
                    self.eobrun = 0
                    mcu_count = 0
                bi = by * c["bw"] + bx
                if ah == 0:
                    self._ac_first(r, arr, bi, ss, se, al, table, zz)
                else:
                    self._ac_refine(r, arr, bi, ss, se, al, table, zz)
                mcu_count += 1

    def _ac_first(self, r, arr, bi, ss, se, al, table, zz) -> None:
        if self.eobrun > 0:
            self.eobrun -= 1
            return
        k = ss
        while k <= se:
            rs = _decode_huffman(r, table)
            run, size = rs >> 4, rs & 0x0F
            if size == 0:
                if run < 15:
                    self.eobrun = (1 << run) - 1
                    if run:
                        self.eobrun += r.read_bits(run)
                    return
                k += 16  # ZRL
                continue
            k += run
            if k > se:
                return
            arr[bi, zz[k]] = _extend(r.read_bits(size), size) << al
            k += 1

    def _ac_refine(self, r, arr, bi, ss, se, al, table, zz) -> None:
        plus1 = 1 << al
        minus1 = -1 << al
        k = ss
        if self.eobrun <= 0:
            while k <= se:
                rs = _decode_huffman(r, table)
                run, size = rs >> 4, rs & 0x0F
                value = 0
                if size == 0:
                    if run < 15:
                        self.eobrun = (1 << run)
                        if run:
                            self.eobrun += r.read_bits(run)
                        break
                    # ZRL: skip 16 zero-history coefficients
                else:
                    value = plus1 if r.read_bit() else minus1
                # Advance over `run` zero-history coefficients, applying
                # correction bits to nonzero-history ones on the way.
                while k <= se:
                    if arr[bi, zz[k]] != 0:
                        if r.read_bit() and (arr[bi, zz[k]] & plus1) == 0:
                            if arr[bi, zz[k]] >= 0:
                                arr[bi, zz[k]] += plus1
                            else:
                                arr[bi, zz[k]] += minus1
                    else:
                        if run == 0:
                            if value != 0:
                                arr[bi, zz[k]] = value
                            k += 1
                            break
                        run -= 1
                    k += 1
        if self.eobrun > 0:
            # Correction bits for the remainder of the band.
            while k <= se:
                if arr[bi, zz[k]] != 0:
                    if r.read_bit() and (arr[bi, zz[k]] & plus1) == 0:
                        if arr[bi, zz[k]] >= 0:
                            arr[bi, zz[k]] += plus1
                        else:
                            arr[bi, zz[k]] += minus1
                k += 1
            self.eobrun -= 1


def decode_progressive_to_coefs(data: bytes):
    """Decode an SOF2 JPEG to (decoder, coefs) with the same coefficient
    layout as the baseline path."""
    dec = ProgressiveDecoder(data).decode()
    return dec, [c.astype(np.int16) for c in dec.coefs]
