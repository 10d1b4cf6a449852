"""Kernel K9: the entropy decode of a single-scan baseline JPEG on the
device in CUDA C++ (csrc/huffman_decode.cu), and its wrapper.

Replaces no TPU kernel: the JAX package decodes scans on the host
(fennec_tpu/native/entropy.cpp:498), as the port did before K9.  At first
use on a CUDA device the source is compiled with nvcc for sm_90a into
fennec_tpu_torch/_build/ and loaded with ctypes, as K1-K8 are.

huffman_decode.decode(data, offset, specs, mcus_x, mcus_y,
restart_interval, device) prepares the scan on the host
(ops/huffman_decode: the tables; the restart intervals, where the scan has
them, else the card finds its one interval), writes it into a pinned
staging buffer the calling thread keeps and reuses, copies it up in one
copy on the device's current stream, launches the chain (the stuffed
zeros counted, their prefix, the unstuff, the sync rounds, the scan, the
write) and copies the flag into a pinned word, without synchronising.  It
returns a Decoded: each component's (bw * bh, 64) int16 blocks on the
device, and `flag()`, read once the stream has passed the copy (after the
caller's own download, which synchronises): 0 when the blocks are
native.jpeg_decode_scan's, bit for bit.  It returns None, and decodes
nothing, where the scan goes to the host decoder: tables or markers the
host decoder must judge (fallbacks["corrupt"]), or a geometry K9 does not
take (no count).  A Decoded whose flag is set counts, when read, as
fallbacks["no_sync"] where the sync did not converge (which the launches'
bound rules out) and as fallbacks["corrupt"] otherwise: the scan itself is
malformed.  codecs/jpeg.decode_jpeg leaves frames of fewer than MIN_BLOCKS
blocks to the host decoder and counts them as fallbacks["small"].
`launches` counts the chains launched.  K9 runs only on a CUDA device;
the CPU keeps the host decoder, and the plain model
(ops/huffman_decode.decode_scan) is its yardstick in the tests.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import huffman_decode as plain
from .jpeg_emit_cuda import BUILD_DIR, NVCC_FLAGS, _Counted, _stream
from .ssim_cuda import compile_library, is_current

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "huffman_decode.cu")
_SO = os.path.join(BUILD_DIR, "libhuffman_decode.so")
# Frames with fewer blocks decode on the host: K9's chain costs the card
# ~0.4 ms however small the frame.  One sweep of decode_jpeg through both
# routes on an H100 put the crossover between 1 536 and 4 704 blocks; no
# benchmark cell decodes a frame below it, so the threshold is not settled
# (PERF.md, K9).
MIN_BLOCKS = 3072
PAD = 16  # zero bytes past the unstuffed data (csrc kPad)
# The descriptor's fields, in the order of csrc's enum Desc.
DESC = (["scan", "scan_len", "spans", "span", "end_byte", "device_layout",
         "total_blocks", "seg_start", "seg_end", "seg_first_block",
         "seg_blocks", "seg_first_sub", "nseg", "nsub", "nsub_max",
         "sub_bits", "lut", "maxcode", "delta", "vals", "ucomp", "udy", "udx",
         "ncomp", "bpm", "mcus_x", "changed", "flag"]
        + [f"comp_{a}{c}" for a in ("h", "v", "bw")
           for c in range(plain.MAX_COMPS)]
        + ["bits", "start", "exits0", "exits1", "count", "dcsum", "first",
           "pred", "ck"])
# The staged header's int32 words; the sync's round counters follow it.
HEADER = ["flag", "end_byte", "nsub"]


def _align(n: int) -> int:
    return (n + 15) & ~15


class Plan(NamedTuple):
    """Byte offsets of the staged sections and of the workspace's."""

    staged: dict
    staged_bytes: int
    work: dict
    work_bytes: int


def plan(lay: plain.Layout, ncomp: int) -> Plan:
    """Where each part of a scan's staged buffer and workspace lies, every
    part 16-byte aligned.  The staged header's int32 words are HEADER's:
    the flag, the first marker's byte and the subsequences; then a round
    counter for each of the sync's launches."""
    nt, nseg, nsub = 2 * ncomp, lay.nseg, lay.nsub
    spans = -(-len(lay.scan) // plain.SPAN)
    parts = [("header", 4 * len(HEADER)),
             ("changed", 4 * plain.launches(nsub)),
             ("lut", nt * (2 << plain.LUT_BITS)), ("maxcode", nt * 68),
             ("delta", nt * 68), ("vals", nt * 256),
             ("ucomp", plain.MAX_BPM), ("udy", plain.MAX_BPM),
             ("udx", plain.MAX_BPM), ("seg_start", 4 * nseg),
             ("seg_end", 4 * nseg), ("seg_first_block", 4 * nseg),
             ("seg_blocks", 4 * nseg), ("seg_first_sub", 4 * (nseg + 1)),
             ("scan", len(lay.scan))]
    work = [("bits", len(lay.scan) + PAD), ("span", 4 * (spans + 1)),
            ("start", 8 * nsub), ("exits0", 8 * nsub), ("exits1", 8 * nsub),
            ("count", 4 * nsub), ("dcsum", 16 * nsub), ("first", 4 * nsub),
            ("pred", 16 * nsub), ("ck", 32 * plain.CHECKS * nsub)]
    out = []
    for spec in (parts, work):
        offs, pos = {}, 0
        for name, nbytes in spec:
            offs[name] = pos
            pos += _align(nbytes)
        out += [offs, pos]
    return Plan(*out)


def descriptor(lay: plain.Layout, geo: plain.Geometry, pl: Plan,
               on_device: bool) -> np.ndarray:
    """The kernel's int64 descriptor of a planned scan; on_device: the card
    finds the scan's one interval (plain.device_layout)."""
    vals = dict(pl.staged)
    vals.update(pl.work)
    head = pl.staged["header"]
    vals.update(scan_len=len(lay.scan),
                spans=-(-len(lay.scan) // plain.SPAN),
                device_layout=int(on_device), total_blocks=geo.blocks,
                nseg=lay.nseg, nsub_max=lay.nsub, sub_bits=lay.sub_bits,
                ncomp=len(geo.comps), bpm=geo.bpm, mcus_x=geo.mcus_x,
                **{name: head + 4 * HEADER.index(name)
                   for name in ("flag", "end_byte", "nsub")})
    for c in range(plain.MAX_COMPS):
        h, v, bw, _ = geo.comps[c] if c < len(geo.comps) else (0, 0, 0, 0)
        vals.update({f"comp_h{c}": h, f"comp_v{c}": v, f"comp_bw{c}": bw})
    return np.array([vals[name] for name in DESC], np.int64)


def fill(buf: np.ndarray, lay: plain.Layout, geo: plain.Geometry, tabs,
         pl: Plan) -> None:
    """Write a scan's staged buffer into buf (uint8): the header (counters
    and flag zeroed, the first marker at the bytes' end until the card
    finds it, the subsequences), tables, the MCU's blocks, the intervals
    and the bytes."""
    o = pl.staged

    def put(name, arr):
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        buf[o[name]:o[name] + raw.size] = raw

    put("header", np.array([0, len(lay.scan), lay.nsub], np.int32))
    put("changed", np.zeros(plain.launches(lay.nsub), np.int32))
    pairs = [t for pair in tabs for t in pair]
    put("lut", np.concatenate([t.lut for t in pairs]))
    put("maxcode", np.concatenate([t.maxcode for t in pairs]))
    put("delta", np.concatenate([t.delta for t in pairs]))
    put("vals", np.concatenate([t.vals for t in pairs]))
    for name in ("ucomp", "udy", "udx"):
        put(name, np.array(getattr(geo, "u_" + name[1:]), np.uint8))
    for name in ("seg_start", "seg_end", "seg_first_block", "seg_blocks",
                 "seg_first_sub", "scan"):
        put(name, getattr(lay, name))


class Decoded:
    """K9's blocks and its flag.  `read` gives the flag once the stream
    has passed its copy (waiting for that copy, which the caller's
    download has done); flag() reads it once and counts a set flag as a
    fallback.  On the card the flag lies in the calling thread's one
    pinned word: read it before that thread's next decode."""

    def __init__(self, blocks: List[torch.Tensor], owner, read) -> None:
        self.blocks = blocks
        self._owner = owner
        self._read = read
        self._flag = None

    def flag(self) -> int:
        if self._flag is None:
            self._flag = int(self._read())
            if self._flag:
                self._owner.count_fallback(
                    "no_sync" if self._flag & plain.NO_SYNC else "corrupt")
        return self._flag


class _Staging(threading.local):
    """The calling thread's pinned staging buffer (its numpy view), the
    event after its last copy up, and its pinned flag word."""

    def __init__(self) -> None:
        self.pinned = None
        self.array = None
        self.copied = None
        self.word = None


class HuffmanDecodeKernel(_Counted):
    """Builds, loads and launches K9; `build_log` holds nvcc's report of
    the last build."""

    def __init__(self, source: str = SOURCE, library: str = _SO) -> None:
        super().__init__()
        self.source = source
        self.library = library
        self.build_log = ""
        self.fallbacks = {"corrupt": 0, "no_sync": 0, "small": 0}
        self._lib = None
        self._lock = threading.Lock()
        self._staging = _Staging()

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
                p = ctypes.c_void_p
                lib.fennec_k9_error_string.restype = ctypes.c_char_p
                lib.fennec_k9_error_string.argtypes = [ctypes.c_int]
                lib.fennec_k9_desc_fields.restype = ctypes.c_int
                lib.fennec_k9_decode.restype = ctypes.c_int
                lib.fennec_k9_decode.argtypes = [p, p, p, p, p]
                if lib.fennec_k9_desc_fields() != len(DESC):
                    raise RuntimeError("fennec: K9's library and wrapper "
                                       "disagree on the descriptor")
                self._lib = lib
            return self._lib

    def count_fallback(self, reason: str) -> None:
        with self._count_lock:
            self.fallbacks[reason] += 1

    def decode(self, data: bytes, offset: int, specs, mcus_x: int,
               mcus_y: int, restart_interval: int, device: torch.device,
               sub_bits: int = plain.SUB_BITS) -> Optional[Decoded]:
        """The scan at byte `offset` of `data`, its components `specs`
        (DecodeComponentSpec) on an mcus_x x mcus_y lattice, decoded on
        `device`; None where the host decoder takes it."""
        geo = plain.geometry(specs, mcus_x, mcus_y, restart_interval)
        if geo is None:
            return None
        tabs = plain.decode_tables(specs)
        on_device = restart_interval == 0
        layout = plain.device_layout if on_device else plain.scan_layout
        lay = None if tabs is None else layout(data, offset, geo, sub_bits)
        if lay is None:
            self.count_fallback("corrupt")
            return None
        return self._launch(lay, geo, tabs, on_device, device)

    def _launch(self, lay: plain.Layout, geo: plain.Geometry, tabs,
                on_device: bool, device: torch.device) -> Decoded:
        """The staged copy and the chain on `device`, a CUDA device."""
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.index != torch.cuda.current_device():
            with torch.cuda.device(device):
                return self._launch(lay, geo, tabs, on_device, device)
        lib = self.load()
        pl = plan(lay, len(geo.comps))
        st = self._staging
        if st.pinned is None or st.pinned.numel() < pl.staged_bytes:
            size = max(1 << 22, 1 << (pl.staged_bytes - 1).bit_length())
            st.pinned = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            st.array = st.pinned.numpy()
            st.word = torch.empty(4, dtype=torch.uint8, pin_memory=True)
            st.copied = None
        if st.copied is not None:
            st.copied.synchronize()  # the last copy up has left the buffer
        fill(st.array, lay, geo, tabs, pl)
        desc = descriptor(lay, geo, pl, on_device)
        staged = torch.empty(pl.staged_bytes, dtype=torch.uint8,
                             device=device)
        staged.copy_(st.pinned[:pl.staged_bytes], non_blocking=True)
        st.copied = torch.cuda.Event()
        st.copied.record()
        work = torch.empty(pl.work_bytes, dtype=torch.uint8, device=device)
        outs = [torch.empty((bw * bh, 64), dtype=torch.int16, device=device)
                for _, _, bw, bh in geo.comps]
        ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
        err = lib.fennec_k9_decode(desc.ctypes.data, staged.data_ptr(),
                                   work.data_ptr(),
                                   ctypes.cast(ptrs, ctypes.c_void_p),
                                   _stream(device))
        if err != 0:
            msg = lib.fennec_k9_error_string(err).decode()
            raise RuntimeError(f"fennec: K9 launch failed: CUDA error {err}: "
                               f"{msg}")
        self.count_launch()
        at = int(desc[DESC.index("flag")])
        st.word.copy_(staged[at:at + 4], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        word = st.word.numpy().view(np.int32)

        def read() -> int:
            done.synchronize()
            return int(word[0])

        return Decoded(outs, self, read)


# The instance codecs/jpeg.decode_jpeg launches and chip_smoke.py counts.
huffman_decode = HuffmanDecodeKernel()
