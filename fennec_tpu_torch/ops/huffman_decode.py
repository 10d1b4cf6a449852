"""Kernel K9's host preparation and its plain model: the entropy decode
of a single-scan baseline JPEG, cut into independent pieces.

The host C++ decoder (native.jpeg_decode_scan) walks the scan's bits in
one serial chain.  K9 (csrc/huffman_decode.cu, wrapper
ops/huffman_decode_cuda.py) splits the scan into subsequences of
`sub_bits` bits and decodes them all at once, relying on the
self-synchronisation of Huffman codes (Klein and Wiseman 2003;
Weissenberger and Schmidt, ICPP 2018): a decode begun at a guessed state
soon lands on the true symbol boundaries, and from there on it is the
true decode.

A decoder state is (p, u, k): the unstuffed bit position of the next
symbol, the block's index within its MCU and the next coefficient (0: the
DC symbol).  A subsequence owns the blocks whose DC symbol starts in it.

Host preparation, shared with the wrapper:
  decode_tables(specs) - each component's DC and AC lookahead tables;
  geometry(specs, mcus_x, mcus_y, restart_interval) - the MCU's blocks;
  scan_layout(data, offset, geo, sub_bits) - the drops (the 0x00 after
      each 0xFF), the restart intervals (segments) and the subsequences;
  device_layout - the same left for the card to find, for a scan of one
      interval (complete_on_device: what the card finds).
The phases, in plain Python and NumPy (the kernel's yardstick, never run
on the card):
  unstuff - the scan without its stuffed zeros;
  run - decode from a state to the first symbol boundary at or past a bit,
      recording CHECKS checkpoints on the way (where a decode from a new
      start meets the last one, it stops);
  sync - the kernel's rounds: within a CTA of CTA subsequences until none
      changes, then launches across CTAs, one per CTA at most (launches);
  count_scan - each subsequence's first block and DC predictors;
  write - every block, natural order, the DC values summed, a piece per
      checkpoint.
decode_scan runs them all and returns (blocks, flag): flag 0 means the
blocks are native.jpeg_decode_scan's, bit for bit; any other value names
the anomaly (FLAGS) and the caller decodes on the host.  A scan without
restart intervals is laid out as the card lays it out (device_layout,
complete_on_device), one with them as the host does (scan_layout).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

LUT_BITS = 10  # the lookahead table's index bits (csrc kLutBits)
SUB_BITS = 1024  # bits of a subsequence on the main path
CTA = 128  # subsequences a CTA syncs (kThreads)
CHECKS = 8  # checkpoint slots of a subsequence (kChecks)
MAX_COMPS = 4
MAX_BPM = 64  # blocks of an MCU: four components of 4 x 4
MAX_SCAN_BYTES = 1 << 27  # bit positions stay within int32
ERROR = (-1, 0, 0)  # the state of a decode that met an invalid symbol

# Flag bits: why the device's blocks are not the host decoder's.
BAD_CODE = 1  # no code matches the bits
BAD_RUN = 2  # an AC run passes coefficient 63
BAD_DC = 4  # a DC size above 16
PAST_END = 8  # a block read bits past its interval's data
NO_SYNC = 16  # the rounds did not converge (never in `launches` of them)
SHORT = 32  # an interval holds fewer blocks than its MCUs
BAD_ORDER = 64  # a block's index in its MCU is not its decode order's
FLAGS = {BAD_CODE: "invalid code", BAD_RUN: "run past 63",
         BAD_DC: "DC size above 16", PAST_END: "bits past the end",
         NO_SYNC: "no convergence", SHORT: "too few blocks",
         BAD_ORDER: "block order"}

# Zigzag index -> natural index (entropy.cpp kZigzag).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    dtype=np.int64)


# ── Host preparation ────────────────────────────────────────────────────────


class Table(NamedTuple):
    """One Huffman table for K9: lut[peek >> (32 - LUT_BITS)] is length
    << 8 | symbol for codes of at most LUT_BITS bits, 0 otherwise; a
    longer code of length l is the one with code <= maxcode[l], its
    symbol vals[code + delta[l]]."""

    lut: np.ndarray  # (1 << LUT_BITS,) uint16
    maxcode: np.ndarray  # (17,) int32, -1 where no code has the length
    delta: np.ndarray  # (17,) int32: valptr - mincode
    vals: np.ndarray  # (256,) uint8


@functools.lru_cache(maxsize=64)
def _table(bits: bytes, vals: bytes) -> Optional[Table]:
    if len(bits) != 16 or sum(bits) != len(vals) or len(vals) > 256:
        return None
    # Kraft: a table that claims more codes than its lengths hold has no
    # prefix-free decode (the host decoder's tables overflow there).
    if sum(n << (16 - length) for length, n in enumerate(bits, 1)) > 1 << 16:
        return None
    lut = np.zeros(1 << LUT_BITS, np.uint16)
    maxcode = np.full(17, -1, np.int32)
    delta = np.zeros(17, np.int32)
    code = k = 0
    for length in range(1, 17):
        n = bits[length - 1]
        if n:
            delta[length] = k - code
            maxcode[length] = code + n - 1
            if length <= LUT_BITS:
                span = 1 << (LUT_BITS - length)
                for i in range(n):
                    lo = (code + i) * span
                    lut[lo:lo + span] = length << 8 | vals[k + i]
        code = (code + n) << 1
        k += n
    v = np.zeros(256, np.uint8)
    v[:len(vals)] = np.frombuffer(vals, np.uint8)
    for a in (lut, maxcode, delta, v):
        a.flags.writeable = False
    return Table(lut, maxcode, delta, v)


def decode_tables(specs) -> Optional[List[Tuple[Table, Table]]]:
    """(DC, AC) tables of each scan component (DecodeComponentSpec), or
    None when one is malformed (the host decoder then decides)."""
    out = []
    for s in specs:
        dc = _table(bytes(s.dc_spec[0]), bytes(s.dc_spec[1]))
        ac = _table(bytes(s.ac_spec[0]), bytes(s.ac_spec[1]))
        if dc is None or ac is None:
            return None
        out.append((dc, ac))
    return out


class Geometry(NamedTuple):
    """The scan's MCU lattice as the host decoder walks it: block u of an
    MCU belongs to component u_comp[u], at (dy, dx) = (u_dy[u], u_dx[u])
    inside the component's h x v blocks of the MCU."""

    mcus_x: int
    mcus_y: int
    restart_interval: int
    comps: Tuple[Tuple[int, int, int, int], ...]  # (h, v, bw, bh)
    u_comp: Tuple[int, ...]
    u_dy: Tuple[int, ...]
    u_dx: Tuple[int, ...]

    @property
    def bpm(self) -> int:
        return len(self.u_comp)

    @property
    def blocks(self) -> int:
        return self.mcus_x * self.mcus_y * self.bpm


def geometry(specs, mcus_x: int, mcus_y: int,
             restart_interval: int) -> Optional[Geometry]:
    """The scan's Geometry, or None for one K9 does not take (no
    component, more than four, a sampling factor outside 1-4)."""
    if not 1 <= len(specs) <= MAX_COMPS or mcus_x < 1 or mcus_y < 1:
        return None
    u_comp, u_dy, u_dx = [], [], []
    for c, s in enumerate(specs):
        if not (1 <= s.h <= 4 and 1 <= s.v <= 4):
            return None
        for dy in range(s.v):
            for dx in range(s.h):
                u_comp.append(c)
                u_dy.append(dy)
                u_dx.append(dx)
    return Geometry(mcus_x, mcus_y, restart_interval,
                    tuple((s.h, s.v, s.bw, s.bh) for s in specs),
                    tuple(u_comp), tuple(u_dy), tuple(u_dx))


class Layout(NamedTuple):
    """Where K9's pieces lie.  scan: the stuffed bytes from the scan's
    start to its last interval's end; drops: the positions in it of the
    stuffed 0x00 bytes (sorted).  Per interval (segment) s: its data in
    unstuffed bits [seg_start[s], seg_end[s]), its first block in decode
    order and its blocks, its subsequences seg_first_sub[s] up to
    seg_first_sub[s + 1]."""

    scan: np.ndarray  # uint8
    drops: np.ndarray  # int32
    seg_start: np.ndarray  # int32
    seg_end: np.ndarray  # int32
    seg_first_block: np.ndarray  # int32
    seg_blocks: np.ndarray  # int32
    seg_first_sub: np.ndarray  # int32, nseg + 1 entries
    sub_bits: int

    @property
    def nsub(self) -> int:
        return int(self.seg_first_sub[-1])

    @property
    def nseg(self) -> int:
        return len(self.seg_start)


def scan_layout(data, offset: int, geo: Geometry,
                sub_bits: int = SUB_BITS) -> Optional[Layout]:
    """The Layout of the scan that starts at byte `offset` of `data`, or
    None when its markers are not those of a well-formed scan (an RSTn
    missing where an interval ends; the host decoder then decides).

    As the host decoder reads: a 0xFF followed by 0x00 is a data byte
    0xFF; any other 0xFF (or one at the data's end) starts a marker,
    which ends an interval's data; between intervals the marker, after
    any fill 0xFF bytes, must be RST0-7."""
    buf = np.frombuffer(data, np.uint8)[offset:]
    n = len(buf)
    if n == 0 or n > MAX_SCAN_BYTES or sub_bits < 1:
        return None
    ff = np.flatnonzero(buf == 0xFF)
    nxt = np.full(len(ff), 0xD9, np.uint8)
    inside = ff + 1 < n
    nxt[inside] = buf[ff[inside] + 1]
    drops = (ff[nxt == 0] + 1).astype(np.int32)
    mk = ff[nxt != 0]
    # A fill run's first 0xFF starts its marker.
    starts = mk[~np.isin(mk - 1, mk)]
    n_mcus = geo.mcus_x * geo.mcus_y
    ri = geo.restart_interval
    nseg = 1 if ri == 0 else -(-n_mcus // ri)
    if len(starts) < nseg - 1:
        return None
    ends = np.empty(nseg, np.int64)
    begins = np.zeros(nseg, np.int64)
    if nseg > 1:
        ends[:-1] = starts[:nseg - 1]
        code = ends[:-1] + 1
        while True:
            fill = code < n
            fill[fill] = buf[code[fill]] == 0xFF
            if not fill.any():
                break
            code += fill
        if (code >= n).any():
            return None
        marks = buf[code]
        if ((marks < 0xD0) | (marks > 0xD7)).any():
            return None
        begins[1:] = code + 1
    ends[-1] = starts[nseg - 1] if len(starts) >= nseg else n
    # Unstuffed byte of stuffed byte i: i less the drops before it.
    ustart = (begins - np.searchsorted(drops, begins)) * 8
    uend = (ends - np.searchsorted(drops, ends)) * 8
    uend = np.maximum(uend, ustart)
    per = geo.bpm * ri if ri else geo.blocks
    first_block = np.arange(nseg, dtype=np.int64) * per
    blocks = np.minimum(per, geo.blocks - first_block)
    nsub = np.maximum(1, -(-(uend - ustart) // sub_bits))
    first_sub = np.zeros(nseg + 1, np.int64)
    np.cumsum(nsub, out=first_sub[1:])
    last = int(ends[-1])
    return Layout(buf[:last], drops[drops < last],
                  ustart.astype(np.int32), uend.astype(np.int32),
                  first_block.astype(np.int32), blocks.astype(np.int32),
                  first_sub.astype(np.int32), sub_bits)


SPAN = 64  # scan bytes a thread of the count and unstuff kernels (kSpan)


def device_layout(data, offset: int, geo: Geometry,
                  sub_bits: int = SUB_BITS) -> Optional[Layout]:
    """The Layout the wrapper stages for a scan without restart intervals,
    which the card completes itself (complete_on_device): every byte from
    the scan's start to the data's end, no drops, one interval of all the
    blocks whose data bits are not known yet, and its subsequences at most
    one for every sub_bits bits of those bytes (the grid's bound).  None
    for a scan with restart intervals, or one out of bounds."""
    buf = np.frombuffer(data, np.uint8)[offset:]
    n = len(buf)
    if geo.restart_interval or n == 0 or n > MAX_SCAN_BYTES or sub_bits < 1:
        return None
    one = np.zeros(1, np.int32)
    return Layout(buf, np.zeros(0, np.int32), one, one, one,
                  np.array([geo.blocks], np.int32),
                  np.array([0, -(-8 * n // sub_bits)], np.int32), sub_bits)


def complete_on_device(lay: Layout) -> Layout:
    """What the count and prefix kernels make of a device_layout: the
    stuffed zeros by spans of SPAN bytes (a 0x00 after a 0xFF), the first
    marker (a 0xFF followed by anything but 0x00, or last), the interval's
    data bits up to it, and its subsequences.  For a scan without restart
    intervals it is scan_layout's Layout (bar the bytes kept)."""
    buf = lay.scan
    n = len(buf)
    drop = np.zeros(n, bool)
    drop[1:] = (buf[1:] == 0) & (buf[:-1] == 0xFF)
    span = np.add.reduceat(drop, np.arange(0, n, SPAN)).astype(np.int64)
    pre = np.concatenate([[0], np.cumsum(span)])
    nxt = np.append(buf[1:], 0xD9)
    marks = np.flatnonzero((buf == 0xFF) & (nxt != 0))
    end = int(marks[0]) if len(marks) else n
    before = int(pre[end // SPAN]) + int(
        drop[end // SPAN * SPAN:end].sum())
    bits = (end - before) * 8
    nsub = max(1, -(-bits // lay.sub_bits))
    return lay._replace(
        drops=np.flatnonzero(drop).astype(np.int32),
        seg_end=np.array([bits], np.int32),
        seg_first_sub=np.array([0, nsub], np.int32))


def sub_bounds(lay: Layout, j: int) -> Tuple[int, int, int, int, bool]:
    """(segment, start bit, end bit, segment end bit, first of its
    segment) of subsequence j, as the kernel computes them."""
    s = int(np.searchsorted(lay.seg_first_sub, j, side="right")) - 1
    i = j - int(lay.seg_first_sub[s])
    start = int(lay.seg_start[s]) + i * lay.sub_bits
    seg_end = int(lay.seg_end[s])
    return s, start, min(start + lay.sub_bits, seg_end), seg_end, i == 0


# ── The phases in plain Python ──────────────────────────────────────────────


def unstuff(lay: Layout) -> bytes:
    """The scan's bytes without the stuffed zeros, and 16 zero bytes."""
    return np.delete(lay.scan, lay.drops).tobytes() + bytes(16)


def _peek(bits: bytes, p: int, seg_end: int) -> int:
    """32 bits from bit p, those at or past seg_end read as 0 (the host
    decoder feeds zeros past a marker)."""
    rem = seg_end - p
    if rem <= 0:
        return 0
    b = p >> 3
    v = (int.from_bytes(bits[b:b + 5], "big") >> (8 - (p & 7))) & 0xFFFFFFFF
    if rem < 32:
        v &= (0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF
    return v


def _symbol(t: Table, v: int) -> Tuple[int, int]:
    """(code length, symbol) of the code at the top of v, (0, 0) for
    none."""
    e = int(t.lut[v >> (32 - LUT_BITS)])
    if e:
        return e >> 8, e & 0xFF
    for length in range(LUT_BITS + 1, 17):
        code = v >> (32 - length)
        if code <= t.maxcode[length]:
            return length, int(t.vals[code + t.delta[length]])
    return 0, 0


def _extend(v: int, size: int) -> int:
    if size == 0:
        return 0
    return v - (1 << size) + 1 if v < 1 << (size - 1) else v


def _step(bits: bytes, tabs, geo: Geometry, p: int, u: int, k: int,
          seg_end: int):
    """One symbol from state (p, u, k): (p, u, k, error flag, DC diff or
    None, (zigzag index, value) or None)."""
    v = _peek(bits, p, seg_end)
    dc_t, ac_t = tabs[geo.u_comp[u]]
    if k == 0:
        length, size = _symbol(dc_t, v)
        if length == 0:
            return p, u, k, BAD_CODE, None, None
        if size > 16:
            return p, u, k, BAD_DC, None, None
        x = ((v << length) & 0xFFFFFFFF) >> (32 - size) if size else 0
        return p + length + size, u, 1, 0, _extend(x, size), None
    length, rs = _symbol(ac_t, v)
    if length == 0:
        return p, u, k, BAD_CODE, None, None
    run, s = rs >> 4, rs & 15
    coef = None
    if s == 0:
        k = k + 16 if run == 15 else 64
    else:
        k += run
        if k > 63:
            return p, u, k, BAD_RUN, None, None
        x = ((v << length) & 0xFFFFFFFF) >> (32 - s)
        coef = (k, _extend(x, s))
        k += 1
    if k >= 64:
        u, k = (u + 1) % geo.bpm, 0
    return p + length + s, u, k, 0, None, coef


def checkpoints(lay: Layout, start: int, end: int) -> Tuple[int, int]:
    """(spacing, slots) of a subsequence's checkpoints: slot m is the first
    symbol boundary at or past bit start + m * spacing, for the slots
    whose bit lies before `end` (slot 0, the start, always)."""
    spacing = -(-lay.sub_bits // CHECKS)
    return spacing, max(1, min(CHECKS, -(-(end - start) // spacing)))


def run(bits: bytes, tabs, geo: Geometry, state, bounds, lay: Layout,
        ck: list, old=None):
    """Decode from `state` to the first symbol boundary at or past the
    subsequence's end (bounds: sub_bounds): (exit state, blocks begun
    before the end, DC diffs of those blocks summed per component).  A
    decode that meets an invalid symbol exits at ERROR.

    ck, the subsequence's checkpoint slots, each (state, blocks begun
    before it, DC sums before it) or None, is rewritten on the way.  A
    decode again from a new start (old: the last decode's exit, count
    and sums) that reaches a slot in the state the last decode recorded
    there is the last decode from there on: it stops, and its results are
    the last ones moved by the difference of the counts at that slot."""
    _, start, end, seg_end, _ = bounds
    spacing, nck = checkpoints(lay, start, end)
    dcsum = [0] * len(geo.comps)
    p, u, k = state
    count = m = 0
    while True:
        while m < nck and p >= start + m * spacing:
            if old is not None and m and ck[m] and ck[m][0] == (p, u, k):
                dc = count - ck[m][1]
                dd = [a - b for a, b in zip(dcsum, ck[m][2])]
                for i in range(m, nck):
                    if ck[i] is None:
                        break
                    ck[i] = (ck[i][0], ck[i][1] + dc,
                             [a + b for a, b in zip(ck[i][2], dd)])
                return (old[0], old[1] + dc,
                        [a + b for a, b in zip(old[2], dd)])
            ck[m] = ((p, u, k), count, list(dcsum))
            m += 1
        if p >= end:
            return (p, u, k), count, dcsum
        c = geo.u_comp[u]
        p, u, k, bad, diff, _ = _step(bits, tabs, geo, p, u, k, seg_end)
        if bad:
            ck[m:nck] = [None] * (nck - m)
            return ERROR, count, dcsum
        if diff is not None:
            count += 1
            dcsum[c] += diff


class Synced(NamedTuple):
    start: list  # each subsequence's start state after the rounds
    count: list
    dcsum: list
    ck: list  # each subsequence's checkpoint slots (run)
    changed: list  # CTAs whose last exit moved, per launch
    converged: bool


def launches(nsub: int, cta: int = CTA) -> int:
    """The sync kernel's launches for a grid of nsub subsequences: one per
    CTA.  Launch b leaves CTA b exact (its first takes CTA b - 1's exact
    exit), so the last counts no move on any input."""
    return max(1, -(-nsub // cta))


def sync(bits: bytes, tabs, geo: Geometry, lay: Layout, cta: int = CTA,
         rounds: Optional[int] = None) -> Synced:
    """The sync kernel's launches.  Launch 0 decodes every subsequence
    from its guess (its first bit, u = k = 0; exact for an interval's
    first.  Within a launch, a CTA of `cta` subsequences repeats: each
    takes its predecessor's exit as its start and, if that changed,
    decodes again (from the start to a checkpoint where it meets its last
    decode, run); until none changes.  An exit at ERROR leaves its
    successor's start as it was: a guess that met an invalid symbol says
    nothing of the bits after it (a true one is flagged by the write).
    A CTA's first subsequence reads its predecessor's exit from the
    launch before.  A launch counts the CTAs whose last exit (not ERROR)
    moved from the start the next CTA's first holds (launch 0: its guess;
    later: the exit the launch before left); a later launch runs only if
    the one before counted one, and the rounds converged when the last of
    `rounds` (default: launches) counted none."""
    n = lay.nsub
    if rounds is None:
        rounds = launches(n, cta)
    bounds = [sub_bounds(lay, j) for j in range(n)]
    start = [(b[1], 0, 0) for b in bounds]
    ck = [[None] * CHECKS for _ in range(n)]
    results = [run(bits, tabs, geo, start[j], b, lay, ck[j])
               for j, b in enumerate(bounds)]
    ex = [r[0] for r in results]
    count = [r[1] for r in results]
    dcsum = [r[2] for r in results]
    changed = []
    for r in range(rounds):
        if r and changed[-1] == 0:
            changed.append(0)
            continue
        before = list(ex)  # the exits the last launch wrote
        moved = 0
        for base in range(0, n, cta):
            ids = range(base, min(base + cta, n))
            for _ in range(cta + 1):
                preds = {}
                for j in ids:
                    if bounds[j][4] or (j == base and r == 0):
                        preds[j] = start[j]
                    elif j == base:
                        preds[j] = before[j - 1]
                    else:
                        preds[j] = ex[j - 1]
                now = [j for j in ids
                       if preds[j] != ERROR and preds[j] != start[j]]
                for j in now:
                    start[j] = preds[j]
                    ex[j], count[j], dcsum[j] = run(
                        bits, tabs, geo, start[j], bounds[j], lay, ck[j],
                        (ex[j], count[j], dcsum[j]))
                if not now:
                    break
            j = base + cta - 1
            if j < n and bounds[j][2] < bounds[j][3] and ex[j] != ERROR:
                held = (bounds[j][2], 0, 0) if r == 0 else before[j]
                moved += held != ex[j]
        changed.append(moved)
    return Synced(start, count, dcsum, ck, changed, changed[-1] == 0)


def count_scan(sy: Synced, lay: Layout, ncomp: int):
    """Each subsequence's first block (decode order) and DC predictors: a
    scan of the counts and DC sums that restarts with each interval; and
    the SHORT flag when an interval holds fewer blocks than its MCUs."""
    first, pred, flag = [], [], 0
    for s in range(lay.nseg):
        acc, dacc = 0, [0] * ncomp
        for j in range(int(lay.seg_first_sub[s]),
                       int(lay.seg_first_sub[s + 1])):
            first.append(int(lay.seg_first_block[s]) + acc)
            pred.append(list(dacc))
            acc += sy.count[j]
            dacc = [a + b for a, b in zip(dacc, sy.dcsum[j])]
        if acc < lay.seg_blocks[s]:
            flag |= SHORT
    return first, pred, flag


def write(bits: bytes, tabs, geo: Geometry, lay: Layout, sy: Synced,
          first, pred, outs) -> int:
    """The write kernel, a piece per checkpoint slot: from its slot's
    state, the piece skips the end of a block begun before it and writes
    every block whose DC symbol starts before the next slot (the last
    piece: before the subsequence's end) whole into outs, component c's
    (bw * bh, 64) int16 natural-order blocks; the block's index and DC
    predictors are its subsequence's plus the slot's counts, its DC value
    the predictor plus the diff, kept as int and stored as int16.  Blocks
    past an interval's last are the bits that pad it and are dropped.
    Returns the flags raised."""
    flag = 0
    for j in range(lay.nsub):
        bounds = sub_bounds(lay, j)
        s, start, end, seg_end, _ = bounds
        _, nck = checkpoints(lay, start, end)
        last = int(lay.seg_first_block[s]) + int(lay.seg_blocks[s])
        ck = sy.ck[j]
        for m in range(nck):
            if ck[m] is None:
                break
            (p, u, k), c0, d0 = ck[m]
            stop = (ck[m + 1][0][0] if m + 1 < nck and ck[m + 1] is not None
                    else end)
            bad = 0
            while k and not bad:
                p, u, k, bad, _, _ = _step(bits, tabs, geo, p, u, k, seg_end)
            if bad:
                continue
            g = first[j] + c0
            dc = [a + b for a, b in zip(pred[j], d0)]
            while p < stop and g < last:
                if u != g % geo.bpm:
                    flag |= BAD_ORDER
                    break
                c = geo.u_comp[u]
                block = np.zeros(64, np.int64)
                p, u, k, bad, diff, _ = _step(bits, tabs, geo, p, u, k,
                                              seg_end)
                while not bad and k:
                    p, u, k, bad, _, coef = _step(bits, tabs, geo, p, u, k,
                                                  seg_end)
                    if coef is not None:
                        block[ZIGZAG[coef[0]]] = coef[1]
                if bad:
                    flag |= bad
                    break
                if p > seg_end:
                    flag |= PAST_END
                    break
                dc[c] += diff
                block[0] = dc[c]
                h, v, bw, _ = geo.comps[c]
                mcu, q = divmod(g, geo.bpm)
                by = (mcu // geo.mcus_x) * v + geo.u_dy[q]
                bx = (mcu % geo.mcus_x) * h + geo.u_dx[q]
                outs[c][by * bw + bx] = block.astype(np.uint16).view(np.int16)
                g += 1
    return flag


def decode_scan(data, offset: int, specs, mcus_x: int, mcus_y: int,
                restart_interval: int, sub_bits: int = SUB_BITS,
                cta: int = CTA, rounds: Optional[int] = None):
    """All of K9's phases in plain Python: (per component (bw * bh, 64)
    int16 blocks, flag), or None where K9 does not take the scan (the
    wrapper's route); flag 0 means the blocks are the host decoder's."""
    geo = geometry(specs, mcus_x, mcus_y, restart_interval)
    tabs = decode_tables(specs)
    if geo is None or tabs is None:
        return None
    if restart_interval:
        lay = scan_layout(data, offset, geo, sub_bits)
    else:
        lay = device_layout(data, offset, geo, sub_bits)
    if lay is None:
        return None
    return decode_laid_out(lay, geo, tabs, not restart_interval, cta, rounds)


def decode_laid_out(lay: Layout, geo: Geometry, tabs, on_device: bool,
                    cta: int = CTA, rounds: Optional[int] = None):
    """decode_scan from what the wrapper stages: a scan's Layout (a
    device_layout, completed here as the card completes it, where
    on_device), its Geometry and tables."""
    if on_device:
        lay = complete_on_device(lay)
    bits = unstuff(lay)
    sy = sync(bits, tabs, geo, lay, cta, rounds)
    outs = [np.zeros((bw * bh, 64), np.int16) for _, _, bw, bh in geo.comps]
    if not sy.converged:
        return outs, NO_SYNC
    first, pred, flag = count_scan(sy, lay, len(geo.comps))
    return outs, flag | write(bits, tabs, geo, lay, sy, first, pred, outs)


def names(flag: int) -> Sequence[str]:
    """The anomalies a flag names."""
    return [name for bit, name in FLAGS.items() if flag & bit]
