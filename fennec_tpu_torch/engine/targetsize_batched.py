"""Target-file-size engine over a same-shape bucket of images, in lockstep.

Counterpart of fennec_tpu/engine/targetsize_batched.py.  The per-image
engine (engine/targetsize.py) runs each bisection and each scale probe
as device work with one copy back; here the reference's four-strategy
search (targetsize.go:26-348) runs over a whole bucket resident on the
device:

  * S1 (targetsize.go:125-176): one forward DCT and one size bisection
    for every image; byte verification (0xFF stuffing) and the
    optimal-Huffman ascent run as rounds that re-encode only the pending
    lanes: on the device (kernel K3, as the JAX engine's
    _encode_two_stage) or on the host C++ encoder (worker pool), as
    compress.device_entropy_on says; the same bytes either way.  The
    winners' SSIM is
    their reconstruction at the winning quality from the resident
    coefficients, scored by K1 over the bucket.
  * S2 (targetsize.go:180-206): median cut per image on the pool, one
    nearest-palette map per pending image and level on the device, PNG
    deflate on the pool, the winners' SSIM in one SSIMFast call.
  * S3 (targetsize.go:210-281): the per-image scale bisections advance in
    lockstep; images whose next probe snaps to the same lattice geometry
    share one probe, answers are memoized per (image, geometry), and
    each wave also measures the probes the next FENNEC_TS_SPEC rounds
    could ask for (clamped to [0, 3]), so later rounds replay from the
    memo.  Final re-searches group by output geometry.
  * S4 and the fallback are rare and run per image.

Ranking (better_fit), the quality floor of 20, the BPP-seeded bounds and
the scale grids are the per-image engine's, so each image gets the
strategy, quality and geometry hit_target_size gives it; bytes can
differ by a few where a batched Lanczos resize rounds a pixel tie
differently (tests/test_targetsize_batched.py:28-42 states the
contract).

Two faults of the JAX engine are fixed here: it checks the context once
per speculative wave (targetsize_batched.py:789-791), this engine before
every bisection round and every final group; and FENNEC_TS_SPEC is
clamped (each wave costs about 2^spec probes).  Not ported: the fused
device-table encode (FENNEC_TS_FUSED, off by default in the JAX package)
and the concurrent strategy and final-group threads (FENNEC_TS_CONC),
which overlap remote-TPU call latency and give the sequential results;
the strategies and groups run in order on one stream.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..codecs import png as png_codec
from ..codecs.jpeg import decode_jpeg, encode_quantized, forward_dct
from ..image import is_opaque, to_nrgba_ref
from ..ops.quantize import median_cut_levels, palette_indices, palette_to_nrgba
from ..ops.resize import (
    box_weights_device,
    lanczos_resize_device,
    lanczos_weights_device,
)
from ..ops.ssim import WINDOW_SIZE, ssim_fast_dims
from ..ops.ssim_cuda import ssim_window
from ..parallel.batched import batched_ssim_fast
from ..types import Context, Format, Options
from .compress import device_entropy_on, probe_luminance, search_inputs
from .size_search import quality_tables_on, quantize_packed, size_bisect
from .targetsize import (
    FIXED_SCALES,
    MIN_JPEG_QUALITY,
    PALETTE_LEVELS,
    SizeResult,
    _bpp_bounds,
    _ctx_err,
    _fallback_encode,
    _header_len,
    better_fit,
    box_probe,
    probe_geometry,
    scale_search,
    stage_clock,
)

TS_SPEC_MAX = 3


def ts_spec() -> int:
    """Bisection levels each S3 probe wave measures ahead:
    FENNEC_TS_SPEC (default 1, as in the JAX package) clamped to
    [0, TS_SPEC_MAX]."""
    return min(TS_SPEC_MAX, max(0, int(os.environ.get("FENNEC_TS_SPEC",
                                                      "1"))))


def _count(name: str, n: int = 1) -> None:
    from .batched import counters

    counters.add_event(name, n)


def _host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy int64 tensors of one shape to the host in one transfer."""
    out = torch.stack([t.to(torch.int64) for t in tensors]).cpu().numpy()
    return list(out)


# ── S1 ──────────────────────────────────────────────────────────────────────


def _encode_lanes(pool, coefs, qvec: np.ndarray, sel: Sequence[int],
                  h: int, w: int, emit: bool) -> List[Tuple[int, bytes]]:
    """Encode the selected lanes of the resident coefficient stack, each
    at its quality qvec[lane], with per-image optimal Huffman tables (the
    target-size engine always optimizes, like _JpegSizer): quantize on
    the device, then with `emit` Huffman-code on the device (the
    histograms down, the K.2 tables on the host, K3, the words down; JAX
    _encode_two_stage, :331-381) and wrap each file on the pool, else one
    int16 copy back and the C++ encoder on the pool.  Returns (lane,
    bytes) pairs."""
    from ..parallel.batched import emit_scans

    dev = coefs[0].device
    lanes = torch.as_tensor(np.asarray(sel, np.int64), device=dev)
    sub = tuple(c.index_select(0, lanes) for c in coefs)
    quals = [int(qvec[j]) for j in sel]

    def enc(k: int) -> bytes:
        blk = packed[k]
        return encode_quantized(blk[:ny], blk[ny:ny + nc], blk[ny + nc:],
                                w, h, quals[k], True, optimize=True)

    with stage_clock("encode"):
        ny, nc = sub[0].shape[1], sub[1].shape[1]
        packed = quantize_packed(sub, quality_tables_on(dev)[
            torch.as_tensor(quals, device=dev).clamp(0, 100)])
        if emit:
            scans = emit_scans(packed, h, w, True, True)
            return list(zip(sel, pool.map(
                lambda k: scans.jpeg(k, w, h, quals[k], True),
                range(len(sel)))))
        packed = packed.cpu().numpy()
        return list(zip(sel, pool.map(enc, range(len(sel)))))


def _s1_search_batch(pool, stack: torch.Tensor, h: int, w: int,
                     target_bytes: int, emit: bool):
    """_JpegSizer.search over (B, h, w, 4) images on the device.

    Returns (qualities (B,), ok (B,) bool, data list, the resident
    coefficients); ok[i] False means no quality in bounds fit.  Per
    image: bisect on the bit-count oracle, verify real bytes stepping
    down, then probe up while the optimized encoding still fits
    (engine/targetsize.py, _JpegSizer.search)."""
    lo, hi = _bpp_bounds(target_bytes, w * h)
    budget = max(0, target_bytes - _header_len(w, h))
    coefs = forward_dct(stack.to(torch.float32), True)
    q_d, found_d = size_bisect(coefs, h + (-h) % 16, w + (-w) % 16, True,
                               budget, lo, hi)
    q, ok = _host(q_d, found_d)
    ok = ok.astype(bool)
    b = q.shape[0]
    data: List[Optional[bytes]] = [None] * b
    q = np.where(ok, q, lo)  # placeholder quality for dead lanes

    # Verify-down rounds: stuffing can push the real size past the
    # oracle; step those images down one quality per round.
    pending = ok.copy()
    while pending.any():
        for j, e in _encode_lanes(pool, coefs, q, np.nonzero(pending)[0],
                                  h, w, emit):
            if len(e) <= target_bytes:
                data[j] = e
                pending[j] = False
            else:
                q[j] -= 1
                if q[j] < lo:
                    ok[j] = False
                    pending[j] = False
                    q[j] = lo

    # Ascent rounds: optimized Huffman beats the standard-table oracle,
    # so a higher quality may fit; encode only the climbing lanes.
    climbing = ok & (q < hi)
    while climbing.any():
        trial = np.where(climbing, q + 1, q)
        for j, e in _encode_lanes(pool, coefs, trial,
                                  np.nonzero(climbing)[0], h, w, emit):
            if len(e) <= target_bytes:
                q[j] += 1
                data[j] = e
                if q[j] >= hi:
                    climbing[j] = False
            else:
                climbing[j] = False
    return q, ok, data, coefs


def _ssim_at_q(stack: torch.Tensor, coefs, q: np.ndarray) -> np.ndarray:
    """SSIMFast of each lane's reconstruction at its quality against its
    source, with K1 over the bucket.  The winner file's coefficients are
    quantize(coefs, q), so this scores what decoding the file gives,
    without a decode per winner (JAX _ssim_at_q_jit)."""
    inp = search_inputs(stack.to(torch.float32), coefs, True)
    lum = probe_luminance(inp, torch.as_tensor(q, device=stack.device))
    return ssim_window(inp.lum_orig, lum.contiguous()).cpu().numpy()


def _s1_batched(pool, stack: torch.Tensor, arrs: List[np.ndarray], h: int,
                w: int, target_bytes: int, idxs: List[int],
                emit: bool) -> List[Optional[SizeResult]]:
    """Strategy 1 for the bucket's JPEG-eligible images idxs (reference
    targetsize.go:125-176)."""
    b = len(arrs)
    out: List[Optional[SizeResult]] = [None] * b
    if not idxs:
        return out
    if len(idxs) < b:
        stack = stack.index_select(0, torch.as_tensor(idxs,
                                                      device=stack.device))
    q, ok, data, coefs = _s1_search_batch(pool, stack, h, w, target_bytes,
                                          emit)
    winners = [(k, i) for k, i in enumerate(idxs) if ok[k]]
    if not winners:
        return out
    ds_w, ds_h = ssim_fast_dims(w, h)
    if ds_w > WINDOW_SIZE and ds_h > WINDOW_SIZE:
        ssims_all = _ssim_at_q(stack, coefs, np.where(ok, q, 1))
        ssims = [float(ssims_all[k]) for k, _ in winners]
    else:  # a side of 8 px or less: decode and route as SSIMFast does
        dev = stack.device
        decoded = np.stack([decode_jpeg(data[k], dev) for k, _ in winners])
        a = torch.from_numpy(np.stack([arrs[i] for _, i in winners]))
        ssims = batched_ssim_fast(a.to(dev), torch.from_numpy(decoded).to(
            dev))
    for m, (k, i) in enumerate(winners):
        out[i] = SizeResult(data=data[k], format=Format.JPEG,
                            quality=int(q[k]), ssim=float(ssims[m]),
                            final_w=w, final_h=h, img=arrs[i])
    return out


# ── S2 ──────────────────────────────────────────────────────────────────────


def _s2_batched(pool, stack: torch.Tensor, arrs: List[np.ndarray],
                target_bytes: int,
                idxs: List[int]) -> List[Optional[SizeResult]]:
    """Strategy 2 for the bucket (reference targetsize.go:180-206):
    median cut on the pool (one run per image gives every level), the
    palette map on the device, PNG deflate on the pool, and one SSIMFast
    call for the winners.  Per image the same as quantize_strategy."""
    b = len(arrs)
    out: List[Optional[SizeResult]] = [None] * b
    if not idxs:
        return out
    dev = stack.device
    h, w = arrs[0].shape[:2]
    levels: Dict[int, dict] = dict(zip(idxs, pool.map(
        lambda i: median_cut_levels(arrs[i], PALETTE_LEVELS), idxs)))
    pending = list(idxs)
    winners: List[Tuple[int, bytes, np.ndarray]] = []
    for max_colors in PALETTE_LEVELS:
        if not pending:
            break
        pals = [levels[i][max_colors] for i in pending]
        maps = []
        for i, pal in zip(pending, pals):
            rgb = stack[i, ..., :3].reshape(-1, 3).to(torch.int32)
            p = torch.from_numpy(np.ascontiguousarray(pal[:, :3])).to(
                dev).to(torch.int32)
            maps.append(palette_indices(rgb, p).to(torch.uint8))
        idx_host = torch.stack(maps).cpu().numpy().reshape(-1, h, w)
        with stage_clock("png"):
            datas = list(pool.map(
                lambda k: png_codec.encode_png_paletted(idx_host[k],
                                                        pals[k]),
                range(len(pending))))
        nxt = []
        for k, i in enumerate(pending):
            if len(datas[k]) <= target_bytes:
                winners.append((i, datas[k],
                                palette_to_nrgba(idx_host[k], pals[k])))
            else:
                nxt.append(i)
        pending = nxt

    if winners:
        lanes = torch.as_tensor([i for i, _, _ in winners], device=dev)
        quantized = torch.from_numpy(np.stack([q for _, _, q in winners]))
        ssims = batched_ssim_fast(stack.index_select(0, lanes),
                                  quantized.to(dev))
        for m, (i, data, qimg) in enumerate(winners):
            out[i] = SizeResult(data=data, format=Format.PNG, quality=0,
                                ssim=float(ssims[m]), final_w=w,
                                final_h=h, img=qimg)
    return out


# ── S3 ──────────────────────────────────────────────────────────────────────


class _LockstepProber:
    """Probe answers (fits, quality) per (image, snapped geometry) for a
    bucket, measured a geometry group at a time and memoized."""

    def __init__(self, stack: torch.Tensor, w: int, h: int,
                 target_bytes: int):
        self.stack = stack
        self.w, self.h = w, h
        self.target_bytes = target_bytes
        self.memo: Dict[Tuple[int, int, int], Tuple[bool, int]] = {}

    def measure(self, pairs) -> None:
        """Measure every (image, geometry) pair not in the memo: one
        box_probe per geometry group, one copy back for the wave."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        hits = 0
        for i, geom in pairs:
            if (i, *geom) in self.memo:
                hits += 1
            elif i not in groups.get(geom, ()):
                groups.setdefault(geom, []).append(i)
        _count("ts_memo_hits", hits)
        if not groups:
            return
        dev = self.stack.device
        answers = []
        for (nw, nh), group in groups.items():
            wh, wv = box_weights_device(self.w, self.h, nw, nh, dev)
            lo, hi = _bpp_bounds(self.target_bytes, nw * nh)
            sub = self.stack.index_select(0, torch.as_tensor(group,
                                                             device=dev))
            answers += list(box_probe(sub, wh, wv, self.target_bytes, lo,
                                      hi))
        q_all, f_all = _host(torch.cat(answers[0::2]),
                             torch.cat(answers[1::2]))
        k = 0
        for geom, group in groups.items():
            for i in group:
                self.memo[(i, *geom)] = (bool(f_all[k]), int(q_all[k]))
                k += 1
        _count("ts_waves")
        _count("ts_probes", k)


def _spec_geoms(w: int, h: int, lo: float, hi: float, depth: int,
                acc: set) -> None:
    """Snapped geometries of every bisection node reachable within
    `depth` more levels from interval (lo, hi), both branch outcomes,
    mirroring the round body of _s3_batched (the too-small rule advances
    lo without probing and consumes a level)."""
    mid = (lo + hi) / 2
    nw, nh = int(w * mid), int(h * mid)
    if nw < 8 or nh < 8:
        if depth > 0:
            _spec_geoms(w, h, mid, hi, depth - 1, acc)
        return
    acc.add(probe_geometry(w, h, nw, nh))
    if depth > 0:
        _spec_geoms(w, h, mid, hi, depth - 1, acc)
        _spec_geoms(w, h, lo, mid, depth - 1, acc)


def _s3_batched(ctx: Optional[Context], pool, stack: torch.Tensor,
                arrs: List[np.ndarray], h: int, w: int, target_bytes: int,
                idxs: List[int],
                emit: bool = False) -> List[Optional[SizeResult]]:
    """Strategy 3 for the bucket: lockstep binary scale search, the fixed
    scale grid and final re-searches grouped by output geometry
    (reference targetsize.go:210-281).  `emit`: encode on the device
    (_encode_lanes)."""
    b = len(arrs)
    out: List[Optional[SizeResult]] = [None] * b
    if not idxs:
        return out
    prober = _LockstepProber(stack, w, h, target_bytes)
    lo_s = {i: 0.05 for i in idxs}
    hi_s = {i: 1.0 for i in idxs}
    best: Dict[int, Tuple[float, int]] = {}
    fixed = []
    for scale in FIXED_SCALES:
        nw, nh = int(w * scale), int(h * scale)
        if nw >= 8 and nh >= 8:
            fixed.append((scale, probe_geometry(w, h, nw, nh)))
    spec_max = ts_spec()

    r = 0
    cancelled = False
    while r < 10 and not cancelled:
        # One wave: this round's probes plus every probe the next `spec`
        # rounds could ask for (both branches per level), and on the
        # first wave the fixed grid; the rounds below replay from the
        # memo.
        spec = min(spec_max, 9 - r)
        pairs = [(i, geom) for _, geom in fixed
                 for i in idxs] if r == 0 else []
        if spec:
            for i in idxs:
                acc: set = set()
                _spec_geoms(w, h, lo_s[i], hi_s[i], spec, acc)
                pairs.extend((i, g) for g in acc)
        for _ in range(spec + 1):
            if _ctx_err(ctx):
                cancelled = True
                break
            want: Dict[int, Tuple[int, int]] = {}
            mids: Dict[int, float] = {}
            for i in idxs:
                mid = (lo_s[i] + hi_s[i]) / 2
                mids[i] = mid
                nw, nh = int(w * mid), int(h * mid)
                if nw < 8 or nh < 8:
                    lo_s[i] = mid  # too small (targetsize.go:247-250)
                    continue
                want[i] = probe_geometry(w, h, nw, nh)
            prober.measure(pairs + list(want.items()))
            pairs = []
            for i, geom in want.items():
                fits, q = prober.memo[(i, *geom)]
                if fits and q >= MIN_JPEG_QUALITY:
                    best[i] = (mids[i], q)
                    lo_s[i] = mids[i]
                else:
                    hi_s[i] = mids[i]
            _count("ts_s3_rounds")
            r += 1
            if r >= 10:
                break

    if not _ctx_err(ctx):
        prober.measure((i, geom) for _, geom in fixed for i in idxs)
        for scale, geom in fixed:
            for i in idxs:
                fits, q = prober.memo[(i, *geom)]
                if fits and q >= MIN_JPEG_QUALITY:
                    if i not in best or scale > best[i][0]:
                        best[i] = (scale, q)

    finals: Dict[Tuple[int, int], List[int]] = {}
    for i, (scale, _q) in best.items():
        finals.setdefault((int(w * scale), int(h * scale)), []).append(i)
    for (fw, fh), group in finals.items():
        if _ctx_err(ctx):
            break
        _final_group(pool, stack, w, h, fw, fh, group, target_bytes, out,
                     emit)
    return out


def _final_group(pool, stack: torch.Tensor, w: int, h: int, fw: int,
                 fh: int, group: List[int], target_bytes: int,
                 out: List[Optional[SizeResult]], emit: bool) -> None:
    """One output geometry of S3: Lanczos-resize the group, run S1 on the
    scaled stack, and score SSIM against the originals after upscaling
    back (compute_ssim_nrgba semantics, targetsize.go:563-568)."""
    dev = stack.device
    lanes = torch.as_tensor(group, device=dev)
    src = stack.index_select(0, lanes)
    dwh, dwv = lanczos_weights_device(w, h, fw, fh, dev)
    scaled = lanczos_resize_device(src, dwh, dwv)
    q2, ok2, data2, _ = _s1_search_batch(pool, scaled, fh, fw,
                                         target_bytes, emit)
    uwh, uwv = lanczos_weights_device(fw, fh, w, h, dev)
    ssims = batched_ssim_fast(src, lanczos_resize_device(scaled, uwh, uwv))

    # Only the candidate that wins the ranking copies its pixels back.
    def fetch(lane: int) -> np.ndarray:
        return scaled[lane].to(torch.uint8).cpu().numpy()

    for k, i in enumerate(group):
        if not ok2[k] or int(q2[k]) < MIN_JPEG_QUALITY:
            continue
        out[i] = SizeResult(data=data2[k], format=Format.JPEG,
                            quality=int(q2[k]), ssim=float(ssims[k]),
                            final_w=fw, final_h=fh,
                            img_fetch=functools.partial(fetch, k))


# ── Public entry ─────────────────────────────────────────────────────────────


def hit_target_size_batched(ctx: Optional[Context],
                            arrs: List[np.ndarray], target_bytes: int,
                            opts: Options,
                            device: _device.DeviceLike = None,
                            workers: int = 0) -> List[SizeResult]:
    """The target-size engine over a bucket of NRGBA images of one shape
    (the caller guarantees it).  Each image gets hit_target_size's
    strategy, quality and geometry; the searches run in lockstep on the
    device.  workers sizes the host encode pool (0 = auto)."""
    dev = _device.resolve(device)
    b = len(arrs)
    arrs = [to_nrgba_ref(a) for a in arrs]
    h, w = arrs[0].shape[:2]
    emit = device_entropy_on(opts, dev)
    want_png = opts.format == Format.PNG
    want_jpeg = opts.format == Format.JPEG
    jpeg_idx = [i for i in range(b)
                if want_jpeg or (not want_png and is_opaque(arrs[i]))]
    candidates: List[List[SizeResult]] = [[] for _ in range(b)]

    nworkers = workers if workers > 0 else min(16, os.cpu_count() or 4)
    with concurrent.futures.ThreadPoolExecutor(nworkers) as pool:
        stack = torch.from_numpy(np.stack(arrs)).to(dev)
        if jpeg_idx and not _ctx_err(ctx):
            with stage_clock("s1"):
                s1 = _s1_batched(pool, stack, arrs, h, w, target_bytes,
                                 jpeg_idx, emit)
            for i in jpeg_idx:
                if s1[i] is not None and s1[i].quality >= MIN_JPEG_QUALITY:
                    candidates[i].append(s1[i])
        if not want_jpeg and not _ctx_err(ctx):
            with stage_clock("s2"):
                s2 = _s2_batched(pool, stack, arrs, target_bytes,
                                 list(range(b)))
            for i in range(b):
                if s2[i] is not None:
                    candidates[i].append(s2[i])
        if jpeg_idx and not _ctx_err(ctx):
            with stage_clock("s3"):
                s3 = _s3_batched(ctx, pool, stack, arrs, h, w,
                                 target_bytes, jpeg_idx, emit)
            for i in jpeg_idx:
                if s3[i] is not None:
                    candidates[i].append(s3[i])
        del stack

    results: List[Optional[SizeResult]] = [None] * b
    for i in range(b):
        if not candidates[i]:
            continue
        bst = candidates[i][0]
        for c in candidates[i][1:]:
            if better_fit(c, bst, target_bytes):
                bst = c
        results[i] = bst.materialize()

    # S4 and the fallback: only images with no candidate, per image.
    for i in range(b):
        if results[i] is not None:
            continue
        can_jpeg = i in jpeg_idx
        if not _ctx_err(ctx):
            fmt = opts.format
            if fmt == Format.AUTO:
                fmt = Format.JPEG if can_jpeg else Format.PNG
            with stage_clock("s4"):
                r = scale_search(ctx, arrs[i], target_bytes, fmt, dev)
            if r is not None:
                results[i] = r
                continue
        results[i] = _fallback_encode(arrs[i], target_bytes, can_jpeg, opts,
                                      dev)
    return results  # type: ignore[return-value]
