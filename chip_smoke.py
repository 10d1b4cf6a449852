"""Drive the PyTorch port's main paths once on one CUDA card, and check
them.

    python3 chip_smoke.py [--k2 | --k3 | --k5 | --digests | --mesh | --wire
                           | --k7k8]

With no argument, every phase below; it needs one card.  --k2 runs
phases 1 and 2, K2's part of phase 3 and the size oracle's checks of
phase 10 alone (the two search loops' kernels against their plain
versions, and K2 against the first K2); --k3 runs phases 1, 2 and 11
and the size oracle's checks (K3 against its plain version and, in
turns, against the first K3; K4's step and bisection); --k5 runs
phases 1, 2 and 16 (K5 against its plain version, the host builder and
the first K5, its phase split, its timings in turns with the first K5
and the emission in turns); --digests prints digests of a few main-path
outputs, to compare two checkouts on one card, each call also on K7's
and K8's plain versions (the route before them) with every difference
traced to a tie; --mesh runs phases 1, 2, 14 and 15 alone; --wire runs
phases 1, 2 and 17 alone; --k7k8 runs phases 1, 2 and 18 alone.  None
of these prints the result lines.

Phases, each raising on failure:
  1. environment: a CUDA card, its name and power limit, TF32 off;
  2. build: kernels K1, K2, K3 with K4's entries, K5, K6, K7 and K8
     (nvcc, sm_90a), the first K3, the first K2, the first K5 and the
     first K6 (kept under bench_sources/ to be timed against), the first
     K5 and K5 again with -DK5_STAMPS, and the host C++ entropy coder,
     from the sources in this checkout, all fourteen at once, each K5-K8
     build's -Xptxas -v printed;
  3. K1 against its plain PyTorch version on the card, at the shapes the
     main paths give it and beyond, the batch engines' (64, 500, 500)
     included, and at ragged shapes for its strips and bands: max |diff|
     <= 1e-5, an identical pair 1.0, two calls bit-identical, the last
     image alone bit-identical to its score in the batch.  At the
     timed shapes: K1's device time (torch.profiler, its kernel's rows
     only), its CUDA-event time per call (host cost included), its host
     time per call, its bound and share of it, and the plain version's
     CUDA-event time.  Then K2, the fused probe reconstruction, against
     its plain version probe_luminance_plain at 12 MP 4:2:0 (Q30 and
     Q90), 1080p in 4:2:0 and 4:4:4, the batch chunk of 64 x 500x500 and
     T2's 64 x 499x499 lanes at per-image qualities, and ragged
     geometries (17x9, 1x1, 9x1000, 513x700, 3x600): the luminance equal
     except where a channel moved by one level (differing pixels counted
     and attributed: the IDCT's summation order, or the plain version's
     float32 box mean at an exact k + 1/2), SSIM through K1 within 1e-5
     of the plain route, two calls bit-identical, the last image alone
     bit-identical to its luminance in the batch, and the luminance
     bit-identical to the first K2's (FIRST_K2_SOURCE); K2's device time
     and device operations per call, CUDA-event time and host time per
     call, in turns with the first K2 (new, first, first, new), its bound
     and share, and the plain version's time;
  4. the single-image path through the public entry points: compress_file
     on a 12 MP (4032x3024) photo-like JPEG, cold then warm; with
     max_width=1920; compress_bytes on four 1920x1080 requests at ULTRA,
     HIGH, BALANCED and AGGRESSIVE.  Every output must decode to its
     dimensions, meet its SSIM target (or be the Q=100 fallback), agree
     with SSIM scored on its own decode, and K1 must have run at least 7
     times per image.  With the default Options every image is
     Huffman-coded on the card: K3 counted from 0 before each call must
     have launched for it, K3a, K5 and K3b once each per emission (phases
     6-8 and T2/T3 of 10 the same, per device chunk or encode round; T1
     keeps the host encoder, as the JAX package's per-image target-size
     engine does, and launches only the size oracle's K3a, which is
     counted apart).  Each accept/reject decision at the boundary (the
     chosen quality q, and q-1) is re-scored with the plain scorer
     (probe_luminance_plain and K1's plain version), and the whole
     bisection is replayed with it, every probe also scored through K2
     and K1: no accept/reject decision may differ.  Each standard-mode
     call must launch K2 seven times per image or chunk, counted from 0
     like K1's and K3's, and every search K8's DCT and luminance.  Then
     the program's own stages of one warm 12 MP compress_file (its
     StageTimer report) and its peak device memory;
  5. a small noisy image through the same entry point on the card and on
     the CPU (plain versions): the same quality and SSIM, and the same
     decision checks;
  6. compress_batch over 512 JPEG files of 500x500 at Q92, cold then warm
     (then once more under torch.profiler): every file through the
     coefficient route, none rescued by the per-file pool, K1 at least 7
     times per chunk; every 32nd item against per-image compress_bytes on
     the card (same quality, SSIM within 1e-5, size within 16 bytes,
     decoded pixels within 3 levels); every 64th item's decisions
     replayed with the plain scorer.  The photos go up as COO; then 64
     files of noise at Q100 with default options (the census sends them
     as dense int8, against per-image compress_bytes) and 64 photos with
     FENNEC_UPLOAD=csr (bytes equal to the COO run's), so that the main
     path launches K6 on every layout;
  7. compress_images over 256 decoded 500x500 images (32 distinct x 8):
     each must give the bytes compress_image gives its source;
  8. compress_batch over 16 files of 4032x3024: the chunk size the engine
     picks from the card's free memory, and two files against per-image
     compress_file;
  9. the CLI (python -m fennec_tpu_torch --batch) in a subprocess on a
     directory of the committed progressive and multi-scan fixtures, a
     baseline JPEG, a PNG, an EXIF-rotated JPEG and a truncated JPEG:
     only the truncated file fails, and the progressive fixture decodes
     on the card as on the CPU;
 10. target-size mode.  T1, per image, cold then warm: compress_file on
     the 12 MP JPEG at 100 KB (AUTO), compress_bytes on a 1920x1080
     JPEG at 200 KB and compress_image on a 500x500 photo at 20 KB and
     at 128 KB (JPEG; S1 wins the last, and q+1 must overshoot).  T2:
     compress_images over 64 photos of 500x500 at 20 KB, cold then warm,
     and an AUTO bucket holding a transparent image, items against
     per-image compress_image; then one bucket of 16 12 MP photos at
     100 KB (JPEG) in the chunks the engine picks, with the peak device
     bytes per pixel.  T3: compress_batch over 64 such files at 20 KB,
     and the CLI's --target-size 100KB on the 12 MP file.  Then the same
     160x120 search (S3 wins) on the card and on the CPU, and one 12 MP
     palette map on both.  Every output fits its target or is the
     fallback and decodes to its dimensions; its reported SSIM is honest
     (S1/S2: within 0.01 of SSIMFast of the decoded output; S3/S4 report
     the scaled image's SSIM before encoding, as the reference does,
     reproduced within 1e-4).  Every timed compress_* call of T1-T3
     must launch K1, counted from 0 just before it and read just after,
     before any check runs, and K4's bisection once per size bisection
     (counted by count_bisections; never K4's step, never the packed
     quantize).  The size oracle's step on the card (scan_bytes_at: one
     launch of K4's step, which quantizes the float32 coefficients as it
     stages them) equals its plain version scan_bits, K4's own plain
     version and the earlier route (the packed quantize, then K3a's
     totals) on the same CUDA tensors at 12 MP, 1080p, 64 x 500x500 at
     per-image qualities and 1080p 4:4:4; its step is timed in turns
     with the earlier route, beside the plain step and its bound.  K4's
     bisection (phase_bisect) equals the step loop through K4's step and
     the plain step loop ((best_q, found) and the (7, B) table of each
     step's bits) at those shapes with the main path's targets and
     ranges, over a narrowed and an empty range, at a target nothing
     fits and one everything fits, for one image in its 0-d form and at
     16 x 12 MP; it is timed in turns with the step loop (CUDA events,
     host µs, device µs, device operations) beside its bound and the
     plain loop.  The palette map per level at 12 MP.  T1-T3 print a
     digest of their outputs.
 11. K3 against its plain version on the card, at the main path's
     shapes (12 MP and 1080p 4:2:0 at the qualities phase 4 chose, a
     64-image 500x500 chunk, 1080p 4:4:4, ragged 17x9 and 1x1) and at
     synthetic blocks that cross the design's seams (one block per
     component, one slot more than a segment, a short last segment,
     all-zero blocks, zero runs of 16 to 62, a batch of 64 with
     per-image tables, dense blocks that overflow K3b's shared buffer,
     images whose bits end on a word), with the standard and with
     optimal tables: totals, block bits, histograms and words
     bit-identical, the words equal to the first K3's, and every file
     byte-identical to the C++ encoder's.  K3a's (with histograms, and
     totals alone as the oracle calls it) and K3b's device time
     (torch.profiler), host time per call, bound and share, in turns
     with the first K3's; the plain version's CUDA-event time; and the
     whole device emission (host ms, device ms and device operations)
     against the first K3's flow and against the download and the C++
     encoder;
 12. the A/B of device_entropy=None (K3) against False (the host C++
     encoder), in turns: warm 12 MP compress_file, the 512-file batch
     and T2; the outputs byte-identical;
 13. the rest of the surface at 12 MP: ssim (K1 at (1, 3024, 4032)) and
     ms_ssim on the card against the CPU within 1e-5, and the effects
     (sharpen, adaptive_sharpen, gaussian_blur) uint8-identical;
 14. the mesh and the stages.  torch.cuda.device_count() and
     data_mesh(None), which must be None with one card (the default
     paths unchanged there).  The 512-file 500x500 compress_batch
     (coefficient path, K3 emission), the 256-image compress_images
     (pixel path) and 64 of the files with max_width=256 (the Lanczos
     route, host encoder), each on [cuda:k, cuda:k] (two shards, each on
     its own stream, in turn on one thread) and on cuda:k, in turns (a
     warm-up round, then 3 rounds alternating which goes first): every output
     byte-identical, and K1, K2, K3a, K5 and K3b, counted from 0 around
     each call, launched 7, 7, 1, 1 and 1 times (0 for K3 and K5 on the
     Lanczos route)
     per shard chunk (a chunk's non-empty shards; one device's chunk is
     one); warm img/s of both, median of 3.  The four *_sharded
     functions at (64, 500, 500) on the two shards against their
     unsharded forms (q, found, SSIM bit-equal; scan bytes equal; the size
     search's (q, found) equal, K4's bisection launched once on one
     device and once per shard on the two).  The CLI's -v on the 12 MP
     file: a `Stages:` report naming the JAX CLI's stages and the port's
     sub-stages.  One warm 12 MP compress_file under utils/profiling.
     device_trace: the Chrome trace must name the kernels of K1, K2, K3a
     and K3b and hold a range for each of the program's stages.
 15. the data×spatial mesh on bands of this card (SPATIAL_CASES: a 12 MP
     portrait over 2 and over 4 bands, a 4000x3008 image whose
     rectangles straddle three seams over 4, a 64 MP square over 4) at
     BALANCED: quality_search_spatial_sharded on [cuda:k] * bands against
     the unsharded search on cuda:k, (q, found) and the blocks equal,
     SSIM equal or within 1e-5 with the original's luminance pixels that
     differ counted (each must sit at a float32 box-mean tie), K2
     launched 7 times per band and K1 7 times per search, counted from 0
     around the call, and every band's K2 luminance at each of its 7
     probes bit-equal to its rows of K2 on the whole image and held to
     K2's plain version on the band's own inputs (each differing pixel
     at a float32 box-mean tie, |diff| <= 1); CUDA-event ms of both in
     turns and their peak device memory, with the card's name and power
     limit; batched_ssim_sharded(spatial=True) on (2, 2160, 3840) over a
     2x2 mesh against batched_ssim and the plain windowed SSIM, each
     within 1e-5, K1 launched once per band;
 16. K5, the device K.2 table build, against its plain version on the
     same CUDA tensors (tables and header bit for bit), against the first
     K5 (FIRST_K5_SOURCE, bit for bit) and against the host C++ builder
     (_optimal_tables and hist_bits: tables, specs and scan bits equal,
     errors for exactly the flagged images) on the histograms phase 4's
     warm calls handed K5, on the 12 MP and 1080p photos and a 64 x
     500x500 chunk at BALANCED's qualities and at Q95 / Q100 (K5_HIGH),
     and on k5_families (ties, single symbols, empty classes, skew,
     Fibonacci counts, a code past 32 bits, counts whose merges pass
     2^31, a mixed batch of 64, all 162 AC symbols live); both stamped
     builds' cycles per phase and per merge (k5_split); K5 and the first
     K5 in turns (device, CUDA-event and host time) at B = 1 and 64 and
     at high quality (K5_TIMED) beside K5's bound, the serial chain at
     the measured latency of the walk's steps (K5Build.step_cycles), the
     plain version and the host builder; the host µs of each build's
     call and its parts (k5_host_split); the header's pull three ways in
     turns (header_pull_ab); and the whole optimal
     emission (emit_scans) against the host-built flow (host_built_emit)
     in turns at 12 MP and 64 x 500x500, the bytes equal;
 17. the upload routes (--wire alone).  K6, the coefficient-wire unpack,
     against its plain version on the same CUDA tensors, the first K6
     (FIRST_K6_SOURCE) and the C++ decoder's int16 blocks, bit for bit,
     on each layout (COO, dense int8, CSR, as wire_sections builds them
     the engine's way) at the 64 x 500x500 chunk, 16 x 12 MP, 8 noise
     files at Q100 and ragged 17x9 and 513x700, and on k6_cases (every
     R and K at the seams, exceptions, views at unaligned addresses);
     K6's device time (torch.profiler, every kernel of the call, split by
     kernel), CUDA-event time, host time, in turns with the first K6,
     bound (bytes: the live wire read and 128 bytes a block written) and
     share, and the plain version's time, at the first two.  The search's
     outputs from int16 blocks decoded here and from each layout through
     K6, equal (wire_search_agrees).  The 512-file batch through the
     int16 upload (int16_uploads) and COO in turns, three runs each, then
     dense int8 and CSR (FENNEC_UPLOAD) once: img/s, prep and device
     seconds of every run, uploaded bytes per chunk, the device's idle
     share (torch.profiler), the upload event of every chunk, K6 launched
     once per chunk (never for int16), the four byte-identical and every
     32nd item held to per-image compress_bytes; 64 files with
     max_width: int16 uploads, no K6.  Phase 17's launches count apart
     from the main path's.  Then 256 images through compress_images on the rgb
     and the yuv420 wire (FENNEC_PIXEL_WIRE): img/s, uploaded bytes, the
     qualities that moved and the largest |dSSIM|; every yuv420 output
     meets its target or is the Q100 fallback.
 18. (run after phase 3) K7, the decode's device stage, and K8, the
     forward DCT and the original's luminance, against their plain
     versions on the same CUDA tensors (phase_k7k8; --k7k8 alone): K7 on
     the frames of a 12 MP 4:2:0 and a 1080p 4:4:4 JPEG, the progressive
     and multi-scan fixtures, synthetic gray, Adobe RGB, CMYK, YCCK and
     4:2:2 frames (a fifth of their blocks a DC tie) and a ragged one, DC
     1 at q = 4 (129), each frame at EXIF orientations 2-8 against
     orient_plain of its image at 1 bit for bit, its batch entry on a 64
     x 500x500 chunk that K6 rebuilt from the COO wire; K8's DCT at 12 MP
     in 4:2:0 and 4:4:4, 64 x 500x500, one 12 MP band of four and ragged
     alpha images (levels at Q30/60/92), images alone against the batch
     bit for bit; its luminance at 12 MP, 64 x 500x500 (no downsample),
     the band and 700x20, bit-equal to the exact box means.  Every pixel,
     level or luminance value that differs from the plain version must
     sit at a tie, and is counted.  Device, CUDA-event and host time, the plain
     version's, bound and share and the block product alone (torch.matmul
     of (N, 64) x (64, 64), a part of the function) at K7's 12 MP, 1080p
     4:4:4 and 64 x 500x500, K8's 12 MP, 64 x 500x500 and band; K7 at
     orientations 1, 6 and 3 in turns at 12 MP 4:2:0 and 1080p 4:4:4.

The last lines: the kernel table as JSON (K1's, K2's, K3a's, K3b's, K5's
and K4's step's and bisection's launches summed over the main-path runs of
phases 4, 6-8 and 10, each counted from 0; K4's step, now the
bisection's yardstick, launches 0 times there; K6's per layout over those
runs and phase 17's; K7's and K8's, with phase 18's timings and tie
counts),
the card's name and power limit as nvidia-smi reports them, and {"ok":
true, "device": {...}}.  Images are made from numpy seeds; nothing is
fetched.  Without a CUDA card the script fails before printing any
result.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
SHAPES = [(3, 32, 32), (3, 64, 48), (3, 130, 100), (1, 384, 512),
          (4, 288, 512), (1, 1080, 1920), (1, 2160, 3840), (64, 500, 500),
          (1, 288, 512), (1, 500, 500), (5, 499, 499),
          # ssim() at full resolution on a 12 MP photo.
          (1, 3024, 4032),
          # Ragged for K1's strips of 128 columns and bands of rows.
          (1, 9, 9), (2, 9, 300), (1, 1000, 9), (3, 137, 261),
          (1, 2161, 3839)]
TIMED_SHAPES = [(1, 384, 512), (1, 288, 512), (1, 500, 500), (5, 499, 499),
                (64, 500, 500), (1, 2160, 3840), (1, 3024, 4032)]
K1_ATOL = 1e-5  # the bound tests/test_ssim_pallas.py holds Pallas to
# K1's bound: 174 flops per window position (3 products, 150 in the two
# window passes, 21 in the formula and the sum) and 8 bytes per pixel,
# against an H100 SXM's 67 TFLOP/s fp32 and 3.35 TB/s.
K1_FLOPS_PER_POSITION = 174
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# K3's bound: the bytes (each block's 128 read once, the layout's three
# ints per slot, the tables, and what the launch writes), or its thread
# instructions reckoned from csrc/jpeg_emit.cu at an H100 SXM's issue
# rate, 132 SMs x 4 schedulers x 32 lanes at 1.98 GHz.  Per block: the
# staging (eight 16-byte loads' worth of address arithmetic and 64 2-byte
# stores, ~190), eight vector loads and tests, the DC symbol and the sums
# (~60); K3b walks twice and scans (~130 more).  Per nonzero AC
# coefficient: the size, the symbol, the table load and the sum (14),
# with histograms the match and the add (22), in K3b the count and then
# the field into the accumulator (44).
K3A_INSTR_PER_BLOCK = 250
K3B_INSTR_PER_BLOCK = 380
K3A_INSTR_PER_NONZERO = 14
K3A_HIST_INSTR_PER_NONZERO = 22
K3B_INSTR_PER_NONZERO = 44
INT_ISSUE_PER_S = 33.4e12
# The first K3 (one thread per block, three launches and a cumsum per
# optimal-table emission), kept only to be timed against the current one.
FIRST_K3_SOURCE = os.path.join("bench_sources", "jpeg_emit_first.cu")
# The first K2 (PR 7's design), kept to be held bit for bit and timed in
# turns against the current one.
FIRST_K2_SOURCE = os.path.join("bench_sources", "probe_recon_first.cu")
DECODE_SSIM_ATOL = 1e-3  # probe model vs real decode: IDCT order, ties
# The coefficient path's contract against per-image compression
# (tests/test_coef_fastpath.py:60-97, tests/test_torch_batch.py).
SIZE_ATOL = 16
PIXEL_ATOL = 3
# Target-size checks: the reported SSIM against SSIMFast of the decoded
# output (tests/test_pipeline.py:43-46), and the batched engine's
# contract against the per-image engine (tests/test_targetsize_batched.py
# :28-42).
TS_HONEST_ATOL = 0.01
TS_SSIM_ATOL = 1e-4
TS_SIZE_ATOL = 8
HERE = os.path.dirname(os.path.abspath(__file__))
# The program's stages of a standard-mode 12 MP JPEG request.
REQUEST_STAGES = ("open + decode", "huffman decode", "blocks up",
                  "image down", "validate", "nrgba", "jpeg quality search",
                  "image up", "device search", "emit")


def log(msg: str) -> None:
    print(msg, flush=True)


def digest(blobs) -> str:
    """The first 16 hex digits of SHA-256 over the byte strings in order,
    each behind its length: equal outputs of two runs print equal
    digests."""
    sha = hashlib.sha256()
    for blob in blobs:
        sha.update(struct.pack("<Q", len(blob)))
        sha.update(blob)
    return sha.hexdigest()[:16]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def photo(w: int, h: int, seed: int, fine: float = 3.0) -> np.ndarray:
    """Opaque photo-like (h, w, 4) uint8: gradients, soft waves, hard
    edges, coarse noise and per-pixel noise of std `fine` (thousands of
    colours, so AUTO picks JPEG)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 255.0 * x / w
    img[..., 1] = 255.0 * y / h
    img[..., 2] = 128.0 + 90.0 * np.sin(x / 97.0) * np.cos(y / 61.0)
    del x, y
    for _ in range(24):  # hard-edged rectangles
        x0, x1 = sorted(rng.integers(0, w, 2))
        y0, y1 = sorted(rng.integers(0, h, 2))
        img[y0:y1, x0:x1] += rng.uniform(-60, 60, 3).astype(np.float32)
    cell = 16
    coarse = rng.normal(0, 10, (h // cell + 1, w // cell + 1, 3))
    img += np.repeat(np.repeat(coarse.astype(np.float32), cell, 0),
                     cell, 1)[:h, :w]
    img += rng.normal(0, fine, (h, w, 3)).astype(np.float32)
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = np.clip(img, 0, 255)
    out[..., 3] = 255
    return out


def k1_bound(shape):
    """(least ms the card could take, "operations" or "bytes") for one K1
    call: each input read once, each output written once."""
    bsz, h, w = shape
    flops = K1_FLOPS_PER_POSITION * bsz * (h - 8) * (w - 8)
    nbytes = 8 * bsz * h * w + 4 * bsz
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# Timings torch.profiler could not give, each timed with CUDA events
# instead (profiled_rows); main() reports them.
PROFILER_MISSES = []


def device_us(e) -> float:
    """A torch.profiler row's own device µs."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def profiled_rows(fn, iters: int, name: str = ""):
    """torch.profiler's CUDA rows (kernels, memsets and copies) of fn()
    calls after one warm-up, with the number of calls profiled.  The
    profiler on the card drops some records of a long run of short
    launches, and in some runs all of them, so while no row's name holds
    `name` (no row at all, when empty) it profiles again, up to three
    times, the last time over a tenth of the calls.  (None, iters) when it
    never does: the caller then times the whole call with CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for n in (iters, iters, max(3, iters // 10)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(name in e.key for e in rows):
            return rows, n
    what = f"'{name}'" if name else "any device operation"
    PROFILER_MISSES.append(what)
    log(f"torch.profiler recorded no launch of {what} in three tries; "
        f"timed with CUDA events instead (the whole call)")
    return None, iters


def profiled_device_ms(fn, iters: int, name: str,
                       per_call: int = 1) -> float:
    """Device ms per fn() call, which launches `per_call` kernels whose
    names hold `name`, from torch.profiler's CUDA rows of those kernels:
    their mean time per launch (over the launches it recorded) times
    per_call.  CUDA-event ms of the whole call when the profiler records
    none (profiled_rows)."""
    rows, _ = profiled_rows(fn, iters, name)
    if rows is None:
        return cuda_ms(fn, iters)
    mine = [e for e in rows if name in e.key]
    return (sum(device_us(e) for e in mine) / sum(e.count for e in mine)
            * per_call / 1e3)


def profiled_all_device(fn, iters: int):
    """(device ms, device operations) per fn() call over everything it
    runs on the card: torch.profiler's CUDA rows (kernels, memsets and
    copies).  (CUDA-event ms, None) when the profiler records nothing
    (profiled_rows)."""
    rows, n = profiled_rows(fn, iters)
    if rows is None:
        return cuda_ms(fn, iters), None
    return (sum(device_us(e) for e in rows) / n / 1e3,
            sum(e.count for e in rows) / n)


def profiled_per_call(fn, iters: int, name: str):
    """(device ms, device operations) per fn() call, which launches one
    kernel whose name holds `name` and maybe other device work (memsets,
    more kernels): torch.profiler's CUDA rows of everything, over the
    number of `name` launches it recorded (it drops some records of a long
    run of short launches; see profiled_rows).  (CUDA-event ms, None)
    when it records none."""
    rows, _ = profiled_rows(fn, iters, name)
    if rows is None:
        return cuda_ms(fn, iters), None
    calls = sum(e.count for e in rows if name in e.key)
    return (sum(device_us(e) for e in rows) / calls / 1e3,
            sum(e.count for e in rows) / calls)


def host_us(fn, iters: int) -> float:
    """Host µs per fn() call: the time to enqueue it, the device not
    awaited."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


# The launches on the main path (phases 4, 6-8 and 10) of K3 (emission's
# K3a and K3b) and K5 (each optimal emission's table build), of K4 (the size oracle's bisection, and its step, which
# only phase_k4 launches now) and of K2 (the probe reconstruction), each
# call counted from 0 just before it and read just after; and the engines'
# size bisections on the card (count_bisections).
K3_MAIN = {"block_stats": 0, "deposit": 0, "oracle": 0, "bisect": 0,
           "huffbuild": 0}
# K6's launches by layout: on the main path (phases 4, 6-8 and 10), and
# in phase 17 (its routes forced in turns and the pixel wires), apart.
K6_MAIN = {"coo": 0, "i8": 0, "csr": 0}
K6_WIRE = {"coo": 0, "i8": 0, "csr": 0}


def k6_wrappers():
    """{layout: K6's wrapper} (fennec_tpu_torch/ops/coef_wire_cuda.py)."""
    from fennec_tpu_torch.ops import coef_wire_cuda as k6

    return {"coo": k6.unpack_coo, "i8": k6.unpack_i8, "csr": k6.unpack_csr}


class K6Launches:
    """The three K6 wrappers' launches as one count, set to 0 together."""

    @property
    def launches(self) -> int:
        return sum(k.launches for k in k6_wrappers().values())

    @launches.setter
    def launches(self, value: int) -> None:
        for k in k6_wrappers().values():
            k.launches = value
K2_MAIN = {"recon": 0}
BISECTIONS = {"calls": 0}


def count_bisections() -> None:
    """Count every size_search.size_bisect call of the engines on a CUDA
    device into BISECTIONS, so that k3_take can hold K4's bisection to
    one launch per bisection: the three modules that call it get a
    counting wrapper around it (installed once)."""
    import threading

    from fennec_tpu_torch.engine import size_search, targetsize
    from fennec_tpu_torch.engine import targetsize_batched
    from fennec_tpu_torch.parallel import batched

    real = size_search.size_bisect
    lock = threading.Lock()

    def counted(coefs, *args, **kwargs):
        if coefs[0].device.type == "cuda":
            with lock:
                BISECTIONS["calls"] += 1
        return real(coefs, *args, **kwargs)

    for mod in (targetsize, targetsize_batched, batched):
        if mod.size_bisect is real:
            mod.size_bisect = counted


def k3_zero() -> None:
    """Set K2's, K3's, K4's, K5's and K6's counts and the bisections to
    0."""
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.huffbuild_cuda import build_tables
    from fennec_tpu_torch.ops.probe_recon_cuda import probe_recon

    build_tables.launches = 0
    K6Launches().launches = 0
    for w in k78_wrappers().values():
        w.launches = 0

    k3.block_stats.launches = 0
    k3.deposit.launches = 0
    k3.oracle_stats.launches = 0
    k3.quantize_count.launches = 0
    k3.size_bisect.launches = 0
    BISECTIONS["calls"] = 0
    probe_recon.launches = 0


def k3_take(tag: str, dev, emissions: int, bisections: int = 0,
            probes: int = 0, main: bool = True):
    """The launches since k3_zero, added to the main path's totals (main=
    False: K6's to phase 17's, and none of the others anywhere).  On a
    CUDA device every JPEG of the call must have been coded by K3: at
    least `emissions` emissions (one per image or device chunk coded),
    each one K3a, one K5 and one K3b launch (every emission of the main
    path builds optimal tables); the size oracle must have bisected
    at least `bisections` times, each bisection one launch of K4's
    bisection, and launched neither K4's step nor K3a's totals over
    packed blocks; and K2 must have reconstructed at least `probes`
    probes.  emissions=0: the call keeps the host encoder and must launch
    neither K3a nor K3b."""
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.huffbuild_cuda import build_tables
    from fennec_tpu_torch.ops.probe_recon_cuda import probe_recon

    a, b = k3.block_stats.launches, k3.deposit.launches
    o, z = k3.quantize_count.launches, k3.size_bisect.launches
    p = probe_recon.launches
    k5 = build_tables.launches
    if main:
        K3_MAIN["block_stats"] += a
        K3_MAIN["deposit"] += b
        K3_MAIN["huffbuild"] += k5
        K3_MAIN["oracle"] += o
        K3_MAIN["bisect"] += z
        K2_MAIN["recon"] += p
    for layout, k in k6_wrappers().items():
        (K6_MAIN if main else K6_WIRE)[layout] += k.launches
    k78 = {k: w.launches for k, w in k78_wrappers().items()}
    if main:
        for k, n in k78.items():
            K78_MAIN[k] += n
    if (main and dev.type == "cuda" and probes
            and not (k78["forward_dct"] and k78["luminance"])):
        raise AssertionError(f"{tag}: a search on the card launched K8 "
                             f"{k78}: its forward DCT and the original's "
                             f"luminance must run through K8")
    calls = BISECTIONS["calls"]
    if dev.type == "cuda" and (a != b or k5 != b or b < emissions
                               or z != calls
                               or calls < bisections or o
                               or (emissions == 0 and b != 0)
                               or k3.oracle_stats.launches or p < probes):
        raise AssertionError(f"{tag}: launches K3a={a} K5={k5} K3b={b} K4 "
                             f"bisection={z} for {calls} bisections, K4 "
                             f"step={o} (K3a over packed blocks as the "
                             f"oracle: {k3.oracle_stats.launches}) K2={p}, "
                             f"want {emissions} or more emissions of one K3a"
                             f", one K5 and one K3b, one K4 bisection per "
                             f"bisection "
                             f"and >= {bisections} of them, no K4 step, and "
                             f">= {probes} K2 probes")
    return a, b, z


def phase_kernel(dev, ssim_window, batched_ssim_plain):
    """K1 against the plain version at every shape: within K1_ATOL, an
    identical pair 1.0, two calls bit-identical.  Returns (max_abs_err,
    {shape: times}) for the timed shapes."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    times = {}
    for shape in SHAPES:
        a_np = rng.uniform(0, 255, shape).astype(np.float32)
        b_np = np.clip(a_np + rng.normal(0, 12, shape), 0, 255)
        a = torch.from_numpy(a_np).to(dev)
        b = torch.from_numpy(b_np.astype(np.float32)).to(dev)
        got = ssim_window(a, b)
        again = ssim_window(a, b)
        want = batched_ssim_plain(a, b)
        ones = ssim_window(a, a.clone())
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        one_err = float((ones - 1.0).abs().max())
        repeat = torch.equal(got, again)
        # The batch engines hold batch results to per-image ones bit for
        # bit: the last image alone must score what it scores in the batch.
        alone = torch.equal(got[-1:], ssim_window(a[-1:].contiguous(),
                                                  b[-1:].contiguous()))
        if not (torch.isfinite(got).all() and err <= K1_ATOL
                and one_err <= K1_ATOL and repeat and alone):
            raise AssertionError(f"K1 {shape}: |diff| {err}, identical "
                                 f"pair off 1.0 by {one_err}, repeat "
                                 f"bit-identical {repeat}, alone as in "
                                 f"the batch {alone}")
        worst = max(worst, err, one_err)
        log(f"k1 shape={shape} max_abs_err={err:.3e} "
            f"identical_err={one_err:.3e} repeat_identical={repeat} "
            f"alone_identical={alone} ssim={got.tolist()[:2]}")
        if shape in TIMED_SHAPES:
            iters = 200 if a.numel() < 1_000_000 else 50
            t = {"ms": profiled_device_ms(lambda: ssim_window(a, b), iters,
                                          "ssim_window_kernel"),
                 "event_ms": cuda_ms(lambda: ssim_window(a, b), iters),
                 "host_us": host_us(lambda: ssim_window(a, b), iters),
                 "plain_ms": cuda_ms(lambda: batched_ssim_plain(a, b),
                                     iters // 5)}
            t["bound_ms"], t["bound_by"] = k1_bound(shape)
            t["share"] = t["bound_ms"] / t["ms"]
            times[shape] = t
            log(f"k1 time shape={shape} device_us={t['ms'] * 1e3:.2f} "
                f"event_us={t['event_ms'] * 1e3:.2f} host_us="
                f"{t['host_us']:.2f} bound_us={t['bound_ms'] * 1e3:.2f} "
                f"({t['bound_by']}) share={t['share']:.3f} "
                f"plain_event_ms={t['plain_ms']:.4f}")
    return worst, times


# K2's cases: (tag, w, h, B, subsample, qualities (one for all, or None
# for per-image ones from the seed), timed).  The main path's shapes,
# then ragged ones: under 8 px, one pixel, a side scaled up to 8 rows by
# SSIMFast (9x1000 and 3x600: rectangles of one row, some empty), a
# downsample with odd ratios.
K2_CASES = [("12mp_420_q30", 4032, 3024, 1, True, 30, True),
            ("12mp_420_q90", 4032, 3024, 1, True, 90, True),
            ("1080p_420", 1920, 1080, 1, True, 50, True),
            ("chunk_64x500x500_420", 500, 500, 64, True, None, True),
            ("t2_lanes_64x499x499_420", 499, 499, 64, True, None, True),
            ("1080p_444", 1920, 1080, 1, False, 50, True),
            ("ragged_9x17", 9, 17, 1, True, 75, False),
            ("ragged_1x1", 1, 1, 1, True, 50, False),
            ("ragged_1x1_444", 1, 1, 2, False, 50, False),
            ("ragged_1000x9", 1000, 9, 1, True, 60, False),
            ("ragged_600x3_444", 600, 3, 1, False, 60, False),
            ("odd_700x513", 700, 513, 2, True, None, False)]
# One level of one channel moves the luminance by at most 0.587; all
# three by 1.0 (plus the float32 rounding of the weighted sum).
K2_LEVEL_ATOL = 1.0 + 1e-3


def k2_bound(inp, bsz: int):
    """(least ms, "bytes" or "operations") for one K2 call: every
    coefficient read once, the luminance written once, the tables and
    rectangles read once; against 34 flops a coefficient (two passes of
    eight multiply-adds, the quantize-dequantize) and 16 a pixel (the
    colour maths and roundings) at the card's fp32 rate."""
    coefs = sum(p.numel() for p in inp.cplanes)
    nbytes = 4 * coefs + 4 * inp.lum_orig.numel() + 4 * (101 * 128 + 64)
    if inp.box_rectangles is not None:
        nbytes += 4 * inp.box_rectangles.numel()
    flops = 34 * coefs + 16 * bsz * inp.h * inp.w
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_k2(dev, cases=None, timed: bool = True, first=None):
    """K2 against its plain version and, given `first` (a FirstK2), bit
    for bit against the first K2, timed in turns with it (see the module
    docstring, phase 3).  Returns (largest |luminance difference|, {tag:
    times})."""
    import dataclasses

    from fennec_tpu_torch.engine import compress as C
    from fennec_tpu_torch.ops.filters import box_bounds
    from fennec_tpu_torch.ops.probe_recon_cuda import (
        box_mean_exact,
        probe_recon,
    )
    from fennec_tpu_torch.ops.ssim import batched_ssim_plain, ssim_fast_dims
    from fennec_tpu_torch.ops.ssim_cuda import ssim_window

    rng = np.random.default_rng(SEED + 21)
    worst = 0.0
    times = {}
    for tag, w, h, n, sub, quality, time_it in (K2_CASES if cases is None
                                                else cases):
        imgs = np.stack([photo(w, h, SEED + 2000 + 7 * k + w)
                         for k in range(n)])
        x = torch.from_numpy(imgs).to(dev).to(torch.float32)
        inp, _ = C.prepare_search(x, sub)
        del x
        q = (torch.from_numpy(rng.integers(1, 101, n)) if quality is None
             else torch.full((n,), quality, dtype=torch.int64)).to(dev)
        before = probe_recon.launches
        got = C.probe_luminance(inp, q)
        again = C.probe_luminance(inp, q)
        want = C.probe_luminance_plain(inp, q)
        box = inp.box_rectangles is not None
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            if probe_recon.launches != before + 2:
                raise AssertionError(f"K2 {tag}: two calls did not launch "
                                     f"the kernel twice")
        ds_w, ds_h = ssim_fast_dims(w, h)
        if tuple(got.shape) != (n, ds_h, ds_w) or got.shape != want.shape:
            raise AssertionError(f"K2 {tag}: shape {tuple(got.shape)}, "
                                 f"plain {tuple(want.shape)}")
        # The first K2 on the same inputs: the same luminance, bit for bit.
        same_as_first = first is None or torch.equal(got, first(inp, q))
        diff = (got - want).abs()
        n_diff = int((diff != 0).sum())
        err = float(diff.max())
        # Where the differences come from.  The plain version's r, g, b
        # with the box mean taken exactly, as K2 takes it: what is left
        # against K2 is the IDCT's summation order alone, and what that
        # differs from the plain version by is the float32 box mean.
        qt = inp.tables[q]
        rgb = C._reconstruct_rgb_planes(*inp.cplanes, qt, inp.dmat, sub, h,
                                        w)
        if box:
            ys, xs = box_bounds(ds_h, h), box_bounds(ds_w, w)
            rgb = [box_mean_exact(p, *ys, *xs) for p in rgb]
        exact = C._luminance(*rgb)
        del rgb
        n_idct = int((got != exact).sum())
        n_mean = int((want != exact).sum())
        alone_inp = dataclasses.replace(
            inp, cplanes=tuple(p[-1:].contiguous() for p in inp.cplanes),
            lum_orig=inp.lum_orig[-1:].contiguous())
        alone = torch.equal(C.probe_luminance(alone_inp, q[-1:]), got[-1:])
        repeat = torch.equal(got, again)
        s_diff = 0.0
        if min(ds_h, ds_w) > 8:
            scorer = ssim_window if on_card else batched_ssim_plain
            s_k = scorer(inp.lum_orig, got.contiguous())
            s_p = scorer(inp.lum_orig, want.contiguous())
            s_diff = float((s_k - s_p).abs().max())
        log(f"k2 {tag} planes={tuple(inp.cplanes[0].shape)} out="
            f"{tuple(got.shape)} pixels_differing={n_diff} of {got.numel()} "
            f"(from the IDCT's order {n_idct}, from the plain float32 box "
            f"mean {n_mean}) max_abs_diff={err:.6f} ssim_diff={s_diff:.3e} "
            f"repeat_identical={repeat} alone_identical={alone} "
            f"equal_to_first_k2={same_as_first}")
        if not (torch.isfinite(got).all() and err <= K2_LEVEL_ATOL
                and s_diff <= K1_ATOL and repeat and alone
                and same_as_first):
            raise AssertionError(
                f"K2 {tag}: |luminance diff| {err} (limit {K2_LEVEL_ATOL}), "
                f"ssim diff {s_diff} (limit {K1_ATOL}), repeat "
                f"bit-identical {repeat}, alone as in the batch {alone}, "
                f"equal to the first K2 {same_as_first}")
        worst = max(worst, err)
        if timed and time_it:
            times[tag] = time_k2(inp, q, n, first)
            t = times[tag]
            log(f"k2 time {tag}: device_us={t['ms'] * 1e3:.2f} (turns "
                f"{[round(v * 1e3, 2) for v in t['turns']]}) first_us="
                f"{t['first_ms'] * 1e3:.2f} (turns "
                f"{[round(v * 1e3, 2) for v in t['first_turns']]}) event_us="
                f"{t['event_ms'] * 1e3:.2f} first_event_us="
                f"{t['first_event_ms'] * 1e3:.2f} host_us={t['host_us']:.2f} "
                f"first_host_us={t['first_host_us']:.2f} ops={t['ops']} "
                f"first_ops={t['first_ops']} bound_us="
                f"{t['bound_ms'] * 1e3:.2f} ({t['bound_by']}) share="
                f"{t['share']:.3f} first_share={t['first_share']:.3f} "
                f"plain_event_ms={t['plain_ms']:.4f}")
        del inp, alone_inp, got, again, want, exact, diff
    return worst, times


def time_k2(inp, q, n: int, first) -> dict:
    """K2's times on one case, in turns with the first K2 (new, first,
    first, new): device ms and device operations per call (torch.profiler,
    every CUDA row: the first K2's memset and finishing kernel included),
    CUDA-event ms and host µs per call; the bound, the share of it, and
    the plain version's CUDA-event ms."""
    from fennec_tpu_torch.engine import compress as C

    def turn(fn):
        ms, ops = profiled_per_call(fn, 50, "probe_recon_kernel")
        return ms, ops, cuda_ms(fn, 50), host_us(fn, 50)

    new = lambda: C.probe_luminance(inp, q)  # noqa: E731
    old = lambda: first(inp, q)  # noqa: E731
    runs = {"new": [], "first": []}
    for name in ("new", "first", "first", "new"):
        runs[name].append(turn(new if name == "new" else old))
    t = {"shape": list(inp.cplanes[0].shape),
         "turns": [r[0] for r in runs["new"]],
         "first_turns": [r[0] for r in runs["first"]]}
    for key, i in (("ms", 0), ("ops", 1), ("event_ms", 2), ("host_us", 3)):
        for who, out in (("new", key), ("first", f"first_{key}")):
            got = [r[i] for r in runs[who] if r[i] is not None]
            t[out] = float(np.mean(got)) if got else None  # ops unseen
    t["plain_ms"] = cuda_ms(lambda: C.probe_luminance_plain(inp, q), 5)
    t["bound_ms"], t["bound_by"] = k2_bound(inp, n)
    t["share"] = t["bound_ms"] / t["ms"]
    t["first_share"] = t["bound_ms"] / t["first_ms"]
    return t


def quantized_stack(images, quality: int, subsample: bool, dev):
    """(B, NT, 64) int16 blocks of (h, w, 4) uint8 images quantized at
    `quality` on the card, y|cb|cr as the engines hold them."""
    from fennec_tpu_torch.codecs.jpeg import forward_dct, quantize_coefs
    from fennec_tpu_torch.ops.dct import all_quality_tables

    x = torch.from_numpy(np.stack(images)).to(dev).to(torch.float32)
    qt = torch.from_numpy(np.array(all_quality_tables()[quality])).to(dev)
    parts = quantize_coefs(forward_dct(x, subsample), qt)
    return torch.cat(parts, dim=1).to(torch.int16).contiguous()


def k3_bound(packed: torch.Tensor, n_words: int, kind: str):
    """(least ms, "bytes" or "operations") for one launch over these
    blocks; kind is "total" (K3a, bits per image only: the oracle's
    call), "hist" (K3a with histograms) or "deposit" (K3b).  Bytes: every
    block (128 B), the layout (12 B per slot) and the tables read once,
    the totals, histograms or words written once.  Operations: the thread
    instructions reckoned from csrc/jpeg_emit.cu, counting this run's
    nonzero AC coefficients, at one instruction per lane and clock."""
    bsz, nt = packed.shape[:2]
    blocks = bsz * nt
    nnz = int((packed[..., 1:] != 0).sum())
    nbytes = blocks * 128 + nt * 12 + 2 * 272 * 4
    if kind == "deposit":
        nbytes += 4 * n_words + 8 * bsz
        instr = blocks * K3B_INSTR_PER_BLOCK + nnz * K3B_INSTR_PER_NONZERO
    elif kind == "hist":
        nbytes += bsz * (8 + 544 * 4)
        instr = (blocks * K3A_INSTR_PER_BLOCK
                 + nnz * K3A_HIST_INSTR_PER_NONZERO)
    else:
        nbytes += bsz * 8
        instr = blocks * K3A_INSTR_PER_BLOCK + nnz * K3A_INSTR_PER_NONZERO
    t_ops, t_bytes = instr / INT_ISSUE_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


class FirstK3:
    """The first K3 (FIRST_K3_SOURCE: one thread per block; K3a writes
    block bits, torch.cumsum makes the offsets, K3b reads them), built
    here and called as its wrapper called it, to be timed in turns
    against the current kernel.  The port does not import it."""

    def __init__(self) -> None:
        import ctypes

        from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
        from fennec_tpu_torch.ops.ssim_cuda import compile_library

        so = os.path.join(k3.BUILD_DIR, "libjpeg_emit_first.so")
        self.build_log = compile_library(os.path.join(HERE, FIRST_K3_SOURCE),
                                         so, k3.NVCC_FLAGS)
        lib = ctypes.CDLL(so)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fennec_jpeg_block_stats.restype = i
        lib.fennec_jpeg_block_stats.argtypes = [p, i, i, p, p, i, p, i, p,
                                                p, p]
        lib.fennec_jpeg_deposit.restype = i
        lib.fennec_jpeg_deposit.argtypes = [p, i, i, p, p, i, p, i, p, p, p,
                                            ll, p]
        self.lib = lib
        self.check_inputs = k3.check_inputs

    @staticmethod
    def _stream(dev) -> int:
        return torch._C._cuda_getCurrentRawStream(dev.index)

    def block_stats(self, packed, lay, tables, want_bits=True,
                    want_hist=True):
        self.check_inputs(packed, lay, tables)
        dev = packed.device
        bsz, nt = packed.shape[:2]
        bits = (torch.empty((bsz, nt), dtype=torch.int32, device=dev)
                if want_bits else None)
        hist = (torch.empty((bsz, 544), dtype=torch.int32, device=dev)
                if want_hist else None)
        err = self.lib.fennec_jpeg_block_stats(
            packed.data_ptr(), bsz, nt, lay.slot_row.data_ptr(),
            lay.prev_row.data_ptr(), lay.ny, tables.data_ptr(),
            0 if tables.shape[0] == 1 else 544,
            None if bits is None else bits.data_ptr(),
            None if hist is None else hist.data_ptr(), self._stream(dev))
        if err:
            raise RuntimeError(f"first K3a: CUDA error {err}")
        return bits, hist

    def deposit(self, packed, lay, tables, block_off, word_base, n_words):
        self.check_inputs(packed, lay, tables)
        dev = packed.device
        bsz, nt = packed.shape[:2]
        words = torch.empty(n_words + 1, dtype=torch.int32, device=dev)
        err = self.lib.fennec_jpeg_deposit(
            packed.data_ptr(), bsz, nt, lay.slot_row.data_ptr(),
            lay.prev_row.data_ptr(), lay.ny, tables.data_ptr(),
            0 if tables.shape[0] == 1 else 544, block_off.data_ptr(),
            word_base.data_ptr(), words.data_ptr(), n_words,
            self._stream(dev))
        if err:
            raise RuntimeError(f"first K3b: CUDA error {err}")
        return words

    def emit_words(self, packed, lay, optimize: bool) -> np.ndarray:
        """The first flow of parallel/batched.emit_scans, down to the
        pulled words: optimal tables took K3a (histograms), the host K.2
        build, K3a (block bits), a cumsum and K3b; standard ones K3a, a
        sum and its pull, the cumsum and K3b."""
        from fennec_tpu_torch.ops.jpeg_emit import std_tables_on
        from fennec_tpu_torch.parallel.batched import (
            _optimal_tables,
            hist_bits,
        )

        dev = packed.device
        tables = std_tables_on(dev)
        if optimize:
            hist = self.block_stats(packed, lay, tables, False,
                                    True)[1].cpu().numpy().astype(np.int64)
            dcf = hist[:, :32].reshape(-1, 2, 16)
            acf = hist[:, 32:].reshape(-1, 2, 256)
            _specs, tabs, _errors = _optimal_tables(dcf, acf)
            totals = hist_bits(dcf, acf, tabs)
            tables = torch.from_numpy(tabs).to(dev)
            bits = self.block_stats(packed, lay, tables, True, False)[0]
        else:
            bits = self.block_stats(packed, lay, tables, True, False)[0]
            totals = bits.sum(dim=1, dtype=torch.int64).cpu().numpy()
        base = np.zeros(totals.size + 1, dtype=np.int64)
        np.cumsum((totals + 31) // 32, out=base[1:])
        off = torch.cumsum(bits, dim=1, dtype=torch.int64) - bits
        words = self.deposit(packed, lay, tables, off,
                             torch.from_numpy(base).to(dev), int(base[-1]))
        return words.cpu().numpy()


class FirstK2:
    """The first K2 (FIRST_K2_SOURCE: a CTA per 16 x 128 pixel tile; with a
    downsample, integer atomics into a zeroed buffer and a second kernel
    that rounds the means), built here and called as its wrapper called
    it, inputs checked in full on every call, to be held bit for bit and
    timed in turns against the current kernel.  The port does not import
    it."""

    def __init__(self) -> None:
        import ctypes

        from fennec_tpu_torch.ops import probe_recon_cuda as k2
        from fennec_tpu_torch.ops.ssim_cuda import compile_library

        so = os.path.join(k2.BUILD_DIR, "libprobe_recon_first.so")
        self.build_log = compile_library(os.path.join(HERE, FIRST_K2_SOURCE),
                                         so, k2.NVCC_FLAGS)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fennec_probe_recon.restype = i
        lib.fennec_probe_recon.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                           p, p, p, i, i, p, p, p, p]
        self.lib = lib
        self.check_inputs = k2.check_inputs

    def __call__(self, inp, quality: torch.Tensor) -> torch.Tensor:
        y, cb, cr = inp.cplanes
        dev = y.device
        quality = quality.to(torch.int64).reshape(-1).contiguous()
        out_hw = tuple(inp.lum_orig.shape[1:])
        self.check_inputs(inp.cplanes, quality, inp.tables, inp.dmat,
                          inp.subsample, inp.h, inp.w, inp.box_rectangles,
                          out_hw)
        bsz, ph, pw = y.shape
        dh, dw = out_hw
        box = out_hw != (inp.h, inp.w)
        cells = bsz * dh * dw
        buf = torch.empty(cells * (4 if box else 1), dtype=torch.float32,
                          device=dev)
        err = self.lib.fennec_probe_recon(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), bsz, ph, pw,
            cb.shape[1], cb.shape[2], inp.h, inp.w, int(inp.subsample),
            inp.tables.data_ptr(), quality.data_ptr(), inp.dmat.data_ptr(),
            dh, dw, inp.box_rectangles.data_ptr() if box else None,
            buf.data_ptr(), buf.data_ptr() + 4 * cells if box else None,
            torch._C._cuda_getCurrentRawStream(dev.index))
        if err:
            raise RuntimeError(f"first K2: CUDA error {err}")
        return buf[:cells].view(bsz, dh, dw)


def synthetic_blocks(h: int, w: int, subsample: bool, bsz: int, seed: int,
                     kind: str) -> np.ndarray:
    """(B, NT, 64) int16 blocks of h x w images that cross K3's seams.
    kind "sparse": random sparse blocks with extreme magnitudes, all-zero
    AC blocks and a nonzero last coefficient; "zero": nothing but the
    first DC (EOB only); "runs": one or two coefficients per block, far
    apart (zero runs of 16 to 62: one to three ZRLs); "dense": every
    coefficient nonzero (a segment too long for K3b's word buffer in
    shared memory, which then writes straight to device memory)."""
    from fennec_tpu_torch.ops.dct import ZIGZAG

    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if subsample else ny
    nt = ny + 2 * nc
    rng = np.random.default_rng(seed)
    if kind == "zero":
        blocks = np.zeros((bsz, nt, 64), np.int64)
        blocks[:, 0, 0] = 37
    elif kind == "runs":
        blocks = np.zeros((bsz, nt, 64), np.int64)
        for k, pos in enumerate((17, 20, 33, 49, 50, 63)):
            blocks[:, k::6, ZIGZAG[pos]] = rng.integers(1, 900, (bsz, 1))
        blocks[:, 3::6, ZIGZAG[63]] = -1
        blocks[:, 1::4, ZIGZAG[1]] = 5
        blocks[:, :, 0] = rng.integers(-1000, 1000, (bsz, nt))
    elif kind == "dense":
        blocks = rng.integers(200, 1000, (bsz, nt, 64)) * rng.choice(
            [-1, 1], (bsz, nt, 64))
    else:
        blocks = (rng.integers(-300, 300, (bsz, nt, 64))
                  * (rng.random((bsz, nt, 64)) < 0.12))
        blocks[:, :, 0] = rng.integers(-1024, 1024, (bsz, nt))
        blocks[:, ::7, 1:] = 0
        blocks[:, 1::11, 63] = -1023
    return blocks.astype(np.int16)


def k3_seam_cases():
    """(tag, w, h, B, subsample, kind, seed) of synthetic_blocks: one
    block per component, fewer blocks than a segment of 128 slots, one
    more than a segment, a last segment cut short, all-zero blocks, long
    zero runs, a batch whose segments interleave images, and segments of
    dense blocks."""
    return [("one_block_each_444", 8, 8, 1, False, "sparse", 1),
            ("one_mcu_420", 16, 16, 1, True, "sparse", 2),
            ("segment_plus_one_444", 8 * 43, 8, 1, False, "sparse", 3),
            ("short_run_420", 16 * 23, 16, 5, True, "sparse", 4),
            ("zero_blocks_420", 208, 176, 3, True, "zero", 5),
            ("zrl_runs_420", 208, 176, 2, True, "runs", 6),
            ("zrl_runs_444", 120, 88, 2, False, "runs", 7),
            ("batch64_sparse_420", 96, 80, 64, True, "sparse", 8),
            ("dense_420", 128, 128, 2, True, "dense", 9)]


def check_k3_case(dev, first, tag, packed, w, h, sub, quality, timed):
    """One set of blocks through K3 and its plain version, with the
    standard and with optimal tables: totals, block bits, histograms and
    words bit-identical, the flag word 0, and every image's bytes through
    emit_scans equal to the host C++ encoder's.  Returns (largest
    absolute difference, {optimize: times}, empty unless timed)."""
    from fennec_tpu_torch.codecs.jpeg import encode_quantized
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.jpeg_emit import (
        block_stats_plain,
        deposit_plain,
        layout_on,
        std_tables_on,
    )
    from fennec_tpu_torch.parallel.batched import (
        _optimal_tables,
        emit_scans,
        hist_bits,
    )

    times = {}
    worst = 0
    n = packed.shape[0]
    mult = 16 if sub else 8
    lay = layout_on(h + (-h) % mult, w + (-w) % mult, sub, dev)
    host = packed.cpu().numpy().astype(np.int32)
    ny = lay.ny
    nc = (packed.shape[1] - ny) // 2
    for optimize in (False, True):
        if optimize:
            hist = block_stats_plain(packed, lay, std_tables_on(dev),
                                     False, True).hist.cpu().numpy()
            dcf = hist[:, :32].reshape(-1, 2, 16).astype(np.int64)
            acf = hist[:, 32:].reshape(-1, 2, 256).astype(np.int64)
            _specs, tabs_np, errors = _optimal_tables(dcf, acf)
            assert not errors, errors
            tables = torch.from_numpy(tabs_np).to(dev)
        else:
            tables = std_tables_on(dev)
        got = k3.block_stats(packed, lay, tables, True, True)
        want = block_stats_plain(packed, lay, tables, True, True)
        lean = k3.block_stats(packed, lay, tables)
        totals = want.totals.cpu().numpy()
        if optimize and not np.array_equal(
                totals, hist_bits(dcf, acf, tabs_np)):
            raise AssertionError(f"K3 {tag}: histogram bits disagree")
        base = np.zeros(n + 1, dtype=np.int64)
        np.cumsum((totals + 31) // 32, out=base[1:])
        nw = int(base[-1])
        wb = torch.from_numpy(base).to(dev)
        words_k = k3.deposit(packed, lay, tables, wb, nw)
        words_p = deposit_plain(packed, lay, tables, wb)
        pairs = [(got.bits, want.bits), (got.hist, want.hist),
                 (got.totals, want.totals), (lean.totals, want.totals),
                 (words_k, words_p)]
        if n == 1:  # one image may leave its word bases out
            pairs.append((k3.deposit(packed, lay, tables, None, nw),
                          words_p))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in pairs]
        for a, b in pairs:
            worst = max(worst, int((a.to(torch.int64)
                                    - b.to(torch.int64)).abs().max()))
        if lean.bits is not None or lean.hist is not None:
            raise AssertionError(f"K3 {tag}: unasked outputs")
        flag = int(words_k[-1])
        scans = emit_scans(packed, h, w, sub, optimize)
        mismatched = []
        for j in range(n):
            blk = host[j]
            if scans.jpeg(j, w, h, quality, sub) != encode_quantized(
                    blk[:ny], blk[ny:ny + nc], blk[ny + nc:], w, h, quality,
                    sub, optimize):
                mismatched.append(j)
        if first is not None and not np.array_equal(
                first.emit_words(packed, lay, optimize),
                words_k.cpu().numpy()):
            raise AssertionError(f"K3 {tag} optimize={optimize}: the first "
                                 f"K3's words differ")
        if not all(same) or flag or mismatched:
            raise AssertionError(
                f"K3 {tag} optimize={optimize}: bits/hist/totals/totals "
                f"alone/words equal {same}, flag {flag}, bytes differ for "
                f"images {mismatched[:8]}")
        on_word = int((totals % 32 == 0).sum())
        log(f"k3 {tag} optimize={optimize} blocks={packed.shape[1]}x{n}"
            f" scan_bits={int(totals.sum())} words={nw} images ending on "
            f"a word={on_word}: K3a totals, bits and histograms and K3b "
            f"words bit-identical to the plain version; {n} file(s) "
            f"byte-identical to the C++ encoder")
        if not timed:
            continue
        times[optimize] = time_k3_case(dev, first, packed, lay, tables, wb,
                                       nw, h, w, sub, quality, optimize)
        log(f"k3 time {tag} optimize={optimize}: " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in times[optimize].items()))
    return worst, times


def time_k3_case(dev, first, packed, lay, tables, wb, nw, h, w, sub,
                 quality, optimize):
    """Device ms (torch.profiler rows), host us per call, bound and share
    of K3a as this route calls it (with histograms under the standard
    tables for optimal tables, the totals alone otherwise), of K3a's
    totals alone (the size oracle's call) and of K3b; the plain version's
    CUDA-event ms; the same for the first K3, in turns (first, current,
    current, first); and the whole emission against the host route."""
    from fennec_tpu_torch.codecs.jpeg import encode_quantized
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.jpeg_emit import (
        block_stats_plain,
        deposit_plain,
        std_tables_on,
    )
    from fennec_tpu_torch.parallel.batched import emit_scans

    iters = 50
    n = packed.shape[0]
    std = std_tables_on(dev)
    word_base = wb if n > 1 else None
    calls = {
        "k3a": ((lambda: k3.block_stats(packed, lay, std, False, True))
                if optimize else (lambda: k3.block_stats(packed, lay, std))),
        "k4": lambda: k3.block_stats(packed, lay, std),
        "k3b": lambda: k3.deposit(packed, lay, tables, word_base, nw),
    }
    names = {"k3a": "block_stats_kernel", "k4": "block_stats_kernel",
             "k3b": "deposit_kernel"}
    t = {}
    if first is not None:
        bits = first.block_stats(packed, lay, tables, True, False)[0]
        off = torch.cumsum(bits, 1, dtype=torch.int64) - bits
        first_calls = {
            "k3a": ((lambda: first.block_stats(packed, lay, std, False,
                                               True)) if optimize else
                    (lambda: first.block_stats(packed, lay, std, True,
                                               False))),
            "k3b": lambda: first.deposit(packed, lay, tables, off, wb, nw),
        }
        order = ("first", "cur", "cur", "first")
    else:
        order = ("cur",)
    for part in ("k3a", "k3b"):
        turns = []  # (who, device ms, host us), in the order run
        for who in order:
            fn = calls[part] if who == "cur" else first_calls[part]
            turns.append((who, profiled_device_ms(fn, iters, names[part]),
                          host_us(fn, iters)))
        t[f"{part}_ms"] = min(ms for who, ms, _ in turns if who == "cur")
        t[f"{part}_host_us"] = min(us for who, _, us in turns
                                   if who == "cur")
        if first is not None:
            t[f"{part}_turns_us"] = [round(ms * 1e3, 2)
                                     for _, ms, _ in turns]
            t[f"{part}_first_ms"] = min(ms for who, ms, _ in turns
                                        if who == "first")
            t[f"{part}_first_host_us"] = min(us for who, _, us in turns
                                             if who == "first")
    t["k4_ms"] = profiled_device_ms(calls["k4"], iters, names["k4"])
    t["k4_host_us"] = host_us(calls["k4"], iters)
    t["k3a_plain_ms"] = cuda_ms(lambda: block_stats_plain(
        packed, lay, std, False, optimize), 5)
    t["k3b_plain_ms"] = cuda_ms(lambda: deposit_plain(
        packed, lay, tables, wb), 5)
    for part, kind in (("k3a", "hist" if optimize else "total"),
                       ("k4", "total"), ("k3b", "deposit")):
        t[f"{part}_bound_ms"], t[f"{part}_bound_by"] = k3_bound(
            packed, nw, kind)
        t[f"{part}_share"] = t[f"{part}_bound_ms"] / t[f"{part}_ms"]
    # The whole device emission (launches, both pulls, the host K.2
    # build) now and through the first K3's flow, in turns, and the host
    # route: one download of the blocks and the C++ encoder.
    ny = lay.ny
    nc = (packed.shape[1] - ny) // 2
    emit = {"first": [], "cur": []}
    for who in order:
        fn = ((lambda: emit_scans(packed, h, w, sub, optimize))
              if who == "cur" else
              (lambda: first.emit_words(packed, lay, optimize)))
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        emit[who].append((time.perf_counter() - t0) / 3 * 1e3)
    t["emit_scans_ms"] = min(emit["cur"])
    t["emit_device_ms"], t["emit_device_ops"] = profiled_all_device(
        lambda: emit_scans(packed, h, w, sub, optimize), 10)
    if first is not None:
        t["emit_first_ms"] = min(emit["first"])
        t["emit_first_device_ms"], t["emit_first_device_ops"] = (
            profiled_all_device(
                lambda: first.emit_words(packed, lay, optimize), 10))
    t0 = time.perf_counter()
    for _ in range(3):
        blocks = packed.cpu().numpy().astype(np.int32)
        for j in range(n):
            encode_quantized(blocks[j, :ny], blocks[j, ny:ny + nc],
                             blocks[j, ny + nc:], w, h, quality, sub,
                             optimize)
    t["host_encode_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    return t


def phase_k3(T, dev, cases, timed: bool = True, first=None, seams=None):
    """K3 against its plain version at the main path's shapes (photos
    quantized on the card) and at synthetic blocks that cross the
    design's seams (k3_seam_cases unless given).  `first` is a FirstK3 to
    be held to the same words and timed in turns.  Returns (the largest
    absolute difference seen, {(tag, optimize): times}, empty unless
    timed)."""
    times = {}
    worst = 0
    for tag, w, h, n, sub, quality, seed in cases:
        images = [photo(w, h, seed + k) for k in range(n)]
        packed = quantized_stack(images, quality, sub, dev)
        err, got = check_k3_case(dev, first, tag, packed, w, h, sub, quality,
                                 timed and n * packed.shape[1] > 1000)
        worst = max(worst, err)
        times.update({(tag, opt): t for opt, t in got.items()})
    for tag, w, h, n, sub, kind, seed in (k3_seam_cases() if seams is None
                                          else seams):
        packed = torch.from_numpy(synthetic_blocks(h, w, sub, n, seed,
                                                   kind)).to(dev)
        err, _ = check_k3_case(dev, first, tag, packed, w, h, sub, 50, False)
        worst = max(worst, err)
    # An image whose bits end exactly on a word: among many small images
    # some do; they are coded alone and together.
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.jpeg_emit import layout_on, std_tables_on

    many = torch.from_numpy(synthetic_blocks(16, 32, True, 256, 11,
                                             "sparse")).to(dev)
    totals = k3.block_stats(many, layout_on(16, 32, True, dev),
                            std_tables_on(dev)).totals.cpu().numpy()
    on_word = np.nonzero(totals % 32 == 0)[0]
    if on_word.size == 0:
        raise AssertionError("K3: no image of 256 ends on a word")
    picked = many[torch.from_numpy(on_word).to(dev)].contiguous()
    for tag, blocks in (("on_word_alone", picked[:1]),
                        ("on_word_batch", picked)):
        err, _ = check_k3_case(dev, first, tag, blocks.contiguous(), 32, 16,
                               True, 50, False)
        worst = max(worst, err)
    return worst, times


# ── Phase 16: K5, the device K.2 table build ────────────────────────────────

# The first K5 (PR 12's design: one warp reduction per K.2 merge), kept to
# be held bit for bit and timed in turns against the current one.
FIRST_K5_SOURCE = os.path.join("bench_sources", "huffbuild_first.cu")
# K5's bound (csrc/huffbuild.cu): the larger of its bytes (each image's
# 544 histogram counts read once, its tables and header written once, the
# standard tables read once) at 3.35 TB/s and its thread instructions at
# the issue rate, counted from the kernel for this run's tables of n live
# chains: the bitonic network it runs over the 32 E keys that hold n (E
# the least of 1, 2, 4, 8, 16), P log2 P (log2 P + 1) / 4 compare-
# exchanges for P = 32 E, each a 64-bit compare and two 64-bit selects
# (6); the walk, n - 1 merges on one lane (four loads, three 64-bit
# compares, the selects, the children's store, the sum and its store, the
# heads: 24); the depths, ceil(log2 D) rounds of pointer doubling over the
# n - 1 merges (D the deepest merge's depth, at least one round), each
# merge's step two loads, its ancestor's two, an add, a compare and two
# stores (8); the rest per table over 32 lanes (loads, compaction, the
# parents, the sizes, a match per slot, three scans, the codes' searches,
# the writes: about 400 a lane).  Beside it the serial chain no width
# hides: the longest table's merges, each at least one link of the walk
# (a shared-memory load whose index came from the last merge's compare)
# and one more 64-bit compare and select, at the latencies the stamped
# build measures in this run (fennec_huff_step_cycles, K5Build.
# step_cycles) and an H100 SXM's 1.98 GHz.
K5_INSTR_PER_EXCHANGE = 6
K5_INSTR_PER_MERGE = 24
K5_INSTR_PER_DOUBLING = 8
K5_INSTR_PER_TABLE = 32 * 400
SM_CLOCK_HZ = 1.98e9


def k5_families():
    """(tag, (B, 544) int32 histograms) that cross K5's seams, made with
    numpy: random dense counts, sparse counts full of ties, a single
    symbol and empty classes (a grey image's chroma), heavy skew, 36
    Fibonacci counts (lengths past 16: K.3 redistributes), 34 counts
    that need a code of 34 bits (flagged) among good images, every
    symbol near 2^24 (merged frequencies past 2^31), a batch of 64
    mixing all of them, and a photo at high quality: all 162 AC symbols
    of a baseline scan live in every AC table."""
    rng = np.random.default_rng(SEED + 16)

    def hist(dc, ac):
        b = dc.shape[0]
        return np.concatenate([dc.reshape(b, 32), ac.reshape(b, 512)],
                              1).astype(np.int32)

    def chain(n, step):
        out = [1, 1]
        while len(out) < n:
            out.append(out[-1] + out[-2] + step)
        return out[:n]

    fams = [("dense", hist(rng.integers(0, 50_000, (8, 2, 16)),
                           rng.integers(0, 50_000, (8, 2, 256))))]
    dc = np.zeros((8, 2, 16), np.int64)
    ac = np.zeros((8, 2, 256), np.int64)
    for j in range(8):
        for c in range(2):
            k = rng.integers(1, 12)
            dc[j, c, rng.choice(16, k, replace=False)] = rng.integers(1, 10, k)
            k = rng.integers(1, 80)
            ac[j, c, rng.choice(256, k, replace=False)] = rng.integers(1, 8, k)
    fams.append(("sparse_ties", hist(dc, ac)))
    dc = np.zeros((5, 2, 16), np.int64)
    ac = np.zeros((5, 2, 256), np.int64)
    dc[0, 0, 5] = 100
    ac[1, 1, 0xF0] = 1
    dc[2] = 1
    ac[3, 0, :8] = 7
    dc[4, 0, 3], ac[4, 0, 1] = 9, 4
    fams.append(("single_and_empty", hist(dc, ac)))
    dc = np.zeros((2, 2, 16), np.int64)
    ac = np.zeros((2, 2, 256), np.int64)
    dc[0, 0] = [min(1 << s, 1 << 28) for s in range(16)]
    f = 1
    for s in range(40):
        ac[0, 0, s] = max(1, f)
        f = int(f * 1.6) + 1
        f = 1 if f > 1 << 27 else f
    dc[1] = 1
    ac[1, :, ::3] = 2
    fams.append(("skewed", hist(dc, ac)))
    dc = np.ones((3, 2, 16), np.int64)
    ac = rng.integers(1, 100, (3, 2, 256))
    ac[0, 0] = 0
    ac[0, 0, :36] = chain(36, 0)
    ac[1, 0] = 0
    ac[1, 0, :34] = chain(34, 1)
    fams.append(("fibonacci_and_past_32", hist(dc, ac)))
    fams.append(("counts_near_2^24", hist(
        rng.integers(1 << 23, 1 << 24, (2, 2, 16)),
        rng.integers(1 << 23, 1 << 24, (2, 2, 256)))))
    mixed = np.concatenate([h for _, h in fams])
    fams.append(("batch64_mixed", mixed[rng.integers(0, len(mixed), 64)]))
    # High quality: run r (0-15) and size s (1-10) at counts falling with
    # both as a photo's do, EOB and ZRL; DC sizes 0-11.
    dc = np.zeros((4, 2, 16), np.int64)
    ac = np.zeros((4, 2, 256), np.int64)
    run, size = np.meshgrid(np.arange(16), np.arange(1, 11), indexing="ij")
    for j in range(4):
        for c in range(2):
            scale = 2e6 / (1 + 3 * c) / (1 + j)
            f = scale * np.exp(-0.55 * size - 0.35 * run) * rng.uniform(
                0.7, 1.3, run.shape)
            ac[j, c, (16 * run + size).ravel()] = np.maximum(
                1, f.ravel().astype(np.int64))
            ac[j, c, 0x00] = int(0.2 * scale)
            ac[j, c, 0xF0] = max(1, int(2e-3 * scale))
            dc[j, c, :12] = np.maximum(1, (scale / 40 * np.exp(
                -0.4 * np.abs(np.arange(12) - 4))).astype(np.int64))
    fams.append(("ac_162_live", hist(dc, ac)))
    return fams


def live_symbols(hist: np.ndarray) -> list:
    """The most live symbols of each table [dc-luma, dc-chroma, ac-luma,
    ac-chroma] over a batch of (B, 544) histograms."""
    bsz = hist.shape[0]
    dc = (hist[:, :32].reshape(bsz, 2, 16) > 0).sum(-1)
    ac = (hist[:, 32:].reshape(bsz, 2, 256) > 0).sum(-1)
    return np.concatenate([dc, ac], 1).max(0).tolist()


def k5_bound(hist: np.ndarray, step: dict):
    """(least ms, "operations" or "bytes", serial-chain ms) of one K5
    launch on these histograms (see K5_INSTR_PER_EXCHANGE), the chain at
    `step`'s measured cycles of a link and of a compare."""
    from fennec_tpu_torch.ops.huffbuild import _merge_codesizes

    bsz = hist.shape[0]
    freq = np.zeros((bsz, 4, 257), np.int64)
    freq[:, :2, :16] = hist[:, :32].reshape(bsz, 2, 16)
    freq[:, 2:, :256] = hist[:, 32:].reshape(bsz, 2, 256)
    freq[:, :, 0] += freq.sum(axis=2) == 0  # an empty class codes 0
    freq[:, :, 256] = 1  # the reserved symbol
    chains = (freq > 0).sum(axis=2).ravel()
    width = np.maximum(32, 1 << np.ceil(np.log2(chains)).astype(np.int64))
    lg = np.log2(width).astype(np.int64)
    exchanges = int((width * lg * (lg + 1) // 4).sum())
    deepest = _merge_codesizes(torch.from_numpy(
        freq.reshape(-1, 257))).max(dim=1).values.numpy() - 1
    rounds = np.maximum(1, np.ceil(np.log2(np.maximum(deepest, 1))))
    nbytes = bsz * 4 * (544 + 2 * 272 + 208) + 4 * 2 * 272
    ops = (K5_INSTR_PER_EXCHANGE * exchanges
           + K5_INSTR_PER_MERGE * int((chains - 1).sum())
           + K5_INSTR_PER_DOUBLING * int((rounds * (chains - 1)).sum())
           + 4 * bsz * K5_INSTR_PER_TABLE)
    t_ops, t_bytes = ops / INT_ISSUE_PER_S, nbytes / HBM_BYTES_PER_S
    chain = (int((chains - 1).max()) * (step["link"] + step["compare"])
             / SM_CLOCK_HZ)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", chain * 1e3)


class K5Build:
    """A K5 source built here with nvcc (FIRST_K5_SOURCE; or a source
    with -DK5_STAMPS, which records clock64() at each phase boundary of
    every warp and, for the current source, times the walk's dependent
    steps) and called as PR 12's wrapper called it: the inputs and
    the standard tables checked on every call, one torch.empty and two
    views, one launch on the current stream.  The port does not import
    it."""

    def __init__(self, source: str, tag: str, stamps: bool = False) -> None:
        import ctypes

        from fennec_tpu_torch.ops import huffbuild_cuda as k5
        from fennec_tpu_torch.ops.ssim_cuda import compile_library

        so = os.path.join(k5.BUILD_DIR, f"libhuffbuild_{tag}.so")
        self.build_log = compile_library(
            os.path.join(HERE, source), so,
            list(k5.NVCC_FLAGS) + (["-DK5_STAMPS"] if stamps else []))
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fennec_huff_build.restype = i
        lib.fennec_huff_build.argtypes = [p, i, p, p, p, p]
        self.names = []
        if stamps:
            lib.fennec_huff_stamps.restype = i
            lib.fennec_huff_stamps.argtypes = [p]
            lib.fennec_huff_stamp_names.restype = ctypes.c_char_p
            self.names = lib.fennec_huff_stamp_names().decode().split(",")
        self.lib = lib
        self.tag = tag

    def check(self, hist: torch.Tensor, std: torch.Tensor) -> None:
        """The inputs and the standard tables, every call."""
        from fennec_tpu_torch.ops.huffbuild_cuda import check_hist

        check_hist(hist, std)
        if hist.device.index != torch.cuda.current_device():
            raise ValueError(f"K5 {self.tag}: histograms on {hist.device}, "
                             f"not the current device")

    @staticmethod
    def outputs(hist: torch.Tensor) -> tuple:
        """(tables, header): one torch.empty, two slices and views."""
        from fennec_tpu_torch.ops.huffbuild import OPT_HDR
        from fennec_tpu_torch.ops.jpeg_emit import TABLE

        bsz = hist.shape[0]
        out = torch.empty(bsz * (2 * TABLE + OPT_HDR), dtype=torch.int32,
                          device=hist.device)
        return (out[:bsz * 2 * TABLE].view(bsz, 2, TABLE),
                out[bsz * 2 * TABLE:].view(bsz, OPT_HDR))

    def __call__(self, hist: torch.Tensor, std: torch.Tensor):
        from fennec_tpu_torch.ops.huffbuild import Built

        self.check(hist, std)
        dev = hist.device
        bsz = hist.shape[0]
        tables, header = self.outputs(hist)
        err = self.lib.fennec_huff_build(
            hist.data_ptr(), bsz, std.data_ptr(), tables.data_ptr(),
            header.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
        if err:
            raise RuntimeError(f"K5 {self.tag}: CUDA error {err}")
        return Built(tables, header)

    def step_cycles(self, steps: int = 4096) -> dict:
        """A stamped build's latency of the walk's dependent steps, in
        cycles on one lane (the second of two runs): "link", a shared-
        memory load of a key whose index came from the last link's 64-bit
        compare; "compare", a 64-bit compare and select on the last one's
        result."""
        import ctypes

        fn = self.lib.fennec_huff_step_cycles
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        out = np.zeros(4, np.int64)
        for _ in range(2):
            err = fn(out.ctypes.data, steps)
            if err:
                raise RuntimeError(f"K5 {self.tag}: step cycles: CUDA "
                                   f"error {err}")
        return {"link": int(out[0]), "compare": int(out[1])}

    def stamps(self) -> np.ndarray:
        """(64, 4, 12) int64: the last launch's clock64() per image (the
        first 64), warp and phase boundary (`names`), the warp's merge
        count in the last slot."""
        torch.cuda.synchronize()
        out = np.zeros((64, 4, 12), np.int64)
        err = self.lib.fennec_huff_stamps(out.ctypes.data)
        if err:
            raise RuntimeError(f"K5 {self.tag}: stamps: CUDA error {err}")
        return out


def k5_split(build: K5Build, hist: torch.Tensor) -> dict:
    """Where one launch of a stamped K5 build spends its cycles, on these
    histograms (the second of two launches): each phase's clock64()
    cycles, the mean over the first 64 images of the DC warps' and of
    the AC warps'; an image's cycles from its first warp's start to its
    last warp's end (mean and max); the most merges of a table; and the
    cycles per merge of the merge phase (median over the tables of at
    least 16 merges, else of any)."""
    from fennec_tpu_torch.ops.jpeg_emit import std_tables_on

    std = std_tables_on(hist.device)
    build(hist, std)
    build(hist, std)
    st = build.stamps()[:min(64, hist.shape[0])]
    n = len(build.names)
    cyc = np.diff(st[..., :n], axis=-1)  # (B, 4, n - 1)
    merges = st[..., -1]
    out = {"phases": build.names[1:],
           "dc_cycles": cyc[:, :2].mean(axis=(0, 1)).round(1).tolist(),
           "ac_cycles": cyc[:, 2:].mean(axis=(0, 1)).round(1).tolist()}
    whole = st[..., n - 1].max(1) - st[..., 0].min(1)
    out["image_cycles"] = float(whole.mean())
    out["image_cycles_max"] = int(whole.max())
    out["merges_max"] = int(merges.max())
    walk = cyc[..., build.names.index("merges") - 1]
    big = merges >= 16 if (merges >= 16).any() else merges >= 1
    out["cycles_per_merge"] = float(np.median(walk[big] / merges[big]))
    return out


def check_k5(tag: str, hist: torch.Tensor, first=None) -> int:
    """K5 on (B, 544) int32 histograms on the card against its plain
    version on the same tensors (tables and header bit for bit: scan
    bits, flags, specs), against the first K5 (`first`, a K5Build; bit
    for bit) and against the host C++ builder (_optimal_tables and
    hist_bits: the same tables, specs and bits, and an error for exactly
    the images K5 flags, which get the standard tables).  Returns the
    largest absolute difference from the plain version."""
    from fennec_tpu_torch.ops import huffbuild_cuda as k5
    from fennec_tpu_torch.ops.huffbuild import build_plain
    from fennec_tpu_torch.ops.jpeg_emit import std_tables_on
    from fennec_tpu_torch.parallel.batched import (
        _optimal_tables,
        hist_bits,
        specs_from_opt_header,
        split_opt_header,
    )

    std = std_tables_on(hist.device)
    got = k5.build_tables(hist, std)
    again = k5.build_tables(hist, std)
    want = build_plain(hist, std)
    old = first(hist, std) if first is not None else want
    if hist.device.type == "cuda":
        torch.cuda.synchronize()
    worst = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in ((got.tables, want.tables),
                             (got.header, want.header)))
    if not (torch.equal(got.tables, want.tables)
            and torch.equal(got.header, want.header)
            and torch.equal(got.header, again.header)):
        raise AssertionError(f"K5 {tag}: tables/header differ from the "
                             f"plain version (largest difference {worst}) "
                             f"or between two calls")
    if not (torch.equal(got.tables, old.tables)
            and torch.equal(got.header, old.header)):
        raise AssertionError(f"K5 {tag}: tables/header differ from the "
                             f"first K5's")
    h = hist.cpu().numpy().astype(np.int64)
    dcf, acf = h[:, :32].reshape(-1, 2, 16), h[:, 32:].reshape(-1, 2, 256)
    specs, tables, errors = _optimal_tables(dcf, acf)
    bits, flagged, bits16, nvals, vals = split_opt_header(
        got.header.cpu().numpy())
    tables = np.where(flagged[:, None, None], std.cpu().numpy(), tables)
    bad = [j for j in range(h.shape[0]) if not flagged[j]
           and specs_from_opt_header(bits16, nvals, vals, j) != specs[j]]
    if (sorted(errors) != np.nonzero(flagged)[0].tolist()
            or not np.array_equal(got.tables.cpu().numpy(), tables)
            or not np.array_equal(bits, hist_bits(dcf, acf, tables))
            or bad):
        raise AssertionError(f"K5 {tag}: against the host builder: errors "
                             f"{sorted(errors)} flagged "
                             f"{np.nonzero(flagged)[0].tolist()}, specs "
                             f"differ for {bad[:8]}")
    log(f"k5 {tag} B={h.shape[0]} live={live_symbols(h)} flagged="
        f"{int(flagged.sum())} scan_bits={int(bits.sum())}: tables, bits16, "
        f"vals, nvals, overflow and scan bits bit-identical to the plain "
        f"version, the host C++ builder"
        f"{' and the first K5' if first is not None else ''}")
    return worst


def time_k5(hist: torch.Tensor, first, step: dict, walk_cycles: float,
            iters: int = 50) -> dict:
    """K5 and the first K5 (a K5Build) on the same histograms in turns
    (first, K5, K5, first): each turn's device ms (torch.profiler rows),
    CUDA-event ms and host µs per call, the least of each over its two
    turns, and the turns; K5's bound and share, and its serial chain at
    `step` (K5Build.step_cycles); beside them `walk_cycles`, the stamped
    build's cycles a merge of the shipped walk (k5_split), a diagnostic,
    not a bound; the plain version's CUDA-event ms; the host C++ builder's ms on the same
    histograms (_optimal_tables and hist_bits on host arrays, the
    download not counted)."""
    from fennec_tpu_torch.ops import huffbuild_cuda as k5
    from fennec_tpu_torch.ops.huffbuild import build_plain
    from fennec_tpu_torch.ops.jpeg_emit import std_tables_on
    from fennec_tpu_torch.parallel.batched import _optimal_tables, hist_bits

    std = std_tables_on(hist.device)
    runs = {"k5": lambda: k5.build_tables(hist, std),
            "first": lambda: first(hist, std)}
    turns = {"k5": [], "first": []}
    for who in ("first", "k5", "k5", "first"):
        fn = runs[who]
        turns[who].append((profiled_device_ms(fn, iters, "huff_build_kernel"),
                           cuda_ms(fn, iters), host_us(fn, iters)))
    h = hist.cpu().numpy()
    t = {"shape": list(hist.shape), "live": live_symbols(h)}
    for who, pre in (("k5", ""), ("first", "first_")):
        dev_ms, ev_ms, h_us = zip(*turns[who])
        t[pre + "ms"] = min(dev_ms)
        t[pre + "event_ms"] = min(ev_ms)
        t[pre + "host_us"] = min(h_us)
    t["turns"] = {who: [[round(x, 6) for x in turn] for turn in v]
                  for who, v in turns.items()}
    t["plain_ms"] = cuda_ms(lambda: build_plain(hist, std), 3)
    h = h.astype(np.int64)
    dcf, acf = h[:, :32].reshape(-1, 2, 16), h[:, 32:].reshape(-1, 2, 256)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        hist_bits(dcf, acf, _optimal_tables(dcf, acf)[1])
    t["host_builder_ms"] = (time.perf_counter() - t0) / reps * 1e3
    t["bound_ms"], t["bound_by"], t["chain_ms"] = k5_bound(
        hist.cpu().numpy(), step)
    t["link_cycles"], t["compare_cycles"] = step["link"], step["compare"]
    t["walk_cycles_per_merge"] = walk_cycles
    t["share"] = t["bound_ms"] / t["ms"]
    return t


def k5_host_split(hist: torch.Tensor, first, iters: int = 300) -> dict:
    """Host µs of each part of a K5 call, each part timed alone over
    `iters` calls, for the port's wrapper (ops/huffbuild_cuda.build_tables)
    and for the first K5's (`first`, a K5Build, called as PR 12's wrapper
    called it): its input check, its outputs' allocation and its ctypes
    launch on ready buffers, then the whole call; and, shared by both,
    torch.cuda.current_device() and the stream lookup."""
    from fennec_tpu_torch.ops import huffbuild_cuda as k5
    from fennec_tpu_torch.ops.jpeg_emit import std_tables_on
    from fennec_tpu_torch.ops.jpeg_emit_cuda import _stream

    dev = hist.device
    std = std_tables_on(dev)
    bsz = hist.shape[0]
    stream = _stream(dev)
    parts = {"current_device": torch.cuda.current_device,
             "stream": lambda: _stream(dev)}
    for pre, build, lib in (("", k5.build_tables, k5.library.load()),
                            ("first_", first, first.lib)):
        tables, header = build.outputs(hist)
        parts.update({
            pre + "check": lambda build=build: build.check(hist, std),
            pre + "outputs": lambda build=build: build.outputs(hist),
            pre + "launch": lambda lib=lib, t=tables, h=header: (
                lib.fennec_huff_build(hist.data_ptr(), bsz, std.data_ptr(),
                                      t.data_ptr(), h.data_ptr(), stream)),
            pre + "call": lambda build=build: build(hist, std)})
    got = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        got[name] = (time.perf_counter() - t) / iters * 1e6
        torch.cuda.synchronize()
    return got


def header_pull_ab(hist: torch.Tensor, reps: int = 200) -> dict:
    """The emission's pull of K5's header three ways, in turns (pageable,
    cached, fresh, fresh, cached, pageable): pageable, header.cpu().numpy()
    as PR 12's emit_scans made it; cached, ops/huffbuild_cuda.pull_header
    (a pinned buffer the thread keeps for its last row count, copied
    out); fresh, a new
    pinned tensor per call (PyTorch's caching host allocator) copied into.
    Host µs per pull, each turn's and the least of each; the arrays
    equal."""
    from fennec_tpu_torch.ops import huffbuild_cuda as k5
    from fennec_tpu_torch.ops.jpeg_emit import std_tables_on

    header = k5.build_tables(hist, std_tables_on(hist.device)).header
    runs = {"pageable": lambda: header.cpu().numpy(),
            "cached": lambda: k5.pull_header(header),
            "fresh": lambda: torch.empty(
                header.shape, dtype=torch.int32,
                pin_memory=True).copy_(header).numpy()}
    want = runs["pageable"]()
    if not all(np.array_equal(want, fn()) for fn in runs.values()):
        raise AssertionError("the header's pulls differ")
    turns = {who: [] for who in runs}
    for who in ("pageable", "cached", "fresh", "fresh", "cached",
                "pageable"):
        fn = runs[who]
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        turns[who].append(round((time.perf_counter() - t) / reps * 1e6, 3))
    return {"turns_us": turns, **{k: min(v) for k, v in turns.items()}}


def host_built_emit(packed: torch.Tensor, h: int, w: int, sub: bool):
    """The host-built optimal emission (the flow before K5), composed
    here: K3a, the histograms down, the C++ K.2 build and hist_bits on
    the host, emit_custom (one upload of the tables and word bases, K3b),
    the words down.  Returns a HostScans."""
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.jpeg_emit import layout_on, std_tables_on
    from fennec_tpu_torch.parallel.batched import (
        HostScans,
        _optimal_tables,
        emit_custom,
        hist_bits,
        pull_emit_words,
    )

    mult = 16 if sub else 8
    lay = layout_on(h + (-h) % mult, w + (-w) % mult, sub, packed.device)
    hist = k3.block_stats.launch(packed, lay, std_tables_on(packed.device),
                                 want_hist=True).hist.cpu().numpy()
    dcf = hist[:, :32].reshape(-1, 2, 16).astype(np.int64)
    acf = hist[:, 32:].reshape(-1, 2, 256).astype(np.int64)
    specs, tables, errors = _optimal_tables(dcf, acf)
    scans = emit_custom(packed, lay, tables, hist_bits(dcf, acf, tables))
    return HostScans(pull_emit_words(scans), scans.bits, scans.base, specs,
                     errors)


def time_emission_in_turns(tag: str, packed, h: int, w: int, sub: bool,
                           quality: int, reps: int = 10) -> dict:
    """The whole optimal emission, emit_scans (K3a, K5, one pull of the
    header, K3b, the words) against host_built_emit, in turns (host, K5,
    K5, host): host-clock ms per call (each ends in a pull) and CUDA-event
    ms per call; every image's bytes equal."""
    from fennec_tpu_torch.parallel.batched import emit_scans

    runs = {"k5": lambda: emit_scans(packed, h, w, sub, True),
            "host": lambda: host_built_emit(packed, h, w, sub)}
    a, b = runs["k5"](), runs["host"]()
    diff = [j for j in range(packed.shape[0])
            if a.jpeg(j, w, h, quality, sub) != b.jpeg(j, w, h, quality, sub)]
    if diff or a.specs != b.specs:
        raise AssertionError(f"emission {tag}: K5's flow and the host-built "
                             f"flow differ for images {diff[:8]}")
    got = {"k5": [], "host": [], "k5_event": [], "host_event": []}
    for who in ("host", "k5", "k5", "host"):
        fn = runs[who]
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        got[who].append((time.perf_counter() - t0) / reps * 1e3)
        got[f"{who}_event"].append(cuda_ms(fn, reps))
    out = {k: min(v) for k, v in got.items()}
    out["turns_ms"] = [round(v, 4) for v in got["host"][:1] + got["k5"]
                       + got["host"][1:]]
    log(f"emission {tag} B={packed.shape[0]}: bytes equal; K5 flow host "
        f"{out['k5']:.4f} ms event {out['k5_event']:.4f} ms, host-built "
        f"flow host {out['host']:.4f} ms event {out['host_event']:.4f} ms "
        f"(turns host, K5, K5, host: {out['turns_ms']})")
    return out


# The histograms of the main path's emissions (phase 4), recorded at K5's
# call (record_k5_inputs) to be checked in phase 16.
K5_INPUTS = {}


@contextlib.contextmanager
def record_k5_inputs(tag: str):
    """While active, every emission's histograms, as parallel/batched
    hands them to K5, are kept in K5_INPUTS under `tag` (a copy on the
    card).  K5's own count is untouched."""
    from fennec_tpu_torch.parallel import batched

    real = batched.build_tables

    def recorded(hist, std):
        K5_INPUTS[tag] = hist.clone()
        return real(hist, std)

    batched.build_tables = recorded
    try:
        yield
    finally:
        batched.build_tables = real


# Phase 16's cases beyond phase 11's shapes, at high quality (many live
# AC symbols, so many merges): the 12 MP photo at Q95 and Q100 and a
# 64-image 500x500 chunk at Q95.
K5_HIGH = [("12mp_420_q95", 4032, 3024, 1, True, 95, SEED),
           ("12mp_420_q100", 4032, 3024, 1, True, 100, SEED),
           ("500x500x64_420_q95", 500, 500, 64, True, 95, SEED + 100)]
# The cases timed in turns against the first K5: (a) B = 1 at BALANCED,
# (b) B = 64 at BALANCED, (c) high quality.
K5_TIMED = ["12mp_420", "500x500x64_420", "12mp_420_q95", "12mp_420_q100",
            "500x500x64_420_q95", "ac_162_live"]


def phase_k5(T, dev, quality, first, stamped) -> tuple:
    """Phase 16: K5 bit-equal to its plain version, the first K5 (`first`,
    a K5Build) and the host C++ builder on phase 4's histograms, the 12
    MP and 1080p photos and a 64 x 500x500 chunk at BALANCED's qualities
    and at high quality (K5_HIGH), and k5_families; each stamped build of
    `stamped` ({name: K5Build}) split by phase on K5_TIMED's cases; K5
    timed in turns with the first K5 on those cases beside its bound, the
    plain version and the host builder; the host µs of a call's parts;
    the header's pull three ways; the whole emission
    against the host-built flow in turns at 12 MP and 64 x 500x500.
    `quality`: BALANCED's qualities (12 MP, 1080p, 500x500).  Returns
    (largest difference, {case: K5 times}, {case: emission times},
    {"build case": split})."""
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.jpeg_emit import layout_on, std_tables_on

    worst = 0
    for tag, hist in sorted(K5_INPUTS.items()):
        worst = max(worst, check_k5(f"phase4_{tag}", hist, first))
    hists, stacks, images = {}, {}, {}
    for tag, w, h, n, sub, q, seed in k3_cases(*quality)[:3] + K5_HIGH:
        if (w, h, n, seed) not in images:
            images[(w, h, n, seed)] = [photo(w, h, seed + k)
                                       for k in range(n)]
        packed = quantized_stack(images[(w, h, n, seed)], q, sub, dev)
        mult = 16 if sub else 8
        hist = k3.block_stats(packed, layout_on(
            h + (-h) % mult, w + (-w) % mult, sub, dev),
            std_tables_on(dev), want_hist=True).hist
        worst = max(worst, check_k5(tag, hist, first))
        hists[tag] = hist
        stacks[tag] = (packed, w, h, sub, q)
    del images
    for tag, hist in k5_families():
        hists[tag] = torch.from_numpy(hist).to(dev)
        worst = max(worst, check_k5(tag, hists[tag], first))
    splits = {}
    for tag in K5_TIMED:
        for who, build in stamped.items():
            split = splits[f"{who} {tag}"] = k5_split(build, hists[tag])
            log(f"k5 split {who} {tag}: " + json.dumps(split))
    step = stamped["k5"].step_cycles()
    log(f"k5 step cycles (one lane): link {step['link']} (a shared-memory "
        f"load of a 64-bit key indexed by the last compare), compare "
        f"{step['compare']} (a 64-bit compare and select)")
    times, emits = {}, {}
    for tag in K5_TIMED:
        times[tag] = time_k5(hists[tag], first, step,
                             splits[f"k5 {tag}"]["cycles_per_merge"])
        log(f"k5 time {tag}: " + " ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in times[tag].items()))
    for tag in ("12mp_420", "500x500x64_420"):
        log(f"k5 host split {tag} (us per call): " + json.dumps(
            {k: round(v, 3) for k, v in k5_host_split(hists[tag],
                                                      first).items()}))
        log(f"k5 header pull {tag} (us): "
            + json.dumps(header_pull_ab(hists[tag])))
        packed, w, h, sub, q = stacks[tag]
        emits[tag] = time_emission_in_turns(tag, packed, h, w, sub, q)
    return worst, times, emits, splits


# Over every replay of check_result: the probes scored by both routes,
# the largest |SSIM difference| between K2 + K1 and the plain scorer, and
# the decisions (s >= target) on which they differ.
REPLAY = {"probes": 0, "max_ssim_diff": 0.0, "flips": []}


def check_result(T, res, dev, target: float, expect_wh, tag: str,
                 src_img=None):
    """Decode, SSIM target, decode-scored SSIM and boundary decisions.
    src_img is the image the search saw (res.image unless given: the
    coefficient path keeps no pixels on the host)."""
    from fennec_tpu_torch.engine.compress import (
        _seed_lo,
        prepare_search,
        probe_luminance,
        probe_luminance_plain,
    )
    from fennec_tpu_torch.ops.ssim import batched_ssim_plain
    from fennec_tpu_torch.ops.ssim_cuda import ssim_window

    target = 0.999 if target >= 1.0 else target
    if res.format != T.JPEG:
        raise AssertionError(f"{tag}: expected JPEG, got {res.format}")
    out = T.codecs.decode_image(res.compressed_data, device=dev)
    if (out.shape[1], out.shape[0]) != expect_wh or out.shape[2] != 4:
        raise AssertionError(f"{tag}: decoded {out.shape}, want "
                             f"{expect_wh}")
    fallback = res.jpeg_quality == 100 and res.ssim == 1.0
    if not (np.isfinite(res.ssim) and (res.ssim >= target or fallback)):
        raise AssertionError(f"{tag}: ssim {res.ssim} < target {target}")

    src_img = res.image if src_img is None else src_img
    src = torch.from_numpy(src_img).to(dev).to(torch.float32)
    inp, _ = prepare_search(src[None], True)
    t32 = torch.tensor(target, dtype=torch.float32, device=dev)
    windowed = min(inp.lum_orig.shape[1:]) > 8

    def plain(q: int) -> torch.Tensor:
        """The plain scorer: no kernel anywhere."""
        lum = probe_luminance_plain(inp, torch.tensor([q], device=dev))
        return batched_ssim_plain(inp.lum_orig, lum)[0]

    def kernels(q: int) -> torch.Tensor:
        """The search's scorer: K2, then K1."""
        lum = probe_luminance(inp, torch.tensor([q], device=dev))
        return ssim_window(inp.lum_orig, lum)[0]

    q = res.jpeg_quality
    s_q = plain(q)
    if bool(s_q >= t32):
        if abs(float(s_q) - res.ssim) > K1_ATOL:
            raise AssertionError(f"{tag}: kernel ssim {res.ssim} vs plain "
                                 f"{float(s_q)} at q={q}")
    elif not fallback:
        raise AssertionError(f"{tag}: plain rejects the chosen q={q} "
                             f"({float(s_q)} < {target})")
    checked = [q]
    lo0 = _seed_lo(target)
    if q > lo0:
        s_prev = plain(q - 1)
        if bool(s_prev >= t32):
            raise AssertionError(f"{tag}: plain accepts q-1={q - 1} "
                                 f"({float(s_prev)} >= {target})")
        checked.append(q - 1)

    # Replay the whole bisection with the plain scorer: every probe's
    # accept/reject must match the kernels' (K2 and K1 score the same
    # probe beside it), so it must end at the same quality.
    lo, hi, best = lo0, 100, (100, 1.0)
    while lo <= hi:
        mid = (lo + hi) // 2
        s_mid = plain(mid)
        REPLAY["probes"] += 1
        if dev.type == "cuda" and windowed:
            s_ker = kernels(mid)
            REPLAY["max_ssim_diff"] = max(REPLAY["max_ssim_diff"],
                                          abs(float(s_ker) - float(s_mid)))
            if bool(s_ker >= t32) != bool(s_mid >= t32):
                REPLAY["flips"].append((tag, mid, float(s_ker),
                                        float(s_mid), target))
        if bool(s_mid >= t32):
            best, hi = (mid, float(s_mid)), mid - 1
        else:
            lo = mid + 1
    if best[0] != q or abs(best[1] - res.ssim) > K1_ATOL:
        raise AssertionError(f"{tag}: plain bisection ends at {best}, the "
                             f"kernel's at ({q}, {res.ssim}); decisions "
                             f"that differ (input, q, kernels' score, plain "
                             f"score, target): {REPLAY['flips']}")

    dec = torch.from_numpy(out).to(dev).to(torch.float32)
    dec_inp, _ = prepare_search(dec[None], True)
    s_dec = float(batched_ssim_plain(inp.lum_orig, dec_inp.lum_orig)[0])
    if not fallback and abs(s_dec - res.ssim) > DECODE_SSIM_ATOL:
        raise AssertionError(f"{tag}: ssim of the decoded output {s_dec} "
                             f"vs reported {res.ssim}")
    return checked, s_dec


def check_contract(T, got, want, dev, tag: str) -> None:
    """A batch result against per-image compression of the same file."""
    a = T.codecs.decode_image(got.compressed_data, device=dev)
    b = T.codecs.decode_image(want.compressed_data, device=dev)
    diff = int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
    if (got.jpeg_quality != want.jpeg_quality
            or abs(got.ssim - want.ssim) > K1_ATOL
            or abs(got.compressed_size - want.compressed_size) > SIZE_ATOL
            or got.final_dimensions != want.final_dimensions
            or diff > PIXEL_ATOL):
        raise AssertionError(
            f"{tag}: batch q={got.jpeg_quality} ssim={got.ssim} "
            f"bytes={got.compressed_size} vs per-image q={want.jpeg_quality}"
            f" ssim={want.ssim} bytes={want.compressed_size}, pixels "
            f"differ by {diff}")


def exif_orientation_segment(orient: int) -> bytes:
    """A minimal APP1 EXIF segment holding only an orientation tag."""
    tiff = struct.pack(">2sHI", b"MM", 42, 8) + struct.pack(">H", 1)
    tiff += struct.pack(">HHIHH", 0x0112, 3, 1, orient, 0)
    tiff += struct.pack(">I", 0)
    payload = b"Exif\x00\x00" + tiff
    return b"\xFF\xE1" + struct.pack(">H", len(payload) + 2) + payload


def run_batch(T, ssim_window, counters, items, dev, tag: str,
              main: bool = True):
    """One compress_batch pass with the counts set to 0 just before it:
    every item through the coefficient route and, on a CUDA device, K1
    at least 7 times per device chunk and K3 coding every chunk.  Its
    launches count to the main path's totals unless main=False (phase
    17).  Returns (results, wall ms, K1 launches, engine counters)."""
    counters.reset()
    ssim_window.launches = 0
    k3_zero()
    t = time.perf_counter()
    res = T.compress_batch(None, items, T.BatchOptions(
        fused=True, default_opts=T.Options(format=T.JPEG)), device=dev)
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = ssim_window.launches
    snap = counters.snapshot()
    k3a, k3b, _ = k3_take(tag, dev, len(snap["chunk_items"]),
                          probes=7 * len(snap["chunk_items"]), main=main)
    log(f"{tag}: K3 launches K3a={k3a} K3b={k3b} for "
        f"{len(snap['chunk_items'])} chunks")
    bad = [(r.item.src, r.err) for r in res if r.err is not None]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} item(s) failed: {bad[:3]}")
    if snap["routes"] != {"coefficient": len(items)}:
        raise AssertionError(f"{tag}: routes {snap['routes']}; every item "
                             f"must take the coefficient route")
    if dev.type == "cuda" and launches < 7 * len(snap["chunk_items"]):
        raise AssertionError(f"{tag}: K1 ran {launches} times for "
                             f"{len(snap['chunk_items'])} chunks")
    check_k6_per_chunk(tag, dev, snap)
    return res, wall_ms, launches, snap


def check_k6_per_chunk(tag: str, dev, snap, shards: int = 1) -> None:
    """K6 launched once per shard of every compact-layout chunk of the
    call just run (read since k3_zero) and never for an int16 chunk:
    events upload_coo / upload_i8 / upload_csr count those chunks."""
    got = {k: w.launches for k, w in k6_wrappers().items()}
    ev = snap["events"]
    want = {k: ev.get(f"upload_{k}", 0) for k in got}
    if dev.type == "cuda" and sum(want.values()) and shards == 1 \
            and got != want:
        raise AssertionError(f"{tag}: K6 launches {got}, want one per chunk "
                             f"of each layout {want}")
    if dev.type == "cuda" and not sum(want.values()) and sum(got.values()):
        raise AssertionError(f"{tag}: K6 launched {got} for int16 chunks")


def log_batch(tag: str, n: int, wall_ms: float, launches: int, snap,
              res, T) -> None:
    chunks = snap["chunk_items"]
    st = snap["stage_seconds"]
    log(f"{tag}: {n} files wall_ms={wall_ms:.1f} img_per_s="
        f"{n / (wall_ms / 1e3):.1f} mean_ssim="
        f"{T.summarize(res).avg_ssim:.6f} chunks={chunks} k1_launches="
        f"{launches} uploaded_bytes_per_chunk="
        f"{snap['uploaded_bytes'] / max(1, len(chunks)):.0f} stage_s "
        f"prep={st.get('prep', 0):.3f} device={st.get('device', 0):.3f} "
        f"encode_summed={st.get('encode', 0):.3f}")


def profile_device(fn, tag: str):
    """Device busy time of one fn() call from torch.profiler's CUDA
    events, beside its wall time; the eight busiest kernels.  Returns the
    device's idle share of the wall time (None when nothing was
    recorded)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Kernel and copy rows only: an aten:: row repeats the device time
    # of the kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    busy_ms = sum(device_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        log(f"{tag} profile: no device time recorded (not measured)")
        return None
    log(f"{tag} profile: wall_ms={wall_ms:.1f} device_busy_ms="
        f"{busy_ms:.1f} idle_share={1 - busy_ms / wall_ms:.3f}")
    for e in sorted(events, key=device_us, reverse=True)[:8]:
        log(f"  {device_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")
    return 1 - busy_ms / wall_ms


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def log_peak(tag: str, dev, chunk: int, pixels: int) -> None:
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"{tag} peak_device_bytes={peak} per_pixel_of_chunk="
            f"{peak / (chunk * pixels):.1f}")


def write_files500(T, dev, src_dir, n=512, w=500, h=500):
    """bench.py's workload: n JPEG files of w x h at Q92 (64 distinct
    photos, shifted by 4 px every 64 files).  Returns (paths, datas)."""
    canvases = [photo(w + 32, h + 32, SEED + 100 + k) for k in range(64)]
    datas = []
    for i in range(n):
        off = (i // 64) * 4
        img = np.ascontiguousarray(canvases[i % 64][off:off + h,
                                                    off:off + w])
        datas.append(T.encode_to_bytes(img, T.JPEG, 92, device=dev))
    os.makedirs(src_dir)
    paths = []
    for i, data in enumerate(datas):
        paths.append(os.path.join(src_dir, f"in{i:03d}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths, datas


def phase_batch_files(T, dev, ssim_window, counters, tmp, n=512, w=500,
                      h=500):
    """Phase 6: 512 files of 500x500 at Q92 through compress_batch."""
    paths, datas = write_files500(T, dev, os.path.join(tmp, "files500"), n,
                                  w, h)

    def items(tag):
        return [T.BatchItem(src=p, dst=os.path.join(tmp, f"{tag}{i}.jpg"))
                for i, p in enumerate(paths)]

    total = 0
    for tag in ("cold", "warm"):
        reset_peak(dev)
        res, wall_ms, launches, snap = run_batch(
            T, ssim_window, counters, items(tag), dev, f"batch512 {tag}")
        total += launches
        log_batch(f"batch512 {tag}", n, wall_ms, launches, snap, res, T)
    log_peak("batch512 warm", dev, max(snap["chunk_items"]), w * h)
    profile_device(lambda: T.compress_batch(None, items("prof"),
                                            T.BatchOptions(
                                                fused=True,
                                                default_opts=T.Options(
                                                    format=T.JPEG)),
                                            device=dev), "batch512")

    opts = T.Options(format=T.JPEG)
    for i in range(0, n, 32):
        want = T.compress_bytes(None, datas[i], opts, device=dev)
        check_contract(T, res[i].result, want, dev, f"batch512 item {i}")
    for i in range(0, n, 64):
        src = T.codecs.decode_image(datas[i], device=dev)
        check_result(T, res[i].result, dev, 0.94, (w, h),
                     f"batch512 item {i}", src_img=src)
    log(f"batch512: items 0,32,..,480 agree with per-image compress_bytes;"
        f" items 0,64,..,448 pass the plain-scorer replay")
    return total + phase_batch_layouts(T, dev, ssim_window, counters, tmp,
                                       paths, res, w, h)


def phase_batch_layouts(T, dev, ssim_window, counters, tmp, paths, res512,
                        w=500, h=500, n=64):
    """Phase 6, the two upload layouts photos do not take by default: n
    files of noise at Q100 with default options (the census sends them
    as dense int8: their values overflow COO's exceptions) and the first
    n photos with FENNEC_UPLOAD=csr (the opt-in CSR route).  The noise
    agrees with per-image compress_bytes, the CSR run's bytes equal the
    default route's (res512).  Returns K1's launches."""
    n = min(n, len(paths))
    rng = np.random.default_rng(SEED + 600)
    src = os.path.join(tmp, "noise500")
    os.makedirs(src)
    noise_paths, noise_datas = [], []
    for i in range(n):
        noise_datas.append(T.encode_to_bytes(rng.integers(
            0, 256, (h, w, 3), dtype=np.uint8), T.JPEG, 100, device=dev))
        noise_paths.append(os.path.join(src, f"noise{i:02d}.jpg"))
        with open(noise_paths[-1], "wb") as f:
            f.write(noise_datas[-1])
    total = 0
    outs = []
    for tag, env, srcs, event in (
            ("noise64", {}, noise_paths, "upload_i8"),
            ("csr64", {"FENNEC_UPLOAD": "csr"}, paths[:n], "upload_csr")):
        items = [T.BatchItem(src=p, dst=os.path.join(tmp, f"{tag}_{i}.jpg"))
                 for i, p in enumerate(srcs)]
        with env_set(env):
            got, wall_ms, launches, snap = run_batch(
                T, ssim_window, counters, items, dev, f"batch {tag}")
        if snap["events"] != {event: len(snap["chunk_items"])}:
            raise AssertionError(f"batch {tag}: events {snap['events']}, "
                                 f"want {event} for every chunk")
        log_batch(f"batch {tag} {env or 'default options'}", n, wall_ms,
                  launches, snap, got, T)
        total += launches
        outs.append(got)
    opts = T.Options(format=T.JPEG)
    for i in range(0, n, 16):
        want = T.compress_bytes(None, noise_datas[i], opts, device=dev)
        check_contract(T, outs[0][i].result, want, dev, f"noise64 item {i}")
    differ = [i for i in range(n) if outs[1][i].result.compressed_data
              != res512[i].result.compressed_data]
    if differ:
        raise AssertionError(f"batch csr64: items {differ[:5]} differ from "
                             f"the default route's")
    log(f"batch noise64: items 0,16,32,48 agree with per-image "
        f"compress_bytes; batch csr64: {n} outputs byte-identical to the "
        f"default route's")
    return total


def phase_pixel_path(T, dev, ssim_window, counters, w=500, h=500):
    """Phase 7: 256 decoded images (32 distinct x 8) via compress_images."""
    distinct = [photo(w, h, SEED + 300 + k) for k in range(32)]
    images = [distinct[i % 32] for i in range(256)]
    opts = T.Options(format=T.JPEG)
    total = 0
    for tag in ("cold", "warm"):
        counters.reset()
        ssim_window.launches = 0
        k3_zero()
        t = time.perf_counter()
        res = T.compress_images(None, images, opts, device=dev)
        wall_ms = (time.perf_counter() - t) * 1e3
        total += ssim_window.launches
        snap = counters.snapshot()
        k3_take(f"images256 {tag}", dev, len(snap["chunk_items"]),
                probes=7 * len(snap["chunk_items"]))
        if snap["routes"] != {"pixel": 256}:
            raise AssertionError(f"pixel path routes {snap['routes']}")
        st = snap["stage_seconds"]
        log(f"images256 {tag}: wall_ms={wall_ms:.1f} img_per_s="
            f"{256 / (wall_ms / 1e3):.1f} chunks={snap['chunk_items']} "
            f"k1_launches={ssim_window.launches} uploaded_bytes_per_chunk="
            f"{snap['uploaded_bytes'] / len(snap['chunk_items']):.0f} "
            f"stage_s prep={st.get('prep', 0):.3f} "
            f"device={st.get('device', 0):.3f} "
            f"encode_summed={st.get('encode', 0):.3f}")
    for k in range(32):
        want = T.compress_image(None, distinct[k], opts, device=dev)
        for i in range(k, 256, 32):
            got = res[i]
            if (got.compressed_data != want.compressed_data
                    or got.jpeg_quality != want.jpeg_quality
                    or got.ssim != want.ssim):
                raise AssertionError(
                    f"images256 item {i}: q={got.jpeg_quality} ssim="
                    f"{got.ssim} bytes={got.compressed_size} vs per-image "
                    f"q={want.jpeg_quality} ssim={want.ssim} bytes="
                    f"{want.compressed_size}")
    log("images256: every image's bytes equal per-image compress_image")
    return total


def phase_full_size(T, dev, ssim_window, counters, tmp, w=4032, h=3024):
    """Phase 8: 16 files of 4032x3024 through compress_batch."""
    n = 16
    base = photo(w, h, SEED + 500)
    src_dir = os.path.join(tmp, "files12mp")
    os.makedirs(src_dir)
    paths = []
    for i in range(n):
        img = np.roll(base, (61 * i, 97 * i), axis=(0, 1))
        paths.append(os.path.join(src_dir, f"big{i:02d}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(T.encode_to_bytes(img, T.JPEG, 92, device=dev))
    del base
    total = 0
    for tag in ("cold", "warm"):
        items = [T.BatchItem(src=p, dst=os.path.join(tmp, f"{tag}_big{i}"
                                                     f".jpg"))
                 for i, p in enumerate(paths)]
        reset_peak(dev)
        res, wall_ms, launches, snap = run_batch(
            T, ssim_window, counters, items, dev, f"batch12mp {tag}")
        total += launches
        log_batch(f"batch12mp {tag}", n, wall_ms, launches, snap, res, T)
    log(f"batch12mp chunk_size_picked={snap['chunk_items'][0]}")
    log_peak("batch12mp warm", dev, max(snap["chunk_items"]), w * h)
    for i in (0, n - 1):
        want = T.compress_file(None, paths[i], os.path.join(
            tmp, f"single_big{i}.jpg"), T.Options(format=T.JPEG),
            device=dev)
        check_contract(T, res[i].result, want, dev, f"batch12mp item {i}")
    log(f"batch12mp: items 0 and {n - 1} agree with per-image "
        f"compress_file")
    return total


def phase_cli_mixed(T, dev, tmp):
    """Phase 9: the CLI's --batch on a mixed directory, in a subprocess."""
    mixed = os.path.join(tmp, "mixed")
    out_dir = os.path.join(tmp, "mixed_out")
    os.makedirs(mixed)
    fixtures = os.path.join(HERE, "tests", "torch_fixtures")
    files = {}
    for name in ("progressive_1280x720.jpg", "multiscan_1280x720.jpg"):
        with open(os.path.join(fixtures, name), "rb") as f:
            files[name] = f.read()
    files["baseline.jpg"] = T.encode_to_bytes(photo(640, 480, SEED + 700),
                                              T.JPEG, 90, device=dev)
    files["photo.png"] = T.encode_to_bytes(photo(320, 240, SEED + 701),
                                           T.PNG, 0, device=dev)
    rotated = T.encode_to_bytes(photo(480, 320, SEED + 702), T.JPEG, 90,
                                device=dev)
    files["rotated.jpg"] = (rotated[:2] + exif_orientation_segment(6)
                            + rotated[2:])
    files["truncated.jpg"] = files["baseline.jpg"][:300]
    for name, data in files.items():
        with open(os.path.join(mixed, name), "wb") as f:
            f.write(data)
    env = dict(os.environ, PYTHONPATH=HERE)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fennec_tpu_torch", "--batch", "--format",
         "jpeg", "--device", "cuda", "-v", mixed, out_dir],
        capture_output=True, text=True, cwd=HERE, env=env, timeout=600)
    wall_ms = (time.perf_counter() - t) * 1e3
    failed = [ln for ln in proc.stderr.splitlines() if "failed:" in ln]
    if (proc.returncode != 1 or "5/6 succeeded" not in proc.stdout
            or len(failed) != 1 or "truncated.jpg" not in failed[0]):
        raise AssertionError(f"cli mixed: rc={proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr[-3000:]}")
    want_wh = {"progressive_1280x720.jpg": (1280, 720),
               "multiscan_1280x720.jpg": (1280, 720),
               "baseline.jpg": (640, 480), "photo.png": (320, 240),
               "rotated.jpg": (320, 480)}
    for name, wh in want_wh.items():
        with open(os.path.join(out_dir, name), "rb") as f:
            out = T.codecs.decode_image(f.read(), device=dev)
        if (out.shape[1], out.shape[0]) != wh:
            raise AssertionError(f"cli mixed {name}: {out.shape}, want {wh}")
    prog = files["progressive_1280x720.jpg"]
    on_card = T.codecs.decode_image(prog, device=dev)
    on_cpu = T.codecs.decode_image(prog, device="cpu")
    diff = np.abs(on_card.astype(np.int32) - on_cpu.astype(np.int32))
    log(f"cli mixed: rc=1, 5/6 succeeded, only truncated.jpg failed, "
        f"wall_ms={wall_ms:.1f} (process start included); progressive "
        f"fixture card vs cpu decode: values differing="
        f"{int(np.count_nonzero(diff))} max_diff={int(diff.max())}")
    if diff.max() > 1 or np.count_nonzero(diff) > 1e-5 * diff.size:
        raise AssertionError("progressive fixture decodes differently on "
                             "the card")
    for line in proc.stdout.splitlines():
        log(f"  cli: {line}")

# ── Target-size mode (phase 10) ─────────────────────────────────────────────


def ts_strategy(res, w: int, h: int, target: int) -> str:
    """Which strategy produced a target-size Result, from what it looks
    like: S3 and S4 change the geometry, S1 keeps it as JPEG, S2 as PNG;
    the fallback is a Q=1 JPEG or an over-target PNG scored 1.0."""
    fmt = str(res.format)
    if res.ssim == 1.0 and (res.jpeg_quality == 1 or (
            fmt == "PNG" and res.compressed_size > target)):
        return "fallback"
    if tuple(res.final_dimensions) != (w, h):
        return "s3" if fmt == "JPEG" else "s4"
    return "s1" if fmt == "JPEG" else "s2"


def check_ts(T, res, original, target: int, dev, tag: str):
    """The target-size contract on one Result: under target unless it is
    the fallback, JPEG quality >= 20, an S1 winner maximal (q+1
    overshoots unless q is the top of its bounds), and the output
    decoding to final_dimensions.  The reported SSIM must be honest: S1
    and S2 report SSIMFast of what the file decodes to, so SSIMFast of
    the decoded output against the original must agree within 0.01
    (tests/test_pipeline.py:43-46); S3 and S4 report, as the reference
    does (targetsize.go:210-232), the scaled image's SSIM before
    encoding, which must be reproduced from that image within 1e-4.
    Returns (strategy, SSIMFast of the decoded output)."""
    from fennec_tpu_torch.engine.targetsize import (
        MIN_JPEG_QUALITY,
        _bpp_bounds,
        _JpegSizer,
    )
    from fennec_tpu_torch.ops.ssim import compute_ssim_nrgba

    h, w = original.shape[:2]
    strategy = ts_strategy(res, w, h, target)
    if strategy != "fallback" and res.compressed_size > target:
        raise AssertionError(f"{tag}: {res.compressed_size} bytes over the "
                             f"target {target} ({strategy})")
    if (strategy != "fallback" and res.format == T.JPEG
            and res.jpeg_quality < MIN_JPEG_QUALITY):
        raise AssertionError(f"{tag}: quality {res.jpeg_quality} < 20")
    if strategy == "s1":
        hi = _bpp_bounds(target, w * h)[1]
        if res.jpeg_quality < hi:
            over = len(_JpegSizer(original, dev).encode(
                res.jpeg_quality + 1))
            if over <= target:
                raise AssertionError(f"{tag}: q+1={res.jpeg_quality + 1} "
                                     f"still fits ({over} bytes)")
    out = T.codecs.decode_image(res.compressed_data, device=dev)
    if (out.shape[1], out.shape[0]) != tuple(res.final_dimensions):
        raise AssertionError(f"{tag}: decoded {out.shape}, want "
                             f"{res.final_dimensions}")
    decoded = compute_ssim_nrgba(original, out, dev)
    if strategy in ("s1", "s2") and abs(decoded - res.ssim) > \
            TS_HONEST_ATOL:
        raise AssertionError(f"{tag}: reported ssim {res.ssim} vs "
                             f"{decoded} of the decoded output")
    if strategy in ("s3", "s4"):
        scaled = compute_ssim_nrgba(original, res.image, dev)
        if abs(scaled - res.ssim) > TS_SSIM_ATOL:
            raise AssertionError(f"{tag}: reported ssim {res.ssim} vs "
                                 f"{scaled} of the scaled image")
    return strategy, decoded


def ts_contract(T, got, want, target: int, tag: str) -> None:
    """A batched target-size Result against per-image compress_image."""
    same = (got.format == want.format
            and got.jpeg_quality == want.jpeg_quality
            and got.final_dimensions == want.final_dimensions
            and abs(got.ssim - want.ssim) <= TS_SSIM_ATOL)
    if got.compressed_data != want.compressed_data:
        same = same and (
            abs(got.compressed_size - want.compressed_size) <= TS_SIZE_ATOL
            and (got.compressed_size <= target)
            == (want.compressed_size <= target))
    if not same:
        raise AssertionError(
            f"{tag}: batch {got.format} q={got.jpeg_quality} "
            f"{got.final_dimensions} ssim={got.ssim} bytes="
            f"{got.compressed_size} vs per-image {want.format} "
            f"q={want.jpeg_quality} {want.final_dimensions} ssim={want.ssim}"
            f" bytes={want.compressed_size}")


def ts_seconds(counters) -> str:
    st = counters.snapshot()["stage_seconds"]
    return " ".join(f"{k}={st.get(k, 0):.3f}s"
                    for k in ("ts_s1", "ts_s2", "ts_s3", "ts_s4",
                              "ts_encode", "ts_png"))


def phase_ts_single(T, dev, ssim_window, counters, big_path, big_img, tmp,
                    mid=(1920, 1080), small=(500, 500)):
    """T1: the per-image engine through compress_file, compress_bytes and
    compress_image, cold then warm.  Returns K1's launches."""
    mid_img = photo(*mid, SEED + 800)
    mid_jpeg = T.encode_to_bytes(mid_img, T.JPEG, 92, device=dev)
    mid_img = T.codecs.decode_image(mid_jpeg, device=dev)
    small_img = photo(*small, SEED + 801)
    runs = [
        ("12mp_auto_100KB", 100 * 1024, big_img,
         lambda: T.compress_file(None, big_path, os.path.join(
             tmp, "ts_big.out"), T.Options(target_size=100 * 1024),
             device=dev)),
        ("1080p_jpeg_200KB", 200 * 1024, mid_img,
         lambda: T.compress_bytes(None, mid_jpeg, T.Options(
             format=T.JPEG, target_size=200 * 1024), device=dev)),
        ("500_jpeg_20KB", 20 * 1024, small_img,
         lambda: T.compress_image(None, small_img, T.Options(
             format=T.JPEG, target_size=20 * 1024), device=dev)),
        # A generous target, where S1 wins and its maximality is checked.
        ("500_jpeg_128KB", 128 * 1024, small_img,
         lambda: T.compress_image(None, small_img, T.Options(
             format=T.JPEG, target_size=128 * 1024), device=dev)),
    ]
    total = 0
    for tag, target, original, run in runs:
        ssim_window.launches = 0
        t = time.perf_counter()
        run()
        cold_ms = (time.perf_counter() - t) * 1e3
        cold_launches = ssim_window.launches
        counters.reset()
        ssim_window.launches = 0
        k3_zero()
        t = time.perf_counter()
        res = run()  # the result is host bytes, so synced
        warm_ms = (time.perf_counter() - t) * 1e3
        warm_launches = ssim_window.launches
        # The per-image target-size engine encodes on the host C++
        # encoder, as the JAX package's does (engine/targetsize.py:197):
        # no emission, but its size oracle's bisections run on K4.
        k3_warm = k3_take(f"T1 {tag}", dev, 0, 1)
        total += cold_launches + warm_launches
        if dev.type == "cuda" and not (cold_launches and warm_launches):
            raise AssertionError(f"T1 {tag}: K1 launches cold="
                                 f"{cold_launches} warm={warm_launches}")
        strategy, decoded = check_ts(T, res, original, target, dev,
                                     f"T1 {tag}")
        log(f"T1 {tag}: strategy={strategy} format={res.format} "
            f"quality={res.jpeg_quality} geometry={res.final_dimensions} "
            f"bytes={res.compressed_size} target={target} "
            f"ssim={res.ssim:.6f} decoded_ssim={decoded:.6f} "
            f"cold_ms={cold_ms:.1f} warm_ms={warm_ms:.1f} K1 launches "
            f"cold={cold_launches} warm={warm_launches} K3 launches warm "
            f"(K3a, K3b, K4 bisection)={k3_warm} (host encoder) "
            f"warm {ts_seconds(counters)} "
            f"digest={digest([res.compressed_data])}")
    log(f"T1: K1 launches={total} (the compress_* calls only)")
    return total


def transparent(w: int, h: int, seed: int) -> np.ndarray:
    img = photo(w, h, seed)
    img[..., 3] = np.linspace(0, 255, w, dtype=np.float32).astype(np.uint8)
    return img


def phase_ts_batch(T, dev, ssim_window, counters, n=64, w=500, h=500,
                   n_auto=8):
    """T2: compress_images over n photos at 20 KB (JPEG), cold then warm,
    and an AUTO bucket holding a transparent image; items against
    per-image compress_image.  Returns K1's launches in the compress_images
    calls alone; each must launch it."""
    target = 20 * 1024
    images = [photo(w, h, SEED + 900 + k) for k in range(n)]
    opts = T.Options(format=T.JPEG, target_size=target)
    total = 0
    for tag in ("cold", "warm"):
        counters.reset()
        reset_peak(dev)
        ssim_window.launches = 0
        k3_zero()
        t = time.perf_counter()
        res = T.compress_images(None, images, opts, device=dev)
        wall_ms = (time.perf_counter() - t) * 1e3
        launches = ssim_window.launches
        k3a, k3b, k4 = k3_take(f"T2 {tag}", dev, 1, 1)
        total += launches
        if dev.type == "cuda" and launches == 0:
            raise AssertionError(f"T2 {tag}: the batched pass never ran K1")
        snap = counters.snapshot()
        ev = snap["events"]
        if snap["routes"] != {"target-size": n}:
            raise AssertionError(f"T2 routes {snap['routes']}")
        over = sum(r.compressed_size > target for r in res)
        strategies = {}
        for r in res:
            k = ts_strategy(r, w, h, target)
            strategies[k] = strategies.get(k, 0) + 1
        log(f"T2 {n}x{w}x{h} {tag}: wall_ms={wall_ms:.1f} img_per_s="
            f"{n / (wall_ms / 1e3):.2f} chunks={snap['chunk_items']} "
            f"waves={ev.get('ts_waves', 0)} probes={ev.get('ts_probes', 0)}"
            f" memo_hits={ev.get('ts_memo_hits', 0)} rounds="
            f"{ev.get('ts_s3_rounds', 0)} over_target={over} strategies="
            f"{strategies} K1 launches={launches} K3 launches K3a={k3a} "
            f"K3b={k3b} K4 bisection={k4} {ts_seconds(counters)} "
            f"digest={digest(r.compressed_data for r in res)}")
        if over:
            raise AssertionError(f"T2: {over} result(s) over the target")
    log_peak(f"T2 {n}x{w}x{h} warm", dev, max(snap["chunk_items"]), w * h)
    profile_device(lambda: T.compress_images(None, images, opts, device=dev),
                   f"T2 {n}x{w}x{h}")
    for i in range(0, n, 16):
        want = T.compress_image(None, images[i], opts, device=dev)
        ts_contract(T, res[i], want, target, f"T2 item {i}")
        check_ts(T, res[i], images[i], target, dev, f"T2 item {i}")

    auto = [photo(w, h, SEED + 950 + k) for k in range(n_auto)]
    auto[3] = transparent(w, h, SEED + 960)
    counters.reset()
    ssim_window.launches = 0
    k3_zero()
    t = time.perf_counter()
    res = T.compress_images(None, auto, T.Options(target_size=target),
                            device=dev)
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = ssim_window.launches
    k3_take("T2 auto bucket", dev, 1, 1)
    total += launches
    if dev.type == "cuda" and launches == 0:
        raise AssertionError("T2 auto bucket: the batched pass never ran K1")
    for i in (0, 3):
        want = T.compress_image(None, auto[i], T.Options(target_size=target),
                                device=dev)
        ts_contract(T, res[i], want, target, f"T2 auto item {i}")
        check_ts(T, res[i], auto[i], target, dev, f"T2 auto item {i}")
    if res[3].format != T.PNG:
        raise AssertionError(f"T2: the transparent image got {res[3].format}")
    log(f"T2 auto bucket {n_auto}x{w}x{h}: wall_ms={wall_ms:.1f} formats="
        f"{[str(r.format) for r in res]} K1 launches={launches} "
        f"{ts_seconds(counters)}; items 0,16,..,{n - 16} and the AUTO "
        f"bucket's 0 and 3 (transparent) agree with per-image "
        f"compress_image")
    log(f"T2: K1 launches={total} (the compress_images calls only)")
    return total


def phase_ts_full_size(T, dev, ssim_window, counters, big_img, n=16,
                       target=100 * 1024):
    """T2 at 12 MP: one compress_images bucket of n rolled copies of the
    12 MP photo at 100 KB (JPEG), in the chunks the engine picks from the
    card's free memory; the peak device bytes per pixel of a chunk, and
    items 0 and n-1 against per-image compress_image.  Returns K1's
    launches in the compress_images call."""
    h, w = big_img.shape[:2]
    images = [np.roll(big_img, (61 * i, 97 * i), axis=(0, 1))
              for i in range(n)]
    opts = T.Options(format=T.JPEG, target_size=target)
    counters.reset()
    reset_peak(dev)
    ssim_window.launches = 0
    k3_zero()
    t = time.perf_counter()
    res = T.compress_images(None, images, opts, device=dev)
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = ssim_window.launches
    snap = counters.snapshot()
    k3_take("T2 12 MP", dev, 1, 1)
    if dev.type == "cuda" and launches == 0:
        raise AssertionError("T2 12 MP: the batched pass never ran K1")
    if snap["routes"] != {"target-size": n}:
        raise AssertionError(f"T2 12 MP routes {snap['routes']}")
    over = sum(r.compressed_size > target for r in res)
    if over:
        raise AssertionError(f"T2 12 MP: {over} result(s) over the target")
    log(f"T2 {n}x{w}x{h} at {target} B: wall_ms={wall_ms:.1f} img_per_s="
        f"{n / (wall_ms / 1e3):.3f} chunks={snap['chunk_items']} "
        f"geometries={sorted({r.final_dimensions for r in res})} "
        f"K1 launches={launches} {ts_seconds(counters)} "
        f"digest={digest(r.compressed_data for r in res)}")
    log_peak(f"T2 {n}x{w}x{h}", dev, max(snap["chunk_items"]), w * h)
    for i in (0, n - 1):
        want = T.compress_image(None, images[i], opts, device=dev)
        ts_contract(T, res[i], want, target, f"T2 12 MP item {i}")
    check_ts(T, res[0], images[0], target, dev, "T2 12 MP item 0")
    log(f"T2 12 MP: items 0 and {n - 1} agree with per-image compress_image")
    return launches


def phase_ts_files(T, dev, ssim_window, counters, tmp, big_path, n=64,
                   w=500, h=500):
    """T3: compress_batch over n JPEG files at 20 KB and the CLI's
    --target-size on the 12 MP file.  Returns K1's launches."""
    target = 20 * 1024
    src_dir = os.path.join(tmp, "ts_files")
    os.makedirs(src_dir)
    items = []
    for i in range(n):
        p = os.path.join(src_dir, f"in{i:02d}.jpg")
        with open(p, "wb") as f:
            f.write(T.encode_to_bytes(photo(w, h, SEED + 1000 + i), T.JPEG,
                                      92, device=dev))
        items.append(T.BatchItem(src=p, dst=os.path.join(tmp,
                                                         f"ts_o{i}.jpg")))
    counters.reset()
    ssim_window.launches = 0
    k3_zero()
    t = time.perf_counter()
    res = T.compress_batch(None, items, T.BatchOptions(
        default_opts=T.Options(format=T.JPEG, target_size=target)),
        device=dev)
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = ssim_window.launches
    k3_take("T3", dev, 1, 1)
    bad = [(r.item.src, r.err) for r in res if r.err is not None]
    if bad:
        raise AssertionError(f"T3: {len(bad)} item(s) failed: {bad[:3]}")
    routes = counters.snapshot()["routes"]
    if routes != {"target-size": n}:
        raise AssertionError(f"T3 routes {routes}")
    written = []
    for r in res:
        with open(r.item.dst, "rb") as f:
            written.append(f.read())
        size = len(written[-1])
        if size == 0 or size > 2 * target:
            raise AssertionError(f"T3 {r.item.dst}: {size} bytes")
    if dev.type == "cuda" and launches == 0:
        raise AssertionError("T3: K1 never ran")
    log(f"T3 compress_batch {n}x{w}x{h}: wall_ms={wall_ms:.1f} img_per_s="
        f"{n / (wall_ms / 1e3):.2f} every item written, <= 2x target, "
        f"K1 launches={launches} {ts_seconds(counters)} "
        f"digest={digest(written)}")

    out = os.path.join(tmp, "ts_cli.jpg")
    env = dict(os.environ, PYTHONPATH=HERE)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fennec_tpu_torch", "--target-size", "100KB",
         "--device", dev.type, big_path, out],
        capture_output=True, text=True, cwd=HERE, env=env, timeout=600)
    wall_ms = (time.perf_counter() - t) * 1e3
    size = os.path.getsize(out) if os.path.exists(out) else -1
    fallback = "SSIM: 1.0000" in proc.stdout
    if proc.returncode != 0 or size <= 0 or (size > 100 * 1024
                                             and not fallback):
        raise AssertionError(f"T3 cli: rc={proc.returncode} size={size}\n"
                             f"{proc.stdout}\n{proc.stderr[-3000:]}")
    log(f"T3 cli --target-size 100KB on 12 MP: rc=0 bytes={size} "
        f"wall_ms={wall_ms:.1f} (process start included): "
        f"{proc.stdout.strip()}")
    return launches


def phase_ts_card_vs_cpu(T, dev, big_img):
    """The same S3 search on the card and on the CPU, and one 12 MP
    palette map on both."""
    from fennec_tpu_torch.engine.targetsize import hit_target_size
    from fennec_tpu_torch.ops.quantize import apply_palette, median_cut

    img = photo(160, 120, SEED + 9)
    target = 1600
    opts = T.Options(format=T.JPEG, target_size=target)
    on_card = hit_target_size(None, img, target, opts, dev)
    on_cpu = hit_target_size(None, img, target, opts, "cpu")
    got = [(r.format, r.quality, r.final_w, r.final_h)
           for r in (on_card, on_cpu)]
    if (got[0] != got[1] or (on_card.final_w, on_card.final_h) == (160, 120)
            or abs(on_card.ssim - on_cpu.ssim) > TS_SSIM_ATOL
            or abs(len(on_card.data) - len(on_cpu.data)) > TS_SIZE_ATOL):
        raise AssertionError(f"card vs cpu 160x120: {got}, ssim "
                             f"{on_card.ssim}/{on_cpu.ssim}, bytes "
                             f"{len(on_card.data)}/{len(on_cpu.data)}")
    pal = median_cut(big_img, 256)
    idx_card = apply_palette(big_img, pal, dev)
    idx_cpu = apply_palette(big_img, pal, "cpu")
    if not np.array_equal(idx_card, idx_cpu):
        raise AssertionError(
            f"palette map: {int(np.count_nonzero(idx_card != idx_cpu))} "
            f"indices differ between the card and the CPU")
    log(f"card vs cpu: 160x120 at {target} B: {got[0]} (S3) on both, ssim "
        f"{on_card.ssim:.7f}/{on_cpu.ssim:.7f}, bytes_identical="
        f"{on_card.data == on_cpu.data}; 12 MP palette map (256 colours) "
        f"identical on both")


def oracle_cases(T, dev, big_img):
    """(tag, coefs, quality tensor, padded h, padded w, subsample) at the
    size oracle's main-path shapes: the 12 MP photo, a 1080p photo, T2's
    64 x 500x500 bucket at per-image qualities, and 1080p in 4:4:4."""
    from fennec_tpu_torch.codecs.jpeg import forward_dct

    def coefs_of(images, sub):
        x = torch.from_numpy(np.stack(images)).to(dev).to(torch.float32)
        return forward_dct(x, sub)

    rng = np.random.default_rng(SEED + 77)
    mid = photo(1920, 1080, SEED + 800)
    batch = [photo(500, 500, SEED + 900 + k) for k in range(64)]
    one = torch.tensor([50], device=dev)
    return [
        ("12mp_420", coefs_of([big_img], True), one, 3024, 4032, True),
        ("1080p_420", coefs_of([mid], True), one, 1088, 1920, True),
        ("t2_64x500_420", coefs_of(batch, True),
         torch.from_numpy(rng.integers(1, 101, 64)).to(dev), 512, 512, True),
        ("1080p_444", coefs_of([mid], False), one, 1080, 1920, False),
    ]


def phase_k4(T, dev, big_img):
    """The size oracle on the card: scan_bytes_at, one launch of K4,
    against its plain version ops/jpeg_size.scan_bits, K4's own plain
    version (the packed quantize, then K3a's plain totals) and the route
    it replaced (the packed quantize, then K3a's totals over the int16
    blocks) on the same CUDA tensors (equal integers); a single image's
    (N, 64) form against its batch of one; and the bisection step's time
    for the plain step, the earlier route and K4, the last two in turns
    (earlier, K4, K4, earlier), beside the step's bound: 256 B of float32
    coefficients per block read once.  Returns {tag: times}."""
    from fennec_tpu_torch.engine import size_search
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.jpeg_emit import (
        layout_on,
        quantize_count_plain,
        std_tables_on,
    )
    from fennec_tpu_torch.ops.jpeg_size import scan_bits

    out = {}
    qtables = size_search.quality_tables_on(dev)
    std = std_tables_on(dev)
    for tag, coefs, q, ph, pw, sub in oracle_cases(T, dev, big_img):
        before = (k3.quantize_count.launches, k3.oracle_stats.launches)
        lay = layout_on(ph, pw, sub, dev)

        def plain():
            bits = scan_bits(*size_search.quantize_at(coefs, q), ph, pw, sub)
            return torch.div(bits + 7, 8, rounding_mode="floor")

        def earlier():
            packed = size_search.quantize_packed(coefs, qtables[q])
            bits = k3.oracle_stats(packed, lay, std).totals
            return torch.div(bits + 7, 8, rounding_mode="floor")

        def step():
            return size_search.scan_bytes_at(coefs, q, ph, pw, sub)

        got, want, old = step(), plain(), earlier()
        own_bits = quantize_count_plain(coefs, qtables, q, lay, std)
        own = torch.div(own_bits + 7, 8, rounding_mode="floor")
        if (k3.quantize_count.launches, k3.oracle_stats.launches) != (
                before[0] + 1, before[1] + 1):
            raise AssertionError(f"K4 {tag}: scan_bytes_at did not launch "
                                 f"K4 once and nothing else")
        # The bit totals themselves, not only the bytes they round up to.
        bits = k3.quantize_count([c.contiguous() for c in coefs], qtables, q,
                                 lay, std)
        bit_err = int((bits - own_bits).abs().max())
        if not (torch.equal(got, want) and torch.equal(got, old)
                and torch.equal(got, own) and bit_err == 0):
            raise AssertionError(
                f"K4 {tag}: K4's totals {got.tolist()[:4]} != scan_bits "
                f"{want.tolist()[:4]}, the earlier route {old.tolist()[:4]} "
                f"or its plain version {own.tolist()[:4]} (bits off by up "
                f"to {bit_err})")
        if q.numel() == 1:
            alone = size_search.scan_bytes_at([c[0] for c in coefs], q[0],
                                              ph, pw, sub)
            if alone.dim() != 0 or int(alone) != int(got[0]):
                raise AssertionError(f"K4 {tag}: one image {alone} != batch "
                                     f"of one {got}")
        blocks = sum(c.shape[0] * c.shape[1] for c in coefs)
        parts = size_search.quantize_at(coefs, q)
        turns = {"earlier": [], "k4": []}
        for who in ("earlier", "k4", "k4", "earlier"):
            fn = step if who == "k4" else earlier
            turns[who].append((cuda_ms(fn, 20), host_us(fn, 20)))
        t = {"blocks": blocks, "max_abs_err": bit_err,
             "step_ms": min(ms for ms, _ in turns["k4"]),
             "host_us": min(us for _, us in turns["k4"]),
             "kernel_ms": profiled_device_ms(step, 50,
                                             "block_stats_kernel"),
             "earlier_step_ms": min(ms for ms, _ in turns["earlier"]),
             "earlier_host_us": min(us for _, us in turns["earlier"]),
             "turns_step_us": [round(ms * 1e3, 1) for who in
                               ("earlier", "k4") for ms, _ in turns[who]],
             "plain_step_ms": cuda_ms(plain, 5),
             "plain_ms": cuda_ms(lambda: scan_bits(*parts, ph, pw, sub), 5),
             "bound_ms": blocks * 256 / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes"}
        t["share"] = t["bound_ms"] / t["kernel_ms"]
        out[tag] = t
        log(f"k4 {tag}: scan_bytes_at through K4 == plain scan_bits == the "
            f"earlier route == K4's plain version (bytes "
            f"{got.tolist()[:3]}..) " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in t.items())
            + f" step_share={t['bound_ms'] / t['step_ms']:.3f}")
    return out


def bisect_cases(T, dev, big_img, rolled: int = 16):
    """(tag, coefs, (target, lo0, hi0), padded h, padded w, subsample) for
    K4's bisection.  The main path's: the 12 MP photo at T1's 100 KB, a
    1080p photo at 200 KB (each over the engine's bits-per-pixel range,
    the container header subtracted), T2's 64 x 500x500 at per-image
    targets of 10-30 KB, 1080p 4:4:4 over [1, 100].  Then the 1080p photo
    over a narrowed range, an empty one (lo0 > hi0: nothing read), at a
    target nothing fits and one everything fits; one 500x500 image as
    (N, 64) components with 0-d bounds; and `rolled` rolled copies of the
    12 MP photo at 100 KB (1.17 GB of coefficients at 16)."""
    from fennec_tpu_torch.codecs.jpeg import forward_dct
    from fennec_tpu_torch.engine.targetsize import _bpp_bounds, _header_len

    by = {c[0]: c for c in oracle_cases(T, dev, big_img)}

    def main_path(target: int, w: int, h: int):
        return (target - _header_len(w, h),) + _bpp_bounds(target, w * h)

    _, c12, _, ph12, pw12, _ = by["12mp_420"]
    _, c1080, _, ph, pw, _ = by["1080p_420"]
    _, c500, _, p5, _, _ = by["t2_64x500_420"]
    _, c444, _, ph4, pw4, _ = by["1080p_444"]
    rng = np.random.default_rng(SEED + 78)
    t2_targets = torch.from_numpy(   # on the card: bounds built there
        rng.integers(10 * 1024, 30 * 1024, 64) - _header_len(500, 500)
    ).to(dev)
    cases = [
        ("12mp_420", c12, main_path(100 * 1024, 4032, 3024), ph12, pw12,
         True),
        ("1080p_420", c1080, main_path(200 * 1024, 1920, 1080), ph, pw,
         True),
        ("t2_64x500_420", c500, (t2_targets,) + _bpp_bounds(20 * 1024,
                                                            250000),
         p5, p5, True),
        ("1080p_444", c444, (200 * 1024, 1, 100), ph4, pw4, False),
        ("1080p_narrow", c1080, (200 * 1024, 40, 60), ph, pw, True),
        ("1080p_empty", c1080, (200 * 1024, 70, 20), ph, pw, True),
        ("1080p_none_fits", c1080, (1, 1, 100), ph, pw, True),
        ("1080p_all_fit", c1080, (10 ** 9, 1, 100), ph, pw, True),
        ("500_single", [c[7] for c in c500], (torch.tensor(18000),
                                              torch.tensor(10),
                                              torch.tensor(70)),
         p5, p5, True),
    ]
    if rolled:
        x = torch.from_numpy(np.stack([
            np.roll(big_img, (61 * i, 97 * i), axis=(0, 1))
            for i in range(rolled)])).to(dev)
        coefs = forward_dct(x.to(torch.float32), True)
        del x
        cases.append((f"{rolled}x12mp_420", coefs,
                      main_path(100 * 1024, 4032, 3024), ph12, pw12, True))
    return cases


def bisect_bound(coefs, table) -> dict:
    """K4's bisection's least time from its bytes: 256 B of float32
    coefficients per block of every image at every step it was still
    searching ("reread", the work the kernel does: its coefficients do
    not stay in L2 between steps when over 50 MB) and, as the kernel
    contract counts bytes, every input read once ("once": each image
    that searched at all, once; all a bisection needs if its
    coefficients stayed in L2), each in ms at 3.35 TB/s."""
    per_image = sum(c.shape[-2] for c in coefs) * 256
    active = (table >= 0).reshape(table.shape[0], -1)
    reread = int(active.sum()) * per_image
    once = int(active.any(dim=0).sum()) * per_image
    return {"reread_bound_ms": reread / HBM_BYTES_PER_S * 1e3,
            "bound_ms": once / HBM_BYTES_PER_S * 1e3,
            "coef_mb": active.shape[1] * per_image / 1e6,
            "active_steps": int(active.sum())}


def phase_bisect(T, dev, big_img, rolled: int = 16):
    """K4's bisection on the card against the step loop through K4's step
    and against the plain step loop (scan_bits), on the same CUDA tensors
    at every bisect_cases case: (best_q, found) and the (7, B) table of
    each step's bits equal; size_search.size_bisect launches the
    bisection once and K4's step never.  Timed in turns (step loop, new,
    new, step loop): CUDA-event ms and host µs per bisection, the new
    kernel's device µs (torch.profiler, its kernel's rows), the device
    ms and operations per bisection of both (every CUDA row), beside the
    bound and the plain step loop's ms.  Returns {tag: times}."""
    from fennec_tpu_torch.engine import size_search
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.jpeg_emit import (
        bisect_steps,
        layout_on,
        std_tables_on,
    )
    from fennec_tpu_torch.ops.jpeg_size import scan_bits

    out = {}
    steps = size_search.MAX_STEPS
    for tag, coefs, (target, lo, hi), ph, pw, sub in bisect_cases(
            T, dev, big_img, rolled):
        single = coefs[0].dim() == 2

        def new():
            return size_search.size_bisect(coefs, ph, pw, sub, target, lo,
                                           hi)

        def loop():
            return size_search.size_bisect_steps(coefs, ph, pw, sub, target,
                                                 lo, hi)

        bounds = size_search._bounds(coefs, target, lo, hi)

        def plain():
            def count(q):
                return scan_bits(*size_search.quantize_at(coefs, q), ph, pw,
                                 sub)
            return bisect_steps(count, *bounds, steps)

        before = (k3.size_bisect.launches, k3.quantize_count.launches)
        q, found = new()
        if dev.type == "cuda" and (
                k3.size_bisect.launches, k3.quantize_count.launches) != (
                before[0] + 1, before[1]):
            raise AssertionError(f"bisect {tag}: size_bisect did not launch "
                                 f"K4's bisection once and nothing else")
        stacked = [c[None] if single else c for c in coefs]
        kq, kf, table = k3.size_bisect(
            [c.contiguous() for c in stacked],
            size_search.quality_tables_on(dev),
                layout_on(ph, pw, sub, dev), std_tables_on(dev),
            bounds.reshape(3, -1), steps)
        lq, lf, ltable = loop()
        pq, pf, ptable = plain()
        if single and (q.dim() or found.dim()):
            raise AssertionError(f"bisect {tag}: one image gave "
                                 f"{tuple(q.shape)} results, not 0-d")
        got = [t.reshape(-1) for t in (q, found, kq, kf)]
        want = [t.reshape(-1) for t in (lq, lf, pq, pf)]
        if not (all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))
                and all(torch.equal(g, w) for g, w in zip(got[2:], want[:2]))
                and all(torch.equal(g, w) for g, w in zip(got[:2], want[2:]))
                and torch.equal(table, ltable.reshape(steps, -1))
                and torch.equal(table, ptable.reshape(steps, -1))):
            raise AssertionError(
                f"bisect {tag}: K4's bisection (q {got[0].tolist()[:6]}, "
                f"found {got[1].tolist()[:6]}) differs from the step loop "
                f"({want[0].tolist()[:6]}, {want[1].tolist()[:6]}) or the "
                f"plain loop ({want[2].tolist()[:6]}); tables\n"
                f"{table[:, :4].tolist()}\n"
                f"{ltable.reshape(steps, -1)[:, :4].tolist()}\n"
                f"{ptable.reshape(steps, -1)[:, :4].tolist()}")
        iters = 5 if tag.startswith(f"{rolled}x") else 20
        turns = {"loop": [], "new": []}
        for who in ("loop", "new", "new", "loop"):
            fn = new if who == "new" else loop
            turns[who].append((cuda_ms(fn, iters), host_us(fn, iters)))
        new_dev_ms, new_ops = profiled_all_device(new, iters)
        loop_dev_ms, loop_ops = profiled_all_device(loop, iters)
        t = {"images": table.shape[1], "found": int(kf.sum()),
             "max_abs_err": int((table - ltable.reshape(steps, -1))
                                .abs().max()),
             "kernel_ms": profiled_device_ms(new, iters,
                                             "size_bisect_kernel"),
             "device_ms": new_dev_ms, "device_ops": new_ops,
             "event_ms": min(ms for ms, _ in turns["new"]),
             "host_us": min(us for _, us in turns["new"]),
             "loop_device_ms": loop_dev_ms, "loop_device_ops": loop_ops,
             "loop_event_ms": min(ms for ms, _ in turns["loop"]),
             "loop_host_us": min(us for _, us in turns["loop"]),
             "turns_event_us": [round(ms * 1e3, 1) for who in
                                ("loop", "new") for ms, _ in turns[who]],
             "plain_ms": cuda_ms(plain, 2 if tag.startswith(
                 f"{rolled}x") else 3)}
        t.update(bisect_bound(stacked, table))
        t["share"] = t["bound_ms"] / t["kernel_ms"]
        t["reread_share"] = t["reread_bound_ms"] / t["kernel_ms"]
        out[tag] = t
        log(f"bisect {tag}: K4's bisection == the step loop through K4 == "
            f"the plain step loop (q {got[0].tolist()[:4]}.., table rows "
            f"equal) " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in t.items()))
        del coefs, stacked
    return out


def time_ts_device_work(dev, big_img) -> None:
    """CUDA-event time at 12 MP of the palette map of one level (the
    size oracle's step is phase_k4's)."""
    from fennec_tpu_torch.ops.quantize import median_cut, palette_indices

    h, w = big_img.shape[:2]
    img = torch.from_numpy(big_img).to(dev).to(torch.float32)
    rgb = img[..., :3].reshape(-1, 3).to(torch.int32)
    pal = torch.from_numpy(np.ascontiguousarray(
        median_cut(big_img, 256)[:, :3])).to(dev).to(torch.int32)
    map_ms = cuda_ms(lambda: palette_indices(rgb, pal), 5)
    log(f"ts device work at {w}x{h}: palette_map_ms={map_ms:.3f} "
        f"(256 colours, one level)")


def k3_cases(q12: int, q1080: int, q500: int):
    """Phase 11's shapes: the main path's 12 MP and 1080p photos at the
    qualities BALANCED picked in phase 4, a 64-image 500x500 chunk at the
    quality BALANCED picks for such a photo, T2's encode round (64 lanes
    at the 499x499 geometry S3 settles on, near its Q70), 1080p in 4:4:4,
    and ragged geometries (17x9, 1x1)."""
    return [("12mp_420", 4032, 3024, 1, True, q12, SEED),
            ("1080p_420", 1920, 1080, 1, True, q1080, SEED + 2),
            ("500x500x64_420", 500, 500, 64, True, q500, SEED + 100),
            ("t2_lanes_499x499x64_420", 499, 499, 64, True, 70, SEED + 900),
            ("1080p_444", 1920, 1080, 1, False, q1080, SEED + 2),
            ("ragged_17x9", 17, 9, 3, True, 100, SEED + 5),
            ("ragged_1x1_444", 1, 1, 2, False, 50, SEED + 6)]


def ab_run(tag: str, runs, check) -> dict:
    """Phase 12's A/B: each route once cold, then twice None, False,
    False, None warm (host clock; every call returns host bytes, so it
    ends synchronised).  check(outputs of None, outputs of False) must
    hold.  Returns {route: [four warm ms]}."""
    warm = {None: [], False: []}
    outs = {}
    for route in (None, False):
        outs[route] = runs[route]()
    for route in (None, False, False, None) * 2:
        t = time.perf_counter()
        runs[route]()
        warm[route].append((time.perf_counter() - t) * 1e3)
    check(outs[None], outs[False])
    log(f"A/B {tag}: digest="
        f"{digest(r.compressed_data for r in outs[None])}")
    log(f"A/B {tag}: device_entropy=None (K3) warm_ms="
        f"{[round(x, 1) for x in warm[None]]} device_entropy=False (host "
        f"encoder) warm_ms={[round(x, 1) for x in warm[False]]}; outputs "
        f"byte-identical")
    return warm


def phase_ab(T, dev, tmp, big_path):
    """Phase 12: device_entropy=None (K3 on the card) against False (the
    host C++ encoder) in this call, on warm 12 MP compress_file, the
    512-file batch and T2; every output byte-identical between them."""
    out = {}

    def same_results(a, b):
        for x, y in zip(a, b):
            if x.compressed_data != y.compressed_data:
                raise AssertionError("A/B: the two routes' bytes differ")

    out["12mp_compress_file"] = ab_run("12 MP compress_file", {
        route: (lambda route=route: [T.compress_file(
            None, big_path, os.path.join(tmp, f"ab_{route}.jpg"),
            T.Options(device_entropy=route), device=dev)])
        for route in (None, False)}, same_results)

    paths, _ = write_files500(T, dev, os.path.join(tmp, "ab500"))

    def batch(route):
        res = T.compress_batch(None, [
            T.BatchItem(src=p, dst=os.path.join(tmp, f"ab_{route}_{i}.jpg"))
            for i, p in enumerate(paths)], T.BatchOptions(
                fused=True, default_opts=T.Options(
                    format=T.JPEG, device_entropy=route)), device=dev)
        bad = [r for r in res if r.err is not None]
        if bad:
            raise AssertionError(f"A/B batch: {len(bad)} item(s) failed")
        return [r.result for r in res]

    out["batch512"] = ab_run("512-file compress_batch", {
        route: (lambda route=route: batch(route))
        for route in (None, False)}, same_results)

    images = [photo(500, 500, SEED + 900 + k) for k in range(64)]
    out["t2_64x500"] = ab_run("T2 compress_images 64x500x500 at 20 KB", {
        route: (lambda route=route: T.compress_images(
            None, images, T.Options(format=T.JPEG, target_size=20 * 1024,
                                    device_entropy=route), device=dev))
        for route in (None, False)}, same_results)
    return out


def phase_surface(T, dev, big_img):
    """Phase 13: ssim and ms_ssim at 12 MP on the card against the CPU
    (within K1_ATOL), and the effects at 12 MP (uint8, equal)."""
    from fennec_tpu_torch.ops import effects

    h, w = big_img.shape[:2]
    other = np.roll(big_img, (3, 5), axis=(0, 1))
    for name, fn in (("ssim", T.ssim), ("ms_ssim", T.ms_ssim)):
        t = time.perf_counter()
        card = fn(big_img, other, device=dev)
        card_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        card = fn(big_img, other, device=dev)
        warm_ms = (time.perf_counter() - t) * 1e3
        cpu = fn(big_img, other, device="cpu")
        if not (np.isfinite(card) and abs(card - cpu) <= K1_ATOL):
            raise AssertionError(f"{name} 12 MP: card {card} cpu {cpu}")
        log(f"surface {name} {w}x{h}: card={card:.7f} cpu={cpu:.7f} "
            f"cold_ms={card_ms:.1f} warm_ms={warm_ms:.1f}")
    for name, arg in (("sharpen", 0.6), ("adaptive_sharpen", 0.5),
                      ("gaussian_blur", 1.5)):
        fn = getattr(effects, name)
        t = time.perf_counter()
        card = fn(big_img, arg, device=dev)
        card_ms = (time.perf_counter() - t) * 1e3
        cpu = fn(big_img, arg, device="cpu")
        diff = np.abs(card.astype(np.int32) - cpu.astype(np.int32))
        if diff.max() != 0:
            raise AssertionError(f"{name} 12 MP: {np.count_nonzero(diff)} "
                                 f"values differ, by up to {diff.max()}")
        log(f"surface {name}({arg}) {w}x{h}: uint8 identical on the card "
            f"and the CPU, card_ms={card_ms:.1f}")


def mesh_units(snap, shards: int) -> int:
    """Shard chunks an engine call ran: each chunk's non-empty shards."""
    return sum(min(n, shards) for n in snap["chunk_items"])


def mesh_run(tag: str, run, counters, dev, shards: int, per_unit):
    """One engine call with K1's, K2's, K3's, K5's and K6's counts set to
    0 just
    before it and read just after: (outputs, wall s, launches).  Each
    kernel must have launched per_unit[k] times per shard chunk (a chunk
    of one device is one shard chunk; the kernels launch on a CUDA device
    only)."""
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.huffbuild_cuda import build_tables
    from fennec_tpu_torch.ops.probe_recon_cuda import probe_recon
    from fennec_tpu_torch.ops.ssim_cuda import ssim_window

    kernels = {"K1": ssim_window, "K2": probe_recon,
               "K3a": k3.block_stats, "K5": build_tables,
               "K3b": k3.deposit, "K6": K6Launches()}
    counters.reset()
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t
    got = {name: k.launches for name, k in kernels.items()}
    snap = counters.snapshot()
    units = mesh_units(snap, shards)
    want = {name: per_unit[name] * units for name in kernels}
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"{tag}: launches {got}, want {want} "
                             f"({units} shard chunks of {snap['chunk_items']}"
                             f" over {shards} shard(s))")
    return out, wall, got, snap


def phase_mesh(T, dev, counters, big_path, tmp, n=512, w=500, h=500,
               rounds: int = 3):
    """Phase 14: the mesh and the stages.  On one card, data_mesh(None)
    is None; the three batch routes on [cuda:k, cuda:k] (two shards, each
    on its own stream, in turn on one thread) against cuda:k, in turns, byte for
    byte, with their launches per shard chunk; the four *_sharded
    functions against their unsharded forms at (64, 500, 500); the CLI's
    -v report; a device_trace of one warm 12 MP compress_file naming K1,
    K2, K3a and K3b and each of the program's stages."""
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.parallel import batched as pb
    from fennec_tpu_torch.utils.profiling import device_trace

    cards = torch.cuda.device_count()
    log(f"mesh: torch.cuda.device_count()={cards} data_mesh(None)="
        f"{pb.data_mesh(None)}")
    if cards == 1 and pb.data_mesh(None) is not None:
        raise AssertionError("mesh: one card must keep the unsharded path")
    one = (torch.device("cuda", torch.cuda.current_device())
           if dev.type == "cuda" else dev)
    two = [one, one]
    paths, datas = write_files500(T, dev, os.path.join(tmp, "mesh500"), n,
                                  w, h)
    distinct = [photo(w, h, SEED + 300 + k) for k in range(32)]
    images = [distinct[i % 32] for i in range(256)]

    def batch(paths_, opts, tag):
        def run(device):
            res = T.compress_batch(None, [
                T.BatchItem(src=p, dst=os.path.join(tmp, f"{tag}{i}.jpg"))
                for i, p in enumerate(paths_)], T.BatchOptions(
                    fused=True, default_opts=opts), device=device)
            bad = [r.err for r in res if r.err is not None]
            if bad:
                raise AssertionError(f"mesh {tag}: {bad[:3]}")
            return [r.result.compressed_data for r in res]
        return run

    def pixel(device):
        return [r.compressed_data for r in T.compress_images(
            None, images, T.Options(format=T.JPEG), device=device)]

    routes = [
        ("batch512", batch(paths, T.Options(format=T.JPEG), "m"), n,
         {"K1": 7, "K2": 7, "K3a": 1, "K5": 1, "K3b": 1, "K6": 1},
         "coefficient"),
        ("images256", pixel, 256,
         {"K1": 7, "K2": 7, "K3a": 1, "K5": 1, "K3b": 1, "K6": 0}, "pixel"),
        # The Lanczos route keeps the host encoder (JAX :598-604).
        ("resize64", batch(paths[:64], T.Options(format=T.JPEG,
                                                  max_width=256), "r"), 64,
         {"K1": 7, "K2": 7, "K3a": 0, "K5": 0, "K3b": 0, "K6": 0},
         "coefficient"),
    ]
    summary = {}
    for tag, run, count, per_unit, route in routes:
        outs, walls = {}, {"one": [], "mesh": []}
        for k in range(rounds + 1):  # the first round warms both up
            order = (("one", one, 1), ("mesh", two, 2))
            if k % 2:
                order = order[::-1]
            for name, device, shards in order:
                out, wall, got, snap = mesh_run(
                    f"mesh {tag} {name}", lambda: run(device), counters, dev,
                    shards, per_unit)
                if snap["routes"] != {route: count}:
                    raise AssertionError(f"mesh {tag} {name}: routes "
                                         f"{snap['routes']}")
                if name in outs and out != outs[name]:
                    raise AssertionError(f"mesh {tag} {name}: outputs "
                                         f"differ between rounds")
                outs[name] = out
                if k:
                    walls[name].append(wall)
                log(f"mesh {tag} {name} round {k}: wall_ms="
                    f"{wall * 1e3:.1f} img_per_s={count / wall:.1f} "
                    f"chunks={snap['chunk_items']} launches={got}")
        if outs["one"] != outs["mesh"]:
            diff = sum(a != b for a, b in zip(outs["one"], outs["mesh"]))
            raise AssertionError(f"mesh {tag}: {diff} of {count} outputs "
                                 f"differ between the mesh and one device")
        med = {name: count / float(np.median(v)) for name, v in
               walls.items()}
        summary[tag] = med
        log(f"mesh {tag}: {count} outputs byte-identical on {two} and "
            f"{one}; warm img/s median of {rounds}: one={med['one']:.1f} "
            f"mesh={med['mesh']:.1f} digest={digest(outs['one'])}")

    # The four *_sharded functions at (64, 500, 500) against their
    # unsharded forms on the card.
    mesh = pb.data_mesh(two)
    imgs = torch.from_numpy(np.stack(distinct + distinct)).to(dev)
    targets = [0.94] * 64
    q1, s1, f1 = pb.batched_quality_search(imgs, targets)
    q2, s2, f2 = pb.batched_quality_search_sharded(mesh, imgs, targets)
    if not (torch.equal(q1, q2) and torch.equal(f1, f2)
            and torch.equal(s1, s2)):
        raise AssertionError("mesh: batched_quality_search_sharded differs")
    e1 = pb.batched_search_emit(imgs, targets)
    e2 = pb.batched_search_emit_sharded(mesh, imgs, targets)
    scans1 = [e1[3].scan(j) for j in range(64)]
    if (not np.array_equal(e1[0], e2[0]) or not np.array_equal(e1[2], e2[2])
            or e1[1].tobytes() != e2[1].tobytes()
            or scans1 != [e2[3].scan(j) for j in range(64)]):
        raise AssertionError("mesh: batched_search_emit_sharded differs")

    def counted(run):
        before = (k3.size_bisect.launches, k3.quantize_count.launches)
        got = run()
        return got, (k3.size_bisect.launches - before[0],
                     k3.quantize_count.launches - before[1])

    z1, n1 = counted(lambda: pb.batched_size_search(imgs, 20000, 1, 100))
    z2, n2 = counted(lambda: pb.batched_size_search_sharded(
        mesh, imgs, 20000, 1, 100))
    launched = [n1, n2]
    # One launch of K4's bisection per non-empty shard (both shards of 64
    # images hold 32), none of K4's step.
    if dev.type == "cuda" and launched != [(1, 0), (2, 0)]:
        raise AssertionError(f"mesh: K4's bisection and step launched "
                             f"{launched} times (one device, two shards)")
    if not all(torch.equal(a, b) for a, b in zip(z1, z2)):
        raise AssertionError("mesh: batched_size_search_sharded differs")
    other = torch.clamp(imgs.to(torch.float32) + 9.0, 0, 255)
    if not torch.equal(pb.batched_ssim(imgs, other),
                       pb.batched_ssim_sharded(mesh, imgs, other)):
        raise AssertionError("mesh: batched_ssim_sharded differs")
    log(f"mesh sharded functions at (64, 500, 500) on {two}: q, found and "
        f"SSIM bit-equal, scan bytes equal (digest {digest(scans1)}), size "
        f"search (q, found) equal (found {int(z1[1].sum())} of 64; K4's "
        f"bisection launched {launched[0][0]} / {launched[1][0]} times)")

    # The CLI's -v report on the 12 MP file.
    env = dict(os.environ, PYTHONPATH=HERE)
    proc = subprocess.run(
        [sys.executable, "-m", "fennec_tpu_torch", big_path,
         os.path.join(tmp, "cli_v.jpg"), "-v", "--device", dev.type],
        capture_output=True,
        text=True, cwd=HERE, env=env, timeout=600)
    lines = proc.stderr.splitlines()
    if proc.returncode != 0 or "  Stages:" not in lines:
        raise AssertionError(f"cli -v: rc={proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    stages = lines[lines.index("  Stages:") + 1:]
    names = sorted(ln[:24].strip() for ln in stages if ln.endswith("avg)"))
    if names != sorted(REQUEST_STAGES + ("write",)):
        raise AssertionError(f"cli -v stages {names}")
    for ln in stages:
        log(f"  cli -v: {ln}")

    # A device_trace of one warm 12 MP compress_file.
    out = os.path.join(tmp, "trace_out.jpg")
    T.compress_file(None, big_path, out, T.Options(), device=dev)
    want = ("ssim_window_kernel", "probe_recon_kernel", "block_stats_kernel",
            "deposit_kernel")
    found = {}
    for attempt in range(3):  # the profiler may drop records
        trace_dir = os.path.join(tmp, f"trace{attempt}")
        with device_trace(trace_dir):
            T.compress_file(None, big_path, out, T.Options(), device=dev)
        names = set()
        for fname in os.listdir(trace_dir):
            with open(os.path.join(trace_dir, fname)) as f:
                names.update(str(e.get("name", ""))
                             for e in json.load(f)["traceEvents"])
        found = {k: any(k in nm for nm in names) for k in want}
        missing = sorted(set(REQUEST_STAGES) - names)
        log(f"device_trace of a warm 12 MP compress_file: {len(names)} "
            f"event names, kernels named {found}, stages missing "
            f"{missing} (trace {attempt + 1})")
        if all(found.values()) or dev.type != "cuda":
            break
    if dev.type == "cuda" and not all(found.values()):
        raise AssertionError(f"device_trace names {found}")
    if missing:
        raise AssertionError(f"device_trace lacks the stages {missing}")
    return summary


# The data×spatial phase's searches: (tag, width, height, bands).  The
# 12 MP portrait's and the 64 MP square's seams fall on rectangle edges
# (4032 / 512 and 8192 / 512 rows a rectangle); 4000 x 3008 goes to 385
# rows of 7.81, so three of its four bands read a halo of one MCU row.
SPATIAL_CASES = [("12mp_portrait_2", 3024, 4032, 2),
                 ("12mp_portrait_4", 3024, 4032, 4),
                 ("12mp_landscape_straddling_4", 4000, 3008, 4),
                 ("64mp_4", 8192, 8192, 4)]


def unsharded_search(imgs: torch.Tensor, target: float):
    """The unsharded counterpart of quality_search_spatial_sharded at B =
    1 on the device: batched_quality_search_quantize's search, the winner
    quantized by quantize_coefs, nothing copied to the host."""
    from fennec_tpu_torch.codecs.jpeg import quantize_coefs
    from fennec_tpu_torch.engine import compress as tcomp

    inp, coefs, (q, s, f) = tcomp._search_chunk(imgs, [target], True)
    final = inp.tables[torch.where(f, q, 100)][0]
    return q[0], s[0], f[0], quantize_coefs(tuple(c[0] for c in coefs), final)


def spatial_recorded(pb, mesh, img, target):
    """One sharded search with every band's probe recorded: (result,
    [(band, quality, K2's luminance)], {band: its SearchInputs})."""
    from fennec_tpu_torch.engine import compress as tcomp

    calls, inputs = [], {}
    inner = tcomp.probe_luminance

    def probe(inp, quality):
        lum = inner(inp, quality)
        calls.append((inp.band, quality.clone(), lum.clone()))
        inputs[inp.band] = inp
        return lum

    pb._compress.probe_luminance = probe
    try:
        got = pb.quality_search_spatial_sharded(mesh, img, target)
    finally:
        pb._compress.probe_luminance = inner
    torch.cuda.synchronize()
    return got, calls, inputs


def band_vs_plain(inp, quality: torch.Tensor, lum: torch.Tensor):
    """K2's luminance `lum` of one band at `quality` against its plain
    version on the same band inputs, phase_k2's rule: (pixels that
    differ, of them those at a float32 box-mean tie, max |diff|).  A
    tie: in some channel the exact box mean of the reconstruction lies
    within 1e-3 of a half level, where the plain version's float32
    products may round the other way than K2's integer sum."""
    from fennec_tpu_torch.engine import compress as tcomp
    from fennec_tpu_torch.ops.filters import box_weights

    want = tcomp.probe_luminance_plain(inp, quality)
    differ = (lum != want)[0]
    err = float((lum - want).abs().max())
    ties = 0
    if inp.box_wh is not None and bool(differ.any()):
        band, dev = inp.band, lum.device
        ds_w = int(lum.shape[-1])
        rgb = tcomp._reconstruct_rgb_planes(*inp.cplanes,
                                            inp.tables[quality], inp.dmat,
                                            inp.subsample, inp.h, inp.w)
        wv = torch.from_numpy(box_weights(band.dst_h, band.src_h)[
            band.d0:band.d1, band.start:band.end]).to(dev)
        wh = torch.from_numpy(box_weights(ds_w, inp.w)).to(dev)
        means = torch.matmul(wv, torch.matmul(
            torch.cat(rgb).to(torch.float64), wh.T))
        frac = (means % 1.0 - 0.5).abs().amin(dim=0)
        ties = int((differ & (frac < 1e-3)).sum())
    return int(differ.sum()), ties, err


def exact_box_rgb(img: torch.Tensor) -> torch.Tensor:
    """float64 box means (dh, dw, 3) of an (H, W, 4) image: the exact
    values SSIMFast's float32 products round."""
    from fennec_tpu_torch.ops.filters import box_weights
    from fennec_tpu_torch.ops.ssim import ssim_fast_dims

    h, w = img.shape[:2]
    ds_w, ds_h = ssim_fast_dims(w, h)
    wv = torch.from_numpy(box_weights(ds_h, h)).to(img.device)
    wh = torch.from_numpy(box_weights(ds_w, w)).to(img.device)
    rgb = img[..., :3].permute(2, 0, 1).to(torch.float64)
    return torch.matmul(wv, torch.matmul(rgb, wh.T)).permute(1, 2, 0)


def phase_spatial(T, dev, rounds: int = 2):
    """Phase 15: the data×spatial mesh on bands of this card.  Each case
    of SPATIAL_CASES at BALANCED's target through
    quality_search_spatial_sharded on [cuda:k] * bands against the
    unsharded search on cuda:k: (q, found) equal, the blocks equal, SSIM
    equal or within 1e-5 with the original's luminance pixels that differ
    counted and each held to a float32 box-mean tie; K2 launched 7 times
    per band and K1 7 times per search, counted from 0 around the call;
    every band's K2 luminance at each of its 7 probes bit-equal to the
    rows it owns of K2 on the whole image, and held to its plain version
    on the same band inputs (band_vs_plain: every differing pixel at a
    float32 box-mean tie, |diff| <= 1).  CUDA-event ms of both in turns
    and each call's peak device memory, beside the card's name and power
    limit.  Then batched_ssim_sharded(spatial=True) on (2, 2160, 3840)
    over a 2 x 2 mesh against batched_ssim (K1 on whole images) and the
    plain windowed SSIM, each within 1e-5."""
    from fennec_tpu_torch.engine import compress as tcomp
    from fennec_tpu_torch.ops.color import luminance
    from fennec_tpu_torch.ops.probe_recon_cuda import probe_recon
    from fennec_tpu_torch.ops.ssim import batched_ssim_plain
    from fennec_tpu_torch.ops.ssim_cuda import ssim_window
    from fennec_tpu_torch.parallel import batched as pb
    from fennec_tpu_torch.parallel import mesh as pm

    one = torch.device("cuda", torch.cuda.current_device())
    target = T.BALANCED.target_ssim()
    smi = nvidia_smi_line()
    summary = {}
    for tag, w, h, n in SPATIAL_CASES:
        mesh = pm.data_spatial_mesh(n, n, [one] * n)
        img = torch.from_numpy(photo(w, h, SEED + 1500 + n)).to(one)
        imgs = img[None].to(torch.float32)
        want = unsharded_search(imgs, target)
        for k in (ssim_window, probe_recon):
            k.launches = 0
        got = pb.quality_search_spatial_sharded(mesh, img, target)
        torch.cuda.synchronize()
        launched = (probe_recon.launches, ssim_window.launches)
        if dev.type == "cuda" and launched != (7 * n, 7):
            raise AssertionError(f"spatial {tag}: K2, K1 launched "
                                 f"{launched}, want {(7 * n, 7)}")
        got2, calls, band_inputs = spatial_recorded(pb, mesh, img, target)
        inp, _ = tcomp.prepare_search(imgs, True)
        unequal = plain_diff = plain_ties = 0
        plain_err = 0.0
        for band, quality, lum in calls:
            whole = tcomp.probe_luminance(inp, quality)
            unequal += int(not torch.equal(lum[0],
                                           whole[0, band.d0:band.d1]))
            n_diff, ties, err = band_vs_plain(band_inputs[band], quality,
                                              lum)
            plain_diff += n_diff
            plain_ties += ties
            plain_err = max(plain_err, err)
        if unequal or len(calls) != 7 * n:
            raise AssertionError(f"spatial {tag}: {unequal} of {len(calls)}"
                                 f" band probes differ from K2 on the whole "
                                 f"image")
        if plain_err > K2_LEVEL_ATOL or plain_diff != plain_ties:
            raise AssertionError(
                f"spatial {tag}: band K2 against its plain version: "
                f"{plain_diff} pixels differ, {plain_ties} of them at a "
                f"float32 box-mean tie, max |diff| {plain_err} (limit "
                f"{K2_LEVEL_ATOL})")
        originals = {b: x.lum_orig for b, x in band_inputs.items()}
        lum_bands = torch.cat([originals[b] for b in sorted(originals)],
                              dim=1)
        differ = (lum_bands != inp.lum_orig)[0]
        exact = exact_box_rgb(img)
        frac = (exact % 1.0 - 0.5).abs().amin(dim=-1)
        ties = int((differ & (frac < 1e-3)).sum())
        others = int(differ.sum()) - ties
        blocks = torch.cat(got[3]).to(torch.int16)
        same_blocks = torch.equal(blocks, torch.cat(want[3]).to(torch.int16))
        s_diff = abs(float(got[1]) - float(want[1]))
        ok = (int(got[0]) == int(want[0]) and bool(got[2]) == bool(want[2])
              and same_blocks and others == 0
              and (s_diff == 0 or (s_diff <= K1_ATOL and ties > 0))
              and all(torch.equal(a, b) for a, b in zip(got[:3], got2[:3])))
        log(f"spatial {tag}: {w}x{h} over {n} bands of {h // n} rows of "
            f"{one}: q={int(got[0])}/{int(want[0])} found="
            f"{bool(got[2])}/{bool(want[2])} ssim={float(got[1]):.7f}/"
            f"{float(want[1]):.7f} blocks_equal={same_blocks} "
            f"original_luminance_pixels_differing={int(differ.sum())} "
            f"(at a float32 box-mean tie {ties}, other {others}) "
            f"band_probes_bit_equal={len(calls) - unequal}/{len(calls)} "
            f"band_k2_vs_plain pixels_differing={plain_diff} (at a float32 "
            f"box-mean tie {plain_ties}) max_abs_diff={plain_err:.6f} "
            f"launches K2={launched[0]} K1={launched[1]} "
            f"halo_rows={[b.end - b.stop for b in sorted(originals)]}")
        if not ok:
            raise AssertionError(f"spatial {tag}: differs from the "
                                 f"unsharded search")
        del inp, calls, band_inputs, originals, exact, frac, got2
        times = {"sharded": [], "unsharded": []}
        peaks = {}
        runs = {"sharded": lambda: pb.quality_search_spatial_sharded(
                    mesh, img, target),
                "unsharded": lambda: unsharded_search(
                    img[None].to(torch.float32), target)}
        for k in range(rounds + 1):  # the first round warms both up
            order = ("unsharded", "sharded", "sharded", "unsharded")
            for name in order if k else order[:2]:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(one)
                base = torch.cuda.memory_allocated(one)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = runs[name]()
                end.record()
                torch.cuda.synchronize()
                del out
                if k:
                    times[name].append(start.elapsed_time(end))
                peaks[name] = max(peaks.get(name, 0),
                                  torch.cuda.max_memory_allocated(one) - base)
        summary[tag] = {
            "sharded_ms": times["sharded"], "unsharded_ms": times["unsharded"],
            "sharded_peak_mb": peaks["sharded"] / 2**20,
            "unsharded_peak_mb": peaks["unsharded"] / 2**20}
        log(f"spatial {tag} timing (CUDA events, whole call, in turns "
            f"unsharded, sharded, sharded, unsharded; card {smi}): "
            f"sharded_ms={[round(t, 3) for t in times['sharded']]} "
            f"unsharded_ms={[round(t, 3) for t in times['unsharded']]} "
            f"peak_mb sharded={peaks['sharded'] / 2**20:.1f} "
            f"unsharded={peaks['unsharded'] / 2**20:.1f} (all bands on one "
            f"card: the split per card is not measured)")
        del img, imgs, want, got, blocks

    # Spatial SSIM: (2, 2160, 3840) over a 2 x 2 mesh.
    rng = np.random.default_rng(SEED + 1600)
    a = torch.from_numpy(np.stack([photo(3840, 2160, SEED + 1601 + i)
                                   for i in range(2)])).to(one)
    b = torch.clamp(a.to(torch.float32) + torch.from_numpy(
        rng.normal(0, 6, a.shape).astype(np.float32)).to(one), 0, 255)
    mesh = pm.data_spatial_mesh(4, 2, [one] * 4)
    want = pb.batched_ssim(a, b)
    plain = batched_ssim_plain(luminance(a.to(torch.float32)),
                               luminance(b.to(torch.float32)))
    ssim_window.launches = 0
    got = pb.batched_ssim_sharded(mesh, a, b, spatial=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_plain = float((got - plain).abs().max())
    if ssim_window.launches != 4 or max(err, err_plain) > K1_ATOL:
        raise AssertionError(f"spatial ssim: |diff| {err} from K1 on whole "
                             f"images, {err_plain} from the plain windowed "
                             f"SSIM, K1 launched {ssim_window.launches} "
                             f"times (want 4)")
    log(f"spatial ssim (2, 2160, 3840) over a 2 x 2 mesh of {one}: "
        f"{got.tolist()} vs K1 on whole images {want.tolist()} (max |diff| "
        f"{err:.3e}) vs the plain windowed SSIM {plain.tolist()} (max "
        f"|diff| {err_plain:.3e}), K1 launched 4 times (one per band of "
        f"each data row)")
    return summary


# ── Phase 17: the upload routes and K6 ─────────────────────────────────────

# K6's source lines it replaces, by layout: the XLA programs of the JAX
# package that rebuild a chunk's blocks from its upload.
K6_REPLACES = {"coo": "fennec_tpu/parallel/batched.py:570",
               "i8": "fennec_tpu/parallel/batched.py:542",
               "csr": "fennec_tpu/parallel/batched.py:732"}
K6_KERNEL = {"coo": "coo_tile_kernel", "i8": "i8_tile_kernel",
             "csr": "csr_tile_kernel"}
# The first K6 (a warp rebuilds one block and leaves), kept to be held
# bit for bit and timed in turns against the current one, and its rebuild
# kernels' names.
FIRST_K6_SOURCE = os.path.join("bench_sources", "coef_wire_first.cu")
FIRST_K6_KERNEL = {"coo": "coo_kernel", "i8": "i8_kernel",
                   "csr": "csr_kernel"}
# The batch routes phase 17 forces, with the environment that forces each
# and the upload event its chunks must carry.
WIRE_ROUTES = (("coo", {}, "upload_coo"),
               ("dense", {"FENNEC_UPLOAD": "dense"}, "upload_i8"),
               ("csr", {"FENNEC_UPLOAD": "csr"}, "upload_csr"))


@contextlib.contextmanager
def env_set(values: dict):
    """os.environ with `values` set (None: removed), restored after."""
    keys = ("FENNEC_UPLOAD", "FENNEC_COO", "FENNEC_PIXEL_WIRE", *values)
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update({k: v for k, v in values.items() if v is not None})
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def int16_uploads(on: bool = True):
    """While on, the coefficient engine uploads every chunk as int16
    blocks, as it does a resized chunk (and as every chunk went up before
    the compact routes): the yardstick phase 17 times them against.  It
    patches the engine's private _CoefWire; phase 17 checks that every
    chunk's event says upload_int16, so a patch that stops taking effect
    fails there, and wire_search_agrees holds the layouts to int16
    blocks without it."""
    from fennec_tpu_torch.engine import batched as tb

    real = tb._CoefWire.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.resize = True

    if on:
        tb._CoefWire.__init__ = init
    try:
        yield
    finally:
        tb._CoefWire.__init__ = real


def wire_exceptions(parts):
    """Per-image (offsets, values) → (exc_off (B, E) int32, exc_val (B, E)
    int16, exc_n (B,) int32) host tensors."""
    e = max((p[0].size for p in parts), default=0)
    off = np.zeros((len(parts), e), np.int32)
    val = np.zeros((len(parts), e), np.int16)
    n = np.zeros(len(parts), np.int32)
    for j, (ei, ev) in enumerate(parts):
        n[j] = ei.size
        off[j, :ei.size] = ei
        val[j, :ei.size] = ev
    return [torch.from_numpy(x) for x in (off, val, n)]


def wire_sections(datas, dev):
    """The three upload layouts of files of one geometry, on `dev`, built
    as the engine builds them (engine/batched._CoefWire): COO at the
    census's R (the pairs past it demoted to exceptions), dense int8 cut
    at the largest zigzag extent K (exceptions remapped to NT x K), CSR
    from the census decode.  Returns ({layout: sections}, NT, R, K)."""
    from fennec_tpu_torch.codecs import jpeg as cj
    from fennec_tpu_torch.engine.batched import COO_RCAP, _census_r

    specs = cj._build_decode_specs(cj.parse_jpeg(datas[0]))[4]
    nt = sum(sp.bw * sp.bh for sp in specs)
    b = len(datas)
    dcp = np.zeros((b, nt), np.int8)
    posp = np.zeros((b, nt, COO_RCAP), np.uint8)
    valp = np.zeros((b, nt, COO_RCAP), np.int8)
    full = np.zeros((b, nt, 64), np.int8)
    coo_parts, i8_parts, maxks = [], [], []
    hist = np.zeros(65, np.int64)
    for j, d in enumerate(datas):
        got = cj.decode_jpeg_to_coefs_coo(d, dcp[j], posp[j], valp[j],
                                          max_exc=1 << 24)
        got8 = cj.decode_jpeg_to_coefs_i8(d, full[j], max_exc=1 << 24)
        if got is None or got8 is None:
            raise AssertionError("wire: a file rejects the compact decoders")
        coo_parts.append((got[1], got[2]))
        hist += got[3]
        i8_parts.append((got8[1], got8[2]))
        maxks.append(got8[3])
    r = _census_r(hist, b, nt)[0]
    k = max(maxks)
    coo = []
    for j, (ei, ev) in enumerate(coo_parts):
        blk, slot = np.nonzero(posp[j, :, r:])
        coo.append((np.concatenate([ei, (blk * 64 + posp[j, blk, slot + r])
                                    .astype(np.int32)]),
                    np.concatenate([ev, valp[j, blk, slot + r]
                                    .astype(np.int16)])))
    occ = posp != 0
    counts = occ.sum(axis=2).astype(np.uint8)
    per_img = counts.sum(axis=1, dtype=np.int64)
    spos = np.zeros((b, int(per_img.max())), np.uint8)
    sval = np.zeros(spos.shape, np.int8)
    for j in range(b):
        spos[j, :per_img[j]] = posp[j][occ[j]]
        sval[j, :per_img[j]] = valp[j][occ[j]]
    host = {
        "coo": [torch.from_numpy(dcp),
                torch.from_numpy(np.ascontiguousarray(posp[:, :, :r])),
                torch.from_numpy(np.ascontiguousarray(valp[:, :, :r])),
                *wire_exceptions(coo)],
        "i8": [torch.from_numpy(np.ascontiguousarray(full[:, :, :k])),
               *wire_exceptions([((ei // 64) * k + ei % 64, ev)
                                 for ei, ev in i8_parts])],
        "csr": [torch.from_numpy(dcp), torch.from_numpy(counts),
                torch.from_numpy(spos), torch.from_numpy(sval),
                *wire_exceptions(coo_parts)],
    }
    return ({layout: [x.to(dev) for x in secs]
             for layout, secs in host.items()}, nt, r, k)


def wire_search_agrees(T, datas, sections, dev) -> None:
    """The search's outputs (quality, SSIM, found, quantized blocks) from
    these files' int16 blocks, decoded here by decode_jpeg_to_coefs, and
    from each compact layout's sections through K6 (batched_wire_search_
    quantize): all equal."""
    from fennec_tpu_torch.codecs.jpeg import decode_jpeg_to_coefs
    from fennec_tpu_torch.engine.batched import qualify_jpeg_bytes
    from fennec_tpu_torch.parallel.batched import \
        batched_wire_search_quantize

    w, h, in_sub = qualify_jpeg_bytes(datas[0])
    blocks = []
    qtabs = np.zeros((len(datas), 2, 64), np.int32)
    for j, d in enumerate(datas):
        hdr, coefs = decode_jpeg_to_coefs(d)
        blocks.append(np.concatenate(coefs))
        for c in (0, 1):
            qtabs[j, c] = hdr.qtables[hdr.comps[c]["tq"]]
    opts = T.Options(format=T.JPEG)
    args = (torch.from_numpy(qtabs).to(dev), h, w, in_sub,
            bool(opts.subsample), [opts.quality.target_ssim()] * len(datas))
    want = batched_wire_search_quantize(
        "int16", (torch.from_numpy(np.stack(blocks)).to(dev),), *args)
    for layout, secs in sections.items():
        got = batched_wire_search_quantize(layout, secs, *args)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"wire {layout}: the search's outputs "
                                 f"differ from the int16 blocks'")
    log(f"wire: the search over {len(datas)} files gives the same "
        f"qualities, SSIM and blocks from int16 blocks and from "
        f"{', '.join(sections)}")


def k6_plain():
    """{layout: K6's plain version} (fennec_tpu_torch/ops/coef_wire.py)."""
    from fennec_tpu_torch.ops import coef_wire

    return {"coo": coef_wire.coo_to_natural, "i8": coef_wire.i8_to_natural,
            "csr": coef_wire.csr_to_natural}


class FirstK6:
    """The first K6 (FIRST_K6_SOURCE) built here with nvcc and called
    through the port's wrappers given its library (`wrappers`, {layout:
    wrapper}; their launches count apart from K6's).  The port does not
    import it."""

    def __init__(self) -> None:
        from fennec_tpu_torch.ops import coef_wire_cuda as k6

        self.library = k6.WireLibrary(
            os.path.join(HERE, FIRST_K6_SOURCE),
            os.path.join(k6.BUILD_DIR, "libcoef_wire_first.so"))
        self.library.build(force=True)
        self.library.load()
        self.build_log = self.library.build_log
        self.wrappers = {"coo": k6.UnpackCoo(self.library),
                         "i8": k6.UnpackI8(self.library),
                         "csr": k6.UnpackCsr(self.library)}


def k6_agree(tag: str, layout: str, secs, first=None, want=None) -> None:
    """K6 on one layout's sections (twice) against its plain version on
    the same tensors, the first K6 (a FirstK6) and `want` (the decoder's
    blocks on the device), bit for bit; raises on any difference."""
    got = k6_wrappers()[layout](*secs)
    others = {"plain version": k6_plain()[layout](*secs),
              "second call": k6_wrappers()[layout](*secs)}
    if first is not None:
        others["first K6"] = first.wrappers[layout](*secs)
    if want is not None:
        others["decoder"] = want
    for who, other in others.items():
        if not torch.equal(got, other):
            bad = int((got != other).sum())
            raise AssertionError(f"K6 {tag} {layout}: {bad} of "
                                 f"{got.numel()} values differ from the "
                                 f"{who}")


def check_k6(tag: str, datas, dev, want=None, first=None):
    """K6 on every layout of these files against its plain version on the
    same CUDA tensors, the first K6 (`first`, a FirstK6, when given) and
    the C++ decoder's int16 blocks (`want`, decoded here when None), bit
    for bit.  Returns the layouts' sections, NT, R and K."""
    from fennec_tpu_torch.codecs.jpeg import decode_jpeg_to_coefs

    sections, nt, r, k = wire_sections(datas, dev)
    if want is None:
        want = np.stack([np.concatenate(decode_jpeg_to_coefs(d)[1])
                         for d in datas])
    want_dev = torch.from_numpy(want).to(dev)
    for layout, secs in sections.items():
        k6_agree(tag, layout, secs, first, want_dev)
    e = {lay: int(secs[-3].shape[1]) for lay, secs in sections.items()}
    log(f"K6 {tag}: ({len(datas)}, {nt}) R={r} K={k} exception rows {e}: "
        f"coo, i8, csr bit-equal to the plain version, the decoder"
        f"{' and the first K6' if first is not None else ''}")
    return sections, nt, r, k


def k6_cases():
    """[(tag, layout, host sections)] that cross K6's seams, made with
    numpy (ops/coef_wire.py's layouts): COO at every R the engine's census
    picks (COO_RS) and int8 at K = 1, 8, 63, 64, on 3 images of 101
    blocks (303: no multiple of the tile); CSR on 3 images of 101 blocks
    (no multiple of the tile either), the second with no pairs, counts up
    to 63, streams padded past the pairs, and on 2 images of 70 000 blocks
    (the scan's second round of tiles); each without exception rows (E =
    0) and with them: rows at a block's DC and at its last coefficient,
    live rows outside the image (negative, at and past NT x width), dead
    rows (past exc_n) inside it, every image's rows in no order; and each
    layout once more as rows 1.. of a chunk of 4 images, views whose
    sections start at addresses that are no multiple of 16 (NT x K odd
    for int8, M odd for CSR)."""
    from fennec_tpu_torch.engine.batched import COO_RS

    rng = np.random.default_rng(SEED + 615)

    def pairs(bsz, nt, r, counts):
        """(pos, val) (bsz, nt, r): counts[b, n] distinct zigzag positions
        1..63 ascending, nonzero int8 values, position 0 past them."""
        pick = np.argsort(rng.random((bsz, nt, 63)), axis=2)[:, :, :r] + 1
        pick.sort(axis=2)
        live = np.arange(r) < counts[:, :, None]
        pos = np.where(live, pick, 0).astype(np.uint8)
        val = rng.integers(1, 128, (bsz, nt, r)) * rng.choice([-1, 1],
                                                              (bsz, nt, r))
        val = np.where(live, np.clip(val, -128, 127), 0).astype(np.int8)
        return pos, val

    def exceptions(bsz, nt, width, rows):
        """(exc_off, exc_val, exc_n); rows = 0: E = 0."""
        limit = nt * width
        off = np.zeros((bsz, rows), np.int32)
        val = rng.integers(-2048, 2048, (bsz, rows)).astype(np.int16)
        n = np.zeros(bsz, np.int32)
        if rows == 0:
            return off, val, n
        special = np.unique([0, width - 1, (nt - 1) * width, limit - 1])
        for j in range(bsz):
            inside = rows - 6 - 3 * j
            cand = np.setdiff1d(rng.choice(limit, inside + 4, replace=False),
                                special)
            live = np.concatenate([special, cand[:inside - special.size],
                                   [-7, limit, limit + 100]])
            rng.shuffle(live)
            n[j] = live.size
            dead = rng.integers(0, limit, rows - live.size)
            off[j] = np.concatenate([live, dead])
        return off, val, n

    def with_exc(tag, layout, secs, bsz, nt, width):
        out = []
        for rows in (0, 40):
            exc = exceptions(bsz, nt, width, rows)
            out.append((f"{tag}_e{rows}", layout,
                        [torch.from_numpy(x) for x in (*secs, *exc)]))
        return out

    def csr(bsz, nt, empty=None):
        counts = rng.integers(0, 64, (bsz, nt))
        if empty is not None:
            counts[empty] = 0
        pos, val = pairs(bsz, nt, 63, counts)
        per_img = counts.sum(axis=1)
        m = int(per_img.max()) + 7
        m += 1 - m % 2  # odd: rows 1.. of the streams start unaligned
        spos = np.zeros((bsz, m), np.uint8)
        sval = np.zeros((bsz, m), np.int8)
        occ = pos != 0
        for j in range(bsz):
            spos[j, :per_img[j]] = pos[j][occ[j]]
            sval[j, :per_img[j]] = val[j][occ[j]]
        dc = rng.integers(-128, 128, (bsz, nt)).astype(np.int8)
        return [dc, counts.astype(np.uint8), spos, sval]

    def coo(bsz, nt, r):
        pos, val = pairs(bsz, nt, r, rng.integers(0, r + 1, (bsz, nt)))
        return [rng.integers(-128, 128, (bsz, nt)).astype(np.int8), pos, val]

    def i8(bsz, nt, k):
        blk = rng.integers(-128, 128, (bsz, nt, k)).astype(np.int8)
        return [np.where(rng.random(blk.shape) < 0.5, blk, 0).astype(np.int8)]

    cases = []
    for r in COO_RS:
        cases += with_exc(f"coo_r{r}", "coo", coo(3, 101, r), 3, 101, 64)
    for k in (1, 8, 63, 64):
        cases += with_exc(f"i8_k{k}", "i8", i8(3, 101, k), 3, 101, k)
    cases += with_exc("csr_101", "csr", csr(3, 101, empty=1), 3, 101, 64)
    cases += with_exc("csr_70000", "csr", csr(2, 70_000), 2, 70_000, 64)
    for tag, layout, secs, width in (("coo_r6", "coo", coo(4, 101, 6), 64),
                                     ("i8_k63", "i8", i8(4, 101, 63), 63),
                                     ("csr_101", "csr", csr(4, 101), 64)):
        exc = exceptions(4, 101, width, 40)
        cases.append((f"{tag}_rows1", layout,
                      [torch.from_numpy(x) for x in (*secs, *exc)]))
    return cases


def check_k6_cases(dev, first=None) -> int:
    """K6 on every k6_cases case against its plain version and the first
    K6 (when given), bit for bit; a "_rows1" case is cut to rows 1.. on
    the device.  Returns the number of cases."""
    cases = k6_cases()
    for tag, layout, secs in cases:
        secs = [x.to(dev) for x in secs]
        if tag.endswith("_rows1"):
            secs = [x[1:] for x in secs]
            if dev.type == "cuda" and all(
                    x.data_ptr() % 16 == 0 for x in secs[:-3]):
                raise AssertionError(f"K6 {tag}: every section aligned")
        k6_agree(tag, layout, secs, first)
    log(f"K6 cases: {len(cases)} bit-equal to the plain version"
        f"{' and the first K6' if first is not None else ''}")
    return len(cases)


def kernel_name(key: str) -> str:
    """A profiler row's kernel name without its namespace and arguments."""
    m = re.search(r"(\w+)\(", key)
    return m.group(1) if m else key[:40]


def k6_bound(layout: str, secs, nt: int) -> float:
    """K6's least ms: the bytes it must read and write at the card's
    memory rate (its work is a few integer operations a value: bytes
    bound it).  Read: the dense sections whole, each image's exception
    count and its live exception rows (6 bytes each; the (B, E) rows'
    padding past exc_n is never read), and for CSR the live pairs (2
    bytes each; the (B, M) streams' padding past each image's pairs is
    never read); written: 128 bytes a block."""
    exc_n = secs[-1]
    dense = secs[:2] if layout == "csr" else secs[:-3]
    pairs = int(secs[1].sum(dtype=torch.int64)) if layout == "csr" else 0
    nbytes = sum(x.numel() * x.element_size() for x in dense)
    nbytes += exc_n.numel() * 4 + int(exc_n.sum()) * 6 + pairs * 2
    nbytes += secs[0].shape[0] * nt * 128
    return nbytes / HBM_BYTES_PER_S * 1e3


def k6_turn(fn, kernel: str, iters: int) -> dict:
    """One turn of a K6 build on one layout's sections: device ms per
    call (torch.profiler: every CUDA row of the call over the launches of
    its rebuild kernel `kernel`), device operations and device µs of each
    kernel per call, CUDA-event ms and host µs."""
    rows, _ = profiled_rows(fn, iters, kernel)
    if rows is None:
        dev_ms, ops, split = cuda_ms(fn, iters), None, None
    else:
        calls = sum(e.count for e in rows if kernel in e.key)
        dev_ms = sum(device_us(e) for e in rows) / calls / 1e3
        ops = sum(e.count for e in rows) / calls
        split = {kernel_name(e.key): device_us(e) / calls for e in rows}
    return {"ms": dev_ms, "device_ops": ops, "kernel_us": split,
            "event_ms": cuda_ms(fn, iters), "host_us": host_us(fn, iters)}


def k6_trusted(turns: list) -> list:
    """The turns whose profiler reading holds at least 0.8 of their own
    CUDA-event time (a K6 call keeps the card busy from its first launch
    to its last: the profiler has been seen to record half of a call's
    kernel time, 20.5 µs against 47.6 of events); all of them when none
    does."""
    kept = [t for t in turns if t["ms"] >= 0.8 * t["event_ms"]]
    if len(kept) < len(turns):
        log(f"K6 timing: profiler readings dropped as below 0.8 of their "
            f"CUDA events: {[round(t['ms'] * 1e3, 2) for t in turns]} µs "
            f"against {[round(t['event_ms'] * 1e3, 2) for t in turns]}")
    return kept or turns


def time_k6(tag: str, sections, nt: int, first, iters: int = 50) -> dict:
    """K6 and the first K6 (a FirstK6) on each layout's sections in turns
    (first, K6, K6, first): device ms per call, its split by kernel,
    CUDA-event ms and host µs (k6_turn), the least of each over a build's
    two turns (device ms and split over its k6_trusted turns: the split
    of the faster), and the turns; bound and share, and the plain
    version's CUDA-event ms, per layout."""
    out = {}
    for layout, secs in sections.items():
        runs = {"k6": (functools.partial(k6_wrappers()[layout], *secs),
                       K6_KERNEL[layout]),
                "first": (functools.partial(first.wrappers[layout], *secs),
                          FIRST_K6_KERNEL[layout])}
        turns = {"k6": [], "first": []}
        for who in ("first", "k6", "k6", "first"):
            turns[who].append(k6_turn(*runs[who], iters))
        bound = k6_bound(layout, secs, nt)
        t = {"shape": [int(secs[0].shape[0]), nt],
             "exception_rows": int(secs[-1].sum())}
        for who, pre in (("k6", ""), ("first", "first_")):
            best = min(k6_trusted(turns[who]), key=lambda x: x["ms"])
            t[pre + "ms"] = best["ms"]
            t[pre + "kernel_us"] = best["kernel_us"]
            t[pre + "event_ms"] = min(x["event_ms"] for x in turns[who])
            t[pre + "host_us"] = min(x["host_us"] for x in turns[who])
        t["device_ops"] = turns["k6"][0]["device_ops"]
        t["turns_us"] = {who: [round(x["ms"] * 1e3, 2) for x in v]
                         for who, v in turns.items()}
        t.update(plain_ms=cuda_ms(functools.partial(k6_plain()[layout],
                                                    *secs), 3),
                 bound_ms=bound, bound_by="bytes", share=bound / t["ms"],
                 first_share=bound / t["first_ms"],
                 wire_bytes=sum(x.numel() * x.element_size() for x in secs))
        out[layout] = t
        log(f"K6 timing {tag} {layout}: " + json.dumps(t))
    return out


def phase_wire(T, dev, ssim_window, counters, tmp, first=None, n=512,
               w=500, h=500, big_wh=(4032, 3024), n_big=16, n_pixel=256):
    """Phase 17: K6 against its plain version and the first K6 (`first`,
    a FirstK6; None on the CPU) on every layout at the batch path's
    shapes and on k6_cases, its timings in turns with the first K6, the
    512-file batch through each route (int16 and COO in turns), and the
    pixel path's two wires.  Returns ({case: {layout: timings}}, the
    largest difference (0)).  The sizes are parameters so that the phase
    rehearses on the CPU (no timings there)."""
    started = time.perf_counter()
    timed = dev.type == "cuda"
    # K6 on k6_cases, at the 64 x 500x500 chunk, 16 x 12 MP, noise at
    # Q100 and ragged geometries; timed at the 64 x 500x500 chunk and 16 x
    # 12 MP.
    check_k6_cases(dev, first)
    paths, datas = write_files500(T, dev, os.path.join(tmp, "wire500"), n,
                                  w, h)
    times = {}
    secs, nt, *_ = check_k6(f"{w}x{h}x64", datas[:64], dev, first=first)
    if timed:
        times["500x500x64"] = time_k6("500x500x64", secs, nt, first)
    wire_search_agrees(T, datas[:64], secs, dev)
    del secs
    base = photo(*big_wh, SEED + 500)
    big = [T.encode_to_bytes(np.roll(base, (61 * i, 97 * i), axis=(0, 1)),
                             T.JPEG, 92, device=dev) for i in range(n_big)]
    del base
    secs, nt, *_ = check_k6(f"{big_wh[0]}x{big_wh[1]}x{n_big}", big, dev,
                            first=first)
    if timed:
        times["12mp_x16"] = time_k6("12mp_x16", secs, nt, first, iters=20)
    del secs, big
    rng = np.random.default_rng(SEED + 1700)
    noise = [T.encode_to_bytes(rng.integers(0, 256, (h, w, 4),
                                            dtype=np.uint8), T.JPEG, 100,
                               device=dev) for _ in range(8)]
    check_k6("noise_q100_x8", noise, dev, first=first)
    for rw, rh in ((17, 9), (513, 700)):
        ragged = [T.encode_to_bytes(photo(rw, rh, SEED + rw + s), T.JPEG, 95,
                                    device=dev) for s in range(3)]
        check_k6(f"{rw}x{rh}_x3", ragged, dev, first=first)
    if timed:
        torch.cuda.empty_cache()
    log(f"wire: K6 checked and timed in "
        f"{time.perf_counter() - started:.1f} s")

    # The 512-file batch: the int16 upload (the yardstick) and COO (the
    # default) in turns, three runs each, then dense int8 and CSR once;
    # each route's last run profiled.  The four byte-identical, every 32nd
    # item held to per-image compress_bytes.
    batch_started = time.perf_counter()
    order = ("int16", "coo", "coo", "int16", "int16", "coo", "dense", "csr")
    route_of = {route: (env, event) for route, env, event in WIRE_ROUTES}
    route_of["int16"] = ({}, "upload_int16")
    summary = {route: {"runs": []} for route in route_of}
    outs = {}
    for k, route in enumerate(order):
        env, event = route_of[route]
        last = k == max(i for i, r in enumerate(order) if r == route)
        items = [T.BatchItem(src=p, dst=os.path.join(
            tmp, f"w{route}{k}_{i}.jpg")) for i, p in enumerate(paths)]
        with env_set(env), int16_uploads(route == "int16"):
            res, wall_ms, launches, snap = run_batch(
                T, ssim_window, counters, items, dev, f"wire {route} run {k}",
                main=False)
            idle = (profile_device(lambda: T.compress_batch(
                None, items, T.BatchOptions(
                    fused=True, default_opts=T.Options(format=T.JPEG)),
                device=dev), f"wire {route}") if timed and last else None)
        chunks = len(snap["chunk_items"])
        if snap["events"] != {event: chunks}:
            raise AssertionError(f"wire {route}: events {snap['events']}, "
                                 f"want {event} for each of {chunks} chunks")
        log_batch(f"wire {route} run {k}", n, wall_ms, launches, snap, res, T)
        st = snap["stage_seconds"]
        summary[route]["runs"].append({
            "run": k, "img_per_s": n / (wall_ms / 1e3),
            "prep_s": st.get("prep", 0.0), "device_s": st.get("device", 0.0),
            "encode_summed_s": st.get("encode", 0.0)})
        blobs = []
        for r in res:
            with open(r.item.dst, "rb") as f:
                blobs.append(f.read())
        if outs.setdefault(route, blobs) != blobs:
            raise AssertionError(f"wire {route}: outputs differ between runs")
        if last:
            summary[route].update(
                uploaded_bytes_per_chunk=snap["uploaded_bytes"] / chunks,
                device_idle_share=idle, chunks=chunks, digest=digest(blobs))
    for route in ("coo", "dense", "csr"):
        if outs[route] != outs["int16"]:
            diff = sum(a != b for a, b in zip(outs[route], outs["int16"]))
            raise AssertionError(f"wire {route}: {diff} outputs differ from "
                                 f"the int16 route's")
    opts = T.Options(format=T.JPEG)
    identical = 0
    for i in range(0, n, 32):  # res: the CSR run's, equal to the others
        want = T.compress_bytes(None, datas[i], opts, device=dev)
        check_contract(T, res[i].result, want, dev, f"wire item {i}")
        identical += want.compressed_data == outs["coo"][i]
    summary["per_image_bytes_identical"] = \
        f"{identical} of {len(range(0, n, 32))}"
    # A resized chunk keeps the int16 blocks: no K6.
    items = [T.BatchItem(src=p, dst=os.path.join(tmp, f"wr{i}.jpg"))
             for i, p in enumerate(paths[:64])]
    counters.reset()
    k3_zero()
    bad = [r.err for r in T.compress_batch(None, items, T.BatchOptions(
        fused=True, default_opts=T.Options(format=T.JPEG,
                                           max_width=w // 2)),
        device=dev) if r.err is not None]
    snap = counters.snapshot()
    if bad or snap["events"] != {"upload_int16": len(snap["chunk_items"])} \
            or K6Launches().launches:
        raise AssertionError(f"wire resize: errors {bad[:3]}, events "
                             f"{snap['events']}, K6 launches "
                             f"{K6Launches().launches}")
    log(f"wire: the four routes byte-identical, items 0,32,..,480 agree "
        f"with per-image compress_bytes; the resized batch uploads int16 "
        f"blocks and launches no K6 ({time.perf_counter() - batch_started:.1f}"
        f" s)")
    pixel_started = time.perf_counter()

    # The pixel path's two wires over 256 images (32 distinct x 8).
    distinct = [photo(w, h, SEED + 300 + k) for k in range(32)]
    images = [distinct[i % 32] for i in range(n_pixel)]
    pixel = {}
    target = T.Options().quality.target_ssim()
    # Coded on the device (the card's default; the CPU rehearses it too).
    popts = T.Options(format=T.JPEG, device_entropy=True)
    for wire in ("rgb", "yuv420"):
        with env_set({"FENNEC_PIXEL_WIRE": wire}):
            for tag in ("cold", "warm"):
                counters.reset()
                ssim_window.launches = 0
                k3_zero()
                t = time.perf_counter()
                got = T.compress_images(None, images, popts, device=dev)
                wall_ms = (time.perf_counter() - t) * 1e3
                snap = counters.snapshot()
                k3_take(f"wire images256 {wire} {tag}", dev,
                        len(snap["chunk_items"]),
                        probes=7 * len(snap["chunk_items"]), main=False)
                if snap["events"] != {f"upload_{wire}":
                                      len(snap["chunk_items"])}:
                    raise AssertionError(f"wire {wire}: events "
                                         f"{snap['events']}")
        pixel[wire] = got
        summary[f"images256_{wire}"] = {
            "img_per_s": n_pixel / (wall_ms / 1e3),
            "uploaded_bytes": snap["uploaded_bytes"],
            "prep_s": snap["stage_seconds"].get("prep", 0.0)}
    changed = sum(a.jpeg_quality != b.jpeg_quality
                  for a, b in zip(pixel["rgb"], pixel["yuv420"]))
    deltas = np.array([b.jpeg_quality - a.jpeg_quality
                       for a, b in zip(pixel["rgb"], pixel["yuv420"])])
    moves = {int(d): int((deltas == d).sum()) for d in np.unique(deltas)}
    dssim = max(abs(a.ssim - b.ssim)
                for a, b in zip(pixel["rgb"], pixel["yuv420"]))
    missed = [i for i, r in enumerate(pixel["yuv420"])
              if r.ssim < target and (r.jpeg_quality, r.ssim) != (100, 1.0)]
    if missed:
        raise AssertionError(f"wire yuv420: items {missed[:5]} miss their "
                             f"target {target}")
    summary["images256_yuv420"].update(changed_qualities=changed,
                                       quality_moves=moves,
                                       max_abs_dssim=dssim)
    log(f"wire images256: yuv420 against rgb: {changed} of {n_pixel} "
        f"qualities changed (yuv420 - rgb: count {moves}), max |dSSIM| "
        f"{dssim:.3e}; every yuv420 output meets its target or is the Q100 "
        f"fallback")
    log(f"wire: the pixel wires took {time.perf_counter() - pixel_started:.1f}"
        f" s")
    log("wire summary: " + json.dumps(summary))
    log(f"wire: phase 17 took {time.perf_counter() - started:.1f} s")
    return times, 0


def wire_only(T, dev, ssim_window, first_k6) -> int:
    """`--wire`: phases 1, 2 and 17 alone; no main path, so no result
    line."""
    from fennec_tpu_torch.engine.batched import counters

    with tempfile.TemporaryDirectory() as tmp:
        phase_wire(T, dev, ssim_window, counters, tmp, first_k6)
    log(f"wire only: every case passed; K6 launches {K6_WIRE}")
    return 0


# ── Kernels K7 and K8 (phase 18) ──────────────────────────────────────────

# K7's and K8's launches on the main path (phases 4, 6-8 and 10), each call
# counted from 0 just before it and read just after (k3_zero, k3_take).
K78_MAIN = {"decode_recon": 0, "forward_dct": 0, "luminance": 0}
K78_TIE = 1e-3  # a value that rounds apart must sit within this of k + 1/2
K78_REPLACES = {
    "decode_recon": "fennec_tpu/codecs/jpeg.py:702",
    "forward_dct": "fennec_tpu/codecs/jpeg.py:52",
    "luminance": "fennec_tpu/engine/compress.py:166"}


def k78_wrappers():
    """{name: wrapper} of K7's and K8's entries."""
    from fennec_tpu_torch.ops import decode_recon_cuda as k7
    from fennec_tpu_torch.ops import forward_dct_cuda as k8

    return {"decode_recon": k7.decode_recon, "forward_dct": k8.forward_dct,
            "luminance": k8.original_luminance}


FIRST_K7_SOURCE = os.path.join("bench_sources", "decode_recon_first.cu")
FIRST_K8_SOURCE = os.path.join("bench_sources", "forward_dct_first.cu")
FIRST_K8_TILE_BLOCKS = 128  # blocks of the first K8's DCT tile


class FirstK7:
    """The first K7 (FIRST_K7_SOURCE) built here with nvcc and called
    through the port's wrapper class given its library (`k7`, a
    DecodeReconKernel whose launches count apart from K7's).  The port
    does not import it."""

    def __init__(self) -> None:
        from fennec_tpu_torch.ops import decode_recon_cuda as k7

        self.k7 = k7.DecodeReconKernel(
            os.path.join(HERE, FIRST_K7_SOURCE),
            os.path.join(k7.BUILD_DIR, "libdecode_recon_first.so"))
        self.k7.build(force=True)
        self.k7.load()
        self.build_log = self.k7.build_log


class FirstK8:
    """The first K8 (FIRST_K8_SOURCE) built here with nvcc and its DCT
    called through the port's entry class given its library (`fdct`,
    counted apart from K8's), at its own tile (FIRST_K8_TILE_BLOCKS).  The
    port does not import it."""

    def __init__(self) -> None:
        from fennec_tpu_torch.ops import forward_dct_cuda as k8

        self.library = k8.K8Library(
            os.path.join(HERE, FIRST_K8_SOURCE),
            os.path.join(k8.BUILD_DIR, "libforward_dct_first.so"))
        self.library.tile_blocks = FIRST_K8_TILE_BLOCKS
        self.library.build(force=True)
        self.library.load()
        self.build_log = self.library.build_log
        self.fdct = k8.ForwardDct(self.library)


def at_tie(x: torch.Tensor) -> torch.Tensor:
    """Values within K78_TIE of k + 1/2."""
    x = x.to(torch.float64)
    return (x - torch.floor(x) - 0.5).abs() <= K78_TIE


def k7_frame(data: bytes, dev):
    """A JPEG file's frame as K7's frame entry takes it, decoded to
    coefficients on the host as codecs/jpeg.decode_jpeg decodes it:
    (blocks, tables, comps, hmax, vmax, h, w, mode) on `dev`."""
    from fennec_tpu_torch.codecs import jpeg as J
    from fennec_tpu_torch.codecs.progressive import (
        decode_progressive_to_coefs,
    )

    if J.is_progressive_jpeg(data):
        frame, coefs = decode_progressive_to_coefs(data)
        comps, qtables = frame.comps, frame.qtables
        hmax, vmax = frame.hmax, frame.vmax
    else:
        frame, coefs = J.decode_jpeg_to_coefs(data)
        hmax = max(c["h"] for c in frame.comps)
        vmax = max(c["v"] for c in frame.comps)
        mx, my = -(-frame.width // (8 * hmax)), -(-frame.height // (8 * vmax))
        comps = [dict(frame.comps[sc["comp"]], bw=mx * frame.comps[
            sc["comp"]]["h"], bh=my * frame.comps[sc["comp"]]["v"])
            for sc in frame.scan_comps]
        qtables = frame.qtables
    return ([torch.from_numpy(np.asarray(q, np.int16)).to(dev)
             for q in coefs],
            torch.from_numpy(np.stack([qtables[c["tq"]] for c in comps])
                             ).to(dev),
            [(c["h"], c["v"], c["bw"], c["bh"]) for c in comps], hmax, vmax,
            frame.height, frame.width, J.jpeg_color_mode(frame))


def k7_synthetic(sampling, mode: str, w: int, h: int, seed: int, dev):
    """Random quantized blocks of a frame (sparse AC; a fifth of the
    blocks an odd DC alone at a table entry of 4, every pixel of those at
    k + 1/2) in K7's frame form, for the modes no encoder here writes."""
    rng = np.random.default_rng(seed)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    blocks, tables, comps = [], [], []
    for ch, cv in sampling:
        n = mx * ch * my * cv
        b = np.zeros((n, 64), np.int16)
        b[:, 0] = rng.integers(-90, 90, n)
        b[:, 1:] = np.where(rng.random((n, 63)) < 0.12,
                            rng.integers(-12, 13, (n, 63)), 0)
        flat = rng.random(n) < 0.2
        b[flat, 1:] = 0
        b[flat, 0] = 2 * rng.integers(-15, 15, int(flat.sum())) + 1
        t = rng.integers(1, 40, 64).astype(np.int32)
        t[0] = 4
        blocks.append(torch.from_numpy(b).to(dev))
        tables.append(t)
        comps.append((ch, cv, mx * ch, my * cv))
    return (blocks, torch.from_numpy(np.stack(tables)).to(dev), comps, hmax,
            vmax, h, w, mode)


def k7_round_inputs(blocks, tables, comps, hmax, vmax, h, w, mode):
    """(..., h, w, n) the values the plain decode rounds for each output
    channel (blocks may carry a batch dimension)."""
    from fennec_tpu_torch.ops import dct as D
    from fennec_tpu_torch.ops.color import ycbcr_to_rgb

    planes = []
    for b, t, (ch, cv, bw, bh) in zip(blocks, tables, comps):
        p = D.from_blocks(D.idct2d_blocks(D.dequantize_blocks(
            b.to(torch.float32), t)), bh * 8, bw * 8) + 128.0
        p = p.repeat_interleave(vmax // cv, dim=-2)
        planes.append(p.repeat_interleave(hmax // ch, dim=-1)[..., :h, :w])
    if mode in ("ycbcr", "ycck"):
        rgb = ycbcr_to_rgb(torch.stack(planes[:3], dim=-1))
        planes = [rgb[..., 0], rgb[..., 1], rgb[..., 2]] + planes[3:]
    return torch.stack(planes, dim=-1)


def k7_compare(tag: str, got, want, inputs) -> int:
    """The pixels (rows of RGBA) where got and want differ: each must sit
    at a tie of one of the values the plain decode rounds (`inputs`).
    Returns their count."""
    diff = (got.to(torch.int32) != want.to(torch.int32)).any(dim=-1)
    n = int(diff.sum())
    if n:
        bad = int((diff & ~at_tie(inputs).any(dim=-1)).sum())
        if bad:
            raise AssertionError(f"K7 {tag}: {bad} of {n} differing pixels "
                                 f"away from a tie")
    return n


def k8_levels(tag: str, got, want, qualities, dev) -> int:
    """K8's coefficients against the plain version's, quantized at each
    quality: every level that differs must sit at a tie of the plain
    coefficient's quotient.  Returns the count."""
    from fennec_tpu_torch.engine.size_search import quality_tables_on
    from fennec_tpu_torch.ops.dct import quantize_blocks

    tables = quality_tables_on(dev)
    n = 0
    for q in qualities:
        for part, (g, w) in enumerate(zip(got, want)):
            t = tables[q][min(part, 1)]
            d = quantize_blocks(g, t) != quantize_blocks(w, t)
            k = int(d.sum())
            if k:
                bad = int((d & ~at_tie((w / t).abs())).sum())
                if bad:
                    raise AssertionError(f"K8 {tag} Q{q}: {bad} of {k} "
                                         f"levels differ away from a tie")
            n += k
    return n


def box_sums(imgs: torch.Tensor, rect: torch.Tensor, ndh: int, dw: int):
    """(sums (B, 3, ndh, dw), n (ndh, dw)) int64 of r, g and b over the
    rectangles of `rect` (ops/resize.box_rectangles' layout)."""
    r = rect.to(torch.int64)
    y0, y1 = r[:ndh], r[ndh:2 * ndh]
    x0, x1 = r[2 * ndh:2 * ndh + dw], r[2 * ndh + dw:2 * ndh + 2 * dw]
    p = imgs[..., :3].permute(0, 3, 1, 2).to(torch.int64)
    table = torch.zeros((*p.shape[:2], p.shape[2] + 1, p.shape[3] + 1),
                        dtype=torch.int64, device=p.device)
    table[..., 1:, 1:] = p.cumsum(-2).cumsum(-1)
    hi, lo = table.index_select(-2, y1), table.index_select(-2, y0)
    sums = (hi.index_select(-1, x1) - hi.index_select(-1, x0)
            - lo.index_select(-1, x1) + lo.index_select(-1, x0))
    return sums, (y1 - y0)[:, None] * (x1 - x0)[None, :]


def k8_lum_compare(tag: str, got, want, imgs, rect, ndh: int, dw: int):
    """K8's luminance against the plain version's: bit-equal to the
    exact means' luminance, and differing from the plain version only
    where a channel's exact mean is k + 1/2.  Returns (differing values,
    largest |difference|)."""
    from fennec_tpu_torch.engine.compress import _luminance

    if rect is None:
        if not torch.equal(got, want):
            raise AssertionError(f"K8 {tag}: the luminance without a "
                                 f"downsample differs from the plain one")
        return 0, 0.0
    sums, n = box_sums(imgs, rect, ndh, dw)
    mean = torch.where(n > 0, torch.div(2 * sums + n, 2 * n.clamp(min=1),
                                        rounding_mode="floor"), 0)
    mean = mean.to(torch.float32)
    exact = _luminance(mean[:, 0], mean[:, 1], mean[:, 2])
    if not torch.equal(got, exact):
        raise AssertionError(f"K8 {tag}: the luminance differs from the "
                             f"exact box means' in "
                             f"{int((got != exact).sum())} values")
    tie = ((n > 0) & ((2 * sums) % (2 * n).clamp(min=1) == n)).any(dim=1)
    diff = got != want
    bad = int((diff & ~tie).sum())
    if bad:
        raise AssertionError(f"K8 {tag}: {bad} luminance values differ "
                             f"away from a box-mean tie")
    return int(diff.sum()), float((got - want).abs().max())


def k78_bound(nbytes: float, fmas: float):
    """(bound ms, "bytes" or "operations"): the bytes over the card's
    memory rate, the multiply-adds (two operations each) over its float32
    rate, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * fmas / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_k78(kernel, plain, kname: str, nbytes: float, fmas: float,
             shape, matmul_rows: int = 0, iters: int = 20,
             first=None) -> dict:
    """One entry's timings at one shape: device ms (torch.profiler, rows
    of `kname`), CUDA-event ms and host µs per call, the plain version's
    CUDA-event ms, the bound and its share, and the time of the block
    product alone, torch.matmul of (matmul_rows, 64) x (64, 64): a part of
    the function, not a library call that computes it (none when
    matmul_rows is 0).  With `first` (the same call on a first build),
    the two are timed in turns (first, new, new, first): the least of each
    reading over a build's two turns (first_* for the first build), every
    turn's device µs, and the bound's share of each."""
    turns = {"new": [], "first": []}
    for who in ("first", "new", "new", "first") if first else ("new",):
        fn = kernel if who == "new" else first
        turns[who].append({"ms": profiled_device_ms(fn, iters, kname),
                           "event_ms": cuda_ms(fn, iters),
                           "host_us": host_us(fn, iters)})
    bound_ms, bound_by = k78_bound(nbytes, fmas)
    got = {"shape": list(shape)}
    for who, pre in (("new", ""), ("first", "first_")):
        for key in ("ms", "event_ms", "host_us") if turns[who] else ():
            got[pre + key] = min(t[key] for t in turns[who])
    got.update(plain_ms=cuda_ms(plain, max(3, iters // 4)),
               bound_ms=bound_ms, bound_by=bound_by,
               share=bound_ms / got["ms"])
    if first:
        got["first_share"] = bound_ms / got["first_ms"]
        got["turns_us"] = {who: [round(t["ms"] * 1e3, 2) for t in v]
                           for who, v in turns.items()}
    if matmul_rows:
        rows = torch.zeros((matmul_rows, 64), dtype=torch.float32,
                           device="cuda")
        m = torch.zeros((64, 64), dtype=torch.float32, device="cuda")
        got["matmul_part_ms"] = cuda_ms(lambda: torch.matmul(rows, m), iters)
    return got


def phase_k7k8(T, dev, timed: bool = True, first=None):
    """Phase 18: K7 and K8 against their plain versions on the same CUDA
    tensors.  K7 on the frames of a 12 MP 4:2:0 and a 1080p 4:4:4 JPEG,
    the progressive and multi-scan fixtures, and synthetic gray, Adobe
    RGB, CMYK, YCCK and 4:2:2 frames (a fifth of their blocks a DC tie),
    DC 1 at q = 4 decoding to 129, and the batch entry on a 64 x 500²
    chunk rebuilt by K6 from the COO wire; K8's DCT at 12 MP (levels at
    Q30, Q60, Q92), 64 x 500², one 12 MP band of four and ragged
    shapes, alone against inside the batch bit for bit; its luminance
    there and without a downsample.  Every differing pixel, level or
    luminance value must sit at a tie; each is counted.  With `first`
    (FirstK7, FirstK8), K7 on every frame and the batch and K8's DCT on
    every case (alone and inside the batch) must equal the first builds'
    bit for bit.  Timed (device, CUDA-event and host time, plain, bound,
    share, the block product alone) at K7's 12 MP, 1080p 4:4:4 and 64 x
    500² and K8's 12 MP, 64 x 500² and band, K7 and K8's DCT in turns
    with the first builds when given.  Returns ({entry: {case:
    timings}}, {counts})."""
    from fennec_tpu_torch.codecs import jpeg as J
    from fennec_tpu_torch.engine import compress as C
    from fennec_tpu_torch.ops import resize as R
    from fennec_tpu_torch.ops.decode_recon_cuda import orient_plain
    from fennec_tpu_torch.ops.ssim import ssim_fast_dims

    w78 = k78_wrappers()
    k7, fdct, lum = w78["decode_recon"], w78["forward_dct"], w78["luminance"]
    first_k7, first_fdct = (first[0].k7, first[1].fdct) if first else (None,
                                                                        None)
    times = {"decode_recon": {}, "forward_dct": {}, "luminance": {}}
    counts = {}
    before = {k: w.launches for k, w in w78.items()}
    plain_before = {k: w.plain_calls for k, w in w78.items()}

    # K7, one frame at a time.
    big = T.encode_to_bytes(photo(4032, 3024, SEED), T.JPEG, 92, device=dev)
    mid444 = J.encode_jpeg(photo(1920, 1080, SEED + 3), 92, False, device=dev)
    fixtures = os.path.join(HERE, "tests", "torch_fixtures")
    frames = [("12mp_420", k7_frame(big, dev)),
              ("1080p_444", k7_frame(mid444, dev))]
    for name in ("progressive_1280x720.jpg", "multiscan_1280x720.jpg"):
        with open(os.path.join(fixtures, name), "rb") as f:
            frames.append((name.split("_")[0], k7_frame(f.read(), dev)))
    for i, (tag, samp, mode) in enumerate((
            ("gray", [(1, 1)], "gray"),
            ("adobe_rgb", [(1, 1)] * 3, "rgb"),
            ("cmyk", [(1, 1)] * 4, "cmyk"),
            ("ycck_420", [(2, 2), (1, 1), (1, 1), (2, 2)], "ycck"),
            ("ycbcr_422", [(2, 1), (1, 1), (1, 1)], "ycbcr"),
            ("ycbcr_422_ragged", [(2, 1), (1, 1), (1, 1)], "ycbcr"))):
        w, h = (1001, 753) if i < 5 else (17, 9)
        frames.append((tag, k7_synthetic(samp, mode, w, h, SEED + 50 + i,
                                          dev)))
    dc = torch.zeros((1, 64), dtype=torch.int16, device=dev)
    dc[0, 0] = 1
    frames.append(("dc_tie", ([dc], torch.full((1, 64), 4, dtype=torch.int32,
                                                device=dev),
                              [(1, 1, 1, 1)], 1, 1, 8, 8, "gray")))
    worst = 0
    for tag, args in frames:
        got = k7.frame(*args)
        again = k7.frame(*args)
        want = J.reconstruct_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K7 {tag}: two calls differ")
        if first_k7 is not None and not torch.equal(got,
                                                    first_k7.frame(*args)):
            raise AssertionError(f"K7 {tag}: differs from the first K7")
        n = k7_compare(tag, got, want, k7_round_inputs(*args))
        counts[f"k7_{tag}"] = n
        worst = max(worst, int((got.to(torch.int32)
                                - want.to(torch.int32)).abs().max()))
        log(f"K7 {tag} {args[6]}x{args[5]} {args[7]}: pixels differing from "
            f"the plain version (each at a rounding tie) {n}")
    if not bool((k7.frame(*frames[-1][1])[..., :3] == 129).all()):
        raise AssertionError("K7: DC 1 at q = 4 must decode to 129")
    # K7 at every other EXIF orientation: the upright image turned.
    oriented = k7.oriented
    for tag, args in frames:
        upright = k7.frame(*args)
        for o in range(2, 9):
            if not torch.equal(k7.frame(*args, o), orient_plain(upright, o)):
                raise AssertionError(f"K7 {tag} at orientation {o}: not "
                                     f"orientation 1's image turned")
    counts["k7_oriented_launches"] = k7.oriented - oriented
    log(f"K7 at orientations 2-8 on {len(frames)} frames: each bit for bit "
        f"orient_plain of its image at 1 ({counts['k7_oriented_launches']} "
        f"oriented launches)")

    # K7's batch entry on a 64 x 500² chunk that K6 rebuilt.
    datas = [T.encode_to_bytes(photo(500, 500, SEED + 900 + k), T.JPEG, 92,
                               device=dev) for k in range(64)]
    sections, nt, _r, _k = wire_sections(datas, dev)
    blocks = k6_wrappers()["coo"](*sections["coo"])
    hdr = J.parse_jpeg(datas[0])
    qt = torch.from_numpy(np.stack([hdr.qtables[0], hdr.qtables[1]])).to(
        dev)[None].expand(64, 2, 64).contiguous()
    got = k7.batch(blocks, qt, 500, 500, True)
    want = C.decode_jpeg_image_plain(blocks, qt, 500, 500, True)
    if first_k7 is not None and not torch.equal(
            got, first_k7.batch(blocks, qt, 500, 500, True)):
        raise AssertionError("K7 64x500 batch: differs from the first K7")
    ny = 32 * 32 * 4
    parts = [blocks[:, :ny], blocks[:, ny:ny + 1024], blocks[:, ny + 1024:]]
    comps = [(2, 2, 64, 64), (1, 1, 32, 32), (1, 1, 32, 32)]
    inputs = k7_round_inputs(parts, [qt[:, 0, None], qt[:, 1, None],
                                     qt[:, 1, None]], comps, 2, 2, 500, 500,
                             "ycbcr")
    counts["k7_batch_64x500"] = k7_compare("64x500 batch", got, want, inputs)
    for i in (0, 63):
        alone = k7.batch(blocks[i:i + 1], qt[i:i + 1], 500, 500, True)
        if not torch.equal(alone[0], got[i]):
            raise AssertionError(f"K7: image {i} alone differs from the "
                                 f"batch")
    log(f"K7 64 x 500x500 batch (float32): pixels differing "
        f"{counts['k7_batch_64x500']}, largest level difference "
        f"{int((got - want).abs().max())}")

    # K8: the DCT and the luminance.
    big_img = torch.from_numpy(T.codecs.decode_image(big, device=dev)).to(
        dev).to(torch.float32)[None]
    small = torch.stack([torch.from_numpy(T.codecs.decode_image(
        d, device=dev)) for d in datas]).to(dev).to(torch.float32)
    alpha = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, 256, (2, 37, 93, 4)).astype(np.float32)).to(dev)
    band = R.box_band(3024, ssim_fast_dims(4032, 3024)[1], 1512, 2268, 16)
    pix = big_img[:, band.start:band.end]
    k8_cases = [("12mp_420", big_img, True), ("12mp_444", big_img, False),
                ("64x500_420", small, True),
                ("band_12mp_420", pix[:, :band.stop - band.start], True),
                ("alpha_37x93_420", alpha, True),
                ("alpha_37x93_444", alpha, False)]
    worst_coef = 0.0
    for tag, x, sub in k8_cases:
        got = fdct(x, sub)
        want = J.forward_dct_plain(x, sub)
        again = fdct(x, sub)
        torch.cuda.synchronize()
        if any(not torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K8 {tag}: two calls differ")
        if first_fdct is not None and any(
                not torch.equal(a, b) for a, b in zip(got,
                                                      first_fdct(x, sub))):
            raise AssertionError(f"K8 {tag}: differs from the first K8")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        worst_coef = max(worst_coef, err)
        n = k8_levels(tag, got, want, (30, 60, 92), dev)
        counts[f"k8_{tag}"] = n
        if x.shape[0] > 1:
            for i in (0, x.shape[0] - 1):
                alone = fdct(x[i:i + 1].contiguous(), sub)
                if any(not torch.equal(a[0], b[i])
                       for a, b in zip(alone, got)):
                    raise AssertionError(f"K8 {tag}: image {i} alone "
                                         f"differs from the batch")
                if first_fdct is not None and any(
                        not torch.equal(a, b) for a, b in zip(
                            alone, first_fdct(x[i:i + 1].contiguous(),
                                              sub))):
                    raise AssertionError(f"K8 {tag}: image {i} alone "
                                         f"differs from the first K8")
        log(f"K8 DCT {tag} {tuple(x.shape)}: largest |coefficient "
            f"difference| {err:.3e}, levels differing at Q30/60/92 (each at "
            f"a tie) {n}")
    for tag, x, rows, bandinfo in (
            ("12mp", big_img, 3024, None), ("64x500", small, 500, None),
            ("band_12mp", pix, band.stop - band.start, band),
            ("ragged_700x20", torch.round(alpha[:1, :20].repeat(
                1, 1, 8, 1)[:, :, :700]), 20, None)):
        h, w = x.shape[1], x.shape[2]
        if bandinfo is None:
            ds_w, ds_h = ssim_fast_dims(w, h)
            wh = wv = rect = None
            if (ds_w, ds_h) != (w, h):
                wh, wv, rect = C._ssim_box(w, h, dev)
        else:
            ds_w = ssim_fast_dims(w, band.src_h)[0]
            wh, wv, rect = R.band_box_device(w, ds_w, band, dev)
        got = lum(x, wh, wv, rect, rows)
        want = C.lum_orig_plain(x, wh, wv, rows)
        ndh, dw = got.shape[1], got.shape[2]
        n, err = k8_lum_compare(tag, got, want, x, rect, ndh, dw)
        counts[f"k8_lum_{tag}"] = n
        log(f"K8 luminance {tag} {tuple(x.shape)} -> {tuple(got.shape)}: "
            f"values differing from the plain version (each at a box-mean "
            f"tie) {n}, largest |difference| {err}")
    for k, w in w78.items():
        if w.plain_calls != plain_before[k]:
            raise AssertionError(f"{k}: a CUDA tensor took the plain version")
    ran = {k: w.launches - before[k] for k, w in w78.items()}
    log(f"K7/K8 phase: launches {ran}, largest K7 level difference "
        f"{worst}, K8 coefficient {worst_coef:.3e}")
    if first:
        log(f"K7 on {len(frames)} frames and the 64 x 500² batch, K8's DCT "
            f"on {len(k8_cases)} cases (alone and inside the batch): bit "
            f"for bit the first builds' ({FIRST_K7_SOURCE}, "
            f"{FIRST_K8_SOURCE}; {first_k7.launches} and "
            f"{first_fdct.launches} launches of theirs)")
    counts["k7_max_level_diff"] = worst
    counts["k8_max_coef_diff"] = worst_coef
    if not timed:
        return times, counts

    # Timings.  K7: the blocks read once (2 bytes a coefficient), the
    # tables, the output written once; multiply-adds 64 for every nonzero
    # coefficient (the zero ones change nothing and the kernel skips
    # them).  K8: the image read once (16 bytes a pixel) and the blocks
    # written (256 bytes each), 4096 multiply-adds a block; the luminance
    # the image read once and the output written.
    def k7_cost(blocks_list, out_bytes):
        nnz = sum(int((b != 0).sum()) for b in blocks_list)
        nbytes = sum(b.numel() * 2 for b in blocks_list) + out_bytes
        return nbytes, 64.0 * nnz

    for tag, args in frames[:2]:
        nb = sum(b.shape[0] for b in args[0])
        nbytes, fmas = k7_cost(args[0], args[5] * args[6] * 4)
        times["decode_recon"][tag] = time_k78(
            lambda a=args: k7.frame(*a),
            lambda a=args: J.reconstruct_plain(*a), "decode_recon_kernel",
            nbytes, fmas, (1, nb, 64), nb,
            first=first and (lambda a=args: first_k7.frame(*a)))
        times["decode_recon"][tag]["dense_ops_bound_ms"] = k78_bound(
            0, 4096.0 * nb)[0]
    nbytes, fmas = k7_cost([blocks], 64 * 500 * 500 * 16)
    times["decode_recon"]["64x500_f32"] = time_k78(
        lambda: k7.batch(blocks, qt, 500, 500, True),
        lambda: C.decode_jpeg_image_plain(blocks, qt, 500, 500, True),
        "decode_recon_kernel", nbytes, fmas, tuple(blocks.shape),
        blocks.shape[0] * blocks.shape[1],
        first=first and (lambda: first_k7.batch(blocks, qt, 500, 500,
                                                True)))
    times["decode_recon"]["64x500_f32"]["dense_ops_bound_ms"] = k78_bound(
        0, 4096.0 * blocks.shape[0] * blocks.shape[1])[0]
    for tag, x, sub in (k8_cases[0], k8_cases[2], k8_cases[3]):
        nblk = x.shape[0] * sum(c.shape[1] for c in fdct(x, sub))
        times["forward_dct"][tag] = time_k78(
            lambda x=x, s=sub: fdct(x, s),
            lambda x=x, s=sub: J.forward_dct_plain(x, s), "fdct_kernel",
            x.numel() * 4 + nblk * 256, 4096.0 * nblk,
            (x.shape[0], nblk // x.shape[0], 64), nblk,
            first=first and (lambda x=x, s=sub: first_fdct(x, s)))
    for tag, x, rows, bandinfo in (
            ("12mp", big_img, 3024, None), ("64x500", small, 500, None),
            ("band_12mp", pix, band.stop - band.start, band)):
        h, w = x.shape[1], x.shape[2]
        if bandinfo is None:
            wh, wv, rect = C._ssim_box(w, h, dev)
        else:
            wh, wv, rect = R.band_box_device(
                w, ssim_fast_dims(w, band.src_h)[0], band, dev)
        out = lum(x, wh, wv, rect, rows)
        kname = "lum_box_kernel" if rect is not None else "lum_pixels_kernel"
        times["luminance"][tag] = time_k78(
            lambda x=x, a=(wh, wv, rect, rows): lum(x, *a),
            lambda x=x, a=(wh, wv, rows): C.lum_orig_plain(x, *a), kname,
            x.numel() * 4 + out.numel() * 4, 0.0, tuple(out.shape))
    for entry, rows in times.items():
        for tag, t in rows.items():
            log(f"K7/K8 {entry} {tag} {t['shape']}: device "
                f"{t['ms'] * 1e3:.2f} µs, CUDA events "
                f"{t['event_ms'] * 1e3:.2f} µs, host {t['host_us']:.2f} µs, "
                f"plain {t['plain_ms']:.3f} ms, bound "
                f"{t['bound_ms'] * 1e3:.2f} µs ({t['bound_by']}), share "
                f"{100 * t['share']:.1f} %"
                + (f", block product alone {t['matmul_part_ms'] * 1e3:.2f} "
                   f"µs" if "matmul_part_ms" in t else "")
                + (f"; first build in turns: device {t['first_ms'] * 1e3:.2f}"
                   f" µs, CUDA events {t['first_event_ms'] * 1e3:.2f} µs, "
                   f"host {t['first_host_us']:.2f} µs, share "
                   f"{100 * t['first_share']:.1f} %, turns (µs) "
                   f"{t['turns_us']}" if "first_ms" in t else ""))
    times["k7_orientation"] = {}
    for tag, args in frames[:2]:
        t = times["k7_orientation"][tag] = time_k7_orientations(k7, args)
        log(f"K7 {tag} by orientation, in turns (1, 6, 3, 3, 6, 1): "
            + "; ".join(f"{o}: device {v['ms'] * 1e3:.2f} µs "
                        f"({v['over_identity']:.3f} x orientation 1's), "
                        f"CUDA events {v['event_ms'] * 1e3:.2f} µs, turns "
                        f"(µs) {v['turns_us']}" for o, v in t.items()))
    return times, counts


def time_k7_orientations(k7, args, iters: int = 20) -> dict:
    """K7 on one frame at EXIF orientations 1 (identity), 6 (transposing)
    and 3 (flips) in turns (1, 6, 3, 3, 6, 1): each one's least device ms
    (torch.profiler rows of K7's kernels, all named decode_recon...) and
    CUDA-event ms, every turn's device µs, and its device time over
    orientation 1's."""
    turns = {1: [], 6: [], 3: []}
    for o in (1, 6, 3, 3, 6, 1):
        fn = functools.partial(k7.frame, *args, o)
        turns[o].append((profiled_device_ms(fn, iters, "decode_recon"),
                         cuda_ms(fn, iters)))
    out = {o: {"ms": min(t[0] for t in v), "event_ms": min(t[1] for t in v),
               "turns_us": [round(t[0] * 1e3, 2) for t in v]}
           for o, v in turns.items()}
    for v in out.values():
        v["over_identity"] = v["ms"] / out[1]["ms"]
    return out


def k7k8_only(T, dev, first) -> int:
    """`--k7k8`: phases 1, 2 and 18 alone (K7 and K8's DCT held to the
    first builds and timed in turns with them); no main path, so no
    result line."""
    times, counts = phase_k7k8(T, dev, first=first)
    log("K7/K8 summary: " + json.dumps({"times": times, "counts": counts}))
    log("k7k8 only: every case passed")
    return 0


def build_all(ssim_window, k3, probe_recon):
    """Phase 2: every kernel of the port and the host entropy coder
    built from this checkout's sources, all at once; returns the first
    K3's, the first K2's and the first K5's harnesses, the stamped K5
    builds ({"first": ..., "k5": ...}), the first K6's harness and the
    first K7's and K8's (FirstK7, FirstK8)."""
    from concurrent.futures import ThreadPoolExecutor

    from fennec_tpu_torch import native
    from fennec_tpu_torch.ops import coef_wire_cuda as k6
    from fennec_tpu_torch.ops import forward_dct_cuda as k8
    from fennec_tpu_torch.ops import huffbuild_cuda as k5
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon as k7

    def timed(build):
        t = time.perf_counter()
        got = build()
        return time.perf_counter() - t, got

    with ThreadPoolExecutor(16) as pool:
        done = list(pool.map(timed, (
            lambda: ssim_window.build(force=True),
            lambda: k3.library.build(force=True),
            lambda: native.build(force=True), FirstK3,
            lambda: probe_recon.build(force=True), FirstK2,
            lambda: k5.library.build(force=True),
            lambda: K5Build(FIRST_K5_SOURCE, "first"),
            lambda: K5Build(FIRST_K5_SOURCE, "first_stamped", True),
            lambda: K5Build(os.path.relpath(k5.SOURCE, HERE), "stamped",
                            True),
            lambda: k6.library.build(force=True), FirstK6,
            lambda: k7.build(force=True),
            lambda: k8.library.build(force=True), FirstK7, FirstK8)))
    ssim_window.load()
    k3.library.load()
    native.load()
    probe_recon.load()
    k5.library.load()
    k6.library.load()
    k7.load()
    k8.library.load()
    log(f"build k1_nvcc_s={done[0][0]:.3f} k3_nvcc_s={done[1][0]:.3f} "
        f"native_gxx_s={done[2][0]:.3f} first_k3_nvcc_s={done[3][0]:.3f} "
        f"k2_nvcc_s={done[4][0]:.3f} first_k2_nvcc_s={done[5][0]:.3f} "
        f"k5_nvcc_s={done[6][0]:.3f} first_k5_nvcc_s={done[7][0]:.3f} "
        f"stamped_k5_nvcc_s={done[8][0]:.3f}, {done[9][0]:.3f} "
        f"k6_nvcc_s={done[10][0]:.3f} first_k6_nvcc_s={done[11][0]:.3f} "
        f"k7_nvcc_s={done[12][0]:.3f} k8_nvcc_s={done[13][0]:.3f} "
        f"first_k7_nvcc_s={done[14][0]:.3f} "
        f"first_k8_nvcc_s={done[15][0]:.3f} (in parallel)")
    log(ssim_window.build_log.strip())
    log(k3.library.build_log.strip())
    log(probe_recon.build_log.strip())
    for tag, text in (("K5", k5.library.build_log),
                      ("first K5", done[7][1].build_log),
                      ("first K5 -DK5_STAMPS", done[8][1].build_log),
                      ("K5 -DK5_STAMPS", done[9][1].build_log),
                      ("K6", k6.library.build_log),
                      ("first K6", done[11][1].build_log),
                      ("K7", k7.build_log), ("K8", k8.library.build_log),
                      ("first K7", done[14][1].build_log),
                      ("first K8", done[15][1].build_log)):
        log(f"{tag} nvcc -Xptxas -v: {text.strip()}")
    lib = k3.library.load()
    log(f"K3 segment_blocks={k3.library.segment_blocks} resident CTAs "
        f"K3a={lib.fennec_jpeg_resident_ctas(0)} "
        f"K3b={lib.fennec_jpeg_resident_ctas(1)}")
    dev = torch.device("cuda", torch.cuda.current_device())
    log(f"K2 resident CTAs, SMs: 4:2:0 {probe_recon.card(dev, True)} "
        f"4:4:4 {probe_recon.card(dev, False)}")
    log(f"K7 resident CTAs {k7.ctas(dev)}, K8's DCT {k8.library.ctas(dev)}; "
        f"the first K7's {done[14][1].k7.ctas(dev)}, the first K8's DCT "
        f"{done[15][1].library.ctas(dev)}")
    return (done[3][1], done[5][1], done[7][1],
            {"first": done[8][1], "k5": done[9][1]}, done[11][1],
            (done[14][1], done[15][1]))


def k2_only(T, dev, first_k2) -> int:
    """`--k2`: phases 1 and 2, K2 against its plain version and the first
    K2 (timed in turns) and the size oracle's checks (phase_k4 and
    phase_bisect) alone; no main path, so no result line."""
    phase_k2(dev, first=first_k2)
    big = T.codecs.decode_image(T.encode_to_bytes(
        photo(4032, 3024, SEED), T.JPEG, 92, device=dev), device=dev)
    phase_k4(T, dev, big)
    phase_bisect(T, dev, big)
    log("k2 only: every case passed")
    return 0


def k3_only(T, dev, first_k3) -> int:
    """`--k3`: phases 1, 2 and 11 alone, at BALANCED's usual qualities,
    and the size oracle's checks (phase_k4 and phase_bisect); no main
    path, so no result line."""
    _err, _times = phase_k3(T, dev, k3_cases(30, 30, 60), first=first_k3)
    big = T.codecs.decode_image(T.encode_to_bytes(
        photo(4032, 3024, SEED), T.JPEG, 92, device=dev), device=dev)
    phase_k4(T, dev, big)
    phase_bisect(T, dev, big)
    log("k3 only: every case passed")
    return 0


def k5_only(T, dev, first_k5, stamped) -> int:
    """`--k5`: phases 1, 2 and 16 alone, at BALANCED's usual qualities; no
    main path, so no result line."""
    worst, *_ = phase_k5(T, dev, (30, 30, 60), first_k5, stamped)
    log(f"k5 only: every case passed (largest difference {worst})")
    return 0


@contextlib.contextmanager
def k78_route(plain: bool, record: list):
    """K7's and K8's entries as the package calls them, replaced for the
    duration by recorders that append (kind, inputs, output) to `record`;
    with plain=True they run the plain versions on the card, which is the
    route before K7 and K8 (the parent's)."""
    from fennec_tpu_torch.codecs import jpeg as J
    from fennec_tpu_torch.engine import compress as C
    from fennec_tpu_torch.ops import forward_dct_cuda as k8

    real = k78_wrappers()

    def keep(kind, inputs, out):
        record.append((kind, inputs, out))
        return out

    class Decode:
        @staticmethod
        def frame(*args):
            return keep("frame", args, J.reconstruct_plain(*args) if plain
                        else real["decode_recon"].frame(*args))

        @staticmethod
        def batch(*args):
            return keep("batch", args,
                        C.decode_jpeg_image_plain(*args) if plain
                        else real["decode_recon"].batch(*args))

    def fdct(img, sub):
        return keep("forward_dct", (img, sub),
                    J.forward_dct_plain(img, sub) if plain
                    else real["forward_dct"](img, sub))

    def lum(imgs, wh, wv, rect, rows):
        return keep("luminance", (imgs, wh, wv, rect, rows),
                    C.lum_orig_plain(imgs, wh, wv, rows) if plain
                    else real["luminance"](imgs, wh, wv, rect, rows))

    saved = (k8.forward_dct, C.original_luminance, J.decode_recon,
             C.decode_recon)
    k8.forward_dct, C.original_luminance = fdct, lum
    J.decode_recon = C.decode_recon = Decode
    try:
        yield record
    finally:
        (k8.forward_dct, C.original_luminance, J.decode_recon,
         C.decode_recon) = saved


def same_inputs(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype
                and bool(torch.equal(a, b)))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(same_inputs, a, b))
    return a == b


def trace_ties(name: str, kern: list, plain: list, qualities, dev) -> dict:
    """Each K7 / K8 call of the kernel route paired with the plain route's
    call on the same inputs: the pixels, levels (at the call's chosen
    qualities) and luminance values that differ, every one at a tie (the
    phase-18 checks, which raise otherwise).  Calls with no partner got
    inputs that an earlier difference had already moved."""
    out = {"pixels": 0, "levels": 0, "luminance": 0, "downstream": 0}
    for kind, args, got in kern:
        match = next((w for k, a, w in plain
                      if k == kind and same_inputs(a, args)), None)
        if match is None:
            out["downstream"] += 1
            continue
        if kind == "frame":
            out["pixels"] += k7_compare(name, got, match,
                                        k7_round_inputs(*args))
        elif kind == "batch":
            blocks, qt, h, w, sub = args
            s = 2 if sub else 1
            mx, my = -(-w // (8 * s)), -(-h // (8 * s))
            ny, nc = mx * my * s * s, mx * my
            parts = [blocks[:, :ny], blocks[:, ny:ny + nc],
                     blocks[:, ny + nc:]]
            comps = [(s, s, mx * s, my * s), (1, 1, mx, my), (1, 1, mx, my)]
            q = qt.to(torch.int32)
            out["pixels"] += k7_compare(name, got, match, k7_round_inputs(
                parts, [q[:, 0, None], q[:, 1, None], q[:, 1, None]], comps,
                s, s, h, w, "ycbcr"))
        elif kind == "forward_dct":
            out["levels"] += k8_levels(name, got, match, qualities, dev)
        else:
            imgs, _wh, wv, rect, _rows = args
            x = imgs if imgs.dim() == 4 else imgs[None]
            out["luminance"] += k8_lum_compare(
                name, got, match, x, rect, got.shape[-2], got.shape[-1])[0]
    return out


def digests_only(T, dev) -> int:
    """`--digests`: the outputs of a few main-path calls as digests, and
    each call's warm time, to compare two checkouts on one card: standard
    mode at 12 MP and 1080p, T1 at 1080p and 500x500, T2 over 64 photos,
    T3 over 16 files.  Each call runs on K7 and K8 ("digest") and on their
    plain versions on the card ("digest_plain", the route before them: a
    checkout without K7 and K8 prints it as "digest"); where the two
    differ, trace_ties holds every differing pixel, level and luminance
    value to a tie, and the chosen qualities that moved are printed.  The
    standard calls' decisions are replayed with the plain scorer
    (check_result).  The input files are encoded on the plain versions,
    as such a checkout encodes them."""
    with k78_route(True, []):
        big = T.encode_to_bytes(photo(4032, 3024, SEED), T.JPEG, 92,
                                device=dev)
        mid = T.encode_to_bytes(photo(1920, 1080, SEED + 800), T.JPEG, 92,
                                device=dev)
        small = [photo(500, 500, SEED + 900 + k) for k in range(64)]
        files = [T.encode_to_bytes(small[i], T.JPEG, 92, device=dev)
                 for i in range(16)]
    moved = {}

    def say(name, run, check=None):
        run()  # cold
        t = time.perf_counter()
        results = run()  # warm; host bytes, so it ends synchronised
        log(f"timing {name} warm_ms={(time.perf_counter() - t) * 1e3:.1f}")
        blobs = [r.compressed_data for r in results]
        log(f"digest {name}={digest(blobs)}")
        kern, plain = [], []
        with k78_route(False, kern):
            got = run()
        with k78_route(True, plain):
            was = run()
        if [r.compressed_data for r in got] != blobs:
            raise AssertionError(f"digests {name}: a run differs")
        log(f"digest_plain {name}="
            f"{digest(r.compressed_data for r in was)}")
        qa = [getattr(r, "jpeg_quality", 0) for r in got]
        qb = [getattr(r, "jpeg_quality", 0) for r in was]
        moved[name] = [(i, a, b) for i, (a, b) in enumerate(zip(qa, qb))
                       if a != b]
        if digest(blobs) != digest(r.compressed_data for r in was):
            # The levels at the chosen qualities, at every quality where
            # the call does not say which it chose (T3's files).
            ties = trace_ties(name, kern, plain,
                              sorted({q for q in qa + qb if q})
                              or range(1, 101), dev)
            differ = sum(a.compressed_data != b.compressed_data
                         for a, b in zip(got, was))
            log(f"trace {name}: differing outputs {differ} of {len(got)}, "
                f"ties {ties}, qualities moved "
                f"(item, K7/K8, plain) {moved[name]}")
            if not (ties["pixels"] or ties["levels"] or ties["luminance"]):
                raise AssertionError(f"digests {name}: the outputs differ "
                                     f"with no tie to explain it")
        if check is not None:
            check(got)

    std = T.Options()
    say("std_12mp", lambda: [T.compress_bytes(None, big, std, device=dev)],
        lambda res: check_result(T, res[0], dev, 0.94, (4032, 3024),
                                 "digests std_12mp"))
    say("std_1080p", lambda: [T.compress_bytes(None, mid, std, device=dev)],
        lambda res: check_result(T, res[0], dev, 0.94, (1920, 1080),
                                 "digests std_1080p"))
    ts = T.Options(format=T.JPEG, target_size=200 * 1024)
    say("t1_1080p_200KB",
        lambda: [T.compress_bytes(None, mid, ts, device=dev)])
    ts = T.Options(format=T.JPEG, target_size=20 * 1024)
    say("t1_500_20KB",
        lambda: [T.compress_image(None, small[0], ts, device=dev)])
    say("t2_64x500_20KB",
        lambda: T.compress_images(None, small, ts, device=dev))
    say("images_32x500", lambda: T.compress_images(
        None, small[:32], T.Options(format=T.JPEG), device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        items = []
        for i in range(16):
            src = os.path.join(tmp, f"in{i}.jpg")
            with open(src, "wb") as f:
                f.write(files[i])
            items.append(T.BatchItem(src=src,
                                     dst=os.path.join(tmp, f"out{i}.jpg")))

        class Out:
            def __init__(self, data):
                self.compressed_data = data

        def t3():
            res = T.compress_batch(None, items,
                                   T.BatchOptions(default_opts=ts),
                                   device=dev)
            blobs = []
            for r in res:
                if r.err is not None:
                    raise AssertionError(f"digests: {r.item.src}: {r.err}")
                with open(r.item.dst, "rb") as f:
                    blobs.append(Out(f.read()))
            return blobs

        say("t3_16x500_20KB", t3)
    log(f"digests: qualities that moved between K7/K8 and their plain "
        f"versions {moved}")
    return 0


def main(only: str = "") -> int:
    started = time.perf_counter()
    # 1. Environment.  The port is imported before anything is printed,
    # so a copy of this script without the repository prints nothing.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to check")
    import fennec_tpu_torch as T
    from fennec_tpu_torch import device as fdevice

    smi = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {smi}")
    dev = fdevice.resolve("cuda")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 is on")

    # 2. Build: the nvcc builds (K1, K2, K3 and the first K3, kept for
    # phase 11's timing in turns) and the g++ build at once.
    from fennec_tpu_torch.ops import coef_wire_cuda as k6
    from fennec_tpu_torch.ops import huffbuild_cuda as k5
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops import probe_recon_cuda as k2
    from fennec_tpu_torch.ops.ssim import batched_ssim_plain
    from fennec_tpu_torch.ops.ssim_cuda import SOURCE, ssim_window

    count_bisections()
    if only == "digests":  # kernels build at first use
        return digests_only(T, dev)
    first_k3, first_k2, first_k5, stamped, first_k6, first_k78 = build_all(
        ssim_window, k3, k2.probe_recon)
    if only == "k3":
        return k3_only(T, dev, first_k3)
    if only == "k2":
        return k2_only(T, dev, first_k2)
    if only == "k5":
        return k5_only(T, dev, first_k5, stamped)
    if only == "wire":
        return wire_only(T, dev, ssim_window, first_k6)
    if only == "k7k8":
        return k7k8_only(T, dev, first_k78)
    if only == "mesh":
        from fennec_tpu_torch.engine.batched import counters

        big = T.encode_to_bytes(photo(4032, 3024, SEED), T.JPEG, 92,
                                device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            big_path = os.path.join(tmp, "photo_12mp.jpg")
            with open(big_path, "wb") as f:
                f.write(big)
            phase_mesh(T, dev, counters, big_path, tmp)
        log("spatial summary: " + json.dumps(phase_spatial(T, dev)))
        return 0

    # 3. K1, then K2, against their plain versions.
    max_err, times = phase_kernel(dev, ssim_window, batched_ssim_plain)
    k2_err, k2_times = phase_k2(dev, first=first_k2)
    # 18. K7 and K8 against their plain versions, before the main path
    # runs through them.
    k78_times, k78_counts = phase_k7k8(T, dev, first=first_k78)

    # 4. The main path.
    big = photo(4032, 3024, SEED)
    big_jpeg = T.encode_to_bytes(big, T.JPEG, 92, device=dev)
    del big
    requests = [(q, T.encode_to_bytes(photo(1920, 1080, SEED + i), T.JPEG,
                                      92, device=dev))
                for i, q in enumerate((T.ULTRA, T.HIGH, T.BALANCED,
                                       T.AGGRESSIVE))]
    results = []
    ssim_window.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "photo_12mp.jpg")
        with open(src, "wb") as f:
            f.write(big_jpeg)
        runs = [("12mp_balanced", lambda: T.compress_file(
                    None, src, os.path.join(tmp, "a.jpg"), T.Options(),
                    device=dev), 0.94, (4032, 3024)),
                ("12mp_max_width_1920", lambda: T.compress_file(
                    None, src, os.path.join(tmp, "b.jpg"),
                    T.Options(max_width=1920), device=dev), 0.94,
                 (1920, 1440))]
        runs += [(f"1080p_{str(q).lower()}",
                  lambda q=q, data=data: T.compress_bytes(
                      None, data, T.Options(quality=q), device=dev),
                  q.target_ssim(), (1920, 1080)) for q, data in requests]
        n_images = 0
        for tag, run, target, wh in runs:
            k3_zero()
            t = time.perf_counter()
            run()  # cold: first call at this shape
            cold_ms = (time.perf_counter() - t) * 1e3
            k3_take(f"{tag} cold", dev, 1, probes=7)
            k3_zero()
            t = time.perf_counter()
            with record_k5_inputs(tag):
                res = run()  # warm; the result is host bytes, so synced
            warm_ms = (time.perf_counter() - t) * 1e3
            k3_take(f"{tag} warm", dev, 1, probes=7)
            n_images += 2
            results.append((tag, res, target, wh, cold_ms, warm_ms))
    launches = ssim_window.launches
    total_launches = launches
    if launches < 7 * n_images:
        raise AssertionError(f"K1 ran {launches} times for {n_images} "
                             f"images; the main path must launch it "
                             f">= 7 times per image")
    log(f"main path: {n_images} images, K1 launches={launches}, K2 "
        f"launches {K2_MAIN} (seven probes per image), K3 launches "
        f"{K3_MAIN} (one K3b per image, coding it on the card)")

    for tag, res, target, wh, cold_ms, warm_ms in results:
        checked, s_dec = check_result(T, res, dev, target, wh, tag)
        log(f"image {tag} dims={wh[0]}x{wh[1]} quality={res.jpeg_quality} "
            f"ssim={res.ssim:.7f} target={target} bytes={res.compressed_size}"
            f" cold_ms={cold_ms:.1f} warm_ms={warm_ms:.1f} "
            f"decoded_ssim={s_dec:.7f} decisions_rescored_q={checked}")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "photo_12mp.jpg")
        with open(src, "wb") as f:
            f.write(big_jpeg)
        from fennec_tpu_torch.utils.profiling import StageTimer, use_timer

        reset_peak(dev)
        timer = StageTimer()
        with use_timer(timer):
            T.compress_file(None, src, os.path.join(tmp, "out.jpg"),
                            T.Options(), device=dev)
        log_peak("12 MP compress_file", dev, 1, 4032 * 3024)
        log("the program's stages of a warm 12 MP compress_file:")
        for ln in timer.report().splitlines():
            log(f"  {ln}")

    # 5. Card against CPU on a small, noisy input (no SSIMFast
    # downsample, so the search ends above its seed and q-1 is probed).
    small = photo(480, 360, SEED + 7, fine=40.0)
    r_gpu = T.compress_image(None, small, T.Options(), device=dev)
    r_cpu = T.compress_image(None, small, T.Options(), device="cpu")
    if (r_gpu.jpeg_quality != r_cpu.jpeg_quality
            or abs(r_gpu.ssim - r_cpu.ssim) > K1_ATOL):
        raise AssertionError(f"card vs CPU: q {r_gpu.jpeg_quality}/"
                             f"{r_cpu.jpeg_quality} ssim {r_gpu.ssim}/"
                             f"{r_cpu.ssim}")
    checked, _ = check_result(T, r_gpu, dev, 0.94, (480, 360), "480x360")
    log(f"card vs cpu 480x360: quality={r_gpu.jpeg_quality} "
        f"ssim={r_gpu.ssim:.7f}/{r_cpu.ssim:.7f} bytes_identical="
        f"{r_gpu.compressed_data == r_cpu.compressed_data} "
        f"decisions_rescored_q={checked}")

    # 6-9. The batch paths and the CLI.
    from fennec_tpu_torch.engine.batched import counters

    with tempfile.TemporaryDirectory() as tmp:
        total_launches += phase_batch_files(T, dev, ssim_window, counters,
                                            tmp)
        total_launches += phase_pixel_path(T, dev, ssim_window, counters)
        total_launches += phase_full_size(T, dev, ssim_window, counters,
                                          tmp)
        phase_cli_mixed(T, dev, tmp)

    # 10. Target-size mode.
    with tempfile.TemporaryDirectory() as tmp:
        big_path = os.path.join(tmp, "photo_12mp.jpg")
        with open(big_path, "wb") as f:
            f.write(big_jpeg)
        big_img = T.codecs.decode_image(big_jpeg, device=dev)
        time_ts_device_work(dev, big_img)
        k4_times = phase_k4(T, dev, big_img)
        bisect_times = phase_bisect(T, dev, big_img)
        total_launches += phase_ts_single(T, dev, ssim_window, counters,
                                          big_path, big_img, tmp)
        total_launches += phase_ts_batch(T, dev, ssim_window, counters)
        total_launches += phase_ts_full_size(T, dev, ssim_window, counters,
                                             big_img)
        total_launches += phase_ts_files(T, dev, ssim_window, counters, tmp,
                                         big_path)
        phase_ts_card_vs_cpu(T, dev, big_img)
    log(f"main path launches (phases 4, 6-8, 10): K3 and K4 {K3_MAIN}, "
        f"K2 {K2_MAIN}, K6 {K6_MAIN}")
    if not all(K6_MAIN.values()):
        raise AssertionError(f"the main path launched K6 {K6_MAIN}: every "
                             f"layout must run (photos as COO, noise as "
                             f"dense int8, FENNEC_UPLOAD=csr as CSR)")
    log(f"main path launches of K7 and K8 (phases 4, 6-8, 10): {K78_MAIN}")
    if not all(K78_MAIN.values()):
        raise AssertionError(f"the main path launched K7 / K8 {K78_MAIN}: "
                             f"every decode on the card is K7, every forward "
                             f"DCT and original's luminance K8")
    log(f"replays of the bisection with the plain scorer: "
        f"{REPLAY['probes']} probes, largest |SSIM difference| between K2 "
        f"+ K1 and the plain scorer {REPLAY['max_ssim_diff']:.3e}, "
        f"decisions that differ: {REPLAY['flips']}")
    if REPLAY["flips"] or REPLAY["max_ssim_diff"] > K1_ATOL:
        raise AssertionError(f"K2 + K1 against the plain scorer: "
                             f"{REPLAY}")

    # 11. K3 against its plain version at the main path's shapes.
    quality = {tag: res.jpeg_quality for tag, res, *_ in results}
    q500 = T.compress_image(None, photo(500, 500, SEED + 100),
                            T.Options(format=T.JPEG), device=dev).jpeg_quality
    k3_err, k3_times = phase_k3(T, dev, k3_cases(
        quality["12mp_balanced"], quality["1080p_balanced"], q500),
        first=first_k3)

    # 12. The two encode routes, in this call; 13. the rest of the surface.
    with tempfile.TemporaryDirectory() as tmp:
        big_path = os.path.join(tmp, "photo_12mp.jpg")
        with open(big_path, "wb") as f:
            f.write(big_jpeg)
        ab = phase_ab(T, dev, tmp, big_path)
    phase_surface(T, dev, big_img)

    # 14. The mesh over this card, and the stage report and trace.
    with tempfile.TemporaryDirectory() as tmp:
        big_path = os.path.join(tmp, "photo_12mp.jpg")
        with open(big_path, "wb") as f:
            f.write(big_jpeg)
        mesh = phase_mesh(T, dev, counters, big_path, tmp)
    # 15. The data×spatial mesh over this card.
    log("spatial summary: " + json.dumps(phase_spatial(T, dev)))
    # 16. K5 against its plain version, the host builder and the first K5.
    k5_err, k5_times, k5_emits, _splits = phase_k5(T, dev, (
        quality["12mp_balanced"], quality["1080p_balanced"], q500),
        first_k5, stamped)
    # 17. The upload routes: K6 against its plain version, the batch
    # through each route, the pixel path's two wires.
    with tempfile.TemporaryDirectory() as tmp:
        k6_times, k6_err = phase_wire(T, dev, ssim_window, counters, tmp,
                                      first_k6)
    log("K5 emission summary (ms, K5 flow vs host-built flow in turns): "
        + json.dumps(k5_emits))
    log("mesh summary (warm img/s, median of 3; cross-card scaling not "
        "measured: one card): " + json.dumps(mesh))
    log("A/B summary (warm ms, K3 vs host encoder): " + json.dumps(
        {k: {"k3": v[None], "host": v[False]} for k, v in ab.items()}))
    log(f"timings torch.profiler recorded nothing of (CUDA-event ms of the "
        f"whole call instead): {PROFILER_MISSES or 'none'}")
    log(f"all phases took {time.perf_counter() - started:.1f} s, the builds "
        f"included")

    k3t = k3_times[("12mp_420", True)]
    k4t = k4_times["12mp_420"]
    k3_rows = []
    for part, name, replaces, key in (
            ("k3a", "jpeg_block_stats", "fennec_tpu/ops/jpeg_emit.py:306",
             "block_stats"),
            ("k3b", "jpeg_deposit", "fennec_tpu/ops/jpeg_emit.py:587",
             "deposit"),
            # The size oracle's step: quantize and count in one launch.
            # The main path bisects with K4's bisection now; the step is
            # phase_k4's and phase_bisect's yardstick (0 launches here).
            ("k4", "jpeg_quantize_count",
             "fennec_tpu/ops/jpeg_size.py:138", "oracle")):
        if part == "k4":
            k3_rows.append({
                "name": name, "route": "cuda",
                "source": os.path.relpath(k3.SOURCE, HERE),
                "replaces": replaces, "launches": K3_MAIN[key],
                # Integer bit totals against the plain version's.
                "max_abs_err": k4t["max_abs_err"],
                "shape": [1, 285768, 64],
                "ms": k4t["kernel_ms"], "plain_ms": k4t["plain_step_ms"],
                "bound_ms": k4t["bound_ms"], "bound_by": k4t["bound_by"],
                "share": k4t["share"], "library_ms": None,
                "host_us": k4t["host_us"], "step_ms": k4t["step_ms"],
                "earlier_step_ms": k4t["earlier_step_ms"]})
            continue
        k3_rows.append({
            "name": name,
            "route": "cuda",
            "source": os.path.relpath(k3.SOURCE, HERE),
            # XLA programs of the JAX package, not Pallas kernels.
            "replaces": replaces,
            "launches": K3_MAIN[key],
            "max_abs_err": k3_err,
            "shape": [1, 285768, 64],
            "ms": k3t[f"{part}_ms"],
            "plain_ms": k3t[f"{part}_plain_ms"],
            "bound_ms": k3t[f"{part}_bound_ms"],
            "bound_by": k3t[f"{part}_bound_by"],
            "share": k3t[f"{part}_share"],
            # No PyTorch call codes Huffman or counts its bits.
            "library_ms": None,
            "host_us": k3t[f"{part}_host_us"],
            "first_ms": k3t.get(f"{part}_first_ms"),
        })
    # K4's bisection: the whole size search in one launch.
    bt = bisect_times["12mp_420"]
    k3_rows.append({
        "name": "jpeg_size_bisect", "route": "cuda",
        "source": os.path.relpath(k3.SOURCE, HERE),
        # The XLA program size_bisect_device (a fori_loop of 7 steps).
        "replaces": "fennec_tpu/engine/size_search.py:61",
        "launches": K3_MAIN["bisect"],
        # Integer (best_q, found) and table cells against the step loop's,
        # at every phase_bisect case.
        "max_abs_err": max(t["max_abs_err"] for t in bisect_times.values()),
        "shape": [1, 285768, 64],
        "ms": bt["kernel_ms"], "plain_ms": bt["plain_ms"],
        "bound_ms": bt["bound_ms"], "bound_by": "bytes",
        "share": bt["share"], "library_ms": None,
        "reread_bound_ms": bt["reread_bound_ms"],
        "event_ms": bt["event_ms"], "host_us": bt["host_us"],
        "device_ops": bt["device_ops"],
        # The step loop through K4's step, in turns.
        "loop_event_ms": bt["loop_event_ms"],
        "loop_device_ms": bt["loop_device_ms"],
        "loop_device_ops": bt["loop_device_ops"]})
    # K5: the device K.2 table build, once per optimal emission.
    k5t, k5b = k5_times["12mp_420"], k5_times["500x500x64_420"]
    k3_rows.append({
        "name": "huffbuild", "route": "cuda",
        "source": os.path.relpath(k5.SOURCE, HERE),
        # An XLA program of the JAX package, not a Pallas kernel.
        "replaces": "fennec_tpu/ops/huffbuild.py:169",
        "launches": K3_MAIN["huffbuild"],
        # Integer tables and header against the plain version's.
        "max_abs_err": k5_err, "shape": k5t["shape"],
        "ms": k5t["ms"], "plain_ms": k5t["plain_ms"],
        "bound_ms": k5t["bound_ms"], "bound_by": k5t["bound_by"],
        "share": k5t["share"],
        # No PyTorch call builds Huffman tables.
        "library_ms": None,
        "host_us": k5t["host_us"], "event_ms": k5t["event_ms"],
        "host_builder_ms": k5t["host_builder_ms"],
        "chain_ms": k5t["chain_ms"],
        # The first K5 (bench_sources/huffbuild_first.cu), in turns.
        "first_ms": k5t["first_ms"], "first_event_ms": k5t["first_event_ms"],
        "first_host_us": k5t["first_host_us"],
        # B = 64 at BALANCED, and the cases at high quality.
        **{case: {k: k5_times[case][k] for k in (
            "shape", "live", "ms", "event_ms", "host_us", "first_ms",
            "first_event_ms", "first_host_us", "bound_ms", "bound_by",
            "chain_ms", "share")} for case in K5_TIMED[1:]}})
    # K6: one row per layout, timed at the 64 x 500x500 chunk (12 MP x 16
    # beside it); launches from the main path, phase 17's beside them.
    k6_main_runs = {
        "coo": "default options: the 500x500 and 12 MP photo batches",
        "i8": "default options: 64 files of noise at Q100",
        "csr": "FENNEC_UPLOAD=csr (opt-in): 64 of the 500x500 photos"}
    for layout in ("coo", "i8", "csr"):
        kt, kb = k6_times["500x500x64"][layout], k6_times["12mp_x16"][layout]
        k3_rows.append({
            "name": f"coef_wire_{layout}", "route": "cuda",
            "source": os.path.relpath(k6.SOURCE, HERE),
            # An XLA program of the JAX package, not a Pallas kernel.
            "replaces": K6_REPLACES[layout],
            "launches": K6_MAIN[layout],
            "main_path_runs": k6_main_runs[layout],
            "phase17_launches": K6_WIRE[layout],
            # Integer blocks against the plain version's and the decoder's.
            "max_abs_err": k6_err, "shape": kt["shape"],
            "ms": kt["ms"], "plain_ms": kt["plain_ms"],
            "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
            "share": kt["share"],
            # No one PyTorch call rebuilds the blocks (several do).
            "library_ms": None,
            "event_ms": kt["event_ms"], "host_us": kt["host_us"],
            # The first K6 (bench_sources/coef_wire_first.cu), in turns.
            "first_ms": kt["first_ms"], "first_event_ms": kt["first_event_ms"],
            "first_host_us": kt["first_host_us"],
            "device_ops": kt["device_ops"], "wire_bytes": kt["wire_bytes"],
            "12mp_x16": kb})
    # K7 and K8 (phase 18): timed at 12 MP; the other shapes beside.
    for name, entry, case in (("decode_recon", "decode_recon", "12mp_420"),
                              ("forward_dct", "forward_dct", "12mp_420")):
        kt = k78_times[entry][case]
        row = {
            "name": name, "route": "cuda",
            "source": os.path.relpath(k78_wrappers()[entry].source
                                      if entry == "decode_recon" else
                                      k78_wrappers()[entry].library.source,
                                      HERE),
            # XLA programs of the JAX package, not Pallas kernels.
            "replaces": K78_REPLACES[entry],
            "launches": K78_MAIN[entry],
            # Pixel levels (K7) or coefficients (K8) against the plain
            # version; every differing level sits at a tie (phase 18).
            "max_abs_err": (k78_counts["k7_max_level_diff"]
                            if entry == "decode_recon"
                            else k78_counts["k8_max_coef_diff"]),
            "shape": kt["shape"], "ms": kt["ms"], "plain_ms": kt["plain_ms"],
            "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
            "share": kt["share"],
            # No one PyTorch call computes either; matmul_part_ms is the
            # block product alone.
            "library_ms": None,
            "event_ms": kt["event_ms"], "host_us": kt["host_us"],
            # The first build (bench_sources/*_first.cu), in turns.
            "first_ms": kt["first_ms"], "first_event_ms": kt["first_event_ms"],
            "first_host_us": kt["first_host_us"],
            "matmul_part_ms": kt["matmul_part_ms"],
            "others": {c: v for c, v in k78_times[entry].items()
                       if c != case}}
        if entry == "forward_dct":
            row["luminance"] = {
                "replaces": K78_REPLACES["luminance"],
                "launches": K78_MAIN["luminance"],
                **k78_times["luminance"]}
        else:
            row["ties"] = {k: v for k, v in k78_counts.items()
                           if k.startswith("k7_") and "max" not in k}
        k3_rows.append(row)
    k3_rows[-1]["ties"] = {k: v for k, v in k78_counts.items()
                           if k.startswith("k8_") and "max" not in k}
    t = times[(1, 384, 512)]
    k2t = k2_times["12mp_420_q30"]
    print(json.dumps({"kernels": [{
        "name": "ssim_window",
        "route": "cuda",
        "source": os.path.relpath(SOURCE, os.path.dirname(
            os.path.abspath(__file__))),
        "replaces": "fennec_tpu/ops/ssim_pallas.py:130",
        "launches": total_launches,
        "max_abs_err": max_err,
        "shape": [1, 384, 512],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "share": t["share"],
        # No single PyTorch call computes windowed SSIM.
        "library_ms": None,
        "event_ms": t["event_ms"],
        "host_us": t["host_us"],
    }, {
        "name": "probe_recon",
        "route": "cuda",
        "source": os.path.relpath(k2.SOURCE, HERE),
        # XLA programs of the JAX package's probe, not a Pallas kernel.
        "replaces": "fennec_tpu/engine/compress.py:140",
        "launches": K2_MAIN["recon"],
        # Luminance levels: a channel that lands on the other side of a
        # rounding moves it by up to 1.0.
        "max_abs_err": k2_err,
        "shape": k2t["shape"],
        "ms": k2t["ms"],
        "plain_ms": k2t["plain_ms"],
        "bound_ms": k2t["bound_ms"],
        "bound_by": k2t["bound_by"],
        "share": k2t["share"],
        # No single PyTorch call reconstructs a probe.
        "library_ms": None,
        "event_ms": k2t["event_ms"],
        "host_us": k2t["host_us"],
        "device_ops": k2t["ops"],
        # The first K2 (bench_sources/probe_recon_first.cu), in turns.
        "first_ms": k2t["first_ms"],
        "first_host_us": k2t["first_host_us"],
        "first_device_ops": k2t["first_ops"],
    }] + k3_rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    flags = {"--k2": "k2", "--k3": "k3", "--k5": "k5",
             "--digests": "digests", "--mesh": "mesh", "--wire": "wire",
             "--k7k8": "k7k8"}
    if len(sys.argv) > 2 or (len(sys.argv) == 2
                             and sys.argv[1] not in flags):
        raise SystemExit(f"usage: python3 chip_smoke.py [{' | '.join(flags)}]")
    sys.exit(main(flags[sys.argv[1]] if len(sys.argv) == 2 else ""))
