"""Drive the PyTorch port's main paths once on one CUDA card, and check
them.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. environment: a CUDA card, its name and power limit, TF32 off;
  2. build: kernel K1 (nvcc, sm_90a) and the host C++ entropy coder, from
     the sources in this checkout;
  3. K1 against its plain PyTorch version on the card, at the shapes the
     main paths give it and beyond, the batch engines' (64, 500, 500)
     included (max |diff| <= 1e-5), with both times;
  4. the single-image path through the public entry points: compress_file
     on a 12 MP (4032x3024) photo-like JPEG, cold then warm; with
     max_width=1920; compress_bytes on four 1920x1080 requests at ULTRA,
     HIGH, BALANCED and AGGRESSIVE.  Every output must decode to its
     dimensions, meet its SSIM target (or be the Q=100 fallback), agree
     with SSIM scored on its own decode, and K1 must have run at least 7
     times per image.  Each accept/reject decision at the boundary (the
     chosen quality q, and q-1) is re-scored with the plain scorer, and
     the whole bisection is replayed with it;
  5. a small noisy image through the same entry point on the card and on
     the CPU (plain versions): the same quality and SSIM, and the same
     decision checks;
  6. compress_batch over 512 JPEG files of 500x500 at Q92, cold then warm
     (then once more under torch.profiler): every file through the
     coefficient route, none rescued by the per-file pool, K1 at least 7
     times per chunk; every 32nd item against per-image compress_bytes on
     the card (same quality, SSIM within 1e-5, size within 16 bytes,
     decoded pixels within 3 levels); every 64th item's decisions
     replayed with the plain scorer;
  7. compress_images over 256 decoded 500x500 images (32 distinct x 8):
     each must give the bytes compress_image gives its source;
  8. compress_batch over 16 files of 4032x3024: the chunk size the engine
     picks from the card's free memory, and two files against per-image
     compress_file;
  9. the CLI (python -m fennec_tpu_torch --batch) in a subprocess on a
     directory of the committed progressive and multi-scan fixtures, a
     baseline JPEG, a PNG, an EXIF-rotated JPEG and a truncated JPEG:
     only the truncated file fails, and the progressive fixture decodes
     on the card as on the CPU.

The last lines: the kernel table as JSON (K1's launches summed over the
main-path runs of phases 4 and 6-8, each counted from 0), the card's
name and power limit as nvidia-smi reports them, and {"ok": true,
"device": {...}}.  Images are made from numpy seeds; nothing is
fetched.  Without a CUDA card the script fails before printing any
result.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
SHAPES = [(3, 32, 32), (3, 64, 48), (3, 130, 100), (1, 384, 512),
          (4, 288, 512), (1, 1080, 1920), (1, 2160, 3840), (64, 500, 500)]
TIMED_SHAPES = [(1, 384, 512), (1, 2160, 3840), (64, 500, 500)]
K1_ATOL = 1e-5  # the bound tests/test_ssim_pallas.py holds Pallas to
DECODE_SSIM_ATOL = 1e-3  # probe model vs real decode: IDCT order, ties
# The coefficient path's contract against per-image compression
# (tests/test_coef_fastpath.py:60-97, tests/test_torch_batch.py).
SIZE_ATOL = 16
PIXEL_ATOL = 3
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_kernel(dev, ssim_window, batched_ssim_plain):
    """K1 against the plain version; returns (max_abs_err, times)."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    times = {}
    for shape in SHAPES:
        a_np = rng.uniform(0, 255, shape).astype(np.float32)
        b_np = np.clip(a_np + rng.normal(0, 12, shape), 0, 255)
        a = torch.from_numpy(a_np).to(dev)
        b = torch.from_numpy(b_np.astype(np.float32)).to(dev)
        got = ssim_window(a, b)
        want = batched_ssim_plain(a, b)
        ones = ssim_window(a, a.clone())
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        one_err = float((ones - 1.0).abs().max())
        if not (torch.isfinite(got).all() and err <= K1_ATOL
                and one_err <= K1_ATOL):
            raise AssertionError(f"K1 {shape}: |diff| {err}, identical "
                                 f"pair off 1.0 by {one_err}")
        worst = max(worst, err, one_err)
        log(f"k1 shape={shape} max_abs_err={err:.3e} "
            f"identical_err={one_err:.3e} ssim={got.tolist()[:2]}")
        if shape in TIMED_SHAPES:
            iters = 200 if a.numel() < 1_000_000 else 30
            k_ms = cuda_ms(lambda: ssim_window(a, b), iters)
            p_ms = cuda_ms(lambda: batched_ssim_plain(a, b), iters)
            times[shape] = (k_ms, p_ms)
            log(f"k1 time shape={shape} kernel_ms={k_ms:.5f} "
                f"plain_ms={p_ms:.5f}")
    return worst, times


def check_result(T, res, dev, target: float, expect_wh, tag: str,
                 src_img=None):
    """Decode, SSIM target, decode-scored SSIM and boundary decisions.
    src_img is the image the search saw (res.image unless given: the
    coefficient path keeps no pixels on the host)."""
    from fennec_tpu_torch.engine.compress import (
        _seed_lo,
        prepare_search,
        probe_luminance,
    )
    from fennec_tpu_torch.ops.ssim import batched_ssim_plain

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

    def plain(q: int) -> torch.Tensor:
        lum = probe_luminance(inp, torch.tensor([q], device=dev))
        return batched_ssim_plain(inp.lum_orig, lum)[0]

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
    # accept/reject must match, so it must end at the same quality.
    lo, hi, best = lo0, 100, (100, 1.0)
    while lo <= hi:
        mid = (lo + hi) // 2
        s_mid = plain(mid)
        if bool(s_mid >= t32):
            best, hi = (mid, float(s_mid)), mid - 1
        else:
            lo = mid + 1
    if best[0] != q or abs(best[1] - res.ssim) > K1_ATOL:
        raise AssertionError(f"{tag}: plain bisection ends at {best}, the "
                             f"kernel's at ({q}, {res.ssim})")

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


def run_batch(T, ssim_window, counters, items, dev, tag: str):
    """One compress_batch pass with the counts set to 0 just before it:
    every item through the coefficient route and, on a CUDA device, K1
    at least 7 times per device chunk.  Returns (results, wall ms, K1
    launches, engine counters)."""
    counters.reset()
    ssim_window.launches = 0
    t = time.perf_counter()
    res = T.compress_batch(None, items, T.BatchOptions(
        fused=True, default_opts=T.Options(format=T.JPEG)), device=dev)
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = ssim_window.launches
    snap = counters.snapshot()
    bad = [(r.item.src, r.err) for r in res if r.err is not None]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} item(s) failed: {bad[:3]}")
    if snap["routes"] != {"coefficient": len(items)}:
        raise AssertionError(f"{tag}: routes {snap['routes']}; every item "
                             f"must take the coefficient route")
    if dev.type == "cuda" and launches < 7 * len(snap["chunk_items"]):
        raise AssertionError(f"{tag}: K1 ran {launches} times for "
                             f"{len(snap['chunk_items'])} chunks")
    return res, wall_ms, launches, snap


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


def profile_device(fn, tag: str) -> None:
    """Device busy time of one fn() call from torch.profiler's CUDA
    events, beside its wall time; the eight busiest kernels."""
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        log(f"{tag} profile: no device time recorded (not measured)")
        return
    log(f"{tag} profile: wall_ms={wall_ms:.1f} device_busy_ms="
        f"{busy_ms:.1f} idle_share={1 - busy_ms / wall_ms:.3f}")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def log_peak(tag: str, dev, chunk: int, pixels: int) -> None:
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"{tag} peak_device_bytes={peak} per_pixel_of_chunk="
            f"{peak / (chunk * pixels):.1f}")


def phase_batch_files(T, dev, ssim_window, counters, tmp, n=512, w=500,
                      h=500):
    """Phase 6: 512 files of 500x500 at Q92 through compress_batch."""
    canvases = [photo(w + 32, h + 32, SEED + 100 + k) for k in range(64)]
    datas = []
    for i in range(n):
        off = (i // 64) * 4
        img = np.ascontiguousarray(canvases[i % 64][off:off + h,
                                                    off:off + w])
        datas.append(T.encode_to_bytes(img, T.JPEG, 92, device=dev))
    src_dir = os.path.join(tmp, "files500")
    os.makedirs(src_dir)
    paths = []
    for i, data in enumerate(datas):
        paths.append(os.path.join(src_dir, f"in{i:03d}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(data)

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
        t = time.perf_counter()
        res = T.compress_images(None, images, opts, device=dev)
        wall_ms = (time.perf_counter() - t) * 1e3
        total += ssim_window.launches
        snap = counters.snapshot()
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


def main() -> int:
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

    # 2. Build.
    from fennec_tpu_torch import native
    from fennec_tpu_torch.ops.ssim import batched_ssim_plain
    from fennec_tpu_torch.ops.ssim_cuda import SOURCE, ssim_window

    t0 = time.perf_counter()
    ssim_window.build(force=True)
    ssim_window.load()
    t1 = time.perf_counter()
    native.build(force=True)
    native.load()
    t2 = time.perf_counter()
    log(f"build k1_nvcc_s={t1 - t0:.3f} native_gxx_s={t2 - t1:.3f}")
    log(ssim_window.build_log.strip())

    # 3. K1 against its plain version.
    max_err, times = phase_kernel(dev, ssim_window, batched_ssim_plain)

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
            t = time.perf_counter()
            run()  # cold: first call at this shape
            cold_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            res = run()  # warm; the result is host bytes, so synced
            warm_ms = (time.perf_counter() - t) * 1e3
            n_images += 2
            results.append((tag, res, target, wh, cold_ms, warm_ms))
    launches = ssim_window.launches
    total_launches = launches
    if launches < 7 * n_images:
        raise AssertionError(f"K1 ran {launches} times for {n_images} "
                             f"images; the main path must launch it "
                             f">= 7 times per image")
    log(f"main path: {n_images} images, K1 launches={launches}")

    for tag, res, target, wh, cold_ms, warm_ms in results:
        checked, s_dec = check_result(T, res, dev, target, wh, tag)
        log(f"image {tag} dims={wh[0]}x{wh[1]} quality={res.jpeg_quality} "
            f"ssim={res.ssim:.7f} target={target} bytes={res.compressed_size}"
            f" cold_ms={cold_ms:.1f} warm_ms={warm_ms:.1f} "
            f"decoded_ssim={s_dec:.7f} decisions_rescored_q={checked}")

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

    k_ms, p_ms = times[(1, 384, 512)]
    print(json.dumps({"kernels": [{
        "name": "ssim_window",
        "route": "cuda",
        "source": os.path.relpath(SOURCE, os.path.dirname(
            os.path.abspath(__file__))),
        "replaces": "fennec_tpu/ops/ssim_pallas.py:130",
        "launches": total_launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
