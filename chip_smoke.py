"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. environment: a CUDA card, its name and power limit, TF32 off;
  2. build: kernel K1 (nvcc, sm_90a) and the host C++ entropy coder, from
     the sources in this checkout;
  3. K1 against its plain PyTorch version on the card, at the shapes the
     main path gives it and beyond (max |diff| <= 1e-5), with both times;
  4. the main path through the public entry points: compress_file on a
     12 MP (4032x3024) photo-like JPEG, cold then warm; with
     max_width=1920; compress_bytes on four 1920x1080 requests at ULTRA,
     HIGH, BALANCED and AGGRESSIVE.  Every output must decode to its
     dimensions, meet its SSIM target (or be the Q=100 fallback), agree
     with SSIM scored on its own decode, and K1 must have run at least 7
     times per image.  Each accept/reject decision at the boundary (the
     chosen quality q, and q-1) is re-scored with the plain scorer, and
     the whole bisection is replayed with it;
  5. a small noisy image through the same entry point on the card and on
     the CPU (plain versions): the same quality and SSIM, and the same
     decision checks.

The last lines: the kernel table as JSON, the card's name and power limit
as nvidia-smi reports them, and {"ok": true, "device": {...}}.  Images
are made from numpy seeds; nothing is fetched.  Without a CUDA card the
script fails before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
SHAPES = [(3, 32, 32), (3, 64, 48), (3, 130, 100), (1, 384, 512),
          (4, 288, 512), (1, 1080, 1920), (1, 2160, 3840)]
TIMED_SHAPES = [(1, 384, 512), (1, 2160, 3840)]
K1_ATOL = 1e-5  # the bound tests/test_ssim_pallas.py holds Pallas to
DECODE_SSIM_ATOL = 1e-3  # probe model vs real decode: IDCT order, ties


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
            iters = 200 if shape[1] < 1000 else 30
            k_ms = cuda_ms(lambda: ssim_window(a, b), iters)
            p_ms = cuda_ms(lambda: batched_ssim_plain(a, b), iters)
            times[shape] = (k_ms, p_ms)
            log(f"k1 time shape={shape} kernel_ms={k_ms:.5f} "
                f"plain_ms={p_ms:.5f}")
    return worst, times


def check_result(T, res, dev, target: float, expect_wh, tag: str):
    """Decode, SSIM target, decode-scored SSIM and boundary decisions."""
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

    src = torch.from_numpy(res.image).to(dev).to(torch.float32)
    inp, _ = prepare_search(src, True)
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
    dec_inp, _ = prepare_search(dec, True)
    s_dec = float(batched_ssim_plain(inp.lum_orig, dec_inp.lum_orig)[0])
    if not fallback and abs(s_dec - res.ssim) > DECODE_SSIM_ATOL:
        raise AssertionError(f"{tag}: ssim of the decoded output {s_dec} "
                             f"vs reported {res.ssim}")
    return checked, s_dec


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

    k_ms, p_ms = times[(1, 384, 512)]
    print(json.dumps({"kernels": [{
        "name": "ssim_window",
        "route": "cuda",
        "source": os.path.relpath(SOURCE, os.path.dirname(
            os.path.abspath(__file__))),
        "replaces": "fennec_tpu/ops/ssim_pallas.py:130",
        "launches": launches,
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
