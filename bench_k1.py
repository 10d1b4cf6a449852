"""Time kernel K1 (windowed SSIM) on one CUDA card, against other builds
of it.

    python3 bench_k1.py [--against OTHER.cu ...] [--out FILE.json]

At the shapes the main paths give K1 it reports, per call: the device
time of K1's kernels (torch.profiler rows whose name holds
"ssim_window"), the CUDA-event time (host cost included), the host time,
and the bound with its share.  Each --against source is built as the
package builds its own and called through the wrapper of its interface:
this version's (fennec_ssim_window_ctas_per_sm present: one launch per
call), or the first K1's (partials per image, then a partials and an
out buffer: two launches per call, called as that version's wrapper
did).
Every build must agree with the plain version within 1e-5; they are
timed in turns, the others before and after the current one (A, current,
current, A for one other), in this one process and so on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (
    K1_ATOL,
    SEED,
    cuda_ms,
    host_us,
    k1_bound,
    log,
    nvidia_smi_line,
    profiled_device_ms,
)

SHAPES = [(1, 384, 512), (1, 288, 512), (1, 500, 500), (5, 499, 499),
          (64, 500, 500), (1, 2160, 3840)]


def build_other(path: str, tag: str):
    """(callable (a, b) -> (B,), kernel launches per call) for a K1
    source of either interface."""
    from fennec_tpu_torch.ops.filters import gaussian_window_1d
    from fennec_tpu_torch.ops.ssim import GAUSS_SIGMA, SSIM_C1, SSIM_C2
    from fennec_tpu_torch.ops.ssim_cuda import (
        BUILD_DIR,
        NVCC_FLAGS,
        WindowedSsimKernel,
        find_nvcc,
    )

    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libssim_window_{tag}.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, path],
                          capture_output=True, text=True)
    log(f"{tag} = {path}\n{(proc.stdout + proc.stderr).strip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}")
    lib = ctypes.CDLL(so)
    if hasattr(lib, "fennec_ssim_window_ctas_per_sm"):
        return WindowedSsimKernel(source=path, library=so), 1
    lib.fennec_ssim_window_partials_per_image.restype = ctypes.c_int
    lib.fennec_ssim_window_partials_per_image.argtypes = [ctypes.c_int,
                                                          ctypes.c_int]
    lib.fennec_ssim_window.restype = ctypes.c_int
    lib.fennec_ssim_window.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

    def first(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        # The first wrapper's work per call: two allocations, the taps
        # as a new ctypes array, a device context.
        bsz, h, w = a.shape
        per_image = lib.fennec_ssim_window_partials_per_image(h, w)
        partials = torch.empty((bsz, per_image), dtype=torch.float32,
                               device=a.device)
        out = torch.empty((bsz,), dtype=torch.float32, device=a.device)
        taps = (ctypes.c_float * 8)(*gaussian_window_1d(8, GAUSS_SIGMA))
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.fennec_ssim_window(
                a.data_ptr(), b.data_ptr(), bsz, h, w,
                ctypes.cast(taps, ctypes.c_void_p), SSIM_C1, SSIM_C2,
                partials.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"CUDA error {err}")
        return out

    return first, 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another K1 source (repeatable)")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1: no CUDA device")
    from fennec_tpu_torch.ops.ssim import batched_ssim_plain
    from fennec_tpu_torch.ops.ssim_cuda import launch_plan, ssim_window

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    ssim_window.build(force=True)
    ssim_window.load()
    log(ssim_window.build_log.strip())
    dev = torch.device("cuda")
    sms, per_sm = ssim_window.card(dev)
    log(f"SMs={sms} K1 CTAs per SM={per_sm}")
    versions = {"current": (ssim_window, 1)}
    for i, path in enumerate(args.against):
        versions[f"other{i}"] = build_other(path, f"other{i}")
    others = [name for name in versions if name != "current"]
    order = others + ["current", "current"] + others[::-1]
    rng = np.random.default_rng(SEED)
    rows = []
    for shape in SHAPES:
        a_np = rng.uniform(0, 255, shape).astype(np.float32)
        b_np = np.clip(a_np + rng.normal(0, 12, shape), 0, 255)
        a = torch.from_numpy(a_np).to(dev)
        b = torch.from_numpy(b_np.astype(np.float32)).to(dev)
        want = batched_ssim_plain(a, b)
        for name, (fn, _) in versions.items():
            err = float((fn(a, b) - want).abs().max())
            if err > K1_ATOL:
                raise AssertionError(f"{name} {shape}: |diff| {err}")
        iters = 200 if a.numel() < 1_000_000 else 50
        bound_ms, bound_by = k1_bound(shape)
        for turn, name in enumerate(order):
            fn, per_call = versions[name]
            call = lambda: fn(a, b)  # noqa: E731
            m = {"ms": profiled_device_ms(call, iters, "ssim_window",
                                          per_call),
                 "event_ms": cuda_ms(call, iters),
                 "host_us": host_us(call, iters)}
            row = {"shape": list(shape), "version": name, "turn": turn,
                   **m, "bound_ms": bound_ms, "bound_by": bound_by,
                   "share": bound_ms / m["ms"]}
            if name == "current":
                row["plan"] = launch_plan(*shape, sms, per_sm)._asdict()
            rows.append(row)
            log(f"{name:8s} {shape} device_us={m['ms'] * 1e3:.2f} "
                f"event_us={m['event_ms'] * 1e3:.2f} "
                f"host_us={m['host_us']:.2f} bound_us={bound_ms * 1e3:.2f}"
                f" ({bound_by}) share={row['share']:.3f}")
    result = {"card": smi, "sms": sms, "ctas_per_sm": per_sm,
              "against": args.against, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
