"""Where the time of quality_search_spatial_sharded goes, on one CUDA card.

    python3 bench_sources/spatial_profile.py [--bands N] [--out FILE.txt]

A 12 MP portrait (chip_smoke.photo, 3024x4032) on the card as uint8, at
BALANCED's target, over N bands of cuda:0 (default 4) and unsharded
(chip_smoke.unsharded_search).  After a warm-up of both: CUDA-event ms
of each, in turns; the sharded call's host profile (cProfile, the 25
functions with the most cumulative time); and its device time by
kernel and its device busy share from torch.profiler (CUDA rows only).
Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from fennec_tpu_torch.parallel import batched as pb  # noqa: E402
from fennec_tpu_torch.parallel import mesh as pm  # noqa: E402


def event_ms(fn) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("spatial_profile: no CUDA device")
    out = []

    def say(msg: str) -> None:
        print(msg, flush=True)
        out.append(msg)

    say(f"card: {cs.nvidia_smi_line()}")
    one = torch.device("cuda", torch.cuda.current_device())
    n = args.bands
    mesh = pm.data_spatial_mesh(n, n, [one] * n)
    img = torch.from_numpy(cs.photo(3024, 4032, cs.SEED + 1500 + n)).to(one)
    target = 0.94
    runs = {"sharded": lambda: pb.quality_search_spatial_sharded(
                mesh, img, target),
            "unsharded": lambda: cs.unsharded_search(
                img[None].to(torch.float32), target)}
    for fn in runs.values():  # warm-up
        fn()
    times = {name: [] for name in runs}
    for name in ("unsharded", "sharded", "sharded", "unsharded") * 2:
        times[name].append(event_ms(runs[name]))
    say(f"event ms over {n} bands: " + ", ".join(
        f"{k}={[round(t, 3) for t in v]}" for k, v in times.items()))

    # Host timeline of one warm sharded call: every call of the functions
    # below, per thread, in ms from the call's start (no synchronise inside,
    # so a call that waits for the card shows as a long one).
    import threading
    import time

    from fennec_tpu_torch.engine import compress as tcomp
    from fennec_tpu_torch.ops import probe_recon_cuda as k2

    marks = []
    t0 = [0.0]
    patched = []

    def wrap(owner, name):
        inner = getattr(owner, name)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                marks.append((threading.current_thread().name, name,
                              (t - t0[0]) * 1e3,
                              (time.perf_counter() - t) * 1e3))
        setattr(owner, name, timed)
        patched.append((owner, name, inner))

    for owner, name in ((pb, "forward_dct"), (tcomp, "coef_planes"),
                        (tcomp, "band_inputs"), (tcomp, "band_box_device"),
                        (tcomp, "_dmat_on"),
                        (tcomp, "_box_down_plane"),
                        (k2.probe_recon, "prepare"), (tcomp, "bisect"),
                        (tcomp, "probe_luminance"), (tcomp, "ssim_window"),
                        (pb, "quantize_coefs"), (tcomp, "_search_targets"),
                        (pb._Shards, "move")):
        wrap(owner, name)
    torch.cuda.synchronize()
    t0[0] = time.perf_counter()
    runs["sharded"]()
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0[0]) * 1e3
    for owner, name, inner in patched:
        setattr(owner, name, inner)
    say(f"host timeline of one sharded call ({total:.3f} ms to the end of "
        f"the device's work): thread, function, start ms, ms")
    for thread, name, start, ms in sorted(marks, key=lambda m: m[2]):
        if ms > 0.05 or name not in ("move",):
            say(f"  {thread:16s} {name:18s} {start:9.3f} {ms:8.3f}")

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    runs["sharded"]()
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(25)
    say(text.getvalue())

    from torch.profiler import ProfilerActivity, profile

    for name in ("sharded", "unsharded"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            runs[name]()
            torch.cuda.synchronize()
        rows = [e for e in p.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        say(f"{name}: device busy {busy:.3f} ms (sum of CUDA rows)")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
            say(f"  {e.key[:70]:70s} {e.count:5d} "
                f"{e.self_device_time_total / 1e3:9.3f} ms")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
