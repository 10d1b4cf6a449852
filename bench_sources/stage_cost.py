"""The cost of the port's stages (utils/profiling.stage).

1. The host µs of one `with stage(name):` entry in three states: off (no
   timer, no profiler), with a StageTimer installed, and with a
   StageTimer and a running torch.profiler; the median of `--rounds`
   rounds of `--entries` entries each, beside an empty loop's.
2. With `--card`: warm compress_file calls of the photo12mp cell's files
   (the benchmark's generator and writer, 8 distinct 4032x3024 Q92
   files cycled) on cuda:0, `--calls` pairs of calls, each pair one file
   with and without a StageTimer installed, the first of the two
   alternating, each call on the host clock; the pairs' differences, and
   the timed calls' mean ms per stage; the
   process keeps its heap as the benchmark's runs do (gpubench/run.py's
   keep_heap).

  python3 bench_sources/stage_cost.py [--card] [--calls 200] [--out F.json]
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# gpubench/run.py sets the allocator (keep_heap) when loaded, before numpy
# and torch allocate anything.
_spec = importlib.util.spec_from_file_location(
    "gpubench_run", os.path.join(ROOT, "gpubench", "run.py"))
_run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_run)

import torch  # noqa: E402

from fennec_tpu_torch.utils import profiling  # noqa: E402


def entry_us(entries: int, rounds: int) -> dict:
    """Median µs per iteration of an empty loop and of a loop of stage()
    entries in each state."""

    def loop_empty():
        t = time.perf_counter()
        for _ in range(entries):
            pass
        return time.perf_counter() - t

    def loop_stage():
        stage = profiling.stage
        t = time.perf_counter()
        for _ in range(entries):
            with stage("s"):
                pass
        return time.perf_counter() - t

    def off():
        return loop_stage()

    def timer():
        with profiling.use_timer(profiling.StageTimer()):
            return loop_stage()

    def timer_profiler():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            return timer()

    timer_profiler()  # the profiler's first start is slow
    states = {"empty_loop": loop_empty, "off": off, "timer": timer,
              "timer_profiler": timer_profiler}
    times = {k: [] for k in states}
    for _ in range(rounds):
        for k, fn in states.items():
            times[k].append(fn() / entries * 1e6)
    return {k: {"median_us": statistics.median(v), "min_us": min(v),
                "max_us": max(v)} for k, v in times.items()}


def card_calls(calls: int, seed: int) -> dict:
    """Warm compress_file of the photo12mp cell's files, with and without
    a StageTimer, in turns."""
    import fennec_tpu_torch as T
    from gpubench.harness import jpeg, plain
    from gpubench.harness.photo import photos

    dev = torch.device("cuda:0")
    with open(os.path.join(ROOT, "gpubench", "configs",
                           "photo12mp.json")) as f:
        c = json.load(f)
    w, h, q = int(c["width"]), int(c["height"]), int(c["input_quality"])
    tmp = tempfile.mkdtemp(prefix="stage-cost-")
    paths = []
    imgs = photos(8, w, h, seed, dev, float(c["fine_noise"]))
    for i in range(imgs.shape[0]):
        levels = plain.quantize(plain.forward(imgs[i, ..., :3], "float64"),
                                q)
        paths.append(os.path.join(tmp, f"in{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(jpeg.write(levels, w, h, q, None))
    del imgs
    out = os.path.join(tmp, "out.jpg")
    opts = T.Options()  # the cell's options are the defaults

    split = profiling.StageTimer()  # the timed calls' stages, summed

    def call(path: str, timed: bool) -> float:
        t = time.perf_counter()
        if timed:
            with profiling.use_timer(split):
                T.compress_file(None, path, out, opts, device=dev)
        else:
            T.compress_file(None, path, out, opts, device=dev)
        return (time.perf_counter() - t) * 1e3

    for k in range(16):  # warm every shape and file
        call(paths[k % 8], k % 2 == 1)
    split.totals.clear()
    split.counts.clear()
    ms = {"off": [], "timer": []}
    diffs = []  # timer - off, over each pair
    for j in range(calls):
        # Pair j: one file in both states, the first state alternating.
        first = j % 2 == 1
        for timed in (first, not first):
            ms["timer" if timed else "off"].append(call(paths[j % 8], timed))
        diffs.append(ms["timer"][-1] - ms["off"][-1])
    out_d = {}
    for key, v in (*ms.items(), ("pair_diff", diffs)):
        qs = statistics.quantiles(v, n=4)
        out_d[key] = {"n": len(v), "median_ms": statistics.median(v),
                      "q1_ms": qs[0], "q3_ms": qs[2],
                      "mean_ms": statistics.fmean(v)}
    out_d["stage_ms_per_call"] = {name: 1e3 * t / calls
                                  for name, t in split.totals.items()}
    return out_d


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--entries", type=int, default=20000)
    p.add_argument("--rounds", type=int, default=25)
    p.add_argument("--card", action="store_true")
    p.add_argument("--calls", type=int, default=200)
    p.add_argument("--seed", type=int, default=2_718_281_829)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    res = {"torch": torch.__version__,
           "stage_entry": entry_us(args.entries, args.rounds)}
    if args.card:
        if not torch.cuda.is_available():
            print("stage_cost: --card needs a CUDA device", file=sys.stderr)
            return 2
        res["device"] = torch.cuda.get_device_name(0)
        res["compress_file"] = card_calls(args.calls, args.seed)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
