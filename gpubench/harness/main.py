"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result's line.

  python3 gpubench/run.py --workload <name> --seed <n> --seconds <s>
                          --trace <0|1>

With --trace 0 the line's metrics are the cell's end-to-end metrics;
with --trace 1 its per-layer metrics, read by gpubench/metrics/<name>.py
from a torch.profiler slice at the window's start and from the
program's stages and counters over the rest of the window, with
`breakdown`.  Every run compares
a sample of the window's results with the reference (reference.py) and
prints each number beside its limit, on standard error and as the
line's last key, "checks".
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Optional

import torch

from . import cells, spec as spec_mod, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "fennec_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Readings:
    """What a per-layer metric reads: the requests and images the window
    completed after its traced slice, the program's stage seconds and the
    batch counters over that part, and the traced slice's summary."""

    def __init__(self, driver: cells.Driver):
        self.requests = driver.readings_requests
        self.images = driver.readings_images
        self.stages = driver.stages
        self.counters = driver.counters
        self.trace = driver.summary

    def stage_ms_per_request(self, stage: str) -> Optional[float]:
        seconds = self.stages.get(stage)
        if seconds is None or not self.requests:
            return None
        return 1e3 * seconds / self.requests


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: Optional[str] = None, system=None,
        overrides: Optional[dict] = None, root: str = spec_mod.ROOT) -> int:
    """Run the cell once and print its line.  device None is the real
    run: it needs as many cards as the cell asks for and takes cuda:0.
    Tests pass a CPU device, a system (the control, or the program with
    a fault) and overrides of the configuration and the mix."""
    spec = spec_mod.Spec(root)
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for key, value in (overrides or {}).items():
        (traffic if key in traffic else config)[key] = value
    if device is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < int(cell["chips"]):
            print(f"gpubench: {workload} needs {cell['chips']} CUDA "
                  f"device(s); torch sees {cards}", file=sys.stderr)
            return 2
        device = "cuda:0"
    on_card = torch.device(device).type == "cuda"
    if system is None:
        system = cells.Program(device, config["options"])
    driver = spec.driver(traffic["entry"])(config, traffic, seed, device,
                                           system)
    try:
        driver.setup()
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        driver.warmup()
        if traced:
            trace.warm_up()
        setup_s = time.perf_counter() - t_start
        driver.measure(seconds, float(traffic["trace_seconds"]) if traced
                       else 0.0)
        found = forbidden_modules()
        if found:
            print(f"gpubench: loaded after the window: {found}",
                  file=sys.stderr)
            return 3
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        numbers = driver.judge()
    finally:
        driver.close()
    limits = config["limits"]
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in numbers.items()}
    correct = (driver.failed == 0 and len(driver.sample) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    if traced:
        readings = Readings(driver)
        for m in spec.per_layer(workload):
            value = spec.reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = driver.end_to_end()
        values["setup_s"] = setup_s
        for m in spec.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]) if on_card else 0,
           "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": driver.attempted,
            "failed": driver.failed, "metrics": metrics, "device": dev}
    if traced and driver.summary is not None:
        s = driver.summary
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        line["breakdown"] = {"device_ops": s.device_ops,
                             "idle_gaps": s.idle_gaps}
    line["card"] = power_limit() if on_card else "cpu"
    line["sampled"] = len(driver.sample)
    line.update(driver.notes)
    line["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"gpubench: loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    print(f"correct {correct}: {driver.failed} of {driver.attempted} "
          f"failed, {len(driver.sample)} judged", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} <= {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cli(argv, t_start: float) -> int:
    args = parse(argv)
    return run(args.workload, args.seed, args.seconds, bool(args.trace),
               t_start)
