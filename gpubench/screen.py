"""Steadiness screen of one cell: two sets of runs of the same code with
the same seeds, each run a process of its own, and the spreads the
benchmark's bounds are held to.

  python3 gpubench/screen.py --workload <cell> --runs 3 --seconds 40 \
      [--seed0 N] [--prime] [--out screen.jsonl]

A spread is the distance between the first and third quartiles
(statistics.quantiles, n=4) over the median.  For each end-to-end
metric it prints each set's median and spread, the widest spread, the
mean of the two sets' spreads with each set's run farthest from its
median left out, the bound five times the widest spread would give
(at least 1 %, at most 25 %), and whether that mean is at most half of
it.  --prime runs the cell once first, uncounted, so that the builds
are done.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values) -> float:
    if len(values) < 2:
        return 0.0
    q1, med, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else 0.0


def trimmed(values) -> list:
    """The values without the one farthest from their median."""
    if len(values) < 3:
        return list(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def one_run(workload: str, seed: int, seconds: float, trace: int = 0):
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], capture_output=True, text=True, cwd=ROOT)
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return out.returncode, line, out.stderr[-2000:]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed0", type=int, default=3_000_000_001)
    p.add_argument("--prime", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sink = open(args.out, "a") if args.out else None
    if args.prime:
        rc, line, err = one_run(args.workload, args.seed0 - 1, 5)
        print(f"prime rc={rc} setup_s="
              f"{line and line['metrics']['setup_s']['value']}", flush=True)
    seeds = [args.seed0 + 7919 * i for i in range(args.runs)]
    sets = []
    for s in range(2):
        rows = []
        for seed in seeds:
            rc, line, err = one_run(args.workload, seed, args.seconds)
            rows.append(line)
            short = checks = None
            if line:
                short = {k: round(v["value"], 4)
                         for k, v in line["metrics"].items()}
                checks = {k: v["value"] for k, v in line["checks"].items()}
            print(f"set {s} seed {seed} rc={rc} correct="
                  f"{line and line['correct']} {short} checks={checks}",
                  flush=True)
            if line is None:
                print(err, flush=True)
            if sink:
                sink.write(json.dumps({"workload": args.workload, "set": s,
                                       "seed": seed, "rc": rc,
                                       "line": line}) + "\n")
                sink.flush()
        sets.append(rows)
    names = sorted({k for rows in sets for r in rows if r
                    for k in r["metrics"]})
    for name in names:
        per = [[r["metrics"][name]["value"] for r in rows
                if r and name in r["metrics"]] for rows in sets]
        if not all(per):
            continue
        widest = max(spread(v) for v in per)
        mean_trim = sum(spread(trimmed(v)) for v in per) / 2
        bound = min(0.25, max(0.01, 5 * widest))
        medians = [statistics.median(v) for v in per]
        verdict = "pass" if mean_trim <= bound / 2 else "FAIL"
        print(f"{name}: medians {medians} spreads "
              f"{[round(spread(v), 5) for v in per]} widest {widest:.5f} "
              f"mean-trimmed {mean_trim:.5f} bound(5x) {bound:.4f} screen "
              f"{verdict} medians moved {abs(medians[1] / medians[0] - 1):.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
