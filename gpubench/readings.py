"""The compared numbers of one cell over many seeds, in one process: the
program's (the readings a limit's lower end is set from) and the
control's (the reference in TF32 in the program's place, whose least
reading sets the upper end).  Each seed makes its own inputs and runs a
short window at the cell's own size and load; the kernels build once.

  python3 gpubench/readings.py --workload <cell> --seconds 6 \
      --program 12 --control 3 [--seed0 N] [--out readings.jsonl]
"""

import argparse
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from gpubench.harness import main as harness  # noqa: E402
from gpubench.harness import spec as spec_mod  # noqa: E402
from gpubench.harness.reference import Control  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--program", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seed0", type=int, default=2_500_000_003)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    spec = spec_mod.Spec()
    config = spec.config(spec.workload(args.workload)["config"])
    sink = open(args.out, "a") if args.out else None
    plan = ([("program", i) for i in range(args.program)]
            + [("control", i) for i in range(args.control)])
    for who, i in plan:
        seed = args.seed0 + 104729 * i
        system = (Control("cuda:0", float(config["target_ssim"]))
                  if who == "control" else None)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            rc = harness.run(args.workload, seed, args.seconds, False,
                             time.perf_counter(), system=system)
        lines = buf.getvalue().strip().splitlines()
        line = json.loads(lines[-1]) if lines else None
        checks = line and {k: v["value"] for k, v in line["checks"].items()}
        print(f"{who} seed {seed} rc={rc} correct={line and line['correct']}"
              f" attempted={line and line['attempted']} {checks} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if sink:
            sink.write(json.dumps({"workload": args.workload, "who": who,
                                   "seed": seed, "rc": rc,
                                   "checks": checks}) + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
