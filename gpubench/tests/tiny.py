"""Helpers of the benchmark's CPU tests: every cell at a tiny size on
the port's CPU path.

Run from the repository's root:
    python -m pytest gpubench/tests -q -o addopts=
"""

import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Tiny sizes for each configuration and mix.
TINY = {"photo12mp": {"width": 96, "height": 64, "distinct": 2, "check": 2,
                      "trace_seconds": 0.2}}
CELLS = ["photo12mp.file", "photo12mp.file_rotated"]


def run_cell(workload, seed=20261018, seconds=0.4, traced=False,
             system=None, root=ROOT, overrides=None):
    """(exit code, the last line as a dict or None) of one CPU run."""
    from gpubench.harness import main

    config = workload.split(".")[0]
    ov = dict(TINY.get(config, {}))
    ov.update(overrides or {})
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main.run(workload, seed, seconds, traced, time.perf_counter(),
                      device="cpu", system=system, overrides=ov, root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
