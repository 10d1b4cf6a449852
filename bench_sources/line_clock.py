"""Run a command and print each line of its standard output prefixed by
the seconds since the command started, so that a script that prints as
it goes (chip_smoke.py) shows when each of its phases ended.

    python3 bench_sources/line_clock.py -- python3 chip_smoke.py

Two checkouts timed this way in one call (A, B, B, A) give each phase's
seconds on both sides.  Standard error passes through unstamped; the
exit code is the command's.
"""

from __future__ import annotations

import subprocess
import sys
import time


def main(argv) -> int:
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if not argv:
        raise SystemExit("usage: python3 bench_sources/line_clock.py -- "
                         "COMMAND [ARGUMENTS]")
    start = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True,
                            bufsize=1)
    for line in proc.stdout:
        sys.stdout.write(f"[{time.perf_counter() - start:9.2f}] {line}")
        sys.stdout.flush()
    return proc.wait()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
