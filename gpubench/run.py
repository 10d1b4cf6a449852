"""Run one cell of the benchmark once and print its result's line.

  python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

See gpubench/harness/main.py.  Needs a CUDA card: without one it exits
with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import ctypes  # noqa: E402
import ctypes.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def keep_heap() -> None:
    """The process's allocator keeps what it frees: glibc serves every
    block from its heap (no mapping of its own, M_MMAP_MAX 0) and never
    hands the heap back (M_TRIM_THRESHOLD), so the 12 MP arrays each
    request allocates reuse pages already mapped instead of mapping and
    unmapping some hundreds of MB a request, whose cost swings with the
    host.  Set before numpy and torch allocate anything."""
    name = ctypes.util.find_library("c")
    if not name:
        return
    libc = ctypes.CDLL(name)
    if not hasattr(libc, "mallopt"):
        return
    m_trim_threshold, m_top_pad, m_mmap_max = -1, -2, -4
    libc.mallopt(m_mmap_max, 0)
    libc.mallopt(m_trim_threshold, 2**31 - 1)
    libc.mallopt(m_top_pad, 256 << 20)


keep_heap()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Build and kernel caches stay inside the checkout, at fixed paths.
CACHE = os.path.join(ROOT, ".gpubench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

from gpubench.harness.main import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:], T_START))
