"""Time variants of K6 against the current source and the first K6, in
turns, on one CUDA card.

    python3 bench_sources/k6_variants.py [--check] [--out FILE.json]

Each variant is fennec_tpu_torch/csrc/coef_wire.cu with one design choice
changed (VARIANTS below: the tile's store, the stages of the ring), built
beside the current source and bench_sources/coef_wire_first.cu with the
same nvcc flags and called through the port's wrappers given its library
(chip_smoke.FirstK6 does the same for the first K6).  Every build is held
bit for bit to the plain version on chip_smoke.k6_cases; then on the
layouts of the 64 x 500x500 chunk and of 16 x 12 MP photos, as phase 17
builds them, every build runs twice in turn (current, first, variants,
then the reverse): its blocks must equal the current one's, and its
device µs per call (every kernel of the call, split by kernel) comes from
torch.profiler's rows (chip_smoke.k6_turn).  --check stops after the
k6_cases and the 500x500 chunk's check.  Prints one line per layout and
case and the card's name and power limit.
"""

from __future__ import annotations

import functools
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from fennec_tpu_torch.ops import coef_wire_cuda as k6  # noqa: E402

# The tile stored by every thread's 16-byte stores instead of one TMA bulk
# store (this kernel's first design).
THREAD_STORE = [
    ("  if (threadIdx.x == 0)\n"
     "    asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\");\n"
     "}", "}"),
    ("  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    asm volatile(\n"
     "        \"cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n\"\n"
     "        \"cp.async.bulk.commit_group;\\n\" ::\"l\"(out + b0 * 8),\n"
     "        \"r\"((unsigned)__cvta_generic_to_shared(tile)), \"r\"(n * 128)\n"
     "        : \"memory\");\n"
     "  }",
     "  __syncthreads();\n"
     "  for (int c = threadIdx.x; c < n * 8; c += kThreads)\n"
     "    out[b0 * 8 + c] = tile[c];")]
VARIANTS = [
    ("thread_store", THREAD_STORE),
    ("stages2", [("constexpr int kStages = 3;",
                  "constexpr int kStages = 2;")]),
]


def edited(name: str, edits) -> str:
    """The current source with `edits`, (old, new) each replaced once."""
    text = open(k6.SOURCE).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: edit not found once: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


class Build:
    """One library (built here unless given) and `wrappers` {layout:
    wrapper} that launch it."""

    def __init__(self, name: str, source: str, library=None) -> None:
        self.name = name
        self.library = library or k6.WireLibrary(
            source, os.path.join(k6.BUILD_DIR, f"libcoef_wire_{name}.so"))
        self.library.build(force=True)
        self.library.load()
        self.wrappers = {"coo": k6.UnpackCoo(self.library),
                         "i8": k6.UnpackI8(self.library),
                         "csr": k6.UnpackCsr(self.library)}


def build_all(variants: bool):
    """{name: Build}: the current source (K6's own library), the first K6
    and (variants) every variant, built at once."""
    os.makedirs(k6.BUILD_DIR, exist_ok=True)
    sources = {"current": k6.SOURCE,
               "first": os.path.join(HERE, cs.FIRST_K6_SOURCE)}
    for name, edits in VARIANTS if variants else ():
        path = os.path.join(k6.BUILD_DIR, f"k6_{name}.cu")
        with open(path, "w") as f:
            f.write(edited(name, edits))
        sources[name] = path
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(
            lambda item: Build(*item, k6.library if item[0] == "current"
                               else None), sources.items())))
    for name, build in builds.items():
        cs.log(f"built {name}: {build.library.build_log.strip()}")
    return builds


def sections_of(T, dev, tmp: str, big: bool):
    """{case: (layouts' sections, NT)}: the 64 x 500x500 chunk and (big)
    16 x 12 MP photos at Q92, built and checked as phase 17 does."""
    _, datas = cs.write_files500(T, dev, os.path.join(tmp, "wire500"), 64)
    out = {"500x500x64": cs.check_k6("500x500x64", datas, dev)[:2]}
    if big:
        base = cs.photo(4032, 3024, cs.SEED + 500)
        files = [T.encode_to_bytes(np.roll(base, (61 * i, 97 * i),
                                           axis=(0, 1)), T.JPEG, 92,
                                   device=dev) for i in range(16)]
        out["12mp_x16"] = cs.check_k6("12mp_x16", files, dev)[:2]
    return out


def main() -> int:
    import tempfile

    args = sys.argv[1:]
    check = "--check" in args
    out_path = args[args.index("--out") + 1] if "--out" in args else None
    if not torch.cuda.is_available():
        raise SystemExit("k6_variants: no CUDA device")
    import fennec_tpu_torch as T

    smi = cs.nvidia_smi_line()
    cs.log(f"card: {smi}")
    dev = torch.device("cuda", torch.cuda.current_device())
    builds = build_all(not check)
    for build in builds.values():
        cs.check_k6_cases(dev, build)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case, (sections, nt) in sections_of(T, dev, tmp,
                                                not check).items():
            if check:
                break
            iters = 50 if case == "500x500x64" else 20
            for layout, secs in sections.items():
                want = builds["current"].wrappers[layout](*secs)
                turns = {name: [] for name in builds}
                order = list(builds)
                kernel = {name: cs.K6_KERNEL[layout] for name in builds}
                kernel["first"] = cs.FIRST_K6_KERNEL[layout]
                for name in order + order[::-1]:
                    fn = functools.partial(builds[name].wrappers[layout],
                                           *secs)
                    if not torch.equal(fn(), want):
                        raise AssertionError(f"{case} {layout}: {name} "
                                             f"differs from the current")
                    t = cs.k6_turn(fn, kernel[name], iters)
                    turns[name].append({
                        "device_us": round(t["ms"] * 1e3, 2),
                        "event_us": round(t["event_ms"] * 1e3, 2),
                        "host_us": round(t["host_us"], 2),
                        "kernel_us": {k: round(v, 2) for k, v in
                                      (t["kernel_us"] or {}).items()}})
                bound = cs.k6_bound(layout, secs, nt)
                results[f"{case} {layout}"] = {"bound_us": bound * 1e3,
                                               "turns": turns}
                cs.log(f"k6 variants {case} {layout} bound_us="
                       f"{bound * 1e3:.2f}: {json.dumps(turns)}")
    cs.log(f"card: {smi}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
