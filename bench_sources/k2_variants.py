"""Time variants of kernel K2 against the current source and the first K2,
in turns, on one CUDA card.

    python3 bench_sources/k2_variants.py [--out FILE.json]

Each variant is csrc/probe_recon.cu with one or more text edits (VARIANTS
below), built beside the current source and the first K2
(bench_sources/probe_recon_first.cu) with the same nvcc flags.  At
12 MP 4:2:0 (Q30 and Q90), 1080p 4:2:0, the 64 x 500x500 chunk and
1080p 4:4:4, every build runs twice in turn: its luminance must equal
the first K2's (except the variant that drops the box sums, which
measures what they cost), and its device µs per call comes from
torch.profiler's CUDA rows (chip_smoke.profiled_per_call).  Prints one
line per shape and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from fennec_tpu_torch.engine import compress as C  # noqa: E402
from fennec_tpu_torch.ops import probe_recon_cuda as k2  # noqa: E402

DIVISION_SKIP = ("""    float x[8];
#pragma unroll
    for (int v = 0; v < 8; ++v)
      x[v] = __any_sync(0xffffffffu,
                        fabsf(c8[v]) >= __fmul_rn(0.25f, q8[v]))
                 ? requantize(c8[v], q8[v])
                 : 0.0f;""", """    float x[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) x[v] = requantize(c8[v], q8[v]);""")
# floorf (a conversion-pipe instruction) on the FP32 pipe instead: y plus
# 1.5 * 2^23 rounds it to an integer, less one where that went up.
FLOOR_ON_FP32 = [
    ("""// engine/compress._qd_plane for one coefficient: three roundings.""",
     """__device__ __forceinline__ float floor_fp(float y) {
  const float r = __fsub_rn(__fadd_rn(y, 12582912.0f), 12582912.0f);
  return r > y ? __fsub_rn(r, 1.0f) : r;
}

// engine/compress._qd_plane for one coefficient: three roundings."""),
    ("""  const float f = floorf(__fadd_rn(fabsf(s), 0.5f));""",
     """  const float f = floor_fp(__fadd_rn(fabsf(s), 0.5f));"""),
    ("""  return fminf(fmaxf(floorf(__fadd_rn(x, 0.5f)), 0.0f), 255.0f);""",
     """  return fminf(fmaxf(floor_fp(__fadd_rn(x, 0.5f)), 0.0f), 255.0f);""")]
# (name, edits, whether its luminance must equal the first K2's)
VARIANTS = [
    ("three_stages_two_ctas",
     [("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
      ("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)")],
     True),
    ("no_division_skip", [DIVISION_SKIP], True),
    ("floor_on_fp32", FLOOR_ON_FP32, True),
    ("no_box_sums",
     [("      box_pass<SUB>(p, u, cur.iy, cur.ix, cy0, cx0, rgb, ytab, xtab,",
       "      if (0) box_pass<SUB>(p, u, cur.iy, cur.ix, cy0, cx0, rgb, ytab, "
       "xtab,")],
     False),
]
CASES = [cs.K2_CASES[i] for i in (0, 1, 2, 3, 5)]


def build_variants(out_dir: str):
    """{name: (ProbeReconKernel, must equal the first K2)}, built at once."""
    source = open(k2.SOURCE).read()
    kernels = {"current": (k2.ProbeReconKernel(), True)}
    for name, edits, exact in VARIANTS:
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: edit does not apply: "
                                 f"{old[:60]!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"probe_recon_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        kernels[name] = (k2.ProbeReconKernel(
            path, os.path.join(k2.BUILD_DIR, f"libprobe_recon_{name}.so")),
            exact)
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        first = pool.submit(cs.FirstK2)
        list(pool.map(lambda kx: kx[0].build(force=True), kernels.values()))
        return kernels, first.result()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: no CUDA device")
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv else None
    smi = cs.nvidia_smi_line()
    dev = torch.device("cuda")
    kernels, first = build_variants(k2.BUILD_DIR)
    for name, (kernel, _) in kernels.items():
        regs = [line.split(":")[-1].strip() for line in
                kernel.build_log.splitlines() if "registers" in line]
        print(f"{name}: {regs}", flush=True)
    rows = {}
    for tag, w, h, n, sub, quality, _ in CASES:
        imgs = np.stack([cs.photo(w, h, cs.SEED + 2000 + 7 * k + w)
                         for k in range(n)])
        inp, _ = C.prepare_search(torch.from_numpy(imgs).to(dev).float(), sub)
        q = (torch.from_numpy(np.random.default_rng(cs.SEED).integers(
            1, 101, n)) if quality is None
            else torch.full((n,), quality, dtype=torch.int64)).to(dev)
        want = first(inp, q)
        row = {}
        for _turn in range(2):
            for name, (kernel, exact) in list(kernels.items()) + [
                    ("first", (first, True))]:
                inp.k2_state = None  # each build plans for its own occupancy
                run = lambda: kernel(inp, q)  # noqa: E731
                if name != "first" and exact and not torch.equal(run(), want):
                    raise AssertionError(f"{name} {tag}: not equal to the "
                                         f"first K2")
                ms, _ops = cs.profiled_per_call(run, 30, "probe_recon_kernel")
                row.setdefault(name, []).append(round(ms * 1e3, 2))
        rows[tag] = row
        print(f"{tag} device_us {json.dumps(row)}", flush=True)
    print(smi, flush=True)
    if out:
        with open(out, "w") as f:
            json.dump({"card": smi, "device_us": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
