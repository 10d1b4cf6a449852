"""Time variants of K4's bisection against the current source, in turns,
on one CUDA card, beside the step loop it replaced.

    python3 bench_sources/k4_variants.py [--out FILE.json]

Each variant is csrc/jpeg_emit.cu, or a whole source kept under
bench_sources/, with text edits (VARIANTS below), built beside the
current source with the same nvcc flags.  At the main path's
bisections of chip_smoke.bisect_cases (12 MP, 1080p, T2's 64 x 500x500,
1080p 4:4:4 and 16 x 12 MP), every build runs twice in turn (current,
variants, variants reversed, current): its (best_q, found) and table
must equal the current one's, and its device µs per bisection comes from
torch.profiler's CUDA rows (chip_smoke.profiled_per_call).  Also per
case: the current kernel at one step (what a step costs beyond the
launch and the barrier), and the step loop through K4's step (device µs
and operations, every CUDA row).  Prints one line per case and the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from fennec_tpu_torch.engine import size_search  # noqa: E402
from fennec_tpu_torch.ops import jpeg_emit_cuda as k3  # noqa: E402
from fennec_tpu_torch.ops.jpeg_emit import (  # noqa: E402
    layout_on,
    std_tables_on,
)

# A thread per block: thread j loads its block's natural rows, so that the
# 32 threads of a warp hold one coefficient position at once and may skip
# its division warp-wide where |c| < q / 4 in all 32 blocks.
ROWS_CODE = r'''// Zigzag position of natural index n = 8 r + c (c_position's entries, as a
// constant expression for fully unrolled code): anti-diagonal d = r + c,
// walked down the rows when d is odd and up them when it is even.
__host__ __device__ constexpr int zigzag_at(int n) {
  const int r = n / 8, d = r + n % 8;
  const int base = d < 8 ? d * (d + 1) / 2 : 64 - (15 - d) * (16 - d) / 2;
  return base + (d % 2 ? r - (d < 8 ? 0 : d - 7) : (d < 8 ? d : 7) - r);
}
static_assert(zigzag_at(1) == 1 && zigzag_at(8) == 2 && zigzag_at(16) == 3 &&
                  zigzag_at(2) == 5 && zigzag_at(56) == 35 &&
                  zigzag_at(55) == 61 && zigzag_at(62) == 62 &&
                  zigzag_at(63) == 63 && zigzag_at(39) == 54,
              "zigzag_at disagrees with c_position");

// Segment s0 of image b quantized at `qtab` (the step's two tables, in
// device memory) into `rows` in K3a's layout: thread j's block, natural
// row by natural row (two 16-byte loads each; each 32-byte sector of a
// block is read by one thread), its int16 values stored at their zigzag
// positions of row j.  Every thread of a warp holds the same coefficient
// position at once, so a position whose |c| < q / 4 in all 32 blocks (0
// however the division rounds: q / 4 is exact), as a photo's high
// frequencies mostly are at moderate qualities, skips quantize()'s IEEE
// division warp-wide; every other coefficient pays it.
__device__ __forceinline__ void stage_rows(const BisectArgs& a, int b, int s0,
                                           const float* qtab,
                                           unsigned char* rows) {
  const int j = threadIdx.x, g = s0 + j;
  const bool valid = g < a.src.nt;
  const int slot = valid ? __ldg(a.slot_row + g) : 0;
  const float4* src = reinterpret_cast<const float4*>(a.src.block(b, slot));
  const float* qt = qtab + (slot < a.src.ny ? 0 : 64);
  unsigned char* dst = rows + j * kRowBytes;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
    if (valid) {
      lo = src[2 * k];
      hi = src[2 * k + 1];
    }
    const float4 qlo = __ldg(reinterpret_cast<const float4*>(qt + 8 * k));
    const float4 qhi = __ldg(reinterpret_cast<const float4*>(qt + 8 * k + 4));
    const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float q[8] = {qlo.x, qlo.y, qlo.z, qlo.w,
                        qhi.x, qhi.y, qhi.z, qhi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool big = !(fabsf(c[e]) < __fmul_rn(0.25f, q[e]));
      const int v = __any_sync(kFull, big) ? quantize(c[e], q[e]) : 0;
      *reinterpret_cast<short*>(dst + 2 * zigzag_at(8 * k + e)) = (short)v;
    }
  }
}

'''
KERNEL = ("__global__ void __launch_bounds__(kThreads, 8)\n"
          "    size_bisect_kernel")
STAGE = ("        a.src.stage_segment(b_k, a.slot_row, s0, rows, map, "
         "qtab);")
ROWS = [(KERNEL, ROWS_CODE + KERNEL),
        (STAGE, "        stage_rows(a, b_k, s0, qtab, rows);")]
WARP_SKIP = "__any_sync(kFull, big) ? quantize(c[e], q[e]) : 0"
LANE_Q = ("            (short)quantize(c[e], luma ? q_luma[e] : "
          "q_chroma[e]);")
ASYNC = os.path.join(HERE, "bench_sources", "jpeg_emit_bisect_async.cu")
# (name, source: None for csrc/jpeg_emit.cu, text edits)
VARIANTS = [
    # The division skipped per lane where |c| < q / 4 (a warp divides
    # unless all 32 lanes skip).
    ("skip_per_lane", None,
     [(LANE_Q, "            (short)(fabsf(c[e]) < __fmul_rn(0.25f, luma ? "
               "q_luma[e] : q_chroma[e]) ? 0 : quantize(c[e], luma ? "
               "q_luma[e] : q_chroma[e]));")]),
    # A thread per block, the division skipped warp-wide, and not at all.
    ("thread_per_block_skip", None, ROWS),
    ("thread_per_block", None,
     ROWS + [(WARP_SKIP, "quantize(c[e], q[e])")]),
    # The blocks staged with cp.async, a block quantized into registers and
    # walked there (see the source's header), at one stage and two.
    ("async_registers", ASYNC, []),
    ("async_two_stages", ASYNC,
     [("constexpr int kStages = 1;", "constexpr int kStages = 2;"),
      ("__launch_bounds__(kThreads, 5)", "__launch_bounds__(kThreads, 3)")]),
]
CASES = ("12mp_420", "1080p_420", "t2_64x500_420", "1080p_444",
         "16x12mp_420")


def build_variants():
    """{name: EmitLibrary}, the current source's and every variant's,
    built at once."""
    libs = {"current": k3.EmitLibrary()}
    for name, base, edits in VARIANTS:
        text = open(base or k3.SOURCE).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: edit not found once: "
                                 f"{old[:60]!r}")
            text = text.replace(old, new)
        path = os.path.join(k3.BUILD_DIR, f"k4_{name}.cu")
        os.makedirs(k3.BUILD_DIR, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        libs[name] = k3.EmitLibrary(path, os.path.join(
            k3.BUILD_DIR, f"libk4_{name}.so"))
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(force=True), libs.values()))
    for name, lib in libs.items():
        lib.load()
        regs = [ln for ln in lib.build_log.splitlines() if "Used" in ln]
        cs.log(f"built {name}: {regs[-2] if len(regs) > 1 else regs}")
    return libs


def on(lib, fn):
    """fn with K4's wrappers on `lib`."""
    def run():
        saved = k3.library
        k3.library = lib
        try:
            return fn()
        finally:
            k3.library = saved
    return run


def main() -> int:
    out_path = None
    if len(sys.argv) == 3 and sys.argv[1] == "--out":
        out_path = sys.argv[2]
    elif len(sys.argv) != 1:
        raise SystemExit("usage: python3 bench_sources/k4_variants.py "
                         "[--out FILE.json]")
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: no CUDA device")
    import fennec_tpu_torch as T

    smi = cs.nvidia_smi_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_variants()
    big = T.codecs.decode_image(T.encode_to_bytes(
        cs.photo(4032, 3024, cs.SEED), T.JPEG, 92, device=dev), device=dev)
    steps = size_search.MAX_STEPS
    results = {}
    for tag, coefs, (target, lo, hi), ph, pw, sub in cs.bisect_cases(
            T, dev, big):
        if tag not in CASES:
            continue
        bounds = size_search._bounds(coefs, target, lo, hi)
        lay = layout_on(ph, pw, sub, dev)
        std = std_tables_on(dev)
        qt = size_search.quality_tables_on(dev)

        def call(n=steps):
            return k3.size_bisect(coefs, qt, lay, std, bounds, n)

        iters = 5 if tag.startswith("16x") else 20
        want = on(libs["current"], call)()
        times = {name: [] for name in libs}
        order = list(libs)
        for name in order + order[::-1]:
            got = on(libs[name], call)()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{tag}: variant {name} differs")
            ms, _ = cs.profiled_per_call(on(libs[name], call), iters,
                                         "size_bisect_kernel")
            times[name].append(round(ms * 1e3, 1))
        one_step, _ = cs.profiled_per_call(
            on(libs["current"], lambda: call(1)), iters, "size_bisect_kernel")
        loop_ms, loop_ops = cs.profiled_all_device(
            lambda: size_search.size_bisect_steps(coefs, ph, pw, sub, target,
                                                  lo, hi), iters)
        results[tag] = {"device_us": times, "one_step_us":
                        round(one_step * 1e3, 1),
                        "step_loop_device_us": round(loop_ms * 1e3, 1),
                        "step_loop_device_ops": loop_ops,
                        "active_steps": int((want[2] >= 0).sum())}
        cs.log(f"k4 variants {tag}: {json.dumps(results[tag])}")
        del coefs
    cs.log(f"card: {smi}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
