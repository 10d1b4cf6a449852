"""Time variants of K7 (csrc/decode_recon.cu) and K8's DCT
(csrc/forward_dct.cu) against the current sources and the first builds,
in turns, on one CUDA card.

    python3 bench_sources/k7k8_variants.py [--only NAME,...] [--out FILE.json]

Each variant is the current source with one design choice changed
(K7_VARIANTS and K8_VARIANTS below: the designs that lost, and builds
that measure), built beside the current sources and
bench_sources/{decode_recon,forward_dct}_first.cu with the same nvcc flags
and called through the port's wrapper classes given its library (as
chip_smoke.FirstK7 and FirstK8 do).  A variant marked exact must give the
current build's output bit for bit on every timed shape.  The others only
measure: an ablation takes a phase out, to see what the phase costs, and
"stamps" adds clock64() stamps at every phase boundary, printed as the
cycles a CTA spends in each phase, per warp.  The shapes are phase 18's:
K7 on the 12 MP 4:2:0 and 1080p 4:4:4 frames and a 64 x 500x500 chunk
(float32), and on the 12 MP frame at EXIF orientation 6 (the transposing
stores; a build without the oriented entry, the first K7, skips it),
K8's DCT on the 12 MP photo, 64 x 500x500 images and a 12 MP band.  Every
build runs twice at each shape (current, first, variants, then the
reverse); its device µs per call come from torch.profiler's rows of its
kernel.  --only keeps the named variants (the current and first builds
always run).  Prints one line per shape and the card's name and power
limit.
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
from fennec_tpu_torch.ops import decode_recon_cuda as k7  # noqa: E402
from fennec_tpu_torch.ops import forward_dct_cuda as k8  # noqa: E402

# Prefixed to a statement, skips it (the launch's nimg is never 0).
SKIP = "if (f.nimg > 0) {} else\n"

# Phase stamps (measuring builds, not designs): lane 0 of every warp adds
# the clock64() cycles between phase boundaries into g_stamps[warp][phase]
# (fennec_stamps reads them, fennec_stamps_zero clears them).
STAMP_DEFS = """
__device__ unsigned long long g_stamps[8 * 8];
#define STAMP(i) { const long long t_ = clock64(); st_acc[i] += t_ - st_last; \\
                   st_last = t_; }
"""
STAMP_ENTRIES = """
extern "C" int fennec_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
extern "C" int fennec_stamps_zero() {
  unsigned long long z[8 * 8] = {};
  return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
}
"""
STAMP_INIT = ("  int it = 0;\n",
              "  int it = 0;\n  unsigned long long st_acc[8] = {};\n"
              "  long long st_last = clock64();\n")
STAMP_HEAD = ("namespace {\n", "namespace {\n" + STAMP_DEFS)
STAMP_TAIL = ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + STAMP_ENTRIES)


def stamp_end(closing: str):
    """The edit that adds a warp's stamps into g_stamps after the tile
    loop, whose last line is `closing`."""
    return (closing + "\n  }\n}\n",
            closing + "\n  }\n  if (lane == 0)\n    for (int i = 0; i < 8; ++i)\n"
            "      atomicAdd(&g_stamps[warp * 8 + i], st_acc[i]);\n}\n")


K7_STAMPS = [
    STAMP_HEAD, STAMP_TAIL, STAMP_INIT,
    ("    bar_wait(&full[s], (uint32_t)(it / kStages) & 1);\n",
     "    bar_wait(&full[s], (uint32_t)(it / kStages) & 1);\n    STAMP(0)\n"),
    ("    __syncwarp();\n", "    __syncwarp();\n    STAMP(1)\n"),
    ("    __syncthreads();  // stage s converted, the k-major buffer read\n",
     "    STAMP(2)\n    __syncthreads();\n    STAMP(3)\n"),
    ("    __syncthreads();\n\n    // 4. Colour",
     "    STAMP(4)\n    __syncthreads();\n    STAMP(5)\n\n    // 4. Colour"),
    stamp_end("    __syncthreads();  // the pixel buffer read before the next "
              "conversion"),
    ("    __syncthreads();  // the pixel buffer read before the next "
     "conversion",
     "    STAMP(6)\n    __syncthreads();\n    STAMP(7)"),
]
K8_STAMPS = [
    STAMP_HEAD, STAMP_TAIL, STAMP_INIT,
    ("    bar_wait(&full[s], (uint32_t)(it / kStages) & 1);\n",
     "    bar_wait(&full[s], (uint32_t)(it / kStages) & 1);\n    STAMP(0)\n"),
    ("    consumers_sync();  // the samples written\n",
     "    STAMP(1)\n    consumers_sync();\n    STAMP(2)\n"),
    stamp_end("    consumers_sync();  // the samples read before the next "
              "conversion"),
    ("    consumers_sync();  // the samples read before the next conversion",
     "    STAMP(4)\n    consumers_sync();\n    STAMP(5)"),
]
K7_PHASES = ["wait", "convert", "product", "sync_a", "write", "sync_b",
             "colour", "sync_c"]
K8_PHASES = ["wait", "convert", "sync_a", "-", "product_store", "sync_b",
             "-", "-"]

# The barrier wait as written, and with a suspend-time hint (the thread
# may sleep up to the hint's ns before try_wait returns false).
BAR_TRY = "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
BAR_TRY_HINT = ("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, "
                "1000000;\\n")
# The shared-memory carveout asked for in prepare().
def carveout(kernel: str) -> str:
    return f"""  if (err == cudaSuccess)
    err = cudaFuncSetAttribute({kernel},
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
"""

# (name, exact, edits): edits are (old, new), each found once.
# K7's copies issued by warp 0's lanes (one each), and by thread 0 alone
# (the design's first form).
K7_ISSUE = """  int j = lane - 1, pre = 0;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= f.ncomp) break;
    const int hs = f.hs[c], vs = f.vs[c];
    if (j >= 0 && j < vs) {"""
K7_ISSUE_SERIAL = """  if (lane != 0) return;
  int pre = 0;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= f.ncomp) break;
    const int hs = f.hs[c], vs = f.vs[c];
    for (int j = 0; j < vs; ++j) {"""
# K8's copies issued by a producer warp outside the consumers' barriers,
# and by warp 0 between the conversion and the product (the producer warp
# idle): the design before the producer warp.
K8_PRODUCER = """    int i = 0;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
      const int s = i % kStages;
      if (i >= kStages) bar_wait(&empty[s], (uint32_t)(i / kStages - 1) & 1);
      issue(f, t, stages + s * kStageBytes, &full[s], lane);
    }
    return;
  }
"""
K8_WARP0_PROLOGUE = """    return;
  }
  if (warp == 0) {
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + (long long)s * gridDim.x;
      if (t < ntiles) issue(f, t, stages + s * kStageBytes, &full[s], lane);
    }
  }
"""
K8_CONSUMER_RELEASE = """    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with stage s
    consumers_sync();  // the samples written
"""
K8_WARP0_ISSUE = """    consumers_sync();  // the samples written
    if (warp == 0) {
      const long long next = t + (long long)kStages * gridDim.x;
      if (next < ntiles) {
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        issue(f, next, st, &full[s], lane);
      }
    }
"""
# K7's product over the warp's 64-bit mask at once (__ffsll), and as two
# 32-bit halves.
K7_MASK32 = """#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t m = live ? (half ? hi : lo) : 0u;
      while (m) {
        const int k = half * 32 + __ffs(m) - 1;
        m &= m - 1;"""
K7_MASK64 = """    {
      unsigned long long m =
          live ? ((unsigned long long)hi << 32) | lo : 0ull;
      while (m) {
        const int k = __ffsll((long long)m) - 1;
        m &= m - 1;"""

# K7's carveout, asked for each of its three kernels.
K7_CARVEOUT = """    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel_of(k), cudaFuncAttributePreferredSharedMemoryCarveout, 100);
"""
# K7's transposing colour pass: units of 8 rows by 4 columns (a warp store
# four 32-byte runs), of 16 rows by 2 columns (two 64-byte runs; lanes past
# an 8-row tile idle), or the identity's lanes (a pixel row a warp: each
# lane's store in another output row).
K7_COLS8 = (
    "  const int ng = (trows + 7) >> 3, units = ng * ((tcols + 3) >> 2);",
    "    const int ly = 8 * g + (lane & 7), lx = 4 * (u / ng) + (lane >> 3);")
K7_COLS16 = (
    "  const int ng = (trows + 15) >> 4, units = ng * ((tcols + 1) >> 1);",
    "    const int ly = 16 * g + (lane & 15), lx = 2 * (u / ng) + "
    "(lane >> 4);")

# (name, exact, edits): edits are (old, new), each found once.
K7_VARIANTS = [
    ("no_colour", False, [
        ("    if constexpr (kStore == kIdentity) {\n      if (f.out_f32)",
         "    " + SKIP + "    if constexpr (kStore == kIdentity) {\n"
         "      if (f.out_f32)")]),
    ("no_product", False, [
        ("      uint32_t m = live ? (half ? hi : lo) : 0u;",
         "      uint32_t m = 0u;")]),
    ("no_convert", False, [
        ("#pragma unroll\n    for (int q = 0; q < kWarpBlocks / 4; ++q) {",
         SKIP + "    for (int q = 0; q < kWarpBlocks / 4; ++q) {")]),
    ("stamps", False, K7_STAMPS),
    ("stages3", True, [("constexpr int kStages = 2;",
                        "constexpr int kStages = 3;")]),
    ("serial_issue", True, [(K7_ISSUE, K7_ISSUE_SERIAL),
                            ("    j -= vs;\n    pre += hs * vs;",
                             "    pre += hs * vs;")]),
    ("mask64", True, [(K7_MASK32, K7_MASK64)]),
    ("spin_hint", True, [(BAR_TRY, BAR_TRY_HINT)]),
    ("carveout_default", True, [(K7_CARVEOUT, "")]),
    ("cols16", True, list(zip(K7_COLS8, K7_COLS16))),
    ("rows_lanes", True, [
        ("  if constexpr (kStore == kTranspose)\n    colour_cols",
         "  if constexpr (false)\n    colour_cols")]),
]

K8_VARIANTS = [
    ("no_convert", False, [
        ("    if (f.sub) {\n      for (int i = tid;",
         "    " + SKIP + "    if (f.sub) {\n      for (int i = tid;")]),
    ("no_product", False, [
        ("    if (warp * kWarpBlocks < nblk) {",
         "    if (warp * kWarpBlocks < nblk && f.nimg < 0) {")]),
    ("stamps", False, K8_STAMPS),
    ("stages1", True, [("constexpr int kStages = 2;",
                        "constexpr int kStages = 1;")]),
    ("warp0_issue", True, [(K8_PRODUCER, K8_WARP0_PROLOGUE),
                           (K8_CONSUMER_RELEASE, K8_WARP0_ISSUE)]),
    ("spin_hint", True, [(BAR_TRY, BAR_TRY_HINT)]),
    ("carveout_default", True, [(carveout("fdct_kernel"), "")]),
    ("unroll16", True, [("#pragma unroll 8\n      for (int p = 0;",
                         "#pragma unroll 16\n      for (int p = 0;")]),
    # Tiles of at most 48 blocks (8 MCUs of 4:2:0, 16 of 4:4:4): six
    # warps' worth, none partly idle; the source unchanged.
    ("tile48", True, []),
]
# Variants launched with another tile bound than the wrapper's.
K8_TILE_BLOCKS = {"tile48": 48}


def edited(source: str, name: str, edits) -> str:
    """`source`'s text with `edits`, (old, new) each replaced once."""
    text = open(source).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: edit not found once: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def k7_build(name: str, source: str):
    kern = k7.DecodeReconKernel(source, os.path.join(
        k7.BUILD_DIR, f"libdecode_recon_{name}.so"))
    kern.build(force=True)
    kern.load()
    return kern


def k8_build(name: str, source: str, tile_blocks: int):
    lib = k8.K8Library(source, os.path.join(k8.BUILD_DIR,
                                            f"libforward_dct_{name}.so"))
    lib.tile_blocks = tile_blocks
    lib.build(force=True)
    lib.load()
    return k8.ForwardDct(lib)


def build_all(only):
    """({name: K7 build}, {name: K8 DCT entry}, {name: exact}), every build
    at once: the current sources, the first builds and the variants."""
    os.makedirs(k7.BUILD_DIR, exist_ok=True)
    jobs = {("k7", "current"): lambda: k7.decode_recon,
            ("k8", "current"): lambda: k8.forward_dct,
            ("k7", "first"): lambda: k7_build(
                "first_v", os.path.join(HERE, cs.FIRST_K7_SOURCE)),
            ("k8", "first"): lambda: k8_build(
                "first_v", os.path.join(HERE, cs.FIRST_K8_SOURCE),
                cs.FIRST_K8_TILE_BLOCKS)}
    exact = {("k7", "first"): True, ("k8", "first"): True}
    for kind, source, variants in (("k7", k7.SOURCE, K7_VARIANTS),
                                   ("k8", k8.SOURCE, K8_VARIANTS)):
        for name, is_exact, edits in variants:
            if only and name not in only:
                continue
            path = os.path.join(k7.BUILD_DIR, f"{kind}_{name}.cu")
            with open(path, "w") as f:
                f.write(edited(source, name, edits))
            exact[(kind, name)] = is_exact
            jobs[(kind, name)] = (
                (lambda n=name, p=path: k7_build(n, p)) if kind == "k7"
                else (lambda n=name, p=path: k8_build(
                    n, p, K8_TILE_BLOCKS.get(n, k8.TILE_BLOCKS))))
    k7.decode_recon.build(force=True)
    k7.decode_recon.load()
    k8.library.build(force=True)
    k8.library.load()
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    k7s = {n: b for (kind, n), b in done.items() if kind == "k7"}
    k8s = {n: b for (kind, n), b in done.items() if kind == "k8"}
    return k7s, k8s, exact


def k7_cases(T, dev):
    """{case: (call of a K7 build, kernel name)} at phase 18's shapes."""
    from fennec_tpu_torch.codecs import jpeg as J

    big = T.encode_to_bytes(cs.photo(4032, 3024, cs.SEED), T.JPEG, 92,
                            device=dev)
    mid = J.encode_jpeg(cs.photo(1920, 1080, cs.SEED + 3), 92, False,
                        device=dev)
    a12 = cs.k7_frame(big, dev)
    out = {"12mp_420": lambda kern, a=a12: kern.frame(*a),
           "1080p_444": lambda kern, a=cs.k7_frame(mid, dev): kern.frame(*a),
           "12mp_420_o6": lambda kern, a=a12: kern.frame(*a, 6)}

    datas = [T.encode_to_bytes(cs.photo(500, 500, cs.SEED + 900 + k), T.JPEG,
                               92, device=dev) for k in range(64)]
    blocks = torch.stack([torch.from_numpy(np.concatenate(
        J.decode_jpeg_to_coefs(d)[1])) for d in datas]).to(dev)
    hdr = J.parse_jpeg(datas[0])
    qt = torch.from_numpy(np.stack([hdr.qtables[0], hdr.qtables[1]])).to(
        dev)[None].expand(64, 2, 64).contiguous()
    out["64x500_f32"] = lambda kern: kern.batch(blocks, qt, 500, 500, True)
    return out


def k8_cases(T, dev):
    from fennec_tpu_torch.ops import resize as R
    from fennec_tpu_torch.ops.ssim import ssim_fast_dims

    big = T.encode_to_bytes(cs.photo(4032, 3024, cs.SEED), T.JPEG, 92,
                            device=dev)
    img = torch.from_numpy(T.codecs.decode_image(big, device=dev)).to(
        dev).to(torch.float32)[None]
    small = torch.stack([torch.from_numpy(cs.photo(500, 500, cs.SEED + k))
                         for k in range(64)]).to(dev).to(torch.float32)
    band = R.box_band(3024, ssim_fast_dims(4032, 3024)[1], 1512, 2268, 16)
    pix = img[:, band.start:band.stop]
    return {"12mp_420": lambda e: e(img, True),
            "64x500_420": lambda e: e(small, True),
            "band_12mp_420": lambda e: e(pix, True)}


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def stamps(build, call, phases) -> dict:
    """A measuring build's phase split of one call: {phase: cycles}, the
    mean over CTAs of lane 0's clock64() cycles, per warp (w0..w7)."""
    import ctypes

    lib = build.load() if hasattr(build, "frame") else build.library.load()
    lib.fennec_stamps.argtypes = [ctypes.c_void_p]
    lib.fennec_stamps_zero()
    call(build)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    lib.fennec_stamps(ctypes.addressof(buf))
    ctas = (build.ctas if hasattr(build, "frame") else build.library.ctas)(
        torch.device("cuda", torch.cuda.current_device()))
    return {ph: [round(buf[w * 8 + i] / ctas) for w in range(8)]
            for i, ph in enumerate(phases) if ph != "-"}


def run(builds, exact, kind, cases, kname: str, iters: int = 20) -> dict:
    results = {}
    phases = K7_PHASES if kind == "k7" else K8_PHASES
    for case, call in cases.items():
        if "stamps" in builds:
            split = stamps(builds["stamps"], call, phases)
            results[f"{kind} {case} stamps"] = split
            cs.log(f"{kind} stamps {case} (cycles a CTA, per warp): "
                   f"{json.dumps(split)}")
        want = call(builds["current"])
        order = [n for n in builds if not case.endswith("_o6") or hasattr(
            builds[n].load(), "fennec_decode_recon_oriented")]
        turns = {name: [] for name in order}
        for name in order + order[::-1]:
            fn = lambda b=builds[name]: call(b)  # noqa: E731
            if exact.get((kind, name), True) and not same(fn(), want):
                raise AssertionError(f"{kind} {case}: {name} differs from "
                                     f"the current build")
            turns[name].append(round(cs.profiled_device_ms(
                fn, iters, kname) * 1e3, 2))
        results[f"{kind} {case}"] = turns
        cs.log(f"{kind} variants {case} device µs: {json.dumps(turns)}")
    return results


def main() -> int:
    import fennec_tpu_torch as T

    args = sys.argv[1:]
    only = set(args[args.index("--only") + 1].split(",")) if (
        "--only" in args) else set()
    out_path = args[args.index("--out") + 1] if "--out" in args else None
    if not torch.cuda.is_available():
        raise SystemExit("k7k8_variants: no CUDA device")
    smi = cs.nvidia_smi_line()
    cs.log(f"card: {smi}")
    dev = torch.device("cuda", torch.cuda.current_device())
    k7s, k8s, exact = build_all(only)
    results = run(k7s, exact, "k7", k7_cases(T, dev), "decode_recon")
    results.update(run(k8s, exact, "k8", k8_cases(T, dev), "fdct_kernel"))
    cs.log(f"card: {smi}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
