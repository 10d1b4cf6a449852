"""Time variants of K5 against the current source and the first K5, in
turns, on one CUDA card.

    python3 bench_sources/k5_variants.py [--out FILE.json]

Each variant is fennec_tpu_torch/csrc/huffbuild.cu with one design choice
put back to an alternative that was tried (VARIANTS below: the sort, the
walk's stores and heads, the depths, the ranks, K.3), built beside the
current source and bench_sources/huffbuild_first.cu with the same nvcc
flags and called as chip_smoke.K5Build calls a build.  On the histograms of
chip_smoke's K5_TIMED cases (K3a's of photos at BALANCED and at Q95 /
Q100, and the 162-live family), every build runs twice in turn
(current, first, variants, then the reverse): its tables and header
must equal the current one's, and its device µs per launch comes from
torch.profiler's rows (chip_smoke.profiled_device_ms).  Prints one line
per case and the card's name and power limit.
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
from fennec_tpu_torch.ops import huffbuild_cuda as k5  # noqa: E402
from fennec_tpu_torch.ops import jpeg_emit_cuda as k3  # noqa: E402
from fennec_tpu_torch.ops.jpeg_emit import (  # noqa: E402
    layout_on,
    std_tables_on,
)

DISPATCH = """  if (n <= 32) {
    sort_keys<1>(keys, leaf, n, lane);
  } else if (n <= 64) {
    sort_keys<2>(keys, leaf, n, lane);
  } else if (n <= 128) {
    sort_keys<4>(keys, leaf, n, lane);
  } else if (n <= 256) {
    sort_keys<8>(keys, leaf, n, lane);
  } else {
    sort_keys<16>(keys, leaf, n, lane);
  }"""
SCAN = "__device__ __forceinline__ int scan_excl(int v, int lane) {"
# Each lane ranks its keys against all n: n steps of the warp, n^2
# compares in all.
RANK_SORT = [(SCAN, r"""template <int NJ>
__device__ __forceinline__ void rank_sort(const u64* keys, u64* sorted,
                                          int n, int lane) {
  u64 mine[NJ];
  int rank[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mine[j] = lane + 32 * j < n ? keys[lane + 32 * j] : kEnd;
    rank[j] = 0;
  }
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    const u64 x = keys[t];
#pragma unroll
    for (int j = 0; j < NJ; ++j) rank[j] += x < mine[j];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (lane + 32 * j < n) sorted[rank[j]] = mine[j];
}

""" + SCAN), (DISPATCH, r"""  switch ((n + 31) >> 5) {
    case 1: rank_sort<1>(keys, leaf, n, lane); break;
    case 2: rank_sort<2>(keys, leaf, n, lane); break;
    case 3: rank_sort<3>(keys, leaf, n, lane); break;
    case 4: rank_sort<4>(keys, leaf, n, lane); break;
    case 5: rank_sort<5>(keys, leaf, n, lane); break;
    case 6: rank_sort<6>(keys, leaf, n, lane); break;
    case 7: rank_sort<7>(keys, leaf, n, lane); break;
    case 8: rank_sort<8>(keys, leaf, n, lane); break;
    default: rank_sort<9>(keys, leaf, n, lane); break;
  }""")]
# A merge's key stored one merge late, after the next merge's loads, and
# forwarded to it from a register.
LATE_STORE = [("""    int li = 0, mi = 0;
    for (int k = 0; k < n - 1; ++k) {
      const u64 l0 = leaf[li], l1 = leaf[li + 1];
      const u64 m0 = keys[mi], m1 = keys[mi + 1];""", """    int li = 0, mi = 0;
    u64 last = kEnd;
    for (int k = 0; k < n - 1; ++k) {
      const u64 l0 = leaf[li], l1 = leaf[li + 1];
      u64 m0 = keys[mi], m1 = keys[mi + 1];
      if (mi == k - 1) m0 = last;
      if (mi == k - 2) m1 = last;
      if (k > 0) keys[k - 1] = last;"""),
              ("      keys[k] = a + (b & ~511ull);",
               "      last = a + (b & ~511ull);")]
WALK_START = ("    for (int k = 0; k < n - 1; ++k) {\n"
              "      const u64 l0 = leaf[li]")
WALK_END = """      li += a_leaf + b_leaf;
      mi += 2 - a_leaf - b_leaf;
    }"""
# Each queue's first four keys in registers: no load on the chain, a key
# of queue M made after its load forwarded in, the next two keys of each
# queue loaded for the merge after.
REGISTER_HEADS = [("  if (lane < 2) leaf[n + lane] = kEnd;",
                   "  if (lane < 4) leaf[n + lane] = kEnd;"),
                  ("WALK",
                   """    u64 l0 = leaf[0], l1 = leaf[1], l2 = leaf[2], l3 = leaf[3];
    u64 m0 = kEnd, m1 = kEnd, m2 = kEnd, m3 = kEnd;
    for (int k = 0; k < n - 1; ++k) {
      const bool a_leaf = l0 < m0;
      const u64 a = a_leaf ? l0 : m0;
      const u64 x = a_leaf ? l1 : l0;
      const u64 y = a_leaf ? m0 : m1;
      const bool b_leaf = x < y;
      const u64 b = b_leaf ? x : y;
      kids[k] = (unsigned)(a_leaf ? li : n + mi) |
                (unsigned)(b_leaf ? li + a_leaf : n + mi + !a_leaf) << 16;
      const u64 merged = a + (b & ~511ull);
      keys[k] = merged;
      const int took = a_leaf + b_leaf;
      const u64 w0 = mi == k ? merged : m0, w1 = mi + 1 == k ? merged : m1;
      const u64 w2 = mi + 2 == k ? merged : m2;
      const u64 w3 = mi + 3 == k ? merged : m3;
      const u64 n0 = took == 0 ? l0 : took == 1 ? l1 : l2;
      const u64 n1 = took == 0 ? l1 : took == 1 ? l2 : l3;
      m0 = took == 2 ? w0 : took == 1 ? w1 : w2;
      m1 = took == 2 ? w1 : took == 1 ? w2 : w3;
      l0 = n0;
      l1 = n1;
      li += took;
      mi += 2 - took;
      l2 = leaf[li + 2];
      l3 = leaf[li + 3];
      m2 = keys[mi + 2];
      m3 = keys[mi + 3];
    }""")]
DOUBLING_START = "  short* anc = up + n;"
DOUBLING_END = """    if (!__any_sync(kFull, more)) break;
  }
  K5_STAMP(4);"""
# Each leaf's parent chain walked to the root, a level a step.
CHAINS = [("DOUBLING", """  const int root = n - 2;
  int node[kSlots], depth[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    node[j] = lane + 32 * j < n ? up[lane + 32 * j] : root;
    depth[j] = 1;
  }
  for (int level = 1; level < n; ++level) {
    bool more = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      depth[j] += node[j] != root;
      node[j] = up[n + node[j]];
      more |= node[j] != root;
    }
    if (!__any_sync(kFull, more)) break;
  }
  __syncwarp();
  K5_STAMP(4);"""),
          ("          (short)(dist[up[lane + 32 * j]] + 1);",
           "          (short)depth[j];")]
MATCH_START = "    int* cnt = s_cnt[warp];"
MATCH_END = "      if (cs[k] > 0) rank[k] += cnt[32 * k + cs[k] - 1];"
# For each present code length, one ballot per slot.
BALLOT_RANKS = [("MATCH", """    unsigned present = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (cs[k] > 0) present |= 1u << (cs[k] - 1);
    present = __reduce_or_sync(kFull, present);
    int rank[8];
    int count = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) rank[k] = 0;
    for (unsigned left = present; left; left &= left - 1) {
      const int len = __ffs(left);
      int seen = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k == 0 || !is_dc) {
          const bool mine = cs[k] == len;
          const unsigned m = __ballot_sync(kFull, mine);
          rank[k] = mine ? seen + __popc(m & below) : rank[k];
          seen += __popc(m);
        }
      }
      if (lane == len - 1) count = seen;
    }""")]
K3_START = "      for (int i = 32; i > 16; --i) {\n        // Only length i's"
K3_END = """                  (lane == j ? 2 : 0) - (lane == j - 1 ? 1 : 0);
        }
      }"""
# Figure K.3 serially on lane 0, its counts in shared memory.
K3_LANE0 = [("  __shared__ int s_over[kWarps];",
             "  __shared__ int s_bins[kWarps][33];\n"
             "  __shared__ int s_over[kWarps];"),
            ("K3", """      s_bins[warp][lane + 1] = bins;
      if (lane == 0) s_bins[warp][0] = 0;
      __syncwarp();
      if (lane == 0) {
        int* b = s_bins[warp];
        for (int i = 32; i > 16; --i) {
          while (b[i] > 0) {
            int j = i - 2;
            while (b[j] == 0) --j;
            b[i] -= 2;
            b[i - 1] += 1;
            b[j + 1] += 2;
            b[j] -= 1;
          }
        }
      }
      __syncwarp();
      bins = s_bins[warp][lane + 1];""")]
VARIANTS = [("rank_sort", RANK_SORT), ("late_store", LATE_STORE),
            ("register_heads", REGISTER_HEADS),
            ("parent_chains", CHAINS), ("ballot_ranks", BALLOT_RANKS),
            ("k3_lane0", K3_LANE0)]
SPANS = {"WALK": (WALK_START, WALK_END),
         "DOUBLING": (DOUBLING_START, DOUBLING_END),
         "MATCH": (MATCH_START, MATCH_END), "K3": (K3_START, K3_END)}


def edited(name: str, edits) -> str:
    """The current source with `edits`: (old, new) replaced once, or
    (span, new) with SPANS[span], first line to last, replaced."""
    text = open(k5.SOURCE).read()
    for old, new in edits:
        if old in SPANS:
            start, end = SPANS[old]
            a, b = text.find(start), text.find(end)
            if a < 0 or b < a or text.count(start) != 1:
                raise SystemExit(f"variant {name}: span {old} not found")
            text = text[:a] + new + text[b + len(end):]
            continue
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: edit not found once: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants():
    """{name: K5Build}: the current source, the first K5 and every
    variant, built at once."""
    os.makedirs(k5.BUILD_DIR, exist_ok=True)
    sources = {"current": k5.SOURCE,
               "first": os.path.join(HERE, cs.FIRST_K5_SOURCE)}
    for name, edits in VARIANTS:
        path = os.path.join(k5.BUILD_DIR, f"k5_{name}.cu")
        with open(path, "w") as f:
            f.write(edited(name, edits))
        sources[name] = path
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        k3_build = pool.submit(k3.library.build, True)
        builds = dict(zip(sources, pool.map(
            lambda item: cs.K5Build(item[1], f"variant_{item[0]}"),
            sources.items())))
        k3_build.result()
    for name, build in builds.items():
        regs = [ln for ln in build.build_log.splitlines() if "Used" in ln]
        cs.log(f"built {name}: {regs[-1] if regs else build.build_log}")
    return builds


def histograms(dev):
    """{case: (B, 544) int32 histograms on dev} of chip_smoke.K5_TIMED:
    K3a's of the photos at BALANCED's usual qualities and at high
    quality, and the 162-live family."""
    out, images = {}, {}
    for tag, w, h, n, sub, q, seed in (cs.k3_cases(30, 30, 60)[:3]
                                       + cs.K5_HIGH):
        if tag not in cs.K5_TIMED:
            continue
        if (w, h, n, seed) not in images:
            images[(w, h, n, seed)] = [cs.photo(w, h, seed + k)
                                       for k in range(n)]
        packed = cs.quantized_stack(images[(w, h, n, seed)], q, sub, dev)
        mult = 16 if sub else 8
        out[tag] = k3.block_stats(packed, layout_on(
            h + (-h) % mult, w + (-w) % mult, sub, dev),
            std_tables_on(dev), want_hist=True).hist
    out["ac_162_live"] = torch.from_numpy(
        dict(cs.k5_families())["ac_162_live"]).to(dev)
    return out


def main() -> int:
    out_path = None
    if len(sys.argv) == 3 and sys.argv[1] == "--out":
        out_path = sys.argv[2]
    elif len(sys.argv) != 1:
        raise SystemExit("usage: python3 bench_sources/k5_variants.py "
                         "[--out FILE.json]")
    if not torch.cuda.is_available():
        raise SystemExit("k5_variants: no CUDA device")
    smi = cs.nvidia_smi_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    builds = build_variants()
    std = std_tables_on(dev)
    results = {}
    for tag, hist in histograms(dev).items():
        want = builds["current"](hist, std)
        times = {name: [] for name in builds}
        order = list(builds)
        for name in order + order[::-1]:
            got = builds[name](hist, std)
            if not (torch.equal(got.tables, want.tables)
                    and torch.equal(got.header, want.header)):
                raise AssertionError(f"{tag}: variant {name} differs")
            ms = cs.profiled_device_ms(lambda b=builds[name]: b(hist, std),
                                       50, "huff_build_kernel")
            times[name].append(round(ms * 1e3, 2))
        results[tag] = {"live": cs.live_symbols(hist.cpu().numpy()),
                        "device_us": times}
        cs.log(f"k5 variants {tag}: {json.dumps(results[tag])}")
    cs.log(f"card: {smi}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
