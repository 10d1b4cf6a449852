// Kernel K5: optimal Huffman tables (ITU T.81 Annex K.2) on the device,
// CUDA C++ for sm_90a.
//
// Replaces fennec_tpu/ops/huffbuild.py:169, build_tables_device, an XLA
// program of the JAX package (no Pallas).  The plain PyTorch version, which
// the CPU runs and this kernel is held to bit for bit, is fennec_tpu_torch/
// ops/huffbuild.py (build_plain); the wrapper is ops/huffbuild_cuda.py.
//
// Input: K3a's (B, 544) int32 symbol histograms, per image dc-luma[16]
// dc-chroma[16] ac-luma[256] ac-chroma[256], and the standard tables
// (1, 2, 272) int32.  Output, per image:
//   tables (2, 272) int32: per class 16 DC then 256 AC entries, code << 5
//       | length, 0 for an absent symbol (K3b's tables);
//   a header of 208 int32 words: the scan's bits under those tables
//       (int64, words 0-1, from the raw histograms), the overflow flag
//       (word 2: some code size above 32 bits before the K.3 limit, where
//       the host builder raises), nvals (3-6), the DHT BITS lists (7-70,
//       tables [dc-luma, dc-chroma, ac-luma, ac-chroma]), the DHT VALS as
//       bytes (71-206: dc-luma[16] dc-chroma[16] ac-luma[256]
//       ac-chroma[256], canonical order, zero-padded) and a zero pad word.
//       A flagged image gets the standard tables, the bits under them and
//       zero specs: K3b still codes its batch, and the host redoes the
//       image alone, which raises the builder's error.
//
// Semantics, tie-break for tie-break those of the host builder
// (fennec_tpu/native/entropy.cpp fennec_optimal_spec_one): the reserved
// symbol has frequency 1 at index 256 (a DC table is padded to 257
// symbols, so that it orders above every real symbol as at index 16 in
// the host builder); an empty class codes symbol 0; each merge takes v1,
// the largest index among the least-frequent live chains, and v2, the
// largest among the least of the rest; K.3's redistribution of lengths
// above 16; the canonical order (pre-limit code size, symbol).
//
// What bounds it on an H100.  Not bytes: 2,176 bytes of histograms in and
// about 3 KB out per image, under a microsecond for a 64-image chunk at
// 3.35 TB/s, and little arithmetic.  The bound is a dependent chain: a
// table of n live chains needs n - 1 merges, each of which needs the one
// before.  Images and tables are independent, so the batch only adds
// width; the image waits for its longest table.  The design keeps that
// chain to a few compares a merge on one lane and gives the rest of the
// work to the warp.
//
// The design: one CTA of 4 warps per image, one warp per table; a lane
// holds 9 symbols (s = lane + 32 k, k < 9).
//   1. Keys.  A live chain's key is frequency << 9 | (511 - s) (64-bit:
//      merged counts of a large image pass 2^31).  The keys are distinct;
//      K.2's loop pops the two least, a then b, and pushes the merged
//      chain's key a + (b with its index bits cleared).
//   2. One sort instead of a search per merge.  The merged keys come out
//      in ascending order: the merged frequencies never decrease, and when
//      two successive merges give equal frequencies all four chains were
//      equal, so the earlier merge's key (that of the smaller a) is the
//      smaller.  So K.2 is a two-queue walk: queue L the live leaves
//      sorted once, queue M the merged keys in creation order, each merge
//      the least two of at most four heads.  The warp compacts the live
//      keys (a ballot per slot) and sorts them in registers (a bitonic
//      network over the next power of two, shuffles across lanes); lane 0
//      walks the queues, a few dependent compares a merge, recording each
//      merge's two children.  (tests/test_torch_huffbuild.py holds a model
//      of this walk to the lockstep loop of ops/huffbuild.py.)
//   3. Code sizes.  The warp turns the children into parents, then finds
//      every merge's depth by pointer doubling (log2 of the depth rounds);
//      a leaf's code size is its parent's depth + 1, put back in symbol
//      order through shared memory.
//   4. The tail across the warp.  In each slot __match_any_sync groups the
//      symbols by code size (their rank in the canonical order, pre-limit
//      length then symbol, within the slot); counts per (slot, length)
//      and a sum over slots per lane give each symbol's rank among its
//      length, a warp scan each length's first position.  K.3 (Figure
//      K.3) runs only when a length above 16 exists, across the warp: a
//      ballot finds the longest shorter length with codes.  The reserved
//      symbol's slot is dropped by a ballot; the first position and first
//      code of each limited length are warp scans of the counts and of
//      count << (16 - length); a symbol's limited length is a 4-step
//      search over them by shuffles.
//   5. Writes.  The header is assembled in shared memory (VALS bytes
//      scattered there) and stored as whole words; the tables are stored
//      per slot, coalesced.
//   Integer arithmetic only; warp shuffles, ballots and match; no
//   tensor cores, TMA or clusters (there is nothing to move in bulk).
//   Built with -DK5_STAMPS, every warp records clock64() at each phase
//   boundary (fennec_huff_stamps), for chip_smoke.py --k5's split, and
//   fennec_huff_step_cycles times one dependent step of the walk (the
//   serial chain of K5's bound).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kSlots = 9;    // symbols per lane: ceil(257 / 32)
constexpr int kWarps = 4;    // tables per image
constexpr int kThreads = 32 * kWarps;
constexpr int kHist = 544;   // histogram columns per image
constexpr int kTable = 272;  // table entries per class: 16 DC, 256 AC
constexpr int kHdr = 208;    // header words per image
constexpr int kHdrOverflow = 2;
constexpr int kHdrNvals = 3;
constexpr int kHdrBits16 = 7;
constexpr int kHdrVals = 71;
constexpr int kLive = 257;   // at most: 256 symbols and the reserved one
constexpr int kQueue = 264;  // a queue and two reads past its end
constexpr u64 kEnd = ~0ull;  // above every key
constexpr unsigned kFull = 0xffffffffu;

#ifdef K5_STAMPS
// clock64() of lane 0 at each phase boundary, after the warp meets; the
// last slot holds the table's merge count.
constexpr int kStampImgs = 64;
constexpr int kStamps = 12;
__device__ long long k5_stamps[kStampImgs][kWarps][kStamps];
#define K5_STAMP(i)                                               \
  do {                                                            \
    __syncwarp();                                                 \
    if (lane == 0 && img < kStampImgs)                            \
      k5_stamps[img][warp][i] = clock64();                        \
  } while (0)
#define K5_MERGES(n)                                              \
  do {                                                            \
    if (lane == 0 && img < kStampImgs)                            \
      k5_stamps[img][warp][kStamps - 1] = (n);                    \
  } while (0)
#else
#define K5_STAMP(i) ((void)0)
#define K5_MERGES(n) ((void)0)
#endif

// Sorts the 32 E keys v ascending, lane holding elements lane * E + r: a
// bitonic network, strides below E inside a lane, the rest by shuffles.
template <int E>
__device__ __forceinline__ void bitonic_sort(u64 (&v)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= E) {
        const bool lower = (lane & (stride / E)) == 0;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const u64 o = __shfl_xor_sync(kFull, v[r], stride / E);
          const bool up = ((lane * E + r) & size) == 0;
          const bool less = o < v[r];
          v[r] = (lower == up) == less ? o : v[r];
        }
      } else {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & stride) == 0) {
            const bool up = ((lane * E + r) & size) == 0;
            const u64 a = v[r], b = v[r + stride];
            const bool swap = (b < a) == up;
            v[r] = swap ? b : a;
            v[r + stride] = swap ? a : b;
          }
        }
      }
    }
  }
}

// keys[0, n) distinct, into sorted[0, n), n <= 32 E.
template <int E>
__device__ __forceinline__ void sort_keys(const u64* keys, u64* sorted,
                                          int n, int lane) {
  u64 v[E];
#pragma unroll
  for (int r = 0; r < E; ++r)
    v[r] = lane * E + r < n ? keys[lane * E + r] : kEnd;
  bitonic_sort<E>(v, lane);
#pragma unroll
  for (int r = 0; r < E; ++r)
    if (lane * E + r < n) sorted[lane * E + r] = v[r];
}

__device__ __forceinline__ int scan_excl(int v, int lane) {
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += o;
  }
  return inc - v;
}

__global__ void __launch_bounds__(kThreads)
    huff_build_kernel(const int* __restrict__ hist,
                      const int* __restrict__ std_tables,
                      int* __restrict__ tables, int* __restrict__ header) {
  __shared__ u64 s_keys[kWarps][kQueue];    // live keys, then queue M
  __shared__ u64 s_leaf[kWarps][kQueue];    // queue L: the keys sorted
  __shared__ unsigned s_kids[kWarps][kLive];  // each merge's children
  __shared__ short s_up[kWarps][2 * kLive];  // parent merge of each node
  __shared__ short s_dist[kWarps][kLive];  // a merge's distance to anc
  __shared__ int s_cnt[kWarps][8 * 32];  // (slot, length) counts
  __shared__ short s_size[kWarps][kLive + 31];  // code size by symbol
  __shared__ int s_over[kWarps];
  __shared__ long long s_bits[kWarps];
  __shared__ int s_hdr[kHdr];

  const int img = blockIdx.x;
  const int warp = threadIdx.x >> 5;  // 0 dc-luma 1 dc-chroma 2 ac-luma 3
  const int lane = threadIdx.x & 31;
  const bool is_dc = warp < 2;
  const int cls = warp & 1;
  const int nsym = is_dc ? 16 : 256;
  const unsigned below = (1u << lane) - 1;
  const int* h = hist + (size_t)img * kHist + (is_dc ? 16 * cls
                                                     : 32 + 256 * cls);
  K5_STAMP(0);
  for (int i = threadIdx.x; i < kHdr; i += kThreads) s_hdr[i] = 0;

  int raw[kSlots];  // the symbol's count as K3a gave it
  bool any = false;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    raw[k] = s < nsym ? h[s] : 0;
    any |= raw[k] != 0;
  }
  // An empty class codes symbol 0; the reserved symbol is s = 256.
  const bool empty = !__any_sync(kFull, any);
  K5_STAMP(1);

  // Compact the live keys in symbol order, then sort them.
  u64* keys = s_keys[warp];
  u64* leaf = s_leaf[warp];
  int n = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    const long long f = (k == 8 && lane == 0) || (k == 0 && lane == 0 && empty)
                            ? 1 : raw[k];
    const bool live = f > 0;
    const unsigned m = __ballot_sync(kFull, live);
    if (live)
      keys[n + __popc(m & below)] = ((u64)f << 9) | (unsigned)(511 - s);
    n += __popc(m);
  }
  __syncwarp();
  if (n <= 32) {
    sort_keys<1>(keys, leaf, n, lane);
  } else if (n <= 64) {
    sort_keys<2>(keys, leaf, n, lane);
  } else if (n <= 128) {
    sort_keys<4>(keys, leaf, n, lane);
  } else if (n <= 256) {
    sort_keys<8>(keys, leaf, n, lane);
  } else {
    sort_keys<16>(keys, leaf, n, lane);
  }
  __syncwarp();
  // Queue M reuses the live keys' array: every slot reads as the end
  // until a merge fills it; two reads past queue L's end do too.
  for (int i = lane; i < kQueue; i += 32) keys[i] = kEnd;
  if (lane < 2) leaf[n + lane] = kEnd;
  __syncwarp();
  K5_STAMP(2);

  // K.2 as a two-queue walk on lane 0.  Node ids: the leaves by sorted
  // position, 0..n-1, then merge k as n + k; merge k's two children go
  // to s_kids[k], then the warp turns them into each node's parent merge
  // (s_up).  The last merge, n - 2, is the root, its own parent.
  unsigned* kids = s_kids[warp];
  if (lane == 0) {
    int li = 0, mi = 0;
    for (int k = 0; k < n - 1; ++k) {
      const u64 l0 = leaf[li], l1 = leaf[li + 1];
      const u64 m0 = keys[mi], m1 = keys[mi + 1];
      const bool a_leaf = l0 < m0;
      const u64 a = a_leaf ? l0 : m0;
      const u64 x = a_leaf ? l1 : l0;  // the heads once a is taken
      const u64 y = a_leaf ? m0 : m1;
      const bool b_leaf = x < y;
      const u64 b = b_leaf ? x : y;
      kids[k] = (unsigned)(a_leaf ? li : n + mi) |
                (unsigned)(b_leaf ? li + a_leaf : n + mi + !a_leaf) << 16;
      keys[k] = a + (b & ~511ull);
      li += a_leaf + b_leaf;
      mi += 2 - a_leaf - b_leaf;
    }
  }
  __syncwarp();
  K5_STAMP(3);
  K5_MERGES(n - 1);
  short* up = s_up[warp];
  for (int k = lane; k < n - 1; k += 32) {
    up[kids[k] & 0xffff] = (short)k;
    up[kids[k] >> 16] = (short)k;
  }
  if (lane == 0) up[n + n - 2] = (short)(n - 2);
  __syncwarp();

  // Code sizes.  Each merge's depth by pointer doubling: dist[i] is the
  // distance from merge i to its ancestor anc[i] (the root is its own, at
  // distance 0); a round adds the ancestor's distance and jumps to its
  // ancestor, so ceil(log2(depth)) rounds reach the root.  A leaf's code
  // size is its parent's depth + 1, written back in symbol order.
  short* anc = up + n;
  short* dist = s_dist[warp];
  for (int i = lane; i < n - 1; i += 32) dist[i] = i != n - 2;
  __syncwarp();
  for (int round = 0; round < 9; ++round) {  // 2^9 > 256 merges
    short nd[8], na[8];
    bool more = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (32 * j >= n - 1) break;  // the warp leaves together
      const int i = lane + 32 * j;
      if (i < n - 1) {
        const int a = anc[i];
        nd[j] = dist[i] + dist[a];
        na[j] = anc[a];
        more |= na[j] != n - 2;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (32 * j >= n - 1) break;
      const int i = lane + 32 * j;
      if (i < n - 1) {
        dist[i] = nd[j];
        anc[i] = na[j];
      }
    }
    __syncwarp();
    if (!__any_sync(kFull, more)) break;
  }
  K5_STAMP(4);
  short* size = s_size[warp];
  for (int i = lane; i < kLive + 31; i += 32) size[i] = 0;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (32 * j >= n) break;
    if (lane + 32 * j < n)
      size[511 - (int)(leaf[lane + 32 * j] & 511)] =
          (short)(dist[up[lane + 32 * j]] + 1);
  }
  __syncwarp();
  int cs[kSlots];
  int over = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    cs[k] = size[lane + 32 * k];
    over |= cs[k] > 32;
  }
  K5_STAMP(5);
  over = __any_sync(kFull, over);
  if (lane == 0) s_over[warp] = over;
  __syncthreads();
  const bool flagged = s_over[0] | s_over[1] | s_over[2] | s_over[3];
  K5_STAMP(6);

  int entry[kSlots];  // the symbol's table entry
  const int base = cls * kTable + (is_dc ? 0 : 16);
  int nvals = 0, bits16 = 0;  // lane l: the DHT BITS count of length l + 1
  if (flagged) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      entry[k] = s < nsym ? std_tables[base + s] : 0;
    }
    K5_STAMP(7);
    K5_STAMP(8);
    K5_STAMP(9);
  } else {
    // Counts and ranks, slot by slot (real symbols lie in slots 0-7, a
    // DC table's in slot 0): __match_any_sync groups a slot's symbols by
    // code size, which ranks each within its group; the group's first
    // lane records the group's size in the (slot, length) counts, and
    // lane l turns length l + 1's counts into sums over earlier slots.
    int* cnt = s_cnt[warp];
    for (int i = lane; i < 8 * 32; i += 32) cnt[i] = 0;
    __syncwarp();
    int rank[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      rank[k] = 0;
      if (k == 0 || !is_dc) {
        const unsigned peers = __match_any_sync(kFull, cs[k]);
        rank[k] = __popc(peers & below);
        if (cs[k] > 0 && rank[k] == 0)
          cnt[32 * k + cs[k] - 1] = __popc(peers);
      }
    }
    __syncwarp();
    int count = 0;  // lane l: real symbols of code size l + 1
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = cnt[32 * k + lane];
      cnt[32 * k + lane] = count;
      count += c;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (cs[k] > 0) rank[k] += cnt[32 * k + cs[k] - 1];
    K5_STAMP(7);
    const int reserved = __shfl_sync(kFull, cs[8], 0);
    const int first_pos = scan_excl(count, lane);  // canonical positions
    nvals = __shfl_sync(kFull, first_pos + count, 31);
    int bins = count + (reserved == lane + 1);
    if (__any_sync(kFull, lane >= 16 && bins > 0)) {
      // K.3 (Figure K.3) across the warp, lane l holding length l + 1:
      // while length i has codes, two of them leave, one moves up to
      // i - 1, and the longest length j <= i - 2 with codes gives one
      // code to make two of length j + 1.
      for (int i = 32; i > 16; --i) {
        // Only length i's count falls, by two a step.
        const int steps = __shfl_sync(kFull, bins, i - 1);
        for (int t = 0; t < steps; t += 2) {
          const unsigned nz = __ballot_sync(kFull, bins > 0 && lane < i - 2);
          const int j = 32 - __clz(nz);
          bins += (lane == i - 1 ? -2 : 0) + (lane == i - 2 ? 1 : 0) +
                  (lane == j ? 2 : 0) - (lane == j - 1 ? 1 : 0);
        }
      }
    }
    // Drop the reserved symbol's slot from the longest length left.
    const unsigned have = __ballot_sync(kFull, lane < 16 && bins > 0);
    if (lane == 31 - __clz(have)) --bins;
    bits16 = lane < 16 ? bins : 0;
    // T.81 C.2 over the limited lengths: the first position of each
    // length, and its first code, the exclusive sum of 2^(16 - L) over
    // the positions before it, shifted down by 16 - L.
    const int first = scan_excl(bits16, lane);
    const int kraft = scan_excl(lane < 16 ? bits16 << (15 - lane) : 0, lane);
    const int code0 = lane < 16 ? kraft >> (15 - lane) : 0;
    K5_STAMP(8);
    uint8_t* vals = (uint8_t*)(s_hdr + kHdrVals) + (is_dc ? 16 * cls
                                                          : 32 + 256 * cls);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      const bool real = k < 8 && s < nsym && cs[k] > 0;
      const int pos = __shfl_sync(kFull, first_pos, real ? cs[k] - 1 : 0) +
                      (k < 8 ? rank[k] : 0);
      int l = 0;  // the last length (lane) whose first position <= pos
#pragma unroll
      for (int step = 8; step > 0; step >>= 1)
        if (__shfl_sync(kFull, first, l + step) <= pos) l += step;
      const int c = __shfl_sync(kFull, code0, l) + pos -
                    __shfl_sync(kFull, first, l);
      entry[k] = real ? (c << 5) | (l + 1) : 0;
      if (real) vals[pos] = (uint8_t)s;
    }
    K5_STAMP(9);
  }

  // The table entries, and the bits of the scan under them.
  int* out = tables + (size_t)img * 2 * kTable + base;
  long long bits = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    if (s < nsym) {
      out[s] = entry[k];
      bits += (long long)raw[k] * ((entry[k] & 31) + (is_dc ? s : s & 15));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bits += __shfl_xor_sync(kFull, bits, off);
  if (lane == 0) {
    s_bits[warp] = bits;
    s_hdr[kHdrNvals + warp] = nvals;
  }
  if (lane < 16) s_hdr[kHdrBits16 + 16 * warp + lane] = bits16;
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long total = s_bits[0] + s_bits[1] + s_bits[2] + s_bits[3];
    s_hdr[0] = (int)(unsigned)total;
    s_hdr[1] = (int)(total >> 32);
    s_hdr[kHdrOverflow] = flagged;
  }
  __syncthreads();
  int* hdr = header + (size_t)img * kHdr;
  for (int i = threadIdx.x; i < kHdr; i += kThreads) hdr[i] = s_hdr[i];
  K5_STAMP(10);
}

#ifdef K5_STAMPS
// fennec_huff_step_cycles' chains on lane 0.  The keys ascend with the
// index; `thr` (a launch argument, so nothing folds) splits them, and
// each link steps up or down by the compare's result.
__global__ void step_cycles_kernel(long long* out, int steps, u64 thr) {
  __shared__ u64 keys[kQueue];
  for (int i = threadIdx.x; i < kQueue; i += 32)
    keys[i] = (u64)i << 9 | (unsigned)(i * 37 & 511);
  __syncwarp();
  if (threadIdx.x != 0) return;
  int i = 7;
  long long t0 = clock64();
#pragma unroll 8
  for (int k = 0; k < steps; ++k) {
    const u64 v = keys[i];
    i = v < thr ? (i + 9) & 255 : (i + 3) & 255;
  }
  asm volatile("" ::"r"(i));  // the chain ends before the clock is read
  long long t1 = clock64();
  u64 v = thr + (unsigned)i;
  const u64 p = thr >> 3, q = thr >> 5;
  long long t2 = clock64();
#pragma unroll 8
  for (int k = 0; k < steps; ++k) v = v < thr ? v + p : v - q;
  asm volatile("" ::"l"(v));
  long long t3 = clock64();
  out[0] = (t1 - t0) / steps;
  out[1] = (t3 - t2) / steps;
  out[2] = i;
  out[3] = (long long)v;
}
#endif

}  // namespace

extern "C" {

const char* fennec_huff_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K5.  hist (nimg, 544) int32; std_tables (1, 2, 272) int32; tables
// (nimg, 2, 272) int32 and header (nimg, 208) int32, 8-byte aligned, both
// written in full.  One launch on `stream`; returns its cudaError_t.
int fennec_huff_build(const void* hist, int nimg, const void* std_tables,
                      void* tables, void* header, void* stream) {
  if (nimg <= 0) return (int)cudaErrorInvalidValue;
  huff_build_kernel<<<nimg, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)hist, (const int*)std_tables, (int*)tables, (int*)header);
  return (int)cudaGetLastError();
}

#ifdef K5_STAMPS
// The stamps of the last launch: (64, 4, 12) int64 into host memory.
int fennec_huff_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k5_stamps, sizeof(k5_stamps));
}

// The latency of the walk's dependent steps, in clock64() cycles a step
// over `steps` steps on one lane: out[0] a link (a shared-memory load of
// a 64-bit key whose index came from the last link's 64-bit compare and
// select), out[1] a 64-bit compare and select in registers on the last
// one's result; out[2-3] the chains' ends, so that neither is dropped.
int fennec_huff_step_cycles(long long* out, int steps) {
  long long* dev = nullptr;
  cudaError_t err = cudaMalloc(&dev, 4 * sizeof(long long));
  if (err != cudaSuccess) return (int)err;
  step_cycles_kernel<<<1, 32>>>(dev, steps, 128ull << 9);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaMemcpy(out, dev, 4 * sizeof(long long),
                     cudaMemcpyDeviceToHost);
  cudaFree(dev);
  return (int)err;
}

const char* fennec_huff_stamp_names() {
  return "start,loaded,sorted,merges,depths,sizes,flag_barrier,"
         "counts_ranks,scans_k3,codes,writes_header";
}
#endif

}  // extern "C"
