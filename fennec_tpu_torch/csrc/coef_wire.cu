// Kernel K6: the coefficient batch path's compact upload layouts unpacked
// on the device, CUDA C++ for sm_90a.
//
// Replaces the XLA programs _coo_to_natural, _i8_zigzag_to_natural and
// _csr_to_slots of fennec_tpu/parallel/batched.py (:570, :542, :732; no
// Pallas).  The plain PyTorch version, which the CPU runs and this kernel
// is held to bit for bit, is fennec_tpu_torch/ops/coef_wire.py; the
// wrapper is ops/coef_wire_cuda.py.  Layouts and the exceptions' rules are
// described there.  Every entry writes the (B, NT, 64) int16 blocks in
// natural order, all of them, on one stream:
//
//   fennec_wire_coo  dc (B, NT) int8, pos / val (B, NT, R) uint8 / int8;
//   fennec_wire_i8   (B, NT, K) int8 in zigzag order;
//   fennec_wire_csr  dc, counts (B, NT) int8 / uint8, streams spos / sval
//                    (B, M): a scan launch first (one CTA per image: the
//                    pairs before each of its tiles), then the rebuild;
//
// then, when the chunk has exception rows (E > 0), one launch that sets
// them.  A call is so one to three kernel launches.
//
// What bounds it on an H100: bytes, 128 written a block against 2-64
// read.  A 64-image 500x500 chunk is 393 216 blocks, 50 MB of int16: 15 us
// at 3.35 TB/s.  The first K6 (bench_sources/coef_wire_first.cu), a warp
// per block in short-lived CTAs, stored at 0.6 TB/s: every warp's chain of
// load, shared scatter and store was exposed.  This design keeps the
// stores streaming:
//
//   A persistent tile engine.  The grid is the CTAs the card holds at once
//   (its SMs, read once per device, times the occupancy); each CTA walks
//   tiles of kTile = 64 consecutive blocks (8 KB of output) of the
//   flattened B x NT (CSR: of one image, whose stream row holds its
//   pairs), and loads the zigzag table once.
//
//   Staged, wide reads.  A tile's wire is a few contiguous byte spans (COO
//   dc, pos and val; int8 its K-byte rows; CSR dc, counts and the pairs
//   from the tile's first to its last).  Each span is copied into shared
//   memory as the aligned 16-byte chunks that cover it (cp.async), so any
//   base address works: a row slice of a chunk need not be aligned, and a
//   chunk that holds one byte of a span lies inside its allocation.  A
//   ring of three stages keeps the next two tiles' bytes in flight while
//   one is built; CSR loads the bounds of a tile's pairs one tile earlier
//   still, so no global load waits between two builds.
//
//   Built in shared memory, stored whole.  int8 is a gather: natural
//   index n takes the wire's byte at zigzag position inv[n] < K, else 0,
//   eight to a thread's 16-byte store, no zero pass and no scatter.  COO
//   and CSR zero the tile with 16-byte stores (DC written in the same
//   pass), scatter the pairs with every thread (CSR finds a pair's block
//   by a binary search of the tile's block starts), and leave as one TMA
//   bulk store that drains while the CTA builds the next tile.
//
//   The exceptions after the rebuild, in a launch of their own on the same
//   stream: persistent warps over units of 128 rows of one image, a unit
//   past the image's live rows (exc_n) skipped at the cost of one load,
//   the rows in any order.  One launch with a grid barrier was not taken:
//   its counter would need memory of its own per call (COO and int8 get no
//   scratch, and calls on different streams run at once).  The pass's
//   2-byte stores land on 32-byte sectors that the rebuild wrote and L2
//   has mostly let go, likely a read and a write of the sector each:
//   PERF.md names the pass as what keeps COO from half its bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kTile = 64;            // blocks per tile
constexpr int kThreads = 256;        // threads of a tile CTA
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;           // tiles of wire in shared memory
constexpr int kChunks = kTile * 8;   // 16-byte words of a tile's output
constexpr int kScanThreads = 1024;   // CSR's scan: one CTA per image
constexpr int kExcRows = 128;        // exception rows per warp unit
constexpr int kMaxPairs = kTile * 64;  // CSR pairs a stage holds

// Bytes of shared memory that hold the 16-byte chunks covering any span of
// n bytes: up to 15 before it and 15 after.
constexpr int cover(int n) { return (n + 30 + 15) / 16 * 16; }
static_assert(kTile <= 64 && kThreads % 8 == 0,
              "a tile's counts fit a warp's scan; a thread keeps its eight "
              "natural indices");

constexpr int kCooDc = 0, kCooPos = cover(kTile);
constexpr int kCooVal = kCooPos + cover(kTile * 63);
constexpr int kCooStage = kCooVal + cover(kTile * 63);
constexpr int kI8Stage = cover(kTile * 64);
constexpr int kCsrDc = 0, kCsrCnt = cover(kTile);
constexpr int kCsrPos = kCsrCnt + cover(kTile);
constexpr int kCsrVal = kCsrPos + cover(kMaxPairs);
constexpr int kCsrStage = kCsrVal + cover(kMaxPairs);

// The natural index of zigzag position k (fennec_tpu_torch/ops/dct.py
// ZIGZAG), and its inverse: the zigzag position of natural index n.
__constant__ unsigned char kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
__constant__ unsigned char kInverse[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

__device__ __forceinline__ void copy16(void* dst, uintptr_t src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kStages - 2 of this thread's groups are in flight:
// the oldest tile's copies have landed.
__device__ __forceinline__ void wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// The offset of byte lo of src within its 16-byte chunk: where the staged
// span starts in shared memory.
__device__ __forceinline__ int head(const void* src, long long lo) {
  return (int)(((uintptr_t)src + lo) & 15);
}

// Issues the copies of the 16-byte chunks of global memory that cover
// bytes [lo, hi) of src into dst (the CTA's threads share them); byte lo
// lands at dst + head(src, lo).
__device__ __forceinline__ void stage_span(unsigned char* dst,
                                           const void* src, long long lo,
                                           long long hi) {
  if (hi <= lo) return;
  const uintptr_t a = ((uintptr_t)src + lo) & ~(uintptr_t)15;
  const uintptr_t e = ((uintptr_t)src + hi + 15) & ~(uintptr_t)15;
  const int n = (int)((e - a) >> 4);
  for (int c = threadIdx.x; c < n; c += kThreads) copy16(dst + 16 * c,
                                                         a + 16 * c);
}

__device__ __forceinline__ void load_zigzag(unsigned char* zz) {
  if (threadIdx.x < 64) zz[threadIdx.x] = kZigzag[threadIdx.x];
}

// The first pass of a COO or CSR tile: its n blocks zeroed as 16-byte
// words, each block's DC in its first word.
__device__ __forceinline__ void zero_with_dc(int4* tile,
                                             const unsigned char* dc,
                                             int n) {
  for (int c = threadIdx.x; c < n * 8; c += kThreads) {
    int4 z = make_int4(0, 0, 0, 0);
    if ((c & 7) == 0) z.x = (int)(uint16_t)(int16_t)(int8_t)dc[c >> 3];
    tile[c] = z;
  }
}

// A COO or CSR tile leaves shared memory as one TMA bulk store, issued
// by thread 0 and drained while the CTA builds the next tile.  Before the
// tile's buffer is written again, thread 0 waits until that store has
// read it (the caller syncs after).
__device__ __forceinline__ void tile_free() {
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The build's shared-memory writes made visible to the bulk store, then
// the tile's n blocks stored.
__device__ __forceinline__ void store_tile(const int4* tile, int n,
                                           long long b0, int4* out) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        "cp.async.bulk.commit_group;\n" ::"l"(out + b0 * 8),
        "r"((unsigned)__cvta_generic_to_shared(tile)), "r"(n * 128)
        : "memory");
  }
}

// At the CTA's end: no copy in flight to or from its shared memory.
__device__ __forceinline__ void drain() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ── COO ────────────────────────────────────────────────────────────────

struct Coo {
  const int8_t* dc;
  const uint8_t* pos;
  const int8_t* val;
  int r;
  unsigned long long magic;  // ceil(2^32 / r): p / r as (p * magic) >> 32
  long long nblocks, tiles;
  int4* out;
};

__device__ __forceinline__ void stage_coo(const Coo& a, long long g,
                                          unsigned char* st) {
  const long long b0 = g * kTile;
  const long long b1 = min(b0 + kTile, a.nblocks);
  stage_span(st + kCooDc, a.dc, b0, b1);
  stage_span(st + kCooPos, a.pos, b0 * a.r, b1 * a.r);
  stage_span(st + kCooVal, a.val, b0 * a.r, b1 * a.r);
}

__global__ void __launch_bounds__(kThreads) coo_tile_kernel(const Coo a) {
  __shared__ __align__(16) unsigned char stage[kStages][kCooStage];
  __shared__ __align__(16) int4 tile[kChunks];
  __shared__ unsigned char zz[64];
  load_zigzag(zz);
  for (int s = 0; s < kStages - 1; s++) {
    const long long g = blockIdx.x + (long long)s * gridDim.x;
    if (g < a.tiles) stage_coo(a, g, stage[s]);
    commit();
  }
  int s = 0;
  for (long long g = blockIdx.x; g < a.tiles; g += gridDim.x) {
    wait_oldest();
    tile_free();
    __syncthreads();  // tile g's bytes landed; the last tile is stored
    const long long next = g + (long long)(kStages - 1) * gridDim.x;
    if (next < a.tiles) stage_coo(a, next, stage[(s + kStages - 1) % kStages]);
    commit();
    const unsigned char* st = stage[s];
    const long long b0 = g * kTile;
    const int n = (int)min((long long)kTile, a.nblocks - b0);
    zero_with_dc(tile, st + kCooDc + head(a.dc, b0), n);
    __syncthreads();
    const unsigned char* pos = st + kCooPos + head(a.pos, b0 * a.r);
    const signed char* val =
        (const signed char*)st + kCooVal + head(a.val, b0 * a.r);
    int16_t* blocks = (int16_t*)tile;
    for (int p = threadIdx.x; p < n * a.r; p += kThreads) {
      const int q = pos[p] & 63;
      if (q != 0) {
        const int j = (int)(((unsigned long long)p * a.magic) >> 32);
        blocks[j * 64 + zz[q]] = val[p];
      }
    }
    store_tile(tile, n, b0, a.out);
    s = (s + 1) % kStages;
  }
  drain();
}

// ── Dense int8 ─────────────────────────────────────────────────────────

struct I8 {
  const int8_t* in;
  int k;
  long long nblocks, tiles;
  int4* out;
};

__device__ __forceinline__ void stage_i8(const I8& a, long long g,
                                         unsigned char* st) {
  const long long b0 = g * kTile;
  const long long b1 = min(b0 + kTile, a.nblocks);
  stage_span(st, a.in, b0 * a.k, b1 * a.k);
}

// A gather: the thread's 16-byte word c of the tile holds natural
// indices 8 (c % 8) .. +8 of block c / 8; kThreads is a multiple of 8, so
// every word of a thread has the same eight zigzag positions, kept in
// registers.
__global__ void __launch_bounds__(kThreads) i8_tile_kernel(const I8 a) {
  __shared__ __align__(16) unsigned char stage[kStages][kI8Stage];
  int inv[8];
#pragma unroll
  for (int e = 0; e < 8; e++) inv[e] = kInverse[(threadIdx.x & 7) * 8 + e];
  for (int s = 0; s < kStages - 1; s++) {
    const long long g = blockIdx.x + (long long)s * gridDim.x;
    if (g < a.tiles) stage_i8(a, g, stage[s]);
    commit();
  }
  int s = 0;
  for (long long g = blockIdx.x; g < a.tiles; g += gridDim.x) {
    wait_oldest();
    __syncthreads();  // tile g's bytes landed; the last tile is read
    const long long next = g + (long long)(kStages - 1) * gridDim.x;
    if (next < a.tiles) stage_i8(a, next, stage[(s + kStages - 1) % kStages]);
    commit();
    const long long b0 = g * kTile;
    const int n = (int)min((long long)kTile, a.nblocks - b0);
    const signed char* wire =
        (const signed char*)stage[s] + head(a.in, b0 * a.k);
    for (int c = threadIdx.x; c < n * 8; c += kThreads) {
      const signed char* blk = wire + (c >> 3) * a.k;
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int lo = inv[e] < a.k ? blk[inv[e]] : 0;
        const int hi = inv[e + 1] < a.k ? blk[inv[e + 1]] : 0;
        w[e >> 1] = (unsigned)(uint16_t)lo | ((unsigned)(uint16_t)hi << 16);
      }
      a.out[b0 * 8 + c] = make_int4((int)w[0], (int)w[1], (int)w[2],
                                    (int)w[3]);
    }
    s = (s + 1) % kStages;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ── CSR ────────────────────────────────────────────────────────────────

// The sum of the bytes of src at [lo, hi), at most kTile of them, read as
// the aligned 16-byte chunks that cover them, all loads in flight at once;
// each 4-byte word's bytes outside the span masked, the rest summed by
// __dp4a.
__device__ __forceinline__ int span_sum(const uint8_t* src, long long lo,
                                        long long hi) {
  constexpr int kMost = (kTile + 30) / 16;  // chunks that may cover it
  const uintptr_t x0 = (uintptr_t)src + lo;
  const uintptr_t a = x0 & ~(uintptr_t)15;
  const int first = (int)(x0 - a), end = first + (int)(hi - lo);
  uint4 v[kMost];
#pragma unroll
  for (int i = 0; i < kMost; i++)
    v[i] = 16 * i < end ? __ldg((const uint4*)(a + 16 * i))
                        : make_uint4(0, 0, 0, 0);
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < kMost; i++) {
    const unsigned w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int at = 16 * i + 4 * k;
      const int f = min(max(first - at, 0), 4), l = min(max(end - at, 0), 4);
      const unsigned keep =
          (unsigned)(((1ull << (8 * l)) - 1) & ~((1ull << (8 * f)) - 1));
      sum = __dp4a(w[k] & keep, 0x01010101u, sum);
    }
  }
  return (int)sum;
}

// Pass 1, one CTA per image: base[img][t] = the image's pairs before its
// tile t (an exclusive scan of the tile sums), base[img][tiles] = all of
// them; rounds of kScanThreads tiles, a tile a thread.
__global__ void __launch_bounds__(kScanThreads)
    csr_scan_kernel(const uint8_t* __restrict__ counts, int nt, int tiles,
                    int* __restrict__ base) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int img = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* row = counts + (long long)img * nt;
  int* out = base + (long long)img * (tiles + 1);
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    const int c = t < tiles ? span_sum(row, (long long)t * kTile,
                                       min((long long)(t + 1) * kTile,
                                           (long long)nt))
                            : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += v;
      }
      warp_sum[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    if (t < tiles) out[t] = carry + (warp > 0 ? warp_sum[warp - 1] : 0) +
                            incl - c;
    carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[tiles] = carry;
}

struct Csr {
  const int8_t* dc;
  const uint8_t* counts;
  const uint8_t* spos;
  const int8_t* sval;
  long long m;
  int nt, tiles;  // tiles per image
  long long all;  // tiles of the chunk
  const int* base;
  int4* out;
};

// A tile's first pair and the next tile's in its image's stream row,
// loaded from pass 1's bases a tile before they are staged.
struct Bases {
  int lo, hi;
};

__device__ __forceinline__ Bases load_bases(const Csr& a, long long g) {
  if (g >= a.all) return {0, 0};
  const int* b = a.base + g / a.tiles * (a.tiles + 1) + g % a.tiles;
  return {b[0], b[1]};
}

// The tile's pairs [lo, hi), cut at M; the first kMaxPairs are staged.
struct PairSpan {
  long long lo, hi;
};

// Stages tile g's bytes and records its pair span in `span`.
__device__ __forceinline__ void stage_csr(const Csr& a, long long g,
                                          const Bases& bases,
                                          unsigned char* st, PairSpan* span) {
  const int img = (int)(g / a.tiles), t = (int)(g % a.tiles);
  const long long b0 = (long long)img * a.nt + (long long)t * kTile;
  const long long b1 = (long long)img * a.nt +
                       min((long long)(t + 1) * kTile, (long long)a.nt);
  stage_span(st + kCsrDc, a.dc, b0, b1);
  stage_span(st + kCsrCnt, a.counts, b0, b1);
  const PairSpan p = {min((long long)bases.lo, a.m),
                      min((long long)bases.hi, a.m)};
  if (threadIdx.x == 0) *span = p;
  const long long row = (long long)img * a.m;
  const long long hi = min(p.hi, p.lo + kMaxPairs);
  stage_span(st + kCsrPos, a.spos, row + p.lo, row + hi);
  stage_span(st + kCsrVal, a.sval, row + p.lo, row + hi);
}

__global__ void __launch_bounds__(kThreads) csr_tile_kernel(const Csr a) {
  __shared__ __align__(16) unsigned char stage[kStages][kCsrStage];
  __shared__ __align__(16) int4 tile[kChunks];
  __shared__ int start[64];  // each block's first pair; past n: INT_MAX
  __shared__ PairSpan span[kStages];
  __shared__ unsigned char zz[64];
  load_zigzag(zz);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = 0; s < kStages - 1; s++) {
    const long long g = blockIdx.x + (long long)s * gridDim.x;
    if (g < a.all) stage_csr(a, g, load_bases(a, g), stage[s], &span[s]);
    commit();
  }
  // The bases of the next tile to stage, loaded while a tile is built.
  Bases ahead = load_bases(a, blockIdx.x + (long long)(kStages - 1) *
                                               gridDim.x);
  int s = 0;
  for (long long g = blockIdx.x; g < a.all; g += gridDim.x) {
    wait_oldest();
    tile_free();
    __syncthreads();  // tile g's bytes landed; the last tile is stored
    const long long next = g + (long long)(kStages - 1) * gridDim.x;
    if (next < a.all) {
      const int to = (s + kStages - 1) % kStages;
      stage_csr(a, next, ahead, stage[to], &span[to]);
    }
    ahead = load_bases(a, next + gridDim.x);
    commit();
    const unsigned char* st = stage[s];
    const int img = (int)(g / a.tiles), t = (int)(g % a.tiles);
    const long long b0 = (long long)img * a.nt + (long long)t * kTile;
    const int n = min(kTile, a.nt - t * kTile);
    const unsigned char* cnt = st + kCsrCnt + head(a.counts, b0);
    zero_with_dc(tile, st + kCsrDc + head(a.dc, b0), n);
    if (warp == 0) {  // each block's first pair in the tile's span
      const int c0 = 2 * lane < n ? cnt[2 * lane] : 0;
      const int c1 = 2 * lane + 1 < n ? cnt[2 * lane + 1] : 0;
      int incl = c0 + c1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      start[2 * lane] = 2 * lane < n ? incl - c0 - c1 : INT_MAX;
      start[2 * lane + 1] = 2 * lane + 1 < n ? incl - c1 : INT_MAX;
    }
    __syncthreads();
    // Every thread takes pairs; a pair's block is the last whose first
    // pair is at or before it (empty blocks share the next one's start).
    const PairSpan p = span[s];
    const long long row = (long long)img * a.m;
    const int npairs = (int)(p.hi - p.lo);
    const int staged = min(npairs, kMaxPairs);
    const unsigned char* pos = st + kCsrPos + head(a.spos, row + p.lo);
    const signed char* val =
        (const signed char*)st + kCsrVal + head(a.sval, row + p.lo);
    int16_t* blocks = (int16_t*)tile;
    for (int q = threadIdx.x; q < npairs; q += kThreads) {
      int j = 0;
#pragma unroll
      for (int step = 32; step > 0; step >>= 1)
        if (start[j + step] <= q) j += step;
      int pq, v;
      if (q < staged) {
        pq = pos[q] & 63;
        v = val[q];
      } else {  // a span past kMaxPairs: counts past 63
        pq = a.spos[row + p.lo + q] & 63;
        v = a.sval[row + p.lo + q];
      }
      if (pq != 0) blocks[j * 64 + zz[pq]] = (int16_t)v;
    }
    store_tile(tile, n, b0, a.out);
    s = (s + 1) % kStages;
  }
  drain();
}

// ── The exceptions ─────────────────────────────────────────────────────

// Live rows (row < n[image]) with an offset inside the image's nt x width
// zigzag layout, set at their natural position.  A warp's unit is 128
// consecutive rows of one image, the rows of an image in any order; a
// unit past the image's live rows costs one load of its count.
__global__ void __launch_bounds__(kThreads)
    exceptions_kernel(const int* __restrict__ off,
                      const int16_t* __restrict__ val,
                      const int* __restrict__ n, int e, int nimg, int nt,
                      int width, int16_t* __restrict__ out) {
  __shared__ unsigned char zz[64];
  load_zigzag(zz);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  const int per = (e + kExcRows - 1) / kExcRows;  // units per image
  const long long units = (long long)nimg * per;
  const long long limit = (long long)nt * width;
  for (long long u = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       u < units; u += warps) {
    const int img = (int)(u / per);
    const int first = (int)(u % per) * kExcRows;
    const int live = min(max(n[img], 0), e);
    if (first >= live) continue;
    const long long row = (long long)img * e;
    int o[kExcRows / 32];
    int v[kExcRows / 32];
#pragma unroll
    for (int k = 0; k < kExcRows / 32; k++) {
      const int r = first + k * 32 + lane;
      o[k] = -1;
      v[k] = 0;
      if (r < live) {
        o[k] = off[row + r];
        v[k] = val[row + r];
      }
    }
#pragma unroll
    for (int k = 0; k < kExcRows / 32; k++) {
      if (o[k] >= 0 && o[k] < limit) {
        const long long b = (long long)img * nt + o[k] / width;
        out[b * 64 + zz[o[k] % width]] = (int16_t)v[k];
      }
    }
  }
}

// The most CTAs of `kernel` (`threads` each, static shared memory only)
// the current device holds at once, asked once per device.
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int threads, std::atomic<int>* cache,
                          int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int got = cache[dev].load(std::memory_order_relaxed);
  if (got == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return err;
    got = sms * (per_sm > 0 ? per_sm : 1);
    cache[dev].store(got, std::memory_order_relaxed);
  }
  *out = got;
  return cudaSuccess;
}

// The grid of a persistent kernel over `work` units: the resident CTAs,
// at most one a unit.
template <typename Kernel>
cudaError_t grid_of(Kernel kernel, std::atomic<int>* cache, long long work,
                    unsigned* grid) {
  int limit = 0;
  const cudaError_t err = resident_ctas(kernel, kThreads, cache, &limit);
  if (err != cudaSuccess) return err;
  *grid = (unsigned)(work < limit ? (work > 0 ? work : 1) : limit);
  return cudaSuccess;
}

int exceptions(const void* off, const void* val, const void* n, int e,
               int nimg, int nt, int width, void* out, cudaStream_t stream) {
  if (e == 0) return (int)cudaSuccess;
  static std::atomic<int> cache[64];
  const long long units =
      (long long)nimg * ((e + kExcRows - 1) / kExcRows);
  unsigned grid = 0;
  cudaError_t err = grid_of(exceptions_kernel, cache,
                            (units + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return (int)err;
  exceptions_kernel<<<grid, kThreads, 0, stream>>>(
      (const int*)off, (const int16_t*)val, (const int*)n, e, nimg, nt, width,
      (int16_t*)out);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* fennec_wire_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// COO: dc (nimg, nt) int8, pos / val (nimg, nt, r) uint8 / int8, the
// exceptions exc_off / exc_val (nimg, e) int32 / int16 and exc_n (nimg,)
// int32 (offsets into each image's nt x 64 zigzag layout); out (nimg, nt,
// 64) int16, 16-byte aligned, written in full.  The inputs may start at
// any address.  Returns the first cudaError_t.
int fennec_wire_coo(const void* dc, const void* pos, const void* val, int r,
                    int nimg, int nt, const void* exc_off,
                    const void* exc_val, const void* exc_n, int e, void* out,
                    void* stream) {
  if (nimg <= 0 || nt <= 0 || r < 1 || r > 63 || e < 0 || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  static std::atomic<int> cache[64];
  Coo a;
  a.dc = (const int8_t*)dc;
  a.pos = (const uint8_t*)pos;
  a.val = (const int8_t*)val;
  a.r = r;
  a.magic = ((1ull << 32) + r - 1) / r;
  a.nblocks = (long long)nimg * nt;
  a.tiles = (a.nblocks + kTile - 1) / kTile;
  a.out = (int4*)out;
  unsigned grid = 0;
  cudaError_t err = grid_of(coo_tile_kernel, cache, a.tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  coo_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return exceptions(exc_off, exc_val, exc_n, e, nimg, nt, 64, out,
                    (cudaStream_t)stream);
}

// Dense int8: in (nimg, nt, k) int8 in zigzag order; exceptions as for
// COO but with offsets into each image's nt x k layout.
int fennec_wire_i8(const void* in, int k, int nimg, int nt,
                   const void* exc_off, const void* exc_val,
                   const void* exc_n, int e, void* out, void* stream) {
  if (nimg <= 0 || nt <= 0 || k < 1 || k > 64 || e < 0 || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  static std::atomic<int> cache[64];
  I8 a;
  a.in = (const int8_t*)in;
  a.k = k;
  a.nblocks = (long long)nimg * nt;
  a.tiles = (a.nblocks + kTile - 1) / kTile;
  a.out = (int4*)out;
  unsigned grid = 0;
  cudaError_t err = grid_of(i8_tile_kernel, cache, a.tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  i8_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return exceptions(exc_off, exc_val, exc_n, e, nimg, nt, k, out,
                    (cudaStream_t)stream);
}

// The int32 scratch of fennec_wire_csr per image: each tile's first pair,
// then the image's pairs.
int fennec_wire_csr_tiles(int nt) { return (nt + kTile - 1) / kTile + 1; }

// CSR: dc (nimg, nt) int8, counts (nimg, nt) uint8, spos / sval (nimg, m)
// uint8 / int8 (image b's pairs in row b, block by block); scratch nimg *
// fennec_wire_csr_tiles(nt) int32; exceptions as for COO.  The scan, the
// rebuild, then the exceptions' launch.
int fennec_wire_csr(const void* dc, const void* counts, const void* spos,
                    const void* sval, long long m, int nimg, int nt,
                    void* scratch, const void* exc_off, const void* exc_val,
                    const void* exc_n, int e, void* out, void* stream) {
  if (nimg <= 0 || nt <= 0 || m < 0 || e < 0 || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  static std::atomic<int> cache[64];
  const int tiles = fennec_wire_csr_tiles(nt) - 1;
  csr_scan_kernel<<<nimg, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)counts, nt, tiles, (int*)scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Csr a;
  a.dc = (const int8_t*)dc;
  a.counts = (const uint8_t*)counts;
  a.spos = (const uint8_t*)spos;
  a.sval = (const int8_t*)sval;
  a.m = m;
  a.nt = nt;
  a.tiles = tiles;
  a.all = (long long)nimg * tiles;
  a.base = (const int*)scratch;
  a.out = (int4*)out;
  unsigned grid = 0;
  err = grid_of(csr_tile_kernel, cache, a.all, &grid);
  if (err != cudaSuccess) return (int)err;
  csr_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return exceptions(exc_off, exc_val, exc_n, e, nimg, nt, 64, out,
                    (cudaStream_t)stream);
}

}  // extern "C"
