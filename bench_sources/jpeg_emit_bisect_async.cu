// A design of K4's bisection (fennec_jpeg_size_bisect) kept only to be
// timed in turns against fennec_tpu_torch/csrc/jpeg_emit.cu by
// bench_sources/k4_variants.py: a segment's float32 blocks staged with
// cp.async (one stage, five CTAs an SM), a thread's block quantized from
// the stage into registers and walked there.  Same results, bit for bit;
// slower than the shipped design's synchronous loads at eight CTAs an SM
// (PERF.md).  Everything else is the shipped source as it was when this
// design was timed.
//
// Kernel K3: Huffman emission of baseline JPEG scans, and kernel K4, the
// size oracle's step and bisection, CUDA C++ for sm_90a.
//
// Replaces the XLA programs of fennec_tpu/ops/jpeg_emit.py that code a
// scan on the accelerator, scan_symbol_hist_device (:306) and
// emit_scan_device (:587), and serves the size oracle's bit count, the XLA
// programs component_scan_bits (:102) and scan_bits_device (:138) of
// fennec_tpu/ops/jpeg_size.py.  The plain PyTorch version, which the CPU
// runs and this kernel is held to bit for bit, is fennec_tpu_torch/ops/
// jpeg_emit.py; the wrapper is ops/jpeg_emit_cuda.py.
//
// Input: (B, NT, 64) int16 quantized blocks of one geometry, and the
// geometry's scan layout: for scan slot g (MCU order) the block's row, the
// row of the previous block of its component, and that block's slot.
//
//   K3a fennec_jpeg_block_stats: the scan's bits per image under the given
//       tables (one 64-bit integer atomic per CTA and image), and when
//       asked for the per-image (2, 16) DC and (2, 256) AC symbol
//       histograms and the bits of every block.
//   K3b fennec_jpeg_deposit: the scan's big-endian 32-bit words.  It finds
//       its own bit offsets: no pass before it, nothing between the two.
//   K4  fennec_jpeg_quantize_count: the size oracle's step in one launch.
//       K3a's totals from the unquantized float32 coefficients (y, cb, cr,
//       each (B, N, 64)) and a (B,) quality on the device: a block is
//       quantized where it is staged (c / q in IEEE division, then
//       sign * floor(|s| + 0.5) with the float32 add, operation for
//       operation ops/dct.quantize_blocks) and the int16 lands at its
//       zigzag position; everything after the staging is K3a.  The step
//       reads each coefficient once (256 B a block) and writes B totals:
//       no packed int16 tensor, no float32 temporaries.
//   K4  fennec_jpeg_size_bisect: the size oracle's whole bisection in one
//       launch, the counterpart of the XLA program size_bisect_device
//       (fennec_tpu/engine/size_search.py:61, a fori_loop of 7 steps over
//       scan_bits_device): for every image the highest quality in [lo0,
//       hi0] whose ceil(bits / 8) fits its target, and the (steps, B) table
//       of the bits counted at each step (-1 once the image's range is
//       empty).  Same (best_q, found) as the step loop over the entry
//       above, bit for bit (engine/size_search.size_bisect_steps).
//
// What bounds it on an H100.  Every block is 128 bytes read once: 11 us
// for a 12 MP 4:2:0 image at 3.35 TB/s.  The arithmetic is far below that
// when it follows the data: quantized photos are sparse (at the usual
// qualities a block holds a DC, a few low coefficients and an EOB), so
// the work that counts is finding the nonzeros.  A design that spreads a
// block's 64 positions over the lanes of a warp (ballots for the nonzero
// mask, a count of leading zeros for each run) was built and measured: it
// pays some 50 warp instructions a block whatever the block holds and ran
// slower than one thread per block (25 against 22 us for K3a at 12 MP, 77
// against 29 us for K3b).  So a thread keeps a block, and the design
// removes what made that slow instead:
//
//   Zeros are skipped eight at a time.  A CTA stages its segment of slots
//   in shared memory in zigzag order (coalesced 16-byte loads, the
//   permutation in the 2-byte stores); a thread reads its block as eight
//   16-byte vectors (row stride 144 bytes: conflict-free) and tests each
//   with one OR, so an all-zero block costs eight loads and eight tests,
//   not a walk of 63 dependent steps, and a warp diverges only inside a
//   group of eight positions that holds a nonzero.
//
//   The grid is sized to the card: CTAs loop over segments of 128 slots
//   (K3b: handed out by an atomic ticket), so 1080p spreads over all 132
//   SMs and 12 MP has no short last wave.
//
//   The previous block's DC comes from the staged rows when the CTA holds
//   it (all but 3 or 4 blocks of a segment), from device memory otherwise.
//
//   Histograms: a warp counts its DC symbols and each AC symbol of one
//   step with a match and a population count, and its EOBs with a ballot,
//   before one shared-memory add; a CTA adds its nonzero bins to the
//   image's with global integer atomics.  Counts do not depend on order.
//
//   K3b is one launch.  A thread counts its block's bits, the CTA scans
//   them, publishes the segment's total and looks back over the segments
//   before it (a 64-bit status word per segment: an aggregate, then an
//   inclusive prefix; a CTA that waits only waits for CTAs that took their
//   ticket before it and so already run).  Then each thread packs its
//   fields into a 64-bit accumulator and puts whole words into the CTA's
//   word buffer in shared memory, which the CTA shifts to its place and
//   stores coalesced; only the first and the last word of a segment, which
//   a neighbour may share, take a global atomicOr.  A segment too long for
//   the buffer (dense blocks at the highest qualities) writes its words
//   straight to device memory, each block's edge words with atomicOr.  Bit
//   ranges are disjoint, so OR is exact and the words do not depend on the
//   order CTAs run.  A word outside its image's range sets the flag word
//   after the buffer (the wrapper raises on it) instead of being written.
//
// K4's bisection.  What bounded the step loop was not the card: each of
// its 7 steps was a memset, a K4 launch and a dozen small torch kernels,
// hundreds of us of host time against a kernel of 12.5 us at 1080p.  One
// launch does the 7 steps; what bounds a step then is the 256 bytes of
// float32 a block (73 MB at 12 MP, read again at every step: one 12 MP
// image's coefficients, or a T2 chunk's, do not stay in the 50 MB L2)
// and issuing 64 quantizations a block.  The design:
//
//   One cooperative launch of persistent CTAs, as many as the card holds
//   at once, so every CTA is resident and a barrier across the grid ends:
//   a count and a generation word in the launch's own buffer (no
//   cooperative_groups grid sync, so no -rdc and no device runtime; two
//   bisections on streams of one card each have their own words, and a
//   cooperative launch starts only with room for its whole grid).  One
//   barrier a step.  Each step adds every CTA's bits of an image into the
//   image's cell of row `step` of the table with 64-bit integer atomics:
//   exact, whatever the order.
//
//   No state but the table.  After barrier s every CTA replays steps
//   0 .. s of each image it is about to stage from the table, with the
//   step loop's integer rule (lo <= hi, mid = floor((lo + hi) / 2),
//   ceil(bits / 8) <= target), so all agree on lo, hi and mid without a
//   second barrier or a serial section; the quality is mid clamped to
//   [0, 100], as the step entry clamps it.  An image whose range is empty
//   is not read again: its result can no longer change.
//
//   Balanced over what is left.  A CTA's segments of a step are its block
//   index, plus the grid, plus twice the grid, ...; so each CTA holds a
//   share of every image, and images that finished early leave no CTA
//   idle.  The active ones of a window of 128 are listed in order (a
//   ballot and a count per warp).
//
//   Loads in flight.  A segment's 128 blocks (32 KB), the step's tables
//   and the segment's layout are copied with cp.async; the stage is free
//   again once the blocks are quantized, so the next segment loads while
//   this one is walked, and five CTAs an SM keep five such loads going.
//   (Two stages at three CTAs an SM were slower: bench_sources/
//   k4_variants.py.)
//
//   A block is a thread's, in registers.  A thread quantizes its block from
//   the stage row by row into 32 registers in zigzag order (the positions
//   are constants of the unrolled code) and walks it there: no int16 rows
//   in shared memory, one barrier between the two (for the DCs the next
//   blocks need).  The stage's chunks are swizzled so that the row loads
//   are free of bank conflicts.
//
//   No division where it cannot matter.  |c| < q / 4 quantizes to 0 however
//   the division rounds (q / 4 is exact).  The 32 threads of a warp hold
//   the same coefficient position at once, so a position small in all 32
//   blocks, as a photo's high frequencies mostly are at moderate
//   qualities, skips the division warp-wide; every other coefficient keeps
//   quantize()'s IEEE division, float32 add and floor.
//
// Code tables are (1 or B, 2, 272) int32, code << 5 | length with lengths
// of at most 16 bits, as JPEG has them.  Everything is integer.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;           // and slots per segment
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 144;          // a staged block: 128 bytes + 16
constexpr int kBufWords = 1024;         // K3b's word buffer: 256 bits a block
constexpr int kTable = 16 + 256;
constexpr int kHist = 2 * 16 + 2 * 256;
constexpr int kZrl = 0xF0;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

// Zigzag position of each natural index.
__constant__ int c_position[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

__device__ __forceinline__ int bit_length(int v) {
  return v == 0 ? 0 : 32 - __clz(v < 0 ? -v : v);
}

__device__ __forceinline__ unsigned magnitude(int v, int size) {
  return (unsigned)(v >= 0 ? v : v + (1 << size) - 1);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ void load_tables(const int* __restrict__ tables,
                                            int* tab) {
  for (int i = threadIdx.x; i < 2 * kTable; i += kThreads) tab[i] = tables[i];
}

// Where a thread's part of a block goes when it is staged: eight lanes
// load one block as 16-byte vectors, lane `part` its natural row, and
// store each coefficient at its zigzag position.
struct StageMap {
  int part;
  int at[8];  // byte offsets of the row's coefficients in a staged block

  __device__ StageMap() : part(threadIdx.x & 7) {
#pragma unroll
    for (int e = 0; e < 8; ++e) at[e] = 2 * c_position[8 * part + e];
  }
};

// Stages slots s0 .. s0 + kThreads - 1 of one image in zigzag order.
__device__ __forceinline__ void stage(const int16_t* __restrict__ img,
                                      const int* __restrict__ slot_row,
                                      int nt, int s0, unsigned char* rows,
                                      const StageMap& map) {
  const int part = map.part;
  const int* at = map.at;
#pragma unroll 4
  for (int i = threadIdx.x; i < kThreads * 8; i += kThreads) {
    const int blk = i >> 3;
    const int g = s0 + blk;
    if (g >= nt) continue;
    const uint4 v = reinterpret_cast<const uint4*>(
        img + (size_t)slot_row[g] * 64)[part];
    unsigned char* dst = rows + blk * kRowBytes;
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *reinterpret_cast<unsigned short*>(dst + at[2 * e]) =
          (unsigned short)w[e];
      *reinterpret_cast<unsigned short*>(dst + at[2 * e + 1]) =
          (unsigned short)(w[e] >> 16);
    }
  }
}

// ops/dct.quantize_blocks for one coefficient: IEEE division, the
// float32 add of 0.5 (0.49999997f + 0.5f is 1.0f: roundf or rintf would
// give another block there), floor, the sign put back.  The intrinsics
// keep the compiler from contracting or reassociating anything.
__device__ __forceinline__ int quantize(float c, float q) {
  const float s = __fdiv_rn(c, q);
  const int f = (int)floorf(__fadd_rn(fabsf(s), 0.5f));
  return s < 0.0f ? -f : f;
}

// Where a kernel's blocks come from.  PackedSource: the (B, NT, 64) int16
// blocks K3a and K3b take.  CoefSource: the float32 coefficients of the
// three components, quantized on the way into shared memory at the
// image's luma or chroma table (K4); rows below ny are y, then cb, then
// cr, the packed order.
struct PackedSource {
  const int16_t* blocks;
  int nt;
  static constexpr bool kQuantizes = false;

  __device__ __forceinline__ void begin_image(int, float*) const {}

  __device__ __forceinline__ void stage_segment(int b,
                                                const int* __restrict__ slot_row,
                                                int s0, unsigned char* rows,
                                                const StageMap& map,
                                                const float*) const {
    stage(blocks + (size_t)b * nt * 64, slot_row, nt, s0, rows, map);
  }

  // The DC of a block the CTA has not staged.
  __device__ __forceinline__ int dc(int b, int row, const float*) const {
    return blocks[((size_t)b * nt + row) * 64];
  }
};

struct CoefSource {
  const float* y;             // (B, ny, 64)
  const float* cb;            // (B, nc, 64)
  const float* cr;            // (B, nc, 64)
  int ny, nc, nt;
  const float* qtables;       // (101, 2, 64) [luma, chroma] by quality
  const long long* quality;   // (B,), clamped to [0, 100] here
  static constexpr bool kQuantizes = true;

  __device__ __forceinline__ const float* block(int b, int row) const {
    if (row < ny) return y + ((size_t)b * ny + row) * 64;
    row -= ny;
    if (row < nc) return cb + ((size_t)b * nc + row) * 64;
    return cr + ((size_t)b * nc + (row - nc)) * 64;
  }

  // The image's two tables into shared memory (128 floats).
  __device__ __forceinline__ void begin_image(int b, float* qtab) const {
    long long q = quality[b];
    q = q < 0 ? 0 : (q > 100 ? 100 : q);
    for (int i = threadIdx.x; i < 128; i += kThreads)
      qtab[i] = qtables[q * 128 + i];
  }

  // As stage(): eight lanes load one block, lane `part` its natural row
  // (two 16-byte loads), quantize it and store each value at its zigzag
  // position.
  __device__ __forceinline__ void stage_segment(int b,
                                                const int* __restrict__ slot_row,
                                                int s0, unsigned char* rows,
                                                const StageMap& map,
                                                const float* qtab) const {
    const int part = map.part;
    float q_luma[8], q_chroma[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      q_luma[e] = qtab[8 * part + e];
      q_chroma[e] = qtab[64 + 8 * part + e];
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < kThreads * 8; i += kThreads) {
      const int blk = i >> 3;
      const int g = s0 + blk;
      if (g >= nt) continue;
      const int row = slot_row[g];
      const float4* src =
          reinterpret_cast<const float4*>(block(b, row)) + 2 * part;
      const float4 lo = src[0];
      const float4 hi = src[1];
      const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const bool luma = row < ny;
      unsigned char* dst = rows + blk * kRowBytes;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        *reinterpret_cast<short*>(dst + map.at[e]) =
            (short)quantize(c[e], luma ? q_luma[e] : q_chroma[e]);
    }
  }

  __device__ __forceinline__ int dc(int b, int row, const float* qtab) const {
    return quantize(block(b, row)[0], qtab[row < ny ? 0 : 64]);
  }
};

// Calls ac(run, size, value) for every nonzero AC coefficient of a block
// in zigzag order, its 64 int16 values eight to a 16-byte group, load(grp)
// giving group grp; returns true when the block ends in zeros (EOB).  A
// group of zeros costs one test.
template <typename Load, typename F>
__device__ __forceinline__ bool walk_zigzag(Load load, F ac) {
  int last = 0;
#pragma unroll
  for (int grp = 0; grp < 8; ++grp) {
    const uint4 v = load(grp);
    if ((v.x | v.y | v.z | v.w) == 0) continue;
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 8 * grp + e;
      if (k == 0) continue;  // the DC
      const int c = (e & 1) ? (int)w[e >> 1] >> 16
                            : (int)(short)(w[e >> 1] & 0xFFFFu);
      if (c == 0) continue;
      ac(k - last - 1, bit_length(c), c);
      last = k;
    }
  }
  return last != 63;
}

// A thread's block: its tables and the DC difference.
struct Block {
  const uint4* row;   // the staged block, zigzag order
  const int* dc_tab;
  const int* ac_tab;
  int cls;            // 0 luma, 1 chroma
  int diff;           // DC minus the previous block's of the component

  // g = s0 + threadIdx.x < nt.  The predecessor's DC is read from the
  // staged rows when its slot is in the segment, else from the source
  // (which quantizes it, if it quantizes).
  template <typename Source>
  __device__ __forceinline__ Block(const Source& src, int b, int g, int s0,
                                   int ny, const int* __restrict__ slot_row,
                                   const int* __restrict__ prev_row,
                                   const int* __restrict__ prev_slot,
                                   const unsigned char* rows, const int* tab,
                                   const float* qtab) {
    const unsigned char* mine = rows + threadIdx.x * kRowBytes;
    row = reinterpret_cast<const uint4*>(mine);
    cls = slot_row[g] >= ny ? 1 : 0;
    dc_tab = tab + cls * kTable;
    ac_tab = dc_tab + 16;
    const int ps = prev_slot[g];
    int pdc = 0;
    if (ps >= s0) {
      pdc = *reinterpret_cast<const short*>(rows + (ps - s0) * kRowBytes);
    } else if (ps >= 0) {
      pdc = src.dc(b, prev_row[g], qtab);
    }
    diff = *reinterpret_cast<const short*>(mine) - pdc;
  }

  // Calls ac(run, size, value) for every nonzero AC coefficient in zigzag
  // order and returns true when the block ends in zeros (EOB).
  template <typename F>
  __device__ __forceinline__ bool walk(F ac) const {
    return walk_zigzag([&](int grp) { return row[grp]; }, ac);
  }
};

template <bool kWantHist, bool kWantBits, typename Source>
__global__ void __launch_bounds__(kThreads)
    block_stats_kernel(const Source src, int nimg, int nt,
                       const int* __restrict__ slot_row,
                       const int* __restrict__ prev_row,
                       const int* __restrict__ prev_slot, int ny,
                       const int* __restrict__ tables, int tables_stride,
                       unsigned long long* __restrict__ totals,
                       int* __restrict__ hist, int* __restrict__ block_bits) {
  __shared__ __align__(16) unsigned char rows[kThreads * kRowBytes];
  __shared__ int tab[2 * kTable];
  __shared__ int shist[kHist];
  __shared__ float qtab[128];  // the image's quantization tables (K4)
  __shared__ unsigned long long s_total;
  const int lane = threadIdx.x & 31;
  const StageMap map;
  const int nseg = (nt + kThreads - 1) / kThreads;
  const int total = nimg * nseg;
  if (threadIdx.x == 0) s_total = 0;
  if (kWantHist)
    for (int i = threadIdx.x; i < kHist; i += kThreads) shist[i] = 0;

  int cur = -1;                 // the image whose sums the CTA holds
  unsigned long long lsum = 0;  // this thread's bits of image cur

  // Adds what the CTA holds of image b to the image's sums.
  auto flush = [&](int b) {
    const unsigned long long wsum = warp_sum(lsum);
    lsum = 0;
    if (lane == 0 && wsum != 0) atomicAdd(&s_total, wsum);
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(totals + b, s_total);
      s_total = 0;
    }
    if (kWantHist)
      for (int i = threadIdx.x; i < kHist; i += kThreads) {
        const int c = shist[i];
        if (c != 0) atomicAdd(hist + (size_t)b * kHist + i, c);
        shist[i] = 0;
      }
  };

  // A CTA takes consecutive segments, so that it changes image seldom.
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int seg_end = min(total, (int)(blockIdx.x + 1) * per);
  for (int seg = blockIdx.x * per; seg < seg_end; ++seg) {
    const int b = seg / nseg;
    const int s0 = (seg - b * nseg) * kThreads;
    __syncthreads();  // the rows and the tables are free
    if (b != cur) {   // the same for every thread of the CTA
      if (cur >= 0) flush(cur);
      if (cur < 0 || tables_stride != 0)
        load_tables(tables + (size_t)b * tables_stride, tab);
      src.begin_image(b, qtab);
      if (Source::kQuantizes) __syncthreads();  // staging reads qtab
      cur = b;
    }
    src.stage_segment(b, slot_row, s0, rows, map, qtab);
    __syncthreads();
    const int g = s0 + threadIdx.x;
    const bool valid = g < nt;
    int bits = 0;
    int dc_bin = -1 - lane;  // no lane's symbol
    bool eob = false;
    int cls = 0;
    if (valid) {
      const Block blk(src, b, g, s0, ny, slot_row, prev_row, prev_slot, rows,
                      tab, qtab);
      cls = blk.cls;
      const int s_dc = bit_length(blk.diff);
      const int dc_sym = s_dc < 15 ? s_dc : 15;
      bits = (blk.dc_tab[dc_sym] & 31) + s_dc;
      dc_bin = cls * 16 + dc_sym;
      const int zrl_len = blk.ac_tab[kZrl] & 31;
      int* ac_hist = shist + 32 + cls * 256;
      eob = blk.walk([&](int run, int size, int) {
        const int sym = (((run & 15) << 4) | size) & 255;
        bits += (run >> 4) * zrl_len + (blk.ac_tab[sym] & 31) + size;
        if (kWantHist) {
          // The lanes here with one symbol add it once.
          const unsigned same = __match_any_sync(__activemask(),
                                                 cls * 256 + sym);
          if (lane == __ffs(same) - 1) atomicAdd(ac_hist + sym, __popc(same));
          if (run >= 16) atomicAdd(ac_hist + kZrl, run >> 4);
        }
      });
      if (eob) bits += blk.ac_tab[0] & 31;
      if (kWantBits) block_bits[(size_t)b * nt + g] = bits;
    }
    lsum += (unsigned long long)bits;
    if (kWantHist) {
      const unsigned same = __match_any_sync(kFull, dc_bin);
      if (valid && lane == __ffs(same) - 1)
        atomicAdd(shist + dc_bin, __popc(same));
      const unsigned luma = __ballot_sync(kFull, eob && cls == 0);
      const unsigned chroma = __ballot_sync(kFull, eob && cls == 1);
      if (lane == 0) {
        if (luma) atomicAdd(shist + 32, __popc(luma));
        if (chroma) atomicAdd(shist + 32 + 256, __popc(chroma));
      }
    }
  }
  __syncthreads();
  if (cur >= 0) flush(cur);
}

// Packs a block's fields from bit `start` of a word array on.  Words of
// index [lo, hi) may be written; one outside sets the flag instead.  A
// word that only this block covers is stored; its first and last word,
// which a neighbour may share, take atomicOr.
struct BitSink {
  unsigned* words;
  unsigned* flag;
  long long cur, lo, hi;
  unsigned long long acc;
  int n;
  bool first;

  __device__ BitSink(unsigned* w, unsigned* f, long long start, long long l,
                     long long h)
      : words(w), flag(f), cur(l + (start >> 5)), lo(l), hi(h), acc(0),
        n((int)(start & 31)), first(true) {}

  __device__ __forceinline__ void store(unsigned w, bool shared) {
    if (cur < lo || cur >= hi) {
      atomicOr(flag, 1u);
    } else if (shared) {
      atomicOr(words + cur, w);
    } else {
      words[cur] = w;
    }
  }

  // len <= 32; n < 32 on entry, so one word at most becomes full.
  __device__ __forceinline__ void put(unsigned v, int len) {
    acc = (acc << len) | v;
    n += len;
    if (n >= 32) {
      n -= 32;
      store((unsigned)(acc >> n), first);
      first = false;
      ++cur;
    }
  }

  __device__ __forceinline__ void finish() {
    if (n > 0) store((unsigned)(acc << (32 - n)), true);
  }
};

// Decoupled look-back over the segments of one image: a 64-bit status
// word per segment, an aggregate (the segment's own bits) as soon as they
// are known, then an inclusive prefix.

__device__ __forceinline__ void publish(unsigned long long* status, int s,
                                        unsigned long long own) {
  atomicExch(status + s, (s == 0 ? kPrefix : kAggregate) | own);
}

// The bits of the segments before segment s, which has published `own`;
// one whole warp calls it.  Lanes read four status words each, the
// nearest first, all four loads in flight together.
__device__ unsigned long long look_back(unsigned long long* status, int s,
                                        unsigned long long own, int lane) {
  unsigned long long before = 0;
  for (int idx = s - 1; idx >= 0; idx -= 128) {
    unsigned long long st[4];
    bool waiting;
    do {
      waiting = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int at = idx - 4 * lane - k;
        // Before the image's first segment: an empty prefix.
        st[k] = at >= 0 ? *(const volatile unsigned long long*)(status + at)
                        : kPrefix;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) waiting |= (st[k] >> 62) == 0;
    } while (waiting);
    unsigned long long part = 0;
    bool found = false;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!found) {
        part += st[k] & kValue;
        found = (st[k] >> 62) == 2;
      }
    const unsigned with_prefix = __ballot_sync(kFull, found);
    const int last = with_prefix ? __ffs(with_prefix) - 1 : 31;
    before += warp_sum(lane <= last ? part : 0ull);
    if (with_prefix) break;
  }
  if (lane == 0 && s > 0) atomicExch(status + s, kPrefix | (before + own));
  return before;
}

__global__ void __launch_bounds__(kThreads)
    deposit_kernel(const int16_t* __restrict__ blocks, int nimg, int nt,
                   const int* __restrict__ slot_row,
                   const int* __restrict__ prev_row,
                   const int* __restrict__ prev_slot, int ny,
                   const int* __restrict__ tables, int tables_stride,
                   const long long* __restrict__ word_base,
                   long long n_words, unsigned* words, unsigned* flag,
                   unsigned* ticket, unsigned long long* status) {
  __shared__ __align__(16) unsigned char rows[kThreads * kRowBytes];
  __shared__ int tab[2 * kTable];
  __shared__ unsigned buf[kBufWords];
  __shared__ int s_wbits[kWarps];
  __shared__ int s_seg;
  __shared__ unsigned long long s_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const StageMap map;
  const PackedSource src{blocks, nt};
  const int nseg = (nt + kThreads - 1) / kThreads;
  const int total = nimg * nseg;
  for (int k = threadIdx.x; k < kBufWords; k += kThreads) buf[k] = 0;
  int cur = -1;

  for (;;) {
    // Segments in the order CTAs ask for them: a CTA that waits in
    // look_back waits only for CTAs that already run.  (Asking for the
    // next segment ahead of time was measured: it doubles the segments
    // in flight, deepens every look-back and cost 14 us at 12 MP.)
    if (threadIdx.x == 0) s_seg = (int)atomicAdd(ticket, 1u);
    __syncthreads();  // also: the rows, the tables and buf are free
    const int seg = s_seg;
    if (seg >= total) break;
    const int b = seg / nseg;
    const int s = seg - b * nseg;
    const int s0 = s * kThreads;
    if (b != cur && (cur < 0 || tables_stride != 0))
      load_tables(tables + (size_t)b * tables_stride, tab);
    cur = b;
    src.stage_segment(b, slot_row, s0, rows, map, nullptr);
    __syncthreads();

    // The bits of this thread's block, then their exclusive scan over the
    // segment.
    const int g = s0 + threadIdx.x;
    const bool valid = g < nt;
    int bits = 0;
    if (valid) {
      const Block blk(src, b, g, s0, ny, slot_row, prev_row, prev_slot, rows,
                      tab, nullptr);
      const int s_dc = bit_length(blk.diff);
      bits = (blk.dc_tab[s_dc < 15 ? s_dc : 15] & 31) + s_dc;
      const int zrl_len = blk.ac_tab[kZrl] & 31;
      const bool eob = blk.walk([&](int run, int size, int) {
        bits += (run >> 4) * zrl_len
                + (blk.ac_tab[(((run & 15) << 4) | size) & 255] & 31) + size;
      });
      if (eob) bits += blk.ac_tab[0] & 31;
    }
    int incl = bits;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) s_wbits[warp] = incl;
    __syncthreads();
    int offset = incl - bits, seg_bits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) offset += s_wbits[w];
      seg_bits += s_wbits[w];
    }
    // The segment's words go through buf when they fit: bit 0 of buf is
    // the segment's first, so the fields can be packed before the
    // segment's place is known, while the look-back's loads are in flight
    // behind the segments that come after.
    const bool buffered = seg_bits <= 32 * (kBufWords - 1);
    unsigned long long* image_status = status + (size_t)b * nseg;
    if (threadIdx.x == 0) publish(image_status, s, seg_bits);
    const long long lo = word_base != nullptr ? word_base[b] : 0;
    const long long hi = word_base != nullptr ? word_base[b + 1] : n_words;
    if (!buffered) {  // the same for every thread of the CTA
      if (warp == 0) {
        const unsigned long long before = look_back(image_status, s,
                                                    seg_bits, lane);
        if (lane == 0) s_before = before;
      }
      __syncthreads();
    }

    if (valid) {
      const Block blk(src, b, g, s0, ny, slot_row, prev_row, prev_slot, rows,
                      tab, nullptr);
      BitSink sink = buffered
          ? BitSink(buf, flag, offset, 0, kBufWords)
          : BitSink(words, flag, (long long)s_before + offset, lo, hi);
      const int s_dc = bit_length(blk.diff);
      const int dc = blk.dc_tab[s_dc < 15 ? s_dc : 15];
      sink.put(((unsigned)(dc >> 5) << s_dc) | magnitude(blk.diff, s_dc),
               (dc & 31) + s_dc);
      const int zrl = blk.ac_tab[kZrl];
      const bool eob = blk.walk([&](int run, int size, int c) {
        for (; run >= 16; run -= 16) sink.put((unsigned)(zrl >> 5), zrl & 31);
        const int e = blk.ac_tab[((run << 4) | size) & 255];
        sink.put(((unsigned)(e >> 5) << size) | magnitude(c, size),
                 (e & 31) + size);
      });
      if (eob)
        sink.put((unsigned)(blk.ac_tab[0] >> 5), blk.ac_tab[0] & 31);
      sink.finish();
    }
    if (!buffered) continue;
    if (warp == 0) {
      const unsigned long long before = look_back(image_status, s, seg_bits,
                                                  lane);
      if (lane == 0) s_before = before;
    }
    __syncthreads();
    // buf's bits to their place, as whole words, coalesced; the segment's
    // first and last word may be a neighbour's too.
    const unsigned long long at = s_before;  // the segment's first bit
    const int shift = (int)(at & 31);
    const int nloc = (seg_bits + 31) >> 5;
    const int nout = seg_bits > 0 ? (shift + seg_bits + 31) >> 5 : 0;
    const long long w0 = lo + (long long)(at >> 5);
    for (int k = threadIdx.x; k < nout; k += kThreads) {
      const unsigned here = k < nloc ? buf[k] : 0u;
      const unsigned left = k > 0 ? buf[k - 1] : 0u;
      const unsigned w = __funnelshift_r(here, left, shift);
      const long long dst = w0 + k;
      if (dst >= hi) {
        atomicOr(flag, 1u);
      } else if (k == 0 || k == nout - 1) {
        if (w != 0) atomicOr(words + dst, w);
      } else {
        words[dst] = w;
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nloc; k += kThreads) buf[k] = 0;
  }
}

// The most CTAs of `kernel` the current device holds at once.
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, std::atomic<int>* cache,
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
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    got = sms * (per_sm > 0 ? per_sm : 1);
    cache[dev].store(got, std::memory_order_relaxed);
  }
  *out = got;
  return cudaSuccess;
}

template <bool kWantHist, bool kWantBits, typename Source>
cudaError_t launch_stats(const Source& src, int nimg, int nt,
                         const void* slot_row, const void* prev_row,
                         const void* prev_slot, int ny, const void* tables,
                         int tables_stride, void* totals, void* hist,
                         void* block_bits, cudaStream_t s) {
  static std::atomic<int> cache[64];
  int limit = 0;
  cudaError_t err = resident_ctas(
      block_stats_kernel<kWantHist, kWantBits, Source>, cache, &limit);
  if (err != cudaSuccess) return err;
  const long long segs = (long long)nimg * ((nt + kThreads - 1) / kThreads);
  // The fewest CTAs that take the same number of segments each.
  const long long per = (segs + limit - 1) / limit;
  const int grid = (int)((segs + per - 1) / per);
  block_stats_kernel<kWantHist, kWantBits, Source><<<grid, kThreads, 0, s>>>(
      src, nimg, nt, (const int*)slot_row,
      (const int*)prev_row, (const int*)prev_slot, ny, (const int*)tables,
      tables_stride, (unsigned long long*)totals, (int*)hist,
      (int*)block_bits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4's bisection (fennec_jpeg_size_bisect): the whole size search in one
// cooperative launch.  See the header for the design.

constexpr int kSlotBytes = 256;  // a staged float32 block
// A stage: a segment's blocks, the step's two quantization tables, and
// the segment's slot_row and prev_slot.
constexpr int kQtabAt = kThreads * kSlotBytes;
constexpr int kRowsAt = kQtabAt + 128 * 4;
constexpr int kPrevAt = kRowsAt + kThreads * 4;
constexpr int kStageBytes = kPrevAt + kThreads * 4;
constexpr int kStages = 1;
constexpr int kBisectSmem = kStages * kStageBytes;  // dynamic
constexpr int kMaxSteps = 8;
constexpr long long kBarrierTimeoutNs = 5000000000ll;

// Zigzag position of natural index n = 8 r + c (c_position's entries, as a
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

struct BisectArgs {
  CoefSource src;              // its quality pointer is unused
  int nimg;
  const int* slot_row;
  const int* prev_row;
  const int* prev_slot;
  const int* tables;           // (1, 2, 272)
  const long long* bounds;     // (3, nimg): target bytes, lo0, hi0
  int steps;
  unsigned* barrier;           // two words, zero on entry
  long long* table;            // (steps, nimg), zero on entry
  long long* best_q;           // (nimg,)
  bool* found;                 // (nimg,)
};

// lo + hi, mid + 1 and mid - 1 wrap as the step loop's int64 tensors do.
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

struct Range {
  long long lo, hi, best;
  bool found;
};

// Image b's search before step `done`, replayed from rows 0 .. done - 1
// with the rule of fennec_tpu/engine/size_search.py:41-53 (bisect_steps
// in ops/jpeg_emit.py): active = lo <= hi; mid = floor((lo + hi) / 2);
// ok = active and ceil(bits / 8) <= target; then best_q, found, lo and
// hi.  An image no longer active keeps its state.  The rows are read
// past L1 (other SMs added to them), all at once.  With kFinal the rows
// of the steps where b was no longer active are set to -1 (only the
// final pass, one thread per image, writes them).
template <bool kFinal>
__device__ __forceinline__ Range replay(const BisectArgs& a, int b, int done) {
  long long bits[kMaxSteps];
#pragma unroll
  for (int t = 0; t < kMaxSteps; ++t)
    bits[t] = t < done ? __ldcg(a.table + (size_t)t * a.nimg + b) : 0;
  const long long target = a.bounds[b];
  Range r{a.bounds[a.nimg + b], a.bounds[2 * a.nimg + b], 0, false};
#pragma unroll
  for (int t = 0; t < kMaxSteps; ++t) {
    if (t >= done) break;
    if (r.lo > r.hi) {
      if (kFinal) a.table[(size_t)t * a.nimg + b] = -1;
      continue;
    }
    const long long mid = wrap_add(r.lo, r.hi) >> 1;  // floor division
    if ((wrap_add(bits[t], 7) >> 3) <= target) {
      r.best = mid;
      r.found = true;
      r.lo = wrap_add(mid, 1);
    } else {
      r.hi = wrap_add(mid, -1);
    }
  }
  return r;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every CTA of the grid waits here for all the others: a count and a
// generation word.  The launch is cooperative, so every CTA is resident
// and the wait ends; the timeout turns a broken guarantee into a fault
// instead of a hung card.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t0 = global_ns();
      while (*gen == g) {
        __nanosleep(64);
        if (global_ns() - t0 > (unsigned long long)kBarrierTimeoutNs)
          __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// A 16-byte copy into shared memory that reads `bytes` (0 to 16) of src
// and zeroes the rest.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes = 16) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Segment s0 of image b into `stage` at quality q, in flight until the
// wait: its blocks (slot j at byte 256 j, the block's 16-byte chunk c at
// (c ^ (j % 8)) * 16, so that the eight threads of a quarter warp, each
// reading one row of its own block, hit distinct banks), the two tables
// and the segment's slot_row and prev_slot (zeros past nt).
__device__ __forceinline__ void stage_async(const BisectArgs& a, int b, int s0,
                                            int q, unsigned char* stage) {
  const int nt = a.src.nt;
#pragma unroll
  for (int k = 0; k < kSlotBytes / 16; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int blk = i >> 4, c = i & 15;
    const int g = s0 + blk;
    if (g < nt)
      copy16(stage + blk * kSlotBytes + ((c ^ (blk & 7)) << 4),
             a.src.block(b, __ldg(a.slot_row + g)) + 4 * c);
  }
  const int t = threadIdx.x;
  if (t < 32) {
    copy16(stage + kQtabAt + 16 * t, a.src.qtables + q * 128 + 4 * t);
  } else if (t < 96) {  // slot_row, then prev_slot, four slots a copy
    const int m = t - 32, c = m & 31, g = s0 + 4 * c;
    const int left = nt - g;
    const int* src = (m < 32 ? a.slot_row : a.prev_slot);
    copy16(stage + (m < 32 ? kRowsAt : kPrevAt) + 16 * c,
           left > 0 ? src + g : src, left >= 4 ? 16 : (left > 0 ? 4 * left : 0));
  }
}

// Thread j's block of the stage quantized into zigzag order, two int16 a
// word (position p in word p / 2, the low half first), at the luma or
// chroma table.  Row k is read as its two 16-byte chunks.  Every thread of
// a warp holds the same coefficient position at once, so a position whose
// |c| < q / 4 in every lane (0 however the division rounds: q / 4 is exact)
// skips quantize()'s IEEE division warp-wide; a photo's high frequencies
// mostly do at moderate qualities.
__device__ __forceinline__ void quantize_block(const unsigned char* stage,
                                               int j, bool chroma, bool valid,
                                               unsigned (&zz)[32]) {
  const float* qt =
      reinterpret_cast<const float*>(stage + kQtabAt) + (chroma ? 64 : 0);
  const unsigned char* blk = stage + j * kSlotBytes;
  const int x = j & 7;
#pragma unroll
  for (int w = 0; w < 32; ++w) zz[w] = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 lo =
        *reinterpret_cast<const float4*>(blk + (((2 * k) ^ x) << 4));
    const float4 hi =
        *reinterpret_cast<const float4*>(blk + (((2 * k + 1) ^ x) << 4));
    const float4 qlo = *reinterpret_cast<const float4*>(qt + 8 * k);
    const float4 qhi = *reinterpret_cast<const float4*>(qt + 8 * k + 4);
    const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float q[8] = {qlo.x, qlo.y, qlo.z, qlo.w,
                        qhi.x, qhi.y, qhi.z, qhi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool big = valid && !(fabsf(c[e]) < __fmul_rn(0.25f, q[e]));
      const int v = __any_sync(kFull, big) ? quantize(c[e], q[e]) : 0;
      const int p = zigzag_at(8 * k + e);
      zz[p >> 1] |= (unsigned)(v & 0xFFFF) << (16 * (p & 1));
    }
  }
}

// Adds the warps' sums to the table cell: one atomic per warp.
__device__ __forceinline__ void flush_bits(long long* cell,
                                           unsigned long long& lsum) {
  const unsigned long long w = warp_sum(lsum);
  lsum = 0;
  if ((threadIdx.x & 31) == 0 && w != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(cell), w);
}

__global__ void __launch_bounds__(kThreads, 5)
    size_bisect_kernel(const BisectArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int tab[2 * kTable];
  __shared__ int s_img[kThreads], s_s0[kThreads], s_q[kThreads];
  __shared__ int s_dc[kThreads];
  __shared__ int s_warp[kWarps];
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int nt = a.src.nt, ny = a.src.ny;
  const int nseg = (nt + kThreads - 1) / kThreads;
  const long long total = (long long)a.nimg * nseg;
  const long long window = (long long)kThreads * gridDim.x;
  load_tables(a.tables, tab);  // read after the first window's barriers

  for (int step = 0; step < a.steps; ++step) {
    long long* row = a.table + (size_t)step * a.nimg;
    int cur = -1;                 // the image whose bits the CTA holds
    unsigned long long lsum = 0;  // this thread's bits of image cur
    // The CTA's segments of the step are first, first + grid, ...: every
    // CTA gets its share of every image, so images that have finished
    // leave no CTA idle.  Thread j finds the state of the image of the
    // window's segment j; the active ones are listed in order.
    for (long long first = blockIdx.x; first < total; first += window) {
      const long long w = first + (long long)j * gridDim.x;
      int q = -1, b = 0;
      if (w < total) {
        b = (int)(w / nseg);
        const Range r = replay<false>(a, b, step);
        if (r.lo <= r.hi) {
          const long long mid = wrap_add(r.lo, r.hi) >> 1;
          q = (int)(mid < 0 ? 0 : (mid > 100 ? 100 : mid));
        }
      }
      const unsigned ballot = __ballot_sync(kFull, q >= 0);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int rank = __popc(ballot & ((1u << lane) - 1)), n = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        if (k < warp) rank += s_warp[k];
        n += s_warp[k];
      }
      if (q >= 0) {
        s_img[rank] = b;
        s_s0[rank] = (int)(w - (long long)b * nseg) * kThreads;
        s_q[rank] = q;
      }
      __syncthreads();
      // A ring of kStages stages: segment k + kStages loads into the stage
      // segment k leaves once quantized, while k is walked.  One commit
      // group per segment (empty past the end), so the wait counts them.
#pragma unroll
      for (int k = 0; k < kStages; ++k) {
        if (k < n)
          stage_async(a, s_img[k], s_s0[k], s_q[k], ring + k * kStageBytes);
        commit();
      }
      for (int k = 0; k < n; ++k) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1)
                     : "memory");
        __syncthreads();  // segment k has landed; s_dc is free
        const int b_k = s_img[k], s0 = s_s0[k];
        if (b_k != cur) {  // the same for every thread of the CTA
          if (cur >= 0) flush_bits(row + cur, lsum);
          cur = b_k;
        }
        unsigned char* stage = ring + (k % kStages) * kStageBytes;
        const int g = s0 + j;
        const bool valid = g < nt;
        const int slot_row = reinterpret_cast<const int*>(stage + kRowsAt)[j];
        const int ps = reinterpret_cast<const int*>(stage + kPrevAt)[j];
        const int cls = slot_row >= ny ? 1 : 0;
        unsigned zz[32];
        quantize_block(stage, j, cls, valid, zz);
        const int dc = (int)(short)(zz[0] & 0xFFFFu);
        s_dc[j] = dc;
        __syncthreads();  // the DCs are in; the stage is free
        if (k + kStages < n)
          stage_async(a, s_img[k + kStages], s_s0[k + kStages],
                      s_q[k + kStages], stage);
        commit();
        if (!valid) continue;
        // The block's bits, as K3a counts them; the predecessor's DC from
        // the segment when it is there, else quantized from the source.
        int pdc = 0;
        if (ps >= s0) {
          pdc = s_dc[ps - s0];
        } else if (ps >= 0) {
          pdc = a.src.dc(b_k, __ldg(a.prev_row + g),
                         a.src.qtables + s_q[k] * 128);
        }
        const int diff = dc - pdc;
        const int* dc_tab = tab + cls * kTable;
        const int* ac_tab = dc_tab + 16;
        const int s_dc_len = bit_length(diff);
        int bits = (dc_tab[s_dc_len < 15 ? s_dc_len : 15] & 31) + s_dc_len;
        const int zrl_len = ac_tab[kZrl] & 31;
        const bool eob = walk_zigzag(
            [&](int grp) {
              return make_uint4(zz[4 * grp], zz[4 * grp + 1], zz[4 * grp + 2],
                                zz[4 * grp + 3]);
            },
            [&](int run, int size, int) {
              bits += (run >> 4) * zrl_len +
                      (ac_tab[(((run & 15) << 4) | size) & 255] & 31) + size;
            });
        if (eob) bits += ac_tab[0] & 31;
        lsum += (unsigned long long)bits;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (cur >= 0) flush_bits(row + cur, lsum);
    grid_barrier(a.barrier);
  }
  // Every row is complete: each image's result, and -1 where it was done.
  for (int b = blockIdx.x * kThreads + j; b < a.nimg;
       b += gridDim.x * kThreads) {
    const Range r = replay<true>(a, b, a.steps);
    a.best_q[b] = r.best;
    a.found[b] = r.found;
  }
}

// The grid of a bisection on the current device: every CTA the card holds
// at once, at most one per segment of the batch.
cudaError_t bisect_grid(long long segments, int* grid) {
  static std::atomic<int> cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int limit = cache[dev].load(std::memory_order_relaxed);
  if (limit == 0) {
    err = cudaFuncSetAttribute(size_bisect_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBisectSmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0, coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, size_bisect_kernel, kThreads, kBisectSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    limit = sms * per_sm;
    cache[dev].store(limit, std::memory_order_relaxed);
  }
  *grid = (int)(segments < limit ? segments : limit);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* fennec_jpeg_emit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The slots of one look-back segment: K3b's buffer holds a status word
// for each segment of each image.
int fennec_jpeg_segment_blocks(void) { return kThreads; }

// The most CTAs K3a (totals only) and K3b run at once on the current
// device, for reports; negative on error.
int fennec_jpeg_resident_ctas(int deposit) {
  static std::atomic<int> cache_a[64], cache_b[64];
  int out = 0;
  const cudaError_t err =
      deposit ? resident_ctas(deposit_kernel, cache_b, &out)
              : resident_ctas(
                    block_stats_kernel<false, false, PackedSource>, cache_a,
                    &out);
  return err == cudaSuccess ? out : -(int)err;
}

// K3a.  blocks (nimg, nt, 64) int16; slot_row, prev_row, prev_slot (nt,)
// int32; tables (nimg or 1, 2, 272) int32 with tables_stride 544 or 0.
// sums: nimg 64-bit bit totals, then, with want_hist, (nimg, 544) int32
// histograms; zeroed here.  block_bits (nimg, nt) int32 or NULL.
// Returns a cudaError_t.
int fennec_jpeg_block_stats(const void* blocks, int nimg, int nt,
                            const void* slot_row, const void* prev_row,
                            const void* prev_slot, int ny,
                            const void* tables, int tables_stride,
                            void* sums, int want_hist, void* block_bits,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t total_bytes = (size_t)nimg * sizeof(unsigned long long);
  const size_t hist_bytes =
      want_hist ? (size_t)nimg * kHist * sizeof(int) : 0;
  cudaError_t err = cudaMemsetAsync(sums, 0, total_bytes + hist_bytes, s);
  if (err != cudaSuccess) return (int)err;
  void* hist = want_hist ? (char*)sums + total_bytes : nullptr;
  const PackedSource src{(const int16_t*)blocks, nt};
  if (want_hist && block_bits != nullptr)
    err = launch_stats<true, true>(src, nimg, nt, slot_row, prev_row,
                                   prev_slot, ny, tables, tables_stride,
                                   sums, hist, block_bits, s);
  else if (want_hist)
    err = launch_stats<true, false>(src, nimg, nt, slot_row, prev_row,
                                    prev_slot, ny, tables, tables_stride,
                                    sums, hist, block_bits, s);
  else if (block_bits != nullptr)
    err = launch_stats<false, true>(src, nimg, nt, slot_row, prev_row,
                                    prev_slot, ny, tables, tables_stride,
                                    sums, hist, block_bits, s);
  else
    err = launch_stats<false, false>(src, nimg, nt, slot_row, prev_row,
                                     prev_slot, ny, tables, tables_stride,
                                     sums, hist, block_bits, s);
  return (int)err;
}

// K4.  y (nimg, ny, 64), cb and cr (nimg, nc, 64) float32 coefficients,
// 16-byte aligned; qtables (101, 2, 64) float32; quality (nimg,) int64 on
// the device, clamped to [0, 100] by the kernel; tables (1, 2, 272) int32.
// totals: nimg 64-bit bit totals, zeroed here.  Returns a cudaError_t.
int fennec_jpeg_quantize_count(const void* y, const void* cb, const void* cr,
                               int nimg, int ny, int nc,
                               const void* slot_row, const void* prev_row,
                               const void* prev_slot, const void* qtables,
                               const void* quality, const void* tables,
                               void* totals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      totals, 0, (size_t)nimg * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const int nt = ny + 2 * nc;
  const CoefSource src{(const float*)y,  (const float*)cb,
                       (const float*)cr, ny,
                       nc,               nt,
                       (const float*)qtables,
                       (const long long*)quality};
  return (int)launch_stats<false, false>(src, nimg, nt, slot_row, prev_row,
                                         prev_slot, ny, tables, 0, totals,
                                         nullptr, nullptr, s);
}

// K4's bisection.  y, cb, cr, qtables and tables as for K4's step; bounds
// (3, nimg) int64 on the device: each image's target scan bytes, lo0 and
// hi0; steps in [1, 8].  out: int64 words: two barrier
// words (one int64), the (steps, nimg) table of the bits each step
// counted (-1 where the image's range was already empty), best_q
// (nimg,), then found as nimg bytes; the barrier and the table are zeroed
// here.  The highest quality in [lo0, hi0] whose ceil(bits / 8) fits the
// target, the step loop's result.  One cooperative launch on `stream`;
// returns a cudaError_t.
int fennec_jpeg_size_bisect(const void* y, const void* cb, const void* cr,
                            int nimg, int ny, int nc, const void* slot_row,
                            const void* prev_row, const void* prev_slot,
                            const void* qtables, const void* tables,
                            const void* bounds, int steps, void* out,
                            void* stream) {
  if (nimg < 1 || ny < 1 || nc < 1 || steps < 1 || steps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = ny + 2 * nc;
  long long* words = (long long*)out;
  cudaError_t err = cudaMemsetAsync(
      words, 0, (size_t)(1 + (long long)steps * nimg) * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  err = bisect_grid((long long)nimg * ((nt + kThreads - 1) / kThreads), &grid);
  if (err != cudaSuccess) return (int)err;
  BisectArgs args;
  args.src = CoefSource{(const float*)y, (const float*)cb, (const float*)cr,
                        ny, nc, nt, (const float*)qtables, nullptr};
  args.nimg = nimg;
  args.slot_row = (const int*)slot_row;
  args.prev_row = (const int*)prev_row;
  args.prev_slot = (const int*)prev_slot;
  args.tables = (const int*)tables;
  args.bounds = (const long long*)bounds;
  args.steps = steps;
  args.barrier = (unsigned*)words;
  args.table = words + 1;
  args.best_q = args.table + (size_t)steps * nimg;
  args.found = (bool*)(args.best_q + nimg);
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)size_bisect_kernel,
                                    dim3(grid), dim3(kThreads), params,
                                    kBisectSmem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K3b.  word_base (nimg + 1,) int64 on the device, or NULL for one image
// that owns all n_words.  buf: n_words 32-bit words, the out-of-range
// flag word, padding to 8 bytes, the ticket (8 bytes) and a 64-bit status
// word per segment; buf_ints is its size in 32-bit units and must be what
// this layout needs.  All of it is zeroed here.  Returns a cudaError_t.
int fennec_jpeg_deposit(const void* blocks, int nimg, int nt,
                        const void* slot_row, const void* prev_row,
                        const void* prev_slot, int ny, const void* tables,
                        int tables_stride, const void* word_base, void* buf,
                        long long n_words, long long buf_ints,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long segs = (long long)nimg * ((nt + kThreads - 1) / kThreads);
  const long long work_at = (n_words + 2) & ~1ll;
  if (buf_ints != work_at + 2 + 2 * segs || segs > 0x7FFFFFFF ||
      (word_base == nullptr && nimg != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(buf, 0, (size_t)buf_ints * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  static std::atomic<int> cache[64];
  int limit = 0;
  err = resident_ctas(deposit_kernel, cache, &limit);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(segs < limit ? segs : limit);
  uint32_t* words = (uint32_t*)buf;
  deposit_kernel<<<grid, kThreads, 0, s>>>(
      (const int16_t*)blocks, nimg, nt, (const int*)slot_row,
      (const int*)prev_row, (const int*)prev_slot, ny, (const int*)tables,
      tables_stride, (const long long*)word_base, n_words, words,
      words + n_words, words + work_at,
      (unsigned long long*)(words + work_at + 2));
  return (int)cudaGetLastError();
}

}  // extern "C"
