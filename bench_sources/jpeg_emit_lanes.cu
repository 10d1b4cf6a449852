// Kept for the record only: the design that spread a block over eight
// lanes.  It is bit-exact and was measured slower than one thread per
// block; it has the C interface of fennec_tpu_torch/csrc/
// jpeg_emit.cu, so `python3 chip_smoke.py --k3` times it when it is copied
// over that file.  The port does not use it.
//
// Kernel K3: Huffman emission of baseline JPEG scans, CUDA C++ for sm_90a.
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
//
// What bounds it on an H100: every block is 128 bytes read once, 11 us for
// a 12 MP 4:2:0 image at 3.35 TB/s, and a block's symbols cost 30 to 60
// warp instructions, about as long at the card's issue rate; at 1080p and
// below a launch is latency: too few blocks to fill 132 SMs for long.
// What the design does about each:
//
//   Lanes share a block.  Eight lanes hold one block, a warp four blocks:
//   lane j of a group holds zigzag positions j, j + 8, .., j + 56 (a
//   16-byte load per lane, 128 coalesced bytes per block, turned into
//   zigzag order through a 576-byte stage per warp).  Eight ballots give
//   every block's 64-bit nonzero mask; a nonzero coefficient finds the one
//   before it with a count of leading zeros on the mask below its
//   position, so run, ZRL count, size, symbol and field length are
//   computed by all lanes at once, with no walk over positions and no
//   branch on the data except to skip a row of eight positions that is
//   zero in all four blocks (most rows at the usual qualities).
//
//   The grid is sized to the card: CTAs of 8 warps loop over segments of
//   128 slots, a warp over runs of 16, its loads issued ahead of its
//   arithmetic.  1080p fills the SMs once; 12 MP leaves no tail wave.
//
//   The previous block's DC comes from a register: a warp keeps the DCs of
//   its run across its lanes and reads device memory only for a
//   predecessor outside the run (3 or 4 blocks of 16 in 4:2:0).
//
//   Histograms: a warp counts its DC symbols with one match and its EOBs
//   with one ballot and a population count before a single shared-memory
//   add; AC symbols take shared-memory integer atomics of at most the
//   lanes of one warp; a CTA adds its nonzero bins to the image's with
//   global integer atomics.  Counts do not depend on order.
//
//   K3b is one pass.  A warp deposits its run's fields, each at the
//   exclusive scan of the field lengths (eight-lane scans, row by row),
//   into its own words in shared memory, as if the run began at bit 0.
//   The CTA sums its warps' bits, publishes the segment's total and looks
//   back over the segments before it (a 64-bit status word per segment:
//   an aggregate, then an inclusive prefix; segments are handed out by an
//   atomic ticket, so a waiting CTA only waits for CTAs that already run).
//   Then each warp shifts its words to their place and stores them whole
//   and coalesced; only the first and the last word of a run, which a
//   neighbour may share, take a global atomicOr.  Bit ranges are disjoint,
//   so OR is exact and the words do not depend on the order CTAs run.  A
//   word outside its image's range sets the flag word after the buffer
//   (the wrapper raises on it) instead of being written.
//
// Code tables are (1 or B, 2, 272) int32, code << 5 | length with lengths
// of at most 16 bits, as JPEG has them.  Everything is integer.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 4;               // warp iterations of 4 blocks a run
constexpr int kRun = 4 * kIters;        // slots per warp and segment
constexpr int kSeg = kWarps * kRun;     // slots per CTA and segment
constexpr int kStageStride = 144;       // bytes per staged block (128 + 16)
constexpr int kStageBytes = 4 * kStageStride;
// A field is at most 32 bits (16 of code, 16 of magnitude) and a block has
// at most 64 of them.
constexpr int kLocalWords = kRun * 64 + 2;
constexpr int kTable = 16 + 256;
constexpr int kHist = 2 * 16 + 2 * 256;
constexpr int kZrl = 0xF0;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;

__constant__ int c_zigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

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

// A lane's place: lane j of group q holds zigzag positions 8 i + j of the
// q-th block of a warp iteration; zlo and zhi hold the byte offsets of
// those positions in a staged block (natural order), one byte each.
struct Lane {
  int lane, warp, j, q;
  unsigned zlo, zhi;

  __device__ Lane() {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    j = lane & 7;
    q = lane >> 3;
    zlo = zhi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      zlo |= (unsigned)(2 * c_zigzag[8 * i + j]) << (8 * i);
      zhi |= (unsigned)(2 * c_zigzag[8 * (i + 4) + j]) << (8 * i);
    }
  }
};

// A run: 16 consecutive slots of one image, four per warp iteration.  The
// loads of all four iterations are issued here, ahead of the arithmetic.
struct Run {
  uint4 raw[kIters];   // 16 bytes of the lane's block
  int row[kIters];     // the block's row, -1 past the image's last slot
  int rel[kIters];     // the predecessor's slot relative to the run's first
  int pdc[kIters];     // the predecessor's DC when it lies before the run

  __device__ Run(const int16_t* __restrict__ img, int nt, int run0,
                 const int* __restrict__ slot_row,
                 const int* __restrict__ prev_row,
                 const int* __restrict__ prev_slot, const Lane& L) {
    int pr[kIters];
#pragma unroll
    for (int t = 0; t < kIters; ++t) {
      const int g = run0 + 4 * t + L.q;
      const bool valid = g < nt;
      row[t] = valid ? slot_row[g] : -1;
      pr[t] = valid ? prev_row[g] : -1;
      rel[t] = valid ? prev_slot[g] - run0 : -1;
    }
#pragma unroll
    for (int t = 0; t < kIters; ++t) {
      raw[t] = make_uint4(0, 0, 0, 0);
      if (row[t] >= 0)
        raw[t] = reinterpret_cast<const uint4*>(
            img + (size_t)row[t] * 64)[L.j];
      pdc[t] = 0;
      if (rel[t] < 0 && pr[t] >= 0) pdc[t] = img[(size_t)pr[t] * 64];
    }
  }
};

// Four blocks in zigzag order across the warp.
struct Quad {
  int v[8];           // the coefficient at zigzag position 8 i + j
  unsigned mlo, mhi;  // the block's nonzero mask; bit 0 is always set
  unsigned active;    // bit i: a block of the four has a nonzero in row i

  __device__ __forceinline__ Quad(unsigned char* stage, const uint4& raw,
                                  const Lane& L) {
    unsigned char* blk = stage + L.q * kStageStride;
    *reinterpret_cast<uint4*>(blk + L.j * 16) = raw;
    __syncwarp();
    unsigned bal[8];
    active = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned off = ((i < 4 ? L.zlo : L.zhi) >> (8 * (i & 3))) & 0xFFu;
      v[i] = *reinterpret_cast<const short*>(blk + off);
      bal[i] = __ballot_sync(kFull, v[i] != 0);
      active |= (bal[i] != 0 ? 1u : 0u) << i;
    }
    __syncwarp();
    // Byte q of ballot i is byte i of group q's mask.
    const unsigned sel = (unsigned)L.q | ((4u + (unsigned)L.q) << 4);
    mlo = __byte_perm(__byte_perm(bal[0], bal[1], sel),
                      __byte_perm(bal[2], bal[3], sel), 0x5410) | 1u;
    mhi = __byte_perm(__byte_perm(bal[4], bal[5], sel),
                      __byte_perm(bal[6], bal[7], sel), 0x5410);
  }

  // The zeros between position 8 i + j and the nonzero before it (the DC
  // counts as one).  i is a constant after unrolling.
  __device__ __forceinline__ int run_before(int i, int j) const {
    int prev;
    if (i < 4) {
      prev = 31 - __clz(mlo & ((1u << (8 * i + j)) - 1u));
    } else {
      const unsigned x = mhi & ((1u << (8 * (i - 4) + j)) - 1u);
      prev = x ? 63 - __clz(x) : 31 - __clz(mlo);
    }
    return 8 * i + j - prev - 1;
  }
};

// The DC of the block before each of the four blocks: from the run's DCs,
// kept one per lane (lane r holds the DC of the run's slot r), or from
// device memory (run.pdc) for a predecessor before the run.
__device__ __forceinline__ int previous_dc(const Quad& Q, const Run& run,
                                           int t, const Lane& L,
                                           int& run_dc) {
  const int dcs = __shfl_sync(kFull, Q.v[0], (L.lane & 3) * 8);
  if ((L.lane >> 2) == t) run_dc = dcs;
  const int held = __shfl_sync(kFull, run_dc, run.rel[t] & 31);
  return run.rel[t] >= 0 ? held : run.pdc[t];
}

__device__ __forceinline__ void load_tables(const int* __restrict__ tables,
                                            int* tab) {
  for (int i = threadIdx.x; i < 2 * kTable; i += kThreads) tab[i] = tables[i];
}

template <bool kWantHist, bool kWantBits>
__global__ void __launch_bounds__(kThreads)
    block_stats_kernel(const int16_t* __restrict__ blocks, int nimg, int nt,
                       const int* __restrict__ slot_row,
                       const int* __restrict__ prev_row,
                       const int* __restrict__ prev_slot, int ny,
                       const int* __restrict__ tables, int tables_stride,
                       unsigned long long* __restrict__ totals,
                       int* __restrict__ hist, int* __restrict__ block_bits) {
  __shared__ __align__(16) unsigned char stage[kWarps][kStageBytes];
  __shared__ int tab[2 * kTable];
  __shared__ int shist[kHist];
  __shared__ unsigned long long s_total;
  const Lane L;
  const int nseg = (nt + kSeg - 1) / kSeg;
  const int total = nimg * nseg;
  if (threadIdx.x == 0) s_total = 0;
  if (kWantHist)
    for (int i = threadIdx.x; i < kHist; i += kThreads) shist[i] = 0;
  __syncthreads();

  int cur = -1;                 // the image whose sums the CTA holds
  unsigned long long lsum = 0;  // this lane's bits of image cur

  // Adds what the CTA holds of image b to the image's sums.
  auto flush = [&](int b) {
    const unsigned long long wsum = warp_sum(lsum);
    lsum = 0;
    if (L.lane == 0 && wsum != 0) atomicAdd(&s_total, wsum);
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
    __syncthreads();
  };

  for (int seg = blockIdx.x; seg < total; seg += gridDim.x) {
    const int b = seg / nseg;
    if (b != cur) {  // the same for every thread of the CTA
      if (cur >= 0) flush(cur);
      if (cur < 0 || tables_stride != 0) {
        load_tables(tables + (size_t)b * tables_stride, tab);
        __syncthreads();
      }
      cur = b;
    }
    const int run0 = (seg - b * nseg) * kSeg + L.warp * kRun;
    if (run0 >= nt) continue;
    const int16_t* img = blocks + (size_t)b * nt * 64;
    const Run run(img, nt, run0, slot_row, prev_row, prev_slot, L);
    int run_dc = 0;
#pragma unroll
    for (int t = 0; t < kIters; ++t) {
      const Quad Q(stage[L.warp], run.raw[t], L);
      const bool valid = run.row[t] >= 0;
      const int cls = run.row[t] >= ny ? 1 : 0;
      const int* dc_tab = tab + cls * kTable;
      const int* ac_tab = dc_tab + 16;
      int* ac_hist = shist + 32 + cls * 256;
      const int pdc = previous_dc(Q, run, t, L, run_dc);
      int bits = 0;
      if (L.j == 0) {
        const int s_dc = bit_length(Q.v[0] - pdc);
        const int dc_sym = s_dc < 15 ? s_dc : 15;
        if (valid) bits = (dc_tab[dc_sym] & 31) + s_dc;
        if (kWantHist) {
          // The leaders of the four groups count their symbols together.
          const int bin = valid ? cls * 16 + dc_sym : -1;
          const unsigned same = __match_any_sync(0x01010101u, bin);
          if (valid && L.lane == __ffs(same) - 1)
            atomicAdd(shist + bin, __popc(same));
        }
      }
      const int zrl_len = ac_tab[kZrl] & 31;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!((Q.active >> i) & 1u)) continue;  // zero in all four blocks
        const int v = Q.v[i];
        if (v == 0 || (i == 0 && L.j == 0)) continue;
        const int run_len = Q.run_before(i, L.j);
        const int s = bit_length(v);
        const int sym = (((run_len & 15) << 4) | s) & 255;
        bits += (run_len >> 4) * zrl_len + (ac_tab[sym] & 31) + s;
        if (kWantHist) {
          atomicAdd(ac_hist + sym, 1);
          if (run_len >= 16) atomicAdd(ac_hist + kZrl, run_len >> 4);
        }
      }
      // EOB exactly when zigzag position 63 is zero: lane 7's last.
      const bool eob = valid && L.j == 7 && Q.v[7] == 0;
      if (eob) bits += ac_tab[0] & 31;
      if (kWantHist) {
        const unsigned luma = __ballot_sync(kFull, eob && cls == 0);
        const unsigned chroma = __ballot_sync(kFull, eob && cls == 1);
        if (L.lane == 0) {
          if (luma) atomicAdd(shist + 32, __popc(luma));
          if (chroma) atomicAdd(shist + 32 + 256, __popc(chroma));
        }
      }
      lsum += (unsigned long long)bits;
      if (kWantBits) {
        bits += __shfl_xor_sync(kFull, bits, 1);
        bits += __shfl_xor_sync(kFull, bits, 2);
        bits += __shfl_xor_sync(kFull, bits, 4);
        if (valid && L.j == 0)
          block_bits[(size_t)b * nt + run0 + 4 * t + L.q] = bits;
      }
    }
  }
  if (cur >= 0) flush(cur);
}

// ORs the len low bits of val into the bit string in buf at bit o (bit 0
// is the top bit of word 0).  A field that is too long or would leave the
// buffer sets the flag: the tables break the kernel's contract.
__device__ __forceinline__ void put(unsigned* buf, unsigned* flag,
                                    unsigned val, int len, int o) {
  if (len == 0) return;
  if (len > 32 || o + len > 32 * (kLocalWords - 1)) {
    atomicOr(flag, 1u);
    return;
  }
  const unsigned long long placed = (unsigned long long)val
                                    << (64 - (o & 31) - len);
  atomicOr(buf + (o >> 5), (unsigned)(placed >> 32));
  if ((unsigned)placed != 0) atomicOr(buf + (o >> 5) + 1, (unsigned)placed);
}

// Segment s of an image publishes its bits and returns the bits of the
// segments before it (decoupled look-back; the whole warp calls it).
// Lanes read four status words each, the nearest first.
__device__ unsigned long long look_back(unsigned long long* status, int s,
                                        unsigned long long own, int lane) {
  if (lane == 0) atomicExch(status + s, (s == 0 ? kPrefix : kAggregate) | own);
  unsigned long long before = 0;
  for (int idx = s - 1; idx >= 0; idx -= 128) {
    unsigned long long part = 0;
    bool found = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int at = idx - 4 * lane - k;
      unsigned long long st = kPrefix;  // before the image's first segment
      if (at >= 0) {
        const volatile unsigned long long* p = status + at;
        do {
          st = *p;
        } while ((st >> 62) == 0);
      }
      if (!found) {
        part += st & kValue;
        found = (st >> 62) == 2;
      }
    }
    const unsigned with_prefix = __ballot_sync(kFull, found);
    const int last = with_prefix ? __ffs(with_prefix) - 1 : 31;
    before += warp_sum(lane <= last ? part : 0ull);
    if (with_prefix) break;
  }
  if (lane == 0 && s > 0) atomicExch(status + s, kPrefix | (before + own));
  return before;
}

// Moves a run's nbits bits from the warp's words (bit 0 first) to bit
// `at` of the image whose words are [lo, hi), and zeroes the warp's words.
__device__ __forceinline__ void store_run(unsigned* local, int nbits,
                                          unsigned long long at,
                                          long long lo, long long hi,
                                          unsigned* words, unsigned* flag,
                                          int lane) {
  const int shift = (int)(at & 31);
  const long long w0 = lo + (long long)(at >> 5);
  const int nloc = (nbits + 31) >> 5;
  const int nout = nbits > 0 ? (shift + nbits + 31) >> 5 : 0;
  __syncwarp();
  for (int k = lane; k < nout; k += 32) {
    const unsigned here = k < nloc ? local[k] : 0u;
    const unsigned left = k > 0 ? local[k - 1] : 0u;
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
  __syncwarp();
  for (int k = lane; k < nloc; k += 32) local[k] = 0;
  __syncwarp();
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
  __shared__ __align__(16) unsigned char stage[kWarps][kStageBytes];
  __shared__ int tab[2 * kTable];
  __shared__ unsigned local_words[kWarps][kLocalWords];
  __shared__ int s_wbits[kWarps];
  __shared__ int s_seg;
  __shared__ unsigned long long s_before;
  const Lane L;
  unsigned* local = local_words[L.warp];
  const int nseg = (nt + kSeg - 1) / kSeg;
  const int total = nimg * nseg;
  for (int k = L.lane; k < kLocalWords; k += 32) local[k] = 0;
  int cur = -1;

  for (;;) {
    // Segments in the order CTAs ask for them: a CTA that waits in
    // look_back waits only for CTAs that already run.
    if (threadIdx.x == 0) s_seg = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    const int seg = s_seg;
    if (seg >= total) break;
    const int b = seg / nseg;
    const int s = seg - b * nseg;
    if (b != cur && (cur < 0 || tables_stride != 0)) {
      load_tables(tables + (size_t)b * tables_stride, tab);
      __syncthreads();
    }
    cur = b;
    const int run0 = s * kSeg + L.warp * kRun;
    int run_bits = 0;  // the same in every lane of the warp
    if (run0 < nt) {
      const int16_t* img = blocks + (size_t)b * nt * 64;
      const Run run(img, nt, run0, slot_row, prev_row, prev_slot, L);
      int run_dc = 0;
#pragma unroll
      for (int t = 0; t < kIters; ++t) {
        const Quad Q(stage[L.warp], run.raw[t], L);
        const bool valid = run.row[t] >= 0;
        const int* dc_tab = tab + (run.row[t] >= ny ? kTable : 0);
        const int* ac_tab = dc_tab + 16;
        const int pdc = previous_dc(Q, run, t, L, run_dc);
        const int zrl = ac_tab[kZrl];
        const int zrl_len = zrl & 31;
        // The field at each of the lane's positions: its value, and its
        // length | ZRLs before it << 8.  The DC's is at i = 0 of lane 0.
        unsigned fval[8];
        int fmeta[8];
        int mine = 0;  // the bits of the lane's fields
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          fval[i] = 0;
          fmeta[i] = 0;
          if (i > 0 && !((Q.active >> i) & 1u)) continue;
          const int v = Q.v[i];
          if (i == 0 && L.j == 0) {
            if (valid) {
              const int diff = v - pdc;
              const int s_dc = bit_length(diff);
              const int e = dc_tab[s_dc < 15 ? s_dc : 15];
              fval[0] = ((unsigned)(e >> 5) << s_dc) | magnitude(diff, s_dc);
              fmeta[0] = (e & 31) + s_dc;
              mine += fmeta[0];
            }
          } else if (v != 0) {
            const int run_len = Q.run_before(i, L.j);
            const int sz = bit_length(v);
            const int e = ac_tab[(((run_len & 15) << 4) | sz) & 255];
            fval[i] = ((unsigned)(e >> 5) << sz) | magnitude(v, sz);
            fmeta[i] = ((e & 31) + sz) | ((run_len >> 4) << 8);
            mine += (run_len >> 4) * zrl_len + (e & 31) + sz;
          }
        }
        const bool eob = valid && L.j == 7 && Q.v[7] == 0;
        const int eob_len = eob ? ac_tab[0] & 31 : 0;
        mine += eob_len;
        // The block's bits, and where it starts in the warp's words.
        int block = mine;
        block += __shfl_xor_sync(kFull, block, 1);
        block += __shfl_xor_sync(kFull, block, 2);
        block += __shfl_xor_sync(kFull, block, 4);
        const int b0 = __shfl_sync(kFull, block, 0);
        const int b1 = __shfl_sync(kFull, block, 8);
        const int b2 = __shfl_sync(kFull, block, 16);
        const int b3 = __shfl_sync(kFull, block, 24);
        const int start = run_bits + (L.q > 0 ? b0 : 0) + (L.q > 1 ? b1 : 0)
                          + (L.q > 2 ? b2 : 0);
        run_bits += b0 + b1 + b2 + b3;
        // Row by row: the exclusive scan of the field lengths over the
        // group's eight lanes, then the deposit.
        int before = 0;  // the bits of the block's rows before this one
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i > 0 && !((Q.active >> i) & 1u)) continue;
          const int len = fmeta[i] & 255;
          const int zrls = fmeta[i] >> 8;
          const int mybits = zrls * zrl_len + len;
          int incl = mybits;
          int up = __shfl_up_sync(kFull, incl, 1, 8);
          if (L.j >= 1) incl += up;
          up = __shfl_up_sync(kFull, incl, 2, 8);
          if (L.j >= 2) incl += up;
          up = __shfl_up_sync(kFull, incl, 4, 8);
          if (L.j >= 4) incl += up;
          int o = start + before + incl - mybits;
          before += __shfl_sync(kFull, incl, 7, 8);
          for (int z = 0; z < zrls; ++z) {
            put(local, flag, (unsigned)(zrl >> 5), zrl_len, o);
            o += zrl_len;
          }
          put(local, flag, fval[i], len, o);
        }
        if (eob)
          put(local, flag, (unsigned)(ac_tab[0] >> 5), eob_len,
              start + block - eob_len);
      }
    }
    if (L.lane == 0) s_wbits[L.warp] = run_bits;
    __syncthreads();
    int warp_off = 0, seg_bits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < L.warp) warp_off += s_wbits[w];
      seg_bits += s_wbits[w];
    }
    if (L.warp == 0) {
      const unsigned long long before = look_back(
          status + (size_t)b * nseg, s, (unsigned long long)seg_bits, L.lane);
      if (L.lane == 0) s_before = before;
    }
    __syncthreads();
    const long long lo = word_base != nullptr ? word_base[b] : 0;
    const long long hi = word_base != nullptr ? word_base[b + 1] : n_words;
    store_run(local, run_bits, s_before + (unsigned long long)warp_off, lo,
              hi, words, flag, L.lane);
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

template <bool kWantHist, bool kWantBits>
cudaError_t launch_stats(const void* blocks, int nimg, int nt,
                         const void* slot_row, const void* prev_row,
                         const void* prev_slot, int ny, const void* tables,
                         int tables_stride, void* totals, void* hist,
                         void* block_bits, cudaStream_t s) {
  static std::atomic<int> cache[64];
  int limit = 0;
  cudaError_t err = resident_ctas(
      block_stats_kernel<kWantHist, kWantBits>, cache, &limit);
  if (err != cudaSuccess) return err;
  const long long segs = (long long)nimg * ((nt + kSeg - 1) / kSeg);
  const int grid = (int)(segs < limit ? segs : limit);
  block_stats_kernel<kWantHist, kWantBits><<<grid, kThreads, 0, s>>>(
      (const int16_t*)blocks, nimg, nt, (const int*)slot_row,
      (const int*)prev_row, (const int*)prev_slot, ny, (const int*)tables,
      tables_stride, (unsigned long long*)totals, (int*)hist,
      (int*)block_bits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fennec_jpeg_emit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The slots of one look-back segment: K3b's buffer holds a status word
// for each segment of each image.
int fennec_jpeg_segment_blocks(void) { return kSeg; }

// The most CTAs K3a (totals only) and K3b run at once on the current
// device, for reports; negative on error.
int fennec_jpeg_resident_ctas(int deposit) {
  static std::atomic<int> cache_a[64], cache_b[64];
  int out = 0;
  const cudaError_t err =
      deposit ? resident_ctas(deposit_kernel, cache_b, &out)
              : resident_ctas(block_stats_kernel<false, false>, cache_a,
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
  if (want_hist && block_bits != nullptr)
    err = launch_stats<true, true>(blocks, nimg, nt, slot_row, prev_row,
                                   prev_slot, ny, tables, tables_stride,
                                   sums, hist, block_bits, s);
  else if (want_hist)
    err = launch_stats<true, false>(blocks, nimg, nt, slot_row, prev_row,
                                    prev_slot, ny, tables, tables_stride,
                                    sums, hist, block_bits, s);
  else if (block_bits != nullptr)
    err = launch_stats<false, true>(blocks, nimg, nt, slot_row, prev_row,
                                    prev_slot, ny, tables, tables_stride,
                                    sums, hist, block_bits, s);
  else
    err = launch_stats<false, false>(blocks, nimg, nt, slot_row, prev_row,
                                     prev_slot, ny, tables, tables_stride,
                                     sums, hist, block_bits, s);
  return (int)err;
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
  const long long segs = (long long)nimg * ((nt + kSeg - 1) / kSeg);
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
