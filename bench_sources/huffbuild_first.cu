// Kept to be held bit for bit and timed in turns: chip_smoke.py builds this
// first version of K5 (one warp reduction per K.2 merge) beside
// fennec_tpu_torch/csrc/huffbuild.cu.  The port does not use it.  Built
// with -DK5_STAMPS it records clock64() at each phase boundary of every
// warp (fennec_huff_stamps, fennec_huff_stamp_names).
//
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
// 3.35 TB/s.  The bound is the serial chain of one table: at most (live
// symbols - 1) merges, each of which needs the result of the one before,
// and each a reduction over 257 symbols of depth ceil(log2 257) = 9.
// Images and tables are independent, so the batch only adds width.
//
// The design (simple first; speed is later work):
//   One CTA of 4 warps per image, one warp per table.  A lane holds 9
//   symbols (s = lane + 32 k, k < 9) in registers: frequency (64-bit:
//   merged counts of a large image pass 2^31), code size and the label of
//   its tree's root.  A merge is one warp reduction: each lane keeps the
//   two least keys frequency << 9 | (511 - s) of its symbols, and five
//   butterfly steps of shuffles combine the pairs (the two least of the
//   union), so v1 and v2 come out of one pass of depth 4 + 5 = 9, not two.
//   Then a shuffle from each owner gives the two trees' labels, and every
//   lane adds 1 to the code size of its symbols in either tree and
//   relabels the absorbed one: the host builder's linked lists become two
//   compares per symbol, with no pointer chasing.
//   After the loop: the length counts in shared memory, K.3 serially on
//   one lane (33 bins), the canonical position of each symbol by a
//   counting sort (a running count per length in shared memory; in each
//   group of 32 symbols, __match_any_sync and a population count below the
//   lane rank the symbols of one length), the canonical codes from the
//   first code and the first position of each length, the table entries
//   and the dot product of the counts with the code and magnitude bits.
//   Integer arithmetic only; the four warps of an image meet once (the
//   overflow flag) and once more (the bit total), in shared memory, and
//   share nothing with other images.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr unsigned long long kDead = 1ull << 62;  // above every live key
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

__device__ __forceinline__ void keep_two_least(unsigned long long& a,
                                               unsigned long long& b,
                                               unsigned long long c,
                                               unsigned long long d) {
  // (a, b) and (c, d) each the two least of a set, a < b and c < d (or
  // dead); leaves (a, b) the two least of the union.
  const unsigned long long lo = a < c ? a : c;
  const unsigned long long hi = a < c ? c : a;
  const unsigned long long bd = b < d ? b : d;
  b = hi < bd ? hi : bd;
  a = lo;
}

__global__ void __launch_bounds__(kThreads)
    huff_build_kernel(const int* __restrict__ hist,
                      const int* __restrict__ std_tables,
                      int* __restrict__ tables, int* __restrict__ header) {
  __shared__ int s_bins[kWarps][33];   // code lengths, reserved included
  __shared__ int s_next[kWarps][33];   // next canonical position per length
  __shared__ int s_start[kWarps][17];  // first position of each length
  __shared__ int s_code[kWarps][17];   // first code of each length
  __shared__ int s_nvals[kWarps];
  __shared__ int s_over[kWarps];
  __shared__ long long s_bits[kWarps];

  const int img = blockIdx.x;
  const int warp = threadIdx.x >> 5;  // 0 dc-luma 1 dc-chroma 2 ac-luma 3
  const int lane = threadIdx.x & 31;
  const bool is_dc = warp < 2;
  const int cls = warp & 1;
  const int nsym = is_dc ? 16 : 256;
  const int* h = hist + (size_t)img * kHist + (is_dc ? 16 * cls
                                                     : 32 + 256 * cls);
  K5_STAMP(0);

  long long f[kSlots];  // a live chain's frequency, else 0
  int raw[kSlots];      // the symbol's count as K3a gave it
  int cs[kSlots];       // code size
  int grp[kSlots];      // label of the symbol's tree
  long long total = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = lane + 32 * k;
    raw[k] = s < nsym ? h[s] : 0;
    f[k] = raw[k];
    total += raw[k];
    cs[k] = 0;
    grp[k] = s;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_xor_sync(kFull, total, off);
  if (lane == 0) {
    if (total == 0) f[0] = 1;  // an empty class codes symbol 0
    f[8] = 1;                  // the reserved symbol, s = 256
  }

  K5_STAMP(1);
  int merges = 0;
  // K.2: merge the two least-frequent chains until one is left.
  for (;;) {
    unsigned long long a = kDead, b = kDead;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (f[k] > 0) {
        const unsigned long long key =
            ((unsigned long long)f[k] << 9) | (unsigned)(511 - lane - 32 * k);
        if (key < a) {
          b = a;
          a = key;
        } else if (key < b) {
          b = key;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long c = __shfl_xor_sync(kFull, a, off);
      const unsigned long long d = __shfl_xor_sync(kFull, b, off);
      keep_two_least(a, b, c, d);
    }
    if (b == kDead) break;  // one chain left (the same on every lane)
    const int v1 = 511 - (int)(a & 511);
    const int v2 = 511 - (int)(b & 511);
    const long long f2 = (long long)(b >> 9);
    int g1 = 0, g2 = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      if (s == v1) g1 = grp[k];
      if (s == v2) g2 = grp[k];
    }
    g1 = __shfl_sync(kFull, g1, v1 & 31);
    g2 = __shfl_sync(kFull, g2, v2 & 31);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      const bool in2 = grp[k] == g2;
      if (in2 || grp[k] == g1) ++cs[k];
      if (in2) grp[k] = g1;
      if (s == v1) f[k] += f2;
      if (s == v2) f[k] = 0;
    }
    ++merges;
  }
  K5_STAMP(2);
  K5_MERGES(merges);

  int over = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) over |= cs[k] > 32;
  over = __any_sync(kFull, over);
  if (lane == 0) s_over[warp] = over;
  for (int i = lane; i < 33; i += 32) {
    s_bins[warp][i] = 0;
    s_next[warp][i] = 0;
  }
  __syncthreads();
  const bool flagged = s_over[0] | s_over[1] | s_over[2] | s_over[3];
  K5_STAMP(3);

  int entry[kSlots];  // the symbol's table entry
  const int base = cls * kTable + (is_dc ? 0 : 16);
  if (flagged) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      entry[k] = s < nsym ? std_tables[base + s] : 0;
    }
    K5_STAMP(4);
    K5_STAMP(5);
    K5_STAMP(6);
  } else {
    // Length counts: s_bins with the reserved symbol, s_next without it.
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (cs[k] > 0) {
        atomicAdd(&s_bins[warp][cs[k]], 1);
        if (lane + 32 * k < 256) atomicAdd(&s_next[warp][cs[k]], 1);
      }
    }
    __syncwarp();
    K5_STAMP(4);
    if (lane == 0) {
      int* bits = s_bins[warp];
      for (int i = 32; i > 16; --i) {  // K.3 (Figure K.3)
        while (bits[i] > 0) {
          int j = i - 2;
          while (bits[j] == 0) --j;
          bits[i] -= 2;
          bits[i - 1] += 1;
          bits[j + 1] += 2;
          bits[j] -= 1;
        }
      }
      int i = 16;
      while (bits[i] == 0) --i;
      bits[i] -= 1;  // drop the reserved symbol's slot
      int pos = 0;   // canonical positions: (pre-limit length, symbol)
      for (int len = 1; len <= 32; ++len) {
        const int n = s_next[warp][len];
        s_next[warp][len] = pos;
        pos += n;
      }
      s_nvals[warp] = pos;
      int code = 0, first = 0;  // T.81 C.2 over the limited lengths
      for (int len = 1; len <= 16; ++len) {
        s_start[warp][len] = first;
        s_code[warp][len] = code;
        first += bits[len];
        code = (code + bits[len]) << 1;
      }
    }
    __syncwarp();
    K5_STAMP(5);
    const unsigned below = (1u << lane) - 1;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int s = lane + 32 * k;
      const bool real = s < 256 && cs[k] > 0;
      const unsigned peers = __match_any_sync(kFull, real ? cs[k] : 0);
      const int rank = __popc(peers & below);
      const int pos = real ? s_next[warp][cs[k]] + rank : 0;
      __syncwarp();
      if (real && rank == 0) s_next[warp][cs[k]] += __popc(peers);
      __syncwarp();
      int len = 0;
      if (real) {
#pragma unroll
        for (int l = 1; l <= 16; ++l)
          if (pos >= s_start[warp][l]) len = l;
        const int code = s_code[warp][len] + pos - s_start[warp][len];
        entry[k] = (code << 5) | len;
        // VALS byte: this table's segment of the header's VALS bytes.
        uint8_t* vals = (uint8_t*)(header + (size_t)img * kHdr + kHdrVals);
        vals[(is_dc ? 16 * cls : 32 + 256 * cls) + pos] = (uint8_t)s;
      } else {
        entry[k] = 0;
      }
    }
    K5_STAMP(6);
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
  if (lane == 0) s_bits[warp] = bits;

  // The header: this table's specs (zero when flagged), then the image's
  // words from thread 0.
  int* hdr = header + (size_t)img * kHdr;
  const int nvals = flagged ? 0 : s_nvals[warp];
  if (lane == 0) hdr[kHdrNvals + warp] = nvals;
  if (lane < 16)
    hdr[kHdrBits16 + 16 * warp + lane] = flagged ? 0 : s_bins[warp][lane + 1];
  uint8_t* vals = (uint8_t*)(hdr + kHdrVals) + (is_dc ? 16 * cls
                                                      : 32 + 256 * cls);
  for (int i = nvals + lane; i < nsym; i += 32) vals[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    *(long long*)hdr = s_bits[0] + s_bits[1] + s_bits[2] + s_bits[3];
    hdr[kHdrOverflow] = flagged;
    hdr[kHdr - 1] = 0;
  }
  K5_STAMP(7);
}

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

const char* fennec_huff_stamp_names() {
  return "start,loaded,merges,flag_barrier,length_counts,k3_prefix,"
         "ranks_codes,writes_header";
}
#endif

}  // extern "C"
