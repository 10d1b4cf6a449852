// Kept for timing only: chip_smoke.py builds this first version of K3 and
// times it in turns against fennec_tpu_torch/csrc/jpeg_emit.cu.  The port
// does not use it.
//
// Kernel K3: Huffman emission of baseline JPEG scans, CUDA C++ for sm_90a.
//
// Replaces the XLA programs of fennec_tpu/ops/jpeg_emit.py that code a
// scan on the accelerator: scan_symbol_hist_device (:306) and
// emit_scan_device (:587).  The plain PyTorch version, which the CPU runs
// and this kernel is held to bit for bit, is fennec_tpu_torch/ops/
// jpeg_emit.py; the wrapper is ops/jpeg_emit_cuda.py.
//
// Two launches over (B, NT, 64) int16 quantized blocks of one geometry:
//
//   K3a fennec_jpeg_block_stats: one thread per block (scan slot g of
//       image blockIdx.y).  It computes the block's symbols as the C++
//       encoder does (entropy.cpp encode_block): the DC difference against
//       the previous block of the same component in MCU order, read
//       directly from that block (no serial chain); r zeros before a
//       nonzero AC coefficient cost r / 16 ZRLs and the symbol
//       (r % 16) << 4 | size; EOB exactly when zigzag position 63 is zero.
//       It writes the block's bit count under the tables it is given and
//       adds its symbols into the image's (2, 16) DC and (2, 256) AC
//       histograms: shared-memory integer atomics, then one global integer
//       atomic per nonzero bin, so the counts do not depend on order.
//   (between the launches, torch.cumsum takes the exclusive scan of the
//       block bits per image in slot order, in int64.)
//   K3b fennec_jpeg_deposit: one thread per block again.  It walks the
//       same symbols and packs their fields into a 64-bit accumulator,
//       starting at its block's global bit offset.  A word that only this
//       block covers is stored; the first and the last word, which it may
//       share with its neighbours, take atomicOr.  Bit ranges are
//       disjoint, so OR is exact and the words do not depend on order.
//       A word outside its image's range sets the flag word after the
//       buffer (the wrapper raises on it) instead of being written.
//
// Each CTA of 256 threads serves 256 consecutive slots of one image: it
// stages their blocks in shared memory (row stride 33 words, so the
// threads of a warp reading one zigzag position hit 32 banks), and the
// image's code tables (2 x 272 entries, code << 5 | length).
//
// Bound: each pass reads every block once, 128 bytes, and K3b writes the
// scan; that is ~37 MB and ~11 us per pass at 3.35 TB/s for a 12 MP 4:2:0
// image (285 768 blocks).  The instructions: ~64 shared-memory loads and
// compares per block plus ~12 per nonzero coefficient (~2 x 10^8 a pass
// at 12 MP and quality 75, ~7 us at the card's integer issue rate), so
// bytes bound it.  The design keeps the simple one-thread-per-block form;
// the histogram atomics on a few hot bins (EOB, the small symbols) are
// its known cost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowWords = 33;  // 32 words of a block + 1 of padding
constexpr int kTable = 16 + 256;
constexpr int kHist = 2 * 16 + 2 * 256;
constexpr int kZrl = 0xF0;

__constant__ int c_zigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__device__ __forceinline__ int bit_length(int v) {
  return v == 0 ? 0 : 32 - __clz(v < 0 ? -v : v);
}

__device__ __forceinline__ uint32_t magnitude(int v, int size) {
  return (uint32_t)(v >= 0 ? v : v + (1 << size) - 1);
}

// Stage the CTA's blocks (slots g0 .. g0+255 of one image) and the
// image's tables in shared memory.  Eight lanes load one 128-byte block
// as 16-byte vectors.
__device__ __forceinline__ void stage(const int16_t* __restrict__ img,
                                      const int* __restrict__ slot_row,
                                      int nt, int g0,
                                      const int* __restrict__ tables,
                                      uint32_t* rows, int* tab) {
  for (int i = threadIdx.x; i < 2 * kTable; i += kThreads) tab[i] = tables[i];
  for (int i = threadIdx.x; i < kThreads * 8; i += kThreads) {
    const int blk = i >> 3, part = i & 7;
    const int g = g0 + blk;
    if (g >= nt) continue;
    const uint4 v = reinterpret_cast<const uint4*>(
        img + (size_t)slot_row[g] * 64)[part];
    uint32_t* dst = rows + blk * kRowWords + part * 4;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads)
    block_stats_kernel(const int16_t* __restrict__ blocks, int nt,
                       const int* __restrict__ slot_row,
                       const int* __restrict__ prev_row, int ny,
                       const int* __restrict__ tables, int tables_stride,
                       int* __restrict__ block_bits, int* __restrict__ hist) {
  __shared__ uint32_t rows[kThreads * kRowWords];
  __shared__ int tab[2 * kTable];
  __shared__ int shist[kHist];
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * kThreads;
  const int16_t* img = blocks + (size_t)b * nt * 64;
  if (hist != nullptr)
    for (int i = threadIdx.x; i < kHist; i += kThreads) shist[i] = 0;
  stage(img, slot_row, nt, g0, tables + (size_t)b * tables_stride, rows, tab);
  __syncthreads();

  const int g = g0 + threadIdx.x;
  if (g < nt) {
    const int row = slot_row[g];
    const int cls = row >= ny ? 1 : 0;
    const int* dc_tab = tab + cls * kTable;
    const int* ac_tab = dc_tab + 16;
    int* dc_hist = shist + cls * 16;
    int* ac_hist = shist + 32 + cls * 256;
    const int16_t* blk =
        reinterpret_cast<const int16_t*>(rows + threadIdx.x * kRowWords);
    const int pr = prev_row[g];
    const int pdc = pr >= 0 ? img[(size_t)pr * 64] : 0;
    const int s_dc = bit_length(blk[0] - pdc);
    const int dc_sym = s_dc < 15 ? s_dc : 15;
    int bits = (dc_tab[dc_sym] & 31) + s_dc;
    if (hist != nullptr) atomicAdd(dc_hist + dc_sym, 1);
    const int zrl_len = ac_tab[kZrl] & 31;
    int last = 0;
    for (int k = 1; k < 64; ++k) {
      const int v = blk[c_zigzag[k]];
      if (v == 0) continue;
      const int run = k - last - 1;
      const int s = bit_length(v);
      const int sym = (((run & 15) << 4) | s) & 255;
      bits += (run >> 4) * zrl_len + (ac_tab[sym] & 31) + s;
      if (hist != nullptr) {
        atomicAdd(ac_hist + sym, 1);
        if (run >= 16) atomicAdd(ac_hist + kZrl, run >> 4);
      }
      last = k;
    }
    if (blk[63] == 0) {  // zigzag position 63 is natural index 63
      bits += ac_tab[0] & 31;
      if (hist != nullptr) atomicAdd(ac_hist, 1);
    }
    if (block_bits != nullptr) block_bits[(size_t)b * nt + g] = bits;
  }
  if (hist != nullptr) {
    __syncthreads();
    for (int i = threadIdx.x; i < kHist; i += kThreads)
      if (shist[i] != 0) atomicAdd(hist + (size_t)b * kHist + i, shist[i]);
  }
}

// Writes a block's fields from global bit `off` on.  The words of image
// b are [lo, hi).
struct BitSink {
  uint32_t* words;
  uint32_t* flag;
  long long cur, lo, hi;
  unsigned long long acc;
  int n;
  bool first;

  __device__ BitSink(uint32_t* w, uint32_t* f, long long off, long long l,
                     long long h)
      : words(w), flag(f), cur(off >> 5), lo(l), hi(h), acc(0),
        n((int)(off & 31)), first(true) {}

  __device__ __forceinline__ void store(uint32_t w, bool shared) {
    if (cur < lo || cur >= hi) {
      atomicOr(flag, 1u);
    } else if (shared) {
      atomicOr(words + cur, w);
    } else {
      words[cur] = w;
    }
  }

  // len <= 32; n < 32 on entry, so one word at most becomes full.
  __device__ __forceinline__ void put(uint32_t v, int len) {
    acc = (acc << len) | v;
    n += len;
    if (n >= 32) {
      n -= 32;
      store((uint32_t)(acc >> n), first);
      first = false;
      ++cur;
    }
  }

  __device__ __forceinline__ void finish() {
    if (n > 0) store((uint32_t)(acc << (32 - n)), true);
  }
};

__global__ void __launch_bounds__(kThreads)
    deposit_kernel(const int16_t* __restrict__ blocks, int nt,
                   const int* __restrict__ slot_row,
                   const int* __restrict__ prev_row, int ny,
                   const int* __restrict__ tables, int tables_stride,
                   const long long* __restrict__ block_off,
                   const long long* __restrict__ word_base,
                   uint32_t* words, uint32_t* flag) {
  __shared__ uint32_t rows[kThreads * kRowWords];
  __shared__ int tab[2 * kTable];
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * kThreads;
  const int16_t* img = blocks + (size_t)b * nt * 64;
  stage(img, slot_row, nt, g0, tables + (size_t)b * tables_stride, rows, tab);
  __syncthreads();

  const int g = g0 + threadIdx.x;
  if (g >= nt) return;
  const int row = slot_row[g];
  const int* dc_tab = tab + (row >= ny ? kTable : 0);
  const int* ac_tab = dc_tab + 16;
  const int16_t* blk =
      reinterpret_cast<const int16_t*>(rows + threadIdx.x * kRowWords);
  const int pr = prev_row[g];
  const int pdc = pr >= 0 ? img[(size_t)pr * 64] : 0;
  const long long lo = word_base[b];
  BitSink sink(words, flag, lo * 32 + block_off[(size_t)b * nt + g], lo,
               word_base[b + 1]);

  const int diff = blk[0] - pdc;
  const int s_dc = bit_length(diff);
  const int dc = dc_tab[s_dc < 15 ? s_dc : 15];
  sink.put(((uint32_t)(dc >> 5) << s_dc) | magnitude(diff, s_dc),
           (dc & 31) + s_dc);
  const int zrl = ac_tab[kZrl];
  int last = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = blk[c_zigzag[k]];
    if (v == 0) continue;
    int run = k - last - 1;
    for (; run >= 16; run -= 16) sink.put((uint32_t)(zrl >> 5), zrl & 31);
    const int s = bit_length(v);
    const int e = ac_tab[((run << 4) | s) & 255];
    sink.put(((uint32_t)(e >> 5) << s) | magnitude(v, s), (e & 31) + s);
    last = k;
  }
  if (blk[63] == 0) sink.put((uint32_t)(ac_tab[0] >> 5), ac_tab[0] & 31);
  sink.finish();
}

}  // namespace

extern "C" {

const char* fennec_jpeg_emit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K3a.  blocks (nimg, nt, 64) int16; slot_row, prev_row (nt,) int32;
// tables (nimg or 1, 2, 272) int32 with tables_stride 544 or 0;
// block_bits (nimg, nt) int32 and hist (nimg, 544) int32, either NULL.
// Returns a cudaError_t.
int fennec_jpeg_block_stats(const void* blocks, int nimg, int nt,
                            const void* slot_row, const void* prev_row,
                            int ny, const void* tables, int tables_stride,
                            void* block_bits, void* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hist != nullptr) {
    cudaError_t err =
        cudaMemsetAsync(hist, 0, (size_t)nimg * kHist * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((nt + kThreads - 1) / kThreads, nimg);
  block_stats_kernel<<<grid, kThreads, 0, s>>>(
      (const int16_t*)blocks, nt, (const int*)slot_row,
      (const int*)prev_row, ny, (const int*)tables, tables_stride,
      (int*)block_bits, (int*)hist);
  return (int)cudaGetLastError();
}

// K3b.  block_off (nimg, nt) int64 exclusive bit offsets in slot order;
// word_base (nimg + 1,) int64; words (n_words + 1,) 32-bit, zeroed here,
// the last one the out-of-range flag.  Returns a cudaError_t.
int fennec_jpeg_deposit(const void* blocks, int nimg, int nt,
                        const void* slot_row, const void* prev_row, int ny,
                        const void* tables, int tables_stride,
                        const void* block_off, const void* word_base,
                        void* words, long long n_words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(words, 0, (size_t)(n_words + 1) * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nt + kThreads - 1) / kThreads, nimg);
  deposit_kernel<<<grid, kThreads, 0, s>>>(
      (const int16_t*)blocks, nt, (const int*)slot_row,
      (const int*)prev_row, ny, (const int*)tables, tables_stride,
      (const long long*)block_off, (const long long*)word_base,
      (uint32_t*)words, (uint32_t*)words + n_words);
  return (int)cudaGetLastError();
}

}  // extern "C"
