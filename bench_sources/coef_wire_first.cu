// Kept to be held bit for bit and timed in turns: chip_smoke.py builds this
// first version of K6 (a warp rebuilds one block and leaves) beside
// fennec_tpu_torch/csrc/coef_wire.cu and calls it through the port's
// wrappers (ops/coef_wire_cuda.py, given this library).  The port does not
// use it.
//
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
//                    (B, M): a tile-sum launch, then the rebuild, which
//                    scans its tile of counts itself;
//
// then, when the chunk has exception rows, one launch that sets them.
//
// What bounds it on an H100: bytes.  A 64-image 500x500 chunk is 393 216
// blocks: 50 MB of int16 written against 5 MB of COO read, so the write
// is the bound (about 15 us at 3.35 TB/s) and the kernel must store whole
// coalesced words.  The design: one warp per 8x8 block.  The warp zeroes
// its block's 64 int16 in shared memory, scatters the block's values
// through the zigzag -> natural table (in shared memory: lanes read
// different entries, which constant memory would serialise), sets DC, and
// stores the block as 32 int32 words, one per lane: each warp writes 128
// contiguous bytes.  The exceptions come after, one thread per row, in a
// second launch on the same stream (they are rare: scattered int16 stores).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kThreads;  // CSR: blocks per tile, one per thread

// The natural index of zigzag position k (fennec_tpu_torch/ops/dct.py
// ZIGZAG).
__constant__ unsigned char kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Stage {
  unsigned char zz[64];
  __align__(16) int16_t blocks[kWarps][64];
};

__device__ __forceinline__ void load_zigzag(Stage& s) {
  if (threadIdx.x < 64) s.zz[threadIdx.x] = kZigzag[threadIdx.x];
  __syncthreads();
}

// The warp's staged block: zeroed, filled by the caller between the two
// syncs, stored as 32 words.
__device__ __forceinline__ void zero_block(int16_t* blk, int lane) {
  reinterpret_cast<int*>(blk)[lane] = 0;
  __syncwarp();
}

__device__ __forceinline__ void store_block(const int16_t* blk, int lane,
                                            long long b, int* out) {
  __syncwarp();
  out[b * 32 + lane] = reinterpret_cast<const int*>(blk)[lane];
}

__global__ void __launch_bounds__(kThreads)
    coo_kernel(const int8_t* __restrict__ dc, const uint8_t* __restrict__ pos,
               const int8_t* __restrict__ val, int r, long long nblocks,
               int* __restrict__ out) {
  __shared__ Stage s;
  load_zigzag(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= nblocks) return;
  int16_t* blk = s.blocks[warp];
  zero_block(blk, lane);
  for (int k = lane; k < r; k += 32) {
    const unsigned p = pos[b * r + k];
    if (p != 0) blk[s.zz[p & 63]] = val[b * r + k];
  }
  if (lane == 0) blk[0] = dc[b];
  store_block(blk, lane, b, out);
}

__global__ void __launch_bounds__(kThreads)
    i8_kernel(const int8_t* __restrict__ in, int k, long long nblocks,
              int* __restrict__ out) {
  __shared__ Stage s;
  load_zigzag(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= nblocks) return;
  int16_t* blk = s.blocks[warp];
  zero_block(blk, lane);
  for (int j = lane; j < k; j += 32) blk[s.zz[j]] = in[b * k + j];
  store_block(blk, lane, b, out);
}

// CSR, pass 1: the sum of each tile of kTile counts, grid (tiles, B).
__global__ void __launch_bounds__(kThreads)
    csr_tile_sum_kernel(const uint8_t* __restrict__ counts, int nt, int tiles,
                        int* __restrict__ tile_sum) {
  __shared__ int warp_sum[kWarps];
  const int img = blockIdx.y, t = blockIdx.x;
  const int n = t * kTile + threadIdx.x;
  int c = n < nt ? counts[(long long)img * nt + n] : 0;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; w++) sum += warp_sum[w];
    tile_sum[(long long)img * tiles + t] = sum;
  }
}

// CSR, pass 2, grid (tiles, B): the tile's first pair (the tile sums
// before it), each block's first pair (an exclusive scan of the tile's
// counts), then a warp per block as in coo_kernel, its pairs read from
// the image's streams.
__global__ void __launch_bounds__(kThreads)
    csr_kernel(const int8_t* __restrict__ dc, const uint8_t* __restrict__ counts,
               const uint8_t* __restrict__ spos,
               const int8_t* __restrict__ sval, long long m, int nt, int tiles,
               const int* __restrict__ tile_sum, int* __restrict__ out) {
  __shared__ Stage s;
  __shared__ int warp_sum[kWarps];
  __shared__ int start[kTile];
  load_zigzag(s);
  const int img = blockIdx.y, t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The pairs of the tiles before this one.
  int before = 0;
  for (int j = threadIdx.x; j < t; j += kThreads)
    before += tile_sum[(long long)img * tiles + j];
  for (int o = 16; o > 0; o >>= 1)
    before += __shfl_down_sync(0xffffffffu, before, o);
  if (lane == 0) warp_sum[warp] = before;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < kWarps; w++) base += warp_sum[w];
  __syncthreads();
  // Exclusive scan of the tile's counts: within each warp, then across.
  const int n = t * kTile + threadIdx.x;
  const int c = n < nt ? counts[(long long)img * nt + n] : 0;
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int warp_base = base;
  for (int w = 0; w < warp; w++) warp_base += warp_sum[w];
  start[threadIdx.x] = warp_base + incl - c;
  __syncthreads();
  const long long row = (long long)img * m;
  int16_t* blk = s.blocks[warp];
  for (int i = warp; i < kTile; i += kWarps) {
    const int bn = t * kTile + i;
    if (bn >= nt) break;
    const long long b = (long long)img * nt + bn;
    const int first = start[i];
    const int cnt = counts[b];
    zero_block(blk, lane);
    for (int k = lane; k < cnt; k += 32) {
      const long long q = first + k;
      if (q < m) {
        const unsigned p = spos[row + q];
        if (p != 0) blk[s.zz[p & 63]] = sval[row + q];
      }
    }
    if (lane == 0) blk[0] = dc[b];
    store_block(blk, lane, b, out);
  }
}

// The exceptions, one thread per (image, row): live rows (row < n[image])
// with an offset inside the image's nt x width zigzag layout are set at
// their natural position.
__global__ void __launch_bounds__(kThreads)
    exceptions_kernel(const int* __restrict__ off,
                      const int16_t* __restrict__ val,
                      const int* __restrict__ n, int e, int nimg, int nt,
                      int width, int16_t* __restrict__ out) {
  __shared__ Stage s;
  load_zigzag(s);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)nimg * e) return;
  const int img = (int)(i / e), row = (int)(i % e);
  if (row >= n[img]) return;
  const int o = off[i];
  if (o < 0 || (long long)o >= (long long)nt * width) return;
  const long long b = (long long)img * nt + o / width;
  out[b * 64 + s.zz[o % width]] = val[i];
}

int exceptions(const void* off, const void* val, const void* n, int e,
               int nimg, int nt, int width, void* out, cudaStream_t stream) {
  if (e == 0) return (int)cudaSuccess;
  const long long rows = (long long)nimg * e;
  exceptions_kernel<<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads,
                      0, stream>>>((const int*)off, (const int16_t*)val,
                                   (const int*)n, e, nimg, nt, width,
                                   (int16_t*)out);
  return (int)cudaGetLastError();
}

unsigned grid_of(long long nblocks) {
  return (unsigned)((nblocks + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

const char* fennec_wire_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// COO: dc (nimg, nt) int8, pos / val (nimg, nt, r) uint8 / int8, the
// exceptions exc_off / exc_val (nimg, e) int32 / int16 and exc_n (nimg,)
// int32 (offsets into each image's nt x 64 zigzag layout); out (nimg, nt,
// 64) int16, written in full.  Returns the first cudaError_t.
int fennec_wire_coo(const void* dc, const void* pos, const void* val, int r,
                    int nimg, int nt, const void* exc_off,
                    const void* exc_val, const void* exc_n, int e, void* out,
                    void* stream) {
  if (nimg <= 0 || nt <= 0 || r < 1 || r > 63 || e < 0)
    return (int)cudaErrorInvalidValue;
  const long long nblocks = (long long)nimg * nt;
  coo_kernel<<<grid_of(nblocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)dc, (const uint8_t*)pos, (const int8_t*)val, r, nblocks,
      (int*)out);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return exceptions(exc_off, exc_val, exc_n, e, nimg, nt, 64, out,
                    (cudaStream_t)stream);
}

// Dense int8: in (nimg, nt, k) int8 in zigzag order; exceptions as for
// COO but with offsets into each image's nt x k layout.
int fennec_wire_i8(const void* in, int k, int nimg, int nt,
                   const void* exc_off, const void* exc_val,
                   const void* exc_n, int e, void* out, void* stream) {
  if (nimg <= 0 || nt <= 0 || k < 1 || k > 64 || e < 0)
    return (int)cudaErrorInvalidValue;
  const long long nblocks = (long long)nimg * nt;
  i8_kernel<<<grid_of(nblocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)in, k, nblocks, (int*)out);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return exceptions(exc_off, exc_val, exc_n, e, nimg, nt, k, out,
                    (cudaStream_t)stream);
}

// The tiles of a CSR chunk's images: scratch for fennec_wire_csr holds
// nimg * fennec_wire_csr_tiles(nt) int32.
int fennec_wire_csr_tiles(int nt) { return (nt + kTile - 1) / kTile; }

// CSR: dc (nimg, nt) int8, counts (nimg, nt) uint8, spos / sval (nimg, m)
// uint8 / int8 (image b's pairs in row b, block by block); scratch as
// above; exceptions as for COO.  Two launches, then the exceptions'.
int fennec_wire_csr(const void* dc, const void* counts, const void* spos,
                    const void* sval, long long m, int nimg, int nt,
                    void* scratch, const void* exc_off, const void* exc_val,
                    const void* exc_n, int e, void* out, void* stream) {
  if (nimg <= 0 || nt <= 0 || m < 0 || e < 0 || nimg > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = fennec_wire_csr_tiles(nt);
  const dim3 grid(tiles, nimg);
  csr_tile_sum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)counts, nt, tiles, (int*)scratch);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  csr_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)dc, (const uint8_t*)counts, (const uint8_t*)spos,
      (const int8_t*)sval, m, nt, tiles, (const int*)scratch, (int*)out);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return exceptions(exc_off, exc_val, exc_n, e, nimg, nt, 64, out,
                    (cudaStream_t)stream);
}

}  // extern "C"
