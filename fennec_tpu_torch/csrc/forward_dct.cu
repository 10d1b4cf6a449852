// Kernel K8: the forward DCT and the original's SSIMFast luminance, CUDA
// C++ for sm_90a.
//
// Replaces the XLA programs forward_dct_device of fennec_tpu/codecs/jpeg.py
// (:52) and, for the search's inputs, _box_down_plane of
// fennec_tpu/engine/compress.py (:166) with the luminance after it.  No
// Pallas kernel.  The plain PyTorch versions, which the CPU runs and this
// kernel is held against on the card, are forward_dct_plain
// (codecs/jpeg.py) and lum_orig_plain (engine/compress.py); the wrapper is
// ops/forward_dct_cuda.py.  Two entries over the same (nimg, h, w, 4)
// float32 images (rows contiguous, a batch stride of its own, so a band of
// rows is a view):
//
// fennec_fdct: per 8x8 block of each component, alpha composited as
//   rgb * (a * (1/255)), ops/color.rgb_to_ycbcr in its order, the plane
//   edge-replicated to a multiple of 16 (4:2:0) or 8, the 2x2 chroma mean
//   in 4:2:0, - 128, and the 64-term product with the float32 (64, 64)
//   matrix of ops/dct.dct_kron, summed over the pixels in ascending order
//   with fmaf.  Output: the (nimg, N, 64) float32 blocks of Y, Cb and Cr in
//   ops/dct.to_blocks' order.  Each block is computed alone, so an image's
//   coefficients are the same alone and inside a batch.
//
// fennec_lum_box / fennec_lum_pixels: the original's luminance as the
//   quality search reads it.  With the SSIMFast downsample, the box mean of
//   each of r, g and b over the output pixel's rectangle
//   (ops/resize.box_rectangles, or a band's band_rectangles), taken as
//   kernel K2 takes its probes' (ops/probe_recon_cuda.box_mean_exact): the
//   integer sum, then floor((2 sum + n) / (2 n)); without one, the pixels
//   themselves.  Then 0.299 r + 0.587 g + 0.114 b.  The pixels are
//   integral (every caller's images are), so the sums are exact.
//
// What bounds it on an H100: bytes.  At 12 MP 4:2:0 the DCT reads 195 MB
// of float32 RGBA and writes 73.2 MB of coefficients (80 us at 3.35
// TB/s) against 4096 multiply-adds a block (35 us at 67 TFLOP/s); the
// luminance reads the image again (58 us).  PR 16's DCT
// (bench_sources/forward_dct_first.cu) ran at 33-48 % of that: a tile's
// loads (__ldg by the threads that then computed), product and stores ran
// in turn, and its product made ~12 shared-memory wavefronts for 32
// warp-FMAs.  What holds this design back (clock64() stamps and edited
// builds, bench_sources/k7k8_variants.py): the dense product is ~40 us of
// FMA issue at 12 MP and only partly overlaps the bytes, since a CTA's
// conversion, product and wait for its next stage run in turn.
//
// Design of the DCT.  Persistent CTAs (two an SM) of eight consumer warps
// and one producer warp walk tiles of up to kTileBlocks blocks: 10 MCUs of
// one MCU row in 4:2:0, 21 in 4:4:4 (ops/forward_dct_cuda.tile_mcus).  Per
// tile:
//
//   0. Staging.  The producer warp fills a ring of kStages stages with TMA
//      bulk copies (cp.async.bulk, a full mbarrier a stage), a pixel row of
//      the tile a lane, 16 bytes a pixel, cut at w; rows past h are not
//      copied.  It refills a stage as soon as the eight consumer warps have
//      arrived on its empty mbarrier, and it never joins their barriers, so
//      a copy that waits for room in the TMA queue stalls no consumer.  The
//      edge replicate is a clamp of the coordinates read from the stage.
//
//   1. Conversion.  A thread takes a 2x2 quad (4:2:0) or a pixel (4:4:4),
//      converts it as the plain version does and writes the level-shifted
//      samples k-major: sample p of the tile's block b at p * 64 + ((b + 4
//      (p mod 8)) mod 64), a rotation that spreads a warp's stores over the
//      banks.  The tile's blocks: 4:2:0 each MCU's four luma blocks (m * 4
//      + 2 by + bx), then nm Cb, nm Cr; 4:4:4 nm Y, nm Cb, nm Cr.
//
//   2. The product, register-tiled: warp w takes blocks [8 w, 8 w + 8), a
//      lane 4 blocks x 4 coefficients; per pixel p one 16-byte load of its
//      blocks' samples (2 addresses a warp) and one of the transposed
//      matrix row (16): 3 wavefronts for 16 warp-FMAs, which keeps the FMA
//      pipe, not shared memory, the limit of the product.  Every sum is
//      fmaf over p ascending from +0, as before.  Each lane stores its
//      coefficients as 16-byte words: whole 128-byte lines a warp.
//
// The luminance: a CTA per output row and 32 output columns; each thread
// sums a source column over the rectangle's rows (coalesced 16-byte
// loads), then adds the integer sums into the rectangles that hold the
// column (shared-memory atomics on integers: exact in any order).  Built
// with --fmad=false, so the colour maths is the plain version's,
// operation for operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a luminance CTA
constexpr int kWarps = 8;  // consumer warps of a DCT CTA
constexpr int kConsumers = kWarps * 32;
constexpr int kDctThreads = kConsumers + 32;  // and one producer warp
constexpr int kTileBlocks = 64;  // blocks of a DCT tile
constexpr int kWarpBlocks = kTileBlocks / kWarps;  // 8
constexpr int kStages = 2;
constexpr int kStageBytes = 16 * 160 * 16;  // 16 rows of 10 4:2:0 MCUs
constexpr int kLumCols = 32;  // output columns of a luminance CTA
constexpr int kSmemBytes = kStages * kStageBytes +
                           (kTileBlocks * 64 + 64 * 64) * 4 + 2 * kStages * 8;

struct Fdct {
  const float* img;      // (nimg, h, w, 4)
  long long img_stride;  // floats between images
  int h, w, sub;
  int mcus_x, mcus_y, tile_mcus, tiles_x, nimg;
  const float* kron;     // (64, 64)
  float* out[3];         // Y (nimg, ny, 64), Cb and Cr (nimg, nc, 64)
  int ny, nc;
};

struct Tile {
  int img, my, mx0, nm;
};

__device__ __forceinline__ Tile tile_at(const Fdct& f, long long t) {
  const long long per_img = (long long)f.mcus_y * f.tiles_x;
  Tile T;
  T.img = (int)(t / per_img);
  const int rem = (int)(t - (long long)T.img * per_img);
  T.my = rem / f.tiles_x;
  T.mx0 = (rem - T.my * f.tiles_x) * f.tile_mcus;
  T.nm = min(f.tile_mcus, f.mcus_x - T.mx0);
  return T;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   shared_addr(bar))
               : "memory");
}

// The consumer warps' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from 16-byte aligned global src to 16-byte
// aligned shared dst, counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// The producer warp: tile t's pixel rows into stage st, row r by lane r
// (at r * tile_mcus * mcu pixels), each cut at w; rows past h are not
// copied.
__device__ __forceinline__ void issue(const Fdct& f, long long t,
                                      unsigned char* st, uint64_t* bar,
                                      int lane) {
  const Tile T = tile_at(f, t);
  const int mcu = f.sub ? 16 : 8;
  const int x0 = T.mx0 * mcu;
  const uint32_t row_bytes = (uint32_t)min(T.nm * mcu, f.w - x0) * 16;
  const int rows = min(mcu, f.h - T.my * mcu);
  if (lane == 0) bar_expect(bar, rows * row_bytes);
  if (lane < rows)
    bulk_load(st + lane * f.tile_mcus * mcu * 16,
              f.img + (long long)T.img * f.img_stride +
                  ((long long)(T.my * mcu + lane) * f.w + x0) * 4,
              row_bytes, bar);
}

// ops/color.rgb_to_ycbcr of the composited pixel, operation for
// operation; each constant is the float32 PyTorch makes of the Python
// float.
__device__ __forceinline__ void to_ycc(float4 p, float& y, float& cb,
                                       float& cr) {
  const float a = p.w * (float)(1.0 / 255.0);
  const float r = p.x * a, g = p.y * a, b = p.z * a;
  y = ((float)0.299 * r + (float)0.587 * g) + (float)0.114 * b;
  cb = ((128.0f - (float)0.168735892 * r) - (float)0.331264108 * g) +
       0.5f * b;
  cr = ((128.0f + 0.5f * r) - (float)0.418687589 * g) -
       (float)0.081312411 * b;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Sample p of the tile's block b in the k-major buffer.
__device__ __forceinline__ int kmajor(int p, int b) {
  return p * kTileBlocks + ((b + 4 * (p & 7)) & (kTileBlocks - 1));
}

__global__ void __launch_bounds__(kDctThreads, 2)
    fdct_kernel(const Fdct f) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stages = smem;  // [kStages][kStageBytes] pixels
  float* samp = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* kt = samp + kTileBlocks * 64;  // kt[p][k] = kron[k][p]
  uint64_t* full = reinterpret_cast<uint64_t*>(kt + 64 * 64);  // [kStages]
  uint64_t* empty = full + kStages;                             // [kStages]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 64 * 64; i += kDctThreads)
    kt[(i & 63) * 64 + (i >> 6)] = __ldg(f.kron + i);
  __syncthreads();

  const int mcu = f.sub ? 16 : 8;
  const int bpm = f.sub ? 6 : 3;
  const int sw = f.tile_mcus * mcu;  // stage pixels a row
  const long long ntiles = (long long)f.mcus_y * f.tiles_x * f.nimg;
  if (warp == kWarps) {
    // The producer: tile i into stage i mod kStages once the consumers
    // have converted the stage's last tile.
    int i = 0;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
      const int s = i % kStages;
      if (i >= kStages) bar_wait(&empty[s], (uint32_t)(i / kStages - 1) & 1);
      issue(f, t, stages + s * kStageBytes, &full[s], lane);
    }
    return;
  }
  const float4* kt4 = reinterpret_cast<const float4*>(kt);
  int it = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int s = it % kStages;
    unsigned char* st = stages + s * kStageBytes;
    const Tile T = tile_at(f, t);
    const int img = T.img, my = T.my, mx0 = T.mx0, nm = T.nm;
    const int nblk = nm * bpm;
    const int ylast = min(mcu, f.h - my * mcu) - 1;  // last staged row
    const int xlast = min(nm * mcu, f.w - mx0 * mcu) - 1;
    const float4* px = reinterpret_cast<const float4*>(st);
    bar_wait(&full[s], (uint32_t)(it / kStages) & 1);

    // 1. Pixels to level-shifted samples, at clamped coordinates.  Item i
    // of a row of nm * 8 is at row i / (nm * 8), as (i * inv) >> 20.
    const int inv = ((1 << 20) + nm * 8 - 1) / (nm * 8);
    if (f.sub) {
      for (int i = tid; i < 8 * nm * 8; i += kConsumers) {
        const int qy = (i * inv) >> 20, qx = i - qy * (nm * 8);
        float ys[2][2], cbs[2][2], crs[2][2];
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
            to_ycc(px[min(2 * qy + dy, ylast) * sw + min(2 * qx + dx, xlast)],
                   ys[dy][dx], cbs[dy][dx], crs[dy][dx]);
        const int m = qx >> 3;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int py = 2 * qy + dy;
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int pxl = 2 * (qx & 7) + dx;  // within the MCU
            const int blk = m * 4 + (py >> 3) * 2 + (pxl >> 3);
            samp[kmajor((py & 7) * 8 + (pxl & 7), blk)] = ys[dy][dx] - 128.0f;
          }
        }
        // The 2x2 mean: ((c00 + c01) + c10) + c11, times 1/4.
        const float cb = (((cbs[0][0] + cbs[0][1]) + cbs[1][0]) +
                          cbs[1][1]) * 0.25f;
        const float cr = (((crs[0][0] + crs[0][1]) + crs[1][0]) +
                          crs[1][1]) * 0.25f;
        const int pos = qy * 8 + (qx & 7);
        samp[kmajor(pos, 4 * nm + m)] = cb - 128.0f;
        samp[kmajor(pos, 5 * nm + m)] = cr - 128.0f;
      }
    } else {
      for (int i = tid; i < 8 * nm * 8; i += kConsumers) {
        const int py = (i * inv) >> 20, pxl = i - py * (nm * 8);
        float y, cb, cr;
        to_ycc(px[min(py, ylast) * sw + min(pxl, xlast)], y, cb, cr);
        const int m = pxl >> 3, pos = py * 8 + (pxl & 7);
        samp[kmajor(pos, m)] = y - 128.0f;
        samp[kmajor(pos, nm + m)] = cb - 128.0f;
        samp[kmajor(pos, 2 * nm + m)] = cr - 128.0f;
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with stage s
    consumers_sync();  // the samples written

    // 2. The product: lane (bg, og) sums blocks blk0..blk0+3,
    // coefficients 4 og..4 og+3, over the pixels ascending.
    const int blk0 = warp * kWarpBlocks + (lane & 1) * 4;
    const int og = lane >> 1;
    if (warp * kWarpBlocks < nblk) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
      for (int p = 0; p < 64; ++p) {
        const float4 xv =
            *reinterpret_cast<const float4*>(samp + kmajor(p, blk0));
        const float4 mv = kt4[p * 16 + og];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = lane_of(xv, i);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(x, lane_of(mv, j), acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int blk = blk0 + i;
        if (blk >= nblk) break;
        float* dst;
        if (f.sub) {
          if (blk < 4 * nm) {
            const int m = blk >> 2, by = (blk >> 1) & 1, bx = blk & 1;
            dst = f.out[0] + ((long long)img * f.ny +
                              (long long)(my * 2 + by) * (2 * f.mcus_x) +
                              (mx0 + m) * 2 + bx) * 64;
          } else {
            const int cc = (blk - 4 * nm) / nm, m = blk - (4 + cc) * nm;
            dst = (cc ? f.out[2] : f.out[1]) +
                  ((long long)img * f.nc + (long long)my * f.mcus_x + mx0 +
                   m) * 64;
          }
        } else {
          const int cc = blk / nm, m = blk - cc * nm;
          float* const base = cc == 0 ? f.out[0] : cc == 1 ? f.out[1]
                                                           : f.out[2];
          dst = base + ((long long)img * (cc ? f.nc : f.ny) +
                        (long long)my * f.mcus_x + mx0 + m) * 64;
        }
        reinterpret_cast<float4*>(dst)[og] =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    consumers_sync();  // the samples read before the next conversion
  }
}

// The box luminance: CTA (column group, output row, image).  rect: y0, y1
// (ndh each), x0, x1 (dw each), then for each of the h source rows and w
// source columns the first and one-past-last rectangle that holds it.
__global__ void __launch_bounds__(kThreads)
    lum_box_kernel(const float* img, long long img_stride, int h, int w,
                   const int* rect, int ndh, int dw, float* out) {
  __shared__ int acc[3][kLumCols];
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kLumCols, d1 = min(d0 + kLumCols, dw);
  const int dy = blockIdx.y, b = blockIdx.z;
  const int* y0 = rect;
  const int* y1 = rect + ndh;
  const int* x0 = rect + 2 * ndh;
  const int* x1 = x0 + dw;
  const int* clo = x1 + dw + 2 * h;
  const int* chi = clo + w;
  if (tid < 3 * kLumCols) acc[tid / kLumCols][tid % kLumCols] = 0;
  __syncthreads();
  const int ya = __ldg(y0 + dy), yb = __ldg(y1 + dy);
  const int xa = __ldg(x0 + d0), xb = __ldg(x1 + d1 - 1);
  const float4* src = reinterpret_cast<const float4*>(img + b * img_stride);
  for (int x = xa + tid; x < xb; x += kThreads) {
    const int lo = max(__ldg(clo + x), d0), hi = min(__ldg(chi + x), d1);
    if (lo >= hi) continue;
    int s0 = 0, s1 = 0, s2 = 0;
    for (int y = ya; y < yb; ++y) {
      const float4 p = __ldg(src + (long long)y * w + x);
      s0 += (int)p.x;
      s1 += (int)p.y;
      s2 += (int)p.z;
    }
    for (int d = lo; d < hi; ++d) {
      atomicAdd(&acc[0][d - d0], s0);
      atomicAdd(&acc[1][d - d0], s1);
      atomicAdd(&acc[2][d - d0], s2);
    }
  }
  __syncthreads();
  if (tid < d1 - d0) {
    const int d = d0 + tid;
    const long long n = (long long)(yb - ya) * (__ldg(x1 + d) - __ldg(x0 + d));
    float m[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      m[c] = n > 0 ? (float)((2 * (long long)acc[c][tid] + n) / (2 * n))
                   : 0.0f;
    out[((long long)b * ndh + dy) * dw + d] =
        ((float)0.299 * m[0] + (float)0.587 * m[1]) + (float)0.114 * m[2];
  }
}

// The luminance without a downsample: rows [0, rows) of each image.
__global__ void __launch_bounds__(kThreads)
    lum_pixels_kernel(const float* img, long long img_stride, int rows,
                      int w, int nimg, float* out) {
  const long long per_img = (long long)rows * w;
  const long long n = per_img * nimg;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long b = i / per_img, r = i - b * per_img;
    const float4 p =
        __ldg(reinterpret_cast<const float4*>(img + b * img_stride) + r);
    out[i] = ((float)0.299 * p.x + (float)0.587 * p.y) + (float)0.114 * p.z;
  }
}

cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fdct_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fdct_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

const char* fennec_fdct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// CTAs of the DCT that fit on one SM of the current device at once, or
// minus the CUDA error.
int fennec_fdct_ctas_per_sm() {
  cudaError_t err = prepare();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fdct_kernel, kDctThreads, kSmemBytes);
  return err == cudaSuccess ? n : -(int)err;
}

// The DCT.  img (nimg, h, w, 4) float32, 16-byte aligned, image i at img +
// i * img_stride floats (a multiple of 4), rows of w pixels contiguous;
// sub 1 for 4:2:0; kron the (64, 64) float32 matrix; y (nimg, ny, 64), cb
// and cr (nimg, nc, 64) float32, 16-byte aligned, with ny and nc the
// blocks of the padded planes; tile_mcus MCUs a tile (<= 10 in 4:2:0, <=
// 21 in 4:4:4); ctas the grid.  One launch on `stream`; returns the CUDA
// error (cudaErrorInvalidValue for a misaligned input or a tile past the
// kernel's buffers).
int fennec_fdct(const void* img, long long img_stride, int nimg, int h, int w,
                int sub, const void* kron, int tile_mcus, int ctas, void* y,
                void* cb, void* cr, void* stream) {
  Fdct f = {};
  const int mcu = sub ? 16 : 8;
  const bool aligned = (((uintptr_t)img | (uintptr_t)y | (uintptr_t)cb |
                         (uintptr_t)cr) & 15) == 0 && img_stride % 4 == 0;
  if (!aligned || tile_mcus < 1 || tile_mcus * (sub ? 6 : 3) > kTileBlocks ||
      mcu * tile_mcus * mcu * 16 > kStageBytes)
    return (int)cudaErrorInvalidValue;
  f.img = static_cast<const float*>(img);
  f.img_stride = img_stride;
  f.h = h, f.w = w, f.sub = sub, f.nimg = nimg;
  f.mcus_x = (w + mcu - 1) / mcu, f.mcus_y = (h + mcu - 1) / mcu;
  f.tile_mcus = tile_mcus;
  f.tiles_x = (f.mcus_x + tile_mcus - 1) / tile_mcus;
  f.kron = static_cast<const float*>(kron);
  f.out[0] = static_cast<float*>(y);
  f.out[1] = static_cast<float*>(cb);
  f.out[2] = static_cast<float*>(cr);
  f.ny = f.mcus_x * f.mcus_y * (sub ? 4 : 1);
  f.nc = f.mcus_x * f.mcus_y;
  const long long ntiles = (long long)nimg * f.mcus_y * f.tiles_x;
  if (ntiles == 0) return 0;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(ntiles < ctas ? ntiles : ctas);
  fdct_kernel<<<grid, kDctThreads, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(f);
  return (int)cudaGetLastError();
}

// The box luminance.  img as fennec_fdct's (h rows); rect int32 as
// ops/resize.box_rectangles or band_rectangles lays it out, for ndh output
// rows of dw columns over the h rows and w columns of img; out (nimg, ndh,
// dw) float32.
int fennec_lum_box(const void* img, long long img_stride, int nimg, int h,
                   int w, const void* rect, int ndh, int dw, void* out,
                   void* stream) {
  if (nimg == 0 || ndh == 0 || dw == 0) return 0;
  const dim3 grid((dw + kLumCols - 1) / kLumCols, ndh, nimg);
  lum_box_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), img_stride, h, w,
      static_cast<const int*>(rect), ndh, dw, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The luminance of rows [0, rows) of each image, pixel by pixel; out
// (nimg, rows, w) float32.
int fennec_lum_pixels(const void* img, long long img_stride, int nimg,
                      int rows, int w, void* out, void* stream) {
  const long long n = (long long)nimg * rows * w;
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 4096 ? blocks : 4096);
  lum_pixels_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), img_stride, rows, w, nimg,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
