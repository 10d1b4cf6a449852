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
// luminance reads the image again (58 us).
//
// Design, simple first.  The DCT: persistent CTAs of 256 threads walk
// tiles of up to 21 MCUs of one MCU row (126 blocks).  Per tile, threads
// load the pixels (a 2x2 quad a thread in 4:2:0, 16-byte loads, the
// coordinates clamped to the image: the edge replicate), convert them and
// write the level-shifted samples into shared memory; then a warp takes
// four blocks at a time, lane l summing coefficients l and l + 32 from the
// transposed matrix in shared memory, and stores each block's 64 floats
// straight to its place.  The luminance: a CTA per output row and 32
// output columns; each thread sums a source column over the rectangle's
// rows (coalesced 16-byte loads), then adds the integer sums into the
// rectangles that hold the column (shared-memory atomics on integers:
// exact in any order).  Built with --fmad=false, so the colour maths is
// the plain version's, operation for operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBlocks = 128;
constexpr int kLumCols = 32;  // output columns of a luminance CTA
constexpr int kSmemBytes = (kTileBlocks * 64 + 64 * 64) * 4;

struct Fdct {
  const float* img;      // (nimg, h, w, 4)
  long long img_stride;  // floats between images
  int h, w, sub;
  int mcus_x, mcus_y, tile_mcus, tiles_x, nimg;
  const float* kron;     // (64, 64)
  float* out[3];         // Y (nimg, ny, 64), Cb and Cr (nimg, nc, 64)
  int ny, nc;
};

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

__device__ __forceinline__ float4 pixel(const Fdct& f, const float* img,
                                        int y, int x) {
  y = min(y, f.h - 1);
  x = min(x, f.w - 1);
  return __ldg(reinterpret_cast<const float4*>(img) + (long long)y * f.w + x);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads) fdct_kernel(const Fdct f) {
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;                     // [kTileBlocks][64] samples
  float* kt = buf + kTileBlocks * 64;    // kt[p][k] = kron[k][p]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 64 * 64; i += kThreads)
    kt[(i & 63) * 64 + (i >> 6)] = __ldg(f.kron + i);
  const int bpm = f.sub ? 6 : 3;
  const long long per_img = (long long)f.mcus_y * f.tiles_x;
  const long long ntiles = per_img * f.nimg;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int img = (int)(t / per_img);
    const int rem = (int)(t - (long long)img * per_img);
    const int my = rem / f.tiles_x;
    const int mx0 = (rem - my * f.tiles_x) * f.tile_mcus;
    const int nm = min(f.tile_mcus, f.mcus_x - mx0);
    const int nblk = nm * bpm;
    const float* src = f.img + (long long)img * f.img_stride;
    __syncthreads();  // the last tile's blocks are read (and kt is set)

    // 1. Pixels to level-shifted samples.  Run layout: 4:2:0 the MCUs'
    // four luma blocks each (m * 4 + 2 by + bx), then nm Cb, nm Cr;
    // 4:4:4 nm Y, nm Cb, nm Cr.
    if (f.sub) {
      for (int i = tid; i < 8 * nm * 8; i += kThreads) {
        const int qy = i / (nm * 8), qx = i - qy * (nm * 8);
        const int gy = my * 16 + 2 * qy, gx = (mx0 * 8 + qx) * 2;
        float ys[2][2], cbs[2][2], crs[2][2];
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
            to_ycc(pixel(f, src, gy + dy, gx + dx), ys[dy][dx],
                   cbs[dy][dx], crs[dy][dx]);
        const int m = qx >> 3;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int py = 2 * qy + dy;
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int px = 2 * (qx & 7) + dx;  // within the MCU
            const int blk = m * 4 + (py >> 3) * 2 + (px >> 3);
            buf[blk * 64 + (py & 7) * 8 + (px & 7)] = ys[dy][dx] - 128.0f;
          }
        }
        // The 2x2 mean: ((c00 + c01) + c10) + c11, times 1/4.
        const float cb = (((cbs[0][0] + cbs[0][1]) + cbs[1][0]) +
                          cbs[1][1]) * 0.25f;
        const float cr = (((crs[0][0] + crs[0][1]) + crs[1][0]) +
                          crs[1][1]) * 0.25f;
        const int pos = qy * 8 + (qx & 7);
        buf[(4 * nm + m) * 64 + pos] = cb - 128.0f;
        buf[(5 * nm + m) * 64 + pos] = cr - 128.0f;
      }
    } else {
      for (int i = tid; i < 8 * nm * 8; i += kThreads) {
        const int py = i / (nm * 8), px = i - py * (nm * 8);
        float y, cb, cr;
        to_ycc(pixel(f, src, my * 8 + py, mx0 * 8 + px), y, cb, cr);
        const int m = px >> 3, pos = py * 8 + (px & 7);
        buf[m * 64 + pos] = y - 128.0f;
        buf[(nm + m) * 64 + pos] = cb - 128.0f;
        buf[(2 * nm + m) * 64 + pos] = cr - 128.0f;
      }
    }
    __syncthreads();

    // 2. The product, four blocks a warp: coefficients lane and lane + 32.
    for (int g = warp * 4; g < nblk; g += kWarps * 4) {
      float acc[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = 0.0f;
      for (int p = 0; p < 64; p += 4) {
        float4 xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv[j] = g + j < nblk ? *reinterpret_cast<const float4*>(
                                     buf + (g + j) * 64 + p)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const float m0 = kt[(p + pp) * 64 + lane];
          const float m1 = kt[(p + pp) * 64 + lane + 32];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x = lane_of(xv[j], pp);
            acc[j][0] = fmaf(x, m0, acc[j][0]);
            acc[j][1] = fmaf(x, m1, acc[j][1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int blk = g + j;
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
        dst[lane] = acc[j][0];
        dst[lane + 32] = acc[j][1];
      }
    }
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fdct_kernel,
                                                        kThreads, kSmemBytes);
  return err == cudaSuccess ? n : -(int)err;
}

// The DCT.  img (nimg, h, w, 4) float32, 16-byte aligned, image i at img +
// i * img_stride floats, rows of w pixels contiguous; sub 1 for 4:2:0;
// kron the (64, 64) float32 matrix; y (nimg, ny, 64), cb and cr (nimg, nc,
// 64) float32 with ny and nc the blocks of the padded planes; tile_mcus
// MCUs a tile (<= 21 in 4:2:0, <= 42 in 4:4:4); ctas the grid.  One launch
// on `stream`; returns the CUDA error.
int fennec_fdct(const void* img, long long img_stride, int nimg, int h, int w,
                int sub, const void* kron, int tile_mcus, int ctas, void* y,
                void* cb, void* cr, void* stream) {
  Fdct f = {};
  const int mcu = sub ? 16 : 8;
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
  fdct_kernel<<<grid, kThreads, kSmemBytes,
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
