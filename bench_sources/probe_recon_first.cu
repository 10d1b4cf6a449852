// Kernel K2: the probe reconstruction of the quality search, CUDA C++ for
// sm_90a.
//
// Replaces the XLA programs the JAX package compiles for one probe of
// fennec_tpu/engine/compress.py: _qd_plane (:96), _idct_plane (:126),
// _reconstruct_rgb_planes (:140), _box_down_plane (:166) and the luminance
// after them.  The plain PyTorch version, which the CPU runs and this
// kernel is held against on the card, is probe_luminance_plain of
// fennec_tpu_torch/engine/compress.py; the wrapper is
// ops/probe_recon_cuda.py.
//
// Input: the float32 forward-DCT coefficient planes of B images of one
// geometry, (B, ph, pw) luma and (B, ch, cw) Cb and Cr (coefficient (u, v)
// of block (I, J) at plane position (8 I + u, 8 J + v)), and a (B,) int64
// quality on the device.  Output: the SSIMFast luminance (B, dh, dw) of the
// image a decoder would reconstruct from the file at that quality.  Per
// pixel: quantize and dequantize each coefficient at the image's table,
// the 8x8 IDCT, + 128, chroma replicated 2x2 when subsampled, the crop to
// (h, w), YCbCr -> RGB rounded half away and clamped to [0, 255], and, for
// an image over 512 px on a side, the box mean of each of r, g, b over the
// output pixel's rectangle, rounded; then 0.299 r + 0.587 g + 0.114 b.
//
// What bounds it on an H100: bytes.  A probe reads each coefficient once
// (6 B a pixel in 4:2:0, 12 B in 4:4:4) and writes (dh, dw) floats: 73 MB
// at 12 MP 4:2:0, 22 us at 3.35 TB/s, against ~40 flops a coefficient (the
// two 8-term passes), 11 us at 67 TFLOP/s.  The plain version moves the
// same planes through a dozen full-size temporaries.  This first kernel is
// simple: everything between the coefficient planes and the luminance
// stays in shared memory and registers.
//
//   A CTA of 128 threads owns a tile of 16 x 128 pixels (one row of eight
//   4:2:0 MCUs).  Row pass: a thread takes eight coefficients of one plane
//   row (two 16-byte loads), quantizes and dequantizes them, and forms the
//   eight row sums; column pass: a thread takes one column of one block
//   from shared memory and forms its eight pixels.  Colour: a thread per
//   pixel, coalesced.
//
//   Arithmetic.  Quantize-dequantize is three separate float32 roundings,
//   as the plain version has them: c / q (IEEE division), sign * floor(|s|
//   + 0.5) with the float32 add, times q.  Each IDCT sum is eight fused
//   multiply-adds in ascending index order from 0, which is how a float32
//   GEMM with an inner dimension of 8 accumulates; the plain version takes
//   these sums in its GEMM library's order, so a pixel within an ulp of
//   k + 0.5 can land on the other level (counted on the card by
//   chip_smoke.py).  The colour maths and the luminance are unfused
//   multiplies and adds in the plain version's order (intrinsics, and the
//   file is built with --fmad=false).  No TF32, no tensor cores.
//
//   The box mean is exact.  r, g, b are integers in shared memory; a
//   thread sums the part of an output rectangle that lies in the tile and
//   adds it to a (B, 3, dh, dw) int32 buffer with one integer atomic, so
//   the sums do not depend on how CTAs are scheduled, and an image scores
//   the same alone and in a batch.  A second small kernel rounds
//   floor((2 sum + n) / (2 n)), the exact mean of n pixels rounded half
//   up, in integers, and forms the luminance.  (The plain version
//   multiplies by float32 1 / count inside two matrix products: where the
//   exact mean is k + 1/2 and 1 / count is inexact it rounds by its own
//   noise.)  The rectangles and, for each source row and column, the range
//   of rectangles that hold it come from the host (ops/filters.box_bounds),
//   so degenerate geometries (a side under 8 px scaled up, empty
//   rectangles) need no special case here.  Without a downsample the
//   colour pass writes the luminance itself and there is no second kernel.
//   No float atomics anywhere.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileH = 16;    // pixel rows of a CTA's tile
constexpr int kTileW = 128;   // pixel columns of a CTA's tile
constexpr int kFinishThreads = 256;

struct Probe {
  const float* y;            // (B, ph, pw)
  const float* cb;           // (B, ch, cw)
  const float* cr;           // (B, ch, cw)
  int ph, pw, ch, cw;        // padded plane sizes, multiples of 8
  int h, w;                  // the image
  int sub;                   // 1 when chroma is subsampled 2x2, else 0
  const float* qtables;      // (101, 2, 64) [luma, chroma] by quality
  const long long* quality;  // (B,), clamped to [0, 100] here
  const float* dmat;         // (8, 8) DCT matrix D: coef = D x
  int dh, dw;                // the output
  // With a downsample: y0, y1 (dh), x0, x1 (dw), then for every source
  // row its first and one-past-last rectangle (h, h), then the same for
  // every source column (w, w).  Else null.
  const int* bounds;
  float* lum;                // (B, dh, dw)
  int* acc;                  // (B, 3, dh, dw) zeroed, or null
};

// engine/compress._qd_plane for one coefficient: three roundings.
__device__ __forceinline__ float requantize(float c, float q) {
  const float s = __fdiv_rn(c, q);
  const float f = floorf(__fadd_rn(fabsf(s), 0.5f));
  return __fmul_rn(s < 0.0f ? -f : (s > 0.0f ? f : 0.0f), q);
}

// ops/color.clamp_u8.
__device__ __forceinline__ float clamp_u8(float x) {
  return fminf(fmaxf(floorf(__fadd_rn(x, 0.5f)), 0.0f), 255.0f);
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                   __fmul_rn(0.114f, b));
}

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of one coefficient
// plane (ph x pw) into dst (row stride kTileW), quantized and dequantized
// at the 64-entry table q, after the row pass of the IDCT:
// dst[r][8 J + j] = sum_v C[r][8 J + v] D[v][j].
__device__ __forceinline__ void row_pass(const float* __restrict__ plane,
                                         int ph, int pw, int r0, int c0,
                                         int rows, int cols, const float* q,
                                         const float* d, float* dst) {
  const int nbx = cols >> 3;
  for (int i = threadIdx.x; i < rows * nbx; i += kThreads) {
    const int bx = i % nbx;
    const int r = i / nbx;
    const int gr = r0 + r;
    const int gc = c0 + 8 * bx;
    if (gr >= ph || gc >= pw) continue;  // the tile hangs over the plane
    const float4* src =
        reinterpret_cast<const float4*>(plane + (size_t)gr * pw + gc);
    const float4 lo = src[0];
    const float4 hi = src[1];
    float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float* qr = q + 8 * (gr & 7);
#pragma unroll
    for (int v = 0; v < 8; ++v) x[v] = requantize(x[v], qr[v]);
    float out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < 8; ++v) s = fmaf(x[v], d[8 * v + j], s);
      out[j] = s;
    }
    float4* to = reinterpret_cast<float4*>(dst + r * kTileW + 8 * bx);
    to[0] = make_float4(out[0], out[1], out[2], out[3]);
    to[1] = make_float4(out[4], out[5], out[6], out[7]);
  }
}

// The column pass, in place, and the level shift:
// dst[8 I + i][x] = sum_u dst[8 I + u][x] D[u][i] + 128.
__device__ __forceinline__ void col_pass(int ph, int pw, int r0, int c0,
                                         int rows, int cols, const float* d,
                                         float* dst) {
  for (int i = threadIdx.x; i < (rows >> 3) * cols; i += kThreads) {
    const int x = i % cols;
    const int by = i / cols;
    if (r0 + 8 * by >= ph || c0 + x >= pw) continue;
    float* col = dst + 8 * by * kTileW + x;
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = col[u * kTileW];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) s = fmaf(t[u], d[8 * u + k], s);
      col[k * kTileW] = __fadd_rn(s, 128.0f);
    }
  }
}

__global__ void __launch_bounds__(kThreads) probe_recon_kernel(const Probe p) {
  __shared__ __align__(16) float ys[kTileH * kTileW];
  __shared__ __align__(16) float cs[2][kTileH * kTileW];
  __shared__ unsigned char rgb[3][kTileH * kTileW];
  __shared__ float dmat[64];
  __shared__ float qtab[128];

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  if (ty0 >= p.h || tx0 >= p.w) return;  // a tile of padding only

  long long q = p.quality[b];
  q = q < 0 ? 0 : (q > 100 ? 100 : q);
  for (int i = threadIdx.x; i < 128; i += kThreads)
    qtab[i] = p.qtables[q * 128 + i];
  for (int i = threadIdx.x; i < 64; i += kThreads) dmat[i] = p.dmat[i];
  __syncthreads();

  // The three planes of the tile: row pass, then column pass.
  const int shift = p.sub;
  const int crows = kTileH >> shift;
  const int ccols = kTileW >> shift;
  const int cy0 = ty0 >> shift;
  const int cx0 = tx0 >> shift;
  const float* plane_y = p.y + (size_t)b * p.ph * p.pw;
  const float* plane_cb = p.cb + (size_t)b * p.ch * p.cw;
  const float* plane_cr = p.cr + (size_t)b * p.ch * p.cw;
  row_pass(plane_y, p.ph, p.pw, ty0, tx0, kTileH, kTileW, qtab, dmat, ys);
  row_pass(plane_cb, p.ch, p.cw, cy0, cx0, crows, ccols, qtab + 64, dmat,
           cs[0]);
  row_pass(plane_cr, p.ch, p.cw, cy0, cx0, crows, ccols, qtab + 64, dmat,
           cs[1]);
  __syncthreads();
  col_pass(p.ph, p.pw, ty0, tx0, kTileH, kTileW, dmat, ys);
  col_pass(p.ch, p.cw, cy0, cx0, crows, ccols, dmat, cs[0]);
  col_pass(p.ch, p.cw, cy0, cx0, crows, ccols, dmat, cs[1]);
  __syncthreads();

  // Colour, pixel by pixel, inside the image only: chroma at (y / 2,
  // x / 2) of its padded plane when subsampled.
  const bool box = p.bounds != nullptr;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int px = i % kTileW;
    const int py = i / kTileW;
    const int gy = ty0 + py;
    const int gx = tx0 + px;
    if (gy >= p.h || gx >= p.w) continue;
    const float yv = ys[i];
    const int ci = (py >> shift) * kTileW + (px >> shift);
    const float cbc = __fsub_rn(cs[0][ci], 128.0f);
    const float crc = __fsub_rn(cs[1][ci], 128.0f);
    const float r = clamp_u8(__fadd_rn(yv, __fmul_rn(1.402f, crc)));
    const float g = clamp_u8(
        __fsub_rn(__fsub_rn(yv, __fmul_rn(0.344136286f, cbc)),
                  __fmul_rn(0.714136286f, crc)));
    const float bl = clamp_u8(__fadd_rn(yv, __fmul_rn(1.772f, cbc)));
    if (box) {
      rgb[0][i] = (unsigned char)r;
      rgb[1][i] = (unsigned char)g;
      rgb[2][i] = (unsigned char)bl;
    } else {
      p.lum[((size_t)b * p.h + gy) * p.w + gx] = luminance(r, g, bl);
    }
  }
  if (!box) return;
  __syncthreads();

  // The tile's share of every output rectangle it touches, per channel.
  const int* y0 = p.bounds;
  const int* y1 = y0 + p.dh;
  const int* x0 = y1 + p.dh;
  const int* x1 = x0 + p.dw;
  const int* row_lo = x1 + p.dw;
  const int* row_hi = row_lo + p.h;
  const int* col_lo = row_hi + p.h;
  const int* col_hi = col_lo + p.w;
  const int ra = ty0, rb = min(ty0 + kTileH, p.h);
  const int ca = tx0, cb = min(tx0 + kTileW, p.w);
  const int dy_a = row_lo[ra], dy_b = row_hi[rb - 1];
  const int dx_a = col_lo[ca], dx_b = col_hi[cb - 1];
  const int ncy = dy_b - dy_a;
  const int ncx = dx_b - dx_a;
  if (ncy <= 0 || ncx <= 0) return;
  for (int i = threadIdx.x; i < 3 * ncy * ncx; i += kThreads) {
    const int dx = dx_a + i % ncx;
    const int rest = i / ncx;
    const int dy = dy_a + rest % ncy;
    const int c = rest / ncy;
    const int ya = max(y0[dy], ra), yb = min(y1[dy], rb);
    const int xa = max(x0[dx], ca), xb = min(x1[dx], cb);
    if (ya >= yb || xa >= xb) continue;
    int sum = 0;
    for (int yy = ya; yy < yb; ++yy) {
      const unsigned char* line = rgb[c] + (yy - ty0) * kTileW;
      for (int xx = xa; xx < xb; ++xx) sum += line[xx - tx0];
    }
    atomicAdd(p.acc + (((size_t)b * 3 + c) * p.dh + dy) * p.dw + dx, sum);
  }
}

// The rounded mean of every rectangle and the luminance.
__global__ void __launch_bounds__(kFinishThreads)
    probe_finish_kernel(const int* __restrict__ acc,
                        const int* __restrict__ bounds, int nimg, int dh,
                        int dw, float* __restrict__ lum) {
  const long long cells = (long long)dh * dw;
  const long long idx = (long long)blockIdx.x * kFinishThreads + threadIdx.x;
  if (idx >= nimg * cells) return;
  const int b = (int)(idx / cells);
  const int cell = (int)(idx - b * cells);
  const int dy = cell / dw;
  const int dx = cell - dy * dw;
  const int* y0 = bounds;
  const int* y1 = y0 + dh;
  const int* x0 = y1 + dh;
  const int* x1 = x0 + dw;
  const long long n = (long long)(y1[dy] - y0[dy]) * (x1[dx] - x0[dx]);
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const long long s = acc[((size_t)b * 3 + c) * cells + cell];
    // floor(s / n + 1/2) in integers; an empty rectangle is 0, as a row
    // of zero weights makes it.
    v[c] = n > 0 ? (float)((2 * s + n) / (2 * n)) : 0.0f;
  }
  lum[idx] = luminance(v[0], v[1], v[2]);
}

}  // namespace

extern "C" {

const char* fennec_probe_recon_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K2.  y (nimg, ph, pw), cb and cr (nimg, ch, cw) float32, 16-byte
// aligned, ph, pw, ch, cw multiples of 8 and (ch, cw) = (ph, pw) / 2 when
// subsample, else (ph, pw); qtables (101, 2, 64) float32; quality (nimg,)
// int64; dmat (8, 8) float32.  Without a downsample (bounds NULL) lum is
// (nimg, h, w) and (dh, dw) = (h, w).  With one, bounds holds 2 dh + 2 dw
// + 2 h + 2 w int32 (see Probe), lum is (nimg, dh, dw) and acc (nimg, 3,
// dh, dw) int32, zeroed here.  Returns a cudaError_t.
int fennec_probe_recon(const void* y, const void* cb, const void* cr,
                       int nimg, int ph, int pw, int ch, int cw, int h,
                       int w, int subsample, const void* qtables,
                       const void* quality, const void* dmat, int dh, int dw,
                       const void* bounds, void* lum, void* acc,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nimg < 1 || nimg > 65535 || (bounds == nullptr) != (acc == nullptr) ||
      (bounds == nullptr && (dh != h || dw != w)))
    return (int)cudaErrorInvalidValue;
  Probe p;
  p.y = (const float*)y;
  p.cb = (const float*)cb;
  p.cr = (const float*)cr;
  p.ph = ph;
  p.pw = pw;
  p.ch = ch;
  p.cw = cw;
  p.h = h;
  p.w = w;
  p.sub = subsample ? 1 : 0;
  p.qtables = (const float*)qtables;
  p.quality = (const long long*)quality;
  p.dmat = (const float*)dmat;
  p.dh = dh;
  p.dw = dw;
  p.bounds = (const int*)bounds;
  p.lum = (float*)lum;
  p.acc = (int*)acc;
  const size_t cells = (size_t)nimg * dh * dw;
  if (acc != nullptr) {
    const cudaError_t err =
        cudaMemsetAsync(acc, 0, 3 * cells * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((pw + kTileW - 1) / kTileW, (ph + kTileH - 1) / kTileH,
                  nimg);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  probe_recon_kernel<<<grid, kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || acc == nullptr) return (int)err;
  probe_finish_kernel<<<(unsigned)((cells + kFinishThreads - 1) /
                                   kFinishThreads),
                        kFinishThreads, 0, s>>>(
      (const int*)acc, (const int*)bounds, nimg, dh, dw, (float*)lum);
  return (int)cudaGetLastError();
}

}  // extern "C"
