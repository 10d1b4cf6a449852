// Kernel K7: the decode's device stage, CUDA C++ for sm_90a.
//
// Replaces the XLA programs the JAX package compiles for a decode:
// _decode_plane_device and _combine_planes_device of
// fennec_tpu/codecs/jpeg.py (:702, :715), and decode_jpeg_image_device of
// fennec_tpu/engine/compress.py (:556), the decode half of the batch
// coefficient path.  No Pallas kernel.  The plain PyTorch versions, which
// the CPU runs and this kernel is held against on the card, are
// reconstruct_plain (codecs/jpeg.py: _decode_plane, then _combine_planes)
// and decode_jpeg_image_plain (engine/compress.py); the wrapper is
// ops/decode_recon_cuda.py.
//
// Input: every component's quantized blocks, int16 in natural order on
// the MCU-padded grids (component c: mcus_y * v_c rows of mcus_x * h_c
// blocks), their quantization tables (int32), the sampling factors and the
// colour mode.  Per output pixel: dequantize, the 8x8 IDCT as the 64-term
// product with the float32 (64, 64) matrix dct_kron() (ops/dct.py) that
// idct2d_blocks multiplies by, + 128, each component replicated by
// (hmax / h, vmax / v), the crop to (h, w), the mode's colour (gray, rgb,
// ycbcr, cmyk, ycck; CMYK and YCCK as x * k // 255 in integers), round half
// away and clamp, alpha 255.  Output (nimg, h, w, 4): uint8 for one frame
// (codecs/jpeg._reconstruct, downloaded after), float32 for the batch path.
//
// Why the Kron matrix and not the 8-point matrix twice: row 0 of the
// float32 Kron matrix is exactly 0.125, so a block holding only its DC
// decodes to exactly c / 8 + 128 whatever the order of the sum, and such
// values often sit on a .5 tie (DC 1 at q = 4: 128.5, which rounds to
// 129).  With the 8-point float32 matrix the DC term is scaled by d00 *
// d00 = 0.12499999 instead, a few ulps below the tie before the + 128.
//
// What bounds it on an H100: at 12 MP 4:2:0 it reads 36.6 MB of blocks and
// writes 48.8 MB of RGBA (25 us at 3.35 TB/s); the product is 4096
// multiply-adds a block (35 us at 67 TFLOP/s), fewer for the zero
// coefficients it skips.  The colour is ~30 operations a pixel.
//
// Design, simple first.  Persistent CTAs of 256 threads (as many as the
// card holds at once) walk tiles: a tile is up to kTileBlocks blocks' worth
// of whole MCUs of one MCU row of one image.  Per tile:
//
//   1. Load and dequantize.  Each block is eight 16-byte loads; a thread
//      converts eight coefficients and multiplies each by its table entry
//      into shared memory (float32, one rounding, as the plain version).
//
//   2. IDCT.  A warp takes four blocks at a time; lane l sums outputs l and
//      l + 32 of each, over k ascending with fmaf, the matrix row k read
//      from shared memory.  A k whose coefficient is zero in all four
//      blocks is skipped: fmaf(0, m, s) is s for every sum the chains hold
//      (they start at +0), so the skip changes no bit.  Then + 128, written
//      in place.
//
//   3. Colour.  A thread takes a pixel column of the tile; the offset of
//      each component's sample in shared memory is a column part and a row
//      part, from tables the CTA builds once (they depend on the sampling
//      alone), so replication and the MCU layout cost two shared loads a
//      component.  The colour maths is the plain version's, operation for
//      operation, built with --fmad=false so nothing is contracted.  Rows
//      are stored coalesced, 4 or 16 bytes a pixel.
//
// Sampling factors must divide the largest (hmax % h == 0, vmax % v == 0):
// the wrapper checks it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBlocks = 128;   // blocks of a tile, all components
constexpr int kMaxComps = 4;
constexpr int kMaxRows = 32;       // 8 * vmax of an MCU, vmax <= 4
constexpr int kMaxCols = 1024;     // pixel columns of a tile (<= 1024 / vmax)

enum Mode { kGray = 0, kRgb = 1, kYcbcr = 2, kCmyk = 3, kYcck = 4 };

struct Frame {
  const int16_t* blocks[kMaxComps];  // image 0's first block
  long long img_stride[kMaxComps];   // blocks between images
  int bw[kMaxComps];                 // blocks per row of the component
  int hs[kMaxComps], vs[kMaxComps];  // sampling factors
  int tsel[kMaxComps];               // table row of the component
  const int* tables;                 // int32 tables
  int tab_stride;                    // ints between images' tables
  const float* kron;                 // (64, 64) float32
  int ncomp, hmax, vmax, mcus_x, mcus_y, h, w, mode, nimg;
  int tile_mcus, tiles_x;            // MCUs a tile, tiles per MCU row
  void* out;
  int out_f32;
};

constexpr int kSmemBytes =
    (kTileBlocks * 64 + 64 * 64 + kMaxComps * 64) * 4 +
    kMaxComps * (kMaxRows + kMaxCols) * 4 + 8 * kMaxComps * 4;

__device__ __forceinline__ float round_clamp(float x) {
  // torch.clamp(torch.floor(x + 0.5), 0, 255) (ops/color.clamp_u8).
  return fminf(fmaxf(floorf(x + 0.5f), 0.0f), 255.0f);
}

// ops/color.ycbcr_to_rgb, operation for operation; each constant is the
// float32 that PyTorch makes of the Python float.
__device__ __forceinline__ void ycbcr_rgb(float y, float cb, float cr,
                                          float* rgb) {
  const float cbc = cb - 128.0f, crc = cr - 128.0f;
  rgb[0] = y + (float)1.402 * crc;
  rgb[1] = (y - (float)0.344136286 * cbc) - (float)0.714136286 * crc;
  rgb[2] = y + (float)1.772 * cbc;
}

__device__ __forceinline__ void colour(int mode, const float* v,
                                       float* rgb) {
  if (mode == kGray) {
    const float y = round_clamp(v[0]);
    rgb[0] = rgb[1] = rgb[2] = y;
  } else if (mode == kRgb) {
    for (int i = 0; i < 3; ++i) rgb[i] = round_clamp(v[i]);
  } else if (mode == kYcbcr) {
    ycbcr_rgb(v[0], v[1], v[2], rgb);
    for (int i = 0; i < 3; ++i) rgb[i] = round_clamp(rgb[i]);
  } else {  // kCmyk, kYcck: x * k // 255 on the rounded planes
    float base[3];
    if (mode == kYcck) {
      ycbcr_rgb(v[0], v[1], v[2], base);
    } else {
      base[0] = v[0], base[1] = v[1], base[2] = v[2];
    }
    const int k = (int)round_clamp(v[3]);
    for (int i = 0; i < 3; ++i)
      rgb[i] = (float)(((int)round_clamp(base[i]) * k) / 255);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
    decode_recon_kernel(const Frame f) {
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;                           // [kTileBlocks][64]
  float* kron = buf + kTileBlocks * 64;        // [64][64]
  float* tab = kron + 64 * 64;                 // [kMaxComps][64]
  int* rowp = reinterpret_cast<int*>(tab + kMaxComps * 64);
  int* colp = rowp + kMaxComps * kMaxRows;     // [kMaxComps][kMaxCols]
  int* info = colp + kMaxComps * kMaxCols;     // per component, below
  int* s_hs = info;
  int* s_vs = info + kMaxComps;
  int* s_bw = info + 2 * kMaxComps;
  int* s_pre = info + 3 * kMaxComps;           // blocks of an MCU before c
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncomp = f.ncomp;

  // Once per CTA: the matrix and the offset tables, which depend on the
  // sampling alone.  Component c's sample (sy, sx) of a tile lies in block
  // m * (h v) + (sy / 8) h + (sx % 8h) / 8 of the component's run (m =
  // sx / 8h its MCU), at (sy % 8) 8 + sx % 8.
  for (int i = tid; i < 64 * 64 / 4; i += kThreads)
    reinterpret_cast<float4*>(kron)[i] =
        __ldg(reinterpret_cast<const float4*>(f.kron) + i);
  if (tid == 0) {
    int pre = 0;
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      s_hs[c] = f.hs[c];
      s_vs[c] = f.vs[c];
      s_bw[c] = f.bw[c];
      s_pre[c] = pre;
      if (c < ncomp) pre += f.hs[c] * f.vs[c];
    }
    s_pre[kMaxComps] = pre;
  }
  const int rows = 8 * f.vmax, cols = f.tile_mcus * 8 * f.hmax;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= ncomp) break;
    const int hs = f.hs[c], vs = f.vs[c];
    const int rx = f.hmax / hs, ry = f.vmax / vs;
    for (int ly = tid; ly < rows; ly += kThreads) {
      const int sy = ly / ry;
      rowp[c * kMaxRows + ly] = (sy >> 3) * hs * 64 + (sy & 7) * 8;
    }
    for (int lx = tid; lx < cols; lx += kThreads) {
      const int sx = lx / rx;
      const int m = sx / (8 * hs), bx = (sx % (8 * hs)) >> 3;
      colp[c * kMaxCols + lx] = (m * vs * hs + bx) * 64 + (sx & 7);
    }
  }

  const long long per_img = (long long)f.mcus_y * f.tiles_x;
  const long long ntiles = per_img * f.nimg;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int img = (int)(t / per_img);
    const int rem = (int)(t - (long long)img * per_img);
    const int my = rem / f.tiles_x;
    const int mx0 = (rem - my * f.tiles_x) * f.tile_mcus;
    const int nm = min(f.tile_mcus, f.mcus_x - mx0);
    __syncthreads();  // the last tile's colour pass is done with buf
    const int bpm = s_pre[kMaxComps];
    const int nblk = nm * bpm;
    if (tid < ncomp * 64) {  // this image's table of each component
      const int c = tid >> 6;
      int sel = 0;
#pragma unroll
      for (int k = 0; k < kMaxComps; ++k)
        if (k == c) sel = f.tsel[k];
      tab[tid] = (float)__ldg(f.tables + (long long)img * f.tab_stride +
                              sel * 64 + (tid & 63));
    }
    __syncthreads();

    // 1. Load and dequantize, eight coefficients a thread.
    for (int i = tid; i < nblk * 8; i += kThreads) {
      const int blk = i >> 3, part = i & 7;
      int c = 0;
#pragma unroll
      for (int k = 1; k < kMaxComps; ++k)
        if (k < ncomp && blk >= nm * s_pre[k]) c = k;
      const int hs = s_hs[c], hv = hs * s_vs[c];
      const int local = blk - nm * s_pre[c];
      const int m = local / hv, r = local - m * hv;
      const int by = r / hs, bx = r - by * hs;
      const long long row = (long long)my * s_vs[c] + by;
      const long long col = (long long)(mx0 + m) * hs + bx;
      const int16_t* base = nullptr;
      long long stride = 0;
#pragma unroll
      for (int k = 0; k < kMaxComps; ++k)
        if (k == c) base = f.blocks[k], stride = f.img_stride[k];
      const int4 raw = __ldg(reinterpret_cast<const int4*>(
          base + (img * stride + row * s_bw[c] + col) * 64 + part * 8));
      const float* q = tab + c * 64 + part * 8;
      const int words[4] = {raw.x, raw.y, raw.z, raw.w};
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = (float)(short)(words[j] & 0xFFFF) * q[2 * j];
        v[2 * j + 1] = (float)(short)(words[j] >> 16) * q[2 * j + 1];
      }
      float4* dst = reinterpret_cast<float4*>(buf + blk * 64 + part * 8);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();

    // 2. IDCT: four blocks a warp, outputs lane and lane + 32 of each.
    for (int g = warp * 4; g < nblk; g += kWarps * 4) {
      float acc[4][2];
      bool live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] = acc[j][1] = 0.0f;
        live[j] = g + j < nblk;
      }
      for (int k = 0; k < 64; k += 4) {
        float4 cv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cv[j] = live[j] ? *reinterpret_cast<const float4*>(
                                buf + (g + j) * 64 + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float c0 = lane_of(cv[0], kk), c1 = lane_of(cv[1], kk);
          const float c2 = lane_of(cv[2], kk), c3 = lane_of(cv[3], kk);
          if (c0 != 0.0f || c1 != 0.0f || c2 != 0.0f || c3 != 0.0f) {
            const float m0 = kron[(k + kk) * 64 + lane];
            const float m1 = kron[(k + kk) * 64 + lane + 32];
            acc[0][0] = fmaf(c0, m0, acc[0][0]);
            acc[0][1] = fmaf(c0, m1, acc[0][1]);
            acc[1][0] = fmaf(c1, m0, acc[1][0]);
            acc[1][1] = fmaf(c1, m1, acc[1][1]);
            acc[2][0] = fmaf(c2, m0, acc[2][0]);
            acc[2][1] = fmaf(c2, m1, acc[2][1]);
            acc[3][0] = fmaf(c3, m0, acc[3][0]);
            acc[3][1] = fmaf(c3, m1, acc[3][1]);
          }
        }
      }
      __syncwarp();  // every lane has read the four blocks
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (live[j]) {
          buf[(g + j) * 64 + lane] = acc[j][0] + 128.0f;
          buf[(g + j) * 64 + lane + 32] = acc[j][1] + 128.0f;
        }
      }
    }
    __syncthreads();

    // 3. Colour, a pixel column a thread, rows in turn.
    const int y0 = my * rows, x0 = mx0 * 8 * f.hmax;
    const int tcols = min(nm * 8 * f.hmax, f.w - x0);
    const int trows = min(rows, f.h - y0);
    for (int lx = tid; lx < tcols; lx += kThreads) {
      int cp[kMaxComps];
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c)
        cp[c] = c < ncomp ? nm * s_pre[c] * 64 + colp[c * kMaxCols + lx] : 0;
      for (int ly = 0; ly < trows; ++ly) {
        float v[kMaxComps] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kMaxComps; ++c)
          if (c < ncomp) v[c] = buf[cp[c] + rowp[c * kMaxRows + ly]];
        float rgb[3];
        colour(f.mode, v, rgb);
        const long long o =
            ((long long)img * f.h + y0 + ly) * f.w + x0 + lx;
        if (f.out_f32) {
          reinterpret_cast<float4*>(f.out)[o] =
              make_float4(rgb[0], rgb[1], rgb[2], 255.0f);
        } else {
          reinterpret_cast<uchar4*>(f.out)[o] = make_uchar4(
              (unsigned char)rgb[0], (unsigned char)rgb[1],
              (unsigned char)rgb[2], 255);
        }
      }
    }
  }
}

cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_recon_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

const char* fennec_decode_recon_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// CTAs of K7 that fit on one SM of the current device at once, or minus
// the CUDA error.
int fennec_decode_recon_ctas_per_sm() {
  cudaError_t err = prepare();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, decode_recon_kernel, kThreads, kSmemBytes);
  return err == cudaSuccess ? n : -(int)err;
}

// K7.  blocks[c]: component c's int16 blocks (16-byte aligned), image i's
// at blocks[c] + i * img_stride[c] * 64, mcus_y * vs[c] rows of bw[c] =
// mcus_x * hs[c] blocks; tables int32, component c of image i at tables +
// i * tab_stride + tsel[c] * 64; kron the (64, 64) float32 matrix of
// ops/dct.dct_kron; out (nimg, h, w, 4) uint8, or float32 when out_f32.
// tile_mcus MCUs a tile (tile_mcus * sum(hs * vs) <= 128, tile_mcus * 8 *
// hmax <= 1024), tiles_x = ceil(mcus_x / tile_mcus); ctas the grid.  One
// launch on `stream`; returns the CUDA error.
int fennec_decode_recon(const void* const* blocks, const long long* img_stride,
                        const int* bw, const int* hs, const int* vs,
                        const int* tsel, int ncomp, const void* tables,
                        int tab_stride, const void* kron, int hmax, int vmax,
                        int mcus_x, int mcus_y, int h, int w, int mode,
                        int nimg, int tile_mcus, int tiles_x, int ctas,
                        void* out, int out_f32, void* stream) {
  Frame f = {};
  for (int c = 0; c < kMaxComps; ++c) {
    const bool on = c < ncomp;
    f.blocks[c] = on ? static_cast<const int16_t*>(blocks[c]) : nullptr;
    f.img_stride[c] = on ? img_stride[c] : 0;
    f.bw[c] = on ? bw[c] : 0;
    f.hs[c] = on ? hs[c] : 1;
    f.vs[c] = on ? vs[c] : 1;
    f.tsel[c] = on ? tsel[c] : 0;
  }
  f.tables = static_cast<const int*>(tables);
  f.tab_stride = tab_stride;
  f.kron = static_cast<const float*>(kron);
  f.ncomp = ncomp, f.hmax = hmax, f.vmax = vmax;
  f.mcus_x = mcus_x, f.mcus_y = mcus_y, f.h = h, f.w = w;
  f.mode = mode, f.nimg = nimg;
  f.tile_mcus = tile_mcus, f.tiles_x = tiles_x;
  f.out = out, f.out_f32 = out_f32;
  const long long ntiles = (long long)nimg * mcus_y * tiles_x;
  if (ntiles == 0) return 0;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(ntiles < ctas ? ntiles : ctas);
  decode_recon_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(f);
  return (int)cudaGetLastError();
}

}  // extern "C"
