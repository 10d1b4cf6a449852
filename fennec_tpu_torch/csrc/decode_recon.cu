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
// What bounds it on an H100: bytes.  At 12 MP 4:2:0 it reads 36.6 MB of
// blocks and writes 48.8 MB of RGBA (25 us at 3.35 TB/s); the product is
// 4096 multiply-adds a block (35 us at 67 TFLOP/s dense), fewer for the
// zero coefficients it skips; the colour ~40 instructions a pixel.  PR 16's
// design (bench_sources/decode_recon_first.cu) ran at 9-27 % of the bytes
// bound: its product made ~12 shared-memory wavefronts for 32 warp-FMAs,
// and a tile's loads, product and stores ran in turn.  What holds this
// design back is issue: clock64() stamps and edited builds
// (bench_sources/k7k8_variants.py) put the product at ~35 us of a 12 MP
// call (a warp's 16 blocks share one mask, ~21 of 64 k a block run, and
// the luma warps run about three times as many as the chroma ones) and the
// colour pass at ~28 us.
//
// Design.  Persistent CTAs of 256 threads (as many as the card holds at
// once, two an SM) walk tiles of whole MCUs of one MCU row (at most
// kTileBlocks blocks).  A tile's blocks of one component block row are one
// contiguous span of device memory, so:
//
//   0. Staging.  Warp 0 fills a ring of kStages stages with TMA bulk copies
//      (cp.async.bulk, completion on one mbarrier a stage), one a lane: one
//      per component block row (four in 4:2:0), raw int16, and one of the
//      image's table rows.  A stage is refilled, kStages tiles ahead, as
//      soon as every warp has converted it, so the copies run while the CTA
//      computes.  The stage's slots are component-major and, within a
//      component, row-major: component c's block row by of the tile's nm
//      MCUs starts at slot nm * (pre_c + by * h_c).
//
//   1. Conversion, warp by warp.  Warp w owns slots [16 w, 16 w + 16).
//      Each lane converts a 16-byte part (eight coefficients) of one block,
//      dequantized as the plain version does (float32, one rounding), into
//      the k-major buffer at k * 128 + ((slot + 4 (k / 8)) mod 128): the
//      rotation puts the 32 lanes of each store on 32 banks.  It ORs the
//      nonzero coefficients into a 64-bit mask; a warp reduce gives the
//      union over the warp's 16 blocks.
//
//   2. The product, a register-tiled (16 x 64) . (64 x 64) GEMM a warp.
//      A lane holds 4 blocks x 8 outputs (outputs 4g..4g+3 and 32+4g..
//      32+4g+3); per k one 16-byte load of its blocks' coefficients (4
//      addresses a warp) and two of the matrix row (8 each): 3 wavefronts
//      for 32 warp-FMAs.  Only the k of the warp's mask run, found a
//      32-bit half at a time: fmaf(0, m, s) is s for every sum the chains
//      hold (they start at +0), so skipping a k whose coefficient is zero
//      changes no bit, and every sum is still fmaf over k ascending.
//
//   3. + 128 into a block-major pixel buffer (72 floats a block: a row of
//      pixels spans 32 banks), which reuses the k-major buffer's memory.
//
//   4. Colour, compiled once per mode and output type (no branch a pixel).
//      A warp takes a pixel row of the tile, its lanes adjacent columns;
//      each component's sample is a row part (per warp row) plus a column
//      part, read with the others from a per-CTA table (colx: one 64-bit
//      word a pixel column, a 16-bit field a component), so replication and
//      the MCU layout cost one load and a few integer operations.  The
//      colour maths is the plain version's, operation for operation, built
//      with --fmad=false so nothing is contracted; a uint8 value [0, 255]
//      is the low byte of x + 2^23.  Rows are stored coalesced, 4 or 16
//      bytes a pixel.
//
// The EXIF orientation (1-8) of a frame maps the store address only: the
// uint8 image comes out upright, (w, h) for 5-8, each pixel the value it
// has at orientation 1.  Pixel (y, x) of the stored image lands at
// c0 + y sy + x sx of the upright one (store_map in the wrapper); the
// orientation picks one of three builds of the kernel per launch, so no
// branch runs a pixel:
//
//   identity (1)      decode_recon_kernel, the stores above;
//   flips (2, 3, 4)   decode_recon_flip_kernel: the same lanes, a row to a
//                     mirrored row and/or columns, still coalesced;
//   transposing (5-8) decode_recon_transpose_kernel: a tile's pixel
//                     columns become output rows, so the colour pass takes
//                     a lane (8 g + (lane & 7), 4 cg + (lane >> 3)): each 8
//                     lanes of one column store 8 adjacent pixels of one
//                     output row (32 bytes, one sector when h is a multiple
//                     of 8), a warp 4 whole sectors.
//
// Sampling factors must divide the largest (hmax % h == 0, vmax % v == 0):
// the wrapper checks it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBlocks = 128;  // blocks of a tile, all components
constexpr int kWarpBlocks = kTileBlocks / kWarps;  // 16, a warp's slots
constexpr int kMaxComps = 4;
constexpr int kMaxRows = 32;    // 8 * vmax of an MCU, vmax <= 4
constexpr int kMaxCols = 1024;  // pixel columns of a tile
constexpr int kStages = 2;
constexpr int kPixStride = 72;  // floats between blocks of the pixel buffer
constexpr int kTabBytes = kMaxComps * 64 * 4;
constexpr int kStageBytes = kTileBlocks * 128 + kTabBytes;
constexpr int kWorkFloats = kTileBlocks * kPixStride;  // >= 64 * 128
constexpr int kInfoInts = 16;  // pre[5], tsel[4], padding
constexpr int kSmemBytes = kStages * kStageBytes + kWorkFloats * 4 +
                           64 * 64 * 4 + kMaxCols * 8 +
                           2 * kMaxComps * kMaxRows * 4 + kInfoInts * 4 +
                           kStages * 8;

enum Mode { kGray = 0, kRgb = 1, kYcbcr = 2, kCmyk = 3, kYcck = 4 };
enum Store { kIdentity = 0, kFlip = 1, kTranspose = 2 };

struct Frame {
  const int16_t* blocks[kMaxComps];  // image 0's first block
  long long img_stride[kMaxComps];   // blocks between images
  int bw[kMaxComps];                 // blocks per row of the component
  int hs[kMaxComps], vs[kMaxComps];  // sampling factors
  int tsel[kMaxComps];               // table row of the component
  const int* tables;                 // int32 tables
  int tab_stride;                    // ints between images' tables
  int ntab;                          // table rows staged a tile
  const float* kron;                 // (64, 64) float32
  int ncomp, hmax, vmax, mcus_x, mcus_y, h, w, mode, nimg;
  int tile_mcus, tiles_x;            // MCUs a tile, tiles per MCU row
  void* out;
  int out_f32;
  long long o_c0, o_sy, o_sx;        // the store map (not identity)
};

struct Tile {
  int img, my, mx0, nm;
};

__device__ __forceinline__ Tile tile_at(const Frame& f, long long t) {
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

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   shared_addr(bar))
               : "memory");
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

// Warp 0: the copies of tile t into stage st, counted on bar, one a lane
// (lane 0 the table rows, which follow the blocks; lane 1 + j the j-th
// component block row in order).  Slots of component c's block row by
// start at nm * (pre_c + by * h_c).
__device__ __forceinline__ void issue(const Frame& f, long long t,
                                      unsigned char* st, uint64_t* bar,
                                      int lane) {
  const Tile T = tile_at(f, t);
  if (lane == 0) {
    uint32_t bytes = f.ntab * 256;
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c)
      if (c < f.ncomp) bytes += f.vs[c] * T.nm * f.hs[c] * 128;
    bar_expect(bar, bytes);
    bulk_load(st + kTileBlocks * 128,
              f.tables + (long long)T.img * f.tab_stride, f.ntab * 256, bar);
  }
  int j = lane - 1, pre = 0;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= f.ncomp) break;
    const int hs = f.hs[c], vs = f.vs[c];
    if (j >= 0 && j < vs) {
      const int16_t* src =
          f.blocks[c] + ((long long)T.img * f.img_stride[c] +
                         (long long)(T.my * vs + j) * f.bw[c] +
                         (long long)T.mx0 * hs) * 64;
      bulk_load(st + T.nm * (pre + j * hs) * 128, src, T.nm * hs * 128, bar);
    }
    j -= vs;
    pre += hs * vs;
  }
}

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

template <int kMode>
__device__ __forceinline__ void colour(const float* v, float* rgb) {
  if (kMode == kGray) {
    const float y = round_clamp(v[0]);
    rgb[0] = rgb[1] = rgb[2] = y;
  } else if (kMode == kRgb) {
    for (int i = 0; i < 3; ++i) rgb[i] = round_clamp(v[i]);
  } else if (kMode == kYcbcr) {
    ycbcr_rgb(v[0], v[1], v[2], rgb);
    for (int i = 0; i < 3; ++i) rgb[i] = round_clamp(rgb[i]);
  } else {  // kCmyk, kYcck: x * k // 255 on the rounded planes
    float base[3];
    if (kMode == kYcck) {
      ycbcr_rgb(v[0], v[1], v[2], base);
    } else {
      base[0] = v[0], base[1] = v[1], base[2] = v[2];
    }
    const int k = (int)round_clamp(v[3]);
    for (int i = 0; i < 3; ++i)
      rgb[i] = (float)(((int)round_clamp(base[i]) * k) / 255);
  }
}

// A value of [0, 255] (integral) as its byte: the low bits of x + 2^23.
__device__ __forceinline__ uint32_t byte_of(float x) {
  return __float_as_uint(x + 8388608.0f) & 0xFFu;
}

template <bool kF32>
__device__ __forceinline__ void store_pixel(void* out, long long i,
                                            const float* rgb) {
  if (kF32) {
    reinterpret_cast<float4*>(out)[i] =
        make_float4(rgb[0], rgb[1], rgb[2], 255.0f);
  } else {
    reinterpret_cast<uint32_t*>(out)[i] = byte_of(rgb[0]) |
                                          byte_of(rgb[1]) << 8 |
                                          byte_of(rgb[2]) << 16 | 0xFF000000u;
  }
}

template <int kMode>
__host__ __device__ constexpr int mode_comps() {
  return kMode == kGray ? 1 : (kMode == kCmyk || kMode == kYcck) ? 4 : 3;
}

// Component c's samples of pixel (ly, lx): pix[ro[c] + colx[lx]'s 16-bit
// field c], coloured.
template <int kMode>
__device__ __forceinline__ void pixel_colour(const float* pix, const int* ro,
                                             uint2 cx, float* rgb) {
  constexpr int kN = mode_comps<kMode>();
  float v[4];
  v[0] = pix[ro[0] + (cx.x & 0xFFFF)];
  if (kN > 1) {
    v[1] = pix[ro[1] + (cx.x >> 16)];
    v[2] = pix[ro[2] + (cx.y & 0xFFFF)];
  }
  if (kN > 3) v[3] = pix[ro[3] + (cx.y >> 16)];
  colour<kMode>(v, rgb);
}

// The colour pass of a tile for one mode, output type and store path
// (identity or flips): a pixel row a warp, adjacent columns a lane.
// Component c's sample of pixel (ly, lx) is pix[ro_c(ly) + colx[lx]'s
// 16-bit field c].
template <int kMode, bool kF32, int kStore>
__device__ __forceinline__ void colour_rows(const Frame& f, const float* pix,
                                            const uint2* colx,
                                            const int* rowb, const int* rowp,
                                            const int* s_pre, const Tile& T,
                                            int warp, int lane) {
  constexpr int kN = mode_comps<kMode>();
  const int rows = 8 * f.vmax;
  const int y0 = T.my * rows, x0 = T.mx0 * 8 * f.hmax;
  const int tcols = min(T.nm * 8 * f.hmax, f.w - x0);
  const int trows = min(rows, f.h - y0);
  for (int ly = warp; ly < trows; ly += kWarps) {
    int ro[kN];
#pragma unroll
    for (int c = 0; c < kN; ++c)
      ro[c] = T.nm * (s_pre[c] + rowb[c * kMaxRows + ly]) * kPixStride +
              rowp[c * kMaxRows + ly];
    if constexpr (kStore == kIdentity) {
      const long long o0 = ((long long)T.img * f.h + y0 + ly) * f.w + x0;
      for (int lx = lane; lx < tcols; lx += 32) {
        float rgb[3];
        pixel_colour<kMode>(pix, ro, colx[lx], rgb);
        store_pixel<kF32>(f.out, o0 + lx, rgb);
      }
    } else {
      const long long o0 = (long long)T.img * f.h * f.w + f.o_c0 +
                           (long long)(y0 + ly) * f.o_sy +
                           (long long)x0 * f.o_sx;
      for (int lx = lane; lx < tcols; lx += 32) {
        float rgb[3];
        pixel_colour<kMode>(pix, ro, colx[lx], rgb);
        store_pixel<kF32>(f.out, o0 + lx * f.o_sx, rgb);
      }
    }
  }
}

// The colour pass of a tile under a transposing orientation, uint8 out:
// units of 8 pixel rows (group g) by 4 columns (cg), a unit a warp, lane
// (8 g + (lane & 7), 4 cg + (lane >> 3)).  A column's 8 pixels are 8
// adjacent pixels of one output row.  With kWarps a multiple of the
// groups (vmax 1, 2 or 4) a warp keeps its group, and its row offsets.
template <int kMode>
__device__ __forceinline__ void colour_cols(const Frame& f, const float* pix,
                                            const uint2* colx,
                                            const int* rowb, const int* rowp,
                                            const int* s_pre, const Tile& T,
                                            int warp, int lane) {
  constexpr int kN = mode_comps<kMode>();
  const int rows = 8 * f.vmax;
  const int y0 = T.my * rows, x0 = T.mx0 * 8 * f.hmax;
  const int tcols = min(T.nm * 8 * f.hmax, f.w - x0);
  const int trows = min(rows, f.h - y0);
  const int ng = (trows + 7) >> 3, units = ng * ((tcols + 3) >> 2);
  const long long o0 = (long long)T.img * f.h * f.w + f.o_c0 +
                       (long long)y0 * f.o_sy + (long long)x0 * f.o_sx;
  int ro[kN];
  int gcur = -1;
  for (int u = warp; u < units; u += kWarps) {
    const int g = u % ng;
    const int ly = 8 * g + (lane & 7), lx = 4 * (u / ng) + (lane >> 3);
    if (g != gcur) {  // ly < 8 ng <= rows: inside the row tables
      gcur = g;
#pragma unroll
      for (int c = 0; c < kN; ++c)
        ro[c] = T.nm * (s_pre[c] + rowb[c * kMaxRows + ly]) * kPixStride +
                rowp[c * kMaxRows + ly];
    }
    if (ly < trows && lx < tcols) {
      float rgb[3];
      pixel_colour<kMode>(pix, ro, colx[lx], rgb);
      store_pixel<false>(f.out, o0 + ly * f.o_sy + lx * f.o_sx, rgb);
    }
  }
}

template <int kMode, bool kF32, int kStore>
__device__ __forceinline__ void colour_mode(const Frame& f, const float* pix,
                                            const uint2* colx,
                                            const int* rowb, const int* rowp,
                                            const int* s_pre, const Tile& T,
                                            int warp, int lane) {
  if constexpr (kStore == kTranspose)
    colour_cols<kMode>(f, pix, colx, rowb, rowp, s_pre, T, warp, lane);
  else
    colour_rows<kMode, kF32, kStore>(f, pix, colx, rowb, rowp, s_pre, T,
                                     warp, lane);
}

template <bool kF32, int kStore>
__device__ __forceinline__ void colour_tile(const Frame& f, const float* pix,
                                            const uint2* colx,
                                            const int* rowb, const int* rowp,
                                            const int* s_pre, const Tile& T,
                                            int warp, int lane) {
  switch (f.mode) {
    case kGray:
      colour_mode<kGray, kF32, kStore>(f, pix, colx, rowb, rowp, s_pre, T,
                                       warp, lane);
      break;
    case kRgb:
      colour_mode<kRgb, kF32, kStore>(f, pix, colx, rowb, rowp, s_pre, T,
                                      warp, lane);
      break;
    case kYcbcr:
      colour_mode<kYcbcr, kF32, kStore>(f, pix, colx, rowb, rowp, s_pre, T,
                                        warp, lane);
      break;
    case kCmyk:
      colour_mode<kCmyk, kF32, kStore>(f, pix, colx, rowb, rowp, s_pre, T,
                                       warp, lane);
      break;
    default:
      colour_mode<kYcck, kF32, kStore>(f, pix, colx, rowb, rowp, s_pre, T,
                                       warp, lane);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The kernel's body for one store path (kStore); kF32 output only with
// the identity.
template <int kStore>
__device__ __forceinline__ void decode_recon_body(const Frame& f) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stages = smem;  // [kStages][kStageBytes]
  // The k-major coefficients ([64][128], rotated) and, after the product,
  // the block-major pixels ([kTileBlocks][kPixStride]).
  float* work = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* kron = work + kWorkFloats;                         // [64][64]
  uint2* colx = reinterpret_cast<uint2*>(kron + 64 * 64);   // [kMaxCols]
  int* rowb = reinterpret_cast<int*>(colx + kMaxCols);      // [c][ly]
  int* rowp = rowb + kMaxComps * kMaxRows;                  // [c][ly]
  int* s_pre = rowp + kMaxComps * kMaxRows;                 // [5]
  int* s_tsel = s_pre + kMaxComps + 1;                      // [4]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_pre + kInfoInts);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncomp = f.ncomp;

  // Once per CTA: the barriers, the matrix, and the tables that depend on
  // the sampling alone.  Component c's sample row sy of a tile lies in
  // its block row sy / 8 (slots nm * (pre_c + (sy / 8) h_c) on), at
  // (sy % 8) 8 within a block; its column sx in the row's block sx / 8, at
  // sx % 8: pixel column lx's offsets, one 16-bit field a component, in
  // colx[lx].
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int pre = 0;
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      s_pre[c] = pre;
      s_tsel[c] = f.tsel[c];
      if (c < ncomp) pre += f.hs[c] * f.vs[c];
    }
    s_pre[kMaxComps] = pre;
  }
  for (int lx = tid; lx < kMaxCols; lx += kThreads) {
    uint32_t field[kMaxComps];
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      const int sx = lx / (f.hmax / f.hs[c]);
      field[c] = c < ncomp ? (sx >> 3) * kPixStride + (sx & 7) : 0;
    }
    colx[lx] = make_uint2(field[0] | field[1] << 16, field[2] | field[3] << 16);
  }
  for (int i = tid; i < 64 * 64 / 4; i += kThreads)
    reinterpret_cast<float4*>(kron)[i] =
        __ldg(reinterpret_cast<const float4*>(f.kron) + i);
  const int rows = 8 * f.vmax;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= ncomp) break;
    const int ry = f.vmax / f.vs[c];
    for (int ly = tid; ly < rows; ly += kThreads) {
      const int sy = ly / ry;
      rowb[c * kMaxRows + ly] = (sy >> 3) * f.hs[c];
      rowp[c * kMaxRows + ly] = (sy & 7) * 8;
    }
  }
  __syncthreads();

  const long long ntiles = (long long)f.mcus_y * f.tiles_x * f.nimg;
  if (warp == 0) {
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + (long long)s * gridDim.x;
      if (t < ntiles) issue(f, t, stages + s * kStageBytes, &full[s], lane);
    }
  }
  const float4* kron4 = reinterpret_cast<const float4*>(kron);
  int it = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int s = it % kStages;
    unsigned char* st = stages + s * kStageBytes;
    const Tile T = tile_at(f, t);
    const int nm = T.nm;
    const int nblk = nm * s_pre[kMaxComps];
    bar_wait(&full[s], (uint32_t)(it / kStages) & 1);

    // 1. Conversion: lane (part, block) of four blocks at a time.
    const int16_t* raw = reinterpret_cast<const int16_t*>(st);
    const int* qt = reinterpret_cast<const int*>(st + kTileBlocks * 128);
    const int part = lane & 7;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int q = 0; q < kWarpBlocks / 4; ++q) {
      const int b = warp * kWarpBlocks + q * 4 + (lane >> 3);
      if (b < nblk) {
        int c = 0;
#pragma unroll
        for (int k = 1; k < kMaxComps; ++k)
          if (k < ncomp && b >= nm * s_pre[k]) c = k;
        const int4 rv =
            *reinterpret_cast<const int4*>(raw + b * 64 + part * 8);
        const int* qrow = qt + s_tsel[c] * 64 + part * 8;
        const int4 q0 = *reinterpret_cast<const int4*>(qrow);
        const int4 q1 = *reinterpret_cast<const int4*>(qrow + 4);
        const int words[4] = {rv.x, rv.y, rv.z, rv.w};
        const int qs[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
        float* dst = work + part * 8 * 128;
        const int col = (b + 4 * part) & 127;
        uint32_t bits = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const short a = (short)(words[j] & 0xFFFF);
          const short z = (short)(words[j] >> 16);
          dst[(2 * j) * 128 + col] = (float)a * (float)qs[2 * j];
          dst[(2 * j + 1) * 128 + col] = (float)z * (float)qs[2 * j + 1];
          bits |= (a != 0 ? 1u : 0u) << (2 * j);
          bits |= (z != 0 ? 1u : 0u) << (2 * j + 1);
        }
        if (part < 4)
          lo |= bits << (8 * part);
        else
          hi |= bits << (8 * (part - 4));
      }
    }
    lo = __reduce_or_sync(0xffffffffu, lo);
    hi = __reduce_or_sync(0xffffffffu, hi);
    __syncwarp();

    // 2. The product: lane (bg, og) sums blocks blk0..blk0+3, outputs
    // 4 og..4 og+3 and 32+4 og..32+4 og+3, over the warp's k ascending.
    const int og = lane >> 2;
    const int blk0 = warp * kWarpBlocks + (lane & 3) * 4;
    const bool live = warp * kWarpBlocks < nblk;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t m = live ? (half ? hi : lo) : 0u;
      while (m) {
        const int k = half * 32 + __ffs(m) - 1;
        m &= m - 1;
        const float4 cv = *reinterpret_cast<const float4*>(
            work + k * 128 + ((blk0 + 4 * (k >> 3)) & 127));
        const float4 ma = kron4[k * 16 + og];
        const float4 mb = kron4[k * 16 + 8 + og];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = lane_of(cv, i);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(c, lane_of(ma, j), acc[i][j]);
            acc[i][4 + j] = fmaf(c, lane_of(mb, j), acc[i][4 + j]);
          }
        }
      }
    }
    __syncthreads();  // stage s converted, the k-major buffer read

    if (warp == 0) {
      const long long next = t + (long long)kStages * gridDim.x;
      if (next < ntiles) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(f, next, st, &full[s], lane);
      }
    }

    // 3. + 128 into the block-major pixel buffer.
    if (live) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* d = reinterpret_cast<float4*>(work + (blk0 + i) * kPixStride);
        d[og] = make_float4(acc[i][0] + 128.0f, acc[i][1] + 128.0f,
                            acc[i][2] + 128.0f, acc[i][3] + 128.0f);
        d[8 + og] = make_float4(acc[i][4] + 128.0f, acc[i][5] + 128.0f,
                                acc[i][6] + 128.0f, acc[i][7] + 128.0f);
      }
    }
    __syncthreads();

    // 4. Colour, a pixel row a warp, adjacent columns a lane.
    if constexpr (kStore == kIdentity) {
      if (f.out_f32)
        colour_tile<true, kIdentity>(f, work, colx, rowb, rowp, s_pre, T,
                                     warp, lane);
      else
        colour_tile<false, kIdentity>(f, work, colx, rowb, rowp, s_pre, T,
                                      warp, lane);
    } else {
      colour_tile<false, kStore>(f, work, colx, rowb, rowp, s_pre, T, warp,
                                 lane);
    }
    __syncthreads();  // the pixel buffer read before the next conversion
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    decode_recon_kernel(const Frame f) {
  decode_recon_body<kIdentity>(f);
}

__global__ void __launch_bounds__(kThreads, 2)
    decode_recon_flip_kernel(const Frame f) {
  decode_recon_body<kFlip>(f);
}

__global__ void __launch_bounds__(kThreads, 2)
    decode_recon_transpose_kernel(const Frame f) {
  decode_recon_body<kTranspose>(f);
}

typedef void (*KernelFn)(const Frame);

KernelFn kernel_of(int kind) {
  return kind == kTranspose ? decode_recon_transpose_kernel
         : kind == kFlip    ? decode_recon_flip_kernel
                            : decode_recon_kernel;
}

// The store path of an EXIF orientation and its map: pixel (y, x) of an
// h x w image lands at c0 + y sy + x sx of the upright one (w x h when
// the orientation transposes).  Orientations 5-8 transpose; 2, 3, 7 mirror
// the output columns, 3, 4, 7, 8 its rows (exif.apply_orientation).
int store_map(int orientation, int h, int w, long long* c0, long long* sy,
              long long* sx) {
  const bool tr = orientation >= 5;
  const bool frow = orientation == 3 || orientation == 4 ||
                    orientation == 7 || orientation == 8;
  const bool fcol = orientation == 2 || orientation == 3 ||
                    orientation == 6 || orientation == 7;
  const long long ow = tr ? h : w, oh = tr ? w : h;
  // (a, b) = the output row and column before mirroring: (y, x), or
  // (x, y) when transposed.
  const long long sa = ow, sb = 1;
  *c0 = (frow ? (oh - 1) * sa : 0) + (fcol ? (ow - 1) * sb : 0);
  const long long ra = frow ? -sa : sa, rb = fcol ? -sb : sb;
  *sy = tr ? rb : ra;
  *sx = tr ? ra : rb;
  return orientation == 1 ? kIdentity : tr ? kTranspose : kFlip;
}

cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  for (int k = 0; k < 3 && err == cudaSuccess; ++k) {
    err = cudaFuncSetAttribute(kernel_of(k),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel_of(k), cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  }
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* fennec_decode_recon_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// CTAs of K7 that fit on one SM of the current device at once (the least
// over its three store paths), or minus the CUDA error.
int fennec_decode_recon_ctas_per_sm() {
  cudaError_t err = prepare();
  int least = 0;
  for (int k = 0; k < 3 && err == cudaSuccess; ++k) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_of(k),
                                                        kThreads, kSmemBytes);
    least = k == 0 || n < least ? n : least;
  }
  return err == cudaSuccess ? least : -(int)err;
}

// K7 as fennec_decode_recon (below) takes it, each image stored upright
// for its EXIF orientation (1-8): out (nimg, w, h, 4) for 5-8, uint8
// unless the orientation is 1.
int fennec_decode_recon_oriented(
    const void* const* blocks, const long long* img_stride, const int* bw,
    const int* hs, const int* vs, const int* tsel, int ncomp,
    const void* tables, int tab_stride, const void* kron, int hmax, int vmax,
    int mcus_x, int mcus_y, int h, int w, int mode, int nimg, int tile_mcus,
    int tiles_x, int ctas, void* out, int out_f32, int orientation,
    void* stream) {
  Frame f = {};
  int per_mcu = 0, ntab = 0;
  bool ok = aligned16(tables) && tab_stride % 4 == 0 && aligned16(kron) &&
            ncomp >= 1 && ncomp <= kMaxComps && orientation >= 1 &&
            orientation <= 8 && (orientation == 1 || !out_f32);
  for (int c = 0; c < kMaxComps; ++c) {
    const bool on = c < ncomp;
    f.blocks[c] = on ? static_cast<const int16_t*>(blocks[c]) : nullptr;
    f.img_stride[c] = on ? img_stride[c] : 0;
    f.bw[c] = on ? bw[c] : 0;
    f.hs[c] = on ? hs[c] : 1;
    f.vs[c] = on ? vs[c] : 1;
    f.tsel[c] = on ? tsel[c] : 0;
    if (on) {
      ok = ok && aligned16(blocks[c]) && tsel[c] >= 0 && tsel[c] < kMaxComps;
      per_mcu += hs[c] * vs[c];
      ntab = tsel[c] + 1 > ntab ? tsel[c] + 1 : ntab;
    }
  }
  if (!ok || tile_mcus < 1 || tile_mcus * per_mcu > kTileBlocks ||
      tile_mcus * 8 * hmax > kMaxCols || 8 * vmax > kMaxRows)
    return (int)cudaErrorInvalidValue;
  f.tables = static_cast<const int*>(tables);
  f.tab_stride = tab_stride;
  f.ntab = ntab;
  f.kron = static_cast<const float*>(kron);
  f.ncomp = ncomp, f.hmax = hmax, f.vmax = vmax;
  f.mcus_x = mcus_x, f.mcus_y = mcus_y, f.h = h, f.w = w;
  f.mode = mode, f.nimg = nimg;
  f.tile_mcus = tile_mcus, f.tiles_x = tiles_x;
  f.out = out, f.out_f32 = out_f32;
  const int kind = store_map(orientation, h, w, &f.o_c0, &f.o_sy, &f.o_sx);
  const long long ntiles = (long long)nimg * mcus_y * tiles_x;
  if (ntiles == 0) return 0;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(ntiles < ctas ? ntiles : ctas);
  kernel_of(kind)<<<grid, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(f);
  return (int)cudaGetLastError();
}

// K7.  blocks[c]: component c's int16 blocks (16-byte aligned), image i's
// at blocks[c] + i * img_stride[c] * 64, mcus_y * vs[c] rows of bw[c] =
// mcus_x * hs[c] blocks; tables int32 (16-byte aligned, tab_stride a
// multiple of 4), component c of image i at tables + i * tab_stride +
// tsel[c] * 64; kron the (64, 64) float32 matrix of ops/dct.dct_kron; out
// (nimg, h, w, 4) uint8, or float32 when out_f32.  tile_mcus MCUs a tile
// (tile_mcus * sum(hs * vs) <= 128, tile_mcus * 8 * hmax <= 1024), tiles_x
// = ceil(mcus_x / tile_mcus); ctas the grid.  One launch on `stream`;
// returns the CUDA error (cudaErrorInvalidValue for a misaligned input or
// a tile past the kernel's buffers).
int fennec_decode_recon(const void* const* blocks, const long long* img_stride,
                        const int* bw, const int* hs, const int* vs,
                        const int* tsel, int ncomp, const void* tables,
                        int tab_stride, const void* kron, int hmax, int vmax,
                        int mcus_x, int mcus_y, int h, int w, int mode,
                        int nimg, int tile_mcus, int tiles_x, int ctas,
                        void* out, int out_f32, void* stream) {
  return fennec_decode_recon_oriented(
      blocks, img_stride, bw, hs, vs, tsel, ncomp, tables, tab_stride, kron,
      hmax, vmax, mcus_x, mcus_y, h, w, mode, nimg, tile_mcus, tiles_x, ctas,
      out, out_f32, 1, stream);
}

}  // extern "C"
