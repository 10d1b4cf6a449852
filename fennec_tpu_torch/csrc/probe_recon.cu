// Kernel K2: the probe reconstruction of the quality search, CUDA C++ for
// sm_90a.
//
// Replaces the XLA programs the JAX package compiles for one probe of
// fennec_tpu/engine/compress.py: _qd_plane (:96), _idct_plane (:126),
// _reconstruct_rgb_planes (:140), _box_down_plane (:166) and the luminance
// after them.  The plain PyTorch version, which the CPU runs and this
// kernel is held against on the card, is probe_luminance_plain of
// fennec_tpu_torch/engine/compress.py; the wrapper is
// ops/probe_recon_cuda.py.  The first version of this kernel is kept as
// bench_sources/probe_recon_first.cu; this one gives the same luminance,
// bit for bit.
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
// What bounds it on an H100: bytes, in principle.  A probe reads each
// coefficient once (6 B a pixel in 4:2:0) and writes (dh, dw) floats: 73
// MB at 12 MP, 22 us at 3.35 TB/s, against ~40 flops a coefficient.  In
// practice the issue rate and the latency between a CTA's phases: a
// coefficient costs an IEEE division and its rounding besides its share
// of the two 8-term passes, and a pixel ~30 instructions of colour.
//
// Design.  One launch of persistent CTAs of 256 threads, as many as the
// card holds at once (3 per SM: 75 KB of shared memory, at most 80
// registers).  The work is cut into chunks of 96 8x8 blocks: 32 x 128
// pixels in 4:2:0 (64 luma blocks, 16 Cb, 16 Cr), 16 x 128 in 4:4:4 (32 +
// 32 + 32).  A CTA walks its chunks in order.  What the first version left
// waiting, this one does as follows.
//
//   Loads in flight.  A chunk's coefficients (24 KB) are staged with
//   cp.async, six 16-byte copies per thread, all issued at once, into a
//   ring of two stages: chunk k+1 loads while chunk k computes, and three
//   CTAs per SM keep three such pairs going.  (Three stages fit only two
//   CTAs per SM, which measured slower.)  A copy outside the plane has a
//   source size of 0, so the stage reads zeros there (the planes are
//   padded only to 8 or 16).  Shared memory is sized to the sampling: a
//   stage holds 96 blocks in both, the 4:2:0 chroma at a quarter of the
//   luma tile.
//
//   No idle threads.  The row pass has 96 x 8 = 768 items (a row of eight
//   coefficients of one block), the column pass 96 x 8 = 768 (a column of
//   one block): three of each per thread in every sampling, luma and chroma
//   together.  A warp's row items are one row index u of 32 blocks (each
//   warp a mix of u); its column items four neighbouring blocks, eight
//   columns each.  The DCT matrix travels in the launch's parameters, so
//   the multiply-adds read it as constants, without loads.
//
//   Zero rows skipped, exactly.  After quantization most high-frequency
//   rows are zero.  fmaf(+-0, d, s) is s for every s the chains hold (they
//   start at +0 and never hold -0), so a zero term changes no sum.  A warp
//   skips a row of its 32 blocks when all are zero (ballot), and within a
//   row every term v that is zero in all 32; the column pass skips term u
//   of its four blocks when their rows u are all zero (the ballots, kept
//   per chunk).  Every other term is summed in the first version's order.
//   Before that, a coefficient with |c| < q / 4 in every lane of the warp
//   skips its division: it quantizes to zero whatever the quotient rounds
//   to (q / 4 is exact).
//
//   No bank conflicts.  Stages are stored with the halves of a block row
//   swapped in every other group of four blocks (sw below), so the 16-byte
//   loads and stores of eight neighbouring row items cover the 32 banks.
//
//   The box mean, separable and owned.  With a downsample, a unit of work
//   is a band of output rows by a strip of output columns, planned on the
//   host (ops/probe_recon_cuda.box_plan, with each chunk's range of
//   rectangles and source rows): its chunks cover every source pixel of
//   its rectangles, starting at the MCU that holds the first one, so the
//   seam MCU row and column are reconstructed again by the neighbouring
//   unit, by the same arithmetic.  Per chunk: horizontal sums per (source
//   row, rectangle column) into shared memory, a word of bytes per dp4a
//   with masks fixed per column, then vertical sums per (rectangle row,
//   rectangle column) into the unit's int32 sums; after the unit's last
//   chunk, floor((2 sum + n) / (2 n)), the exact mean of n pixels rounded
//   half up, and the luminance.  No atomics, no zeroed buffer, no second
//   kernel: a probe is one device operation at every shape.  Without a
//   downsample a unit is one chunk and the colour pass writes the
//   luminance.
//
//   Arithmetic, as the first version's.  Quantize-dequantize is three
//   float32 roundings: c / q (IEEE division), sign * floor(|s| + 0.5) with
//   the float32 add, times q.  Each IDCT sum is fused multiply-adds in
//   ascending index order from +0, which is how a float32 GEMM of depth 8
//   accumulates.  The colour maths and the luminance are unfused multiplies
//   and adds in the plain version's order (intrinsics; --fmad=false).  No
//   TF32, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkW = 128;        // pixel columns of a chunk
constexpr int kStages = 2;          // chunks staged at once
constexpr int kStageFloats = 6144;  // 96 blocks of 64 coefficients
constexpr int kGroups = 3;          // of 32 blocks
constexpr int kSegments = kStageFloats / 4;  // 16-byte copies per chunk
constexpr int kMaxCells = 960;      // output rectangles of a unit
constexpr int kMaxUnitRows = 272;   // its output rows
constexpr int kMaxUnitCols = 128;   // its output columns
constexpr int kRgbBytes = 3 * 32 * kChunkW;
constexpr int kSmemBytes = kStages * kStageFloats * 4 + kRgbBytes +
                           3 * kMaxCells * 4 +
                           8 * (kMaxUnitRows + kMaxUnitCols) +
                           kGroups * 8 * 4;

// A chunk's layout in its stage: luma rows of 128, then Cb and Cr.
template <int SUB>
struct Chunk {
  static constexpr int kRows = SUB ? 32 : 16;    // pixel rows
  static constexpr int kCRows = 16;              // chroma rows
  static constexpr int kCW = SUB ? 64 : 128;     // chroma columns
  static constexpr int kYBlocks = kRows / 8 * 16;
  static constexpr int kCBlocks = kCRows / 8 * (kCW / 8);  // per plane
  static constexpr int kCb = kRows * kChunkW;
  static constexpr int kCr = kCb + kCRows * kCW;
  static constexpr int kYSegments = kRows * kChunkW / 4;
  static constexpr int kCSegments = kCRows * kCW / 4;  // per plane
  static_assert(kYBlocks + 2 * kCBlocks == 32 * kGroups, "96 blocks");
  static_assert(kCr + kCRows * kCW == kStageFloats, "one stage");
};

struct Probe {
  const float* y;            // (B, ph, pw)
  const float* cb;           // (B, ch, cw)
  const float* cr;           // (B, ch, cw)
  int ph, pw, ch, cw;        // padded plane sizes, multiples of 8
  int h, w;                  // the image
  const float* qtables;      // (101, 2, 64) [luma, chroma] by quality
  const long long* quality;  // (B,), clamped to [0, 100] here
  float d[64];               // the (8, 8) DCT matrix D: coef = D x
  int dh, dw;                // the output
  // With a downsample, ops/resize.box_rectangles: y0, y1 (dh), x0, x1
  // (dw), the rectangles this kernel reads, then which rectangles hold
  // each source row and column (box_cover), which box_plan's chunk
  // records already carry.  Else null.
  const int* bounds;
  // With a downsample (ops/probe_recon_cuda.box_plan), as int4s: nbands
  // records of output rows, then nstrips of output columns, two int4s
  // each: (o0, o1, a, n), outputs [o0, o1) and their n chunks from source
  // index a on, and (first, 0, 0, 0), where the n chunk records of the
  // group begin: (d0, d1, r0, nr), the outputs [d0, d1) of the group that
  // the chunk holds a part of, and the source rows (columns) [r0, r0 + nr)
  // of the chunk that they cover.  Else null, and units are single chunks.
  const int4* plan;
  int nbands, nstrips, units;
  float* lum;                // (B, dh, dw)
};

// The unit of work `unit`: image b, output rows [oy0, oy1) and columns
// [ox0, ox1), and ny x nx chunks from source pixel (ay, ax), whose
// records begin at plan[rows] and plan[cols].
struct Unit {
  int b, oy0, oy1, ay, ny, ox0, ox1, ax, nx, rows, cols;
};

template <int SUB>
__device__ __forceinline__ Unit unit_of(const Probe& p, int unit) {
  using C = Chunk<SUB>;
  Unit u;
  const int per_image = p.nbands * p.nstrips;
  u.b = unit / per_image;
  const int rest = unit - u.b * per_image;
  const int band = rest / p.nstrips;
  const int strip = rest - band * p.nstrips;
  if (p.plan != nullptr) {
    const int4 r = __ldg(p.plan + 2 * band);
    const int4 c = __ldg(p.plan + 2 * (p.nbands + strip));
    u.oy0 = r.x, u.oy1 = r.y, u.ay = r.z, u.ny = r.w;
    u.ox0 = c.x, u.ox1 = c.y, u.ax = c.z, u.nx = c.w;
    u.rows = __ldg(p.plan + 2 * band + 1).x;
    u.cols = __ldg(p.plan + 2 * (p.nbands + strip) + 1).x;
  } else {
    u.ay = u.oy0 = band * C::kRows;
    u.oy1 = min(u.oy0 + C::kRows, p.h);
    u.ax = u.ox0 = strip * kChunkW;
    u.ox1 = min(u.ox0 + kChunkW, p.w);
    u.ny = u.nx = 1;
  }
  return u;
}

// A CTA's place in its walk: unit, and chunk (iy, ix) of it.
struct Cursor {
  int unit, iy, ix;
  Unit u;
};

template <int SUB>
__device__ __forceinline__ void advance(const Probe& p, Cursor& c) {
  if (++c.ix < c.u.nx) return;
  c.ix = 0;
  if (++c.iy < c.u.ny) return;
  c.iy = 0;
  c.unit += gridDim.x;
  if (c.unit < p.units) c.u = unit_of<SUB>(p, c.unit);
}

// The position of column x of a stage row: the halves of a block row are
// swapped in blocks 4..7 of every eight, so that eight neighbouring row
// items' 16-byte accesses fall on distinct banks.
__device__ __forceinline__ int sw(int x) { return x ^ ((x >> 3) & 4); }

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool inside) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
               "l"(src), "r"(inside ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every coefficient of the cursor's chunk into `stage`, zeros outside the
// planes: six 16-byte copies per thread.
template <int SUB>
__device__ __forceinline__ void stage_chunk(const Probe& p, const Cursor& c,
                                            float* stage) {
  using C = Chunk<SUB>;
  const int cy0 = c.u.ay + c.iy * C::kRows;
  const int cx0 = c.u.ax + c.ix * kChunkW;
#pragma unroll
  for (int k = 0; k < kSegments / kThreads; ++k) {
    int t = threadIdx.x + k * kThreads;
    const float* plane;
    int rows, cols, r0, c0, width, off;
    if (t < C::kYSegments) {
      plane = p.y + (size_t)c.u.b * p.ph * p.pw;
      rows = p.ph, cols = p.pw, r0 = cy0, c0 = cx0, width = kChunkW, off = 0;
    } else {
      t -= C::kYSegments;
      const bool is_cr = t >= C::kCSegments;
      if (is_cr) t -= C::kCSegments;
      plane = (is_cr ? p.cr : p.cb) + (size_t)c.u.b * p.ch * p.cw;
      rows = p.ch, cols = p.cw, r0 = cy0 >> SUB, c0 = cx0 >> SUB;
      width = C::kCW, off = is_cr ? C::kCr : C::kCb;
    }
    const int r = t / (width / 4);
    const int x = 4 * (t - r * (width / 4));
    const int gr = r0 + r, gc = c0 + x;
    const bool inside = gr < rows && gc < cols;
    copy16(stage + off + r * width + sw(x),
           inside ? plane + (size_t)gr * cols + gc : plane, inside);
  }
}

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

// Block i (0..95) of a chunk: the offset of its top-left coefficient in
// the stage, its plane's row length, and whether it is chroma.  Luma
// blocks come first, row by row, then Cb's, then Cr's; every group of 32
// is all luma or all chroma, and every four-aligned run of four lies in
// one block row.
template <int SUB>
__device__ __forceinline__ int block_at(int i, int& stride, bool& chroma) {
  using C = Chunk<SUB>;
  if (i < C::kYBlocks) {
    stride = kChunkW, chroma = false;
    return (i >> 4) * 8 * kChunkW + (i & 15) * 8;
  }
  i -= C::kYBlocks;
  const bool is_cr = i >= C::kCBlocks;
  if (is_cr) i -= C::kCBlocks;
  constexpr int across = C::kCW / 8;
  stride = C::kCW, chroma = true;
  return (is_cr ? C::kCr : C::kCb) + (i / across) * 8 * C::kCW +
         (i % across) * 8;
}

// The row pass, in place: row u of 32 blocks per warp item, quantized and
// dequantized at the image's table, then out[j] = sum_v x[v] D[v][j]
// over the terms that are not zero in every lane.  masks[g][u]: which
// blocks of group g have a nonzero row u.
template <int SUB>
__device__ __forceinline__ void row_pass(const Probe& p, float* stage,
                                         const float* qtab,
                                         unsigned* masks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const int u = (warp + 3 * g) & 7;  // each warp a mix of rows
    int stride;
    bool chroma;
    const int at = block_at<SUB>(32 * g + lane, stride, chroma);
    const int lo = sw(at & (kChunkW - 1)) - (at & (kChunkW - 1));
    float* row = stage + at + u * stride;
    float4* half0 = reinterpret_cast<float4*>(row + lo);
    float4* half1 = reinterpret_cast<float4*>(row + (4 - lo));
    const float4* q4 =
        reinterpret_cast<const float4*>(qtab + (chroma ? 64 : 0) + 8 * u);
    const float4 qa = __ldg(q4), qb = __ldg(q4 + 1);
    const float4 ca = *half0, cb = *half1;
    const float c8[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
    const float q8[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    // |c| < q / 4 quantizes to zero whatever the division rounds, so a
    // term whose coefficient is that small in every lane skips it (q / 4
    // is exact).
    float x[8];
#pragma unroll
    for (int v = 0; v < 8; ++v)
      x[v] = __any_sync(0xffffffffu,
                        fabsf(c8[v]) >= __fmul_rn(0.25f, q8[v]))
                 ? requantize(c8[v], q8[v])
                 : 0.0f;
    bool nonzero = false;
#pragma unroll
    for (int v = 0; v < 8; ++v) nonzero |= x[v] != 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, nonzero);
    if (lane == 0) masks[g * 8 + u] = ballot;
    if (ballot == 0) continue;  // the column pass skips this row
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.0f;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (!__any_sync(0xffffffffu, x[v] != 0.0f)) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = fmaf(x[v], p.d[8 * v + j], s[j]);
    }
    *half0 = make_float4(s[0], s[1], s[2], s[3]);
    *half1 = make_float4(s[4], s[5], s[6], s[7]);
  }
}

// The column pass, in place, and the level shift: column x of four
// neighbouring blocks per warp item, sum_u t[u] D[u][k] + 128 over the
// rows u that are nonzero in one of the four.
template <int SUB>
__device__ __forceinline__ void col_pass(const Probe& p, float* stage,
                                         const unsigned* masks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    int stride;
    bool chroma;
    const int at =
        block_at<SUB>(32 * g + 4 * warp + (lane >> 3), stride, chroma);
    const int x = at & (kChunkW - 1);
    float* col = stage + (at - x) + sw(x + (lane & 7));
    const unsigned mine = 0xfu << (4 * warp);
    float t[8], s[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = col[u * stride], s[u] = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (!(masks[g * 8 + u] & mine)) continue;  // uniform in the warp
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = fmaf(t[u], p.d[8 * u + k], s[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) col[k * stride] = __fadd_rn(s[k], 128.0f);
  }
}

// An integral float in [0, 255] as its byte: the low bits of v + 2^23.
__device__ __forceinline__ unsigned byte_of(float v) {
  return __float_as_uint(__fadd_rn(v, 8388608.0f)) & 0xffu;
}

// Colour of two neighbouring pixels of one row: r, g, b bytes (two in
// each short) into rgb, or the luminance to lum inside the image.  cbc,
// crc: the chroma less 128 at each pixel.
__device__ __forceinline__ void colour_pair(const Probe& p, float2 yv,
                                            float2 cbc, float2 crc, int b,
                                            int gy, int gx,
                                            unsigned char* rgb, int at,
                                            int plane) {
  const float ys[2] = {yv.x, yv.y};
  const float cbs[2] = {cbc.x, cbc.y}, crs[2] = {crc.x, crc.y};
  float r[2], g[2], bl[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    r[k] = clamp_u8(__fadd_rn(ys[k], __fmul_rn(1.402f, crs[k])));
    g[k] = clamp_u8(__fsub_rn(__fsub_rn(ys[k], __fmul_rn(0.344136286f,
                                                         cbs[k])),
                              __fmul_rn(0.714136286f, crs[k])));
    bl[k] = clamp_u8(__fadd_rn(ys[k], __fmul_rn(1.772f, cbs[k])));
  }
  if (p.bounds != nullptr) {
    // Pixels past the image are never summed: no test needed.
    *reinterpret_cast<unsigned short*>(rgb + at) =
        (unsigned short)(byte_of(r[0]) | byte_of(r[1]) << 8);
    *reinterpret_cast<unsigned short*>(rgb + plane + at) =
        (unsigned short)(byte_of(g[0]) | byte_of(g[1]) << 8);
    *reinterpret_cast<unsigned short*>(rgb + 2 * plane + at) =
        (unsigned short)(byte_of(bl[0]) | byte_of(bl[1]) << 8);
  } else if (gy < p.h) {
    float* out = p.lum + ((size_t)b * p.h + gy) * p.w + gx;
    if (gx < p.w) out[0] = luminance(r[0], g[0], bl[0]);
    if (gx + 1 < p.w) out[1] = luminance(r[1], g[1], bl[1]);
  }
}

// Colour, two pixels of a row per item: r, g, b bytes into rgb (a
// downsample follows) or the luminance straight to lum.  In 4:2:0 an
// item is a 2 x 2 quad, whose four pixels share one chroma sample and so
// its four products.
template <int SUB>
__device__ __forceinline__ void colour_pass(const Probe& p, const float* st,
                                            int b, int cy0, int cx0,
                                            unsigned char* rgb) {
  using C = Chunk<SUB>;
  constexpr int kPix = C::kRows * kChunkW;
  constexpr int kItems = (C::kRows >> SUB) * (kChunkW / 2);
  for (int i = threadIdx.x; i < kItems; i += kThreads) {
    const int px = 2 * (i & (kChunkW / 2 - 1));
    const int py = (i >> 6) << SUB;
    if (cy0 + py >= p.h || cx0 + px >= p.w) continue;
    if (SUB) {
      const int ci = (py >> 1) * C::kCW + sw(px >> 1);
      const float cbc = __fsub_rn(st[C::kCb + ci], 128.0f);
      const float crc = __fsub_rn(st[C::kCr + ci], 128.0f);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int at = (py + dy) * kChunkW;
        const float2 yv = *reinterpret_cast<const float2*>(st + at + sw(px));
        colour_pair(p, yv, make_float2(cbc, cbc), make_float2(crc, crc), b,
                    cy0 + py + dy, cx0 + px, rgb, at + px, kPix);
      }
    } else {
      const int at = py * kChunkW;
      const float2 yv = *reinterpret_cast<const float2*>(st + at + sw(px));
      const float2 cb2 =
          *reinterpret_cast<const float2*>(st + C::kCb + at + sw(px));
      const float2 cr2 =
          *reinterpret_cast<const float2*>(st + C::kCr + at + sw(px));
      colour_pair(p, yv,
                  make_float2(__fsub_rn(cb2.x, 128.0f),
                              __fsub_rn(cb2.y, 128.0f)),
                  make_float2(__fsub_rn(cr2.x, 128.0f),
                              __fsub_rn(cr2.y, 128.0f)),
                  b, cy0 + py, cx0 + px, rgb, at + px, kPix);
    }
  }
}

// The chunk's share of its unit's rectangle sums: horizontal sums per
// (source row, rectangle column) into hs, then vertical sums per
// (rectangle row, rectangle column) added to acc (unit-local, row-major).
// A lane keeps one rectangle column; a warp takes 32 / columns rows at
// once, so narrow units leave few lanes idle.  ytab, xtab: the unit's
// rectangles (y0, y1) per output row and (x0, x1) per output column.
template <int SUB>
__device__ __forceinline__ void box_pass(const Probe& p, const Unit& u,
                                         int iy, int ix, int cy0, int cx0,
                                         const unsigned char* rgb,
                                         const int2* ytab, const int2* xtab,
                                         unsigned short* hs, int* acc) {
  using C = Chunk<SUB>;
  constexpr int kPix = C::kRows * kChunkW;
  const int4 rc = __ldg(p.plan + u.rows + iy);
  const int4 cc = __ldg(p.plan + u.cols + ix);
  const int dya = rc.x - u.oy0, ndy = rc.y - rc.x, ra = rc.z, nr = rc.w;
  const int dxa = cc.x - u.ox0, ncx = cc.y - cc.x;
  if (ndy <= 0 || ncx <= 0) return;  // uniform in the CTA
  const int cy1 = min(cy0 + C::kRows, p.h), cx1 = min(cx0 + kChunkW, p.w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = min(ncx, 32);
  const int per = 32 / span;  // rows a warp takes at once
  const int sub = lane / span;
  const int first = warp * per + sub, step = kWarps * per;
  const unsigned char* top = rgb + (ra - cy0) * kChunkW;
  if (sub < per) {
    for (int j = lane - sub * span; j < ncx; j += span) {
      const int2 xr = xtab[dxa + j];
      const int xa = max(xr.x, cx0) - cx0, xb = min(xr.y, cx1) - cx0;
      // The bytes [xa, xb) of a row, a word at a time: up to three words
      // with their masks fixed, else word by word.
      const int k0 = xa >> 2, k1 = (xb - 1) >> 2;
      unsigned keep[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int k = k0 + i;
        const int lo = max(xa - 4 * k, 0), hi = min(xb - 4 * k, 4);
        keep[i] = k > k1 ? 0u
                         : (0xffffffffu >> (8 * (4 - hi))) &
                               (0xffffffffu << (8 * lo));
      }
#pragma unroll 4
      for (int row = first; row < 3 * nr; row += step) {  // c * nr + rr
        const int c = (row >= nr) + (row >= 2 * nr);
        const unsigned* line = reinterpret_cast<const unsigned*>(
            top + c * (kPix - nr * kChunkW) + row * kChunkW);
        unsigned sum;
        if (k1 - k0 < 3) {  // reads past the row are masked off
          sum = __dp4a(line[k0] & keep[0], 0x01010101u, 0u);
          sum = __dp4a(line[k0 + 1] & keep[1], 0x01010101u, sum);
          sum = __dp4a(line[k0 + 2] & keep[2], 0x01010101u, sum);
        } else {
          sum = 0;
          for (int k = k0; k <= k1; ++k) {
            const int lo = max(xa - 4 * k, 0), hi = min(xb - 4 * k, 4);
            sum = __dp4a(line[k] & (0xffffffffu >> (8 * (4 - hi))) &
                             (0xffffffffu << (8 * lo)),
                         0x01010101u, sum);
          }
        }
        hs[row * ncx + j] = (unsigned short)sum;
      }
    }
  }
  __syncthreads();
  if (sub >= per) return;
  const int ucols = u.ox1 - u.ox0;
  for (int j = lane - sub * span; j < ncx; j += span) {
    for (int row = first; row < 3 * ndy; row += step) {  // c * ndy + dy
      const int c = (row >= ndy) + (row >= 2 * ndy);
      const int dy = dya + row - c * ndy;
      const int2 yr = ytab[dy];
      const int ya = max(yr.x, ra) - ra, yb = min(yr.y, ra + nr) - ra;
      int sum = 0;
      for (int yy = ya; yy < yb; ++yy) sum += hs[(c * nr + yy) * ncx + j];
      acc[c * kMaxCells + dy * ucols + dxa + j] += sum;
    }
  }
}

// The unit's rectangles into ytab and xtab, at its first chunk.
__device__ __forceinline__ void load_unit(const Probe& p, const Unit& u,
                                          int2* ytab, int2* xtab) {
  const int* y0 = p.bounds;
  const int* y1 = y0 + p.dh;
  const int* x0 = y1 + p.dh;
  const int* x1 = x0 + p.dw;
  for (int i = threadIdx.x; i < u.oy1 - u.oy0; i += kThreads)
    ytab[i] = make_int2(__ldg(y0 + u.oy0 + i), __ldg(y1 + u.oy0 + i));
  for (int i = threadIdx.x; i < u.ox1 - u.ox0; i += kThreads)
    xtab[i] = make_int2(__ldg(x0 + u.ox0 + i), __ldg(x1 + u.ox0 + i));
}

// The unit's rounded means and luminance; acc back to zero.
__device__ __forceinline__ void finish_unit(const Probe& p, const Unit& u,
                                            const int2* ytab,
                                            const int2* xtab, int* acc) {
  const int ucols = u.ox1 - u.ox0;
  const int cells = (u.oy1 - u.oy0) * ucols;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int dy = i / ucols;
    const int dx = i - dy * ucols;
    const int2 yr = ytab[dy], xr = xtab[dx];
    const long long n = (long long)(yr.y - yr.x) * (xr.y - xr.x);
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const long long s = acc[c * kMaxCells + i];
      acc[c * kMaxCells + i] = 0;
      // floor(s / n + 1/2) in integers (in 32 bits while 2 s + n, at most
      // 511 n, fits); an empty rectangle is 0, as a row of zero weights
      // makes it.
      v[c] = n <= 0 ? 0.0f
             : n <= (1 << 22)
                 ? (float)((unsigned)(2 * s + n) / (unsigned)(2 * n))
                 : (float)((2 * s + n) / (2 * n));
    }
    p.lum[((size_t)u.b * p.dh + u.oy0 + dy) * p.dw + u.ox0 + dx] =
        luminance(v[0], v[1], v[2]);
  }
}

template <int SUB>
__global__ void __launch_bounds__(kThreads, 3)
    probe_recon_kernel(const Probe p) {
  using C = Chunk<SUB>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  unsigned char* rgb = smem + kStages * kStageFloats * 4;
  int* acc = reinterpret_cast<int*>(rgb + kRgbBytes);
  int2* ytab = reinterpret_cast<int2*>(acc + 3 * kMaxCells);
  int2* xtab = ytab + kMaxUnitRows;
  unsigned* masks = reinterpret_cast<unsigned*>(xtab + kMaxUnitCols);

  for (int i = threadIdx.x; i < 3 * kMaxCells; i += kThreads) acc[i] = 0;

  // The first kStages - 1 chunks in flight; one commit group per chunk
  // (empty past the end), so the wait below counts chunks.
  Cursor cur{(int)blockIdx.x, 0, 0, unit_of<SUB>(p, blockIdx.x)};
  Cursor load = cur;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (load.unit < p.units) {
      stage_chunk<SUB>(p, load, ring + s * kStageFloats);
      advance<SUB>(p, load);
    }
    commit();
  }
  for (int k = 0; cur.unit < p.units; ++k) {
    // Chunk k + 1 into the stage chunk k - 1 left.
    if (load.unit < p.units) {
      stage_chunk<SUB>(p, load, ring + ((k + kStages - 1) % kStages) *
                                           kStageFloats);
      advance<SUB>(p, load);
    }
    commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncthreads();

    float* st = ring + (k % kStages) * kStageFloats;
    const Unit& u = cur.u;
    long long q = p.quality[u.b];
    q = q < 0 ? 0 : (q > 100 ? 100 : q);
    const int cy0 = u.ay + cur.iy * C::kRows;
    const int cx0 = u.ax + cur.ix * kChunkW;
    if (p.bounds != nullptr && cur.iy == 0 && cur.ix == 0)
      load_unit(p, u, ytab, xtab);  // read after the passes' barriers
    row_pass<SUB>(p, st, p.qtables + q * 128, masks);
    __syncthreads();
    col_pass<SUB>(p, st, masks);
    __syncthreads();
    colour_pass<SUB>(p, st, u.b, cy0, cx0, rgb);
    if (p.bounds != nullptr) {
      __syncthreads();
      // The stage's coefficients are spent: its memory holds hs.
      box_pass<SUB>(p, u, cur.iy, cur.ix, cy0, cx0, rgb, ytab, xtab,
                    reinterpret_cast<unsigned short*>(st), acc);
      if (cur.iy == u.ny - 1 && cur.ix == u.nx - 1) {
        __syncthreads();
        finish_unit(p, u, ytab, xtab, acc);
      }
    }
    __syncthreads();  // the stage and rgb are free for chunk k + 1
    advance<SUB>(p, cur);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int SUB>
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(probe_recon_kernel<SUB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

extern "C" {

const char* fennec_probe_recon_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// CTAs of K2 that fit on one SM of the current device at once, or minus
// the CUDA error.
int fennec_probe_recon_ctas_per_sm(int subsample) {
  cudaError_t err = subsample ? prepare<1>() : prepare<0>();
  int n = 0;
  if (err == cudaSuccess)
    err = subsample ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, probe_recon_kernel<1>, kThreads, kSmemBytes)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, probe_recon_kernel<0>, kThreads, kSmemBytes);
  return err == cudaSuccess ? n : -(int)err;
}

// K2.  y (nimg, ph, pw), cb and cr (nimg, ch, cw) float32, 16-byte
// aligned, ph, pw, ch, cw multiples of 8 and (ch, cw) = (ph, pw) / 2 when
// subsample, else (ph, pw); qtables (101, 2, 64) float32; quality (nimg,)
// int64; dmat the (8, 8) float32 DCT matrix in host memory (it travels
// in the launch's parameters, so the passes read it as constants); lum
// (nimg, dh, dw) float32.  Without a
// downsample (bounds and plan NULL) (dh, dw) = (h, w), nbands = ceil(h /
// rows) with rows 32 when subsampled, else 16, and nstrips = ceil(w /
// 128).  With one, bounds holds 2 dh + 2 dw + 2 h + 2 w int32 (see Probe)
// and plan the int32 records of ops/probe_recon_cuda.box_plan, 16-byte
// aligned.
// ctas: the grid, at most the units.  One launch on `stream`; returns a
// cudaError_t.
int fennec_probe_recon(const void* y, const void* cb, const void* cr,
                       int nimg, int ph, int pw, int ch, int cw, int h,
                       int w, int subsample, const void* qtables,
                       const void* quality, const void* dmat, int dh, int dw,
                       const void* bounds, const void* plan, int nbands,
                       int nstrips, int ctas, void* lum, void* stream) {
  const int rows = subsample ? 32 : 16;
  if (nimg < 1 || nbands < 1 || nstrips < 1 || ctas < 1 ||
      (bounds == nullptr) != (plan == nullptr) ||
      (bounds == nullptr &&
       (dh != h || dw != w || nbands != (h + rows - 1) / rows ||
        nstrips != (w + kChunkW - 1) / kChunkW)) ||
      (long long)nimg * nbands * nstrips > 0x7fffffffLL)
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
  p.qtables = (const float*)qtables;
  p.quality = (const long long*)quality;
  for (int i = 0; i < 64; ++i) p.d[i] = ((const float*)dmat)[i];
  p.dh = dh;
  p.dw = dw;
  p.bounds = (const int*)bounds;
  p.plan = (const int4*)plan;
  p.nbands = nbands;
  p.nstrips = nstrips;
  p.units = nimg * nbands * nstrips;
  p.lum = (float*)lum;
  const int grid = ctas < p.units ? ctas : p.units;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = subsample ? prepare<1>() : prepare<0>();
  if (err != cudaSuccess) return (int)err;
  if (subsample)
    probe_recon_kernel<1><<<grid, kThreads, kSmemBytes, s>>>(p);
  else
    probe_recon_kernel<0><<<grid, kThreads, kSmemBytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
