// Kernel K9: the entropy decode of a single-scan baseline JPEG on the
// device, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package, like the port before K9,
// decodes every scan on the host (fennec_tpu/native/entropy.cpp:498,
// fennec_jpeg_decode_scan, through codecs/jpeg.py).  K9 was added because
// that serial decode held most of a 12 MP request on the port's main path
// (some 60 ms of ~100 on an H100's host) and its blocks then went up as
// 36.6 MB of int16.  With K9 only the coded bytes go up, and the blocks are
// born where kernel K7 reads them.  The plain model, which this kernel is
// held to bit for bit on the card and which is held to the host decoder on
// the CPU, is fennec_tpu_torch/ops/huffman_decode.py; the wrapper is
// ops/huffman_decode_cuda.py.
//
// Input, in one staged buffer copied up at once: the scan's stuffed bytes
// (to the data's end), the restart intervals (segments: data bits, first
// block, blocks, subsequences) where the scan has them, every component's
// DC and AC tables (a 10-bit lookahead table of length << 8 | symbol, and
// maxcode / delta / values for longer codes), the MCU's blocks (component,
// dy, dx of each), the round counters and the flag, zeroed.  Output: each
// component's (bw * bh, 64) int16 blocks in natural order, every one
// written, what the host decoder returns for the scan; and the flag, 0
// when they are exactly that.  Any anomaly (an invalid code, a run past
// 63, a DC size above 16, a block reading past its interval's data, an
// interval short of blocks, a block out of order; and rounds that did not
// converge, which the launches' bound rules out) sets a bit of the flag and
// the caller decodes the file on the host, which returns or raises what it
// always did.
//
// What bounds it on an H100.  Bytes: ~1.6 MB of coded bytes read and 36.6
// MB of blocks written at 12 MP (11.4 us at 3.35 TB/s).  But the decode of
// a stretch of bits is a dependent chain, a table lookup and a shift a
// symbol, so what bounds it is latency: the longest chain one thread
// walks.  Measured (-DK9_STAMPS): ~1 060 cycles a symbol at 12 MP, with 4
// warps an SM.  The design cuts the scan into chains and keeps each short.
//
// Design (a decoder state is (p, u, k): the next symbol's bit, the block's
// index in its MCU, the next coefficient, 0 for the DC symbol; a
// subsequence of sub_bits bits owns the blocks whose DC symbol starts in
// it; subsequences never cross a restart interval):
//   1. count, prefix, unstuff: a thread a span of kSpan bytes counts its
//      stuffed zeros (a 0x00 after a 0xFF) and, for a scan without
//      restart intervals, the first marker (its data's end); one CTA
//      scans the counts and lays out that one interval; each span then
//      copies its bytes but the stuffed zeros to the bit buffer, and the
//      last the kPad zero bytes past the end.  Restart intervals are laid
//      out on the host.
//   2. sync, a launch of CTAs of kThreads subsequences for each CTA.
//      Launch 0 decodes each from its guess (its first bit, u = k = 0;
//      exact for an interval's first) to the first symbol boundary at or
//      past its end: its exit state, its blocks begun and their DC
//      differences summed by component, and kChecks checkpoint slots on
//      the way.  Then, in every launch, the CTA repeats: each thread takes
//      its predecessor's exit (shared memory; the CTA's first reads the
//      launch before's, double-buffered) and, if its start changed,
//      decodes again, stopping at the first slot where it meets the state
//      its last decode recorded there; until no start changes
//      (__syncthreads_or).  Huffman codes resynchronise, so a decode from a
//      wrong guess soon lands on the true boundaries.  An exit at ERROR (an
//      invalid symbol) leaves the successor's start alone.  A launch counts
//      the CTAs whose last exit moved from the start their successor, the
//      next CTA's first, holds; a launch runs only when the one before
//      counted one, so the chain ends after the first launch that counts
//      none.  CTA b is exact once launch b has run (its first reads CTA
//      b - 1's exact exit), so the last of the launches, one per CTA,
//      counts none on any input: the rounds always converge.
//   3. scan: one CTA scans the counts and DC sums, restarting with each
//      interval: each subsequence's first block and DC predictors; an
//      interval with fewer blocks than its MCUs raises the flag.
//   4. write: a thread a checkpoint slot decodes from the slot's state,
//      skips the end of a block begun before it, and builds each block
//      whose DC symbol starts before the next slot in shared memory, zeros
//      included (no memset), the DC value its predictor plus the
//      difference (an int, stored as int16, as the host decoder does),
//      then stores it as eight 16-byte stores at its place in its
//      component's grid.  Blocks past an interval's last are its padding
//      bits and are dropped.
// The decoder keeps a 64-bit window of the bits in registers, refilled a
// word at a time.  Integer arithmetic only; no tensor cores, TMA or
// clusters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLutBits = 10;
constexpr int kLut = 1 << kLutBits;
constexpr int kThreads = 128;
constexpr int kChecks = 8;  // checkpoint slots of a subsequence
constexpr int kMaxComps = 4;
constexpr int kMaxBpm = 64;
constexpr int kTables = 2 * kMaxComps;
constexpr int kScanThreads = 1024;
constexpr int kSpan = 64;  // scan bytes a thread of count and unstuff
constexpr int kUnstuffThreads = 256;
constexpr int kPad = 16;  // zero bytes past the bit buffer's data

enum Flag : int {
  kBadCode = 1,
  kBadRun = 2,
  kBadDc = 4,
  kPastEnd = 8,
  kNoSync = 16,  // the last launch counted a move (never, by design)
  kShort = 32,
  kBadOrder = 64,
};

__constant__ uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

#ifdef K9_STAMPS
// Per subsequence j < kStamped of the last launch of round 0: clock64()
// cycles and symbols of its first decode, in-CTA iterations, cycles from
// the kernel's start to its end.
constexpr int kStamped = 1 << 15;
__device__ long long k9_stamps[kStamped][4];
#endif

struct Params {
  // The staged buffer.
  const uint8_t* scan;
  int scan_len;
  int spans;        // threads of kSpan scan bytes
  int* span;        // (spans + 1,) stuffed zeros a span, then their prefix
  int* end_byte;    // the first marker (device_layout), staged as scan_len
  int device_layout;  // the card finds the one interval (no restarts)
  int total_blocks;
  int* seg_start;
  int* seg_end;
  int* seg_first_block;
  int* seg_blocks;
  int* seg_first_sub;  // nseg + 1 entries
  int nseg;
  int* nsub;        // subsequences, staged or found by the card
  int nsub_max;     // the grids' bound on *nsub
  int sub_bits;
  const uint16_t* lut;  // (2 ncomp, kLut): component c's DC at 2c, AC 2c+1
  const int* maxcode;   // (2 ncomp, 17)
  const int* delta;     // (2 ncomp, 17)
  const uint8_t* vals;  // (2 ncomp, 256)
  const uint8_t* ucomp;  // (bpm,)
  const uint8_t* udy;
  const uint8_t* udx;
  int ncomp;
  int bpm;
  int mcus_x;
  int comp_h[kMaxComps];
  int comp_v[kMaxComps];
  int comp_bw[kMaxComps];
  int rounds;     // sync launches: one per CTA of the grid's bound
  int* changed;  // (rounds,) CTAs whose last exit moved, per launch
  int* flag;
  // The workspace.
  uint8_t* bits;  // unstuffed bytes, kPad zero bytes after them
  int2* start;    // (nsub,) synced start states: (p, u << 6 | k)
  int2* exits[2];
  int* count;     // (nsub,)
  int* dcsum;     // (nsub, 4)
  int* first;     // (nsub,)
  int* pred;      // (nsub, 4)
  int4* ck;       // (nsub, kChecks, 2) checkpoint slots
  int16_t* out[kMaxComps];
};

struct Tabs {
  uint16_t lut[kTables * kLut];
  int maxcode[kTables * 17];
  int delta[kTables * 17];
  uint8_t vals[kTables * 256];
  uint8_t ucomp[kMaxBpm];
  uint8_t udy[kMaxBpm];
  uint8_t udx[kMaxBpm];
  uint8_t zigzag[64];
};

__device__ void load_tabs(Tabs& t, const Params& P) {
  const int nt = 2 * P.ncomp;
  const uint32_t* lut32 = reinterpret_cast<const uint32_t*>(P.lut);
  uint32_t* dst32 = reinterpret_cast<uint32_t*>(t.lut);
  for (int i = threadIdx.x; i < nt * kLut / 2; i += blockDim.x)
    dst32[i] = lut32[i];
  for (int i = threadIdx.x; i < nt * 17; i += blockDim.x) {
    t.maxcode[i] = P.maxcode[i];
    t.delta[i] = P.delta[i];
  }
  for (int i = threadIdx.x; i < nt * 256; i += blockDim.x)
    t.vals[i] = P.vals[i];
  for (int i = threadIdx.x; i < P.bpm; i += blockDim.x) {
    t.ucomp[i] = P.ucomp[i];
    t.udy[i] = P.udy[i];
    t.udx[i] = P.udx[i];
  }
  if (threadIdx.x < 64) t.zigzag[threadIdx.x] = kZigzag[threadIdx.x];
}

struct Sub {
  int seg;
  int start;
  int end;
  int seg_end;
  bool first;
};

// Subsequence j's bounds: the last interval whose first subsequence is at
// or before j (ops/huffman_decode.sub_bounds).
__device__ Sub sub_bounds(const Params& P, int j) {
  int lo = 0, hi = P.nseg;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (P.seg_first_sub[mid] <= j) lo = mid; else hi = mid;
  }
  const int i = j - P.seg_first_sub[lo];
  Sub s;
  s.seg = lo;
  s.start = P.seg_start[lo] + i * P.sub_bits;
  s.seg_end = P.seg_end[lo];
  s.end = min(s.start + P.sub_bits, s.seg_end);
  s.first = i == 0;
  return s;
}

// The 32 bits at bit q (a multiple of 32) of the unstuffed bytes, read as
// a big-endian word; those at or past seg_end read as 0, as the host
// decoder feeds zeros past a marker.
__device__ __forceinline__ uint32_t word_at(const uint32_t* words, int q,
                                            int seg_end) {
  if (q >= seg_end) return 0u;
  uint32_t v = __byte_perm(__ldg(words + (q >> 5)), 0, 0x0123);
  const int rem = seg_end - q;
  if (rem < 32) v &= 0xFFFFFFFFu << (32 - rem);
  return v;
}

// The code at the top of v in table `tab`: its length (0 for none) and
// symbol.
__device__ __forceinline__ int symbol(const Tabs& t, int tab, uint32_t v,
                                      int& sym) {
  const uint32_t e = t.lut[tab * kLut + (v >> (32 - kLutBits))];
  if (e) {
    sym = (int)(e & 0xFF);
    return (int)(e >> 8);
  }
  for (int len = kLutBits + 1; len <= 16; ++len) {
    const int code = (int)(v >> (32 - len));
    if (code <= t.maxcode[tab * 17 + len]) {
      sym = t.vals[tab * 256 + code + t.delta[tab * 17 + len]];
      return len;
    }
  }
  return 0;
}

__device__ __forceinline__ int extend(uint32_t v, int s) {
  if (s == 0) return 0;
  return v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
}

// A decoder: the state (p, u, k), the component c of block u, and a 64-bit
// window of the bits from p, nb of them loaded (at least 32 between
// symbols, enough for a code and its extra bits), refilled a word at a
// time, so that a symbol's chain of dependent steps holds no load.
struct Decoder {
  const uint32_t* words;
  int seg_end;
  int p;
  int u;
  int k;
  int c;
  int nb;
  int q;  // the bit of the next word to load
  int n;  // symbols decoded
  uint64_t win;
};

__device__ __forceinline__ void begin_at(Decoder& d, const Tabs& t,
                                     const uint32_t* words, int seg_end,
                                     int2 st) {
  d.words = words;
  d.seg_end = seg_end;
  d.p = st.x;
  d.u = st.y >> 6;
  d.k = st.y & 63;
  d.c = t.ucomp[d.u];
  const int q = st.x & ~31;
  const uint64_t w = ((uint64_t)word_at(words, q, seg_end) << 32) |
                     word_at(words, q + 32, seg_end);
  d.win = w << (st.x - q);
  d.nb = 64 - (st.x - q);
  d.q = q + 64;
  d.n = 0;
}

__device__ __forceinline__ int2 pack(const Decoder& d) {
  return make_int2(d.p, (d.u << 6) | d.k);
}

// One symbol (ops/huffman_decode._step), the DC and AC symbols down one
// path.  Returns 0 or the flag of the anomaly.  A DC symbol sets diff; an
// AC symbol with a value sets zz (its zigzag index) and val, else zz = -1.
__device__ __forceinline__ int next(const Tabs& t, Decoder& d, int bpm,
                                   int& diff, int& zz, int& val) {
  const bool dc = d.k == 0;
  int sym = 0;
  const int len =
      symbol(t, 2 * d.c + (dc ? 0 : 1), (uint32_t)(d.win >> 32), sym);
  if (len == 0) return kBadCode;
  const int size = dc ? sym : (sym & 15);
  if (size > 16) return kBadDc;
  const uint32_t x =
      size ? (uint32_t)((d.win << len) >> (64 - size)) : 0u;
  const int v = extend(x, size);
  const int n = len + size;
  d.win <<= n;
  d.nb -= n;
  d.p += n;
  ++d.n;
  if (d.nb < 32) {
    d.win |= (uint64_t)word_at(d.words, d.q, d.seg_end) << (32 - d.nb);
    d.nb += 32;
    d.q += 32;
  }
  zz = -1;
  if (dc) {
    diff = v;
    d.k = 1;
    return 0;
  }
  const int zeros = sym >> 4;
  if (size == 0) {
    d.k = zeros == 15 ? d.k + 16 : 64;
  } else {
    d.k += zeros;
    if (d.k > 63) return kBadRun;
    zz = d.k;
    val = v;
    d.k += 1;
  }
  if (d.k >= 64) {
    d.k = 0;
    d.u = d.u + 1 == bpm ? 0 : d.u + 1;
    d.c = t.ucomp[d.u];
  }
  return 0;
}

__device__ __forceinline__ void add4(unsigned (&d)[kMaxComps], int c,
                                     unsigned x) {
#pragma unroll
  for (int q = 0; q < kMaxComps; ++q)
    if (q == c) d[q] += x;
}

// A subsequence's checkpoint slots: slot m, two int4 (state p, u << 6 | k,
// blocks begun before it, 0; the DC sums before it), is the first symbol
// boundary at or past bit start + m * spacing, for the slots whose bit lies
// before the end (slot 0, the start, always); p = -1 marks a slot no
// decode reached (one met an invalid symbol first).
__device__ __forceinline__ int slots(const Sub& sb, int spacing) {
  return max(1, min(kChecks, (sb.end - sb.start + spacing - 1) / spacing));
}

// Decode from st to the first symbol boundary at or past the subsequence's
// end (ops/huffman_decode.run): the exit state (ERROR (-1, 0) on an invalid
// symbol), the blocks begun before the end and their DC differences summed
// by component; the slots ck rewritten on the way.  `again`: a decode from
// a new start, whose last decode ended at old_ex with old_cnt and old_dcs;
// at a slot where it meets the state that decode recorded it is that
// decode from there on, so it stops, moves the later slots' counts by the
// difference and returns the last results moved by it.
__device__ int2 run(const Tabs& t, const uint32_t* words, int bpm, int2 st,
                    const Sub& sb, int spacing, int4* ck, bool again,
                    int2 old_ex, int old_cnt,
                    const unsigned (&old_dcs)[kMaxComps], int& count,
                    unsigned (&dcs)[kMaxComps], int& steps) {
  count = 0;
#pragma unroll
  for (int q = 0; q < kMaxComps; ++q) dcs[q] = 0;
  const int nck = slots(sb, spacing);
  Decoder d;
  begin_at(d, t, words, sb.seg_end, st);
  int m = 0, mark = sb.start;
  while (true) {
    if (d.p >= mark) {
      for (; m < nck && d.p >= sb.start + m * spacing; ++m) {
        const int2 here = pack(d);
        if (again && m > 0) {
          const int4 a = ck[2 * m];
          if (a.x == here.x && a.y == here.y) {
            const int4 b = ck[2 * m + 1];
            const int dc = count - a.z;
            const unsigned dd[kMaxComps] = {
                dcs[0] - (unsigned)b.x, dcs[1] - (unsigned)b.y,
                dcs[2] - (unsigned)b.z, dcs[3] - (unsigned)b.w};
            for (int i = m; i < nck; ++i) {
              int4 ai = ck[2 * i];
              if (ai.x < 0) break;
              ai.z += dc;
              ck[2 * i] = ai;
              int4 bi = ck[2 * i + 1];
              bi.x = (int)((unsigned)bi.x + dd[0]);
              bi.y = (int)((unsigned)bi.y + dd[1]);
              bi.z = (int)((unsigned)bi.z + dd[2]);
              bi.w = (int)((unsigned)bi.w + dd[3]);
              ck[2 * i + 1] = bi;
            }
            count = old_cnt + dc;
#pragma unroll
            for (int q = 0; q < kMaxComps; ++q) dcs[q] = old_dcs[q] + dd[q];
            steps = d.n;
            return old_ex;
          }
        }
        ck[2 * m] = make_int4(here.x, here.y, count, 0);
        ck[2 * m + 1] = make_int4((int)dcs[0], (int)dcs[1], (int)dcs[2],
                                  (int)dcs[3]);
      }
      mark = m < nck ? sb.start + m * spacing : 0x7FFFFFFF;
    }
    if (d.p >= sb.end) {
      steps = d.n;
      return pack(d);
    }
    const bool dc = d.k == 0;
    const int c = d.c;
    int diff = 0, zz, val;
    if (next(t, d, bpm, diff, zz, val)) {
      for (int i = m; i < nck; ++i) ck[2 * i].x = -1;
      steps = d.n;
      return make_int2(-1, 0);
    }
    if (dc) {
      ++count;
      add4(dcs, c, (unsigned)diff);
    }
  }
}

// A stuffed zero: a 0x00 after a 0xFF, dropped as the host decoder drops
// it.
__device__ __forceinline__ bool is_drop(const uint8_t* s, int i) {
  return i > 0 && s[i] == 0 && s[i - 1] == 0xFF;
}

// Each thread, a span of kSpan bytes: its stuffed zeros, and (device
// layout) the first marker in it: a 0xFF followed by anything but 0x00, or
// the data's last byte, the end of the scan's data.
__global__ void __launch_bounds__(kUnstuffThreads) count_kernel(Params P) {
  const int t = blockIdx.x * kUnstuffThreads + threadIdx.x;
  if (t >= P.spans) return;
  const int a = t * kSpan, b = min(a + kSpan, P.scan_len);
  int drops = 0, mark = -1;
  uint8_t prev = a > 0 ? P.scan[a - 1] : 0;
  for (int i = a; i < b; ++i) {
    const uint8_t c = P.scan[i];
    drops += c == 0 && prev == 0xFF;
    if (c == 0xFF && mark < 0 && (i + 1 == P.scan_len || P.scan[i + 1] != 0))
      mark = i;
    prev = c;
  }
  P.span[t] = drops;
  if (P.device_layout && mark >= 0) atomicMin(P.end_byte, mark);
}

// One CTA: the exclusive prefix of the spans' stuffed zeros (span[spans]
// their total); with the device layout, the one interval: its data bits
// end at the first marker's unstuffed bit, and it holds a subsequence for
// every sub_bits bits of them (ops/huffman_decode.complete_on_device).
__global__ void __launch_bounds__(kScanThreads) prefix_kernel(Params P) {
  __shared__ int part[kScanThreads];
  const int tid = threadIdx.x, n = P.spans;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int a = min(tid * per, n), b = min(a + per, n);
  int sum = 0;
  for (int i = a; i < b; ++i) sum += P.span[i];
  part[tid] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int x = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += x;
    __syncthreads();
  }
  int run = tid ? part[tid - 1] : 0;
  for (int i = a; i < b; ++i) {
    const int c = P.span[i];
    P.span[i] = run;
    run += c;
  }
  if (tid == kScanThreads - 1) P.span[n] = part[tid];
  if (!P.device_layout) return;
  __syncthreads();
  if (tid == 0) {
    const int end = *P.end_byte;
    const int t = end / kSpan;
    int before = P.span[t];
    for (int i = t * kSpan; i < end; ++i) before += is_drop(P.scan, i);
    const int bits = (end - before) * 8;
    const int nsub = max(1, (bits + P.sub_bits - 1) / P.sub_bits);
    P.seg_start[0] = 0;
    P.seg_end[0] = bits;
    P.seg_first_block[0] = 0;
    P.seg_blocks[0] = P.total_blocks;
    P.seg_first_sub[0] = 0;
    P.seg_first_sub[1] = nsub;
    *P.nsub = nsub;
  }
}

// Each thread, a span: its bytes but the stuffed zeros to the bit buffer at
// their unstuffed place; the last also the kPad zero bytes past the end.
__global__ void __launch_bounds__(kUnstuffThreads) unstuff_kernel(Params P) {
  const int t = blockIdx.x * kUnstuffThreads + threadIdx.x;
  if (t >= P.spans) return;
  const int a = t * kSpan, b = min(a + kSpan, P.scan_len);
  int r = P.span[t];
  uint8_t prev = a > 0 ? P.scan[a - 1] : 0;
  for (int i = a; i < b; ++i) {
    const uint8_t c = P.scan[i];
    if (c == 0 && prev == 0xFF) ++r; else P.bits[i - r] = c;
    prev = c;
  }
  if (t == P.spans - 1)
    for (int i = 0; i < kPad; ++i) P.bits[b - r + i] = 0;
}

__global__ void __launch_bounds__(kThreads) sync_kernel(Params P, int round) {
  if (round > 0 && P.changed[round - 1] == 0) return;
#ifdef K9_STAMPS
  const long long t_begin = clock64();
  long long t_first = 0;
  int first_steps = 0, iterations = 0;
#endif
  __shared__ Tabs t;
  __shared__ int2 sh_ex[kThreads];
  load_tabs(t, P);
  __syncthreads();
  const uint32_t* words = reinterpret_cast<const uint32_t*>(P.bits);
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool live = j < *P.nsub;
  Sub sb{0, 0, 0, 0, true};
  if (live) sb = sub_bounds(P, j);
  const int2* ex_in = P.exits[(round + 1) & 1];
  int2* ex_out = P.exits[round & 1];
  int2 st = make_int2(0, 0), ex = make_int2(0, 0), was = ex;
  int cnt = 0;
  unsigned d[kMaxComps] = {0, 0, 0, 0};
  const int spacing = (P.sub_bits + kChecks - 1) / kChecks;
  int4* ck = P.ck + (long long)j * 2 * kChecks;
  if (live) {
    int steps = 0;
    if (round == 0) {
      st = make_int2(sb.start, 0);
#ifdef K9_STAMPS
      t_first = clock64();
#endif
      ex = run(t, words, P.bpm, st, sb, spacing, ck, false, ex, cnt, d, cnt,
               d, steps);
#ifdef K9_STAMPS
      t_first = clock64() - t_first;
      first_steps = steps;
#endif
    } else {
      st = P.start[j];
      ex = ex_in[j];
      was = ex;
      cnt = P.count[j];
#pragma unroll
      for (int q = 0; q < kMaxComps; ++q) d[q] = (unsigned)P.dcsum[4 * j + q];
    }
  }
  int2 boundary = st;
  if (live && round > 0 && threadIdx.x == 0 && !sb.first)
    boundary = ex_in[j - 1];
  for (int it = 0; it <= kThreads; ++it) {
    sh_ex[threadIdx.x] = ex;
    __syncthreads();
    const int2 pred = (sb.first || threadIdx.x == 0)
                          ? boundary : sh_ex[threadIdx.x - 1];
    const bool ch =
        live && pred.x >= 0 && (pred.x != st.x || pred.y != st.y);
    if (ch) {
      st = pred;
      const unsigned od[kMaxComps] = {d[0], d[1], d[2], d[3]};
      int steps = 0;
      ex = run(t, words, P.bpm, st, sb, spacing, ck, true, ex, cnt, od, cnt,
               d, steps);
    }
#ifdef K9_STAMPS
    ++iterations;
#endif
    if (!__syncthreads_or(ch)) break;
  }
#ifdef K9_STAMPS
  if (live && round == 0 && j < kStamped) {
    k9_stamps[j][0] = t_first;
    k9_stamps[j][1] = first_steps;
    k9_stamps[j][2] = iterations;
    k9_stamps[j][3] = clock64() - t_begin;
  }
#endif
  if (live) {
    P.start[j] = st;
    ex_out[j] = ex;
    P.count[j] = cnt;
#pragma unroll
    for (int q = 0; q < kMaxComps; ++q) P.dcsum[4 * j + q] = (int)d[q];
  }
  // The CTA's last exit against the start its successor holds (launch 0:
  // its guess; later: the exit the launch before left, which it took; an
  // ERROR there, which it did not take, counts as a move).
  if (live && threadIdx.x == kThreads - 1 && sb.end < sb.seg_end &&
      ex.x >= 0) {
    const int2 held = round == 0 ? make_int2(sb.end, 0) : was;
    if (held.x != ex.x || held.y != ex.y)
      atomicAdd(&P.changed[round], 1);
  }
}

__global__ void __launch_bounds__(kScanThreads) scan_kernel(Params P) {
  if (P.changed[P.rounds - 1] != 0) {
    if (threadIdx.x == 0) atomicOr(P.flag, kNoSync);
    return;
  }
  __shared__ int sf[kScanThreads];
  __shared__ int sc[kScanThreads];
  __shared__ unsigned sd[kMaxComps][kScanThreads];
  const int tid = threadIdx.x;
  const int n = *P.nsub;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int a = min(tid * per, n), b = min(a + per, n);
  int seg = 0;
  {
    int lo = 0, hi = P.nseg;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (P.seg_first_sub[mid] <= a) lo = mid; else hi = mid;
    }
    seg = lo;
  }
  int reset = 0, c = 0;
  unsigned d[kMaxComps] = {0, 0, 0, 0};
  for (int j = a, s = seg; j < b; ++j) {
    while (P.seg_first_sub[s + 1] <= j) ++s;
    if (P.seg_first_sub[s] == j) {
      reset = 1;
      c = 0;
#pragma unroll
      for (int q = 0; q < kMaxComps; ++q) d[q] = 0;
    }
    c += P.count[j];
#pragma unroll
    for (int q = 0; q < kMaxComps; ++q) d[q] += (unsigned)P.dcsum[4 * j + q];
  }
  sf[tid] = reset;
  sc[tid] = c;
#pragma unroll
  for (int q = 0; q < kMaxComps; ++q) sd[q][tid] = d[q];
  __syncthreads();
  // Inclusive scan with the segmented operator: a right part that holds a
  // restart keeps its own sum.
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const bool take = tid >= off;
    int f = 0, cc = 0;
    unsigned dd[kMaxComps] = {0, 0, 0, 0};
    if (take) {
      f = sf[tid - off];
      cc = sc[tid - off];
#pragma unroll
      for (int q = 0; q < kMaxComps; ++q) dd[q] = sd[q][tid - off];
    }
    __syncthreads();
    if (take) {
      if (!sf[tid]) {
        sc[tid] += cc;
#pragma unroll
        for (int q = 0; q < kMaxComps; ++q) sd[q][tid] += dd[q];
      }
      sf[tid] |= f;
    }
    __syncthreads();
  }
  c = tid ? sc[tid - 1] : 0;
#pragma unroll
  for (int q = 0; q < kMaxComps; ++q) d[q] = tid ? sd[q][tid - 1] : 0u;
  for (int j = a, s = seg; j < b; ++j) {
    while (P.seg_first_sub[s + 1] <= j) ++s;
    if (P.seg_first_sub[s] == j) {
      c = 0;
#pragma unroll
      for (int q = 0; q < kMaxComps; ++q) d[q] = 0;
    }
    P.first[j] = P.seg_first_block[s] + c;
#pragma unroll
    for (int q = 0; q < kMaxComps; ++q) P.pred[4 * j + q] = (int)d[q];
    c += P.count[j];
#pragma unroll
    for (int q = 0; q < kMaxComps; ++q) d[q] += (unsigned)P.dcsum[4 * j + q];
    if (j + 1 == P.seg_first_sub[s + 1] && c < P.seg_blocks[s])
      atomicOr(P.flag, kShort);
  }
}

__global__ void __launch_bounds__(kThreads) write_kernel(Params P) {
  if (P.changed[P.rounds - 1] != 0) return;
  __shared__ Tabs t;
  __shared__ __align__(16) int16_t blk[kThreads][64];
  load_tabs(t, P);
  __syncthreads();
  const int id = blockIdx.x * kThreads + threadIdx.x;
  const int j = id / kChecks, m = id % kChecks;
  if (j >= *P.nsub) return;
  const Sub sb = sub_bounds(P, j);
  const int spacing = (P.sub_bits + kChecks - 1) / kChecks;
  const int nck = slots(sb, spacing);
  const int4* ck = P.ck + (long long)j * 2 * kChecks;
  if (m >= nck) return;
  const int4 a = ck[2 * m];
  if (a.x < 0) return;
  const int4 bsum = ck[2 * m + 1];
  int stop = sb.end;
  if (m + 1 < nck && ck[2 * m + 2].x >= 0) stop = ck[2 * m + 2].x;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(P.bits);
  Decoder d;
  begin_at(d, t, words, sb.seg_end, make_int2(a.x, a.y));
  int diff = 0, zz = -1, val = 0;
  // The end of a block begun before this piece: its owner writes it.
  while (d.k != 0)
    if (next(t, d, P.bpm, diff, zz, val)) return;
  int g = P.first[j] + a.z;
  const int last = P.seg_first_block[sb.seg] + P.seg_blocks[sb.seg];
  unsigned dc[kMaxComps] = {
      (unsigned)P.pred[4 * j] + (unsigned)bsum.x,
      (unsigned)P.pred[4 * j + 1] + (unsigned)bsum.y,
      (unsigned)P.pred[4 * j + 2] + (unsigned)bsum.z,
      (unsigned)P.pred[4 * j + 3] + (unsigned)bsum.w};
  int16_t* b = blk[threadIdx.x];
  int4* b4 = reinterpret_cast<int4*>(b);
  while (d.p < stop && g < last) {
    const int q = g % P.bpm;
    if (d.u != q) {
      atomicOr(P.flag, kBadOrder);
      return;
    }
    const int c = d.c;
#pragma unroll
    for (int i = 0; i < 8; ++i) b4[i] = make_int4(0, 0, 0, 0);
    int err = next(t, d, P.bpm, diff, zz, val);
    while (!err && d.k != 0) {
      err = next(t, d, P.bpm, diff, zz, val);
      if (!err && zz >= 0) b[t.zigzag[zz]] = (int16_t)val;
    }
    if (err) {
      atomicOr(P.flag, err);
      return;
    }
    if (d.p > sb.seg_end) {
      atomicOr(P.flag, kPastEnd);
      return;
    }
    add4(dc, c, (unsigned)diff);
    unsigned dcv = 0;
#pragma unroll
    for (int k = 0; k < kMaxComps; ++k)
      if (k == c) dcv = dc[k];
    b[0] = (int16_t)(uint16_t)dcv;
    const int mcu = g / P.bpm;
    const int by = (mcu / P.mcus_x) * P.comp_v[c] + t.udy[q];
    const int bx = (mcu % P.mcus_x) * P.comp_h[c] + t.udx[q];
    int4* dst = reinterpret_cast<int4*>(
        P.out[c] + ((long long)by * P.comp_bw[c] + bx) * 64);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = b4[i];
    ++g;
  }
}

// The descriptor's fields (ops/huffman_decode_cuda.DESC): byte offsets
// into the staged buffer (S) or the workspace (W), and counts.
enum Desc : int {
  dScan, dScanLen, dSpans, dSpan, dEndByte, dDeviceLayout, dTotalBlocks,
  dSegStart, dSegEnd, dSegFirstBlock, dSegBlocks, dSegFirstSub, dNseg, dNsub,
  dNsubMax, dSubBits, dLut, dMaxcode, dDelta, dVals, dUcomp, dUdy, dUdx,
  dNcomp, dBpm, dMcusX, dChanged, dFlag, dCompH,
  dCompV = dCompH + kMaxComps, dCompBw = dCompV + kMaxComps,
  dBits = dCompBw + kMaxComps, dStart, dExits0, dExits1, dCount, dDcsum,
  dFirst, dPred, dCk, dFields
};

}  // namespace

extern "C" {

const char* fennec_k9_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fennec_k9_desc_fields() { return dFields; }

#ifdef K9_STAMPS
// The stamps of round 0 of the last chain: (kStamped, 4) int64 to host
// memory; returns its cudaError_t.
int fennec_k9_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k9_stamps, sizeof(k9_stamps));
}
#endif

// K9.  desc: dFields int64 (ops/huffman_decode_cuda.DESC); staged: the
// copied buffer on the device; work: the workspace; outs: ncomp device
// pointers to (bw * bh, 64) int16 blocks.  Launches the chain on `stream`
// and returns the first launch's cudaError_t.
int fennec_k9_decode(const long long* desc, void* staged, void* work,
                     void* const* outs, void* stream) {
  uint8_t* S = static_cast<uint8_t*>(staged);
  uint8_t* W = static_cast<uint8_t*>(work);
  auto si = [&](int f) { return reinterpret_cast<int*>(S + desc[f]); };
  auto wi = [&](int f) { return reinterpret_cast<int*>(W + desc[f]); };
  Params P;
  P.scan = S + desc[dScan];
  P.scan_len = (int)desc[dScanLen];
  P.spans = (int)desc[dSpans];
  P.span = wi(dSpan);
  P.end_byte = si(dEndByte);
  P.device_layout = (int)desc[dDeviceLayout];
  P.total_blocks = (int)desc[dTotalBlocks];
  P.seg_start = si(dSegStart);
  P.seg_end = si(dSegEnd);
  P.seg_first_block = si(dSegFirstBlock);
  P.seg_blocks = si(dSegBlocks);
  P.seg_first_sub = si(dSegFirstSub);
  P.nseg = (int)desc[dNseg];
  P.nsub = si(dNsub);
  P.nsub_max = (int)desc[dNsubMax];
  P.sub_bits = (int)desc[dSubBits];
  P.lut = reinterpret_cast<const uint16_t*>(S + desc[dLut]);
  P.maxcode = si(dMaxcode);
  P.delta = si(dDelta);
  P.vals = S + desc[dVals];
  P.ucomp = S + desc[dUcomp];
  P.udy = S + desc[dUdy];
  P.udx = S + desc[dUdx];
  P.ncomp = (int)desc[dNcomp];
  P.bpm = (int)desc[dBpm];
  P.mcus_x = (int)desc[dMcusX];
  P.changed = si(dChanged);
  P.flag = si(dFlag);
  P.bits = W + desc[dBits];
  P.start = reinterpret_cast<int2*>(W + desc[dStart]);
  P.exits[0] = reinterpret_cast<int2*>(W + desc[dExits0]);
  P.exits[1] = reinterpret_cast<int2*>(W + desc[dExits1]);
  P.count = wi(dCount);
  P.dcsum = wi(dDcsum);
  P.first = wi(dFirst);
  P.pred = wi(dPred);
  P.ck = reinterpret_cast<int4*>(W + desc[dCk]);
  if (P.ncomp < 1 || P.ncomp > kMaxComps || P.bpm < 1 || P.bpm > kMaxBpm ||
      P.nsub_max < 1 || P.nseg < 1 || P.sub_bits < 1 || P.scan_len < 1 ||
      P.spans != (P.scan_len + kSpan - 1) / kSpan ||
      (P.device_layout && P.nseg != 1))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < kMaxComps; ++c) {
    P.comp_h[c] = (int)desc[dCompH + c];
    P.comp_v[c] = (int)desc[dCompV + c];
    P.comp_bw[c] = (int)desc[dCompBw + c];
    P.out[c] = c < P.ncomp ? static_cast<int16_t*>(outs[c]) : nullptr;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int span_ctas = (P.spans + kUnstuffThreads - 1) / kUnstuffThreads;
  count_kernel<<<span_ctas, kUnstuffThreads, 0, s>>>(P);
  prefix_kernel<<<1, kScanThreads, 0, s>>>(P);
  unstuff_kernel<<<span_ctas, kUnstuffThreads, 0, s>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ctas = (P.nsub_max + kThreads - 1) / kThreads;
  P.rounds = ctas;
  for (int r = 0; r < ctas; ++r) {
    sync_kernel<<<ctas, kThreads, 0, s>>>(P, r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_kernel<<<(P.nsub_max * kChecks + kThreads - 1) / kThreads, kThreads,
                 0, s>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
