// Image kernels of on-device AutoAugment for Hopper (sm_90a): per-plane
// histogram, per-plane LUT apply, the integer shift of rows or of columns,
// and the cubic per-row shift.
//
// Replace the TPU kernels of imageretrievalresearch_tpu/ops/pallas_image.py:
// - image_histogram       <- _hist_kernel (pallas_histogram)
// - image_lut_apply       <- _lut_kernel (pallas_lut_apply)
// - image_row_shift_cubic <- _row_shift_cubic_kernel (pallas_row_shift_cubic)
// - image_row_shift, image_column_shift <- _row_shift_kernel
//   (pallas_row_shift; the column form is its transpose, as the rotate's Sy
//   pass runs it)
// Plain versions and wrappers: imageretrievalresearch_tpu_torch/ops/
// image_kernels.py.
//
// The TPU kernels are chains of rolls and selects (256 select passes per
// plane for the histogram and the LUT; radix-factored roll passes for the
// shifts) because a TPU has no gather. A GPU gathers from shared memory at
// full rate, so each kernel here is one direct pass over device memory:
// - histogram: a block counts a chunk of one plane into a shared-memory
//   histogram with integer atomicAdd, then adds it to the plane's row in
//   device memory (zeroed by the wrapper). Integer atomics give exact counts
//   in any order.
// - LUT apply: a block builds its plane's table in shared memory and maps a
//   chunk of the plane through it. Entries must lie in [0, 255] (both
//   callers clip them): planes are read and written as uint8.
// - cubic row shift: a block stages consecutive rows in shared memory and
//   writes each output pixel from four taps of the staged row, the fill
//   value outside [0, W).
// - integer shifts: blocks walk chunks of rows (or bands of columns)
//   through a double-buffered stage and write each output vector from the
//   staged chunk, the fill value outside the row (or column).
//
// Bound: each moves its input and its output once: at the AutoAugment
// path's shapes (192 planes of 224 x 224, or 43,008 rows of 224) 9.6 MB in
// and 9.6 MB out, ~5.8 us at 3.35 TB/s (H100 SXM; the histogram writes 256
// counts per plane, ~2.9 us), so all of them are bound by device memory.
// The cubic shift comes closest to its operation bound: ~37 f32 operations
// per pixel (four weight polynomials, the weighted sum, the division) are
// ~5.3 us at 67 TFLOP/s. The histogram and the cubic shift load and store
// single bytes; the LUT apply and the integer shifts move 16-byte vectors
// (notes above each kernel).
//
// The cubic shift is the TPU kernel's arithmetic op for op: the a = -1
// weights of autoaugment._cubic_kernel (both branches, then the select),
// the taps summed in the order -1, 0, 1, 2, the division by
// max(wsum, 1e-8), the validity mask on the source position, round half to
// even, clip. Products, sums and the division are __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, so nvcc contracts nothing into FMAs and the kernel
// is bitwise equal to its plain version.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
// pixels of one plane per histogram block
constexpr int CHUNK = 8192;
// bytes of consecutive rows a cubic-shift block stages in shared memory
constexpr int STAGE_BYTES = 8192;
// widest row a shift block can stage (the cubic shift's limit, the default
// dynamic shared-memory limit; the integer shift takes the same rows)
constexpr int MAX_W = 48 * 1024;

// LUT apply: 16-byte vectors each thread loads before the table is built,
// so at most LUT_VECS * THREADS * 16 = 16,384 pixels per block
constexpr int LUT_VECS = 4;
constexpr int LUT_CHUNK = LUT_VECS * THREADS * 16;
// 64 words of 4 packed entries, one copy per lane: 8 KB
constexpr int LUT_WORDS = 64 * 32;

// integer shifts: bytes of rows a row-shift chunk holds, at most one row
// per thread; columns per column-shift band; the tallest plane a
// column-shift block stages in bands of SHIFT_BAND columns (two bands of
// FULL_BAND_H x SHIFT_BAND bytes, 192 KB: taller planes, up to MAX_W rows,
// take bands of FULL_BAND_H * SHIFT_BAND / H columns in the same bytes);
// resident blocks per SM the grid is sized for
constexpr int SHIFT_CHUNK = 8192;
constexpr int SHIFT_BAND = 32;
constexpr int FULL_BAND_H = 3072;
constexpr int SHIFT_BLOCKS_PER_SM = 4;
// guard bytes before and after each staged row chunk: a 16-byte output
// window that reaches past its row reads (and masks) up to 16 bytes beyond
constexpr int GUARD = 16;

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const uint8_t* __restrict__ planes, int hw,
                 int* __restrict__ out) {
  __shared__ int hist[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const uint8_t* src = planes + (size_t)blockIdx.y * hw;
  const int lo = blockIdx.x * CHUNK;
  const int hi = min(lo + CHUNK, hw);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    atomicAdd(&hist[src[i]], 1);
  __syncthreads();
  int* row = out + (size_t)blockIdx.y * 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (hist[i]) atomicAdd(&row[i], hist[i]);
}

// Copies `count` bytes of consecutive rows, from offset `base`, into shared
// memory.
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ rows,
                                           size_t base, int count,
                                           uint8_t* staged) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    staged[i] = rows[base + i];
  __syncthreads();
}

// autoaugment._cubic_kernel with a = -1: (a + 2) * s is s and * a is a
// negation, both exact, so they are written as such.
__device__ __forceinline__ float cubic_weight(float t) {
  const float s = fabsf(t);
  const float w_near = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(s, 2.0f), s), s),
                               1.0f);
  const float w_far = -__fsub_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(s, 5.0f), s), 8.0f), s), 4.0f);
  return s < 1.0f ? w_near : (s < 2.0f ? w_far : 0.0f);
}

__global__ void __launch_bounds__(THREADS)
row_shift_cubic_kernel(const uint8_t* __restrict__ rows,
                       const float* __restrict__ src0, int n, int w, int rpb,
                       float fill, uint8_t* __restrict__ out) {
  extern __shared__ uint8_t staged[];
  const int n0 = blockIdx.x * rpb;
  const int nr = min(rpb, n - n0);
  const size_t base = (size_t)n0 * w;
  stage_rows(rows, base, nr * w, staged);
  for (int i = threadIdx.x; i < nr * w; i += blockDim.x) {
    const int r = i / w;
    const int x = i - r * w;
    const float src = src0[n0 + r];
    const float fl = floorf(src);
    const int shift = (int)fl;
    const float frac = __fsub_rn(src, fl);
    float acc = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int tap = -1; tap <= 2; ++tap) {
      const float c = cubic_weight(__fsub_rn(frac, (float)tap));
      const long long idx = (long long)x + shift + tap;
      const float pix = (idx >= 0 && idx < w)
                            ? (float)staged[r * w + (int)idx] : fill;
      acc = __fadd_rn(acc, __fmul_rn(c, pix));
      wsum = __fadd_rn(wsum, c);
    }
    float v = __fdiv_rn(acc, fmaxf(wsum, 1e-8f));
    const float srcx = __fadd_rn(__fadd_rn((float)x, fl), frac);
    if (!(srcx >= -0.5f && srcx <= (float)w - 0.5f)) v = fill;
    out[base + i] = (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  }
}

// ---------------------------------------------------------------------------
// LUT apply (replaces _lut_kernel). Bound: 2 x 9.6 MB + 1 KB of entries per
// plane, 0.0058 ms at 3.35 TB/s. The earlier kernel moved one byte per
// thread access, staged each plane's table for 8,192 pixels and read a
// 256-byte table whose 64 words 32 lanes hit in the same banks. Here:
// - each thread issues its (up to 4) 16-byte loads first, so they are in
//   flight while the block builds its table, and stores 16-byte vectors;
// - the table is 32 copies of the 64 words of 4 packed entries, entry e of
//   lane l's copy in word (e >> 2) * 32 + l, so a lane reads only bank l:
//   no conflicts whatever the pixels (8 KB of shared memory);
// - a block takes up to 16,384 pixels of one plane (224 x 224: 4 blocks of
//   12,544), ~6 blocks on each SM at once.
// The bytes before the first 16-byte aligned pixel of a block's range and
// after its last whole vector, and every byte where the planes and the
// output differ in their alignment, take the scalar path of the same block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lut_word(const uint32_t* table,
                                             uint32_t pixels, int lane) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t e = (pixels >> (8 * k)) & 0xff;
    // byte e & 3 of the table word into byte k, the other bytes kept
    const uint32_t keep = 0x7654u & ~(0xfu << (4 * k));
    out = __byte_perm(table[(e >> 2) * 32 + lane], out,
                      keep | ((e & 3) << (4 * k)));
  }
  return out;
}

__device__ __forceinline__ uint8_t lut_byte(const uint32_t* table,
                                            uint32_t e, int lane) {
  return (uint8_t)(table[(e >> 2) * 32 + lane] >> (8 * (e & 3)));
}

__global__ void __launch_bounds__(THREADS)
lut_kernel(const uint8_t* __restrict__ planes, const int* __restrict__ lut,
           int hw, int chunk, int vec, uint8_t* __restrict__ out) {
  __shared__ uint32_t table[LUT_WORDS];
  const size_t base = (size_t)blockIdx.y * hw;
  const int lo = blockIdx.x * chunk;
  const int n = min(chunk, hw - lo);
  const uint8_t* src = planes + base + lo;
  uint8_t* dst = out + base + lo;
  // [0, head) and [head + 16 * nvec, n) bytewise, 16-byte vectors between
  int head = n, nvec = 0;
  if (vec) {
    head = min(n, (int)((16 - ((uintptr_t)src & 15)) & 15));
    nvec = (n - head) >> 4;
  }
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4 v[LUT_VECS];
#pragma unroll
  for (int i = 0; i < LUT_VECS; ++i) {
    const int j = threadIdx.x + i * THREADS;
    if (j < nvec) v[i] = __ldg(vsrc + j);
  }
  const int* entries = lut + (size_t)blockIdx.y * 256;
  for (int i = threadIdx.x; i < LUT_WORDS; i += THREADS) {
    const int e = (i >> 5) * 4;
    table[i] = ((uint32_t)entries[e] & 0xff)
               | ((uint32_t)entries[e + 1] & 0xff) << 8
               | ((uint32_t)entries[e + 2] & 0xff) << 16
               | ((uint32_t)entries[e + 3] & 0xff) << 24;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint4* vdst = reinterpret_cast<uint4*>(dst + head);
#pragma unroll
  for (int i = 0; i < LUT_VECS; ++i) {
    const int j = threadIdx.x + i * THREADS;
    if (j < nvec) {
      uint4 r;
      r.x = lut_word(table, v[i].x, lane);
      r.y = lut_word(table, v[i].y, lane);
      r.z = lut_word(table, v[i].z, lane);
      r.w = lut_word(table, v[i].w, lane);
      vdst[j] = r;
    }
  }
  const int tail = head + 16 * nvec;
  for (int i = threadIdx.x; i < head + (n - tail); i += THREADS) {
    const int k = i < head ? i : tail + (i - head);
    dst[k] = lut_byte(table, src[k], lane);
  }
}

// ---------------------------------------------------------------------------
// Integer shifts (replace _row_shift_kernel). Rows: out(n, x) = rows(n, x +
// s(n)); columns of (P, H, W) planes: out(p, y, x) = planes(p, y + s(p, x),
// x); `fill` outside the row or column. Bound: 2 x 9.6 MB + 4 bytes per
// shift, 0.0058 ms at 3.35 TB/s. The earlier kernel staged rows byte by
// byte, waited, then wrote one byte per access with an integer division
// and a load of the row's shift for each, in 1,195 short blocks that never
// overlapped loads with stores; the column pass ran on transposed copies.
// Here a grid of SHIFT_BLOCKS_PER_SM blocks per SM walks chunks with a
// double-buffered stage: the next chunk's 16-byte cp.async copies (and its
// shifts, 4-byte copies) are in flight while the block writes the current
// one, so each chunk's loads overlap the previous chunk's stores.
// - Rows: a chunk is up to 8,192 bytes of whole rows (36 rows of 224). Each
//   thread writes 16-byte vectors: the source window at x + s is read as
//   two aligned 16-byte words of the staged row, its 4 output words cut
//   out by selects and funnel shifts, and bytes outside [0, W) masked to
//   the fill. One division per chunk per thread sets its (row, vector); the
//   row's shift is one shared-memory read per vector.
// - Columns: a chunk is a band of 32 columns of one plane, all H rows (no
//   halo: a shift reaches any row). Lane l of each group of 8 writes 4
//   bytes (columns 4(l mod 8) ..+3) of one row from the 4 rows its columns'
//   shifts name; its 4 shifts stay in registers for the whole band, and the
//   4 rows a warp reads at once lie in 4 different banks.
// Where W is not a multiple of 16 or the rows, the planes or the output are
// not 16-byte aligned (a slice can start at any byte), the same kernel
// runs its scalar path (VEC = false): the chunk staged by cp.async where it
// is aligned and by single bytes at its edges, one byte per output access.
// Planes taller than FULL_BAND_H take the scalar path too, in bands
// narrower than 32 columns so that two still fit in shared memory.
// Shifts are clamped to [-W, W] (rows) or [-H, H] (columns): past that every
// byte is the fill either way.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      (uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      (uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

// Copies `count` bytes from `src` so that src[k] lands at dst[(src & 15) +
// k] (`dst` 16-byte aligned): the aligned body by 16-byte cp.async, the
// bytes before and after it by single loads and stores.
__device__ __forceinline__ void stage_span(uint8_t* dst,
                                           const uint8_t* __restrict__ src,
                                           int count) {
  const int lead = (int)((uintptr_t)src & 15);
  const int head = min(count, (16 - lead) & 15);
  const int nvec = (count - head) >> 4;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
    cp_async16(dst + lead + head + 16 * i, src + head + 16 * i);
  const int tail = head + 16 * nvec;
  for (int i = threadIdx.x; i < head + (count - tail); i += blockDim.x) {
    const int k = i < head ? i : tail + (i - head);
    dst[lead + k] = src[k];
  }
}

// Bytes [lo, hi) of a 32-bit word as a mask (lo, hi clamped to [0, 4]).
__device__ __forceinline__ uint32_t byte_mask(int lo, int hi) {
  lo = min(max(lo, 0), 4);
  hi = min(max(hi, 0), 4);
  const uint32_t below_hi = (uint32_t)((1ull << (8 * hi)) - 1);
  const uint32_t below_lo = (uint32_t)((1ull << (8 * lo)) - 1);
  return below_hi & ~below_lo;
}

// Output bytes [x, x + 16) of a staged row (`row` 16-byte aligned, with at
// least GUARD readable bytes before it and after row + w, w % 16 == 0):
// byte j is row[x + s + j] where 0 <= x + s + j < w, else the fill.
__device__ __forceinline__ uint4 shifted_vector(const uint8_t* row, int x,
                                                int s, int w,
                                                uint32_t fill4) {
  const int o = x + s;
  const int jlo = max(-o, 0), jhi = min(w - o, 16);
  if (jhi <= jlo) return make_uint4(fill4, fill4, fill4, fill4);
  // o >= -15 and o < w here: the two aligned words lie within the guards
  const int a = o & ~15, d = o - a;
  const uint4 q0 = *reinterpret_cast<const uint4*>(row + a);
  const uint4 q1 = *reinterpret_cast<const uint4*>(row + a + 16);
  // words d / 4 .. d / 4 + 4 of the 8, by two rounds of selects
  const bool two = d & 8, one = d & 4;
  const uint32_t a0 = two ? q0.z : q0.x, a1 = two ? q0.w : q0.y,
                 a2 = two ? q1.x : q0.z, a3 = two ? q1.y : q0.w,
                 a4 = two ? q1.z : q1.x, a5 = two ? q1.w : q1.y;
  const uint32_t b0 = one ? a1 : a0, b1 = one ? a2 : a1, b2 = one ? a3 : a2,
                 b3 = one ? a4 : a3, b4 = one ? a5 : a4;
  const int sh = 8 * (d & 3);
  uint4 r = make_uint4(
      __funnelshift_r(b0, b1, sh), __funnelshift_r(b1, b2, sh),
      __funnelshift_r(b2, b3, sh), __funnelshift_r(b3, b4, sh));
  if (jlo > 0 || jhi < 16) {
    uint32_t m = byte_mask(jlo, jhi);
    r.x = (r.x & m) | (fill4 & ~m);
    m = byte_mask(jlo - 4, jhi - 4);
    r.y = (r.y & m) | (fill4 & ~m);
    m = byte_mask(jlo - 8, jhi - 8);
    r.z = (r.z & m) | (fill4 & ~m);
    m = byte_mask(jlo - 12, jhi - 12);
    r.w = (r.w & m) | (fill4 & ~m);
  }
  return r;
}

// Bytes of one staged row chunk: the guards and up to 15 bytes of lead.
__host__ __device__ __forceinline__ int row_stage_bytes(int rpc, int w) {
  return GUARD + ((rpc * w + 15 + 15) & ~15) + GUARD;
}

__device__ __forceinline__ void stage_row_chunk(
    const uint8_t* __restrict__ rows, const int* __restrict__ shifts, int n,
    int w, int rpc, int c, uint8_t* stage, int* sshift) {
  const int n0 = c * rpc;
  const int nr = min(rpc, n - n0);
  stage_span(stage, rows + (size_t)n0 * w, nr * w);
  if (threadIdx.x < nr)
    cp_async4(sshift + threadIdx.x, shifts + n0 + threadIdx.x);
}

template <bool VEC>
__device__ __forceinline__ void emit_row_chunk(
    const uint8_t* __restrict__ rows, int n, int w, int rpc, int c,
    const uint8_t* stage, const int* sshift, int fill,
    uint8_t* __restrict__ out) {
  const int n0 = c * rpc;
  const int nr = min(rpc, n - n0);
  if (VEC) {
    // rows 16-byte aligned: vector v of row r is bytes [16 v, 16 v + 16)
    const int vpr = w >> 4;
    const uint32_t fill4 = 0x01010101u * (uint32_t)(fill & 0xff);
    int r = threadIdx.x / vpr, v = threadIdx.x - r * vpr;
    const int dr = THREADS / vpr, dv = THREADS - dr * vpr;
    for (int j = threadIdx.x; j < nr * vpr; j += THREADS) {
      const int s = min(max(sshift[r], -w), w);
      *reinterpret_cast<uint4*>(out + (size_t)(n0 + r) * w + 16 * v) =
          shifted_vector(stage + r * w, 16 * v, s, w, fill4);
      r += dr;
      v += dv;
      if (v >= vpr) { v -= vpr; ++r; }
    }
  } else {
    const int lead = (int)((uintptr_t)(rows + (size_t)n0 * w) & 15);
    uint8_t* dst = out + (size_t)n0 * w;
    int r = threadIdx.x / w, x = threadIdx.x - r * w;
    const int dr = THREADS / w, dx = THREADS - dr * w;
    for (int k = threadIdx.x; k < nr * w; k += THREADS) {
      const int s = min(max(sshift[r], -w), w);
      const int src = x + s;
      dst[k] = (src >= 0 && src < w) ? stage[lead + k + s] : (uint8_t)fill;
      r += dr;
      x += dx;
      if (x >= w) { x -= w; ++r; }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
row_shift_kernel(const uint8_t* __restrict__ rows,
                 const int* __restrict__ shifts, int n, int w, int rpc,
                 int fill, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int sb = row_stage_bytes(rpc, w);
  int* sshift = reinterpret_cast<int*>(smem + 2 * sb);
  const int nchunks = (n + rpc - 1) / rpc;
  int c = blockIdx.x;
  if (c < nchunks)
    stage_row_chunk(rows, shifts, n, w, rpc, c, smem + GUARD, sshift);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = 0; c < nchunks; c += gridDim.x, ++i) {
    const int b = i & 1, next = c + gridDim.x;
    if (next < nchunks)
      stage_row_chunk(rows, shifts, n, w, rpc, next,
                      smem + (b ^ 1) * sb + GUARD, sshift + (b ^ 1) * rpc);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    emit_row_chunk<VEC>(rows, n, w, rpc, c, smem + b * sb + GUARD,
                        sshift + b * rpc, fill, out);
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes of one staged band, rounded to 16 so that the second band and the
// shifts after both stay aligned.
__host__ __device__ __forceinline__ int band_stage_bytes(int h, int band) {
  return (h * band + 15) & ~15;
}

// `band`: the columns of a band and the stride of its staged rows
// (SHIFT_BAND on the vector path)
template <bool VEC>
__device__ __forceinline__ void stage_band(
    const uint8_t* __restrict__ planes, const int* __restrict__ shifts,
    int h, int w, int band, int nbands, int item, uint8_t* stage,
    int* sshift) {
  const int p = item / nbands, x0 = (item - p * nbands) * band;
  const int bw = min(band, w - x0);
  const uint8_t* src = planes + (size_t)p * h * w + x0;
  if (VEC) {   // bw is 16 or 32: one or two 16-byte copies per row
    const int lg = bw >> 5;
    for (int i = threadIdx.x; i < (h << lg); i += THREADS) {
      const int y = i >> lg, half = (i & lg) * 16;
      cp_async16(stage + y * band + half, src + (size_t)y * w + half);
    }
  } else {
    for (int i = threadIdx.x; i < h * band; i += THREADS) {
      const int y = i / band, x = i % band;
      if (x < bw) stage[i] = src[(size_t)y * w + x];
    }
  }
  if (threadIdx.x < bw)
    cp_async4(sshift + threadIdx.x, shifts + (size_t)p * w + x0 + threadIdx.x);
}

template <bool VEC>
__device__ __forceinline__ void emit_band(
    int h, int w, int band, int nbands, int item, const uint8_t* stage,
    const int* sshift, int fill, uint8_t* __restrict__ out) {
  const int p = item / nbands, x0 = (item - p * nbands) * band;
  const int bw = min(band, w - x0);
  uint8_t* dst = out + (size_t)p * h * w + x0;
  if (VEC) {   // 8 lanes x 4 columns per row, 32 rows at a time
    const int col = 4 * (threadIdx.x & 7);
    if (col >= bw) return;
    int s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = min(max(sshift[col + k], -h), h);
    for (int y = threadIdx.x >> 3; y < h; y += THREADS / 8) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int src = y + s[k];
        const uint32_t b = (src >= 0 && src < h)
                               ? stage[src * band + col + k]
                               : (uint32_t)(fill & 0xff);
        word |= b << (8 * k);
      }
      *reinterpret_cast<uint32_t*>(dst + (size_t)y * w + col) = word;
    }
  } else {   // one lane per column (band <= 32), one row per warp at a time
    const int col = threadIdx.x & 31;
    if (col >= bw) return;
    const int s = min(max(sshift[col], -h), h);
    for (int y = threadIdx.x >> 5; y < h; y += THREADS / 32) {
      const int src = y + s;
      dst[(size_t)y * w + col] = (src >= 0 && src < h)
                                     ? stage[src * band + col]
                                     : (uint8_t)fill;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
column_shift_kernel(const uint8_t* __restrict__ planes,
                    const int* __restrict__ shifts, int p, int h, int w,
                    int band_cols, int fill, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int band = VEC ? SHIFT_BAND : band_cols;
  const int sb = band_stage_bytes(h, band);
  int* sshift = reinterpret_cast<int*>(smem + 2 * sb);
  const int nbands = (w + band - 1) / band;
  const int items = p * nbands;
  int item = blockIdx.x;
  if (item < items)
    stage_band<VEC>(planes, shifts, h, w, band, nbands, item, smem, sshift);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = 0; item < items; item += gridDim.x, ++i) {
    const int b = i & 1, next = item + gridDim.x;
    if (next < items)
      stage_band<VEC>(planes, shifts, h, w, band, nbands, next,
                      smem + (b ^ 1) * sb, sshift + (b ^ 1) * band);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    emit_band<VEC>(h, w, band, nbands, item, smem + b * sb,
                   sshift + b * band, fill, out);
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

bool planes_ok(int p, int hw) {
  return p >= 1 && p <= 65535 && hw >= 1;
}

dim3 plane_grid(int p, int hw) {
  return dim3((hw + CHUNK - 1) / CHUNK, p);
}

// rows per row-shift block; the block stages rows_per_block(w) * w bytes
int rows_per_block(int w) { return w >= STAGE_BYTES ? 1 : STAGE_BYTES / w; }

// rows per row-shift chunk
int rows_per_chunk(int w) {
  return std::max(1, std::min(THREADS, SHIFT_CHUNK / w));
}

// a shift kernel's grid: SHIFT_BLOCKS_PER_SM blocks on each SM, or one per
// chunk where there are fewer
int shift_grid(long long chunks) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)std::min<long long>(chunks, (long long)sms * SHIFT_BLOCKS_PER_SM);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Launches a shift kernel with `smem` bytes of dynamic shared memory,
// raising the kernel's limit where it needs more than the default 48 KB.
template <class Kernel, class... Args>
int launch_shift(Kernel kernel, int grid, size_t smem, void* stream,
                 Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 = ok); cudaErrorInvalidValue for shapes it does not take.

// planes (P, HW) uint8 -> out (P, 256) int32, which must be zeroed.
int image_histogram(const uint8_t* planes, int p, int hw, int* out,
                    void* stream) {
  if (!planes_ok(p, hw)) return (int)cudaErrorInvalidValue;
  histogram_kernel<<<plane_grid(p, hw), THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(planes, hw,
                                                               out);
  return (int)cudaGetLastError();
}

// planes (P, HW) uint8, lut (P, 256) int32 in [0, 255] -> out (P, HW) uint8.
int image_lut_apply(const uint8_t* planes, const int* lut, int p, int hw,
                    uint8_t* out, void* stream) {
  if (!planes_ok(p, hw) || hw > INT_MAX - LUT_CHUNK)
    return (int)cudaErrorInvalidValue;
  // the fewest blocks of at most LUT_CHUNK pixels, split evenly in vectors
  const int blocks = (hw + LUT_CHUNK - 1) / LUT_CHUNK;
  const int chunk = ((hw + blocks - 1) / blocks + 15) & ~15;
  const int vec = (((uintptr_t)planes ^ (uintptr_t)out) & 15) == 0;
  lut_kernel<<<dim3((hw + chunk - 1) / chunk, p), THREADS, 0,
               reinterpret_cast<cudaStream_t>(stream)>>>(planes, lut, hw,
                                                         chunk, vec, out);
  return (int)cudaGetLastError();
}

// rows (N, W) uint8, shifts (N,) int32 -> out (N, W) uint8,
// out(n, x) = rows(n, x + shifts(n)), `fill` outside [0, W).
int image_row_shift(const uint8_t* rows, const int* shifts, int n, int w,
                    int fill, uint8_t* out, void* stream) {
  if (n < 1 || w < 1 || w > MAX_W) return (int)cudaErrorInvalidValue;
  const int rpc = rows_per_chunk(w);
  const size_t smem = 2 * (size_t)row_stage_bytes(rpc, w)
                      + 2 * sizeof(int) * rpc;
  const int grid = shift_grid((n + (long long)rpc - 1) / rpc);
  const bool vec = w % 16 == 0 && aligned16(rows) && aligned16(out);
  return launch_shift(vec ? &row_shift_kernel<true> : &row_shift_kernel<false>,
                      grid, smem, stream, rows, shifts, n, w, rpc, fill, out);
}

// planes (P, H, W) uint8, shifts (P, W) int32 -> out (P, H, W) uint8,
// out(p, y, x) = planes(p, y + shifts(p, x), x), `fill` outside [0, H);
// H up to MAX_W.
int image_column_shift(const uint8_t* planes, const int* shifts, int p, int h,
                       int w, int fill, uint8_t* out, void* stream) {
  if (p < 1 || h < 1 || w < 1 || h > MAX_W) return (int)cudaErrorInvalidValue;
  const int band =
      h <= FULL_BAND_H ? SHIFT_BAND : FULL_BAND_H * SHIFT_BAND / h;
  const long long items = (long long)p * ((w + band - 1) / band);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)band_stage_bytes(h, band)
                      + 2 * sizeof(int) * band;
  const bool vec = band == SHIFT_BAND && w % 16 == 0 && aligned16(planes)
                   && aligned16(out);
  return launch_shift(
      vec ? &column_shift_kernel<true> : &column_shift_kernel<false>,
      shift_grid(items), smem, stream, planes, shifts, p, h, w, band, fill,
      out);
}

// rows (N, W) uint8, src0 (N,) f32 -> out (N, W) uint8: row n resampled at
// x + src0(n) with the 4-tap a = -1 cubic, `fill` outside.
int image_row_shift_cubic(const uint8_t* rows, const float* src0, int n,
                          int w, int fill, uint8_t* out, void* stream) {
  if (n < 1 || w < 1 || w > MAX_W) return (int)cudaErrorInvalidValue;
  const int rpb = rows_per_block(w);
  row_shift_cubic_kernel<<<(n + rpb - 1) / rpb, THREADS, (size_t)rpb * w,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      rows, src0, n, w, rpb, (float)fill, out);
  return (int)cudaGetLastError();
}

const char* image_ops_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
