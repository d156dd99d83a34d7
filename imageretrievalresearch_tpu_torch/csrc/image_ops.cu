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
// full rate, so each kernel here is one direct pass over device memory,
// with 16-byte loads and stores:
// - histogram: a cluster of up to HIST_RANKS (2) blocks per plane counts
//   it into lane-private tables in shared memory, and rank 0 sums the
//   ranks' counts through distributed shared memory and writes the
//   plane's 256 counts with plain stores (the output needs no zeroing).
//   Integer counts are exact in any order.
// - LUT apply: a block builds its plane's table in shared memory and maps a
//   chunk of the plane through it. Entries must lie in [0, 255] (both
//   callers clip them): planes are read and written as uint8.
// - integer shifts and the cubic row shift: blocks walk chunks of rows (or
//   bands of columns) through a double-buffered stage and write each output
//   vector from the staged chunk, the fill value outside the row (or
//   column); the cubic shift computes each row's weights once.
//
// Bound: each moves its input and its output once: at the AutoAugment
// path's shapes (192 planes of 224 x 224, or 43,008 rows of 224) 9.6 MB in
// and 9.6 MB out, ~5.8 us at 3.35 TB/s (H100 SXM; the histogram writes 256
// counts per plane, ~2.9 us), so all of them are bound by device memory.
// The cubic shift comes closest to its operation bound: 13 f32 operations
// per pixel (notes above its kernel), ~1.9 us at 67 TFLOP/s; but the
// bitwise contract below keeps it from fusing any of them, so its issue
// rate, not its operations, is what it has to watch.
//
// The cubic shift is the TPU kernel's arithmetic, bit for bit: the a = -1
// weights of autoaugment._cubic_kernel (both branches, then the select),
// the taps summed in the order -1, 0, 1, 2 from 0, the division by
// max(wsum, 1e-8), the validity mask on the source position, round half to
// even, clip. Products, sums and the division are __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, so nvcc contracts nothing into FMAs; the mask and
// the rounding are computed another way that gives the same bits (notes
// above the kernel), and the kernel is bitwise equal to its plain
// version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
// widest row a shift block stages (the earlier cubic shift's limit, one
// row in the default 48 KB of dynamic shared memory; both shifts keep it)
constexpr int MAX_W = 48 * 1024;

// histogram: 16-byte vectors each thread loads before the tables are
// cleared, so HIST_CHUNK pixels per block and pass; at most HIST_RANKS
// blocks (one cluster) per plane; 32 lane copies of the 256 counts, 32 KB
constexpr int HIST_VECS = 8;
constexpr int HIST_CHUNK = HIST_VECS * THREADS * 16;
constexpr int HIST_RANKS = 2;
constexpr int HIST_WORDS = 256 * 32;

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
// (the cubic shift's windows, whose taps reach 3 bytes further, up to 32)
constexpr int GUARD = 16;
constexpr int CUBIC_GUARD = 2 * GUARD;

// ---------------------------------------------------------------------------
// Histogram (replaces _hist_kernel). Bound: 9.6 MB in, 1 KB of counts per
// plane out, 0.0029 ms at 3.35 TB/s. The earlier kernel loaded one byte per
// thread access (few HBM bytes in flight: 2.0x slower from HBM than from
// L2), all 256 threads of a block hit one shared table with atomics, and
// each block added its table to an output that the wrapper had to zero (a
// second launch). Here:
// - a cluster of up to HIST_RANKS blocks counts a plane (224 x 224: 2
//   blocks of 1,568 vectors; 192 planes make 384 blocks, all resident at
//   once on 132 SMs); each thread issues its (up to HIST_VECS) 16-byte
//   loads first, so they are in flight while the block clears its table;
//   a larger plane takes further passes of HIST_CHUNK pixels per block;
// - each lane counts into its own copy of the 256 counts, count e of lane
//   l in word e * 32 + l, so a lane's atomics touch only bank l and never
//   the address of another lane's: no conflicts and no serialised atomics
//   within a warp, even on a plane of one value (32 KB of shared memory);
// - each thread sums one bin over the 32 copies (read in a rotated order,
//   so that a warp's 32 reads hit 32 banks) and adds it to rank 0's counts
//   through distributed shared memory; after the cluster's barrier rank 0
//   stores the plane's 256 counts.
// The bytes before the plane's first 16-byte aligned pixel and after its
// last whole vector (a plane can start at any byte) are counted one by one
// by rank 0.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void count_byte(uint32_t* table, uint32_t e,
                                           int lane) {
  atomicAdd(&table[e * 32 + lane], 1u);
}

__device__ __forceinline__ void count_vector(uint32_t* table, uint4 v,
                                             int lane) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      count_byte(table, (words[i] >> (8 * k)) & 0xff, lane);
}

// Vectors base + threadIdx.x + i * THREADS (i < HIST_VECS) below `end`.
__device__ __forceinline__ void load_vectors(const uint4* __restrict__ src,
                                             int base, int end,
                                             uint4 (&v)[HIST_VECS]) {
#pragma unroll
  for (int i = 0; i < HIST_VECS; ++i) {
    const int j = base + threadIdx.x + i * THREADS;
    if (j < end) v[i] = __ldg(src + j);
  }
}

__device__ __forceinline__ void count_vectors(uint32_t* table, int base,
                                              int end,
                                              const uint4 (&v)[HIST_VECS],
                                              int lane) {
#pragma unroll
  for (int i = 0; i < HIST_VECS; ++i)
    if (base + (int)threadIdx.x + i * THREADS < end)
      count_vector(table, v[i], lane);
}

// Launched as clusters of gridDim.x blocks, one cluster per plane
// (blockIdx.y).
__global__ void __launch_bounds__(THREADS)
histogram_kernel(const uint8_t* __restrict__ planes, int hw,
                 int* __restrict__ out) {
  static_assert(THREADS == 256, "one thread per bin");
  __shared__ __align__(16) uint32_t table[HIST_WORDS];
  __shared__ uint32_t hist[256];
  const int rank = blockIdx.x, ranks = gridDim.x;
  const uint8_t* src = planes + (size_t)blockIdx.y * hw;
  // [0, head) and [head + 16 * nvec, hw) bytewise, 16-byte vectors between,
  // split evenly over the ranks
  const int head = min(hw, (int)((16 - ((uintptr_t)src & 15)) & 15));
  const int nvec = (hw - head) >> 4;
  const int vlo = (int)((long long)nvec * rank / ranks);
  const int vhi = (int)((long long)nvec * (rank + 1) / ranks);
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4 v[HIST_VECS];
  load_vectors(vsrc, vlo, vhi, v);
  for (int i = threadIdx.x; i < HIST_WORDS / 4; i += THREADS)
    reinterpret_cast<uint4*>(table)[i] = make_uint4(0, 0, 0, 0);
  hist[threadIdx.x] = 0;
  __syncthreads();
  // rank 0's zeroed counts are released here; the other ranks add to them
  // only after the matching wait below
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  count_vectors(table, vlo, vhi, v, lane);
  for (int base = vlo + HIST_CHUNK / 16; base < vhi;
       base += HIST_CHUNK / 16) {
    load_vectors(vsrc, base, vhi, v);
    count_vectors(table, base, vhi, v, lane);
  }
  if (rank == 0) {
    const int tail = head + 16 * nvec;
    for (int i = threadIdx.x; i < head + (hw - tail); i += THREADS) {
      const int k = i < head ? i : tail + (i - head);
      count_byte(table, src[k], lane);
    }
  }
  __syncthreads();
  const int bin = threadIdx.x;
  uint32_t sum = 0;
#pragma unroll 8
  for (int l = 0; l < 32; ++l) sum += table[bin * 32 + ((l + bin) & 31)];
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  if (sum) atomicAdd(cluster.map_shared_rank(hist, 0) + bin, sum);
  cluster.sync();
  if (rank == 0) out[(size_t)blockIdx.y * 256 + bin] = (int)hist[bin];
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

// The walk every shift kernel takes: the block's chunks c = blockIdx.x,
// blockIdx.x + gridDim.x, ... through two stage buffers. stage(c, b)
// issues chunk c's copies into buffer b (cp.async; committed here);
// ready(c, b) runs once they are issued (the cubic shift's row terms, from
// what its stage loaded into registers); emit(c, b) writes chunk c from
// buffer b once its copies have landed, while the next chunk's are in
// flight.
template <class Stage, class Ready, class Emit>
__device__ __forceinline__ void walk_chunks(int nchunks, Stage stage,
                                            Ready ready, Emit emit) {
  int c = blockIdx.x;
  if (c < nchunks) stage(c, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  if (c < nchunks) ready(c, 0);
  for (int i = 0; c < nchunks; c += gridDim.x, ++i) {
    const int b = i & 1, next = c + gridDim.x;
    if (next < nchunks) stage(next, b ^ 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    emit(c, b);
    if (next < nchunks) ready(next, b ^ 1);
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes of one staged row chunk: `guard` bytes on each side and up to 15
// bytes of lead.
__host__ __device__ __forceinline__ int row_stage_bytes(int rpc, int w,
                                                        int guard) {
  return guard + ((rpc * w + 15 + 15) & ~15) + guard;
}

// Stages the rows of row chunk c (rpc rows of w bytes) at `stage`
// (cp.async, not committed); returns how many rows it holds.
__device__ __forceinline__ int stage_rows(const uint8_t* __restrict__ rows,
                                          int n, int w, int rpc, int c,
                                          uint8_t* stage) {
  const int n0 = c * rpc;
  const int nr = min(rpc, n - n0);
  stage_span(stage, rows + (size_t)n0 * w, nr * w);
  return nr;
}

// Calls f(r, v) for every 16-byte window v of nr rows of w bytes (w % 16 ==
// 0) that this thread writes: one division per chunk sets the first
// (row, window), additions step it.
template <class F>
__device__ __forceinline__ void for_each_window(int nr, int w, F f) {
  const int vpr = w >> 4;
  int r = threadIdx.x / vpr, v = threadIdx.x - r * vpr;
  const int dr = THREADS / vpr, dv = THREADS - dr * vpr;
  for (int j = threadIdx.x; j < nr * vpr; j += THREADS) {
    f(r, v);
    r += dr;
    v += dv;
    if (v >= vpr) { v -= vpr; ++r; }
  }
}

// Calls f(k, r, x) for every byte k = r * w + x of nr rows of w bytes that
// this thread writes, stepped as for_each_window steps its windows.
template <class F>
__device__ __forceinline__ void for_each_byte(int nr, int w, F f) {
  int r = threadIdx.x / w, x = threadIdx.x - r * w;
  const int dr = THREADS / w, dx = THREADS - dr * w;
  for (int k = threadIdx.x; k < nr * w; k += THREADS) {
    f(k, r, x);
    r += dr;
    x += dx;
    if (x >= w) { x -= w; ++r; }
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

template <bool VEC>
__device__ __forceinline__ void emit_row_chunk(
    const uint8_t* __restrict__ rows, int n, int w, int rpc, int c,
    const uint8_t* stage, const int* sshift, int fill,
    uint8_t* __restrict__ out) {
  const int n0 = c * rpc;
  const int nr = min(rpc, n - n0);
  if (VEC) {
    // rows 16-byte aligned: vector v of row r is bytes [16 v, 16 v + 16)
    const uint32_t fill4 = 0x01010101u * (uint32_t)(fill & 0xff);
    for_each_window(nr, w, [&](int r, int v) {
      const int s = min(max(sshift[r], -w), w);
      *reinterpret_cast<uint4*>(out + (size_t)(n0 + r) * w + 16 * v) =
          shifted_vector(stage + r * w, 16 * v, s, w, fill4);
    });
  } else {
    const int lead = (int)((uintptr_t)(rows + (size_t)n0 * w) & 15);
    uint8_t* dst = out + (size_t)n0 * w;
    for_each_byte(nr, w, [&](int k, int r, int x) {
      const int s = min(max(sshift[r], -w), w);
      const int src = x + s;
      dst[k] = (src >= 0 && src < w) ? stage[lead + k + s] : (uint8_t)fill;
    });
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
row_shift_kernel(const uint8_t* __restrict__ rows,
                 const int* __restrict__ shifts, int n, int w, int rpc,
                 int fill, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int sb = row_stage_bytes(rpc, w, GUARD);
  int* sshift = reinterpret_cast<int*>(smem + 2 * sb);
  walk_chunks(
      (n + rpc - 1) / rpc,
      [&](int c, int b) {
        const int nr = stage_rows(rows, n, w, rpc, c, smem + b * sb + GUARD);
        if (threadIdx.x < nr)
          cp_async4(sshift + b * rpc + threadIdx.x,
                    shifts + c * rpc + threadIdx.x);
      },
      [](int, int) {},
      [&](int c, int b) {
        emit_row_chunk<VEC>(rows, n, w, rpc, c, smem + b * sb + GUARD,
                            sshift + b * rpc, fill, out);
      });
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
  walk_chunks(
      p * nbands,
      [&](int item, int b) {
        stage_band<VEC>(planes, shifts, h, w, band, nbands, item,
                        smem + b * sb, sshift + b * band);
      },
      [](int, int) {},
      [&](int item, int b) {
        emit_band<VEC>(h, w, band, nbands, item, smem + b * sb,
                       sshift + b * band, fill, out);
      });
}

// ---------------------------------------------------------------------------
// Cubic row shift (replaces _row_shift_cubic_kernel). out(n, x) resamples
// row n at x + src0(n) with the 4-tap a = -1 cubic. Bound: 2 x 9.6 MB + 4
// bytes per row, 0.0058 ms at 3.35 TB/s; 13 f32 operations per pixel (4
// products and 4 sums, the division, the clip's 2 and the rounding's add,
// ~1 for the bytes' conversion; the weights are per row), 0.0019 ms at 67
// TFLOP/s. The earlier kernel staged rows byte by byte and waited, then
// paid per pixel an integer division, a reload of the row's offset, four
// weight polynomials that depend on the row alone, four byte reads each
// converted on its own, and a byte store, in 1,195 short blocks. Here the
// row shift's chunk walk carries it (walk_chunks and stage_rows: grids of
// SHIFT_BLOCKS_PER_SM blocks per SM, chunks of up to SHIFT_CHUNK bytes of
// rows in a double-buffered cp.async stage; for_each_window and
// for_each_byte), and:
// - one thread per row computes the row's shift, four weights, their
//   clamped sum and the pixels whose source lies in the row once
//   (CubicRow, in shared memory; the next chunk's while the block writes
//   the current one);
// - each thread writes a 16-byte window: the 19 staged bytes its taps
//   reach, read by aligned 16-byte loads cut by selects and funnel shifts
//   (as the row shift's windows), each converted to f32 once, 16 pixels
//   rounded and clipped without the conversion unit and stored as one
//   uint4;
// - a window whose source positions all lie outside the row is the fill;
//   one at a row's end takes the same loads (CUBIC_GUARD bytes around each
//   chunk keep them in the buffer), then sets the taps outside the row and
//   the pixels whose source lies outside to the fill: a few selects, so a
//   warp whose windows straddle rows does not run per-pixel code.
// Where W % 16 != 0 or the rows or the output are not 16-byte aligned, the
// same kernel runs its scalar path (VEC = false): every pixel checked, one
// byte per output access.
// Bitwise: the weights are the same function of the same fraction as
// before, the taps summed from 0 in the order -1, 0, 1, 2, the division an
// IEEE division; the source mask (a per-row interval) and the two
// conversions give the same bits another way (below).
// ---------------------------------------------------------------------------

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

// One row's terms: the taps' weights, their sum clamped to 1e-8, the
// taps' integer shift, and the pixels [xlo, xhi] whose source position
// lies in [-0.5, W - 0.5]. The shift is clamped to ±(W + 2): past that
// every tap and every source position lies outside the row, for the
// clamped shift as for the true one.
//
// The interval is the plain version's mask, exactly. A pixel's source
// position is (x + fl) + frac; x + fl is an integer k, exact, and
// RN(k + frac) rises with k. For 0 <= k <= W - 2 it lies in [k, k + 1],
// inside; for k <= -2 it is at most -1, and for k >= W at least W, both
// outside. So only k = -1 and k = W - 1 need the rounded sum, which is
// computed here as the plain version computes it; a NaN fraction leaves
// every pixel outside, as its NaN positions do.
struct __align__(16) CubicRow {
  float c[4];
  float wmax;
  int s, xlo, xhi;
};

__device__ __forceinline__ CubicRow cubic_row(float src, int w) {
  CubicRow row;
  const float fl = floorf(src);
  const float frac = __fsub_rn(src, fl);
  float wsum = 0.0f;
#pragma unroll
  for (int tap = -1; tap <= 2; ++tap) {
    row.c[tap + 1] = cubic_weight(__fsub_rn(frac, (float)tap));
    wsum = __fadd_rn(wsum, row.c[tap + 1]);
  }
  row.wmax = fmaxf(wsum, 1e-8f);
  const float lim = (float)(w + 2);
  row.s = (int)fminf(fmaxf(fl, -lim), lim);
  int klo = __fadd_rn(-1.0f, frac) >= -0.5f ? -1 : 0;
  int khi = __fadd_rn((float)(w - 1), frac) <= (float)w - 0.5f ? w - 1
                                                                 : w - 2;
  if (frac != frac) klo = 1, khi = 0;
  // x + s = k where the interval meets [0, W) (there s is fl)
  row.xlo = klo - row.s;
  row.xhi = khi - row.s;
  return row;
}

// Byte k of `word` as f32, exactly: the float whose bits are 2^23's with
// the byte in the low mantissa bits, less 2^23 (a byte permute and a
// subtraction, no conversion instruction).
__device__ __forceinline__ float byte_float(uint32_t word, int k) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | k)),
      8388608.0f);
}

// rint(v) clipped to [0, 255], in the low byte of the result: clipping
// first gives the same value (rint is monotone and fixes 0 and 255; a NaN
// becomes 0 either way), and v + 1.5 * 2^23 for v in [0, 255] lies in
// [2^23, 2^24), where the float step is 1, so the sum rounds v half to
// even and its bits are 0x4B400000 + rint(v).
__device__ __forceinline__ uint32_t round_byte(float v) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), 12582912.0f));
}

// The low bytes of a, b, c, d as one word.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b,
                                                   uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Output pixel x of a staged row before rounding, with every check: a
// pixel whose source position lies outside [-0.5, W - 0.5] is the fill, a
// tap outside [0, W) reads the fill.
__device__ __forceinline__ float cubic_pixel(const uint8_t* row, int x,
                                             const CubicRow& p, int w,
                                             float fill) {
  if (x < p.xlo || x > p.xhi) return fill;
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int idx = x + p.s + t - 1;
    const float pix = (idx >= 0 && idx < w) ? byte_float(row[idx], 0) : fill;
    acc = __fadd_rn(acc, __fmul_rn(p.c[t], pix));
  }
  return __fdiv_rn(acc, p.wmax);
}

// Output bytes [x0, x0 + 16) of a staged row (`row` 16-byte aligned, with
// CUBIC_GUARD readable bytes before it and after row + w, w % 16 == 0).
__device__ __forceinline__ uint4 cubic_vector(const uint8_t* row, int x0,
                                              const CubicRow& p, int w,
                                              float fill, uint32_t fill4) {
  // pixels jlo .. jhi of the window have their source in the row
  const int jlo = p.xlo - x0, jhi = p.xhi - x0;
  if (jhi < 0 || jlo > 15) return make_uint4(fill4, fill4, fill4, fill4);
  // taps o .. o + 18: bytes d .. d + 18 of three aligned words (the third
  // only where d + 18 reaches it). Some pixel's source lies in the row, so
  // -17 <= o <= w - 2 and the words lie within CUBIC_GUARD of the row.
  const int o = x0 + p.s - 1;
  const int a = o & ~15, d = o - a;
  const uint4 q0 = *reinterpret_cast<const uint4*>(row + a);
  const uint4 q1 = *reinterpret_cast<const uint4*>(row + a + 16);
  const uint4 q2 =
      d >= 14 ? *reinterpret_cast<const uint4*>(row + a + 32) : q1;
  // words d / 4 .. d / 4 + 5 of the 12, by two rounds of selects
  const uint32_t q[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                         q2.x};
  const bool two = d & 8, one = d & 4;
  uint32_t s1[7], s2[6], bytes[5];
#pragma unroll
  for (int i = 0; i < 7; ++i) s1[i] = two ? q[i + 2] : q[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) s2[i] = one ? s1[i + 1] : s1[i];
  const int sh = 8 * (d & 3);
#pragma unroll
  for (int i = 0; i < 5; ++i) bytes[i] = __funnelshift_r(s2[i], s2[i + 1], sh);
  float px[19];
#pragma unroll
  for (int m = 0; m < 19; ++m) px[m] = byte_float(bytes[m >> 2], m & 3);
  if (o < 0 || o + 18 >= w) {   // taps outside [0, W) read the fill
#pragma unroll
    for (int m = 0; m < 19; ++m)
      if ((unsigned)(o + m) >= (unsigned)w) px[m] = fill;
  }
  uint32_t b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      acc = __fadd_rn(acc, __fmul_rn(p.c[t], px[j + t]));
    b[j] = round_byte(__fdiv_rn(acc, p.wmax));
  }
  uint4 r = make_uint4(pack_low_bytes(b[0], b[1], b[2], b[3]),
                       pack_low_bytes(b[4], b[5], b[6], b[7]),
                       pack_low_bytes(b[8], b[9], b[10], b[11]),
                       pack_low_bytes(b[12], b[13], b[14], b[15]));
  if (jlo > 0 || jhi < 15) {   // the others are the fill
    uint32_t m = byte_mask(jlo, jhi + 1);
    r.x = (r.x & m) | (fill4 & ~m);
    m = byte_mask(jlo - 4, jhi - 3);
    r.y = (r.y & m) | (fill4 & ~m);
    m = byte_mask(jlo - 8, jhi - 7);
    r.z = (r.z & m) | (fill4 & ~m);
    m = byte_mask(jlo - 12, jhi - 11);
    r.w = (r.w & m) | (fill4 & ~m);
  }
  return r;
}

template <bool VEC>
__device__ __forceinline__ void emit_cubic_chunk(
    const uint8_t* __restrict__ rows, int n, int w, int rpc, int c,
    const uint8_t* stage, const CubicRow* rowp, float fill,
    uint8_t* __restrict__ out) {
  const int n0 = c * rpc;
  const int nr = min(rpc, n - n0);
  if (VEC) {
    // rows 16-byte aligned: window v of row r is bytes [16 v, 16 v + 16)
    const uint32_t fill4 = 0x01010101u * (round_byte(fill) & 0xff);
    for_each_window(nr, w, [&](int r, int v) {
      *reinterpret_cast<uint4*>(out + (size_t)(n0 + r) * w + 16 * v) =
          cubic_vector(stage + r * w, 16 * v, rowp[r], w, fill, fill4);
    });
  } else {
    const int lead = (int)((uintptr_t)(rows + (size_t)n0 * w) & 15);
    uint8_t* dst = out + (size_t)n0 * w;
    for_each_byte(nr, w, [&](int k, int r, int x) {
      dst[k] = (uint8_t)round_byte(
          cubic_pixel(stage + lead + r * w, x, rowp[r], w, fill));
    });
  }
}

// The row shift's walk with CUBIC_GUARD bytes around each chunk (a window
// at a row's end reads up to 32 bytes past it); each chunk's row offsets
// are loaded with its copies, and its row terms computed from them while
// the block writes the chunk before.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
row_shift_cubic_kernel(const uint8_t* __restrict__ rows,
                       const float* __restrict__ src0, int n, int w, int rpc,
                       float fill, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int sb = row_stage_bytes(rpc, w, CUBIC_GUARD);
  CubicRow* rowp = reinterpret_cast<CubicRow*>(smem + 2 * sb);
  float src = 0.0f;   // the offset of row threadIdx.x of the staged chunk
  walk_chunks(
      (n + rpc - 1) / rpc,
      [&](int c, int b) {
        const int nr =
            stage_rows(rows, n, w, rpc, c, smem + b * sb + CUBIC_GUARD);
        src = (int)threadIdx.x < nr ? __ldg(src0 + c * rpc + threadIdx.x)
                                    : 0.0f;
      },
      [&](int c, int b) {
        if ((int)threadIdx.x < min(rpc, n - c * rpc))
          rowp[b * rpc + threadIdx.x] = cubic_row(src, w);
      },
      [&](int c, int b) {
        emit_cubic_chunk<VEC>(rows, n, w, rpc, c,
                              smem + b * sb + CUBIC_GUARD, rowp + b * rpc,
                              fill, out);
      });
}

bool planes_ok(int p, int hw) {
  return p >= 1 && p <= 65535 && hw >= 1;
}

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

// planes (P, HW) uint8 -> out (P, 256) int32 (every count written). One
// launch of clusters of up to HIST_RANKS blocks per plane; a cluster
// launch the card refuses comes back as its error.
int image_histogram(const uint8_t* planes, int p, int hw, int* out,
                    void* stream) {
  if (!planes_ok(p, hw)) return (int)cudaErrorInvalidValue;
  const int ranks = (int)std::min<long long>(
      HIST_RANKS, ((long long)hw + HIST_CHUNK - 1) / HIST_CHUNK);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, p);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, histogram_kernel, planes,
                                             hw, out);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
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
  const size_t smem = 2 * (size_t)row_stage_bytes(rpc, w, GUARD)
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
  const int rpc = rows_per_chunk(w);
  const size_t smem = 2 * (size_t)row_stage_bytes(rpc, w, CUBIC_GUARD)
                      + 2 * sizeof(CubicRow) * rpc;
  const int grid = shift_grid((n + (long long)rpc - 1) / rpc);
  const bool vec = w % 16 == 0 && aligned16(rows) && aligned16(out);
  return launch_shift(
      vec ? &row_shift_cubic_kernel<true> : &row_shift_cubic_kernel<false>,
      grid, smem, stream, rows, src0, n, w, rpc, (float)fill, out);
}

const char* image_ops_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
