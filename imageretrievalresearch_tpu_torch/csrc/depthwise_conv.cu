// Depthwise convolution for Hopper (sm_90a): the forward, the input
// gradient and the tap gradients.
//
// Replace the TPU kernels of imageretrievalresearch_tpu/ops/pallas_conv.py:
// - dw_conv_forward <- _dw_fwd_kernel (_pallas_dw)
// - dw_conv_grad_x  <- _dw_fwd_kernel as _dw_op_bwd runs it for dx: the
//   stride-1 forward of the cotangent, dilated by the stride, with the taps
//   flipped (one kernel here, with no dilated copy and no flip)
// - dw_conv_grad_w  <- _dw_grad_w_kernel (_pallas_dw_grad_w)
// Plain versions, wrappers, plans and the autograd wiring:
// imageretrievalresearch_tpu_torch/ops/depthwise.py.
//
// Semantics: torch Conv2d(C, C, K, stride, padding=K//2, groups=C,
// bias=False) for odd K <= 7 and stride 1 or 2; the output size is
// (H + 2p - K) / s + 1. Tensors are NHWC with C innermost: that is the
// memory order of the port's model on the card (its NHWC input, permuted to
// NCHW, makes cuDNN run channels-last throughout), so the depthwise layers
// read and write the activations in place, with no layout copy. Taps arrive
// as f32 (K*K, C), accumulation is f32, the output is the source's type
// (f32 or bf16).
//
// Bound: one pass reads its input once and writes its output once. For the
// 26 depthwise layers of efficientnet_b3a at 224 px and a batch of 192 in
// bf16 that is ~4.6 GB per pass, ~1.4 ms at 3.35 TB/s (H100 SXM), against
// ~27 GFLOP of f32 multiply-adds, ~0.4 ms at 67 TFLOP/s: every pass is bound
// by device memory.
//
// The three are band kernels, and share what they do for that bound:
// - An item is a band of th output rows of one image, across the whole
//   width, for one block of cb channels; a block walks a fixed range of
//   items, two blocks per SM (the wrapper's plan, band_plan and
//   band_splits, sizes th and cb to ~112 KB of dynamic shared memory per
//   block, opted in above 48 KB, and the grid to one wave).
// - The band's source rows (with the halo) are copied raw (bf16 stays
//   bf16) into shared memory by 16-byte cp.async, 8 bf16 channels per
//   copy, zero-filled outside the image, double-buffered: item i + 1's
//   copies are in flight while item i is summed. Each thread walks its
//   copies by carries, with no division per element. C not a multiple of
//   the 16-byte chunk takes masked single-element loads into the same
//   layout.
// - A thread owns a channel pair (bf16x2 words) and runs of RUN = 4
//   neighbouring output pixels of a row: per tap row it reads the run's
//   input pairs once and forms all of the run's products from registers.
//
// Design, forward and dx (dw_band_kernel): the K*K taps of the thread's
// pair sit in registers (dx: in the flipped order), each output pixel's
// sum in a register; products and sums are __fmul_rn / __fadd_rn in the
// plain version's tap order (row, then column), so nvcc contracts nothing
// into FMAs and both are bitwise equal to their plain versions. The output
// pair goes straight to device memory (one bf16x2 or float2 store). dx
// reads the cotangent at output resolution: at stride 1 it is the forward
// with flipped taps; at stride 2 a band of dx rows stages the (th + K) / 2
// cotangent rows it reads, and each dx pixel sums only the taps whose
// source lands on an output pixel, a quarter of the dilated forward's
// terms, which skips three quarters of the reads and products that JAX's
// dilated cotangent costs (the skipped terms are exact zeros: see the
// kernel). The TPU kernel's polyphase split and halo'd row tiles exist only
// for Mosaic's limits.
//
// Design, tap gradients: on the TPU one output block is revisited by a
// sequential grid and accumulated in place. Here blocks run in parallel and
// in no order, so each block writes its own partial sums, and a second
// kernel sums the splits in order. Every sum has a fixed order (no
// atomics), so repeated runs are bitwise equal. The pass is bound by bytes
// (4.6 GB at b3a's N = 192, ~1.4 ms), and what the design does for that:
// - The band staging above, of the item's x rows and its g rows.
// - Per tap row a thread reads the run's (RUN - 1) * s + K input pairs once
//   and forms all RUN * K products from registers, into K*K f32
//   accumulators per channel.
// - The threads of one channel pair are summed in slot order through shared
//   memory (one barrier), then the ordered split reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// Tap gradients (kernel 10; top of file)
// ---------------------------------------------------------------------------

constexpr int RUN = 4;             // output pixels of a row per thread step
constexpr int GRAD_MAX_SMEM = 232448;

// The tap-gradient geometry: items are (image, band of th output rows);
// a block stages the band's x rows (with the halo) and g rows across the
// whole width, for cb channels, in dynamic shared memory.
struct GradGeom {
  int n, h, w, c, ho, wo;
  int th, cb;        // output rows per item, channels per block
  int rows_in;       // staged x rows: (th - 1) * s + k
  int xw, gw;        // staged x columns (with the padding), g columns
  int rpr;           // runs of RUN pixels per output row
  int bands, items;  // bands per image, n * bands
  int np, nslot;     // channel pairs per block, threads per channel pair
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// a channel pair (2c, 2c + 1) as two f32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// A thread's walk over a (rows, cols, chunks) box, THREADS entries apart:
// the first entry by division once, every later one by carries.
struct BoxWalk {
  int row, col, cg;        // the current entry
  int d_row, d_col, d_cg;  // the step of THREADS entries
  __device__ BoxWalk(int cols, int cpc) {
    const int t = threadIdx.x, per_row = cols * cpc;
    row = t / per_row;
    col = t % per_row / cpc;
    cg = t % cpc;
    d_row = THREADS / per_row;
    d_col = THREADS % per_row / cpc;
    d_cg = THREADS % cpc;
  }
  __device__ __forceinline__ void next(int cols, int cpc) {
    cg += d_cg;
    if (cg >= cpc) {
      cg -= cpc;
      ++col;
    }
    col += d_col;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
    row += d_row;
  }
};

// Stages item (image n, band starting at output row r0) into buffer `xs`
// (x: [rows_in][xw][cb], its rows from r0 * S - K/2, its columns shifted
// by K/2) and `gs` (g: [th][gw][cb]): 16-byte cp.async per chunk of
// E = 16 / sizeof(T) channels when `vec`, zero-filled for rows outside the
// image and channels past C; else masked loads of single elements. The
// padding columns and the runs' tail columns are never written here (they
// stay zero).
template <typename T, int K, int S>
__device__ __forceinline__ void stage_grad_item(
    const T* __restrict__ x, const T* __restrict__ gy, const GradGeom& g,
    int n, int r0, int c0, int cn, bool vec, T* xs, T* gs) {
  constexpr int E = 16 / sizeof(T), P = K / 2;
  const int cpc = g.cb / E;
  const int xr0 = r0 * S - P;
  for (BoxWalk b(g.w, cpc); b.row < g.rows_in; b.next(g.w, cpc)) {
    const int hh = xr0 + b.row, cc = b.cg * E;
    const T* src = x + (((size_t)n * g.h + hh) * g.w + b.col) * g.c + c0 + cc;
    T* dst = xs + ((size_t)b.row * g.xw + b.col + P) * g.cb + cc;
    const bool row_in = hh >= 0 && hh < g.h;
    if (vec) {
      const bool in = row_in && cc < cn;
      cp_async16(dst, in ? src : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = row_in && cc + e < cn ? src[e] : T(0.0f);
    }
  }
  for (BoxWalk b(g.wo, cpc); b.row < g.th; b.next(g.wo, cpc)) {
    const int rr = r0 + b.row, cc = b.cg * E;
    const T* src =
        gy + (((size_t)n * g.ho + rr) * g.wo + b.col) * g.c + c0 + cc;
    T* dst = gs + ((size_t)b.row * g.gw + b.col) * g.cb + cc;
    const bool row_in = rr < g.ho;
    if (vec) {
      const bool in = row_in && cc < cn;
      cp_async16(dst, in ? src : gy, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = row_in && cc + e < cn ? src[e] : T(0.0f);
    }
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS, K <= 5 ? 2 : 1)
dw_grad_w_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                 float* __restrict__ partial, GradGeom g, int items_per_split,
                 bool vec) {
  constexpr int KK = K * K, RX = (RUN - 1) * S + K;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  const int tid = threadIdx.x, split = blockIdx.x;
  const int c0 = blockIdx.y * g.cb, cn = min(g.cb, g.c - c0);
  const size_t buf = (size_t)(g.rows_in * g.xw + g.th * g.gw) * g.cb;
  T* bufs = reinterpret_cast<T*>(dw_smem);

  // both buffers zeroed once: the padding stays zero
  {
    const int n16 = (int)(2 * buf * sizeof(T) / 16);
    for (int i = tid; i < n16; i += THREADS)
      reinterpret_cast<uint4*>(dw_smem)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int item0 = split * items_per_split;
  const int item1 = min(item0 + items_per_split, g.items);
  int ld_n = item0 / g.bands, ld_b = item0 % g.bands;  // the next to stage
  auto stage = [&](int slot) {
    T* xs = bufs + slot * buf;
    stage_grad_item<T, K, S>(x, gy, g, ld_n, ld_b * g.th, c0, cn, vec, xs,
                             xs + (size_t)g.rows_in * g.xw * g.cb);
    asm volatile("cp.async.commit_group;\n" ::);
    if (++ld_b == g.bands) {
      ld_b = 0;
      ++ld_n;
    }
  };

  // this thread: channel pair cp, and the runs slot, slot + nslot, ... of
  // each band (run = RUN pixels of one output row)
  const int cp = tid % g.np, slot = tid / g.np;
  const bool active = slot < g.nslot;
  const int runs = g.th * g.rpr;
  const int r_first = slot / g.rpr, w_first = slot % g.rpr;
  const int d_r = g.nslot / g.rpr, d_w = g.nslot % g.rpr;

  float acc[KK][2];
#pragma unroll
  for (int t = 0; t < KK; ++t) acc[t][0] = acc[t][1] = 0.f;

  stage(0);
  for (int it = item0; it < item1; ++it) {
    // item it + 1's copies go out before the wait for item it, so both
    // buffers are in flight while the block waits
    if (it > item0) __syncthreads();  // every warp is done with it - 1
    if (it + 1 < item1) {
      stage((it + 1 - item0) & 1);  // into its buffer
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // item `it` is in, every thread's copies of it
    const T* xs = bufs + ((it - item0) & 1) * buf;
    const T* gs = xs + (size_t)g.rows_in * g.xw * g.cb;
    if (!active) continue;
    int r = r_first, wr = w_first;
    for (int ru = slot; ru < runs; ru += g.nslot) {
      const int w0 = wr * RUN;
      float2 gv[RUN];
      const T* gp = gs + ((size_t)r * g.gw + w0) * g.cb + 2 * cp;
#pragma unroll
      for (int u = 0; u < RUN; ++u) gv[u] = load_pair(gp + u * g.cb);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const T* xp =
            xs + ((size_t)(r * S + i) * g.xw + w0 * S) * g.cb + 2 * cp;
        float2 xv[RX];
#pragma unroll
        for (int q = 0; q < RX; ++q) xv[q] = load_pair(xp + q * g.cb);
#pragma unroll
        for (int u = 0; u < RUN; ++u)
#pragma unroll
          for (int j = 0; j < K; ++j) {
            acc[i * K + j][0] =
                fmaf(xv[u * S + j].x, gv[u].x, acc[i * K + j][0]);
            acc[i * K + j][1] =
                fmaf(xv[u * S + j].y, gv[u].y, acc[i * K + j][1]);
          }
      }
      wr += d_w;
      if (wr >= g.rpr) {
        wr -= g.rpr;
        ++r;
      }
      r += d_r;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // the slots of each channel, summed in slot order
  float* red = reinterpret_cast<float*>(dw_smem);  // [nslot][KK][cb]
  if (active) {
#pragma unroll
    for (int t = 0; t < KK; ++t) {
      red[((size_t)slot * KK + t) * g.cb + 2 * cp] = acc[t][0];
      red[((size_t)slot * KK + t) * g.cb + 2 * cp + 1] = acc[t][1];
    }
  }
  __syncthreads();
  for (int t = 0; t < KK; ++t)
    for (int ch = tid; ch < cn; ch += THREADS) {
      float s = 0.f;
      for (int k = 0; k < g.nslot; ++k)
        s += red[((size_t)k * KK + t) * g.cb + ch];
      partial[((size_t)split * KK + t) * g.c + c0 + ch] = s;
    }
}

// out[i] = sum over the splits, in order, of partial[split][i]
__global__ void __launch_bounds__(THREADS)
dw_grad_w_reduce_kernel(const float* __restrict__ partial, int nsplit,
                        int total, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int k = 0; k < nsplit; ++k) s += partial[(size_t)k * total + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// Forward and input gradient (kernel 9; top of file)
// ---------------------------------------------------------------------------

// The band geometry of the forward and of dx: items are (image, band of th
// output rows); a block stages the source rows an item reads (x for the
// forward, the cotangent for dx) across the whole width, for cb channels,
// in dynamic shared memory, source column s at buffer column s + coff.
struct BandGeom {
  int n, sh, sw, c;  // the source, NHWC
  int oh, ow;        // the output: (Ho, Wo), or (H, W) for dx
  int th, cb;        // output rows per item, channels per block
  int rows_in, xw;   // staged source rows and columns per item
  int coff;          // buffer column of source column 0
  int rpr;           // runs of RUN pixels per output row
  int bands, items;  // bands per image, n * bands
  int np, nslot;     // channel pairs per block, threads per channel pair
};

// Stages the rows_in source rows from sr0 of image n (channels c0 .. c0 +
// cb) into `buf` ([rows_in][xw][cb]), by 16-byte cp.async per chunk of E =
// 16 / sizeof(T) channels when `vec`, zero-filled for rows outside the
// source and channels past C; else masked loads of single elements. The
// buffer's padding columns are never written here (they stay zero).
template <typename T>
__device__ __forceinline__ void stage_band(const T* __restrict__ src,
                                           const BandGeom& g, int n, int sr0,
                                           int c0, int cn, bool vec, T* buf) {
  constexpr int E = 16 / sizeof(T);
  const int cpc = g.cb / E;
  for (BoxWalk b(g.sw, cpc); b.row < g.rows_in; b.next(g.sw, cpc)) {
    const int hh = sr0 + b.row, cc = b.cg * E;
    const T* s = src + (((size_t)n * g.sh + hh) * g.sw + b.col) * g.c + c0 + cc;
    T* dst = buf + ((size_t)b.row * g.xw + b.col + g.coff) * g.cb + cc;
    const bool row_in = hh >= 0 && hh < g.sh;
    if (vec) {
      const bool in = row_in && cc < cn;
      cp_async16(dst, in ? s : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = row_in && cc + e < cn ? s[e] : T(0.0f);
    }
  }
}

// Channels (c, c + 1) of an output pixel, from f32 (RN to bf16); `pair`:
// both in C and 2-element aligned, so one store.
__device__ __forceinline__ void store_pair(float* p, float2 v, bool pair,
                                           bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    p[0] = v.x;
    if (second) p[1] = v.y;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float2 v,
                                           bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  } else {
    p[0] = __float2bfloat16(v.x);
    if (second) p[1] = __float2bfloat16(v.y);
  }
}

// The forward (DX false) of a layer of stride S: out[r][c] = sum over the
// taps (i, j), row by row, of x[r S - P + i][c S - P + j] * tap[i][j]. Its
// input gradient (DX true): the stride-1 forward of the cotangent dilated
// by S (its rows and columns at multiples of S, zeros between) with the
// taps flipped, read without the dilated copy. At S = 1 that is the
// forward with the flipped taps. At S = 2 a term (i', j') of dx[y][x]
// reads the cotangent at ((y - P + i') / 2, (x - P + j') / 2) when both
// are whole, and is a zero product otherwise: the kernel skips those
// terms, three quarters of them. A sum starts at +0 and so is never -0,
// and adding +0 or -0 to it leaves it as it is, so skipping them changes
// no bit: dx equals the plain version's (the forward of the dilated copy)
// under torch.equal, taps with an infinity or NaN aside (0 * inf is NaN
// there). Every product and sum is __fmul_rn / __fadd_rn, in the plain
// version's tap order, so the forward is bitwise equal to it as well.
template <typename T, int K, int S, bool DX>
__global__ void __launch_bounds__(THREADS, K <= 5 ? 2 : 1)
dw_band_kernel(const T* __restrict__ src, const float* __restrict__ taps,
               T* __restrict__ out, BandGeom g, int items_per_split,
               bool vec) {
  constexpr int P = K / 2, KK = K * K;
  constexpr bool DIL = DX && S == 2;  // dx over the dilated cotangent
  constexpr int SS = DX ? 1 : S;       // source step per output pixel
  constexpr int PD = (P + 1) / 2;      // DIL: buffer column offset
  // source pairs a run reads per tap row
  constexpr int RX = DIL ? (RUN - 1 + P + 2 * PD) / 2 + 1 : (RUN - 1) * SS + K;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  const int tid = threadIdx.x, split = blockIdx.x;
  const int c0 = blockIdx.y * g.cb, cn = min(g.cb, g.c - c0);
  const size_t buf = (size_t)g.rows_in * g.xw * g.cb;
  T* bufs = reinterpret_cast<T*>(dw_smem);

  // both buffers zeroed once: the padding columns stay zero
  {
    const int n16 = (int)(2 * buf * sizeof(T) / 16);
    for (int i = tid; i < n16; i += THREADS)
      reinterpret_cast<uint4*>(dw_smem)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // the first source row of the item whose first output row is r0
  auto first_row = [](int r0) {
    return DIL ? (r0 - P + 1) >> 1 : r0 * SS - P;
  };
  const int item0 = split * items_per_split;
  const int item1 = min(item0 + items_per_split, g.items);
  int ld_n = item0 / g.bands, ld_b = item0 % g.bands;  // the next to stage
  auto stage = [&](int slot) {
    stage_band<T>(src, g, ld_n, first_row(ld_b * g.th), c0, cn, vec,
                  bufs + slot * buf);
    asm volatile("cp.async.commit_group;\n" ::);
    if (++ld_b == g.bands) {
      ld_b = 0;
      ++ld_n;
    }
  };

  // this thread: channel pair cp, and the runs slot, slot + nslot, ... of
  // each band (run = RUN pixels of one output row)
  const int cp = tid % g.np, slot = tid / g.np;
  const int ch = c0 + 2 * cp;
  const bool active = slot < g.nslot && 2 * cp < cn;
  const bool pair = g.c % 2 == 0, second = 2 * cp + 1 < cn;
  const int runs = g.th * g.rpr;
  const int r_first = slot / g.rpr, w_first = slot % g.rpr;
  const int d_r = g.nslot / g.rpr, d_w = g.nslot % g.rpr;

  // the K*K taps of the pair, in the order of the terms (dx: flipped)
  float2 wr[KK];
#pragma unroll
  for (int t = 0; t < KK; ++t) {
    const int tap = DX ? KK - 1 - t : t;
    wr[t].x = active ? taps[tap * g.c + ch] : 0.f;
    wr[t].y = active && second ? taps[tap * g.c + ch + 1] : 0.f;
  }

  int it_n = item0 / g.bands, it_b = item0 % g.bands;  // the item summed
  stage(0);
  for (int it = item0; it < item1; ++it) {
    // item it + 1's copies go out before the wait for item it, so both
    // buffers are in flight while the block waits
    if (it > item0) __syncthreads();  // every warp is done with it - 1
    if (it + 1 < item1) {
      stage((it + 1 - item0) & 1);  // into its buffer
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // item `it` is in, every thread's copies of it
    const T* xs = bufs + ((it - item0) & 1) * buf;
    const int r0 = it_b * g.th, sr0 = first_row(r0), n = it_n;
    if (++it_b == g.bands) {
      it_b = 0;
      ++it_n;
    }
    if (!active) continue;
    int r = r_first, wq = w_first;
    for (int ru = slot; ru < runs; ru += g.nslot) {
      const int y = r0 + r, w0 = wq * RUN;
      wq += d_w;
      if (wq >= g.rpr) {
        wq -= g.rpr;
        ++r;
      }
      r += d_r;
      if (y >= g.oh) continue;  // the last band's rows past the output
      float2 acc[RUN];
#pragma unroll
      for (int u = 0; u < RUN; ++u) acc[u] = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        int row;
        if constexpr (DIL) {
          if ((y - P + i) & 1) continue;  // a row of the dilation's zeros
          row = ((y - P + i) >> 1) - sr0;
        } else {
          row = (y - r0) * SS + i;
        }
        const T* xp = xs + ((size_t)row * g.xw + (DIL ? w0 / 2 : w0 * SS)) *
                               g.cb + 2 * cp;
        float2 xv[RX];
#pragma unroll
        for (int q = 0; q < RX; ++q) xv[q] = load_pair(xp + q * g.cb);
#pragma unroll
        for (int u = 0; u < RUN; ++u)
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (DIL && ((u - P + j) & 1)) continue;  // a zero column
            const int q = DIL ? (u - P + j + 2 * PD) / 2 : u * SS + j;
            acc[u].x = __fadd_rn(acc[u].x, __fmul_rn(xv[q].x, wr[i * K + j].x));
            acc[u].y = __fadd_rn(acc[u].y, __fmul_rn(xv[q].y, wr[i * K + j].y));
          }
      }
      T* op = out + (((size_t)n * g.oh + y) * g.ow + w0) * g.c + ch;
#pragma unroll
      for (int u = 0; u < RUN; ++u)
        if (w0 + u < g.ow) store_pair(op + (size_t)u * g.c, acc[u], pair, second);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

int out_len(int size, int k, int s) { return (size + 2 * (k / 2) - k) / s + 1; }

bool bad_conv(int n, int h, int w, int c, int ho, int wo, int k, int s) {
  return n < 1 || h < 1 || w < 1 || c < 1 || k < 1 || k > 7 || k % 2 == 0 ||
         (s != 1 && s != 2) || ho != out_len(h, k, s) ||
         wo != out_len(w, k, s) || ho < 1 || wo < 1;
}

// The band geometry the wrapper planned (band height th, cb channels per
// block) for the forward (dx = 0) or dx (dx = 1) of a layer with input
// (n, h, w, c) and output (ho, wo), with the shared memory it needs (two
// buffers), or false when the kernel does not take it.
bool make_band_geom(int dx, int n, int h, int w, int c, int ho, int wo, int k,
                    int s, int th, int cb, size_t esize, BandGeom* g,
                    size_t* smem) {
  const int p = k / 2;
  if (bad_conv(n, h, w, c, ho, wo, k, s)) return false;
  g->n = n; g->c = c;
  g->sh = dx ? ho : h; g->sw = dx ? wo : w;
  g->oh = dx ? h : ho; g->ow = dx ? w : wo;
  if (th < 1 || th > g->oh || cb < 8 || cb % 8 || cb > 2 * THREADS ||
      (c + cb - 1) / cb > 65535)
    return false;
  g->th = th; g->cb = cb;
  g->rpr = (g->ow + RUN - 1) / RUN;
  const int runs_w = g->rpr * RUN;
  if (dx && s == 2) {
    const int pd = (p + 1) / 2, rx = (RUN - 1 + p + 2 * pd) / 2 + 1;
    g->rows_in = (th + k) / 2;
    g->coff = pd;
    g->xw = std::max((runs_w - RUN) / 2 + rx, g->sw + pd);
  } else {
    const int ss = dx ? 1 : s;
    g->rows_in = (th - 1) * ss + k;
    g->coff = p;
    g->xw = std::max((runs_w - 1) * ss + k, g->sw + 2 * p);
  }
  g->bands = (g->oh + th - 1) / th;
  g->np = cb / 2;
  g->nslot = THREADS / g->np;
  if ((long long)n * g->bands >= (1LL << 31)) return false;
  g->items = n * g->bands;
  *smem = 2 * (size_t)g->rows_in * g->xw * cb * esize;
  return *smem <= GRAD_MAX_SMEM;
}

template <typename T, int K, int S, bool DX>
int launch_band(const void* src, const float* taps, void* out,
                const BandGeom& g, size_t smem, int nsplit,
                int items_per_split, cudaStream_t stream) {
  const bool vec = g.c % (16 / sizeof(T)) == 0 && (uintptr_t)src % 16 == 0;
  int err = (int)cudaFuncSetAttribute(
      dw_band_kernel<T, K, S, DX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  dim3 grid(nsplit, (g.c + g.cb - 1) / g.cb);
  dw_band_kernel<T, K, S, DX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(src), taps, static_cast<T*>(out), g,
      items_per_split, vec);
  return (int)cudaGetLastError();
}

// The tap-gradient geometry the wrapper planned (band height th, cb
// channels per block), with the shared memory it needs, or false when the
// kernels do not take it.
bool make_grad_geom(int n, int h, int w, int c, int ho, int wo, int k, int s,
                    int th, int cb, size_t esize, GradGeom* g, size_t* smem) {
  if (bad_conv(n, h, w, c, ho, wo, k, s) || th < 1 || th > ho || cb < 8 ||
      cb % 8 || cb > 2 * THREADS || (c + cb - 1) / cb > 65535)
    return false;
  g->n = n; g->h = h; g->w = w; g->c = c; g->ho = ho; g->wo = wo;
  g->th = th; g->cb = cb;
  g->rows_in = (th - 1) * s + k;
  g->rpr = (wo + RUN - 1) / RUN;
  g->gw = g->rpr * RUN;
  const int span = (g->gw - 1) * s + k, padded = w + 2 * (k / 2);
  g->xw = span > padded ? span : padded;
  g->bands = (ho + th - 1) / th;
  g->np = cb / 2;
  g->nslot = THREADS / g->np;
  if ((long long)n * g->bands >= (1LL << 31)) return false;
  g->items = n * g->bands;
  const size_t buf =
      (size_t)(g->rows_in * g->xw + th * g->gw) * cb * esize;
  const size_t red = (size_t)g->nslot * k * k * cb * sizeof(float);
  *smem = 2 * buf > red ? 2 * buf : red;
  return *smem <= GRAD_MAX_SMEM;
}

template <typename T, int K, int S>
int launch_grad_w(const void* x, const void* gy, float* partial, float* out,
                  const GradGeom& g, size_t smem, int nsplit,
                  int items_per_split, cudaStream_t stream) {
  const bool vec = g.c % (16 / sizeof(T)) == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)gy % 16 == 0;
  int err = (int)cudaFuncSetAttribute(
      dw_grad_w_kernel<T, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return err;
  dim3 grid(nsplit, (g.c + g.cb - 1) / g.cb);
  dw_grad_w_kernel<T, K, S><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), partial, g,
      items_per_split, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int total = K * K * g.c;
  dw_grad_w_reduce_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0,
                            stream>>>(partial, nsplit, total, out);
  return (int)cudaGetLastError();
}

// Calls F<T, K, S>::run(args...) for the runtime (bf16, k, s).
template <template <typename, int, int> class F, typename... Args>
int dispatch(int bf16, int k, int s, Args... args) {
#define DW_CASE(KK, SS)                                                  \
  if (k == KK && s == SS)                                                \
    return bf16 ? F<__nv_bfloat16, KK, SS>::run(args...)                 \
                : F<float, KK, SS>::run(args...);
  DW_CASE(1, 1) DW_CASE(1, 2) DW_CASE(3, 1) DW_CASE(3, 2)
  DW_CASE(5, 1) DW_CASE(5, 2) DW_CASE(7, 1) DW_CASE(7, 2)
#undef DW_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int K, int S>
struct Forward {
  static int run(const void* x, const float* taps, void* out, BandGeom g,
                 size_t smem, int nsplit, int items_per_split,
                 cudaStream_t stream) {
    return launch_band<T, K, S, false>(x, taps, out, g, smem, nsplit,
                                       items_per_split, stream);
  }
};

template <typename T, int K, int S>
struct GradX {
  static int run(const void* gy, const float* taps, void* dx, BandGeom g,
                 size_t smem, int nsplit, int items_per_split,
                 cudaStream_t stream) {
    return launch_band<T, K, S, true>(gy, taps, dx, g, smem, nsplit,
                                      items_per_split, stream);
  }
};

// Whether (nsplit, items_per_split) gives every one of `items` to exactly
// one split, none empty.
bool bad_split(int nsplit, int items_per_split, int items) {
  return nsplit < 1 || items_per_split < 1 ||
         (long long)nsplit * items_per_split < (long long)items ||
         (long long)(nsplit - 1) * items_per_split >= (long long)items;
}

int band_entry(int dx, const void* src, const float* taps, void* out, int n,
               int h, int w, int c, int ho, int wo, int k, int stride, int th,
               int cb, int nsplit, int items_per_split, int bf16,
               void* stream) {
  BandGeom g;
  size_t smem;
  if (!make_band_geom(dx, n, h, w, c, ho, wo, k, stride, th, cb,
                      bf16 ? 2 : 4, &g, &smem) ||
      bad_split(nsplit, items_per_split, g.items))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return dx ? dispatch<GradX>(bf16, k, stride, src, taps, out, g, smem,
                              nsplit, items_per_split, st)
            : dispatch<Forward>(bf16, k, stride, src, taps, out, g, smem,
                                nsplit, items_per_split, st);
}

template <typename T, int K, int S>
struct GradW {
  static int run(const void* x, const void* gy, float* partial, float* out,
                 GradGeom g, size_t smem, int nsplit, int items_per_split,
                 cudaStream_t stream) {
    return launch_grad_w<T, K, S>(x, gy, partial, out, g, smem, nsplit,
                                  items_per_split, stream);
  }
};

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok);
// cudaErrorInvalidValue for shapes or plans it does not take. x, out and g
// are NHWC contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); taps are f32
// (K*K, C), unflipped; (th, cb) is the wrapper's band plan. Items are
// (image, band of th output rows) for each block of cb channels; split s
// covers items [s * items_per_split, (s + 1) * items_per_split).

// x (N, H, W, C) -> out (N, Ho, Wo, C).
int dw_conv_forward(const void* x, const float* taps, void* out, int n, int h,
                    int w, int c, int ho, int wo, int k, int stride, int th,
                    int cb, int nsplit, int items_per_split, int bf16,
                    void* stream) {
  return band_entry(0, x, taps, out, n, h, w, c, ho, wo, k, stride, th, cb,
                    nsplit, items_per_split, bf16, stream);
}

// The cotangent gy (N, Ho, Wo, C) -> dx (N, H, W, C); bands of th rows of
// dx.
int dw_conv_grad_x(const void* gy, const float* taps, void* dx, int n, int h,
                   int w, int c, int ho, int wo, int k, int stride, int th,
                   int cb, int nsplit, int items_per_split, int bf16,
                   void* stream) {
  return band_entry(1, gy, taps, dx, n, h, w, c, ho, wo, k, stride, th, cb,
                    nsplit, items_per_split, bf16, stream);
}

// x (N, H, W, C), gy (N, Ho, Wo, C) -> out (K*K, C) f32, through
// partial (nsplit, K*K, C) f32. Items are (image, band of th output rows),
// n * ceil(Ho / th) of them, for each block of cb channels; split s covers
// items [s * items_per_split, (s + 1) * items_per_split).
int dw_conv_grad_w(const void* x, const void* gy, float* partial, float* out,
                   int n, int h, int w, int c, int ho, int wo, int k,
                   int stride, int th, int cb, int nsplit,
                   int items_per_split, int bf16, void* stream) {
  GradGeom g;
  size_t smem;
  if (!make_grad_geom(n, h, w, c, ho, wo, k, stride, th, cb, bf16 ? 2 : 4,
                      &g, &smem) ||
      bad_split(nsplit, items_per_split, g.items))
    return (int)cudaErrorInvalidValue;
  return dispatch<GradW>(bf16, k, stride, x, gy, partial, out, g, smem,
                         nsplit, items_per_split,
                         reinterpret_cast<cudaStream_t>(stream));
}

const char* depthwise_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
