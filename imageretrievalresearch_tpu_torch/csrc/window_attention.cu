// Window attention for Hopper (sm_90a): Swin's attention core for f32
// inference in one kernel,
//
//   out = softmax(q·scale · kᵀ + table[index] (+ mask)) · v,
//
// for windows of ws x ws tokens (N = ws², ws <= 14: Swin's windows of 7
// and 14), index being Swin's relative-position index, which the kernel
// computes in closed form: (ih - jh + ws - 1)(2ws - 1) + (iw - jw + ws - 1)
// for query token i = (ih, iw) and key token j = (jh, jw), row-major.
//
// from the qkv linear layer's output to the heads' outputs in the layout
// that the proj linear layer takes; the scores never reach device memory.
// Wrapper and plain version: imageretrievalresearch_tpu_torch/ops/
// attention.py; the dispatch: models/swin.py (WindowAttention.forward).
//
// Replaces no TPU kernel: the JAX package's window attention is plain jnp
// (imageretrievalresearch_tpu/models/swin.py:93-120), which XLA fuses on
// the TPU. On the card the eager PyTorch arithmetic writes the score tensor
// (1.07 G f32 entries a request of 64 images at Swin-S3-B's 224 px) to
// device memory and passes over it five to six times; this kernel keeps
// each row of scores in registers.
//
// Arithmetic, as the eager code does it, in f32 throughout: q multiplied
// by the f32 scale before the product; the score a sum of 32 f32 FMAs in d
// order; + the bias gathered from the table inside the kernel; + the mask
// (-100 on every masked entry: masked entries are computed, never
// skipped, since exp(-100) is not 0 in f32); the softmax with the row max
// subtracted and accurate expf; · v in f32 FMA; the row's sum divides the
// 32 outputs (the eager code divides the N probabilities first: the same
// quotient up to f32 rounding). No TF32, no bf16, no fast-math exponent
// (nvcc runs without --use_fast_math).
//
// Bound, a request of 64 images of Swin-S3-B: 4 x 32 FLOPs for each of
// its 1.07 G scores (q kᵀ and · v), 137 GFLOP of f32 FMA, 2.05 ms at the
// H100 SXM's 67 TFLOP/s without tensor cores (700 W), above its ~3.3 GB of
// q, k, v and output (0.99 ms at 3.35 TB/s; the masks stay in L2).
// With a head only 32 wide, each score's 64 FMAs come with a gather,
// a mask read, an expf and the row reductions, and the products' operands
// are read from shared memory, which delivers 128 bytes a cycle an SM to
// its 128 FMA lanes. What the design does:
// - A pair is (window, head). A block of 8 warps stages the k and v rows
//   of as many pairs as PAIR_SMEM holds (one at N = 196, three at N = 49)
//   by 16-byte cp.async from the 128-byte head segments of each token's
//   qkv row, rows past N zero-filled, each pair's column of the bias
//   table, and each token's offset (jh (2ws - 1) + jw): the bias of (i, j)
//   is the column's entry at offset(i) - offset(j) + 2ws (ws - 1), two
//   shared reads and no read of an index. Two blocks share an SM at
//   N = 196, three at N = 49.
// - A warp takes row tiles of 8 query rows; it stages the next tile's q
//   rows by cp.async while it finishes the current one, and scales each
//   tile's q once.
// - Lane (rg, cg) of CG column lanes by 32 / CG row groups holds
//   RPL = 8 CG / 32 rows against columns cg + CG t, t < TN: a register
//   micro-tile of RPL x TN scores. Two layouts, chosen by N: 16 column
//   lanes x 13 columns (4 rows a lane) to N = 208, so each 16-byte k read
//   feeds 16 FMAs; 8 x 7 (2 rows) to N = 56, where 16 column lanes would
//   leave too many columns empty. Shared rows are 36
//   floats apart, so the 8 rows of a quarter warp's read start in 8
//   different bank groups: no bank conflict for k, v or q.
// - The row max and sum: log2(CG) shuffles each; the probabilities stay
//   in registers.
// - · v: each lane multiplies its probabilities into RPL x 32 / RPL sums
//   from its own v rows, a pass of 32 / RPL dims at a time, then the CG
//   column lanes add their sums in log2(CG) halving shuffle steps, which
//   leaves lane cg with 32 / CG consecutive dims of one row: one vector
//   store each.
// - The loops over d and over the passes stay rolled: fully unrolled, the
//   kernel measured slower (its code outgrows the instruction cache).
// Measured on an H100 SXM (PERF.md, row 13): 26-30% of the FMA bound at
// N = 196 alone, 32% over a Swin-S3-B request; the products run near what
// shared memory delivers, and the mask's reads from L2 and the bias
// gather are the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 32;       // head width
constexpr int LD = HD + 4;   // shared row stride in floats (144 bytes)
constexpr int ROWS = 8;      // query rows of a warp's tile
constexpr int WARPS = 8;     // a block
constexpr int MAX_WS = 14;   // windows of at most 14 x 14 = 196 <= 208
// shared bytes a block's pairs may take beside the q tiles and offsets:
// three pairs at N = 49 (three blocks an SM), one at N = 196 (two)
constexpr size_t PAIR_SMEM = 56 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

struct Geom {
  int pairs;     // windows x heads
  int n;         // tokens of a window, ws x ws
  int ws;
  int heads;
  int nw;        // windows of the mask (0: no mask)
  int tbl_rows;  // rows of the bias table
  int tbl_ld;    // its staged column's length, a multiple of 4
  int per_cta;   // pairs a block stages
};

// One step of the column lanes' sum: the lane whose `upper` bit is set
// keeps the upper half of a[0, 2 HALF) and sends the lower half to its
// partner, which keeps the lower; both add what they receive, into
// a[0, HALF).
template <int HALF>
__device__ __forceinline__ void halve(float* a, bool upper, int lanes) {
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    const float send = upper ? a[e] : a[HALF + e];
    const float keep = upper ? a[HALF + e] : a[e];
    a[e] = keep + __shfl_xor_sync(FULL, send, lanes);
  }
}

// The sum of a[0, 2 HALF) over the column lanes whose lane bits M, M / 2,
// .., 1 differ: lane cg ends with entries HALF / M x cg .. HALF / M x
// (cg + 1) - 1 of the sum, in a[0, HALF / M).
template <int HALF, int M>
__device__ __forceinline__ void sum_lanes(float* a, int cg) {
  halve<HALF>(a, cg & M, M);
  if constexpr (M > 1) sum_lanes<HALF / 2, M / 2>(a, cg);
}

// A warp's copy of the 8 q rows of a row tile (rows past n zero-filled),
// 2 16-byte chunks a lane; the caller commits.
__device__ __forceinline__ void stage_q(float* dst, const float* qkv,
                                        const Geom& g, int pair, int row0,
                                        int lane) {
  const int bw = pair / g.heads, h = pair - bw * g.heads;
#pragma unroll
  for (int c = lane; c < ROWS * HD / 4; c += 32) {
    const int row = c / (HD / 4), part = c % (HD / 4), tok = row0 + row;
    const bool in = tok < g.n;
    const float* src = qkv + (size_t)(bw * g.n + tok) * (3 * g.heads * HD) +
                       h * HD + part * 4;
    cp_async16(dst + row * LD + part * 4, in ? src : qkv, in ? 16 : 0);
  }
}

// CG column lanes by 32 / CG row groups: lane (rg, cg) holds RPL = 8 CG /
// 32 rows of the tile against columns cg + CG t, t < TN. Registers: at
// most 128 a thread where a lane holds more than 16 scores (two blocks an
// SM at N = 196), 80 otherwise (three blocks at N = 49).
template <int TN, int CG>
__global__ void __launch_bounds__(WARPS * 32,
                                  ROWS * CG / 32 * TN <= 16 ? 3 : 2)
window_attn_softmax_kernel(const float* __restrict__ qkv,
                           const float* __restrict__ table,
                           const float* __restrict__ mask,
                           float* __restrict__ out, Geom g, float scale) {
  constexpr int RPL = ROWS * CG / 32;  // rows a lane
  constexpr int PD = HD / RPL;         // dims of a · v pass: 32 sums a lane
  constexpr int OUT = 32 / CG;         // outputs a lane keeps of a pass
  constexpr int rows_kv = CG * TN;
  constexpr int pair_floats = 2 * rows_kv * LD;
  static_assert(rows_kv % 4 == 0, "the q tiles after the offsets align");
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  float* tbl = smem + g.per_cta * pair_floats;
  int* offs = reinterpret_cast<int*>(tbl + g.per_cta * g.tbl_ld);
  float* qbuf = reinterpret_cast<float*>(offs + rows_kv) +
                warp * 2 * ROWS * LD;
  const int first = blockIdx.x * g.per_cta;
  const int count = min(g.per_cta, g.pairs - first);

  // 1. stage k and v of each pair (rows past n zero-filled), the pair's
  // column of the bias table and each token's offset into it
  constexpr int pair_chunks = 2 * rows_kv * (HD / 4);
  for (int c = threadIdx.x; c < count * pair_chunks; c += blockDim.x) {
    const int p = c / pair_chunks, r = c - p * pair_chunks;
    const int row = r / (HD / 4), part = r % (HD / 4);
    const int m = row < rows_kv ? 1 : 2, tok = row - (m - 1) * rows_kv;
    const int pair = first + p, bw = pair / g.heads, h = pair - bw * g.heads;
    const bool in = tok < g.n;
    const float* src = qkv + (size_t)(bw * g.n + tok) * (3 * g.heads * HD) +
                       (m * g.heads + h) * HD + part * 4;
    cp_async16(smem + p * pair_floats + row * LD + part * 4, in ? src : qkv,
               in ? 16 : 0);
  }
  for (int i = threadIdx.x; i < count * g.tbl_rows; i += blockDim.x) {
    const int p = i / g.tbl_rows, r = i - p * g.tbl_rows;
    tbl[p * g.tbl_ld + r] =
        __ldg(table + (size_t)r * g.heads + (first + p) % g.heads);
  }
  for (int j = threadIdx.x; j < g.n; j += blockDim.x)
    offs[j] = j / g.ws * (2 * g.ws - 1) + j % g.ws;

  // 2. row tiles of 8 query rows, one warp each; a warp stages its next
  // tile's q rows while it finishes the current one
  const int lane = threadIdx.x & 31, rg = lane / CG, cg = lane % CG;
  const int tiles = (g.n + ROWS - 1) / ROWS;
  int buf = 0;
  if (warp < count * tiles) {
    const int p = warp / tiles;
    stage_q(qbuf, qkv, g, first + p, (warp - p * tiles) * ROWS, lane);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int tile = warp; tile < count * tiles; tile += WARPS) {
    const int p = tile / tiles, row0 = (tile - p * tiles) * ROWS;
    const int i0 = row0 + RPL * rg;
    const int pair = first + p, bw = pair / g.heads, h = pair - bw * g.heads;
    float* qw = qbuf + buf * ROWS * LD;
    const float* ks = smem + p * pair_floats;
    const float* vs = ks + rows_kv * LD;
    const float* tb = tbl + p * g.tbl_ld;
    // q x scale, once, in the lane's own staged chunks
    asm volatile("cp.async.wait_group 0;\n" ::);
#pragma unroll
    for (int c = lane; c < ROWS * HD / 4; c += 32) {
      float4* a = reinterpret_cast<float4*>(qw + c / (HD / 4) * LD +
                                            c % (HD / 4) * 4);
      float4 v = *a;
      v.x *= scale, v.y *= scale, v.z *= scale, v.w *= scale;
      *a = v;
    }
    __syncwarp();

    // scores of the lane's rows against its columns
    const float* qs = qw + RPL * rg * LD;
    float s[RPL][TN];
#pragma unroll
    for (int r = 0; r < RPL; ++r)
#pragma unroll
      for (int t = 0; t < TN; ++t) s[r][t] = 0.f;
#pragma unroll 1
    for (int d = 0; d < HD; d += 4) {
      float4 q[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r)
        q[r] = *reinterpret_cast<const float4*>(qs + r * LD + d);
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float4 k =
            *reinterpret_cast<const float4*>(ks + (cg + CG * t) * LD + d);
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          s[r][t] = fmaf(q[r].x, k.x, s[r][t]);
          s[r][t] = fmaf(q[r].y, k.y, s[r][t]);
          s[r][t] = fmaf(q[r].z, k.z, s[r][t]);
          s[r][t] = fmaf(q[r].w, k.w, s[r][t]);
        }
      }
    }
    __syncwarp();
    const int next = tile + WARPS;
    if (next < count * tiles) {
      const int np = next / tiles;
      stage_q(qbuf + (buf ^ 1) * ROWS * LD, qkv, g, first + np,
              (next - np * tiles) * ROWS, lane);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    buf ^= 1;

    // + bias, then + mask; columns past n drop out of the softmax. Rows
    // past n (stored nowhere) read row n - 1's bias and mask.
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const float* tr =
          tb + offs[min(i0 + r, g.n - 1)] + 2 * g.ws * (g.ws - 1);
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int j = cg + CG * t;
        s[r][t] = j < g.n ? s[r][t] + tr[-offs[j]] : -INFINITY;
      }
    }
    if (mask != nullptr) {
      const float* mw = mask + (size_t)(bw % g.nw) * g.n * g.n;
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const float* mr = mw + min(i0 + r, g.n - 1) * g.n;
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const int j = cg + CG * t;
          if (j < g.n) s[r][t] += __ldg(mr + j);
        }
      }
    }

    // softmax numerators: each row's max over its column lanes, expf; the
    // sum of the row this lane stores (row cg / 4 of its rows) kept
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      float m = s[r][0];
#pragma unroll
      for (int t = 1; t < TN; ++t) m = fmaxf(m, s[r][t]);
#pragma unroll
      for (int o = CG / 2; o; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        s[r][t] = expf(s[r][t] - m);
        sum += s[r][t];
      }
#pragma unroll
      for (int o = CG / 2; o; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      den = cg / 4 == r ? sum : den;
    }

    // · v, PD dims a pass: the lane's columns into RPL x PD sums, then
    // over the column lanes, which leaves lane cg with OUT consecutive
    // dims of row cg / 4 of its rows
    const int orow = i0 + cg / 4;
#pragma unroll 1
    for (int c = 0; c < HD; c += PD) {
      float acc[RPL * PD];
#pragma unroll
      for (int e = 0; e < RPL * PD; ++e) acc[e] = 0.f;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float* vr = vs + (cg + CG * t) * LD + c;
#pragma unroll
        for (int e = 0; e < PD; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(vr + e);
#pragma unroll
          for (int r = 0; r < RPL; ++r) {
            acc[r * PD + e] = fmaf(s[r][t], v.x, acc[r * PD + e]);
            acc[r * PD + e + 1] = fmaf(s[r][t], v.y, acc[r * PD + e + 1]);
            acc[r * PD + e + 2] = fmaf(s[r][t], v.z, acc[r * PD + e + 2]);
            acc[r * PD + e + 3] = fmaf(s[r][t], v.w, acc[r * PD + e + 3]);
          }
        }
      }
      sum_lanes<RPL * PD / 2, CG / 2>(acc, cg);
      if (orow < g.n) {
        float* o = out + ((size_t)(bw * g.n + orow) * g.heads + h) * HD + c +
                   OUT * (cg % 4);
        if constexpr (OUT == 4) {
          *reinterpret_cast<float4*>(o) = make_float4(
              acc[0] / den, acc[1] / den, acc[2] / den, acc[3] / den);
        } else {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[0] / den, acc[1] / den);
        }
      }
    }
  }
}

// Launches the layout of CG column lanes x TN columns (CG TN >= n), with
// as many pairs a block as PAIR_SMEM holds, at least one.
template <int TN, int CG>
int launch(const float* qkv, const float* table, const float* mask,
           float* out, Geom g, float scale, cudaStream_t stream) {
  const size_t pair_bytes = sizeof(float) * (2 * CG * TN * LD + g.tbl_ld);
  g.per_cta = (int)(PAIR_SMEM / pair_bytes > 1 ? PAIR_SMEM / pair_bytes : 1);
  const size_t smem = g.per_cta * pair_bytes + sizeof(int) * CG * TN +
                      sizeof(float) * WARPS * 2 * ROWS * LD;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_softmax_kernel<TN, CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (g.pairs + g.per_cta - 1) / g.per_cta;
  window_attn_softmax_kernel<TN, CG><<<grid, WARPS * 32, smem, stream>>>(
      qkv, table, mask, out, g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (bw, ws², 3, heads, 32) f32 contiguous, 16-byte aligned; table
// ((2ws - 1)², heads) f32; mask (nw, ws², ws²) f32 or null (nw then
// ignored), window w taking mask[w % nw]; out (bw, ws², heads * 32) f32,
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError();
// cudaErrorInvalidValue for shapes it does not take (ws > 14).
int window_attention_f32(const float* qkv, const float* table,
                         const float* mask, float* out, int bw, int ws,
                         int heads, int nw, float scale, void* stream) {
  if (bw < 0 || ws < 1 || ws > MAX_WS || heads < 1 ||
      (mask != nullptr && (nw < 1 || bw % nw != 0)) ||
      (uintptr_t)qkv % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (bw == 0) return (int)cudaSuccess;
  Geom g;
  g.pairs = bw * heads;
  g.n = ws * ws;
  g.ws = ws;
  g.heads = heads;
  g.nw = mask != nullptr ? nw : 0;
  g.tbl_rows = (2 * ws - 1) * (2 * ws - 1);
  g.tbl_ld = (g.tbl_rows + 3) / 4 * 4;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // 8 column lanes x 7 columns to N = 56, then 16 x 13 to N = 208
  if (g.n <= 56) return launch<7, 8>(qkv, table, mask, out, g, scale, st);
  return launch<13, 16>(qkv, table, mask, out, g, scale, st);
}

const char* window_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
