// Fused cosine top-k for Hopper (sm_90a): normalize the gallery in the
// kernel, score Q̂·Ĝᵀ in f32, keep per-bin top-T buffers in shared memory,
// extract the exact top-k with ties to the lowest index, and certify it.
//
// Replaces the TPU kernel imageretrievalresearch_tpu/ops/retrieval.py
// _fused_topk_kernel + _stream_topk_update (launched by
// fused_cosine_topk_pallas, f32 branch). Plain version and wrapper:
// imageretrievalresearch_tpu_torch/ops/retrieval.py (fused_cosine_topk,
// fused_cosine_topk_reference).
//
// Bound at Q=64, G=100,000, D=1536, k=150, f32: the gallery is 614 MB
// (~0.18 ms at 3.35 TB/s) and the product is 2·Q·G·D = 19.7 GFLOP (~0.29 ms
// at the H100 SXM's 67 TFLOP/s of non-tensor-core f32). So the kernel is
// bound by f32 operations at ~0.29 ms; a card with a lower power limit or
// the PCIe part has a lower peak.
//
// Design for that bound (simple first; wgmma/TMA/warp specialisation are
// later work):
// - One query tile of QT=64 rows covers Q=64, so the gallery streams from
//   device memory once. The grid is (query tiles x gallery splits); the
//   wrapper picks one split per SM (132 on the H100 SXM).
// - The gallery is cut into GT=64-row tiles, dealt round-robin to the
//   splits (tile t to split t mod S), so consecutive near-duplicates land
//   in different splits as well as different bins. Each block walks its
//   split's tiles in index order. Per tile it stages BK=32
//   columns of queries and of gallery rows in shared memory at a time (the
//   gallery element divided by max(norm, eps) as it is stored, the dense
//   path's order), prefetching the next columns into registers, and each of
//   256 threads accumulates a 4x4 block of scores with f32 FMAs.
// - BINS == GT and every tile starts at a multiple of BINS, so row j of a
//   tile is bin j: the 16 (query, bin) buffers a thread folds its scores
//   into are its own, and the insertion chain needs no synchronisation.
// - Buffers: QT x BINS x T x 8 B = 192 KB of shared memory (opted in).
// - Epilogue: one warp per query row extracts k candidates by warp argmax
//   passes over the row's T*BINS entries (held in registers), and records
//   the split's deepest stored value. A second kernel merges the splits'
//   sorted candidate lists per row (k-way, in shared memory) and sets
//   ok = AND over splits of (deepest value < final k-th value).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;        // query rows per block
constexpr int GT = 64;        // gallery rows per tile
constexpr int BINS = GT;      // bin = global index mod BINS
constexpr int TD = 6;         // buffer depth
constexpr int BK = 32;        // columns per staging step
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PADW = QT + 1;  // staged tile row stride (bank spread)
constexpr int LOADS = QT * BK / THREADS;  // staged elements per thread
constexpr int ENTRIES = TD * BINS / 32;   // buffer entries per lane
constexpr float EPS = 1e-6f;

static_assert(QT == GT, "one staging layout serves both operands");
static_assert(QT == 64 && THREADS == 256, "4x4 micro-tile per thread");

// strict total order: value descending, then index ascending
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

constexpr size_t split_smem_bytes() {
  return (size_t)TD * QT * BINS * (sizeof(float) + sizeof(int)) +
         (size_t)2 * BK * PADW * sizeof(float) + (size_t)GT * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_topk_split_kernel(const float* __restrict__ q,
                        const float* __restrict__ g,
                        const float* __restrict__ gnorm,
                        int Q, int G, int D, int k, int nsplit,
                        float* __restrict__ cand_v,
                        int* __restrict__ cand_i, float* __restrict__ tth) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bufv = reinterpret_cast<float*>(smem_raw);   // [TD][QT][BINS]
  int* bufi = reinterpret_cast<int*>(bufv + TD * QT * BINS);
  float* qs = reinterpret_cast<float*>(bufi + TD * QT * BINS);  // [BK][PADW]
  float* gs = qs + BK * PADW;                                   // [BK][PADW]
  float* gn = gs + BK * PADW;                                   // [GT]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;

  for (int e = tid; e < TD * QT * BINS; e += THREADS) {
    bufv[e] = -CUDART_INF_F;
    bufi[e] = 0;
  }

  const int nsteps = (D + BK - 1) / BK;
  for (long long tb = (long long)split * GT; tb < G;
       tb += (long long)nsplit * GT) {
    const int base = (int)tb;
    __syncthreads();  // the previous tile is done with gn
    if (tid < GT) {
      const int r = base + tid;
      gn[tid] = fmaxf(r < G ? gnorm[r] : 1.f, EPS);
    }

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    float qreg[LOADS], greg[LOADS];
    // element e = tid + THREADS*p of the (64 x BK) staging tile: row e / BK,
    // column e % BK, so a warp reads 32 consecutive floats of one row
#pragma unroll
    for (int p = 0; p < LOADS; ++p) {
      const int e = tid + THREADS * p, r = e / BK, c = e % BK;
      const bool cin = c < D;
      qreg[p] = (q0 + r < Q && cin) ? q[(size_t)(q0 + r) * D + c] : 0.f;
      greg[p] = (base + r < G && cin) ? g[(size_t)(base + r) * D + c] : 0.f;
    }

    for (int s = 0; s < nsteps; ++s) {
      __syncthreads();  // the previous step is done with qs/gs
#pragma unroll
      for (int p = 0; p < LOADS; ++p) {
        const int e = tid + THREADS * p, r = e / BK, c = e % BK;
        qs[c * PADW + r] = qreg[p];
        gs[c * PADW + r] = __fdiv_rn(greg[p], gn[r]);
      }
      __syncthreads();
      if (s + 1 < nsteps) {
        const int k0 = (s + 1) * BK;
#pragma unroll
        for (int p = 0; p < LOADS; ++p) {
          const int e = tid + THREADS * p, r = e / BK, c = k0 + e % BK;
          const bool cin = c < D;
          qreg[p] = (q0 + r < Q && cin) ? q[(size_t)(q0 + r) * D + c] : 0.f;
          greg[p] =
              (base + r < G && cin) ? g[(size_t)(base + r) * D + c] : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[kk * PADW + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = gs[kk * PADW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // insertion chain: the new value sinks below stored values >= it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = ty + 16 * i, bin = tx + 16 * j, idx = base + bin;
        float v = idx < G ? acc[i][j] : -CUDART_INF_F;
        int vi = idx;
#pragma unroll
        for (int t = 0; t < TD; ++t) {
          const int a = (t * QT + ql) * BINS + bin;
          const float ov = bufv[a];
          const int oi = bufi[a];
          if (v > ov) {
            bufv[a] = v;
            bufi[a] = vi;
            v = ov;
            vi = oi;
          }
        }
      }
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int ql = warp; ql < QT; ql += WARPS) {
    const int qg = q0 + ql;
    if (qg >= Q) break;  // warp-uniform
    float deepest = -CUDART_INF_F;
    for (int b = lane; b < BINS; b += 32)
      deepest = fmaxf(deepest, bufv[((TD - 1) * QT + ql) * BINS + b]);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      deepest = fmaxf(deepest, __shfl_xor_sync(0xffffffffu, deepest, off));

    float v[ENTRIES];
    int ix[ENTRIES];
#pragma unroll
    for (int e = 0; e < ENTRIES; ++e) {
      const int slot = lane + 32 * e, t = slot / BINS, b = slot % BINS;
      v[e] = bufv[(t * QT + ql) * BINS + b];
      ix[e] = bufi[(t * QT + ql) * BINS + b];
    }
    const size_t out = ((size_t)qg * nsplit + split) * k;
    for (int n = 0; n < k; ++n) {
      float bv = v[0];
      int bi = ix[0];
#pragma unroll
      for (int e = 1; e < ENTRIES; ++e)
        if (better(v[e], ix[e], bv, bi)) {
          bv = v[e];
          bi = ix[e];
        }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      // removed entries become -inf and keep their index (as on the TPU)
#pragma unroll
      for (int e = 0; e < ENTRIES; ++e)
        if (v[e] == bv && ix[e] == bi) v[e] = -CUDART_INF_F;
      if (lane == 0) {
        cand_v[out + n] = bv;
        cand_i[out + n] = bi;
      }
    }
    if (lane == 0) tth[(size_t)qg * nsplit + split] = deepest;
  }
}

// One warp per query row: k-way merge of the splits' sorted candidate
// lists (staged in shared memory), then the certificate.
__global__ void __launch_bounds__(32)
fused_topk_merge_kernel(const float* __restrict__ cand_v,
                        const int* __restrict__ cand_i,
                        const float* __restrict__ tth, int k, int nsplit,
                        float* __restrict__ vals, int* __restrict__ inds,
                        int* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_cand = nsplit * k;
  float* cv = reinterpret_cast<float*>(smem_raw);
  int* ci = reinterpret_cast<int*>(cv + n_cand);
  int* ptr = ci + n_cand;

  const int qg = blockIdx.x, lane = threadIdx.x;
  const size_t off = (size_t)qg * n_cand;
  for (int e = lane; e < n_cand; e += 32) {
    cv[e] = cand_v[off + e];
    ci[e] = cand_i[off + e];
  }
  for (int s = lane; s < nsplit; s += 32) ptr[s] = 0;
  __syncwarp();

  float last = -CUDART_INF_F;
  for (int n = 0; n < k; ++n) {
    float bv = -CUDART_INF_F;
    int bi = 0, bs = -1;
    for (int s = lane; s < nsplit; s += 32) {
      const int p = ptr[s];
      if (p < k) {
        const float v = cv[s * k + p];
        const int i = ci[s * k + p];
        if (bs < 0 || better(v, i, bv, bi)) {
          bv = v;
          bi = i;
          bs = s;
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const int os = __shfl_xor_sync(0xffffffffu, bs, o);
      const bool take =
          os >= 0 && (bs < 0 || better(ov, oi, bv, bi) ||
                      (ov == bv && oi == bi && os < bs));
      if (take) {
        bv = ov;
        bi = oi;
        bs = os;
      }
    }
    if (lane == 0) {
      ptr[bs] += 1;
      vals[(size_t)qg * k + n] = bv;
      inds[(size_t)qg * k + n] = bi;
    }
    __syncwarp();
    last = bv;
  }
  int good = 1;
  for (int s = lane; s < nsplit; s += 32)
    good &= tth[(size_t)qg * nsplit + s] < last;
  good = __all_sync(0xffffffffu, good);
  if (lane == 0) ok[qg] = good;
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// Scratch: cand_v/cand_i (Q, nsplit, k), tth (Q, nsplit). Outputs: vals,
// inds (Q, k), ok (Q,). 1 <= nsplit <= number of 64-row gallery tiles.
int fused_topk_f32(const float* q, const float* g, const float* gnorm,
                   int Q, int G, int D, int k, int nsplit,
                   int bins, int t_depth, float* cand_v, int* cand_i,
                   float* tth, float* vals, int* inds, int* ok,
                   void* stream) {
  if (bins != BINS || t_depth != TD || k < 1 || k > TD * BINS || Q < 1 ||
      G < 1 || D < 1 || nsplit < 1 || nsplit > (G + GT - 1) / GT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem1 = split_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((Q + QT - 1) / QT, nsplit);
  fused_topk_split_kernel<<<grid1, THREADS, smem1, st>>>(
      q, g, gnorm, Q, G, D, k, nsplit, cand_v, cand_i, tth);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)nsplit * k * (sizeof(float) + sizeof(int)) +
                       (size_t)nsplit * sizeof(int);
  err = cudaFuncSetAttribute(fused_topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  fused_topk_merge_kernel<<<Q, 32, smem2, st>>>(cand_v, cand_i, tth, k,
                                                nsplit, vals, inds, ok);
  return (int)cudaGetLastError();
}

const char* fused_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
