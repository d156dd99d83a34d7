// Fused cosine top-k for Hopper (sm_90a), in three score variants: score
// Q̂·Ĝᵀ, keep per-bin top-T buffers in shared memory, extract the exact
// top-k with ties to the lowest index, and certify it.
//
// Replaces the TPU kernels of imageretrievalresearch_tpu/ops/retrieval.py
// (all launched by fused_cosine_topk_pallas, which shares
// _stream_topk_update between them):
// - fused_topk_f32  <- _fused_topk_kernel (f32 branch): raw f32 gallery and
//   its norms; each gallery element is divided by max(norm, eps) as it is
//   stored in shared memory, then f32 FMAs.
// - fused_topk_bf16 <- _fused_topk_kernel_bf16: pre-normalized bf16 gallery
//   and bf16 q̂, no norm input; elements are loaded at 2 bytes and widened
//   to f32 as they are stored, then f32 FMAs. A bf16 x bf16 product is
//   exact in f32, so the scores are the dense bf16 path's (an f32 product
//   of the upcast operands) apart from the order of accumulation.
// - fused_topk_int8 <- _fused_topk_kernel_int8: int8 codes of q̂ and ĝ with
//   per-row scales qs (Q,1), gs (G,1); four codes per 32-bit word, __dp4a
//   into int32 (exact; zero-padded past D), then
//   s = (float)acc * (qs[q] * gs[g]) rounded as JAX orders it, so the
//   scores equal the dense int8 path's bit for bit.
// - cosine_scores_f32 <- _scores_kernel (pallas_cosine_scores): the dense
//   (Q, G) f32 cosine scores of q̂ against the raw f32 gallery, each gallery
//   tile normalized inside the kernel (below).
// - fused_topk_{f32,bf16}_{stream_only,matmul_only,insert_only} <- the
//   ablation ladder of tools/profile_fused_kernel.py (build_variants): the
//   split kernel cut after one of its phases (below).
// Plain versions and wrappers: imageretrievalresearch_tpu_torch/ops/
// retrieval.py (fused_cosine_topk, fused_cosine_topk_reference,
// fused_cosine_scores, cosine_scores_reference) and
// imageretrievalresearch_tpu_torch/tools/profile_fused_kernel.py (the
// ladder).
//
// Bounds at Q=64, G=100,000, D=1536, k=150 on the H100 SXM at 700 W
// (3.35 TB/s; 67 TFLOP/s f32 without tensor cores, 989 TFLOP/s bf16 and
// 1,979 TOP/s int8 on tensor cores), 2·Q·G·D = 19.7 G operations:
// - f32:  gallery 614 MB ~0.18 ms; 19.7 GFLOP at 67 TFLOP/s ~0.29 ms, so
//         bound by operations at ~0.29 ms;
// - bf16: gallery 307 MB ~0.092 ms; 0.020 ms on bf16 tensor cores, so
//         bound by bytes at ~0.092 ms;
// - int8: codes 154 MB ~0.046 ms; 0.010 ms on int8 tensor cores, so bound
//         by bytes at ~0.046 ms.
// The product here is SIMT (f32 FMA, or dp4a at 4 multiply-adds per
// instruction), not tensor cores, so the bf16 and int8 variants sit far
// above their byte bounds; the distance is recorded in PERF.md.
// A card with a lower power limit, or the PCIe part, has lower peaks.
//
// Design (simple first; wgmma/TMA/warp specialisation are later work):
// - One query tile of QT=64 rows covers Q=64, so the gallery streams from
//   device memory once. The grid is (query tiles x gallery splits); the
//   wrapper picks one split per SM (132 on the H100 SXM).
// - The gallery is cut into GT=64-row tiles, dealt round-robin to the
//   splits (tile t to split t mod S), so consecutive near-duplicates land
//   in different splits as well as different bins. Each block walks its
//   split's tiles in index order. Per tile it stages BK=32 words (one
//   element; int8: four codes) of each query and gallery row in shared
//   memory at a time, prefetching the next words into registers, and each
//   of 256 threads accumulates a 4x4 block of scores.
// - BINS == GT and every tile starts at a multiple of BINS, so row j of a
//   tile is bin j: the 16 (query, bin) buffers a thread folds its scores
//   into are its own, and the insertion chain needs no synchronisation.
// - Buffers: QT x BINS x T x 8 B = 192 KB of shared memory (opted in).
// - Epilogue: one warp per query row extracts k candidates by warp argmax
//   passes over the row's T*BINS entries (held in registers), and records
//   the split's deepest stored value. A second kernel merges the splits'
//   sorted candidate lists per row (k-way, in shared memory) and sets
//   ok = AND over splits of (deepest value < final k-th value).
//
// The ladder (phase P of the split kernel; FULL is the production
// instance, the three others exist to attribute its time): STREAM does
// FULL's global loads and shared-memory staging and folds every loaded
// word (and norm) into per-row f32 sums, so no load can be dropped;
// MATMUL adds the division by the norm and the product, and keeps the
// split's max score per query row; INSERT adds the insertion chain and
// writes the first k buffer lanes verbatim (no extraction, no merge).
// Each rung keeps FULL's launch geometry and shared memory, so the
// occupancy is the same; the differences of their times are the costs of
// the phases that the others do not hide.
//
// Kernel 4 (cosine_scores_f32, phase SCORES of the split kernel). Bound
// at Q=64, G=100,000, D=1536: bytes (Q·D + G·D + Q·G)·4 = 640 MB, 0.19 ms;
// 2·Q·G·D = 19.7 GFLOP of f32 FMA, 0.29 ms: bound by operations, like
// kernel 1, and by the same SIMT product. Design: one block per (64-row
// gallery tile, 64-query tile), so blocks are independent and the output
// needs no second pass; with no buffers a block needs 17 KB of shared
// memory, so two fit an SM. The block first sums the squares of its 64
// gallery rows over the whole of D (one warp per row, fmaf in lane order
// then a butterfly), keeps max(sqrt, eps) in shared memory, then runs the
// split kernel's staging and 4x4 micro-tile over the tile (the same
// division as each word is staged) and writes its (64, 64) block of scores
// straight into the (Q, G) output, masking the ragged edges: no padded
// copies. The second read of the gallery tile comes from L2. TF32 is not
// used: true f32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QT = 64;        // query rows per block
constexpr int GT = 64;        // gallery rows per tile
constexpr int BINS = GT;      // bin = global index mod BINS
constexpr int TD = 6;         // buffer depth
constexpr int BK = 32;        // words per row per staging step
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PADW = QT + 1;  // staged tile row stride (bank spread)
constexpr int LOADS = QT * BK / THREADS;  // staged words per thread
constexpr int ENTRIES = TD * BINS / 32;   // buffer entries per lane
constexpr float EPS = 1e-6f;

static_assert(QT == GT, "one staging layout serves both operands");
static_assert(QT == 64 && THREADS == 256, "4x4 micro-tile per thread");

enum Mode { F32 = 0, BF16 = 1, I8 = 2 };
// the ladder's rungs, FULL (the production kernel) and SCORES (kernel 4)
enum Phase { STREAM = 0, MATMUL = 1, INSERT = 2, FULL = 3, SCORES = 4 };

// the staged word (f32 element, bf16 element widened, or four int8 codes)
// and the accumulator of each mode
template <int M>
using Word = std::conditional_t<M == I8, int, float>;

// strict total order: value descending, then index ascending
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

constexpr size_t split_smem_bytes() {
  return (size_t)TD * QT * BINS * (sizeof(float) + sizeof(int)) +
         (size_t)2 * BK * PADW * 4 + (size_t)(GT + QT) * sizeof(float);
}

// Word w of row r of a (rows, D) operand, zero past the edges. `vec`: D is
// a multiple of 4 and the int8 base is 4-byte aligned, so four codes load
// as one int.
template <int M>
__device__ __forceinline__ Word<M> load_word(const void* base, int r,
                                             int rows, int w, int D,
                                             bool vec) {
  if constexpr (M == F32) {
    return (r < rows && w < D)
               ? static_cast<const float*>(base)[(size_t)r * D + w]
               : 0.f;
  } else if constexpr (M == BF16) {
    if (r >= rows || w >= D) return 0.f;
    const uint16_t u = static_cast<const uint16_t*>(base)[(size_t)r * D + w];
    return __uint_as_float((uint32_t)u << 16);  // exact widening
  } else {
    const int c = 4 * w;
    if (r >= rows || c >= D) return 0;
    const int8_t* row = static_cast<const int8_t*>(base) + (size_t)r * D;
    if (vec) return *reinterpret_cast<const int*>(row + c);
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (c + b < D) word |= (uint32_t)(uint8_t)row[c + b] << (8 * b);
    return (int)word;
  }
}

// gaux: f32 -> gallery norms (G,); int8 -> gallery scales (G,); bf16 -> unused.
// qscale: int8 -> query scales (Q,); otherwise unused.
// Phase P (top of file): FULL writes cand_v / cand_i (Q, nsplit, k) and
// tth (Q, nsplit); STREAM and MATMUL write one value per (query row,
// split) into tth; INSERT writes the first k buffer lanes into cand_v /
// cand_i. SCORES (kernel 4, f32 only) runs one block per (gallery tile,
// query tile), grid (tiles, query tiles) with nsplit = tiles, computes its
// tile's norms itself (gaux unused) and writes its scores into cand_v
// (Q, G); it has no buffers, so its shared memory is the staging alone.
// The production code is FULL's; every other phase only adds or leaves
// out steps under `if constexpr`, so FULL compiles as it did before the
// phases existed.
template <int M, int P>
__global__ void __launch_bounds__(THREADS, 1)
fused_topk_split_kernel(const void* __restrict__ q,
                        const void* __restrict__ g,
                        const float* __restrict__ gaux,
                        const float* __restrict__ qscale, int Q, int G,
                        int D, int k, int nsplit, bool vec,
                        float* __restrict__ cand_v,
                        int* __restrict__ cand_i, float* __restrict__ tth) {
  using W = Word<M>;
  static_assert(P == FULL || M != I8, "the ladder is built for f32, bf16");
  static_assert(P != SCORES || M == F32, "the scores kernel is f32");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bufv = reinterpret_cast<float*>(smem_raw);   // [TD][QT][BINS]
  int* bufi = reinterpret_cast<int*>(bufv + TD * QT * BINS);
  W* qs;                                                // [BK][PADW]
  if constexpr (P == SCORES)
    qs = reinterpret_cast<W*>(smem_raw);
  else
    qs = reinterpret_cast<W*>(bufi + TD * QT * BINS);
  W* gs = qs + BK * PADW;                               // [BK][PADW]
  float* gn = reinterpret_cast<float*>(gs + BK * PADW);  // [GT] norm/scale
  float* qsc = gn + GT;                                   // [QT] int8 scales

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = (P == SCORES ? blockIdx.y : blockIdx.x) * QT;
  const int split = P == SCORES ? blockIdx.x : blockIdx.y;

  if constexpr (P == INSERT || P == FULL) {
    for (int e = tid; e < TD * QT * BINS; e += THREADS) {
      bufv[e] = -CUDART_INF_F;
      bufi[e] = 0;
    }
  }
  if constexpr (M == I8)
    if (tid < QT) qsc[tid] = q0 + tid < Q ? qscale[q0 + tid] : 0.f;

  // STREAM: per tile row (tid / 32 + 8p), the words this thread loads, and
  // for thread tid < GT the norms of tile row tid. MATMUL: the max score
  // of each of the thread's four query rows.
  [[maybe_unused]] float rowsum[LOADS], normsum = 0.f, rowmax[4];
  if constexpr (P == STREAM) {
#pragma unroll
    for (int p = 0; p < LOADS; ++p) rowsum[p] = 0.f;
  }
  if constexpr (P == MATMUL) {
#pragma unroll
    for (int i = 0; i < 4; ++i) rowmax[i] = -CUDART_INF_F;
  }

  const int words = M == I8 ? (D + 3) / 4 : D;
  const int nsteps = (words + BK - 1) / BK;
  for (long long tb = (long long)split * GT; tb < G;
       tb += (long long)nsplit * GT) {
    const int base = (int)tb;
    __syncthreads();  // the previous tile is done with gn
    if constexpr (P == SCORES) {
      // the tile's norms: one warp per row, fmaf in lane order, butterfly
      const int w = tid / 32, l = tid % 32;
      for (int r = w; r < GT; r += WARPS) {
        float ss = 0.f;
        if (base + r < G) {
          const float* row = static_cast<const float*>(g) +
                             (size_t)(base + r) * D;
          for (int c = l; c < D; c += 32) ss = fmaf(row[c], row[c], ss);
        }
#pragma unroll
        for (int off = 16; off; off >>= 1)
          ss += __shfl_xor_sync(0xffffffffu, ss, off);
        if (l == 0) gn[r] = base + r < G ? fmaxf(__fsqrt_rn(ss), EPS) : 1.f;
      }
    } else if constexpr (M != BF16) {
      if (tid < GT) {
        const int r = base + tid;
        const float x = r < G ? gaux[r] : 1.f;
        gn[tid] = M == F32 ? fmaxf(x, EPS) : x;
        if constexpr (P == STREAM) normsum += r < G ? x : 0.f;
      }
    }

    W acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = W(0);

    W qreg[LOADS], greg[LOADS];
    // word e = tid + THREADS*p of the (64 x BK) staging tile: row e / BK,
    // column e % BK, so a warp reads 32 consecutive words of one row
#pragma unroll
    for (int p = 0; p < LOADS; ++p) {
      const int e = tid + THREADS * p, r = e / BK, c = e % BK;
      qreg[p] = load_word<M>(q, q0 + r, Q, c, D, vec);
      greg[p] = load_word<M>(g, base + r, G, c, D, vec);
    }

    for (int s = 0; s < nsteps; ++s) {
      __syncthreads();  // the previous step is done with qs/gs
#pragma unroll
      for (int p = 0; p < LOADS; ++p) {
        const int e = tid + THREADS * p, r = e / BK, c = e % BK;
        qs[c * PADW + r] = qreg[p];
        if constexpr (M == F32 && P != STREAM)
          gs[c * PADW + r] = __fdiv_rn(greg[p], gn[r]);
        else
          gs[c * PADW + r] = greg[p];
        if constexpr (P == STREAM) {
          rowsum[p] += qreg[p];
          rowsum[p] += greg[p];
        }
      }
      __syncthreads();
      if (s + 1 < nsteps) {
        const int w0 = (s + 1) * BK;
#pragma unroll
        for (int p = 0; p < LOADS; ++p) {
          const int e = tid + THREADS * p, r = e / BK, c = w0 + e % BK;
          qreg[p] = load_word<M>(q, q0 + r, Q, c, D, vec);
          greg[p] = load_word<M>(g, base + r, G, c, D, vec);
        }
      }
      if constexpr (P != STREAM) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          W a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qs[kk * PADW + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = gs[kk * PADW + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if constexpr (M == I8)
                acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
              else
                acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
        }
      }
    }

    if constexpr (P == MATMUL) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (base + tx + 16 * j < G) rowmax[i] = fmaxf(rowmax[i], acc[i][j]);
    }
    if constexpr (P == SCORES) {
      // the (Q, G) scores, ragged edges masked
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qg = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gc = base + tx + 16 * j;
          if (qg < Q && gc < G) cand_v[(size_t)qg * G + gc] = acc[i][j];
        }
      }
    }
    if constexpr (P == INSERT || P == FULL) {
      // insertion chain: the new value sinks below stored values >= it
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = ty + 16 * i, bin = tx + 16 * j, idx = base + bin;
          float v;
          if constexpr (M == I8)
            v = __fmul_rn(__int2float_rn(acc[i][j]),
                          __fmul_rn(qsc[ql], gn[bin]));
          else
            v = acc[i][j];
          if (idx >= G) v = -CUDART_INF_F;
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
  }
  if constexpr (P == SCORES) return;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if constexpr (P == STREAM) {
    // tile row warp + 8p: its words were loaded by the 32 lanes of `warp`
    float* srow = bufv;  // [QT]; the buffers are unused in this phase
#pragma unroll
    for (int p = 0; p < LOADS; ++p) {
      float v = rowsum[p];
#pragma unroll
      for (int off = 16; off; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) srow[warp + 8 * p] = v;
    }
    __syncthreads();
    if (tid < QT && q0 + tid < Q)
      tth[(size_t)(q0 + tid) * nsplit + split] = srow[tid] + normsum;
  } else if constexpr (P == MATMUL) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = rowmax[i];
#pragma unroll
      for (int off = 8; off; off >>= 1)  // over the 16 lanes of one ty
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int qg = q0 + ty + 16 * i;
      if (tx == 0 && qg < Q) tth[(size_t)qg * nsplit + split] = m;
    }
  } else if constexpr (P == INSERT) {
    // extraction ablated: the first k buffer lanes (depth slot t, bin b of
    // lane t * BINS + b), verbatim
    for (int ql = warp; ql < QT; ql += WARPS) {
      const int qg = q0 + ql;
      if (qg >= Q) break;  // warp-uniform
      const size_t out = ((size_t)qg * nsplit + split) * k;
      for (int n = lane; n < k; n += 32) {
        const int a = ((n / BINS) * QT + ql) * BINS + n % BINS;
        cand_v[out + n] = bufv[a];
        cand_i[out + n] = bufi[a];
      }
    }
  } else {
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

bool bad_geometry(int Q, int G, int D, int k, int nsplit) {
  return k < 1 || k > TD * BINS || Q < 1 || G < 1 || D < 1 || nsplit < 1 ||
         nsplit > (G + GT - 1) / GT;
}

// Launches phase P of the split kernel of mode M on `stream`, one block per
// (query tile, split) with all of its shared memory; returns
// cudaGetLastError() (0 = ok).
template <int M, int P>
cudaError_t launch_split(const void* q, const void* g, const float* gaux,
                         const float* qscale, int Q, int G, int D, int k,
                         int nsplit, float* cand_v, int* cand_i, float* tth,
                         cudaStream_t st) {
  const bool vec = D % 4 == 0 && (uintptr_t)q % 4 == 0 &&
                   (uintptr_t)g % 4 == 0;
  const size_t smem1 = split_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_split_kernel<M, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  dim3 grid1((Q + QT - 1) / QT, nsplit);
  fused_topk_split_kernel<M, P><<<grid1, THREADS, smem1, st>>>(
      q, g, gaux, qscale, Q, G, D, k, nsplit, vec, cand_v, cand_i, tth);
  return cudaGetLastError();
}

// Launches the split kernel of mode M and the merge kernel on `stream`;
// returns cudaGetLastError() (0 = ok).
template <int M>
int launch(const void* q, const void* g, const float* gaux,
           const float* qscale, int Q, int G, int D, int k, int nsplit,
           int bins, int t_depth, float* cand_v, int* cand_i, float* tth,
           float* vals, int* inds, int* ok, void* stream) {
  if (bins != BINS || t_depth != TD || bad_geometry(Q, G, D, k, nsplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split<M, FULL>(q, g, gaux, qscale, Q, G, D, k,
                                          nsplit, cand_v, cand_i, tth, st);
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

// One rung of the ladder: phase P alone (no merge). out_v is (Q, nsplit)
// for STREAM and MATMUL; (Q, nsplit, k) with out_i for INSERT.
template <int M, int P>
int launch_rung(const void* q, const void* g, const float* gaux, int Q,
                int G, int D, int k, int nsplit, float* out_v, int* out_i,
                void* stream) {
  if (bad_geometry(Q, G, D, k, nsplit)) return (int)cudaErrorInvalidValue;
  return (int)launch_split<M, P>(q, g, gaux, nullptr, Q, G, D, k, nsplit,
                                 out_v, out_i, out_v,
                                 reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Each entry launches both kernels on `stream` and returns
// cudaGetLastError() (0 = ok). Scratch: cand_v/cand_i (Q, nsplit, k),
// tth (Q, nsplit). Outputs: vals, inds (Q, k), ok (Q,).
// 1 <= nsplit <= number of 64-row gallery tiles.

// q̂ (Q, D) f32, raw gallery (G, D) f32 and its row norms (G,).
int fused_topk_f32(const float* q, const float* g, const float* gnorm,
                   int Q, int G, int D, int k, int nsplit, int bins,
                   int t_depth, float* cand_v, int* cand_i, float* tth,
                   float* vals, int* inds, int* ok, void* stream) {
  return launch<F32>(q, g, gnorm, nullptr, Q, G, D, k, nsplit, bins,
                     t_depth, cand_v, cand_i, tth, vals, inds, ok, stream);
}

// q̂ (Q, D) bf16, pre-normalized gallery (G, D) bf16.
int fused_topk_bf16(const void* q, const void* g, int Q, int G, int D,
                    int k, int nsplit, int bins, int t_depth, float* cand_v,
                    int* cand_i, float* tth, float* vals, int* inds, int* ok,
                    void* stream) {
  return launch<BF16>(q, g, nullptr, nullptr, Q, G, D, k, nsplit, bins,
                      t_depth, cand_v, cand_i, tth, vals, inds, ok, stream);
}

// int8 codes of q̂ (Q, D) and of the gallery (G, D), scales qs (Q,),
// gs (G,) f32.
int fused_topk_int8(const void* q, const void* g, const float* qscale,
                    const float* gscale, int Q, int G, int D, int k,
                    int nsplit, int bins, int t_depth, float* cand_v,
                    int* cand_i, float* tth, float* vals, int* inds, int* ok,
                    void* stream) {
  return launch<I8>(q, g, gscale, qscale, Q, G, D, k, nsplit, bins, t_depth,
                    cand_v, cand_i, tth, vals, inds, ok, stream);
}

// The ladder: q̂ (Q, D) f32 with the raw gallery (G, D) f32 and its row
// norms (G,), or q̂ and the pre-normalized gallery in bf16 (gnorm unused).
#define LADDER_RUNG(name, M, P)                                            \
  int name(const void* q, const void* g, const float* gnorm, int Q, int G, \
           int D, int k, int nsplit, float* out_v, int* out_i,            \
           void* stream) {                                                \
    return launch_rung<M, P>(q, g, gnorm, Q, G, D, k, nsplit, out_v, out_i, \
                             stream);                                     \
  }
LADDER_RUNG(fused_topk_f32_stream_only, F32, STREAM)
LADDER_RUNG(fused_topk_f32_matmul_only, F32, MATMUL)
LADDER_RUNG(fused_topk_f32_insert_only, F32, INSERT)
LADDER_RUNG(fused_topk_bf16_stream_only, BF16, STREAM)
LADDER_RUNG(fused_topk_bf16_matmul_only, BF16, MATMUL)
LADDER_RUNG(fused_topk_bf16_insert_only, BF16, INSERT)
#undef LADDER_RUNG

// Kernel 4: the (Q, G) f32 cosine scores of q̂ (Q, D) against the raw
// gallery (G, D), both f32, into out; returns cudaGetLastError().
int cosine_scores_f32(const float* q, const float* g, int Q, int G, int D,
                      float* out, void* stream) {
  if (Q < 1 || G < 1 || D < 1 || (Q + QT - 1) / QT > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (G + GT - 1) / GT;
  const size_t smem = (size_t)2 * BK * PADW * 4 + (size_t)(GT + QT) * 4;
  fused_topk_split_kernel<F32, SCORES>
      <<<dim3(tiles, (Q + QT - 1) / QT), THREADS, smem,
         reinterpret_cast<cudaStream_t>(stream)>>>(
          q, g, nullptr, nullptr, Q, G, D, 0, tiles, false, out, nullptr,
          nullptr);
  return (int)cudaGetLastError();
}

const char* fused_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
