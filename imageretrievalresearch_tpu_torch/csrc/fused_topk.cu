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
//   and bf16 q̂, no norm input; the BF16 instance of the tensor-core kernel
//   (fused_topk_tc_kernel, then fused_topk_select_merge_kernel, below). A
//   bf16 x bf16 product is exact in f32, so its tensor-core scores are the
//   dense bf16 path's (an f32 product of the upcast operands) apart from
//   the order of accumulation.
// - fused_topk_int8 <- _fused_topk_kernel_int8: f32 q̂, quantized first by
//   quantize_rows_int8_kernel (one launch, bitwise quantize_rows_int8), and
//   the int8 codes of ĝ with per-row scales gs (G,); the I8 instance of
//   the same kernel: an exact int32 dot on int8 tensor cores (zero-padded
//   past D), then s = (float)acc * (qs[q] * gs[g]) rounded as JAX orders
//   it, so the scores equal the dense int8 path's bit for bit.
// - cosine_scores_f32 <- _scores_kernel (pallas_cosine_scores): the dense
//   (Q, G) f32 cosine scores of q̂ against the raw f32 gallery, each gallery
//   tile normalized inside the kernel (below).
// - fused_topk_{f32,bf16}_{stream_only,matmul_only,insert_only} <- the
//   ablation ladder of tools/profile_fused_kernel.py (build_variants): the
//   f32 or the bf16 split kernel cut after one of its phases (below); the
//   fused_topk_int8_* rungs are the port's own (JAX has no int8 ladder).
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
// The f32 product here is SIMT (f32 FMA), not tensor cores; bf16 and int8
// run on tensor cores. A card with a lower power limit, or the PCIe part,
// has lower peaks.
//
// Design of the f32 kernel (fused_topk_split_kernel; simple first: vector
// loads, tensor cores and a cheaper extraction are later work for it, as
// the tensor-core kernel below has them):
// - One query tile of QT=64 rows covers Q=64, so the gallery streams from
//   device memory once. The grid is (query tiles x gallery splits); the
//   wrapper picks one split per SM (132 on the H100 SXM).
// - The gallery is cut into GT=64-row tiles, dealt round-robin to the
//   splits (tile t to split t mod S), so consecutive near-duplicates land
//   in different splits as well as different bins. Each block walks its
//   split's tiles in index order. Per tile it stages BK=32 elements of
//   each query and gallery row in shared memory at a time, prefetching the
//   next ones into registers, and each of 256 threads accumulates a 4x4
//   block of scores.
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
// The ladder (phase P of the f32 split kernel and of the tensor-core
// kernel; FULL is the production instance, the three others exist to
// attribute its time): STREAM does FULL's global loads and shared-memory
// staging and folds every loaded word (and norm) into per-row sums (f32;
// int8 codes exactly in int32), so no load can be dropped;
// MATMUL adds the division by the norm (f32) or the rescale (int8) and the
// product, and keeps the split's max score per query row; INSERT adds the
// insertion chain and writes the first k buffer lanes verbatim (no
// extraction, no merge).
// Each rung keeps FULL's launch geometry and shared memory, so the
// occupancy is the same; the differences of their times are the costs of
// the phases that the others do not hide.
//
// Kernels 2 and 3, the tensor-core kernel (fused_topk_tc_kernel<M, P>,
// score stage M = BF16 or I8, + the selection merge), designed for the
// card. Bound by bytes (bf16: 0.092 ms for the 307 MB gallery; int8:
// 0.046 ms for 154 MB of codes); what holds a streaming kernel back on an
// SM is the bytes it keeps in flight (~25-30 KB of gallery at 3.35 TB/s
// over 132 SMs), and the shared memory the buffers leave for that. The
// design:
// - The same contract and geometry as the f32 kernel: 64 bins, depth 6,
//   fused_splits splits with tiles dealt round-robin, one query tile of 64
//   rows per block, the insertion chain in index order.
// - Buffers: f32 values and, in place of 32-bit indices, 16-bit tile
//   ordinals within the split (index = (ordinal x nsplit + split) x 64 +
//   bin; an empty slot, value -inf, decodes to index 0), so 144 KB, not
//   192. The launcher refuses more than 65,536 tiles per split.
// - The freed shared memory holds a ring of 5 stages (as many as the 144
//   KB of buffers leave room for), each 128 bytes of 64 rows of q̂ and of
//   the gallery (16 KB: a 64 x 64 bf16 tile, or 64 x 128 int8 codes). A
//   producer warp fills it: per stage one thread issues two TMA box copies
//   (the tensor maps' 128-byte swizzle, zeros past Q, G and D) that
//   complete on the stage's mbarrier; a row that is not a whole number of
//   16-byte chunks (D % 8 bf16, D % 16 int8) takes the warp's masked loads
//   into the same layout. The 8 consumer warps wait on a stage's "full"
//   mbarrier and release it on its "empty" one, with no block-wide barrier
//   per stage, so the producer keeps up to 5 stages (40 KB of gallery) in
//   flight while the consumers compute.
// - The product runs on tensor cores, fed by ldmatrix from rows swizzled
//   by 16-byte chunk (chunk c of row r at c ^ (r % 8)): mma.sync m16n8k16
//   bf16 with f32 accumulators, or m16n8k32 s8 with exact s32
//   accumulators, whose fragments hold the same bytes, so one set of
//   ldmatrix addresses feeds both. Each of 8 warps owns 16 query rows x 32
//   bins, two accumulator sets (even and odd 32-byte steps) halve the
//   dependent chains. int8 rescales each score before its insertion, with
//   the query scales read once and the tile's gallery scales read at its
//   first stage, from device memory. The mma fragment gives every (query,
//   bin) pair to exactly one thread, for every tile, so the insertion
//   chain needs no synchronisation, as before.
// - A tile's 8 score pairs per thread are inserted one pair per step of
//   the next tile (the chain reads its 6 slots at once and runs in
//   registers), so the insertion does not stall the ring.
// - Extraction: one warp per query row holds its 384 entries as order-
//   preserving 32-bit keys, finds the k-th key bit by bit (32 warp counts,
//   __reduce_add_sync), breaks a tie at it by the lowest indices (31 more
//   counts, only when needed) and writes the split's top-k set unsorted.
//   The selection merge kernel does the same over the nsplit x k
//   candidates of a row (one block, the candidates in registers), places
//   each selected entry by its rank in (value desc, index asc), and sets
//   ok = AND over splits of (deepest stored < final k-th value). The
//   output equals the k argmax passes' (any exact method does), including
//   the (-inf, 0) filler of a row with fewer than k finite entries.
// - The host's part: a call of one C entry point launches every kernel of
//   the variant (int8: the query quantization, the split kernel, the
//   merge) into one workspace that the wrapper allocates once (Work,
//   below), so a call costs the host one allocation and one ctypes call,
//   not an eager quantization, six allocations and a device switch.
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

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

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

// the score stage of the tensor-core kernel (kernels 2 and 3)
enum Mode { BF16 = 1, I8 = 2 };
// the ladder's rungs, FULL (the production kernel) and SCORES (kernel 4)
enum Phase { STREAM = 0, MATMUL = 1, INSERT = 2, FULL = 3, SCORES = 4 };

// strict total order: value descending, then index ascending
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

constexpr size_t split_smem_bytes() {
  return (size_t)TD * QT * BINS * (sizeof(float) + sizeof(int)) +
         (size_t)2 * BK * PADW * 4 + (size_t)GT * sizeof(float);
}

// Element w of row r of a (rows, D) f32 operand, zero past the edges.
__device__ __forceinline__ float load_word(const void* base, int r, int rows,
                                           int w, int D) {
  return (r < rows && w < D)
             ? static_cast<const float*>(base)[(size_t)r * D + w]
             : 0.f;
}

// gaux: the gallery norms (G,). qscale and vec are unused: they held the
// int8 instance's query scales and word loads, which kernel 3's tensor-core
// kernel has taken over, and stay so that the f32 instances keep their
// parameter layout (and their SASS).
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
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
fused_topk_split_kernel(const void* __restrict__ q,
                        const void* __restrict__ g,
                        const float* __restrict__ gaux,
                        const float* __restrict__ qscale, int Q, int G,
                        int D, int k, int nsplit, bool vec,
                        float* __restrict__ cand_v,
                        int* __restrict__ cand_i, float* __restrict__ tth) {
  using W = float;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bufv = reinterpret_cast<float*>(smem_raw);   // [TD][QT][BINS]
  int* bufi = reinterpret_cast<int*>(bufv + TD * QT * BINS);
  W* qs;                                                // [BK][PADW]
  if constexpr (P == SCORES)
    qs = reinterpret_cast<W*>(smem_raw);
  else
    qs = reinterpret_cast<W*>(bufi + TD * QT * BINS);
  W* gs = qs + BK * PADW;                               // [BK][PADW]
  float* gn = reinterpret_cast<float*>(gs + BK * PADW);  // [GT] norms

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

  const int nsteps = (D + BK - 1) / BK;
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
    } else {
      if (tid < GT) {
        const int r = base + tid;
        const float x = r < G ? gaux[r] : 1.f;
        gn[tid] = fmaxf(x, EPS);
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
      qreg[p] = load_word(q, q0 + r, Q, c, D);
      greg[p] = load_word(g, base + r, G, c, D);
    }

    for (int s = 0; s < nsteps; ++s) {
      __syncthreads();  // the previous step is done with qs/gs
#pragma unroll
      for (int p = 0; p < LOADS; ++p) {
        const int e = tid + THREADS * p, r = e / BK, c = e % BK;
        qs[c * PADW + r] = qreg[p];
        if constexpr (P != STREAM)
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
          qreg[p] = load_word(q, q0 + r, Q, c, D);
          greg[p] = load_word(g, base + r, G, c, D);
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
          float v = acc[i][j];
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

// Launches phase P of the f32 split kernel on `stream`, one block per
// (query tile, split) with all of its shared memory; returns
// cudaGetLastError() (0 = ok).
template <int P>
cudaError_t launch_split(const void* q, const void* g, const float* gaux,
                         int Q, int G, int D, int k, int nsplit,
                         float* cand_v, int* cand_i, float* tth,
                         cudaStream_t st) {
  const size_t smem1 = split_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_split_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return err;
  dim3 grid1((Q + QT - 1) / QT, nsplit);
  fused_topk_split_kernel<P><<<grid1, THREADS, smem1, st>>>(
      q, g, gaux, nullptr, Q, G, D, k, nsplit, false, cand_v, cand_i, tth);
  return cudaGetLastError();
}

// One rung of the f32 ladder: phase P alone (no merge). out_v is (Q, nsplit)
// for STREAM and MATMUL; (Q, nsplit, k) with out_i for INSERT.
template <int P>
int launch_rung(const void* q, const void* g, const float* gaux, int Q,
                int G, int D, int k, int nsplit, float* out_v, int* out_i,
                void* stream) {
  if (bad_geometry(Q, G, D, k, nsplit)) return (int)cudaErrorInvalidValue;
  return (int)launch_split<P>(q, g, gaux, Q, G, D, k, nsplit, out_v, out_i,
                              out_v, reinterpret_cast<cudaStream_t>(stream));
}


// ---------------------------------------------------------------------------
// Kernels 2 and 3: the tensor-core split kernel (bf16 or int8) and its
// selection merge (top of file)
// ---------------------------------------------------------------------------

constexpr int KC = 64;                        // bf16 elements per row per stage
constexpr int KC_I8 = 128;                    // int8 codes per row per stage
constexpr int STAGES = 5;                     // ring depth
constexpr int TILE_BYTES = QT * KC * 2;       // one operand's tile, 8 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // q̂ tile, then gallery tile
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int BUF = TD * QT * BINS;           // buffer entries
constexpr int DS = QT * BINS / 2;             // depth stride in entry pairs
constexpr int TC_THREADS = THREADS + 32;  // 8 consumer warps, 1 producer
// slack to align the ring to 1024 B (the 128-byte swizzle's period), the
// ring, the buffers, then a full and an empty mbarrier per stage
constexpr size_t TC_SMEM = 1024 + (size_t)RING_BYTES + (size_t)BUF * 6 +
                             (size_t)2 * STAGES * 8;
constexpr int MAX_ORDINALS = 1 << 16;         // 16-bit tile ordinals
constexpr int MERGE_THREADS = 512;
constexpr int MERGE_PER = 40;                 // candidates per merge thread
constexpr int MERGE_MAX = MERGE_THREADS * MERGE_PER;
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(TC_SMEM <= 232448, "one block per SM");
static_assert(QT == 64 && THREADS == 256, "8 warps of 16 x 32 scores");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(bar)
               : "memory");
}
// one arrival that also expects `bytes` of TMA copies to land
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state)
               : "r"(bar), "r"(bytes)
               : "memory");
}
// TMA: the box at (column x, row y) of the 2-D tensor map into `dst`,
// completing `bytes` on the mbarrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}
// Waits for the phase of `parity` of the mbarrier to complete; traps (a
// launch error, not a hang) if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1LL << 26)) __trap();
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators (exact). The
// fragments hold the same bytes as mma_bf16's 16x16 and 16x8 bf16 ones, so
// the same ldmatrix addresses feed it, 32 codes per step.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an unsigned key in the order of the float (-0 taken as +0; no NaN here)
__device__ __forceinline__ uint32_t f2key(float v) {
  const uint32_t u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key2f(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Stage (tile at gallery row `base`, columns col0 .. col0 + KC) of the ring
// by the producer warp's masked 2-byte loads, for a D that is not a
// multiple of 8 (or rows not 16-byte aligned), where TMA cannot copy: the
// layout TMA's 128-byte swizzle gives, 64 x 64 q̂ tile at `dst`, gallery
// tile at dst + TILE_BYTES, rows of 128 B with 16-byte chunk c of row r at
// chunk c ^ (r % 8), zeros past Q, G and D. Lane l moves chunk l % 8 of
// rows l / 8 + 4i of each operand.
__device__ __forceinline__ void load_stage_masked(uint32_t dst,
                                                  const uint16_t* q,
                                                  const uint16_t* g, int q0,
                                                  int Q, int base, int G,
                                                  int D, int col0, int lane) {
#pragma unroll 4
  for (int p = 0; p < 32; ++p) {
    const bool isq = p < 16;
    const uint16_t* src = isq ? q : g;
    const int rows = isq ? Q : G;
    const int r = (lane >> 3) + 4 * (p & 15), c = lane & 7;
    const int row = (isq ? q0 : base) + r, col = col0 + 8 * c;
    const uint32_t d = dst + (isq ? 0 : TILE_BYTES) + r * (KC * 2) +
                       ((c ^ (r & 7)) << 4);
    uint32_t w[4] = {0, 0, 0, 0};
    if (row < rows) {
      const uint16_t* s = src + (size_t)row * D;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < D) w[e >> 1] |= (uint32_t)s[col + e] << (16 * (e & 1));
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
  }
}

// The int8 counterpart of load_stage_masked, for a D that is not a multiple
// of 16 (or rows not 16-byte aligned): the same layout, 128 codes a row,
// lane l moving chunk l % 8 (16 codes) of rows l / 8 + 4i of each operand.
__device__ __forceinline__ void load_stage_masked_i8(uint32_t dst,
                                                     const uint8_t* q,
                                                     const uint8_t* g, int q0,
                                                     int Q, int base, int G,
                                                     int D, int col0,
                                                     int lane) {
#pragma unroll 4
  for (int p = 0; p < 32; ++p) {
    const bool isq = p < 16;
    const uint8_t* src = isq ? q : g;
    const int rows = isq ? Q : G;
    const int r = (lane >> 3) + 4 * (p & 15), c = lane & 7;
    const int row = (isq ? q0 : base) + r, col = col0 + 16 * c;
    const uint32_t d = dst + (isq ? 0 : TILE_BYTES) + r * KC_I8 +
                       ((c ^ (r & 7)) << 4);
    uint32_t w[4] = {0, 0, 0, 0};
    if (row < rows) {
      const uint8_t* s = src + (size_t)row * D;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (col + e < D) w[e >> 2] |= (uint32_t)s[col + e] << (8 * (e & 3));
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
  }
}

// The sum of the 16 int8 codes of the 16-byte chunk at shared address `a`
// (exact, in int32).
__device__ __forceinline__ int chunk_sum_i8(uint32_t a) {
  uint32_t w[4];
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(a));
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) s = __dp4a((int)w[i], 0x01010101, s);
  return s;
}

// The sum of the 8 bf16 of the 16-byte chunk at shared address `a`, as a
// tree of f32 additions.
__device__ __forceinline__ float chunk_sum(uint32_t a) {
  uint32_t w[4];
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(a));
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = bf16_lo(w[i]) + bf16_hi(w[i]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// The insertion chain of two neighbouring bins of one query row (pair
// entries at `bv`, 16-bit tile ordinals at `bo`, depth stride DS): each
// value sinks below the stored values >= it, the displaced value going on
// down. The TD slots are read at once and the chain runs in registers, so
// the chain costs one round trip to shared memory, not TD.
__device__ __forceinline__ void insert_pair(float2* bv, uint32_t* bo,
                                            float a, float b, uint32_t ord) {
  float2 cur[TD];
  uint32_t co[TD];
#pragma unroll
  for (int t = 0; t < TD; ++t) {
    cur[t] = bv[t * DS];
    co[t] = bo[t * DS];
  }
  uint32_t oa = ord, ob = ord;
#pragma unroll
  for (int t = 0; t < TD; ++t) {
    const bool ta = a > cur[t].x, tb = b > cur[t].y;
    const uint32_t lo = co[t] & 0xffffu, hi = co[t] >> 16;
    if (ta || tb) {
      bv[t * DS] = make_float2(ta ? a : cur[t].x, tb ? b : cur[t].y);
      bo[t * DS] = (ta ? oa : lo) | ((tb ? ob : hi) << 16);
    }
    if (ta) {
      a = cur[t].x;
      oa = lo;
    }
    if (tb) {
      b = cur[t].y;
      ob = hi;
    }
  }
}

// The tensor-core split kernel of score stage M (BF16: kernel 2, I8:
// kernel 3), phase P (STREAM, MATMUL, INSERT or FULL; the outputs of each
// as for fused_topk_split_kernel). Grid (query tiles, nsplit), TC_THREADS
// threads (8 consumer warps, then the producer warp that fills the ring),
// TC_SMEM bytes: the ring, then the buffers (values f32 [TD][QT][BINS],
// tile ordinals u16 likewise; bin b of row q at b ^ (8 * (q % 4)), which
// keeps the two neighbouring bins of an entry pair together and spreads a
// warp's rows over the banks). A stage holds 128 bytes of each row: 64
// bf16 or 128 int8 codes. I8 only: qscale (Q,) and gscale (G,), each score
// (float)acc * (qscale[q] * gscale[g]); the int8 rows' STREAM sums are the
// exact int32 sums of their codes. The parameters of the bf16 instance
// come first, so that it keeps its layout (and its SASS).
template <int M, int P>
__global__ void __launch_bounds__(TC_THREADS, 1)
fused_topk_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmg,
                     const uint16_t* __restrict__ q,
                     const uint16_t* __restrict__ g, int Q, int G, int D,
                     int k, int nsplit, bool tma, float* __restrict__ cand_v,
                     int* __restrict__ cand_i, float* __restrict__ tth,
                     const float* __restrict__ qscale,
                     const float* __restrict__ gscale) {
  static_assert(P >= STREAM && P <= FULL, "a phase of the split kernel");
  static_assert(M == BF16 || M == I8, "a tensor-core score stage");
  constexpr int KE = M == I8 ? KC_I8 : KC;  // elements per row per stage
  using Acc = std::conditional_t<M == I8, int, float>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  // the ring at the first 1024-byte boundary, then the buffers
  unsigned char* sm = smem_bf16 + ((1024 - smem_u32(smem_bf16) % 1024) % 1024);
  float* bufv = reinterpret_cast<float*>(sm + RING_BYTES);
  uint16_t* bufo = reinterpret_cast<uint16_t*>(bufv + BUF);
  const uint32_t ring = smem_u32(sm);
  // stage s is in: full[s] (TMA: one arrival and the stage's bytes; else
  // 32 arrivals of the producer's lanes); every consumer warp is done with
  // it: empty[s] (8 arrivals)
  const uint32_t full = smem_u32(bufo + BUF), empty = full + 8 * STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT, split = blockIdx.y;
  // this thread's scores: rows qa and qa + 8, bins bn + 8j + {0, 1}
  const int wq = warp >> 1, wn = warp & 1;
  const int qa = 16 * wq + (lane >> 2), bn = 32 * wn + 2 * (lane & 3);

  if constexpr (P >= INSERT) {
    for (int e = tid; e < BUF; e += TC_THREADS) {
      bufv[e] = -CUDART_INF_F;
      bufo[e] = 0;
    }
  }
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, tma ? 1 : 32);
      mbar_init(empty + 8 * st, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ntiles = (G + GT - 1) / GT;
  const int my_tiles = (ntiles - split + nsplit - 1) / nsplit;
  const int nk = (D + KE - 1) / KE;
  const int total = my_tiles * nk;

  if (warp == WARPS) {
    // the producer: stage s into slot s % STAGES once the consumers have
    // released the slot's previous stage; two TMA boxes (q̂ and gallery)
    // from lane 0, or the warp's masked loads
    int ord = 0, kc = 0, slot = 0;
    uint32_t round = 0;
    for (int st = 0; st < total; ++st) {
      if (round) mbar_wait(empty + 8 * slot, (round - 1) & 1);
      const uint32_t dst = ring + slot * STAGE_BYTES, bar = full + 8 * slot;
      const int base = (split + ord * nsplit) * GT;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(bar, STAGE_BYTES);
          tma_load_2d(dst, &tmq, kc * KE, q0, bar);
          tma_load_2d(dst + TILE_BYTES, &tmg, kc * KE, base, bar);
        }
      } else {
        if constexpr (M == I8)
          load_stage_masked_i8(dst, reinterpret_cast<const uint8_t*>(q),
                               reinterpret_cast<const uint8_t*>(g), q0, Q,
                               base, G, D, kc * KE, lane);
        else
          load_stage_masked(dst, q, g, q0, Q, base, G, D, kc * KC, lane);
        mbar_arrive(bar);
      }
      if (++kc == nk) {
        kc = 0;
        ++ord;
      }
      if (++slot == STAGES) {
        slot = 0;
        ++round;
      }
    }
    __syncwarp();
    __syncthreads();  // the consumers' last barrier
    return;
  }

  // ldmatrix row addresses (chunk 0) and their swizzle
  const int sw = lane & 7;
  const uint32_t a_row = (16 * wq + (lane & 15)) * (KC * 2);
  const int a_c = lane >> 4;
  uint32_t b_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    b_row[h] = (32 * wn + 16 * h + (lane & 7) + ((lane >> 4) << 3)) * (KC * 2);
  const int b_c = (lane >> 3) & 1;

  // two sets of accumulators (even and odd 16-word steps), so that each
  // chain of dependent mma is half as long; a score is their sum
  Acc acc[2][4][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[e][j][c] = Acc(0);
  // the previous tile's 8 score pairs, inserted one pair per stage
  [[maybe_unused]] float pv[8][2] = {};
  [[maybe_unused]] int pend = 0;
  [[maybe_unused]] uint32_t pend_ord = 0;
  [[maybe_unused]] Acc rowsum[2] = {Acc(0), Acc(0)};
  [[maybe_unused]] float rowmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
  // int8: the scales of this thread's rows qa, qa + 8, and of its bins of
  // the current tile (read at the tile's first stage, used at its last)
  [[maybe_unused]] float qsv[2] = {0.f, 0.f}, gsv[8] = {};
  if constexpr (M == I8 && P != STREAM) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qsv[h] = q0 + qa + 8 * h < Q ? qscale[q0 + qa + 8 * h] : 0.f;
  }
  // the score of accumulator (j, c): rows qa + 8 (c / 2), bin bn + 8j + c % 2
  auto score = [&](int j, int c) -> float {
    if constexpr (M == I8)
      return __fmul_rn(__int2float_rn(acc[0][j][c] + acc[1][j][c]),
                       __fmul_rn(qsv[c >> 1], gsv[2 * j + (c & 1)]));
    else
      return acc[0][j][c] + acc[1][j][c];
  };

  // entry pair p = 2j + hh of the pending tile: row qa + 8hh, bins bn + 8j
  auto insert_next = [&]() {
    const int p = 8 - pend;
    const int ql = qa + 8 * (p & 1), bin = bn + 8 * (p >> 1);
    const int e = (ql * BINS + (bin ^ ((ql & 3) << 3))) >> 1;
    insert_pair(reinterpret_cast<float2*>(bufv) + e,
                reinterpret_cast<uint32_t*>(bufo) + e, pv[0][0], pv[0][1],
                pend_ord);
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      pv[i][0] = pv[i + 1][0];
      pv[i][1] = pv[i + 1][1];
    }
    --pend;
  };

  int ord = 0, kc = 0, slot = 0;
  uint32_t round = 0;
  for (int it = 0; it < total; ++it) {
    if constexpr (M == I8 && P != STREAM) {
      if (kc == 0) {  // the tile's gallery scales, in flight while it streams
        const int base = (split + ord * nsplit) * GT;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = base + bn + 8 * j + e;
            gsv[2 * j + e] = r < G ? gscale[r] : 0.f;
          }
      }
    }
    mbar_wait(full + 8 * slot, round & 1);
    const uint32_t sq = ring + slot * STAGE_BYTES;
    const uint32_t sg = sq + TILE_BYTES;
    if constexpr (P == STREAM) {
      // every word this thread loaded, folded into its rows' sums
      const int r = tid >> 3, c = tid & 7;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 32 * h;
        const uint32_t off = rr * (KC * 2) + ((c ^ (rr & 7)) << 4);
        if constexpr (M == I8)
          rowsum[h] += chunk_sum_i8(sq + off) + chunk_sum_i8(sg + off);
        else
          rowsum[h] += chunk_sum(sq + off) + chunk_sum(sg + off);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(sq + a_row + (((2 * ks + a_c) ^ sw) << 4), a[0], a[1],
                    a[2], a[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(sg + b_row[h] + (((2 * ks + b_c) ^ sw) << 4), b0, b1,
                      b2, b3);
          if constexpr (M == I8) {
            mma_s8(acc[ks & 1][2 * h], a, b0, b1);
            mma_s8(acc[ks & 1][2 * h + 1], a, b2, b3);
          } else {
            mma_bf16(acc[ks & 1][2 * h], a, b0, b1);
            mma_bf16(acc[ks & 1][2 * h + 1], a, b2, b3);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);  // the slot is free
    if (++slot == STAGES) {
      slot = 0;
      ++round;
    }
    // one pending pair, after the release: the producer refills the slot
    // meanwhile
    if constexpr (P >= INSERT)
      if (pend) insert_next();
    if (++kc == nk) {  // the tile is complete
      kc = 0;
      const int base = (split + ord * nsplit) * GT;
      if constexpr (P == MATMUL) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (base + bn + 8 * j + (c & 1) < G)
              rowmax[c >> 1] = fmaxf(rowmax[c >> 1], score(j, c));
      }
      if constexpr (P >= INSERT) {
        while (pend) insert_next();
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pv[2 * j + (c >> 1)][c & 1] = base + bn + 8 * j + (c & 1) < G
                                              ? score(j, c)
                                              : -CUDART_INF_F;
        pend = 8;
        pend_ord = ord;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[e][j][c] = Acc(0);
      ++ord;
    }
  }
  if constexpr (P >= INSERT)
    while (pend) insert_next();
  __syncthreads();  // with the producer's last; every buffer is final

  if constexpr (P == STREAM) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Acc v = rowsum[h];
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        v += __shfl_xor_sync(FULL_MASK, v, off);
      const int qg = q0 + (tid >> 3) + 32 * h;
      if ((tid & 7) == 0 && qg < Q) tth[(size_t)qg * nsplit + split] = v;
    }
    return;
  } else if constexpr (P == MATMUL) {
    float* red = reinterpret_cast<float*>(sm);  // [2][QT]; the ring is free
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = rowmax[h];
      m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 1));
      m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 2));
      if ((lane & 3) == 0) red[wn * QT + qa + 8 * h] = m;
    }
    // the consumer warps alone (the producer has left): named barrier 1
    asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
    if (tid < QT && q0 + tid < Q)
      tth[(size_t)(q0 + tid) * nsplit + split] =
          fmaxf(red[tid], red[QT + tid]);
    return;
  } else {
    for (int ql = warp; ql < QT; ql += WARPS) {
      const int qg = q0 + ql;
      if (qg >= Q) break;  // warp-uniform
      const size_t out = ((size_t)qg * nsplit + split) * k;
      const int swz = (ql & 3) << 3;
      if constexpr (P == INSERT) {
        // the first k buffer lanes (depth n / BINS, bin n % BINS), verbatim
        for (int n = lane; n < k; n += 32) {
          const int t = n / BINS, b = n % BINS;
          const int a = t * QT * BINS + ql * BINS + (b ^ swz);
          const float v = bufv[a];
          cand_v[out + n] = v;
          cand_i[out + n] =
              v == -CUDART_INF_F
                  ? 0
                  : (((int)bufo[a] * nsplit + split) * BINS + b);
        }
      } else {
        // the row's 384 entries: lane holds bins 2 lane, 2 lane + 1 at
        // every depth, as (key, index)
        uint32_t key[2 * TD];
        int idx[2 * TD];
        float deepest = -CUDART_INF_F;
        const int e0 = (ql * BINS + ((2 * lane) ^ swz)) >> 1;
#pragma unroll
        for (int t = 0; t < TD; ++t) {
          const float2 v = reinterpret_cast<const float2*>(bufv)[e0 + t * DS];
          const uint32_t o =
              reinterpret_cast<const uint32_t*>(bufo)[e0 + t * DS];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = c ? v.y : v.x;
            key[2 * t + c] = f2key(x);
            idx[2 * t + c] =
                x == -CUDART_INF_F
                    ? 0
                    : ((int)((c ? o >> 16 : o & 0xffffu) * nsplit + split) *
                           BINS +
                       2 * lane + c);
            if (t == TD - 1) deepest = fmaxf(deepest, x);
          }
        }
#pragma unroll
        for (int off = 16; off; off >>= 1)
          deepest = fmaxf(deepest, __shfl_xor_sync(FULL_MASK, deepest, off));
        // the k-th largest key, bit by bit
        uint32_t T = 0;
        for (int bit = 31; bit >= 0; --bit) {
          const uint32_t cand = T | (1u << bit);
          unsigned n = 0;
#pragma unroll
          for (int e = 0; e < 2 * TD; ++e) n += key[e] >= cand;
          if ((int)__reduce_add_sync(FULL_MASK, n) >= k) T = cand;
        }
        unsigned gt = 0, eq = 0;
#pragma unroll
        for (int e = 0; e < 2 * TD; ++e) {
          gt += key[e] > T;
          eq += key[e] == T;
        }
        const int need = k - (int)__reduce_add_sync(FULL_MASK, gt);
        const bool tie = (int)__reduce_add_sync(FULL_MASK, eq) > need;
        // at a tie, the need lowest indices of key T: all below R, then
        // `dup` of the (equal) entries at R
        uint32_t R = 0xffffffffu;
        int dup = 0;
        if (tie) {
          R = 0;
          for (int bit = 30; bit >= 0; --bit) {
            const uint32_t cand = R + (1u << bit);
            unsigned n = 0;
#pragma unroll
            for (int e = 0; e < 2 * TD; ++e)
              n += key[e] == T && (uint32_t)idx[e] < cand;
            if ((int)__reduce_add_sync(FULL_MASK, n) < need) R = cand;
          }
          unsigned lt = 0;
#pragma unroll
          for (int e = 0; e < 2 * TD; ++e)
            lt += key[e] == T && (uint32_t)idx[e] < R;
          dup = need - (int)__reduce_add_sync(FULL_MASK, lt);
        }
        // the selected entries, in (entry, lane) order
        const unsigned below = (1u << lane) - 1u;
        int pos = 0, dtaken = 0;
#pragma unroll
        for (int e = 0; e < 2 * TD; ++e) {
          const bool d = tie && key[e] == T && (uint32_t)idx[e] == R;
          const unsigned bd = __ballot_sync(FULL_MASK, d);
          const bool s = key[e] > T ||
                         (key[e] == T && (uint32_t)idx[e] < R) ||
                         (d && dtaken + __popc(bd & below) < dup);
          dtaken += __popc(bd);
          const unsigned bs = __ballot_sync(FULL_MASK, s);
          if (s) {
            const int at = pos + __popc(bs & below);
            cand_v[out + at] = key2f(key[e]);
            cand_i[out + at] = idx[e];
          }
          pos += __popc(bs);
        }
        if (lane == 0) tth[(size_t)qg * nsplit + split] = deepest;
      }
    }
  }
}

// The sum over the block of each thread's `n` (the same value returned to
// every thread); `part` holds two rounds of per-warp partials, so one
// barrier per call suffices.
__device__ __forceinline__ int block_count(unsigned n, int* part, int& round) {
  const int w = threadIdx.x >> 5;
  n = __reduce_add_sync(FULL_MASK, n);
  int* p = part + round * (MERGE_THREADS / 32);
  if ((threadIdx.x & 31) == 0) p[w] = (int)n;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < MERGE_THREADS / 32; ++i) s += p[i];
  round ^= 1;
  return s;
}

// Exclusive prefix over the block of each thread's `n`.
__device__ __forceinline__ int block_prefix(int n, int* scan) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();  // the previous use of scan is over
  if (lane == 31) scan[w] = x;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < w; ++i) before += scan[i];
  return before + x - n;
}

// One block per query row: the exact top-k of the splits' nsplit * k
// candidates (each split's top-k set, in any order) by the same bit-by-bit
// selection of the k-th key, ties at it to the lowest indices, then each
// selected entry placed by its rank; ok = AND over splits of (deepest <
// final k-th value).
__global__ void __launch_bounds__(MERGE_THREADS)
fused_topk_select_merge_kernel(const float* __restrict__ cand_v,
                               const int* __restrict__ cand_i,
                               const float* __restrict__ tth, int k,
                               int nsplit, float* __restrict__ vals,
                               int* __restrict__ inds, int* __restrict__ ok) {
  __shared__ uint32_t sk[TD * BINS];
  __shared__ int si[TD * BINS];
  __shared__ int part[2 * MERGE_THREADS / 32];
  __shared__ int scan[MERGE_THREADS / 32];
  __shared__ float last;
  const int tid = threadIdx.x, qg = blockIdx.x, n_cand = nsplit * k;
  const size_t off = (size_t)qg * n_cand;
  uint32_t key[MERGE_PER];
  int idx[MERGE_PER];
#pragma unroll
  for (int e = 0; e < MERGE_PER; ++e) {
    const int c = tid + MERGE_THREADS * e;
    key[e] = c < n_cand ? f2key(cand_v[off + c]) : 0u;  // 0: no candidate
    idx[e] = c < n_cand ? cand_i[off + c] : 0;
  }
  int round = 0;
  uint32_t T = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = T | (1u << bit);
    unsigned n = 0;
#pragma unroll
    for (int e = 0; e < MERGE_PER; ++e) n += key[e] >= cand;
    if (block_count(n, part, round) >= k) T = cand;
  }
  unsigned gt = 0, eq = 0;
#pragma unroll
  for (int e = 0; e < MERGE_PER; ++e) {
    gt += key[e] > T;
    eq += key[e] == T;
  }
  const int need = k - block_count(gt, part, round);
  const bool tie = block_count(eq, part, round) > need;
  uint32_t R = 0xffffffffu;
  int dup = 0;
  if (tie) {
    R = 0;
    for (int bit = 30; bit >= 0; --bit) {
      const uint32_t cand = R + (1u << bit);
      unsigned n = 0;
#pragma unroll
      for (int e = 0; e < MERGE_PER; ++e)
        n += key[e] == T && (uint32_t)idx[e] < cand;
      if (block_count(n, part, round) < need) R = cand;
    }
    unsigned lt = 0;
#pragma unroll
    for (int e = 0; e < MERGE_PER; ++e)
      lt += key[e] == T && (uint32_t)idx[e] < R;
    dup = need - block_count(lt, part, round);
  }
  // compaction: the entries above the cut, then `dup` entries at it
  int n_sel = 0, n_dup = 0;
#pragma unroll
  for (int e = 0; e < MERGE_PER; ++e) {
    n_sel += key[e] > T || (key[e] == T && (uint32_t)idx[e] < R);
    n_dup += tie && key[e] == T && (uint32_t)idx[e] == R;
  }
  int at = block_prefix(n_sel, scan);
  int dat = block_prefix(n_dup, scan);
  const int n_above = k - dup;
#pragma unroll
  for (int e = 0; e < MERGE_PER; ++e) {
    if (key[e] > T || (key[e] == T && (uint32_t)idx[e] < R)) {
      sk[at] = key[e];
      si[at++] = idx[e];
    } else if (tie && key[e] == T && (uint32_t)idx[e] == R) {
      if (dat < dup) {
        sk[n_above + dat] = key[e];
        si[n_above + dat] = idx[e];
      }
      ++dat;
    }
  }
  __syncthreads();
  // rank of entry i: the entries before it in (key desc, index asc,
  // position) order
  if (tid < k) {
    const uint32_t ki = sk[tid];
    const int ii = si[tid];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t kj = sk[j];
      const int ij = si[j];
      rank += kj > ki || (kj == ki && (ij < ii || (ij == ii && j < tid)));
    }
    vals[(size_t)qg * k + rank] = key2f(ki);
    inds[(size_t)qg * k + rank] = ii;
    if (rank == k - 1) last = key2f(ki);
  }
  __syncthreads();
  int good = 1;
  for (int s = tid; s < nsplit; s += MERGE_THREADS)
    good &= tth[(size_t)qg * nsplit + s] < last;
  good = __syncthreads_and(good);
  if (tid == 0) ok[qg] = good;
}

// Per-row symmetric int8 quantization of (N, D) f32 rows, one warp per
// row: scale = max(max |x|, 1e-12) / 127 and code = clamp(rint(x / scale),
// -127, 127), each step an IEEE f32 operation rounded to nearest even, so
// the codes and scales are quantize_rows_int8's bit for bit (finite x).
constexpr int QUANT_THREADS = 256;
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_rows_int8_kernel(const float* __restrict__ x, int N, int D,
                          int8_t* __restrict__ codes,
                          float* __restrict__ scales) {
  const int row = blockIdx.x * (QUANT_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // warp-uniform
  const float* xr = x + (size_t)row * D;
  float m = 0.f;
  for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(xr[c]));
#pragma unroll
  for (int off = 16; off; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
  const float sc = __fdiv_rn(m < 1e-12f ? 1e-12f : m, 127.f);
  for (int c = lane; c < D; c += 32) {
    const float v = rintf(__fdiv_rn(xr[c], sc));
    codes[(size_t)row * D + c] = (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
  }
  if (lane == 0) scales[row] = sc;
}

cudaError_t launch_quantize(const float* x, int N, int D, int8_t* codes,
                            float* scales, cudaStream_t st) {
  constexpr int rows = QUANT_THREADS / 32;
  quantize_rows_int8_kernel<<<(N + rows - 1) / rows, QUANT_THREADS, 0, st>>>(
      x, N, D, codes, scales);
  return cudaGetLastError();
}

// The tensor-core geometry, or false: 16-bit tile ordinals, and the merge's
// candidates in its registers.
bool bad_tc_geometry(int Q, int G, int D, int k, int nsplit) {
  if (bad_geometry(Q, G, D, k, nsplit)) return true;
  const int ntiles = (G + GT - 1) / GT;
  return (ntiles + nsplit - 1) / nsplit > MAX_ORDINALS ||
         nsplit * k > MERGE_MAX;
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to
// libcuda), or null
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a (rows, D) operand of score stage M in boxes of 64
// rows x 128 bytes with the 128-byte swizzle, zeros past its edges.
template <int M>
bool tile_map(CUtensorMap* map, const void* base, int rows, int D) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  constexpr int esize = M == I8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(M == I8 ? KC_I8 : KC),
                             (cuuint32_t)QT};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map,
             M == I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches phase P of the tensor-core split kernel of score stage M on
// `st`: TMA when a row is a multiple of 16 bytes (D % 8 bf16, D % 16 int8)
// and both operands 16-byte aligned, else the producer's masked loads.
template <int M, int P>
cudaError_t launch_tc(const void* q, const void* g, const float* qscale,
                      const float* gscale, int Q, int G, int D, int k,
                      int nsplit, float* cand_v, int* cand_i, float* tth,
                      cudaStream_t st) {
  CUtensorMap tmq, tmg;
  memset(&tmq, 0, sizeof tmq);
  memset(&tmg, 0, sizeof tmg);
  const bool tma = D % (M == I8 ? 16 : 8) == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)g % 16 == 0;
  if (tma && (!tile_map<M>(&tmq, q, Q, D) || !tile_map<M>(&tmg, g, G, D)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_tc_kernel<M, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TC_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + QT - 1) / QT, nsplit);
  fused_topk_tc_kernel<M, P><<<grid, TC_THREADS, TC_SMEM, st>>>(
      tmq, tmg, static_cast<const uint16_t*>(q),
      static_cast<const uint16_t*>(g), Q, G, D, k, nsplit, tma, cand_v,
      cand_i, tth, qscale, gscale);
  return cudaGetLastError();
}

// The workspace of one fused top-k call, carved from one allocation of
// `words` 4-byte words: the outputs vals, inds (Q, k) and ok (Q) first;
// then, each at a 64-word (256-byte) boundary, the candidates cand_v,
// cand_i (Q, nsplit, k) and tth (Q, nsplit); int8 only, the query scales
// (Q) and codes (Q, D). ops/retrieval.py (_work_words) computes the same
// size; a call whose size differs is refused.
struct Work {
  float* vals;
  int* inds;
  int* ok;
  float* cand_v;
  int* cand_i;
  float* tth;
  float* qscale;
  int8_t* qcodes;
};

long long up64(long long n) { return (n + 63) / 64 * 64; }

long long carve(void* base, int Q, int D, int k, int nsplit, bool int8,
                Work* w) {
  int* p = static_cast<int*>(base);
  const long long qk = (long long)Q * k, cand = qk * nsplit;
  const long long cv = up64(2 * qk + Q), ci = up64(cv + cand),
                  tt = up64(ci + cand);
  long long end = up64(tt + (long long)Q * nsplit);
  w->vals = reinterpret_cast<float*>(p);
  w->inds = p + qk;
  w->ok = p + 2 * qk;
  w->cand_v = reinterpret_cast<float*>(p + cv);
  w->cand_i = p + ci;
  w->tth = reinterpret_cast<float*>(p + tt);
  w->qscale = nullptr;
  w->qcodes = nullptr;
  if (int8) {
    const long long qc = up64(end + Q);
    w->qscale = reinterpret_cast<float*>(p + end);
    w->qcodes = reinterpret_cast<int8_t*>(p + qc);
    end = up64(qc + ((long long)Q * D + 3) / 4);
  }
  return end;
}

// Kernels 2 and 3: the tensor-core split kernel, then the selection merge.
// Also needs at most 65,536 gallery tiles per split and nsplit * k <=
// 20,480. bf16: q̂ (Q, D) bf16, pre-normalized gallery (G, D) bf16, gscale
// null. int8: q̂ (Q, D) f32, quantized here first (quantize_rows_int8_kernel,
// into the workspace), int8 codes of the gallery (G, D) and their scales
// gscale (G,).
template <int M>
int launch_fused_tc(const void* q, const void* g, const float* gscale, int Q,
                    int G, int D, int k, int nsplit, int bins, int t_depth,
                    void* work, long long words, void* stream) {
  Work w;
  if (bins != BINS || t_depth != TD || bad_tc_geometry(Q, G, D, k, nsplit) ||
      carve(work, Q, D, k, nsplit, M == I8, &w) != words)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M == I8) {
    err = launch_quantize(static_cast<const float*>(q), Q, D, w.qcodes,
                          w.qscale, st);
    if (err != cudaSuccess) return (int)err;
    q = w.qcodes;
  }
  err = launch_tc<M, FULL>(q, g, w.qscale, gscale, Q, G, D, k, nsplit,
                           w.cand_v, w.cand_i, w.tth, st);
  if (err != cudaSuccess) return (int)err;
  fused_topk_select_merge_kernel<<<Q, MERGE_THREADS, 0, st>>>(
      w.cand_v, w.cand_i, w.tth, k, nsplit, w.vals, w.inds, w.ok);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

// Each fused top-k entry launches its kernels on `stream` and returns
// cudaGetLastError() (0 = ok; cudaErrorInvalidValue for a geometry or a
// workspace it does not take). `work` is the call's workspace of `words`
// words (Work, above): the outputs vals, inds (Q, k) and ok (Q) are its
// first words. 1 <= nsplit <= number of 64-row gallery tiles.

// q̂ (Q, D) f32, raw gallery (G, D) f32 and its row norms (G,): the f32 split
// kernel, then the k-way merge.
int fused_topk_f32(const float* q, const float* g, const float* gnorm, int Q,
                   int G, int D, int k, int nsplit, int bins, int t_depth,
                   void* work, long long words, void* stream) {
  Work w;
  if (bins != BINS || t_depth != TD || bad_geometry(Q, G, D, k, nsplit) ||
      carve(work, Q, D, k, nsplit, false, &w) != words)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split<FULL>(q, g, gnorm, Q, G, D, k, nsplit,
                                       w.cand_v, w.cand_i, w.tth, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)nsplit * k * (sizeof(float) + sizeof(int)) +
                       (size_t)nsplit * sizeof(int);
  err = cudaFuncSetAttribute(fused_topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  fused_topk_merge_kernel<<<Q, 32, smem2, st>>>(
      w.cand_v, w.cand_i, w.tth, k, nsplit, w.vals, w.inds, w.ok);
  return (int)cudaGetLastError();
}

int fused_topk_bf16(const void* q, const void* g, const float* gscale, int Q,
                    int G, int D, int k, int nsplit, int bins, int t_depth,
                    void* work, long long words, void* stream) {
  return launch_fused_tc<BF16>(q, g, gscale, Q, G, D, k, nsplit, bins,
                               t_depth, work, words, stream);
}

int fused_topk_int8(const void* q, const void* g, const float* gscale, int Q,
                    int G, int D, int k, int nsplit, int bins, int t_depth,
                    void* work, long long words, void* stream) {
  return launch_fused_tc<I8>(q, g, gscale, Q, G, D, k, nsplit, bins, t_depth,
                             work, words, stream);
}

// x (N, D) f32 -> codes (N, D) int8 and scales (N,) f32, as
// quantize_rows_int8 (one launch).
int quantize_rows_int8_f32(const float* x, int N, int D, void* codes,
                           float* scales, void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_quantize(x, N, D, static_cast<int8_t*>(codes), scales,
                              reinterpret_cast<cudaStream_t>(stream));
}

// The ladder: q̂ (Q, D) f32 with the raw gallery (G, D) f32 and its row
// norms (G,), or q̂ and the pre-normalized gallery in bf16 (gnorm unused).
#define LADDER_RUNG(name, P)                                               \
  int name(const void* q, const void* g, const float* gnorm, int Q, int G, \
           int D, int k, int nsplit, float* out_v, int* out_i,            \
           void* stream) {                                                \
    return launch_rung<P>(q, g, gnorm, Q, G, D, k, nsplit, out_v, out_i,  \
                          stream);                                        \
  }
LADDER_RUNG(fused_topk_f32_stream_only, STREAM)
LADDER_RUNG(fused_topk_f32_matmul_only, MATMUL)
LADDER_RUNG(fused_topk_f32_insert_only, INSERT)
#undef LADDER_RUNG
#define LADDER_RUNG_BF16(name, P)                                          \
  int name(const void* q, const void* g, const float*, int Q, int G, int D, \
           int k, int nsplit, float* out_v, int* out_i, void* stream) {   \
    if (bad_tc_geometry(Q, G, D, k, nsplit))                              \
      return (int)cudaErrorInvalidValue;                                  \
    return (int)launch_tc<BF16, P>(q, g, nullptr, nullptr, Q, G, D, k,    \
                                   nsplit, out_v, out_i, out_v,           \
                                   reinterpret_cast<cudaStream_t>(stream)); \
  }
LADDER_RUNG_BF16(fused_topk_bf16_stream_only, STREAM)
LADDER_RUNG_BF16(fused_topk_bf16_matmul_only, MATMUL)
LADDER_RUNG_BF16(fused_topk_bf16_insert_only, INSERT)
#undef LADDER_RUNG_BF16
// int8: the codes of q̂ (Q, D) with their scales qscale (Q,), the gallery's
// codes (G, D) and scales gscale (G,).
#define LADDER_RUNG_I8(name, P)                                            \
  int name(const void* q, const void* g, const float* qscale,              \
           const float* gscale, int Q, int G, int D, int k, int nsplit,   \
           float* out_v, int* out_i, void* stream) {                      \
    if (bad_tc_geometry(Q, G, D, k, nsplit))                              \
      return (int)cudaErrorInvalidValue;                                  \
    return (int)launch_tc<I8, P>(q, g, qscale, gscale, Q, G, D, k, nsplit, \
                                 out_v, out_i, out_v,                     \
                                 reinterpret_cast<cudaStream_t>(stream)); \
  }
LADDER_RUNG_I8(fused_topk_int8_stream_only, STREAM)
LADDER_RUNG_I8(fused_topk_int8_matmul_only, MATMUL)
LADDER_RUNG_I8(fused_topk_int8_insert_only, INSERT)
#undef LADDER_RUNG_I8

// Kernel 4: the (Q, G) f32 cosine scores of q̂ (Q, D) against the raw
// gallery (G, D), both f32, into out; returns cudaGetLastError().
int cosine_scores_f32(const float* q, const float* g, int Q, int G, int D,
                      float* out, void* stream) {
  if (Q < 1 || G < 1 || D < 1 || (Q + QT - 1) / QT > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles = (G + GT - 1) / GT;
  const size_t smem = (size_t)2 * BK * PADW * 4 + (size_t)GT * 4;
  fused_topk_split_kernel<SCORES>
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
