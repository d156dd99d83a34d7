// A linear layer for Hopper (sm_90a) in f32 on tensor cores:
//
//   y = act(x · Wᵀ + b),  x (M, K), W (N, K), b (N,) or none, y (M, N),
//
// act the identity or the exact (erf) GELU, torch's nn.GELU(): Swin's MLP
// is fc2(gelu(fc1(x))), two calls of this kernel. Wrapper, plain version
// and dispatch: imageretrievalresearch_tpu_torch/ops/linear.py and
// models/swin.py (Mlp.forward).
//
// Replaces no TPU kernel: the JAX package's MLP is two flax Dense layers
// and nn.gelu (imageretrievalresearch_tpu/models/swin.py:158-162), XLA's
// on the TPU. On the card cuBLAS runs f32 GEMMs on the CUDA cores (SIMT
// FMA, 67 TFLOP/s at most), then GELU as a pass of its own.
//
// Arithmetic: the 3xTF32 product of kernels 1 and 4 (csrc/fused_topk.cu).
// Each operand is split as x = hi + lo, hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi); the tensor cores sum lo·hi + hi·lo + hi·hi (lo·lo,
// below 2^-22 of a product, is left out), each product exact, within ~1e-7
// of an f64 product where single-pass TF32 keeps ~1e-3. The tensor cores
// round their f32 sums toward zero, so a stage's 32 columns of K are
// summed from zero (the 8 lo products first, then the 4 hi·hi ones) and
// each stage's sum is added to the running sum by an IEEE f32 addition.
// Then + b, the GELU as torch computes it (0.5 v (1 + erff(v / √2)),
// accurate erff; nvcc runs without --use_fast_math), one store of y. No
// single-pass TF32, no lower precision.
//
// Bound: 3 passes of TF32 on the H100 SXM's 494.7 TFLOP/s dense (700 W),
// 164.9 TFLOP/s of f32 products. Swin-S3-B's MLP at 64 images (M rows of
// tokens, K -> N) is 1.066 TFLOP, 6.46 ms; stages 2-4 are bound by their
// operations, stage 1 (N or K = 96) by its bytes (x and y pass through
// device memory once each).
//
// Design (the hopper-kernels guide's shape, kept small):
// - One persistent block per SM (grid min(tiles, SMs)) walks output tiles
//   of BM = 128 rows x BN = 96 columns, columns fastest, so the blocks in
//   flight share their rows of x and all of W in L2. 96 divides every N and
//   K of Swin's MLPs (96 C-multiples), and 96 columns give whole waves at
//   the stage that holds 83% of the work (stage 3: 392 tiles of fc2 and
//   1,568 of fc1 over 132 SMs).
// - W is split once per weight version by the wrapper (ops/linear.py)
//   into W_hi and W_lo (N, K), so the kernel converts only x.
// - A producer warp keeps STAGES = 4 stages in flight: per stage one
//   thread issues three TMA box copies (x's 128 rows, W_hi's and W_lo's 96
//   rows, 32 f32 words = 128 bytes of each row, the 128-byte swizzle,
//   zeros past M, N and K) that complete on the stage's "full" mbarrier.
//   Its warpgroup keeps 40 registers a thread and gives the rest to the
//   consumers (setmaxnreg), which hold 3 x 48 sums a thread.
// - Two consumer warpgroups own 64 rows each. Per stage a thread waits for
//   the stage's copies and for its previous stage's products, reads its 16
//   words of x (the wgmma A fragment, conflict-free through the swizzle),
//   splits them in registers and issues 12 wgmma m64n96k8 tf32 with A from
//   registers and B (W_hi or W_lo) from shared memory into one of two
//   stage sums; then, while those run, it adds the other stage sum (the
//   previous stage's, complete) into its 48 running sums and releases that
//   stage on its "empty" mbarrier (one arrival a warp). While one
//   warpgroup converts, the other's products keep the tensor cores busy.
//   (Waiting for each stage's products before the next conversion, with
//   one stage sum, measured 12% slower over a request's MLPs.)
// - The epilogue: the consumers add b to their fragments, apply the GELU
//   and leave the tile of y in shared memory (128 x 96, 52 KB, hence 4
//   stages and not 5), then go on to the next tile; the producer
//   warpgroup's 3 other warps store it with 16-byte stores of whole rows
//   (rows past M and columns past N masked) beside the next tile's
//   products. A request's MLPs, back to back, measured 12.0 ms this way,
//   12.9 with the consumers storing their fragments themselves, and 12.8
//   with the GELU in the 3 warps too (at stage 1 they fell behind).

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;                // rows of a tile: 2 warpgroups x 64
constexpr int BN = 96;                 // columns of a tile: one wgmma n96
constexpr int BK = 32;                 // f32 words of a row per stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;         // 2 warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int EPILOGUE = 96;           // the producer warpgroup's last 3 warps
constexpr int A_BYTES = BM * BK * 4;   // 16 KB
constexpr int B_BYTES = BN * BK * 4;   // 12 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
// a tile's sums for the epilogue, rows 104 floats apart: a warp's 8-byte
// stores of 8 rows then take the two passes that 256 bytes need
constexpr int EPI_LD = BN + 8;
// slack to align the ring to 1024 B (the 128-byte swizzle's period), the
// ring, the epilogue's tile, then a full and an empty mbarrier per stage
// and the epilogue's pair
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                        (size_t)BM * EPI_LD * 4 + 16 * STAGES + 16;
constexpr int ACC = BN / 2;            // f32 sums a thread: 64 x 96 / 128
static_assert(SMEM <= 232448, "one block per SM");
static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
              "every tile starts on the swizzle's 1024-byte period");
static_assert(BK * 4 == 128, "a stage holds 128 bytes of each row");

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
// TMA: the box at (column x, row y) of the 2-D tensor map into `dst`,
// completing its bytes on the mbarrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// x = hi + lo, hi = tf32(x), lo = tf32(x - hi), each rounded to nearest,
// ties away from zero (cvt.rna), as ops/retrieval.py split_3xtf32 does
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// The shared-memory descriptor of a K-major operand tile in the 128-byte
// swizzle (rows of 128 bytes, 8-row groups 1024 bytes apart) at `addr`.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of `v` across the
// asynchronous products
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// d (64 x 96 f32, the warpgroup's fragment) = a (64 x 8 tf32, registers)
// · b (8 x 96 tf32, K-major in shared memory) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_n96(float* d, const uint32_t* a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ float gelu(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
}

// A consumer's view of the ring: the stage it reads next and its round,
// the stage whose sum it holds unadded (-1: none), its fragment's offset
// in an x tile and its row within a swizzle period.
struct Ring {
  unsigned char* base;
  uint32_t base_u32, full, empty, a_row;
  int g, lane;
  int stage = 0, round = 0, held = -1;
};

// One stage of a tile: wait for its copies and for the previous stage's
// products, split the fragment's 16 x words, issue the 12 products into
// `cur` (from zero), then add `old`, the previous stage's sum, into `acc`
// and release that stage, while the products run.
__device__ __forceinline__ void stage_products(Ring& r, float (&cur)[ACC],
                                               float (&old)[ACC],
                                               float (&acc)[ACC]) {
  mbar_wait(r.full + 8 * r.stage, r.round & 1);
  wgmma_wait_all();
  const unsigned char* a = r.base + r.stage * STAGE_BYTES + r.a_row;
  uint32_t hi[4][4], lo[4][4];
  // the fragment's rows g and g + 8 (1024 bytes on) swizzle 16-byte chunk
  // c to c ^ g; k-step kk's columns q and q + 4 are chunks 2 kk, 2 kk + 1
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t chunk = (uint32_t)((2 * kk + h) ^ r.g) * 16;
      const float v0 = *reinterpret_cast<const float*>(a + chunk);
      const float v1 = *reinterpret_cast<const float*>(a + 1024 + chunk);
      split_tf32(v0, hi[kk][2 * h], lo[kk][2 * h]);
      split_tf32(v1, hi[kk][2 * h + 1], lo[kk][2 * h + 1]);
    }
  }
  const uint64_t bhi = sw128_desc(r.base_u32 + r.stage * STAGE_BYTES +
                                  A_BYTES);
  const uint64_t blo = bhi + (B_BYTES >> 4);
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    fence_operand(cur[i]);
    fence_operand(old[i]);
  }
  wgmma_fence();
  // the small products first, then hi·hi; k-step kk is 32 bytes on
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_n96(cur, lo[kk], bhi + 2 * kk, kk > 0);
    wgmma_n96(cur, hi[kk], blo + 2 * kk, 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n96(cur, hi[kk], bhi + 2 * kk, 1);
  wgmma_commit();
  if (r.held >= 0) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = __fadd_rn(acc[i], old[i]);
    __syncwarp();
    if (r.lane == 0) mbar_arrive(r.empty + 8 * r.held);
  }
  r.held = r.stage;
  if (++r.stage == STAGES) {
    r.stage = 0;
    ++r.round;
  }
}

// Kernel 14: y = act(x · Wᵀ + b) over tiles of BM x BN (top of file).
__global__ void __launch_bounds__(THREADS, 1)
    linear_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_hi,
                         const __grid_constant__ CUtensorMap tm_lo,
                         const float* __restrict__ bias,
                         float* __restrict__ y, int M, int N, int K,
                         int act_gelu) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  float* epi = reinterpret_cast<float*>(ring + (size_t)STAGES * STAGE_BYTES);
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t full = smem_u32(epi + BM * EPI_LD);
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t epi_full = empty + 8 * STAGES, epi_empty = epi_full + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    mbar_init(epi_full, CONSUMERS / 32);
    mbar_init(epi_empty, EPILOGUE / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int k_stages = (K + BK - 1) / BK;

  if (threadIdx.x >= CONSUMERS) {
    // the producer warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= CONSUMERS + 32) {
      // its last 3 warps store each tile of y that the consumers leave in
      // `epi`, while they compute the next one; a thread takes 16-byte
      // pieces of rows, consecutive threads consecutive pieces, so the
      // stores are whole lines
      const int e = threadIdx.x - (CONSUMERS + 32);
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
        mbar_wait(epi_full, i & 1);
        for (int p = e; p < BM * BN / 4; p += EPILOGUE) {
          const int row = p / (BN / 4), c = 4 * (p % (BN / 4));
          if (m0 + row < M && n0 + c < N)
            *reinterpret_cast<float4*>(y + (size_t)(m0 + row) * N + n0 + c) =
                *reinterpret_cast<const float4*>(epi + row * EPI_LD + c);
        }
        __syncwarp();
        if (e % 32 == 0) mbar_arrive(epi_empty);
      }
      return;
    }
    // its first thread issues every copy
    if (threadIdx.x != CONSUMERS) return;
    int stage = 0, round = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
      for (int ks = 0; ks < k_stages; ++ks) {
        if (round) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const uint32_t a = ring_u32 + stage * STAGE_BYTES;
        const uint32_t bar = full + 8 * stage;
        mbar_arrive_expect_tx(bar, STAGE_BYTES);
        tma_load_2d(a, &tm_x, ks * BK, m0, bar);
        tma_load_2d(a + A_BYTES, &tm_hi, ks * BK, n0, bar);
        tma_load_2d(a + A_BYTES + B_BYTES, &tm_lo, ks * BK, n0, bar);
        if (++stage == STAGES) {
          stage = 0;
          ++round;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile;
  // in it, warp w rows 16 w + g and 16 w + g + 8 of the A fragment, g =
  // lane / 4, columns q = lane % 4 and q + 4 of each k-step of 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  Ring st{ring, ring_u32, full, empty,
          (uint32_t)(wg * 64 + warp * 16 + g) * 128 + q * 4, g, lane};
  // the fragment's sums 4j .. 4j + 3 are rows r and r + 8, columns
  // 8j + 2q and 8j + 2q + 1 of the tile
  float* const epi_row = epi + (wg * 64 + warp * 16 + g) * EPI_LD + 2 * q;
  float acc[ACC], part0[ACC], part1[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) part0[i] = part1[i] = 0.0f;
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int n0 = t % n_tiles * BN;
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] = 0.0f;
    // the stage sums alternate between part0 and part1
    st.held = -1;
    for (int ks = 0; ks < k_stages; ks += 2) {
      stage_products(st, part0, part1, acc);
      if (ks + 1 < k_stages) stage_products(st, part1, part0, acc);
    }
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      fence_operand(part0[j]);
      fence_operand(part1[j]);
    }
    if (k_stages % 2) {
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] = __fadd_rn(acc[j], part0[j]);
    } else {
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] = __fadd_rn(acc[j], part1[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st.held);
    // + b and the GELU, then hand the tile to the epilogue warps once
    // they have stored the previous one
    if (i) mbar_wait(epi_empty, (i - 1) & 1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * q;
      const float2 bc = bias != nullptr && c < N
                            ? *reinterpret_cast<const float2*>(bias + c)
                            : make_float2(0.0f, 0.0f);
      float2 v0 = make_float2(acc[4 * j] + bc.x, acc[4 * j + 1] + bc.y);
      float2 v1 = make_float2(acc[4 * j + 2] + bc.x, acc[4 * j + 3] + bc.y);
      if (act_gelu) {
        v0 = make_float2(gelu(v0.x), gelu(v0.y));
        v1 = make_float2(gelu(v1.x), gelu(v1.y));
      }
      *reinterpret_cast<float2*>(epi_row + 8 * j) = v0;
      *reinterpret_cast<float2*>(epi_row + 8 * EPI_LD + 8 * j) = v1;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(epi_full);
  }
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

// The tensor map of a (rows, K) f32 operand in boxes of `box_rows` rows x
// 128 bytes with the 128-byte swizzle, zeros past its edges.
bool tile_map(CUtensorMap* map, const float* base, int rows, int K,
              int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  memset(map, 0, sizeof *map);
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// x (M, K), w_hi and w_lo (N, K) (W's split, ops/linear.py), y (M, N), all
// f32, contiguous and 16-byte aligned; bias (N,) f32 16-byte aligned, or
// null; K % 4 == 0 and N % 4 == 0; act 0 (none) or 1 (GELU); `blocks` the
// persistent grid's size cap (the card's SM count). Launches on `stream`
// and returns cudaGetLastError(); cudaErrorInvalidValue for what it does
// not take.
int linear_tf32x3_f32(const float* x, const float* w_hi, const float* w_lo,
                      const float* bias, float* y, int M, int N, int K,
                      int act, int blocks, void* stream) {
  if (M < 0 || N < 1 || K < 1 || K % 4 != 0 || N % 4 != 0 || blocks < 1 ||
      (act != 0 && act != 1) || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)w_hi % 16 != 0 || (uintptr_t)w_lo % 16 != 0 ||
      (uintptr_t)y % 16 != 0 || (uintptr_t)bias % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  CUtensorMap tm_x, tm_hi, tm_lo;
  if (!tile_map(&tm_x, x, M, K, BM) || !tile_map(&tm_hi, w_hi, N, K, BN) ||
      !tile_map(&tm_lo, w_lo, N, K, BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      linear_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < blocks ? tiles : blocks);
  linear_tf32x3_kernel<<<grid, THREADS, SMEM,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_hi, tm_lo, bias, y, M, N, K, act);
  return (int)cudaGetLastError();
}

const char* linear_tf32x3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
