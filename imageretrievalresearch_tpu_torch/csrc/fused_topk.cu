// Fused cosine top-k for Hopper (sm_90a), in three score variants: score
// Q̂·Ĝᵀ, keep per-bin top-T buffers in shared memory, extract the exact
// top-k with ties to the lowest index, and certify it; and the dense f32
// cosine scores.
//
// Replaces the TPU kernels of imageretrievalresearch_tpu/ops/retrieval.py
// (the top-k kernels all launched by fused_cosine_topk_pallas, which
// shares _stream_topk_update between them):
// - fused_topk_f32  <- _fused_topk_kernel (f32 branch): raw f32 gallery and
//   its norms; the F32 instance of the tensor-core kernel
//   (fused_topk_tc_kernel, then fused_topk_select_merge_kernel, below):
//   each gallery element is divided by max(norm, eps) once per block, then
//   the 3xTF32 product (below).
// - fused_topk_bf16 <- _fused_topk_kernel_bf16: pre-normalized bf16 gallery
//   and bf16 q̂, no norm input; the BF16 instance of the same kernel. A
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
//   tile normalized inside the kernel (cosine_scores_tc_kernel, below).
// - fused_topk_{f32,bf16}_{stream_only,matmul_only,insert_only} <- the
//   ablation ladder of tools/profile_fused_kernel.py (build_variants): the
//   F32 or BF16 instance of the tensor-core kernel cut after one of its
//   phases (below); the fused_topk_int8_* rungs are the port's own (JAX
//   has no int8 ladder).
// Plain versions and wrappers: imageretrievalresearch_tpu_torch/ops/
// retrieval.py (fused_cosine_topk, fused_cosine_topk_reference,
// fused_cosine_scores, cosine_scores_reference) and
// imageretrievalresearch_tpu_torch/tools/profile_fused_kernel.py (the
// ladder).
//
// The f32 arithmetic (kernels 1 and 4) is 3xTF32 on tensor cores, for
// precision 'default' and 'highest' alike: each operand x is split as x =
// big + small, big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big), and
// mma.sync m16n8k8 tf32 accumulates small·big + big·small + big·big in
// f32 (small·small, below 2^-22 of the product, is left out). Each product
// keeps ~21-22 significant bits (one TF32 pass keeps 11). The tensor cores
// round their f32 sums toward zero, so a stage's 32 words accumulate from
// zero and each stage's sum is added to the running score by an IEEE f32
// addition: the score's error stays at a few 1e-7 where it is near 1, as
// an f32 sum's is. The dense path and the plain versions are true f32
// (cuBLAS, TF32 off). The TPU's 'highest' is a multi-pass MXU product too;
// its 'default' is one bf16 pass. Single-pass TF32 is used nowhere.
//
// Bounds at Q=64, G=100,000, D=1536, k=150 on the H100 SXM at 700 W
// (3.35 TB/s; 494.7 TFLOP/s TF32, 989 TFLOP/s bf16 and 1,979 TOP/s int8 on
// tensor cores, dense; 67 TFLOP/s f32 FMA), 2·Q·G·D = 19.7 G operations:
// - f32:  gallery and norms 615 MB ~0.184 ms; 3 x 19.7 GFLOP of TF32 ~0.119
//         ms, so bound by bytes at ~0.184 ms (by the f32 FMA rate it would
//         be 0.293 ms of operations);
// - bf16: gallery 307 MB ~0.092 ms; 0.020 ms on bf16 tensor cores, so
//         bound by bytes at ~0.092 ms;
// - int8: codes 154 MB ~0.046 ms; 0.010 ms on int8 tensor cores, so bound
//         by bytes at ~0.046 ms.
// Kernel 4 at G=100,000, D=1536: bytes (Q·D + G·D + Q·G)·4, 0.191 ms at
// Q=64 and 0.245 ms at Q=512, against 3 x 2·Q·G·D of TF32, 0.119 and 0.953
// ms: bound by bytes at Q=64, by operations at Q=512 (by the f32 FMA rate
// 0.293 and 2.348 ms). A card with a lower power limit, or the PCIe part,
// has lower peaks.
//
// The tensor-core kernel (fused_topk_tc_kernel<M, P>, score stage M =
// F32, BF16 or I8, + the selection merge), kernels 1-3. What holds a
// streaming kernel back on an SM is the bytes it keeps in flight (~25-30 KB
// of gallery at 3.35 TB/s over 132 SMs), and the shared memory the
// buffers leave for that. The design:
// - One query tile of QT=64 rows covers Q=64, so the gallery streams from
//   device memory once. The grid is (query tiles x gallery splits); the
//   wrapper picks one split per SM (132 on the H100 SXM). The gallery is
//   cut into GT=64-row tiles, dealt round-robin to the splits (tile t to
//   split t mod S), so consecutive near-duplicates land in different splits
//   as well as different bins; each block walks its split's tiles in index
//   order. BINS == GT and every tile starts at a multiple of BINS, so row j
//   of a tile is bin j.
// - Buffers, 64 bins of depth 6: f32 values and, in place of 32-bit
//   indices, 16-bit tile ordinals within the split (index = (ordinal x
//   nsplit + split) x 64 + bin; an empty slot, value -inf, decodes to index
//   0), so 144 KB. The launcher refuses more than 65,536 tiles per split.
// - The freed shared memory holds a ring of 5 stages (as many as the 144
//   KB of buffers leave room for), each 128 bytes of 64 rows of q̂ and of
//   the gallery (16 KB: a 64 x 64 bf16 tile or 64 x 128 int8 codes). A
//   producer warp fills it: per stage one thread issues two TMA box copies
//   (the tensor maps' 128-byte swizzle, zeros past Q, G and D) that
//   complete on the stage's mbarrier; a row that is not a whole number of
//   16-byte chunks (D % 4 f32, D % 8 bf16, D % 16 int8), or an operand that
//   is not 16-byte aligned, takes the warp's masked loads into the same
//   layout. The 8 consumer warps wait on a stage's "full" mbarrier and
//   release it on its "empty" one, with no block-wide barrier per stage, so
//   the producer keeps up to 5 stages (40 KB of gallery) in flight while
//   the consumers compute.
// - F32 (128 bytes = 32 words of a row per stage): ĝ = g / max(norm, eps)
//   as JAX orders it (normalize, then multiply), each element divided once
//   per block (__fdiv_rn), and split once. The same bytes hold a raw ring
//   of 4 gallery tiles (8 KB each, 32 KB of gallery in flight) and two
//   plane buffers of 24 KB: q̂'s tile of the stage (copied there by TMA
//   directly, 2 stages behind the gallery), ĝ's big parts and its small
//   parts. 8 converter warps (256 threads, two 16-byte chunks each) read a
//   raw tile, divide, split, store the parts into the plane buffer and
//   release the raw tile; the consumers read the plane buffer and split q̂
//   in registers. So each gallery element is divided and split once, not
//   once for each of the 4 warps that read it, and the conversion overlaps
//   the products of the previous stage. (Measured against three other
//   layouts on the H100, PERF.md: this one is the fastest; what holds it
//   back is shared-memory traffic, ~120 KB a stage, above all ĝ's big and
//   small parts read by 4 warps each, and q̂'s copy latency.)
// - The product runs on tensor cores, fed by ldmatrix from rows swizzled
//   by 16-byte chunk (chunk c of row r at c ^ (r % 8)): mma.sync m16n8k16
//   bf16 with f32 accumulators, m16n8k32 s8 with exact s32 accumulators,
//   or m16n8k8 tf32 three times (3xTF32; it compiles to HMMA.1688.F32.TF32),
//   whose fragments hold the same 32-bit words, so one set of ldmatrix
//   addresses feeds all three (ldmatrix gives each thread one 32-bit word
//   of each 8x8 b16 matrix, the tf32 fragment's layout). Each of 8 warps
//   owns 16 query rows x 32 bins; bf16 and int8 keep two accumulator sets
//   (even and odd 32-byte steps) to halve the dependent chains, f32 a
//   stage's sum and the running score. int8 rescales each score before its
//   insertion, with the query scales read once and the tile's gallery
//   scales read at its first stage, from device memory (f32's converters
//   read the tile's norms there). The mma fragment gives every (query, bin)
//   pair to exactly one thread, for every tile, so the insertion chain
//   needs no synchronisation.
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
//   output equals k argmax passes' (any exact method does), including the
//   (-inf, 0) filler of a row with fewer than k finite entries.
// - The host's part: a call of one C entry point launches every kernel of
//   the variant (int8: the query quantization, the split kernel, the
//   merge) into one workspace that the wrapper allocates once (Work,
//   below), so a call costs the host one allocation and one ctypes call.
//
// The ladder (phase P of the tensor-core kernel; FULL is the production
// instance, the three others exist to attribute its time): STREAM does
// FULL's copies into the ring and folds every loaded word (and, f32, every
// norm) into per-row sums (f32; int8 codes exactly in int32), so no load
// can be dropped; MATMUL adds the division by the norm (f32) or the
// rescale (int8) and the product, and keeps the split's max score per
// query row; INSERT adds the insertion chain and writes the first k buffer
// lanes verbatim (no extraction, no merge). Each rung keeps FULL's launch
// geometry and shared memory, so the occupancy is the same; the
// differences of their times are the costs of the phases that the others
// do not hide.
//
// Kernel 4 (cosine_scores_tc_kernel<MI>, launched by cosine_scores_f32):
// one block per (query tile of 64 MI rows, gallery tile of 64 rows), MI =
// 2 where Q > 64 (fewer re-reads of each gallery tile from L2), with the
// query tiles fastest in the grid, so the blocks of one gallery tile run
// together and the gallery streams from device memory once at any Q (its
// other reads hit L2). The same producer, converter and consumer warps,
// raw ring, plane buffers and 3xTF32 product as kernel 1's F32 instance;
// the 8 consumer warps own 16 MI query rows x 32 gallery rows each. First
// the converters sum the squares of the tile's 64 rows over the whole of
// D (four rows a warp at once, 16-byte loads where the rows are aligned)
// and keep max(sqrt, eps) in shared memory, while the producer fills the
// ring. The block writes its scores straight into the (Q, G) output with
// 16-byte stores (two threads trade halves of their fragments by one
// shuffle), masking the ragged edges: no padded copies.

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
constexpr int THREADS = 256;  // the consumer warps
constexpr int WARPS = THREADS / 32;
constexpr float EPS = 1e-6f;

static_assert(QT == GT, "one ring layout serves both operands");

// the score stage of the tensor-core kernel (kernels 1-3)
enum Mode { BF16 = 1, I8 = 2, F32 = 3 };
// the ladder's rungs and FULL (the production kernel)
enum Phase { STREAM = 0, MATMUL = 1, INSERT = 2, FULL = 3 };

bool bad_geometry(int Q, int G, int D, int k, int nsplit) {
  return k < 1 || k > TD * BINS || Q < 1 || G < 1 || D < 1 || nsplit < 1 ||
         nsplit > (G + GT - 1) / GT;
}

// ---------------------------------------------------------------------------
// Kernels 1-3: the tensor-core split kernel (f32, bf16 or int8) and its
// selection merge; kernel 4, the scores kernel (top of file)
// ---------------------------------------------------------------------------

constexpr int KC = 64;                        // bf16 elements per row per stage
constexpr int KC_I8 = 128;                    // int8 codes per row per stage
constexpr int KC_F32 = 32;                    // f32 words per row per stage
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
// f32 (kernels 1 and 4): the producer copies each stage's gallery tile
// into a ring of F32_GSTAGES raw tiles and its q̂ tile into one of two
// plane buffers, F32_LOOK stages behind the gallery; NCONV converter warps
// divide each gallery element by its row's norm and store its big and
// small parts beside that q̂ tile. A plane buffer: q̂ (64 MI rows), ĝ's big
// parts, ĝ's small parts (64 rows each). Kernel 1's ring bytes hold the
// two plane buffers and the raw ring.
constexpr int NCONV = 8;
constexpr int F32_THREADS = TC_THREADS + 32 * NCONV;
constexpr int F32_GSTAGES = 4;
constexpr int F32_PLANES = 2;
constexpr int F32_PLANE = 3 * TILE_BYTES;
constexpr int F32_LOOK = 2;
static_assert(F32_PLANES * F32_PLANE + F32_GSTAGES * TILE_BYTES ==
                  RING_BYTES,
              "kernel 1's plane buffers and raw ring take the ring's bytes");
// kernel 1's mbarriers: 2 per raw stage and per plane buffer
constexpr size_t F32_SMEM = TC_SMEM - (size_t)2 * STAGES * 8 +
                            (size_t)2 * (F32_GSTAGES + F32_PLANES) * 8;
static_assert(F32_SMEM <= 232448, "one block per SM");
constexpr unsigned FULL_MASK = 0xffffffffu;
static_assert(TC_SMEM <= 232448, "one block per SM");
static_assert(QT == 64 && THREADS == 256, "8 warps of 16 x 32 scores");
static_assert(KC * 2 == 128 && KC_I8 == 128 && KC_F32 * 4 == 128,
              "a stage holds 128 bytes of each row");

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

// x = big + small with big = tf32(x), small = tf32(x - big), each rounded to
// nearest, ties away from zero (cvt.rna: the low 13 bits cleared), as
// ops/retrieval.py tf32_round restates it
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(__uint_as_float(x)));
  const float r = __fsub_rn(__uint_as_float(x), __uint_as_float(big));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(r));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulators. Its
// fragments hold the 32-bit words that mma_bf16's hold (ldmatrix gives a
// thread one word of each 8x8 b16 matrix), 8 words of a row per step. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The f32 counterpart of load_stage_masked, for a D that is not a multiple
// of 4 (or rows not 16-byte aligned): `nrows` rows of a (rows, D) operand
// from row0, columns col0 .. col0 + 32, into the layout TMA's 128-byte
// swizzle gives at `dst` (rows of 128 B, 16-byte chunk c of row r at chunk
// c ^ (r % 8)), zeros past the operand's rows and D. Lane l moves chunk
// l % 8 (4 words) of rows l / 8 + 4i.
__device__ __forceinline__ void load_rows_masked_f32(uint32_t dst,
                                                     const float* src,
                                                     int row0, int rows,
                                                     int nrows, int D,
                                                     int col0, int lane) {
#pragma unroll 4
  for (int p = 0; p < nrows / 4; ++p) {
    const int r = (lane >> 3) + 4 * p, c = lane & 7;
    const int row = row0 + r, col = col0 + 4 * c;
    float w[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < rows) {
      const float* s = src + (size_t)row * D;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < D) w[e] = s[col + e];
    }
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst + r * 128 + ((c ^ (r & 7)) << 4)),
                 "f"(w[0]), "f"(w[1]), "f"(w[2]), "f"(w[3]));
  }
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts4(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ float sum4(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}
// v / n word by word (IEEE division, rounded to nearest even, as JAX's
// g / norm)
__device__ __forceinline__ float4 div4(float4 v, float n) {
  return make_float4(__fdiv_rn(v.x, n), __fdiv_rn(v.y, n), __fdiv_rn(v.z, n),
                     __fdiv_rn(v.w, n));
}
// the big and small parts (split_tf32) of the 4 words of v
__device__ __forceinline__ void split4(float4 v, uint4& big, uint4& small) {
  split_tf32(__float_as_uint(v.x), big.x, small.x);
  split_tf32(__float_as_uint(v.y), big.y, small.y);
  split_tf32(__float_as_uint(v.z), big.z, small.z);
  split_tf32(__float_as_uint(v.w), big.w, small.w);
}

// The 3xTF32 products of one f32 stage (32 words of each row) for a warp
// that owns MI x 16 query rows and 32 gallery rows, from the plane buffer:
// q̂'s rows at `q` (a_row[m], split in registers), ĝ's big and small parts
// at `gb` and `gs` (b_row[h]), all in the ring's swizzled layout;
// accumulated into part[4m + j] (n8 tile j): per 8-word step, small·big,
// then big·small, then big·big, each pass over every accumulator, so that
// consecutive products are independent.
template <int MI>
__device__ __forceinline__ void products_3xtf32(uint32_t q, uint32_t gb,
                                                uint32_t gs,
                                                const uint32_t* a_row,
                                                const uint32_t* b_row,
                                                int a_c, int b_c, int sw,
                                                float (*part)[4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[MI][4], as[MI][4];
#pragma unroll
    for (int m = 0; m < MI; ++m) {
      ldmatrix_x4(q + a_row[m] + (((2 * ks + a_c) ^ sw) << 4), a[m][0],
                  a[m][1], a[m][2], a[m][3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[m][i], a[m][i], as[m][i]);
    }
    uint32_t b[2][4], s[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = b_row[h] + (((2 * ks + b_c) ^ sw) << 4);
      ldmatrix_x4(gb + off, b[h][0], b[h][1], b[h][2], b[h][3]);
      ldmatrix_x4(gs + off, s[h][0], s[h][1], s[h][2], s[h][3]);
    }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t* bj = (pass == 1 ? s : b)[j >> 1] + 2 * (j & 1);
          mma_tf32(part[4 * m + j], pass == 0 ? as[m] : a[m], bj[0], bj[1]);
        }
  }
}

// A converter thread's part of an f32 stage (NCONV warps; thread ct owns
// chunks 2 (ct % 4) and + 1 of gallery row ct / 4; `off` their offset):
// the raw tile's words at `raw` are read, divided by n, split into big and
// small parts in registers, and, once `wait()` returns (the plane buffer
// is free), stored at gb and gs. The stores consume every loaded word, so
// once they are issued the raw tile may be released (a release before the
// loads' values are used let TMA's refill overtake them).
template <typename Wait>
__device__ __forceinline__ void convert_g(uint32_t raw, uint32_t gb,
                                          uint32_t gs, uint32_t off, float n,
                                          Wait wait) {
  uint4 big[2], small[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    split4(div4(lds4(raw + off + 16 * e), n), big[e], small[e]);
  wait();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sts4(gb + off + 16 * e, big[e]);
    sts4(gs + off + 16 * e, small[e]);
  }
}

// The f32 producer warp (kernels 1 and 4): for stage s of `total` (nk per
// gallery tile, the tile at gallery row base(s / nk)), the gallery tile into
// raw slot s % F32_GSTAGES (full / empty, released by the converters), and,
// F32_LOOK stages later, q̂'s MI boxes of 64 rows into plane buffer s %
// F32_PLANES (its pfull; once the consumers have released the buffer's
// previous stage on pempty). TMA where `tma`, else the warp's masked loads;
// a q̂ box wholly past Q is not copied (its rows are never stored).
template <int MI, typename Base>
__device__ __forceinline__ void produce_f32(
    const CUtensorMap* tmq, const CUtensorMap* tmg, const float* q,
    const float* g, int Q, int G, int D, bool tma, int lane, int q0,
    int total, int nk, Base base, uint32_t planes, uint32_t plane_bytes,
    uint32_t graw, uint32_t full, uint32_t empty, uint32_t pfull,
    uint32_t pempty) {
  const int qboxes = min(MI, (Q - q0 + 63) / 64);
  int gslot = 0, ord = 0, kc = 0;
  uint32_t ground = 0;
  for (int st = 0; st < total + F32_LOOK; ++st) {
    if (st < total) {
      if (ground) mbar_wait(empty + 8 * gslot, (ground - 1) & 1);
      const uint32_t dst = graw + gslot * TILE_BYTES, bar = full + 8 * gslot;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(bar, TILE_BYTES);
          tma_load_2d(dst, tmg, kc * KC_F32, base(ord), bar);
        }
      } else {
        load_rows_masked_f32(dst, g, base(ord), G, GT, D, kc * KC_F32, lane);
        mbar_arrive(bar);
      }
      if (++kc == nk) {
        kc = 0;
        ++ord;
      }
      if (++gslot == F32_GSTAGES) {
        gslot = 0;
        ++ground;
      }
    }
    if (st >= F32_LOOK) {
      const int s = st - F32_LOOK, p = s % F32_PLANES, kq = s % nk;
      if (s >= F32_PLANES)
        mbar_wait(pempty + 8 * p, (s / F32_PLANES - 1) & 1);
      const uint32_t dst = planes + p * plane_bytes, bar = pfull + 8 * p;
      if (tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(bar, qboxes * TILE_BYTES);
          for (int b = 0; b < qboxes; ++b)
            tma_load_2d(dst + b * TILE_BYTES, tmq, kq * KC_F32, q0 + 64 * b,
                        bar);
        }
      } else {
        load_rows_masked_f32(dst, q, q0, Q, 64 * MI, D, kq * KC_F32, lane);
        mbar_arrive(bar);
      }
    }
  }
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

// The tensor-core split kernel of score stage M (F32: kernel 1, BF16:
// kernel 2, I8: kernel 3), phase P (top of file): FULL writes cand_v /
// cand_i (Q, nsplit, k), each split's top-k set, and tth (Q, nsplit), its
// deepest stored values; STREAM and MATMUL write one value per (query
// row, split) into tth; INSERT writes the first k buffer lanes into cand_v
// / cand_i. Grid (query tiles, nsplit), TC_THREADS threads (8 consumer
// warps, then the producer warp that fills the ring; F32: then NCONV
// converter warps), TC_SMEM bytes: the ring, then the buffers (values f32
// [TD][QT][BINS], tile ordinals u16 likewise; bin b of row q at b ^ (8 *
// (q % 4)), which keeps the two neighbouring bins of an entry pair together
// and spreads a warp's rows over the banks). A stage holds 128 bytes of
// each row: 32 f32 words, 64 bf16 or 128 int8 codes. F32 only: q and g
// are f32, gscale the gallery's norms (G,), F32_THREADS threads and
// F32_SMEM bytes; the ring's bytes hold two plane buffers and the raw
// gallery ring (produce_f32); the converter warps divide each gallery
// element by max(norm, eps) and store its 3xTF32 big and small parts in
// the plane buffer beside its stage's q̂ tile (convert_g), and the
// consumers split q̂ in registers. Its STREAM rung: the converters fold
// every gallery word and norm, the consumers every q̂ word, into the rows'
// sums. I8 only: qscale
// (Q,) and gscale (G,), each score (float)acc * (qscale[q] * gscale[g]);
// the int8 rows' STREAM sums are the exact int32 sums of their codes. The
// parameters of the bf16 instance come first, so that it keeps its layout
// (and its SASS).
template <int M, int P>
__global__ void __launch_bounds__(M == F32 ? F32_THREADS : TC_THREADS, 1)
fused_topk_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmg,
                     const uint16_t* __restrict__ q,
                     const uint16_t* __restrict__ g, int Q, int G, int D,
                     int k, int nsplit, bool tma, float* __restrict__ cand_v,
                     int* __restrict__ cand_i, float* __restrict__ tth,
                     const float* __restrict__ qscale,
                     const float* __restrict__ gscale) {
  static_assert(P >= STREAM && P <= FULL, "a phase of the split kernel");
  static_assert(M == BF16 || M == I8 || M == F32, "a tensor-core score stage");
  // elements per row per stage
  constexpr int KE = M == I8 ? KC_I8 : (M == F32 ? KC_F32 : KC);
  using Acc = std::conditional_t<M == I8, int, float>;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  // the ring at the first 1024-byte boundary, then the buffers
  unsigned char* sm = smem_bf16 + ((1024 - smem_u32(smem_bf16) % 1024) % 1024);
  float* bufv = reinterpret_cast<float*>(sm + RING_BYTES);
  uint16_t* bufo = reinterpret_cast<uint16_t*>(bufv + BUF);
  const uint32_t ring = smem_u32(sm);
  // stage s is in: full[s] (TMA: one arrival and the stage's bytes; else
  // 32 arrivals of the producer's lanes); every consumer warp is done with
  // it: empty[s] (8 arrivals). F32: full / empty are the raw gallery
  // ring's (empty: NCONV converter warps); plane buffer p is complete:
  // pfull[p] (every converter thread, and the producer's q̂ copy); read:
  // pempty[p] (8 arrivals)
  constexpr int NS = M == F32 ? F32_GSTAGES : STAGES;  // raw stages
  constexpr int NT = M == F32 ? F32_THREADS : TC_THREADS;
  const uint32_t full = smem_u32(bufo + BUF), empty = full + 8 * NS;
  [[maybe_unused]] const uint32_t pfull = empty + 8 * NS,
                                 pempty = pfull + 8 * F32_PLANES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT, split = blockIdx.y;
  // this thread's scores: rows qa and qa + 8, bins bn + 8j + {0, 1}
  const int wq = warp >> 1, wn = warp & 1;
  const int qa = 16 * wq + (lane >> 2), bn = 32 * wn + 2 * (lane & 3);

  if constexpr (P >= INSERT) {
    for (int e = tid; e < BUF; e += NT) {
      bufv[e] = -CUDART_INF_F;
      bufo[e] = 0;
    }
  }
  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + 8 * st, tma ? 1 : 32);
      mbar_init(empty + 8 * st, M == F32 ? NCONV : WARPS);
    }
    if constexpr (M == F32) {
      for (int p = 0; p < F32_PLANES; ++p) {
        mbar_init(pfull + 8 * p, 32 * NCONV + (tma ? 1 : 32));
        mbar_init(pempty + 8 * p, WARPS);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ntiles = (G + GT - 1) / GT;
  const int my_tiles = (ntiles - split + nsplit - 1) / nsplit;
  const int nk = (D + KE - 1) / KE;
  const int total = my_tiles * nk;

  if constexpr (M == F32) {
    if (warp == WARPS) {
      produce_f32<1>(&tmq, &tmg, reinterpret_cast<const float*>(q),
                     reinterpret_cast<const float*>(g), Q, G, D, tma, lane,
                     q0, total, nk,
                     [&](int ord) { return (split + ord * nsplit) * GT; },
                     ring, F32_PLANE, ring + F32_PLANES * F32_PLANE, full,
                     empty, pfull, pempty);
      __syncwarp();
      __syncthreads();  // the consumers' last barrier
      return;
    }
  }
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
  if constexpr (M == F32) {
    if (warp > WARPS) {
      // the converters: thread ct owns chunks 2 (ct % 4) and + 1 of tile
      // row r = ct / 4 (convert_g)
      const int ct = tid - (WARPS + 1) * 32, r = ct >> 2;
      const uint32_t off = r * 128 + ((2 * (ct & 3)) << 4);
      int ord = 0, kc = 0, slot = 0;
      uint32_t round = 0;
      float gnv = 1.f;
      [[maybe_unused]] float rsum = 0.f;
      for (int it = 0; it < total; ++it) {
        if (kc == 0) {  // the tile's norm of row r
          const int gr = (split + ord * nsplit) * GT + r;
          if constexpr (P == STREAM) {
            if ((ct & 3) == 0) rsum += gr < G ? gscale[gr] : 0.f;
          } else {
            gnv = gr < G ? fmaxf(gscale[gr], EPS) : 1.f;
          }
        }
        mbar_wait(full + 8 * slot, round & 1);
        const uint32_t raw = ring + F32_PLANES * F32_PLANE + slot * TILE_BYTES;
        const int p = it % F32_PLANES;
        const uint32_t pl = ring + p * F32_PLANE;
        auto wait_plane = [&] {  // the buffer's previous stage is consumed
          if (it >= F32_PLANES)
            mbar_wait(pempty + 8 * p, (it / F32_PLANES - 1) & 1);
        };
        if constexpr (P == STREAM) {
          wait_plane();
          rsum += sum4(lds4(raw + off)) + sum4(lds4(raw + off + 16));
          // a store of the sum (into the idle ĝ part of the plane buffer)
          // orders the loads before the release
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(pl + TILE_BYTES +
                                                        4 * ct),
                       "f"(rsum)
                       : "memory");
        } else {
          convert_g(raw, pl + TILE_BYTES, pl + 2 * TILE_BYTES, off, gnv,
                    wait_plane);
        }
        mbar_arrive(pfull + 8 * p);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * slot);  // the raw tile is free
        if (++slot == NS) {
          slot = 0;
          ++round;
        }
        if (++kc == nk) {
          kc = 0;
          ++ord;
        }
      }
      if constexpr (P == STREAM) {
        rsum += __shfl_xor_sync(FULL_MASK, rsum, 1);
        rsum += __shfl_xor_sync(FULL_MASK, rsum, 2);
        // the gallery half of the row's sum, for the consumers (the
        // buffers are idle in this rung)
        if ((ct & 3) == 0) bufv[r] = rsum;
      }
      __syncthreads();  // the consumers' last barrier
      return;
    }
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

  // two sets of accumulators, a score is their sum: bf16 and int8, even
  // and odd 32-byte steps, so that each chain of dependent mma is half as
  // long; f32, the running score (acc[0], IEEE additions) and the current
  // stage's 3xTF32 sum from zero (acc[1]), so that the tensor cores'
  // additions, which round toward zero, act on a stage's sum only
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
    // f32: plane buffer it % 2, else ring stage `slot`
    if constexpr (M == F32)
      mbar_wait(pfull + 8 * (it % F32_PLANES), (it / F32_PLANES) & 1);
    else
      mbar_wait(full + 8 * slot, round & 1);
    const uint32_t sq = M == F32 ? ring + (it % F32_PLANES) * F32_PLANE
                                 : ring + slot * STAGE_BYTES;
    const uint32_t sg = sq + TILE_BYTES;
    if constexpr (M == F32 && P == STREAM) {
      // every q̂ word of the stage, folded into its rows' sums
      const int r = tid >> 3, c = tid & 7;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 32 * h;
        rowsum[h] += sum4(lds4(sq + rr * 128 + ((c ^ (rr & 7)) << 4)));
      }
    } else if constexpr (M == F32) {
      // the running score takes the last stage's sum; this stage's from 0
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[0][j][c] += acc[1][j][c];
          acc[1][j][c] = 0.f;
        }
      products_3xtf32<1>(sq, sg, sg + TILE_BYTES, &a_row, b_row, a_c, b_c,
                         sw, acc[1]);
    } else if constexpr (P == STREAM) {
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
    if (lane == 0)  // the slot (f32: the plane buffer) is free
      mbar_arrive(M == F32 ? pempty + 8 * (it % F32_PLANES) : empty + 8 * slot);
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
      if constexpr (M == F32)  // + the converters' gallery half
        v += bufv[(tid >> 3) + 32 * h];
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
    // the consumer warps alone (the producer, and the converters, have
    // left): named barrier 1
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

// Kernel 4 (top of file): the (Q, G) f32 scores of q̂ (Q, D) against the raw
// gallery (G, D) normalized by its rows' norms, computed here. Grid (query
// tiles of QB = 64 MI rows, gallery tiles of GT rows), F32_THREADS threads
// (8 consumer warps, the producer warp, NCONV converter warps), as
// fused_topk_tc_kernel<F32> runs them (produce_f32, convert_g,
// products_3xtf32): F32_PLANES plane buffers (q̂'s QB rows, ĝ's big parts,
// its small parts), the raw gallery ring of F32_GSTAGES tiles, the tile's
// norms and the mbarriers. Warp w owns query rows 16 MI (w / 2) .. + 16 MI
// and gallery rows 32 (w % 2) .. + 32. `vec`: 16-byte stores (G % 4 == 0
// and out 16-byte aligned).
template <int MI>
__global__ void __launch_bounds__(F32_THREADS, 1)
cosine_scores_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                        const __grid_constant__ CUtensorMap tmg,
                        const float* __restrict__ q,
                        const float* __restrict__ g, int Q, int G, int D,
                        bool tma, bool vec, float* __restrict__ out) {
  constexpr int QBYTES = 64 * MI * 128, PLB = QBYTES + 2 * TILE_BYTES;
  extern __shared__ __align__(16) unsigned char smem_sc[];
  unsigned char* sm = smem_sc + ((1024 - smem_u32(smem_sc) % 1024) % 1024);
  const uint32_t planes = smem_u32(sm), graw = planes + F32_PLANES * PLB;
  float* gn = reinterpret_cast<float*>(sm + F32_PLANES * PLB +
                                       F32_GSTAGES * TILE_BYTES);  // [GT]
  const uint32_t full = smem_u32(gn + GT), empty = full + 8 * F32_GSTAGES;
  const uint32_t pfull = empty + 8 * F32_GSTAGES,
                 pempty = pfull + 8 * F32_PLANES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * 64 * MI, g0 = blockIdx.y * GT;
  if (tid == 0) {
    for (int st = 0; st < F32_GSTAGES; ++st) {
      mbar_init(full + 8 * st, tma ? 1 : 32);
      mbar_init(empty + 8 * st, NCONV);
    }
    for (int p = 0; p < F32_PLANES; ++p) {
      mbar_init(pfull + 8 * p, 32 * NCONV + (tma ? 1 : 32));
      mbar_init(pempty + 8 * p, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = (D + KC_F32 - 1) / KC_F32;

  if (warp == WARPS) {
    produce_f32<MI>(&tmq, &tmg, q, g, Q, G, D, tma, lane, q0, nk, nk,
                    [&](int) { return g0; }, planes, PLB, graw, full, empty,
                    pfull, pempty);
    return;
  }

  if (warp > WARPS) {
    // the converters. First the tile's norms, while the producer fills the
    // ring: converter warp cw sums the squares of rows cw + NCONV i over
    // the whole of D, four rows at once (fmaf per lane, then a butterfly),
    // 16-byte loads where the rows are whole aligned chunks
    const int ct = tid - (WARPS + 1) * 32, cw = ct >> 5;
    static_assert(GT % (4 * NCONV) == 0, "rows of the norm pass");
    for (int i0 = 0; i0 < GT / NCONV; i0 += 4) {
      float ss[4] = {0.f, 0.f, 0.f, 0.f};
      const float* row[4];
      bool in[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g0 + cw + NCONV * (i0 + e);
        in[e] = r < G;
        row[e] = g + (size_t)(in[e] ? r : 0) * D;
      }
      if (tma) {
#pragma unroll 3
        for (int c = lane; c < D / 4; c += 32)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!in[e]) continue;
            const float4 v = __ldg(reinterpret_cast<const float4*>(row[e]) + c);
            ss[e] = fmaf(v.x, v.x, ss[e]);
            ss[e] = fmaf(v.y, v.y, ss[e]);
            ss[e] = fmaf(v.z, v.z, ss[e]);
            ss[e] = fmaf(v.w, v.w, ss[e]);
          }
      } else {
#pragma unroll 4
        for (int c = lane; c < D; c += 32)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (in[e]) ss[e] = fmaf(row[e][c], row[e][c], ss[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int off = 16; off; off >>= 1)
          ss[e] += __shfl_xor_sync(FULL_MASK, ss[e], off);
        if (lane == 0)
          gn[cw + NCONV * (i0 + e)] = in[e] ? fmaxf(__fsqrt_rn(ss[e]), EPS)
                                            : 1.f;
      }
    }
    // the converter warps alone: named barrier 2
    asm volatile("bar.sync 2, %0;\n" ::"n"(32 * NCONV) : "memory");
    // then, per stage, thread ct owns chunks 2 (ct % 4) and + 1 of gallery
    // row ct / 4 (convert_g)
    const float gnv = gn[ct >> 2];
    const uint32_t off = (ct >> 2) * 128 + ((2 * (ct & 3)) << 4);
    int slot = 0;
    uint32_t round = 0;
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(full + 8 * slot, round & 1);
      const int p = kc % F32_PLANES;
      const uint32_t pl = planes + p * PLB;
      convert_g(graw + slot * TILE_BYTES, pl + QBYTES,
                pl + QBYTES + TILE_BYTES, off, gnv, [&] {
                  if (kc >= F32_PLANES)  // the plane buffer is free
                    mbar_wait(pempty + 8 * p, (kc / F32_PLANES - 1) & 1);
                });
      mbar_arrive(pfull + 8 * p);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);  // the raw tile is free
      if (++slot == F32_GSTAGES) {
        slot = 0;
        ++round;
      }
    }
    return;
  }

  // the consumers
  const int wq = warp >> 1, wn = warp & 1;
  const int sw = lane & 7, a_c = lane >> 4, b_c = (lane >> 3) & 1;
  uint32_t a_row[MI], b_row[2];
#pragma unroll
  for (int m = 0; m < MI; ++m)
    a_row[m] = (16 * MI * wq + 16 * m + (lane & 15)) * 128;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    b_row[h] = (32 * wn + 16 * h + (lane & 7) + ((lane >> 4) << 3)) * 128;

  // the running scores (IEEE additions) and the current stage's 3xTF32
  // sum from zero, as fused_topk_tc_kernel<F32> keeps them
  float tot[4 * MI][4], part[4 * MI][4];
#pragma unroll
  for (int j = 0; j < 4 * MI; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) tot[j][c] = part[j][c] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    const int p = kc % F32_PLANES;
    mbar_wait(pfull + 8 * p, (kc / F32_PLANES) & 1);
    const uint32_t pl = planes + p * PLB;
#pragma unroll
    for (int j = 0; j < 4 * MI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        tot[j][c] += part[j][c];
        part[j][c] = 0.f;
      }
    products_3xtf32<MI>(pl, pl + QBYTES, pl + QBYTES + TILE_BYTES, a_row,
                        b_row, a_c, b_c, sw, part);
    __syncwarp();
    if (lane == 0) mbar_arrive(pempty + 8 * p);  // the buffer is free
  }

  // the scores: thread (g, t) holds, per n8 tile j, row g columns 2t, 2t+1
  // and row g + 8 the same columns; threads t and t ^ 1 trade halves, so
  // that an even t holds 4 columns of row g and an odd t 4 of row g + 8
  const int odd = lane & 1;
  const int col_in = 2 * (lane & 3) - 2 * odd;  // the 4 columns' first
#pragma unroll
  for (int m = 0; m < MI; ++m) {
    const int row = q0 + 16 * MI * wq + 16 * m + (lane >> 2) + 8 * odd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = tot[4 * m + j][c] + part[4 * m + j][c];
      const float x0 = __shfl_xor_sync(FULL_MASK, odd ? s[0] : s[2], 1);
      const float x1 = __shfl_xor_sync(FULL_MASK, odd ? s[1] : s[3], 1);
      const float4 v = odd ? make_float4(x0, x1, s[2], s[3])
                           : make_float4(s[0], s[1], x0, x1);
      const int col = g0 + 32 * wn + 8 * j + col_in;
      if (row < Q) {
        float* dst = out + (size_t)row * G + col;
        if (vec && col + 3 < G) {
          __stcs(reinterpret_cast<float4*>(dst), v);
        } else {
          if (col < G) dst[0] = v.x;
          if (col + 1 < G) dst[1] = v.y;
          if (col + 2 < G) dst[2] = v.z;
          if (col + 3 < G) dst[3] = v.w;
        }
      }
    }
  }
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
  constexpr int esize = M == I8 ? 1 : (M == F32 ? 4 : 2);
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)QT};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map,
             M == I8    ? CU_TENSOR_MAP_DATA_TYPE_UINT8
             : M == F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA copies a (rows, D) operand of score stage M when its rows are whole
// 16-byte chunks (D % 4 f32, D % 8 bf16, D % 16 int8) and it is 16-byte
// aligned; else the producer's masked loads run.
template <int M>
bool tma_ok(const void* p, int D) {
  return D % (16 / (M == I8 ? 1 : (M == F32 ? 4 : 2))) == 0 &&
         (uintptr_t)p % 16 == 0;
}

// Launches phase P of the tensor-core split kernel of score stage M on
// `st`, by TMA where both operands take it (tma_ok).
template <int M, int P>
cudaError_t launch_tc(const void* q, const void* g, const float* qscale,
                      const float* gscale, int Q, int G, int D, int k,
                      int nsplit, float* cand_v, int* cand_i, float* tth,
                      cudaStream_t st) {
  CUtensorMap tmq, tmg;
  memset(&tmq, 0, sizeof tmq);
  memset(&tmg, 0, sizeof tmg);
  const bool tma = tma_ok<M>(q, D) && tma_ok<M>(g, D);
  if (tma && (!tile_map<M>(&tmq, q, Q, D) || !tile_map<M>(&tmg, g, G, D)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = M == F32 ? F32_SMEM : TC_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_tc_kernel<M, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + QT - 1) / QT, nsplit);
  fused_topk_tc_kernel<M, P>
      <<<grid, M == F32 ? F32_THREADS : TC_THREADS, smem, st>>>(
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

// Kernels 1-3: the tensor-core split kernel, then the selection merge.
// Also needs at most 65,536 gallery tiles per split and nsplit * k <=
// 20,480. f32: q̂ (Q, D) f32, raw gallery (G, D) f32, gscale its row norms
// (G,). bf16: q̂ (Q, D) bf16, pre-normalized gallery (G, D) bf16, gscale
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

// Kernel 4 with QB = 64 MI query rows per block, on `st`.
template <int MI>
cudaError_t launch_scores(const float* q, const float* g, int Q, int G, int D,
                          float* out, cudaStream_t st) {
  CUtensorMap tmq, tmg;
  memset(&tmq, 0, sizeof tmq);
  memset(&tmg, 0, sizeof tmg);
  const bool tma = tma_ok<F32>(q, D) && tma_ok<F32>(g, D);
  if (tma && (!tile_map<F32>(&tmq, q, Q, D) || !tile_map<F32>(&tmg, g, G, D)))
    return cudaErrorInvalidValue;
  // alignment slack, the plane buffers, the raw ring, the norms, the
  // mbarriers
  const size_t smem = 1024 + (size_t)F32_PLANES * (64 * MI + 2 * GT) * 128 +
                      (size_t)F32_GSTAGES * GT * 128 + GT * 4 +
                      (size_t)(2 * F32_GSTAGES + 2 * F32_PLANES) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      cosine_scores_tc_kernel<MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = G % 4 == 0 && (uintptr_t)out % 16 == 0;
  dim3 grid((Q + 64 * MI - 1) / (64 * MI), (G + GT - 1) / GT);
  cosine_scores_tc_kernel<MI><<<grid, F32_THREADS, smem, st>>>(
      tmq, tmg, q, g, Q, G, D, tma, vec, out);
  return cudaGetLastError();
}
}  // namespace

extern "C" {

// Each fused top-k entry launches its kernels on `stream` and returns
// cudaGetLastError() (0 = ok; cudaErrorInvalidValue for a geometry or a
// workspace it does not take). `work` is the call's workspace of `words`
// words (Work, above): the outputs vals, inds (Q, k) and ok (Q) are its
// first words. 1 <= nsplit <= number of 64-row gallery tiles.

// q̂ (Q, D) f32, raw gallery (G, D) f32 and its row norms (G,).
int fused_topk_f32(const float* q, const float* g, const float* gnorm, int Q,
                   int G, int D, int k, int nsplit, int bins, int t_depth,
                   void* work, long long words, void* stream) {
  return launch_fused_tc<F32>(q, g, gnorm, Q, G, D, k, nsplit, bins,
                              t_depth, work, words, stream);
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
#define LADDER_RUNG(name, M, P)                                            \
  int name(const void* q, const void* g, const float* gnorm, int Q, int G, \
           int D, int k, int nsplit, float* out_v, int* out_i,            \
           void* stream) {                                                \
    if (bad_tc_geometry(Q, G, D, k, nsplit))                              \
      return (int)cudaErrorInvalidValue;                                  \
    return (int)launch_tc<M, P>(q, g, nullptr, gnorm, Q, G, D, k, nsplit, \
                                out_v, out_i, out_v,                      \
                                reinterpret_cast<cudaStream_t>(stream));  \
  }
LADDER_RUNG(fused_topk_f32_stream_only, F32, STREAM)
LADDER_RUNG(fused_topk_f32_matmul_only, F32, MATMUL)
LADDER_RUNG(fused_topk_f32_insert_only, F32, INSERT)
LADDER_RUNG(fused_topk_bf16_stream_only, BF16, STREAM)
LADDER_RUNG(fused_topk_bf16_matmul_only, BF16, MATMUL)
LADDER_RUNG(fused_topk_bf16_insert_only, BF16, INSERT)
#undef LADDER_RUNG
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
// gallery (G, D), both f32, into out (Q, G); blocks of 128 query rows
// where Q > 64, else 64, by 64 gallery rows. Returns cudaGetLastError().
int cosine_scores_f32(const float* q, const float* g, int Q, int G, int D,
                      float* out, void* stream) {
  if (Q < 1 || G < 1 || D < 1 || (G + GT - 1) / GT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(Q > 64 ? launch_scores<2>(q, g, Q, G, D, out, st)
                      : launch_scores<1>(q, g, Q, G, D, out, st));
}

const char* fused_topk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
