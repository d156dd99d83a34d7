// Image kernels of on-device AutoAugment for Hopper (sm_90a): per-plane
// histogram, per-plane LUT apply, and the integer and cubic per-row shifts.
//
// Replace the TPU kernels of imageretrievalresearch_tpu/ops/pallas_image.py:
// - image_histogram       <- _hist_kernel (pallas_histogram)
// - image_lut_apply       <- _lut_kernel (pallas_lut_apply)
// - image_row_shift_cubic <- _row_shift_cubic_kernel (pallas_row_shift_cubic)
// - image_row_shift       <- _row_shift_kernel (pallas_row_shift)
// Plain versions and wrappers: imageretrievalresearch_tpu_torch/ops/
// image_kernels.py.
//
// The TPU kernels are chains of rolls and selects (256 select passes per
// plane for the histogram and the LUT; radix-factored roll passes for the
// shifts) because a TPU has no gather. A GPU gathers from shared memory at
// full rate, so each kernel here is one direct pass:
// - histogram: a block counts a chunk of one plane into a shared-memory
//   histogram with integer atomicAdd, then adds it to the plane's row in
//   device memory (zeroed by the wrapper). Integer atomics give exact counts
//   in any order.
// - LUT apply: a block stages its plane's 256 entries in shared memory, then
//   makes one pass of reads and writes over a chunk of the plane. Entries
//   must lie in [0, 255] (both callers clip them): planes are read and
//   written as uint8.
// - row shifts: a block stages consecutive rows in shared memory and writes
//   each output pixel from the staged row: one tap for the integer shift,
//   four for the cubic one, with the fill value outside [0, W).
//
// Bound: each moves its input and its output once: at the AutoAugment
// path's shapes (192 planes of 224 x 224, or 43,008 rows of 224) 9.6 MB in
// and 9.6 MB out, ~5.8 us at 3.35 TB/s (H100 SXM; the histogram writes 256
// counts per plane, ~2.9 us), so all four are bound by device memory. The cubic shift comes closest to its operation bound:
// ~37 f32 operations per pixel (four weight polynomials, the weighted sum,
// the division) are ~5.3 us at 67 TFLOP/s. Loads and stores here are single
// bytes; 16-byte vector accesses are later work.
//
// The cubic shift is the TPU kernel's arithmetic op for op: the a = -1
// weights of autoaugment._cubic_kernel (both branches, then the select),
// the taps summed in the order -1, 0, 1, 2, the division by
// max(wsum, 1e-8), the validity mask on the source position, round half to
// even, clip. Products, sums and the division are __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, so nvcc contracts nothing into FMAs and the kernel
// is bitwise equal to its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// pixels of one plane per block (histogram, LUT)
constexpr int CHUNK = 8192;
// bytes of consecutive rows a row-shift block stages in shared memory
constexpr int STAGE_BYTES = 8192;
// widest row a block can stage (the default dynamic shared-memory limit)
constexpr int MAX_W = 48 * 1024;

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

__global__ void __launch_bounds__(THREADS)
lut_kernel(const uint8_t* __restrict__ planes, const int* __restrict__ lut,
           int hw, uint8_t* __restrict__ out) {
  __shared__ uint8_t table[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    table[i] = (uint8_t)lut[(size_t)blockIdx.y * 256 + i];
  __syncthreads();
  const size_t base = (size_t)blockIdx.y * hw;
  const int lo = blockIdx.x * CHUNK;
  const int hi = min(lo + CHUNK, hw);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    out[base + i] = table[planes[base + i]];
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

__global__ void __launch_bounds__(THREADS)
row_shift_kernel(const uint8_t* __restrict__ rows,
                 const int* __restrict__ shifts, int n, int w, int rpb,
                 int fill, uint8_t* __restrict__ out) {
  extern __shared__ uint8_t staged[];
  const int n0 = blockIdx.x * rpb;
  const int nr = min(rpb, n - n0);
  const size_t base = (size_t)n0 * w;
  stage_rows(rows, base, nr * w, staged);
  for (int i = threadIdx.x; i < nr * w; i += blockDim.x) {
    const int r = i / w;
    const int x = i - r * w;
    const long long src = (long long)x + shifts[n0 + r];
    out[base + i] = (src >= 0 && src < w) ? staged[r * w + src]
                                          : (uint8_t)fill;
  }
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

bool planes_ok(int p, int hw) {
  return p >= 1 && p <= 65535 && hw >= 1;
}

dim3 plane_grid(int p, int hw) {
  return dim3((hw + CHUNK - 1) / CHUNK, p);
}

// rows per row-shift block; the block stages rows_per_block(w) * w bytes
int rows_per_block(int w) { return w >= STAGE_BYTES ? 1 : STAGE_BYTES / w; }

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
  if (!planes_ok(p, hw)) return (int)cudaErrorInvalidValue;
  lut_kernel<<<plane_grid(p, hw), THREADS, 0,
               reinterpret_cast<cudaStream_t>(stream)>>>(planes, lut, hw,
                                                         out);
  return (int)cudaGetLastError();
}

// rows (N, W) uint8, shifts (N,) int32 -> out (N, W) uint8,
// out(n, x) = rows(n, x + shifts(n)), `fill` outside [0, W).
int image_row_shift(const uint8_t* rows, const int* shifts, int n, int w,
                    int fill, uint8_t* out, void* stream) {
  if (n < 1 || w < 1 || w > MAX_W) return (int)cudaErrorInvalidValue;
  const int rpb = rows_per_block(w);
  row_shift_kernel<<<(n + rpb - 1) / rpb, THREADS, (size_t)rpb * w,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      rows, shifts, n, w, rpb, fill, out);
  return (int)cudaGetLastError();
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
