// Row-block stream probe for Hopper (sm_90a): a read ceiling of device
// memory as a kernel of this repository sees it.
//
// Replaces the row-block stream kernel of tools/profile_fused_kernel.py
// (main, the Pallas kernel that sums (rows, 1536) f32 blocks of a
// (G_pad, 1536) array into (rows, 1)): for x (N, D) f32 with N a multiple
// of `rows`, out[r] = sum over i and d of x[i * rows + r, d].
// Plain version and wrapper: imageretrievalresearch_tpu_torch/tools/
// profile_fused_kernel.py (stream_probe, stream_probe_reference).
//
// Bound: the array read once, N·D·4 bytes over 3.35 TB/s (the H100 SXM's
// data sheet rate at 700 W): 616.6 MB, 0.184 ms at N = 100,352, D = 1536;
// the N·D adds take ~0.002 ms at 67 TFLOP/s. The probe exists to measure
// how close a plain streaming kernel comes to that rate, so its design
// only has to keep enough bytes in flight:
// - pass 1, one warp per row of x: each lane reads 16-byte words
//   (neighbouring lanes on neighbouring addresses; scalar loads when D is
//   not a multiple of 4 or x is not 16-byte aligned), sums them in order,
//   and the warp sums its lanes by a butterfly into rowsum[n]. N / 8
//   blocks of 256 threads fill the 132 SMs many times over.
// - pass 2, one thread per r: out[r] = rowsum[r] + rowsum[rows + r] + ...
//   in i order. Every sum has a fixed order, so the result is the same
//   from run to run: no atomics. rowsum adds N·4 bytes of writes and
//   reads (0.4 MB at N = 100,352, 0.07% of the array).
// CUDA rather than Triton keeps the port to one build path (nvcc).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
row_sum_kernel(const float* __restrict__ x, int N, int D, bool vec,
               float* __restrict__ rowsum) {
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + threadIdx.x / 32;
  if (n >= N) return;  // warp-uniform
  const float* row = x + (size_t)n * D;
  float s = 0.f;
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
    for (int c = lane; c < D / 4; c += 32) {
      const float4 v = __ldg(row4 + c);
      s += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int c = lane; c < D; c += 32) s += __ldg(row + c);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) rowsum[n] = s;
}

__global__ void __launch_bounds__(THREADS)
fold_kernel(const float* __restrict__ rowsum, int nblk, int rows,
            float* __restrict__ out) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= rows) return;
  float s = 0.f;
  for (int i = 0; i < nblk; ++i) s += rowsum[(size_t)i * rows + r];
  out[r] = s;
}

}  // namespace

extern "C" {

// x (N, D) f32, N a multiple of rows; scratch rowsum (N,) f32; out (rows,)
// f32. Launches both passes on `stream`; returns cudaGetLastError().
int stream_probe_f32(const float* x, int N, int D, int rows, float* rowsum,
                     float* out, void* stream) {
  if (N < 1 || D < 1 || rows < 1 || N % rows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && (uintptr_t)x % 16 == 0;
  row_sum_kernel<<<(N + WARPS - 1) / WARPS, THREADS, 0, st>>>(x, N, D, vec,
                                                              rowsum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_kernel<<<(rows + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      rowsum, N / rows, rows, out);
  return (int)cudaGetLastError();
}

const char* stream_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
