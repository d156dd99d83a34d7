// Depthwise convolution for Hopper (sm_90a): the forward (also used for the
// input gradient) and the tap gradients.
//
// Replace the TPU kernels of imageretrievalresearch_tpu/ops/pallas_conv.py:
// - dw_conv_forward <- _dw_fwd_kernel (_pallas_dw); _dw_op_bwd runs it for
//   dx too, with flipped taps on the (dilated) cotangent
// - dw_conv_grad_w  <- _dw_grad_w_kernel (_pallas_dw_grad_w)
// Plain versions, wrappers and the autograd wiring (flip, dilation, high
// pad): imageretrievalresearch_tpu_torch/ops/depthwise.py.
//
// Semantics: torch Conv2d(C, C, K, stride, padding=K//2, groups=C,
// bias=False) for odd K <= 7 and stride 1 or 2; the output size is
// (H + 2p - K) / s + 1. Tensors are NHWC with C innermost: that is the
// memory order of the port's model on the card (its NHWC input, permuted to
// NCHW, makes cuDNN run channels-last throughout), so the depthwise layers
// read and write the activations in place, with no layout copy. Taps arrive
// as f32 (K*K, C), accumulation is f32, the output is x's type (f32 or
// bf16).
//
// Bound: one pass reads its input once and writes its output once. For the
// 26 depthwise layers of efficientnet_b3a at 224 px and a batch of 192 in
// bf16 that is ~4.6 GB per pass, ~1.4 ms at 3.35 TB/s (H100 SXM), against
// ~27 GFLOP of f32 multiply-adds, ~0.4 ms at 67 TFLOP/s: every pass is bound
// by device memory.
//
// Design, forward: a block owns an output tile of th x tw pixels of one
// image and cb channels (cb = C up to 64, else 64 or 32, chosen by the
// wrapper's tile plan to keep the tile under 48 KB). It stages the input
// tile plus its halo ((th-1)*s + K by (tw-1)*s + K pixels) in shared memory
// as f32, zeros where the padding falls, channels fastest, so the loads
// from device memory are runs of cb channels along a row and neighbouring
// threads read neighbouring shared-memory words. Each thread owns one
// channel and a strided set of the tile's pixels; its K*K taps sit in
// registers. Stride 2 reads the staged tile with strided addressing (the
// TPU kernel's polyphase split and halo'd row tiles exist only for Mosaic's
// limits). Products and sums are __fmul_rn / __fadd_rn in the tap order
// (row, then column), so nvcc contracts nothing into FMAs and the kernel is
// bitwise equal to its plain version.
//
// Design, tap gradients: on the TPU one output block is revisited by a
// sequential grid and accumulated in place. Here blocks run in parallel and
// in no order, so each block writes its own partial sums: block (split,
// channel block) walks a fixed range of (image, tile) items, staging each x
// tile as the forward does; each thread accumulates x * g for its channel
// and pixels into K*K f32 registers; the threads of one channel are summed
// in slot order through shared memory, and a second kernel sums the splits
// in order. Every sum has a fixed order, so repeated runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// the tile plan keeps a block's shared memory under the static limit
constexpr int MAX_SMEM = 48 * 1024;

struct Geom {
  int n, h, w, c;        // input, NHWC
  int ho, wo;            // output
  int th, tw, cb;        // output tile and channels of one block
  int tiles_w, tiles;    // tiles across a row of tiles, tiles per image
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stages the input tile of output tile `t` of image `n` (channels c0 ..
// c0 + cb) in shared memory, f32, zero outside the image and past C.
template <typename T, int K, int S>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x,
                                           const Geom& g, int n, int t,
                                           int c0, float* tile) {
  const int th_in = (g.th - 1) * S + K, tw_in = (g.tw - 1) * S + K;
  const int h0 = (t / g.tiles_w) * g.th * S - K / 2;
  const int w0 = (t % g.tiles_w) * g.tw * S - K / 2;
  const int cn = min(g.cb, g.c - c0);
  const int count = th_in * tw_in * g.cb;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int cc = i % g.cb;
    const int pix = i / g.cb;
    const int hh = h0 + pix / tw_in;
    const int ww = w0 + pix % tw_in;
    float v = 0.0f;
    if (cc < cn && hh >= 0 && hh < g.h && ww >= 0 && ww < g.w)
      v = to_f32(x[(((size_t)n * g.h + hh) * g.w + ww) * g.c + c0 + cc]);
    tile[i] = v;
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS)
dw_forward_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                  T* __restrict__ out, Geom g) {
  extern __shared__ float tile[];
  const int n = blockIdx.x / g.tiles;
  const int t = blockIdx.x % g.tiles;
  const int c0 = blockIdx.y * g.cb;
  stage_tile<T, K, S>(x, g, n, t, c0, tile);
  __syncthreads();
  const int cc = threadIdx.x % g.cb;
  const int slot = threadIdx.x / g.cb;
  const int slots = THREADS / g.cb;
  if (slot >= slots || c0 + cc >= g.c) return;
  float wr[K * K];
#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) wr[tap] = taps[tap * g.c + c0 + cc];
  const int ho0 = (t / g.tiles_w) * g.th, wo0 = (t % g.tiles_w) * g.tw;
  const int rows = min(g.th, g.ho - ho0), cols = min(g.tw, g.wo - wo0);
  const int tw_in = (g.tw - 1) * S + K;
  for (int p = slot; p < rows * cols; p += slots) {
    const int r = p / cols, q = p % cols;
    const float* base = tile + ((r * S) * tw_in + q * S) * g.cb + cc;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j)
        acc = __fadd_rn(acc, __fmul_rn(base[(i * tw_in + j) * g.cb],
                                       wr[i * K + j]));
    out[(((size_t)n * g.ho + ho0 + r) * g.wo + wo0 + q) * g.c + c0 + cc] =
        from_f32<T>(acc);
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS)
dw_grad_w_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                 float* __restrict__ partial, Geom g, int items_per_split) {
  extern __shared__ float tile[];
  const int split = blockIdx.x;
  const int c0 = blockIdx.y * g.cb;
  const int cc = threadIdx.x % g.cb;
  const int slot = threadIdx.x / g.cb;
  const int slots = THREADS / g.cb;
  const bool active = slot < slots && c0 + cc < g.c;
  const int tw_in = (g.tw - 1) * S + K;
  float acc[K * K];
#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) acc[tap] = 0.0f;
  const int item0 = split * items_per_split;
  const int item1 = min(item0 + items_per_split, g.n * g.tiles);
  for (int item = item0; item < item1; ++item) {
    const int n = item / g.tiles;
    const int t = item % g.tiles;
    stage_tile<T, K, S>(x, g, n, t, c0, tile);
    __syncthreads();
    if (active) {
      const int ho0 = (t / g.tiles_w) * g.th, wo0 = (t % g.tiles_w) * g.tw;
      const int rows = min(g.th, g.ho - ho0), cols = min(g.tw, g.wo - wo0);
      for (int p = slot; p < rows * cols; p += slots) {
        const int r = p / cols, q = p % cols;
        const float gv = to_f32(
            gy[(((size_t)n * g.ho + ho0 + r) * g.wo + wo0 + q) * g.c + c0 +
               cc]);
        const float* base = tile + ((r * S) * tw_in + q * S) * g.cb + cc;
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int j = 0; j < K; ++j)
            acc[i * K + j] =
                fmaf(base[(i * tw_in + j) * g.cb], gv, acc[i * K + j]);
      }
    }
    __syncthreads();
  }
  // the slots of each channel, summed in slot order (the tile is free now
  // and holds at least THREADS floats)
  const int kk = K * K;
#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) {
    if (slot < slots) tile[slot * g.cb + cc] = acc[tap];
    __syncthreads();
    if (slot == 0 && c0 + cc < g.c) {
      float s = 0.0f;
      for (int k = 0; k < slots; ++k) s += tile[k * g.cb + cc];
      partial[((size_t)split * kk + tap) * g.c + c0 + cc] = s;
    }
    __syncthreads();
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

int out_len(int size, int k, int s) { return (size + 2 * (k / 2) - k) / s + 1; }

size_t smem_bytes(const Geom& g, int k, int s) {
  const size_t tile = (size_t)((g.th - 1) * s + k) * ((g.tw - 1) * s + k) *
                      g.cb;
  return 4 * (tile > THREADS ? tile : THREADS);
}

// The geometry the wrapper planned, or false when the kernels do not take it.
bool make_geom(int n, int h, int w, int c, int ho, int wo, int k, int s,
               int th, int tw, int cb, Geom* g) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || k < 1 || k > 7 || k % 2 == 0 ||
      (s != 1 && s != 2) || ho != out_len(h, k, s) || wo != out_len(w, k, s) ||
      ho < 1 || wo < 1 || th < 1 || tw < 1 || cb < 1 || cb > THREADS ||
      th > ho || tw > wo)
    return false;
  g->n = n; g->h = h; g->w = w; g->c = c; g->ho = ho; g->wo = wo;
  g->th = th; g->tw = tw; g->cb = cb;
  g->tiles_w = (wo + tw - 1) / tw;
  g->tiles = ((ho + th - 1) / th) * g->tiles_w;
  const int cblocks = (c + cb - 1) / cb;
  return smem_bytes(*g, k, s) <= MAX_SMEM && cblocks <= 65535 &&
         (long long)n * g->tiles < (1LL << 31);
}

template <typename T, int K, int S>
int launch_forward(const void* x, const float* taps, void* out, const Geom& g,
                   cudaStream_t stream) {
  dim3 grid(g.n * g.tiles, (g.c + g.cb - 1) / g.cb);
  dw_forward_kernel<T, K, S><<<grid, THREADS, smem_bytes(g, K, S), stream>>>(
      static_cast<const T*>(x), taps, static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T, int K, int S>
int launch_grad_w(const void* x, const void* gy, float* partial, float* out,
                  const Geom& g, int nsplit, int items_per_split,
                  cudaStream_t stream) {
  dim3 grid(nsplit, (g.c + g.cb - 1) / g.cb);
  dw_grad_w_kernel<T, K, S><<<grid, THREADS, smem_bytes(g, K, S), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), partial, g,
      items_per_split);
  int err = (int)cudaGetLastError();
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
  static int run(const void* x, const float* taps, void* out, Geom g,
                 cudaStream_t stream) {
    return launch_forward<T, K, S>(x, taps, out, g, stream);
  }
};

template <typename T, int K, int S>
struct GradW {
  static int run(const void* x, const void* gy, float* partial, float* out,
                 Geom g, int nsplit, int items_per_split,
                 cudaStream_t stream) {
    return launch_grad_w<T, K, S>(x, gy, partial, out, g, nsplit,
                                  items_per_split, stream);
  }
};

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok);
// cudaErrorInvalidValue for shapes or plans it does not take. x, out and g
// are NHWC contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); taps are f32
// (K*K, C); (th, tw, cb) is the wrapper's tile plan.

// x (N, H, W, C) -> out (N, Ho, Wo, C).
int dw_conv_forward(const void* x, const float* taps, void* out, int n, int h,
                    int w, int c, int ho, int wo, int k, int stride, int th,
                    int tw, int cb, int bf16, void* stream) {
  Geom g;
  if (!make_geom(n, h, w, c, ho, wo, k, stride, th, tw, cb, &g))
    return (int)cudaErrorInvalidValue;
  return dispatch<Forward>(bf16, k, stride, x, taps, out, g,
                           reinterpret_cast<cudaStream_t>(stream));
}

// x (N, H, W, C), gy (N, Ho, Wo, C) -> out (K*K, C) f32, through
// partial (nsplit, K*K, C) f32; split s covers the (image, tile) items
// [s * items_per_split, (s + 1) * items_per_split).
int dw_conv_grad_w(const void* x, const void* gy, float* partial, float* out,
                   int n, int h, int w, int c, int ho, int wo, int k,
                   int stride, int th, int tw, int cb, int nsplit,
                   int items_per_split, int bf16, void* stream) {
  Geom g;
  if (!make_geom(n, h, w, c, ho, wo, k, stride, th, tw, cb, &g) ||
      nsplit < 1 || items_per_split < 1 ||
      (long long)nsplit * items_per_split < (long long)n * g.tiles ||
      (long long)(nsplit - 1) * items_per_split >= (long long)n * g.tiles)
    return (int)cudaErrorInvalidValue;
  return dispatch<GradW>(bf16, k, stride, x, gy, partial, out, g, nsplit,
                         items_per_split,
                         reinterpret_cast<cudaStream_t>(stream));
}

const char* depthwise_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
