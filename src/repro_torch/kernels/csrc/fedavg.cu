// fedavg: the p_k-weighted server fold of FedFairMMFL (paper Alg. 1 l.12)
// for NVIDIA Hopper (sm_90a).
//
//   out[n] = sum_k w[k] * x[k, n]      x: (K, N) row-major, w: (K,) f32
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg.py::fedavg_pallas
// (body _fedavg_kernel, one MXU matvec per (K, blk) tile). Contract kept:
// x is read in its own dtype (f32, bf16 or f16), every product is summed in
// f32 over k in order, and the result is written in x's dtype. The weights
// arrive as f32 after the wrapper has rounded them to the common dtype of x
// and w, which is the promotion fedavg_pallas applies.
//
// Bound: memory. The fold does 2*K*N flops on K*N*s_in + N*s_out + 4*K
// bytes, i.e. at most 0.5 flop per byte for f32, far below the H100's
// ridge point; so its floor is (K*N*s_in + N*s_out) / 3.35 TB/s (H100 SXM
// data sheet). Design: a streaming reduce. Each thread owns its column(s)
// and walks k in order, so every byte of x is read once, every output is
// written once, and no shared memory or cross-block reduction is needed.
// When each row is 16-byte aligned (N a multiple of 16 / sizeof(T) and
// aligned base pointers) a thread owns 16 bytes of columns and loads them
// with one 128-bit load per row; otherwise one column per thread with
// scalar loads. The weights are read through the read-only cache.
//
// Left on the table by this simple design, for a later change: ragged N
// (every synthetic-MLP fold on the main path) takes the scalar path for the
// whole row instead of vectorising all but the tail; there is no split over
// K, so a very small N launches too few threads to fill 132 SMs; and one
// launch per fold, so the main path's tiny folds pay launch latency.
//
// C interface (no PyTorch headers; loaded with ctypes). The kernel runs on
// the given stream, allocates nothing, and the launcher returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

constexpr int kThreads = 256;

// One column per thread: any N, any alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_scalar(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
              int64_t K, int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const T* p = x + n;
  float acc = 0.f;
#pragma unroll 4
  for (int64_t k = 0; k < K; ++k) {
    acc = fmaf(__ldg(w + k), to_f32<T>(p[k * N]), acc);
  }
  out[n] = from_f32<T>(acc);
}

// 16 bytes of columns per thread: rows must be 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_vec16(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
             int64_t K, int64_t N) {
  constexpr int V = 16 / sizeof(T);
  const int64_t nv = N / V;  // 16-byte vectors per row
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= nv) return;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + v;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int64_t k = 0; k < K; ++k) {
    const uint4 raw = __ldg(xv + k * nv);
    const T* e = reinterpret_cast<const T*>(&raw);
    const float wk = __ldg(w + k);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(wk, to_f32<T>(e[i]), acc[i]);
  }
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = from_f32<T>(acc[i]);
  reinterpret_cast<uint4*>(out)[v] = packed;
}

template <typename T>
int launch(const void* x, const float* w, void* out, int64_t K, int64_t N,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (N % V == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t work = aligned ? N / V : N;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (aligned) {
    fedavg_vec16<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xt, w, ot, K, N);
  } else {
    fedavg_scalar<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xt, w, ot, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the dtype of x and out).
int fedavg_launch(const void* x, const void* w, void* out, long long K, long long N,
                  int dtype, void* stream) {
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, wf, out, K, N, s);
    case 1: return launch<__nv_bfloat16>(x, wf, out, K, N, s);
    case 2: return launch<__half>(x, wf, out, K, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fedavg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
