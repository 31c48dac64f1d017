// rmsnorm: the row-wise RMSNorm of every dense LM block, for NVIDIA Hopper
// (sm_90a).
//
//   out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w      x: (rows, d)
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas
// (body _rmsnorm_kernel, one (blk_rows, d) tile per grid step, rows padded to
// the block). Contract kept: x is read in its own dtype (f32, bf16 or f16),
// the sum of squares, the rsqrt and both products are f32, and the result is
// written in x's dtype. w arrives as f32 (the wrapper converts it; the
// Pallas kernel casts it to f32 as well). No padding: any row count, any d.
//
// Bound: memory. Each element costs a load, a store and ~4 flops, far below
// the H100's ridge point, so the floor is (2 * rows * d * sizeof(T) + 4 * d)
// / 3.35 TB/s (H100 SXM data sheet). Design: one warp per row, eight rows
// per block, so rows are independent and need no shared memory or block
// barrier. Pass 1 sums squares (lane partials, then a warp shuffle); pass 2
// reads the row again, which for the model's widths (d <= a few thousand,
// a few KB a row) comes from L1/L2 rather than device memory, and writes
// it scaled. When d * sizeof(T) is a multiple of 16 and both pointers are
// 16-byte aligned, each lane moves 16 bytes per load and store; otherwise
// one element at a time.
//
// Left for a later change: holding the row in registers instead of reading
// it twice, and a block per row for very wide rows (d = 8192) so that one
// warp does not walk 256 elements a lane.
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

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// V elements of T moved as one load or store (16 bytes when V > 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
             int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const Pack<T, V>* xr = reinterpret_cast<const Pack<T, V>*>(x + row * d);
  Pack<T, V>* orow = reinterpret_cast<Pack<T, V>*>(out + row * d);
  const int nv = d / V;

  float ss = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const Pack<T, V> p = xr[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32<T>(p.v[j]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane; i < nv; i += 32) {
    const Pack<T, V> p = xr[i];
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o.v[j] = from_f32<T>(to_f32<T>(p.v[j]) * r * __ldg(w + i * V + j));
    }
    orow[i] = o;
  }
}

template <typename T>
int launch(const void* x, const float* w, void* out, int64_t rows, int d, float eps,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d % V == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec) {
    rmsnorm_rows<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xt, w, ot,
                                                                              rows, d, eps);
  } else {
    rmsnorm_rows<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xt, w, ot,
                                                                              rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: (rows, d) contiguous, dtype 0 = float32, 1 = bfloat16, 2 = float16;
// w: (d,) float32.
int rmsnorm_launch(const void* x, const void* w, void* out, long long rows, int d, float eps,
                   int dtype, void* stream) {
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, wf, out, rows, d, eps, s);
    case 1: return launch<__nv_bfloat16>(x, wf, out, rows, d, eps, s);
    case 2: return launch<__half>(x, wf, out, rows, d, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
