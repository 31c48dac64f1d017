// gated_rmsnorm: Mamba2's output gate, a row-wise RMSNorm of x * silu(z),
// for NVIDIA Hopper (sm_90a).
//
//   g = x[r, :] * z[r, :] * sigmoid(z[r, :])
//   out[r, :] = g * rsqrt(mean(g^2) + eps) * w          x, z: (rows, d)
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rmsnorm.py::gated_rmsnorm_pallas (body
// _gated_rmsnorm_kernel, one (blk_rows, d) tile per grid step, rows padded
// to the block). Contract kept: x and z are read in their dtype (f32, bf16
// or f16, the same for both), the gate, the sum of squares, the rsqrt and
// both products are f32, and the result is written in x's dtype. w arrives
// as f32 (the wrapper converts it). No padding: any row count, any d.
//
// Bound: memory. Each element costs two loads, a store and ~10 flops with
// one exp, far below the H100's ridge point, so the floor is
// (3 * rows * d * sizeof(T) + 4 * d) / 3.35 TB/s (H100 SXM data sheet).
// Design: one block of 256 threads per row. Mamba2's rows are d_inner wide
// (7168 for zamba2-7b), too wide for one warp to walk without a second
// read, so the block shares the row: each thread keeps the gate of up to
// kPacks 16-byte packs in registers (d <= 8192 f32, 16384 bf16), the block
// sums the squares (warp shuffles, then eight partials through shared
// memory), and each thread scales and writes what it kept. x and z are
// read once. Wider rows take a second pass for the packs past kPacks,
// recomputing the gate from x and z. When d * sizeof(T) is a multiple of
// 16 and the rows are 16-byte aligned, each thread moves 16 bytes per
// access; otherwise one element at a time. x and z rows may be strided
// (Mamba2's z is a column slice of the input projection), the output is
// contiguous.
//
// Left for a later change: several rows per block for narrow d.
//
// C interface (no PyTorch headers; loaded with ctypes). The kernel runs on
// the given stream, allocates nothing, and the launcher returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
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
constexpr int kPacks = 8;  // packs a thread keeps in registers

// V elements of T moved as one load or store (16 bytes when V > 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// x * silu(z) in f32, as the TPU kernel computes it: x * (z * sigmoid(z))
__device__ __forceinline__ float gate(float x, float z) {
  return x * (z * (1.f / (1.f + expf(-z))));
}

template <typename T, int V>
__device__ __forceinline__ void gate_pack(const Pack<T, V>& xp, const Pack<T, V>& zp,
                                          float (&g)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) g[j] = gate(to_f32<T>(xp.v[j]), to_f32<T>(zp.v[j]));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gated_rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ z,
                   const float* __restrict__ w, T* __restrict__ out, int64_t x_rs,
                   int64_t z_rs, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const Pack<T, V>* xr = reinterpret_cast<const Pack<T, V>*>(x + row * x_rs);
  const Pack<T, V>* zr = reinterpret_cast<const Pack<T, V>*>(z + row * z_rs);
  Pack<T, V>* orow = reinterpret_cast<Pack<T, V>*>(out + row * static_cast<int64_t>(d));
  const int nv = d / V;

  float g[kPacks][V];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int i = tid + k * kThreads;
    if (i < nv) {
      gate_pack<T, V>(xr[i], zr[i], g[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) ss = fmaf(g[k][j], g[k][j], ss);
    }
  }
  for (int i = tid + kPacks * kThreads; i < nv; i += kThreads) {
    float gt[V];
    gate_pack<T, V>(xr[i], zr[i], gt);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(gt[j], gt[j], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) total += partial[k];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int i = tid + k * kThreads;
    if (i < nv) {
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = from_f32<T>(g[k][j] * r * __ldg(w + i * V + j));
      orow[i] = o;
    }
  }
  for (int i = tid + kPacks * kThreads; i < nv; i += kThreads) {
    float gt[V];
    gate_pack<T, V>(xr[i], zr[i], gt);
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) o.v[j] = from_f32<T>(gt[j] * r * __ldg(w + i * V + j));
    orow[i] = o;
  }
}

template <typename T>
int launch(const void* x, const void* z, const float* w, void* out, int64_t rows,
           int64_t x_rs, int64_t z_rs, int d, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d % V == 0) && (x_rs % V == 0) && (z_rs % V == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(z) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned blocks = static_cast<unsigned>(rows);
  if (vec) {
    gated_rmsnorm_rows<T, V><<<blocks, kThreads, 0, stream>>>(xt, zt, w, ot, x_rs, z_rs, d,
                                                               eps);
  } else {
    gated_rmsnorm_rows<T, 1><<<blocks, kThreads, 0, stream>>>(xt, zt, w, ot, x_rs, z_rs, d,
                                                               eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, z: (rows, d) with row strides x_rs, z_rs (elements; the last axis
// contiguous), out: (rows, d) contiguous, all of one dtype: 0 = float32,
// 1 = bfloat16, 2 = float16; w: (d,) float32. rows > 0.
int gated_rmsnorm_launch(const void* x, const void* z, const void* w, void* out,
                         long long rows, long long x_rs, long long z_rs, int d, float eps,
                         int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, z, wf, out, rows, x_rs, z_rs, d, eps, s);
    case 1: return launch<__nv_bfloat16>(x, z, wf, out, rows, x_rs, z_rs, d, eps, s);
    case 2: return launch<__half>(x, z, wf, out, rows, x_rs, z_rs, d, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* gated_rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
