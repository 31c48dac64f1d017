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
// / 3.35 TB/s (H100 SXM data sheet).
//
// Design (rmsnorm_rows_reg): a row is read from device memory once and held
// in registers. A group of G threads owns a row; each thread loads its (up
// to) kPacks 16-byte packs of the row, all before it reduces, so the loads
// are independent and in flight together; then sums their squares, reduces
// across the group (a warp shuffle, and across the group's warps one float a
// warp through shared memory, added in a fixed order, so two calls on the
// same inputs are bit-equal), and writes the packs scaled, loading w in
// 16-byte packs. The launcher picks the smallest power-of-two G (8 to 1024
// threads) whose G * kPacks packs cover the row: one warp or less for rows
// up to 2 KB (several rows a block of 256 threads), 4 warps at d 2048 f32,
// 8 at d 4096. Each group owns one row, so no block walks rows and w is
// reloaded per row, from L1 after the first.
//
// rmsnorm_rows, the earlier two-pass kernel, stays for rows the register
// design cannot take: a row longer than kPacks * 1024 packs (64 KB, d 16384
// f32), or rows and pointers that are not 16-byte aligned (one element at a
// time). One warp per row, eight rows a block: pass 1 sums squares, pass 2
// reads the row again (from L1/L2 for rows of a few KB) and writes it.
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

// V elements of T moved as one load or store (16 bytes when V > 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

constexpr int kPacks = 4;       // 16-byte packs of a row each thread holds (rmsnorm_rows_reg)
constexpr int kMaxGroup = 1024;  // threads of a row at most
constexpr int kBlock = 256;      // threads of a block of several rows
constexpr int kWarps = 8;        // rows a block of the two-pass kernel, one warp each
constexpr int kThreads = 32 * kWarps;

template <typename T, int G>
__global__ void __launch_bounds__(G > kBlock ? G : kBlock)
rmsnorm_rows_reg(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                 int64_t rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = (G > kBlock ? G : kBlock) / G;  // rows a block
  constexpr int W = G / 32;                         // warps a row (0 below a warp)
  using P = Pack<T, V>;
  __shared__ float partial[W > 1 ? R * W : 1];
  const int t = threadIdx.x % G;
  const int g = threadIdx.x / G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * R + g;
  const bool live = row < rows;  // no early return: the group's shuffles and barrier need all
  const int np = d / V;
  const P* xr = reinterpret_cast<const P*>(x) + (live ? row : 0) * np;
  P* orow = reinterpret_cast<P*>(out) + (live ? row : 0) * np;

  P v[kPacks];
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    if (live && t + k * G < np) v[k] = xr[t + k * G];
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    if (live && t + k * G < np) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32<T>(v[k].v[j]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  // the lanes of one row: aligned groups of G lanes below a warp, else the warp
#pragma unroll
  for (int off = (G < 32 ? G : 32) / 2; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if constexpr (W > 1) {
    if ((t & 31) == 0) partial[g * W + t / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) ss += partial[g * W + i];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    const int i = t + k * G;
    if (live && i < np) {
      P o;
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 wq = __ldg(w4 + i * (V / 4) + q);
        o.v[4 * q + 0] = from_f32<T>(to_f32<T>(v[k].v[4 * q + 0]) * r * wq.x);
        o.v[4 * q + 1] = from_f32<T>(to_f32<T>(v[k].v[4 * q + 1]) * r * wq.y);
        o.v[4 * q + 2] = from_f32<T>(to_f32<T>(v[k].v[4 * q + 2]) * r * wq.z);
        o.v[4 * q + 3] = from_f32<T>(to_f32<T>(v[k].v[4 * q + 3]) * r * wq.w);
      }
      orow[i] = o;
    }
  }
}

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

template <typename T, int G>
int launch_reg(const T* x, const float* w, T* out, int64_t rows, int d, float eps,
               cudaStream_t stream) {
  constexpr int threads = G > kBlock ? G : kBlock;
  constexpr int R = threads / G;
  const int64_t blocks = (rows + R - 1) / R;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  rmsnorm_rows_reg<T, G><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(x, w, out, rows,
                                                                              d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* w, void* out, int64_t rows, int d, float eps,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d % V == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec && reinterpret_cast<uintptr_t>(w) % 16 == 0 && d / V <= kPacks * kMaxGroup) {
    int G = 8;
    while (G * kPacks < d / V) G *= 2;
    switch (G) {
      case 8: return launch_reg<T, 8>(xt, w, ot, rows, d, eps, stream);
      case 16: return launch_reg<T, 16>(xt, w, ot, rows, d, eps, stream);
      case 32: return launch_reg<T, 32>(xt, w, ot, rows, d, eps, stream);
      case 64: return launch_reg<T, 64>(xt, w, ot, rows, d, eps, stream);
      case 128: return launch_reg<T, 128>(xt, w, ot, rows, d, eps, stream);
      case 256: return launch_reg<T, 256>(xt, w, ot, rows, d, eps, stream);
      case 512: return launch_reg<T, 512>(xt, w, ot, rows, d, eps, stream);
      default: return launch_reg<T, kMaxGroup>(xt, w, ot, rows, d, eps, stream);
    }
  }
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
