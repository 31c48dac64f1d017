// fused_aggregate: one pass of the async (FedAST) server flush with a
// FedOpt server optimizer, for NVIDIA Hopper (sm_90a).
//
//   disc[k] = w[k] * exp(-beta * log1p(s[k])) * inv_norm
//   d[n]    = sum_k disc[k] * x[k, n]                x: (K, N) row-major f32
//   then, by mode (all f32):
//     fedavg   update = lr*d                           (m, v untouched)
//     fedavgm  m' = b1*m + d,            update = lr*m'  (v untouched)
//     fedadam  m' = b1*m + (1-b1)*d,     v' = b2*v + (1-b2)*d^2
//     fedyogi  m' = b1*m + (1-b1)*d,     v' = v - (1-b2)*d^2*sign(v - d^2)
//     adam and yogi: update = lr*m' / (sqrt(v') + eps)
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg.py::
// fused_aggregate_pallas (body _fused_kernel), which tiles N into blocks of
// a sequential grid, recomputes the discount per tile, does one MXU matvec
// per (K, blk) tile and carries the six scalars in a 128-lane row so that a
// new normalizer never recompiles. Here the scalars are plain kernel
// arguments, since a CUDA launch takes new values without a rebuild.
//
// Bound: memory. Per column the kernel does 2*K flops for the reduce and a
// dozen for the moment update, on 4*K bytes of x plus 4 bytes for each
// moment it reads and each output it writes, far below the H100's ridge
// point; its floor is those bytes over 3.35 TB/s (H100 SXM data sheet).
// Design: the streaming reduce of fedavg.cu. Each thread owns its columns
// and walks k in order, so every byte of x is read once and every output
// written once, with no cross-block reduction. The K discount factors are
// computed once per block into shared memory (in chunks of kChunk, so any
// K fits). When N is a multiple of 4 and every pointer is 16-byte aligned a
// thread owns 4 columns and uses 128-bit loads and stores; otherwise one
// column with scalar loads. The mode is a template parameter: fedavg reads
// and writes no moment, fedavgm only m, and the wrapper hands back the
// moments a mode leaves alone without copying them.
//
// Accuracy: compiled without --use_fast_math, so expf, log1pf, sqrtf and
// the division keep CUDA's full-precision versions; the sum runs in
// another order than the oracle's, so results agree to rounding (the gate
// is rtol/atol 1e-6). Yogi's sign(v - d^2) can flip where v and d^2 tie to
// within that rounding.
//
// C interface (no PyTorch headers; loaded with ctypes). The kernel runs on
// the given stream, allocates nothing, and the launcher returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode : int { kFedAvg = 0, kFedAvgM = 1, kFedAdam = 2, kFedYogi = 3 };

struct Scalars {
  float beta;      // staleness exponent
  float inv_norm;  // 1 / max(normalizer, 1e-12), normalizer = undiscounted weight sum
  float lr;
  float beta1;
  float beta2;
  float eps;
};

struct Moments {
  float update;
  float m;
  float v;
};

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // discount factors staged in shared memory per pass

template <int MODE>
__device__ __forceinline__ Moments step(float d, float m, float v, const Scalars& c) {
  Moments o;
  if constexpr (MODE == kFedAvg) {
    o.update = c.lr * d;
    o.m = m;
    o.v = v;
  } else if constexpr (MODE == kFedAvgM) {
    o.m = c.beta1 * m + d;
    o.update = c.lr * o.m;
    o.v = v;
  } else {
    o.m = c.beta1 * m + (1.f - c.beta1) * d;
    const float d2 = d * d;
    if constexpr (MODE == kFedAdam) {
      o.v = c.beta2 * v + (1.f - c.beta2) * d2;
    } else {
      const float diff = v - d2;
      const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
      o.v = v - (1.f - c.beta2) * d2 * sgn;
    }
    o.update = c.lr * o.m / (sqrtf(o.v) + c.eps);
  }
  return o;
}

// V columns per thread: 1 (any N, any alignment) or 4 (N % 4 == 0 and all
// pointers 16-byte aligned).
template <int MODE, int V>
__global__ void __launch_bounds__(kThreads)
fused_aggregate_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ s, const float* __restrict__ m,
                       const float* __restrict__ v, float* __restrict__ upd,
                       float* __restrict__ om, float* __restrict__ ov, int64_t K, int64_t N,
                       Scalars c) {
  constexpr bool kReadM = MODE != kFedAvg;
  constexpr bool kReadV = MODE == kFedAdam || MODE == kFedYogi;
  __shared__ float disc[kChunk];
  const int64_t n0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  const bool active = n0 < N;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = static_cast<int>(K - k0 < kChunk ? K - k0 : kChunk);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < kc; i += kThreads) {
      disc[i] = __ldg(w + k0 + i) * expf(-c.beta * log1pf(__ldg(s + k0 + i))) * c.inv_norm;
    }
    __syncthreads();
    if (active) {
      const float* p = x + k0 * N + n0;
#pragma unroll 4
      for (int i = 0; i < kc; ++i, p += N) {
        const float dk = disc[i];
        if constexpr (V == 4) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(p));
          acc[0] = fmaf(dk, xv.x, acc[0]);
          acc[1] = fmaf(dk, xv.y, acc[1]);
          acc[2] = fmaf(dk, xv.z, acc[2]);
          acc[3] = fmaf(dk, xv.w, acc[3]);
        } else {
          acc[0] = fmaf(dk, __ldg(p), acc[0]);
        }
      }
    }
  }
  if (!active) return;

  float mi[V], vi[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mi[i] = vi[i] = 0.f;
  if constexpr (V == 4) {
    if constexpr (kReadM) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(m + n0));
      mi[0] = t.x; mi[1] = t.y; mi[2] = t.z; mi[3] = t.w;
    }
    if constexpr (kReadV) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(v + n0));
      vi[0] = t.x; vi[1] = t.y; vi[2] = t.z; vi[3] = t.w;
    }
  } else {
    if constexpr (kReadM) mi[0] = __ldg(m + n0);
    if constexpr (kReadV) vi[0] = __ldg(v + n0);
  }
  Moments o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = step<MODE>(acc[i], mi[i], vi[i], c);
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(upd + n0) = make_float4(o[0].update, o[1].update, o[2].update,
                                                        o[3].update);
    if constexpr (kReadM) {
      *reinterpret_cast<float4*>(om + n0) = make_float4(o[0].m, o[1].m, o[2].m, o[3].m);
    }
    if constexpr (kReadV) {
      *reinterpret_cast<float4*>(ov + n0) = make_float4(o[0].v, o[1].v, o[2].v, o[3].v);
    }
  } else {
    upd[n0] = o[0].update;
    if constexpr (kReadM) om[n0] = o[0].m;
    if constexpr (kReadV) ov[n0] = o[0].v;
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int MODE>
int launch(const float* x, const float* w, const float* s, const float* m, const float* v,
           float* upd, float* om, float* ov, int64_t K, int64_t N, Scalars c,
           cudaStream_t stream) {
  constexpr bool kReadM = MODE != kFedAvg;
  constexpr bool kReadV = MODE == kFedAdam || MODE == kFedYogi;
  const bool vec = N % 4 == 0 && aligned16(x) && aligned16(upd) &&
                   (!kReadM || (aligned16(m) && aligned16(om))) &&
                   (!kReadV || (aligned16(v) && aligned16(ov)));
  const int64_t work = vec ? N / 4 : N;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec) {
    fused_aggregate_kernel<MODE, 4><<<grid, kThreads, 0, stream>>>(x, w, s, m, v, upd, om, ov,
                                                                    K, N, c);
  } else {
    fused_aggregate_kernel<MODE, 1><<<grid, kThreads, 0, stream>>>(x, w, s, m, v, upd, om, ov,
                                                                    K, N, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode: 0 = fedavg, 1 = fedavgm, 2 = fedadam, 3 = fedyogi. All pointers are
// f32 device arrays: x (K, N), w and s (K,), m, v, upd, om, ov (N,). om may
// be null for fedavg, ov for fedavg and fedavgm: those modes never write
// them (nor read m, v respectively).
int fused_aggregate_launch(const void* x, const void* w, const void* s, const void* m,
                           const void* v, void* upd, void* om, void* ov, long long K,
                           long long N, int mode, float beta, float inv_norm, float lr,
                           float beta1, float beta2, float eps, void* stream) {
  const Scalars c{beta, inv_norm, lr, beta1, beta2, eps};
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(s);
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  float* uf = static_cast<float*>(upd);
  float* omf = static_cast<float*>(om);
  float* ovf = static_cast<float*>(ov);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFedAvg: return launch<kFedAvg>(xf, wf, sf, mf, vf, uf, omf, ovf, K, N, c, st);
    case kFedAvgM: return launch<kFedAvgM>(xf, wf, sf, mf, vf, uf, omf, ovf, K, N, c, st);
    case kFedAdam: return launch<kFedAdam>(xf, wf, sf, mf, vf, uf, omf, ovf, K, N, c, st);
    case kFedYogi: return launch<kFedYogi>(xf, wf, sf, mf, vf, uf, omf, ovf, K, N, c, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
