// ssd_scan: the chunked SSD (state-space dual) scan of Mamba2, for NVIDIA
// Hopper (sm_90a).
//
//   h_t = exp(a_t) h_{t-1} + b_t^T x_t ;  y_t = c_t h_t ;  h_0 = 0
//   x: (B, H, L, P) values, a: (B, H, L) log-decay <= 0, b, c: (B, H, L, N)
//
// computed chunk by chunk, as the state-space dual form: for a chunk of Q
// steps with acs = cumsum(a) inside it,
//   y     = ((C B^T) o tril(exp(acs_i - acs_j))) X + (C o exp(acs)) h
//   h'    = h exp(acs[-1]) + sum_j exp(acs[-1] - acs_j) B_j^T X_j
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::
// ssd_scan_pallas (body _ssd_kernel, grid (B, H, chunk) with the (N, P)
// state in VMEM scratch carried across the sequential chunk axis).
// Contract kept: every product and sum is f32 whatever the inputs' dtype
// (x, b, c share one dtype, f32 or bf16; a is f32); the segment sum is a
// difference of cumsums (not a running product); masked entries above the
// diagonal are exactly 0; y is written in x's dtype; the state starts at
// zero. One addition: with h_out set, the final (N, P) state of each
// (b, h) is written out in f32 (the state Mamba2's prefill hands to decode;
// the TPU kernel keeps it in scratch and drops it). L must be a multiple
// of Q: the wrapper pads the tail with identity steps.
//
// Hopper runs blocks in any order, so the sequential chunk axis becomes a
// loop inside the block: one block of 256 threads per (b, h), walking its
// chunks in order, with the state h in shared memory. Per chunk the block
// stages B (Q x N) and X (Q x P) in shared memory as f32 and takes the
// cumsum of a with one warp (lane-contiguous runs, then a shuffle scan).
// The (Q x Q) score matrix does not fit beside them at Q = 256, so the
// chunk's rows go in tiles of kRows: per tile the block stages those rows
// of C, computes their causal scores (a thread per column and group of
// four rows, float4 reads along N), then their outputs (a thread per
// column p and group of four rows, float4 reads of the scores along the
// sequence, the carry-in term C h beside them). After the last tile the
// block updates h (a thread per four state rows and one column). Shapes
// are runtime values; N is padded to a multiple of 4 with zeros in shared
// memory. Inputs are read through strides (the last axis contiguous), so
// Mamba2's B and C, shared by every head, arrive as a stride-0 head view
// with no copy, and x and y as transposed (B, L, H, P) views.
//
// Bound: for Mamba2's shapes, operations: per chunk the causal scores and
// their product with X take 2 (N + P) flops per (i, j <= i) pair, the
// carry-in and the state update 2 N P each per step, on the CUDA cores at
// 67 TFLOP/s f32; bytes are x, y once, b, c once per distinct (b, h) view
// and a once. This simple design multiplies from shared memory on the CUDA
// cores (about one shared load per two to four FMAs) with one block per SM
// at Q = 256, so it stays well below that rate. Left for a later change:
// tensor-core products (mma / wgmma on TF32 or bf16), several heads per
// block sharing B and C, and a pipelined chunk loop.
//
// C interface (no PyTorch headers; loaded with ctypes). The kernel runs on
// the given stream, allocates nothing, and the launcher returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;
constexpr int kRows = 16;          // chunk rows per tile
constexpr int kGroups = kRows / 4;  // groups of four rows
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use (H100)

struct Args {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* h_out;  // (B, H, N, P) contiguous, or null
  int64_t x_sb, x_sh, x_sl, a_sb, a_sh, a_sl, b_sb, b_sh, b_sl, c_sb, c_sh, c_sl, y_sb, y_sh,
      y_sl;
  int H, L, P, N, Q;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// floats of shared memory: Bs (Q x NP+4), Ct (kRows x NP), S (kRows x QR),
// Xs (QR x P), Hs (NP x P), acs, ex, dec (Q each)
__host__ __device__ inline int64_t smem_floats(int N, int P, int Q) {
  const int64_t NP = round4(N), QR = round4(Q);
  return Q * (NP + 4) + kRows * NP + kRows * QR + QR * P + NP * P + 3 * int64_t(Q);
}

__device__ __forceinline__ void fma4(float& acc, const float4& u, const float4& v) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  acc = fmaf(u.w, v.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scan(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, P = a.P, Q = a.Q;
  const int NP = round4(N), LDB = NP + 4, QR = round4(Q);
  float* Bs = smem;               // B of the chunk, rows padded to LDB
  float* Ct = Bs + Q * LDB;       // C of the tile's rows
  float* S = Ct + kRows * NP;     // the tile's causal scores
  float* Xs = S + kRows * QR;     // X of the chunk (rows >= Q stay 0)
  float* Hs = Xs + QR * P;        // the state (rows >= N stay 0)
  float* acs = Hs + NP * P;       // cumsum of a within the chunk
  float* ex = acs + Q;            // exp(acs_i)
  float* dec = ex + Q;            // exp(acs[-1] - acs_j)

  const int tid = threadIdx.x;
  const int64_t bi = blockIdx.x / a.H, hi = blockIdx.x % a.H;
  const T* xp = static_cast<const T*>(a.x) + bi * a.x_sb + hi * a.x_sh;
  const float* ap = a.a + bi * a.a_sb + hi * a.a_sh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + hi * a.b_sh;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + hi * a.c_sh;
  T* yp = static_cast<T*>(a.y) + bi * a.y_sb + hi * a.y_sh;

  // zero everything once: the pads (Bs and Ct columns >= N, Xs rows >= Q,
  // Hs rows >= N) are never written again, and Hs is the initial state
  for (int64_t e = tid; e < smem_floats(N, P, Q); e += kThreads) smem[e] = 0.f;

  const int n_chunks = a.L / Q;
  for (int zc = 0; zc < n_chunks; ++zc) {
    const int64_t l0 = int64_t(zc) * Q;
    __syncthreads();  // the previous chunk's state update is done with Bs, Xs, dec
    for (int e = tid; e < Q * N; e += kThreads) {
      const int j = e / N, n = e % N;
      Bs[j * LDB + n] = to_f32<T>(bp[(l0 + j) * a.b_sl + n]);
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P, p = e % P;
      Xs[e] = to_f32<T>(xp[(l0 + j) * a.x_sl + p]);
    }
    for (int e = tid; e < Q; e += kThreads) acs[e] = ap[(l0 + e) * a.a_sl];
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of the chunk's a: runs per lane, then a shuffle scan
      const int per = (Q + 31) / 32;
      const int s0 = min(tid * per, Q), s1 = min(s0 + per, Q);
      float run = 0.f;
      for (int i = s0; i < s1; ++i) {
        run += acs[i];
        acs[i] = run;
      }
      float inc = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += v;
      }
      const float base = inc - run;
      for (int i = s0; i < s1; ++i) acs[i] += base;
    }
    __syncthreads();
    const float last = acs[Q - 1];
    for (int e = tid; e < Q; e += kThreads) {
      ex[e] = expf(acs[e]);
      dec[e] = expf(last - acs[e]);
    }

    for (int r0 = 0; r0 < Q; r0 += kRows) {
      const int rows = min(kRows, Q - r0);
      const int jmax = r0 + rows, jmax4 = round4(jmax);
      for (int e = tid; e < rows * N; e += kThreads) {
        const int i = e / N, n = e % N;
        Ct[i * NP + n] = to_f32<T>(cp[(l0 + r0 + i) * a.c_sl + n]);
      }
      __syncthreads();
      // causal scores S[i][j] = (C_i . B_j) exp(acs_i - acs_j), 0 for j > i
      for (int u = tid; u < kGroups * jmax4; u += kThreads) {
        const int g = u / jmax4, j = u % jmax4;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if (j < jmax) {
          const float4* brow = reinterpret_cast<const float4*>(Bs + j * LDB);
          for (int n4 = 0; n4 < NP / 4; ++n4) {
            const float4 bv = brow[n4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              fma4(s[k], reinterpret_cast<const float4*>(Ct + (g * 4 + k) * NP)[n4], bv);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = g * 4 + k;
          float v = 0.f;
          if (i < rows && j <= r0 + i) v = s[k] * expf(acs[r0 + i] - acs[j]);
          S[i * QR + j] = v;
        }
      }
      __syncthreads();
      // y[i][p] = S_i . X[:, p] + exp(acs_i) (C_i . h[:, p])
      for (int u = tid; u < kGroups * P; u += kThreads) {
        const int g = u / P, p = u % P;
        float acc[4] = {0.f, 0.f, 0.f, 0.f}, carry[4] = {0.f, 0.f, 0.f, 0.f};
        for (int n4 = 0; n4 < NP / 4; ++n4) {
          const int n = n4 * 4;
          const float4 hv = make_float4(Hs[n * P + p], Hs[(n + 1) * P + p], Hs[(n + 2) * P + p],
                                        Hs[(n + 3) * P + p]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            fma4(carry[k], reinterpret_cast<const float4*>(Ct + (g * 4 + k) * NP)[n4], hv);
          }
        }
        // the four rows' scores are 0 past the last one's diagonal
        const int jend = min(jmax4, round4(r0 + g * 4 + 4));
        for (int j4 = 0; j4 < jend / 4; ++j4) {
          const int j = j4 * 4;
          const float4 xv = make_float4(Xs[j * P + p], Xs[(j + 1) * P + p], Xs[(j + 2) * P + p],
                                        Xs[(j + 3) * P + p]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            fma4(acc[k], reinterpret_cast<const float4*>(S + (g * 4 + k) * QR)[j4], xv);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = g * 4 + k;
          if (i < rows) {
            yp[(l0 + r0 + i) * a.y_sl + p] = from_f32<T>(acc[k] + carry[k] * ex[r0 + i]);
          }
        }
      }
      __syncthreads();  // the next tile overwrites Ct and S; the state update reads Hs
    }

    // h[n][p] = exp(acs[-1]) h[n][p] + sum_j B[j][n] (X[j][p] exp(acs[-1] - acs_j))
    const float el = ex[Q - 1];
    for (int u = tid; u < (NP / 4) * P; u += kThreads) {
      const int n4 = u / P, p = u % P;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Q; ++j) {
        const float4 bv = reinterpret_cast<const float4*>(Bs + j * LDB)[n4];
        const float xd = Xs[j * P + p] * dec[j];
        s[0] = fmaf(bv.x, xd, s[0]);
        s[1] = fmaf(bv.y, xd, s[1]);
        s[2] = fmaf(bv.z, xd, s[2]);
        s[3] = fmaf(bv.w, xd, s[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = n4 * 4 + k;
        if (n < N) Hs[n * P + p] = fmaf(Hs[n * P + p], el, s[k]);
      }
    }
  }
  if (a.h_out != nullptr) {
    __syncthreads();
    float* ho = a.h_out + int64_t(blockIdx.x) * N * P;
    for (int e = tid; e < N * P; e += kThreads) ho[e] = Hs[e];
  }
}

template <typename T>
int launch(const Args& a, int64_t BH, cudaStream_t stream) {
  const size_t smem = smem_floats(a.N, a.P, a.Q) * sizeof(float);
  static bool configured = false;  // once per instantiation: smem above 48 KB
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  ssd_chunk_scan<T><<<static_cast<unsigned>(BH), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of shared memory a block takes for state N, head P, chunk Q.
long long ssd_scan_smem_bytes(int N, int P, int Q) {
  return smem_floats(N, P, Q) * static_cast<long long>(sizeof(float));
}

// x (B, H, L, P), a (B, H, L) float32, b and c (B, H, L, N), y (B, H, L, P),
// each given by its base pointer and element strides of batch, head and
// sequence (x, b, c and y with the last axis contiguous); x, b, c, y share
// dtype 0 = float32 or 1 = bfloat16. L % Q == 0. h_out: (B, H, N, P)
// float32 contiguous, or null.
int ssd_scan_launch(const void* x, const void* a, const void* b, const void* c, void* y,
                    void* h_out, long long x_sb, long long x_sh, long long x_sl,
                    long long a_sb, long long a_sh, long long a_sl, long long b_sb,
                    long long b_sh, long long b_sl, long long c_sb, long long c_sh,
                    long long c_sl, long long y_sb, long long y_sh, long long y_sl, int B,
                    int H, int L, int P, int N, int Q, int dtype, void* stream) {
  const int64_t BH = int64_t(B) * H;
  if (B <= 0 || H <= 0 || L <= 0 || P <= 0 || N <= 0 || Q <= 0 || L % Q != 0 ||
      BH > 0x7fffffff || smem_floats(N, P, Q) * int64_t(sizeof(float)) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{x,    static_cast<const float*>(a), b,    c,    y,    static_cast<float*>(h_out),
                  x_sb, x_sh, x_sl, a_sb, a_sh, a_sl, b_sb, b_sh, b_sl, c_sb, c_sh, c_sl,
                  y_sb, y_sh, y_sl, H,    L,    P,    N,    Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(args, BH, s);
    case 1: return launch<__nv_bfloat16>(args, BH, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
