// flash_attention: forward online-softmax attention (causal switch, GQA) for
// NVIDIA Hopper (sm_90a).
//
//   o[b, h, i, :] = sum_j softmax_j(q[b,h,i,:] . k[b,g,j,:] * hd^-0.5) v[b,g,j,:]
//   with g = h // (H / KV); causal: key j is masked (score -1e30) when j > i.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel). Contract kept: scores are f32 sums of products of the
// inputs, scaled after the product; masked scores are -1e30; causal is
// top-left aligned (query i sees keys 0..i whatever Sq and Sk are); the
// probabilities are rounded to v's dtype before the PV product, whose sums
// are f32; the running denominator l sums the unrounded probabilities; the
// output is acc / max(l, 1e-30) in q's dtype. q, k, v share one dtype (f32
// or bf16); hd is 16, 32, 64, 112 (zamba2-7b's 3584 / 32) or 128; Sq and Sk
// are any length.
//
// The TPU kernel keeps m, l and acc in VMEM scratch across a kv grid axis
// that the TPU runs in order. Hopper runs blocks in any order, so the kv
// loop lives inside the block: one block per (q tile, head, batch), and it
// walks the kv tiles in order from key 0. m, l and acc stay in registers;
// each K and V tile is staged through shared memory, converted to f32.
// Because the walk starts at key 0, which every causal row sees, a row's
// running max is finite after the first tile, so a fully masked later tile
// contributes exp(-1e30 - m) = 0 and cannot corrupt l; causal blocks also
// stop after the last tile that holds a key <= their last row. Keys past Sk
// (the ragged tail of the last tile) get -inf and contribute exactly 0.
//
// Layout: 128 threads; thread (ty, tx) = (tid / 8, tid % 8) owns rows
// ty + 16 i (i < 4) of the 64-row q tile and, within a 64-key tile, score
// columns tx + 8 j (j < 8) and output columns tx + 8 c (c < hd / 8). The
// eight threads of a row are neighbouring lanes of one warp, so row max and
// row sum are three shuffles. Shared rows are padded by one float so that
// those access patterns hit distinct banks. Strides are arguments: the
// model hands over (B, S, H, hd) activations viewed as (B, H, S, hd), and
// the kernel reads and writes them in place (last axis contiguous).
//
// Bound: for the model's shapes, operations (f32: 4 * hd flops per (query,
// key) pair the mask keeps, at 67 TFLOP/s outside the tensor cores; bf16 at
// the 989 TFLOP/s of the tensor cores); bytes are q, k, v and o once. This
// simple design multiplies on the CUDA cores in f32 from shared memory, so
// it stays well below both rates: tensor-core MMA (wgmma on bf16), TMA
// staging and a pipelined kv loop are for a later change.
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

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int kThreads = 128;
constexpr int RQ = BQ / 16;   // rows per thread
constexpr int CK = BK / 8;    // score columns per thread
constexpr float kMaskValue = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, KV, Sq, Sk;
  float scale;
};

// q, k, v tiles and p: at hd = 112, 64 * 113 + 2 * 64 * 113 + 64 * 65 =
// 25,856 floats (103,424 bytes); at hd = 128, 115,712 bytes; both within
// the 232,448 bytes a block may use
template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1);
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Args a) {
  constexpr int LD = HD + 1;   // padded row of q, k, v in shared memory
  constexpr int LDP = BK + 1;  // padded row of p
  constexpr int CV = HD / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  // heavy causal tiles (late queries) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const int i = q0 + r;
    Qs[r * LD + c] = i < a.Sq ? to_f32<T>(qp[i * a.q_ss + c]) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CV];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (a.Sk + BK - 1) / BK;
  if (CAUSAL) {
    const int last_row = min(q0 + BQ, a.Sq) - 1;
    n_tiles = min(n_tiles, last_row / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const int j = k0 + r;
      const bool in = j < a.Sk;
      Ks[r * LD + c] = in ? to_f32<T>(kp[j * a.k_ss + c]) : 0.f;
      Vs[r * LD + c] = in ? to_f32<T>(vp[j * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx + 8 * j;
        float x = s[i][j] * a.scale;
        if (col >= a.Sk) {
          x = -INFINITY;
        } else if (CAUSAL && col > row) {
          x = kMaskValue;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 8 * j] = to_f32<T>(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[CV];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CV; ++c) vv[c] = Vs[kk * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CV; ++c) op[row * a.o_ss + tx + 8 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD, bool CAUSAL>
int launch_one(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  static bool configured = false;  // once per instantiation: smem above 48 KB
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, HD, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_fwd<T, HD, CAUSAL><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int B, int hd, bool causal, cudaStream_t s) {
  switch (hd) {
    case 16: return causal ? launch_one<T, 16, true>(a, B, s) : launch_one<T, 16, false>(a, B, s);
    case 32: return causal ? launch_one<T, 32, true>(a, B, s) : launch_one<T, 32, false>(a, B, s);
    case 64: return causal ? launch_one<T, 64, true>(a, B, s) : launch_one<T, 64, false>(a, B, s);
    case 112:
      return causal ? launch_one<T, 112, true>(a, B, s) : launch_one<T, 112, false>(a, B, s);
    case 128:
      return causal ? launch_one<T, 128, true>(a, B, s) : launch_one<T, 128, false>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o (B, H, Sq, hd), each given by
// its base pointer and element strides of batch, head and sequence (the last
// axis contiguous). dtype 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 112, 128};
// scale is hd^-0.5 rounded to f32 by the caller.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           int B, int H, int KV, int Sq, int Sk, int hd, float scale,
                           int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || B > 65535 ||
      H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
               o_sb, o_sh, o_ss, H, KV, Sq, Sk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, B, hd, causal != 0, s);
    case 1: return launch<__nv_bfloat16>(a, B, hd, causal != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
