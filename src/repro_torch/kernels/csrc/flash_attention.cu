// flash_attention: forward online-softmax attention (causal switch, GQA) for
// NVIDIA Hopper (sm_90a), with both products on the tensor cores.
//
//   o[b, h, i, :] = sum_j softmax_j(q[b,h,i,:] . k[b,g,j,:] * hd^-0.5) v[b,g,j,:]
//   with g = h // (H / KV); causal: key j is masked (score -1e30) when j > i.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel). Contract kept: scores are f32 sums of products of the
// inputs, scaled after the product; masked scores are -1e30 (in the base-2
// units the softmax runs in) and keys past Sk -inf; causal is top-left
// aligned (query i sees keys 0..i whatever Sq and Sk are); the
// probabilities are rounded to v's dtype before the PV product, whose sums
// are f32; the running denominator l sums the unrounded probabilities; the
// output is acc / max(l, 1e-30) in q's dtype.
// q, k, v share one dtype (f32 or bf16); hd is 16, 32, 64, 96 (phi-3-vision's
// 3072 / 32), 112 (zamba2-7b's 3584 / 32) or 128; Sq and Sk are any length.
//
// Bound on this card: operations, 4 hd flops per (query, key) pair that the
// mask keeps. bf16 runs at the tensor cores' 989 TFLOP/s. f32 must keep f32
// accuracy, so its least time is at the three-pass TF32 rate, 494.7 / 3 =
// 165 TFLOP/s (67 TFLOP/s on the CUDA cores). Bytes (q, k, v and o once)
// bound neither model shape.
//
// Design (FlashAttention-2 layout). One block per (query tile, head,
// batch): 8 warps and 128 queries in bf16, 4 warps and 64 queries in f32
// (whose tiles take twice the shared memory); the causal tiles with the
// most keys are scheduled first. Each warp owns 16 query rows. Both products are mma.sync on the
// tensor cores with f32 accumulators:
// - bf16: m16n8k16. Q and K fragments come by ldmatrix, V's by
//   ldmatrix.trans; P, rounded to bf16, is re-packed in registers from the
//   QK^T accumulators into the A operand of PV (no shared round trip).
// - f32: m16n8k8 TF32 in three passes: x = big + small with
//   big = cvt.rna.tf32(x) and small = x - big (the product reads its top 19
//   bits), and a.b = a_small b_big + a_big b_small + a_big b_big, summed in
//   f32 (the dropped terms are about 2^-21 of a.b). One TF32 pass keeps
//   about three digits and would not hold the f32 contract. For PV the
//   accumulator columns 2t and 2t+1 of P feed the A operand's k-slots t and
//   t+4, and V's rows are read in the same order, so P stays in registers.
// S stays in registers as mma fragments; a row's max and sum take two
// shuffles inside the quad of lanes that hold it; the softmax runs in base 2
// (scores scaled by hd^-0.5 log2 e, exp by the special-function unit's ex2). K and V tiles (64 keys in
// bf16, 32 in f32) go through a double-buffered shared ring filled by
// cp.async (16 bytes a thread, zero-filled past Sk and Sq): the next tile's
// copy runs under this tile's products. Shared rows are padded (8 bf16, 4
// f32 values) so that fragment loads hit distinct banks. A block takes at
// most 104,448 bytes of shared memory (bf16, hd 128), so two fit on an SM.
// The running max starts at key 0, which every causal row sees, so it is
// finite after the first tile; a warp skips a causal tile whose keys all
// lie past its rows (it would add exactly 0).
//
// Strides are arguments: the model hands over (B, S, H, hd) activations
// viewed as (B, H, S, hd), read and written in place. The wrapper makes
// every row start 16-byte aligned (last axis contiguous).
//
// C interface (no PyTorch headers; loaded with ctypes). The kernel runs on
// the given stream, allocates nothing, and the launcher returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e30f;
constexpr int kMaxDevices = 64;

// per dtype: warps of 16 query rows, keys per K/V tile, row padding
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int WARPS = 4, BK = 32, PAD = 4; };
template <> struct Tile<__nv_bfloat16> { static constexpr int WARPS = 8, BK = 64, PAD = 8; };
// blocks an SM must hold: for bf16's 8 warps this caps a thread at 128
// registers (f32's 4 warps are held to 2 blocks by shared memory anyway)
constexpr int kMinBlocks = 2;
template <typename T> constexpr int kThreads = 32 * Tile<T>::WARPS;
template <typename T> constexpr int BQ = 16 * Tile<T>::WARPS;  // query rows per block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, KV, Sq, Sk;
  float scale;
};

// Q tile and two K and two V tiles, rows padded to HD + PAD
template <typename T, int HD>
constexpr int smem_bytes() {
  return (BQ<T> + 4 * Tile<T>::BK) * (HD + Tile<T>::PAD) * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + R) of a (rows, HD) matrix with row stride `stride`
// into shared rows of LD elements; rows >= nrows become zeros
template <typename T, int HD, int LD, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride, int row0,
                                          int nrows) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte copy
  constexpr int CPR = HD / EPC;                           // copies per row
#pragma unroll
  for (int e = threadIdx.x; e < R * CPR; e += kThreads<T>) {
    const int r = e / CPR, c = (e % CPR) * EPC;
    const bool valid = row0 + r < nrows;
    cp_async16(dst + r * LD + c, valid ? src + int64_t(row0 + r) * stride + c : src, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the three-pass split: big = tf32(x) and small = x - big, handed over as
// f32 bits (the TF32 product reads their top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// 2^x on the special-function unit (relative error about 2^-22 for the
// arguments here; -1e30 and -inf give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a.b at f32 accuracy: three TF32 passes, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bs0,
                                           uint32_t bb1, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads<T>, kMinBlocks) flash_fwd(const Args a) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int BK = Tile<T>::BK, LD = HD + Tile<T>::PAD, BQT = BQ<T>;
  constexpr int NT = BK / 8;  // score tiles of 8 keys
  constexpr int DT = HD / 8;  // output tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQT * LD;     // two buffers of BK rows
  T* Vs = Ks + 2 * BK * LD;  // two buffers of BK rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQT;  // heavy causal tiles first
  const int kvh = h / (a.H / a.KV);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  const float scale2 = a.scale * 1.4426950408889634f;  // hd^-0.5 log2 e
  int n_tiles = (a.Sk + BK - 1) / BK;
  if (CAUSAL) n_tiles = min(n_tiles, (min(q0 + BQT, a.Sq) - 1) / BK + 1);

  load_tile<T, HD, LD, BQT>(Qs, qp, a.q_ss, q0, a.Sq);
  load_tile<T, HD, LD, BK>(Ks, kp, a.k_ss, 0, a.Sk);
  load_tile<T, HD, LD, BK>(Vs, vp, a.v_ss, 0, a.Sk);
  cp_async_commit();

  const int wrow = warp * 16;             // the warp's first row in the tile
  const int row_lo = q0 + wrow + g;       // this thread's rows: row_lo, row_lo + 8
  const int warp_last = q0 + wrow + 15;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    if (t + 1 < n_tiles) {  // the next tile's copy runs under this tile's products
      const int nb = (t + 1) & 1;
      load_tile<T, HD, LD, BK>(Ks + nb * BK * LD, kp, a.k_ss, k0 + BK, a.Sk);
      load_tile<T, HD, LD, BK>(Vs + nb * BK * LD, vp, a.v_ss, k0 + BK, a.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + (t & 1) * BK * LD;
    const T* Vt = Vs + (t & 1) * BK * LD;

    if (!CAUSAL || k0 <= warp_last) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

      // S = Q K^T
      if constexpr (BF16) {
        // ldmatrix: lane l addresses row l % 8 of 8x8 matrix l / 8
        const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t af[4];
          ldsm_x4(af, Qs + (wrow + (mi & 1) * 8 + mr) * LD + ks * 16 + (mi >> 1) * 8);
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t kb[4];  // B fragments of key tiles 2 jp and 2 jp + 1
            ldsm_x4(kb, Kt + ((2 * jp + (mi >> 1)) * 8 + mr) * LD + ks * 16 + (mi & 1) * 8);
            mma_bf16(s[2 * jp], af, kb[0], kb[1]);
            mma_bf16(s[2 * jp + 1], af, kb[2], kb[3]);
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) {
          const float* qa = reinterpret_cast<const float*>(Qs) + (wrow + g) * LD + ks * 8 + t4;
          uint32_t ab[4], as[4];
          split(qa[0], ab[0], as[0]);
          split(qa[8 * LD], ab[1], as[1]);
          split(qa[4], ab[2], as[2]);
          split(qa[8 * LD + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float* kb = reinterpret_cast<const float*>(Kt) + (j * 8 + g) * LD + ks * 8 + t4;
            uint32_t bb0, bs0, bb1, bs1;
            split(kb[0], bb0, bs0);
            split(kb[4], bb1, bs1);
            mma_3xtf32(s[j], ab, as, bb0, bs0, bb1, bs1);
          }
        }
      }

      // online softmax in base 2: scores are scaled by hd^-0.5 log2 e, so
      // exp(s - m) is 2^(x - m); accumulator e of tile j is
      // (row_lo + 8 (e / 2), k0 + 8 j + 2 t4 + e % 2)
      const bool edge = k0 + BK > a.Sk || (CAUSAL && k0 + BK - 1 > q0 + wrow);
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (edge) {
            const int col = k0 + j * 8 + 2 * t4 + (e & 1);
            if (col >= a.Sk) {
              x = -INFINITY;
            } else if (CAUSAL && col > row_lo + 8 * (e >> 1)) {
              x = kMaskValue;
            }
          }
          s[j][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        corr[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(s[j][e] - m[e >> 1]);
          rs[e >> 1] += p;
          s[j][e] = p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * corr[r] + rs[r];
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= corr[0];
        acc[d][1] *= corr[0];
        acc[d][2] *= corr[1];
        acc[d][3] *= corr[1];
      }

      // acc += P V
      if constexpr (BF16) {
        const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < DT / 2; ++dp) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, Vt + (kk * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8);
            mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
            mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          // k-slot t <-> key 2 t, slot t + 4 <-> key 2 t + 1 (P's own columns)
          uint32_t pb[4], ps[4];
          split(s[kk][0], pb[0], ps[0]);
          split(s[kk][2], pb[1], ps[1]);
          split(s[kk][1], pb[2], ps[2]);
          split(s[kk][3], pb[3], ps[3]);
          const float* vr = reinterpret_cast<const float*>(Vt) + (kk * 8 + 2 * t4) * LD + g;
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            uint32_t bb0, bs0, bb1, bs1;
            split(vr[d * 8], bb0, bs0);
            split(vr[d * 8 + LD], bb1, bs1);
            mma_3xtf32(acc[d], pb, ps, bb0, bs0, bb1, bs1);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this tile's buffers
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = op + int64_t(row) * a.o_ss + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const float x0 = acc[d][2 * r] / denom, x1 = acc[d][2 * r + 1] / denom;
      if constexpr (BF16) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) = __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + d * 8) = make_float2(x0, x1);
      }
    }
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory, once per
// device (`done` is the kernel's own flags): the attribute belongs to the
// current device's context, so a flag for the whole process would leave a
// second card's launches refused.
int opt_in_smem(const void* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

template <typename T, int HD, bool CAUSAL>
int launch_one(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, HD>();
  static bool opted_in[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    const int rc = opt_in_smem(reinterpret_cast<const void*>(flash_fwd<T, HD, CAUSAL>), smem,
                               opted_in);
    if (rc != 0) return rc;
  }
  const dim3 grid(B * a.H, (a.Sq + BQ<T> - 1) / BQ<T>);
  flash_fwd<T, HD, CAUSAL><<<grid, kThreads<T>, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int B, int hd, bool causal, cudaStream_t s) {
  switch (hd) {
    case 16: return causal ? launch_one<T, 16, true>(a, B, s) : launch_one<T, 16, false>(a, B, s);
    case 32: return causal ? launch_one<T, 32, true>(a, B, s) : launch_one<T, 32, false>(a, B, s);
    case 64: return causal ? launch_one<T, 64, true>(a, B, s) : launch_one<T, 64, false>(a, B, s);
    case 96: return causal ? launch_one<T, 96, true>(a, B, s) : launch_one<T, 96, false>(a, B, s);
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
// axis contiguous; every row 16-byte aligned). dtype 0 = float32,
// 1 = bfloat16; hd in {16, 32, 64, 96, 112, 128}; scale is hd^-0.5 rounded to
// f32 by the caller.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           int B, int H, int KV, int Sq, int Sk, int hd, float scale,
                           int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      int64_t(B) * H > 0x7fffffff || (Sq + 15) / 16 > 65535) {
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
