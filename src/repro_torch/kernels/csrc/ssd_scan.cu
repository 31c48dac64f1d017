// ssd_scan: the chunked SSD (state-space dual) scan of Mamba2, for NVIDIA
// Hopper (sm_90a), chunk-parallel, with its products on the tensor cores.
//
//   h_t = exp(a_t) h_{t-1} + b_t^T x_t ;  y_t = c_t h_t ;  h_0 = 0
//   x: (B, H, L, P) values, a: (B, H, L) log-decay <= 0, b, c: (B, H, L, N)
//
// computed chunk by chunk, as the state-space dual form: for chunk z of Q
// steps with acs = cumsum(a) inside it and h_z the state entering it,
//   y     = ((C B^T) o tril(exp(acs_i - acs_j))) X + (C o exp(acs)) h_z
//   h_z+1 = exp(acs[-1]) h_z + s_z,  s_z = sum_j exp(acs[-1] - acs_j) B_j^T X_j
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::
// ssd_scan_pallas (body _ssd_kernel, grid (B, H, chunk) with the (N, P)
// state in VMEM scratch carried across the sequential chunk axis).
// Contract kept: every product and sum at f32 accuracy whatever the inputs'
// dtype (x, b, c share one dtype, f32 or bf16; a is f32); the segment sum
// is a difference of cumsums (not a running product); entries above the
// diagonal are exactly 0; y is written in x's dtype; the state starts at
// zero. One addition: with h_out set, the final (N, P) state of each (b, h)
// is written out in f32 (the state Mamba2's prefill hands to decode). L must
// be a multiple of Q: the wrapper pads the tail with identity steps.
//
// Bound on this card: operations at the loss shape, bytes at the serve
// shape. Per chunk the causal scores take 2 N flops per (i, j <= i) pair,
// once for all heads when B and C are shared; per head, their product
// with X 2 P flops per pair, the carry-in and the chunk state 2 N P each
// per step. At f32 accuracy the least time is at the three-pass TF32
// rate, 494.7 / 3 = 165 TFLOP/s (67 TFLOP/s on the CUDA cores); with bf16
// inputs the scores are exact at the bf16 rate. Bytes: x, y once, b, c
// once per distinct (b, h) view, a once, the final state once.
//
// Design: the chunk-parallel decomposition of the Mamba2 SSD algorithm
// (Dao and Gu, arXiv:2405.21060, section 7). Every launch is on one
// stream:
//   (a') ssd_chunk_scores, a block per (64 x 64 block on or below the
//        diagonal, b, z): the raw scores C_i . B_j of the chunk, once for
//        all heads when B and C are one group shared by the heads
//        (Mamba2's case), else per (b, h, z);
// then, for chunks of at most 64 steps and a state of at most 64 rows over
// at least two (b, h) pairs per SM of the card, one more launch:
//   (s)  ssd_scan_seq, a block per (b, h) walking its chunks in order with
//        the state in shared memory: no state goes through device memory;
// and otherwise three:
//   (a)  ssd_chunk_state, a block per (b, h, z, 64 state rows): the
//        chunk's cumsum of a, its state s_z (to `states`) and its total
//        decay acs[-1] (to `dlast`);
//   (b)  ssd_state_pass, a thread per four (b, h) state elements: over z
//        in order, h_z replaces s_z in `states` in place, and the last
//        state goes to h_out;
//   (c)  ssd_chunk_out, a block per (b, h, z, 64 rows of the chunk), the
//        tiles with the most causal work first: y = exp(acs_i) (C h_z) plus
//        the intra-chunk term, over key tiles up to its diagonal.
// Only phase (b) walks the chunks of a (b, h) in order, and it does no
// products. Every product is mma.sync m16n8k8 TF32 with f32 accumulators,
// in three passes for f32 operands (x = big + small, big =
// cvt.rna.tf32(x), small = x - big, of which the product reads the top 19
// bits; a.b = a_s b_b + a_b b_s + a_b b_b): one pass keeps about three
// digits. A bf16 input is exact in TF32, so a product of two inputs
// (C B^T) takes one pass and a product of an input with an f32 factor two.
// Each warp owns 16 rows; the decayed, masked scores are built in
// registers as the A operand of their product with X: accumulator columns
// 2t and 2t+1 go to k-slots t and t+4, and X's rows are read in that order.
// exp is the special-function unit's ex2 of x log2 e. f32 tiles are staged
// with cp.async (16 bytes a thread where rows are 16-byte aligned, else 4),
// key tiles double-buffered so that the next tile's copy runs under this
// tile's products; bf16 tiles are converted on the way in. N and P are
// padded with zeros in shared memory (N to a multiple of 8, P to 8, 16, 32,
// 64 or 128), the chunk to the key tile; shared rows are padded by 4 floats
// so that fragment loads hit distinct banks. Inputs are read through
// strides (the last axis contiguous), so Mamba2's B and C, shared by every
// head, arrive as a stride-0 head view with no copy, and x and y as
// transposed (B, L, H, P) views. The scratch (`scores`, `states`, `dlast`)
// is the caller's.
//
// C interface (no PyTorch headers; loaded with ctypes). The kernels run on
// the given stream, allocate nothing, and the launcher returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps of 16 rows
constexpr int BR = 64;          // rows of a block: chunk rows (c), state rows (a)
constexpr int BJ = 32;          // keys (chunk steps) per staged tile
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use (H100)
constexpr int kMaxP = 128;
constexpr int kSeqQ = 64;       // the longest chunk (and widest state) of ssd_scan_seq
constexpr int kMaxDevices = 64;

struct Args {
  const void* x;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* h_out;   // (B, H, N, P) contiguous, or null
  float* states;  // (B, H, Z, N, P) contiguous scratch
  float* dlast;   // (B, H, Z) contiguous scratch
  float* scores;  // (B, Z, Q, Q), or (B, H, Z, Q, Q) unless shared_bc: contiguous scratch
  int64_t x_sb, x_sh, x_sl, a_sb, a_sh, a_sl, b_sb, b_sh, b_sl, c_sb, c_sh, c_sl, y_sb, y_sh,
      y_sl;
  int H, L, P, N, Q, Z, NP;
  bool shared_bc;                          // b and c one group for every head
  bool vec_x, vec_b, vec_c, vec_s, vec_q;  // rows 16-byte aligned (f32; vec_q: Q % 4 == 0)
  bool pair_y;  // y's elements (i, 2k) and (i, 2k + 1) form one aligned pair
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ constexpr int p_tile(int P) {
  return P <= 8 ? 8 : P <= 16 ? 16 : P <= 32 ? 32 : P <= 64 ? 64 : 128;
}

// floats of shared memory of phase (a): acs and dec (QR each), two B and two
// X key tiles
__host__ __device__ inline int64_t smem_state_floats(int NP, int PT, int Q) {
  return 2 * int64_t(round_up(Q, BJ)) + 2 * BJ * (NP + 4) + 2 * BJ * (PT + 4);
}

// phase (c): acs (QR), h_z, two score tiles (BR x BJ) and two X key tiles
__host__ __device__ inline int64_t smem_out_floats(int NP, int PT, int Q) {
  return int64_t(round_up(Q, BJ)) + NP * (PT + 4) + 2 * BR * (BJ + 4) + 2 * BJ * (PT + 4);
}

// ssd_scan_seq: acs, dec, h and two chunks' X
__host__ __device__ inline int64_t smem_seq_floats(int NP, int PT) {
  return 2 * kSeqQ + NP * (PT + 4) + 2 * kSeqQ * (PT + 4);
}

// whether ssd_scan_seq can take a call: chunks and state no larger than its
// tiles
inline bool seq_fits(int NP, int Q) { return Q <= kSeqQ && NP <= kSeqQ; }

// the scores kernel: 64 rows of C and 64 of B
__host__ __device__ inline int64_t smem_scores_floats(int NP) { return 2 * BR * (NP + 4); }

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

// y[i][col], y[i][col + 1] (those below P) from one output fragment pair
template <typename T>
__device__ __forceinline__ void store_y(T* yrow, int col, const Args& a, float v0, float v1) {
  if (col >= a.P) return;
  if (a.pair_y) {  // P even: col + 1 < P
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(yrow + col) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(yrow + col) = __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  yrow[col] = from_f32<T>(v0);
  if (col + 1 < a.P) yrow[col + 1] = from_f32<T>(v1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + R) and columns [0, Wp) of a matrix with W columns (the
// last axis contiguous, row stride sl) into f32 shared rows of `ld`; rows
// >= nrows and columns >= W become zeros. f32 goes by cp.async (16 bytes
// when `vec`: rows 16-byte aligned and W % 4 == 0), bf16 by converting loads.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int64_t sl, int r0,
                                      int R, int nrows, int W, int Wp, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      const int cpr = Wp / 4;
      for (int e = threadIdx.x; e < R * cpr; e += kThreads) {
        const int r = e / cpr, col = (e % cpr) * 4;
        const bool valid = r0 + r < nrows && col < W;
        cp_async16(dst + r * ld + col, valid ? src + int64_t(r0 + r) * sl + col : src, valid);
      }
      return;
    }
    for (int e = threadIdx.x; e < R * Wp; e += kThreads) {
      const int r = e / Wp, col = e % Wp;
      const bool valid = r0 + r < nrows && col < W;
      cp_async4(dst + r * ld + col, valid ? src + int64_t(r0 + r) * sl + col : src, valid);
    }
  } else {
    for (int e = threadIdx.x; e < R * Wp; e += kThreads) {
      const int r = e / Wp, col = e % Wp;
      const bool valid = r0 + r < nrows && col < W;
      dst[r * ld + col] = valid ? to_f32<T>(src[int64_t(r0 + r) * sl + col]) : 0.f;
    }
  }
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

// An mma operand as big + small TF32 parts: big = cvt.rna.tf32(x) and
// small = x - big, handed over as f32 bits (the TF32 product reads their
// top 19 bits). An EXACT operand (a bf16 input, exact in TF32) keeps
// small = 0 and skips its pass.
template <int K, bool EXACT>
struct Split {
  uint32_t big[K], small[K];
  __device__ __forceinline__ explicit Split(const float (&v)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      big[i] = to_tf32(v[i]);
      small[i] = EXACT ? 0u : __float_as_uint(v[i] - __uint_as_float(big[i]));
    }
  }
};

// exp(x) as 2^(x log2 e) on the special-function unit (relative error about
// 2^-22 for the arguments here, |x| <= a few hundred)
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// d += a.b at f32 accuracy: up to three TF32 passes, the small terms first
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_f32(float (&d)[4], const Split<4, A_EXACT>& a,
                                        const Split<2, B_EXACT>& b) {
  if (!A_EXACT) mma_tf32(d, a.small, b.big[0], b.big[1]);
  if (!B_EXACT) mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// inclusive cumsum of the chunk's a into acs[0, Q), zeros up to QR; ends
// with the block synchronised
__device__ void chunk_cumsum(float* acs, const float* ap, int64_t a_sl, int Q, int QR) {
  const int tid = threadIdx.x;
  for (int e = tid; e < QR; e += kThreads) acs[e] = e < Q ? ap[e * a_sl] : 0.f;
  __syncthreads();
  if (tid < 32) {  // runs per lane, then a shuffle scan of the run totals
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
}

// (a) s_z[n][p] = sum_j B[j][n] (exp(acs[-1] - acs_j) X[j][p]): rows n of the
// product are the warps' 16-row slices of the block's 64 state rows.
template <typename T, int PT>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(const Args a) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LDX = PT + 4, PW = PT / 8;  // column tiles of 8
  extern __shared__ __align__(16) float smem[];
  const int NP = a.NP, Q = a.Q, QR = round_up(Q, BJ), LDB = NP + 4;
  float* acs = smem;
  float* dec = acs + QR;
  float* Bs = dec + QR;          // two tiles of BJ x LDB
  float* Xs = Bs + 2 * BJ * LDB;  // two tiles of BJ x LDX

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bhz = blockIdx.x, z = bhz % a.Z, bh = bhz / a.Z;
  const int64_t bi = bh / a.H, hi = bh % a.H, l0 = int64_t(z) * Q;
  const T* xp = static_cast<const T*>(a.x) + bi * a.x_sb + hi * a.x_sh + l0 * a.x_sl;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + hi * a.b_sh + l0 * a.b_sl;
  const float* ap = a.a + bi * a.a_sb + hi * a.a_sh + l0 * a.a_sl;
  const int n_tiles = QR / BJ;

  stage<T>(Bs, LDB, bp, a.b_sl, 0, BJ, Q, a.N, NP, a.vec_b);
  stage<T>(Xs, LDX, xp, a.x_sl, 0, BJ, Q, a.P, PT, a.vec_x);
  cp_async_commit();
  chunk_cumsum(acs, ap, a.a_sl, Q, QR);
  const float last = acs[Q - 1];
  for (int e = tid; e < QR; e += kThreads) dec[e] = e < Q ? fast_exp(last - acs[e]) : 0.f;
  if (blockIdx.y == 0 && tid == 0) a.dlast[bhz] = last;

  const int n0 = blockIdx.y * BR + warp * 16;  // the warp's first state row
  float acc[PW][4];
#pragma unroll
  for (int p = 0; p < PW; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      stage<T>(Bs + nb * BJ * LDB, LDB, bp, a.b_sl, (t + 1) * BJ, BJ, Q, a.N, NP, a.vec_b);
      stage<T>(Xs + nb * BJ * LDX, LDX, xp, a.x_sl, (t + 1) * BJ, BJ, Q, a.P, PT, a.vec_x);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // also orders dec (written above) before its first read
    const float* Bt = Bs + (t & 1) * BJ * LDB;
    const float* Xt = Xs + (t & 1) * BJ * LDX;
    if (n0 < NP) {
#pragma unroll
      for (int kk = 0; kk < BJ / 8; ++kk) {
        // k-slot t <-> step 2 t, slot t + 4 <-> step 2 t + 1 (A = B^T)
        const int j = kk * 8 + 2 * t4;
        const float* b0 = Bt + j * LDB + n0 + g;
        const float av[4] = {b0[0], b0[8], b0[LDB], b0[LDB + 8]};
        const Split<4, EXACT> af(av);
        const float d0 = dec[t * BJ + j], d1 = dec[t * BJ + j + 1];
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          const float* x0 = Xt + j * LDX + p * 8 + g;
          const float bv[2] = {x0[0] * d0, x0[LDX] * d1};
          mma_f32(acc[p], af, Split<2, false>(bv));
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this tile's buffers
  }
  if (n0 >= NP) return;
  float* sp = a.states + int64_t(bhz) * a.N * a.P;
  const bool pairs = a.P % 2 == 0;  // (n, col) and (n, col + 1) as one 8-byte store
#pragma unroll
  for (int p = 0; p < PW; ++p) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + g + 8 * r, col = p * 8 + 2 * t4;
      if (n >= a.N || col >= a.P) continue;
      float* dst = sp + n * a.P + col;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[p][2 * r], acc[p][2 * r + 1]);
      } else {
        dst[0] = acc[p][2 * r];
        if (col + 1 < a.P) dst[1] = acc[p][2 * r + 1];
      }
    }
  }
}

// (b) over the chunks in order, four state elements a thread: h_z replaces
// s_z in place (z > 0); h_{z+1} = exp(acs[-1]_z) h_z + s_z; the last one
// goes to h_out. The next chunk's values are loaded before this chunk's stores, so
// each thread keeps loads in flight instead of waiting on one at a time.
constexpr int kPassItems = 4;

__global__ void __launch_bounds__(kThreads) ssd_state_pass(const Args a) {
  const int64_t NPe = int64_t(a.N) * a.P;
  const int64_t e0 = (int64_t(blockIdx.y) * kThreads + threadIdx.x) * kPassItems;
  if (e0 >= NPe) return;
  const int64_t bh = blockIdx.x;
  float* sp = a.states + bh * a.Z * NPe + e0;
  const float* dl = a.dlast + bh * a.Z;
  const bool vec = a.vec_s;  // NPe % 4 == 0 and rows 16-byte aligned
  auto load = [&](int z, float (&v)[kPassItems]) {
    const float* src = sp + z * NPe;
    if (vec) {
      const float4 q = *reinterpret_cast<const float4*>(src);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < kPassItems; ++i) v[i] = e0 + i < NPe ? src[i] : 0.f;
    }
  };
  auto store = [&](float* dst, const float (&v)[kPassItems]) {
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kPassItems; ++i) {
        if (e0 + i < NPe) dst[i] = v[i];
      }
    }
  };
  float h[kPassItems] = {0.f, 0.f, 0.f, 0.f}, s[kPassItems], nxt[kPassItems];
  load(0, nxt);
  float d_nxt = dl[0];
  for (int z = 0; z < a.Z; ++z) {
    const float d = fast_exp(d_nxt);
#pragma unroll
    for (int i = 0; i < kPassItems; ++i) s[i] = nxt[i];
    if (z + 1 < a.Z) {
      load(z + 1, nxt);
      d_nxt = dl[z + 1];
    }
    if (z > 0) store(sp + z * NPe, h);  // chunk 0 starts from zero and reads no state
#pragma unroll
    for (int i = 0; i < kPassItems; ++i) h[i] = fmaf(h[i], d, s[i]);
  }
  if (a.h_out != nullptr) store(a.h_out + bh * NPe + e0, h);
}

// (a') the raw scores C_i . B_j of a chunk (no decay, no mask), in 64 x 64
// blocks on or below the diagonal: once per (b, z) when B and C are one
// group shared by the heads (Mamba2's case), else per (b, h, z)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scores(const Args a) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  const int r0 = blockIdx.y * BR, k0 = blockIdx.z * BR;
  if (k0 > r0) return;  // above the diagonal: never read
  extern __shared__ __align__(16) float smem[];
  const int NP = a.NP, Q = a.Q, LDB = NP + 4;
  float* Cs = smem;
  float* Bs = Cs + BR * LDB;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int gi = blockIdx.x, z = gi % a.Z;
  const int64_t bi = a.shared_bc ? gi / a.Z : gi / a.Z / a.H;
  const int64_t hi = a.shared_bc ? 0 : gi / a.Z % a.H, l0 = int64_t(z) * Q;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + hi * a.b_sh + l0 * a.b_sl;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + hi * a.c_sh + l0 * a.c_sl;
  stage<T>(Cs, LDB, cp, a.c_sl, r0, BR, Q, a.N, NP, a.vec_c);
  stage<T>(Bs, LDB, bp, a.b_sl, k0, BR, Q, a.N, NP, a.vec_b);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int wrow = r0 + warp * 16;
  if (wrow >= Q) return;

  float s[BR / 8][4];
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
  for (int k = 0; k < NP; k += 8) {
    const float* c0 = Cs + (warp * 16 + g) * LDB + k + t4;
    const float av[4] = {c0[0], c0[8 * LDB], c0[4], c0[8 * LDB + 4]};
    const Split<4, EXACT> af(av);
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const float* b0 = Bs + (j * 8 + g) * LDB + k + t4;
      const float bv[2] = {b0[0], b0[4]};
      mma_f32(s[j], af, Split<2, EXACT>(bv));
    }
  }
  float* out = a.scores + int64_t(gi) * Q * Q;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wrow + g + 8 * r;
    if (i >= Q) continue;
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const int col = k0 + j * 8 + 2 * t4;
      if (col < Q) out[int64_t(i) * Q + col] = s[j][2 * r];
      if (col + 1 < Q) out[int64_t(i) * Q + col + 1] = s[j][2 * r + 1];
    }
  }
}

// (c) rows [r0, r0 + 64) of chunk z:
//   y_i = exp(acs_i) (C_i h_z) + sum_{j <= i} scores_ij exp(acs_i - acs_j) X_j
// The decayed, masked scores are built in registers from the score tile as
// the A operand of their product with X. Each warp owns 16 rows.
template <typename T, int PT>
__global__ void __launch_bounds__(kThreads) ssd_chunk_out(const Args a) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LDX = PT + 4, LDS = BJ + 4, PW = PT / 8;  // PW: column tiles of 8
  constexpr int NJ = BJ / 8;  // k-steps of 8 keys
  extern __shared__ __align__(16) float smem[];
  const int NP = a.NP, Q = a.Q, QR = round_up(Q, BJ);
  float* acs = smem;
  float* Hs = acs + QR;           // NP x LDX
  float* Ss = Hs + NP * LDX;      // two tiles of BR x LDS
  float* Xs = Ss + 2 * BR * LDS;  // two tiles of BJ x LDX

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bhz = blockIdx.x, z = bhz % a.Z, bh = bhz / a.Z;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BR;  // heavy row tiles first
  const int64_t bi = bh / a.H, hi = bh % a.H, l0 = int64_t(z) * Q;
  const T* xp = static_cast<const T*>(a.x) + bi * a.x_sb + hi * a.x_sh + l0 * a.x_sl;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + hi * a.c_sh + l0 * a.c_sl;
  const float* ap = a.a + bi * a.a_sb + hi * a.a_sh + l0 * a.a_sl;
  const float* sp = a.scores + (a.shared_bc ? bi * a.Z + z : int64_t(bhz)) * Q * Q;
  T* yp = static_cast<T*>(a.y) + bi * a.y_sb + hi * a.y_sh + l0 * a.y_sl;
  const int n_tiles = (min(r0 + BR, Q) + BJ - 1) / BJ;  // key tiles up to the diagonal

  if (z > 0) {
    stage<float>(Hs, LDX, a.states + int64_t(bhz) * a.N * a.P, a.P, 0, NP, a.N, a.P, PT,
                 a.vec_s);
  }
  stage<float>(Ss, LDS, sp, Q, r0, BR, Q, min(BJ, Q), BJ, a.vec_q);
  stage<T>(Xs, LDX, xp, a.x_sl, 0, BJ, Q, a.P, PT, a.vec_x);
  cp_async_commit();
  chunk_cumsum(acs, ap, a.a_sl, Q, QR);

  const int wrow = r0 + warp * 16;  // the warp's first row
  const int i_lo = wrow + g;      // this thread's rows: i_lo, i_lo + 8
  const bool live = wrow < Q;
  float acc[PW][4];
#pragma unroll
  for (int p = 0; p < PW; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * BJ;
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      stage<float>(Ss + nb * BR * LDS, LDS, sp + j0 + BJ, Q, r0, BR, Q, min(BJ, Q - j0 - BJ),
                   BJ, a.vec_q);
      stage<T>(Xs + nb * BJ * LDX, LDX, xp, a.x_sl, j0 + BJ, BJ, Q, a.P, PT, a.vec_x);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0 && z > 0 && live) {
      // carry-in: acc = exp(acs_i) (C_i h_z), C's fragments read from memory
      const T* c_lo = cp + int64_t(i_lo) * a.c_sl;
      const T* c_hi = c_lo + 8 * a.c_sl;
      const bool in_lo = i_lo < Q, in_hi = i_lo + 8 < Q;
#pragma unroll 2
      for (int k = 0; k < NP; k += 8) {
        const int n0 = k + t4, n1 = k + t4 + 4;
        const float av[4] = {in_lo && n0 < a.N ? to_f32<T>(c_lo[n0]) : 0.f,
                             in_hi && n0 < a.N ? to_f32<T>(c_hi[n0]) : 0.f,
                             in_lo && n1 < a.N ? to_f32<T>(c_lo[n1]) : 0.f,
                             in_hi && n1 < a.N ? to_f32<T>(c_hi[n1]) : 0.f};
        const Split<4, EXACT> af(av);
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          const float* h0 = Hs + n0 * LDX + p * 8 + g;
          const float bv[2] = {h0[0], h0[4 * LDX]};
          mma_f32(acc[p], af, Split<2, false>(bv));
        }
      }
      const float e0 = in_lo ? fast_exp(acs[i_lo]) : 0.f;
      const float e1 = in_hi ? fast_exp(acs[i_lo + 8]) : 0.f;
#pragma unroll
      for (int p = 0; p < PW; ++p) {
        acc[p][0] *= e0;
        acc[p][1] *= e0;
        acc[p][2] *= e1;
        acc[p][3] *= e1;
      }
    }
    const float* St = Ss + (t & 1) * BR * LDS + (warp * 16 + g) * LDS;
    const float* Xt = Xs + (t & 1) * BJ * LDX;
    if (live && j0 <= wrow + 15) {  // a tile wholly past the warp's rows adds exactly 0
      // a row past Q keeps nothing: its last key is -1
      const int last_lo = i_lo < Q ? i_lo : -1, last_hi = i_lo + 8 < Q ? i_lo + 8 : -1;
      const float a_lo = acs[max(last_lo, 0)], a_hi = acs[max(last_hi, 0)];
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        // k-slot t <-> key 2 t, slot t + 4 <-> key 2 t + 1: the score tile's
        // own pairs of columns, decayed and masked (exactly 0 above the diagonal)
        const int jj = j0 + kk * 8 + 2 * t4;
        const float2 s_lo = *reinterpret_cast<const float2*>(St + kk * 8 + 2 * t4);
        const float2 s_hi = *reinterpret_cast<const float2*>(St + 8 * LDS + kk * 8 + 2 * t4);
        const float aj0 = acs[jj], aj1 = acs[jj + 1];
        const float av[4] = {jj <= last_lo ? s_lo.x * fast_exp(a_lo - aj0) : 0.f,
                             jj <= last_hi ? s_hi.x * fast_exp(a_hi - aj0) : 0.f,
                             jj < last_lo ? s_lo.y * fast_exp(a_lo - aj1) : 0.f,
                             jj < last_hi ? s_hi.y * fast_exp(a_hi - aj1) : 0.f};
        const Split<4, false> af(av);
        const float* x0 = Xt + (kk * 8 + 2 * t4) * LDX + g;
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          const float bv[2] = {x0[p * 8], x0[p * 8 + LDX]};
          mma_f32(acc[p], af, Split<2, EXACT>(bv));
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this tile's buffers
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_lo + 8 * r;
    if (i >= Q) continue;
    T* yrow = yp + int64_t(i) * a.y_sl;
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const int col = p * 8 + 2 * t4;
      store_y<T>(yrow, col, a, acc[p][2 * r], acc[p][2 * r + 1]);
    }
  }
}

// (s) short chunks (Q <= 64, N <= 64) over many (b, h): one block per
// (b, h) walks its chunks in order, so the state never leaves the block:
// per chunk y = exp(acs_i) (C_i h) + decayed scores X, then
// h = exp(acs[-1]) h + B^T (dec X), with h in shared memory. x is read
// and y written once; no state goes through device memory. Only X and h,
// which every warp reads, are staged; a warp reads its own rows of the
// scores, B and C (shared by the heads, so mostly from L2) straight into
// registers, which keeps the block at 52 KB of shared memory; the next
// chunk's X is copied in while this chunk computes.
template <typename T, int PT>
__global__ void __launch_bounds__(kThreads) ssd_scan_seq(const Args a) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LDX = PT + 4, PW = PT / 8;
  extern __shared__ __align__(16) float smem[];
  const int NP = a.NP, Q = a.Q;
  float* acs = smem;                // kSeqQ
  float* dec = acs + kSeqQ;         // kSeqQ
  float* Hs = dec + kSeqQ;          // NP x LDX: the state entering the chunk
  float* Xs = Hs + NP * LDX;        // two buffers of kSeqQ x LDX

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int64_t bi = bh / a.H, hi = bh % a.H;
  const int i_lo = warp * 16 + g;  // this thread's chunk rows i_lo, i_lo + 8 (and state rows)
  const bool live = warp * 16 < Q, state_live = warp * 16 < NP;
  const int last_lo = i_lo < Q ? i_lo : -1, last_hi = i_lo + 8 < Q ? i_lo + 8 : -1;
  for (int e = tid; e < NP * LDX; e += kThreads) Hs[e] = 0.f;
  const T* x0p = static_cast<const T*>(a.x) + bi * a.x_sb + hi * a.x_sh;
  stage<T>(Xs, LDX, x0p, a.x_sl, 0, kSeqQ, Q, a.P, PT, a.vec_x);
  cp_async_commit();

  for (int z = 0; z < a.Z; ++z) {
    const int64_t l0 = int64_t(z) * Q;
    float* Xz = Xs + (z & 1) * kSeqQ * LDX;
    const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + hi * a.b_sh + l0 * a.b_sl;
    const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + hi * a.c_sh + l0 * a.c_sl;
    const float* ap = a.a + bi * a.a_sb + hi * a.a_sh + l0 * a.a_sl;
    const float* sp = a.scores + (a.shared_bc ? bi * a.Z + z : int64_t(bh) * a.Z + z) * Q * Q;
    T* yp = static_cast<T*>(a.y) + bi * a.y_sb + hi * a.y_sh + l0 * a.y_sl;
    const bool next = z + 1 < a.Z;
    if (next) {  // the next chunk's X lands while this one computes
      stage<T>(Xs + ((z + 1) & 1) * kSeqQ * LDX, LDX, x0p + (l0 + Q) * a.x_sl, a.x_sl, 0,
               kSeqQ, Q, a.P, PT, a.vec_x);
      cp_async_commit();
    }
    chunk_cumsum(acs, ap, a.a_sl, Q, kSeqQ);
    const float last = acs[Q - 1];
    for (int e = tid; e < kSeqQ; e += kThreads) dec[e] = e < Q ? fast_exp(last - acs[e]) : 0.f;
    if (next) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float acc[PW][4];
#pragma unroll
    for (int p = 0; p < PW; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
    if (live) {
      if (z > 0) {  // carry-in: acc = exp(acs_i) (C_i h)
        const T* c_lo = cp + int64_t(i_lo) * a.c_sl;
        const T* c_hi = c_lo + 8 * a.c_sl;
        // compile-time trip counts (kSeqQ / 8) let the loads of C be issued
        // ahead of the products
#pragma unroll
        for (int k = 0; k < kSeqQ; k += 8) {
          if (k >= NP) break;
          const int n0 = k + t4, n1 = k + t4 + 4;
          const float av[4] = {last_lo >= 0 && n0 < a.N ? to_f32<T>(c_lo[n0]) : 0.f,
                               last_hi >= 0 && n0 < a.N ? to_f32<T>(c_hi[n0]) : 0.f,
                               last_lo >= 0 && n1 < a.N ? to_f32<T>(c_lo[n1]) : 0.f,
                               last_hi >= 0 && n1 < a.N ? to_f32<T>(c_hi[n1]) : 0.f};
          const Split<4, EXACT> af(av);
#pragma unroll
          for (int p = 0; p < PW; ++p) {
            const float* h0 = Hs + n0 * LDX + p * 8 + g;
            const float bv[2] = {h0[0], h0[4 * LDX]};
            mma_f32(acc[p], af, Split<2, false>(bv));
          }
        }
        const float e0 = last_lo >= 0 ? fast_exp(acs[i_lo]) : 0.f;
        const float e1 = last_hi >= 0 ? fast_exp(acs[i_lo + 8]) : 0.f;
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          acc[p][0] *= e0;
          acc[p][1] *= e0;
          acc[p][2] *= e1;
          acc[p][3] *= e1;
        }
      }
      // intra-chunk: decayed, masked scores times X, keys up to the warp's last row
      const float a_lo = acs[max(last_lo, 0)], a_hi = acs[max(last_hi, 0)];
      const float* s_lo = sp + int64_t(max(last_lo, 0)) * Q;  // the rows' scores
      const float* s_hi = sp + int64_t(max(last_hi, 0)) * Q;
      const int k_end = min(warp * 16 + 16, Q);
#pragma unroll
      for (int k8 = 0; k8 < kSeqQ; k8 += 8) {
        if (k8 >= k_end) break;
        const int jj = k8 + 2 * t4;
        const float aj0 = acs[jj], aj1 = acs[jj + 1];
        const float av[4] = {jj <= last_lo ? s_lo[jj] * fast_exp(a_lo - aj0) : 0.f,
                             jj <= last_hi ? s_hi[jj] * fast_exp(a_hi - aj0) : 0.f,
                             jj < last_lo ? s_lo[jj + 1] * fast_exp(a_lo - aj1) : 0.f,
                             jj < last_hi ? s_hi[jj + 1] * fast_exp(a_hi - aj1) : 0.f};
        const Split<4, false> af(av);
        const float* x0 = Xz + jj * LDX + g;
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          const float bv[2] = {x0[p * 8], x0[p * 8 + LDX]};
          mma_f32(acc[p], af, Split<2, EXACT>(bv));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i_lo + 8 * r;
        if (i >= Q) continue;
        T* yrow = yp + int64_t(i) * a.y_sl;
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          const int col = p * 8 + 2 * t4;
          store_y<T>(yrow, col, a, acc[p][2 * r], acc[p][2 * r + 1]);
        }
      }
    }
    // the chunk's state s = B^T (dec X) for state rows i_lo, i_lo + 8
#pragma unroll
    for (int p = 0; p < PW; ++p) acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
    if (state_live) {
      const bool n_lo = i_lo < a.N, n_hi = i_lo + 8 < a.N;
#pragma unroll
      for (int k8 = 0; k8 < kSeqQ; k8 += 8) {
        if (k8 >= Q) break;
        // k-slot t <-> step 2 t, slot t + 4 <-> step 2 t + 1 (A = B^T)
        const int j = k8 + 2 * t4;
        const T* b0 = bp + int64_t(j) * a.b_sl + i_lo;
        const T* b1 = b0 + a.b_sl;
        const bool j0_in = j < Q, j1_in = j + 1 < Q;
        const float av[4] = {j0_in && n_lo ? to_f32<T>(b0[0]) : 0.f,
                             j0_in && n_hi ? to_f32<T>(b0[8]) : 0.f,
                             j1_in && n_lo ? to_f32<T>(b1[0]) : 0.f,
                             j1_in && n_hi ? to_f32<T>(b1[8]) : 0.f};
        const Split<4, EXACT> af(av);
        const float d0 = dec[j], d1 = dec[j + 1];
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          const float* x0 = Xz + j * LDX + p * 8 + g;
          const float bv[2] = {x0[0] * d0, x0[LDX] * d1};
          mma_f32(acc[p], af, Split<2, false>(bv));
        }
      }
    }
    __syncthreads();  // every warp's carry has read the old state
    if (state_live) {
      const float el = fast_exp(last);
#pragma unroll
      for (int p = 0; p < PW; ++p) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = i_lo + 8 * (e >> 1);
          if (n >= NP) continue;  // rows past the padded state hold nothing
          float* hp = Hs + n * LDX + p * 8 + 2 * t4 + (e & 1);
          *hp = fmaf(*hp, el, acc[p][e]);
        }
      }
    }
    __syncthreads();  // the new state is whole; the next chunk's copies may land
  }
  if (a.h_out != nullptr) {
    float* ho = a.h_out + int64_t(bh) * a.N * a.P;
    for (int e = tid; e < a.N * a.P; e += kThreads) ho[e] = Hs[(e / a.P) * LDX + e % a.P];
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory, once per
// device (`done` is the kernel's own flags): the attribute belongs to the
// current device's context, so a flag for the whole process would leave a
// second card's launches refused.
int opt_in_smem(const void* kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

template <typename T, int PT>
int launch_pt(const Args& a, int64_t BH, bool seq, cudaStream_t stream) {
  static bool scores_opted[kMaxDevices] = {}, state_opted[kMaxDevices] = {},
              out_opted[kMaxDevices] = {}, seq_opted[kMaxDevices] = {};
  const size_t smem_s = smem_scores_floats(a.NP) * sizeof(float);
  const size_t smem_a = smem_state_floats(a.NP, PT, a.Q) * sizeof(float);
  const size_t smem_c = smem_out_floats(a.NP, PT, a.Q) * sizeof(float);
  int rc = 0;
  if (smem_s > 48 * 1024 &&
      (rc = opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_scores<T>), scores_opted))) {
    return rc;
  }
  if (smem_a > 48 * 1024 &&
      (rc = opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_state<T, PT>), state_opted))) {
    return rc;
  }
  if (smem_c > 48 * 1024 &&
      (rc = opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_out<T, PT>), out_opted))) {
    return rc;
  }
  const unsigned BHZ = static_cast<unsigned>(BH * a.Z);
  const unsigned row_tiles = static_cast<unsigned>((a.Q + BR - 1) / BR);
  const unsigned G = a.shared_bc ? static_cast<unsigned>(BH / a.H * a.Z) : BHZ;
  ssd_chunk_scores<T><<<dim3(G, row_tiles, row_tiles), kThreads, smem_s, stream>>>(a);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  if (seq) {
    const size_t smem_q = smem_seq_floats(a.NP, PT) * sizeof(float);
    if (smem_q > 48 * 1024 &&
        (rc = opt_in_smem(reinterpret_cast<const void*>(ssd_scan_seq<T, PT>), seq_opted))) {
      return rc;
    }
    ssd_scan_seq<T, PT><<<static_cast<unsigned>(BH), kThreads, smem_q, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  ssd_chunk_state<T, PT><<<dim3(BHZ, (a.NP + BR - 1) / BR), kThreads, smem_a, stream>>>(a);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  const int64_t NPe = int64_t(a.N) * a.P;
  constexpr int per_block = kThreads * kPassItems;
  ssd_state_pass<<<dim3(static_cast<unsigned>(BH),
                        static_cast<unsigned>((NPe + per_block - 1) / per_block)),
                   kThreads, 0, stream>>>(a);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  ssd_chunk_out<T, PT><<<dim3(BHZ, row_tiles), kThreads, smem_c, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int64_t BH, bool seq, cudaStream_t s) {
  switch (p_tile(a.P)) {
    case 8: return launch_pt<T, 8>(a, BH, seq, s);
    case 16: return launch_pt<T, 16>(a, BH, seq, s);
    case 32: return launch_pt<T, 32>(a, BH, seq, s);
    case 64: return launch_pt<T, 64>(a, BH, seq, s);
    default: return launch_pt<T, 128>(a, BH, seq, s);
  }
}

// SMs of the current device, read once per device
int sm_count(int* sms) {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && count[dev] > 0) {
    *sms = count[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) count[dev] = *sms;
  return 0;
}

// f32 rows reached through (batch, head, step) strides start on 16 bytes
bool rows_aligned(const void* p, int64_t sb, int64_t sh, int64_t sl, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 &&
         sl % 4 == 0 && width % 4 == 0;
}

}  // namespace

extern "C" {

// Bytes of shared memory the largest of the three product kernels takes for
// state N, head P, chunk Q.
long long ssd_scan_smem_bytes(int N, int P, int Q) {
  const int NP = round_up(N, 8), PT = p_tile(P);
  int64_t f = smem_scores_floats(NP);
  if (smem_state_floats(NP, PT, Q) > f) f = smem_state_floats(NP, PT, Q);
  if (smem_out_floats(NP, PT, Q) > f) f = smem_out_floats(NP, PT, Q);
  return f * static_cast<long long>(sizeof(float));
}

// 1 if the kernels take state N, head P and chunk Q (P at most 128, the
// tiles and the chunk's cumsum within a block's shared memory), else 0.
int ssd_scan_fits(int N, int P, int Q) {
  return N > 0 && P > 0 && Q > 0 && P <= kMaxP && ssd_scan_smem_bytes(N, P, Q) <= kMaxSmem;
}

// x (B, H, L, P), a (B, H, L) float32, b and c (B, H, L, N), y (B, H, L, P),
// each given by its base pointer and element strides of batch, head and
// sequence (x, b, c and y with the last axis contiguous); x, b, c, y share
// dtype 0 = float32 or 1 = bfloat16. L % Q == 0; P <= 128. h_out: (B, H, N,
// P) float32 contiguous, or null. Scratch, float32 contiguous: states
// (B, H, L / Q, N, P), dlast (B, H, L / Q), scores (B, L / Q, Q, Q) when
// shared_bc (b and c the same for every head: H == 1 or head strides 0),
// else (B, H, L / Q, Q, Q). path: 0 chooses by size (ssd_scan_seq where it
// fits and B * H fills two blocks per SM, else the chunk-parallel kernels),
// 1 the chunk-parallel kernels, 2 ssd_scan_seq (Q and N at most 64).
int ssd_scan_launch(const void* x, const void* a, const void* b, const void* c, void* y,
                    void* h_out, void* states, void* dlast, void* scores, long long x_sb,
                    long long x_sh, long long x_sl, long long a_sb, long long a_sh,
                    long long a_sl, long long b_sb, long long b_sh, long long b_sl,
                    long long c_sb, long long c_sh, long long c_sl, long long y_sb,
                    long long y_sh, long long y_sl, int B, int H, int L, int P, int N, int Q,
                    int shared_bc, int dtype, int path, void* stream) {
  const int64_t BH = int64_t(B) * H;
  if (B <= 0 || H <= 0 || L <= 0 || !ssd_scan_fits(N, P, Q) || L % Q != 0 ||
      BH * (L / Q) > 0x7fffffff || (Q + BR - 1) / BR > 65535 ||
      (int64_t(N) * P + kThreads * kPassItems - 1) / (kThreads * kPassItems) > 65535 ||
      (shared_bc && H > 1 && (b_sh != 0 || c_sh != 0)) || path < 0 || path > 2 ||
      (path == 2 && !seq_fits(round_up(N, 8), Q))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool seq = path == 2;
  if (path == 0 && seq_fits(round_up(N, 8), Q)) {
    int sms = 0;
    if (int rc = sm_count(&sms)) return rc;
    seq = BH >= 2 * int64_t(sms);
  }
  const bool f32 = dtype == 0;
  Args args{x, static_cast<const float*>(a), b, c, y, static_cast<float*>(h_out),
            static_cast<float*>(states), static_cast<float*>(dlast),
            static_cast<float*>(scores),
            x_sb, x_sh, x_sl, a_sb, a_sh, a_sl, b_sb, b_sh, b_sl, c_sb, c_sh, c_sl,
            y_sb, y_sh, y_sl, H, L, P, N, Q, L / Q, round_up(N, 8), shared_bc != 0,
            f32 && rows_aligned(x, x_sb, x_sh, x_sl, P),
            f32 && rows_aligned(b, b_sb, b_sh, b_sl, N),
            f32 && rows_aligned(c, c_sb, c_sh, c_sl, N),
            rows_aligned(states, 0, 0, P, P), rows_aligned(scores, 0, 0, Q, Q),
            P % 2 == 0 && y_sb % 2 == 0 && y_sh % 2 == 0 && y_sl % 2 == 0 &&
                reinterpret_cast<uintptr_t>(y) % (f32 ? 8 : 4) == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(args, BH, seq, s);
    case 1: return launch<__nv_bfloat16>(args, BH, seq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
