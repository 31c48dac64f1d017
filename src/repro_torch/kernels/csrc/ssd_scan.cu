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
// inputs the scores (two bf16 inputs) are exact at the bf16 rate, and a
// product of an input with an f32 factor is exact in three bf16 passes, a
// third of that rate. Bytes: x, y once, b, c once per distinct (b, h) view,
// a once, the final state once.
//
// Two routes, chosen by the wrapper's size rule (ssd_scan.py::hopper_takes,
// path "auto"):
//
// The Hopper route (path 3), for Mamba2's widths N = P = 64 and chunks of
// 64, 128, 192 or 256 steps (zamba2-7b's scans): two kernels and a memset
// of their flags, warp-specialised as flash_attention.cu is (hopper.cuh
// holds the shared pieces). In each, warpgroup 2 is the producer: it gives back its
// registers (setmaxnreg 40) and one thread per consumer warpgroup keeps that
// warpgroup's two-stage ring of 64 x 64 tiles full with TMA loads (tensor
// maps: x as (P, L, H, B), b and c as (N, L, heads, B) with the head axis
// left out when they are one group, so Mamba2's stride-0 head views need no
// copy; 128-byte swizzle; bf16 tiles stay bf16). Warpgroups 0 and 1 are
// consumers (setmaxnreg 232) on wgmma with f32 accumulators:
//   (1) ssd_state_tma, a block per (chunk, batch, head group), taken in the
//       order of an atomic ticket, chunk-major: per head, the chunk's
//       cumsum (kept in scratch for (2), in log2 units, so that (2) takes
//       exp of a difference of cumsums as one ex2) and the state s_z^T = X^T
//       diag(dec) B with A = X^T dec from registers; then, a head behind
//       (under the next head's products), the pass over the chunks folded
//       in: once chunk z - 1's flags are set (it has a smaller ticket, so
//       it is running), h_z+1 = exp(acs[-1]) h_z + s_z goes to scratch as
//       h^T for chunk z + 1, or, for the last chunk, to h_out. Each thread
//       waits for and publishes its own 32 values of the state (a release
//       store of its flag after them), so a link takes no barrier and no
//       fence, and each is one (P, N) fma: the serial part grows as Z, not
//       Z^2.
//   (2) ssd_out_tma, a block per (64-row tile, batch, chunk, head group),
//       the row tiles with the most keys first: the tile's scores C B^T up
//       to its diagonal once for the group's heads (the warpgroups take
//       alternate key tiles), kept in shared memory in the accumulators'
//       order (never in device memory); then per head (warpgroup w takes
//       heads w, w + 2, ...) the carry-in C h_z scaled by exp(acs_i), and
//       the intra-chunk term with (S o L) built in registers from the
//       stored scores as the A operand of the product with X; y is written
//       from registers in x's dtype.
// f32: three TF32 passes (x = big + small, big = cvt.rna.tf32(x), small = x
// - big; a.b = a_s b_b + a_b b_s + a_b b_b), since TF32 wgmma takes K-major
// operands only: A operands split in registers (C's fragments, S o L, X^T
// dec); B and h^T tiles split in place, their small halves in scratch
// shared memory; X^T (transposed once a tile, 4 x 4 in registers, keys in
// the accumulators' order 0, 2, 4, 6, 1, 3, 5, 7) and the chunk's B^T (for
// (1)) split into scratch. bf16: C B^T in one pass (exact); an input times an f32 factor
// (X^T dec, S o L, C h_z) in three bf16 passes, the factor split into
// three bf16 parts hi + mid + lo (24 bits of its mantissa); X and B are
// read as loaded, MN-major, through the descriptor's transpose.
// A head group is head_group heads (the wrapper's head_group(chunk): 16 at
// chunks of 64, 4 above) when b and c are shared, else one head.
//
// The mma.sync route (paths 0-2), for every other shape: mma.sync m16n8k8
// TF32 with f32 accumulators:
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
// Three passes for f32 operands, as above; a bf16 input is exact in TF32,
// so a product of two inputs (C B^T) takes one pass and a product of an
// input with an f32 factor two. Each warp owns 16 rows; the decayed, masked
// scores are built in registers as the A operand of their product with X:
// accumulator columns 2t and 2t+1 go to k-slots t and t+4, and X's rows are
// read in that order. exp is the special-function unit's ex2 of x log2 e.
// f32 tiles are staged with cp.async (16 bytes a thread where rows are
// 16-byte aligned, else 4), key tiles double-buffered so that the next
// tile's copy runs under this tile's products; bf16 tiles are converted on
// the way in. N and P are padded with zeros in shared memory (N to a
// multiple of 8, P to 8, 16, 32, 64 or 128), the chunk to the key tile;
// shared rows are padded by 4 floats so that fragment loads hit distinct
// banks.
//
// Both routes read their inputs through strides (the last axis
// contiguous), so Mamba2's B and C, shared by every head, arrive as a
// stride-0 head view with no copy, and x and y as transposed (B, L, H, P)
// views. The scratch is the caller's (ssd_scan_scratch_bytes).
//
// C interface (no PyTorch headers; loaded with ctypes). The kernels run on
// the given stream, allocate nothing, and the launcher returns
// cudaGetLastError() (0 on success). The Hopper route's tensor maps are
// encoded on the host and remembered by pointer, shape and strides
// (hopper.cuh's cached_map), so a repeated call pays a lookup.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps of 16 rows
constexpr int BR = 64;          // rows of a block: chunk rows (c), state rows (a)
constexpr int BJ = 32;          // keys (chunk steps) per staged tile
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use (H100)
constexpr int kMaxP = 128;
constexpr int kSeqQ = 64;       // the longest chunk (and widest state) of ssd_scan_seq

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
inline int64_t round_up4(int64_t v) { return (v + 3) / 4 * 4; }

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
      big[i] = __float_as_uint(to_tf32(v[i]));
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

template <typename T, int PT>
int launch_pt(const Args& a, int64_t BH, bool seq, cudaStream_t stream) {
  static bool scores_opted[kMaxDevices] = {}, state_opted[kMaxDevices] = {},
              out_opted[kMaxDevices] = {}, seq_opted[kMaxDevices] = {};
  const size_t smem_s = smem_scores_floats(a.NP) * sizeof(float);
  const size_t smem_a = smem_state_floats(a.NP, PT, a.Q) * sizeof(float);
  const size_t smem_c = smem_out_floats(a.NP, PT, a.Q) * sizeof(float);
  int rc = 0;
  if (smem_s > 48 * 1024 &&
      (rc = opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_scores<T>), kMaxSmem,
                               scores_opted))) {
    return rc;
  }
  if (smem_a > 48 * 1024 &&
      (rc = opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_state<T, PT>), kMaxSmem,
                               state_opted))) {
    return rc;
  }
  if (smem_c > 48 * 1024 &&
      (rc = opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_out<T, PT>), kMaxSmem,
                               out_opted))) {
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
        (rc = opt_in_smem(reinterpret_cast<const void*>(ssd_scan_seq<T, PT>), kMaxSmem,
                               seq_opted))) {
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

// f32 rows reached through (batch, head, step) strides start on 16 bytes
bool rows_aligned(const void* p, int64_t sb, int64_t sh, int64_t sl, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 &&
         sl % 4 == 0 && width % 4 == 0;
}


// ------------------------------------------------------- the Hopper route

constexpr int kT = 64;             // chunk rows of a row tile, keys of a key tile; N = P = 64
constexpr int kHopThreads = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kStages = 2;         // stages of each consumer warpgroup's TMA ring
constexpr int kF32Tile = kT * kT * 4;   // bytes of a 64 x 64 f32 tile (and of a score tile)
constexpr int kChunkBytes = kT * 128;   // a 128-byte swizzle chunk of a 64-row tile

template <typename T> struct Hop {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int CW = 128 / sizeof(T);        // values of a 128-byte swizzle row
  static constexpr int NCH = kT / CW;               // swizzle chunks of a 64-wide row
  static constexpr int TILE = kT * kT * sizeof(T);  // a 64 x 64 input tile
  // the state kernel: B (bf16, as loaded) or B^T big and small (f32) for
  // the whole chunk, and the two rings; 1 KB of slack to align to the
  // swizzle's 1 KB
  static int state_smem(int Q) {
    return 1024 + (BF16 ? Q * 128 : 2 * Q * 256) + 2 * kStages * TILE;
  }
  // scratch of a consumer warpgroup of the output kernel: f32 X^T or h^T,
  // big and small; bf16 h^T as three bf16 parts
  static constexpr int SCRATCH = BF16 ? 3 * TILE : 2 * kF32Tile;
  // the output kernel: C, the row tile's scores (f32, one tile per key
  // tile of the chunk), the two rings (stages of an f32 tile: h^T comes
  // through them) and two scratches
  static int out_smem(int Q) {
    return 1024 + TILE + Q / kT * kF32Tile + 2 * kStages * kF32Tile + 2 * SCRATCH;
  }
};

struct HopArgs {
  const float* a;
  void* y;
  float* h_out;   // (B, H, N, P) contiguous, or null
  float* states;  // (B, H, Z, P, N): h_z^T, the state entering chunk z (z >= 1)
  float* acs;     // (B, H, L): the cumsum of a inside each chunk, times log2(e)
  int* flags;     // (B, H, Z, 128): thread t of chunk z wrote its h_{z+1}; then the ticket
  int64_t a_sb, a_sh, a_sl, y_sb, y_sh, y_sl;
  int B, H, Z, Q, G, n_groups;  // G heads a block; n_groups = ceil(H / G)
  bool shared_bc;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// rows [row, row + 64) of a 64-wide operand (its NCH swizzle chunks) by TMA
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row, int head, int batch) {
#pragma unroll
  for (int c = 0; c < Hop<T>::NCH; ++c) {
    tma_load(dst + c * kChunkBytes, map, bar, c * Hop<T>::CW, row, head, batch);
  }
}

// an f32 tile split in place: big = cvt.rna.tf32(x) where x was, small =
// x - big at the same offset of `small`; threads t, t + n, ...
__device__ __forceinline__ void split_tile(unsigned char* tile, unsigned char* small, int t,
                                           int n) {
  for (int i = t; i < kF32Tile / 16; i += n) {
    const float4 v = reinterpret_cast<const float4*>(tile)[i];
    const float4 big = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
    reinterpret_cast<float4*>(tile)[i] = big;
    reinterpret_cast<float4*>(small)[i] = make_float4(v.x - big.x, v.y - big.y, v.z - big.z,
                                                      v.w - big.w);
  }
}

// The transpose of a 64 x 64 f32 tile as loaded ([key][col], two swizzle
// chunks of 32 columns), split: row col of `big` and `small` holds the
// tile's keys, at key0 + (key), each group of 8 in the order 0, 2, 4, 6, 1,
// 3, 5, 7 (k-slot t of an 8-step <-> key 2 t, slot t + 4 <-> key 2 t + 1),
// in swizzle chunks of 32 keys 8 KB apart: a K-major wgmma operand over the
// keys. A thread takes a 4 x 4 block (4 keys of one half of a group by 4
// columns), transposes it in registers and stores 4 rows of 4 slots;
// rotating each lane's rows by (unit / 2) % 4 keeps loads and stores free
// of bank conflicts (flash_attention.cu's V^T). Threads t of `threads`.
__device__ __forceinline__ void transpose_split(unsigned char* __restrict__ big,
                                                unsigned char* __restrict__ small,
                                                const unsigned char* __restrict__ src, int key0,
                                                int t, int threads = 128) {
  constexpr int kMaxPer = 2;  // blocks a thread takes (128 threads)
  float4 r[kMaxPer][4];       // keys grp * 8 + half + 2 i, columns d0 .. d0 + 3
  const int per = 256 / threads;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {  // every load first
    if (k >= per) break;
    const int blk = t + k * threads;
    const int u = blk & 7, half = (blk >> 3) & 1, grp = (blk >> 4) & 7, c = blk >> 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[k][i] = *reinterpret_cast<const float4*>(src + c * kChunkBytes +
                                                 swz<4>(grp * 8 + half + 2 * i, 4 * u));
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    if (k >= per) break;
    const int blk = t + k * threads;
    const int u = blk & 7, half = (blk >> 3) & 1, grp = (blk >> 4) & 7, c = blk >> 7;
    const int d0 = c * 32 + 4 * u;
    // rotate each float4 by rot = (u / 2) % 4 lanes, so that store e holds row d0 + (e + rot) % 4
    const int rot = (u >> 1) & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v = r[k][i];
      if (rot & 1) v = make_float4(v.y, v.z, v.w, v.x);
      if (rot & 2) v = make_float4(v.z, v.w, v.x, v.y);
      r[k][i] = v;
    }
    const int slot = key0 + grp * 8 + 4 * half;  // the first of the block's 4 slots
    const uint32_t base = (slot / 32) * kChunkBytes;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x[4] = {e == 0 ? r[k][0].x : e == 1 ? r[k][0].y : e == 2 ? r[k][0].z : r[k][0].w,
                          e == 0 ? r[k][1].x : e == 1 ? r[k][1].y : e == 2 ? r[k][1].z : r[k][1].w,
                          e == 0 ? r[k][2].x : e == 1 ? r[k][2].y : e == 2 ? r[k][2].z : r[k][2].w,
                          e == 0 ? r[k][3].x : e == 1 ? r[k][3].y : e == 2 ? r[k][3].z : r[k][3].w};
      const uint32_t off = base + swz<4>(d0 + ((e + rot) & 3), slot % 32);
      const float4 b4 = make_float4(to_tf32(x[0]), to_tf32(x[1]), to_tf32(x[2]), to_tf32(x[3]));
      *reinterpret_cast<float4*>(big + off) = b4;
      *reinterpret_cast<float4*>(small + off) =
          make_float4(x[0] - b4.x, x[1] - b4.y, x[2] - b4.z, x[3] - b4.w);
    }
  }
}

// Half h (keys 32 h .. 32 h + 31) of transpose_split's output for one
// 64 x 64 tile: its 32 keys in one swizzle chunk (8 KB) of `big` and
// `small`, the same order, blocks and rotation; 128 threads, one block each.
__device__ __forceinline__ void transpose_half(unsigned char* __restrict__ big,
                                               unsigned char* __restrict__ small,
                                               const unsigned char* __restrict__ src, int h,
                                               int t) {
  const int u = t & 7, half = (t >> 3) & 1, grp = 4 * h + ((t >> 4) & 3), c = t >> 6;
  const int d0 = c * 32 + 4 * u, rot = (u >> 1) & 3;
  float4 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = *reinterpret_cast<const float4*>(src + c * kChunkBytes +
                                                swz<4>(grp * 8 + half + 2 * i, 4 * u));
    if (rot & 1) v = make_float4(v.y, v.z, v.w, v.x);
    if (rot & 2) v = make_float4(v.z, v.w, v.x, v.y);
    r[i] = v;
  }
  const int slot = (grp - 4 * h) * 8 + 4 * half;  // the first of the block's 4 slots
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x[4] = {e == 0 ? r[0].x : e == 1 ? r[0].y : e == 2 ? r[0].z : r[0].w,
                        e == 0 ? r[1].x : e == 1 ? r[1].y : e == 2 ? r[1].z : r[1].w,
                        e == 0 ? r[2].x : e == 1 ? r[2].y : e == 2 ? r[2].z : r[2].w,
                        e == 0 ? r[3].x : e == 1 ? r[3].y : e == 2 ? r[3].z : r[3].w};
    const uint32_t off = swz<4>(d0 + ((e + rot) & 3), slot);
    const float4 b4 = make_float4(to_tf32(x[0]), to_tf32(x[1]), to_tf32(x[2]), to_tf32(x[3]));
    *reinterpret_cast<float4*>(big + off) = b4;
    *reinterpret_cast<float4*>(small + off) =
        make_float4(x[0] - b4.x, x[1] - b4.y, x[2] - b4.z, x[3] - b4.w);
  }
}

// An f32 value v as three bf16 parts hi + mid + lo (each the bf16 rounding
// of what the parts before it leave): 24 bits of v's mantissa, so that a
// product of the parts with a bf16 input, summed in f32, keeps f32 accuracy.
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the pairs (v0, v1) of four A-fragment registers as three bf16 parts,
// two values a conversion
__device__ __forceinline__ void split3(const float (&v)[8], uint32_t (&hi)[4], uint32_t (&mid)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * r], v[2 * r + 1]);
    const float2 hf = __bfloat1622float2(h2);
    const float r0 = v[2 * r] - hf.x, r1 = v[2 * r + 1] - hf.y;
    const __nv_bfloat162 m2 = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(m2);
    hi[r] = bits(h2);
    mid[r] = bits(m2);
    lo[r] = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
  }
}

// 2^x on the special-function unit
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float ld_f32(const unsigned char* p);
template <> __device__ __forceinline__ float ld_f32<float>(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}
template <> __device__ __forceinline__ float ld_f32<__nv_bfloat16>(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
// byte offset of element (row, col) of a 64 x 64 tile as TMA loads it
template <typename T> __device__ __forceinline__ uint32_t tile_off(int row, int col) {
  constexpr int CW = Hop<T>::CW;
  return (col / CW) * kChunkBytes + swz<sizeof(T)>(row, col % CW);
}

// (1) The chunk states and the pass over the chunks. A block takes the
// work item of its ticket: (chunk z, batch b, head group), chunk-major, so
// that the item whose state it waits for has a smaller ticket and is
// running. Per head (warpgroup w takes heads w, w + 2, ... of the group):
// the chunk's cumsum of a (to `acs` for the output kernel), then
//   s^T = X^T diag(exp(acs[-1] - acs)) B   (P x N, over the chunk's keys)
// on wgmma with A = X^T dec from registers (the next key tile's A is
// built while this one's product runs), then, a head behind (under the
// next head's products), h_{z+1} = exp(acs[-1]) h_z + s once chunk z - 1
// has written h_z (the flag of each thread's own values), written for
// chunk z + 1 as h^T (to `states`, then the thread's flag, a release
// store) or, for the last chunk, to h_out.
// f32: B^T split big and small for the whole chunk once (shared by the
// group's heads); three TF32 passes. bf16: B as loaded (MN-major operand);
// A in three bf16 parts.


// A fragments of one 64-key tile of a product: big and small TF32 halves
// of k8 steps (f32), or three bf16 parts of k16 steps (bf16)
template <typename T> struct AFrag;
template <> struct AFrag<float> { uint32_t big[8][4], small[8][4]; };
template <> struct AFrag<__nv_bfloat16> { uint32_t hi[4][4], mid[4][4], lo[4][4]; };

template <typename T>
__device__ __forceinline__ void fence_a(AFrag<T>& A) {
  if constexpr (sizeof(T) == 4) {
    fence_regs(A.big);
    fence_regs(A.small);
  } else {
    fence_regs(A.hi);
    fence_regs(A.mid);
    fence_regs(A.lo);
  }
}

// A = X^T dec of key tile X (rows p_lo, p_lo + 8 of the product). f32: k8
// steps, k-slot t4 <-> key 2 t4, t4 + 4 <-> 2 t4 + 1 (B^T's order); bf16:
// k16 steps, registers (row, keys 2 t4, + 1), (row + 8, ...), then keys + 8.
template <typename T>
__device__ __forceinline__ void state_a(AFrag<T>& A, const unsigned char* X, const float* dec,
                                        int p_lo, int t4) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int j = kk * 8 + 2 * t4;
      const float d0 = dec[j], d1 = dec[j + 1];
      const float v[4] = {ld_f32<T>(X + tile_off<T>(j, p_lo)) * d0,
                          ld_f32<T>(X + tile_off<T>(j, p_lo + 8)) * d0,
                          ld_f32<T>(X + tile_off<T>(j + 1, p_lo)) * d1,
                          ld_f32<T>(X + tile_off<T>(j + 1, p_lo + 8)) * d1};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float big = to_tf32(v[r]);
        A.big[kk][r] = __float_as_uint(big);
        A.small[kk][r] = __float_as_uint(v[r] - big);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = kk * 16 + 2 * t4;
      float v[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jj = j + (r >> 1) * 8, p = p_lo + (r & 1) * 8;
        v[2 * r] = ld_f32<T>(X + tile_off<T>(jj, p)) * dec[jj];
        v[2 * r + 1] = ld_f32<T>(X + tile_off<T>(jj + 1, p)) * dec[jj + 1];
      }
      split3(v, A.hi[kk], A.mid[kk], A.lo[kk]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kHopThreads, 1)
    ssd_state_tma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                  const HopArgs a) {
  using K = Hop<T>;
  constexpr bool BF16 = K::BF16;
  __shared__ __align__(8) uint64_t bars[4 * kStages + 1];  // full[w][s], empty[w][s], B (bf16)
  // per warpgroup, double-buffered by head: the decays, the warps' sums
  __shared__ float dec_s[2][2][256], wsum[2][2][4];
  __shared__ int item_s;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sB = (raw + 1023u) & ~1023u;
  unsigned char* gB = smem_raw + (sB - raw);
  const int Q = a.Q, nkt = Q / kT;
  const uint32_t b_bytes = BF16 ? Q * 128 : Q * 256;  // B (bf16), or B^T big then small (f32)
  const uint32_t sRing = sB + (BF16 ? b_bytes : 2 * b_bytes);
  auto full = [&](int w, int s) { return smem_addr(&bars[w * kStages + s]); };
  auto empty = [&](int w, int s) { return smem_addr(&bars[(2 + w) * kStages + s]); };
  const uint32_t bbar = smem_addr(&bars[4 * kStages]);

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 128);
      }
    }
    mbar_init(bbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    item_s = atomicAdd(a.flags + int64_t(a.B) * a.H * a.Z * 128, 1);
  }
  __syncthreads();
  const int item = item_s, per_z = a.B * a.n_groups;
  const int z = item / per_z, b = item % per_z / a.n_groups, gi = item % a.n_groups;
  const int h0 = gi * a.G, h1 = min(h0 + a.G, a.H), hb = a.shared_bc ? 0 : h0;
  const int l0 = z * Q;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // producer: warp w keeps ring w full (lane 0)
    setmaxnreg_dec<40>();
    const int w = (threadIdx.x - 256) / 32;
    if (w < 2 && (threadIdx.x & 31) == 0) {
      int n = 0;
      auto push = [&](const CUtensorMap* map, int row, int head) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(empty(w, s), ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full(w, s), K::TILE);
        load_tile<T>(sRing + (w * kStages + s) * K::TILE, map, full(w, s), row, head, b);
        ++n;
      };
      if constexpr (BF16) {
        if (w == 0) {
          mbar_expect_tx(bbar, Q * 128);
          for (int kt = 0; kt < nkt; ++kt) {
            load_tile<T>(sB + kt * K::TILE, &tb, bbar, l0 + kt * kT, hb, b);
          }
        }
      } else {
        for (int kt = w; kt < nkt; kt += 2) push(&tb, l0 + kt * kT, hb);
      }
      for (int h = h0 + w; h < h1; h += 2) {
        for (int kt = 0; kt < nkt; ++kt) push(&tx, l0 + kt * kT, h);
      }
    }
    return;
  }
  setmaxnreg_inc<232>();
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const int p_lo = warp * 16 + g;  // this thread's rows of s^T: p_lo, p_lo + 8
  int n = 0;                       // this warpgroup's place in its ring
  auto wait_full = [&]() {
    const int s = n % kStages;
    mbar_wait(full(wg, s), (n / kStages) & 1);
    return smem_raw + (sRing + (wg * kStages + s) * K::TILE - raw);
  };
  auto release = [&]() {
    mbar_arrive(empty(wg, n % kStages));
    ++n;
  };
  // this thread's two steps of the chunk's a, loaded a head ahead
  const int i0 = 2 * t;
  auto load_a = [&](int h, float& v0, float& v1) {
    const float* ap = a.a + b * a.a_sb + h * a.a_sh + int64_t(l0) * a.a_sl;
    v0 = h < h1 && i0 < Q ? ap[i0 * a.a_sl] : 0.f;
    v1 = h < h1 && i0 + 1 < Q ? ap[(i0 + 1) * a.a_sl] : 0.f;
  };
  float v0, v1;
  load_a(h0 + wg, v0, v1);
  if constexpr (BF16) {
    mbar_wait(bbar, 0);
  } else {
    for (int kt = wg; kt < nkt; kt += 2) {  // B^T of the whole chunk, split once
      transpose_split(gB, gB + b_bytes, wait_full(), kt * kT, t);
      release();
    }
    fence_proxy_async();
    named_barrier(1, 256);
  }

  // the pass over the chunks for head h's s (in v, acc's layout: v[4 j +
  // e] at row p_lo + 8 (e / 2), column 8 j + 2 t4 + e % 2), done a head
  // behind the products so that the wait for chunk z - 1 runs under them:
  // h_{z+1} = el h_z + s, el = exp(acs[-1])
  auto pass = [&](float (&v)[32], int h, float el) {
    const int64_t bh = int64_t(b) * a.H + h;
    float* st = a.states + bh * a.Z * (kT * kT);
    // each thread waits for, and publishes, its own 32 values: the flag of
    // (b h, z, thread t) follows chunk z's stores of them
    int* flag = a.flags + (bh * a.Z + z) * 128 + t;
    if (z > 0) {
      while (ld_acquire(flag - 128) == 0) __nanosleep(20);
      const float* hz = st + int64_t(z) * kT * kT;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 u = __ldcg(reinterpret_cast<const float2*>(
              hz + (p_lo + 8 * r) * kT + 8 * j + 2 * t4));
          v[4 * j + 2 * r] = fmaf(el, u.x, v[4 * j + 2 * r]);
          v[4 * j + 2 * r + 1] = fmaf(el, u.y, v[4 * j + 2 * r + 1]);
        }
      }
    }
    if (z + 1 < a.Z) {
      float* hn = st + int64_t(z + 1) * kT * kT;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          __stcg(reinterpret_cast<float2*>(hn + (p_lo + 8 * r) * kT + 8 * j + 2 * t4),
                 make_float2(v[4 * j + 2 * r], v[4 * j + 2 * r + 1]));
        }
      }
      st_release(flag, 1);
    } else if (a.h_out != nullptr) {
      float* ho = a.h_out + bh * kT * kT;  // (N, P)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ho[(8 * j + 2 * t4 + (e & 1)) * kT + p_lo + 8 * (e >> 1)] = v[4 * j + e];
        }
      }
    }
  };

  float prev[32], prev_el = 0.f;  // the last head's s, for its pass
  for (int h = h0 + wg, hp = 0; h < h1; h += 2, hp ^= 1) {
    const int64_t bh = int64_t(b) * a.H + h;
    // the chunk's inclusive cumsum of a: two steps a thread, a shuffle scan
    // in each warp, then the warps' totals (their sum is acs[-1])
    float inc = v0 + v1;
    const float u1 = v1;
    load_a(h + 2, v0, v1);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += u;
    }
    if (lane == 31) wsum[wg][hp][warp] = inc;
    named_barrier(2 + wg, 128);
    float base = 0.f, last = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < warp) base += wsum[wg][hp][k];
      last += wsum[wg][hp][k];
    }
    const float c1 = base + inc, c0 = c1 - u1;  // acs at i0 and i0 + 1
    float* dec = dec_s[wg][hp];
    if (i0 < Q) {
      float* ag = a.acs + bh * a.Z * Q + l0 + i0;  // in log2 units, for the output kernel
      ag[0] = c0 * kLog2e;
      ag[1] = c1 * kLog2e;
      dec[i0] = fast_exp(last - c0);
      dec[i0 + 1] = fast_exp(last - c1);
    }
    named_barrier(2 + wg, 128);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    AFrag<T> A, An;
    state_a<T>(A, wait_full(), dec, p_lo, t4);
    release();
    for (int kt = 0; kt < nkt; ++kt) {
      wgmma_fence();
      if constexpr (BF16) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = desc_mnmajor(sB + (kt * 4 + kk) * 16 * 128, Q * 128);
          wgmma_rs_bf16<64>(acc, A.lo[kk], d, 1);
          wgmma_rs_bf16<64>(acc, A.mid[kk], d, 1);
          wgmma_rs_bf16<64>(acc, A.hi[kk], d, 1);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int kq = kt * 8 + kk;
          const uint32_t off = (kq / 4) * kChunkBytes + (kq % 4) * 32;
          wgmma_rs_tf32<64>(acc, A.small[kk], desc_kmajor(sB + off), 1);
          wgmma_rs_tf32<64>(acc, A.big[kk], desc_kmajor(sB + b_bytes + off), 1);
          wgmma_rs_tf32<64>(acc, A.big[kk], desc_kmajor(sB + off), 1);
        }
      }
      wgmma_commit();
      if (kt + 1 < nkt) {  // the next tile's A while the products run
        state_a<T>(An, wait_full(), dec + (kt + 1) * kT, p_lo, t4);
        release();
      } else if (h > h0 + wg) {  // the last head's pass while this head's products run
        pass(prev, h - 2, prev_el);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_a<T>(A);
      if (kt + 1 < nkt) A = An;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) prev[i] = acc[i];
    prev_el = fast_exp(last);
  }
  if (h0 + wg < h1) pass(prev, h0 + wg + 2 * ((h1 - 1 - h0 - wg) / 2), prev_el);
}

// (2) The outputs. A block per (row tile of 64 chunk rows, b, z, head
// group), the row tiles with the most keys first. The scores of the row
// tile, S = C B^T over the key tiles up to its diagonal, are computed once
// for the group's heads (the two warpgroups take alternate key tiles) and
// kept in shared memory in the accumulators' order; then warpgroup w takes
// heads w, w + 2, ...: y = exp(acs_i) (C h_z) + ((S o L) X), L_ij =
// exp(acs_i - acs_j) for j <= i and exactly 0 above the diagonal, built in
// registers from the stored scores as the A operand of the product with X
// (the next key tile's while this one's product runs). Every operand comes
// ahead of its use: B, X and h_z^T (the state kernel's output) by TMA
// through the warpgroup's ring, each head's cumsum by cp.async one head
// ahead. f32: C's fragments split big and small in registers, B and h^T
// split in place (small into the warpgroup's scratch), X^T transposed and
// split in halves of 32 keys (keys in the accumulators' order) into the
// scratch's two buffers, each half's products running while the next half
// is transposed and its A built; three TF32 passes. bf16: C B^T in one
// pass; h^T in three bf16 parts; X as loaded (MN-major); S o L in three
// bf16 parts.

// C's A fragments for a k8 step ks (rows row, row + 8; columns 8 ks + t4,
// + 4), split big and small
__device__ __forceinline__ void c_frags(AFrag<float>& A, const unsigned char* C, int row, int t4) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int n0 = ks * 8 + t4;
    const float v[4] = {ld_f32<float>(C + tile_off<float>(row, n0)),
                        ld_f32<float>(C + tile_off<float>(row + 8, n0)),
                        ld_f32<float>(C + tile_off<float>(row, n0 + 4)),
                        ld_f32<float>(C + tile_off<float>(row + 8, n0 + 4))};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float big = to_tf32(v[r]);
      A.big[ks][r] = __float_as_uint(big);
      A.small[ks][r] = __float_as_uint(v[r] - big);
    }
  }
}

// (S o L) of key tile k0 for rows i_lo, i_lo + 8 as the A fragments of
// their product with X: s4 is this thread's slot of the score tile (8-column
// group j at s4[32 j]), acs the chunk's cumsum in log2 units, a_lo and a_hi
// its rows' values; only the diagonal tile (`diag`) has keys past a row,
// masked to exactly 0. bf16: the accumulator order is the k16 A
// fragment's; each value in three bf16 parts.
__device__ __forceinline__ void out_a(AFrag<__nv_bfloat16>& A, const float4* s4,
                                      const float* acs, int k0, bool diag, int i_lo, float a_lo,
                                      float a_hi, int t4) {
  float v[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 f = s4[32 * j];
    const int j0 = k0 + 8 * j + 2 * t4;
    const float2 aj = *reinterpret_cast<const float2*>(acs + j0);
    v[4 * j] = f.x * fast_exp2(a_lo - aj.x);
    v[4 * j + 1] = f.y * fast_exp2(a_lo - aj.y);
    v[4 * j + 2] = f.z * fast_exp2(a_hi - aj.x);
    v[4 * j + 3] = f.w * fast_exp2(a_hi - aj.y);
    if (diag) {
      v[4 * j] = j0 <= i_lo ? v[4 * j] : 0.f;
      v[4 * j + 1] = j0 + 1 <= i_lo ? v[4 * j + 1] : 0.f;
      v[4 * j + 2] = j0 <= i_lo + 8 ? v[4 * j + 2] : 0.f;
      v[4 * j + 3] = j0 + 1 <= i_lo + 8 ? v[4 * j + 3] : 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float w8[8] = {v[8 * kk], v[8 * kk + 1], v[8 * kk + 2], v[8 * kk + 3],
                         v[8 * kk + 4], v[8 * kk + 5], v[8 * kk + 6], v[8 * kk + 7]};
    split3(w8, A.hi[kk], A.mid[kk], A.lo[kk]);
  }
}

// The f32 counterpart for keys k0 + 32 i .. + 31 alone (k8 steps 4 i .. 4 i
// + 3): step j takes the accumulator columns 2 t4, 2 t4 + 1 of group j as
// k-slots t4, t4 + 4 (X^T's key order), each value split big and small.
__device__ __forceinline__ void out_a_half(AFrag<float>& A, const float4* s4, const float* acs,
                                           int k0, bool diag, int i, int i_lo, float a_lo,
                                           float a_hi, int t4) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = 4 * i + jj;
    const float4 f = s4[32 * j];
    const int j0 = k0 + 8 * j + 2 * t4;
    const float2 aj = *reinterpret_cast<const float2*>(acs + j0);
    float x[4] = {f.x * fast_exp2(a_lo - aj.x), f.z * fast_exp2(a_hi - aj.x),
                  f.y * fast_exp2(a_lo - aj.y), f.w * fast_exp2(a_hi - aj.y)};
    if (diag) {
      x[0] = j0 <= i_lo ? x[0] : 0.f;
      x[1] = j0 <= i_lo + 8 ? x[1] : 0.f;
      x[2] = j0 + 1 <= i_lo ? x[2] : 0.f;
      x[3] = j0 + 1 <= i_lo + 8 ? x[3] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float big = to_tf32(x[r]);
      A.big[j][r] = __float_as_uint(big);
      A.small[j][r] = __float_as_uint(x[r] - big);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kHopThreads, 1)
    ssd_out_tma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap th,
                const HopArgs a) {
  using K = Hop<T>;
  constexpr bool BF16 = K::BF16;
  __shared__ __align__(8) uint64_t bars[4 * kStages + 1];  // full[w][s], empty[w][s], C
  __shared__ __align__(16) float acs_s[2][2][256];  // per warpgroup, double-buffered by head
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sC = (raw + 1023u) & ~1023u;
  const int Q = a.Q, nkt = Q / kT;
  const uint32_t sS = sC + K::TILE;
  const uint32_t sRing = sS + nkt * kF32Tile;
  const uint32_t sScr = sRing + 2 * kStages * kF32Tile;
  auto gen = [&](uint32_t s) { return smem_raw + (s - raw); };
  auto full = [&](int w, int s) { return smem_addr(&bars[w * kStages + s]); };
  auto empty = [&](int w, int s) { return smem_addr(&bars[(2 + w) * kStages + s]); };
  const uint32_t cbar = smem_addr(&bars[4 * kStages]);

  const int per_rt = a.B * a.Z * a.n_groups;
  const int rt = nkt - 1 - int(blockIdx.x) / per_rt, rest = int(blockIdx.x) % per_rt;
  const int gi = rest % a.n_groups, z = rest / a.n_groups % a.Z, b = rest / (a.n_groups * a.Z);
  const int h0 = gi * a.G, h1 = min(h0 + a.G, a.H), hb = a.shared_bc ? 0 : h0;
  const int l0 = z * Q, r0 = rt * kT;

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 128);
      }
    }
    mbar_init(cbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // producer: warp w keeps ring w full: its key tiles of B, then for each
    // of its heads h_z^T (chunks after the first) and the X tiles
    setmaxnreg_dec<40>();
    const int w = (threadIdx.x - 256) / 32;
    if (w < 2 && (threadIdx.x & 31) == 0) {
      int n = 0;
      auto stage = [&](uint32_t bytes) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(empty(w, s), ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full(w, s), bytes);
        ++n;
        return s;
      };
      auto ring = [&](int s) { return sRing + (w * kStages + s) * kF32Tile; };
      if (w == 0) {
        mbar_expect_tx(cbar, K::TILE);
        load_tile<T>(sC, &tc, cbar, l0 + r0, hb, b);
      }
      for (int kt = w; kt <= rt; kt += 2) {
        const int s = stage(K::TILE);
        load_tile<T>(ring(s), &tb, full(w, s), l0 + kt * kT, hb, b);
      }
      for (int h = h0 + w; h < h1; h += 2) {
        if (z > 0) {
          const int s = stage(kF32Tile);
          load_tile<float>(ring(s), &th, full(w, s), 0, z, b * a.H + h);
        }
        for (int kt = 0; kt <= rt; ++kt) {
          const int s = stage(K::TILE);
          load_tile<T>(ring(s), &tx, full(w, s), l0 + kt * kT, h, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t scr = sScr + wg * K::SCRATCH;
  const int i_lo = r0 + warp * 16 + g;  // this thread's chunk rows: i_lo, i_lo + 8
  int n = 0;                            // this warpgroup's place in its ring
  auto wait_full = [&]() {
    const int s = n % kStages;
    mbar_wait(full(wg, s), (n / kStages) & 1);
    return sRing + (wg * kStages + s) * kF32Tile;
  };
  auto release = [&]() {
    mbar_arrive(empty(wg, n % kStages));
    ++n;
  };
  // this thread's slot of score tile kt (8-column group j at + 32 j)
  auto s_slot = [&](int kt) {
    return reinterpret_cast<float4*>(gen(sS + kt * kF32Tile)) + warp * 8 * 32 + lane;
  };
  // K-major operand offset of k-step ks of a 64-row tile (8 f32 or 16 bf16 a step)
  auto kstep = [](int ks) { return uint32_t((ks / 4) * kChunkBytes + (ks % 4) * 32); };
  // the chunk's cumsum for head h into buffer `buf`, by cp.async
  auto fetch_acs = [&](int h, int buf) {
    if (t < Q / 4) {
      cp_async16(acs_s[wg][buf] + 4 * t,
                 a.acs + (int64_t(b) * a.H + h) * a.Z * Q + l0 + 4 * t, true);
    }
    cp_async_commit();
  };
  if (h0 + wg < h1) fetch_acs(h0 + wg, 0);

  mbar_wait(cbar, 0);
  for (int kt = wg; kt <= rt; kt += 2) {  // the scores, key tile kt
    const uint32_t st = wait_full();
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    if constexpr (BF16) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_ss_bf16<64>(s, desc_kmajor(sC + ks * 32), desc_kmajor(st + ks * 32), 1);
      }
    } else {
      named_barrier(2 + wg, 128);  // the last product that read the scratch is done
      split_tile(gen(st), gen(scr), t, 128);  // B big in place, small in the scratch
      fence_proxy_async();
      AFrag<float> cf;
      c_frags(cf, gen(sC), warp * 16 + g, t4);
      named_barrier(2 + wg, 128);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        wgmma_rs_tf32<64>(s, cf.small[ks], desc_kmajor(st + kstep(ks)), 1);
        wgmma_rs_tf32<64>(s, cf.big[ks], desc_kmajor(scr + kstep(ks)), 1);
        wgmma_rs_tf32<64>(s, cf.big[ks], desc_kmajor(st + kstep(ks)), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release();
    float4* slot = s_slot(kt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      slot[32 * j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
    }
  }
  named_barrier(1, 256);  // every score tile is stored

  for (int h = h0 + wg, hp = 0; h < h1; h += 2, hp ^= 1) {
    named_barrier(2 + wg, 128);  // the last head is done with the scratch and the other buffer
    if (h + 2 < h1) {
      fetch_acs(h + 2, hp ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    named_barrier(2 + wg, 128);  // this head's cumsum has landed for every thread
    const float* acs = acs_s[wg][hp];
    const float a_lo = acs[i_lo], a_hi = acs[i_lo + 8];
    float y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = 0.f;
    if (z > 0) {
      // carry-in: y = exp(acs_i) (C h_z), h_z^T as the K-major operand (rows
      // p, columns n) as TMA loaded it
      const uint32_t st = wait_full();
      if constexpr (BF16) {
        unsigned char* hs = gen(st);
        unsigned char* sc = gen(scr);
        for (int e = t; e < kT * kT / 8; e += 128) {
          const int p = e >> 3, n8 = (e & 7) * 8;
          const float4 u0 = *reinterpret_cast<const float4*>(hs + tile_off<float>(p, n8));
          const float4 u1 = *reinterpret_cast<const float4*>(hs + tile_off<float>(p, n8 + 4));
          const float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
          uint32_t hi[4], mid[4], lo[4];
          split3(v, hi, mid, lo);
          uint4* dst = reinterpret_cast<uint4*>(sc + swz<2>(p, n8));
          dst[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          dst[K::TILE / 16] = make_uint4(mid[0], mid[1], mid[2], mid[3]);
          dst[2 * K::TILE / 16] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        fence_proxy_async();
        named_barrier(2 + wg, 128);
        release();
        wgmma_fence();
#pragma unroll
        for (int part = 2; part >= 0; --part) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_ss_bf16<64>(y, desc_kmajor(sC + ks * 32),
                              desc_kmajor(scr + part * K::TILE + ks * 32), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(y);
      } else {
        split_tile(gen(st), gen(scr), t, 128);  // h big in place, small in the scratch
        fence_proxy_async();
        AFrag<float> cf;
        c_frags(cf, gen(sC), warp * 16 + g, t4);
        named_barrier(2 + wg, 128);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          wgmma_rs_tf32<64>(y, cf.small[ks], desc_kmajor(st + kstep(ks)), 1);
          wgmma_rs_tf32<64>(y, cf.big[ks], desc_kmajor(scr + kstep(ks)), 1);
          wgmma_rs_tf32<64>(y, cf.big[ks], desc_kmajor(st + kstep(ks)), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(y);
        fence_a<float>(cf);
        release();
      }
      const float e_lo = fast_exp2(a_lo), e_hi = fast_exp2(a_hi);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[4 * j] *= e_lo;
        y[4 * j + 1] *= e_lo;
        y[4 * j + 2] *= e_hi;
        y[4 * j + 3] *= e_hi;
      }
    }
    // the intra-chunk term over key tiles 0..rt
    if constexpr (BF16) {
      AFrag<T> A, An;
      out_a(A, s_slot(0), acs, 0, rt == 0, i_lo, a_lo, a_hi, t4);
      for (int kt = 0; kt <= rt; ++kt) {
        const uint32_t st = wait_full();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = desc_mnmajor(st + kk * 16 * 128, kChunkBytes);
          wgmma_rs_bf16<64>(y, A.lo[kk], d, 1);
          wgmma_rs_bf16<64>(y, A.mid[kk], d, 1);
          wgmma_rs_bf16<64>(y, A.hi[kk], d, 1);
        }
        wgmma_commit();
        if (kt < rt) {  // the next tile's A while the products run
          out_a(An, s_slot(kt + 1), acs, (kt + 1) * kT, kt + 1 == rt, i_lo, a_lo, a_hi,
                   t4);
        }
        wgmma_wait<0>();
        fence_regs(y);
        fence_a<T>(A);
        release();
        if (kt < rt) A = An;
      }
    } else {
      // X^T in halves of 32 keys, double-buffered in the scratch (buffer i
      // at scr + i 16 KB: big, then small 8 KB on): each half's products run
      // while the other half of A is built and the next half transposed.
      auto half_buf = [&](int i) { return scr + i * kF32Tile; };
      auto transpose = [&](uint32_t raw_tile, int i) {  // half i of a raw tile into buffer i
        named_barrier(2 + wg, 128);                      // its last reader is done
        transpose_half(gen(half_buf(i)), gen(half_buf(i) + kF32Tile / 2), gen(raw_tile), i, t);
        fence_proxy_async();
        named_barrier(2 + wg, 128);
      };
      AFrag<float> A;
      auto products = [&](int i) {  // k8 steps 4 i .. 4 i + 3
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t off = j * 32;
          wgmma_rs_tf32<64>(y, A.small[4 * i + j], desc_kmajor(half_buf(i) + off), 1);
          wgmma_rs_tf32<64>(y, A.big[4 * i + j],
                            desc_kmajor(half_buf(i) + kF32Tile / 2 + off), 1);
          wgmma_rs_tf32<64>(y, A.big[4 * i + j], desc_kmajor(half_buf(i) + off), 1);
        }
        wgmma_commit();
      };
      auto build = [&](int kt, int i) {  // A's half i for tile kt
        out_a_half(A, s_slot(kt), acs, kt * kT, kt == rt, i, i_lo, a_lo, a_hi, t4);
      };
      build(0, 0);
      uint32_t st = wait_full();
      transpose(st, 0);
      for (int kt = 0; kt <= rt; ++kt) {
        products(0);
        wgmma_wait<1>();  // the last half 1 is done: buffer 1 and A's half 1 are free
        fence_a<float>(A);
        build(kt, 1);
        transpose(st, 1);
        release();
        products(1);
        if (kt < rt) {
          st = wait_full();
          wgmma_wait<1>();  // half 0 is done: buffer 0 and A's half 0 are free
          fence_a<float>(A);
          build(kt + 1, 0);
          transpose(st, 0);
        }
      }
      wgmma_wait<0>();
      fence_regs(y);
      fence_a<float>(A);
    }
    // y rows i_lo, i_lo + 8: columns 8 j + 2 t4, + 1
    T* yp = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + int64_t(l0) * a.y_sl;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      T* yrow = yp + int64_t(i_lo + 8 * r) * a.y_sl + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x0 = y[4 * j + 2 * r], x1 = y[4 * j + 2 * r + 1];
        if constexpr (BF16) {
          *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * j) = __floats2bfloat162_rn(x0, x1);
        } else {
          *reinterpret_cast<float2*>(yrow + 8 * j) = make_float2(x0, x1);
        }
      }
    }
  }
}

// The Hopper route's launches on `stream`: a memset of the flags and the
// ticket, the state kernel, the output kernel.
template <typename T>
int launch_hopper(const void* x, const void* b, const void* c, const int64_t (&xs)[3],
                  const int64_t (&bs)[3], const int64_t (&cs)[3], HopArgs a, int L,
                  cudaStream_t stream) {
  constexpr bool BF16 = Hop<T>::BF16;
  static bool state_opted[kMaxDevices] = {}, out_opted[kMaxDevices] = {};
  // opted in at the largest chunk's size (the kernels' static shared memory comes on top)
  int rc = opt_in_smem(reinterpret_cast<const void*>(ssd_state_tma<T>),
                       Hop<T>::state_smem(4 * kT), state_opted);
  if (rc == 0) {
    rc = opt_in_smem(reinterpret_cast<const void*>(ssd_out_tma<T>), Hop<T>::out_smem(4 * kT),
                     out_opted);
  }
  if (rc != 0) return rc;
  // (P, L, H, B) for x; (N, L, heads, B) for b and c, one head when shared
  const int hbc = a.shared_bc ? 1 : a.H;
  // and the states h_z^T (P x N f32 tiles) as (N, P, Z, B H)
  CUtensorMap tx, tb, tc, th;
  if ((rc = cached_map(&tx, x, BF16, kT, L, a.H, a.B, xs[2], xs[1], xs[0], kT)) != 0 ||
      (rc = cached_map(&tb, b, BF16, kT, L, hbc, a.B, bs[2], bs[1], bs[0], kT)) != 0 ||
      (rc = cached_map(&tc, c, BF16, kT, L, hbc, a.B, cs[2], cs[1], cs[0], kT)) != 0 ||
      (rc = cached_map(&th, a.states, false, kT, kT, a.Z, a.B * a.H, kT, kT * kT,
                       int64_t(a.Z) * kT * kT, kT)) != 0) {
    return rc;
  }
  const int64_t items = int64_t(a.B) * a.Z * a.n_groups;
  const cudaError_t err =
      cudaMemsetAsync(a.flags, 0, (int64_t(a.B) * a.H * a.Z * 128 + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_tma<T><<<static_cast<unsigned>(items), kHopThreads, Hop<T>::state_smem(a.Q), stream>>>(
      tx, tb, a);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  ssd_out_tma<T><<<static_cast<unsigned>(items * (a.Q / kT)), kHopThreads, Hop<T>::out_smem(a.Q),
                   stream>>>(tx, tb, tc, th, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of shared memory the largest of the mma.sync route's product kernels
// takes for state N, head P, chunk Q.
long long ssd_scan_smem_bytes(int N, int P, int Q) {
  const int NP = round_up(N, 8), PT = p_tile(P);
  int64_t f = smem_scores_floats(NP);
  if (smem_state_floats(NP, PT, Q) > f) f = smem_state_floats(NP, PT, Q);
  if (smem_out_floats(NP, PT, Q) > f) f = smem_out_floats(NP, PT, Q);
  return f * static_cast<long long>(sizeof(float));
}

// 1 if the mma.sync route takes state N, head P and chunk Q (P at most 128,
// the tiles and the chunk's cumsum within a block's shared memory), else 0.
int ssd_scan_fits(int N, int P, int Q) {
  return N > 0 && P > 0 && Q > 0 && P <= kMaxP && ssd_scan_smem_bytes(N, P, Q) <= kMaxSmem;
}

// Bytes of the scratch a call takes (f32 throughout, 16-byte aligned
// parts). path 3 (Hopper): the chunks' cumsums (B, H, L), the states
// entering the chunks (B, H, L / Q, P, N), then (B, H, L / Q, 128) + 1 ints
// (the flags of the pass over the chunks, one per thread of a warpgroup,
// and the state kernel's ticket). Paths
// 0-2: the chunk scores ((B, L / Q, Q, Q) when shared_bc, else (B, H, L / Q,
// Q, Q)), the chunk states (B, H, L / Q, N, P), each chunk's total log-decay
// (B, H, L / Q).
long long ssd_scan_scratch_bytes(int B, int H, int L, int N, int P, int Q, int shared_bc,
                                 int path) {
  const int64_t Z = L / Q, BHZ = int64_t(B) * H * Z;
  if (path == 3) return 4 * (round_up4(int64_t(B) * H * L) + BHZ * kT * kT + BHZ * 128 + 1);
  const int64_t scores = int64_t(B) * (shared_bc ? 1 : H) * Z * Q * Q;
  return 4 * (round_up4(scores) + BHZ * N * P + BHZ);
}

// x (B, H, L, P), a (B, H, L) float32, b and c (B, H, L, N), y (B, H, L, P),
// each given by its base pointer and element strides of batch, head and
// sequence (x, b, c and y with the last axis contiguous); x, b, c, y share
// dtype 0 = float32 or 1 = bfloat16. L % Q == 0; P <= 128. h_out: (B, H, N,
// P) float32 contiguous, or null. scratch: ssd_scan_scratch_bytes(...) bytes,
// 16-byte aligned. shared_bc: b and c the same for every head (H == 1 or
// head strides 0). path: 0 chooses between the mma.sync kernels by size
// (ssd_scan_seq where it fits and B * H fills two blocks per SM, else the
// chunk-parallel ones), 1 the chunk-parallel kernels, 2 ssd_scan_seq (Q and
// N at most 64), 3 the Hopper route (N = P = 64, Q a multiple of 64 up to
// 256; x, b and c readable by TMA: rows 16-byte aligned, strides of axes
// longer than 1 nonzero multiples of 16 bytes, b's and c's head axis left
// out when shared) with head_group heads a block (1 unless shared_bc).
int ssd_scan_launch(const void* x, const void* a, const void* b, const void* c, void* y,
                    void* h_out, void* scratch, long long x_sb, long long x_sh, long long x_sl,
                    long long a_sb, long long a_sh, long long a_sl, long long b_sb,
                    long long b_sh, long long b_sl, long long c_sb, long long c_sh,
                    long long c_sl, long long y_sb, long long y_sh, long long y_sl, int B, int H,
                    int L, int P, int N, int Q, int shared_bc, int dtype, int path,
                    int head_group, void* stream) {
  const int64_t BH = int64_t(B) * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || L <= 0 || Q <= 0 || L % Q != 0 || path < 0 || path > 3 ||
      dtype < 0 || dtype > 1 || (shared_bc && H > 1 && (b_sh != 0 || c_sh != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool f32 = dtype == 0;
  if (path == 3) {
    const int G = !shared_bc || head_group < 1 ? 1 : head_group < H ? head_group : H;
    if (N != kT || P != kT || Q % kT != 0 || Q > 4 * kT || BH * (L / Q) * (Q / kT) > 0x7fffffff ||
        reinterpret_cast<uintptr_t>(y) % (f32 ? 8 : 4) != 0 || y_sb % 2 != 0 || y_sh % 2 != 0 ||
        y_sl % 2 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    float* acs = static_cast<float*>(scratch);
    float* states = acs + round_up4(BH * L);
    HopArgs args{static_cast<const float*>(a), y, static_cast<float*>(h_out), states, acs,
                 reinterpret_cast<int*>(states + BH * (L / Q) * kT * kT),
                 a_sb, a_sh, a_sl, y_sb, y_sh, y_sl, B, H, L / Q, Q, G, (H + G - 1) / G,
                 shared_bc != 0};
    const int64_t xs[3] = {x_sb, x_sh, x_sl}, bs[3] = {b_sb, b_sh, b_sl},
                  cs[3] = {c_sb, c_sh, c_sl};
    return f32 ? launch_hopper<float>(x, b, c, xs, bs, cs, args, L, s)
               : launch_hopper<__nv_bfloat16>(x, b, c, xs, bs, cs, args, L, s);
  }
  if (!ssd_scan_fits(N, P, Q) || BH * (L / Q) > 0x7fffffff || (Q + BR - 1) / BR > 65535 ||
      (int64_t(N) * P + kThreads * kPassItems - 1) / (kThreads * kPassItems) > 65535 ||
      (path == 2 && !seq_fits(round_up(N, 8), Q))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool seq = path == 2;
  if (path == 0 && seq_fits(round_up(N, 8), Q)) {
    int sms = 0;
    if (int rc = sm_count(sms)) return rc;
    seq = BH >= 2 * int64_t(sms);
  }
  const int64_t Z = L / Q;
  float* scores = static_cast<float*>(scratch);
  float* states = scores + round_up4(int64_t(B) * (shared_bc ? 1 : H) * Z * Q * Q);
  float* dlast = states + BH * Z * N * P;
  Args args{x, static_cast<const float*>(a), b, c, y, static_cast<float*>(h_out), states, dlast,
            scores,
            x_sb, x_sh, x_sl, a_sb, a_sh, a_sl, b_sb, b_sh, b_sl, c_sb, c_sh, c_sl,
            y_sb, y_sh, y_sl, H, L, P, N, Q, L / Q, round_up(N, 8), shared_bc != 0,
            f32 && rows_aligned(x, x_sb, x_sh, x_sl, P),
            f32 && rows_aligned(b, b_sb, b_sh, b_sl, N),
            f32 && rows_aligned(c, c_sb, c_sh, c_sl, N),
            rows_aligned(states, 0, 0, P, P), rows_aligned(scores, 0, 0, Q, Q),
            P % 2 == 0 && y_sb % 2 == 0 && y_sh % 2 == 0 && y_sl % 2 == 0 &&
                reinterpret_cast<uintptr_t>(y) % (f32 ? 8 : 4) == 0};
  return f32 ? launch<float>(args, BH, seq, s) : launch<__nv_bfloat16>(args, BH, seq, s);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
