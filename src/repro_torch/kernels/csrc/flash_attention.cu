// flash_attention: forward online-softmax attention (causal switch, GQA) for
// NVIDIA Hopper (sm_90a): TMA loads, wgmma on the tensor cores, a producer
// warpgroup and two consumer warpgroups.
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
// mask keeps. bf16 runs at the tensor cores' 989 TFLOP/s, which only wgmma
// reaches. f32 must keep f32 accuracy, so its least time is at the
// three-pass TF32 rate, 494.7 / 3 = 165 TFLOP/s (67 TFLOP/s on the CUDA
// cores). Bytes (q, k, v and o once) bound neither model shape. What holds
// a kernel of this shape back is everything that is not a product: the
// softmax (one ex2 a score), the loads, and in f32 the split of every tile;
// the design keeps them under the products.
//
// Design (warp-specialised, as FlashAttention-3). 384 threads in three
// warpgroups; work items of 128 query rows of one (batch, head).
// - The grid is persistent, one block an SM: block i takes item i, then in
//   odd rounds the mirror item, so that the items with the most causal keys
//   go first and a block that took a heavy item takes a light one next.
//   The K/V ring runs on across items, so the next item's loads overlap
//   this one's last tiles and its stores.
// - Warpgroup 2 is the producer: it gives back its registers (setmaxnreg
//   24) and one thread issues the TMA loads: the Q tile of each item, then
//   K and V tiles into a ring (4 stages for bf16 at hd <= 64, 3 above, 2
//   for f32), each stage with a "full" mbarrier (TMA bytes) and an "empty"
//   one (the 256 consumer threads); Q has its own pair.
// - Warpgroups 0 and 1 are consumers of 64 query rows each (setmaxnreg
//   240). S = Q K^T and O += P V are wgmma with f32 accumulators in
//   registers. S(t) and PV(t - 1) are issued together, so the softmax of
//   tile t runs while the tensor cores work on PV(t - 1); in bf16 the two
//   warpgroups also take turns to issue (named barriers), so that one's
//   softmax runs under the other's products. The online softmax runs on the
//   S accumulators in base 2, the scale folded into the exponent's
//   multiply-add (ex2 on the special-function unit; a row's max and sum take
//   two shuffles in the quad that holds it). A warpgroup skips a causal tile
//   whose keys all lie past its rows (it would add exactly 0). The running
//   max starts at key 0, which every causal row sees, so it is finite after
//   the first tile. Every wgmma is issued on a path the whole warpgroup
//   takes, so that ptxas keeps them asynchronous.
// - Shared tiles are TMA's 128-byte swizzle: rows of 128 bytes (64 bf16 or
//   32 f32 values), a head dim split into such column chunks, one TMA box
//   a chunk. hd 96 and 112 (and, in bf16, 16 and 32) leave the last chunk
//   part full; TMA fills the columns past hd with zeros, which no product
//   reads: QK^T runs over the first hd columns and PV's N is hd.
// - bf16: 128 keys a tile. S is wgmma with Q and K from shared memory
//   (both K-major); P is rounded to bf16 and packed in registers from the
//   S accumulators straight into PV's A operand; PV reads V (MN-major)
//   through the descriptor's transpose.
// - f32: three TF32 passes, so that the f32 tolerance holds. A value x is
//   split once into big = cvt.rna.tf32(x) and small = x - big (the tensor
//   cores read the top 19 bits of each), and a.b = a_small b_big +
//   a_big b_small + a_big b_big summed in f32: the dropped terms are about
//   2^-21 of a.b (one TF32 pass keeps about three digits). TF32
//   wgmma takes K-major operands only, so both consumer warpgroups split
//   each tile once in shared memory, into one of two buffers: K big in
//   place, K small beside it, and V^T big and small with keys contiguous
//   (transposed in registers, 4 x 4 values a thread, 16-byte stores, no
//   bank conflicts); every warpgroup reads them. Tile t + 1's K is split
//   under S(t) and its V under PV(t). Q is split once per item: big in
//   place, small in the consumer's registers as the A operand of the first
//   pass; P's halves are made in registers. P's accumulator columns 2t and
//   2t+1 feed the A operand's k-slots t and t+4, so V^T holds each group of
//   8 keys in that order (0, 2, 4, 6, 1, 3, 5, 7). 64 keys a tile at
//   hd <= 64, 32 above (shared memory).
//
// Strides are arguments: the model hands over (B, S, H, hd) activations
// viewed as (B, H, S, hd), read and written in place. Three tensor maps
// (q, k, v; dims (hd, S, heads, B) with the view's strides) are encoded on
// the host for each call with cuTensorMapEncodeTiled, a CUDA driver API
// function reached through the runtime (no -lcuda), and passed as
// __grid_constant__ parameters. TMA needs every row 16-byte aligned and
// every stride of an axis longer than 1 a nonzero multiple of 16 bytes: the
// wrapper copies a view that is not.
//
// The Hopper building blocks (mbarriers, TMA, wgmma and its descriptors,
// the tensor-map encoder) are in hopper.cuh, shared with ssd_scan.cu.
//
// C interface (no PyTorch headers; loaded with ctypes). Each call is one
// kernel launch on the given stream; it allocates nothing, and the launcher
// returns cudaGetLastError() (0 on success).

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kMaskValue = -1e30f;
constexpr int BQ = 128;         // query rows per block: two consumer warpgroups of 64
constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kConsumers = 256;

// per dtype and head dim: values in a 128-byte swizzle row (CW), keys per
// K/V tile (BK), the shared width of a row (HDP, hd rounded up to whole
// swizzle rows) and the stages of the K/V ring
template <typename T, int HD> struct Cfg;
template <int HD> struct Cfg<__nv_bfloat16, HD> {
  static constexpr int CW = 64, BK = 128, HDP = (HD + 63) / 64 * 64;
  static constexpr int STAGES = HDP <= 64 ? 4 : 3;
};
template <int HD> struct Cfg<float, HD> {
  static constexpr int CW = 32, BK = HD <= 64 ? 64 : 32, HDP = (HD + 31) / 32 * 32;
  static constexpr int STAGES = 2;
};

// shared bytes: Q, the K/V ring, and for f32 two buffers of the split K
// and V^T (big and small); 1 KB of slack to align the tiles to the
// swizzle's 1 KB
template <typename T, int HD> struct Smem {
  using C = Cfg<T, HD>;
  static constexpr int Q = C::HDP / C::CW * BQ * 128;
  static constexpr int KV = C::HDP / C::CW * C::BK * 128;  // one K (or V) tile
  static constexpr int VT = C::BK / 32 * HD * 128;          // one f32 V^T tile
  static constexpr int TOTAL =
      1024 + Q + 2 * C::STAGES * KV + (sizeof(T) == 4 ? 2 * (KV + 2 * VT) : 0);
};

struct Args {
  void* o;
  int64_t o_sb, o_sh, o_ss;
  int B, H, KV, Sq, Sk;
  float scale;
};

// online softmax of one tile's scores, in place: s holds the raw S
// accumulators (entry 4 j + e is row row_lo + 8 (e / 2), key
// k0 + 8 j + 2 t4 + e % 2); on return it holds the probabilities
// 2^(s scale2 - m), m and l are updated, and corr holds the factor by which
// each row's output accumulator is to be rescaled. The scale is folded into
// the exponent's multiply-add (scale2 > 0 keeps the row max in place);
// masked scores become -1e30 and keys past Sk -inf once scaled.
template <int BK, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int row_lo,
                                             int warp_first, int t4, int Sk, float scale2) {
  if (k0 + BK > Sk || (CAUSAL && k0 + BK - 1 > warp_first)) {
    const float masked = kMaskValue / scale2;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
      if (col >= Sk) {
        s[i] = -INFINITY;
      } else if (CAUSAL && col > row_lo + 8 * ((i >> 1) & 1)) {
        s[i] = masked;
      }
    }
  }
  float mt[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, neg[2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m[r], mt[r] * scale2);
    corr[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    neg[r] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = exp2_approx(fmaf(s[i], scale2, neg[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += p;
    s[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * corr[r] + rs[r];
  }
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr bool BF16 = sizeof(T) == 2;
  using C = Cfg<T, HD>;
  using M = Smem<T, HD>;
  constexpr int BK = C::BK, CW = C::CW, NCH = C::HDP / C::CW, NS = C::STAGES;
  constexpr uint32_t kSplit = M::KV + 2 * M::VT;  // f32: K small, V^T big, V^T small
  __shared__ __align__(8) uint64_t bars[2 * NS + 2];  // full[NS], empty[NS], Q full, Q empty
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  unsigned char* gQ = smem_raw + (sQ - raw);  // the same bytes through a generic pointer
  const uint32_t sK = sQ + M::Q;            // stage i: K at sK + 2 i KV, V after it
  const uint32_t sX = sK + 2 * NS * M::KV;  // f32: split buffer j at sX + j kSplit
  const uint32_t full0 = smem_addr(&bars[0]), empty0 = smem_addr(&bars[NS]);
  const uint32_t qbar = smem_addr(&bars[2 * NS]), qempty = smem_addr(&bars[2 * NS + 1]);

  // The grid is persistent: in round r block i takes work item
  // r G + i, or r G + G - 1 - i in odd rounds (G = gridDim.x), so that a
  // block that took a heavy item takes a light one next. Item w is query
  // tile n_qt - 1 - w / (B H) (the tiles with the most causal keys first) of
  // batch-head w % (B H). The ring runs on across items: gt counts the
  // tiles of the items before this one.
  const int n_qt = (a.Sq + BQ - 1) / BQ, n_items = n_qt * a.B * a.H;
  const int G = gridDim.x, blk = blockIdx.x;
  auto item_of = [&](int r) { return r * G + ((r & 1) ? G - 1 - blk : blk); };
  int gt = 0, b = 0, h = 0, q0 = 0, n_tiles = 0;
  auto take_item = [&](int w) {
    b = (w % (a.B * a.H)) / a.H;
    h = w % a.H;
    q0 = (n_qt - 1 - w / (a.B * a.H)) * BQ;
    n_tiles = (a.Sk + BK - 1) / BK;
    if (CAUSAL) n_tiles = min(n_tiles, (min(q0 + BQ, a.Sq) - 1) / BK + 1);
  };
  // this item's tile t: its stage (K and V), the stage's barriers and the
  // parity of its phase; its split buffer (f32)
  auto k_of = [&](int t) { return sK + ((gt + t) % NS) * 2 * M::KV; };
  auto v_of = [&](int t) { return k_of(t) + M::KV; };
  auto full = [&](int t) { return full0 + 8 * ((gt + t) % NS); };
  auto empty = [&](int t) { return empty0 + 8 * ((gt + t) % NS); };
  auto phase = [&](int t) { return uint32_t((gt + t) / NS) & 1; };
  auto x_of = [&](int t) { return sX + ((gt + t) & 1) * kSplit; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_init(qempty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer warpgroup: it gives back its registers, and one thread keeps
    // the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      for (int it = 0; item_of(it) < n_items; ++it) {
        take_item(item_of(it));
        const int kvh = h / (a.H / a.KV);
        if (it > 0) mbar_wait(qempty, (it - 1) & 1);  // the last item's Q is no longer read
        mbar_expect_tx(qbar, M::Q);
#pragma unroll
        for (int c = 0; c < NCH; ++c) tma_load(sQ + c * BQ * 128, &tq, qbar, c * CW, q0, h, b);
        for (int t = 0; t < n_tiles; ++t) {
          if (gt + t >= NS) mbar_wait(empty(t), phase(t) ^ 1);  // the stage's last tile released
          mbar_expect_tx(full(t), 2 * M::KV);
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            tma_load(k_of(t) + c * BK * 128, &tk, full(t), c * CW, t * BK, kvh, b);
            tma_load(v_of(t) + c * BK * 128, &tv, full(t), c * CW, t * BK, kvh, b);
          }
        }
        gt += n_tiles;
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int ct = threadIdx.x;  // 0..255
    const int warp = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
    const float scale2 = a.scale * 1.4426950408889634f;  // hd^-0.5 log2 e
    const uint32_t qwg = sQ + wg * 64 * 128;          // the warpgroup's rows of each Q chunk
    if constexpr (BF16) {
      if (wg == 1) named_barrier_arrive(2, kConsumers);  // warpgroup 0 issues first
    }
    for (int it = 0; item_of(it) < n_items; ++it) {
      take_item(item_of(it));
      const int r0 = q0 + wg * 64;                      // this warpgroup's first row
      const int warp_first = r0 + warp * 16;
      const int row_lo = warp_first + g;                // this thread's rows: row_lo, row_lo + 8
      // tiles whose keys some row of this warpgroup sees (the rest it only
      // releases); every wgmma below is issued on a path all of the
      // warpgroup takes, so that ptxas keeps them asynchronous
      const int n_live = CAUSAL ? min(n_tiles, (r0 + 63) / BK + 1) : n_tiles;
      float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      mbar_wait(qbar, it & 1);

      if constexpr (BF16) {
        // S(t) and PV(t - 1) are issued together; the softmax of tile t runs
        // while the tensor cores work on PV(t - 1). The two warpgroups take
        // turns to issue (named barriers 2 and 3), so that one's softmax
        // runs under the other's products.
        uint32_t p[BK / 16][4];  // P of the tile whose PV is pending, as PV's A operand
        // each take_turn waits on the other warpgroup's pass_turn, so both must
        // take as many turns: the same n_live, which holds while a key tile
        // covers whole query blocks ((q0 + 63) / BK == (q0 + 127) / BK)
        static_assert(BK % BQ == 0, "bf16 turns need both warpgroups to see the same tiles");
        auto take_turn = [&]() { named_barrier(2 + wg, kConsumers); };
        auto pass_turn = [&]() { named_barrier_arrive(3 - wg, kConsumers); };
        auto issue_s = [&](float (&s)[BK / 2], int t) {
          const uint32_t kt = k_of(t);
#pragma unroll
          for (int ks = 0; ks < HD / 16; ++ks) {  // S = Q K^T, 16 columns of hd a step
            const uint32_t off = (ks % 4) * 32;
            wgmma_ss_bf16<BK>(s, desc_kmajor(qwg + (ks / 4) * BQ * 128 + off),
                              desc_kmajor(kt + (ks / 4) * BK * 128 + off), ks > 0);
          }
          wgmma_commit();
        };
        auto issue_pv = [&](int t) {
          const uint32_t vt = v_of(t);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {  // O += P V, 16 keys a step
            wgmma_rs_bf16<HD>(o, p[kk], desc_mnmajor(vt + kk * 16 * 128, BK * 128), 1);
          }
          wgmma_commit();
        };
        auto softmax_to_p = [&](float (&s)[BK / 2], int t, bool rescale) {
          float corr[2];
          softmax_tile<BK, CAUSAL>(s, m, l, corr, t * BK, row_lo, warp_first, t4, a.Sk, scale2);
          if (rescale) {
            wgmma_wait<0>();  // PV(t - 1) is done with o and p
            fence_regs(o);
            fence_regs(p);
            mbar_arrive(empty(t - 1));
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
          }
          // P in bf16: accumulator tiles 2 kk and 2 kk + 1 make k-step kk
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
            }
          }
        };
        {
          float s[BK / 2];
          mbar_wait(full(0), phase(0));
          take_turn();
          wgmma_fence();
          issue_s(s, 0);
          pass_turn();
          wgmma_wait<0>();
          fence_regs(s);
          softmax_to_p(s, 0, false);
        }
        for (int t = 1; t < n_live; ++t) {
          float s[BK / 2];
          mbar_wait(full(t), phase(t));
          take_turn();
          wgmma_fence();
          issue_s(s, t);
          issue_pv(t - 1);
          pass_turn();
          wgmma_wait<1>();  // S(t) is done; PV(t - 1) may run on
          fence_regs(s);
          softmax_to_p(s, t, true);
        }
        take_turn();
        wgmma_fence();
        issue_pv(n_live - 1);
        pass_turn();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        mbar_arrive(empty(n_live - 1));
        for (int t = n_live; t < n_tiles; ++t) {
          mbar_wait(full(t), phase(t));
          mbar_arrive(empty(t));
        }
      } else {
        // split this warpgroup's Q rows once: big in place, small into the
        // A fragments of the first pass (rows g, g + 8; k-slots t4, t4 + 4)
        uint32_t qs[HD / 8][4];
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = wg * 64 + warp * 16 + g + (j & 1) * 8;
            const int col = ks * 8 + t4 + (j >> 1) * 4;
            float* x = reinterpret_cast<float*>(gQ + (col / 32) * BQ * 128 + swz<4>(row, col % 32));
            const float big = to_tf32(*x);
            qs[ks][j] = __float_as_uint(*x - big);
            *x = big;
          }
        }
        fence_proxy_async();
        named_barrier(2 + wg, 128);

        // Tile t's split (in the buffer x_of(t), written by both warpgroups):
        // K big in place in its stage and K small at the same swizzled
        // offsets, 16 bytes a lane, contiguous; V^T big and small, row d
        // holding the tile's keys, each group of 8 in the order 0, 2, 4, 6,
        // 1, 3, 5, 7. For V a thread takes a 4 x 4 block, the 4 keys of one
        // half of a group of 8 by one unit of 4 values, transposes it in
        // registers and stores 4 rows of 4 slots; a quarter warp covers the 8
        // units, so its loads hit 8 distinct 16-byte units, and with each
        // lane's rows rotated by (unit / 2) % 4 so do its stores.
        auto split_k = [&](int t) {
          unsigned char* gK = gQ + (k_of(t) - sQ);
          unsigned char* gX = gQ + (x_of(t) - sQ);
          float4 x[M::KV / 16 / kConsumers];
#pragma unroll
          for (int j = 0; j < M::KV / 16 / kConsumers; ++j)
            x[j] = reinterpret_cast<const float4*>(gK)[ct + j * kConsumers];
#pragma unroll
          for (int j = 0; j < M::KV / 16 / kConsumers; ++j) {
            const float4 big =
                make_float4(to_tf32(x[j].x), to_tf32(x[j].y), to_tf32(x[j].z), to_tf32(x[j].w));
            reinterpret_cast<float4*>(gK)[ct + j * kConsumers] = big;
            reinterpret_cast<float4*>(gX)[ct + j * kConsumers] =
                make_float4(x[j].x - big.x, x[j].y - big.y, x[j].z - big.z, x[j].w - big.w);
          }
        };
        auto split_v = [&](int t) {
          const unsigned char* gV = gQ + (v_of(t) - sQ);
          unsigned char* gX = gQ + (x_of(t) + M::KV - sQ);
          constexpr int BLOCKS = NCH * (BK / 8) * 2 * 8;  // (chunk, group of 8 keys, half, unit)
          const int u = ct & 7, half = (ct >> 3) & 1, grp = (ct >> 4) % (BK / 8);
          const int c = (ct >> 4) / (BK / 8), d0 = c * 32 + 4 * u;
          if (ct >= BLOCKS || d0 >= HD) return;
          float4 r[4];  // keys grp * 8 + half + 2 i, values d0 .. d0 + 3
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            r[i] = *reinterpret_cast<const float4*>(gV + c * BK * 128 +
                                                    swz<4>(grp * 8 + half + 2 * i, 4 * u));
          }
          const int slot = grp * 8 + 4 * half;  // the first of the block's 4 slots
          const uint32_t base = (slot / 32) * HD * 128;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ee = (e + (u >> 1)) & 3;  // this store's row: d0 + ee
            float x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              x[i] = ee == 0 ? r[i].x : ee == 1 ? r[i].y : ee == 2 ? r[i].z : r[i].w;
            }
            const uint32_t off = base + swz<4>(d0 + ee, slot % 32);
            const float4 big =
                make_float4(to_tf32(x[0]), to_tf32(x[1]), to_tf32(x[2]), to_tf32(x[3]));
            *reinterpret_cast<float4*>(gX + off) = big;
            *reinterpret_cast<float4*>(gX + off + M::VT) =
                make_float4(x[0] - big.x, x[1] - big.y, x[2] - big.z, x[3] - big.w);
          }
        };
        // the split of tile t + 1, while the products of tile t run: K under
        // S(t); V, once every warpgroup is done with PV(t - 1), under PV(t)
        auto split_next_k = [&](int t) {
          if (t + 1 < n_tiles) {
            mbar_wait(full(t + 1), phase(t + 1));
            split_k(t + 1);
          }
        };
        auto split_next_v = [&](int t) {
          if (t + 1 < n_tiles) {
            named_barrier(1, kConsumers);
            split_v(t + 1);
            fence_proxy_async();
            named_barrier(1, kConsumers);  // tile t + 1's split is whole
          }
        };

        uint32_t pb[BK / 8][4], ps[BK / 8][4];  // P's halves, PV's A operands
        named_barrier(1, kConsumers);  // every warpgroup is done with the last item's split
        mbar_wait(full(0), phase(0));
        split_k(0);
        split_v(0);
        fence_proxy_async();
        named_barrier(1, kConsumers);
        for (int t = 0; t < n_live; ++t) {
          const uint32_t kt = k_of(t), xt = x_of(t);
          float s[BK / 2], corr[2];
          wgmma_fence();
          // S = Q_small K_big + Q_big K_small + Q_big K_big, 8 columns of hd a step
#pragma unroll
          for (int ks = 0; ks < HD / 8; ++ks) {
            wgmma_rs_tf32<BK>(s, qs[ks], desc_kmajor(kt + (ks / 4) * BK * 128 + (ks % 4) * 32),
                              ks > 0);
          }
#pragma unroll
          for (int ks = 0; ks < HD / 8; ++ks) {
            wgmma_ss_tf32<BK>(s, desc_kmajor(qwg + (ks / 4) * BQ * 128 + (ks % 4) * 32),
                              desc_kmajor(xt + (ks / 4) * BK * 128 + (ks % 4) * 32), 1);
          }
#pragma unroll
          for (int ks = 0; ks < HD / 8; ++ks) {
            wgmma_ss_tf32<BK>(s, desc_kmajor(qwg + (ks / 4) * BQ * 128 + (ks % 4) * 32),
                              desc_kmajor(kt + (ks / 4) * BK * 128 + (ks % 4) * 32), 1);
          }
          wgmma_commit();
          split_next_k(t);
          wgmma_wait<0>();  // S(t), and PV(t - 1)
          fence_regs(s);
          fence_regs(o);
          fence_regs(pb);
          fence_regs(ps);
          mbar_arrive(empty(t));  // the stage's K and V are no longer read
          softmax_tile<BK, CAUSAL>(s, m, l, corr, t * BK, row_lo, warp_first, t4, a.Sk, scale2);
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
          // P's halves as A fragments: k-slot t4 <-> key 2 t4, t4 + 4 <-> 2 t4 + 1
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float big = to_tf32(x[i]);
              pb[kk][i] = __float_as_uint(big);
              ps[kk][i] = __float_as_uint(x[i] - big);
            }
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {  // O += P V, 8 keys a step, three passes
            const uint32_t off = xt + M::KV + (kk / 4) * HD * 128 + (kk % 4) * 32;
            wgmma_rs_tf32<HD>(o, ps[kk], desc_kmajor(off), 1);
            wgmma_rs_tf32<HD>(o, pb[kk], desc_kmajor(off + M::VT), 1);
            wgmma_rs_tf32<HD>(o, pb[kk], desc_kmajor(off), 1);
          }
          wgmma_commit();
          split_next_v(t);
        }
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pb);
        fence_regs(ps);
        for (int t = n_live; t < n_tiles; ++t) {  // the other warpgroup's tiles: split, release
          split_next_k(t);
          mbar_arrive(empty(t));
          split_next_v(t);
        }
      }

      mbar_arrive(qempty);  // this item's Q is no longer read
      // O / l, row by row
      T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        if (row >= a.Sq) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        T* orow = op + int64_t(row) * a.o_ss + 2 * t4;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          const float x0 = o[4 * d + 2 * r] / denom, x1 = o[4 * d + 2 * r + 1] / denom;
          if constexpr (BF16) {
            *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) = __floats2bfloat162_rn(x0, x1);
          } else {
            *reinterpret_cast<float2*>(orow + d * 8) = make_float2(x0, x1);
          }
        }
      }
      gt += n_tiles;
    }
  }
}

struct Views {
  const void *q, *k, *v;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

template <typename T, int HD, bool CAUSAL>
int launch_one(const Views& w, const Args& a, cudaStream_t stream) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int smem = Smem<T, HD>::TOTAL;
  static bool opted_in[kMaxDevices] = {};
  int rc = opt_in_smem(reinterpret_cast<const void*>(flash_fwd<T, HD, CAUSAL>), smem, opted_in);
  if (rc != 0) return rc;
  CUtensorMap tq, tk, tv;
  constexpr int BK = Cfg<T, HD>::BK;
  int sms = 0;
  if ((rc = make_map(&tq, w.q, BF16, HD, a.Sq, a.H, a.B, w.q_ss, w.q_sh, w.q_sb, BQ)) != 0 ||
      (rc = make_map(&tk, w.k, BF16, HD, a.Sk, a.KV, a.B, w.k_ss, w.k_sh, w.k_sb, BK)) != 0 ||
      (rc = make_map(&tv, w.v, BF16, HD, a.Sk, a.KV, a.B, w.v_ss, w.v_sh, w.v_sb, BK)) != 0 ||
      (rc = sm_count(sms)) != 0) {
    return rc;
  }
  const int64_t items = int64_t((a.Sq + BQ - 1) / BQ) * a.B * a.H;
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block an SM at most
  flash_fwd<T, HD, CAUSAL><<<grid, kThreads, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Views& w, const Args& a, int hd, bool causal, cudaStream_t s) {
  switch (hd) {
    case 16: return causal ? launch_one<T, 16, true>(w, a, s) : launch_one<T, 16, false>(w, a, s);
    case 32: return causal ? launch_one<T, 32, true>(w, a, s) : launch_one<T, 32, false>(w, a, s);
    case 64: return causal ? launch_one<T, 64, true>(w, a, s) : launch_one<T, 64, false>(w, a, s);
    case 96: return causal ? launch_one<T, 96, true>(w, a, s) : launch_one<T, 96, false>(w, a, s);
    case 112:
      return causal ? launch_one<T, 112, true>(w, a, s) : launch_one<T, 112, false>(w, a, s);
    case 128:
      return causal ? launch_one<T, 128, true>(w, a, s) : launch_one<T, 128, false>(w, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o (B, H, Sq, hd), each given by
// its base pointer and element strides of batch, head and sequence (the last
// axis contiguous; every row 16-byte aligned and every stride of an axis
// longer than 1 a nonzero multiple of 16 bytes, as TMA needs). dtype 0 =
// float32, 1 = bfloat16; hd in {16, 32, 64, 96, 112, 128}; scale is hd^-0.5
// rounded to f32 by the caller.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss,
                           long long o_sb, long long o_sh, long long o_ss,
                           int B, int H, int KV, int Sq, int Sk, int hd, float scale,
                           int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      int64_t((Sq + BQ - 1) / BQ) * B * H > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Views w{q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const Args a{o, o_sb, o_sh, o_ss, B, H, KV, Sq, Sk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(w, a, hd, causal != 0, s);
    case 1: return launch<__nv_bfloat16>(w, a, hd, causal != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
