// Flash-attention backward for Hopper (sm_90a): bf16 (K4) and with int8
// score recompute (K7), both on wgmma, TMA and warp specialisation.
//
// Replaces
//   K4  smb_vision_tpu/ops/attention.py:_bwd_dq_kernel and _bwd_dkv_kernel
//   K7  smb_vision_tpu/ops/attention.py:_bwd_dq_i8_kernel and
//       _bwd_dkv_i8_kernel (attn_impl "pallas_i8bwd")
//
// What it computes, per (batch, head), from q, k, v, do (bf16), the forward's
// row logsumexp lse2 (log2 units) and delta_i = sum_d do_id * o_id (f32, both
// (B, H, Nq)):
//   p_ij  = exp2((q_i . k_j) * c - lse2_i)          c = scale*log2(e)
//   dp_ij = do_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = scale * sum_i ds_ij q_i
//   dv_j  =         sum_i p_ij do_i
// in two passes with no atomics, as the TPU kernel has, so the result is
// deterministic: a dq pass (a block owns 128 query rows and walks every kv
// tile) and a dk/dv pass (a block owns 128 kv rows and walks every query
// tile), in one grid. The TPU kernel accumulated dq^T and dk^T transposed
// and pre-scaled q by c; both were MXU choices and are not carried over.
//
// K4. Bound on the H100: the least work is 10*N^2*d flops per head (s, dp
// and the three products dq, dk, dv) against O(N*d) bytes, so the tensor
// cores are the limit, not device memory; the two passes recompute s and dp
// each, 14*N^2*d in all. The design follows K1 (flash_fwd.cu):
//   - warpgroup 0 is the producer: one thread issues TMA loads of the
//     block's own rows (q and do in the dq pass, k and v in the dk/dv pass)
//     once, and of the streamed pair (k, v in tiles of 64 keys; q, do in
//     tiles of 64 queries at d <= 80, 32 at d = 128) through a ring of 4
//     stages with full and empty mbarriers; in the dk/dv pass its 32 lanes
//     also stage the tile's lse2 and delta (+inf and 0 past Nq, so those
//     columns give p = ds = 0). Warpgroups 1 and 2 are the consumers, 64
//     rows each; setmaxnreg moves registers to them (40 / 232);
//   - every product is a wgmma: the recomputed s and dp with both operands
//     in shared memory; dq += ds k, dv += p^T do and dk += ds^T q with the
//     A operand in registers (the accumulator of s or dp, rounded to bf16:
//     p and ds never touch shared memory) and the streamed tile as an
//     MN-major B operand (no transposed copies);
//   - the dk/dv pass computes s^T = k q^T and dp^T = v do^T, so that p^T and
//     ds^T come out with keys as rows, the A operand its products need;
//   - the passes share no data and run in one grid, so the card does not
//     idle on the part-filled last wave of each (672 blocks a pass at the
//     MIM encoder are 5.1 waves on 132 SMs, a block an SM);
//   - each pass issues tile j's s and dp with tile j-1's products (dq, or
//     dk and dv), and runs tile j's exp2 and elementwise work while those
//     run; the bf16 A fragments are rewritten only after they finish.
// Ragged lengths: rows past their length read as zero (TMA); in the dq
// pass kv columns past Nk are masked to p = 0; rows a block owns past its
// length are computed and not stored.
// At d = 32 (the V-JEPA2 predictor's heads) every bf16 tile is one panel
// of 32 columns in the 64-byte swizzle (sm90.cuh): s and dp take two k16
// steps, dq, dk and dv are N = 32 accumulators whose B operands (k, q, do)
// are read MN-major from the same tiles, and the tiles are d 64's. With
// 4*d flops per score against one exp2 per score and pass, the exp2 and
// elementwise work weigh twice as much against the products as at d 64.
//
// Head widths past the instantiations, K4 and K7 alike. A head of width D
// (a multiple of 8 up to 128; the wrapper pads any other by a copy and cuts
// dq, dk and dv back, as the JAX `attention` pads it) runs on the
// instantiation of the next of its widths up (the template's D; the real
// width is p.D; K4's and K7's are 32, 64, 80 and 128), as K1
// does (flash_fwd.cu): the bf16 operands (q, k,
// v and do; K7's k, q and do) are read in place by tensor maps whose
// global width is the real D while their boxes keep the instantiation's
// panels, so TMA reads the columns past D as zeros; K7's int8 codes come
// from the quantisation kernel at the instantiation's code width (96 on
// the d-80 tiles) with zero columns past D (a row of 72 or 80 bytes has
// no TMA stride and no int8 swizzle). The zero columns add nothing to s
// or dp, and the columns of
// dq, dk and dv past D come out zero and are not stored: only D columns
// are, by an instantiation of its own (NARROW), so a head as wide as its
// instantiation runs the code it ran before the narrower widths came.
// K7's NARROW instantiations are compiled in a translation unit of their
// own (flash_bwd_i8_narrow.cu includes this file): beside them here, nvcc
// compiled K7's d-32 and d-64 kernels for full-width heads to other SASS
// (the producer warp's registers renamed, an add merged); its d-80 tiles
// compile in flash_bwd_i8_d80.cu, beside no other kernel. Delta and the
// lse2 cotangent are the wrapper's, unchanged.
//
// K4 on tiles of 80 columns (heads of 72 and 80), K1's layout
// (flash_fwd.cu; Panels<80> and TailMaps, sm90.cuh): each bf16 operand a
// 64-column panel in the 128-byte swizzle and a 16-column tail panel in
// the 32-byte one, by two tensor maps, so 16 maps a launch. s, dp, s^T and
// dp^T contract over d in 5 k16 steps in place of 8; dq += ds k, dk +=
// ds^T q and dv += p^T do, whose N is the head, are each an n64 wgmma on
// the 64-column panel and an n16 one on the tail, from the same A
// fragments, in place of one n128. The tiles: the dq pass keeps d 128's
// (own q and do 40 KB, 4 stages of 64 keys of k and v, 20 KB a stage: 124
// KB), with dq in 40 floats a consumer thread; the dk/dv pass streams
// d 64's 64 queries a tile where d 128's took 32 (own k and v 40 KB, 4
// stages of q and do, 20 KB, and 512 bytes of lse2 and delta: 125 KB),
// with dk and dv in 40 floats each beside s^T and dp^T in 32 each: 176
// accumulator and fragment registers of the 232, as at d 128. The d-80
// instantiations compile in flash_bwd_d80.cu, beside no other kernel.
//
// K7 on the same tiles of 80 columns (heads of 72 and 80; the d-128 ones
// did 1.6 to 1.8 times the tensor work, streaming 32 queries a tile in the
// dk/dv pass). Its int8 codes q8, k8, v8 and do8 are rows of 96 bytes (an
// int8 wgmma step is 32 bytes, 80 is 2 1/2 of them), a 64-byte panel in
// the 64-byte swizzle and a 32-byte tail panel in the 32-byte one, each by
// a map of its own (Codes<80>, sm90.cuh), so s, dp, s^T and dp^T take 3
// k32 steps in place of 4; its bf16 k, q and do take K4 d80's panel pairs,
// and dq += ds k, dk += ds^T q and dv += p^T do are K4 d80's n64 + n16
// wgmma pairs. 22 tensor maps a launch (11 and their tails, TailMaps).
// Tiles: the dq pass owns q8 and do8 (12 KB each), a stage holds 64 keys
// of k8 and v8 (6 KB each) and the bf16 k (10 KB): 113 KB with 4 stages;
// the dk/dv pass streams 64 queries a tile, as K4 d80: it owns k8 and v8
// (12 KB each), a stage holds q8 and do8 (6 KB each), q and do (10 KB
// each) and 512 bytes of lse2 and delta: 155 KB. A consumer thread holds
// dk and dv in 40 floats each beside s^T and dp^T in 32 each, K4 d80's
// 176 registers of the 232. At N 9,216 with 16 heads the tensor work is
// 1.19 ms (1.76 on the d-128 tiles): s and dp twice over 96 bytes at the
// int8 rate, the three bf16 products over 80 columns; the exp2 of the two
// passes, 2*N^2*H of them, is ~0.7 ms beside it. At that little tensor
// work a tile, the two consumer warpgroups, which wait on the same stages,
// ran in step: their products and their exp2 and elementwise work came at
// the same time, and each left the other's units idle. On these tiles
// they take turns at issuing their wgmma (ping-pong, `Turns`, as K1's),
// so one's exp2 runs under the other's products; the sums are the same,
// bit for bit (PERF.md has the times with and without; a ring of 6 stages
// and a dq key tile of 128 gained nothing past the spread).
//
// K7 is K4 with the two recomputed products on int8: from per-(batch,
// head) symmetric quantisations q8 (of q*scale*log2(e)), k8, v8, do8 and
// their scales, made in plain torch before the launch,
//   s_ij  = (q8_i . k8_j) * sqk       sqk = sq*sk (log2 units)
//   dp_ij = (do8_i . v8_j) * sdv      sdv = sdo*sv
// then as K4: p = exp2(s - lse2), ds = bf16(p (dp - delta)),
// dq = scale ds k, dk = scale ds^T q, dv = bf16(p)^T do, with k, q, do in
// bf16 and f32 accumulation. Bound on the H100: s and dp on int8 at 1,979
// TOP/s and dq, dk, dv on bf16 at 989 TFLOP/s, 0.70 ms of least work at
// the V-JEPA encoder (N 9,216, 8 heads of 128); the two passes recompute
// s and dp, so 4 of its 7 products run at the int8 rate. K4's design, and:
//   - s, s^T, dp and dp^T are wgmma m64nNk32 .s32.s8.s8 with both operands
//     K-major in shared memory (all four contract over d, along which q8,
//     k8, v8 and do8 are contiguous: no transposed copy); an int8 tile holds
//     whole rows, with the 64-byte swizzle at d 64 and the 128-byte one at
//     d 128 (sm90.cuh). An s32 sum becomes a float by one integer add
//     (i8_exponent), and its scale folds into the FFMA of the exponent and
//     of dp - delta;
//   - at d 32 an int8 row is 32 bytes: one k32 step in the 32-byte swizzle
//     (sm90.cuh), the bf16 tiles as K4's at d 32;
//   - p and ds are written over the s32 accumulators of s and dp, as K4
//     writes ds over s, so the consumers hold no third score array;
//   - the producer streams int8 and bf16 tiles side by side: in the dq
//     pass k8, v8 and the bf16 k (dq's B operand); in the dk/dv pass q8,
//     do8 and the bf16 q and do (dk's and dv's). Shared memory at d 128:
//     the dq pass owns q8 and do8 (2 x 16 KB) and a stage holds k8, v8 (8
//     KB each) and k (16 KB), 32 KB; the dk/dv pass owns k8 and v8 (2 x 16
//     KB) and a stage holds q8, do8 (4 KB each), q and do (8 KB each) and
//     256 bytes of lse2 and delta. A ring of 4 stages, as K4's, is 161 KB
//     and 130 KB of the 227 KB, so TMA runs up to three tiles ahead of
//     the consumers; a deeper ring would fit the dk/dv pass only (not
//     tried);
//   - in the dk/dv pass the producer warp's lanes read each tile's lse2
//     and delta into registers two tiles ahead of its stage, and lane 0
//     issues the stage's TMA loads before the lanes store them: the loads'
//     latency from L2 no longer holds up a stage. With the int8 products
//     the consumers finish a tile sooner than K4's, and a producer that
//     loaded the tile's lse2 only after the ring freed its stage, as K4's
//     does, set the pace of the pass;
//   - the bf16 operands k, q and do may be strided views (fused qkv), as
//     K4's; the int8 ones are contiguous from the quantisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

struct BwdParams {
  const char* q;
  const char* k;
  const char* v;
  const char* dout;
  const float* lse;    // (B*H, Nq), log2 units
  const float* delta;  // (B*H, Nq)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, Nq, Nk;
  // strides in elements: batch, token, head (the last dim is contiguous)
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;     // do
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale, scale_log2;
  int D;  // the real head width: D of the instantiation, or less (NARROW)
};

constexpr int kStages = 4;

// shared memory of a pass: the block's own two operands (ROWS rows each),
// a ring of kStages stages of the streamed pair (BT rows each), AUX bytes
// of lse2 and delta a stage, and the barriers; bf16 tiles in the panels of
// sm90.cuh (64 columns, or one of 32 at d 32, or 64 and a tail of 16 at
// d 80)
template <int D, int ROWS, int BT, int AUX>
struct BwdTiles {
  using P = Panels<D>;
  static constexpr int PANELS = P::N;
  static constexpr int OWN = ROWS * P::BYTES_ROW;  // one own operand
  static constexpr int TILE = BT * P::BYTES_ROW;   // one streamed operand
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BARS = (2 * kStages + 1) * 8;
  static constexpr int BYTES =
      1024 + 2 * OWN + kStages * (STAGE + AUX) + BARS;
};

// dq pass: block bx owns 128 query rows of one (batch, head)
template <int D>
struct DqShape {
  static constexpr int BM = 128;  // query rows a block owns
  static constexpr int BN = 64;   // keys of a tile
};

// (tails: at d 80 the tail panels' maps of q, do, k, v, then of the
// dk/dv pass's k, v, q, do)
template <int D, bool NARROW>
__device__ __forceinline__ void dq_pass(const CUtensorMap& tq,
                                        const CUtensorMap& tdo,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const TailMaps<D, 8>& tails,
                                        const BwdParams& p, int bx,
                                        char* smem_raw) {
  constexpr int BM = DqShape<D>::BM, BN = DqShape<D>::BN, ST = kStages;
  using T = BwdTiles<D, BM, BN, 0>;
  using P = typename T::P;
  char* qs = align1024(smem_raw);       // q, then do
  char* ring = qs + 2 * T::OWN;         // stage s: k panels, then v panels
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * T::STAGE);
  uint64_t* empty = full + ST;
  uint64_t* own = empty + ST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = bx * BM;
  const int ntiles = (p.Nk + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {  // producer warpgroup
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(own, 2 * T::OWN);
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        tma_load_4d(qs + pn * BM * P::ROW, &tq, own, pn * P::COLS, h, q0, b);
        tma_load_4d(qs + T::OWN + pn * BM * P::ROW, &tdo, own, pn * P::COLS,
                    h, q0, b);
      }
      if constexpr (P::TAIL) {  // the last 16 columns of q and do
        tma_load_4d(qs + BM * P::ROW, &tails.m[0], own, P::COLS, h, q0, b);
        tma_load_4d(qs + T::OWN + BM * P::ROW, &tails.m[1], own, P::COLS, h,
                    q0, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE);
        char* ks = ring + s * T::STAGE;
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          tma_load_4d(ks + pn * BN * P::ROW, &tk, &full[s], pn * P::COLS, h,
                      it * BN, b);
          tma_load_4d(ks + T::TILE + pn * BN * P::ROW, &tv, &full[s],
                      pn * P::COLS, h, it * BN, b);
        }
        if constexpr (P::TAIL) {
          tma_load_4d(ks + BN * P::ROW, &tails.m[2], &full[s], P::COLS, h,
                      it * BN, b);
          tma_load_4d(ks + T::TILE + BN * P::ROW, &tails.m[3], &full[s],
                      P::COLS, h, it * BN, b);
        }
      }
    }
  } else {  // consumer warpgroups cw = 0, 1: 64 query rows each
    reg_alloc<232>();
    const int cw = threadIdx.x / kWG - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows
    const float* lb = p.lse + (long long)bh * p.Nq;
    const float* db = p.delta + (long long)bh * p.Nq;
    const float lse0 = r0 < p.Nq ? lb[r0] : 0.f;
    const float lse1 = r0 + 8 < p.Nq ? lb[r0 + 8] : 0.f;
    const float dl0 = r0 < p.Nq ? db[r0] : 0.f;
    const float dl1 = r0 + 8 < p.Nq ? db[r0 + 8] : 0.f;
    const float c = p.scale_log2;
    const uint32_t qa = smem_u32(qs), doa = qa + T::OWN;
    const uint32_t ra = smem_u32(ring);

    float s[BN / 2], dp[BN / 2], acc[D / 2];
    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    auto issue_s_dp = [&](int it) {  // s = q k^T, dp = do v^T over d
      const uint32_t ka = ra + (it % ST) * T::STAGE, va = ka + T::TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, 0>(s, desc_k<D>(qa, BM, cw * 64, kk),
                        desc_k<D>(ka, BN, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, 0>(dp, desc_k<D>(doa, BM, cw * 64, kk),
                        desc_k<D>(va, BN, 0, kk), kk > 0);
    };
    auto issue_dq = [&](int it) {  // dq += ds k over the tile's keys
      const uint32_t ka = ra + (it % ST) * T::STAGE;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_mn<D>(acc, dsa[kk], ka, BN, kk);
    };

    // ds = p (dp - delta), p = exp2(s c - lse2), into s; kv columns past
    // Nk -> 0
    auto elementwise = [&](int it) {
      const int kv0 = it * BN;
      const bool tail = kv0 + BN > p.Nk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse = e < 2 ? lse0 : lse1, dl = e < 2 ? dl0 : dl1;
          float pv = ex2(fmaf(s[4 * j + e], c, -lse));
          if (tail && kv0 + j * 8 + 2 * t + (e & 1) >= p.Nk) pv = 0.f;
          s[4 * j + e] = pv * (dp[4 * j + e] - dl);
        }
      }
    };

    mbar_wait(own, 0);
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s_dp(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    elementwise(0);
    acc_to_a<BN>(dsa, s);
    for (int it = 1; it < ntiles; ++it) {
      mbar_wait(&full[it % ST], (it / ST) & 1);
      wgmma_fence();
      issue_s_dp(it);
      wgmma_commit();
      issue_dq(it - 1);
      wgmma_commit();
      wgmma_wait<1>();  // s and dp of tile it; ds k of tile it - 1 runs on
      fence_regs(s);
      fence_regs(dp);
      elementwise(it);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % ST]);  // k and v of tile it - 1 done
      acc_to_a<BN>(dsa, s);
    }
    wgmma_fence();
    issue_dq(ntiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, acc, p.scale, r0,
                 p.Nq, t, NARROW ? p.D : D);
  }
}

// dk/dv pass: a block owns 128 kv rows of one (batch, head); s and dp are
// computed transposed (rows = keys, columns = queries)
template <int D>
struct DkvShape {
  static constexpr int BN = 128;                 // kv rows a block owns
  static constexpr int BQ = D <= 80 ? 64 : 32;   // queries of a tile
  static constexpr int AUX = 2 * BQ * 4;         // lse2 and delta
};

template <int D, bool NARROW>
__device__ __forceinline__ void dkv_pass(const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         const CUtensorMap& tq,
                                         const CUtensorMap& tdo,
                                         const TailMaps<D, 8>& tails,
                                         const BwdParams& p, int bx,
                                         char* smem_raw) {
  using Sh = DkvShape<D>;
  constexpr int BN = Sh::BN, BQ = Sh::BQ, ST = kStages;
  using T = BwdTiles<D, BN, BQ, Sh::AUX>;
  using P = typename T::P;
  char* ks = align1024(smem_raw);       // k, then v
  char* ring = ks + 2 * T::OWN;         // stage s: q panels, then do panels
  float* aux = reinterpret_cast<float*>(ring + ST * T::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(aux + ST * 2 * BQ);
  uint64_t* empty = full + ST;
  uint64_t* own = empty + ST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = bx * BN;
  const int ntiles = (p.Nq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (lse2, delta)
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {  // producer warpgroup: warp 0 loads
    reg_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lb = p.lse + (long long)bh * p.Nq;
      const float* db = p.delta + (long long)bh * p.Nq;
      if (lane == 0) {
        mbar_expect_tx(own, 2 * T::OWN);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          tma_load_4d(ks + pn * BN * P::ROW, &tk, own, pn * P::COLS, h, k0,
                      b);
          tma_load_4d(ks + T::OWN + pn * BN * P::ROW, &tv, own,
                      pn * P::COLS, h, k0, b);
        }
        if constexpr (P::TAIL) {  // the last 16 columns of k and v
          tma_load_4d(ks + BN * P::ROW, &tails.m[4], own, P::COLS, h, k0, b);
          tma_load_4d(ks + T::OWN + BN * P::ROW, &tails.m[5], own, P::COLS,
                      h, k0, b);
        }
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        float* as = aux + s * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int qi = it * BQ + i;
          as[i] = qi < p.Nq ? lb[qi] : INFINITY;
          as[BQ + i] = qi < p.Nq ? db[qi] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], T::STAGE);
          char* qt = ring + s * T::STAGE;
#pragma unroll
          for (int pn = 0; pn < T::PANELS; ++pn) {
            tma_load_4d(qt + pn * BQ * P::ROW, &tq, &full[s], pn * P::COLS,
                        h, it * BQ, b);
            tma_load_4d(qt + T::TILE + pn * BQ * P::ROW, &tdo, &full[s],
                        pn * P::COLS, h, it * BQ, b);
          }
          if constexpr (P::TAIL) {
            tma_load_4d(qt + BQ * P::ROW, &tails.m[6], &full[s], P::COLS, h,
                        it * BQ, b);
            tma_load_4d(qt + T::TILE + BQ * P::ROW, &tails.m[7], &full[s],
                        P::COLS, h, it * BQ, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // consumer warpgroups cw = 0, 1: 64 kv rows each
    reg_alloc<232>();
    const int cw = threadIdx.x / kWG - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = k0 + cw * 64 + warp * 16 + g;  // this thread's keys
    const float c = p.scale_log2;
    const uint32_t ka = smem_u32(ks), va = ka + T::OWN;
    const uint32_t ra = smem_u32(ring);

    float st[BQ / 2], dpt[BQ / 2], dk[D / 2], dv[D / 2];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    auto issue_s_dp = [&](int it) {  // s^T = k q^T, dp^T = v do^T over d
      const uint32_t qt = ra + (it % ST) * T::STAGE, dot = qt + T::TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(st, desc_k<D>(ka, BN, cw * 64, kk),
                        desc_k<D>(qt, BQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(dpt, desc_k<D>(va, BN, cw * 64, kk),
                        desc_k<D>(dot, BQ, 0, kk), kk > 0);
    };
    // dv += p^T do, dk += ds^T q over the tile's queries
    auto issue_dkv = [&](int it) {
      const uint32_t qt = ra + (it % ST) * T::STAGE, dot = qt + T::TILE;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs_mn<D>(dv, pa[kk], dot, BQ, kk);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs_mn<D>(dk, da[kk], qt, BQ, kk);
    };
    // p^T = exp2(s^T c - lse2) into st, ds^T = p^T (dp^T - delta) into dpt
    auto elementwise = [&](int it) {
      const float* ls = aux + (it % ST) * 2 * BQ;
      const float* ds = ls + BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = j * 8 + 2 * t;
        const float l0 = ls[col], l1 = ls[col + 1];
        const float d0 = ds[col], d1 = ds[col + 1];
        st[4 * j] = ex2(fmaf(st[4 * j], c, -l0));
        st[4 * j + 1] = ex2(fmaf(st[4 * j + 1], c, -l1));
        st[4 * j + 2] = ex2(fmaf(st[4 * j + 2], c, -l0));
        st[4 * j + 3] = ex2(fmaf(st[4 * j + 3], c, -l1));
        dpt[4 * j] = st[4 * j] * (dpt[4 * j] - d0);
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d1);
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d0);
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d1);
      }
    };

    mbar_wait(own, 0);
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_s_dp(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    elementwise(0);
    acc_to_a<BQ>(pa, st);
    acc_to_a<BQ>(da, dpt);
    for (int it = 1; it < ntiles; ++it) {
      mbar_wait(&full[it % ST], (it / ST) & 1);
      wgmma_fence();
      issue_s_dp(it);
      wgmma_commit();
      issue_dkv(it - 1);
      wgmma_commit();
      wgmma_wait<1>();  // s^T and dp^T of tile it; tile it - 1's run on
      fence_regs(st);
      fence_regs(dpt);
      elementwise(it);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      mbar_arrive(&empty[(it - 1) % ST]);  // q, do of tile it - 1 done
      acc_to_a<BQ>(pa, st);
      acc_to_a<BQ>(da, dpt);
    }
    wgmma_fence();
    issue_dkv(ntiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    store_acc<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, dk, p.scale, r0,
                 p.Nk, t, NARROW ? p.D : D);
    store_acc<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, dv, 1.f, r0,
                 p.Nk, t, NARROW ? p.D : D);
  }
}

// One grid runs both passes: the first ceil(Nq / 128) blocks of each
// (batch, head) row the dq pass, the rest the dk/dv pass. They share no
// data, and one grid of both keeps the card full where each pass alone
// would end on a part-filled wave.
template <int D, bool NARROW>
__global__ void __launch_bounds__(3 * kWG, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mdo,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap nk,
                          const __grid_constant__ CUtensorMap nv,
                          const __grid_constant__ CUtensorMap nq,
                          const __grid_constant__ CUtensorMap ndo,
                          const BwdParams p,
                          const __grid_constant__ TailMaps<D, 8> tails) {
  extern __shared__ char smem_raw[];
  const int gq = (p.Nq + DqShape<D>::BM - 1) / DqShape<D>::BM;
  if ((int)blockIdx.x < gq)
    dq_pass<D, NARROW>(mq, mdo, mk, mv, tails, p, blockIdx.x, smem_raw);
  else
    dkv_pass<D, NARROW>(nk, nv, nq, ndo, tails, p, blockIdx.x - gq,
                        smem_raw);
}

// q, k, v and do at the real width p.D through their maps (the note at
// the top)
template <int D, bool NARROW>
cudaError_t launch(const BwdParams& p, int B, int BH, cudaStream_t stream) {
  using Sq = DqShape<D>;
  using Sk = DkvShape<D>;
  using Tq = BwdTiles<D, Sq::BM, Sq::BN, 0>;
  using Tk = BwdTiles<D, Sk::BN, Sk::BQ, Sk::AUX>;
  // the dq pass reads q, do by BM rows and k, v by its BN; the dk/dv pass
  // k, v by its BN and q, do by BQ
  CUtensorMap mq, mdo, mk, mv, nk, nv, nq, ndo;
  const struct {
    CUtensorMap* map;
    const char* base;
    int n, rows;
    long long sb, sn, sh;
  } maps[8] = {
      {&mq, p.q, p.Nq, Sq::BM, p.q_sb, p.q_sn, p.q_sh},
      {&mdo, p.dout, p.Nq, Sq::BM, p.o_sb, p.o_sn, p.o_sh},
      {&mk, p.k, p.Nk, Sq::BN, p.k_sb, p.k_sn, p.k_sh},
      {&mv, p.v, p.Nk, Sq::BN, p.v_sb, p.v_sn, p.v_sh},
      {&nk, p.k, p.Nk, Sk::BN, p.k_sb, p.k_sn, p.k_sh},
      {&nv, p.v, p.Nk, Sk::BN, p.v_sb, p.v_sn, p.v_sh},
      {&nq, p.q, p.Nq, Sk::BQ, p.q_sb, p.q_sn, p.q_sh},
      {&ndo, p.dout, p.Nq, Sk::BQ, p.o_sb, p.o_sn, p.o_sh}};
  for (const auto& m : maps) {
    cudaError_t err = make_map_head(m.map, m.base, B, m.n, p.H, p.D, m.sb,
                                    m.sn, m.sh, m.rows);
    if (err != cudaSuccess) return err;
  }
  TailMaps<D, 8> tails;  // at d 80: the same eight for the last 16 columns
  if constexpr (Tq::P::TAIL) {
    for (int i = 0; i < 8; ++i) {
      const auto& m = maps[i];
      cudaError_t err = make_map_tail(&tails.m[i], m.base, B, m.n, p.H, p.D,
                                      m.sb, m.sn, m.sh, m.rows);
      if (err != cudaSuccess) return err;
    }
  }
  auto kernel = flash_bwd_sm90_kernel<D, NARROW>;
  const int bytes = Tq::BYTES > Tk::BYTES ? Tq::BYTES : Tk::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int gq = (p.Nq + Sq::BM - 1) / Sq::BM;
  const int gk = (p.Nk + Sk::BN - 1) / Sk::BN;
  kernel<<<dim3(gq + gk, BH), 3 * kWG, bytes, stream>>>(mq, mdo, mk, mv, nk,
                                                         nv, nq, ndo, p,
                                                         tails);
  return cudaGetLastError();
}

// the instantiation of width D for a head of width p.D <= D
template <int D>
cudaError_t launch_width(const BwdParams& p, int B, int BH,
                         cudaStream_t stream) {
  return p.D == D ? launch<D, false>(p, B, BH, stream)
                  : launch<D, true>(p, B, BH, stream);
}

// ---------------------------------------------------------------------------
// K7: the int8-score backward (see the note at the top).

struct BwdI8Params {
  const char* q8;
  const char* k8;
  const char* v8;
  const char* do8;
  const char* kbf;   // bf16 k (dq pass)
  const char* qbf;   // bf16 q (dk/dv pass)
  const char* dobf;  // bf16 do (dk/dv pass)
  const float* lse;    // (B*H, Nq), log2 units
  const float* delta;  // (B*H, Nq)
  const float* sqk;    // (B*H)
  const float* sdv;    // (B*H)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, Nq, Nk;
  // strides in elements: batch, token, head (the last dim is contiguous)
  long long q8_sb, q8_sn, q8_sh;
  long long k8_sb, k8_sn, k8_sh;
  long long v8_sb, v8_sn, v8_sh;
  long long o8_sb, o8_sn, o8_sh;  // do8
  long long kb_sb, kb_sn, kb_sh;
  long long qb_sb, qb_sn, qb_sh;
  long long ob_sb, ob_sn, ob_sh;  // bf16 do
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale;
  int D;  // the real head width: D of the instantiation, or less (NARROW)
};

// shared memory of a K7 pass: its two own int8 operands (ROWS code rows of
// Codes<D>::W bytes), a ring of kStages stages of the streamed tiles (two
// int8 tiles of BT rows and N16 bf16 tiles of BT rows in the panels of
// sm90.cuh), AUX bytes of lse2 and delta a stage, and the barriers
template <int D, int ROWS, int BT, int N16, int AUX>
struct BwdI8Tiles {
  using P = Panels<D>;
  using C = Codes<D>;
  static constexpr int OWN = ROWS * C::W;           // one own operand
  static constexpr int T8 = BT * C::W;              // one int8 tile
  static constexpr int T16 = BT * P::BYTES_ROW;     // one bf16 tile
  static constexpr int STAGE = 2 * T8 + N16 * T16;
  static constexpr int BARS = (2 * kStages + 1) * 8;
  static constexpr int BYTES =
      1024 + 2 * OWN + kStages * (STAGE + AUX) + BARS;
};

// An s32 sum x of the int8 products (|x| <= 127^2 * 128 < 2^22) read as
// the float 1.5 * 2^23 + x, exact, by one integer add; x * c - y is then
// one FFMA against i8_bias(y, c) = y + 1.5 * 2^23 * c. The bias is rounded
// once a row or column, by half an ulp: under one unit of x while |y| <
// 2^22 c, else a few ulps of y. So the conversion costs no FADD and no
// trip through the quarter-rate I2F unit.
__device__ __forceinline__ float i8_bias(float y, float c) {
  return fmaf(12582912.f, c, y);
}
__device__ __forceinline__ float i8_exponent(uint32_t x, float c,
                                             float bias) {
  return fmaf(__int_as_float((int)x + 0x4B400000), c, -bias);
}

// whether K7's consumer warpgroups take turns at issuing their wgmma
// (ping-pong, K1's in flash_fwd.cu): on the d-80 tiles (see the note at
// the top); at the other widths the turns compile to nothing
template <int D>
constexpr bool kI8PingPong = Codes<D>::TAIL;

// the turns of consumer warpgroup cw: it issues its wgmma between a sync
// on named barrier 1 + cw and an arrive on the other's, so one warpgroup's
// exp2 and elementwise work runs under the other's products; warpgroup 0
// goes first, and warpgroup 1 skips its last arrive so the counts balance
template <int D>
struct Turns {
  int cw;
  __device__ __forceinline__ explicit Turns(int cw_) : cw(cw_) {
    if constexpr (kI8PingPong<D>) {
      if (cw == 1) named_arrive(1, kConsumers);
    }
  }
  __device__ __forceinline__ void begin() const {
    if constexpr (kI8PingPong<D>) named_sync(1 + cw, kConsumers);
  }
  __device__ __forceinline__ void end(bool last) const {
    if constexpr (kI8PingPong<D>) {
      if (!(last && cw == 1)) named_arrive(2 - cw, kConsumers);
    }
  }
};

// dq pass: block bx owns 128 query rows (q8, do8); k8, v8 and the bf16 k
// stream in tiles of 64 keys (tails: at d 80 the tail panels' maps of q8,
// do8, k8, v8, k, then of the dk/dv pass's k8, v8, q8, do8, q, do)
template <int D, bool NARROW>
__device__ __forceinline__ void dq_pass_i8(const CUtensorMap& tq8,
                                           const CUtensorMap& tdo8,
                                           const CUtensorMap& tk8,
                                           const CUtensorMap& tv8,
                                           const CUtensorMap& tkb,
                                           const TailMaps<D, 11>& tails,
                                           const BwdI8Params& p, int bx,
                                           char* smem_raw) {
  constexpr int BM = DqShape<D>::BM, BN = DqShape<D>::BN, ST = kStages;
  using T = BwdI8Tiles<D, BM, BN, 1, 0>;
  using P = typename T::P;
  using C = typename T::C;
  char* qs = align1024(smem_raw);  // q8, then do8
  char* ring = qs + 2 * T::OWN;    // stage s: k8, v8, then k's panels
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * T::STAGE);
  uint64_t* empty = full + ST;
  uint64_t* own = empty + ST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = bx * BM;
  const int ntiles = (p.Nk + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {  // producer warpgroup
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(own, 2 * T::OWN);
      tma_load_4d(qs, &tq8, own, 0, h, q0, b);
      tma_load_4d(qs + T::OWN, &tdo8, own, 0, h, q0, b);
      if constexpr (C::TAIL) {  // the last 32 bytes of q8 and do8
        tma_load_4d(qs + BM * C::ROW, &tails.m[0], own, C::ROW, h, q0, b);
        tma_load_4d(qs + T::OWN + BM * C::ROW, &tails.m[1], own, C::ROW, h,
                    q0, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE);
        char* ks = ring + s * T::STAGE;
        tma_load_4d(ks, &tk8, &full[s], 0, h, it * BN, b);
        tma_load_4d(ks + T::T8, &tv8, &full[s], 0, h, it * BN, b);
#pragma unroll
        for (int pn = 0; pn < P::N; ++pn)
          tma_load_4d(ks + 2 * T::T8 + pn * BN * P::ROW, &tkb, &full[s],
                      pn * P::COLS, h, it * BN, b);
        if constexpr (C::TAIL) {  // k8's, v8's last 32 bytes, k's 16 columns
          tma_load_4d(ks + BN * C::ROW, &tails.m[2], &full[s], C::ROW, h,
                      it * BN, b);
          tma_load_4d(ks + T::T8 + BN * C::ROW, &tails.m[3], &full[s],
                      C::ROW, h, it * BN, b);
          tma_load_4d(ks + 2 * T::T8 + BN * P::ROW, &tails.m[4], &full[s],
                      P::COLS, h, it * BN, b);
        }
      }
    }
  } else {  // consumer warpgroups cw = 0, 1: 64 query rows each
    reg_alloc<232>();
    const int cw = threadIdx.x / kWG - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows
    const float* lb = p.lse + (long long)bh * p.Nq;
    const float* db = p.delta + (long long)bh * p.Nq;
    const float lse0 = r0 < p.Nq ? lb[r0] : 0.f;
    const float lse1 = r0 + 8 < p.Nq ? lb[r0 + 8] : 0.f;
    const float dl0 = r0 < p.Nq ? db[r0] : 0.f;
    const float dl1 = r0 + 8 < p.Nq ? db[r0 + 8] : 0.f;
    const float cqk = p.sqk[bh], cdv = p.sdv[bh];
    // this warpgroup's q8 and do8 rows; at d 80, whose tail panels lie past
    // the first panels' BM rows, rows cw * 64.. of the tiles at qa, doa
    const uint32_t qa = smem_u32(qs) + (C::TAIL ? 0 : cw * 64 * D);
    const uint32_t doa = qa + T::OWN;
    const uint32_t ra = smem_u32(ring);

    // s32 sums of q8 k8^T and do8 v8^T; ds is written over s (f32 bits)
    uint32_t s[BN / 2], dp[BN / 2];
    float acc[D / 2];
    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0u;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // the scales fold into one FFMA with the bias of the exact int ->
    // float conversion (i8_exponent)
    const float bl0 = i8_bias(lse0, cqk), bl1 = i8_bias(lse1, cqk);
    const float bd0 = i8_bias(dl0, cdv), bd1 = i8_bias(dl1, cdv);

    auto issue_s_dp = [&](int it) {  // s = q8 k8^T, dp = do8 v8^T over d
      const uint32_t ka = ra + (it % ST) * T::STAGE, va = ka + T::T8;
      if constexpr (C::TAIL) {  // 3 k32 steps over the code rows
#pragma unroll
        for (int kk = 0; kk < C::STEPS; ++kk)
          wgmma_i8<BN>(s, desc_c96(qa, BM, cw * 64, kk),
                       desc_c96(ka, BN, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < C::STEPS; ++kk)
          wgmma_i8<BN>(dp, desc_c96(doa, BM, cw * 64, kk),
                       desc_c96(va, BN, 0, kk), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          wgmma_i8<BN>(s, desc_i8<D>(qa, kk), desc_i8<D>(ka, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          wgmma_i8<BN>(dp, desc_i8<D>(doa, kk), desc_i8<D>(va, kk), kk > 0);
      }
    };
    auto issue_dq = [&](int it) {  // dq += ds k over the tile's keys
      const uint32_t kb = ra + (it % ST) * T::STAGE + 2 * T::T8;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        if constexpr (P::TAIL)  // an n64 and an n16 wgmma (sm90.cuh)
          wgmma_rs_mn<D>(acc, dsa[kk], kb, BN, kk);
        else
          wgmma_rs<D, 1>(acc, dsa[kk], desc_mn<D>(kb, BN, kk), 1);
      }
    };

    // ds = p (dp sdv - delta), p = exp2(s sqk - lse2); kv columns past
    // Nk -> 0
    auto elementwise = [&](int it) {
      const int kv0 = it * BN;
      const bool tail = kv0 + BN > p.Nk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float pv = ex2(i8_exponent(s[i], cqk, e < 2 ? bl0 : bl1));
          if (tail && kv0 + j * 8 + 2 * t + (e & 1) >= p.Nk) pv = 0.f;
          s[i] = __float_as_uint(
              pv * i8_exponent(dp[i], cdv, e < 2 ? bd0 : bd1));
        }
      }
    };

    const Turns<D> turns(cw);
    mbar_wait(own, 0);
    mbar_wait(&full[0], 0);
    turns.begin();
    wgmma_fence();
    issue_s_dp(0);
    wgmma_commit();
    turns.end(false);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    elementwise(0);
    acc_to_a<BN>(dsa, s);
    for (int it = 1; it < ntiles; ++it) {
      mbar_wait(&full[it % ST], (it / ST) & 1);
      turns.begin();
      wgmma_fence();
      issue_s_dp(it);
      wgmma_commit();
      issue_dq(it - 1);
      wgmma_commit();
      turns.end(false);
      wgmma_wait<1>();  // s and dp of tile it; ds k of tile it - 1 runs on
      fence_regs(s);
      fence_regs(dp);
      elementwise(it);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % ST]);  // tile it - 1 done
      acc_to_a<BN>(dsa, s);
    }
    turns.begin();
    wgmma_fence();
    issue_dq(ntiles - 1);
    wgmma_commit();
    turns.end(true);
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, acc, p.scale, r0,
                 p.Nq, t, NARROW ? p.D : D);
  }
}

// dk/dv pass: a block owns 128 kv rows (k8, v8); q8, do8 and the bf16 q
// and do stream in tiles of BQ queries; s and dp are computed transposed
// (rows = keys, columns = queries)
template <int D, bool NARROW>
__device__ __forceinline__ void dkv_pass_i8(const CUtensorMap& tk8,
                                            const CUtensorMap& tv8,
                                            const CUtensorMap& tq8,
                                            const CUtensorMap& tdo8,
                                            const CUtensorMap& tqb,
                                            const CUtensorMap& tdob,
                                            const TailMaps<D, 11>& tails,
                                            const BwdI8Params& p, int bx,
                                            char* smem_raw) {
  using Sh = DkvShape<D>;
  constexpr int BN = Sh::BN, BQ = Sh::BQ, ST = kStages;
  using T = BwdI8Tiles<D, BN, BQ, 2, Sh::AUX>;
  using P = typename T::P;
  using C = typename T::C;
  char* ks = align1024(smem_raw);  // k8, then v8
  char* ring = ks + 2 * T::OWN;    // stage s: q8, do8, q's, then do's panels
  float* aux = reinterpret_cast<float*>(ring + ST * T::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(aux + ST * 2 * BQ);
  uint64_t* empty = full + ST;
  uint64_t* own = empty + ST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = bx * BN;
  const int ntiles = (p.Nq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (lse2, delta)
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {  // producer warpgroup: warp 0 loads
    reg_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lb = p.lse + (long long)bh * p.Nq;
      const float* db = p.delta + (long long)bh * p.Nq;
      if (lane == 0) {
        mbar_expect_tx(own, 2 * T::OWN);
        tma_load_4d(ks, &tk8, own, 0, h, k0, b);
        tma_load_4d(ks + T::OWN, &tv8, own, 0, h, k0, b);
        if constexpr (C::TAIL) {  // the last 32 bytes of k8 and v8
          tma_load_4d(ks + BN * C::ROW, &tails.m[5], own, C::ROW, h, k0, b);
          tma_load_4d(ks + T::OWN + BN * C::ROW, &tails.m[6], own, C::ROW,
                      h, k0, b);
        }
      }
      // each lane stages BQ / 32 of a tile's lse2 and delta; they are read
      // into registers two tiles ahead, so their latency runs under the
      // waits on the ring instead of holding up the stage
      constexpr int PER = BQ / 32;
      auto fetch = [&](int it, float (&l)[PER], float (&d)[PER]) {
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int qi = it * BQ + lane + 32 * u;
          const bool ok = it < ntiles && qi < p.Nq;
          l[u] = ok ? lb[qi] : INFINITY;
          d[u] = ok ? db[qi] : 0.f;
        }
      };
      float l0[PER], d0[PER], l1[PER], d1[PER];
      fetch(0, l0, d0);
      fetch(1, l1, d1);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        float l2[PER], d2[PER];
        fetch(it + 2, l2, d2);
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        if (lane == 0) {  // the TMA loads first, then the lanes' stores
          mbar_expect(&full[s], T::STAGE);
          char* qt = ring + s * T::STAGE;
          tma_load_4d(qt, &tq8, &full[s], 0, h, it * BQ, b);
          tma_load_4d(qt + T::T8, &tdo8, &full[s], 0, h, it * BQ, b);
#pragma unroll
          for (int pn = 0; pn < P::N; ++pn) {
            tma_load_4d(qt + 2 * T::T8 + pn * BQ * P::ROW, &tqb, &full[s],
                        pn * P::COLS, h, it * BQ, b);
            tma_load_4d(qt + 2 * T::T8 + T::T16 + pn * BQ * P::ROW, &tdob,
                        &full[s], pn * P::COLS, h, it * BQ, b);
          }
          if constexpr (C::TAIL) {  // the tails of q8, do8, q and do
            tma_load_4d(qt + BQ * C::ROW, &tails.m[7], &full[s], C::ROW, h,
                        it * BQ, b);
            tma_load_4d(qt + T::T8 + BQ * C::ROW, &tails.m[8], &full[s],
                        C::ROW, h, it * BQ, b);
            tma_load_4d(qt + 2 * T::T8 + BQ * P::ROW, &tails.m[9], &full[s],
                        P::COLS, h, it * BQ, b);
            tma_load_4d(qt + 2 * T::T8 + T::T16 + BQ * P::ROW, &tails.m[10],
                        &full[s], P::COLS, h, it * BQ, b);
          }
        }
        float* as = aux + s * 2 * BQ;
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          as[lane + 32 * u] = l0[u];
          as[BQ + lane + 32 * u] = d0[u];
          l0[u] = l1[u];
          d0[u] = d1[u];
          l1[u] = l2[u];
          d1[u] = d2[u];
        }
        mbar_arrive(&full[s]);  // 32 arrivals: the stores are in
      }
    }
  } else {  // consumer warpgroups cw = 0, 1: 64 kv rows each
    reg_alloc<232>();
    const int cw = threadIdx.x / kWG - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = k0 + cw * 64 + warp * 16 + g;  // this thread's keys
    const float cqk = p.sqk[bh], cdv = p.sdv[bh];
    // this warpgroup's k8 and v8 rows (at d 80 rows cw * 64.., as dq's)
    const uint32_t ka = smem_u32(ks) + (C::TAIL ? 0 : cw * 64 * D);
    const uint32_t va = ka + T::OWN;
    const uint32_t ra = smem_u32(ring);

    // s32 sums of k8 q8^T and v8 do8^T; p^T and ds^T are written over
    // them (f32 bits)
    uint32_t st[BQ / 2], dpt[BQ / 2];
    float dk[D / 2], dv[D / 2];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0u;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    auto issue_s_dp = [&](int it) {  // s^T = k8 q8^T, dp^T = v8 do8^T
      const uint32_t qt = ra + (it % ST) * T::STAGE, dot = qt + T::T8;
      if constexpr (C::TAIL) {  // 3 k32 steps over the code rows
#pragma unroll
        for (int kk = 0; kk < C::STEPS; ++kk)
          wgmma_i8<BQ>(st, desc_c96(ka, BN, cw * 64, kk),
                       desc_c96(qt, BQ, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < C::STEPS; ++kk)
          wgmma_i8<BQ>(dpt, desc_c96(va, BN, cw * 64, kk),
                       desc_c96(dot, BQ, 0, kk), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          wgmma_i8<BQ>(st, desc_i8<D>(ka, kk), desc_i8<D>(qt, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          wgmma_i8<BQ>(dpt, desc_i8<D>(va, kk), desc_i8<D>(dot, kk),
                       kk > 0);
      }
    };
    // dv += p^T do, dk += ds^T q over the tile's queries (at d 80 each an
    // n64 and an n16 wgmma, sm90.cuh)
    auto issue_dkv = [&](int it) {
      const uint32_t qb = ra + (it % ST) * T::STAGE + 2 * T::T8;
      const uint32_t dob = qb + T::T16;
      if constexpr (P::TAIL) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs_mn<D>(dv, pa[kk], dob, BQ, kk);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs_mn<D>(dk, da[kk], qb, BQ, kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<D, 1>(dv, pa[kk], desc_mn<D>(dob, BQ, kk), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<D, 1>(dk, da[kk], desc_mn<D>(qb, BQ, kk), 1);
      }
    };
    // p^T = exp2(s^T sqk - lse2), ds^T = p^T (dp^T sdv - delta)
    auto elementwise = [&](int it) {
      const float* ls = aux + (it % ST) * 2 * BQ;
      const float* dls = ls + BQ;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = j * 8 + 2 * t;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float bl = i8_bias(ls[col + u], cqk);
          const float bd = i8_bias(dls[col + u], cdv);
#pragma unroll
          for (int e = u; e < 4; e += 2) {
            const int i = 4 * j + e;
            const float pv = ex2(i8_exponent(st[i], cqk, bl));
            st[i] = __float_as_uint(pv);
            dpt[i] = __float_as_uint(pv * i8_exponent(dpt[i], cdv, bd));
          }
        }
      }
    };

    const Turns<D> turns(cw);
    mbar_wait(own, 0);
    mbar_wait(&full[0], 0);
    turns.begin();
    wgmma_fence();
    issue_s_dp(0);
    wgmma_commit();
    turns.end(false);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    elementwise(0);
    acc_to_a<BQ>(pa, st);
    acc_to_a<BQ>(da, dpt);
    for (int it = 1; it < ntiles; ++it) {
      mbar_wait(&full[it % ST], (it / ST) & 1);
      turns.begin();
      wgmma_fence();
      issue_s_dp(it);
      wgmma_commit();
      issue_dkv(it - 1);
      wgmma_commit();
      turns.end(false);
      wgmma_wait<1>();  // s^T and dp^T of tile it; tile it - 1's run on
      fence_regs(st);
      fence_regs(dpt);
      elementwise(it);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      mbar_arrive(&empty[(it - 1) % ST]);  // tile it - 1 done
      acc_to_a<BQ>(pa, st);
      acc_to_a<BQ>(da, dpt);
    }
    turns.begin();
    wgmma_fence();
    issue_dkv(ntiles - 1);
    wgmma_commit();
    turns.end(true);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    store_acc<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, dk, p.scale, r0,
                 p.Nk, t, NARROW ? p.D : D);
    store_acc<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, dv, 1.f, r0,
                 p.Nk, t, NARROW ? p.D : D);
  }
}

// both K7 passes in one grid, as K4's; the tail panels' maps last (empty
// but at d 80), so the other widths' kernels keep their SASS
template <int D, bool NARROW>
__global__ void __launch_bounds__(3 * kWG, 1)
    flash_bwd_i8_sm90_kernel(const __grid_constant__ CUtensorMap mq8,
                             const __grid_constant__ CUtensorMap mdo8,
                             const __grid_constant__ CUtensorMap mk8,
                             const __grid_constant__ CUtensorMap mv8,
                             const __grid_constant__ CUtensorMap mkb,
                             const __grid_constant__ CUtensorMap nk8,
                             const __grid_constant__ CUtensorMap nv8,
                             const __grid_constant__ CUtensorMap nq8,
                             const __grid_constant__ CUtensorMap ndo8,
                             const __grid_constant__ CUtensorMap nqb,
                             const __grid_constant__ CUtensorMap ndob,
                             const BwdI8Params p,
                             const __grid_constant__ TailMaps<D, 11> tails) {
  extern __shared__ char smem_raw[];
  const int gq = (p.Nq + DqShape<D>::BM - 1) / DqShape<D>::BM;
  if ((int)blockIdx.x < gq)
    dq_pass_i8<D, NARROW>(mq8, mdo8, mk8, mv8, mkb, tails, p, blockIdx.x,
                          smem_raw);
  else
    dkv_pass_i8<D, NARROW>(nk8, nv8, nq8, ndo8, nqb, ndob, tails, p,
                           blockIdx.x - gq, smem_raw);
}

// the int8 codes at the instantiation's code width Codes<D>::W, the bf16
// k, q and do at the real width p.D (the note at the top)
template <int D, bool NARROW>
cudaError_t launch_i8(const BwdI8Params& p, int B, int BH,
                      cudaStream_t stream) {
  using Sq = DqShape<D>;
  using Sk = DkvShape<D>;
  using Tq = BwdI8Tiles<D, Sq::BM, Sq::BN, 1, 0>;
  using Tk = BwdI8Tiles<D, Sk::BN, Sk::BQ, 2, Sk::AUX>;
  constexpr int W = Codes<D>::W;
  CUtensorMap mq8, mdo8, mk8, mv8, mkb, nk8, nv8, nq8, ndo8, nqb, ndob;
  const struct {
    CUtensorMap* map;
    const char* base;
    int n, rows;
    long long sb, sn, sh;
    bool i8;
  } maps[11] = {
      {&mq8, p.q8, p.Nq, Sq::BM, p.q8_sb, p.q8_sn, p.q8_sh, true},
      {&mdo8, p.do8, p.Nq, Sq::BM, p.o8_sb, p.o8_sn, p.o8_sh, true},
      {&mk8, p.k8, p.Nk, Sq::BN, p.k8_sb, p.k8_sn, p.k8_sh, true},
      {&mv8, p.v8, p.Nk, Sq::BN, p.v8_sb, p.v8_sn, p.v8_sh, true},
      {&mkb, p.kbf, p.Nk, Sq::BN, p.kb_sb, p.kb_sn, p.kb_sh, false},
      {&nk8, p.k8, p.Nk, Sk::BN, p.k8_sb, p.k8_sn, p.k8_sh, true},
      {&nv8, p.v8, p.Nk, Sk::BN, p.v8_sb, p.v8_sn, p.v8_sh, true},
      {&nq8, p.q8, p.Nq, Sk::BQ, p.q8_sb, p.q8_sn, p.q8_sh, true},
      {&ndo8, p.do8, p.Nq, Sk::BQ, p.o8_sb, p.o8_sn, p.o8_sh, true},
      {&nqb, p.qbf, p.Nq, Sk::BQ, p.qb_sb, p.qb_sn, p.qb_sh, false},
      {&ndob, p.dobf, p.Nq, Sk::BQ, p.ob_sb, p.ob_sn, p.ob_sh, false}};
  for (const auto& m : maps) {
    cudaError_t err =
        m.i8 ? make_map_i8(m.map, m.base, B, m.n, p.H, W, m.sb, m.sn, m.sh,
                           m.rows)
             : make_map_head(m.map, m.base, B, m.n, p.H, p.D, m.sb, m.sn,
                             m.sh, m.rows);
    if (err != cudaSuccess) return err;
  }
  TailMaps<D, 11> tails;  // at d 80: the same eleven for the tail panels
  if constexpr (Codes<D>::TAIL) {
    for (int i = 0; i < 11; ++i) {
      const auto& m = maps[i];
      cudaError_t err =
          m.i8 ? make_map_i8_tail(&tails.m[i], m.base, B, m.n, p.H, W, m.sb,
                                  m.sn, m.sh, m.rows)
               : make_map_tail(&tails.m[i], m.base, B, m.n, p.H, p.D, m.sb,
                               m.sn, m.sh, m.rows);
      if (err != cudaSuccess) return err;
    }
  }
  auto kernel = flash_bwd_i8_sm90_kernel<D, NARROW>;
  const int bytes = Tq::BYTES > Tk::BYTES ? Tq::BYTES : Tk::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int gq = (p.Nq + Sq::BM - 1) / Sq::BM;
  const int gk = (p.Nk + Sk::BN - 1) / Sk::BN;
  kernel<<<dim3(gq + gk, BH), 3 * kWG, bytes, stream>>>(
      mq8, mdo8, mk8, mv8, mkb, nk8, nv8, nq8, ndo8, nqb, ndob, p, tails);
  return cudaGetLastError();
}

}  // namespace

#if !defined(SMB_FLASH_BWD_I8_NARROW) && !defined(SMB_FLASH_BWD_D80) && \
    !defined(SMB_FLASH_BWD_I8_D80)

// K4's d-80 tiles, compiled apart in flash_bwd_d80.cu (below, under
// SMB_FLASH_BWD_D80)
extern "C" int smb_flash_bwd_d80(const void* params, int B, int BH,
                                 void* stream);

// q, k, v, dout, dq, dk, dv: bf16 (B, N, H, D), D a multiple of 8 up to
// 128 (run on the instantiation of the next of 32, 64, 80 and 128 up),
// through strides; strides: 21 int64 in elements, (batch, token, head) for
// q, k, v, dout, dq, dk, dv (q, k, v and dout are read by TMA: base
// pointers and strides 16-byte multiples).
// lse2 and delta: f32 (B, H, Nq), contiguous. scale_log2 = scale*log2(e)
// as the forward took it. Launches the dq and dk/dv passes, in one grid,
// on `stream`. Returns a cudaError_t (0 on success).
extern "C" int smb_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int B, int H, int Nq, int Nk, int D,
                             const long long* strides, float scale,
                             float scale_log2, void* stream) {
  BwdParams p;
  p.q = static_cast<const char*>(q);
  p.k = static_cast<const char*>(k);
  p.v = static_cast<const char*>(v);
  p.dout = static_cast<const char*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sn = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_sh = strides[11];
  p.dq_sb = strides[12]; p.dq_sn = strides[13]; p.dq_sh = strides[14];
  p.dk_sb = strides[15]; p.dk_sn = strides[16]; p.dk_sh = strides[17];
  p.dv_sb = strides[18]; p.dv_sn = strides[19]; p.dv_sh = strides[20];
  p.scale = scale;
  p.scale_log2 = scale_log2;  // as the forward's, so p matches its lse2
  p.D = D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (Nq <= 0 || Nk <= 0 || BH <= 0 || BH > 65535 || D <= 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 32) return (int)launch_width<32>(p, B, BH, s);
  if (D <= 64) return (int)launch_width<64>(p, B, BH, s);
  if (D <= 80) return smb_flash_bwd_d80(&p, B, BH, stream);
  if (D <= 128) return (int)launch_width<128>(p, B, BH, s);
  return (int)cudaErrorInvalidValue;
}

// K7's instantiations for heads narrower than their width and on the d-80
// tiles, compiled apart in flash_bwd_i8_narrow.cu and flash_bwd_i8_d80.cu
// (below, under SMB_FLASH_BWD_I8_NARROW and SMB_FLASH_BWD_I8_D80)
extern "C" int smb_flash_bwd_i8_narrow(const void* params, int B, int BH,
                                       void* stream);
extern "C" int smb_flash_bwd_i8_d80(const void* params, int B, int BH,
                                    void* stream);

// K7. D, the head width, a multiple of 8 up to 128, runs on the
// instantiation of width DI, the next of 32, 64, 80 and 128 up. q8, k8,
// v8, do8: int8 (B, N, H, W), W the code width of DI (32, 64, 96 or 128),
// codes past D zero; kbf, qbf, dobf: the bf16 k,
// q and do; dq, dk, dv: bf16 (B, N, H, D); all through strides: 30 int64 in
// elements, (batch, token, head) for q8, k8, v8, do8, kbf, qbf, dobf, dq,
// dk, dv (the seven inputs are read by TMA: base pointers and strides
// 16-byte multiples). lse2 and delta: f32 (B, H, Nq), contiguous; sqk =
// sq*sk and sdv = sdo*sv: f32 (B*H). Launches the dq and dk/dv passes, in
// one grid, on `stream`. Returns a cudaError_t (0 on success).
extern "C" int smb_flash_bwd_i8(const void* q8, const void* k8,
                                const void* v8, const void* do8,
                                const void* kbf, const void* qbf,
                                const void* dobf, const void* lse,
                                const void* delta, const void* sqk,
                                const void* sdv, void* dq, void* dk, void* dv,
                                int B, int H, int Nq, int Nk, int D,
                                const long long* strides, float scale,
                                void* stream) {
  BwdI8Params p;
  p.q8 = static_cast<const char*>(q8);
  p.k8 = static_cast<const char*>(k8);
  p.v8 = static_cast<const char*>(v8);
  p.do8 = static_cast<const char*>(do8);
  p.kbf = static_cast<const char*>(kbf);
  p.qbf = static_cast<const char*>(qbf);
  p.dobf = static_cast<const char*>(dobf);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.sqk = static_cast<const float*>(sqk);
  p.sdv = static_cast<const float*>(sdv);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.q8_sb = strides[0]; p.q8_sn = strides[1]; p.q8_sh = strides[2];
  p.k8_sb = strides[3]; p.k8_sn = strides[4]; p.k8_sh = strides[5];
  p.v8_sb = strides[6]; p.v8_sn = strides[7]; p.v8_sh = strides[8];
  p.o8_sb = strides[9]; p.o8_sn = strides[10]; p.o8_sh = strides[11];
  p.kb_sb = strides[12]; p.kb_sn = strides[13]; p.kb_sh = strides[14];
  p.qb_sb = strides[15]; p.qb_sn = strides[16]; p.qb_sh = strides[17];
  p.ob_sb = strides[18]; p.ob_sn = strides[19]; p.ob_sh = strides[20];
  p.dq_sb = strides[21]; p.dq_sn = strides[22]; p.dq_sh = strides[23];
  p.dk_sb = strides[24]; p.dk_sn = strides[25]; p.dk_sh = strides[26];
  p.dv_sb = strides[27]; p.dv_sn = strides[28]; p.dv_sh = strides[29];
  p.scale = scale;
  p.D = D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (Nq <= 0 || Nk <= 0 || BH <= 0 || BH > 65535 || D <= 0 || D % 8 != 0 ||
      D > 128)
    return (int)cudaErrorInvalidValue;
  if (D == 32) return (int)launch_i8<32, false>(p, B, BH, s);
  if (D == 64) return (int)launch_i8<64, false>(p, B, BH, s);
  if (D == 128) return (int)launch_i8<128, false>(p, B, BH, s);
  if (D > 64 && D <= 80) return smb_flash_bwd_i8_d80(&p, B, BH, stream);
  return smb_flash_bwd_i8_narrow(&p, B, BH, stream);
}

#elif defined(SMB_FLASH_BWD_I8_NARROW)  // flash_bwd_i8_narrow.cu

// K7 for a head narrower than its instantiation (NARROW); params: the
// BwdI8Params that smb_flash_bwd_i8 filled, D a multiple of 8 below 128
// but 32, 64, 72 and 80
extern "C" int smb_flash_bwd_i8_narrow(const void* params, int B, int BH,
                                       void* stream) {
  const BwdI8Params& p = *static_cast<const BwdI8Params*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.D < 32) return (int)launch_i8<32, true>(p, B, BH, s);
  if (p.D < 64) return (int)launch_i8<64, true>(p, B, BH, s);
  return (int)launch_i8<128, true>(p, B, BH, s);
}

#elif defined(SMB_FLASH_BWD_D80)  // flash_bwd_d80.cu

// K4 on the d-80 tiles; params: the BwdParams that smb_flash_bwd filled,
// D 72 or 80 (the NARROW instantiation stores 72 columns)
extern "C" int smb_flash_bwd_d80(const void* params, int B, int BH,
                                 void* stream) {
  const BwdParams& p = *static_cast<const BwdParams*>(params);
  return (int)launch_width<80>(p, B, BH, static_cast<cudaStream_t>(stream));
}

#else  // flash_bwd_i8_d80.cu

// K7 on the d-80 tiles (codes of 96 bytes); params: the BwdI8Params that
// smb_flash_bwd_i8 filled, D 72 or 80 (the NARROW instantiation stores 72
// columns)
extern "C" int smb_flash_bwd_i8_d80(const void* params, int B, int BH,
                                    void* stream) {
  const BwdI8Params& p = *static_cast<const BwdI8Params*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.D == 80 ? (int)launch_i8<80, false>(p, B, BH, s)
                   : (int)launch_i8<80, true>(p, B, BH, s);
}

#endif
