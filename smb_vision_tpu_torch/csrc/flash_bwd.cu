// Flash-attention backward for Hopper (sm_90a): bf16 (K4) on wgmma, TMA and
// warp specialisation, and with int8 score recompute (K7, below K4) on
// mma.sync.
//
// Replaces
//   K4  smb_vision_tpu/ops/attention.py:_bwd_dq_kernel and _bwd_dkv_kernel
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
// tile), in one grid (K4) or two (K7). The TPU kernel accumulated dq^T and dk^T transposed and pre-scaled
// q by c; both were MXU choices and are not carried over.
//
// K4. Bound on the H100: the least work is 10*N^2*d flops per head (s, dp
// and the three products dq, dk, dv) against O(N*d) bytes, so the tensor
// cores are the limit, not device memory; the two passes recompute s and dp
// each, 14*N^2*d in all. The design follows K1 (flash_fwd.cu):
//   - warpgroup 0 is the producer: one thread issues TMA loads of the
//     block's own rows (q and do in the dq pass, k and v in the dk/dv pass)
//     once, and of the streamed pair (k, v in tiles of 64 keys; q, do in
//     tiles of 64 queries at d = 64, 32 at d = 128) through a ring of 4
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"
#include "sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBR = 16 * kWarps;  // rows a K7 block owns (queries or keys)

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
};

constexpr int kStages = 4;

// shared memory of a pass: the block's own two operands (ROWS rows each),
// a ring of kStages stages of the streamed pair (BT rows each), AUX bytes
// of lse2 and delta a stage, and the barriers
template <int D, int ROWS, int BT, int AUX>
struct BwdTiles {
  static constexpr int PANELS = D / 64;             // 64-column panels
  static constexpr int OWN = PANELS * ROWS * 128;   // one own operand
  static constexpr int TILE = PANELS * BT * 128;    // one streamed operand
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BARS = (2 * kStages + 1) * 8;
  static constexpr int BYTES =
      1024 + 2 * OWN + kStages * (STAGE + AUX) + BARS;
};

// the K-major descriptor of k-step kk (16 columns) of rows row0.. of a
// tile of `rows` rows at shared address a
__device__ __forceinline__ uint64_t kmajor(uint32_t a, int rows, int row0,
                                           int kk) {
  return desc_sw128(a + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32);
}

// dq pass: block bx owns 128 query rows of one (batch, head)
template <int D>
struct DqShape {
  static constexpr int BM = 128;  // query rows a block owns
  static constexpr int BN = 64;   // keys of a tile
};

template <int D>
__device__ __forceinline__ void dq_pass(const CUtensorMap& tq,
                                        const CUtensorMap& tdo,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const BwdParams& p, int bx,
                                        char* smem_raw) {
  constexpr int BM = DqShape<D>::BM, BN = DqShape<D>::BN, ST = kStages;
  using T = BwdTiles<D, BM, BN, 0>;
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
        tma_load_4d(qs + pn * BM * 128, &tq, own, pn * 64, h, q0, b);
        tma_load_4d(qs + T::OWN + pn * BM * 128, &tdo, own, pn * 64, h, q0,
                    b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE);
        char* ks = ring + s * T::STAGE;
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          tma_load_4d(ks + pn * BN * 128, &tk, &full[s], pn * 64, h, it * BN,
                      b);
          tma_load_4d(ks + T::TILE + pn * BN * 128, &tv, &full[s], pn * 64, h,
                      it * BN, b);
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
        wgmma_ss<BN, 0>(s, kmajor(qa, BM, cw * 64, kk),
                        kmajor(ka, BN, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, 0>(dp, kmajor(doa, BM, cw * 64, kk),
                        kmajor(va, BN, 0, kk), kk > 0);
    };
    auto issue_dq = [&](int it) {  // dq += ds k over the tile's keys
      const uint32_t ka = ra + (it % ST) * T::STAGE;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D, 1>(acc, dsa[kk], desc_sw128(ka + kk * 2048, BN * 128), 1);
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
                 p.Nq, t);
  }
}

// dk/dv pass: a block owns 128 kv rows of one (batch, head); s and dp are
// computed transposed (rows = keys, columns = queries)
template <int D>
struct DkvShape {
  static constexpr int BN = 128;                 // kv rows a block owns
  static constexpr int BQ = D == 64 ? 64 : 32;   // queries of a tile
  static constexpr int AUX = 2 * BQ * 4;         // lse2 and delta
};

template <int D>
__device__ __forceinline__ void dkv_pass(const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         const CUtensorMap& tq,
                                         const CUtensorMap& tdo,
                                         const BwdParams& p, int bx,
                                         char* smem_raw) {
  using Sh = DkvShape<D>;
  constexpr int BN = Sh::BN, BQ = Sh::BQ, ST = kStages;
  using T = BwdTiles<D, BN, BQ, Sh::AUX>;
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
          tma_load_4d(ks + pn * BN * 128, &tk, own, pn * 64, h, k0, b);
          tma_load_4d(ks + T::OWN + pn * BN * 128, &tv, own, pn * 64, h, k0,
                      b);
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
            tma_load_4d(qt + pn * BQ * 128, &tq, &full[s], pn * 64, h,
                        it * BQ, b);
            tma_load_4d(qt + T::TILE + pn * BQ * 128, &tdo, &full[s], pn * 64,
                        h, it * BQ, b);
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
        wgmma_ss<BQ, 0>(st, kmajor(ka, BN, cw * 64, kk),
                        kmajor(qt, BQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(dpt, kmajor(va, BN, cw * 64, kk),
                        kmajor(dot, BQ, 0, kk), kk > 0);
    };
    // dv += p^T do, dk += ds^T q over the tile's queries
    auto issue_dkv = [&](int it) {
      const uint32_t qt = ra + (it % ST) * T::STAGE, dot = qt + T::TILE;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dv, pa[kk], desc_sw128(dot + kk * 2048, BQ * 128), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dk, da[kk], desc_sw128(qt + kk * 2048, BQ * 128), 1);
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
                 p.Nk, t);
    store_acc<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, dv, 1.f, r0,
                 p.Nk, t);
  }
}

// One grid runs both passes: the first ceil(Nq / 128) blocks of each
// (batch, head) row the dq pass, the rest the dk/dv pass. They share no
// data, and one grid of both keeps the card full where each pass alone
// would end on a part-filled wave.
template <int D>
__global__ void __launch_bounds__(3 * kWG, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mdo,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap nk,
                          const __grid_constant__ CUtensorMap nv,
                          const __grid_constant__ CUtensorMap nq,
                          const __grid_constant__ CUtensorMap ndo,
                          const BwdParams p) {
  extern __shared__ char smem_raw[];
  const int gq = (p.Nq + DqShape<D>::BM - 1) / DqShape<D>::BM;
  if ((int)blockIdx.x < gq)
    dq_pass<D>(mq, mdo, mk, mv, p, blockIdx.x, smem_raw);
  else
    dkv_pass<D>(nk, nv, nq, ndo, p, blockIdx.x - gq, smem_raw);
}

template <int D>
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
    cudaError_t err = make_map(m.map, m.base, B, m.n, p.H, D, m.sb, m.sn,
                               m.sh, m.rows);
    if (err != cudaSuccess) return err;
  }
  auto kernel = flash_bwd_sm90_kernel<D>;
  const int bytes = Tq::BYTES > Tk::BYTES ? Tq::BYTES : Tk::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int gq = (p.Nq + Sq::BM - 1) / Sq::BM;
  const int gk = (p.Nk + Sk::BN - 1) / Sk::BN;
  kernel<<<dim3(gq + gk, BH), 3 * kWG, bytes, stream>>>(mq, mdo, mk, mv, nk,
                                                         nv, nq, ndo, p);
  return cudaGetLastError();
}

// ---- mma.sync helpers of K7 ------------------------------------------------

// out (16 x D) += P (16 x BT, f32 C fragments, rounded to bf16 here) . T,
// with T the (BT, D) row-major tile in shared memory: one ldmatrix.x4.trans
// brings the B fragments of two n8 tiles for one 16-row k-step
template <int D, int NS, int ROW>
__device__ __forceinline__ void col_products(float (&out)[D / 8][4],
                                             const float (&pm)[NS][4],
                                             const char* tile, int lane) {
#pragma unroll
  for (int c = 0; c < NS / 2; ++c) {
    const uint32_t pa[4] = {pack_bf16(pm[2 * c][0], pm[2 * c][1]),
                            pack_bf16(pm[2 * c][2], pm[2 * c][3]),
                            pack_bf16(pm[2 * c + 1][0], pm[2 * c + 1][1]),
                            pack_bf16(pm[2 * c + 1][2], pm[2 * c + 1][3])};
    const char* row =
        tile + (c * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
        (lane >> 4) * 16;
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, row + n * 16);
      mma_bf16(out[n], pa, bf[0], bf[1]);
      mma_bf16(out[n + 1], pa, bf[2], bf[3]);
    }
  }
}

// bf16 store of a 16 x D accumulator (rows r0, r0 + 8) times `mul`
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long row_stride,
                                           const float (&acc)[D / 8][4],
                                           float mul, int r0, int n, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r0 * row_stride +
                                         col) =
          __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(
          base + (long long)(r0 + 8) * row_stride + col) =
          __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// ---------------------------------------------------------------------------
// K7: the int8-score backward.
//
// Replaces
//   K7  smb_vision_tpu/ops/attention.py:_bwd_dq_i8_kernel and
//       _bwd_dkv_i8_kernel (attn_impl "pallas_i8bwd")
//
// K4 with the two recomputed products on int8: from per-(batch, head)
// symmetric quantisations q8 (of q*scale*log2(e)), k8, v8, do8 and their
// scales, made in plain torch before the launch,
//   s_ij  = (q8_i . k8_j) * sqk       sqk = sq*sk (log2 units)
//   dp_ij = (do8_i . v8_j) * sdv      sdv = sdo*sv
// on mma.sync m16n8k32 s8 with int32 sums (exact), then as K4:
//   p = exp2(s - lse2), ds = bf16(p (dp - delta)),
//   dq = scale ds k, dk = scale ds^T q, dv = bf16(p)^T do
// with k, q, do in bf16 and f32 accumulation. Every int8 product contracts
// over d, which is contiguous, so plain ldmatrix of the int8 tiles gives
// the B fragments; the s32 C fragment of m16n8k32 has the thread layout of
// the f32 C fragment of m16n8k16, so p and ds become the A operands of the
// bf16 products in registers as in K4. The int8 A operands take half of
// K4's registers, which pays for the bf16 tile streamed beside the int8
// ones (k in the dq pass; q and do in the dk/dv pass).
// Ragged lengths as in K4: streamed int8 and bf16 rows past their length
// are zero-filled; kv columns past Nk get p = 0 in the dq pass; query
// columns past Nq have lse2 = +inf and delta = 0 in the dk/dv pass.

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
};

// streamed tile rows as K4's; a stage holds the dq pass's k8, v8 and bf16
// k, or the dk/dv pass's q8, do8 and bf16 q and do
template <int D, bool DQ>
struct TilesI8 {
  static constexpr int BT = DQ ? 64 : (D <= 64 ? 64 : 32);
  static constexpr int ROW8 = D + 16;       // padded int8 row, bytes
  static constexpr int ROW16 = D * 2 + 16;  // padded bf16 row, bytes
  static constexpr int STAGE =
      DQ ? BT * (2 * ROW8 + ROW16) : 2 * BT * (ROW8 + ROW16);
  static constexpr int AUX = DQ ? 0 : 2 * BT * 4;  // lse2 and delta
  static constexpr int BYTES = 2 * (STAGE + AUX);
};

// A fragments (m16n8k32 s8) of rows r0 and r0 + 8 of a (rows, D) int8
// operand, straight from global memory; rows at or past n load as zero
template <int D>
__device__ __forceinline__ void load_a8(uint32_t (&a)[D / 32][4],
                                        const char* base,
                                        long long row_stride, int r0, int n,
                                        int t) {
  const char* p0 = base + (long long)r0 * row_stride;
  const char* p1 = base + (long long)(r0 + 8) * row_stride;
  const bool v0 = r0 < n, v1 = r0 + 8 < n;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int c0 = kk * 32 + 4 * t;  // a k-step is 32 bytes
    a[kk][0] = v0 ? ld32(p0 + c0) : 0u;
    a[kk][1] = v1 ? ld32(p1 + c0) : 0u;
    a[kk][2] = v0 ? ld32(p0 + c0 + 16) : 0u;
    a[kk][3] = v1 ? ld32(p1 + c0 + 16) : 0u;
  }
}

// acc[j] = (A (16 x D int8) . T^T) * mul per n8 tile j of a BT-row int8
// tile T in shared memory: exact int32 sums, converted once. One
// ldmatrix.x4 brings the B fragments of two k-steps (64 bytes of a row)
template <int D, int NS, int ROW>
__device__ __forceinline__ void row_products_s8(float (&acc)[NS][4],
                                                const uint32_t (&a)[D / 32][4],
                                                const char* tile, float mul,
                                                int lane) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    int c[4] = {0, 0, 0, 0};
    const char* row = tile + (j * 8 + (lane & 7)) * ROW + (lane >> 3) * 16;
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) {
      uint32_t bf[4];
      ldsm_x4(bf, row + hh * 64);
      mma_s8(c, a[2 * hh], bf[0], bf[1]);
      mma_s8(c, a[2 * hh + 1], bf[2], bf[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = (float)c[i] * mul;
  }
}

// stage rows r0 .. r0 + BT of one operand (RB bytes a row, rows sn_bytes
// apart in global memory) into shared memory rows ROW bytes apart
template <int RB, int BT, int ROW>
__device__ __forceinline__ void load_rows(char* dst, const char* src,
                                          long long sn_bytes, int r0, int n,
                                          int tid) {
  constexpr int CH = RB / 16;  // 16-byte chunks per row
  for (int c = tid; c < BT * CH; c += kThreads) {
    const int row = c / CH, col = (c % CH) * 16;
    const bool ok = r0 + row < n;
    cp_async16(dst + row * ROW + col,
               ok ? src + (long long)(r0 + row) * sn_bytes + col : src,
               ok ? 16 : 0);
  }
}

// dq pass: a block owns kBR query rows of one (batch, head)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_i8_dq_kernel(const BwdI8Params p) {
  using T = TilesI8<D, true>;
  constexpr int BT = T::BT;
  constexpr int NS = BT / 8;
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int r0 = blockIdx.x * kBR + warp * 16 + g;

  const char* k8b = p.k8 + b * p.k8_sb + h * p.k8_sh;
  const char* v8b = p.v8 + b * p.v8_sb + h * p.v8_sh;
  const char* kfb = p.kbf + (b * p.kb_sb + h * p.kb_sh) * 2;
  auto load_tile = [&](int stage, int kv0) {
    char* s0 = smem + stage * T::STAGE;
    load_rows<D, BT, T::ROW8>(s0, k8b, p.k8_sn, kv0, p.Nk, tid);
    load_rows<D, BT, T::ROW8>(s0 + BT * T::ROW8, v8b, p.v8_sn, kv0, p.Nk,
                              tid);
    load_rows<2 * D, BT, T::ROW16>(s0 + 2 * BT * T::ROW8, kfb,
                                   p.kb_sn * 2, kv0, p.Nk, tid);
    cp_async_commit();
  };
  load_tile(0, 0);

  uint32_t qa[D / 32][4], da[D / 32][4];
  load_a8<D>(qa, p.q8 + b * p.q8_sb + h * p.q8_sh, p.q8_sn, r0, p.Nq, t);
  load_a8<D>(da, p.do8 + b * p.o8_sb + h * p.o8_sh, p.o8_sn, r0, p.Nq, t);
  const float* lb = p.lse + (long long)bh * p.Nq;
  const float* db = p.delta + (long long)bh * p.Nq;
  const float lse0 = r0 < p.Nq ? lb[r0] : 0.f;
  const float lse1 = r0 + 8 < p.Nq ? lb[r0 + 8] : 0.f;
  const float dl0 = r0 < p.Nq ? db[r0] : 0.f;
  const float dl1 = r0 + 8 < p.Nq ? db[r0 + 8] : 0.f;
  const float cqk = p.sqk[bh], cdv = p.sdv[bh];

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (p.Nk + BT - 1) / BT;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile((it + 1) & 1, (it + 1) * BT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const char* k8s = smem + (it & 1) * T::STAGE;
    const char* v8s = k8s + BT * T::ROW8;
    const char* kfs = k8s + 2 * BT * T::ROW8;
    const int kv0 = it * BT;

    float s[NS][4], dp[NS][4];
    row_products_s8<D, NS, T::ROW8>(s, qa, k8s, cqk, lane);
    row_products_s8<D, NS, T::ROW8>(dp, da, v8s, cdv, lane);
    // ds = p (dp - delta), p = exp2(s - lse2); kv columns past Nk -> 0
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lse = i < 2 ? lse0 : lse1, dl = i < 2 ? dl0 : dl1;
        float pv = ex2(s[j][i] - lse);
        if (kv0 + j * 8 + 2 * t + (i & 1) >= p.Nk) pv = 0.f;
        s[j][i] = pv * (dp[j][i] - dl);
      }
    }
    // dq += ds k (ds rounded to bf16 in col_products)
    col_products<D, NS, T::ROW16>(acc, s, kfs, lane);
    __syncthreads();  // every warp is done with this stage
  }
  store_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, acc, p.scale, r0,
                p.Nq, t);
}

// dk/dv pass: a block owns kBR kv rows of one (batch, head); scores and dp
// are computed transposed (rows = keys, columns = queries)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_i8_dkv_kernel(const BwdI8Params p) {
  using T = TilesI8<D, false>;
  constexpr int BT = T::BT;
  constexpr int NS = BT / 8;
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int r0 = blockIdx.x * kBR + warp * 16 + g;  // this thread's keys

  const char* q8b = p.q8 + b * p.q8_sb + h * p.q8_sh;
  const char* o8b = p.do8 + b * p.o8_sb + h * p.o8_sh;
  const char* qfb = p.qbf + (b * p.qb_sb + h * p.qb_sh) * 2;
  const char* ofb = p.dobf + (b * p.ob_sb + h * p.ob_sh) * 2;
  const float* lb = p.lse + (long long)bh * p.Nq;
  const float* db = p.delta + (long long)bh * p.Nq;
  float* aux = reinterpret_cast<float*>(smem + 2 * T::STAGE);

  // stage query rows q0 .. q0 + BT: q8, do8, q and do by cp.async; lse2
  // and delta by plain loads (+inf and 0 past Nq, so those columns give
  // p = ds = 0)
  auto load_tile = [&](int stage, int q0) {
    char* s0 = smem + stage * T::STAGE;
    load_rows<D, BT, T::ROW8>(s0, q8b, p.q8_sn, q0, p.Nq, tid);
    load_rows<D, BT, T::ROW8>(s0 + BT * T::ROW8, o8b, p.o8_sn, q0, p.Nq,
                              tid);
    load_rows<2 * D, BT, T::ROW16>(s0 + 2 * BT * T::ROW8, qfb, p.qb_sn * 2,
                                   q0, p.Nq, tid);
    load_rows<2 * D, BT, T::ROW16>(s0 + 2 * BT * T::ROW8 + BT * T::ROW16,
                                   ofb, p.ob_sn * 2, q0, p.Nq, tid);
    if (tid < BT) {
      const bool ok = q0 + tid < p.Nq;
      aux[stage * 2 * BT + tid] = ok ? lb[q0 + tid] : INFINITY;
      aux[stage * 2 * BT + BT + tid] = ok ? db[q0 + tid] : 0.f;
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  uint32_t ka[D / 32][4], va[D / 32][4];
  load_a8<D>(ka, p.k8 + b * p.k8_sb + h * p.k8_sh, p.k8_sn, r0, p.Nk, t);
  load_a8<D>(va, p.v8 + b * p.v8_sb + h * p.v8_sh, p.v8_sn, r0, p.Nk, t);
  const float cqk = p.sqk[bh], cdv = p.sdv[bh];

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  const int ntiles = (p.Nq + BT - 1) / BT;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile((it + 1) & 1, (it + 1) * BT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const char* q8s = smem + (it & 1) * T::STAGE;
    const char* o8s = q8s + BT * T::ROW8;
    const char* qfs = q8s + 2 * BT * T::ROW8;
    const char* ofs = qfs + BT * T::ROW16;
    const float* ls = aux + (it & 1) * 2 * BT;
    const float* ds = ls + BT;

    float st[NS][4], dpt[NS][4];
    row_products_s8<D, NS, T::ROW8>(st, ka, q8s, cqk, lane);   // s^T
    row_products_s8<D, NS, T::ROW8>(dpt, va, o8s, cdv, lane);  // dp^T
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = j * 8 + 2 * t;
      const float l0 = ls[col], l1 = ls[col + 1];
      const float d0 = ds[col], d1 = ds[col + 1];
      st[j][0] = ex2(st[j][0] - l0);
      st[j][1] = ex2(st[j][1] - l1);
      st[j][2] = ex2(st[j][2] - l0);
      st[j][3] = ex2(st[j][3] - l1);
      dpt[j][0] = st[j][0] * (dpt[j][0] - d0);
      dpt[j][1] = st[j][1] * (dpt[j][1] - d1);
      dpt[j][2] = st[j][2] * (dpt[j][2] - d0);
      dpt[j][3] = st[j][3] * (dpt[j][3] - d1);
    }
    col_products<D, NS, T::ROW16>(dv, st, ofs, lane);   // dv += p^T do
    col_products<D, NS, T::ROW16>(dk, dpt, qfs, lane);  // dk += ds^T q
    __syncthreads();  // every warp is done with this stage
  }
  store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, dk, p.scale, r0,
                p.Nk, t);
  store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, dv, 1.f, r0,
                p.Nk, t);
}

template <int D>
cudaError_t launch_i8(const BwdI8Params& p, int BH, cudaStream_t stream) {
  auto dq = flash_bwd_i8_dq_kernel<D>;
  auto dkv = flash_bwd_i8_dkv_kernel<D>;
  const int bq = TilesI8<D, true>::BYTES, bkv = TilesI8<D, false>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, bq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bkv);
  if (err != cudaSuccess) return err;
  dq<<<dim3((p.Nq + kBR - 1) / kBR, BH), kThreads, bq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<dim3((p.Nk + kBR - 1) / kBR, BH), kThreads, bkv, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: bf16 (B, N, H, D) through strides; strides: 21
// int64 in elements, (batch, token, head) for q, k, v, dout, dq, dk, dv
// (q, k, v and dout are read by TMA: base pointers and strides 16-byte
// multiples).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (Nq <= 0 || Nk <= 0 || BH <= 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch<64>(p, B, BH, s);
  if (D == 128) return (int)launch<128>(p, B, BH, s);
  return (int)cudaErrorInvalidValue;
}

// K7. q8, k8, v8, do8: int8 (B, N, H, D); kbf, qbf, dobf: the bf16 k, q and
// do; dq, dk, dv: bf16 (B, N, H, D); all through strides: 30 int64 in
// elements, (batch, token, head) for q8, k8, v8, do8, kbf, qbf, dobf, dq,
// dk, dv. lse2 and delta: f32 (B, H, Nq), contiguous; sqk = sq*sk and
// sdv = sdo*sv: f32 (B*H). Launches the dq pass and the dk/dv pass on
// `stream`. Returns a cudaError_t (0 on success).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (Nq <= 0 || Nk <= 0 || BH <= 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch_i8<64>(p, BH, s);
  if (D == 128) return (int)launch_i8<128>(p, BH, s);
  return (int)cudaErrorInvalidValue;
}
