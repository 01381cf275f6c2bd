// Flash-attention forward for Hopper (sm_90a): bf16 scores (K1) and int8
// scores (K3) on wgmma, TMA and warp specialisation, one kernel template;
// int8 scores with int8 p v (K8) on the same design, a sibling kernel
// further down with its own note.
//
// Replaces
//   K1  smb_vision_tpu/ops/attention.py:_fwd_kernel      (bf16 flash forward)
//   K3  smb_vision_tpu/ops/attention.py:_fwd_i8_kernel   (pv=False: int8 q k^T)
//   K8  smb_vision_tpu/ops/attention.py:_fwd_i8_kernel   (pv=True: int8 p v too)
//
// What it computes, per (batch, head) and query row i:
//   s_ij = (q_i . k_j) * c          c = scale*log2(e)        (K1)
//   s_ij = (q8_i . k8_j) * c        c = sq*sk, q8 pre-scaled (K3)
//   o_i  = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i)
//   lse2_i = m_i + log2(sum_j exp2(s_ij - m_i))             (K1, optional)
// with an ordinary online softmax: m_i is a running max, rescaled per kv
// tile. The TPU kernels fixed the shift from the first kv block and
// accumulated o^T against [v | 1 | pad]; both were MXU tiling choices and
// are not carried over: the denominator is a plain row sum here (of p as
// computed in f32 for K1, of p rounded to bf16, as p v takes it, for K3).
//
// K1. Bound on the H100: at N = 20,480, d = 64 the kernel does 4*N^2*d
// flops per head against O(N*d) bytes of q, k, v, so device memory is never
// the limit: the tensor cores are (1.30 ms at 989 TFLOP/s, 12 heads), and
// at d = 64 the exp2 work is as long again (N^2*H = 5.0e9 ex2 at 16 a
// clock on each of 132 SMs is about 1.3 ms), so the two must overlap. The
// design (after FlashAttention-3, arXiv 2407.08608):
//   - a block owns 128 query rows of one (batch, head): warpgroup 0 is the
//     producer, of which one thread issues TMA loads (q once; k and v in
//     tiles of BN keys through a ring of 4 stages with full and empty
//     mbarriers; keys past Nk read as zero); warpgroups 1 and 2 are the
//     consumers, 64 query rows each; setmaxnreg moves registers from the
//     producer (40) to the consumers (232);
//   - S = Q K^T is a wgmma with both operands in shared memory (one read of
//     a k tile serves 64 rows, where mma.sync fed by ldmatrix read it per
//     16 rows); O += P V takes P from registers (the accumulator of S,
//     rounded to bf16, is the A fragment) and V as an MN-major operand, so
//     neither p nor a transposed v touches shared memory;
//   - inside a warpgroup, tile j+1's S wgmma is issued with tile j's P V
//     before tile j+1's softmax, which runs while the tensor cores work;
//     across the two warpgroups, named barriers take turns at issuing
//     (ping-pong), so one warpgroup's exp2 runs under the other's GEMMs;
//   - the running max m is kept raw and c is folded into the exp2's FFMA.
// Ragged lengths: q rows past Nq read as zero and are not stored; keys past
// Nk read as zero and their scores are masked to -inf.
// At d = 32 (the V-JEPA2 predictor's heads) a bf16 row is 64 bytes: q, k
// and v are one panel of 32 columns in the 64-byte swizzle (sm90.cuh), S
// takes two k16 steps and P V an N = 32 accumulator, with d 64's tiles
// (BN 128). The exp2 work is then twice the tensor work (N 9,216, 12
// heads: 0.13 ms at 989 TFLOP/s against ~0.27 ms of ex2), so the
// multi-function units bound it and the ping-pong matters more than at
// d 64: one warpgroup's exp2 runs under the other's GEMMs.
//
// Head widths past the instantiations. A head of width D (a multiple of 8
// up to 128; the wrapper pads any other by a copy, as the JAX `attention`
// does) runs on the instantiation of the next of its widths up (the
// template's D; the real width is p.D): K1's and K3's are 32, 64, 80 and
// 128, K8's 32, 64 and 128. It runs unchanged but for three things:
// the tensor maps of the bf16 operands (K1's q, k, v; K3's v) declare the
// real D as their global width while their boxes keep the instantiation's
// panels, so TMA reads the columns past D as zeros, as it reads the keys
// past Nk; the int8 codes of K3 and K8 (q8, k8, K8's v8) come from the
// quantisation kernel at the instantiation's code width with zeros past D
// (a row of 72 or 80 bytes has no TMA stride and no int8 swizzle: K3's
// d-80 tiles take rows of 96, K8's d-128 ones rows of 128); and only D
// columns of o are stored. The zero columns add nothing to any score or
// output column that is kept, so the kernel computes the function at D,
// with the tensor work of the instantiation: K8 at D 72 and 80 on the
// 128-wide tiles does 1.6 to 1.8 times what D needs. The store of the
// real width is an instantiation of its own (NARROW), so a head as wide as
// its instantiation runs the code it ran before the narrower widths came.
//
// K1 on tiles of 80 columns (heads of 72 and 80: SigLIP so400m, ViT-H).
// On the d-128 tiles these heads did 1.6 to 1.8 times the tensor work and
// took d 128's key tile, BN 64, so each barrier and each exp2 pass of a
// warpgroup covered half the keys it covers at d 64. The d-80 tiles
// (Panels<80>, sm90.cuh):
//   - a bf16 row of q, k or v is a 64-column panel in the 128-byte swizzle
//     and a 16-column tail panel (32-byte rows) in the 32-byte swizzle,
//     each loaded by a tensor map of its own (TailMaps: the tails' maps,
//     boxes of 16 columns at column 64; a head of 72 reads zeros past 72);
//   - s = q k^T takes 5 k16 steps, the fifth from the tail panels, in
//     place of 8; o += p v, whose N is the head, is an n64 wgmma on v's
//     64-column panel and an n16 one on its tail from the same A fragments
//     (an MN-major operand has no one descriptor across two swizzles), in
//     place of one n128;
//   - the key tile is d 64's, BN 128: q (20 KB) and 4 stages of k and v
//     (40 KB a stage) are 181 KB of the 227; a consumer thread holds o in
//     40 floats and s in 64 (d 64: 32 and 64).
// The bound is then d 64's in kind: the tensor work of 4*N^2*80 flops and
// the N^2*H exp2 stand in the ratio they have at d 64 times 1.25, so the
// two still overlap under the ping-pong. The d-80 instantiations compile
// in flash_fwd_d80.cu, beside no other kernel, so the kernels of the other
// widths keep their SASS.
//
// K3 on the same tiles of 80 columns (heads of 72 and 80; the d-128 ones
// did 1.6 to 1.8 times the tensor work, on d 128's key tile of 64). Its
// int8 codes are rows of 96 bytes (an int8 wgmma step is 32 bytes, 80 is
// 2 1/2 of them): q8 and k8 a 64-byte panel in the 64-byte swizzle and a
// 32-byte tail panel in the 32-byte one, each by a map of its own
// (make_map_i8, make_map_i8_tail; Codes<80>), so s = q8 k8^T takes 3 k32
// steps in place of 4; p v is K1 d80's, an n64 and an n16 wgmma on v's
// panel pair from the same P fragments. The key tile is BN 128: q8 (12 KB)
// and 4 stages of k8 (12 KB) and v (20 KB) are 141 KB of the 227. At N
// 20,480 with 16 heads the tensor work is 0.65 ms of int8 q8 k8^T over 96
// bytes and 1.09 ms of bf16 p v over 80 columns, 1.74 ms (2.61 on the
// d-128 tiles), beside the exp2 floor of 1.605 ms that K1 d80 shares: the
// exp2 now weighs as much as the products, and the ping-pong overlaps
// them. The d-80 instantiations compile in flash_fwd_i8_d80.cu.
//
// K3 is K1 with the score product on int8 (the I8 instantiation). Bound
// on the H100 at N = 20,480, 12 heads of 64: the int8 q8 k8^T at 1,979
// TOP/s (0.33 ms) and the bf16 p v at 989 TFLOP/s (0.65 ms), 0.98 ms of
// tensor work against the same 1.2-1.3 ms of exp2 as K1: the exp2 bounds
// it, so it cannot go far below K1. What changes against K1:
//   - S = q8 k8^T is wgmma m64nNk32 .s32.s8.s8 from shared memory, both
//     operands K-major (integer wgmma has no transpose; q8 and k8 are
//     contiguous along d). A q8 or k8 tile holds whole rows: at d 128 the
//     bytes of a bf16 panel (128-byte swizzle); at d 64 rows of 64 bytes
//     with the 64-byte swizzle (sm90.cuh), so q8 and k8 take half of K1's
//     shared memory and TMA traffic;
//   - the s32 scores x become the floats 1.5 * 2^23 + x exactly by one
//     integer add (|q8 . k8| <= 127^2 * 128 < 2^22): their max and their
//     differences are exact, and c = sq*sk folds into the exp2's FFMA as
//     K1's scale does. The conversion unit (I2F) runs at a quarter of the
//     FP32 rate, as slowly as the exp2 it would have to share the issue
//     slots with;
//   - no lse2; the row sums of p are taken of p as P V takes it, rounded to
//     bf16, on the tensor cores: each k16 step of P V also issues a wgmma
//     m64n8k16 of the same A fragments against 256 bytes of bf16 ones, so
//     every column of that small accumulator is the row's sum (as the TPU
//     kernel's [v | 1] column), rescaled with o. That takes K1's FADD per
//     score off the FP32 pipe and the quad shuffles off the epilogue.
// At d = 32 (the V-JEPA2 predictor's heads) K3's q8 and k8 rows are 32
// bytes, one k32 step with the 32-byte swizzle (sm90.cuh), and its P V is
// K1's d-32 bf16 product. A score then costs 64 int8 and 64 bf16 tensor
// operations against one exp2, so the exp2 floor bounds it (0.244 ms at N
// 9,216, 12 heads, beside 0.10 ms of tensor work) and it cannot run much
// below K1 at d 32; K8 at d 32 likewise (its p v an N = 32 int8 wgmma with
// p8 from registers, v8 a tile of 32 rows of BN = 128 keys).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

struct FlashParams {
  const char* q;
  const char* k;
  const char* v;
  const float* sq;  // int8 only: per (b*H + h) scales
  const float* sk;
  __nv_bfloat16* o;
  float* lse;  // may be null
  int H, Nq, Nk;
  // strides in elements: batch, token, head (the last dim is contiguous)
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  float scale_log2;
  int D;  // the real head width: D of the instantiation, or less (NARROW)
};

// ---------------------------------------------------------------------------
// K1 on wgmma (see the note at the top).

template <int D, bool I8>
struct FwdTiles {
  using P = Panels<D>;                           // bf16 panels (sm90.cuh)
  using C = Codes<D>;                            // K3's int8 code rows
  static constexpr int BM = 128;                 // query rows a block owns
  static constexpr int BN = D <= 80 ? 128 : 64;  // keys of a streamed tile
  static constexpr int STAGES = 4;
  static constexpr int PANELS = P::N;
  // bytes of a q or k row in its tile: a bf16 panel's row (K1), or the
  // whole int8 row (K3)
  static constexpr int QK_ROW = I8 ? D : P::ROW;
  static constexpr int Q_BYTES = I8 ? BM * C::W : BM * P::BYTES_ROW;
  static constexpr int K_BYTES = I8 ? BN * C::W : BN * P::BYTES_ROW;
  static constexpr int V_BYTES = BN * P::BYTES_ROW;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int ONES = I8 ? 256 : 0;  // K3: bf16 ones (desc_ones)
  static constexpr int BARS = (2 * STAGES + 1) * 8;
  static constexpr int BYTES = 1024 + Q_BYTES + STAGES * STAGE + ONES + BARS;
};

template <int D, bool I8, bool NARROW>
__global__ void __launch_bounds__(3 * kWG, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FlashParams p,
                          const __grid_constant__ TailMaps<D, 3> tails) {
  using T = FwdTiles<D, I8>;
  using P = typename T::P;
  constexpr int BM = T::BM, BN = T::BN, ST = T::STAGES;
  extern __shared__ char smem_raw[];
  char* qs = align1024(smem_raw);
  char* kv = qs + T::Q_BYTES;  // stage s: k panels, then v panels
  char* ones = kv + ST * T::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + T::ONES);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (p.Nk + BN - 1) / BN;
  if constexpr (I8) {
    if (threadIdx.x < T::ONES / 4) {
      reinterpret_cast<uint32_t*>(ones)[threadIdx.x] = 0x3F803F80u;
      fence_proxy_async();
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {  // producer warpgroup: one thread issues TMA
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_expect_tx(qbar, T::Q_BYTES);
      if constexpr (I8) {
        tma_load_4d(qs, &tq, qbar, 0, h, q0, b);
      } else {
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn)
          tma_load_4d(qs + pn * BM * P::ROW, &tq, qbar, pn * P::COLS, h, q0,
                      b);
      }
      // q's last 16 columns, or q8's last 32 bytes (k's, v's by stage;
      // the tails start at column, or byte, P::COLS = Codes::ROW = 64)
      if constexpr (P::TAIL)
        tma_load_4d(qs + BM * (I8 ? T::C::ROW : P::ROW), &tails.m[0], qbar,
                    P::COLS, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE);
        char* ks = kv + s * T::STAGE;
        if constexpr (I8) {
          tma_load_4d(ks, &tk, &full[s], 0, h, it * BN, b);
#pragma unroll
          for (int pn = 0; pn < T::PANELS; ++pn)
            tma_load_4d(ks + T::K_BYTES + pn * BN * P::ROW, &tv, &full[s],
                        pn * P::COLS, h, it * BN, b);
          if constexpr (P::TAIL) {  // k8's last 32 bytes, v's 16 columns
            tma_load_4d(ks + BN * T::C::ROW, &tails.m[1], &full[s],
                        T::C::ROW, h, it * BN, b);
            tma_load_4d(ks + T::K_BYTES + BN * P::ROW, &tails.m[2],
                        &full[s], P::COLS, h, it * BN, b);
          }
        } else {
#pragma unroll
          for (int pn = 0; pn < T::PANELS; ++pn) {
            tma_load_4d(ks + pn * BN * P::ROW, &tk, &full[s], pn * P::COLS,
                        h, it * BN, b);
            tma_load_4d(ks + T::K_BYTES + pn * BN * P::ROW, &tv, &full[s],
                        pn * P::COLS, h, it * BN, b);
          }
          if constexpr (P::TAIL) {
            tma_load_4d(ks + BN * P::ROW, &tails.m[1], &full[s], P::COLS, h,
                        it * BN, b);
            tma_load_4d(ks + T::K_BYTES + BN * P::ROW, &tails.m[2],
                        &full[s], P::COLS, h, it * BN, b);
          }
        }
      }
    }
  } else {  // consumer warpgroups cw = 0, 1: 64 query rows each
    reg_alloc<232>();
    const int cw = threadIdx.x / kWG - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows
    const float c = I8 ? p.sq[bh] * p.sk[bh] : p.scale_log2;
    // this warpgroup's q rows: from qa, or at d 80, whose tail panel lies
    // past the first panel's BM rows (q's or q8's), rows qrow.. of the
    // tile at qa
    const uint32_t qa = smem_u32(qs) + (P::TAIL ? 0 : cw * 64 * T::QK_ROW);
    const int qrow = P::TAIL ? cw * 64 : 0;
    const uint32_t kva = smem_u32(kv);

    // ping-pong: warpgroup cw issues its GEMMs between a sync on barrier
    // 1 + cw and an arrive on the other's; warpgroup 0 goes first, and
    // warpgroup 1 skips its last arrive so the counts balance
    auto turn_begin = [&]() { named_sync(1 + cw, kConsumers); };
    auto turn_end = [&](bool last) {
      if (!(last && cw == 1)) named_arrive(2 - cw, kConsumers);
    };
    if (cw == 1) named_arrive(1, kConsumers);

    float s[BN / 2], o[D / 2];
    uint32_t si[I8 ? BN / 2 : 1];  // K3: the s32 scores
    float ls[4] = {0.f, 0.f, 0.f, 0.f};  // K3: p's row sums, by wgmma
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    auto issue_s = [&](int it) {  // s = q k^T over d
      const uint32_t ka = kva + (it % ST) * T::STAGE;
      if constexpr (I8 && T::C::TAIL) {  // 3 k32 steps over the code rows
#pragma unroll
        for (int kk = 0; kk < T::C::STEPS; ++kk)
          wgmma_i8<BN>(si, desc_c96(qa, BM, qrow, kk),
                       desc_c96(ka, BN, 0, kk), kk > 0);
      } else if constexpr (I8) {
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          wgmma_i8<BN>(si, desc_i8<D>(qa, kk), desc_i8<D>(ka, kk), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BN, 0>(s, desc_k<D>(qa, BM, qrow, kk),
                          desc_k<D>(ka, BN, 0, kk), kk > 0);
      }
    };
    // after the wait on tile it's scores: K3's s32 scores x into s as the
    // floats 1.5 * 2^23 + x, exactly (|q8 . k8| <= 127^2 * 128 < 2^22), by
    // one integer add. Their max and differences are exact; the shift m c
    // of the exp2 is rounded once a row and tile, by less than c: less
    // than one unit of the integer scores, shared by the tile's row
    auto scores_in = [&]() {
      if constexpr (I8) {
        fence_regs(si);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          s[i] = __int_as_float((int)si[i] + 0x4B400000);
      } else {
        fence_regs(s);
      }
    };
    // o += p v over the tile's keys; K3 also ls += p 1, the row sums of p
    // as p v takes it (bf16), on the tensor cores
    auto issue_pv = [&](int it) {
      const uint32_t va = kva + (it % ST) * T::STAGE + T::K_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs_mn<D>(o, pa[kk], va, BN, kk);
        if constexpr (I8) wgmma_rs_n8(ls, pa[kk], desc_ones(smem_u32(ones)));
      }
    };
    // online softmax of tile it: s := p = exp2(s c - m c) (f32); returns
    // the rescale factors of the old rows in a0, a1 and (K1) their new sums
    auto softmax = [&](int it, float& a0, float& a1, float& rs0,
                       float& rs1) {
      const int kv0 = it * BN;
      if (kv0 + BN > p.Nk) {  // ragged kv tail
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + j * 8 + 2 * t + (e & 1) >= p.Nk) s[4 * j + e] = -INFINITY;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      a0 = ex2((m0 - mx0) * c);  // 0 on the first tile (m = -inf)
      a1 = ex2((m1 - mx1) * c);
      m0 = mx0;
      m1 = mx1;
      const float mc0 = m0 * c, mc1 = m1 * c;
      rs0 = 0.f;
      rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], c, -mc0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -mc0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -mc1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -mc1));
        if constexpr (!I8) {
          rs0 += s[4 * j] + s[4 * j + 1];
          rs1 += s[4 * j + 2] + s[4 * j + 3];
        }
      }
    };
    mbar_wait(qbar, 0);
    float a0, a1, rs0, rs1;
    // tile 0: its scores alone
    mbar_wait(&full[0], 0);
    turn_begin();
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<0>();
    scores_in();
    softmax(0, a0, a1, rs0, rs1);
    l0 = rs0;
    l1 = rs1;
    acc_to_a<BN>(pa, s);

    for (int it = 1; it < ntiles; ++it) {
      mbar_wait(&full[it % ST], (it / ST) & 1);
      turn_begin();
      wgmma_fence();
      issue_s(it);
      wgmma_commit();
      issue_pv(it - 1);
      wgmma_commit();
      turn_end(false);
      wgmma_wait<1>();  // s of tile it is in; p v of tile it - 1 runs on
      scores_in();
      softmax(it, a0, a1, rs0, rs1);
      wgmma_wait<0>();
      fence_regs(o);
      if constexpr (I8) fence_regs(ls);
      mbar_arrive(&empty[(it - 1) % ST]);  // k and v of tile it - 1 done
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      if constexpr (I8) {
        ls[0] *= a0;
        ls[1] *= a0;
        ls[2] *= a1;
        ls[3] *= a1;
      } else {
        l0 = l0 * a0 + rs0;
        l1 = l1 * a1 + rs1;
      }
      acc_to_a<BN>(pa, s);
    }
    turn_begin();
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_commit();
    turn_end(true);
    wgmma_wait<0>();
    fence_regs(o);

    if constexpr (I8) {  // every column of ls is the whole row's sum
      fence_regs(ls);
      l0 = ls[0];
      l1 = ls[2];
    } else {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    }
    const float safe0 = l0 == 0.f ? 1.f : l0, safe1 = l1 == 0.f ? 1.f : l1;
    const float inv0 = 1.f / safe0, inv1 = 1.f / safe1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= inv0;
      o[4 * j + 1] *= inv0;
      o[4 * j + 2] *= inv1;
      o[4 * j + 3] *= inv1;
    }
    store_acc<D>(p.o + b * p.o_sb + h * p.o_sh, p.o_sn, o, 1.f, r0, p.Nq, t,
                 NARROW ? p.D : D);
    if (p.lse != nullptr && t == 0) {
      float* lb = p.lse + (long long)bh * p.Nq;
      if (r0 < p.Nq) lb[r0] = m0 * c + log2f(safe0);
      if (r0 + 8 < p.Nq) lb[r0 + 8] = m1 * c + log2f(safe1);
    }
  }
}

// q, k (bf16 at the real width p.D, or int8 codes at D's code width) and
// v (bf16 at p.D) through their maps, as the note at the top says
template <int D, bool I8, bool NARROW>
cudaError_t launch_sm90(const FlashParams& p, int B, int BH,
                        cudaStream_t stream) {
  using T = FwdTiles<D, I8>;
  auto qk_map = I8 ? make_map_i8 : make_map_head;
  const int qk_d = I8 ? T::C::W : p.D;
  CUtensorMap tq, tk, tv;
  cudaError_t err = qk_map(&tq, p.q, B, p.Nq, p.H, qk_d, p.q_sb, p.q_sn,
                           p.q_sh, T::BM);
  if (err == cudaSuccess)
    err = qk_map(&tk, p.k, B, p.Nk, p.H, qk_d, p.k_sb, p.k_sn, p.k_sh,
                 T::BN);
  if (err == cudaSuccess)
    err = make_map_head(&tv, p.v, B, p.Nk, p.H, p.D, p.v_sb, p.v_sn, p.v_sh,
                        T::BN);
  TailMaps<D, 3> tails;
  if constexpr (T::P::TAIL) {  // the last 16 columns of q, k and v
    // (K3: the last 32 bytes of q8 and k8)
    auto qk_tail = I8 ? make_map_i8_tail : make_map_tail;
    if (err == cudaSuccess)
      err = qk_tail(&tails.m[0], p.q, B, p.Nq, p.H, qk_d, p.q_sb, p.q_sn,
                    p.q_sh, T::BM);
    if (err == cudaSuccess)
      err = qk_tail(&tails.m[1], p.k, B, p.Nk, p.H, qk_d, p.k_sb, p.k_sn,
                    p.k_sh, T::BN);
    if (err == cudaSuccess)
      err = make_map_tail(&tails.m[2], p.v, B, p.Nk, p.H, p.D, p.v_sb,
                          p.v_sn, p.v_sh, T::BN);
  }
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_sm90_kernel<D, I8, NARROW>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Nq + T::BM - 1) / T::BM, BH);
  kernel<<<grid, 3 * kWG, T::BYTES, stream>>>(tq, tk, tv, p, tails);
  return cudaGetLastError();
}

// the instantiation of width D for a head of width p.D <= D
template <int D, bool I8>
cudaError_t launch_width(const FlashParams& p, int B, int BH,
                         cudaStream_t stream) {
  return p.D == D ? launch_sm90<D, I8, false>(p, B, BH, stream)
                  : launch_sm90<D, I8, true>(p, B, BH, stream);
}


// ---------------------------------------------------------------------------
// K8: int8 scores AND int8 p v (replaces _fwd_i8_kernel, pv=True), K3's
// design with the bf16 p v replaced by an int8 one.
//
// Per query row i and per sub-block u of 64 keys (the JAX kernel's
// sub-block at block_k 64, ops/attention.py PV_SUB):
//   s_ij  = (q8_i . k8_j) * sq*sk             (log2 units, as K3)
//   sm_u  = max_j in u s_ij
//   p8_ij = floor(exp2(s_ij - sm_u + log2 127) + .5)   in 0..127
//           (the kernel rounds to nearest, see below)
//   o_i   = sv * sum_u w_u n_u / sum_u w_u l_u,   n_u = sum_j p8_ij v8_j,
//   l_u   = sum_j p8_ij,   w_u = exp2(sm_u - m_i), m_i the running max.
// Numerator and denominator come from the same integers p8. The TPU kernel
// fixed the shift from the first kv block and got the row sum from a
// [v8 | 127 | pad] column on the MXU; both cancel in o and are not carried
// over.
//
// Bound on the H100: int8 operations, 4*B*H*N^2*d at 1,979 TOP/s (0.651 ms
// at N 20,480, 12 heads of 64, batch 1), and the same N^2*H exp2 as K1 and
// K3 (~1.2-1.3 ms there), so it cannot go far below K3. Design, K3's:
//   - a producer warpgroup issues TMA (q8 once; k8 and v8 in tiles of BN
//     keys through a ring of 4 stages), two consumer warpgroups of 64 query
//     rows take turns at issuing their wgmma (ping-pong), setmaxnreg;
//   - S = q8 k8^T is K3's int8 wgmma; its s32 scores x become the floats
//     1.5 * 2^23 + x exactly, so the sub-block maxima and the differences
//     s - sm_u are exact, and one FFMA gives the exponent;
//   - p8 is requantised per sub-block and row in registers: the sub-block's
//     max by a quad shuffle, y rounded to the nearest integer as the low
//     bits of y + 2^23 (one FADD; it differs from floor(y + .5) only where y
//     is exactly k + .5, finer than ex2.approx's own error, and y < 127.5
//     keeps p8 a positive int8), four p8 packed into a register by byte
//     permutes;
//   - n_u = p8 v8 is wgmma m64nDk32 .s32.s8.s8 with p8 as A from registers
//     and v8 as B from shared memory, into a fresh s32 accumulator for each
//     sub-block (scale-d 0 on its first k-step); BN = 128 keys hold two
//     sub-blocks at d 32 and 64, BN = 64 one at d 128;
//   - tile j+1's S is issued with tile j's p v, its requantisation runs
//     while the tensor cores work, and tile j's n_u fold into the f32 o
//     after (o = o a + sum_u w_u n_u, a the running max's rescale; n_u
//     converted by the conversion instruction, which measured faster here
//     than K3's integer-add trick), one tile behind; l_u is an integer sum
//     of the packed p8 by dp4a, on the integer pipe, folded the same way
//     and summed over the quad at the end.
// Past K3's work a score costs the requantisation (exponent, rounding,
// packing, row sums) and an element of o the fold, on the FP32 and integer
// pipes, so K8 takes somewhat longer than K3 (PERF.md has the split;
// scripts/torch_k8_split.py measures it).
// Layout. The s32 accumulator of S gives thread (g, t) keys 2t, 2t+1 of
// each 8-key group (acc_to_a's note in sm90.cuh), but the s8 A fragment of
// a k32 step wants k = 4t..4t+3 and 16+4t..16+4t+3. The order of keys
// inside a step is free, so A's k = 4t+e is taken to be key
// 2t + (e&1) + 8*(e>>1) (and +16 for the second half): each thread's own
// p8 values are its A fragment, with no shuffles. v8 comes d-major, (B, H,
// D, N_pad) with N_pad a multiple of 64 (zeros past N), keys permuted
// within each 32-key group to that order (ops/attention.py
// quantize_v_kernel_layout; written by the quantisation kernel, quant.cu),
// so B is K-major as integer wgmma reads it: a tile is D rows of BN bytes,
// loaded by TMA with the swizzle of BN bytes (desc_i8<BN>).
// Ragged keys: keys past Nk score -inf, so their p8 is 0, and their v8
// bytes are 0; a sub-block wholly past Nk gets w_u = 0 and p8 = 0.

// p8 from its float without the conversion unit, which would share the
// issue slots with ex2 once a score: rint(x) for x in [0, 2^22) is the low
// bits of x + 2^23 (the ulp there is 1)
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, 8388608.f));
}

// the low bytes of a, b, c, d as one word, a in byte 0
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b,
                                                   uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

constexpr int kPvSub = 64;  // keys of a requantisation sub-block

template <int D>
struct PvTiles {
  static constexpr int BM = 128;                 // query rows a block owns
  static constexpr int BN = D <= 64 ? 128 : 64;  // keys of a streamed tile
  static constexpr int SUBS = BN / kPvSub;       // sub-blocks of a tile
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = BM * D;         // int8 rows, as K3's
  static constexpr int K_BYTES = BN * D;
  static constexpr int V_BYTES = D * BN;         // D rows of BN keys
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int BARS = (2 * STAGES + 1) * 8;
  static constexpr int BYTES = 1024 + Q_BYTES + STAGES * STAGE + BARS;
};

struct PvParams {
  const float* sq;  // per (b*H + h) scales
  const float* sk;
  const float* sv;
  __nv_bfloat16* o;  // (B, Nq, H, p.D) contiguous
  int H, Nq, Nk;
  int D;  // the real head width: D of the instantiation, or less
};

template <int D, bool NARROW>
__global__ void __launch_bounds__(3 * kWG, 1)
    flash_fwd_i8pv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const PvParams p) {
  using T = PvTiles<D>;
  constexpr int BM = T::BM, BN = T::BN, ST = T::STAGES, SUBS = T::SUBS;
  constexpr float kLog127 = 6.988684686772166f;
  extern __shared__ char smem_raw[];
  char* qs = align1024(smem_raw);
  char* kv = qs + T::Q_BYTES;  // stage s: a k8 tile, then a v8 tile
  uint64_t* full = reinterpret_cast<uint64_t*>(kv + ST * T::STAGE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (p.Nk + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {  // producer warpgroup: one thread issues TMA
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_expect_tx(qbar, T::Q_BYTES);
      tma_load_4d(qs, &tq, qbar, 0, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE);
        char* ks = kv + s * T::STAGE;
        tma_load_4d(ks, &tk, &full[s], 0, h, it * BN, b);
        tma_load_4d(ks + T::K_BYTES, &tv, &full[s], it * BN, 0, 0, bh);
      }
    }
  } else {  // consumer warpgroups cw = 0, 1: 64 query rows each
    reg_alloc<232>();
    const int cw = threadIdx.x / kWG - 1;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows
    const float c = p.sq[bh] * p.sk[bh];
    const uint32_t qa = smem_u32(qs) + cw * 64 * D;
    const uint32_t kva = smem_u32(kv);

    // ping-pong, as K3
    auto turn_begin = [&]() { named_sync(1 + cw, kConsumers); };
    auto turn_end = [&](bool last) {
      if (!(last && cw == 1)) named_arrive(2 - cw, kConsumers);
    };
    if (cw == 1) named_arrive(1, kConsumers);

    uint32_t si[BN / 2];          // s32 scores, then their floats, then p8
    uint32_t n[SUBS][D / 2];      // n_u = p8 v8 of the tile in flight
    uint32_t pa[BN / 32][4];      // p8 packed: the A fragments of p v
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    // what the tile in flight folds in with: its rescale of o and l, its
    // sub-blocks' weights and this thread's p8 row sums
    float fa0, fa1, fw[SUBS][2];
    int frs[SUBS][2];

    auto issue_s = [&](int it) {  // s = q8 k8^T over d
      const uint32_t ka = kva + (it % ST) * T::STAGE;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_i8<BN>(si, desc_i8<D>(qa, kk), desc_i8<D>(ka, kk), kk > 0);
    };
    // n_u = p8 v8 over the sub-block's two k32 steps, n_u overwritten
    auto issue_pv = [&](int it) {
      const uint32_t va = kva + (it % ST) * T::STAGE + T::K_BYTES;
#pragma unroll
      for (int u = 0; u < SUBS; ++u)
#pragma unroll
        for (int ks = 0; ks < kPvSub / 32; ++ks) {
          const int kk = u * (kPvSub / 32) + ks;
          wgmma_i8_rs<D>(n[u], pa[kk], desc_i8<BN>(va, kk), ks > 0);
        }
    };
    // after the wait on tile it's scores: si := p8 of the tile (in the low
    // byte of each word); a0, a1 the rescale of the rows' earlier sums and
    // w the sub-blocks' weights, both against the new running max
    auto requant = [&](int it, float& a0, float& a1, float (&w)[SUBS][2]) {
      fence_regs(si);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) si[i] += 0x4B400000u;
      const int kv0 = it * BN;
      if (kv0 + BN > p.Nk) {  // ragged kv tail
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + j * 8 + 2 * t + (e & 1) >= p.Nk)
              si[4 * j + e] = __float_as_uint(-INFINITY);
      }
      float sm[SUBS][2];
#pragma unroll
      for (int u = 0; u < SUBS; ++u) {
        float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
        for (int j = u * 8; j < u * 8 + 8; ++j) {
          x0 = fmaxf(x0, fmaxf(__uint_as_float(si[4 * j]),
                               __uint_as_float(si[4 * j + 1])));
          x1 = fmaxf(x1, fmaxf(__uint_as_float(si[4 * j + 2]),
                               __uint_as_float(si[4 * j + 3])));
        }
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
        sm[u][0] = x0;
        sm[u][1] = x1;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int u = 0; u < SUBS; ++u) {
        mx0 = fmaxf(mx0, sm[u][0]);
        mx1 = fmaxf(mx1, sm[u][1]);
      }
      a0 = ex2((m0 - mx0) * c);  // 0 on the first tile (m = -inf)
      a1 = ex2((m1 - mx1) * c);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int u = 0; u < SUBS; ++u) {
        w[u][0] = ex2((sm[u][0] - m0) * c);  // 0 for a sub-block past Nk
        w[u][1] = ex2((sm[u][1] - m1) * c);
        // a sub-block past Nk: s - (+inf) = -inf, so p8 = 0 there too
        if (sm[u][0] == -INFINITY) sm[u][0] = INFINITY;
        if (sm[u][1] == -INFINITY) sm[u][1] = INFINITY;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __uint_as_float(si[4 * j + e]);
          const float y = ex2(fmaf(x - sm[j / 8][e >> 1], c, kLog127));
          si[4 * j + e] = rint_bits(y);
        }
    };
    // p8 of the tile into pa, and this thread's row sums of it by dp4a
    auto pack = [&]() {
#pragma unroll
      for (int u = 0; u < SUBS; ++u) frs[u][0] = frs[u][1] = 0;
#pragma unroll
      for (int cs = 0; cs < BN / 32; ++cs) {
        const uint32_t* q = si + 16 * cs;
        pa[cs][0] = pack_low_bytes(q[0], q[1], q[4], q[5]);
        pa[cs][1] = pack_low_bytes(q[2], q[3], q[6], q[7]);
        pa[cs][2] = pack_low_bytes(q[8], q[9], q[12], q[13]);
        pa[cs][3] = pack_low_bytes(q[10], q[11], q[14], q[15]);
        int* rs = frs[cs / (kPvSub / 32)];
        rs[0] = __dp4a((int)pa[cs][0], 0x01010101, rs[0]);
        rs[0] = __dp4a((int)pa[cs][2], 0x01010101, rs[0]);
        rs[1] = __dp4a((int)pa[cs][1], 0x01010101, rs[1]);
        rs[1] = __dp4a((int)pa[cs][3], 0x01010101, rs[1]);
      }
    };
    // after the wait on tile it's p v: o = o a + sum_u w_u n_u, and l the
    // same of the row sums
    auto fold = [&]() {
#pragma unroll
      for (int u = 0; u < SUBS; ++u) fence_regs(n[u]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const int r = (i >> 1) & 1;
        float acc = o[i] * (r ? fa1 : fa0);
#pragma unroll
        for (int u = 0; u < SUBS; ++u)
          acc = fmaf(fw[u][r], __int2float_rn((int)n[u][i]), acc);
        o[i] = acc;
      }
      l0 *= fa0;
      l1 *= fa1;
#pragma unroll
      for (int u = 0; u < SUBS; ++u) {
        l0 = fmaf(fw[u][0], __int2float_rn(frs[u][0]), l0);
        l1 = fmaf(fw[u][1], __int2float_rn(frs[u][1]), l1);
      }
    };

    mbar_wait(qbar, 0);
    // tile 0: its scores alone
    mbar_wait(&full[0], 0);
    turn_begin();
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<0>();
    requant(0, fa0, fa1, fw);
    pack();

    for (int it = 1; it < ntiles; ++it) {
      mbar_wait(&full[it % ST], (it / ST) & 1);
      turn_begin();
      wgmma_fence();
      issue_s(it);
      wgmma_commit();
      issue_pv(it - 1);
      wgmma_commit();
      turn_end(false);
      wgmma_wait<1>();  // s of tile it is in; p v of tile it - 1 runs on
      float a0, a1, w[SUBS][2];
      requant(it, a0, a1, w);
      wgmma_wait<0>();
      mbar_arrive(&empty[(it - 1) % ST]);  // k8 and v8 of tile it - 1 done
      fold();
      fa0 = a0;
      fa1 = a1;
#pragma unroll
      for (int u = 0; u < SUBS; ++u) {
        fw[u][0] = w[u][0];
        fw[u][1] = w[u][1];
      }
      pack();
    }
    turn_begin();
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_commit();
    turn_end(true);
    wgmma_wait<0>();
    fold();

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float sv = p.sv[bh];
    const float inv0 = sv / (l0 == 0.f ? 1.f : l0);
    const float inv1 = sv / (l1 == 0.f ? 1.f : l1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= inv0;
      o[4 * j + 1] *= inv0;
      o[4 * j + 2] *= inv1;
      o[4 * j + 3] *= inv1;
    }
    const int dw = NARROW ? p.D : D;  // the head's width
    store_acc<D>(p.o + ((long long)b * p.Nq * p.H + h) * dw,
                 (long long)p.H * dw, o, 1.f, r0, p.Nq, t, dw);
  }
}

// q8, k8 through K3's maps; v8 (B*H, D, Npad) as a map of dims (Npad, 1,
// D, B*H) whose box is a tile of BN keys by D rows
template <int D, bool NARROW>
cudaError_t launch_pv(const void* q8, const void* k8, const void* vt8,
                      const PvParams& p, int B, int Npad,
                      const long long* strides, cudaStream_t stream) {
  using T = PvTiles<D>;
  const int BH = B * p.H;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map_i8(&tq, q8, B, p.Nq, p.H, D, strides[0],
                                strides[1], strides[2], T::BM);
  if (err == cudaSuccess)
    err = make_map_i8(&tk, k8, B, p.Nk, p.H, D, strides[3], strides[4],
                      strides[5], T::BN);
  if (err == cudaSuccess)
    err = make_map_box(&tv, vt8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, T::BN,
                       T::BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                       BH, D, 1, Npad, (long long)D * Npad, Npad, Npad, D);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_i8pv_sm90_kernel<D, NARROW>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Nq + T::BM - 1) / T::BM, BH);
  kernel<<<grid, 3 * kWG, T::BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// K8's instantiation of width D for a head of width p.D <= D
template <int D>
cudaError_t launch_pv_width(const void* q8, const void* k8, const void* vt8,
                            const PvParams& p, int B, int Npad,
                            const long long* strides, cudaStream_t stream) {
  return p.D == D
             ? launch_pv<D, false>(q8, k8, vt8, p, B, Npad, strides, stream)
             : launch_pv<D, true>(q8, k8, vt8, p, B, Npad, strides, stream);
}

}  // namespace

#if !defined(SMB_FLASH_FWD_D80) && !defined(SMB_FLASH_FWD_I8_D80)

// K1's and K3's d-80 tiles, compiled apart in flash_fwd_d80.cu and
// flash_fwd_i8_d80.cu (below, under SMB_FLASH_FWD_D80 and
// SMB_FLASH_FWD_I8_D80)
extern "C" int smb_flash_fwd_d80(const void* params, int B, int BH,
                                 void* stream);
extern "C" int smb_flash_fwd_i8_d80(const void* params, int B, int BH,
                                    void* stream);

// strides: 12 int64 in elements, (batch, token, head) for q, k, v, o.
// int8 != 0 selects K3 (q, k int8 with per-(b*H + h) scales sq, sk);
// otherwise K1 (q, k bf16, scores scaled by scale_log2). D, the head width
// of v and o (and of K1's q and k), is a multiple of 8 up to 128; K1 and
// K3 run it on the instantiation of the next of 32, 64, 80 and 128 up,
// whose code width K3's int8 rows hold (32, 64, 96 or 128 bytes, zeros
// past D). q, k and v are
// read by TMA, so their base pointers and strides must be 16-byte
// multiples. v and o are bf16.
// Returns a cudaError_t (0 on success).
extern "C" int smb_flash_fwd(const void* q, const void* k, const void* v,
                             const void* sq, const void* sk, void* o,
                             void* lse, int B, int H, int Nq, int Nk, int D,
                             int int8, const long long* strides,
                             float scale_log2, void* stream) {
  FlashParams p;
  p.q = static_cast<const char*>(q);
  p.k = static_cast<const char*>(k);
  p.v = static_cast<const char*>(v);
  p.sq = static_cast<const float*>(sq);
  p.sk = static_cast<const float*>(sk);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sn = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_sh = strides[11];
  p.scale_log2 = scale_log2;
  p.D = D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (Nq <= 0 || Nk <= 0 || BH <= 0 || BH > 65535 || D <= 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (int8) {
    if (D <= 32) return (int)launch_width<32, true>(p, B, BH, s);
    if (D <= 64) return (int)launch_width<64, true>(p, B, BH, s);
    if (D <= 80) return smb_flash_fwd_i8_d80(&p, B, BH, stream);
    if (D <= 128) return (int)launch_width<128, true>(p, B, BH, s);
  } else {
    if (D <= 32) return (int)launch_width<32, false>(p, B, BH, s);
    if (D <= 64) return (int)launch_width<64, false>(p, B, BH, s);
    if (D <= 80) return smb_flash_fwd_d80(&p, B, BH, stream);
    if (D <= 128) return (int)launch_width<128, false>(p, B, BH, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K8. D, the head width, a multiple of 8 up to 128, runs on the
// instantiation of width DI, the next of 32, 64 and 128 up. q8, k8 int8
// (B, N, H, DI) with strides (6 int64 in elements: batch, token, head for
// q8 then k8; the last dim contiguous; read by TMA, so the bases and
// strides are 16-byte multiples); vt8 int8 (B*H, DI, Npad), Npad a multiple
// of 64, in the key order described above; codes past D zero; sq, sk, sv
// f32 per (b*H + h); o bf16 (B, Nq, H, D) contiguous. Returns a
// cudaError_t.
extern "C" int smb_flash_fwd_i8pv(const void* q8, const void* k8,
                                  const void* vt8, const void* sq,
                                  const void* sk, const void* sv, void* o,
                                  int B, int H, int Nq, int Nk, int Npad,
                                  int D, const long long* strides,
                                  void* stream) {
  PvParams p;
  p.sq = static_cast<const float*>(sq);
  p.sk = static_cast<const float*>(sk);
  p.sv = static_cast<const float*>(sv);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.D = D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  if (Nq <= 0 || Nk <= 0 || BH <= 0 || BH > 65535 || Npad % kPvSub != 0 ||
      Npad < Nk || Npad - Nk >= kPvSub || D <= 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 32)
    return (int)launch_pv_width<32>(q8, k8, vt8, p, B, Npad, strides, s);
  if (D <= 64)
    return (int)launch_pv_width<64>(q8, k8, vt8, p, B, Npad, strides, s);
  if (D <= 128)
    return (int)launch_pv_width<128>(q8, k8, vt8, p, B, Npad, strides, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* smb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#elif defined(SMB_FLASH_FWD_D80)  // flash_fwd_d80.cu

// K1 on the d-80 tiles; params: the FlashParams that smb_flash_fwd filled,
// D 72 or 80 (the NARROW instantiation stores 72 columns)
extern "C" int smb_flash_fwd_d80(const void* params, int B, int BH,
                                 void* stream) {
  const FlashParams& p = *static_cast<const FlashParams*>(params);
  return (int)launch_width<80, false>(p, B, BH,
                                      static_cast<cudaStream_t>(stream));
}

#else  // flash_fwd_i8_d80.cu

// K3 on the d-80 tiles (codes of 96 bytes); params: the FlashParams that
// smb_flash_fwd filled, D 72 or 80 (the NARROW instantiation stores 72
// columns)
extern "C" int smb_flash_fwd_i8_d80(const void* params, int B, int BH,
                                    void* stream) {
  const FlashParams& p = *static_cast<const FlashParams*>(params);
  return (int)launch_width<80, true>(p, B, BH,
                                     static_cast<cudaStream_t>(stream));
}

#endif
