// Attention half-block glue for Hopper (sm_90a): kernels K10a and K10b.
//
// Replaces
//   K10a smb_vision_tpu/ops/attn_glue.py:_qkv_ln_kernel
//        q, k, v = LN(x) Wq + bq, LN(x) Wk + bk, LN(x) Wv + bv
//   K10b smb_vision_tpu/ops/attn_glue.py:_out_res_kernel
//        o = res + y Wo + bo     (LayerScale folded into Wo, bo by the caller)
//
// Numerics as the TPU kernels: LayerNorm statistics in f32 with var =
// E[x^2] - mean^2, xn = (x - mean) * rsqrt(var + eps) * lnw + lnb rounded to
// bf16; bf16 operands, f32 accumulation, the f32 bias (and for K10b the
// residual) added in f32, one rounding to bf16.
//
// Bound on the H100: K10a by operations, 2*M*K*3K (0.073 ms at M 20,480, K
// 768); K10b by bytes, res, y and o (3*M*K*2) plus Wo (0.029 ms at the same
// shape). The TPU kernels kept all three (K, K) weights resident in VMEM
// and streamed rows; a block here cannot (64 x 3K f32 accumulators are far
// beyond its registers), so both are one tiled GEMM:
//   - one block = 8 warps computes BM x 128 output tiles (BM 64, or 32 for
//     K past 1,280); warp (wm, wn) of the 2 x 4 grid owns BM/2 x 32 of a
//     tile, in mma.sync m16n8k16 (bf16) fragments kept in registers;
//   - the weights come in PyTorch's Linear layout (out, in), row-major:
//     exactly the "col" B operand of the mma, so their rows load by
//     ldmatrix without a transpose, and three separate tensors serve as q,
//     k, v (K % 128 == 0, so a 128-column tile lies in one of them);
//   - K10a normalises its BM rows in a prologue (f32 statistics, xn in bf16
//     in shared memory: BM x K, 96 KB at K 768), then walks the K/128
//     column tiles of one of q, k, v, so LN runs three times a row; K10b
//     (no prologue, 83 KB, two blocks an SM) takes one tile a block;
//   - the weight tiles (and for K10b the y tile) stream in 64-deep K chunks
//     through a 3-stage cp.async ring that runs on across a block's tiles,
//     one barrier a chunk;
//   - epilogue: + bias [+ residual of the same rows] in f32, bf16 store.
// Rows are padded by 16 bytes in shared memory so the 8 row addresses of an
// ldmatrix hit distinct banks. Ragged M: rows past M load as zero and are
// not stored. Not yet done (later work): wgmma, TMA, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;    // output columns per block
constexpr int kKC = 64;     // K depth per ring stage
constexpr int kStages = 3;  // ring stages: kStages - 1 copies in flight
constexpr int kRS = kKC + 8;  // padded row of a ring tile (elements)

struct GlueParams {
  const __nv_bfloat16* a;      // x (K10a) or y (K10b), (M, K)
  const float* lnw;            // (K,) K10a only
  const float* lnb;
  const __nv_bfloat16* w[3];   // (K, K) each, (out, in) row-major
  const float* bias[3];        // (K,) each
  const __nv_bfloat16* res;    // (M, K), K10b only
  __nv_bfloat16* out[3];       // (M, K) each
  int M, K;
  int tiles_per_block;         // 128-column tiles a block walks
  float eps;
};

template <int BM, bool LN>
struct GlueSmem {
  static constexpr int W_ELEMS = kBN * kRS;
  static constexpr int A_ELEMS = LN ? 0 : BM * kRS;
  static constexpr int STAGE = W_ELEMS + A_ELEMS;
  // K10a's xn (BM x (K + 8)) follows the ring
  static constexpr int RING_BYTES = kStages * STAGE * 2;
  static int bytes(int K) { return RING_BYTES + (LN ? BM * (K + 8) * 2 : 0); }
};

template <int BM, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
    glue_gemm_kernel(const GlueParams p) {
  using S = GlueSmem<BM, LN>;
  constexpr int WM = BM / 2;   // rows per warp
  constexpr int MT = WM / 16;  // m16 tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xn =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + S::RING_BYTES);

  const int K = p.K;
  const int XS = K + 8;  // xn row stride (elements)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  // the block's tiles: tpb consecutive 128-column tiles of one weight
  const int tpb = p.tiles_per_block;
  const int ct0 = blockIdx.x * tpb;           // first column tile over nw * K
  const int which = ct0 * kBN / K;            // q, k or v (K10a)
  const int col00 = ct0 * kBN - which * K;    // its first column
  const long long m0 = (long long)blockIdx.y * BM;
  // selects, not p.w[which]: a dynamic index would copy the parameter
  // arrays to the stack
  const __nv_bfloat16* wb = which == 0 ? p.w[0] : which == 1 ? p.w[1] : p.w[2];
  const int nchunks = K / kKC;
  const int nitems = tpb * nchunks;           // ring items: (tile, chunk)

  auto issue = [&](int v) {
    if (v < nitems) {
      __nv_bfloat16* dst = ring + (v % kStages) * S::STAGE;
      const int k0 = (v % nchunks) * kKC;
      const __nv_bfloat16* wt =
          wb + (long long)(col00 + (v / nchunks) * kBN) * K + k0;
      for (int e = tid; e < kBN * (kKC / 8); e += kThreads) {
        const int r = e / (kKC / 8), col = (e % (kKC / 8)) * 8;
        cp_async16(dst + r * kRS + col, wt + (long long)r * K + col, 16);
      }
      if constexpr (!LN) {
        __nv_bfloat16* ad = dst + S::W_ELEMS;
        for (int e = tid; e < BM * (kKC / 8); e += kThreads) {
          const int r = e / (kKC / 8), col = (e % (kKC / 8)) * 8;
          const bool ok = m0 + r < p.M;
          cp_async16(ad + r * kRS + col,
                     ok ? p.a + (m0 + r) * K + k0 + col : p.a, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  if constexpr (LN) {
    // prologue: xn = LN(x) for the block's rows, BM / 8 rows per warp; the
    // weight copies above are in flight meanwhile
    for (int rr = 0; rr < BM / kWarps; ++rr) {
      const int r = warp * (BM / kWarps) + rr;
      const long long row = m0 + r;
      const bool ok = row < p.M;
      const __nv_bfloat16* xr = p.a + row * K;
      float sum = 0.f, sq = 0.f;
      if (ok) {
        for (int c = lane; c < K / 8; c += 32) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
          const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float v = __bfloat162float(e8[e]);
            sum += v;
            sq += v * v;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      const float mean = sum / K;
      const float rstd = rsqrtf(sq / K - mean * mean + p.eps);
      for (int c = lane; c < K / 8; c += 32) {
        __align__(16) __nv_bfloat16 o8[8];
        if (ok) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xr + c * 8);
          const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o8[e] = __float2bfloat16((__bfloat162float(e8[e]) - mean) * rstd *
                                         p.lnw[c * 8 + e] +
                                     p.lnb[c * 8 + e]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) o8[e] = __float2bfloat16(0.f);
        }
        *reinterpret_cast<uint4*>(xn + r * XS + c * 8) =
            *reinterpret_cast<const uint4*>(o8);
      }
    }
  }

  float acc[MT][4][4];
  auto zero = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  };
  zero();

  // ldmatrix row addresses: A (16 x 16, rows lane & 15, k half lane >> 4)
  // and B (one n8 tile x 32 k: matrix lane >> 3 is k 8i..8i+7)
  const int arow = wm * WM + (lane & 15), acol = (lane >> 4) * 8;
  const int boff = (wn * 32 + (lane & 7)) * kRS + (lane >> 3) * 8;
  const float* bias =
      which == 0 ? p.bias[0] : which == 1 ? p.bias[1] : p.bias[2];
  __nv_bfloat16* out = which == 0 ? p.out[0] : which == 1 ? p.out[1] : p.out[2];

  for (int v = 0; v < nitems; ++v) {
    const int i = v % nchunks;
    // wait for item v; the barrier also frees the stage of item v - 1,
    // which the copy of item v + kStages - 1 then refills (and, at v = 0,
    // publishes xn)
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(v + kStages - 1);
    const __nv_bfloat16* ws = ring + (v % kStages) * S::STAGE;
    const __nv_bfloat16* as;
    int astride;
    if constexpr (LN) {
      as = xn + arow * XS + i * kKC + acol;
      astride = XS;
    } else {
      as = ws + S::W_ELEMS + arow * kRS + acol;
      astride = kRS;
    }
#pragma unroll
    for (int kk = 0; kk < kKC / 32; ++kk) {
      uint32_t a[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4(a[mt][0], as + mt * 16 * astride + kk * 32);
        ldsm_x4(a[mt][1], as + mt * 16 * astride + kk * 32 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        ldsm_x4(b, ws + boff + j * 8 * kRS + kk * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][j], a[mt][0], b[0], b[1]);
          mma_bf16(acc[mt][j], a[mt][1], b[2], b[3]);
        }
      }
    }
    if (i != nchunks - 1) continue;

    // the tile is done: + bias [+ residual] in f32, one rounding to bf16
    const int col0 = col00 + (v / nchunks) * kBN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = m0 + wm * WM + mt * 16 + g + 8 * hh;
        if (row >= p.M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = col0 + wn * 32 + j * 8 + 2 * t;
          float v0 = acc[mt][j][2 * hh] + bias[col];
          float v1 = acc[mt][j][2 * hh + 1] + bias[col + 1];
          if constexpr (!LN) {
            const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(
                p.res + row * K + col);
            v0 += __bfloat162float(r2.x);
            v1 += __bfloat162float(r2.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + row * K + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    zero();
  }
  cp_async_wait<0>();  // the groups still open are empty
}

template <int BM, bool LN>
cudaError_t launch(const GlueParams& p, int nw, cudaStream_t stream) {
  auto kernel = glue_gemm_kernel<BM, LN>;
  const int bytes = GlueSmem<BM, LN>::bytes(p.K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(nw * p.K / kBN / p.tiles_per_block, (p.M + BM - 1) / BM);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// the widest K whose K10a prologue (xn) fits beside the ring at BM rows
constexpr int kMaxK64 = 1280;
constexpr int kMaxK32 = 2688;

bool shape_ok(int M, int K) {
  return M > 0 && K > 0 && K % 128 == 0 && (long long)M * K < (1LL << 40);
}

}  // namespace

// K10a. x (M, K) bf16; lnw, lnb, bq, bk, bv f32 (K,); wq, wk, wv bf16 (K,
// K) in the Linear layout (out, in), contiguous; q, k, v bf16 (M, K). K a
// multiple of 128, at most 2,688. Returns a cudaError_t.
extern "C" int smb_qkv_ln_fwd(const void* x, const void* lnw, const void* lnb,
                              const void* wq, const void* wk, const void* wv,
                              const void* bq, const void* bk, const void* bv,
                              void* q, void* k, void* v, int M, int K,
                              float eps, void* stream) {
  if (!shape_ok(M, K) || K > kMaxK32) return (int)cudaErrorInvalidValue;
  GlueParams p = {};
  p.a = static_cast<const __nv_bfloat16*>(x);
  p.lnw = static_cast<const float*>(lnw);
  p.lnb = static_cast<const float*>(lnb);
  p.w[0] = static_cast<const __nv_bfloat16*>(wq);
  p.w[1] = static_cast<const __nv_bfloat16*>(wk);
  p.w[2] = static_cast<const __nv_bfloat16*>(wv);
  p.bias[0] = static_cast<const float*>(bq);
  p.bias[1] = static_cast<const float*>(bk);
  p.bias[2] = static_cast<const float*>(bv);
  p.out[0] = static_cast<__nv_bfloat16*>(q);
  p.out[1] = static_cast<__nv_bfloat16*>(k);
  p.out[2] = static_cast<__nv_bfloat16*>(v);
  p.M = M;
  p.K = K;
  p.tiles_per_block = K / kBN;  // one block: BM rows of one of q, k, v
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= kMaxK64) return (int)launch<64, true>(p, 3, s);
  return (int)launch<32, true>(p, 3, s);
}

// K10b. res, y (M, K) bf16; wo bf16 (K, K) in the Linear layout (out, in),
// contiguous; bo f32 (K,); out bf16 (M, K). K a multiple of 128. Returns a
// cudaError_t.
extern "C" int smb_out_res_fwd(const void* res, const void* y, const void* wo,
                               const void* bo, void* out, int M, int K,
                               void* stream) {
  if (!shape_ok(M, K)) return (int)cudaErrorInvalidValue;
  GlueParams p = {};
  p.a = static_cast<const __nv_bfloat16*>(y);
  p.w[0] = static_cast<const __nv_bfloat16*>(wo);
  p.bias[0] = static_cast<const float*>(bo);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out[0] = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.tiles_per_block = 1;
  return (int)launch<64, false>(p, 1, static_cast<cudaStream_t>(stream));
}
