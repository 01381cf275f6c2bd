// Fused transformer MLP forward for Hopper (sm_90a): the plain MLP (K6), the
// training forward that also spills the pre-activation (K5a) and the whole
// MLP half-block with LayerNorm prologue and residual (K2), one templated
// body.
//
// Replaces
//   K6  smb_vision_tpu/ops/mlp.py:_mlp_kernel        y = act(x w1 + b1) w2 + b2
//   K5a smb_vision_tpu/ops/mlp.py:_mlp_train_kernel  K6, plus h = x w1 + b1
//                                                    stored in bf16
//   K2  smb_vision_tpu/ops/mlp.py:_mlp_block_kernel  y = x + act(LN(x) w1 + b1) w2 + b2
//
// Numerics as the TPU kernels: bf16 operands, f32 accumulation, LayerNorm
// statistics, bias and activation in f32, the activation rounded to bf16
// before the second product. GELU is the exact erf form (erff; the TPU
// kernel needed a rational approximation because Mosaic has no erf).
// LayerNorm takes two-pass statistics (the TPU kernel: E[x^2] - mean^2).
//
// Bound on the H100: at M = 20,480, K = 768, F = 3,072 the two products are
// 4*M*K*F flops against 2*K*F weight bytes, which every row block reads
// again from L2; the (M, F) intermediate, which a plain chain writes to and
// reads back from device memory, never leaves the SM.
//
// The TPU kernel kept a (bm, K) f32 accumulator and the (bm, K) normalised
// rows in VMEM with bm in the hundreds. A Hopper block has 227 KB of shared
// memory and 64K registers, so the design here is a SMALL ROW BLOCK with the
// accumulator in REGISTERS:
//   - one block = 8 warps = 32 rows; F streams in chunks of 32 columns;
//   - the block's normalised rows xn (32 x K bf16) stay in shared memory for
//     the whole F loop (LN runs once per row block);
//   - per chunk: h (32 x 32) = xn w1_chunk^T with one m16n8 tile per warp
//     (mma.sync m16n8k16), + b1, act, rounded to bf16 into shared memory;
//     then y (32 x K) += h w2_chunk with every warp owning K/8 output
//     columns, so the f32 accumulator is 2 x K/64 m16n8 tiles per warp
//     (96 floats a thread at K = 768) and never leaves registers;
//   - the weight copies overlap the math with one buffer each (there is no
//     room for two): cp.async brings the next chunk's w1 rows during this
//     chunk's h w2 product, and the next w2 columns during the next
//     chunk's xn w1 product;
//   - the epilogue adds b2 (and the residual x) in f32 and stores bf16;
//   - K5a (SPILL) also stores each chunk's h = x w1 + b1, rounded to bf16,
//     from the phase-1 registers: the (M, F) tensor the backward kernel
//     (mlp_bwd.cu) reads instead of recomputing x w1. The activation is
//     still taken of the f32 h, as in K6.
// Weights come in PyTorch's Linear layout, w1 (F, K) and w2 (K, F); every
// fragment is loaded by ldmatrix, and rows are padded by 16 bytes so the 8
// row addresses of an ldmatrix hit distinct banks. Ragged M: rows past M
// load as zero and are not stored. K is a template parameter (128, 256,
// 384, 512, 768, 1024); F must be a multiple of 32.
// Not yet done (later work): wgmma, TMA multicast of the weight chunks to a
// cluster of row blocks, a larger row block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 32;  // rows per block
constexpr int kBF = 32;  // F columns per chunk

struct MlpParams {
  const __nv_bfloat16* x;    // (M, K)
  const float* lnw;          // (K,)   LN only
  const float* lnb;          // (K,)   LN only
  const __nv_bfloat16* w1;   // (F, K)
  const float* b1;           // (F,)
  const __nv_bfloat16* w2;   // (K, F)
  const float* b2;           // (K,)
  __nv_bfloat16* out;        // (M, K)
  __nv_bfloat16* h;          // (M, F) pre-activation spill, K5a only
  int M, F;
  float eps;
  int act;                   // 0: exact gelu, 1: tanh gelu
};

__device__ __forceinline__ float activation(float v, int act) {
  if (act == 0) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return 0.5f * v *
         (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

template <int K>
struct Smem {
  static constexpr int XS = K + 8;     // xn and w1 chunk row stride (elems)
  static constexpr int WS = kBF + 8;   // w2 chunk and h row stride (elems)
  static constexpr int XN = 0;
  static constexpr int W1 = XN + kBM * XS;
  static constexpr int W2 = W1 + kBF * XS;
  static constexpr int HS = W2 + K * WS;
  static constexpr int ELEMS = HS + kBM * WS;
  static constexpr int BYTES = ELEMS * 2;
};

template <int K, bool LN, bool SPILL>
__global__ void __launch_bounds__(kThreads, 1) mlp_fwd_kernel(const MlpParams p) {
  using S = Smem<K>;
  constexpr int NT = K / 64;  // n8 output tiles per warp (K/8 columns)
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* xn = smem + S::XN;
  __nv_bfloat16* w1s = smem + S::W1;
  __nv_bfloat16* w2s = smem + S::W2;
  __nv_bfloat16* hs = smem + S::HS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * kBM;

  auto load_w1 = [&](int f0) {  // w1 rows f0 .. f0 + kBF
    for (int c = tid; c < kBF * (K / 8); c += kThreads) {
      const int r = c / (K / 8), col = (c % (K / 8)) * 8;
      cp_async16(w1s + r * S::XS + col, p.w1 + (long long)(f0 + r) * K + col);
    }
  };
  auto load_w2 = [&](int f0) {  // w2 columns f0 .. f0 + kBF
    for (int c = tid; c < K * (kBF / 8); c += kThreads) {
      const int r = c / (kBF / 8), col = (c % (kBF / 8)) * 8;
      cp_async16(w2s + r * S::WS + col, p.w2 + (long long)r * p.F + f0 + col);
    }
  };
  load_w1(0);
  cp_async_commit();
  load_w2(0);
  cp_async_commit();

  // prologue: xn = LN(x) (or x) for the block's rows, 4 rows per warp
  constexpr int CH = (K / 8 + 31) / 32;  // 8-element chunks per lane per row
  for (int rr = 0; rr < kBM / kWarps; ++rr) {
    const int r = warp * (kBM / kWarps) + rr;
    const long long row = m0 + r;
    float v[CH][8];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + 32 * i;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = 0.f;
      if (c < K / 8 && row < p.M) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(p.x + row * K + c * 8);
        const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = __bfloat162float(e8[e]);
      }
    }
    float mean = 0.f, rstd = 1.f;
    if constexpr (LN) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += v[i][e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      mean = sum / K;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (lane + 32 * i < K / 8)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = v[i][e] - mean;
            sq += d * d;
          }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      rstd = rsqrtf(sq / K + p.eps);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + 32 * i;
      if (c < K / 8) {
        __align__(16) __nv_bfloat16 o8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = v[i][e];
          if constexpr (LN)
            val = (val - mean) * rstd * p.lnw[c * 8 + e] + p.lnb[c * 8 + e];
          o8[e] = __float2bfloat16(val);
        }
        *reinterpret_cast<uint4*>(xn + r * S::XS + c * 8) =
            *reinterpret_cast<const uint4*>(o8);
      }
    }
  }

  float y[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n) y[mt][n][0] = y[mt][n][1] = y[mt][n][2] = y[mt][n][3] = 0.f;

  const int pm = warp / 4, pn = warp % 4;  // phase-1 tile of this warp
  const int nchunks = p.F / kBF;
  // ldmatrix row addresses: A fragments (16 x 16) and B fragments (8 x 32)
  const __nv_bfloat16* a1 = xn + (pm * 16 + (lane & 15)) * S::XS + (lane >> 4) * 8;
  const __nv_bfloat16* b1p = w1s + (pn * 8 + (lane & 7)) * S::XS + (lane >> 3) * 8;
  const __nv_bfloat16* b2p =
      w2s + (warp * (K / 8) + (lane & 7)) * S::WS + (lane >> 3) * 8;
  for (int c = 0; c < nchunks; ++c) {
    const int f0 = c * kBF;
    cp_async_wait<1>();  // w1 chunk c has landed (w2 chunk c may be in flight)
    __syncthreads();

    // phase 1: h tile (rows pm*16.., cols pn*8..) = xn w1_chunk^T + b1, act
    {
      // four independent accumulators: one chain of K/16 dependent mma
      // would leave the tensor cores waiting on their own latency
      float part[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < K / 32; ++kk) {
        uint32_t b[4], a[4];
        ldsm_x4(b, b1p + kk * 32);
        ldsm_x4(a, a1 + kk * 32);
        mma_bf16(part[(kk & 1) * 2], a, b[0], b[1]);
        ldsm_x4(a, a1 + kk * 32 + 16);
        mma_bf16(part[(kk & 1) * 2 + 1], a, b[2], b[3]);
      }
      float acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = (part[0][i] + part[1][i]) + (part[2][i] + part[3][i]);
      const int col = pn * 8 + 2 * t;
      const float bb0 = p.b1[f0 + col], bb1 = p.b1[f0 + col + 1];
      if constexpr (SPILL) {
        const long long r = m0 + pm * 16 + g;
        if (r < p.M)
          *reinterpret_cast<__nv_bfloat162*>(p.h + r * p.F + f0 + col) =
              __floats2bfloat162_rn(acc[0] + bb0, acc[1] + bb1);
        if (r + 8 < p.M)
          *reinterpret_cast<__nv_bfloat162*>(p.h + (r + 8) * p.F + f0 + col) =
              __floats2bfloat162_rn(acc[2] + bb0, acc[3] + bb1);
      }
      *reinterpret_cast<__nv_bfloat162*>(hs + (pm * 16 + g) * S::WS + col) =
          __floats2bfloat162_rn(activation(acc[0] + bb0, p.act),
                                activation(acc[1] + bb1, p.act));
      *reinterpret_cast<__nv_bfloat162*>(hs + (pm * 16 + g + 8) * S::WS + col) =
          __floats2bfloat162_rn(activation(acc[2] + bb0, p.act),
                                activation(acc[3] + bb1, p.act));
    }
    __syncthreads();  // h written; the w1 buffer is free
    if (c + 1 < nchunks) load_w1(f0 + kBF);
    cp_async_commit();
    cp_async_wait<1>();  // w2 chunk c has landed
    __syncthreads();

    // phase 2: y[:, warp's K/8 columns] += h w2_chunk
    uint32_t a[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
        ldsm_x4(a[mt][kc], hs + (mt * 16 + (lane & 15)) * S::WS + kc * 16 +
                               (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b[4];
      ldsm_x4(b, b2p + n * 8 * S::WS);
      mma_bf16(y[0][n], a[0][0], b[0], b[1]);
      mma_bf16(y[0][n], a[0][1], b[2], b[3]);
      mma_bf16(y[1][n], a[1][0], b[0], b[1]);
      mma_bf16(y[1][n], a[1][1], b[2], b[3]);
    }
    __syncthreads();  // h and the w2 buffer are free
    if (c + 1 < nchunks) load_w2(f0 + kBF);
    cp_async_commit();
  }

  // epilogue: + b2 (+ residual), bf16 store
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + mt * 16 + g + 8 * half;
      if (row >= p.M) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = warp * (K / 8) + n * 8 + 2 * t;
        float v0 = y[mt][n][2 * half] + p.b2[col];
        float v1 = y[mt][n][2 * half + 1] + p.b2[col + 1];
        if constexpr (LN) {
          const __nv_bfloat162 res =
              *reinterpret_cast<const __nv_bfloat162*>(p.x + row * K + col);
          v0 += __bfloat162float(res.x);
          v1 += __bfloat162float(res.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + row * K + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int K, bool LN, bool SPILL>
cudaError_t launch(const MlpParams& p, cudaStream_t stream) {
  auto kernel = mlp_fwd_kernel<K, LN, SPILL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<K>::BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = (p.M + kBM - 1) / kBM;
  kernel<<<blocks, kThreads, Smem<K>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <bool LN, bool SPILL>
cudaError_t dispatch(const MlpParams& p, int K, cudaStream_t s) {
  switch (K) {
    case 128: return launch<128, LN, SPILL>(p, s);
    case 256: return launch<256, LN, SPILL>(p, s);
    case 384: return launch<384, LN, SPILL>(p, s);
    case 512: return launch<512, LN, SPILL>(p, s);
    case 768: return launch<768, LN, SPILL>(p, s);
    case 1024: return launch<1024, LN, SPILL>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, w1 (F, K), w2 (K, F), out, h (M, F): bf16; lnw, lnb, b1, b2: f32.
// ln != 0 selects K2 (LayerNorm prologue + residual); otherwise h != null
// selects K5a (K6 plus the pre-activation spill into h), h == null K6.
// Returns a cudaError_t.
extern "C" int smb_mlp_fwd(const void* x, const void* lnw, const void* lnb,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, void* h, int M, int K,
                           int F, float eps, int ln, int act, void* stream) {
  if (M <= 0 || F <= 0 || F % kBF != 0 || (act != 0 && act != 1) ||
      (ln && h != nullptr))
    return (int)cudaErrorInvalidValue;
  MlpParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.lnw = static_cast<const float*>(lnw);
  p.lnb = static_cast<const float*>(lnb);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.h = static_cast<__nv_bfloat16*>(h);
  p.M = M;
  p.F = F;
  p.eps = eps;
  p.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln) return (int)dispatch<true, false>(p, K, s);
  return (int)(h ? dispatch<false, true>(p, K, s) : dispatch<false, false>(p, K, s));
}
