// Fused transformer MLP backward for Hopper (sm_90a): the data-gradient pass
// over the spilled pre-activation (K5b).
//
// Replaces
//   K5b smb_vision_tpu/ops/mlp.py:_mlp_bwd_kernel
//
// What it computes, per row of g = dL/dy (M, K) and the pre-activation h =
// x w1 + b1 (M, F) that the training forward (K5a, mlp_fwd.cu) stored in
// bf16, F streamed in chunks:
//   a  = act(h)                  f32, stored bf16 (for dw2 = a^T g)
//   da = g w2^T                  w2 (F, K): the JAX layout
//   dh = da * act'(h)            f32, stored bf16 (for dw1 = x^T dh, db1)
//   dx += dh w1^T                w1 (K, F): the JAX layout; f32 registers
// dw1, dw2, db1 and db2 are left to plain products and sums outside the
// kernel, as in the JAX package. act' uses the real erf (the TPU kernel used
// the Abramowitz-Stegun stand-in, Mosaic having no erf).
//
// Bound on the H100: at M = 20,480, K = 384, F = 1,536 (the decoder) the
// two products are 4*M*K*F flops against the 3*M*F*2 bytes of h, dh and a
// and the 2*K*F weight bytes that every row block reads again from L2; the
// weight re-reads from L2, as for the forward (PERF.md), and the narrow
// mma.sync tiles are what hold it back.
//
// The design is the forward's (mlp_fwd.cu), with the roles of the operands
// exchanged: one block = 8 warps = 32 rows; the block's g rows (32 x K bf16)
// stay in shared memory for the whole F loop; per 32-column chunk of F
//   - phase 1: da (32 x 32) = g w2_chunk^T, one m16n8 tile per warp, then in
//     registers a and dh from the h the warp loaded from global memory; a
//     and dh go to global memory, dh (bf16) also to shared memory;
//   - phase 2: dx (32 x K) += dh w1_chunk, every warp owning K/8 output
//     columns in registers (2 x K/64 m16n8 tiles);
//   - the weight copies overlap the math with one buffer each: the next
//     chunk's w2 rows during this chunk's phase 2, and the next w1 columns
//     during the next chunk's phase 1.
// Rows past M load as zero and are not stored. K is a template parameter
// (128 .. 1024, as the forward); F must be a multiple of 32.
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

struct MlpBwdParams {
  const __nv_bfloat16* h;   // (M, F)
  const __nv_bfloat16* g;   // (M, K)
  const __nv_bfloat16* w1;  // (K, F)
  const __nv_bfloat16* w2;  // (F, K)
  __nv_bfloat16* dx;        // (M, K)
  __nv_bfloat16* dh;        // (M, F)
  __nv_bfloat16* a;         // (M, F)
  int M, F;
  int act;                  // 0: exact gelu, 1: tanh gelu
};

// (act(v), act'(v)) in f32
__device__ __forceinline__ float2 act_and_grad(float v, int act) {
  if (act == 0) {
    const float cdf = 0.5f * (1.f + erff(v * 0.70710678118654752f));
    const float pdf = 0.3989422804014327f * __expf(-0.5f * v * v);
    return make_float2(v * cdf, cdf + v * pdf);
  }
  const float c = 0.7978845608028654f;
  const float th = tanhf(c * (v + 0.044715f * v * v * v));
  const float du = c * (1.f + 3.f * 0.044715f * v * v);
  return make_float2(0.5f * v * (1.f + th),
                     0.5f * (1.f + th) + 0.5f * v * (1.f - th * th) * du);
}

template <int K>
struct Smem {
  static constexpr int XS = K + 8;     // g and w2 chunk row stride (elems)
  static constexpr int WS = kBF + 8;   // w1 chunk and dh row stride (elems)
  static constexpr int GS = 0;
  static constexpr int W2 = GS + kBM * XS;
  static constexpr int W1 = W2 + kBF * XS;
  static constexpr int DH = W1 + K * WS;
  static constexpr int ELEMS = DH + kBM * WS;
  static constexpr int BYTES = ELEMS * 2;
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_bwd_kernel(const MlpBwdParams p) {
  using S = Smem<K>;
  constexpr int NT = K / 64;  // n8 output tiles per warp (K/8 columns)
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* gs = smem + S::GS;
  __nv_bfloat16* w2s = smem + S::W2;
  __nv_bfloat16* w1s = smem + S::W1;
  __nv_bfloat16* dhs = smem + S::DH;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * kBM;

  auto load_w2 = [&](int f0) {  // w2 rows f0 .. f0 + kBF
    for (int c = tid; c < kBF * (K / 8); c += kThreads) {
      const int r = c / (K / 8), col = (c % (K / 8)) * 8;
      cp_async16(w2s + r * S::XS + col, p.w2 + (long long)(f0 + r) * K + col);
    }
  };
  auto load_w1 = [&](int f0) {  // w1 columns f0 .. f0 + kBF
    for (int c = tid; c < K * (kBF / 8); c += kThreads) {
      const int r = c / (kBF / 8), col = (c % (kBF / 8)) * 8;
      cp_async16(w1s + r * S::WS + col, p.w1 + (long long)r * p.F + f0 + col);
    }
  };
  load_w2(0);
  cp_async_commit();
  load_w1(0);
  cp_async_commit();

  // the block's g rows into shared memory (rows past M as zero)
  for (int c = tid; c < kBM * (K / 8); c += kThreads) {
    const int r = c / (K / 8), col = (c % (K / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < p.M)
      v = *reinterpret_cast<const uint4*>(p.g + (m0 + r) * K + col);
    *reinterpret_cast<uint4*>(gs + r * S::XS + col) = v;
  }

  float dx[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n) dx[mt][n][0] = dx[mt][n][1] = dx[mt][n][2] = dx[mt][n][3] = 0.f;

  const int pm = warp / 4, pn = warp % 4;  // phase-1 tile of this warp
  const long long hr0 = m0 + pm * 16 + g;  // its rows in h, dh, a
  const long long hr1 = hr0 + 8;
  const int nchunks = p.F / kBF;
  // ldmatrix row addresses: A fragments (16 x 16) and B fragments (8 x 32)
  const __nv_bfloat16* a1 = gs + (pm * 16 + (lane & 15)) * S::XS + (lane >> 4) * 8;
  const __nv_bfloat16* b1p = w2s + (pn * 8 + (lane & 7)) * S::XS + (lane >> 3) * 8;
  const __nv_bfloat16* b2p =
      w1s + (warp * (K / 8) + (lane & 7)) * S::WS + (lane >> 3) * 8;
  for (int c = 0; c < nchunks; ++c) {
    const int f0 = c * kBF;
    const int col = f0 + pn * 8 + 2 * t;
    // this warp's h values, loaded ahead of the product that needs them
    __nv_bfloat162 h0 = __floats2bfloat162_rn(0.f, 0.f), h1 = h0;
    if (hr0 < p.M)
      h0 = *reinterpret_cast<const __nv_bfloat162*>(p.h + hr0 * p.F + col);
    if (hr1 < p.M)
      h1 = *reinterpret_cast<const __nv_bfloat162*>(p.h + hr1 * p.F + col);
    cp_async_wait<1>();  // w2 chunk c has landed (w1 chunk c may be in flight)
    __syncthreads();

    // phase 1: da tile (rows pm*16.., cols pn*8..) = g w2_chunk^T; then
    // a = act(h) and dh = da * act'(h)
    {
      // four independent accumulators, as in the forward
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
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[i] = (part[0][i] + part[1][i]) + (part[2][i] + part[3][i]);
      const float2 r00 = act_and_grad(__bfloat162float(h0.x), p.act);
      const float2 r01 = act_and_grad(__bfloat162float(h0.y), p.act);
      const float2 r10 = act_and_grad(__bfloat162float(h1.x), p.act);
      const float2 r11 = act_and_grad(__bfloat162float(h1.y), p.act);
      const __nv_bfloat162 dh0 = __floats2bfloat162_rn(da[0] * r00.y, da[1] * r01.y);
      const __nv_bfloat162 dh1 = __floats2bfloat162_rn(da[2] * r10.y, da[3] * r11.y);
      const int lc = pn * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dhs + (pm * 16 + g) * S::WS + lc) = dh0;
      *reinterpret_cast<__nv_bfloat162*>(dhs + (pm * 16 + g + 8) * S::WS + lc) = dh1;
      if (hr0 < p.M) {
        *reinterpret_cast<__nv_bfloat162*>(p.dh + hr0 * p.F + col) = dh0;
        *reinterpret_cast<__nv_bfloat162*>(p.a + hr0 * p.F + col) =
            __floats2bfloat162_rn(r00.x, r01.x);
      }
      if (hr1 < p.M) {
        *reinterpret_cast<__nv_bfloat162*>(p.dh + hr1 * p.F + col) = dh1;
        *reinterpret_cast<__nv_bfloat162*>(p.a + hr1 * p.F + col) =
            __floats2bfloat162_rn(r10.x, r11.x);
      }
    }
    __syncthreads();  // dh written; the w2 buffer is free
    if (c + 1 < nchunks) load_w2(f0 + kBF);
    cp_async_commit();
    cp_async_wait<1>();  // w1 chunk c has landed
    __syncthreads();

    // phase 2: dx[:, warp's K/8 columns] += dh w1_chunk^T
    uint32_t a[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
        ldsm_x4(a[mt][kc], dhs + (mt * 16 + (lane & 15)) * S::WS + kc * 16 +
                               (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b[4];
      ldsm_x4(b, b2p + n * 8 * S::WS);
      mma_bf16(dx[0][n], a[0][0], b[0], b[1]);
      mma_bf16(dx[0][n], a[0][1], b[2], b[3]);
      mma_bf16(dx[1][n], a[1][0], b[0], b[1]);
      mma_bf16(dx[1][n], a[1][1], b[2], b[3]);
    }
    __syncthreads();  // dh and the w1 buffer are free
    if (c + 1 < nchunks) load_w1(f0 + kBF);
    cp_async_commit();
  }

  // epilogue: bf16 store of dx
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + mt * 16 + g + 8 * half;
      if (row >= p.M) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = warp * (K / 8) + n * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(p.dx + row * K + col) =
            __floats2bfloat162_rn(dx[mt][n][2 * half], dx[mt][n][2 * half + 1]);
      }
    }
  }
}

template <int K>
cudaError_t launch(const MlpBwdParams& p, cudaStream_t stream) {
  auto kernel = mlp_bwd_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<K>::BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = (p.M + kBM - 1) / kBM;
  kernel<<<blocks, kThreads, Smem<K>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// h (M, F), g (M, K), w1 (K, F), w2 (F, K), dx (M, K), dh and a (M, F): all
// bf16 and contiguous. Returns a cudaError_t (0 on success).
extern "C" int smb_mlp_bwd(const void* h, const void* g, const void* w1,
                           const void* w2, void* dx, void* dh, void* a, int M,
                           int K, int F, int act, void* stream) {
  if (M <= 0 || F <= 0 || F % kBF != 0 || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  MlpBwdParams p;
  p.h = static_cast<const __nv_bfloat16*>(h);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.dh = static_cast<__nv_bfloat16*>(dh);
  p.a = static_cast<__nv_bfloat16*>(a);
  p.M = M;
  p.F = F;
  p.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 128: return (int)launch<128>(p, s);
    case 256: return (int)launch<256>(p, s);
    case 384: return (int)launch<384>(p, s);
    case 512: return (int)launch<512>(p, s);
    case 768: return (int)launch<768>(p, s);
    case 1024: return (int)launch<1024>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
