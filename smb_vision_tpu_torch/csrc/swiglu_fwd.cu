// SwiGLU MLP half-block forward for Hopper (sm_90a): kernel K9.
//
// Replaces
//   K9 smb_vision_tpu/ops/mlp.py:_swiglu_block_kernel
//      y = x + (silu(xn w1a + b1a) * (xn w1b + b1b)) w2 + b2,  xn = LN(x)
// the DINOv2 use_swiglu_ffn feed-forward with its LayerNorm prologue and
// residual epilogue (LayerScale folds into w2 and b2 at the caller).
//
// Numerics as the TPU kernel: LayerNorm statistics, scale and bias in f32
// (two-pass variance; the TPU kernel takes E[x^2] - mean^2), xn rounded to
// bf16; h1 and h2 accumulated in f32 plus their f32 biases; g = silu(h1) *
// h2 in f32, rounded to bf16 before the w2 product; f32 accumulation, then
// the residual and b2 in f32, stored as bf16. The (M, 2F) and (M, F)
// intermediates never leave the SM.
//
// Bound on the H100: 6*M*K*F flops (148 GFLOP at M 3,922, K 1,536, F 4,096:
// 0.150 ms at the dense bf16 peak) against 3*K*F weight elements, which
// every row block reads again from L2.
//
// Why not K2's design (mlp_fwd.cu): at K = 1,536 a 32-row block's f32
// output accumulator is 192 floats a thread, and xn, whole rows of w1a and
// w1b and a w2 chunk need 419 KB of shared memory against 227 KB. So:
//   - one block = 8 warps = 16 rows; the f32 accumulator (16 x K) is K/16
//     floats a thread (96 at K = 1,536) and stays in registers for the
//     whole F loop; xn (16 x K bf16) stays in shared memory;
//   - F streams in chunks of 32 columns. Within a chunk the weights stream
//     through ONE ring of 4 shared-memory stages, 3 copies in flight
//     (cp.async), one barrier per stage:
//       K/128 "w1 slices" (rows f0..f0+32 of w1a and of w1b, 128 K-columns
//       each): warp w accumulates one 16x8 tile of h1 (w < 4) or h2
//       (w >= 4) over the whole of K in registers;
//       g = silu(h1) * h2 meets in shared memory (warps 0-3 leave silu(h1)
//       in f32, warps 4-7 multiply it by their h2) and is stored as bf16;
//       K/RS "w2 slices" (RS output columns x the chunk's 32 rows of w2):
//       in every slice each warp owns RS/8 of the columns, so all warps
//       work on every slice, and warp w's accumulator holds columns
//       q*RS + w*RS/8 .. + RS/8 of every slice q;
//   - epilogue: + b2 + residual x in f32, bf16 store.
// Weights come in PyTorch's Linear layout: weights_in (2F, K), whose rows
// 0..F-1 are w1a^T and F..2F-1 are w1b^T, and weights_out (K, F). Every
// fragment is loaded by ldmatrix; rows are padded by 16 bytes so the 8 row
// addresses of an ldmatrix hit distinct banks. Ragged M: rows past M load
// as zero and are not stored. K is a template parameter (128, 256, 384,
// 512, 768, 1,024, 1,536); F must be a multiple of 32.
// Not yet done (later work): wgmma, a larger row block (this one reads all
// weights from L2 again for every 16 rows), TMA multicast of the weight
// slices to a cluster of row blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16;     // rows per block
constexpr int kBF = 32;     // F columns per chunk
constexpr int kKS = 128;    // K columns per w1 slice
constexpr int kStages = 4;  // ring stages: kStages - 1 copies in flight

struct SwigluParams {
  const __nv_bfloat16* x;    // (M, K)
  const float* lnw;          // (K,)
  const float* lnb;          // (K,)
  const __nv_bfloat16* w1;   // (2F, K): the rows of w1a^T, then of w1b^T
  const float* b1;           // (2F,)
  const __nv_bfloat16* w2;   // (K, F)
  const float* b2;           // (K,)
  __nv_bfloat16* out;        // (M, K)
  int M, F;
  float eps;
};

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

template <int K>
struct SwSmem {
  static constexpr int RS = K % 256 == 0 ? 256 : 128;  // w2 slice columns
  static constexpr int XS = K + 8;     // xn row stride (elements)
  static constexpr int W1S = kKS + 8;  // w1 slice row stride
  static constexpr int WS = kBF + 8;   // w2 slice and g row stride
  static constexpr int W1_ELEMS = 2 * kBF * W1S;
  static constexpr int W2_ELEMS = RS * WS;
  static constexpr int STAGE = W1_ELEMS > W2_ELEMS ? W1_ELEMS : W2_ELEMS;
  static constexpr int XN = 0;
  static constexpr int RING = XN + kBM * XS;
  static constexpr int GS = RING + kStages * STAGE;
  static constexpr int ELEMS = GS + kBM * WS;
  static constexpr int HB = ELEMS * 2;  // byte offset of the f32 silu(h1)
  static constexpr int BYTES = HB + kBM * kBF * 4;
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    swiglu_fwd_kernel(const SwigluParams p) {
  using S = SwSmem<K>;
  constexpr int RS = S::RS;
  constexpr int NS1 = K / kKS;      // w1 slices per chunk
  constexpr int NS2 = K / RS;       // w2 slices per chunk
  constexpr int NI = NS1 + NS2;     // ring items per chunk
  constexpr int CW = RS / kWarps;   // a warp's columns in one w2 slice
  static_assert(K % kKS == 0 && K % RS == 0 && CW % 8 == 0, "K");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xn = smem + S::XN;
  __nv_bfloat16* ring = smem + S::RING;
  __nv_bfloat16* gs = smem + S::GS;
  float* hb = reinterpret_cast<float*>(smem_raw + S::HB);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int nchunks = p.F / kBF;
  const int nitems = nchunks * NI;

  // ring item v of chunk v / NI: a w1 slice (i < NS1) or a w2 slice
  auto issue = [&](int v) {
    if (v < nitems) {
      const int c = v / NI, i = v % NI, f0 = c * kBF;
      __nv_bfloat16* dst = ring + (v % kStages) * S::STAGE;
      if (i < NS1) {
        const int k0 = i * kKS;
        for (int e = tid; e < 2 * kBF * (kKS / 8); e += kThreads) {
          const int r = e / (kKS / 8), col = (e % (kKS / 8)) * 8;
          const int src = r < kBF ? f0 + r : p.F + f0 + (r - kBF);
          cp_async16(dst + r * S::W1S + col,
                     p.w1 + (long long)src * K + k0 + col);
        }
      } else {
        const int r0 = (i - NS1) * RS;
        for (int e = tid; e < RS * (kBF / 8); e += kThreads) {
          const int r = e / (kBF / 8), col = (e % (kBF / 8)) * 8;
          cp_async16(dst + r * S::WS + col,
                     p.w2 + (long long)(r0 + r) * p.F + f0 + col);
        }
      }
    }
    cp_async_commit();
  };
  for (int v = 0; v < kStages - 1; ++v) issue(v);

  // prologue: xn = LN(x) for the block's rows, 2 rows per warp
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
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / K;
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
    const float rstd = rsqrtf(sq / K + p.eps);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + 32 * i;
      if (c < K / 8) {
        __align__(16) __nv_bfloat16 o8[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o8[e] = __float2bfloat16((v[i][e] - mean) * rstd * p.lnw[c * 8 + e] +
                                   p.lnb[c * 8 + e]);
        *reinterpret_cast<uint4*>(xn + r * S::XS + c * 8) =
            *reinterpret_cast<const uint4*>(o8);
      }
    }
  }

  float y[NS2][CW / 8][4];
#pragma unroll
  for (int q = 0; q < NS2; ++q)
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
      y[q][n][0] = y[q][n][1] = y[q][n][2] = y[q][n][3] = 0.f;

  // phase-1 tile of this warp: h1 (half 0) or h2 (half 1), columns tile*8..
  const int half = warp >> 2, tile = warp & 3;
  // ldmatrix row addresses: A fragments (16 x 16), B fragments (8 x 32)
  const __nv_bfloat16* a1 = xn + (lane & 15) * S::XS + (lane >> 4) * 8;
  const __nv_bfloat16* ga = gs + (lane & 15) * S::WS + (lane >> 4) * 8;
  const int b1off =
      (half * kBF + tile * 8 + (lane & 7)) * S::W1S + (lane >> 3) * 8;
  const int b2off = (warp * CW + (lane & 7)) * S::WS + (lane >> 3) * 8;

  // wait for ring item v; the barrier also frees the stage of item v - 1,
  // which the copy of item v + kStages - 1 then refills
  auto advance = [&](int v) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(v + kStages - 1);
    return ring + (v % kStages) * S::STAGE;
  };

  int v = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int f0 = c * kBF;
    // four independent accumulators: one chain of dependent mma would
    // leave the tensor cores waiting on their own latency
    float part[4][4] = {};
    for (int i = 0; i < NS1; ++i, ++v) {
      const __nv_bfloat16* bp = advance(v) + b1off;
      const __nv_bfloat16* ap = a1 + i * kKS;
#pragma unroll
      for (int kk = 0; kk < kKS / 32; ++kk) {
        uint32_t b[4], a[4];
        ldsm_x4(b, bp + kk * 32);
        ldsm_x4(a, ap + kk * 32);
        mma_bf16(part[(kk & 1) * 2], a, b[0], b[1]);
        ldsm_x4(a, ap + kk * 32 + 16);
        mma_bf16(part[(kk & 1) * 2 + 1], a, b[2], b[3]);
      }
    }
    {
      // h tile + bias; g = silu(h1) * h2 meets in shared memory
      const int col = tile * 8 + 2 * t;
      const float* bias = p.b1 + half * p.F + f0 + col;
      float h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = (part[0][i] + part[1][i]) + (part[2][i] + part[3][i]) +
               bias[i & 1];
      float* h0 = hb + g * kBF + col;
      float* h8 = hb + (g + 8) * kBF + col;
      if (half == 0) {
        h0[0] = silu(h[0]);
        h0[1] = silu(h[1]);
        h8[0] = silu(h[2]);
        h8[1] = silu(h[3]);
      }
      __syncthreads();
      if (half == 1) {
        *reinterpret_cast<__nv_bfloat162*>(gs + g * S::WS + col) =
            __floats2bfloat162_rn(h0[0] * h[0], h0[1] * h[1]);
        *reinterpret_cast<__nv_bfloat162*>(gs + (g + 8) * S::WS + col) =
            __floats2bfloat162_rn(h8[0] * h[2], h8[1] * h[3]);
      }
      // the barrier of the next ring item publishes g
    }
    uint32_t ag[2][4];
#pragma unroll
    for (int q = 0; q < NS2; ++q, ++v) {
      const __nv_bfloat16* bp = advance(v) + b2off;
      if (q == 0) {
        ldsm_x4(ag[0], ga);
        ldsm_x4(ag[1], ga + 16);
      }
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        uint32_t b[4];
        ldsm_x4(b, bp + n * 8 * S::WS);
        mma_bf16(y[q][n], ag[0], b[0], b[1]);
        mma_bf16(y[q][n], ag[1], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();  // the groups still open are empty

  // epilogue: + b2 + residual, bf16 store
#pragma unroll
  for (int q = 0; q < NS2; ++q) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = m0 + g + 8 * hh;
      if (row >= p.M) continue;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        const int col = q * RS + warp * CW + n * 8 + 2 * t;
        const __nv_bfloat162 res =
            *reinterpret_cast<const __nv_bfloat162*>(p.x + row * K + col);
        const float v0 = y[q][n][2 * hh] + p.b2[col] + __bfloat162float(res.x);
        const float v1 =
            y[q][n][2 * hh + 1] + p.b2[col + 1] + __bfloat162float(res.y);
        *reinterpret_cast<__nv_bfloat162*>(p.out + row * K + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int K>
cudaError_t launch(const SwigluParams& p, cudaStream_t stream) {
  auto kernel = swiglu_fwd_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SwSmem<K>::BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = (p.M + kBM - 1) / kBM;
  kernel<<<blocks, kThreads, SwSmem<K>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x, w1 (2F, K), w2 (K, F), out: bf16; lnw, lnb, b1 (2F), b2: f32.
// Returns a cudaError_t.
extern "C" int smb_swiglu_fwd(const void* x, const void* lnw, const void* lnb,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, int M, int K, int F,
                              float eps, void* stream) {
  if (M <= 0 || F <= 0 || F % kBF != 0) return (int)cudaErrorInvalidValue;
  SwigluParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.lnw = static_cast<const float*>(lnw);
  p.lnb = static_cast<const float*>(lnb);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.F = F;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 128: return (int)launch<128>(p, s);
    case 256: return (int)launch<256>(p, s);
    case 384: return (int)launch<384>(p, s);
    case 512: return (int)launch<512>(p, s);
    case 768: return (int)launch<768>(p, s);
    case 1024: return (int)launch<1024>(p, s);
    case 1536: return (int)launch<1536>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
