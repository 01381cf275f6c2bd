// Fused transformer MLP backward for Hopper (sm_90a): the data-gradient pass
// over the spilled pre-activation (K5b), as two wgmma + TMA GEMMs on the
// core of gemm_sm90.cuh.
//
// Replaces
//   K5b smb_vision_tpu/ops/mlp.py:_mlp_bwd_kernel
//
// What it computes from g = dL/dy (M, K) and the pre-activation h = x w1 +
// b1 (M, F) that the training forward (K5a, mlp_fwd.cu) stored in bf16:
//   a  = act(h)                  f32, stored bf16 (for dw2 = a^T g)
//   da = g w2^T                  w2 (F, K) in the JAX layout
//   dh = da * act'(h)            f32, stored bf16 (for dw1 = x^T dh, db1)
//   dx = dh w1^T                 w1 (K, F) in the JAX layout; f32, one
//                                rounding
// dw1, dw2, db1 and db2 are left to plain products and sums outside the
// kernel, as in the JAX package. act' uses the real erf (the TPU kernel used
// the Abramowitz-Stegun stand-in, Mosaic having no erf). The rounding points
// are the TPU kernel's: a is rounded from the f32 h, dh is rounded to bf16
// before the second product, dx accumulates in f32.
//
// Bound on the H100: at M = 7,168, K = 768, F = 3,072 (the MIM encoder) the
// two products are 4*M*K*F = 67.6 GFLOP, 0.068 ms at 989 TFLOP/s; h, a, dh
// (M x F), g, dx (M x K) and the weights are 155 MB, 0.046 ms at 3.35 TB/s.
// The operations bound it.
//
// The TPU kernel owned whole rows of dx and streamed F through them; on
// Hopper a row block small enough to hold whole output rows reads both
// weights again from L2 for every few rows (the former 32-row design read
// 2.1 GB from L2 at the shape above). So the function runs as two tiled
// products over 128 x 128 output tiles (gemm_sm90.cuh: two consumer
// warpgroups and a producer warp, a 3-stage TMA ring, two blocks an SM):
//   1. da = g w2^T over K, tiles over (M, F); A is g, B is w2 read from
//      the Linear weight w2^T (K, F) as it stands (MN-major: kBCols of
//      gemm_sm90.cuh). Once it has issued the last k-step, the producer
//      loads the block's 128 x 128 tile of h by TMA into the ring stage
//      the k-loop would have used next, as soon as the consumers free it,
//      so the tile lands while the last products run. The epilogue takes
//      act and act' of each element of h in f32, multiplies da by act',
//      and stages a and dh in bf16 in the TMA layout in the other two
//      stages; one thread of each warpgroup stores both by TMA. h, a and
//      dh fill the freed ring: a 32 KB stage each, so two blocks still
//      share an SM.
//   2. dx = dh w1^T over F, tiles over (M, K); A is the dh that phase 1
//      just wrote (an output of K5b, so no workspace), B is w1 read from
//      the Linear weight w1^T (F, K) as it stands (MN-major). The
//      epilogue rounds once and stores by TMA.
// Reading the Linear weights MN-major spares the wrapper a transposed copy
// of each weight a call (the model holds them as nn.Linear weights).
// Ragged M, F and contraction tails read as zero through TMA and are not
// stored (a weight panel wholly past F is not loaded: it feeds only
// columns that are not stored). K is any multiple of 128 (the JAX kernels'
// rule) and F a multiple of 32: phase 1 takes K as its count of k-steps
// (K / 64, the ring reused round by round), phase 2 as its count of output
// columns (K / 128 tiles), and neither holds anything of K's size.
//
// What holds it at about a third of the bound on an H100 (chip_smoke.py
// times it beside its cuBLAS chain; PERF.md has the times): phase 1 moves
// three M x F bf16 tensors (h in, a and dh out: 132 MB at the shape above,
// 0.04 ms at the HBM rate) and takes erff and expf of every element in its
// epilogue, which the second block of an SM hides only in part; phase 2 is
// a plain product whose 336 tiles at the shape above fill 1.27 waves of
// the 264 two-per-SM slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

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

// the rows and columns of the output (phase 1: M x F, phase 2: M x K)
struct BwdEpi {
  int rows, n;
  int act;  // 0: exact gelu, 1: tanh gelu
};

// PHASE 1: A = g, B^T = w2^T; to = dh, tact = a, th = h (read).
// PHASE 2: A = dh, B^T = w1^T; to = dx.
template <int PHASE>
__global__ void __launch_bounds__(kGemmThreads, 2)
    mlp_bwd_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap to,
                        const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap tact,
                        const int ksteps, const BwdEpi e) {
  __shared__ uint64_t hbar;  // h's tile has landed
  extern __shared__ char smem_raw[];
  if (PHASE == 1 && threadIdx.x == 0) mbar_init(&hbar, 1);
  const GemmSmem s = gemm_smem_init(smem_raw);  // fences hbar's init too
  const int n0 = blockIdx.x * kGemmBN, m0 = blockIdx.y * kGemmBM;
  const int sh = ksteps % kGemmStages;  // the stage after the last k-step
  char* hbuf = s.ring + sh * kGemmStage;
  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      gemm_produce<kBCols>(s, &ta, &tb, m0, n0, ksteps, nullptr, e.n);
      if constexpr (PHASE == 1) {
        if (ksteps >= kGemmStages)  // the consumers have freed stage sh
          mbar_wait(&s.empty[sh], ((ksteps / kGemmStages) & 1) ^ 1);
        gemm_load_tile(&th, hbuf, &hbar, m0, n0, e.rows, e.n);
      }
    }
    return;
  }
  const int cw = threadIdx.x / kWG;
  float acc[kGemmAcc];
  gemm_consume<kBCols>(s, acc, cw, ksteps);

  gemm_release_ring();
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (PHASE == 2) {
    char* stage = s.ring + cw * kGemmHalf;
#pragma unroll
    for (int j = 0; j < kGemmBN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        gemm_stage(stage, warp * 16 + g + 8 * half, 8 * j + 2 * t,
                   __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                         acc[4 * j + 2 * half + 1]));
    fence_proxy_async();
    named_sync(2 + cw, kWG);
    if (threadIdx.x % kWG == 0) {
      gemm_store(&to, stage, m0 + cw * 64, n0, e.rows, e.n);
      gemm_store_wait();
    }
    return;
  }
  // a and dh go to the two stages that h does not hold
  const int sa = (sh + 1) % kGemmStages, sd = (sh + 2) % kGemmStages;
  char* stage_a = s.ring + sa * kGemmStage + cw * kGemmHalf;
  char* stage_d = s.ring + sd * kGemmStage + cw * kGemmHalf;
  const char* hw = hbuf + cw * kGemmHalf;
  mbar_wait(&hbar, 0);
#pragma unroll
  for (int j = 0; j < kGemmBN / 8; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = warp * 16 + g + 8 * half;  // of the warpgroup's 64
      const __nv_bfloat162 hv = gemm_unstage(hw, rr, c);
      const float2 r0 = act_and_grad(__bfloat162float(hv.x), e.act);
      const float2 r1 = act_and_grad(__bfloat162float(hv.y), e.act);
      gemm_stage(stage_a, rr, c, __floats2bfloat162_rn(r0.x, r1.x));
      gemm_stage(stage_d, rr, c,
                 __floats2bfloat162_rn(acc[4 * j + 2 * half] * r0.y,
                                       acc[4 * j + 2 * half + 1] * r1.y));
    }
  }
  fence_proxy_async();
  named_sync(2 + cw, kWG);
  if (threadIdx.x % kWG == 0) {
    gemm_store(&to, stage_d, m0 + cw * 64, n0, e.rows, e.n);
    gemm_store(&tact, stage_a, m0 + cw * 64, n0, e.rows, e.n);
    gemm_store_wait();
  }
}

template <int PHASE>
cudaError_t launch_bwd(const CUtensorMap& ta, const CUtensorMap& tb,
                       const CUtensorMap& to, const CUtensorMap& th,
                       const CUtensorMap& tact, int ksteps, const BwdEpi& e,
                       cudaStream_t stream) {
  auto kernel = mlp_bwd_gemm_kernel<PHASE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((e.n + kGemmBN - 1) / kGemmBN,
                  (e.rows + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(ta, tb, to, th, tact,
                                                    ksteps, e);
  return cudaGetLastError();
}

}  // namespace

// h (M, F), g (M, K), w1t = w1^T (F, K) and w2t = w2^T (K, F) (the Linear
// layouts of fc1 and fc2), dx (M, K), dh and a (M, F): all bf16, contiguous
// and 16-byte aligned (every one passes through TMA).
// Returns a cudaError_t (0 on success).
extern "C" int smb_mlp_bwd(const void* h, const void* g, const void* w1t,
                           const void* w2t, void* dx, void* dh, void* a,
                           int M, int K, int F, int act, void* stream) {
  if (M <= 0 || F <= 0 || F % 32 != 0 || K <= 0 || K % 128 != 0 ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // phase 1: da = g w2^T, then a and dh
  CUtensorMap tg, tw2, th, tdh, ta;
  cudaError_t err = make_map_2d(&tg, g, M, K, K, kGemmBM);
  if (err == cudaSuccess) err = make_map_2d(&tw2, w2t, K, F, F, kGemmBK);
  if (err == cudaSuccess) err = make_map_2d(&th, h, M, F, F, 64);
  if (err == cudaSuccess) err = make_map_2d(&tdh, dh, M, F, F, 64);
  if (err == cudaSuccess) err = make_map_2d(&ta, a, M, F, F, 64);
  if (err == cudaSuccess)
    err = launch_bwd<1>(tg, tw2, tdh, th, ta, K / kGemmBK, BwdEpi{M, F, act},
                        s);
  // phase 2: dx = dh w1^T
  CUtensorMap tdh_a, tw1, tdx;
  if (err == cudaSuccess) err = make_map_2d(&tdh_a, dh, M, F, F, kGemmBM);
  if (err == cudaSuccess) err = make_map_2d(&tw1, w1t, F, K, K, kGemmBK);
  if (err == cudaSuccess) err = make_map_2d(&tdx, dx, M, K, K, 64);
  if (err == cudaSuccess)
    err = launch_bwd<2>(tdh_a, tw1, tdx, tdx, tdx,
                        (F + kGemmBK - 1) / kGemmBK, BwdEpi{M, K, act}, s);
  return (int)err;
}
