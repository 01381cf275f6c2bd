// Attention half-block glue for Hopper (sm_90a): kernels K10a and K10b, on
// wgmma and TMA (the GEMM core of gemm_sm90.cuh).
//
// Replaces
//   K10a smb_vision_tpu/ops/attn_glue.py:_qkv_ln_kernel
//        q, k, v = LN(x) Wq + bq, LN(x) Wk + bk, LN(x) Wv + bv
//   K10b smb_vision_tpu/ops/attn_glue.py:_out_res_kernel
//        o = res + y Wo + bo     (LayerScale folded into Wo, bo by the caller)
//
// Numerics as the TPU kernels: LayerNorm statistics in f32 with var =
// E[x^2] - mean^2 (one pass; mlp_fwd.cu's K2 takes two), xn = (x - mean) *
// rsqrt(var + eps) * lnw + lnb rounded to bf16; bf16 operands, f32
// accumulation, the f32 bias (and for K10b the residual) added in f32, one
// rounding to bf16.
//
// Bound on the H100: K10a by operations, 2*M*K*3K (0.073 ms at M 20,480, K
// 768, at 989 TFLOP/s); K10b by bytes, res, y and o (3*M*K*2) plus Wo
// (0.029 ms at the same shape, at 3.35 TB/s). What holds them there on an
// H100 (chip_smoke.py; PERF.md has the times): K10a takes 0.17 ms, its
// GEMM at about 545 TFLOP/s (the GEMM core's rate) after an LN pass that
// moves its 63 MB at about 2.7 TB/s; K10b takes 0.06 ms, moving its bytes
// at about 1.8 TB/s, its 12 k-steps a tile too few to hide the epilogue.
//
// The TPU kernels kept all three (K, K) weights resident in VMEM and
// streamed rows, normalising each row block once. On Hopper a block cannot
// hold the 3K output columns of its rows (128 x 2,304 f32 at K 768 is 1.2
// MB), so each kernel is a tiled GEMM over 128 x 128 output tiles, two
// blocks an SM, so that one block's epilogue runs under the other's
// products (only K/64 k-steps a tile: 12 at K 768):
//   K10a = a LayerNorm row pass + one GEMM over N = 3K columns.
//     1. qkv_ln_rows_kernel writes xn = LN(x) in bf16 to the caller's
//        workspace, one warp a row, a runtime loop over the row past K
//        1,024 (so any K that is a multiple of 128 runs), so LN runs once
//        a row;
//     2. qkv_gemm_kernel: column tile t of 3K/128 lies in one of Wq, Wk, Wv
//        (K % 128 == 0); the tile selects its B tensor map, its bias and its
//        output map (selects of the __grid_constant__ parameters' addresses:
//        an array of them indexed at run time would be copied to the
//        stack). A is xn; B is the Linear weight (out, in) as it stands,
//        K-major, so no weight is copied. The epilogue adds the f32 bias,
//        rounds once and TMA-stores into q, k or v. Column tiles run
//        fastest in the grid, so the 3K/128 blocks of a row tile read its
//        xn from L2.
//     The host walks the rows in chunks of the workspace's rows (the
//     wrapper sizes it), so the workspace does not grow with M.
//   K10b = K2's second product with the residual's tile loaded by TMA
//     (mlp_fwd.cu, mlp_gemm_kernel<4, true>, through smb_gemm_residual): y
//     Wo^T over K; once it has issued the last k-step, the producer loads
//     the block's 128 x 128 tile of the residual into the ring stage the
//     products free, and the epilogue adds bo and the residual in f32 and
//     stages the result over it. (Read from global memory in the epilogue,
//     as K2 reads it, the residual made K10b 1.1-1.5x slower on an H100:
//     PERF.md.)
// Ragged M reads as zero through TMA and is not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

// mlp_fwd.cu: out = res + a b^T + bias, K2's second product
cudaError_t smb_gemm_residual(const void* a, const void* b, const float* bias,
                              const void* res, void* out, int rows, int n,
                              int kdim, cudaStream_t stream);

namespace {

constexpr int kLnWarps = 8;
constexpr int kLnKeep = 4;  // 8-column chunks a lane keeps: a row to K 1,024

__device__ __forceinline__ void ln_sums(const uint4& raw, float& sum,
                                        float& sq) {
  const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = __bfloat162float(e8[e]);
    sum += v;
    sq += v * v;
  }
}

// the 8 columns 8c .. 8c + 7 of a row, normalised and rounded to bf16
// (lnw, lnb 16-byte aligned: two float4 loads each)
__device__ __forceinline__ uint4 ln_norm(const uint4& raw, int c,
                                         const float* lnw, const float* lnb,
                                         float mean, float rstd) {
  const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
  const float4* w4 = reinterpret_cast<const float4*>(lnw) + 2 * c;
  const float4* b4 = reinterpret_cast<const float4*>(lnb) + 2 * c;
  const float4 wb[4] = {w4[0], w4[1], b4[0], b4[1]};
  const float* w = &wb[0].x;
  __align__(16) __nv_bfloat16 o8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    o8[e] = __float2bfloat16((__bfloat162float(e8[e]) - mean) * rstd * w[e] +
                             w[8 + e]);
  return *reinterpret_cast<const uint4*>(o8);
}

// xn = LN(x) rounded to bf16, one warp a row, one-pass f32 statistics. A
// lane keeps its first kLnKeep chunks of 8 columns in registers, so their
// loads issue together, and reads any further ones twice (the second time
// from L1), so any K that is a multiple of 8 runs.
__global__ void __launch_bounds__(kLnWarps * 32)
    qkv_ln_rows_kernel(const __nv_bfloat16* x, const float* lnw,
                       const float* lnb, __nv_bfloat16* xn, int rows, int K,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
  uint4* out = reinterpret_cast<uint4*>(xn + row * K);
  const int chunks = K / 8;
  uint4 keep[kLnKeep];
#pragma unroll
  for (int i = 0; i < kLnKeep; ++i)
    if (lane + 32 * i < chunks) keep[i] = xr[lane + 32 * i];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < kLnKeep; ++i)
    if (lane + 32 * i < chunks) ln_sums(keep[i], sum, sq);
  for (int c = lane + 32 * kLnKeep; c < chunks; c += 32)
    ln_sums(xr[c], sum, sq);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float mean = sum / K;
  const float rstd = rsqrtf(sq / K - mean * mean + eps);
#pragma unroll
  for (int i = 0; i < kLnKeep; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) out[c] = ln_norm(keep[i], c, lnw, lnb, mean, rstd);
  }
  for (int c = lane + 32 * kLnKeep; c < chunks; c += 32)
    out[c] = ln_norm(xr[c], c, lnw, lnb, mean, rstd);
}

struct QkvEpi {
  const float* bq;  // (K,) each
  const float* bk;
  const float* bv;
  int rows, K;
};

// tile (blockIdx.x, blockIdx.y) of [q | k | v] = xn [Wq | Wk | Wv]^T + b:
// ta maps xn (rows, K), tq/tk/tv the Linear weights (K, K), oq/ok/ov the
// outputs (rows, K)
__global__ void __launch_bounds__(kGemmThreads, 2)
    qkv_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap oq,
                    const __grid_constant__ CUtensorMap ok,
                    const __grid_constant__ CUtensorMap ov, const int ksteps,
                    const QkvEpi e) {
  extern __shared__ char smem_raw[];
  const GemmSmem s = gemm_smem_init(smem_raw);
  const int tiles = e.K / kGemmBN;  // column tiles of each of q, k, v
  const int which = blockIdx.x / tiles;
  const int n0 = (blockIdx.x - which * tiles) * kGemmBN;
  const int m0 = blockIdx.y * kGemmBM;
  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers)
      gemm_produce(s, &ta, which == 0 ? &tq : which == 1 ? &tk : &tv, m0, n0,
                   ksteps);
    return;
  }
  const int cw = threadIdx.x / kWG;
  float acc[kGemmAcc];
  gemm_consume(s, acc, cw, ksteps);

  gemm_release_ring();
  char* stage = s.ring + cw * kGemmHalf;
  const float* bias = (which == 0 ? e.bq : which == 1 ? e.bk : e.bv) + n0;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kGemmBN / 8; ++j) {
    const int c = 8 * j + 2 * t;  // K % 128 == 0: every column is in
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half)
      gemm_stage(stage, warp * 16 + g + 8 * half, c,
                 __floats2bfloat162_rn(acc[4 * j + 2 * half] + b0,
                                       acc[4 * j + 2 * half + 1] + b1));
  }
  fence_proxy_async();
  named_sync(2 + cw, kWG);
  if (threadIdx.x % kWG == 0) {
    gemm_store(which == 0 ? &oq : which == 1 ? &ok : &ov, stage,
               m0 + cw * 64, n0, e.rows, e.K);
    gemm_store_wait();
  }
}

bool shape_ok(int M, int K) { return M > 0 && K > 0 && K % 128 == 0; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// K10a. x (M, K) bf16; lnw, lnb, bq, bk, bv f32 (K,); wq, wk, wv bf16 (K,
// K) in the Linear layout (out, in), contiguous; q, k, v bf16 (M, K). K a
// multiple of 128. The rows run in chunks of `chunk` rows through the
// caller's bf16 workspace xn (chunk, K), which holds LN(x). Every bf16
// matrix passes through TMA and lnw, lnb are read as float4, so their
// addresses must be 16-byte aligned. The
// workspace arguments come last, so a caller that passes them to an older
// library of this interface (which takes none) still runs.
// Returns a cudaError_t.
extern "C" int smb_qkv_ln_fwd(const void* x, const void* lnw, const void* lnb,
                              const void* wq, const void* wk, const void* wv,
                              const void* bq, const void* bk, const void* bv,
                              void* q, void* k, void* v, int M, int K,
                              float eps, void* stream, void* xn, int chunk) {
  if (!shape_ok(M, K) || xn == nullptr || chunk <= 0 || !aligned16(x) ||
      !aligned16(lnw) || !aligned16(lnb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* outs[3] = {static_cast<__nv_bfloat16*>(q),
                            static_cast<__nv_bfloat16*>(k),
                            static_cast<__nv_bfloat16*>(v)};
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map_2d(&tq, wq, K, K, K, kGemmBN);
  if (err == cudaSuccess) err = make_map_2d(&tk, wk, K, K, K, kGemmBN);
  if (err == cudaSuccess) err = make_map_2d(&tv, wv, K, K, K, kGemmBN);
  auto kernel = qkv_gemm_kernel;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  for (int m = 0; m < M && err == cudaSuccess; m += chunk) {
    const int rows = M - m < chunk ? M - m : chunk;
    qkv_ln_rows_kernel<<<(rows + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0,
                         s>>>(xb + (long long)m * K,
                              static_cast<const float*>(lnw),
                              static_cast<const float*>(lnb),
                              static_cast<__nv_bfloat16*>(xn), rows, K, eps);
    err = cudaGetLastError();
    CUtensorMap ta, to[3];
    if (err == cudaSuccess) err = make_map_2d(&ta, xn, rows, K, K, kGemmBM);
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
      err = make_map_2d(&to[i], outs[i] + (long long)m * K, rows, K, K, 64);
    if (err != cudaSuccess) break;
    const QkvEpi e{static_cast<const float*>(bq),
                   static_cast<const float*>(bk),
                   static_cast<const float*>(bv), rows, K};
    const dim3 grid(3 * K / kGemmBN, (rows + kGemmBM - 1) / kGemmBM);
    kernel<<<grid, kGemmThreads, kGemmSmem, s>>>(
        ta, tq, tk, tv, to[0], to[1], to[2], K / kGemmBK, e);
    err = cudaGetLastError();
  }
  return (int)err;
}

// K10b. res, y (M, K) bf16; wo bf16 (K, K) in the Linear layout (out, in),
// contiguous; bo f32 (K,); out bf16 (M, K). K a multiple of 128; every
// bf16 matrix 16-byte aligned (TMA). Returns a cudaError_t.
extern "C" int smb_out_res_fwd(const void* res, const void* y, const void* wo,
                               const void* bo, void* out, int M, int K,
                               void* stream) {
  if (!shape_ok(M, K)) return (int)cudaErrorInvalidValue;
  return (int)smb_gemm_residual(y, wo, static_cast<const float*>(bo), res,
                                out, M, K, K,
                                static_cast<cudaStream_t>(stream));
}
