// W8A8 product for Hopper (sm_90a): y = f32(x8 w8^T) * (sx sw) (+ bias) on
// int8 wgmma and TMA, on the GEMM core of gemm_sm90.cuh.
//
// Replaces the XLA product of the JAX package (no Pallas kernel):
//   smb_vision_tpu/ops/quant.py:w8a8_dot, lines 56-59 (the s8 x s8 -> s32
//   dot_general and its dequantisation), and models/layers.py:QuantDense's
//   bias add (line 59),
// and on the same codes it is exactly ops/quant.py::w8a8_linear_plain, bit
// for bit: the int32 sum is exact, and the epilogue takes QuantDense's
// steps one IEEE operation at a time (no FMA contraction):
//   y = f32(acc) * (sx[row] * sw[col])        (the scales multiplied first)
//   y = round_to_out(y)                       (bf16 or f32)
//   y = round_to_out(y + bias[col])           (bias in the output dtype)
//
// The codes come from quant.cu's w8a8_rows_kernel: x8 (rows, kp) and w8
// (n, kp) int8, K-major (contiguous along the contraction), kp a multiple
// of 16 with zeros past K. Integer wgmma reads both operands K-major,
// which is what both already are.
//
// Bound on the H100 at M = 20,480 (ViT-Base at 512^2 x 320): fc1 (768 ->
// 3,072) and fc2 (3,072 -> 768) are 2*M*K*N = 96.6 G integer operations
// each, 0.049 ms at 1,979 TOP/s, against 0.041 ms (fc1) of bytes at 3.35
// TB/s; q, k, v, o (768 -> 768) are bound by their bytes (0.0143 ms each).
//
// Design: gemm_sm90.cuh's block, unchanged in its producer, ring and
// stores: 128 x 128 output tiles, two consumer warpgroups of 64 rows and a
// producer warp, three stages of 32 KB, two blocks an SM. The codes travel
// through TMA as pairs, one 16-bit element per two codes, so the core's
// boxes of 64 elements by 128 rows are 128-byte panels of 128 codes, its
// k-steps 128 contraction columns (make_map_codes): gemm_produce reads
// them as it reads bf16. A k-step is four wgmma m64n128k32 .s32.s8.s8 a
// warpgroup with both operands in shared memory (the 128-byte swizzle,
// a k32 step 32 bytes on, as K3 reads its d-128 int8 tiles), into a 64 x
// 128 s32 accumulator (64 registers a thread, as the bf16 core's f32 one).
// The epilogue dequantises in registers; a bf16 tile is staged in the
// freed ring and stored by TMA (gemm_stage, gemm_store), an f32 one is
// written straight from registers (the f32 path serves float32 models,
// not the bf16 serving path). Rows and columns past the edge read as zero
// and are not stored, so every shape runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

struct W8A8Epi {
  const float* sx;   // (rows,) the activations' scales
  const float* sw;   // (n,) the weight's
  const void* bias;  // (n,) in the output dtype, or null
  void* out;         // f32 path: (rows, n), rows ld elements apart
  int rows, n;
  long long ld;
};

// consumer warpgroup cw: acc = (its 64 rows of x8) w8^T over all k-steps,
// four k32 steps of int8 wgmma a stage; lane 0 of each warp frees a stage
// once the warp's wgmma that read it have completed (as gemm_consume)
__device__ __forceinline__ void w8a8_consume(const GemmSmem& s,
                                             uint32_t (&acc)[kGemmAcc],
                                             int cw, int ksteps) {
#pragma unroll
  for (int i = 0; i < kGemmAcc; ++i) acc[i] = 0u;
  const uint32_t ring = smem_u32(s.ring);
  const bool signals = (threadIdx.x & 31) == 0;
  for (int k = 0; k < ksteps; ++k) {
    const int st = k % kGemmStages;
    mbar_wait(&s.full[st], (k / kGemmStages) & 1);
    const uint32_t a = ring + st * kGemmStage + cw * 64 * 128;
    const uint32_t b = ring + st * kGemmStage + kGemmTileA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 128 / 32; ++kk)
      wgmma_i8<kGemmBN>(acc, desc_sw128(a + kk * 32),
                        desc_sw128(b + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the group of step k - 1 is done: free its stage
    if (k > 0 && signals) mbar_arrive(&s.empty[(k - 1) % kGemmStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// f32(acc) * (sx * sw), one rounding each
__device__ __forceinline__ float dequant(uint32_t acc, float sx, float sw) {
  return __fmul_rn(__int2float_rn(static_cast<int>(acc)), __fmul_rn(sx, sw));
}

// y rounded to bf16, then + bias (bf16) rounded again
__device__ __forceinline__ __nv_bfloat16 to_bf16(float y, bool has_bias,
                                                 float b) {
  const __nv_bfloat16 o = __float2bfloat16_rn(y);
  return has_bias ? __float2bfloat16_rn(__fadd_rn(__bfloat162float(o), b))
                  : o;
}

template <bool F32>
__global__ void __launch_bounds__(kGemmThreads, 2)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap to,
                     const int ksteps, const W8A8Epi e) {
  extern __shared__ char smem_raw[];
  const GemmSmem s = gemm_smem_init(smem_raw);
  const int n0 = blockIdx.x * kGemmBN;
  const int m0 = blockIdx.y * kGemmBM;
  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) gemm_produce(s, &ta, &tb, m0, n0, ksteps);
    return;
  }
  const int cw = threadIdx.x / kWG;
  uint32_t acc[kGemmAcc];
  w8a8_consume(s, acc, cw, ksteps);

  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool has_bias = e.bias != nullptr;
  float sx[2];  // the scales of this thread's two rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + cw * 64 + warp * 16 + g + 8 * half;
    sx[half] = r < e.rows ? e.sx[r] : 0.f;
  }
  if constexpr (F32) {
    float* out = static_cast<float*>(e.out);
    const float* bias = static_cast<const float*>(e.bias);
#pragma unroll
    for (int j = 0; j < kGemmBN / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = n0 + 8 * j + 2 * t + u;
        if (col >= e.n) continue;
        const float sw = e.sw[col];
        const float b = has_bias ? bias[col] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + cw * 64 + warp * 16 + g + 8 * half;
          if (r >= e.rows) continue;
          float y = dequant(acc[4 * j + 2 * half + u], sx[half], sw);
          if (has_bias) y = __fadd_rn(y, b);
          out[(long long)r * e.ld + col] = y;
        }
      }
    return;
  }
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(e.bias);
  gemm_release_ring();
  char* stage = s.ring + cw * kGemmHalf;
#pragma unroll
  for (int j = 0; j < kGemmBN / 8; ++j) {
    const int c = 8 * j + 2 * t, col = n0 + c;
    const bool in0 = col < e.n, in1 = col + 1 < e.n;
    const float sw0 = in0 ? e.sw[col] : 0.f, sw1 = in1 ? e.sw[col + 1] : 0.f;
    const float b0 = has_bias && in0 ? __bfloat162float(bias[col]) : 0.f;
    const float b1 = has_bias && in1 ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * j + 2 * half;
      __nv_bfloat162 v;
      v.x = to_bf16(dequant(acc[i], sx[half], sw0), has_bias, b0);
      v.y = to_bf16(dequant(acc[i + 1], sx[half], sw1), has_bias, b1);
      gemm_stage(stage, warp * 16 + g + 8 * half, c, v);
    }
  }
  fence_proxy_async();
  named_sync(2 + cw, kWG);
  if (threadIdx.x % kWG == 0) {
    gemm_store(&to, stage, m0 + cw * 64, n0, e.rows, e.n);
    gemm_store_wait();
  }
}

// int8 codes (rows, kp) row-major as a tensor map of 16-bit elements (two
// codes each): boxes of 64 elements (one 128-byte panel of 128 codes) by
// box_rows rows with the 128-byte swizzle, the geometry of make_map_2d's
// bf16 boxes, so gemm_produce's k-step k reads codes 128 k .. 128 k + 127
inline cudaError_t make_map_codes(CUtensorMap* map, const void* base,
                                  int rows, int kp, int box_rows) {
  return make_map_box(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, 64,
                      CU_TENSOR_MAP_SWIZZLE_128B, 1, rows, 1, kp / 2, 0,
                      kp / 2, 0, box_rows);
}

template <bool F32>
cudaError_t launch_w8a8(const CUtensorMap& ta, const CUtensorMap& tb,
                        const CUtensorMap& to, int kp, const W8A8Epi& e,
                        cudaStream_t stream) {
  auto kernel = w8a8_gemm_kernel<F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((e.n + kGemmBN - 1) / kGemmBN,
                  (e.rows + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(
      ta, tb, to, (kp + 127) / 128, e);
  return cudaGetLastError();
}

}  // namespace

// x8 (M, kp) and w8 (N, kp) int8 row-major, 16-byte aligned, kp a multiple
// of 16; sx (M,) and sw (N,) f32; bias (N,) in the output dtype or null;
// out (M, N) with rows ld elements apart: bf16 (out_f32 == 0; ld a
// multiple of 8, 16-byte aligned: TMA stores it) or f32. Returns a
// cudaError_t (0 on success).
extern "C" int smb_w8a8_gemm(const void* x8, const void* w8, const void* sx,
                             const void* sw, const void* bias, void* out,
                             int M, int N, int kp, long long ld, int out_f32,
                             void* stream) {
  if (M <= 0 || N <= 0 || kp <= 0 || kp % 16 != 0 || ld < N ||
      M > 65535 * kGemmBM || (!out_f32 && ld % 8 != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb, to;
  cudaError_t err = make_map_codes(&ta, x8, M, kp, kGemmBM);
  if (err == cudaSuccess) err = make_map_codes(&tb, w8, N, kp, kGemmBN);
  to = ta;  // the f32 path stores without a map
  if (err == cudaSuccess && !out_f32)
    err = make_map_2d(&to, out, M, N, ld, 64);
  if (err != cudaSuccess) return (int)err;
  const W8A8Epi e{static_cast<const float*>(sx),
                  static_cast<const float*>(sw), bias, out, M, N, ld};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_f32 ? launch_w8a8<true>(ta, tb, to, kp, e, s)
                       : launch_w8a8<false>(ta, tb, to, kp, e, s));
}
