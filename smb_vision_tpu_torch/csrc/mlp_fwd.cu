// Fused transformer MLP forward for Hopper (sm_90a): the plain MLP (K6), the
// training forward that also spills the pre-activation (K5a), the whole
// MLP half-block with LayerNorm prologue and residual (K2) and the DINOv2
// SwiGLU half-block (K9), on wgmma and TMA (the GEMM core of
// gemm_sm90.cuh).
//
// Replaces
//   K6  smb_vision_tpu/ops/mlp.py:_mlp_kernel        y = act(x w1 + b1) w2 + b2
//   K5a smb_vision_tpu/ops/mlp.py:_mlp_train_kernel  K6, plus h = x w1 + b1
//                                                    stored in bf16
//   K2  smb_vision_tpu/ops/mlp.py:_mlp_block_kernel  y = x + act(LN(x) w1 + b1) w2 + b2
//   K9  smb_vision_tpu/ops/mlp.py:_swiglu_block_kernel
//       y = x + (silu(xn w1a + b1a) * (xn w1b + b1b)) w2 + b2, xn = LN(x)
//       (LayerScale folds into w2 and b2 at the caller)
// and K2's second product with a TMA-loaded residual (PHASE 4) to K10b
// (attn_glue.cu: o = res + y Wo + bo) through smb_gemm_residual.
//
// Numerics as the TPU kernels: bf16 operands, f32 accumulation, LayerNorm
// statistics, bias and activation in f32, the activation rounded to bf16
// before the second product. GELU is the exact erf form (erff; the TPU
// kernel needed a rational approximation because Mosaic has no erf) or the
// tanh form of gelu_new. LayerNorm takes two-pass statistics (the TPU
// kernel: E[x^2] - mean^2) and rounds xn to bf16 (its xn scratch is bf16).
// K2 adds the residual in f32 before its one rounding; K5a's h is x w1 + b1
// rounded to bf16, and the activation is taken of the f32 h. K9's gate
// silu(h1) * h2 is taken in f32 and rounded to bf16 before w2, as the TPU
// kernel's is.
//
// Bound on the H100: at M = 20,480, K = 768, F = 3,072 the two products are
// 4*M*K*F = 193 GFLOP, 0.195 ms at 989 TFLOP/s; x, y and the weights are
// 72 MB, 0.022 ms at 3.35 TB/s. The operations bound it.
//
// The TPU kernels kept a (bm, K) f32 output accumulator in VMEM with bm in
// the hundreds and streamed F through it. On Hopper that accumulator would
// live in registers: 128 rows x 768 columns in f32 is 384 KB, more than an
// SM's register file (256 KB). A row block small enough to hold whole
// output rows (32 rows) reads all of w1 and w2 again from L2 for every 32
// rows (6 GB at the shape above), more bytes than the products take time.
// So the function is computed as two tiled products instead, each a wgmma
// GEMM over 128 x 128 output tiles:
//   1. a = act(A w1^T + b1), A = x (K6, K5a) or xn = LN(x) in bf16 (K2,
//      written by a row pass before it); A's and w1's tiles come by TMA,
//      the f32 epilogue adds b1, stores h (K5a), takes the activation and
//      stores a in bf16 into a workspace (rows, F);
//   2. y = a w2^T + b2 (+ x for K2), over F; the epilogue adds b2 and the
//      residual in f32 and stores bf16.
// Every tile leaves through shared memory by TMA stores (gemm_sm90.cuh).
// w1 (F, K) and w2 (K, F) are PyTorch's Linear layouts, K-major for wgmma's
// B operand as they are. A 128-row tile reads each weight panel once, so
// the weights cross L2 M/128 times instead of M/32. The workspace costs
// 2*rows*F*2 bytes of device memory traffic (0.075 ms at the shape above);
// the wrapper sizes it to a chunk of rows and the host walks the chunks
// (the workspace does not grow with M). Two blocks share an SM, so one
// block's epilogue (erff over its 128 x 128 tile, the stores) runs under
// the other's products. Ragged M, F and contraction tails read as zero
// through TMA and are not stored. K is any multiple of 128 (the JAX
// kernels' rule): the LayerNorm pass reads K at run time, and the GEMM
// core takes K as a count of k-steps or of output columns. F must be a
// multiple of 32.
//
// K9 is K2's three passes with a gated phase 1 (PHASE 3). w_in is the
// Linear layout (2F, K): rows 0..F-1 are w1a^T, F..2F-1 w1b^T. Two tensor
// maps over its halves bring 64 rows of each into one 128-row B stage, so
// one m64n128 wgmma gives h1 in accumulator columns 0-63 and h2 in 64-127
// of the same 64 gate columns; in the wgmma D layout a thread holds column
// c and c + 64, so silu(h1 + b1a) * (h2 + b1b) is register-local. Each
// half reads as zero past its own edge F. The gate crosses device memory
// once in bf16 through the workspace (the TPU kernel kept it in VMEM):
// 2*rows*F*2 bytes, 64 MB at DINOv2-giant batch 2 (M 3,922, F 4,096),
// about 0.02 ms. Its bound there: 6*M*K*F = 148 GFLOP, 0.150 ms at the
// bf16 peak, against 38 MB of weights and 24 MB of x and y. It runs at
// about 45 % of it (chip_smoke.py times it beside its bf16 cuBLAS chain;
// PERF.md has the times), held where K6 is held (below): its products
// at the rate of L2-to-SM traffic a 128 x 128 tile allows, the gated
// epilogue (expf over half the accumulator) hidden in part by the second
// block of an SM.
//
// What holds it at about 45 % of the bound on an H100 (chip_smoke.py: K6
// 0.44 ms at the shape above; in its profile at 81,920 rows a call, phase
// 1 0.98 ms and phase 2 0.69 ms): phase 2's products reach about 57 % of
// the bf16 peak, at a rate of L2-to-SM traffic (32 KB of A and B a k-step
// of a 128 x 128 tile, 1M multiply-adds) near what L2 delivers (inferred
// from bytes and time: no counter can be read); phase 1, the same
// products, takes 43 % longer for its epilogue (erff over every element,
// the workspace stores), which the second block of an SM hides only in
// part.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

__device__ __forceinline__ float activation(float v, int act) {
  if (act == 0) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return 0.5f * v *
         (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// xn = LN(x) rounded to bf16, one warp a row, two-pass f32 statistics,
// for a K read at run time (a multiple of 8): a lane keeps its first KEEP
// chunks of 8 columns in registers and reads any further ones again for
// each pass (from L1), so a row of any width runs. KEEP is compiled
// (launch_ln picks the least of 1, 2, 3, 4, 6 and 8 that holds it): the
// registers a lane holds set how many warps an SM runs, and this
// memory-bound pass needs them (on an H100 at M 20,480, K 768: 8 kept
// chunks took 98 registers and the pass 0.045 ms, 3 took 48 and 0.041)
constexpr int kLnWarps = 8;
constexpr int kLnKeepMax = 8;  // a row to K 2,048 from registers

__device__ __forceinline__ void bf16x8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(e8[e]);
}

// f(v, c) for each 8-column chunk c of this lane's share of a row: the
// kept chunks from registers, the others read (again) from x
template <int KEEP, typename Fn>
__device__ __forceinline__ void ln_chunks(const uint4 (&keep)[KEEP],
                                          const uint4* xr, int chunks,
                                          int lane, Fn f) {
#pragma unroll
  for (int i = 0; i < KEEP; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      float v[8];
      bf16x8(keep[i], v);
      f(v, c);
    }
  }
  for (int c = lane + 32 * KEEP; c < chunks; c += 32) {
    float v[8];
    bf16x8(xr[c], v);
    f(v, c);
  }
}

template <int KEEP>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_rows_any_kernel(const __nv_bfloat16* x, const float* lnw,
                       const float* lnb, __nv_bfloat16* xn, int rows, int K,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * K);
  uint4* out = reinterpret_cast<uint4*>(xn + row * K);
  const int chunks = K / 8;
  uint4 keep[KEEP];
#pragma unroll
  for (int i = 0; i < KEEP; ++i)
    if (lane + 32 * i < chunks) keep[i] = xr[lane + 32 * i];
  float sum = 0.f;
  ln_chunks(keep, xr, chunks, lane, [&](const float (&v)[8], int) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / K;
  float sq = 0.f;
  ln_chunks(keep, xr, chunks, lane, [&](const float (&v)[8], int) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[e] - mean;
      sq += d * d;
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / K + eps);
  ln_chunks(keep, xr, chunks, lane, [&](const float (&v)[8], int c) {
    __align__(16) __nv_bfloat16 o8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o8[e] = __float2bfloat16((v[e] - mean) * rstd * lnw[c * 8 + e] +
                               lnb[c * 8 + e]);
    out[c] = *reinterpret_cast<const uint4*>(o8);
  });
}

// the epilogue's operands
struct Epi {
  const float* bias;         // (n,)
  const __nv_bfloat16* res;  // (rows, n): phase 2 of K2, the residual x
  int rows, n;
  int act;  // 0: exact gelu, 1: tanh gelu
};

// PHASE 1: to = act(acc + b1) (and th = acc + b1 if EXTRA);
// PHASE 2: to = acc + b2 (+ res if EXTRA);
// PHASE 3 (K9): B's stage is 64 rows of w1a (tb) over 64 of w1b (th), so
// to = silu(h1 + b1a) * (h2 + b1b) over the tile's 64 gate columns;
// PHASE 4 (K10b, EXTRA): to = acc + bias + res, the residual's tile loaded
// from th by the producer after the last k-step into the freed ring stage,
// where the result is staged over it
template <int PHASE, bool EXTRA>
__global__ void __launch_bounds__(kGemmThreads, 2)
    mlp_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap to,
                    const __grid_constant__ CUtensorMap th, const int ksteps,
                    const Epi e) {
  extern __shared__ char smem_raw[];
  const GemmSmem s = gemm_smem_init(smem_raw);
  // PHASE 3 owns 64 gate columns: their h1 and h2 fill the 128-column tile
  const int n0 = blockIdx.x * (PHASE == 3 ? kGemmBN / 2 : kGemmBN);
  const int m0 = blockIdx.y * kGemmBM;
  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      if constexpr (PHASE == 3)
        gemm_produce<kBSplit>(s, &ta, &tb, m0, n0, ksteps, &th);
      else
        gemm_produce(s, &ta, &tb, m0, n0, ksteps);
      if constexpr (PHASE == 4)
        gemm_produce_tile(s, &th, m0, n0, ksteps, e.rows, e.n);
    }
    return;
  }
  const int cw = threadIdx.x / kWG;
  float acc[kGemmAcc];
  gemm_consume(s, acc, cw, ksteps);

  char* stage_o;
  if constexpr (PHASE == 4) {  // the residual's tile, staged over in place
    stage_o = gemm_wait_tile(s, ksteps) + cw * kGemmHalf;
  } else {
    gemm_release_ring();
    stage_o = s.ring + cw * kGemmHalf;
  }
  char* stage_h = s.ring + (2 + cw) * kGemmHalf;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (PHASE == 3) {
    // accumulator columns c (h1) and c + 64 (h2) are the same gate column
#pragma unroll
    for (int j = 0; j < kGemmBN / 16; ++j) {
      const int c = 8 * j + 2 * t, col = n0 + c;
      const bool in = col < e.n;
      const float a0 = in ? e.bias[col] : 0.f;
      const float a1 = in ? e.bias[col + 1] : 0.f;
      const float b0 = in ? e.bias[e.n + col] : 0.f;
      const float b1 = in ? e.bias[e.n + col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i1 = 4 * j + 2 * half, i2 = i1 + 4 * (kGemmBN / 16);
        gemm_stage(stage_o, warp * 16 + g + 8 * half, c,
                   __floats2bfloat162_rn(
                       silu(acc[i1] + a0) * (acc[i2] + b0),
                       silu(acc[i1 + 1] + a1) * (acc[i2 + 1] + b1)));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGemmBN / 8; ++j) {
      const int c = 8 * j + 2 * t, col = n0 + c;  // n is even: col + 1 < n
      const bool in = col < e.n;
      const float b0 = in ? e.bias[col] : 0.f;
      const float b1 = in ? e.bias[col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = warp * 16 + g + 8 * half;  // of the warpgroup's 64
        float v0 = acc[4 * j + 2 * half] + b0;
        float v1 = acc[4 * j + 2 * half + 1] + b1;
        if constexpr (PHASE == 1) {
          if constexpr (EXTRA)
            gemm_stage(stage_h, rr, c, __floats2bfloat162_rn(v0, v1));
          v0 = activation(v0, e.act);
          v1 = activation(v1, e.act);
        } else if constexpr (PHASE == 4) {
          const __nv_bfloat162 x2 = gemm_unstage(stage_o, rr, c);
          v0 += __bfloat162float(x2.x);
          v1 += __bfloat162float(x2.y);
        } else if constexpr (EXTRA) {
          const int r = m0 + cw * 64 + rr;
          if (in && r < e.rows) {
            const __nv_bfloat162 x2 =
                *reinterpret_cast<const __nv_bfloat162*>(
                    e.res + (long long)r * e.n + col);
            v0 += __bfloat162float(x2.x);
            v1 += __bfloat162float(x2.y);
          }
        }
        gemm_stage(stage_o, rr, c, __floats2bfloat162_rn(v0, v1));
      }
    }
  }
  fence_proxy_async();
  named_sync(2 + cw, kWG);
  if (threadIdx.x % kWG == 0) {
    if constexpr (PHASE == 3) {  // one 64 x 64 box of the gate
      if (m0 + cw * 64 < e.rows)
        tma_store_4d(&to, stage_o, n0, 0, m0 + cw * 64, 0);
    } else {
      gemm_store(&to, stage_o, m0 + cw * 64, n0, e.rows, e.n);
    }
    if constexpr (PHASE == 1 && EXTRA)
      gemm_store(&th, stage_h, m0 + cw * 64, n0, e.rows, e.n);
    gemm_store_wait();
  }
}

// to (rows, n) = epilogue(A B^T), A (rows, kdim) and B (n, kdim) bf16
// row-major; PHASE 3: B is w_in (2 n, kdim), its two halves mapped apart
template <int PHASE, bool EXTRA>
cudaError_t launch_gemm(const void* a, const void* b, int kdim,
                        const CUtensorMap& to, const CUtensorMap& th,
                        const Epi& e, cudaStream_t stream) {
  constexpr int bn = PHASE == 3 ? kGemmBN / 2 : kGemmBN;  // B rows a block
  CUtensorMap ta, tb, tx = th;
  cudaError_t err = make_map_2d(&ta, a, e.rows, kdim, kdim, kGemmBM);
  if (err == cudaSuccess) err = make_map_2d(&tb, b, e.n, kdim, kdim, bn);
  if (PHASE == 3 && err == cudaSuccess)
    err = make_map_2d(
        &tx, static_cast<const __nv_bfloat16*>(b) + (long long)e.n * kdim,
        e.n, kdim, kdim, bn);
  auto kernel = mlp_gemm_kernel<PHASE, EXTRA>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((e.n + bn - 1) / bn, (e.rows + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(
      ta, tb, to, tx, (kdim + kGemmBK - 1) / kGemmBK, e);
  return cudaGetLastError();
}

cudaError_t launch_ln(const __nv_bfloat16* x, const float* lnw,
                      const float* lnb, __nv_bfloat16* xn, int rows, int K,
                      float eps, cudaStream_t s) {
  if (K <= 0 || K % 8 != 0) return cudaErrorInvalidValue;
  const int per_lane = (K / 8 + 31) / 32;  // chunks of 8 columns a lane
  void (*kernel)(const __nv_bfloat16*, const float*, const float*,
                 __nv_bfloat16*, int, int, float) =
      per_lane <= 1   ? ln_rows_any_kernel<1>
      : per_lane <= 2 ? ln_rows_any_kernel<2>
      : per_lane <= 3 ? ln_rows_any_kernel<3>
      : per_lane <= 4 ? ln_rows_any_kernel<4>
      : per_lane <= 6 ? ln_rows_any_kernel<6>
                      : ln_rows_any_kernel<kLnKeepMax>;
  kernel<<<(rows + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, s>>>(
      x, lnw, lnb, xn, rows, K, eps);
  return cudaGetLastError();
}

// the chunk loop of K2, K6, K5a (gated = 0) and K9 (gated = 1): see
// smb_mlp_fwd and smb_swiglu_fwd
cudaError_t run_chunks(const void* x, const void* lnw, const void* lnb,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, void* h, int M, int K,
                       int F, float eps, int ln, int act, int gated,
                       cudaStream_t s, void* ws, void* xn, int chunk) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* outb = static_cast<__nv_bfloat16*>(out);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* wsb = static_cast<__nv_bfloat16*>(ws);
  auto* xnb = static_cast<__nv_bfloat16*>(xn);
  cudaError_t err = cudaSuccess;
  for (int m = 0; m < M && err == cudaSuccess; m += chunk) {
    const int rows = M - m < chunk ? M - m : chunk;
    const __nv_bfloat16* xm = xb + (long long)m * K;
    if (ln)
      err = launch_ln(xm, static_cast<const float*>(lnw),
                      static_cast<const float*>(lnb), xnb, rows, K, eps, s);
    // the outputs: the workspace (phase 1), the spill, y (phase 2)
    CUtensorMap tws, th, ty;
    if (err == cudaSuccess) err = make_map_2d(&tws, wsb, rows, F, F, 64);
    if (err == cudaSuccess && hb)
      err = make_map_2d(&th, hb + (long long)m * F, rows, F, F, 64);
    if (err == cudaSuccess)
      err = make_map_2d(&ty, outb + (long long)m * K, rows, K, K, 64);
    if (err != cudaSuccess) break;
    const Epi e1{static_cast<const float*>(b1), nullptr, rows, F, act};
    const void* a1 = ln ? static_cast<const void*>(xnb) : xm;
    err = gated ? launch_gemm<3, false>(a1, w1, K, tws, tws, e1, s)
          : hb  ? launch_gemm<1, true>(a1, w1, K, tws, th, e1, s)
                : launch_gemm<1, false>(a1, w1, K, tws, tws, e1, s);
    if (err != cudaSuccess) break;
    const Epi e2{static_cast<const float*>(b2), ln ? xm : nullptr, rows, K,
                 act};
    err = ln ? launch_gemm<2, true>(wsb, w2, F, ty, ty, e2, s)
             : launch_gemm<2, false>(wsb, w2, F, ty, ty, e2, s);
  }
  return err;
}

}  // namespace

// K10b (attn_glue.cu): out = res + a b^T + bias, K2's second product with
// the residual's tile loaded by TMA (PHASE 4); a (rows, kdim), b (n, kdim)
// (a Linear weight), res and out (rows, n) bf16 and 16-byte aligned, bias
// f32 (n,); n even.
cudaError_t smb_gemm_residual(const void* a, const void* b, const float* bias,
                              const void* res, void* out, int rows, int n,
                              int kdim, cudaStream_t stream) {
  CUtensorMap to, tr;
  cudaError_t err = make_map_2d(&to, out, rows, n, n, 64);
  if (err == cudaSuccess) err = make_map_2d(&tr, res, rows, n, n, 64);
  if (err != cudaSuccess) return err;
  const Epi e{bias, nullptr, rows, n, 0};
  return launch_gemm<4, true>(a, b, kdim, to, tr, e, stream);
}

// x (M, K), w1 (F, K), w2 (K, F), out (M, K), h (M, F): bf16; lnw, lnb, b1,
// b2: f32. K a multiple of 128, F of 32. ln != 0 selects K2 (LayerNorm +
// residual); otherwise h != null selects K5a (K6 plus the pre-activation
// spill into h), h == null K6.
// The rows run in chunks of `chunk` rows through the caller's workspaces:
// ws (chunk, F) bf16 for the activation, and for K2 xn (chunk, K) bf16.
// Every matrix but the biases and LayerNorm parameters passes through TMA,
// so their addresses must be 16-byte aligned. The workspace arguments come
// last, so a caller that passes them to an older library of this interface
// (which takes none) still runs.
// Returns a cudaError_t.
extern "C" int smb_mlp_fwd(const void* x, const void* lnw, const void* lnb,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, void* h, int M, int K,
                           int F, float eps, int ln, int act, void* stream,
                           void* ws, void* xn, int chunk) {
  if (M <= 0 || F <= 0 || F % 32 != 0 || K <= 0 || K % 128 != 0 ||
      (act != 0 && act != 1) || (ln && h != nullptr) ||
      ws == nullptr || (ln && xn == nullptr) || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)run_chunks(x, lnw, lnb, w1, b1, w2, b2, out, h, M, K, F, eps,
                         ln, act, 0, static_cast<cudaStream_t>(stream), ws,
                         xn, chunk);
}

// K9: x (M, K), w1 = w_in (2F, K) (rows 0..F-1 w1a^T, F..2F-1 w1b^T), w2 =
// w_out (K, F), out (M, K): bf16; lnw, lnb, b1 (2F), b2: f32. K is a
// multiple of 128, F of 32. The rows run in
// chunks of `chunk` through the caller's workspaces ws (chunk, F) for the
// gate and xn (chunk, K), both bf16; every matrix must be 16-byte aligned.
// The workspace arguments come last, as smb_mlp_fwd's do.
// Returns a cudaError_t.
extern "C" int smb_swiglu_fwd(const void* x, const void* lnw, const void* lnb,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, int M, int K, int F,
                              float eps, void* stream, void* ws, void* xn,
                              int chunk) {
  if (M <= 0 || F <= 0 || F % 32 != 0 || K <= 0 || K % 128 != 0 ||
      ws == nullptr ||
      xn == nullptr || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)run_chunks(x, lnw, lnb, w1, b1, w2, b2, out, nullptr, M, K, F,
                         eps, 1, 0, 1, static_cast<cudaStream_t>(stream), ws,
                         xn, chunk);
}
