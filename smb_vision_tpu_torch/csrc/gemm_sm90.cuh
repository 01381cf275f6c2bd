// A warp-specialised bf16 GEMM core for Hopper (sm_90a) on wgmma and TMA,
// for kernels that own one output tile per block and differ only in their
// epilogues: mlp_fwd.cu's two MLP products (K2, K6, K5a), K9's gated
// product, whose B stage holds 64 rows of each half of w_in (kBSplit), and
// K10b's product, whose epilogue reads a residual tile that the producer
// loads after the last k-step (gemm_produce_tile); mlp_bwd.cu's two
// backward products (K5b), which read B as the Linear weight B^T stands
// (kBCols, MN-major) and whose first epilogue reads a tile of h back from
// shared memory (gemm_load_tile, gemm_unstage); and attn_glue.cu's q/k/v
// product (K10a).
//
// The product of a block: the f32 tile C (kGemmBM x kGemmBN) = A B^T over
// kdim, with A (rows, kdim) and B (cols, kdim) both K-major bf16 in device
// memory, which is what a Linear weight (out, in) already is for x w^T.
// TMA brings kGemmBK = 64 contraction columns of A's kGemmBM rows and B's
// kGemmBN rows a step (one 128-byte panel a row, the 128-byte swizzle of
// sm90.cuh) through a ring of kGemmStages stages with full and empty
// mbarriers. Rows and columns past a tensor's edge read as zero, so ragged
// rows, columns and contraction lengths need no masks in the products.
// With kBCols, B comes as B^T (kdim, cols), row-major: a stage holds
// kGemmBK of its rows by kGemmBN columns as two 64-column panels, which
// wgmma reads MN-major (sm90.cuh: panels kGemmPanel bytes apart, a k16
// step 2,048 bytes on).
//
// The block: two consumer warpgroups (threads 0-255; warpgroup cw owns the
// tile's rows 64 cw .. 64 cw + 63, a 64 x kGemmBN f32 accumulator of
// kGemmBN / 2 registers a thread, laid out as sm90.cuh's acc_to_a says) and
// one producer warp (threads 256-287), of which one thread issues the TMA
// loads. The consumers keep one group of wgmma in flight and free a stage
// when the group that read it has completed. Two blocks fit on an SM (97 KB
// of shared memory and at most 112 registers a thread each), so one block's
// epilogue runs under the other's products.
//
// The epilogue: once both warpgroups are done with the ring, each writes
// its 64 x kGemmBN bf16 result into the ring in the layout a TMA load would
// have given it (64-column panels, the 128-byte swizzle: conflict-free for
// the accumulator's thread layout) and one thread stores it with TMA, which
// writes whole lines and clips rows and columns past the tensor's edge.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kGemmBM = 128;  // tile rows
constexpr int kGemmBN = 128;  // tile columns
constexpr int kGemmBK = 64;   // contraction columns a step
constexpr int kGemmStages = 3;
constexpr int kGemmThreads = kConsumers + 32;  // and one producer warp
constexpr int kGemmTileA = kGemmBM * 128;      // bytes of a stage's A
constexpr int kGemmStage = kGemmTileA + kGemmBN * 128;
constexpr int kGemmSmem =
    1024 + kGemmStages * kGemmStage + 2 * kGemmStages * 8;
constexpr int kGemmAcc = kGemmBN / 2;  // accumulator floats a thread
constexpr int kGemmPanel = 64 * 128;   // bytes of a staged 64-column panel
constexpr int kGemmHalf = (kGemmBN / 64) * kGemmPanel;  // a warpgroup's tile

struct GemmSmem {
  char* ring;       // kGemmStages stages of A then B, 1024-byte aligned
  uint64_t* full;   // TMA has landed the stage
  uint64_t* empty;  // every consumer warp is done with the stage
};

// carve the dynamic shared memory and initialise the barriers; every thread
// of the block calls it (it ends in __syncthreads)
__device__ __forceinline__ GemmSmem gemm_smem_init(char* raw) {
  GemmSmem s;
  s.ring = align1024(raw);
  s.full = reinterpret_cast<uint64_t*>(s.ring + kGemmStages * kGemmStage);
  s.empty = s.full + kGemmStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kGemmStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return s;
}

// how B reaches its stage: kBRows, rows n0 .. n0 + kGemmBN - 1 of B (n,
// kdim) in one box; kBSplit, rows n0 .. n0 + kGemmBN / 2 - 1 of tb, then
// the same rows of tb2 (boxes of kGemmBN / 2 rows), so that each half
// reads as zero past its own edge; kBCols, columns n0 .. n0 + kGemmBN - 1
// of B^T (kdim, n) as two boxes of kGemmBK rows by 64 columns, a box
// wholly past column n not loaded (its panel only feeds columns that are
// never stored)
enum GemmB { kBRows, kBSplit, kBCols };

// the producer thread: k-steps 0 .. ksteps - 1 of A's rows m0 .. m0 +
// kGemmBM - 1 and B's columns n0 .. n0 + kGemmBN - 1 of the product (maps
// from make_map_2d: boxes of kGemmBM rows for A; for B as above)
template <GemmB BL = kBRows>
__device__ __forceinline__ void gemm_produce(
    const GemmSmem& s, const CUtensorMap* ta, const CUtensorMap* tb, int m0,
    int n0, int ksteps, const CUtensorMap* tb2 = nullptr, int n = 0) {
  tma_prefetch(ta);
  tma_prefetch(tb);
  if constexpr (BL == kBSplit) tma_prefetch(tb2);
  const bool second = BL != kBCols || n0 + 64 < n;  // kBCols: panel 1 in
  for (int k = 0; k < ksteps; ++k) {
    const int st = k % kGemmStages;
    if (k >= kGemmStages)
      mbar_wait(&s.empty[st], ((k / kGemmStages) & 1) ^ 1);
    char* dst = s.ring + st * kGemmStage;
    mbar_expect_tx(&s.full[st],
                   second ? kGemmStage : kGemmStage - kGemmPanel);
    tma_load_4d(dst, ta, &s.full[st], k * kGemmBK, 0, m0, 0);
    if constexpr (BL == kBCols) {
      tma_load_4d(dst + kGemmTileA, tb, &s.full[st], n0, 0, k * kGemmBK, 0);
      if (second)
        tma_load_4d(dst + kGemmTileA + kGemmPanel, tb, &s.full[st], n0 + 64,
                    0, k * kGemmBK, 0);
    } else {
      tma_load_4d(dst + kGemmTileA, tb, &s.full[st], k * kGemmBK, 0, n0, 0);
      if constexpr (BL == kBSplit)
        tma_load_4d(dst + kGemmTileA + kGemmBN / 2 * 128, tb2, &s.full[st],
                    k * kGemmBK, 0, n0, 0);
    }
  }
}

// one thread: the 128 x 128 bf16 tile of `map` (boxes of 64 x 64, from
// make_map_2d) at rows m0.. and columns n0.. into buf, as four boxes laid
// out as gemm_stage lays out the two warpgroups' staged tiles, completing
// on bar; boxes wholly past the edge (rows, n) are not loaded
__device__ __forceinline__ void gemm_load_tile(const CUtensorMap* map,
                                               char* buf, uint64_t* bar,
                                               int m0, int n0, int rows,
                                               int n) {
  uint32_t bytes = 0;
#pragma unroll
  for (int cw = 0; cw < 2; ++cw)
#pragma unroll
    for (int p = 0; p < kGemmBN / 64; ++p)
      bytes += (m0 + 64 * cw < rows && n0 + 64 * p < n) ? kGemmPanel : 0;
  mbar_expect_tx(bar, bytes);
#pragma unroll
  for (int cw = 0; cw < 2; ++cw)
#pragma unroll
    for (int p = 0; p < kGemmBN / 64; ++p)
      if (m0 + 64 * cw < rows && n0 + 64 * p < n)
        tma_load_4d(buf + cw * kGemmHalf + p * kGemmPanel, map, bar,
                    n0 + 64 * p, 0, m0 + 64 * cw, 0);
}

// the producer thread, after gemm_produce: an epilogue's input tile (as
// gemm_load_tile) into the ring stage that k-step ksteps would fill, once
// the consumers have freed it, completing on that stage's full barrier, so
// it lands while the last products run; the consumers take it with
// gemm_wait_tile
__device__ __forceinline__ void gemm_produce_tile(const GemmSmem& s,
                                                  const CUtensorMap* map,
                                                  int m0, int n0, int ksteps,
                                                  int rows, int n) {
  const int st = ksteps % kGemmStages;
  if (ksteps >= kGemmStages)
    mbar_wait(&s.empty[st], ((ksteps / kGemmStages) & 1) ^ 1);
  gemm_load_tile(map, s.ring + st * kGemmStage, &s.full[st], m0, n0, rows,
                 n);
}

// a consumer: wait for gemm_produce_tile's tile; returns its stage
__device__ __forceinline__ char* gemm_wait_tile(const GemmSmem& s,
                                                int ksteps) {
  const int st = ksteps % kGemmStages;
  mbar_wait(&s.full[st], (ksteps / kGemmStages) & 1);
  return s.ring + st * kGemmStage;
}

// consumer warpgroup cw: acc = (its 64 rows of A) B^T over all k-steps
// (BL as the producer's: kBCols reads B's stage MN-major); lane 0 of each
// warp frees a stage once the warp's wgmma that read it have completed
template <GemmB BL = kBRows>
__device__ __forceinline__ void gemm_consume(const GemmSmem& s,
                                             float (&acc)[kGemmAcc], int cw,
                                             int ksteps) {
#pragma unroll
  for (int i = 0; i < kGemmAcc; ++i) acc[i] = 0.f;
  const uint32_t ring = smem_u32(s.ring);
  const bool signals = (threadIdx.x & 31) == 0;
  for (int k = 0; k < ksteps; ++k) {
    const int st = k % kGemmStages;
    mbar_wait(&s.full[st], (k / kGemmStages) & 1);
    const uint32_t a = ring + st * kGemmStage + cw * 64 * 128;
    const uint32_t b = ring + st * kGemmStage + kGemmTileA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      if constexpr (BL == kBCols)
        wgmma_ss<kGemmBN, 1>(acc, desc_sw128(a + kk * 32),
                             desc_sw128(b + kk * 2048, kGemmPanel), 1);
      else
        wgmma_ss<kGemmBN, 0>(acc, desc_sw128(a + kk * 32),
                             desc_sw128(b + kk * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of step k - 1 is done: free its stage
    if (k > 0 && signals) mbar_arrive(&s.empty[(k - 1) % kGemmStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// the ring is free for staging once both consumer warpgroups call this
__device__ __forceinline__ void gemm_release_ring() {
  named_sync(1, kConsumers);
}

// the value pair of a thread at row rr (0-63) and columns col, col + 1
// (col even, 0 .. kGemmBN - 2) of a warpgroup's staged tile
__device__ __forceinline__ void gemm_stage(char* stage, int rr, int col,
                                           __nv_bfloat162 v) {
  char* dst = stage + (col >> 6) * kGemmPanel + rr * 128 +
              ((((col & 63) >> 3) ^ (rr & 7)) << 4) + (col & 7) * 2;
  *reinterpret_cast<__nv_bfloat162*>(dst) = v;
}

// the value pair that gemm_stage put at row rr and columns col, col + 1
// of a staged tile (or that a TMA load of 64 x 64 boxes, as gemm_store
// writes them, brought in)
__device__ __forceinline__ __nv_bfloat162 gemm_unstage(const char* stage,
                                                       int rr, int col) {
  return *reinterpret_cast<const __nv_bfloat162*>(
      stage + (col >> 6) * kGemmPanel + rr * 128 +
      ((((col & 63) >> 3) ^ (rr & 7)) << 4) + (col & 7) * 2);
}

// TMA store of the box at (c0, c1, c2, c3) of `map` from shared memory
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one thread of a warpgroup, after the warpgroup's gemm_stage writes, a
// fence_proxy_async each and a barrier: its staged tile to rows row0 ..
// row0 + 63 and columns n0 .. n0 + kGemmBN - 1 of `map` (box 64 x 64, from
// make_map_2d), boxes wholly past the edge skipped
__device__ __forceinline__ void gemm_store(const CUtensorMap* map,
                                           const char* stage, int row0,
                                           int n0, int rows, int n) {
  if (row0 >= rows) return;
#pragma unroll
  for (int p = 0; p < kGemmBN / 64; ++p)
    if (n0 + 64 * p < n)
      tma_store_4d(map, stage + p * kGemmPanel, n0 + 64 * p, 0, row0, 0);
}

// the issuing thread: commit its TMA stores and wait until they have read
// shared memory (which must outlive them)
__device__ __forceinline__ void gemm_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// tensor map of a row-major bf16 matrix (rows, cols) with a row stride of
// `stride` elements, read in boxes of 64 columns by `box_rows` rows
inline cudaError_t make_map_2d(CUtensorMap* map, const void* base, int rows,
                               int cols, long long stride, int box_rows) {
  return make_map(map, base, 1, rows, 1, cols, 0, stride, 0, box_rows);
}

}  // namespace
