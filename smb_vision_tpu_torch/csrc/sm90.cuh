// Hopper (sm_90a) building blocks shared by the wgmma kernels (K1, K4):
// shared-memory matrix descriptors for the 128-byte swizzle, wgmma
// m64nNk16 bf16 -> f32 with A from shared memory or from registers,
// mbarriers, 4-D TMA tile loads and the host-side tensor maps they read,
// setmaxnreg and named barriers.
//
// Tile layout. Every tile in shared memory is what a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes for a box of 64 bf16 columns (128 bytes)
// by R rows: row r at r * 128 bytes, its 16-byte chunk c at chunk c ^ (r % 8),
// the tile 1024-byte aligned. A head of width 128 is two such panels, the
// columns 0-63 and 64-127. The same bytes serve wgmma both ways:
//   - K-major (the contraction runs along the 64 columns, e.g. q k^T over d):
//     8-row groups 1024 bytes apart (SBO); the k-step kk of 16 columns
//     starts kk * 32 bytes into the panel;
//   - MN-major (the contraction runs along the rows, e.g. p v over keys):
//     8-row groups 1024 bytes apart (SBO), 64-column panels LBO bytes
//     apart; the k-step kk of 16 rows starts kk * 2048 bytes in.
// (PTX ISA, "Matrix Descriptor Format" and the canonical layouts of
// wgmma.mma_async for .bf16.)

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the kernels' block: a producer warpgroup and two consumer warpgroups
constexpr int kWG = 128;             // threads of a warpgroup
constexpr int kConsumers = 2 * kWG;  // the two consumer warpgroups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or past p in shared memory (the
// 128-byte swizzle repeats every 1024 bytes)
__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---- wgmma ---------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at shared address `addr`;
// lbo_bytes: the MN-major panel stride (unused by K-major operands)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes = 0) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;  // SBO: 8 rows of 128 bytes
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue or the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, f32) (+)= A B, one k16 step. _ss: A and B from shared memory
// by descriptors; _rs: A from registers (the m16n8k16 A fragment of each
// warp's 16 rows). TB = 1 reads B MN-major. scale_d = 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N");
  if constexpr (N == 32) wgmma_ss_n32<TB>(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<TB>(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_n128<TB>(d, da, db, scale_d);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N");
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_rs_n128<TB>(d, a, db, scale_d);
}

// The wgmma accumulator of a 64 x N tile gives thread (warp w, lane 4g + t)
// d[4j + e], e = 0..3, at row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1):
// the m16n8 C fragment of each n8 tile j. Two n8 tiles, rounded to bf16,
// are the A fragment of one k16 step of a register-A wgmma.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4],
                                         const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const float* s = d + 8 * kk;
    __nv_bfloat162 v0 = __floats2bfloat162_rn(s[0], s[1]);
    __nv_bfloat162 v1 = __floats2bfloat162_rn(s[2], s[3]);
    __nv_bfloat162 v2 = __floats2bfloat162_rn(s[4], s[5]);
    __nv_bfloat162 v3 = __floats2bfloat162_rn(s[6], s[7]);
    a[kk][0] = *reinterpret_cast<uint32_t*>(&v0);
    a[kk][1] = *reinterpret_cast<uint32_t*>(&v1);
    a[kk][2] = *reinterpret_cast<uint32_t*>(&v2);
    a[kk][3] = *reinterpret_cast<uint32_t*>(&v3);
  }
}

// bf16 store of a 64 x N accumulator times `mul` into rows row0 + (the
// thread's rows) of a row-major base; rows at or past n are skipped
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base,
                                          long long row_stride,
                                          const float (&d)[N / 2], float mul,
                                          int r0, int n, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r0 * row_stride +
                                         col) =
          __floats2bfloat162_rn(d[4 * j] * mul, d[4 * j + 1] * mul);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(
          base + (long long)(r0 + 8) * row_stride + col) =
          __floats2bfloat162_rn(d[4 * j + 2] * mul, d[4 * j + 3] * mul);
  }
}

// ---- mbarriers, TMA, registers, named barriers ----------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` into shared memory
// at dst, completing `bytes` on bar (counted by the caller's expect_tx)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// named barriers 1.. (0 is __syncthreads): sync waits for `count` threads,
// arrive counts this thread toward them without waiting
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, so the
// library links no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a bf16 (B, N, H, D) tensor with element strides sb, sn, sh
// (the last dim contiguous): dims (D, H, N, B), box (64, 1, rows, 1), the
// 128-byte swizzle, rows past N read as zero. A dim of size 1 is never
// stepped, so its stride is set to 16 bytes. The same geometry as
// ops/attention.py::_tma_geometry, which checks it before the launch.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int N,
                            int H, int D, long long sb, long long sn,
                            long long sh, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const long long el[3] = {sh, sn, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = dims[i + 1] == 1 ? 16 : el[i] * 2;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1LL << 40))
      return cudaErrorInvalidValue;
    strides[i] = (cuuint64_t)bytes;
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || rows < 1 || rows > 256)
    return cudaErrorInvalidValue;
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
