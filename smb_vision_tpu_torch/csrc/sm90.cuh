// Hopper (sm_90a) building blocks shared by the wgmma kernels (K1, K3, K4,
// K7, K8): shared-memory matrix descriptors for the 128-, 64- and 32-byte
// swizzles,
// wgmma m64nNk16 bf16 -> f32 with A from shared memory or from registers,
// wgmma m64nNk32 s8 -> s32 with both operands in shared memory or A from
// registers, the exp2 of the softmax, mbarriers,
// 4-D TMA tile loads and the host-side tensor maps they read, setmaxnreg
// and named barriers.
//
// Tile layout. Every bf16 tile in shared memory is what a TMA load with
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
// A head of width 32 is one panel of 32 columns: rows of 64 bytes, which
// TMA writes with CU_TENSOR_MAP_SWIZZLE_64B (chunk c of row r at
// c ^ ((r / 2) % 4)), the tile 512-byte aligned. The descriptor says the
// 64-byte swizzle with 8-row groups 512 bytes apart (SBO) both ways: K-major
// the k-step kk of 16 columns starts kk * 32 bytes in; MN-major the 32
// columns are exactly one swizzle atom wide, so an N = 32 operand needs no
// panel stride, and the k-step kk of 16 rows starts kk * 1024 bytes in
// (`Panels`, `desc_k`, `desc_mn`).
// An int8 tile holds whole rows, one box of D columns (D bytes): at D = 128
// the bf16 panel's bytes exactly (the 128-byte swizzle, a k32 step 32 bytes
// like a bf16 k16 step); at D = 64 a row is 64 bytes, so TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_64B (chunk c of row r at c ^ ((r / 2) % 4)) and the
// descriptor says the 64-byte swizzle, 8-row groups 512 bytes apart, the
// k32 step kk at kk * 32 bytes; at D = 32 a row is 32 bytes, one k32 step,
// written with CU_TENSOR_MAP_SWIZZLE_32B (chunk c of row r at
// c ^ ((r / 4) % 2)) and read with the 32-byte swizzle, 8-row groups 256
// bytes apart. Integer wgmma takes both operands K-major
// only; every int8 product of K3 and K7 contracts over d, along which q8,
// k8, v8 and do8 are contiguous, so none needs a transposed copy. K8's p v
// contracts over keys: its v8 comes d-major, keys contiguous (the layout
// the quantisation kernel writes), a tile of D rows of BN bytes read as
// above with the swizzle of BN.
// A head of width 80 (the d-80 tiles of K1 and K4) is one 64-column panel
// in the 128-byte swizzle and, after it, one panel of the last 16 columns:
// rows of 32 bytes, which TMA writes with CU_TENSOR_MAP_SWIZZLE_32B (chunk c
// of row r at c ^ ((r / 4) % 2)), the panel 256-byte aligned (Panels<80>::
// TAIL). K-major, k-steps 0-3 come from the 64-column panel as at d 128
// and k-step 4 is the whole tail panel (the 32-byte swizzle, 8-row groups
// 256 bytes apart); MN-major, an N = 80 operand has no one descriptor
// across two swizzles, so a product with the head as its N is an n64
// wgmma on the 64-column panel and an n16 one on the tail into the last
// 8 floats of the accumulator (`wgmma_rs_mn`), the tail's k-step kk of 16
// rows kk * 512 bytes in.
// The int8 codes of the d-80 tiles (K3, K7) are rows of 96 bytes: an int8
// wgmma step is 32 bytes deep, and 80 is 2 1/2 of them, so the quantisation
// writes 96 with zeros past d. A row is a 64-byte panel in the 64-byte
// swizzle and after it, `rows` * 64 bytes on, a 32-byte tail panel in the
// 32-byte swizzle (256-byte aligned), each loaded by a tensor map of its
// own (make_map_i8, make_map_i8_tail): a product over d takes k32 steps 0
// and 1 from the first panel and step 2, the whole tail row, from the
// second (`Codes`, `desc_c96`).
// (PTX ISA, "Matrix Descriptor Format" and the canonical layouts of
// wgmma.mma_async for .bf16 and .s8.)

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

// descriptor of a k16 x 8 bf16 B operand read without swizzle: two 8 x 8
// core matrices of 128 bytes, 128 bytes apart (LBO and SBO), at `addr`.
// Over 256 bytes of bf16 ones it is a B of ones whatever the k-step, so
// one such tile serves every k-step of a row sum by wgmma.
__device__ __forceinline__ uint64_t desc_ones(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= (uint64_t)(128 >> 4) << 16;
  d |= (uint64_t)(128 >> 4) << 32;
  return d;
}

// descriptor of an operand with 64-byte rows and the 64-byte swizzle;
// lbo_bytes as desc_sw128's (an MN-major operand of N = 32 never steps it)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr,
                                              uint32_t lbo_bytes = 0) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(512 >> 4) << 32;  // SBO: 8 rows of 64 bytes
  d |= (uint64_t)2 << 62;           // 64-byte swizzle
  return d;
}

// descriptor of an operand with 32-byte rows and the 32-byte swizzle, read
// K-major or, one swizzle atom of 16 bf16 columns wide, MN-major (the
// d-80 tiles' tail panel)
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= (uint64_t)(256 >> 4) << 32;  // SBO: 8 rows of 32 bytes
  d |= (uint64_t)3 << 62;           // 32-byte swizzle
  return d;
}

// descriptor of k32 step kk of an int8 tile of D-byte rows (see the top),
// from row 0 of the operand at `addr`
template <int D>
__device__ __forceinline__ uint64_t desc_i8(uint32_t addr, int kk) {
  static_assert(D == 32 || D == 64 || D == 128, "desc_i8: D");
  if constexpr (D == 32) return desc_sw32(addr);
  if constexpr (D == 64) return desc_sw64(addr + kk * 32);
  return desc_sw128(addr + kk * 32);
}

// The int8 code tile of an instantiation of head width D (K3, K7; see the
// top): rows of W bytes, whole rows of D (one box) at D = 32, 64 and 128,
// and at D = 80 rows of 96 bytes, a panel of ROW = 64 bytes a row and the
// tail panel of the last 32; STEPS k32 steps over a row.
template <int D>
struct Codes {
  static constexpr bool TAIL = D == 80;
  static constexpr int W = TAIL ? 96 : D;
  static constexpr int ROW = TAIL ? 64 : D;
  static constexpr int STEPS = W / 32;
};

// the K-major descriptor of k32 step kk (0 to 2) of rows row0.. of a tile
// of `rows` code rows of 96 bytes (Codes<80>) at shared address a
__device__ __forceinline__ uint64_t desc_c96(uint32_t a, int rows, int row0,
                                             int kk) {
  if (kk == 2) return desc_sw32(a + rows * 64 + row0 * 32);
  return desc_sw64(a + row0 * 64 + kk * 32);
}

// A bf16 tile of head width D in shared memory (see the top): N panels of
// COLS columns, each ROW bytes a row and `rows` rows deep, one after the
// other, the TMA box of a panel COLS columns wide; at D = 80 (TAIL) one
// such panel and then the tail panel of the last 16 columns, 32 bytes a
// row, its box 16 columns wide. A tile holds BYTES_ROW bytes a row.
template <int D>
struct Panels {
  static_assert(D == 32 || D == 80 || D % 64 == 0, "Panels: D");
  static constexpr int COLS = D == 32 ? 32 : 64;
  static constexpr int ROW = 2 * COLS;
  static constexpr int N = D / COLS;
  static constexpr bool TAIL = D == 80;
  static constexpr int BYTES_ROW = 2 * D;
};

// the K-major descriptor of k-step kk (16 columns) of rows row0.. of a bf16
// tile of `rows` rows at shared address a
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t a, int rows, int row0,
                                           int kk) {
  if constexpr (D == 32) return desc_sw64(a + row0 * 64 + kk * 32);
  if constexpr (D == 80) {
    if (kk == 4) return desc_sw32(a + rows * 128 + row0 * 32);
  }
  return desc_sw128(a + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32);
}

// the MN-major descriptor of k-step kk (16 rows) of a bf16 tile of `rows`
// rows at shared address a, read as a B operand of N = D (at D = 80, of
// the 64-column panel alone: `wgmma_rs_mn`)
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t a, int rows, int kk) {
  if constexpr (D == 32) return desc_sw64(a + kk * 1024, 512);
  return desc_sw128(a + kk * 2048, rows * 128);
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
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
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
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
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
// D (64 x 8, f32) += A B, one k16 step, A from registers and B by a
// descriptor; with `desc_ones` it gives each row's sum of A in every column
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_rs: N");
  if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, db, scale_d);
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_rs_n128<TB>(d, a, db, scale_d);
}

// D (64 x N, f32) += A B over k-step kk (16 rows) of a bf16 tile of `rows`
// rows at shared address a in the panels of head width N, read MN-major
// (p v, ds k, p^T do, ds^T q): one wgmma, or at N = 80 an n64 wgmma on the
// 64-column panel into d[0..31] (columns 0-63) and an n16 one on the tail
// panel into d[32..39] (columns 64-79), the accumulator's layout at N = 80
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint32_t tile, int rows, int kk) {
  if constexpr (N == 80) {
    wgmma_rs_n64<1>(*reinterpret_cast<float(*)[32]>(d), a,
                    desc_mn<N>(tile, rows, kk), 1);
    wgmma_rs_n16<1>(*reinterpret_cast<float(*)[8]>(d + 32), a,
                    desc_sw32(tile + rows * 128 + kk * 512), 1);
  } else {
    wgmma_rs<N, 1>(d, a, desc_mn<N>(tile, rows, kk), 1);
  }
}

// D (64 x N, s32) (+)= A B, one k32 step of s8 operands, both K-major in
// shared memory by descriptors; scale_d = 0 overwrites D. The s32
// accumulator has the thread layout of the f32 one (see acc_to_a).
__device__ __forceinline__ void wgmma_i8_n32(uint32_t (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_i8_n64(uint32_t (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_i8_n128(uint32_t (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_i8(uint32_t (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_i8: N");
  if constexpr (N == 32) wgmma_i8_n32(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_i8_n64(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_i8_n128(d, da, db, scale_d);
}

// D (64 x N, s32) (+)= A B, one k32 step of s8 operands: A from registers,
// four bytes a register in the m16n8k32 A fragment of each warp's 16 rows
// (register 0: row g, k 4t..4t+3; 1: row g + 8, the same k; 2 and 3: k + 16);
// B K-major in shared memory by a descriptor (K8's p8 v8)
__device__ __forceinline__ void wgmma_i8_rs_n32(uint32_t (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_i8_rs_n64(uint32_t (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_i8_rs_n128(uint32_t (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_i8_rs(uint32_t (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_i8_rs: N");
  if constexpr (N == 32) wgmma_i8_rs_n32(d, a, db, scale_d);
  if constexpr (N == 64) wgmma_i8_rs_n64(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_i8_rs_n128(d, a, db, scale_d);
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

// the same from f32 values held as their bits (the int8 kernels write
// them over their s32 accumulators)
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4],
                                         const uint32_t (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int w = 0; w < 4; ++w)
    {
      __nv_bfloat162 v = __floats2bfloat162_rn(
          __uint_as_float(d[8 * kk + 2 * w]),
          __uint_as_float(d[8 * kk + 2 * w + 1]));
      a[kk][w] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}

// bf16 store of a 64 x N accumulator times `mul` into rows row0 + (the
// thread's rows) of a row-major base; rows at or past n are skipped, and
// columns at or past cols (even; N by default)
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base,
                                          long long row_stride,
                                          const float (&d)[N / 2], float mul,
                                          int r0, int n, int t,
                                          int cols = N) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col >= cols) continue;
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

// 2^x in one MUFU op (subnormal results flush to 0; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers, TMA, registers, named barriers ----------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// make this thread's shared-memory writes visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// expect `bytes` more of TMA transactions in the current phase, without
// an arrival
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
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

// Tensor map of a (B, N, H, D) tensor of `esize`-byte elements with element
// strides sb, sn, sh (the last dim contiguous): dims (D, H, N, B), box
// (cols, 1, rows, 1), rows past N read as zero. A dim of size 1 is never
// stepped, so its stride is set to 16 bytes. The same geometry as
// ops/attention.py::_tma_geometry, which checks it before the launch.
inline cudaError_t make_map_box(CUtensorMap* map, const void* base,
                                CUtensorMapDataType type, int esize,
                                int cols, CUtensorMapSwizzle swizzle, int B,
                                int N, int H, int D, long long sb,
                                long long sn, long long sh, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const long long el[3] = {sh, sn, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const long long bytes = dims[i + 1] == 1 ? 16 : el[i] * esize;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1LL << 40))
      return cudaErrorInvalidValue;
    strides[i] = (cuuint64_t)bytes;
  }
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || rows < 1 || rows > 256)
    return cudaErrorInvalidValue;
  CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides, box,
                  estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16: boxes of 64 columns (one 128-byte panel), the 128-byte swizzle
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int N,
                            int H, int D, long long sb, long long sn,
                            long long sh, int rows) {
  return make_map_box(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64,
                      CU_TENSOR_MAP_SWIZZLE_128B, B, N, H, D, sb, sn, sh,
                      rows);
}

// bf16 heads of width D, read into the tiles of the instantiation of the
// next of 32, 64 and 128 up (Panels): boxes of 64 columns with the 128-byte
// swizzle, or for D up to 32 boxes of 32 columns (64 bytes) with the
// 64-byte swizzle; the box columns past D read as zero
inline cudaError_t make_map_head(CUtensorMap* map, const void* base, int B,
                                 int N, int H, int D, long long sb,
                                 long long sn, long long sh, int rows) {
  if (D > 32) return make_map(map, base, B, N, H, D, sb, sn, sh, rows);
  return make_map_box(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 32,
                      CU_TENSOR_MAP_SWIZZLE_64B, B, N, H, D, sb, sn, sh,
                      rows);
}

// the tail panel of a bf16 head read into the d-80 tiles (Panels<80>):
// boxes of 16 columns (32 bytes) with the 32-byte swizzle, loaded at column
// 64; for a head of 72 the box columns past it read as zero
inline cudaError_t make_map_tail(CUtensorMap* map, const void* base, int B,
                                 int N, int H, int D, long long sb,
                                 long long sn, long long sh, int rows) {
  return make_map_box(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 16,
                      CU_TENSOR_MAP_SWIZZLE_32B, B, N, H, D, sb, sn, sh,
                      rows);
}

// the tail panels' maps of NM operands of a kernel instantiated at width D:
// only the d-80 tiles have tail panels; empty at every other width
template <int D, int NM>
struct TailMaps {};
template <int NM>
struct TailMaps<80, NM> {
  CUtensorMap m[NM];
};

// int8: a box holds whole rows of D = 32, 64 or 128 bytes, with the swizzle
// of their width (see the top); rows of D = 96 bytes (the d-80 tiles'
// codes) by two maps, boxes of the first 64 bytes with the 64-byte swizzle
// here and of the last 32 in make_map_i8_tail. CUtensorMapDataType has no
// signed 8-bit type; UINT8 copies the same bytes.
inline cudaError_t make_map_i8(CUtensorMap* map, const void* base, int B,
                               int N, int H, int D, long long sb,
                               long long sn, long long sh, int rows) {
  if (D == 96)
    return make_map_box(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 64,
                        CU_TENSOR_MAP_SWIZZLE_64B, B, N, H, D, sb, sn, sh,
                        rows);
  if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
  return make_map_box(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D,
                      D == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                      : D == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_128B,
                      B, N, H, D, sb, sn, sh, rows);
}

// the tail panel of int8 codes of D = 96 bytes a row (the d-80 tiles):
// boxes of 32 bytes with the 32-byte swizzle, loaded at byte 64
inline cudaError_t make_map_i8_tail(CUtensorMap* map, const void* base,
                                    int B, int N, int H, int D, long long sb,
                                    long long sn, long long sh, int rows) {
  if (D != 96) return cudaErrorInvalidValue;
  return make_map_box(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 32,
                      CU_TENSOR_MAP_SWIZZLE_32B, B, N, H, D, sb, sn, sh,
                      rows);
}

}  // namespace
