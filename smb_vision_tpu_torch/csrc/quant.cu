// The per-(batch, head) symmetric int8 quantisation of the operands of the
// int8 attention kernels K3, K7 and K8 (R6), and the per-row one of W8A8's
// operands (w8a8_rows_kernel, at the end), for Hopper (sm_90a).
//
// Replaces the XLA quantisation of the JAX package (no Pallas kernel):
//   smb_vision_tpu/ops/attention.py:_fwd_i8 (q, k and, for pv, v) and
//   _quant_per_head (q, k, v, do of the int8 backward),
// and it is exactly ops/attention.py::quantize_per_head, bit for bit. For x
// (B, N, H, D) bf16 and a multiplier mult, per (b, h) over all (n, d):
//   xf  = float(x) * mult                         (f32, rounded once)
//   s   = max|xf| * f32(1/127), 1 where that is 0 (as XLA compiles the JAX
//         `max / 127.`: a division by a constant becomes a multiply by its
//         f32 reciprocal)
//   x8  = clamp(rint(xf / s), -127, 127)           (IEEE division, ties to
//         even)
// With zero_scale, an all-zero (b, h) reports the scale 0 instead of the
// guard's 1 (its bytes are 0 either way): K7 takes do's scale so, since its
// one-FFMA conversion of dp rounds at half a unit of the scale.
// D is any multiple of 8 up to 128. The codes' rows may be wider than D
// (W, a multiple of 8 up to 128): K3 and K8 read a head of width D < W on
// their instantiation of width W (32, 64 or 128), whose int8 tiles hold
// whole rows of W bytes, so the columns D .. W-1 are written as zeros.
// Zeros leave the absmax, and so every code and scale, as at width D.
// Every step is an exact IEEE operation or a max, so the bytes and scales
// are the plain version's whatever the order of the reduction.
//
// Bound on the H100: bytes, one read of x (bf16) and one write of x8 (int8)
// at 3.35 TB/s: 14 us for one 20,480 x 768 tensor. Design: two launches
// after a memset of the (B*H) max workspace, so x is read twice: the second
// read is this design's cost above the bound.
//   - pass 1: a block takes 256 rows of one (b, h), each thread 16 bytes
//     (8 values) of a row, 4 rows in flight before it uses one (D/8 threads
//     a row, so a warp reads 2 to 32 whole rows; where D/8 does not divide
//     the block's 256 threads, the last few idle); the block's max goes to the
//     workspace by one atomicMax on the f32 bits, which order as integers
//     for non-negative floats;
//   - pass 2 reads x again (much of it from L2) and writes x8 either in the
//     input's layout, (B, N, H, W) contiguous, 8 bytes a thread (W/8
//     threads a row, those past D writing zeros), or in the
//     layout K8 reads its v8 in (flash_fwd.cu; ops/attention.py::
//     quantize_v_kernel_layout): (B, H, W, Npad), keys contiguous, zeros
//     past N and in the rows past D, keys permuted within each 32 so that K8's register fragments
//     of p8 meet them. A block then takes 64 keys of one (b, h) and
//     transposes them through shared memory, writing 16-byte runs of keys.
// The first block of pass 2 for each (b, h) writes s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;        // rows of one (b, h) a block covers
constexpr int kVKeys = 64;        // keys of one (b, h) a v-layout block covers
constexpr int kMaxD = 128;
constexpr int kBatch = 4;         // rows a thread loads before it uses one
constexpr float kInv127 = 1.f / 127.f;

struct QuantParams {
  const __nv_bfloat16* x;
  long long sb, sn, sh;  // element strides of x; the last dim contiguous
  int N, H, D;
  int W;           // codes a row of x8 (or rows of a v-layout block): D to 128
  float mult;
  unsigned* amax;  // (B*H) workspace, zeroed before pass 1
  float* s;        // (B*H) scales
  int8_t* x8;
  int npad;        // v layout: keys of a (b, h) row of x8; 0: row layout
  int zero_scale;  // write 0, not 1, as the scale of an all-zero (b, h)
};

// the 8 values of x at (b, n, h, c..c+7), times mult
__device__ __forceinline__ void load8(const QuantParams& p, int b, int n,
                                      int h, int c, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(
      p.x + b * p.sb + n * p.sn + h * p.sh + c);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(x2[i]);
    v[2 * i] = __fmul_rn(f.x, p.mult);
    v[2 * i + 1] = __fmul_rn(f.y, p.mult);
  }
}

__device__ __forceinline__ float scale_of(const QuantParams& p, int bh) {
  const float s = __fmul_rn(__uint_as_float(p.amax[bh]), kInv127);
  return s == 0.f ? 1.f : s;
}

// the scale written out for (b, h), whose quantisation divides by s
__device__ __forceinline__ float out_scale(const QuantParams& p, int bh,
                                           float s) {
  return p.zero_scale && p.amax[bh] == 0u ? 0.f : s;
}

// clamp(rint(v / s), -127, 127) as a byte
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu;
}

// kBatch rows of this thread's column c, `step` rows apart from n, and
// whether each is below n1 (zeros past it)
__device__ __forceinline__ void load_batch(const QuantParams& p, int b,
                                           int n, int step, int n1, int h,
                                           int c, float (&v)[kBatch][8],
                                           bool (&ok)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    ok[u] = n + u * step < n1;
    if (ok[u]) {
      load8(p, b, n + u * step, h, c, v[u]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    quant_absmax_kernel(const QuantParams p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int cpr = p.D / 8;  // threads a row
  const int step = kThreads / cpr;
  const int c = (threadIdx.x % cpr) * 8;
  const int n1 = min((blockIdx.x + 1) * kRows, p.N);
  // the threads past step whole rows idle (D/8 need not divide kThreads)
  const int first = threadIdx.x < step * cpr ? threadIdx.x / cpr : kRows;
  float m = 0.f;
  for (int n = blockIdx.x * kRows + first; n < n1; n += kBatch * step) {
    float v[kBatch][8];
    bool ok[kBatch];
    load_batch(p, b, n, step, n1, h, c, v, ok);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[u][i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float wmax[kThreads / 32];
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, wmax[w]);
    atomicMax(p.amax + b * p.H + h, __float_as_uint(m));
  }
}

// x8 in the input's layout at W codes a row, (B, N, H, W) contiguous
__global__ void __launch_bounds__(kThreads)
    quant_rows_kernel(const QuantParams p) {
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const int cpr = p.W / 8;
  const int c = (threadIdx.x % cpr) * 8;
  const float s = scale_of(p, bh);
  if (blockIdx.x == 0 && threadIdx.x == 0) p.s[bh] = out_scale(p, bh, s);
  const int step = kThreads / cpr;
  const int n1 = min((blockIdx.x + 1) * kRows, p.N);
  const int first = threadIdx.x < step * cpr ? threadIdx.x / cpr : kRows;
  for (int n = blockIdx.x * kRows + first; n < n1; n += kBatch * step) {
    float v[kBatch][8];
    bool ok[kBatch];
    // a thread past D loads nothing: its 8 values are 0, their codes 0
    load_batch(p, b, n, step, c < p.D ? n1 : n, h, c, v, ok);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (n + u * step >= n1) continue;
      const float* w = v[u];
      uint2 out;
      out.x = quant_byte(w[0], s) | quant_byte(w[1], s) << 8 |
              quant_byte(w[2], s) << 16 | quant_byte(w[3], s) << 24;
      out.y = quant_byte(w[4], s) | quant_byte(w[5], s) << 8 |
              quant_byte(w[6], s) << 16 | quant_byte(w[7], s) << 24;
      *reinterpret_cast<uint2*>(
          p.x8 + (((long long)b * p.N + n + u * step) * p.H + h) * p.W +
          c) = out;
    }
  }
}

// the key that position pos of a 32-key group of K8's v8 holds:
// pos = half*16 + 4t + 2hi + lo holds key half*16 + hi*8 + 2t + lo
__device__ __forceinline__ int v_key(int pos) {
  return (pos & 16) | ((pos >> 1) & 1) << 3 | ((pos >> 2) & 3) << 1 |
         (pos & 1);
}

// x8 in K8's v layout, (B, H, W, Npad)
__global__ void __launch_bounds__(kThreads)
    quant_v_kernel(const QuantParams p) {
  __shared__ uint8_t tile[kMaxD][kVKeys + 4];  // [d][key]
  const int h = blockIdx.y, b = blockIdx.z, bh = b * p.H + h;
  const int n0 = blockIdx.x * kVKeys;
  const int cpr = p.W / 8;
  const float s = scale_of(p, bh);
  if (blockIdx.x == 0 && threadIdx.x == 0) p.s[bh] = out_scale(p, bh, s);
  for (int i = threadIdx.x; i < kVKeys * cpr; i += kThreads) {
    const int key = i / cpr, c = (i % cpr) * 8;
    float v[8];
    if (n0 + key < p.N && c < p.D) {
      load8(p, b, n0 + key, h, c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;  // quantises to 0 (keys past
    }                                          // N, rows past D)
#pragma unroll
    for (int e = 0; e < 8; ++e) tile[c + e][key] = quant_byte(v[e], s);
  }
  __syncthreads();
  // W rows of 64 bytes, 16 bytes a thread
  for (int i = threadIdx.x; i < p.W * (kVKeys / 16); i += kThreads) {
    const int d = i / (kVKeys / 16), p0 = (i % (kVKeys / 16)) * 16;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + 4 * k + e;
        w[k] |= (uint32_t)tile[d][(pos & ~31) | v_key(pos & 31)] << (8 * e);
      }
    }
    *reinterpret_cast<uint4*>(p.x8 + ((long long)bh * p.W + d) * p.npad + n0 +
                              p0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace

// x bf16 (B, N, H, D), strides (3 int64 in elements: batch, token, head;
// the last dim contiguous, every row 16-byte aligned); D a multiple of 8 up
// to 128. amax: B*H uint32 of workspace; s: B*H f32 out; x8: int8 out,
// (B, N, H, W) contiguous when npad is 0, else K8's v layout (B, H, W, npad)
// with npad a multiple of 64 and at least N, W = width (a multiple of 8
// from D to 128; 0 for D) and zeros past D; zero_scale: 0, not 1, as the
// scale of an all-zero (b, h). width comes last, so a caller that passes it
// to an older library of this interface (which takes none, at W = D) still
// runs. Returns a cudaError_t (0 on success).
extern "C" int smb_quantize(const void* x, int B, int N, int H, int D,
                            const long long* strides, float mult, void* amax,
                            void* s, void* x8, int npad, int zero_scale,
                            void* stream, int width) {
  QuantParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.sb = strides[0];
  p.sn = strides[1];
  p.sh = strides[2];
  p.N = N;
  p.H = H;
  p.D = D;
  p.mult = mult;
  p.amax = static_cast<unsigned*>(amax);
  p.s = static_cast<float*>(s);
  p.x8 = static_cast<int8_t*>(x8);
  p.W = width == 0 ? D : width;
  p.npad = npad;
  p.zero_scale = zero_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || B <= 0 || B > 65535 || H <= 0 || H > 65535 || D <= 0 ||
      D % 8 != 0 || p.W < D || p.W > kMaxD || p.W % 8 != 0 || npad < 0 ||
      (npad > 0 && (npad % kVKeys != 0 || npad < N)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * B * H, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kRows - 1) / kRows, H, B);
  quant_absmax_kernel<<<grid, kThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (npad == 0)
    quant_rows_kernel<<<grid, kThreads, 0, st>>>(p);
  else
    quant_v_kernel<<<dim3(npad / kVKeys, H, B), kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

namespace {

// ---------------------------------------------------------------------------
// W8A8's row quantisation: the activations of every quant8 projection (per
// token) and the weights (per output channel: a Linear weight's rows).
//
// Replaces the XLA quantisation of the JAX package (no Pallas kernel):
//   smb_vision_tpu/ops/quant.py:w8a8_dot, lines 47-49 (x) and 52-54 (the
//   weight),
// and it is exactly ops/quant.py::quantize_rows_plain, bit for bit. For x
// (rows, K) bf16 or f32, per row:
//   s   = max|x| * f32(1/127), 1 where that is 0 (XLA's compile of the JAX
//         `max / 127.`, as above)
//   x8  = clamp(rint(x / s), -127, 127)       (IEEE division, ties to even)
// written into rows of kpad >= K bytes, zeros past K (kpad a multiple of
// 16: TMA reads the codes, and zeros are exact in the product).
//
// Bound on the H100: bytes, one read of x and one write of x8 at 3.35
// TB/s: 14 us for a 20,480 x 768 bf16 tensor, 56 us at 20,480 x 3,072.
// Design: one warp a row, 8 rows a block; the warp reads its row twice,
// for the max and then for the codes, the second read from L1 (a block's
// rows are at most 8 x 12 KB at K 3,072 in f32). Each lane loads 16 bytes
// at a time (8 bf16 or 4 f32 values) where the row's start and K allow,
// else one value, and writes its 8 or 4 codes at once.

constexpr int kRowWarps = 8;  // rows of a block

template <typename T>
__device__ __forceinline__ float as_float(T v);
template <>
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float as_float(float v) {
  return v;
}

// V values of row xr at column c: 16 bytes at once for V > 1
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* xr, int c, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = as_float(xr[c]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = as_float(e[i]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kRowWarps * 32)
    w8a8_rows_kernel(const T* x, long long stride, int rows, int K,
                     int kpad, float* s, int8_t* x8) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * stride;
  float m = 0.f;
  for (int c = lane * V; c < K; c += 32 * V) {
    float v[V];
    load_row<T, V>(xr, c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) m = fmaxf(m, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float sc = __fmul_rn(m, kInv127);
  sc = sc == 0.f ? 1.f : sc;
  if (lane == 0) s[row] = sc;
  int8_t* out = x8 + row * kpad;
  for (int c = lane * V; c < K; c += 32 * V) {
    float v[V];
    load_row<T, V>(xr, c, v);
    if constexpr (V == 1) {
      out[c] = static_cast<int8_t>(quant_byte(v[0], sc));
    } else {
      uint32_t w[V / 4];
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        w[i] = quant_byte(v[4 * i], sc) | quant_byte(v[4 * i + 1], sc) << 8 |
               quant_byte(v[4 * i + 2], sc) << 16 |
               quant_byte(v[4 * i + 3], sc) << 24;
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(out + c) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(out + c) = w[0];
    }
  }
  for (int c = K + lane; c < kpad; c += 32) out[c] = 0;
}

template <typename T, int V>
cudaError_t launch_rows(const void* x, long long stride, int rows, int K,
                        int kpad, void* s, void* x8, cudaStream_t st) {
  w8a8_rows_kernel<T, V><<<(rows + kRowWarps - 1) / kRowWarps,
                           kRowWarps * 32, 0, st>>>(
      static_cast<const T*>(x), stride, rows, K, kpad,
      static_cast<float*>(s), static_cast<int8_t*>(x8));
  return cudaGetLastError();
}

}  // namespace

// x (rows, K) bf16 (f32 == 0) or f32 (f32 != 0), rows `stride` elements
// apart, the last dim contiguous; s: rows f32 out; x8: (rows, kpad) int8
// out, contiguous, kpad >= K a multiple of 16, zeros past K. Returns a
// cudaError_t (0 on success).
extern "C" int smb_quantize_rows(const void* x, int rows, int K,
                                 long long stride, int f32, int kpad,
                                 void* s, void* x8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || K <= 0 || kpad < K || kpad % 16 != 0 ||
      (rows > 1 && stride < K) ||
      reinterpret_cast<uintptr_t>(x8) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int esize = f32 ? 4 : 2, v = 16 / esize;
  // 16-byte loads where every row's start is 16-byte aligned and K splits
  // into whole loads
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (stride * esize) % 16 == 0 && K % v == 0;
  if (f32)
    return (int)(vec ? launch_rows<float, 4>(x, stride, rows, K, kpad, s, x8,
                                             st)
                     : launch_rows<float, 1>(x, stride, rows, K, kpad, s, x8,
                                             st));
  return (int)(vec ? launch_rows<__nv_bfloat16, 8>(x, stride, rows, K, kpad,
                                                   s, x8, st)
                   : launch_rows<__nv_bfloat16, 1>(x, stride, rows, K, kpad,
                                                   s, x8, st));
}
