// Blockwise activation quantization (int8 and packed int4) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/act_quant.py:
//   act_quant    (pallas_call at line 47, body `_act_quant_kernel` :21)
//   act_dequant  (pallas_call at line 70, body `_act_dequant_kernel` :32)
//   act_quant4   (pallas_call at line 113, body `_act_quant4_kernel` :83)
//   act_dequant4 (pallas_call at line 154, body `_act_dequant4_kernel` :129)
// Plain versions: repro_torch.kernels.ref.act_quant_ref, act_dequant_ref,
// act_quant4_ref and act_dequant4_ref.
//
// What it computes: each row of x (rows, n) is cut into blocks of 128
// elements.  For each block, in f32:
//   scale = amax / 127 + 1e-12           (int8; amax / 7 + 1e-12 for int4)
//   code  = clip(round_half_even(x / scale), -127, 127)   (int4: -7, 7)
// int8 codes are stored as they are, (rows, n); int4 codes are biased by
// +8 into [1, 15] and packed two to a byte, the even column in the low
// nibble, (rows, ceil(n / 128) * 64).  Scales are f32 (rows,
// ceil(n / 128)).  Dequantization is code * scale in f32, rounded once
// to the output type.  The last block of a row may be short: its missing
// columns count as zeros, which change no absmax, so this is the JAX
// codec's zero padding of the row without the padding copy.  int4 writes
// the padded columns' codes too (0 + 8, so every padded byte is 0x88),
// as the JAX codec packs the padded row.
//
// Bits: the arithmetic is the plain version's, element by element, so
// codes, packed bytes, scales and dequantized values are bit-equal to
// it.  That needs IEEE division (`/`, never a reciprocal or
// __fdividef, and no --use_fast_math), f32 literals, rintf (half to
// even, where roundf rounds half away from zero) and
// __float2bfloat16_rn.  A NaN in a block is dropped by fmaxf from the
// absmax (the plain version's amax propagates it), so the two disagree
// on such a block: inputs are expected to be finite.
//
// Bound on the H100: bytes.  Quantizing the mamba2-370m SSM state
// (786,432 rows x 128 in f32, 402.7 MB) reads 402.7 MB and writes
// 100.7 MB of codes (50.3 MB packed) and 3.1 MB of scales: ~0.15 ms at
// 3.35 TB/s; dequantizing to bf16 writes 201.3 MB: ~0.09 ms.  Nothing is
// reused, so nothing is staged in shared memory.
//
// Design (simple first): one warp per 128-wide block.  Each lane loads
// 4 consecutive elements (16 bytes of f32, 8 of bf16; one vector load
// when the row length and the base pointer allow it, else masked scalar
// loads), a __shfl_xor_sync max reduction gives the block's absmax, lane
// 0 writes the scale, and each lane writes its 4 codes as one char4
// (int8) or 2 bytes (int4).  The grid strides over rows x blocks, 8
// warps to a thread block.  More bytes in flight per SM is a later
// change.
//
// Interface: plain C, bound with ctypes; each entry point returns
// cudaGetLastError() of its launch.  It launches on the caller's stream
// and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;              // elements a scale covers
constexpr int kWarps = 8;                // warps per thread block
constexpr int kThreads = 32 * kWarps;
constexpr long long kMaxGrid = 4096;     // thread blocks; the grid strides

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4 consecutive elements from col; zeros at and past n
template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int col, int n,
                                      float v[4]) {
  if (VEC && col < n) {
    const float4 t = *reinterpret_cast<const float4*>(row + col);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = col + i < n ? row[col + i] : 0.0f;
}

template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* row, int col,
                                      int n, float v[4]) {
  if (VEC && col < n) {
    const uint2 t = *reinterpret_cast<const uint2*>(row + col);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    v[0] = __bfloat162float(lo.x); v[1] = __bfloat162float(lo.y);
    v[2] = __bfloat162float(hi.x); v[3] = __bfloat162float(hi.y);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = col + i < n ? __bfloat162float(row[col + i]) : 0.0f;
}

// 4 consecutive outputs from col, those before n
template <bool VEC>
__device__ __forceinline__ void store4(float* row, int col, int n,
                                       const float v[4]) {
  if (VEC && col < n) {
    *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < n) row[col + i] = v[i];
}

template <bool VEC>
__device__ __forceinline__ void store4(__nv_bfloat16* row, int col, int n,
                                       const float v[4]) {
  if (VEC && col < n) {
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16_rn(v[0]); lo.y = __float2bfloat16_rn(v[1]);
    hi.x = __float2bfloat16_rn(v[2]); hi.y = __float2bfloat16_rn(v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&lo);
    t.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(row + col) = t;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < n) row[col + i] = __float2bfloat16_rn(v[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// BITS 8: q is int8 (rows, n).  BITS 4: q is uint8 (rows, nb * 64).
template <typename T, int BITS, bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
             float* __restrict__ scales, long long rows, int n, int nb) {
  const int lane = threadIdx.x & 31;
  const long long total = rows * nb;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < total; w += step) {
    const long long row = w / nb;
    const int blk = (int)(w - row * nb);
    const int col = blk * kBlock + lane * 4;
    float v[4];
    load4<VEC>(x + row * n, col, n, v);
    const float amax = warp_max(fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                                      fmaxf(fabsf(v[2]), fabsf(v[3]))));
    const float qmax = BITS == 8 ? 127.0f : 7.0f;
    const float scale = amax / qmax + 1e-12f;
    if (lane == 0) scales[row * nb + blk] = scale;
    int c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[i] = (int)fminf(fmaxf(rintf(v[i] / scale), -qmax), qmax);
    if (BITS == 8) {
      int8_t* qr = reinterpret_cast<int8_t*>(q) + row * n;
      if (VEC && col < n) {
        *reinterpret_cast<char4*>(qr + col) =
            make_char4((signed char)c[0], (signed char)c[1],
                       (signed char)c[2], (signed char)c[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col + i < n) qr[col + i] = (int8_t)c[i];
      }
    } else {
      // the padded columns hold code 0 -> nibble 8, so padded bytes are
      // 0x88; every byte of the packed row is written
      const unsigned b0 = (unsigned)(c[0] + 8) | ((unsigned)(c[1] + 8) << 4);
      const unsigned b1 = (unsigned)(c[2] + 8) | ((unsigned)(c[3] + 8) << 4);
      *reinterpret_cast<uint16_t*>(q + row * (long long)nb * (kBlock / 2) +
                                   blk * (kBlock / 2) + lane * 2) =
          (uint16_t)(b0 | (b1 << 8));
    }
  }
}

template <typename OT, int BITS, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const uint8_t* __restrict__ q,
               const float* __restrict__ scales, OT* __restrict__ out,
               long long rows, int n, int nb) {
  const int lane = threadIdx.x & 31;
  const long long total = rows * nb;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < total; w += step) {
    const long long row = w / nb;
    const int blk = (int)(w - row * nb);
    const int col = blk * kBlock + lane * 4;
    const float s = scales[row * nb + blk];
    float c[4];
    if (BITS == 8) {
      const int8_t* qr = reinterpret_cast<const int8_t*>(q) + row * n;
      if (VEC && col < n) {
        const char4 t = *reinterpret_cast<const char4*>(qr + col);
        c[0] = (float)t.x; c[1] = (float)t.y;
        c[2] = (float)t.z; c[3] = (float)t.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c[i] = col + i < n ? (float)qr[col + i] : 0.0f;
      }
    } else {
      const unsigned t = *reinterpret_cast<const uint16_t*>(
          q + row * (long long)nb * (kBlock / 2) + blk * (kBlock / 2) +
          lane * 2);
      c[0] = (float)((int)(t & 0xFu) - 8);
      c[1] = (float)((int)((t >> 4) & 0xFu) - 8);
      c[2] = (float)((int)((t >> 8) & 0xFu) - 8);
      c[3] = (float)((int)((t >> 12) & 0xFu) - 8);
    }
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = c[i] * s;
    store4<VEC>(out + row * n, col, n, v);
  }
}

int grid_for(long long rows, int nb) {
  const long long warps = rows * nb;
  long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  return (int)blocks;
}

template <int BITS>
int quant(const void* x, void* q, void* scales, long long rows, int n,
          int in_dtype, int vec, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || n < 1) return cudaErrorInvalidValue;
  const int nb = (n + kBlock - 1) / kBlock;
  const int grid = grid_for(rows, nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* qb = static_cast<uint8_t*>(q);
  float* sc = static_cast<float*>(scales);
  if (in_dtype == kF32) {
    const float* xp = static_cast<const float*>(x);
    if (vec)
      quant_kernel<float, BITS, true><<<grid, kThreads, 0, s>>>(
          xp, qb, sc, rows, n, nb);
    else
      quant_kernel<float, BITS, false><<<grid, kThreads, 0, s>>>(
          xp, qb, sc, rows, n, nb);
  } else if (in_dtype == kBF16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    if (vec)
      quant_kernel<__nv_bfloat16, BITS, true><<<grid, kThreads, 0, s>>>(
          xp, qb, sc, rows, n, nb);
    else
      quant_kernel<__nv_bfloat16, BITS, false><<<grid, kThreads, 0, s>>>(
          xp, qb, sc, rows, n, nb);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int BITS>
int dequant(const void* q, const void* scales, void* out, long long rows,
            int n, int out_dtype, int vec, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (rows < 0 || n < 1) return cudaErrorInvalidValue;
  const int nb = (n + kBlock - 1) / kBlock;
  const int grid = grid_for(rows, nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  if (out_dtype == kF32) {
    float* o = static_cast<float*>(out);
    if (vec)
      dequant_kernel<float, BITS, true><<<grid, kThreads, 0, s>>>(
          qb, sc, o, rows, n, nb);
    else
      dequant_kernel<float, BITS, false><<<grid, kThreads, 0, s>>>(
          qb, sc, o, rows, n, nb);
  } else if (out_dtype == kBF16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec)
      dequant_kernel<__nv_bfloat16, BITS, true><<<grid, kThreads, 0, s>>>(
          qb, sc, o, rows, n, nb);
    else
      dequant_kernel<__nv_bfloat16, BITS, false><<<grid, kThreads, 0, s>>>(
          qb, sc, o, rows, n, nb);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x (rows, n) f32/bf16, contiguous -> codes int8 (rows, n), scales f32
// (rows, ceil(n/128)).  vec: n % 4 == 0 and x 16-byte (f32) / 8-byte
// (bf16) aligned.
extern "C" int act_quant8(const void* x, void* q, void* scales,
                          long long rows, int n, int in_dtype, int vec,
                          void* stream) {
  return quant<8>(x, q, scales, rows, n, in_dtype, vec, stream);
}

// x (rows, n) -> packed uint8 (rows, ceil(n/128) * 64), scales as above.
extern "C" int act_quant4(const void* x, void* q, void* scales,
                          long long rows, int n, int in_dtype, int vec,
                          void* stream) {
  return quant<4>(x, q, scales, rows, n, in_dtype, vec, stream);
}

// codes int8 (rows, n), scales -> out (rows, n) f32/bf16.  vec: n % 4 == 0
// and the codes 4-byte aligned.
extern "C" int act_dequant8(const void* q, const void* scales, void* out,
                            long long rows, int n, int out_dtype, int vec,
                            void* stream) {
  return dequant<8>(q, scales, out, rows, n, out_dtype, vec, stream);
}

// packed uint8 (rows, ceil(n/128) * 64), 2-byte aligned, scales -> out
// (rows, n) f32/bf16.  vec: n % 4 == 0.
extern "C" int act_dequant4(const void* q, const void* scales, void* out,
                            long long rows, int n, int out_dtype, int vec,
                            void* stream) {
  return dequant<4>(q, scales, out, rows, n, out_dtype, vec, stream);
}
