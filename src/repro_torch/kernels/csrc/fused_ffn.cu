// Fused gated FFN, y = (act(x @ Wg) * (x @ Wu)) @ Wd, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_ffn` in
// src/repro/kernels/fused_ffn.py (pallas_call at line 54, kernel body
// `_fused_ffn_kernel` at line 24).  Plain version:
// repro_torch.kernels.ref.fused_ffn_ref.
//
// What it computes: x (M, D), Wg and Wu (D, F), Wd (F, D), all f32 or
// all bf16; act is silu or the tanh form of gelu (jax.nn.gelu's
// default).  The hidden tile act(x@Wg) * (x@Wu) lives in shared memory
// and never goes to device memory.  Accumulation: the TPU kernel adds
// each F tile's partial product into its output block in the output's
// dtype, so in bf16 it rounds once per F tile (fused_ffn.py:34-41).
// This kernel follows the oracle instead: every sum is f32 across all
// of F, rounded once to the output dtype.
//
// Bound on the H100: at the served shapes (D 256, F 1024) a decode step
// (M = 8) reads the three weight matrices, 1.5 MB in bf16, for 12.6
// MFLOP: bytes bound (~0.5 us).  A prefill burst (M = 8 x 1024 .. 8 x
// 2048) does 6 * M * D * F flops, 0.8 GFLOP per 512 rows, on ~1.6 MB
// plus 1 KB a row: operations bound, bf16 tensor cores in the limit.
// This first version runs on the CUDA cores in f32 (67 TFLOP/s), far
// from that bound by design; mma/wgmma tiles are a later change.
//
// Design (simple first).  The TPU design keeps D whole in a (bm, D)
// output tile in VMEM and walks F in a sequential grid; on Hopper the
// blocks run in no order and a (bm, D) f32 tile does not fit shared
// memory for large D.  So the grid is (64-row tile, 256-column output
// tile, F split), with a loop over 64-wide F tiles inside the block:
//   phase A: g, u = x_tile @ Wg/Wu[:, f-tile] over D in 32-wide chunks
//            staged in shared memory (4x4 of g and u per thread);
//            h = act(g) * u goes to shared memory;
//   phase B: out_tile += h @ Wd[f-tile, d-tile] with Wd's tile staged in
//            shared memory (4x16 output values per thread, f32).
// Output tiles narrower than D recompute phase A D/256 times: no
// recompute at D 256, 4x at D 1024.  Small M gives too few row tiles to
// fill the card, so the wrapper splits F across blocks (blockIdx.z):
// each split writes its f32 partial sum to a workspace of nsplit * M * D
// floats (16 * 8 * 256 * 4 = 128 KB at a decode step), and a second pass
// adds the splits in a fixed order and rounds once.  No float atomics:
// the result repeats from run to run.  Any M, D and F: ragged tiles are
// masked (loads of 0 give a hidden value act(0) * 0 == 0).
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError() of
// the launches.  It launches on the caller's stream and allocates
// nothing: the wrapper passes the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;      // rows per block
constexpr int kBF = 64;      // hidden columns per F tile
constexpr int kBD = 256;     // output columns per block
constexpr int kKD = 32;      // D chunk of phase A
constexpr int kThreads = 256;
constexpr int kXP = kKD + 1;
constexpr int kHP = kBF + 1;

enum DType { kF32 = 0, kBF16 = 1 };
enum Act { kSilu = 0, kGelu = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == kSilu) return g / (1.f + expf(-g));
  // tanh approximation: 0.5 g (1 + tanh(sqrt(2/pi) (g + 0.044715 g^3)))
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f *
                                 (g + 0.044715f * g * g * g)));
}

struct Args {
  const void* x;
  const void* wg;
  const void* wu;
  const void* wd;
  void* out;           // written directly when nsplit == 1
  float* ws;           // nsplit x M x D partial sums otherwise
  int m, d, f, nsplit, f_tiles_per_split, act;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ffn_kernel(Args a) {
  extern __shared__ float smem[];
  float* x_s = smem;                     // kBM x kXP
  float* g_s = x_s + kBM * kXP;          // kKD x kBF
  float* u_s = g_s + kKD * kBF;          // kKD x kBF
  float* h_s = u_s + kKD * kBF;          // kBM x kHP
  float* w_s = h_s + kBM * kHP;          // kBF x kBD

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ wg = static_cast<const T*>(a.wg);
  const T* __restrict__ wu = static_cast<const T*>(a.wu);
  const T* __restrict__ wd = static_cast<const T*>(a.wd);

  const int M = a.m, D = a.d, F = a.f;
  const int m0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBD;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float o[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) o[i][j] = 0.f;

  const int ft_begin = blockIdx.z * a.f_tiles_per_split;
  const int ft_end = min(ft_begin + a.f_tiles_per_split,
                         (F + kBF - 1) / kBF);
  for (int ft = ft_begin; ft < ft_end; ++ft) {
    const int f0 = ft * kBF;
    // ---- phase A: the (kBM, kBF) hidden tile
    float g[4][4], u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += kKD) {
      for (int i = tid; i < kBM * kKD; i += kThreads) {
        const int rr = i / kKD, kk = i % kKD;
        const int row = m0 + rr, col = k0 + kk;
        x_s[rr * kXP + kk] =
            row < M && col < D ? to_float(x[(long long)row * D + col]) : 0.f;
      }
      for (int i = tid; i < kKD * kBF; i += kThreads) {
        const int kk = i / kBF, ff = i % kBF;
        const int row = k0 + kk, col = f0 + ff;
        const bool in = row < D && col < F;
        const long long off = (long long)row * F + col;
        g_s[i] = in ? to_float(wg[off]) : 0.f;
        u_s[i] = in ? to_float(wu[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKD; ++kk) {
        float xv[4], gv[4], uv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = x_s[(ty * 4 + i) * kXP + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gv[j] = g_s[kk * kBF + tx + 16 * j];
          uv[j] = u_s[kk * kBF + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            g[i][j] = fmaf(xv[i], gv[j], g[i][j]);
            u[i][j] = fmaf(xv[i], uv[j], u[i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h_s[(ty * 4 + i) * kHP + tx + 16 * j] =
            activate(g[i][j], a.act) * u[i][j];
    for (int i = tid; i < kBF * kBD; i += kThreads) {
      const int ff = i / kBD, dd = i % kBD;
      const int row = f0 + ff, col = d0 + dd;
      w_s[i] = row < F && col < D ? to_float(wd[(long long)row * D + col])
                                  : 0.f;
    }
    __syncthreads();
    // ---- phase B: out_tile += h @ Wd tile, f32
#pragma unroll 4
    for (int ff = 0; ff < kBF; ++ff) {
      float hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = h_s[(ty * 4 + i) * kHP + ff];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float w = w_s[ff * kBD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(hv[i], w, o[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = d0 + tx + 16 * j;
      if (col >= D) continue;
      const long long off = (long long)row * D + col;
      if (a.nsplit == 1)
        static_cast<T*>(a.out)[off] = from_float<T>(o[i][j]);
      else
        a.ws[(long long)blockIdx.z * M * D + off] = o[i][j];
    }
  }
}

// Adds the F splits in order and rounds once.
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  T* __restrict__ out, long long n,
                                  int nsplit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < nsplit; ++z) s += ws[(long long)z * n + i];
  out[i] = from_float<T>(s);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) *
                       ((size_t)kBM * kXP + 2 * (size_t)kKD * kBF +
                        (size_t)kBM * kHP + (size_t)kBF * kBD);
  auto kernel = fused_ffn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.m + kBM - 1) / kBM, (a.d + kBD - 1) / kBD, a.nsplit);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long n = (long long)a.m * a.d;
  const int threads = 256;
  sum_splits_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         stream>>>(a.ws, static_cast<T*>(a.out), n, a.nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_ffn(const void* x, const void* wg, const void* wu,
                         const void* wd, void* out, void* ws, int m, int d,
                         int f, int nsplit, int f_tiles_per_split, int act,
                         int dtype, void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  Args a{x, wg, wu, wd, out, static_cast<float*>(ws), m, d, f, nsplit,
         f_tiles_per_split, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(a, s);
    case kBF16: return launch<__nv_bfloat16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
