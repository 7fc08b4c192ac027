// Fused gated FFN, y = (act(x @ Wg) * (x @ Wu)) @ Wd, for Hopper (sm_90a),
// in five routes: four for bf16 (two for D <= 512, two for larger D) and
// the f32 CUDA-core kernel.  The wrapper's plan (ffn_plan in
// kernels/fused_ffn.py) picks the route and sizes its launch.
//
// Replaces the Pallas TPU kernel `fused_ffn` in
// src/repro/kernels/fused_ffn.py (pallas_call at line 54, kernel body
// `_fused_ffn_kernel` at line 24).  Plain version:
// repro_torch.kernels.ref.fused_ffn_ref.
//
// What it computes: x (M, D), Wg and Wu (D, F), Wd (F, D), all f32 or
// all bf16; act is silu or the tanh form of gelu (jax.nn.gelu's
// default).  Accumulation: the TPU kernel adds each F tile's partial
// product into its output block in the output's dtype, so in bf16 it
// rounds once per F tile (fused_ffn.py:34-41).  These kernels follow the
// oracle instead: G and U are f32 sums over all of D, the output an f32
// sum over all of F, rounded once to the output dtype.  No float atomics
// anywhere: a result repeats bit for bit.
//
// Bounds on the H100 (bf16; 3.35 TB/s, 989 TFLOP/s dense):
// - a decode step (M = 8) reads the three weight matrices once and is
//   bound by their bytes: 1.5 MB at D 256, F 1024 (0.47 us); 100.7 MB at
//   D 2048, F 8192 (30.1 us); 604 MB at D 6144, F 16384 (180 us);
// - a prefill or training batch does 6 M D F operations and is bound by
//   them: 25.8 GFLOP at M 16384, D 256, F 1024 (0.026 ms); 0.83 TFLOP at
//   M 8192, D 2048, F 8192 (0.834 ms); 1.24 TFLOP at M 2048, D 6144,
//   F 16384 (1.251 ms).
//
// bf16, D <= 512, large M ("tiles", fused_ffn_wg_kernel), on wgmma: one
// warpgroup (4 warps) per 64-row tile of x and 256-column tile of the
// output (blockIdx.y, D > 256 only).  The x tile is staged in shared
// memory once.  The loop runs over 32-wide F tiles; each F tile is a
// sequence of chunks, D/256 chunks of [Wg | Wu] (256 x 64) and one chunk
// of Wd (32 x 256), staged with cp.async 16-byte copies into a two-slot
// ring (one barrier a chunk) so the next chunk loads while this one
// computes.  [G | U] = x [Wg | Wu] is one wgmma m64n64k16 a k-step, both
// operands read by the tensor cores from shared memory; H = act(G) * U
// is computed in f32 in registers (fast intrinsics), rounded to bf16 and
// is the register A operand of O += H Wd[f-tile, :], a wgmma m64n256k16
// (the accumulator fragment of one is the A fragment of the next).  O
// (64 x 256 over the warpgroup) stays in f32 registers across all of F
// and is rounded once.  H never goes to device memory.  The operands use
// the 128-byte swizzled layout (each 16-byte chunk of a 128-byte row
// XORed with the row's index in its 8-row atom): without it the tensor
// cores' reads conflict in shared memory.  Rounding H to bf16 adds ~2^-9
// relative per term of the last sum; the output's own bf16 rounding is
// the same size.
//
// bf16, small M ("small_m", fused_ffn_small_kernel: M <= 64 while x and
// the slices fit in 200 KiB, so every M <= 64 at D <= 512): bound
// by the weight bytes, so the grid splits F into 16-column slices and the
// output into 64-column chunks: 256 blocks of 8 warps at F 1024, D 256.
// Each block stages x (M rows), its Wg/Wu slices and its Wd rows whole
// with cp.async, computes G and U for its slice on mma.sync (warps split
// D; their f32 partials are added in a fixed order), H in f32, and its
// f32 partial of the output chunk on the CUDA cores, written to the
// workspace.  The last block of a chunk to arrive (__threadfence, then a
// counter) adds the partials in split order, 16 splits' loads in flight
// at a time, rounds once and resets the counter: one launch, no float
// atomics.
//
// Why neither carries to D 2048 or 6144: small_m holds x and D x 16
// slices whole (282 KB at D 2048, above the 227 KB a block may have) and
// reads Wg/Wu once per 64-column output chunk; tiles gives each block
// one 256-column output tile, so at M 8 only D/256 blocks run (8 at D
// 2048, 24 at D 6144, on 132 SMs), each streaming all of Wg and Wu, and
// the gate and up products are done D/256 times.
//
// bf16, D > 512, small M ("split_f", fused_ffn_split_kernel; M <= 64
// while the workspace stays within a quarter of the weight bytes, which
// is M <= 24): bound by the weight bytes, so every weight byte is read
// once.  The grid splits F only, into 64-column slices: 128 blocks at F
// 8192, 256 at F 16384 (one or two an SM).  A block streams x and its
// slices of Wg/Wu through a four-stage cp.async ring of 64-row D chunks,
// so its shared memory does not grow with D (88 KB at M 8: two blocks an
// SM); G and U are computed once over all of D on mma.sync (each warp
// owns 8 columns of G and the same 8 of U, so no partials are added
// across warps).  H = act(G) * U is formed in f32 and split into bf16
// hi + lo parts, so the product with the bf16 Wd rows on mma.sync keeps
// H to ~2^-17 relative.  The block then streams its 64 Wd rows through
// the same ring in 128-column chunks, starting at its own chunk (split
// mod chunks) so the last arrivals spread over the blocks, and writes
// each chunk's f32 partial to the workspace (nsplit x M x D: 8.4 MB at
// M 8, D 2048; 50 MB at D 6144).  The last block to arrive at a chunk
// adds its nsplit partials in split order (8 float4 loads in flight a
// thread), rounds once and resets the chunk's counter.
//
// bf16, D > 512, larger M ("two_pass", fused_ffn_pass_kernel): two
// launches on wgmma, each a 4-stage cp.async ring of 64-deep K chunks in
// the 128-byte swizzled layout, tiles of 128 rows (two warpgroups
// sharing B; 64 rows, one warpgroup, for M <= 64) by 256 columns, the
// blocks rastered in groups of 8 row tiles so that concurrent blocks
// share x / H rows and weight columns in L2.  Pass 1: [G | U] = x [Wg |
// Wu] over all of D for 128 F columns (one m64n256k16 a k-step and
// warpgroup), H = act(G) * U in f32 registers, rounded to bf16 into the
// (M, F) workspace: the gate and up products are done once per row.
// Pass 2: y = H Wd, f32 over all of F, rounded once.  Why H leaves the
// chip here: fused, a block that owns an output tile must hold (or
// recompute) H for all of F; at D 256 that is one 256-column tile and
// H's 64 x 32 pieces live in registers, but at D > 512 the output has
// D/256 tiles and either each recomputes [G | U] (the old tiles route:
// D/256 times the gate and up products) or one block holds the tile's
// 64 x D f32 output (96 KB of registers at D 6144).  The round trip costs
// 2 M F 2 bytes (268 MB at M 8192, F 8192: ~0.08 ms against the 0.834 ms
// operation bound), and H is rounded to bf16 exactly where the tiles
// route rounds it.
//
// f32 (fused_ffn_kernel), kept from the first version: the tensor cores
// would compute f32 as TF32.  Grid (64-row tile, 256-column output tile,
// F split); phase A computes the (64, 64) hidden tile into shared memory
// with 4x4 register tiles, phase B adds h @ Wd into 4x16 f32 outputs a
// thread.  Small M splits F across blocks into an f32 workspace that a
// second pass adds in a fixed order.
//
// Any M, D and F for f32; D and F multiples of 8 and 16-byte aligned
// rows for bf16 (the wrapper checks).  Ragged tiles are masked (loads of
// 0 give a hidden value act(0) * 0 == 0).
//
// Interface: plain C, bound with ctypes; each entry returns
// cudaGetLastError() of its launches.  It launches on the caller's
// stream and allocates nothing: the wrapper passes the workspaces and
// the arrival counters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
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

// ------------------------------------------------ bf16 tensor-core routes --
// the activation of the bf16 routes: silu through the fast exp (ex2
// based, a few ulp for the |g| < 20 of an FFN's gate) and a fast
// division, gelu as in `activate` (tanhf at full f32 precision); both
// far inside the bf16 rounding of H and of the output
__device__ __forceinline__ float activate_fast(float g, int act) {
  if (act == kSilu) return __fdividef(g, 1.f + __expf(-g));
  return activate(g, act);
}

struct TcArgs {
  const bf16* x;
  const bf16* wg;
  const bf16* wu;
  const bf16* wd;
  bf16* out;
  int m, d, f, act;
};

// ------------------------------------------------- bf16 large M on wgmma
// The operands use hopper.cuh's 128-byte swizzled layout.  x is K-major
// (a row holds 64 k of one row of x); Wg, Wu and Wd stay N-major as they
// lie in device memory (a row holds 64 n of one k; the products read B
// transposed), so each 16-byte cp.async lands one chunk.
namespace wg {
constexpr int kBM = 64;                   // rows a block: one warpgroup
constexpr int kBF = 32;                   // F columns a tile
constexpr int kBD = 256;                  // output columns a block
constexpr int kKD = 256;                  // D rows of a Wg/Wu chunk
constexpr int kThreads = 128;
constexpr int kSlotA = 2 * kKD * kBF;     // [Wg | Wu], in bf16
constexpr int kSlotB = kBF * kBD;         // Wd
constexpr int kSlot = kSlotA > kSlotB ? kSlotA : kSlotB;
__host__ __device__ inline int d_pad(int d) {
  return (d + kKD - 1) / kKD * kKD;
}
__host__ __device__ inline size_t smem_bytes(int d) {
  // + 1024: the atoms need a 1024-byte aligned base
  return sizeof(bf16) * ((size_t)kBM * d_pad(d) + 2 * (size_t)kSlot) + 1024;
}
}  // namespace wg

__global__ void __launch_bounds__(wg::kThreads)
    fused_ffn_wg_kernel(TcArgs a) {
  constexpr int kBM = wg::kBM, kBF = wg::kBF, kBD = wg::kBD, kKD = wg::kKD;
  constexpr int kThreads = wg::kThreads, kSlot = wg::kSlot;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = a.m, D = a.d, F = a.f;
  const int dp = wg::d_pad(D);
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // x, resident: blocks of 64 k, each 64 rows x 128 bytes
  unsigned char* x_s = smem;
  unsigned char* slots = smem + kBM * dp * 2;

  const int m0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_a = dp / kKD;                         // Wg/Wu chunks a tile
  const int n_chunks = (F + kBF - 1) / kBF * (n_a + 1);

  // rows r of x, 16-byte chunks kc: block kc / 8, chunk kc % 8 of row r
  for (int i = tid; i < kBM * (dp / 8); i += kThreads) {
    const int r = i / (dp / 8), kc = i % (dp / 8);
    const int row = m0 + r, col = kc * 8;
    const bool ok = row < M && col < D;
    cp_async16(x_s + (kc >> 3) * (kBM * 128) + swz(r, kc & 7),
               a.x + (ok ? (long long)row * D + col : 0), ok);
  }
  auto issue = [&](int i, int slot) {
    unsigned char* base = slots + slot * kSlot * 2;
    const int ft = i / (n_a + 1), c = i % (n_a + 1);
    const int f0 = ft * kBF;
    if (c < n_a) {
      // [Wg | Wu] as one 64-wide B: row k holds Wg's 32 columns of the
      // tile in chunks 0..3 and Wu's in chunks 4..7
      const int k0 = c * kKD;
      for (int j = tid; j < kKD * (kBF / 8); j += kThreads) {
        const int r = j / (kBF / 8), nc = j % (kBF / 8);
        const int kr = k0 + r, col = f0 + nc * 8;
        const bool ok = kr < D && col < F;
        const long long off = ok ? (long long)kr * F + col : 0;
        cp_async16(base + swz(r, nc), a.wg + off, ok);
        cp_async16(base + swz(r, kBF / 8 + nc), a.wu + off, ok);
      }
    } else {
      // Wd rows f0 + r, columns d0 + 8 nc: 64-column atoms of 32 rows,
      // 4096 bytes apart
      for (int j = tid; j < kBF * (kBD / 8); j += kThreads) {
        const int r = j / (kBD / 8), nc = j % (kBD / 8);
        const int fr = f0 + r, col = d0 + nc * 8;
        const bool ok = fr < F && col < D;
        cp_async16(base + (nc >> 3) * (kBF * 128) + swz(r, nc & 7),
                   a.wd + (ok ? (long long)fr * D + col : 0), ok);
      }
    }
  };

  float o[kBD / 2];                     // 64 x 256 f32 over the warpgroup
  float gu[kBF];                        // [G | U], 64 x 64 f32
#pragma unroll
  for (int i = 0; i < kBD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBF; ++i) gu[i] = 0.f;

  issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < n_chunks; ++i) {
    // chunk i has landed; the products of chunk i - 1 (the last group in
    // flight) are done, so its slot is free for the copy issued below
    cp_async_wait<0>();
    fence_proxy_async();
    wgmma_wait<0>();
    __syncthreads();
    if (i + 1 < n_chunks) issue(i + 1, (i + 1) & 1);
    cp_async_commit();
    const unsigned char* base = slots + (i & 1) * kSlot * 2;
    const int c = i % (n_a + 1);
    if (c < n_a) {
      // ---- [G | U] += x[:, k-chunk] @ [Wg | Wu][k-chunk, f-tile]; a
      // k-step is 32 bytes into x's 128-byte rows and 16 rows of [Wg|Wu]
      fence_regs(gu, kBF);
      wgmma_fence();
#pragma unroll 4
      for (int kk = 0; kk < kKD / 16; ++kk) {
        const int k = c * kKD + 16 * kk;
        wgmma_ss<64, 1>(
            gu, wgmma_desc(x_s + (k >> 6) * (kBM * 128) + (k & 63) * 2, 16,
                           1024),
            wgmma_desc(base + kk * 16 * 128, 16, 1024), 1);
      }
      wgmma_commit();
    } else {
      // ---- H = act(G) * U as bf16 A fragments, O += H @ Wd[f-tile, :]
      fence_regs(gu, kBF);
      uint32_t hf[kBF / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBF / 16; ++kk)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int n = 2 * kk + h2;            // n-block n of G, 4 + n of U
          float hv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hv[e] = activate_fast(gu[4 * n + e], a.act) *
                    gu[kBF / 2 + 4 * n + e];
          hf[kk][2 * h2] = pack_bf16(hv[0], hv[1]);
          hf[kk][2 * h2 + 1] = pack_bf16(hv[2], hv[3]);
        }
#pragma unroll
      for (int i2 = 0; i2 < kBF; ++i2) gu[i2] = 0.f;
      fence_regs(o, kBD / 2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBF / 16; ++kk)
        wgmma_rs<256, 1>(o, hf[kk],
                         wgmma_desc(base + kk * 16 * 128, kBF * 128, 1024), 1);
      wgmma_commit();
    }
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  fence_regs(o, kBD / 2);

  const int row0 = m0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < kBD / 8; ++n) {
    const int col = d0 + 8 * n + 2 * t;
    if (col >= D) continue;
    if (row0 < M)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (long long)row0 * D + col) =
          __floats2bfloat162_rn(o[4 * n], o[4 * n + 1]);
    if (row1 < M)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (long long)row1 * D + col) =
          __floats2bfloat162_rn(o[4 * n + 2], o[4 * n + 3]);
  }
}

namespace sm {
constexpr int kFS = 16;                   // F columns a block
constexpr int kWR = kFS + 8;              // Wg/Wu slice row, in bf16
constexpr int kDC = 64;                   // output columns a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 64;
__host__ __device__ inline int m_pad(int m) {
  return (m + 15) / 16 * 16;
}
__host__ __device__ inline int d_pad(int d) {
  return (d + 15) / 16 * 16;
}
}  // namespace sm

struct SmallArgs {
  const bf16* x;
  const bf16* wg;
  const bf16* wu;
  const bf16* wd;
  bf16* out;
  float* ws;            // nsplit x M x D partial sums
  int* counters;        // one per output chunk, 0 between launches
  int m, d, f, act, nsplit;
};

__global__ void __launch_bounds__(sm::kThreads)
    fused_ffn_small_kernel(SmallArgs a) {
  constexpr int kFS = sm::kFS, kWR = sm::kWR, kDC = sm::kDC;
  constexpr int kThreads = sm::kThreads, kWarps = sm::kWarps;
  constexpr int kMaxM = sm::kMaxM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = a.m, D = a.d, F = a.f;
  // the layout that the wrapper's small_smem_bytes sizes
  const int mp = sm::m_pad(M), dp = sm::d_pad(D), xs = dp + 8;
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);    // mp x xs
  bf16* wg_s = x_s + mp * xs;                        // dp x kWR
  bf16* wu_s = wg_s + dp * kWR;                      // dp x kWR
  bf16* wd_s = wu_s + dp * kWR;                      // kFS x kDC
  float* red_s = reinterpret_cast<float*>(wd_s + kFS * kDC);
  float* h_s = red_s + kWarps * mp * kFS * 2;        // mp x kFS

  const int split = blockIdx.x, f0 = split * kFS;
  const int d0 = blockIdx.y * kDC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;

  for (int i = tid; i < mp * (dp / 8); i += kThreads) {
    const int r = i / (dp / 8), col = (i % (dp / 8)) * 8;
    const bool ok = r < M && col < D;
    cp_async16(x_s + r * xs + col, a.x + (ok ? (long long)r * D + col : 0),
               ok);
  }
  for (int i = tid; i < dp * (kFS / 8); i += kThreads) {
    const int k = i / (kFS / 8), c = (i % (kFS / 8)) * 8;
    const bool ok = k < D && f0 + c < F;
    const long long off = ok ? (long long)k * F + f0 + c : 0;
    cp_async16(wg_s + k * kWR + c, a.wg + off, ok);
    cp_async16(wu_s + k * kWR + c, a.wu + off, ok);
  }
  for (int i = tid; i < kFS * (kDC / 8); i += kThreads) {
    const int r = i / (kDC / 8), c = (i % (kDC / 8)) * 8;
    const bool ok = f0 + r < F && d0 + c < D;
    cp_async16(wd_s + r * kDC + c,
               a.wd + (ok ? (long long)(f0 + r) * D + d0 + c : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- G, U for the slice: warps split D, partials added in warp order
  float gacc[kMaxM / 16][2][4], uacc[kMaxM / 16][2][4];
#pragma unroll
  for (int i = 0; i < kMaxM / 16; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[i][n][e] = uacc[i][n][e] = 0.f;
  for (int kk = warp; kk < dp / 16; kk += kWarps) {
    uint32_t bg[4], bu[4];          // b0, b1 of n-blocks 0 and 1
    const int off = (16 * kk + (mi & 1) * 8 + mr) * kWR + (mi >> 1) * 8;
    ldmatrix_x4_trans(bg, wg_s + off);
    ldmatrix_x4_trans(bu, wu_s + off);
#pragma unroll
    for (int i = 0; i < kMaxM / 16; ++i) {
      if (16 * i < mp) {
        uint32_t af[4];
        ldmatrix_x4(af, x_s + (16 * i + (mi & 1) * 8 + mr) * xs + 16 * kk +
                            (mi >> 1) * 8);
        mma_bf16(gacc[i][0], af, bg[0], bg[1]);
        mma_bf16(gacc[i][1], af, bg[2], bg[3]);
        mma_bf16(uacc[i][0], af, bu[0], bu[1]);
        mma_bf16(uacc[i][1], af, bu[2], bu[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxM / 16; ++i) {
    if (16 * i < mp) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + (e < 2 ? 0 : 8);
          const int col = 8 * n + 2 * t + (e & 1);
          float* r = red_s + ((warp * mp + row) * kFS + col) * 2;
          r[0] = gacc[i][n][e];
          r[1] = uacc[i][n][e];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < mp * kFS; i += kThreads) {
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      gs += red_s[(w * mp * kFS + i) * 2];
      us += red_s[(w * mp * kFS + i) * 2 + 1];
    }
    h_s[i] = activate_fast(gs, a.act) * us;
  }
  __syncthreads();

  // ---- this slice's f32 share of the output chunk, to the workspace
  for (int i = tid; i < M * kDC; i += kThreads) {
    const int row = i / kDC, c = i % kDC;
    if (d0 + c >= D) continue;
    float acc = 0.f;
#pragma unroll
    for (int ff = 0; ff < kFS; ++ff)
      acc = fmaf(h_s[row * kFS + ff], __bfloat162float(wd_s[ff * kDC + c]),
                 acc);
    a.ws[((long long)split * M + row) * D + d0 + c] = acc;
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(a.counters + blockIdx.y, 1) == a.nsplit - 1;
  __syncthreads();
  if (!last) return;
  // ---- the last block of this chunk adds the splits in order, with 16
  // splits' loads in flight at a time
  __threadfence();
  const long long step = (long long)M * D;
  for (int i = tid; i < M * kDC; i += kThreads) {
    const int row = i / kDC, c = i % kDC;
    if (d0 + c >= D) continue;
    const float* p = a.ws + (long long)row * D + d0 + c;
    float acc = 0.f;
    int sp = 0;
    for (; sp + 16 <= a.nsplit; sp += 16) {
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = __ldcg(p + (sp + r) * step);
#pragma unroll
      for (int r = 0; r < 16; ++r) acc += v[r];
    }
    for (; sp < a.nsplit; ++sp) acc += __ldcg(p + sp * step);
    a.out[(long long)row * D + d0 + c] = __float2bfloat16(acc);
  }
  if (tid == 0) a.counters[blockIdx.y] = 0;          // ready for the next
}

// ------------------------------------ bf16 small M at any D: split F only
namespace sf {
constexpr int kFS = 64;                   // F columns a block
constexpr int kKC = 64;                   // D rows of a Wg/Wu/x chunk
constexpr int kDC = 128;                  // output columns of a Wd chunk
constexpr int kStages = 4;                // ring slots
constexpr int kThreads = 256;
constexpr int kMaxM = 64;
constexpr int kWR = kFS + 8;              // Wg/Wu and H rows, in bf16
constexpr int kXR = kKC + 8;              // x rows
constexpr int kDR = kDC + 8;              // Wd rows
constexpr int kInFlight = 8;              // float4 loads a thread, merge
__device__ inline int m_pad(int m) {
  return (m + 15) / 16 * 16;
}
// a ring slot holds [Wg; Wu] (2 kKC rows) and x (mp rows), or Wd
__device__ inline int slot_elems(int mp) {
  const int a = 2 * kKC * kWR + mp * kXR, b = kFS * kDR;
  return a > b ? a : b;
}
}  // namespace sf

__global__ void __launch_bounds__(sf::kThreads, 2)
    fused_ffn_split_kernel(SmallArgs a) {
  constexpr int kFS = sf::kFS, kKC = sf::kKC, kDC = sf::kDC;
  constexpr int kStages = sf::kStages, kThreads = sf::kThreads;
  constexpr int kMT = sf::kMaxM / 16;
  constexpr int kWR = sf::kWR, kXR = sf::kXR, kDR = sf::kDR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = a.m, D = a.d, F = a.f;
  // the layout that the wrapper's split_smem_bytes sizes
  const int mp = sf::m_pad(M), slot = sf::slot_elems(mp);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* h_hi = ring + kStages * slot;                 // mp x kWR
  bf16* h_lo = h_hi + mp * kWR;                       // mp x kWR

  const int split = blockIdx.x, f0 = split * kFS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int n_k = (D + kKC - 1) / kKC, n_c = (D + kDC - 1) / kDC;
  const int n = n_k + n_c;
  auto chunk_of = [&](int j) { return (j + split) % n_c; };

  // chunk i of the sequence: D chunks of [Wg; Wu] and x, then this
  // block's Wd rows in column chunks, starting at its own
  auto issue = [&](int i) {
    bf16* s = ring + (i % kStages) * slot;
    if (i < n_k) {
      const int k0 = i * kKC;
      for (int j = tid; j < kKC * (kFS / 8); j += kThreads) {
        const int r = j / (kFS / 8), c = (j % (kFS / 8)) * 8;
        const bool ok = k0 + r < D && f0 + c < F;
        const long long off = ok ? (long long)(k0 + r) * F + f0 + c : 0;
        cp_async16(s + r * kWR + c, a.wg + off, ok);
        cp_async16(s + (kKC + r) * kWR + c, a.wu + off, ok);
      }
      bf16* xs = s + 2 * kKC * kWR;
      for (int j = tid; j < mp * (kKC / 8); j += kThreads) {
        const int r = j / (kKC / 8), c = (j % (kKC / 8)) * 8;
        const bool ok = r < M && k0 + c < D;
        cp_async16(xs + r * kXR + c,
                   a.x + (ok ? (long long)r * D + k0 + c : 0), ok);
      }
    } else {
      const int d0 = chunk_of(i - n_k) * kDC;
      for (int j = tid; j < kFS * (kDC / 8); j += kThreads) {
        const int r = j / (kDC / 8), c = (j % (kDC / 8)) * 8;
        const bool ok = f0 + r < F && d0 + c < D;
        cp_async16(s + r * kDR + c,
                   a.wd + (ok ? (long long)(f0 + r) * D + d0 + c : 0), ok);
      }
    }
  };
  // waits for chunk i and frees the slot of chunk i - 1 for chunk i + 3
  auto advance = [&](int i) -> const bf16* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n) issue(i + kStages - 1);
    cp_async_commit();
    return ring + (i % kStages) * slot;
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }

  // ---- G, U over all of D: warp w owns columns 8w..8w+7 of both
  {
    float gacc[kMT][4], uacc[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[i][e] = uacc[i][e] = 0.f;
    for (int i = 0; i < n_k; ++i) {
      const bf16* s = advance(i);
      const bf16* xs = s + 2 * kKC * kWR;
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        // the four matrices: Wg k 0-7, Wg k 8-15, Wu k 0-7, Wu k 8-15
        uint32_t b[4];
        ldmatrix_x4_trans(b, s + ((mi >> 1) * kKC + 16 * kk + (mi & 1) * 8 +
                                  mr) * kWR + 8 * warp);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (16 * mt < mp) {
            uint32_t af[4];
            ldmatrix_x4(af, xs + (16 * mt + (mi & 1) * 8 + mr) * kXR +
                                16 * kk + (mi >> 1) * 8);
            mma_bf16(gacc[mt], af, b[0], b[1]);
            mma_bf16(uacc[mt], af, b[2], b[3]);
          }
        }
      }
    }
    // H = act(G) U in f32, kept as bf16 hi + lo for the Wd product
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (16 * mt < mp) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float h0 = activate_fast(gacc[mt][2 * hf], a.act) *
                           uacc[mt][2 * hf];
          const float h1 = activate_fast(gacc[mt][2 * hf + 1], a.act) *
                           uacc[mt][2 * hf + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(h0 - __low2float(hi),
                                    h1 - __high2float(hi));
          const int off = (16 * mt + g + 8 * hf) * kWR + 8 * warp + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(h_hi + off) = hi;
          *reinterpret_cast<__nv_bfloat162*>(h_lo + off) = lo;
        }
      }
    }
  }

  // ---- this slice's f32 partial of every output chunk: warp w owns
  // columns 16w..16w+15 of a chunk
  __shared__ int last;
  const long long step = (long long)M * D;
  for (int j = 0; j < n_c; ++j) {
    const bf16* s = advance(n_k + j);       // its barrier orders H too
    const int c = chunk_of(j), d0 = c * kDC;
    float acc[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kFS / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, s + (16 * kk + (mi & 1) * 8 + mr) * kDR +
                               16 * warp + (mi >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (16 * mt < mp) {
          const int off = (16 * mt + (mi & 1) * 8 + mr) * kWR + 16 * kk +
                          (mi >> 1) * 8;
          uint32_t ah[4], al[4];
          ldmatrix_x4(ah, h_hi + off);
          ldmatrix_x4(al, h_lo + off);
          mma_bf16(acc[mt][0], ah, b[0], b[1]);
          mma_bf16(acc[mt][0], al, b[0], b[1]);
          mma_bf16(acc[mt][1], ah, b[2], b[3]);
          mma_bf16(acc[mt][1], al, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (16 * mt < mp) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = 16 * mt + g + 8 * hf;
            const int col = d0 + 16 * warp + 8 * nb + 2 * t;
            if (row < M && col < D)
              *reinterpret_cast<float2*>(a.ws + split * step +
                                         (long long)row * D + col) =
                  make_float2(acc[mt][nb][2 * hf], acc[mt][nb][2 * hf + 1]);
          }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.counters + c, 1) == a.nsplit - 1;
    __syncthreads();
    if (!last) continue;
    // ---- the last block at chunk c adds the splits in order
    __threadfence();
    for (int q = tid; q < M * (kDC / 4); q += kThreads) {
      const int row = q / (kDC / 4), col = d0 + (q % (kDC / 4)) * 4;
      if (col >= D) continue;
      const float* p = a.ws + (long long)row * D + col;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      int sp = 0;
      for (; sp + sf::kInFlight <= a.nsplit; sp += sf::kInFlight) {
        float4 v[sf::kInFlight];
#pragma unroll
        for (int r = 0; r < sf::kInFlight; ++r)
          v[r] = __ldcg(reinterpret_cast<const float4*>(p + (sp + r) * step));
#pragma unroll
        for (int r = 0; r < sf::kInFlight; ++r) {
          sum.x += v[r].x;
          sum.y += v[r].y;
          sum.z += v[r].z;
          sum.w += v[r].w;
        }
      }
      for (; sp < a.nsplit; ++sp) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(p + sp * step));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *reinterpret_cast<uint2*>(a.out + (long long)row * D + col) =
          make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    }
    if (tid == 0) a.counters[c] = 0;          // ready for the next launch
  }
  cp_async_wait<0>();
}

// ---------------------------------- bf16 larger M at D > 512: two passes
namespace tp {
constexpr int kBN = 256;                  // N columns a block
constexpr int kKC = 64;                   // K a chunk: one 128-byte row
constexpr int kStages = 4;                // ring slots, 2 chunks ahead
constexpr int kGroupM = 8;                // row tiles a raster group
// the wrapper's pass_smem_bytes: kStages of these + 1024 to align atoms
__host__ __device__ constexpr int stage_bytes(int bm) {
  return bm * 128 + kKC * kBN * 2;
}
}  // namespace tp

struct PassArgs {
  const bf16* a;        // (M, K) row-major: x in pass 1, H in pass 2
  const bf16* b0;       // (K, N) row-major: Wg in pass 1, Wd in pass 2
  const bf16* b1;       // Wu in pass 1
  bf16* c;              // (M, N): H in pass 1, the output in pass 2
  int m, k, n, act, col_tiles;
};

// GATED (pass 1): the block's B is [Wg | Wu] over kBN / 2 F columns and
// its epilogue writes H = act(G) * U; else (pass 2) B is kBN columns of
// Wd and the epilogue writes the f32 sums rounded once.  A is K-major
// and B N-major in shared memory, both 128-byte swizzled as in wg.
template <int WGS, bool GATED>
__global__ void __launch_bounds__(128 * WGS)
    fused_ffn_pass_kernel(PassArgs a) {
  constexpr int kBM = 64 * WGS, kThreads = 128 * WGS;
  constexpr int kBN = tp::kBN, kKC = tp::kKC, kStages = tp::kStages;
  constexpr int kStage = tp::stage_bytes(kBM);
  constexpr int kCols = GATED ? kBN / 2 : kBN;     // of c a block writes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  // grouped raster: kGroupM row tiles walk the column tiles together
  const int row_tiles = (a.m + kBM - 1) / kBM;
  const int per_group = tp::kGroupM * a.col_tiles;
  const int first = blockIdx.x / per_group * tp::kGroupM;
  const int rows_in = min(row_tiles - first, tp::kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows_in) * kBM;
  const int n0 = in_group / rows_in * kCols;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_k = (a.k + kKC - 1) / kKC;

  auto issue = [&](int i) {
    unsigned char* s = smem + (i % kStages) * kStage;
    const int k0 = i * kKC;
    for (int j = tid; j < kBM * 8; j += kThreads) {
      const int r = j >> 3, c = j & 7;
      const int row = m0 + r, col = k0 + c * 8;
      const bool ok = row < a.m && col < a.k;
      cp_async16(s + swz(r, c), a.a + (ok ? (long long)row * a.k + col : 0),
                 ok);
    }
    // B: 64-column groups of kKC rows, 8 KB apart; pass 1 takes pieces
    // 0..15 of a row from Wg and 16..31 from Wu, at the same F columns
    unsigned char* sb = s + kBM * 128;
    for (int j = tid; j < kKC * (kBN / 8); j += kThreads) {
      const int r = j / (kBN / 8), nc = j % (kBN / 8);
      const int col = n0 + 8 * (GATED ? nc % (kBN / 16) : nc);
      const bf16* src = GATED && nc >= kBN / 16 ? a.b1 : a.b0;
      const bool ok = k0 + r < a.k && col < a.n;
      cp_async16(sb + (nc >> 3) * (kKC * 128) + swz(r, nc & 7),
                 src + (ok ? (long long)(k0 + r) * a.n + col : 0), ok);
    }
  };

  float acc[kBN / 2];                   // 64 x 256 f32 over a warpgroup
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < kStages - 2; ++i) {
    if (i < n_k) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    // chunk i has landed; every warpgroup's products of chunk i - 2 are
    // done (those of i - 1 may run on), so its slot takes chunk i + 2
    cp_async_wait<kStages - 3>();
    fence_proxy_async();
    wgmma_wait<1>();
    __syncthreads();
    if (i + kStages - 2 < n_k) issue(i + kStages - 2);
    cp_async_commit();
    const unsigned char* s = smem + (i % kStages) * kStage;
    const unsigned char* sa = s + wgi * (64 * 128);
    const unsigned char* sb = s + kBM * 128;
    fence_regs(acc, kBN / 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk)
      wgmma_ss<256, 1>(acc, wgmma_desc(sa + kk * 32, 16, 1024),
                       wgmma_desc(sb + kk * 16 * 128, kKC * 128, 1024), 1);
    wgmma_commit();
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  fence_regs(acc, kBN / 2);

  const int row0 = m0 + wgi * 64 + warp * 16 + g, row1 = row0 + 8;
  if (GATED) {
    // n-block j of G and n-block j + 16 of U hold the same F columns
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= a.n) continue;
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = activate_fast(acc[4 * j + e], a.act) *
               acc[4 * (j + kBN / 16) + e];
      if (row0 < a.m)
        *reinterpret_cast<__nv_bfloat162*>(a.c + (long long)row0 * a.n +
                                           col) =
            __floats2bfloat162_rn(h[0], h[1]);
      if (row1 < a.m)
        *reinterpret_cast<__nv_bfloat162*>(a.c + (long long)row1 * a.n +
                                           col) =
            __floats2bfloat162_rn(h[2], h[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= a.n) continue;
      if (row0 < a.m)
        *reinterpret_cast<__nv_bfloat162*>(a.c + (long long)row0 * a.n +
                                           col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (row1 < a.m)
        *reinterpret_cast<__nv_bfloat162*>(a.c + (long long)row1 * a.n +
                                           col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <int WGS>
cudaError_t two_pass(const PassArgs& p1, const PassArgs& p2, int row_tiles,
                     int smem_bytes, cudaStream_t stream) {
  auto k1 = fused_ffn_pass_kernel<WGS, true>;
  auto k2 = fused_ffn_pass_kernel<WGS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k2, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  k1<<<row_tiles * p1.col_tiles, 128 * WGS, smem_bytes, stream>>>(p1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<row_tiles * p2.col_tiles, 128 * WGS, smem_bytes, stream>>>(p2);
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
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 entries launch the grid of the wrapper's plan (ffn_plan in
// kernels/fused_ffn.py) as given.
extern "C" int fused_ffn_bf16_tiles(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    void* out, int m, int d, int f, int act,
                                    int row_tiles, int col_tiles,
                                    void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  TcArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
           static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
           static_cast<bf16*>(out), m, d, f, act};
  const size_t bytes = wg::smem_bytes(d);
  auto kernel = fused_ffn_wg_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(row_tiles, col_tiles);
  kernel<<<grid, wg::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int fused_ffn_bf16_small(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    void* out, void* ws, void* counters,
                                    int m, int d, int f, int act, int nsplit,
                                    int nchunks, int smem_bytes,
                                    void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  SmallArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
              static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
              static_cast<bf16*>(out), static_cast<float*>(ws),
              static_cast<int*>(counters), m, d, f, act, nsplit};
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  fused_ffn_small_kernel<<<dim3(nsplit, nchunks), sm::kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int fused_ffn_bf16_split(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    void* out, void* ws, void* counters,
                                    int m, int d, int f, int act, int nsplit,
                                    int smem_bytes, void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  SmallArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
              static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
              static_cast<bf16*>(out), static_cast<float*>(ws),
              static_cast<int*>(counters), m, d, f, act, nsplit};
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  fused_ffn_split_kernel<<<nsplit, sf::kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// h: the (M, F) bf16 workspace between the passes; block_m 64 or 128
extern "C" int fused_ffn_bf16_two_pass(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       void* out, void* h, int m, int d,
                                       int f, int act, int block_m,
                                       int row_tiles, int f_tiles,
                                       int d_tiles, int smem_bytes,
                                       void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  const PassArgs p1{static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                    static_cast<const bf16*>(wu), static_cast<bf16*>(h),
                    m, d, f, act, f_tiles};
  const PassArgs p2{static_cast<const bf16*>(h), static_cast<const bf16*>(wd),
                    nullptr, static_cast<bf16*>(out), m, f, d, act, d_tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_m) {
    case 64: return two_pass<1>(p1, p2, row_tiles, smem_bytes, s);
    case 128: return two_pass<2>(p1, p2, row_tiles, smem_bytes, s);
    default: return cudaErrorInvalidValue;
  }
}
