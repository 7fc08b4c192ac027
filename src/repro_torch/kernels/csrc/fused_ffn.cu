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
// bf16, D > 512, small M ("stream", fused_ffn_stream_gate_kernel and
// fused_ffn_stream_down_kernel: M <= 24 where small_m does not fit).
// Bound by the weight bytes, 3 D F 2: 881 MB at yi-34b (D 7168, F 20480:
// 0.263 ms), 604 MB at internvl2-26b (0.180 ms), 101 MB at D 2048, F
// 8192 (0.030 ms).  Two persistent launches of at most one block an SM,
// each block a producer warp whose one thread streams the weights by TMA
// through a four-slot ring (a full and an empty mbarrier a slot; no
// consumer thread issues a copy or waits at a block-wide barrier a
// chunk) and a consumer warpgroup on wgmma with the weight tile as the
// 64-row operand (A, MN-major: the row-major weight read transposed) and
// x or H on the N side (N = 8, 16, 24 for M <= 24), so no tensor work is
// spent on padding rows:
// - pass 1, H = act(x Wg) (x Wu) once per row: units of 64 F columns
//   over all of D, a ring slot Wg's and Wu's 64-row tiles (128-byte rows)
//   and x's 64 columns, two products a k-step (G and U), so a thread
//   holds G and U of the same element and forms H in registers.  The
//   first (units / blocks) blocks' worth run whole, unit u on block u mod
//   blocks (neighbouring SMs stream neighbouring 128-byte pieces of the
//   same rows), and the (unit, D chunk) steps of the rest are cut into
//   one even run a block, a unit split between blocks summed from its f32
//   partials in block order before the activation.  H is formed in f32
//   and written as bf16 hi + lo rows of a (2 MP, F) workspace (655 KB at
//   yi-34b, held in L2), keeping H to ~2^-17 relative;
// - pass 2, y = H Wd: the (64-column output tile, 128-row F chunk) steps
//   are cut into one even run a block (stream-K); B = [H_hi; H_lo]^T (N
//   = 2 MP), so one product a k-step takes both parts.  A tile one block
//   runs whole is rounded and written by it; a tile split between blocks
//   (at most two a block) is summed from its f32 partials in block order
//   by the last to arrive (__threadfence, a counter it resets) and
//   rounded once.  Wd is read once, H from L2.
// It replaced split_f (one mma.sync launch of ceil(F / 64) blocks, each
// a 64-column F slice through a cp.async ring, 38-54 % of this bound)
// and answers its three losses: every SM streams the same weight bytes
// to a ring chunk (split_f: 320 blocks on 264 slots at yi-34b, a second
// wave of 56; 128 at phi3-mini, half the slots empty); the workspace is
// two slots of 64 x MP f32 partials a block (1 MB at M 8), not one (M,
// D) partial an F slice (M / 48 of the weight bytes more traffic, 147 MB
// at yi-34b, merged by one block a chunk); and the loads are TMA boxes
// issued by one thread, so the consumers spend no registers, address
// arithmetic or block barriers on them.
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

// ------------------------- bf16 small M at D > 512: TMA weight streaming
// Two launches, each persistent (at most one block an SM), each block a
// consumer warpgroup (warps 0-3) and a producer warp (warp 4) whose one
// thread keeps TMA loads in flight into a ring of kStages slots, with a
// full and an empty mbarrier a slot.  The products put the weight tile on
// wgmma's 64-row side (A, MN-major: the row-major weight read transposed)
// and the few rows of activations on its N side (B, K-major), so no
// tensor work is spent on padding rows beyond N = 8, 16 or 24.
namespace st {
constexpr int kUnitF = 64;        // F columns of a pass-1 unit
constexpr int kKC = 64;           // D rows of a pass-1 ring slot
constexpr int kTileD = 64;        // output columns of a pass-2 tile
constexpr int kFC = 128;          // F rows of a pass-2 ring slot
constexpr int kStages = 4;        // ring slots
constexpr int kThreads = 160;     // a consumer warpgroup + a producer warp
// a pass-1 slot: Wg's and Wu's kKC x 64 tiles (128-byte rows), then x's
// kKC / 64 blocks of MP rows x 128 bytes
__host__ __device__ constexpr int stage1_bytes(int mp) {
  return 2 * kKC * kUnitF * 2 + (kKC / 64) * mp * 128;
}
// a pass-2 slot: Wd's kFC x 64 tile (128-byte rows), then H's kFC / 64
// blocks of 2 MP rows (hi, then lo) x 128 bytes
__host__ __device__ constexpr int stage2_bytes(int mp) {
  return kFC * kTileD * 2 + (kFC / 64) * 2 * mp * 128;
}
// + 1024 to align the swizzle atoms, 16 bytes of barriers a slot
__host__ __device__ constexpr int smem1_bytes(int mp) {
  return 1024 + kStages * (stage1_bytes(mp) + 16);
}
__host__ __device__ constexpr int smem2_bytes(int mp) {
  return 1024 + kStages * (stage2_bytes(mp) + 16);
}
}  // namespace st

struct StreamArgs {
  bf16* h;             // (2 MP, F): H's bf16 hi rows, then its lo rows
  bf16* out;           // (M, D)
  float* ws;           // two slots of f32 partials a block
  int* counters;       // one a split item, 0 between launches
  int m, d, f, act;
  int units;           // pass 1: ceil(F / 64)
  int chunks;          // pass 2: F chunks a tile, ceil(F / kFC)
  long long steps;     // pass 2: tiles x chunks
};

// the first step of block b's run when `total` steps are cut into one
// even run a block
__device__ __forceinline__ long long run_begin(long long b, long long total) {
  return b * total / gridDim.x;
}
// the block whose run holds `step`: the largest b with run_begin(b) <=
// step (a block whose run is empty never holds one)
__device__ __forceinline__ int run_block(long long step, long long total) {
  return (int)(((step + 1) * gridDim.x - 1) / total);
}

// The fixup of an item (a pass-1 unit or a pass-2 tile: steps [item
// chunks, (item + 1) chunks) of the `total` cut into runs) that more than
// one block ran part of: this block's f32 share v (NT tiles of 64 x MP,
// MP / 2 values a thread and tile: rows 16 warp + g and + 8, columns
// 8 j + 2 t and + 1) goes to its workspace slot (0 for the block's first
// item, 1 for its last); the last contributor to arrive gets the item's
// sum in block order in v, resets the item's counter and returns true.
// No float atomics: the sum repeats bit for bit.
template <int MP, int NT>
__device__ __forceinline__ bool stream_fixup(float* v, float* ws,
                                             int* counter, long long item,
                                             long long chunks,
                                             long long total, int* last) {
  constexpr int kTile = 64 * MP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  auto slot = [&](int b) -> float* {
    const int s = run_begin(b, total) / chunks == item ? 0 : 1;
    return ws + ((long long)b * 2 + s) * (NT * kTile);
  };
  auto at = [&](int k, int j, int e) {
    return k * kTile + (16 * warp + g + 8 * (e >> 1)) * MP + 8 * j + 2 * t +
           (e & 1);
  };
  float* mine = slot(blockIdx.x);
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[at(k, j, e)] = v[k * (MP / 2) + 4 * j + e];
  __threadfence();
  named_bar_sync(1, 128);
  const int b_lo = run_block(item * chunks, total);
  const int b_hi = run_block((item + 1) * chunks - 1, total);
  if (tid == 0) {
    int n = 0;
    for (int b = b_lo; b <= b_hi; ++b)
      n += run_begin(b, total) < run_begin(b + 1, total);
    *last = atomicAdd(counter, 1) == n - 1;
  }
  named_bar_sync(1, 128);
  if (!*last) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < NT * (MP / 2); ++i) v[i] = 0.f;
  for (int b = b_lo; b <= b_hi; ++b) {
    if (run_begin(b, total) == run_begin(b + 1, total)) continue;
    const float* p = slot(b);
#pragma unroll
    for (int k = 0; k < NT; ++k)
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[k * (MP / 2) + 4 * j + e] += __ldcg(p + at(k, j, e));
  }
  if (tid == 0) *counter = 0;                // ready for the next launch
  return true;
}

// the slot's release by one consumer warp, once its products are done
__device__ __forceinline__ void release_slot(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// Pass 1: H = act(x Wg) * (x Wu) in units of 64 F columns over all of D.
// The first (units / blocks) * blocks units run whole, unit u on block u
// mod blocks (neighbouring blocks stream neighbouring 128-byte pieces of
// the same weight rows); the (unit, D chunk) steps of the rest are cut
// into one even run a block, a unit split between blocks summed by
// stream_fixup before its activation, so every block streams the same
// weight bytes to a chunk.  A k-step is two products: G^T += Wg^T x^T and
// U^T += Wu^T x^T (A: Wg's or Wu's 64 x kKC tile, 128-byte swizzled,
// MN-major; B: x^T), so a thread holds G and U of the same (column, row)
// and forms H in registers.
template <int MP>
__global__ void __launch_bounds__(st::kThreads, 1)
    fused_ffn_stream_gate_kernel(const __grid_constant__ CUtensorMap tm_x,
                                 const __grid_constant__ CUtensorMap tm_wg,
                                 const __grid_constant__ CUtensorMap tm_wu,
                                 StreamArgs a) {
  constexpr int kS = st::kStages, kKC = st::kKC, kUF = st::kUnitF;
  constexpr int kStage = st::stage1_bytes(MP);
  constexpr int kTile = kKC * kUF * 2;           // one of Wg's, Wu's tiles
  constexpr int kV = MP / 2;                     // values a tile and thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * kStage);
  uint64_t* empty = full + kS;
  __shared__ int last;
  const int tid = threadIdx.x;
  const int nk = (a.d + kKC - 1) / kKC;
  const int rounds = a.units / gridDim.x;        // whole units a block
  const int tail0 = rounds * gridDim.x;          // the first split unit
  const long long tail = (long long)(a.units - tail0) * nk;
  const long long t_begin = run_begin(blockIdx.x, tail);
  const long long t_end = run_begin(blockIdx.x + 1, tail);
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);             // one arrival a consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer: one thread issues every load.  A fresh barrier's
    // previous phase counts as complete, so each first wait passes.
    if (tid == 128) {
      tma_prefetch(&tm_x);
      tma_prefetch(&tm_wg);
      tma_prefetch(&tm_wu);
      int i = 0;
      auto load = [&](int u, int c) {
        const int s = i % kS;
        mbar_wait(&empty[s], ((i / kS) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        unsigned char* sp = smem + s * kStage;
        tma_load_2d(sp, &tm_wg, &full[s], u * kUF, c * kKC);
        tma_load_2d(sp + kTile, &tm_wu, &full[s], u * kUF, c * kKC);
#pragma unroll
        for (int cb = 0; cb < kKC / 64; ++cb)
          tma_load_2d(sp + 2 * kTile + cb * (MP * 128), &tm_x, &full[s],
                      c * kKC + 64 * cb, 0);
        ++i;
      };
      for (int r = 0; r < rounds; ++r)
        for (int c = 0; c < nk; ++c) load(blockIdx.x + r * gridDim.x, c);
      for (long long q = t_begin; q < t_end; ++q)
        load(tail0 + (int)(q / nk), (int)(q % nk));
    }
    return;
  }

  // ---- consumers: G^T and U^T (64 x MP each) of each unit or part of
  // one, in acc[0, kV) and acc[kV, 2 kV)
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int i = 0;
  float acc[2 * kV];
  // acc over D chunks [c0, c1)
  auto run = [&](int c0, int c1) {
#pragma unroll
    for (int j = 0; j < 2 * kV; ++j) acc[j] = 0.f;
    for (int c = c0; c < c1; ++c, ++i) {
      const int s = i % kS;
      mbar_wait(&full[s], (i / kS) & 1);
      const unsigned char* sp = smem + s * kStage;
      // A: kKC rows of 64 F columns, MN-major; a k-step is 16 rows of
      // 128 bytes.  B: x's rows K-major, 128-byte rows of 64 k; a k-step
      // is 32 bytes.
      const uint64_t dg = wgmma_desc(sp, 16, 1024);
      const uint64_t du = wgmma_desc(sp + kTile, 16, 1024);
      const uint64_t db = wgmma_desc(sp + 2 * kTile, 16, 1024);
      fence_regs(acc, 2 * kV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        const uint64_t bk =
            db + (((kk >> 2) * (MP * 128) + (kk & 3) * 32) >> 4);
        wgmma_mn<MP>(acc, dg + ((kk * 16 * 128) >> 4), bk, 1);
        wgmma_mn<MP>(acc + kV, du + ((kk * 16 * 128) >> 4), bk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc, 2 * kV);
      release_slot(&empty[s], lane);
    }
  };
  // H = act(G) U of unit u: A row r = 16 warp + g (+ 8) is F column
  // u * 64 + r; n-block j of each holds x rows 8 j + 2 t and + 1
  auto gate_out = [&](int u) {
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = u * kUF + 16 * warp + g + 8 * (e >> 1);
        const int n = 8 * j + 2 * t + (e & 1);
        const float hv = activate_fast(acc[4 * j + e], a.act) *
                         acc[kV + 4 * j + e];
        const bf16 hi = __float2bfloat16(hv);
        if (col < a.f) {
          a.h[(long long)n * a.f + col] = hi;
          a.h[(long long)(MP + n) * a.f + col] =
              __float2bfloat16(hv - __bfloat162float(hi));
        }
      }
  };
  for (int r = 0; r < rounds; ++r) {
    run(0, nk);
    gate_out(blockIdx.x + r * gridDim.x);
  }
  for (long long q = t_begin; q < t_end;) {
    const long long item = q / nk, u0 = item * nk;
    const long long q_end = t_end < u0 + nk ? t_end : u0 + nk;
    run((int)(q - u0), (int)(q_end - u0));
    const bool whole = q == u0 && q_end == u0 + nk;
    q = q_end;
    if (!whole && !stream_fixup<MP, 2>(acc, a.ws, a.counters + item, item,
                                       nk, tail, &last))
      continue;
    gate_out(tail0 + (int)item);
  }
}

// Pass 2: y = H Wd, stream-K: the (64-column output tile, F chunk) steps,
// tile-major, cut into one even run a block.  A = Wd^T (64 x kFC,
// 128-byte swizzled), B = [H_hi; H_lo]^T (N = 2 MP), so the accumulator's
// first MP columns hold H's hi part's products and the next MP its lo
// part's, added in the epilogue.  A tile one block runs whole is rounded
// and written by it; a tile split between blocks is summed by
// stream_fixup and rounded once.
template <int MP>
__global__ void __launch_bounds__(st::kThreads, 1)
    fused_ffn_stream_down_kernel(const __grid_constant__ CUtensorMap tm_wd,
                                 const __grid_constant__ CUtensorMap tm_h,
                                 StreamArgs a) {
  constexpr int kS = st::kStages, kFC = st::kFC, kN = 2 * MP;
  constexpr int kStage = st::stage2_bytes(MP);
  constexpr int kTile = kFC * st::kTileD * 2;    // Wd's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * kStage);
  uint64_t* empty = full + kS;
  __shared__ int last;
  const int tid = threadIdx.x;
  const long long s_begin = run_begin(blockIdx.x, a.steps);
  const long long s_end = run_begin(blockIdx.x + 1, a.steps);
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {
    if (tid == 128) {
      tma_prefetch(&tm_wd);
      tma_prefetch(&tm_h);
      int i = 0;
      for (long long q = s_begin; q < s_end; ++q, ++i) {
        const int tile = (int)(q / a.chunks), c = (int)(q % a.chunks);
        const int s = i % kS;
        mbar_wait(&empty[s], ((i / kS) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        unsigned char* sp = smem + s * kStage;
        tma_load_2d(sp, &tm_wd, &full[s], tile * st::kTileD, c * kFC);
#pragma unroll
        for (int cb = 0; cb < kFC / 64; ++cb)
          tma_load_2d(sp + kTile + cb * (kN * 128), &tm_h, &full[s],
                      c * kFC + 64 * cb, 0);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int i = 0;
  for (long long q = s_begin; q < s_end;) {
    const long long tile = q / a.chunks, t0 = tile * a.chunks;
    const long long q_end = s_end < t0 + a.chunks ? s_end : t0 + a.chunks;
    const bool whole = q == t0 && q_end == t0 + a.chunks;
    float acc[kN / 2];
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) acc[j] = 0.f;
    for (; q < q_end; ++q, ++i) {
      const int s = i % kS;
      mbar_wait(&full[s], (i / kS) & 1);
      const unsigned char* sp = smem + s * kStage;
      // A: Wd's kFC rows of 64 output columns, MN-major; a k-step is 16
      // rows of 128 bytes.  B: H's 2 MP rows K-major.
      const uint64_t da = wgmma_desc(sp, 16, 1024);
      const uint64_t db = wgmma_desc(sp + kTile, 16, 1024);
      fence_regs(acc, kN / 2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFC / 16; ++kk)
        wgmma_mn<kN>(acc, da + ((kk * 16 * 128) >> 4),
                     db + (((kk >> 2) * (kN * 128) + (kk & 3) * 32) >> 4), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc, kN / 2);
      release_slot(&empty[s], lane);
    }
    // y^T rows d0 + 16 warp + g (+ 8), x rows 8 j + 2 t (+ 1): hi + lo
    float y[MP / 2];
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[4 * j + e] = acc[4 * j + e] + acc[4 * (j + MP / 8) + e];
    if (!whole && !stream_fixup<MP, 1>(y, a.ws, a.counters + tile, tile,
                                       a.chunks, a.steps, &last))
      continue;
    const int d0 = (int)tile * st::kTileD;
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 16 * warp + g + 8 * (e >> 1);
        const int n = 8 * j + 2 * t + (e & 1);
        if (d < a.d && n < a.m)
          a.out[(long long)n * a.d + d] = __float2bfloat16(y[4 * j + e]);
      }
  }
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

// One 2-d map of a bf16 row-major matrix from the wrapper's numbers
// (ffn_tma_map in kernels/fused_ffn.py): the dims (columns, rows), the
// row stride in bytes, the box (columns, rows) and the swizzle span in
// bytes (128: the box's row, also the L2 fetch size); out-of-bounds boxes
// filled with zeros.
bool encode_map_2d(CUtensorMap* map, const void* base, const long long* p) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || p[5] != 128 || p[3] * 2 != 128) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)p[0], (cuuint64_t)p[1]};
  const cuuint64_t strides[1] = {(cuuint64_t)p[2]};
  const cuuint32_t box[2] = {(cuuint32_t)p[3], (cuuint32_t)p[4]};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the dynamic shared memory attribute of a kernel, set once a device
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (*set & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *set |= bit;
  return err;
}

// plan: rows (MP), unit columns, pass-1 chunk, tile columns, pass-2
// chunk, stages, pass-1 blocks, pass-2 blocks, pass-1 and pass-2 shared
// memory (stream_plan); maps: x, Wg, Wu, Wd, H, 6 numbers each
template <int MP>
cudaError_t launch_stream(const void* x, const void* wg, const void* wu,
                          const void* wd, StreamArgs a, const int* plan,
                          const long long* maps, cudaStream_t stream) {
  constexpr int kSmem1 = st::smem1_bytes(MP), kSmem2 = st::smem2_bytes(MP);
  if (plan[1] != st::kUnitF || plan[2] != st::kKC ||
      plan[3] != st::kTileD || plan[4] != st::kFC ||
      plan[5] != st::kStages || plan[8] != kSmem1 || plan[9] != kSmem2 ||
      plan[6] <= 0 || plan[7] <= 0 ||
      maps[3] != 64 || maps[4] != MP ||                       // x
      maps[9] != st::kUnitF || maps[10] != st::kKC ||         // Wg
      maps[15] != st::kUnitF || maps[16] != st::kKC ||        // Wu
      maps[21] != st::kTileD || maps[22] != st::kFC ||        // Wd
      maps[27] != 64 || maps[28] != 2 * MP)                   // H
    return cudaErrorInvalidValue;
  CUtensorMap tx, tg, tu, td, th;
  if (!encode_map_2d(&tx, x, maps) || !encode_map_2d(&tg, wg, maps + 6) ||
      !encode_map_2d(&tu, wu, maps + 12) ||
      !encode_map_2d(&td, wd, maps + 18) ||
      !encode_map_2d(&th, a.h, maps + 24))
    return cudaErrorInvalidValue;
  auto k1 = fused_ffn_stream_gate_kernel<MP>;
  auto k2 = fused_ffn_stream_down_kernel<MP>;
  static unsigned long long set1 = 0, set2 = 0;
  cudaError_t err = allow_smem(k1, kSmem1, &set1);
  if (err == cudaSuccess) err = allow_smem(k2, kSmem2, &set2);
  if (err != cudaSuccess) return err;
  k1<<<plan[6], st::kThreads, kSmem1, stream>>>(tx, tg, tu, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<plan[7], st::kThreads, kSmem2, stream>>>(td, th, a);
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

// h: the (2 MP, F) bf16 H workspace between the passes; ws: two 64 x MP
// f32 partials a pass-2 block; counters: one int a 64-column output tile,
// 0 before and after each launch
extern "C" int fused_ffn_bf16_stream(const void* x, const void* wg,
                                     const void* wu, const void* wd,
                                     void* out, void* h, void* ws,
                                     void* counters, int m, int d, int f,
                                     int act, const int* plan,
                                     const long long* maps, void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  const int chunks = (f + st::kFC - 1) / st::kFC;
  const long long tiles = (d + st::kTileD - 1) / st::kTileD;
  StreamArgs a{static_cast<bf16*>(h), static_cast<bf16*>(out),
               static_cast<float*>(ws), static_cast<int*>(counters),
               m, d, f, act, (f + st::kUnitF - 1) / st::kUnitF, chunks,
               tiles * chunks};
  const long long nk = (d + st::kKC - 1) / st::kKC;
  if (plan[7] > a.steps || plan[6] > a.units * nk)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan[0]) {
    case 8: return launch_stream<8>(x, wg, wu, wd, a, plan, maps, s);
    case 16: return launch_stream<16>(x, wg, wu, wd, a, plan, maps, s);
    case 24: return launch_stream<24>(x, wg, wu, wd, a, plan, maps, s);
    default: return cudaErrorInvalidValue;
  }
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
