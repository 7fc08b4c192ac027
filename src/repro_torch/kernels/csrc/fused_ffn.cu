// Fused gated FFN, y = (act(x @ Wg) * (x @ Wu)) @ Wd, for Hopper (sm_90a),
// in four routes: three for bf16 (small_m for a few rows at D up to 576,
// or 1440 at fewer rows, stream for the other M <= 24, two_pass for the
// rest) and the f32 CUDA-core kernel.  The wrapper's plan (ffn_plan in
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
// bf16, small M ("small_m", fused_ffn_small_kernel: every M <= 64 at D
// <= 576, and up to D 1440 at fewer rows: the domain of PR 16's kernel,
// which held x and D x 16 weight slices in 200 KiB).  Bound by the
// weight bytes, and at a decode step's few MB by latency: the weights of
// paper-backbone's FFN (1.5 MB) stay in L2 across graph-replayed steps.
// One launch of clusters of up to 16 blocks (cudaLaunchKernelEx with a
// cluster dimension): the blocks of a cluster split F into units of 64
// columns, each cluster owns a group of 64-column output tiles (a cluster
// beside another recomputes H) and, at large D x F, one of a few ranges
// of F.  A block is a producer warp, whose one thread issues every TMA
// load (x once, then a unit's Wg/Wu tiles chunk by chunk and its Wd
// tiles) into a ring of mbarrier slots, and a consumer warpgroup on wgmma
// with the weight tile as the 64-row operand and x (then H as bf16 hi +
// lo) on the N side: the first products start on the first chunk to
// land.  Each block keeps its F slice's f32 share of the group's output
// in shared memory; the shares are summed through distributed shared
// memory (each block stores every owner's columns into the owner's
// shared memory, one cluster barrier, each owner adds the ranks' shares
// in order), rounded once.  At paper-backbone's decode step (M 8, D 256,
// F 1024) four clusters of 16 blocks each take one 64-column output tile
// and all of F, 64 F columns a block.  It replaced PR 16's kernel
// (mma.sync after one cp.async wait, Wg/Wu read once per 64-column
// output chunk by 256 blocks, an f32 workspace of 64 splits summed by the
// last block of each chunk behind a __threadfence and a counter), which
// reached 5 % of the byte bound (PERF.md).
//
// Why small_m does not carry to D 2048 or 6144: a unit's Wg/Wu tiles over
// all of D are 256 KB a block at D 1024, and the F ranges beyond one go
// through a global workspace; above D 512 the stream route spreads the
// weights over every SM in even runs.

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
// bf16, larger M ("two_pass", fused_ffn_two_pass_kernel: M > 24 at D >
// 512, M > 64 below).  Bound by the 6 M D F operations; H's round trip
// through device memory, 2 M F 2 bytes, is 268 MB at M 8192, F 8192
// (~0.08 ms against the 0.834 ms operation bound).  Two launches of one
// persistent kernel, C = A B, at most one block an SM.  A block is a
// producer warpgroup whose one thread issues every TMA load (64 x 64
// boxes in the 128-byte swizzle: A's 128 rows of a 64-deep K chunk
// K-major, B's four 64-column groups N-major, as wgmma's descriptors read
// them) into a 4-slot ring with a full and an empty mbarrier a slot, and
// two consumer warpgroups of 64 rows on wgmma m64n256k16 (setmaxnreg: 24
// registers a producer thread, 240 a consumer's), which wait only on the
// full barrier of the slot they read and free it by one arrival a warp
// once its products are done; no block-wide barrier in the K loop.
// - pass 1: B = [Wg | Wu] over 128 F columns, so a thread holds G and U
//   of the same element: H = act(G) * U in f32, rounded once to bf16
//   into the (M, F) workspace; the gate and up products are done once a
//   row;
// - pass 2: y = H Wd over 256 output columns, f32 over all of F, rounded
//   once.
// The 128 x 256 tiles are handed out statically (block b: tiles b, b +
// grid, ...), rastered in groups of 8 row tiles, so the blocks running at
// once share rows of x / H and weight columns in L2.  The tiles of a last
// wave that would leave at least half the SMs idle are cut into K parts
// (at most 8, one a block; the blocks of a part read the same K range):
// each part's f32 share goes to the workspace and the last of the tile's
// blocks to arrive (a counter it resets) sums them in part order and
// rounds once.  qwen1.5-32b's pass 2 at M 1024 runs 132 whole tiles, then
// 28 in 4 parts; a 32-row decode step's at yi-34b 28 tiles in 4 parts on
// 112 SMs.  The epilogue stages the rounded tile in 64 x 64 boxes in
// shared memory (two a consumer, in turn) and writes each by a TMA store,
// which drops rows past M and columns past N, while the producer already
// fills the next tile's slots.  A consumer waits for its products at the
// end of each chunk (wgmma_wait<0>): the other warpgroup's keep the
// tensor cores busy, and leaving them in flight across the next chunk's
// wait held each slot a chunk longer (slower on the H100 at every shape
// tried).  ptxas
// gives the kernel 168 registers (the launch bound's share of 384
// threads) without spills; the 128 f32 accumulators of a consumer's 64 x
// 256 share leave no room to hold one tile while the next one's products
// start, so the epilogue is not hidden behind the tensor cores.  Why H
// leaves the chip: fused, a block that owns an output tile must hold (or
// recompute) H for all of F; at D > 512 the output has D/256 tiles and
// either each recomputes [G | U] (D/256 times the gate and up products)
// or one block holds the tile's 64 x D f32 output (96 KB of registers at
// D 6144).  At D 256, where one tile could keep H on chip, two_pass was
// still faster on the H100 than such a kernel (64-row tiles holding H in
// registers), which it replaced (PERF.md).

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

// the slot's release by one consumer warp, once its products are done
__device__ __forceinline__ void release_slot(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// ----------------------------------- bf16 small M: one launch of clusters
// The blocks of a cluster split its F range into units of 64 columns; a
// cluster owns a column group of the output (tiles_g 64-column tiles) and
// one of `fsplits` ranges of F.  A block is a consumer warpgroup (warps
// 0-3) and a producer warp (warp 4) whose one thread issues every TMA
// load: x once, then, a unit at a time, Wg's and Wu's 64 x 64 tiles of
// each 64-row D chunk (one ring slot), then Wd's 64 x 64 tiles of the
// unit's rows and the group's columns, two tiles a slot.  The consumers
// form G^T and U^T of the unit on wgmma (the weight tile as the MN-major
// 64-row A operand, x^T on the N side), H = act(G) U in f32 as bf16 hi +
// lo rows in shared memory, then y^T += Wd^T [H_hi; H_lo]^T (N = 2 MP)
// into the block's f32 share of the group's output in shared memory,
// units added in order.  Then the cluster's blocks sum the shares through
// distributed shared memory: block r owns a run of the group's columns;
// every block stores its share of each run into the owner's shared memory
// (mapa, st.shared::cluster), and after one cluster barrier each owner
// adds what ranks 0, 1, ... sent in turn.  With one F range the sum is
// rounded once and written: no workspace, counter or float atomic.  With
// several (large D x F, where one cluster's 16 SMs would stream all of Wg
// and Wu), each cluster's sums go to an f32 workspace and the last of the
// ranges' blocks to arrive (a counter it resets) adds them in range order
// and rounds once.  A call repeats bit for bit either way.
namespace sm {
constexpr int kUnitF = 64;        // F columns of a unit
constexpr int kKC = 64;           // D rows of a gate chunk
constexpr int kTileD = 64;        // output columns of a tile
constexpr int kSlot = 16384;      // a ring slot: two 64 x 64 bf16 tiles
constexpr int kMaxStages = 8;     // ring slots at most
constexpr int kMaxCluster = 16;   // blocks a cluster at most
constexpr int kThreads = 160;     // a consumer warpgroup + a producer warp
// the most quads (4 output columns) of a group of tiles_g tiles that one
// block of a cluster owns
__host__ __device__ constexpr int owned_quads(int tiles_g, int cluster) {
  return (tiles_g * kTileD / 4 + cluster - 1) / cluster;
}
// dynamic shared memory of a block, in the kernel's layout: 1024 to align
// the swizzle atoms, the ring, H's 2 MP rows (hi, then lo) of 128 bytes,
// x's nk blocks of MP rows x 128 bytes, the f32 share of the group's
// output (MP rows of tiles_g * 64 + 4 floats: the 4 keep the rows' banks
// apart), the shares received of the owned quads (cluster x MP rows of
// owned_quads x 16 bytes), a full and an empty mbarrier a slot, x's and a
// flag
__host__ __device__ constexpr int smem_bytes(int mp, int nk, int tiles_g,
                                             int stages, int cluster) {
  return 1024 + stages * kSlot + 2 * mp * 128 + nk * mp * 128 +
         mp * (tiles_g * kTileD + 4) * 4 +
         cluster * mp * owned_quads(tiles_g, cluster) * 16 + 16 * stages +
         16;
}
}  // namespace sm

struct SmallArgs {
  bf16* out;           // (M, D)
  float* ws;           // fsplits > 1: fsplits x M x D f32 sums
  int* counters;       // fsplits > 1: one a (group, rank), 0 between launches
  int m, d, f, act;
  int units;           // ceil(F / 64)
  int nk;              // ceil(D / 64): gate chunks a unit, x's blocks
  int tiles_g;         // output tiles of a column group
  int groups;          // column groups
  int fsplits;         // ranges of F, a cluster each (for each group)
  int stages;          // ring slots
};

template <int MP>
__global__ void __launch_bounds__(sm::kThreads, 1)
    fused_ffn_small_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_wg,
                           const __grid_constant__ CUtensorMap tm_wu,
                           const __grid_constant__ CUtensorMap tm_wd,
                           SmallArgs a) {
  constexpr int kV = MP / 2;                  // G's (U's) values a thread
  constexpr int kHalf = sm::kSlot / 2;        // one 64 x 64 bf16 tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int S = a.stages, nk = a.nk;
  const int cs = (int)cluster_size(), rank = (int)cluster_rank();
  const int pstride = a.tiles_g * sm::kTileD + 4;
  const int rstride = 4 * sm::owned_quads(a.tiles_g, cs);   // floats a row
  unsigned char* h_s = smem + S * sm::kSlot;
  unsigned char* x_s = h_s + 2 * MP * 128;
  float* part = reinterpret_cast<float*>(x_s + nk * MP * 128);
  // the shares received of the owned quads: MP rows a rank, in rank order
  float* recv = part + MP * pstride;
  uint64_t* full = reinterpret_cast<uint64_t*>(recv + cs * MP * rstride);
  uint64_t* empty = full + S;
  uint64_t* x_full = empty + S;
  volatile int* last = reinterpret_cast<volatile int*>(x_full + 1);
  const int cluster = (int)blockIdx.x / cs;
  const int group = cluster % a.groups, split = cluster / a.groups;
  // the cluster's F range, then this block's units of it
  const int c0 = split * a.units / a.fsplits;
  const int c1 = (split + 1) * a.units / a.fsplits;
  const int u0 = c0 + rank * (c1 - c0) / cs;
  const int u1 = c0 + (rank + 1) * (c1 - c0) / cs;
  const int tiles = (a.d + sm::kTileD - 1) / sm::kTileD;
  const int t0 = group * a.tiles_g;
  const int t1 = min(t0 + a.tiles_g, tiles);
  const int pairs = (t1 - t0 + 1) / 2;
  const int tid = threadIdx.x;
  if (tid == 128) {
    tma_prefetch(&tm_x);
    tma_prefetch(&tm_wg);
    tma_prefetch(&tm_wu);
    tma_prefetch(&tm_wd);
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);             // one arrival a consumer warp
    }
    mbar_init(x_full, 1);
    fence_mbar_init();
  }
  __syncthreads();
  // the first half of a cluster barrier, whose wait (before the first
  // store into another block) ensures every block of the cluster runs
  cluster_arrive_relaxed();

  if (tid >= 128) {
    // ---- producer: one thread issues every load.  A fresh barrier's
    // previous phase counts as complete, so each first wait passes.
    if (tid == 128) {
      mbar_expect_tx(x_full, nk * MP * 128);
      for (int c = 0; c < nk; ++c)
        tma_load_2d(x_s + c * MP * 128, &tm_x, x_full, c * sm::kKC, 0);
      int i = 0;
      auto take = [&](uint32_t bytes) {
        const int s = i % S;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        ++i;
        return s;
      };
      for (int u = u0; u < u1; ++u) {
        for (int c = 0; c < nk; ++c) {
          const int s = take(sm::kSlot);
          unsigned char* sp = smem + s * sm::kSlot;
          tma_load_2d(sp, &tm_wg, &full[s], u * sm::kUnitF, c * sm::kKC);
          tma_load_2d(sp + kHalf, &tm_wu, &full[s], u * sm::kUnitF,
                      c * sm::kKC);
        }
        // a slot's second tile is loaded only where the group has one
        for (int p = 0; p < pairs; ++p) {
          const int ta = t0 + 2 * p;
          const bool two = ta + 1 < t1;
          const int s = take(two ? sm::kSlot : kHalf);
          unsigned char* sp = smem + s * sm::kSlot;
          tma_load_2d(sp, &tm_wd, &full[s], ta * sm::kTileD,
                      u * sm::kUnitF);
          if (two)
            tma_load_2d(sp + kHalf, &tm_wd, &full[s], (ta + 1) * sm::kTileD,
                        u * sm::kUnitF);
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    mbar_wait(x_full, 0);
    int i = 0;
    for (int u = u0; u < u1; ++u) {
      // G^T and U^T (64 x MP each) of unit u in acc[0, kV), acc[kV, 2 kV).
      // A: the chunk's 64 D rows of the unit's 64 F columns, MN-major; a
      // k-step is 16 rows of 128 bytes.  B: x's block c, K-major; a
      // k-step is 32 bytes into its rows.
      float acc[2 * kV];
#pragma unroll
      for (int j = 0; j < 2 * kV; ++j) acc[j] = 0.f;
      for (int c = 0; c < nk; ++c, ++i) {
        const int s = i % S;
        mbar_wait(&full[s], (i / S) & 1);
        const unsigned char* sp = smem + s * sm::kSlot;
        const uint64_t dg = wgmma_desc(sp, 16, 1024);
        const uint64_t du = wgmma_desc(sp + kHalf, 16, 1024);
        const uint64_t dx = wgmma_desc(x_s + c * MP * 128, 16, 1024);
        fence_regs(acc, 2 * kV);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < sm::kKC / 16; ++kk) {
          wgmma_mn<MP>(acc, dg + ((kk * 16 * 128) >> 4),
                       dx + ((kk * 32) >> 4), 1);
          wgmma_mn<MP>(acc + kV, du + ((kk * 16 * 128) >> 4),
                       dx + ((kk * 32) >> 4), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc, 2 * kV);
        release_slot(&empty[s], lane);
      }
      // H = act(G) U of the unit: A row 16 warp + g (+ 8) is its F column,
      // n-block j holds x rows 8 j + 2 t and + 1.  Its bf16 hi part goes
      // to row n of h_s, its lo part to row MP + n, in the 128-byte
      // swizzle wgmma's K-major B reads; H stays within ~2^-17 of f32
      named_bar_sync(1, 128);      // the last unit's products are done
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * warp + g + 8 * (e >> 1);
          const int n = 8 * j + 2 * t + (e & 1);
          const float hv = activate_fast(acc[4 * j + e], a.act) *
                           acc[kV + 4 * j + e];
          const bf16 hi = __float2bfloat16(hv);
          const int off = swz(n, col >> 3) + 2 * (col & 7);
          *reinterpret_cast<bf16*>(h_s + off) = hi;
          *reinterpret_cast<bf16*>(h_s + MP * 128 + off) =
              __float2bfloat16(hv - __bfloat162float(hi));
        }
      fence_proxy_async();                  // visible to wgmma's reads
      named_bar_sync(1, 128);
      // the unit's share of the group's tiles, two a slot: y^T (64 output
      // columns x 2 MP) += Wd^T (A: the slot's 64 x 64 tile, MN-major)
      // [H_hi; H_lo]^T (B: h_s, K-major).  A slot holding one tile has
      // stale bytes in its second half: that product is never stored.
      const uint64_t dh = wgmma_desc(h_s, 16, 1024);
      for (int p = 0; p < pairs; ++p, ++i) {
        const int s = i % S;
        float y[2 * MP];
#pragma unroll
        for (int j = 0; j < 2 * MP; ++j) y[j] = 0.f;
        mbar_wait(&full[s], (i / S) & 1);
        const unsigned char* sp = smem + s * sm::kSlot;
        const uint64_t d0 = wgmma_desc(sp, 16, 1024);
        const uint64_t d1 = wgmma_desc(sp + kHalf, 16, 1024);
        fence_regs(y, 2 * MP);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < sm::kUnitF / 16; ++kk) {
          const uint64_t bk = dh + ((kk * 32) >> 4);
          wgmma_mn<2 * MP>(y, d0 + ((kk * 16 * 128) >> 4), bk, 1);
          wgmma_mn<2 * MP>(y + MP, d1 + ((kk * 16 * 128) >> 4), bk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(y, 2 * MP);
        release_slot(&empty[s], lane);
        // y^T row 16 warp + g (+ 8) of tile 2 p + h is the group's column
        // (2 p + h) 64 + that row; x rows 8 j + 2 t (+ 1): hi + lo
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && t0 + 2 * p + 1 >= t1) break;
#pragma unroll
          for (int j = 0; j < MP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = (2 * p + h) * sm::kTileD + 16 * warp + g +
                              8 * (e >> 1);
              const int n = 8 * j + 2 * t + (e & 1);
              const float v = y[h * MP + 4 * j + e] +
                              y[h * MP + 4 * (j + MP / 8) + e];
              float* dst = part + n * pstride + col;
              *dst = u == u0 ? v : *dst + v;
            }
        }
      }
    }
  }

  // ---- the cluster's sum.  Block r owns quads [r quads / cs, (r + 1)
  // quads / cs) of the group's columns within D (quads of 4 columns).
  // Every block stores its share of each owner's quads into the owner's
  // receive rows for its rank (remote stores, once every block of the
  // cluster runs); after the barrier each owner adds what it received
  // from ranks 0, 1, ... in turn.  Nothing reads another block's shared
  // memory after the barrier, so no block waits for another to leave.
  const int quads = (min(t1 * sm::kTileD, a.d) - t0 * sm::kTileD) / 4;
  const int q_mine = rank * quads / cs;
  const int nq_mine = (rank + 1) * quads / cs - q_mine;
  cluster_wait();
  if (tid < 128) {
    named_bar_sync(1, 128);              // every unit's share is in `part`
    for (int it = tid; it < a.m * quads; it += 128) {
      const int n = it / quads, q = it % quads;
      // the owner: the largest r whose run begins at or before quad q
      const int r = ((q + 1) * cs - 1) / quads;
      const float* dst =
          recv + (rank * MP + n) * rstride + 4 * (q - r * quads / cs);
      st_cluster_f4(cluster_map(smem_addr(dst), r),
                    *reinterpret_cast<const float4*>(part + n * pstride +
                                                     4 * q));
    }
  }
  cluster_arrive();
  cluster_wait();
  const bool whole = a.fsplits == 1;
  for (int it = tid; it < a.m * nq_mine; it += sm::kThreads) {
    const int n = it / nq_mine, q = it % nq_mine;
    const int col = t0 * sm::kTileD + 4 * (q_mine + q);
    const float4* src =
        reinterpret_cast<const float4*>(recv + n * rstride + 4 * q);
    float4 v[sm::kMaxCluster];            // every load issued, then added
#pragma unroll
    for (int r = 0; r < sm::kMaxCluster; ++r)
      if (r < cs) v[r] = src[r * MP * rstride / 4];
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < sm::kMaxCluster; ++r)
      if (r < cs) {
        sum.x += v[r].x;
        sum.y += v[r].y;
        sum.z += v[r].z;
        sum.w += v[r].w;
      }
    if (whole)
      *reinterpret_cast<uint2*>(a.out + (long long)n * a.d + col) =
          make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    else
      *reinterpret_cast<float4*>(
          a.ws + ((long long)split * a.m + n) * a.d + col) = sum;
  }
  if (whole) return;
  // the last of the F ranges' blocks of this (group, rank) to arrive adds
  // the ranges' sums in range order and rounds once
  __threadfence();
  __syncthreads();
  int* counter = a.counters + group * cs + rank;
  if (tid == 0) *last = atomicAdd(counter, 1) == a.fsplits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int it = tid; it < a.m * nq_mine; it += sm::kThreads) {
    const int n = it / nq_mine;
    const int col = t0 * sm::kTileD + 4 * (q_mine + it % nq_mine);
    const float* src = a.ws + (long long)n * a.d + col;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(src));
    for (int c = 1; c < a.fsplits; ++c) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          src + (long long)c * a.m * a.d));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<uint2*>(a.out + (long long)n * a.d + col) =
        make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
  }
  if (tid == 0) *counter = 0;                // ready for the next launch
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
// Two persistent launches of one warp-specialised kernel, C = A B: pass 1
// A = x, B = [Wg | Wu], C = H (its epilogue forms act(G) * U); pass 2 A =
// H, B = Wd, C = y.  A block is a producer warpgroup (one thread issues
// every TMA load into a ring of kStages slots, each with a full and an
// empty mbarrier) and two consumer warpgroups of 64 rows each on wgmma
// m64n256k16; at most one block an SM.  The plan (two_pass_plan in
// kernels/fused_ffn.py) mirrors these numbers and passes them in; the
// entry refuses a plan or map that differs.
namespace tp {
constexpr int kBM = 128;            // rows a tile: 64 a consumer warpgroup
constexpr int kBN = 256;            // N columns a tile
constexpr int kKC = 64;             // K a ring slot: one 128-byte row
constexpr int kBox = 64;            // TMA boxes: 64 columns by 64 rows
constexpr int kStages = 4;          // ring slots
constexpr int kGroupM = 8;          // row tiles a raster group
constexpr int kThreads = 384;       // a producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// a slot: A's two 64-row boxes (128-byte rows), then B's four boxes of
// kKC rows
constexpr int kStageBytes = kBM * 128 + kKC * kBN * 2;
constexpr int kOutBytes = 4 * kBox * 128;   // two 64 x 64 boxes a consumer
// + 1024 to align the swizzle atoms, the epilogue's boxes, 16 bytes of
// barriers a slot, two flags
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kOutBytes +
                           16 * kStages + 16;
// f32 values of one consumer warpgroup's share of a tile (64 x 256)
constexpr int kShare = 64 * kBN;
}  // namespace tp

struct TwoPassArgs {
  int m, n, k, act;           // rows, C's columns (F, D), K (D, F)
  int row_tiles, col_tiles;   // tiles of kBM rows and of the N columns
  int tiles, parts;           // parts: K parts of the last wave's tiles
  float* ws;                  // parts > 1: a 64 x 256 f32 share a block
                              // and consumer warpgroup
  int* counters;              // parts > 1: one a (last-wave tile,
                              // warpgroup), 0 between launches
};

// tile -> (row tile, column tile): groups of kGroupM row tiles walk the
// column tiles together, the rows fastest, so the blocks running at once
// share a few A rows and B columns in L2
__device__ __forceinline__ void tp_tile(int tile, int row_tiles,
                                        int col_tiles, int* rt, int* ct) {
  const int per_group = tp::kGroupM * col_tiles;
  const int first = tile / per_group * tp::kGroupM;
  const int rows_in = min(row_tiles - first, tp::kGroupM);
  const int in_group = tile - first * col_tiles;
  *rt = first + in_group % rows_in;
  *ct = in_group / rows_in;
}

// A block's segments, each a tile and its K chunks [c0, c1): first the
// whole waves, tiles blockIdx.x, blockIdx.x + gridDim.x, ... below
// full = gridDim.x * (tiles / gridDim.x); then the last wave's rem tiles,
// each cut into `parts` K parts (split-K; 1: whole): block j < rem *
// parts runs part j / rem of tile full + j % rem, so the blocks running
// a part at once read the same K range of their rows and columns.
struct TpSegments {
  int t, full, rem, nk, parts;
  bool tail;                   // the last wave's segment is still to run
  __device__ TpSegments(const TwoPassArgs& a, int nk_)
      : t(blockIdx.x), nk(nk_), parts(a.parts) {
    full = a.tiles / gridDim.x * gridDim.x;
    rem = a.tiles - full;
    tail = (int)blockIdx.x < rem * parts;
  }
  __device__ __forceinline__ bool next(int* tile, int* c0, int* c1) {
    if (t < full) {
      *tile = t;
      *c0 = 0;
      *c1 = nk;
      t += gridDim.x;
      return true;
    }
    if (!tail) return false;
    tail = false;
    const int p = blockIdx.x / rem;
    *tile = full + blockIdx.x % rem;
    *c0 = p * nk / parts;
    *c1 = (p + 1) * nk / parts;
    return true;
  }
};

// The fixup of a tile cut into K parts, one consumer warpgroup's 64 rows:
// its f32 share acc (value j of thread ctid at j * 128 + ctid) goes to
// this block's slot; the last of the tile's blocks to arrive gets the sum
// in part order in acc, resets the counter and returns true.  No float
// atomics: the sum repeats bit for bit.
__device__ __forceinline__ bool tp_fixup(float* acc, const TwoPassArgs& a,
                                         int r, int rem, int cw, int ctid,
                                         volatile int* last) {
  auto slot = [&](int b) -> float* {
    return a.ws + (long long)(b * 2 + cw) * tp::kShare;
  };
  float* mine = slot(blockIdx.x);
#pragma unroll
  for (int j = 0; j < tp::kBN / 2; ++j) mine[j * 128 + ctid] = acc[j];
  __threadfence();
  named_bar_sync(1 + cw, 128);
  int* counter = a.counters + 2 * r + cw;
  if (ctid == 0) *last = atomicAdd(counter, 1) == a.parts - 1;
  named_bar_sync(1 + cw, 128);
  if (!*last) return false;
  __threadfence();
#pragma unroll
  for (int j = 0; j < tp::kBN / 2; ++j) acc[j] = 0.f;
  for (int p = 0; p < a.parts; ++p) {
    const float* src = slot(r + p * rem);
#pragma unroll
    for (int j = 0; j < tp::kBN / 2; ++j)
      acc[j] += __ldcg(src + j * 128 + ctid);
  }
  if (ctid == 0) *counter = 0;               // ready for the next launch
  return true;
}

// GATED (pass 1): a tile's B is [Wg | Wu] over 128 F columns (N column n
// < 128 is Wg's column n0 + n, the rest Wu's at the same F columns), so a
// thread holds G and U of the same element and its epilogue writes H =
// act(G) * U; else (pass 2) B is 256 columns of Wd and the epilogue
// writes the f32 sums.  Both round to bf16 once, stage the tile in 64 x
// 64 boxes in shared memory (the 128-byte swizzle, two boxes a warpgroup
// in turn) and write each by a TMA store, which drops the rows past M and
// columns past N; a box of C wholly past N is neither staged nor stored.
// A box of A or B that lies wholly past M or N is not
// loaded (its products are never stored); K's ragged chunk is zero-filled
// by TMA.  tm_a: A's map (boxes of 64 columns by 64 rows, K-major);
// tm_b0, tm_b1: B's (64 by 64, N-major; tm_b1 is Wu, pass 2 passes Wd
// twice); tm_c: C's (64 by 64).
template <bool GATED>
__global__ void __launch_bounds__(tp::kThreads, 1)
    fused_ffn_two_pass_kernel(const __grid_constant__ CUtensorMap tm_a,
                              const __grid_constant__ CUtensorMap tm_b0,
                              const __grid_constant__ CUtensorMap tm_b1,
                              const __grid_constant__ CUtensorMap tm_c,
                              TwoPassArgs a) {
  constexpr int kS = tp::kStages, kStage = tp::kStageBytes;
  constexpr int kKC = tp::kKC, kBN = tp::kBN, kBoxBytes = tp::kBox * 128;
  constexpr int kA = tp::kBM * 128;             // A's bytes in a slot
  constexpr int kCols = GATED ? kBN / 2 : kBN;  // C columns a tile
  constexpr int kV = kBN / 2;                   // accumulators a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* out_s = smem + kS * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + tp::kOutBytes);
  uint64_t* empty = full + kS;
  volatile int* last = reinterpret_cast<volatile int*>(empty + kS);
  const int tid = threadIdx.x;
  const int nk = (a.k + kKC - 1) / kKC;
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);             // one arrival a consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();
  TpSegments seg(a, nk);
  int tile, c0, c1;

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every load, the ring's
    // parity following the block's running chunk count across tiles.  A
    // fresh barrier's previous phase counts as complete, so each first
    // wait on an empty slot passes.
    setmaxnreg_dec<tp::kProducerRegs>();
    if (tid == 0) {
      tma_prefetch(&tm_a);
      tma_prefetch(&tm_b0);
      tma_prefetch(&tm_b1);
      int i = 0;
      while (seg.next(&tile, &c0, &c1)) {
        int rt, ct;
        tp_tile(tile, a.row_tiles, a.col_tiles, &rt, &ct);
        const int m0 = rt * tp::kBM, n0 = ct * kCols;
        // B box q's first column (of Wg for q < 2, else of Wu, in pass 1)
        auto col = [&](int q) { return n0 + 64 * (GATED ? q & 1 : q); };
        const bool rows2 = m0 + 64 < a.m;
        uint32_t bytes = (rows2 ? 2 : 1) * kBoxBytes;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col(q) < a.n) bytes += kBoxBytes;
        for (int c = c0; c < c1; ++c, ++i) {
          const int s = i % kS;
          mbar_wait(&empty[s], ((i / kS) & 1) ^ 1);
          mbar_expect_tx(&full[s], bytes);
          unsigned char* sp = smem + s * kStage;
          tma_load_2d(sp, &tm_a, &full[s], c * kKC, m0);
          if (rows2)
            tma_load_2d(sp + kBoxBytes, &tm_a, &full[s], c * kKC, m0 + 64);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col(q) < a.n)
              tma_load_2d(sp + kA + q * kBoxBytes,
                          GATED && q >= 2 ? &tm_b1 : &tm_b0, &full[s],
                          col(q), c * kKC);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows [m0, m0 + 64) of each tile each
  setmaxnreg_inc<tp::kConsumerRegs>();
  const int cw = tid / 128 - 1, ctid = tid & 127;
  const int warp = ctid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* boxes = out_s + cw * 2 * kBoxBytes;
  int i = 0, stored = 0;
  while (seg.next(&tile, &c0, &c1)) {
    int rt, ct;
    tp_tile(tile, a.row_tiles, a.col_tiles, &rt, &ct);
    const int m0 = rt * tp::kBM + 64 * cw, n0 = ct * kCols;
    // a warpgroup whose rows all lie past M (M <= 64) frees its slots
    // and skips the products, the fixup and the epilogue
    const bool live = m0 < a.m;
    float acc[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) acc[j] = 0.f;
    for (int c = c0; c < c1; ++c, ++i) {
      const int s = i % kS;
      mbar_wait(&full[s], (i / kS) & 1);
      if (live) {
        // A: this warpgroup's 64 rows, K-major, a k-step 32 bytes into
        // the 128-byte rows.  B: N-major, 64-column groups kKC * 128
        // bytes apart, a k-step 16 rows (2048 bytes).
        const unsigned char* sp = smem + s * kStage;
        const uint64_t da = wgmma_desc(sp + cw * kBoxBytes, 16, 1024);
        const uint64_t db = wgmma_desc(sp + kA, kKC * 128, 1024);
        fence_regs(acc, kV);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
          wgmma_ss<kBN, 1>(acc, da + ((kk * 32) >> 4),
                           db + ((kk * 16 * 128) >> 4), 1);
        wgmma_commit();
        // the slot is free once its products are done.  The other
        // warpgroup's products keep the tensor cores busy meanwhile;
        // leaving a chunk's products in flight across the next chunk's
        // wait (wgmma_wait<1>) holds each slot a chunk longer and was
        // slower on the H100
        wgmma_wait<0>();
        fence_regs(acc, kV);
      }
      release_slot(&empty[s], lane);
    }
    if (!live) continue;
    if ((c0 > 0 || c1 < nk) &&
        !tp_fixup(acc, a, tile - seg.full, seg.rem, cw, ctid, last + cw))
      continue;
    // ---- epilogue: the producer is already filling the next tile's
    // slots.  Box p holds C columns n0 + 64 p .. + 63 (n-blocks 8 p ..
    // 8 p + 7 of the accumulator; of G, beside U's at + 16, in pass 1);
    // thread (warp, g, t) writes rows 16 warp + g and + 8, columns 8 j +
    // 2 t and + 1 of it, conflict-free in the swizzled layout.  The boxes
    // go in increasing column order and the loop ends at the first box
    // wholly past N, so every box written is stored and `stored` counts
    // the bulk groups issued.
#pragma unroll
    for (int p = 0; p < kCols / 64 && n0 + 64 * p < a.n; ++p, ++stored) {
      unsigned char* box = boxes + (stored & 1) * kBoxBytes;
      // the store issued from this box two stores ago is done reading it
      if (ctid == 0) tma_store_wait_read<1>();
      named_bar_sync(1 + cw, 128);
      const int r0 = 16 * warp + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nb = 8 * p + j;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = GATED ? activate_fast(acc[4 * nb + e], a.act) *
                             acc[4 * (nb + 16) + e]
                       : acc[4 * nb + e];
        *reinterpret_cast<uint32_t*>(box + swz(r0, j) + 4 * t) =
            pack_bf16(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(box + swz(r0 + 8, j) + 4 * t) =
            pack_bf16(v[2], v[3]);
      }
      fence_proxy_async();                  // visible to the TMA store
      named_bar_sync(1 + cw, 128);
      if (ctid == 0) {
        tma_store_2d(&tm_c, box, n0 + 64 * p, m0);
        tma_store_commit();
      }
    }
  }
  if (ctid == 0) tma_store_wait<0>();
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

// a kernel attribute set once a device
template <typename K>
cudaError_t func_attr_once(K kernel, cudaFuncAttribute attr, int value,
                           unsigned long long* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (*set & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess) *set |= bit;
  return err;
}

// the dynamic shared memory attribute of a kernel, set once a device
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long* set) {
  return func_attr_once(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                        bytes, set);
}

// plan: rows (MP), unit columns, gate chunk, tile columns, slot bytes,
// cluster size, column groups, tiles a group, ring slots, shared memory,
// F ranges (small_plan); maps: x, Wg, Wu, Wd, 6 numbers each.  One launch
// of groups x F ranges clusters of `cluster` blocks (cudaLaunchKernelEx
// with a cluster dimension; a size above 8 is allowed by the kernel's
// non-portable attribute), which a CUDA graph captures like any launch.
template <int MP>
cudaError_t launch_small(const void* x, const void* wg, const void* wu,
                         const void* wd, SmallArgs a, const int* plan,
                         const long long* maps, cudaStream_t stream) {
  const int smem =
      sm::smem_bytes(MP, a.nk, a.tiles_g, a.stages, plan[5]);
  if (plan[9] != smem || smem > 232448 ||
      maps[3] != 64 || maps[4] != MP ||                       // x
      maps[9] != sm::kUnitF || maps[10] != sm::kKC ||         // Wg
      maps[15] != sm::kUnitF || maps[16] != sm::kKC ||        // Wu
      maps[21] != sm::kTileD || maps[22] != sm::kUnitF)       // Wd
    return cudaErrorInvalidValue;
  CUtensorMap tx, tg, tu, td;
  if (!encode_map_2d(&tx, x, maps) || !encode_map_2d(&tg, wg, maps + 6) ||
      !encode_map_2d(&tu, wu, maps + 12) ||
      !encode_map_2d(&td, wd, maps + 18))
    return cudaErrorInvalidValue;
  auto kernel = fused_ffn_small_kernel<MP>;
  static unsigned long long set_smem = 0, set_cluster = 0;
  cudaError_t err = allow_smem(kernel, 232448, &set_smem);
  if (err == cudaSuccess)
    err = func_attr_once(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1,
                         &set_cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan[5] * plan[6] * plan[10], 1, 1);
  cfg.blockDim = dim3(sm::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan[5];
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&tx, &tg, &tu, &td, &a};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            args);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// plan: rows, columns and K of a tile, ring slots, shared memory, the
// two passes' blocks and K parts (two_pass_plan); tm: the maps of x,
// Wg, Wu, Wd, H and y
cudaError_t launch_two_pass(const CUtensorMap* tm, const TwoPassArgs& a1,
                            const TwoPassArgs& a2, const int* plan,
                            cudaStream_t stream) {
  auto k1 = fused_ffn_two_pass_kernel<true>;
  auto k2 = fused_ffn_two_pass_kernel<false>;
  static unsigned long long set1 = 0, set2 = 0;
  cudaError_t err = allow_smem(k1, tp::kSmemBytes, &set1);
  if (err == cudaSuccess) err = allow_smem(k2, tp::kSmemBytes, &set2);
  if (err != cudaSuccess) return err;
  k1<<<plan[5], tp::kThreads, tp::kSmemBytes, stream>>>(tm[0], tm[1], tm[2],
                                                         tm[4], a1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<plan[6], tp::kThreads, tp::kSmemBytes, stream>>>(tm[4], tm[3], tm[3],
                                                         tm[5], a2);
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
// ws: F ranges x M x D f32 sums and counters: one int a (column group,
// rank), 0 before and after each launch, where the plan has more than one
// F range (else unused, may be null)
extern "C" int fused_ffn_bf16_small(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    void* out, void* ws, void* counters,
                                    int m, int d, int f, int act,
                                    const int* plan, const long long* maps,
                                    void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  const int units = (f + sm::kUnitF - 1) / sm::kUnitF;
  const int tiles = (d + sm::kTileD - 1) / sm::kTileD;
  const int cluster = plan[5], groups = plan[6], tiles_g = plan[7];
  const int fsplits = plan[10];
  // every block at least one unit, every group at least one tile
  if (plan[1] != sm::kUnitF || plan[2] != sm::kKC || plan[3] != sm::kTileD ||
      plan[4] != sm::kSlot || m > plan[0] || cluster < 1 ||
      cluster > sm::kMaxCluster || fsplits < 1 ||
      units / fsplits < cluster || tiles_g < 1 ||
      groups != (tiles + tiles_g - 1) / tiles_g || plan[8] < 1 ||
      plan[8] > sm::kMaxStages || (fsplits > 1 && (!ws || !counters)))
    return cudaErrorInvalidValue;
  SmallArgs a{static_cast<bf16*>(out), static_cast<float*>(ws),
              static_cast<int*>(counters), m, d, f, act, units,
              (d + sm::kKC - 1) / sm::kKC, tiles_g, groups, fsplits,
              plan[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan[0]) {
    case 8: return launch_small<8>(x, wg, wu, wd, a, plan, maps, s);
    case 16: return launch_small<16>(x, wg, wu, wd, a, plan, maps, s);
    case 24: return launch_small<24>(x, wg, wu, wd, a, plan, maps, s);
    case 32: return launch_small<32>(x, wg, wu, wd, a, plan, maps, s);
    case 48: return launch_small<48>(x, wg, wu, wd, a, plan, maps, s);
    case 64: return launch_small<64>(x, wg, wu, wd, a, plan, maps, s);
    default: return cudaErrorInvalidValue;
  }
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

// h: the (M, F) bf16 workspace between the passes; ws: two 64 x 256 f32
// shares a block, for a pass whose last wave is cut into K parts;
// counters: two a tile of that wave, 0 before and after each launch;
// plan and maps as in launch_two_pass (maps: 6 numbers each).  Pass 1 has
// row tiles x ceil(F / 128) tiles, pass 2 row tiles x ceil(D / 256).
extern "C" int fused_ffn_bf16_two_pass(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       void* out, void* h, void* ws,
                                       void* counters, int m, int d, int f,
                                       int act, const int* plan,
                                       const long long* maps, void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  if (plan[0] != tp::kBM || plan[1] != tp::kBN || plan[2] != tp::kKC ||
      plan[3] != tp::kStages || plan[4] != tp::kSmemBytes || plan[5] <= 0 ||
      plan[6] <= 0 || plan[7] <= 0 || plan[8] <= 0 ||
      ((plan[7] > 1 || plan[8] > 1) && (!ws || !counters)))
    return cudaErrorInvalidValue;
  for (int j = 0; j < 6; ++j)
    if (maps[6 * j + 3] != tp::kBox || maps[6 * j + 4] != tp::kBox)
      return cudaErrorInvalidValue;
  const void* bases[6] = {x, wg, wu, wd, h, out};
  CUtensorMap tm[6];
  for (int j = 0; j < 6; ++j)
    if (!encode_map_2d(&tm[j], bases[j], maps + 6 * j))
      return cudaErrorInvalidValue;
  const int row_tiles = (m + tp::kBM - 1) / tp::kBM;
  const int ct1 = (f + tp::kBN / 2 - 1) / (tp::kBN / 2);
  const int ct2 = (d + tp::kBN - 1) / tp::kBN;
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  const TwoPassArgs a1{m, f, d, act, row_tiles, ct1, row_tiles * ct1,
                       plan[7], w, c};
  const TwoPassArgs a2{m, d, f, act, row_tiles, ct2, row_tiles * ct2,
                       plan[8], w, c};
  // no block without work; the last wave's parts one a block, each at
  // least one K chunk
  const int nk1 = (d + tp::kKC - 1) / tp::kKC;
  const int nk2 = (f + tp::kKC - 1) / tp::kKC;
  if (plan[5] > a1.tiles * a1.parts || plan[6] > a2.tiles * a2.parts ||
      a1.parts > nk1 ||
      a2.parts > nk2 || (a1.tiles % plan[5]) * a1.parts > plan[5] ||
      (a2.tiles % plan[6]) * a2.parts > plan[6])
    return cudaErrorInvalidValue;
  return launch_two_pass(tm, a1, a2, plan, static_cast<cudaStream_t>(stream));
}

