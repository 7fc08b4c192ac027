// Paged single-query GQA decode attention for Hopper (sm_90a), in two
// routes picked by dtype (decode_plan in kernels/paged_decode_attn.py):
// bf16 q over int8 or bf16 pools on the tensor cores (wgmma) with TMA
// loads, and f32 q, or any f32 pool, on the CUDA cores.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` in
// src/repro/kernels/paged_decode_attn.py (pallas_call at line 175, kernel
// body `_paged_decode_kernel` at line 42).  Plain version:
// repro_torch.kernels.ref.paged_decode_attn_ref.
//
// What it computes: for each slot, one query (H heads) attends to the KV
// rows its block table maps, plus the current token's own key/value,
// which has not been written to the pool yet and is folded in at the end
// as an always-valid key (so pos == 0 gives out == v_new).  Pool column c
// is valid iff c < pos, and with a window also c > pos - window; masked
// keys get exactly zero weight.  int8 pools carry one f32 scale per row
// and are dequantized inside the loop.
//
// Bound on the H100: bytes.  Each (slot, kv-head) reads its valid KV rows
// once (kvh * hd bytes per row and side for int8, twice that for bf16,
// plus 4-byte row scales) and does 4 * group * hd flops per row, far
// below the 295 flop/byte at which the tensor cores would bound it.  At
// the served shapes the bound is 0.2-17 us, so a launch is also bounded
// below by its latency: the first rows' table lookup and load, and the
// merge of the splits after the last one.
//
// Both routes split the block table across blocks (flash-decoding): the
// grid is (slot * kv-head, split), the number of splits a function of the
// table's width and the host-known shapes alone, never of pos (device
// data), so a CUDA graph replayed at new positions keeps its geometry.  A
// split whose columns lie wholly outside the valid (or windowed) range
// does no work.  Each split's partial (f32 sums of every query head of
// the group, and its (m, l)) goes to an f32 workspace; the last block of
// each (slot, kv-head) to arrive (fence, then an arrival counter in
// device memory that it resets) merges the partials in split order and
// folds in the new token.  No atomics on values: a repeat is bit for bit
// the same, and a launch is one kernel.  One layer of the pool is read in
// place: the caller passes that layer's base pointer and the stride
// between blocks, so the pool's (num_blocks, n_layers, bs, kvh, hd) layout
// is never copied.
//
// bf16 q (paged_decode_wg_kernel), built for the byte bound.  What held
// the CUDA-core kernel below at 4-33 % of it on bf16 q (traced by
// variants, tools/k1_ab.py --variants): the group's heads scored one after another on the CUDA
// cores, and a merge tail that recomputed the new token's score once an
// output element (27 of its 84 us at yi-34b).  The design:
// - splits sized to the card: a split is a whole number of 64-column
//   tiles, as few as fill the SMs' block slots once (three blocks an SM
//   below hd 256, two at it; the launch bounds), at most 64;
// - one producer warp and one consumer warpgroup a block.  The producer's
//   lanes read the split's table entries beside pos (one round trip),
//   then one thread issues every load: TMA boxes of one table block's
//   rows of one kv head (a 4-d tensor map over the pool slice, (hd, kvh,
//   bs, num_blocks) with the caller's block stride; the table entry is
//   the box's block coordinate), K and V, and for int8 pools each
//   block's row scales (a 2-d map), into a 2-stage ring with a full and
//   an empty mbarrier a stage (expect_tx completes a stage; deeper rings
//   measured no faster).  A box wholly outside the valid range is not
//   loaded;
// - products on the tensor cores, the whole GQA group in one pass over a
//   tile: S^T = K Q^T is wgmma m64nNk16 with the tile's 64 keys as the
//   64 rows and the group's query heads, padded to N = 8 or 16, as B
//   (K-major, in shared memory); its A, K, comes from registers: each
//   lane converts 16 contiguous int8 columns of its two rows at once into
//   mma fragments (the head dim read permuted, Q laid out in the same
//   order).  O^T += V^T P^T is m64nNk16 with V's rows read MN-major (A:
//   64 head-dim columns a product, converted to bf16 in the 128-byte
//   swizzled layout while S^T runs) and P^T (bf16, K-major) as B.  hd
//   16/32 ride hd 64's layout and hd 96 hd 128's, their padding zero.
//   mma.sync (the group as 16 rows) was not tried;
// - int8 exactly: int8 is exact in bf16, q enters unscaled (exact in
//   bf16); 1 / sqrt(hd) * k_scale[row] multiplies the f32 score,
//   v_scale[row] multiplies P before it is rounded to bf16, every sum is
//   f32; rows outside the valid range are selected out (never read into
//   a sum), so whatever a stage held there is harmless;
// - the softmax in registers: a thread holds 2 keys x N/4 heads of S^T;
//   the tile's max of each head comes from the warp's shuffles and the
//   four warps' maxima in shared memory; weights are ex2 of scores scaled
//   by log2(e); each thread keeps partial row sums, added once a split;
// - no divergent branch and no ring wait between a wgmma and its wait,
//   and register operands pinned before the fence: otherwise ptxas
//   inserts fences of its own and serializes the products (its C7520
//   warning; measured slower).  At hd 256 S^T runs in two halves of the
//   head dim, so the pinned fragments fit the two-block register budget;
// - one split: the block folds in the new token from its registers, no
//   workspace.  Several: the last block merges the splits' partials in
//   split order, eight a round of loads, and the new token's score is
//   computed once a query head (a warp a head, while the first tile
//   loads), not once an output element.
// Shared memory at hd 128 int8: 16 KB of converted V, Q, P^T, a 2-stage
// ring of 17 KB, about 55 KB in all.
//
// f32 q, or an f32 pool (paged_decode_split_kernel, kept on the CUDA
// cores for the f32 serving path's card == CPU greedy streams): splits of 128
// columns; inside a split, each of the 4 warps takes 16-column tiles (2 a
// split) with its own online softmax: it copies its tiles' K and V rows
// (each row found through the table, 16-byte cp.async chunks) into a
// two-slot ring of its own, so the next tile lands while the current one
// is scored, with no block-wide barrier.  Two lanes score a row (half the
// head dim each); the row weights reach every lane by shuffles, and lane
// d accumulates output column d.  The warps' (m, l, acc) merge in shared
// memory before the split's partial goes to the workspace.
//
// Interface: plain C, bound with ctypes; each entry returns
// cudaGetLastError() of its launch.  It launches on the caller's stream
// and allocates nothing: the wrapper passes the workspace and the
// counters, sized by its plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;                  // columns a warp scores at once
constexpr int kSplitCols = 128;            // columns a block

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared copies; the destination is zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const void* q;
  const void* k_blocks;
  const void* v_blocks;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* pos;
  const void* k_new;
  const void* v_new;
  void* out;
  float* ws;          // (slots * kvh, splits): group * hd acc, then (m, l)
  int* counters;      // slots * kvh, 0 between launches
  int slots, heads, kv_heads, head_dim, block_size, max_blocks;
  long long kv_stride, scale_stride;
  int window;
  float scale;
  int splits, stages;
};

// Shared memory, in the order the kernel lays it out: the pre-scaled
// query (group * hd f32), then for each warp its ring (stages slots of
// K rows, V rows, K scales, V scales) and its softmax state (m and l
// padded to 4 floats each, acc group * hd).
__host__ __device__ inline int slot_bytes(int hd, int esize) {
  return 2 * kTile * hd * esize + 2 * kTile * 4;
}
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int warp_bytes(int group, int hd, int esize,
                                          int stages) {
  return stages * slot_bytes(hd, esize) +
         4 * (2 * round4(group) + group * hd);
}
__host__ __device__ inline size_t smem_bytes(int group, int hd, int esize,
                                             int stages) {
  return 4 * (size_t)group * hd +
         (size_t)kWarps * warp_bytes(group, hd, esize, stages);
}

// the valid columns [lo, hi) of a slot at position p
__device__ __forceinline__ void valid_range(const Args& a, int p, int& lo,
                                            int& hi) {
  hi = min(p, a.max_blocks * a.block_size);
  lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
}

template <typename QT, typename KT, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(Args a) {
  const KT* __restrict__ kb = static_cast<const KT*>(a.k_blocks);
  const KT* __restrict__ vb = static_cast<const KT*>(a.v_blocks);
  const QT* __restrict__ q = static_cast<const QT*>(a.q);

  const int kvh = a.kv_heads, hd = a.head_dim, bs = a.block_size;
  const int sk = blockIdx.x, split = blockIdx.y;
  const int slot = sk / kvh, kh = sk % kvh;
  const int group = a.heads / kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_elems = kvh * hd;           // one pool row, all kv heads
  const int rowb = hd * (int)sizeof(KT);    // one head's row, bytes
  const int gh = group * hd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  unsigned char* wbase = smem_raw + 4 * gh +
                         warp * warp_bytes(group, hd, sizeof(KT), a.stages);
  const int sb = slot_bytes(hd, sizeof(KT));
  float* wm = reinterpret_cast<float*>(wbase + a.stages * sb);
  float* wl = wm + round4(group);
  float* wacc = wl + round4(group);

  const int p = a.pos[slot];
  int lo, hi;
  valid_range(a, p, lo, hi);
  const int s0 = split * kSplitCols;
  const int c_begin = max(s0, lo), c_end = min(s0 + kSplitCols, hi);
  const long long rec = (long long)sk * a.splits + split;
  const long long n_rec = (long long)a.slots * kvh * a.splits;

  // this warp's tiles: 16-column tiles t = warp, warp + 4, ... of the
  // split that hold a valid column
  int tiles[kSplitCols / kTile / kWarps];
  int n_tiles = 0;
  if (c_begin < c_end) {
    const int t_first = (c_begin - s0) / kTile;
    const int t_last = (c_end - 1 - s0) / kTile;
    for (int t = warp; t <= t_last; t += kWarps)
      if (t >= t_first) tiles[n_tiles++] = t;
  }
  const int chunks = rowb / 16;            // 16-byte chunks a row
  auto issue = [&](int n) {
    unsigned char* sl = wbase + (n % a.stages) * sb;
    const int c0 = s0 + tiles[n] * kTile;
    for (int i = lane; i < kTile * chunks; i += 32) {
      const int r = i / chunks, ch = i % chunks;
      const int col = c0 + r;
      const bool ok = col >= c_begin && col < c_end;
      long long off = 0;
      if (ok) {
        const long long bid =
            a.tables[(long long)slot * a.max_blocks + col / bs];
        off = bid * a.kv_stride + (long long)(col % bs) * row_elems +
              kh * hd;
      }
      cp_async16(sl + r * rowb + ch * 16,
                 reinterpret_cast<const unsigned char*>(kb + off) +
                     ch * 16, ok);
      cp_async16(sl + (kTile + r) * rowb + ch * 16,
                 reinterpret_cast<const unsigned char*>(vb + off) +
                     ch * 16, ok);
    }
    if (kScaled && lane < kTile) {
      const int col = c0 + lane;
      const bool ok = col >= c_begin && col < c_end;
      long long off = 0;
      if (ok)
        off = a.tables[(long long)slot * a.max_blocks + col / bs] *
                  a.scale_stride + col % bs;
      float* scl = reinterpret_cast<float*>(sl + 2 * kTile * rowb);
      cp_async4(scl + lane, a.k_scale + off, ok);
      cp_async4(scl + kTile + lane, a.v_scale + off, ok);
    }
  };
  // the first tiles' copies go out before the query is read
  const int pre = min(a.stages, n_tiles);
  for (int n = 0; n < pre; ++n) {
    issue(n);
    cp_async_commit();
  }
  const long long q_base = ((long long)slot * a.heads + kh * group) * hd;
  for (int i = tid; i < gh; i += kThreads)
    q_s[i] = to_float(q[q_base + i]) * a.scale;
  for (int i = lane; i < gh; i += 32) wacc[i] = 0.f;
  for (int g = lane; g < group; g += 32) {
    wm[g] = kNegInf;
    wl[g] = 0.f;
  }
  __syncthreads();

  const int r = lane >> 1, half = lane & 1;  // the lane's row and half
  const int hh = hd / 2;
  for (int n = 0; n < n_tiles; ++n) {
    if (n + 1 < n_tiles && a.stages > 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncwarp();
    const unsigned char* sl = wbase + (n % a.stages) * sb;
    const KT* k_t = reinterpret_cast<const KT*>(sl);
    const KT* v_t = reinterpret_cast<const KT*>(sl + kTile * rowb);
    const float* scl = reinterpret_cast<const float*>(sl + 2 * kTile * rowb);
    const int col = s0 + tiles[n] * kTile + r;
    const bool valid = col >= c_begin && col < c_end;
    const float ks = kScaled ? scl[r] : 1.f;
    const float vs = kScaled ? scl[kTile + r] : 1.f;

    for (int g = 0; g < group; ++g) {
      // score of row r: two lanes, half the head dim each, 8 bytes of
      // K at a time
      const float* qg = q_s + g * hd + half * hh;
      const KT* kr = k_t + r * hd + half * hh;
      constexpr int kE = 8 / sizeof(KT);
      float dot = 0.f;
      for (int u = 0; u < hh; u += kE) {
        const uint2 raw = *reinterpret_cast<const uint2*>(kr + u);
        const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
        for (int j = 0; j < kE; ++j) dot = fmaf(qg[u + j], to_float(e[j]), dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const float s = valid ? dot * ks : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off >= 2; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = wm[g];
      const float m_new = fmaxf(m_old, mx);
      // m_old == kNegInf gives corr == 0 once a valid key appears, and
      // corr == 1 while the sweep is still fully masked (acc is 0 then)
      const float corr = expf(m_old - m_new);
      const float pr = s == kNegInf ? 0.f : expf(s - m_new);
      float sum = half ? 0.f : pr;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // every lane gets every row's weight, times its V scale
      const float pv_own = pr * vs;
      float pv[kTile];
#pragma unroll
      for (int rr = 0; rr < kTile; ++rr)
        pv[rr] = __shfl_sync(0xffffffffu, pv_own, 2 * rr);
      for (int d = lane; d < hd; d += 32) {
        float acc = wacc[g * hd + d] * corr;
#pragma unroll
        for (int rr = 0; rr < kTile; ++rr)
          acc = fmaf(pv[rr], to_float(v_t[rr * hd + d]), acc);
        wacc[g * hd + d] = acc;
      }
      __syncwarp();                          // every lane read wm, wl
      if (lane == 0) {
        wm[g] = m_new;
        wl[g] = wl[g] * corr + sum;
      }
      __syncwarp();
    }
    __syncwarp();                            // the slot is free
    if (n + a.stages < n_tiles) {
      issue(n + a.stages);
      cp_async_commit();
    }
  }

  // merge the warps in order; the split's partial to the workspace
  __syncthreads();
  if (c_begin < c_end) {
    const unsigned char* base0 = smem_raw + 4 * gh;
    const int wb = warp_bytes(group, hd, sizeof(KT), a.stages);
    for (int i = tid; i < gh; i += kThreads) {
      const int g = i / hd;
      float m = kNegInf;
      for (int w = 0; w < kWarps; ++w) {
        const float* m_w = reinterpret_cast<const float*>(
            base0 + w * wb + a.stages * sb);
        m = fmaxf(m, m_w[g]);
      }
      float l = 0.f, acc = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float* m_w = reinterpret_cast<const float*>(
            base0 + w * wb + a.stages * sb);
        const float e = expf(m_w[g] - m);
        l = fmaf(m_w[round4(group) + g], e, l);
        acc = fmaf(m_w[2 * round4(group) + i], e, acc);
      }
      a.ws[rec * gh + i] = acc;
      if (i % hd == 0) {
        float* ml = a.ws + n_rec * gh + (rec * group + g) * 2;
        ml[0] = m;
        ml[1] = l;
      }
    }
  }

  // arrive; the last block of this (slot, kv-head) merges the splits
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(a.counters + sk, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  const QT* __restrict__ kn = static_cast<const QT*>(a.k_new);
  const QT* __restrict__ vn = static_cast<const QT*>(a.v_new);
  QT* __restrict__ out = static_cast<QT*>(a.out);
  const long long kv_base = ((long long)slot * kvh + kh) * hd;
  const long long rec0 = (long long)sk * a.splits;
  // the splits that hold a valid column, in order
  const int sp_begin = lo / kSplitCols;
  const int sp_end = hi > lo ? (hi - 1) / kSplitCols + 1 : sp_begin;
  constexpr int kBatch = 8;                  // splits' loads in flight
  for (int i = tid; i < gh; i += kThreads) {
    const int g = i / hd, d = i % hd;
    // the current token's KV: always valid, so the denominator is >= 1.
    // v_new is indexed by this block's kv head, never by the query head.
    float sn = 0.f;
    for (int e = 0; e < hd; ++e)
      sn = fmaf(q_s[g * hd + e], to_float(kn[kv_base + e]), sn);
    const float* mlg = a.ws + n_rec * gh + (rec0 * group + g) * 2;
    float m = sn;
    for (int sp0 = sp_begin; sp0 < sp_end; sp0 += kBatch) {
      float mv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        mv[j] = sp0 + j < sp_end ? __ldcg(mlg + (sp0 + j) * group * 2)
                                 : kNegInf;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) m = fmaxf(m, mv[j]);
    }
    float num = 0.f, den = 0.f;
    for (int sp0 = sp_begin; sp0 < sp_end; sp0 += kBatch) {
      float mv[kBatch], lv[kBatch], av[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int sp = sp0 + j;
        if (sp < sp_end) {
          mv[j] = __ldcg(mlg + sp * group * 2);
          lv[j] = __ldcg(mlg + sp * group * 2 + 1);
          av[j] = __ldcg(a.ws + (rec0 + sp) * gh + i);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (sp0 + j < sp_end) {
          const float e = expf(mv[j] - m);
          num = fmaf(av[j], e, num);
          den = fmaf(lv[j], e, den);
        }
      }
    }
    const float pn = expf(sn - m);
    num = fmaf(pn, to_float(vn[kv_base + d]), num);
    den += pn;
    out[((long long)slot * a.heads + kh * group) * hd + i] =
        from_float<QT>(num / fmaxf(den, 1e-30f));
  }
  if (tid == 0) a.counters[sk] = 0;          // ready for the next launch
}

template <typename QT, typename KT, bool kScaled>
cudaError_t launch(const Args& a, size_t bytes, cudaStream_t stream) {
  auto kernel = paged_decode_split_kernel<QT, KT, kScaled>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.slots * a.kv_heads, a.splits), kThreads, bytes, stream>>>(
      a);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const Args& a, size_t bytes,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch<QT, float, false>(a, bytes, stream);
    case kBF16: return launch<QT, __nv_bfloat16, false>(a, bytes, stream);
    case kI8: return launch<QT, int8_t, true>(a, bytes, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------- bf16 q on the tensor cores --
namespace wg {
using namespace hopper;

constexpr int kTile = 64;          // pool columns a tile: wgmma's 64 rows
constexpr int kThreads = 160;      // a consumer warpgroup + a producer warp
constexpr int kScaleSlot = 128;    // bytes a box of row scales takes
constexpr int kMaxGroup = 16;      // query heads a kv head: N <= 16
constexpr int kMaxSplits = 64;     // splits a table at most (decode_plan)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte aligned base, in this order: the
// converted V tile (hdp / 64 blocks of 64 rows x 128 bytes, swizzled), Q
// (hdp / 64 blocks of N rows x 128 bytes, its columns permuted as the
// K fragments read them), P^T (N rows x 128 bytes), the ring's stages
// (K's rows, V's rows, then for int8 pools `pieces` 128-byte slots of K
// scales and of V scales), the full and empty barriers, the warps'
// maxima and row sums (4 x N f32 each), the new token's scores (16 f32),
// the last-block flag, the table entries.  decode_plan in
// kernels/paged_decode_attn.py mirrors it.
struct Layout {
  int vc, qs, pt, raw, stage, bars, red, lred, sn, flag, tbl, total;
};
__host__ __device__ inline Layout layout(int hdp, int n, int hd, int esize,
                                         int scaled, int pieces, int stages,
                                         int entries) {
  Layout l;
  l.vc = 0;
  l.qs = l.vc + hdp * 128;
  l.pt = l.qs + (hdp / 64) * n * 128;
  l.raw = l.pt + n * 128;
  l.stage = 2 * kTile * hd * esize + (scaled ? 2 * pieces * kScaleSlot : 0);
  l.stage = (l.stage + 127) / 128 * 128;
  l.bars = l.raw + stages * l.stage;
  l.red = l.bars + 16 * stages;
  l.lred = l.red + 16 * n;
  l.sn = l.lred + 16 * n;
  l.flag = l.sn + 4 * kMaxGroup;
  l.tbl = l.flag + 16;
  l.total = 1024 + l.tbl + 4 * entries;
  return l;
}

struct Args {
  const bf16* q;
  const int* tables;
  const int* pos;
  const bf16* k_new;
  const bf16* v_new;
  bf16* out;
  float* ws;          // (slots * kvh, splits): group * hd acc, then (m, l)
  int* counters;      // slots * kvh, 0 between launches
  int slots, heads, kv_heads, head_dim, block_size, max_blocks;
  int window;
  float scale_log2;   // 1 / sqrt(hd) * log2(e)
  int splits, split_cols, stages, rows, pieces, entries;
};

// two int8 of a word (bytes 2 h, 2 h + 1) as a bf16 pair, exactly: the
// byte, biased to unsigned, becomes the low mantissa byte of 2^23 + u
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, int h) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + 2 * h)) -
      8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651 + 2 * h)) -
      8388736.f;
  return pack_bf16(f0, f1);
}
// 8 landed elements of a row: loaded, then as 8 bf16 (one 16-byte chunk)
template <typename KT>
struct Raw;
template <>
struct Raw<int8_t> {
  typedef uint2 T;
  static __device__ __forceinline__ T load(const unsigned char* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ uint4 to_bf16(T w) {
    return make_uint4(i8_pair(w.x, 0), i8_pair(w.x, 1), i8_pair(w.y, 0),
                      i8_pair(w.y, 1));
  }
};
template <>
struct Raw<bf16> {
  typedef uint4 T;
  static __device__ __forceinline__ T load(const unsigned char* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ uint4 to_bf16(T w) { return w; }
};

// The K fragments of one 64-column block J of the head dim: wgmma's A
// operand from registers, the rows key0 and key0 + 8 of the tile.  The
// head dim is read permuted: k-step 4 J + u of quad lane t takes columns
// 64 J + 16 t + 4 u + {0, 1} (a0, a1) and + {2, 3} (a2, a3), so a lane
// reads 16 contiguous columns of a row at once; Q's columns are laid out
// in shared memory in the same order (q_column), and the dot products
// are unchanged.  Columns past hd are zero.  Every load is made whatever
// its column and row (a read past a row lands inside the stage), and
// what lies outside is set apart by selects: no divergent branch may
// stand between a wgmma and its wait, or ptxas serializes the products.
template <typename KT>
__device__ __forceinline__ void k_frags(uint32_t (*a)[4],
                                        const unsigned char* k0,
                                        const unsigned char* k1, int hd,
                                        int j, int t);
template <>
__device__ __forceinline__ void k_frags<int8_t>(uint32_t (*a)[4],
                                                const unsigned char* k0,
                                                const unsigned char* k1,
                                                int hd, int j, int t) {
  // loaded whatever c (a row past hd reads its neighbour, inside the
  // stage), then zeroed past hd by a select: no divergent branch
  const int c = 64 * j + 16 * t;
  const uint4 r0 = *reinterpret_cast<const uint4*>(k0 + c);
  const uint4 r1 = *reinterpret_cast<const uint4*>(k1 + c);
  const uint32_t z = c < hd ? 0xffffffffu : 0u;
  const uint32_t w0[4] = {r0.x & z, r0.y & z, r0.z & z, r0.w & z};
  const uint32_t w1[4] = {r1.x & z, r1.y & z, r1.z & z, r1.w & z};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    a[u][0] = i8_pair(w0[u], 0);
    a[u][1] = i8_pair(w1[u], 0);
    a[u][2] = i8_pair(w0[u], 1);
    a[u][3] = i8_pair(w1[u], 1);
  }
}
template <>
__device__ __forceinline__ void k_frags<bf16>(uint32_t (*a)[4],
                                              const unsigned char* k0,
                                              const unsigned char* k1,
                                              int hd, int j, int t) {
  const int c = 64 * j + 16 * t;
  uint4 r0[2], r1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r0[h] = *reinterpret_cast<const uint4*>(k0 + 2 * c + 16 * h);
    r1[h] = *reinterpret_cast<const uint4*>(k1 + 2 * c + 16 * h);
  }
  const uint32_t z = c < hd ? 0xffffffffu : 0u;
  const uint32_t w0[8] = {r0[0].x & z, r0[0].y & z, r0[0].z & z, r0[0].w & z,
                          r0[1].x & z, r0[1].y & z, r0[1].z & z, r0[1].w & z};
  const uint32_t w1[8] = {r1[0].x & z, r1[0].y & z, r1[0].z & z, r1[0].w & z,
                          r1[1].x & z, r1[1].y & z, r1[1].z & z, r1[1].w & z};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    a[u][0] = w0[2 * u];
    a[u][1] = w1[2 * u];
    a[u][2] = w0[2 * u + 1];
    a[u][3] = w1[2 * u + 1];
  }
}
// the head-dim column that position p of Q's shared rows holds (k-step
// p / 16, its column c = p % 16: quad lane (c % 8) / 2, half c / 8)
__device__ __forceinline__ int q_column(int p) {
  const int kk = p >> 4, c = p & 15;
  return 64 * (kk >> 2) + 16 * ((c & 7) >> 1) + 4 * (kk & 3) +
         2 * (c >> 3) + (c & 1);
}

// the query head of accumulator value e of this thread (quad lane t): the
// n-block e / 4, its columns 2 t and 2 t + 1
__device__ __forceinline__ int head_of(int e, int t) {
  return 8 * (e >> 2) + 2 * t + (e & 1);
}
// ... and of its head slot hs = 2 (e / 4) + e % 2
__device__ __forceinline__ int head_of_slot(int hs, int t) {
  return 8 * (hs >> 1) + 2 * t + (hs & 1);
}

// three blocks an SM below hd 256, two at it (registers; decode_plan
// sizes the splits to these)
template <int HDP, int N, typename KT>
__global__ void __launch_bounds__(kThreads, HDP == 256 ? 2 : 3)
    paged_decode_wg_kernel(const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_ks,
                           const __grid_constant__ CUtensorMap tm_vs,
                           Args a) {
  constexpr bool kScaled = sizeof(KT) == 1;
  constexpr int kES = sizeof(KT);
  constexpr int kCB = HDP / 64;            // 64-column blocks of a row
  constexpr int kHS = N / 4;               // head slots of a thread
  const int hd = a.head_dim, kvh = a.kv_heads, bs = a.block_size;
  const int group = a.heads / kvh;
  const int sk = blockIdx.x, split = blockIdx.y;
  const int slot = sk / kvh, kh = sk % kvh;
  const int tid = threadIdx.x;
  const Layout L = layout(HDP, N, hd, kES, kScaled, a.pieces, a.stages,
                          a.entries);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* vc = smem + L.vc;
  unsigned char* qs = smem + L.qs;
  unsigned char* pt = smem + L.pt;
  unsigned char* raw = smem + L.raw;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + a.stages;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* lred = reinterpret_cast<float*>(smem + L.lred);
  float* sn = reinterpret_cast<float*>(smem + L.sn);
  volatile int* flag = reinterpret_cast<volatile int*>(smem + L.flag);
  int* tbl = reinterpret_cast<int*>(smem + L.tbl);

  const int p = a.pos[slot];
  const int s0 = split * a.split_cols;
  // the producer warp reads the split's table entries beside pos (one
  // round trip for both)
  const int b0 = s0 / bs;
  if (tid >= 128) {
    const int b1 = min((s0 + a.split_cols - 1) / bs, a.max_blocks - 1);
    const int* trow = a.tables + (long long)slot * a.max_blocks;
    for (int i = tid - 128; i <= b1 - b0; i += 32) tbl[i] = trow[b0 + i];
  }
  // the slot's valid columns [lo, hi); this split's [c_begin, c_end), in
  // tiles t_first .. t_first + n_tiles - 1 of the split
  const int hi = min(p, a.max_blocks * bs);
  const int lo = a.window > 0 ? max(0, p - a.window + 1) : 0;
  const int c_begin = max(s0, lo), c_end = min(s0 + a.split_cols, hi);
  int t_first = 0, n_tiles = 0;
  if (c_begin < c_end) {
    t_first = (c_begin - s0) / kTile;
    n_tiles = (c_end - 1 - s0) / kTile - t_first + 1;
  }
  const int col_base = s0 + t_first * kTile;   // the first tile's column
  const long long rec = (long long)sk * a.splits + split;
  const long long n_rec = (long long)a.slots * kvh * a.splits;
  const int gh = group * hd;
  const int tile_bytes = kTile * hd * kES;     // K's (or V's) rows
  const int piece_bytes = a.rows * hd * kES;   // one box of them

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);               // one arrival a consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer: one thread issues every load.  A fresh barrier's
    // previous phase counts as complete, so each first wait on an empty
    // stage passes.
    if (n_tiles == 0 || tid != 128) return;
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    if (kScaled) {
      tma_prefetch(&tm_ks);
      tma_prefetch(&tm_vs);
    }
    const int box_bytes =
        2 * piece_bytes + (kScaled ? 2 * a.rows * 4 : 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % a.stages;
      const int c0 = col_base + n * kTile;
      // the boxes (runs of `rows` columns in one table block) that hold a
      // valid column
      const int pc_first = (max(c_begin, c0) - c0) / a.rows;
      const int pc_last = (min(c_end, c0 + kTile) - 1 - c0) / a.rows;
      mbar_wait(&empty[s], ((n / a.stages) & 1) ^ 1);
      mbar_expect_tx(&full[s], (pc_last - pc_first + 1) * box_bytes);
      unsigned char* st = raw + s * L.stage;
      for (int pc = pc_first; pc <= pc_last; ++pc) {
        const int col = c0 + pc * a.rows;
        const int blk = tbl[col / bs - b0];
        const int r = col % bs;
        tma_load_4d(st + pc * piece_bytes, &tm_k, &full[s], 0, kh, r, blk);
        tma_load_4d(st + tile_bytes + pc * piece_bytes, &tm_v, &full[s], 0,
                    kh, r, blk);
        if (kScaled) {
          unsigned char* sc = st + 2 * tile_bytes;
          tma_load_2d(sc + pc * kScaleSlot, &tm_ks, &full[s], r, blk);
          tma_load_2d(sc + (a.pieces + pc) * kScaleSlot, &tm_vs, &full[s],
                      r, blk);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = 16 * warp + g;      // this thread's keys: key0, key0 + 8
  const bf16* qg = a.q + ((long long)slot * a.heads + kh * group) * hd;
  const bf16* kn = a.k_new + ((long long)slot * kvh + kh) * hd;
  const bf16* vn = a.v_new + ((long long)slot * kvh + kh) * hd;
  // the new token's score of each query head, in log2 units: a warp a
  // head (read by every consumer after the next barrier)
  auto new_token_scores = [&]() {
    for (int h = warp; h < group; h += 4) {
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32)
        dot = fmaf(__bfloat162float(qg[h * hd + d]),
                   __bfloat162float(kn[d]), dot);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) sn[h] = dot * a.scale_log2;
    }
  };
  if (n_tiles > 0) {
    // Q, unscaled, K-major and swizzled, its columns in the K fragments'
    // order (rows past the group and columns past hd zero), and the new
    // token's scores, while the first tile loads; a block with no valid
    // column skips both
    for (int i = tid; i < N * HDP; i += 128) {
      const int row = i / HDP, pcol = i % HDP, col = q_column(pcol);
      const bf16 v = row < group && col < hd ? qg[row * hd + col]
                                             : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(qs + (pcol >> 6) * (N * 128) +
                               swz(row, (pcol & 63) >> 3) + (pcol & 7) * 2) =
          v;
    }
    new_token_scores();
  }
  float o[kCB][N / 2];
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) o[cb][e] = 0.f;
  float m[kHS], l[kHS];
#pragma unroll
  for (int hs = 0; hs < kHS; ++hs) {
    m[hs] = kNegInf;
    l[hs] = 0.f;
  }
  // descriptors: the start address field takes byte offsets / 16
  const uint64_t dv = wgmma_desc(vc, 16, 1024);
  const uint64_t dq = wgmma_desc(qs, 16, 1024);
  const uint64_t dp = wgmma_desc(pt, 16, 1024);

  // Each tile: S^T = K Q^T issued from registers, V converted while it
  // runs; then the softmax, and O^T += V^T P^T.
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % a.stages;
    const int c0 = col_base + n * kTile;
    const unsigned char* st = raw + s * L.stage;
    mbar_wait(&full[s], (n / a.stages) & 1);
    // S^T = K Q^T in kParts parts of the head dim (two at hd 256, one
    // below), each part's K fragments converted into the same registers,
    // pinned before the fence (so ptxas inserts no fence of its own
    // between the products, which would serialize them) and its products
    // issued; a part's products run while a share of V is converted.  One
    // accumulator a 64-column block, so consecutive k-steps do not wait
    // on each other; summed in block order.
    constexpr int kParts = HDP == 256 ? 2 : 1, kCBP = kCB / kParts;
    constexpr int kIters = kTile * (HDP / 8) / 128, kRun = 4;
    float sacc[kCB][N / 2];
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      uint32_t af[4 * kCBP][4];
#pragma unroll
      for (int j = 0; j < kCBP; ++j)
        k_frags<KT>(af + 4 * j, st + key0 * hd * kES,
                    st + (key0 + 8) * hd * kES, hd, part * kCBP + j, t);
#pragma unroll
      for (int j = 0; j < kCBP; ++j) {
#pragma unroll
        for (int e = 0; e < N / 2; ++e) sacc[part * kCBP + j][e] = 0.f;
        fence_regs(sacc[part * kCBP + j], N / 2);
      }
      fence_regs(&af[0][0], 16 * kCBP);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < kCBP; ++j)
          wgmma_k_rs<N>(sacc[part * kCBP + j], af[4 * j + u],
                        dq + (((part * kCBP + j) * (N * 128) + u * 32) >> 4),
                        1);
      wgmma_commit();
      // every warp's last products are done: V's and P^T's buffers free
      if (part == 0) named_bar_sync(1, 128);
      // this part's share of the landed V tile to bf16 in the products'
      // layout, rows outside the valid range as zeros: 4 chunks' loads at
      // a time before their conversions and stores (the compiler cannot
      // move a load above a store to shared memory)
#pragma unroll
      for (int i0 = part * kIters / kParts; i0 < (part + 1) * kIters / kParts;
           i0 += kRun) {
        typename Raw<KT>::T rv[kRun];
        bool ok[kRun];
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const int i = tid + 128 * (i0 + u);
          const int row = i / (HDP / 8), ch = i % (HDP / 8), col = c0 + row;
          ok[u] = col >= c_begin && col < c_end && ch * 8 < hd;
          rv[u] = Raw<KT>::load(st + tile_bytes + (row * hd + ch * 8) * kES);
        }
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const int i = tid + 128 * (i0 + u);
          const int row = i / (HDP / 8), ch = i % (HDP / 8);
          *reinterpret_cast<uint4*>(vc + (ch >> 3) * (kTile * 128) +
                                    swz(row, ch & 7)) =
              ok[u] ? Raw<KT>::to_bf16(rv[u]) : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if (part + 1 < kParts) {
        wgmma_wait<0>();         // the part's products: its fragments free
#pragma unroll
        for (int j = 0; j < kCBP; ++j) fence_regs(sacc[part * kCBP + j], N / 2);
      }
    }
    // this thread's keys: valid or not, K's scale on the log2 score, V's
    bool kval[2];
    float ksl[2], vsc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r, col = c0 + key;
      kval[r] = col >= c_begin && col < c_end;
      ksl[r] = a.scale_log2;
      vsc[r] = 1.f;
      if (kScaled) {           // read whatever the row, then selected
        const float* sc = reinterpret_cast<const float*>(st + 2 * tile_bytes);
        const int pc = key / a.rows, pr = key % a.rows;
        const float ks = sc[pc * 32 + pr], vs = sc[(a.pieces + pc) * 32 + pr];
        ksl[r] = kval[r] ? ks * a.scale_log2 : 0.f;
        vsc[r] = kval[r] ? vs : 0.f;
      }
    }
    fence_proxy_async();
    wgmma_wait<0>();             // S^T
    // this warp's reads of the stage are done (the barriers below order
    // V's conversion before the products that read it)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // the stage may take a tile
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) fence_regs(sacc[cb], N / 2);
#pragma unroll
    for (int cb = 1; cb < kCB; ++cb)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) sacc[0][e] += sacc[cb][e];

    // the tile's max of each head: the warp's 8 row groups by shuffles,
    // then the four warps' through shared memory (rows outside the valid
    // range, whatever their K, are set apart by the select)
    float x[N / 2], mt[kHS];
#pragma unroll
    for (int hs = 0; hs < kHS; ++hs) mt[hs] = kNegInf;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int r = (e >> 1) & 1, hs = 2 * (e >> 2) + (e & 1);
      x[e] = kval[r] ? sacc[0][e] * ksl[r] : kNegInf;
      mt[hs] = fmaxf(mt[hs], x[e]);
    }
#pragma unroll
    for (int hs = 0; hs < kHS; ++hs) {
      mt[hs] = fmaxf(mt[hs], __shfl_xor_sync(0xffffffffu, mt[hs], 4));
      mt[hs] = fmaxf(mt[hs], __shfl_xor_sync(0xffffffffu, mt[hs], 8));
      mt[hs] = fmaxf(mt[hs], __shfl_xor_sync(0xffffffffu, mt[hs], 16));
    }
    if (g == 0) {
#pragma unroll
      for (int hs = 0; hs < kHS; ++hs)
        red[warp * N + head_of_slot(hs, t)] = mt[hs];
    }
    named_bar_sync(1, 128);
    float corr[kHS], psum[kHS];
#pragma unroll
    for (int hs = 0; hs < kHS; ++hs) {
      const int h = head_of_slot(hs, t);
      const float tm = fmaxf(fmaxf(red[h], red[N + h]),
                             fmaxf(red[2 * N + h], red[3 * N + h]));
      const float mn = fmaxf(m[hs], tm);
      // a tile holds a valid key, so mn is finite; the first tile's
      // rescale of the sentinel is ex2(-huge) == 0
      corr[hs] = mn == m[hs] ? 1.f : ex2(m[hs] - mn);
      m[hs] = mn;
      psum[hs] = 0.f;
    }
    // P = ex2(S - m); P^T * v_scale to shared memory in bf16, K-major
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int r = (e >> 1) & 1, hs = 2 * (e >> 2) + (e & 1);
      const float pe = kval[r] ? ex2(x[e] - m[hs]) : 0.f;
      psum[hs] += pe;
      const int key = key0 + 8 * r;
      *reinterpret_cast<bf16*>(pt + swz(head_of(e, t), key >> 3) +
                               (key & 7) * 2) = __float2bfloat16(pe * vsc[r]);
    }
#pragma unroll
    for (int hs = 0; hs < kHS; ++hs) l[hs] = fmaf(l[hs], corr[hs], psum[hs]);
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int e = 0; e < N / 2; ++e)
        o[cb][e] *= corr[2 * (e >> 2) + (e & 1)];
    fence_proxy_async();
    named_bar_sync(1, 128);

    // O^T += V^T P^T: hd rows (64 a product) x N heads; A = V's rows
    // MN-major, a k-step 16 rows of 128 bytes; B = P^T K-major
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) fence_regs(o[cb], N / 2);
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_mn<N>(o[cb], dv + ((cb * (kTile * 128) + kk * 16 * 128) >> 4),
                    dp + ((kk * 32) >> 4), 1);
    wgmma_commit();
    // waited here, not over the next tile's ring wait: a wgmma in flight
    // across that polling loop (a divergent path to ptxas) gets its
    // products serialized
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) fence_regs(o[cb], N / 2);
  }

  // the row sums of the split: the warp's 8 row groups, then the warps'
  if (n_tiles == 0 && a.splits == 1) new_token_scores();
  if (n_tiles > 0) {
#pragma unroll
    for (int hs = 0; hs < kHS; ++hs) {
      l[hs] += __shfl_xor_sync(0xffffffffu, l[hs], 4);
      l[hs] += __shfl_xor_sync(0xffffffffu, l[hs], 8);
      l[hs] += __shfl_xor_sync(0xffffffffu, l[hs], 16);
    }
    if (g == 0) {
#pragma unroll
      for (int hs = 0; hs < kHS; ++hs)
        lred[warp * N + head_of_slot(hs, t)] = l[hs];
    }
  }
  named_bar_sync(1, 128);        // lred, and sn for every warp
  bf16* out = a.out + ((long long)slot * a.heads + kh * group) * hd;
  if (a.splits == 1) {
    // one split: the block folds in the new token from its registers
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) {
        const int h = head_of(e, t), hs = 2 * (e >> 2) + (e & 1);
        const int d = 64 * cb + key0 + 8 * ((e >> 1) & 1);
        if (h < group && d < hd) {
          const float lt = n_tiles > 0 ? lred[h] + lred[N + h] +
                                             lred[2 * N + h] + lred[3 * N + h]
                                       : 0.f;
          const float mx = fmaxf(m[hs], sn[h]);
          const float e1 = exp2f(m[hs] - mx), pn = exp2f(sn[h] - mx);
          const float num = fmaf(pn, __bfloat162float(vn[d]), o[cb][e] * e1);
          const float den = fmaf(lt, e1, pn);
          out[h * hd + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
        }
      }
    return;
  }

  // the split's partial to the workspace: O^T, the max and the row sums
  if (n_tiles > 0) {
    float* wsr = a.ws + rec * gh;
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) {
        const int h = head_of(e, t);
        const int d = 64 * cb + key0 + 8 * ((e >> 1) & 1);
        if (h < group && d < hd) wsr[h * hd + d] = o[cb][e];
      }
    if (warp == 0 && g == 0) {
#pragma unroll
      for (int hs = 0; hs < kHS; ++hs) {
        const int h = head_of_slot(hs, t);
        if (h < group) {
          float* ml = a.ws + n_rec * gh + (rec * group + h) * 2;
          ml[0] = m[hs];
          ml[1] = lred[h] + lred[N + h] + lred[2 * N + h] + lred[3 * N + h];
        }
      }
    }
  }

  // arrive; the last block of this (slot, kv-head) merges the splits
  __threadfence();
  named_bar_sync(1, 128);
  if (tid == 0) *flag = atomicAdd(a.counters + sk, 1) == a.splits - 1;
  named_bar_sync(1, 128);
  if (!*flag) return;
  __threadfence();
  if (n_tiles == 0) {            // the new token's scores, not made yet
    new_token_scores();
    named_bar_sync(1, 128);
  }

  const long long rec0 = (long long)sk * a.splits;
  // the splits that hold a valid column, in order
  const int sp_begin = lo / a.split_cols;
  const int sp_end = hi > lo ? (hi - 1) / a.split_cols + 1 : sp_begin;
  const int n_sp = sp_end - sp_begin;
  // each 4 outputs: the splits' sums in split order, 8 splits a round of
  // loads (the maxima, row sums and sums at once), the running max and
  // sums rescaled a round, then the new token folded in
  const float* wsr0 = a.ws + (rec0 + sp_begin) * gh;
  for (int i = 4 * tid; i < gh; i += 4 * 128) {
    const int h = i / hd, d = i % hd;
    const float* mlg = a.ws + n_rec * gh + ((rec0 + sp_begin) * group + h) * 2;
    float mx = sn[h], den = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sp0 = 0; sp0 < n_sp; sp0 += 8) {
      float mv[8], lv[8];
      float4 av[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mv[j] = kNegInf;
        lv[j] = 0.f;
        av[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (sp0 + j < n_sp) {
          mv[j] = __ldcg(mlg + (sp0 + j) * group * 2);
          lv[j] = __ldcg(mlg + (sp0 + j) * group * 2 + 1);
          av[j] = __ldcg(reinterpret_cast<const float4*>(
              wsr0 + (long long)(sp0 + j) * gh + i));
        }
      }
      float bm = mx;
#pragma unroll
      for (int j = 0; j < 8; ++j) bm = fmaxf(bm, mv[j]);
      const float c = exp2f(mx - bm);
      den *= c;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] *= c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = exp2f(mv[j] - bm);   // 0 past n_sp
        den = fmaf(lv[j], e, den);
        acc[0] = fmaf(av[j].x, e, acc[0]);
        acc[1] = fmaf(av[j].y, e, acc[1]);
        acc[2] = fmaf(av[j].z, e, acc[2]);
        acc[3] = fmaf(av[j].w, e, acc[3]);
      }
      mx = bm;
    }
    // the current token's key: always valid, so the denominator is >= 1
    const float pn = exp2f(sn[h] - mx);
    const float inv = 1.f / (den + pn);
    float r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r[q] = fmaf(pn, __bfloat162float(vn[d + q]), acc[q]) * inv;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + i);
    o2[0] = __floats2bfloat162_rn(r[0], r[1]);
    o2[1] = __floats2bfloat162_rn(r[2], r[3]);
  }
  if (tid == 0) a.counters[sk] = 0;          // ready for the next launch
}

// One map from the wrapper's numbers (tma_numbers in
// kernels/paged_decode_attn.py).  4-d (the pool slice): dims (hd, kvh,
// bs, num_blocks), the byte strides of kvh, bs and num_blocks, the box
// (hd columns, `rows` rows) of one kv head; 2-d (row scales): dims (bs,
// num_blocks), the byte stride of num_blocks, a box of `rows` scales.
// No swizzle: the consumers convert the landed rows into the products'
// swizzled layout.
bool encode_4d(CUtensorMap* map, const void* base, const long long* p,
               CUtensorMapDataType dtype) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4] = {(cuuint32_t)p[7], 1, (cuuint32_t)p[8], 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)p[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)p[4 + i];
  return fn(map, dtype, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
bool encode_2d(CUtensorMap* map, const void* base, const long long* p) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)p[0], (cuuint64_t)p[1]};
  cuuint64_t strides[1] = {(cuuint64_t)p[2]};
  cuuint32_t box[2] = {(cuuint32_t)p[3], 1};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, int N, typename KT>
cudaError_t launch(const CUtensorMap* maps, const Args& a, int smem,
                   cudaStream_t stream) {
  auto kernel = paged_decode_wg_kernel<HDP, N, KT>;
  // the shared memory attribute, once a device: it holds for later
  // launches (the largest a plan can ask for)
  static unsigned long long attr_set = 0;    // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    attr_set |= bit;
  }
  kernel<<<dim3(a.slots * a.kv_heads, a.splits), kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t dispatch(int hdp, int n, const CUtensorMap* maps, const Args& a,
                     int smem, cudaStream_t stream) {
  if (n == 8) {
    switch (hdp) {
      case 64: return launch<64, 8, KT>(maps, a, smem, stream);
      case 128: return launch<128, 8, KT>(maps, a, smem, stream);
      case 256: return launch<256, 8, KT>(maps, a, smem, stream);
    }
  } else if (n == 16) {
    switch (hdp) {
      case 64: return launch<64, 16, KT>(maps, a, smem, stream);
      case 128: return launch<128, 16, KT>(maps, a, smem, stream);
      case 256: return launch<256, 16, KT>(maps, a, smem, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

extern "C" int paged_decode_attn(
    const void* q, const void* k_blocks, const void* v_blocks,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos, const void* k_new, const void* v_new, void* out,
    void* ws, void* counters, int slots, int heads, int kv_heads,
    int head_dim, int block_size, int max_blocks, long long kv_block_stride,
    long long scale_block_stride, int window, float scale, int splits,
    int stages, long long smem, int q_dtype, int kv_dtype, void* stream) {
  if (slots == 0) return cudaSuccess;
  const int esize = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
  const int group = kv_heads > 0 ? heads / kv_heads : 0;
  // the plan's geometry, checked against what this kernel lays out
  if (group < 1 || head_dim < 1 || (head_dim * esize) % 16 ||
      block_size < 1 || max_blocks < 1 || stages < 1 || stages > 2 ||
      splits != (max_blocks * block_size + kSplitCols - 1) / kSplitCols ||
      (long long)slots * kv_heads > 0x7fffffffLL || splits > 65535 ||
      smem != (long long)smem_bytes(group, head_dim, esize, stages))
    return cudaErrorInvalidValue;
  Args a{q, k_blocks, v_blocks,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(tables), static_cast<const int*>(pos),
         k_new, v_new, out, static_cast<float*>(ws),
         static_cast<int*>(counters),
         slots, heads, kv_heads, head_dim, block_size, max_blocks,
         kv_block_stride, scale_block_stride, window, scale, splits, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // f32 q over any pool; bf16 q only over an f32 pool (bf16 q over int8
  // and bf16 pools takes paged_decode_attn_wg)
  if (q_dtype == kF32) return dispatch_kv<float>(kv_dtype, a, (size_t)smem, s);
  if (q_dtype == kBF16 && kv_dtype == kF32)
    return launch<__nv_bfloat16, float, false>(a, (size_t)smem, s);
  return cudaErrorInvalidValue;
}

// The bf16-q route.  plan: splits, split_cols, stages, smem, n, hd_pad,
// rows, pieces, entries (decode_plan); maps: the 4-d maps of k_blocks and
// v_blocks, 9 numbers each, then the 2-d maps of k_scale and v_scale, 4
// each (tma_numbers; zeros for a bf16 pool).  The entry checks the plan
// against what the kernel lays out and refuses any other.
extern "C" int paged_decode_attn_wg(
    const void* q, const void* k_blocks, const void* v_blocks,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos, const void* k_new, const void* v_new, void* out,
    void* ws, void* counters, int slots, int heads, int kv_heads,
    int head_dim, int block_size, int max_blocks, int window, float scale,
    const int* plan, const long long* maps, int kv_dtype, void* stream) {
  if (slots == 0) return cudaSuccess;
  const int splits = plan[0], split_cols = plan[1], stages = plan[2];
  const int smem = plan[3], n = plan[4], hdp = plan[5], rows = plan[6];
  const int pieces = plan[7], entries = plan[8];
  const int group = kv_heads > 0 ? heads / kv_heads : 0;
  const int hd = head_dim;
  const bool scaled = kv_dtype == kI8;
  const int esize = scaled ? 1 : 2;
  if ((kv_dtype != kI8 && kv_dtype != kBF16) || group < 1 ||
      group > wg::kMaxGroup || heads % kv_heads || n != (group <= 8 ? 8 : 16) ||
      hd < 16 || hd > 256 || hd % 16 || hdp != (hd + 63) / 64 * 64 ||
      block_size < 1 || max_blocks < 1 || rows != (block_size < 64 ? block_size : 64) ||
      (block_size < 64 ? 64 % block_size : block_size % 64) ||
      pieces != 64 / rows || (rows * hd * esize) % 128 ||
      (scaled && ((rows * 4) % 16 || k_scale == nullptr || v_scale == nullptr)) ||
      split_cols < 64 || split_cols % 64 ||
      splits != (max_blocks * block_size + split_cols - 1) / split_cols ||
      splits > 65535 || (long long)slots * kv_heads > 0x7fffffffLL ||
      entries != split_cols / block_size + 2 || stages < 2 || stages > 4 ||
      splits > wg::kMaxSplits || smem > 232448 ||
      smem != wg::layout(hdp, n, hd, esize, scaled, pieces, stages, entries)
                  .total ||
      maps[7] != hd || maps[8] != rows || maps[16] != hd || maps[17] != rows ||
      (scaled && (maps[21] != rows || maps[25] != rows)))
    return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  const CUtensorMapDataType dt =
      scaled ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!wg::encode_4d(&tm[0], k_blocks, maps, dt) ||
      !wg::encode_4d(&tm[1], v_blocks, maps + 9, dt))
    return cudaErrorInvalidValue;
  if (scaled) {
    if (!wg::encode_2d(&tm[2], k_scale, maps + 18) ||
        !wg::encode_2d(&tm[3], v_scale, maps + 22))
      return cudaErrorInvalidValue;
  } else {
    tm[2] = tm[0];                         // not read
    tm[3] = tm[0];
  }
  const wg::Args a{static_cast<const hopper::bf16*>(q),
                   static_cast<const int*>(tables),
                   static_cast<const int*>(pos),
                   static_cast<const hopper::bf16*>(k_new),
                   static_cast<const hopper::bf16*>(v_new),
                   static_cast<hopper::bf16*>(out), static_cast<float*>(ws),
                   static_cast<int*>(counters), slots, heads, kv_heads, hd,
                   block_size, max_blocks, window,
                   scale * wg::kLog2e, splits, split_cols, stages, rows,
                   pieces, entries};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return scaled ? wg::dispatch<int8_t>(hdp, n, tm, a, smem, s)
                : wg::dispatch<hopper::bf16>(hdp, n, tm, a, smem, s);
}
