// Paged single-query GQA decode attention for Hopper (sm_90a).
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
// below the 295 flop/byte at which the tensor cores would bound it.
//
// Design (flash-decoding): the table is split across blocks.  The grid
// is (slot * kv-head, split), a split being 128 consecutive pool columns,
// so the number of splits comes from the table's width alone (host
// data: never from pos, which lives on the card).  A split whose columns
// lie wholly outside the valid (or windowed) range does no work.  Inside
// a split, each of the 4 warps takes 16-column tiles (2 a split) with its
// own online softmax: it copies its tiles' K and V rows (each row found
// through the table, 16-byte cp.async chunks) into a two-slot ring of
// its own, so the next tile lands while the current one is scored, with
// no block-wide barrier.  Two lanes score a row (half the head dim
// each); the row weights reach every lane by shuffles, and lane d
// accumulates output column d.  The warps' (m, l, acc) merge in shared
// memory, and the split's partial goes to an f32 workspace.  The last
// block of each (slot, kv-head) to arrive (fence, then an arrival
// counter in device memory that it resets) merges the partials in split
// order and folds in the new token.  No atomics on values: a repeat is
// bit for bit the same.  One layer of the pool is read in place: the
// caller passes that layer's base pointer and the stride between blocks,
// so the pool's (num_blocks, n_layers, bs, kvh, hd) layout is never
// copied.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError() of
// the launch.  It launches on the caller's stream and allocates nothing:
// the wrapper passes the workspace and the counters, sized by its plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  switch (q_dtype) {
    case kF32: return dispatch_kv<float>(kv_dtype, a, (size_t)smem, s);
    case kBF16: return dispatch_kv<__nv_bfloat16>(kv_dtype, a, (size_t)smem, s);
    default: return cudaErrorInvalidValue;
  }
}
