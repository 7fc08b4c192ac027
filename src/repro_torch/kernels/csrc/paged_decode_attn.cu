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
// and are dequantized inside the block loop.
//
// Bound on the H100: bytes.  Each (slot, kv-head) reads its valid KV rows
// once (kvh * hd bytes per row and side for int8, twice that for bf16,
// plus 4-byte row scales) and does 4 * group * hd flops per row, far
// below the 295 flop/byte at which the tensor cores would bound it.
//
// Design (simple first): one thread block per (slot, kv-head).  The block
// loads its own table row (there is no scalar prefetch on the GPU) and
// walks only the table entries that hold a valid column, so the work
// follows the data rather than the table width.  Per pool block it stages
// the K/V rows of its head in shared memory (dequantized to f32), scores
// the `group` query heads against them and updates the running online
// softmax state (m, l, acc) kept in shared memory.  The TPU kernel's
// sequential grid axis over table entries becomes this loop.  One layer
// of the pool is read in place: the caller passes that layer's base
// pointer and the stride between blocks, so the pool's
// (num_blocks, n_layers, bs, kvh, hd) layout is never copied.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError() of
// the launch.  It launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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
  int slots, heads, kv_heads, head_dim, block_size, max_blocks;
  long long kv_stride, scale_stride;
  int window;
  float scale;
};

template <typename QT, typename KT, bool kScaled>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(Args a) {
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  const KT* __restrict__ kb = static_cast<const KT*>(a.k_blocks);
  const KT* __restrict__ vb = static_cast<const KT*>(a.v_blocks);
  const QT* __restrict__ kn = static_cast<const QT*>(a.k_new);
  const QT* __restrict__ vn = static_cast<const QT*>(a.v_new);
  QT* __restrict__ out = static_cast<QT*>(a.out);

  const int kvh = a.kv_heads, hd = a.head_dim, bs = a.block_size;
  const int slot = blockIdx.x / kvh;
  const int kh = blockIdx.x % kvh;
  const int group = a.heads / kvh;
  const int tid = threadIdx.x;
  const int kpad = hd + 1;  // padded K rows keep the score dots conflict-free
  const int row = kvh * hd;  // elements in one pool row (all kv heads)

  extern __shared__ float smem[];
  float* q_s = smem;                  // group * hd, pre-scaled query
  float* k_s = q_s + group * hd;      // bs * kpad
  float* v_s = k_s + bs * kpad;       // bs * hd
  float* s_s = v_s + bs * hd;         // group * bs scores
  float* acc = s_s + group * bs;      // group * hd running numerator
  float* m_s = acc + group * hd;      // group running max
  float* l_s = m_s + group;           // group running denominator
  float* m_next = l_s + group;        // group
  float* l_next = m_next + group;     // group

  const int p = a.pos[slot];
  const long long q_base = ((long long)slot * a.heads + kh * group) * hd;
  for (int i = tid; i < group * hd; i += kThreads) {
    q_s[i] = to_float(q[q_base + i]) * a.scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // visit only the table entries that hold a valid column
  int j_end = (p + bs - 1) / bs;
  if (j_end > a.max_blocks) j_end = a.max_blocks;
  int j_begin = 0;
  if (a.window > 0 && p - a.window + 1 > 0) j_begin = (p - a.window + 1) / bs;
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const long long bid = a.tables[(long long)slot * a.max_blocks + j];
    const KT* kblk = kb + bid * a.kv_stride + kh * hd;
    const KT* vblk = vb + bid * a.kv_stride + kh * hd;
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int c = i / hd, d = i % hd;
      float kv = to_float(kblk[(long long)c * row + d]);
      float vv = to_float(vblk[(long long)c * row + d]);
      if (kScaled) {
        kv *= a.k_scale[bid * a.scale_stride + c];
        vv *= a.v_scale[bid * a.scale_stride + c];
      }
      k_s[c * kpad + d] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    for (int i = tid; i < group * bs; i += kThreads) {
      const int g = i / bs, c = i % bs;
      const int col = j * bs + c;
      const bool valid = col < p && (a.window <= 0 || col > p - a.window);
      float s = kNegInf;
      if (valid) {
        s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(q_s[g * hd + d], k_s[c * kpad + d], s);
      }
      s_s[i] = s;
    }
    __syncthreads();

    for (int i = tid; i < group * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      const float* sg = s_s + g * bs;
      const float m_old = m_s[g];
      float m_new = m_old;
      for (int c = 0; c < bs; ++c) m_new = fmaxf(m_new, sg[c]);
      // m_old == kNegInf gives corr == 0 once a valid key appears, and
      // corr == 1 while the sweep is still fully masked (acc is 0 then)
      const float corr = expf(m_old - m_new);
      float num = acc[i] * corr;
      float den = 0.f;
      for (int c = 0; c < bs; ++c) {
        const float pc = sg[c] == kNegInf ? 0.f : expf(sg[c] - m_new);
        num = fmaf(pc, v_s[c * hd + d], num);
        den += pc;
      }
      acc[i] = num;
      if (d == 0) {
        m_next[g] = m_new;
        l_next[g] = l_s[g] * corr + den;
      }
    }
    __syncthreads();
    for (int g = tid; g < group; g += kThreads) {
      m_s[g] = m_next[g];
      l_s[g] = l_next[g];
    }
    __syncthreads();
  }

  // fold in the current token's KV: always valid, so l_fin >= 1.  v_new
  // is indexed by this block's kv head, never by the query head.
  const long long kv_base = ((long long)slot * kvh + kh) * hd;
  for (int i = tid; i < group * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    float sn = 0.f;
    for (int e = 0; e < hd; ++e) sn = fmaf(q_s[g * hd + e], to_float(kn[kv_base + e]), sn);
    const float m_fin = fmaxf(m_s[g], sn);
    const float pn = expf(sn - m_fin);
    const float corr = expf(m_s[g] - m_fin);
    const float l_fin = l_s[g] * corr + pn;
    const float o = (acc[i] * corr + pn * to_float(vn[kv_base + d])) / fmaxf(l_fin, 1e-30f);
    out[q_base + i] = from_float<QT>(o);
  }
}

template <typename QT, typename KT, bool kScaled>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int group = a.heads / a.kv_heads;
  const int hd = a.head_dim, bs = a.block_size;
  const size_t floats = (size_t)group * hd + (size_t)bs * (hd + 1) +
                        (size_t)bs * hd + (size_t)group * bs +
                        (size_t)group * hd + 4 * (size_t)group;
  const size_t bytes = floats * sizeof(float);
  auto kernel = paged_decode_kernel<QT, KT, kScaled>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.slots * a.kv_heads, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const Args& a, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch<QT, float, false>(a, stream);
    case kBF16: return launch<QT, __nv_bfloat16, false>(a, stream);
    case kI8: return launch<QT, int8_t, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_decode_attn(
    const void* q, const void* k_blocks, const void* v_blocks,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos, const void* k_new, const void* v_new, void* out,
    int slots, int heads, int kv_heads, int head_dim, int block_size,
    int max_blocks, long long kv_block_stride, long long scale_block_stride,
    int window, float scale, int q_dtype, int kv_dtype, void* stream) {
  if (slots == 0) return cudaSuccess;
  Args a{q, k_blocks, v_blocks,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const int*>(tables), static_cast<const int*>(pos),
         k_new, v_new, out,
         slots, heads, kv_heads, head_dim, block_size, max_blocks,
         kv_block_stride, scale_block_stride, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32: return dispatch_kv<float>(kv_dtype, a, s);
    case kBF16: return dispatch_kv<__nv_bfloat16>(kv_dtype, a, s);
    default: return cudaErrorInvalidValue;
  }
}
