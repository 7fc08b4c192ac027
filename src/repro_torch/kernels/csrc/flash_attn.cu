// Flash attention for prefill (causal / windowed / kv_len-masked) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attn.py (pallas_call at line 96, kernel body
// `_flash_kernel` at line 27).  Plain version:
// repro_torch.kernels.ref.flash_attn_ref.
//
// What it computes: for every (batch, head) and query row, softmax over
// the valid keys of q.k / sqrt(hd), times V.  Key column c of row r is
// valid iff c < S, and c <= r when causal, c > r - window when a window
// is set, c < kv_len when kv_len >= 0.  Scores, the online softmax state
// and the output sum are f32; the output is rounded once to q's dtype.
// A row that has seen no valid key keeps the running max at the -1e30
// sentinel (never -inf, so exp(m_old - m_new) stays exp(0) == 1) and
// its weights are forced to 0, so it finalises to exactly 0, as
// flash_attn.py:57-73 does.
//
// Bound on the H100: operations at the served shapes.  A causal prefill
// at S = 1024..2048 and hd 32 does 2 * 2 * hd flops per valid (row,
// col) pair against 4 * hd * 2 bytes of q/k/v/out per row, so hundreds
// of flops per byte: above the bf16 ridge of 295 flop/byte for
// S >~ 600, tensor-core bound in the limit.  This first version runs on
// the CUDA cores in f32 (67 TFLOP/s peak), so it is far from that
// bound by design; mma/wgmma tiles are a later change.
//
// Design (simple first): one thread block per (batch*head, 64-row query
// tile), 256 threads, four threads per query row.  The TPU kernel's
// sequential KV grid axis becomes a loop inside the block over 64-key
// tiles, from the first tile the window can reach to the causal edge
// (or kv_len), so masked tiles are skipped, not computed.  Each tile of
// K and V is staged in shared memory as f32; each thread scores 16 keys
// of its row, the row's max and sum are reduced across its four threads
// with warp shuffles, the weights go through shared memory (written and
// read by the same warp), and each thread keeps hd/4 output columns of
// its row in registers.  q, k, v and out are read and written in place
// through their strides, so the model's (B, S, H, hd) and (B, S, K, hd)
// tensors after rotary need no transpose, and grouped KV heads are read
// as kv head = h / (H / K) with no broadcast copy.  Any S: the ragged
// last tiles are masked.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError() of
// the launch.  It launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per KV tile
constexpr int kTPR = 4;                  // threads per query row
constexpr int kThreads = kBQ * kTPR;     // 256
constexpr int kKeys = kBK / kTPR;        // keys scored per thread

enum DType { kF32 = 0, kBF16 = 1 };

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int heads, kv_heads, seq, q_tiles;
  // strides in elements over (batch, head, seq); the last dim is dense
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window, kv_len;            // kv_len < 0: no kv_len mask
  float scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(Args a) {
  constexpr int kQP = HD + 1;            // padded rows: conflict-free dots
  constexpr int kPP = kBK + 1;
  constexpr int kCols = HD / kTPR;       // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                     // kBQ x kQP, pre-scaled
  float* k_s = q_s + kBQ * kQP;          // kBK x kQP
  float* v_s = k_s + kBK * kQP;          // kBK x HD
  float* p_s = v_s + kBK * HD;           // kBQ x kPP softmax weights

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ out = static_cast<T*>(a.out);

  // the last query tiles carry the most causal work: start them first
  const int qt = a.q_tiles - 1 - (int)(blockIdx.x % a.q_tiles);
  const int bh = (int)(blockIdx.x / a.q_tiles);
  const int b = bh / a.heads, h = bh % a.heads;
  const int kh = h / (a.heads / a.kv_heads);
  const int q0 = qt * kBQ;
  const int S = a.seq;
  const int tid = threadIdx.x;
  const int r = tid / kTPR, t = tid % kTPR;
  const int row = q0 + r;

  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* kb = k + b * a.k_sb + kh * a.k_sh;
  const T* vb = v + b * a.v_sb + kh * a.v_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    const int qr = q0 + rr;
    q_s[rr * kQP + d] =
        qr < S ? to_float(qb[qr * a.q_ss + d]) * a.scale : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  // keys any row of this tile can see
  const int row_hi = min(q0 + kBQ, S) - 1;
  int col_end = S;
  if (a.causal) col_end = min(col_end, row_hi + 1);
  if (a.kv_len >= 0) col_end = min(col_end, a.kv_len);
  int col_begin = 0;
  if (a.window > 0) col_begin = max(0, q0 - a.window + 1);

  for (int c0 = (col_begin / kBK) * kBK; c0 < col_end; c0 += kBK) {
    __syncthreads();                     // q_s ready / last tile consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int col = c0 + c;
      float kv = 0.f, vv = 0.f;
      if (col < S) {
        kv = to_float(kb[col * a.k_ss + d]);
        vv = to_float(vb[col * a.v_ss + d]);
      }
      k_s[c * kQP + d] = kv;
      v_s[c * HD + d] = vv;
    }
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = q_s[r * kQP + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        s[j] = fmaf(qd, k_s[(t + kTPR * j) * kQP + d], s[j]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int col = c0 + t + kTPR * j;
      bool valid = row < S && col < S;
      if (a.causal) valid = valid && col <= row;
      if (a.window > 0) valid = valid && col > row - a.window;
      if (a.kv_len >= 0) valid = valid && col < a.kv_len;
      s[j] = valid ? s[j] : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    // the four threads of a row are neighbouring lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      // no valid key yet: weights are exactly 0, never exp(0) == 1
      const float p = m_new == kNegInf ? 0.f : expf(s[j] - m_new);
      p_s[r * kPP + t + kTPR * j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = p_s[r * kPP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = fmaf(p, v_s[c * HD + t + kTPR * j], acc[j]);
    }
  }

  if (row < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* ob = out + b * a.o_sb + h * a.o_sh + row * a.o_ss;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      ob[t + kTPR * j] = from_float<T>(acc[j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * ((size_t)kBQ * (HD + 1) +
                                        (size_t)kBK * (HD + 1) +
                                        (size_t)kBK * HD +
                                        (size_t)kBQ * (kBK + 1));
  auto kernel = flash_attn_kernel<T, HD>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, int blocks,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, blocks, stream);
    case 32: return launch<T, 32>(a, blocks, stream);
    case 64: return launch<T, 64>(a, blocks, stream);
    case 128: return launch<T, 128>(a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attn(
    const void* q, const void* k, const void* v, void* out, int batch,
    int heads, int kv_heads, int seq, int head_dim, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int window,
    int kv_len, float scale, int dtype, void* stream) {
  if (batch == 0 || heads == 0 || seq == 0) return cudaSuccess;
  const int q_tiles = (seq + kBQ - 1) / kBQ;
  Args a{q, k, v, out, heads, kv_heads, seq, q_tiles,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         o_sb, o_sh, o_ss, causal, window, kv_len, scale};
  const long long blocks = (long long)batch * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_hd<float>(head_dim, a, (int)blocks, s);
    case kBF16: return dispatch_hd<__nv_bfloat16>(head_dim, a, (int)blocks, s);
    default: return cudaErrorInvalidValue;
  }
}
