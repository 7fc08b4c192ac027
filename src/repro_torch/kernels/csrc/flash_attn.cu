// Flash attention for prefill (causal / windowed / kv_len-masked) for
// Hopper (sm_90a), in two routes picked by dtype.
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
// flash_attn.py:57-73 does.  q, k, v and out are read and written in
// place through their strides, so the model's (B, S, H, hd) and
// (B, S, K, hd) tensors after rotary need no transpose, and grouped KV
// heads are read as kv head = h / (H / K) with no broadcast copy.  Any
// S: the ragged last tiles are masked.  Head dims 16, 32, 64, 128, 256.
//
// Bound on the H100: operations at the served shapes.  A causal prefill
// at S = 1024..2048 and hd 32 does 2 * 2 * hd flops per valid (row,
// col) pair against 4 * hd * 2 bytes of q/k/v/out per row: hundreds of
// flops per byte, above the bf16 ridge of 295 flop/byte for S >~ 600.
// At hd 32 the exponentials cost as much as the products: one ex2 per
// valid pair at 16 a clock per SM is a floor of ~0.03 ms at 8 x 2048 x
// 8 heads, above the 0.0174 ms of the products at the bf16 peak.
//
// bf16 route (flash_attn_tc_kernel), FlashAttention-2 on mma.sync
// m16n8k16 (bf16 in, f32 accumulate): one block of 4 warps per
// (batch*head, 64-row query tile); each warp owns 16 query rows.  The
// grid starts the heaviest causal tiles of every (batch, head) first, so
// the light ones fill the tail.  Q is staged once (cp.async) and read as
// A fragments with ldmatrix (kept in registers for hd <= 64).  64-key
// tiles of K and V (32 at hd 256) are staged in bf16 with cp.async
// 16-byte copies into a two-slot ring, one barrier a tile, so the next
// tile loads while this one computes; each thread's copy addresses are
// computed once; rows are padded by 16 bytes so ldmatrix is free of
// bank conflicts.  S = Q K^T runs on the tensor cores with K's rows as
// the B operand.  The online softmax stays in registers: the row max
// goes through the four lanes of a quad, and each weight is one FFMA and
// one ex2.approx (the f32 scores scaled by scale * log2(e) in the same
// FFMA).  P is rounded to bf16 in registers and is the A operand of O +=
// P V directly (the C fragment of one m16n8k16 is the A fragment of the
// next); V is the B operand through ldmatrix.trans, and the row sums of
// P come from one more mma against a fragment of ones.  Masks are
// evaluated only on tiles that cross the causal diagonal, the window's
// edge, kv_len or S; a warp skips a tile that no row of its own can see,
// and the block skips the tiles outside the window.  Rows past S and keys
// past S are zero-filled by the copies, so nothing undefined enters a
// product.  At hd <= 64 the kernel is held to 96 registers so five
// blocks share an SM.  What limits it at hd 32 is the issue of the
// softmax's instructions (two per weight plus the max) and their
// latencies: it runs at about three times the ex2 floor above.
//
// f32 route (flash_attn_kernel), kept from the first version: the
// tensor cores would compute f32 as TF32 (about three decimal digits),
// which the f32 serving path's card == CPU greedy streams do not allow.
// One block per (batch*head, 64-row query tile), 256 threads, four per
// query row, f32 on the CUDA cores: each K/V tile staged in shared
// memory as f32, 16 keys of a row scored per thread, weights through
// shared memory, hd/4 output columns of the row per thread.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError() of
// the launch.  It launches on the caller's stream and allocates nothing.
// The bf16 route needs 16-byte aligned rows (the wrapper checks).

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

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
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
    case 256: return launch<T, 256>(a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ bf16 tensor-core route --
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op; results below 2^-126 flush to 0 (a softmax weight
// that small is 0 beside the row's largest, which is 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Tile shapes of the tensor-core route.
template <int HD>
struct TcTile {
  static constexpr bool kSmallHd = HD <= 64;
  static constexpr int kWarps = 4;                  // 16 rows each
  static constexpr int kBQ = 16 * kWarps;           // query rows a block
  static constexpr int kBK = HD <= 128 ? 64 : 32;   // keys a tile
  static constexpr int kStages = 2;                 // K/V ring slots
  static constexpr int kMinBlocks = kSmallHd ? 5 : 1;  // a SM
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStride = HD + 8;            // smem row, in bf16
  static constexpr bool kQRegs = kSmallHd;          // Q fragments kept
  static constexpr int kNB = kBK / 8;               // S n-blocks
  static constexpr int kKD = HD / 16;               // k-steps of Q K^T
  static constexpr int kND = HD / 8;                // O n-blocks
  static constexpr int kChunks = HD / 8;            // 16-byte row chunks
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(kBQ + 2 * kStages * kBK) * kStride;
};

template <int HD>
__global__ void __launch_bounds__(TcTile<HD>::kThreads,
                                  TcTile<HD>::kMinBlocks)
    flash_attn_tc_kernel(Args a) {
  using C = TcTile<HD>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kStride = C::kStride;
  constexpr int kStages = C::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);    // kBQ x kStride
  bf16* kv_s = q_s + kBQ * kStride;                  // kStages x (K, V)

  const bf16* __restrict__ q = static_cast<const bf16*>(a.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(a.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(a.v);
  bf16* __restrict__ out = static_cast<bf16*>(a.out);

  // the last query tiles carry the most causal work: the grid starts
  // them first across all (batch, head) pairs, so the light ones fill
  // the tail
  const int n_bh = (int)(gridDim.x / a.q_tiles);
  const int qt = a.q_tiles - 1 - (int)(blockIdx.x / n_bh);
  const int bh = (int)(blockIdx.x % n_bh);
  const int b = bh / a.heads, h = bh % a.heads;
  const int kh = h / (a.heads / a.kv_heads);
  const int q0 = qt * kBQ;
  const int S = a.seq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;          // ldmatrix address

  const bf16* qb = q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = k + b * a.k_sb + kh * a.k_sh;
  const bf16* vb = v + b * a.v_sb + kh * a.v_sh;

  // keys any row of this tile can see
  const int row_hi = min(q0 + kBQ, S) - 1;
  int col_end = S;
  if (a.causal) col_end = min(col_end, row_hi + 1);
  if (a.kv_len >= 0) col_end = min(col_end, a.kv_len);
  int col_begin = 0;
  if (a.window > 0) col_begin = max(0, q0 - a.window + 1);
  const int t_begin = col_begin / kBK;
  const int t_end = col_end > 0 ? (col_end + kBK - 1) / kBK : 0;

  for (int i = tid; i < kBQ * C::kChunks; i += C::kThreads) {
    const int r = i / C::kChunks, c = i % C::kChunks;
    const int row = q0 + r;
    const bool ok = row < S;
    cp_async16(q_s + r * kStride + c * 8,
               qb + (long long)(ok ? row : 0) * a.q_ss + c * 8, ok);
  }
  // each thread copies the same 16-byte column chunk of rows r0, r0 +
  // kRowStep, ... of every K and V tile
  constexpr int kRowStep = C::kThreads / C::kChunks;
  const int r0 = tid / C::kChunks, c8 = (tid % C::kChunks) * 8;
  const bf16* kp = kb + (long long)r0 * a.k_ss + c8;
  const bf16* vp = vb + (long long)r0 * a.v_ss + c8;
  auto load_kv = [&](int tile) {
    bf16* ks = kv_s + ((tile - t_begin) % kStages) * 2 * kBK * kStride +
               r0 * kStride + c8;
    bf16* vs = ks + kBK * kStride;
    const int c0 = tile * kBK;
#pragma unroll
    for (int r = 0; r < kBK; r += kRowStep) {
      if (kRowStep > kBK && r0 >= kBK) break;       // more threads than rows
      const bool ok = c0 + r0 + r < S;
      const long long off = ok ? (long long)(c0 + r) : -(long long)r0;
      cp_async16(ks + r * kStride, kp + off * a.k_ss, ok);
      cp_async16(vs + r * kStride, vp + off * a.v_ss, ok);
    }
  };
  // prologue: the first kStages - 1 tiles, one copy group each (Q rides
  // in the first)
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (t_begin + p < t_end) load_kv(t_begin + p);
    cp_async_commit();
  }

  const int r_lo = q0 + warp * 16;                   // this warp's rows
  const int r_hi = r_lo + 15;
  const int row0 = r_lo + g, row1 = row0 + 8;        // this lane's rows
  const float sl2 = a.scale * kLog2e;
  const bf16* q_frag = q_s + (warp * 16 + (mi & 1) * 8 + mr) * kStride +
                       (mi >> 1) * 8;

  float o[C::kND][4];
#pragma unroll
  for (int n = 0; n < C::kND; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  uint32_t qf[C::kQRegs ? C::kKD : 1][4];

  for (int it = t_begin; it < t_end; ++it) {
    // tile `it` has landed; every warp is done with tile it - 1, whose
    // slot the copy issued below refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < t_end) load_kv(it + kStages - 1);
    cp_async_commit();
    const bf16* ks = kv_s + ((it - t_begin) % kStages) * 2 * kBK * kStride;
    const bf16* vs = ks + kBK * kStride;
    if constexpr (C::kQRegs) {
      if (it == t_begin) {
#pragma unroll
        for (int kk = 0; kk < C::kKD; ++kk)
          ldmatrix_x4(qf[kk], q_frag + 16 * kk);
      }
    }
    const int c0 = it * kBK;
    const bool skip = r_lo >= S || (a.causal && c0 > r_hi) ||
                      (a.window > 0 && c0 + kBK - 1 <= r_lo - a.window) ||
                      (a.kv_len >= 0 && c0 >= a.kv_len);
    if (skip) continue;
    // ---- S = Q K^T
    float s[C::kNB][4];
#pragma unroll
    for (int j = 0; j < C::kNB; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::kKD; ++kk) {
      uint32_t af[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[kk][e];
      } else {
        ldmatrix_x4(af, q_frag + 16 * kk);
      }
#pragma unroll
      for (int j = 0; j < C::kNB; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (8 * (j + (mi >> 1)) + mr) * kStride + 16 * kk +
                            (mi & 1) * 8);
        mma_bf16(s[j], af, bf[0], bf[1]);
        mma_bf16(s[j + 1], af, bf[2], bf[3]);
      }
    }
    // ---- mask the tiles that need it, then the online softmax in
    // registers: the running max is kept in raw score units, and each
    // weight is exp2(s * scale * log2(e) - m * scale * log2(e)), one FFMA
    // and one ex2
    const bool need_mask = c0 + kBK > S ||
                           (a.causal && c0 + kBK - 1 > r_lo) ||
                           (a.window > 0 && c0 <= r_hi - a.window) ||
                           (a.kv_len >= 0 && c0 + kBK > a.kv_len);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < C::kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          bool valid = col < S;
          if (a.causal) valid = valid && col <= row;
          if (a.window > 0) valid = valid && col > row - a.window;
          if (a.kv_len >= 0) valid = valid && col < a.kv_len;
          if (!valid) s[j][e] = kNegInf;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < C::kNB; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // the four lanes of a quad hold one row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // no valid key yet (max still the sentinel): shift by 0, so every
    // weight is exp2(-huge) == 0, never exp2(0) == 1
    const float sh0 = mn0 == kNegInf ? 0.f : -mn0 * sl2;
    const float sh1 = mn1 == kNegInf ? 0.f : -mn1 * sl2;
    const float corr0 = ex2(fmaf(m0, sl2, sh0));
    const float corr1 = ex2(fmaf(m1, sl2, sh1));
    m0 = mn0;
    m1 = mn1;
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < C::kNB; ++j) {
      // the C fragment of n-block j is half of P's A fragment
      pf[j >> 1][(j & 1) * 2] = pack_bf16(ex2(fmaf(s[j][0], sl2, sh0)),
                                          ex2(fmaf(s[j][1], sl2, sh0)));
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ex2(fmaf(s[j][2], sl2, sh1)),
                                              ex2(fmaf(s[j][3], sl2, sh1)));
    }
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int n = 0; n < C::kND; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }
    // ---- O += P V.  The row sums of P (as rounded to bf16, the weights
    // O is built from) come from one more product, with ones as B
    constexpr uint32_t kOnes = 0x3f803f80u;         // bf16 1.0, twice
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float ls[4] = {l0, 0.f, l1, 0.f};
      mma_bf16(ls, pf[kk], kOnes, kOnes);
      l0 = ls[0];
      l1 = ls[2];
#pragma unroll
      for (int n = 0; n < C::kND; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (16 * kk + (mi & 1) * 8 + mr) * kStride +
                                  8 * (n + (mi >> 1)));
        mma_bf16(o[n], pf[kk], bf[0], bf[1]);
        mma_bf16(o[n + 1], pf[kk], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // every lane of a quad holds its rows' whole sums
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = out + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < C::kND; ++n) {
    const int col = 8 * n + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * a.o_ss + col) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * a.o_ss + col) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD>
cudaError_t launch_tc(Args a, int batch, cudaStream_t stream) {
  using C = TcTile<HD>;
  a.q_tiles = (a.seq + C::kBQ - 1) / C::kBQ;
  const long long blocks = (long long)batch * a.heads * a.q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = flash_attn_tc_kernel<HD>;
  if (C::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(int)blocks, C::kThreads, C::kSmem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int hd, const Args& a, int batch,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_tc<16>(a, batch, stream);
    case 32: return launch_tc<32>(a, batch, stream);
    case 64: return launch_tc<64>(a, batch, stream);
    case 128: return launch_tc<128>(a, batch, stream);
    case 256: return launch_tc<256>(a, batch, stream);
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
    case kBF16: return dispatch_tc(head_dim, a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}
