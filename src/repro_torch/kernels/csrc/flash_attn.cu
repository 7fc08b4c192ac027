// Flash attention for prefill (causal / windowed / kv_len-masked) for
// Hopper (sm_90a), in three routes picked by dtype and head dim (the
// wrapper's flash_plan in kernels/flash_attn.py): bf16 at hd 64..256 on
// wgmma with TMA and a producer warp, bf16 at hd 16 and 32 on mma.sync,
// f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attn.py (pallas_call at line 96, kernel body
// `_flash_kernel` at line 27).  Plain version:
// repro_torch.kernels.ref.flash_attn_ref.
//
// What it computes: for every (batch, head) and query row, softmax over
// the valid keys of q.k / sqrt(hd), times V.  The queries are S_q rows
// and the keys S_k columns (S_q == S_k for self-attention; a decoder's
// cross-attention reads S_k encoder frames).  Key column c of row r is
// valid iff c < S_k, and c <= r when causal, c > r - window when a
// window is set, c < kv_len when kv_len >= 0 (the wrapper allows causal
// and window only when S_q == S_k).  Scores, the online softmax state
// and the output sum are f32; the output is rounded once to q's dtype.
// A row that has seen no valid key keeps the running max at the -1e30
// sentinel (never -inf, so exp(m_old - m_new) stays exp(0) == 1) and
// its weights are forced to 0, so it finalises to exactly 0, as
// flash_attn.py:57-73 does.  q, k, v and out are read and written in
// place through their strides, so the model's (B, S, H, hd) and
// (B, S, K, hd) tensors after rotary need no transpose, and grouped KV
// heads are read as kv head = h / (H / K) with no broadcast copy.  Any
// S_q and S_k: the ragged last query and key tiles are masked.  Head
// dims 16, 32, 64, 96 (phi3-mini), 128 and 256.
//
// Bound on the H100.  A causal prefill does 2 * 2 * hd flops per valid
// (row, col) pair against 4 * hd * 2 bytes of q/k/v/out per row, so its
// operations per byte grow with the keys a row sees: at the served
// shapes the call is bound by operations (gemma3-12b's 8 x 2048 tokens
// at hd 256: 275 GFLOP, 0.278 ms at 989 TFLOP/s, against 402 MB, 0.120
// ms; whisper-small's encoder, 1500 keys a row) or sits just below the
// bf16 ridge of ~295 flop/byte (8 x 512..1024 causal tokens at hd
// 64..128, where the bytes bound it by 15-35 %).  The exponentials add a
// floor:
// one ex2 a valid pair at 16 a clock per SM, which at hd 32 costs as
// much as the products and at hd 64 about half as much.
//
// bf16 at hd 64, 96, 128 and 256 (flash_attn_wg_kernel), in the shape
// of FlashAttention-3, built for the operation bound:
// - products on wgmma, the only way to the tensor cores' full rate:
//   S = Q K^T is m64nBKk16 with both operands read from shared memory
//   (K's rows K-major), and O += P V is m64n{hd}k16 with P, the S
//   accumulator rounded to bf16, as the register A operand and V the
//   N-major B operand through the descriptor's transpose bit.  Q, K and
//   V lie in shared memory in the 128-byte swizzled layout that TMA
//   writes (CU_TENSOR_MAP_SWIZZLE_128B, 64-column boxes), so neither the
//   copies nor the tensor cores' reads conflict in banks;
// - a block of 384 threads: a producer warpgroup, of which one thread
//   issues every TMA load (setmaxnreg gives its registers to the
//   consumers: 24 against 240), and two consumer warpgroups of 64 query
//   rows each, so one group's softmax runs beside the other's products;
// - the loads are TMA tile copies into a ring of K/V stages (4 at hd 64,
//   2 above) with a full and an empty mbarrier each, and Q loads once a
//   tile into one of two slots (one at hd 256, where two do not fit
//   beside the ring), so the next tile's Q and first K/V land while
//   this tile computes.  TMA reads the strided (B, H, S, hd) views
//   through 4-d tensor maps encoded on the host each launch
//   (cuTensorMapEncodeTiled, found at run time) and fills rows past S,
//   keys past S_k and hd 96's columns 96..127 with zeros;
// - persistent: one block an SM takes tiles of 128 query rows from a
//   counter (any block may take any tile; each tile is computed whole by
//   one block in a fixed order, so the output repeats bit for bit, with
//   no atomics on values).  Tiles are numbered by KV group (batch, kv
//   head), within a group the heaviest causal tiles first and the
//   group's heads side by side, so the tiles running at once read a few
//   groups' K/V from L2 and the light tiles fill the tail;
// - tiles of 128 keys (64 at hd 256, whose O alone takes 128 registers
//   a thread); hd 96 runs in hd 128's layout (its S products stop at
//   column 96, its P V products run at n 128 on zero columns);
// - the online softmax stays in registers as on the mma.sync route (a
//   quad-lane row max, one FFMA and one ex2 a weight, f32 row sums a
//   lane, added across the quad once at the end).  Masks are evaluated
//   only on tiles that cross the causal diagonal, the window's edge,
//   kv_len or S_k; a group skips the key tiles its 64 rows cannot see,
//   the block the tiles none of its rows can;
// - at hd 64 each tile's S runs beside the last tile's O += P V (one
//   product phase a tile); above hd 64 a tile's S, softmax and P V run
//   in turn, since O, S and P live at once cost more registers than the
//   overlap gains (measured: chip_smoke.py phase 2, PERF.md).
// The consumers' loop tests for the end of the walk at its top: with
// the test after the wait inside the loop, ptxas spilled at hd 256.
//
// bf16 at hd 16 and 32 (flash_attn_tc_kernel), FlashAttention-2 on
// mma.sync m16n8k16 (bf16 in, f32 accumulate): one block of 4 warps per
// (batch*head, 64-row query tile); each warp owns 16 query rows.  The
// grid starts the heaviest causal tiles of every (batch, head) first, so
// the light ones fill the tail.  Q is staged once (cp.async) and kept in
// registers as A fragments (ldmatrix).  64-key tiles of K and V are
// staged in bf16 with cp.async 16-byte copies into a two-slot ring, one
// barrier a tile, so the next tile loads while this one computes; each
// thread's copy addresses are computed once; rows are padded by 16 bytes
// so ldmatrix is free of bank conflicts.  S = Q K^T runs on the tensor
// cores with K's rows as the B operand.  The online softmax stays in
// registers: the row max goes through the four lanes of a quad, and each
// weight is one FFMA and one ex2.approx (the f32 scores scaled by scale
// * log2(e) in the same FFMA).  P is rounded to bf16 in registers and is
// the A operand of O += P V directly (the C fragment of one m16n8k16 is
// the A fragment of the next); V is the B operand through
// ldmatrix.trans, and the row sums of P come from one more mma against a
// fragment of ones.  Masks are evaluated only on tiles that cross the
// causal diagonal, the window's edge, kv_len or S; a warp skips a tile
// that no row of its own can see, and the block skips the tiles outside
// the window.  Rows past S and keys past S are zero-filled by the
// copies, so nothing undefined enters a product.  The kernel is held to
// 96 registers so five blocks share an SM.  What limits it at hd 32 is
// the issue of the softmax's instructions (two per weight plus the max)
// and their latencies: it runs at about three times the ex2 floor.
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
// the launch.  It launches on the caller's stream and allocates nothing:
// the wrapper passes the tile counter (_build.arrival_counters, zero
// between launches).  The bf16 routes need 16-byte aligned rows and
// strides (the wrapper checks; TMA's rules in tma_map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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
  int heads, kv_heads, seq, seq_k, q_tiles;   // seq: query rows
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
  const int S = a.seq, Sk = a.seq_k;
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
  int col_end = Sk;
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
      if (col < Sk) {
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
      bool valid = row < S && col < Sk;
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
    case 96: return launch<T, 96>(a, blocks, stream);
    case 128: return launch<T, 128>(a, blocks, stream);
    case 256: return launch<T, 256>(a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ bf16 tensor-core route --
// Tile shapes of the mma.sync route (hd 16 and 32).
template <int HD>
struct TcTile {
  static_assert(HD == 16 || HD == 32, "hd 64..256 run on wgmma");
  static constexpr int kWarps = 4;                  // 16 rows each
  static constexpr int kBQ = 16 * kWarps;           // query rows a block
  static constexpr int kBK = 64;                    // keys a tile
  static constexpr int kStages = 2;                 // K/V ring slots
  static constexpr int kMinBlocks = 5;              // a SM
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStride = HD + 8;            // smem row, in bf16
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
  const int S = a.seq, Sk = a.seq_k;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;          // ldmatrix address

  const bf16* qb = q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = k + b * a.k_sb + kh * a.k_sh;
  const bf16* vb = v + b * a.v_sb + kh * a.v_sh;

  // keys any row of this tile can see
  const int row_hi = min(q0 + kBQ, S) - 1;
  int col_end = Sk;
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
  const int r0 = tid / C::kChunks;
  const int c8 = (tid % C::kChunks) * 8;
  const bf16* kp = kb + (long long)r0 * a.k_ss + c8;
  const bf16* vp = vb + (long long)r0 * a.v_ss + c8;
  auto load_kv = [&](int tile) {
    bf16* ks = kv_s + ((tile - t_begin) % kStages) * 2 * kBK * kStride +
               r0 * kStride + c8;
    bf16* vs = ks + kBK * kStride;
    const int c0 = tile * kBK;
#pragma unroll
    for (int r = 0; r < kBK; r += kRowStep) {
      const bool ok = c0 + r0 + r < Sk;
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
  uint32_t qf[C::kKD][4];                            // Q's A fragments

  for (int it = t_begin; it < t_end; ++it) {
    // tile `it` has landed; every warp is done with tile it - 1, whose
    // slot the copy issued below refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < t_end) load_kv(it + kStages - 1);
    cp_async_commit();
    const bf16* ks = kv_s + ((it - t_begin) % kStages) * 2 * kBK * kStride;
    const bf16* vs = ks + kBK * kStride;
    if (it == t_begin) {
#pragma unroll
      for (int kk = 0; kk < C::kKD; ++kk)
        ldmatrix_x4(qf[kk], q_frag + 16 * kk);
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
#pragma unroll
      for (int e = 0; e < 4; ++e) af[e] = qf[kk][e];
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
    const bool need_mask = c0 + kBK > Sk ||
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
          bool valid = col < Sk;
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
    default: return cudaErrorInvalidValue;       // 64..256: wgmma
  }
}


// ------------------------------------------------- bf16 route on wgmma --
// Tile shapes of the wgmma route (hd 96 rides hd 128's layout: TMA fills
// columns 96..127 with zeros).  flash_plan in kernels/flash_attn.py
// mirrors these numbers and passes them in; the entry refuses a plan
// that differs.
template <int HD>
struct WgTile {
  static constexpr int kHDP = HD == 96 ? 128 : HD;   // shared columns
  static constexpr int kColBlocks = kHDP / 64;        // 128-byte boxes
  static constexpr int kBQ = 128;                     // 64 a consumer
  static constexpr int kBK = HD == 256 ? 64 : 128;    // keys a tile
  // two Q slots where they fit beside the ring: the next tile's Q loads
  // while this one computes
  static constexpr int kQSlots = HD == 256 ? 1 : 2;
  static constexpr int kStages = HD == 64 ? 4 : 2;    // K/V ring slots
  // hd 64 overlaps each tile's S with the last tile's O += P V (one
  // product phase a tile); above it the registers of O, S and P at once
  // cost more than the overlap gains (measured)
  static constexpr bool kOverlap = HD == 64;
  static constexpr int kThreads = 384;                // producer + 2
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kQBytes = kBQ * kHDP * 2;
  static constexpr int kTileBytes = kBK * kHDP * 2;   // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  // + 1024: the swizzle atoms need a 1024-byte aligned base
  // + the barriers (full, empty a stage and a Q slot) and the tile
  // indices
  static constexpr size_t kSmem = 1024 + (size_t)kQSlots * kQBytes +
                                  (size_t)kStages * kStageBytes +
                                  8 * (2 * kStages + 2 * kQSlots) + 16;
};

struct WgArgs {
  bf16* out;
  int* counter;       // the tile counter: 0 before and after each launch
  int heads, kv_heads, seq, seq_k, q_tiles, tiles;
  long long o_sb, o_sh, o_ss;
  int causal, window, kv_len;
  float scale;
};

// One output tile: 128 query rows of one (batch, head) and the key tiles
// [t_begin, t_end) any of its rows can see.  Tiles are numbered by KV
// group (batch, kv head), and within a group the heaviest causal tiles
// first, the group's heads side by side: the tiles running at once share
// a few groups' K/V in L2.
struct WgWork {
  int b, h, kh, q0, t_begin, t_end;
};

template <int BQ, int BK>
__device__ __forceinline__ WgWork wg_work(const WgArgs& a, int tile) {
  const int hpg = a.heads / a.kv_heads;
  const int group = tile / (hpg * a.q_tiles);
  const int r = tile % (hpg * a.q_tiles);
  WgWork w;
  w.b = group / a.kv_heads;
  w.kh = group % a.kv_heads;
  w.h = w.kh * hpg + r % hpg;
  w.q0 = (a.q_tiles - 1 - r / hpg) * BQ;
  const int row_hi = min(w.q0 + BQ, a.seq) - 1;
  int col_end = a.seq_k;
  if (a.causal) col_end = min(col_end, row_hi + 1);
  if (a.kv_len >= 0) col_end = min(col_end, a.kv_len);
  const int col_begin = a.window > 0 ? max(0, w.q0 - a.window + 1) : 0;
  w.t_begin = col_begin / BK;
  w.t_end = col_end > 0 ? (col_end + BK - 1) / BK : 0;
  return w;
}

// The online softmax of one S tile of the wgmma route in registers
// (n-block j of the accumulator holds keys c0 + 8 j + 2 t, + 1 of rows
// row0 and row1): masks where the tile needs them, the running max
// through the quad's four lanes, each weight one FFMA and one ex2 (the
// scores scaled by scale * log2(e) in the FFMA), P rounded to bf16 as
// the A fragments of O += P V (n-blocks 2 kk and 2 kk + 1 make k-step
// kk), and this lane's share of the row sums in f32.  A row that has
// seen no valid key keeps the -1e30 sentinel and is shifted by 0, so its
// weights are exp2(-huge) == 0.  Returns the rows' rescale of O.
template <int BK>
__device__ __forceinline__ float2 wg_softmax(
    float* sc, uint32_t (*pf)[4], float& m0, float& m1, float& l0,
    float& l1, const WgArgs& a, int c0, int row0, int row1, int r_lo,
    int r_hi, int t, float sl2) {
  const bool need_mask = c0 + BK > a.seq_k ||
                         (a.causal && c0 + BK - 1 > r_lo) ||
                         (a.window > 0 && c0 <= r_hi - a.window) ||
                         (a.kv_len >= 0 && c0 + BK > a.kv_len);
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = c0 + 8 * j + 2 * t + (e & 1);
        bool valid = col < a.seq_k;
        if (a.causal) valid = valid && col <= row;
        if (a.window > 0) valid = valid && col > row - a.window;
        if (a.kv_len >= 0) valid = valid && col < a.kv_len;
        if (!valid) sc[4 * j + e] = kNegInf;
      }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float sh0 = mn0 == kNegInf ? 0.f : -mn0 * sl2;
  const float sh1 = mn1 == kNegInf ? 0.f : -mn1 * sl2;
  // exactly 1 where the row's max stands, so O's rescale can be skipped
  const float2 corr =
      make_float2(mn0 == m0 ? 1.f : ex2(fmaf(m0, sl2, sh0)),
                  mn1 == m1 ? 1.f : ex2(fmaf(m1, sl2, sh1)));
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float p0 = ex2(fmaf(sc[4 * j], sl2, sh0));
    const float p1 = ex2(fmaf(sc[4 * j + 1], sl2, sh0));
    const float p2 = ex2(fmaf(sc[4 * j + 2], sl2, sh1));
    const float p3 = ex2(fmaf(sc[4 * j + 3], sl2, sh1));
    ps0 += p0 + p1;
    ps1 += p2 + p3;
    pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
  l0 = fmaf(l0, corr.x, ps0);
  l1 = fmaf(l1, corr.y, ps1);
  return corr;
}

// Persistent: one block an SM.  Its producer takes the next tile from
// the counter (any block may take any tile; each tile is computed whole
// by one block in a fixed order, so the output repeats bit for bit),
// runs ahead into that tile's Q and K/V while the consumers finish the
// last one, and hands them the tile's index beside Q.
template <int HD>
__global__ void __launch_bounds__(WgTile<HD>::kThreads, 1)
    flash_attn_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         WgArgs a) {
  using C = WgTile<HD>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kHDP = C::kHDP;
  constexpr int kStages = C::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // the Q slots, each kColBlocks boxes of kBQ rows x 128 bytes; then
  // the ring, each stage K's boxes (kBK rows x 128 bytes each) and V's;
  // then barriers and the tile index that rides with each Q
  unsigned char* q_s = smem;
  unsigned char* kv_s = smem + C::kQSlots * C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s +
                                               kStages * C::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + C::kQSlots;
  volatile int* tile_s =
      reinterpret_cast<volatile int*>(q_empty + C::kQSlots);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);            // one arrival a consumer warp
    }
    for (int s = 0; s < C::kQSlots; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread takes the tiles and issues
    // every TMA load.  A fresh barrier's previous phase counts as
    // complete, so each first wait on an empty slot passes.
    setmaxnreg_dec<C::kProducerRegs>();
    if (tid == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      int i = 0;                           // ring loads
      for (int n = 0;; ++n) {              // tiles of this block
        const int tile = atomicAdd(a.counter, 1);
        const int qn = n % C::kQSlots;
        const uint32_t q_phase = (n / C::kQSlots) & 1;
        if (tile >= a.tiles) {
          // each block's last take overshoots once: the launch's last
          // take of all resets the counter for the next launch
          if (tile == a.tiles + (int)gridDim.x - 1) *a.counter = 0;
          mbar_wait(&q_empty[qn], q_phase ^ 1);
          tile_s[qn] = -1;
          mbar_arrive(&q_full[qn]);
          break;
        }
        const WgWork w = wg_work<kBQ, kBK>(a, tile);
        // Q (after the first K/V tile) into its slot, once the consumers
        // have released the slot's last tile
        auto load_q = [&]() {
          mbar_wait(&q_empty[qn], q_phase ^ 1);
          tile_s[qn] = tile;
          mbar_expect_tx(&q_full[qn], C::kQBytes);
          unsigned char* qs = q_s + qn * C::kQBytes;
#pragma unroll
          for (int cb = 0; cb < C::kColBlocks; ++cb)
            tma_load_4d(qs + cb * (kBQ * 128), &tm_q, &q_full[qn], cb * 64,
                        w.q0, w.h, w.b);
        };
        for (int it = w.t_begin; it < w.t_end; ++it, ++i) {
          const int s = i % kStages;
          mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::kStageBytes);
          unsigned char* ks = kv_s + s * C::kStageBytes;
          unsigned char* vs = ks + C::kTileBytes;
#pragma unroll
          for (int cb = 0; cb < C::kColBlocks; ++cb) {
            tma_load_4d(ks + cb * (kBK * 128), &tm_k, &full[s], cb * 64,
                        it * kBK, w.kh, w.b);
            tma_load_4d(vs + cb * (kBK * 128), &tm_v, &full[s], cb * 64,
                        it * kBK, w.kh, w.b);
          }
          if (it == w.t_begin) load_q();
        }
        if (w.t_begin >= w.t_end) load_q();   // no key to see: Q alone
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows of each tile each
    setmaxnreg_inc<C::kConsumerRegs>();
    const int cw = tid / 128 - 1;
    const int warp = (tid / 32) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int S = a.seq;
    const float sl2 = a.scale * kLog2e;
    // descriptors: the start address field takes byte offsets / 16
    const uint64_t dq = wgmma_desc(q_s + cw * (64 * 128), 16, 1024);
    const uint64_t dkv = wgmma_desc(kv_s, 16, 1024);
    const uint64_t dvv = wgmma_desc(kv_s + C::kTileBytes, kBK * 128, 1024);

    // S = Q K^T from ring slot s_: both operands K-major in shared
    // memory; a k-step is 32 bytes into the 128-byte rows of a column
    // block
    auto qk = [&](float* sc_, uint64_t dqn_, int s_) {
      const uint64_t dk_ = dkv + ((s_ * C::kStageBytes) >> 4);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kBK, 0>(
            sc_, dqn_ + (((kk >> 2) * (kBQ * 128) + (kk & 3) * 32) >> 4),
            dk_ + (((kk >> 2) * (kBK * 128) + (kk & 3) * 32) >> 4), kk > 0);
    };
    // O += P V from slot s_: V is B N-major (its rows hold hd columns),
    // in 64-column groups kBK * 128 bytes apart; a k-step is 16 rows
    auto pv = [&](float* o_, uint32_t (*pf_)[4], int s_) {
      const uint64_t dv_ = dvv + ((s_ * C::kStageBytes) >> 4);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<kHDP, 1>(o_, pf_[kk], dv_ + ((kk * 16 * 128) >> 4), 1);
    };
    // O's rescale to a row's new max, skipped by a warp whose 16 rows all
    // kept theirs
    auto rescale = [&](float* o_, float2 corr) {
      if (!__any_sync(0xffffffffu, corr.x != 1.f || corr.y != 1.f)) return;
#pragma unroll
      for (int j = 0; j < kHDP / 8; ++j) {
        o_[4 * j] *= corr.x;
        o_[4 * j + 1] *= corr.x;
        o_[4 * j + 2] *= corr.y;
        o_[4 * j + 3] *= corr.y;
      }
    };
    // this warp is done with slot s_ (its products have completed)
    auto release = [&](int s_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s_]);
    };

    int i = 0;                               // ring tiles
    // tile n of this block rides in Q slot n % kQSlots; -1 ends the walk
    // (the loop's test at its top keeps the consumers' register budget:
    // a break after the wait spills at hd 256)
    mbar_wait(&q_full[0], 0);
    int n = 0;
    for (int tile = tile_s[0]; tile >= 0;
         mbar_wait(&q_full[n % C::kQSlots], (n / C::kQSlots) & 1),
             tile = tile_s[n % C::kQSlots]) {
      const int qn = n % C::kQSlots;
      ++n;
      const uint64_t dqn = dq + ((qn * C::kQBytes) >> 4);
      const WgWork w = wg_work<kBQ, kBK>(a, tile);
      const int r_lo = w.q0 + 64 * cw, r_hi = r_lo + 63;  // this group's
      const int row0 = r_lo + 16 * warp + g, row1 = row0 + 8;
      // the key tiles this group's rows see: [wb, we) of [t_begin, t_end),
      // the tiles the producer loaded (a window past kv_len can start
      // beyond t_end: then wb = we = t_end and every loaded tile is
      // skipped)
      int wb = w.t_begin, we = w.t_end;
      if (r_lo >= S) {
        we = wb;
      } else {
        if (a.window > 0)
          wb = min(max(wb, max(0, r_lo - a.window + 1) / kBK), w.t_end);
        if (a.causal) we = min(we, min(r_hi, S - 1) / kBK + 1);
        we = max(we, wb);
      }

      float o[kHDP / 2];
#pragma unroll
      for (int j = 0; j < kHDP / 2; ++j) o[j] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      int it = w.t_begin;
      for (; it < wb; ++it, ++i) {           // tiles no row here sees
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
        release(i % kStages);
      }
      if constexpr (!C::kOverlap) {
        // each tile: S, its softmax, then O += P V
        for (; it < we; ++it, ++i) {
          const int s = i % kStages;
          mbar_wait(&full[s], (i / kStages) & 1);
          float sc[kBK / 2];
          uint32_t pf[kBK / 16][4];
          wgmma_fence();
          qk(sc, dqn, s);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc, kBK / 2);
          rescale(o, wg_softmax<kBK>(sc, pf, m0, m1, l0, l1, a, it * kBK,
                                     row0, row1, r_lo, r_hi, t, sl2));
          fence_regs(o, kHDP / 2);
          wgmma_fence();
          pv(o, pf, s);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o, kHDP / 2);
          release(s);
        }
      } else if (wb < we) {
        // one product phase a tile: the last tile's O += P V beside this
        // tile's S, then this tile's softmax; a last phase for the last
        // P V.  O, S and P are live at once.
        float sc[kBK / 2];
        uint32_t pf[kBK / 16][4];
        int sp = i % kStages;
        mbar_wait(&full[sp], (i / kStages) & 1);
        wgmma_fence();
        qk(sc, dqn, sp);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc, kBK / 2);
        wg_softmax<kBK>(sc, pf, m0, m1, l0, l1, a, it * kBK, row0, row1,
                        r_lo, r_hi, t, sl2);
        ++it, ++i;
        for (; it < we; ++it, ++i) {
          const int s = i % kStages;
          mbar_wait(&full[s], (i / kStages) & 1);
          fence_regs(o, kHDP / 2);
          wgmma_fence();
          pv(o, pf, sp);
          qk(sc, dqn, s);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o, kHDP / 2);
          fence_regs(sc, kBK / 2);
          release(sp);
          rescale(o, wg_softmax<kBK>(sc, pf, m0, m1, l0, l1, a, it * kBK,
                                     row0, row1, r_lo, r_hi, t, sl2));
          sp = s;
        }
        fence_regs(o, kHDP / 2);
        wgmma_fence();
        pv(o, pf, sp);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o, kHDP / 2);
        release(sp);
      }
      for (; it < w.t_end; ++it, ++i) {      // tiles past this group's
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
        release(i % kStages);
      }
      // ... and with Q and the tile index: the slot may take the next
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[qn]);

      // the quad's four lanes hold a row's partial sums
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      bf16* ob = a.out + w.b * a.o_sb + w.h * a.o_sh;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (row0 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * a.o_ss +
                                             col) =
              __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (row1 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * a.o_ss +
                                             col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
  }
}

// One 4-d map (hd, S, heads, batch) of a bf16 view from the wrapper's
// numbers (tma_map in kernels/flash_attn.py): 4 dims, the byte strides
// of S, heads and batch, the box (64 columns, rows); 128-byte swizzle,
// out-of-bounds boxes filled with zeros.
bool encode_map(CUtensorMap* map, const void* base, const long long* p) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4] = {(cuuint32_t)p[7], (cuuint32_t)p[8], 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)p[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)p[4 + i];
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SMs, the persistent grid's size
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// plan: block_q, block_k, stages, threads, smem bytes (flash_plan)
template <int HD>
cudaError_t launch_wg(const void* q, const void* k, const void* v,
                      WgArgs a, int batch, const int* plan,
                      const long long* maps, cudaStream_t stream) {
  using C = WgTile<HD>;
  if (plan[0] != C::kBQ || plan[1] != C::kBK || plan[2] != C::kStages ||
      plan[3] != C::kThreads || plan[4] != (int)C::kSmem ||
      maps[8] != C::kBQ || maps[17] != C::kBK || maps[26] != C::kBK)
    return cudaErrorInvalidValue;
  a.q_tiles = (a.seq + C::kBQ - 1) / C::kBQ;
  const long long tiles = (long long)batch * a.heads * a.q_tiles;
  const int sms = sm_count();
  if (tiles > 0x7fffffffLL || sms == 0) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, maps) || !encode_map(&tk, k, maps + 9) ||
      !encode_map(&tv, v, maps + 18))
    return cudaErrorInvalidValue;
  auto kernel = flash_attn_wg_kernel<HD>;
  // the shared memory attribute, once a device: it holds for later
  // launches
  static unsigned long long attr_set = 0;   // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (err != cudaSuccess) return err;
    attr_set |= bit;
  }
  const int grid = tiles < sms ? (int)tiles : sms;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

cudaError_t dispatch_wg(int hd, const void* q, const void* k, const void* v,
                        const WgArgs& a, int batch, const int* plan,
                        const long long* maps, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_wg<64>(q, k, v, a, batch, plan, maps, stream);
    case 96: return launch_wg<96>(q, k, v, a, batch, plan, maps, stream);
    case 128: return launch_wg<128>(q, k, v, a, batch, plan, maps, stream);
    case 256: return launch_wg<256>(q, k, v, a, batch, plan, maps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

enum Route { kCudaCores = 0, kMmaSync = 1, kWgmma = 2 };

// route: the plan's (flash_plan); plan: block_q, block_k, stages,
// threads, smem bytes; maps: the wgmma route's tensor maps of q, k and v,
// 9 numbers each (tma_map); counter: one int, 0, that the wgmma route
// counts its tiles on and leaves at 0.  The other routes read none.
extern "C" int flash_attn(
    const void* q, const void* k, const void* v, void* out, int batch,
    int heads, int kv_heads, int seq, int seq_k, int head_dim,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, int kv_len, float scale, int dtype, int route,
    const int* plan, const long long* maps, void* counter, void* stream) {
  if (batch == 0 || heads == 0 || seq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kWgmma) {
    if (dtype != kBF16 || plan[0] <= 0) return cudaErrorInvalidValue;
    const WgArgs wa{static_cast<bf16*>(out), static_cast<int*>(counter),
                    heads, kv_heads, seq, seq_k, 0, 0, o_sb, o_sh, o_ss,
                    causal, window, kv_len, scale};
    return dispatch_wg(head_dim, q, k, v, wa, batch, plan, maps, s);
  }
  const int q_tiles = (seq + kBQ - 1) / kBQ;
  Args a{q, k, v, out, heads, kv_heads, seq, seq_k, q_tiles,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         o_sb, o_sh, o_ss, causal, window, kv_len, scale};
  const long long blocks = (long long)batch * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (route == kCudaCores && dtype == kF32)
    return dispatch_hd<float>(head_dim, a, (int)blocks, s);
  if (route == kMmaSync && dtype == kBF16)
    return dispatch_tc(head_dim, a, batch, s);
  return cudaErrorInvalidValue;
}
