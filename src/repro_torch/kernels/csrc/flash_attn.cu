// Flash attention for prefill (causal / windowed / kv_len-masked) for
// Hopper (sm_90a), in three kernels picked by dtype and head dim (the
// wrapper's flash_plan in kernels/flash_attn.py): bf16 at hd 64..256 and
// bf16 at hd 16 and 32, both on wgmma with TMA and a producer warpgroup
// (the plan's "wgmma" route), f32 on the CUDA cores.
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
// - the online softmax stays in registers (a quad-lane row max, one
//   FFMA and one ex2 a weight, f32 row sums a lane, added across the
//   quad once at the end).  Masks are evaluated
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
// bf16 at hd 16 and 32 (flash_attn_nw_kernel), paper-backbone's prefill
// (8 heads of 32).  Here the products are the smaller part: a valid pair
// costs 4 hd = 128 flops at hd 32 (1/32 of a clock of an SM's tensor
// cores) but one ex2 (1/16 of a clock of its MUFU), and the softmax's
// other instructions (an FFMA, a max, half a pack a weight) and each key
// tile's bookkeeping compete with the ex2s for issue slots:
// - the FlashAttention-3 skeleton of the route above (persistent blocks
//   over a tile counter, a producer warpgroup of which one thread issues
//   every TMA load into a ring of K/V stages with full and empty
//   mbarriers and two Q slots, setmaxnreg moving the producer's
//   registers to the consumers), with rows of hd bf16 in the 64-byte
//   (hd 32) or 32-byte (hd 16) swizzle that TMA writes and the wgmma
//   descriptors name (CU_TENSOR_MAP_SWIZZLE_64B / 32B: one box of hd
//   columns a tile, no padding);
// - a block is the producer and one consumer warpgroup of 64 query
//   rows, three blocks an SM, each over its own tiles: the blocks drift
//   apart, so one block's softmax overlaps another's products and
//   barriers (three or four consumer warpgroups of one block sharing a
//   ring ran their softmaxes in lockstep, the MUFU idle between them);
// - in a warpgroup, key tile j's S = Q K^T (m64n64k16, both operands in
//   shared memory) and tile j - 1's O += P V (P from registers, V
//   N-major) are issued together; S is waited, and the softmax runs on
//   the CUDA cores and the MUFU while the tensor cores finish P V
//   (FlashAttention-3's order).  No branch and no ring wait stands
//   between a product and its wait (ptxas would serialize the
//   products): a tile that needs masks runs its own copy of the step,
//   whose masks are selects on each row's valid columns [lo, hi), and
//   the first tile's P V is 0 times a landed V;
// - the row sums of P, as rounded to bf16 (the weights O is built
//   from), come out of P V itself: V's tile is followed, one swizzle
//   atom on, by a tile of ones, so P V runs at n = hd + 8 and its last 8
//   columns are the sums (no FADD a weight, no product of its own);
// - a block's first tile is blockIdx.x (no counter on the path to its
//   first loads); the counter hands out the rest, query tile first, the
//   heaviest causal tiles of every (batch, head) before any lighter one.
// The geometry (NwTile: keys a tile, blocks an SM, ring stages), the
// row sums' form (FADDs a weight lost from 8 x 1024 up) and the order
// (issuing the next tile's S before this tile's softmax kept two S
// register sets and lost) were chosen among measured variants:
// tools/k2_prefill_ab.py --variants and PERF.md.
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

// the key tiles [t_begin, t_end) that any of the BQ rows from q0 sees
template <int BQ, int BK>
__device__ __forceinline__ void tile_cols(const WgArgs& a, WgWork& w) {
  const int row_hi = min(w.q0 + BQ, a.seq) - 1;
  int col_end = a.seq_k;
  if (a.causal) col_end = min(col_end, row_hi + 1);
  if (a.kv_len >= 0) col_end = min(col_end, a.kv_len);
  const int col_begin = a.window > 0 ? max(0, w.q0 - a.window + 1) : 0;
  w.t_begin = col_begin / BK;
  w.t_end = col_end > 0 ? (col_end + BK - 1) / BK : 0;
}

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
  tile_cols<BQ, BK>(a, w);
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
          // (with one tile a block, no take reached the counter)
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

// ---------------------------------------- bf16 route on wgmma, hd 16/32 --
// Tile shapes of the narrow route (flash_attn_nw_kernel), chosen among
// measured variants (tools/k2_prefill_ab.py --variants, PERF.md).
// flash_plan in kernels/flash_attn.py mirrors them (NW_BLOCK_K,
// NW_STAGES, NW_CONSUMER_REGS) and passes them in; the entry refuses a
// plan that differs.  A block is the producer warpgroup and one consumer
// warpgroup of 64 query rows, three blocks an SM.
template <int HD>
struct NwTile {
  static_assert(HD == 16 || HD == 32, "hd 64..256 run on WgTile");
  static constexpr int kBQ = 64;                        // query rows
  static constexpr int kBK = 64;                        // keys a tile
  static constexpr int kStages = 3;                     // K/V ring slots
  static constexpr int kMinBlocks = 3;                  // blocks an SM
  static constexpr int kThreads = 256;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 136;
  // setmaxnreg: the two warpgroups' registers within what the launch
  // gives a thread at kMinBlocks blocks an SM (a multiple of 8)
  static_assert(128 * (kProducerRegs + kConsumerRegs) <=
                    kThreads * ((65536 / (kMinBlocks * kThreads)) & ~7),
                "setmaxnreg beyond the launch's registers");
  // a row of hd bf16 is the swizzle span: 64 bytes at hd 32, 32 at 16
  static constexpr int kRowBytes = 2 * HD;
  static constexpr uint32_t kLayout = HD == 32 ? kSwizzle64 : kSwizzle32;
  static constexpr int kAtom = 8 * kRowBytes;           // SBO: 8 rows
  static constexpr int kQSlots = 2;
  static constexpr int kQBytes = kBQ * kRowBytes;
  static constexpr int kTileBytes = kBK * kRowBytes;    // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  // the row sums: a tile of ones after the ring, which P V reads as 8
  // more columns of V (n = hd + 8): the swizzle atom after V's
  static constexpr int kOnesBytes = kTileBytes;
  static constexpr int kN = HD + 8;
  // + 1024: a 1024-byte aligned base; the Q slots, the ring, the ones,
  // the barriers (full, empty a stage and a Q slot), tile indices
  static constexpr size_t kSmem = 1024 + (size_t)kQSlots * kQBytes +
                                  (size_t)kStages * kStageBytes +
                                  (size_t)kOnesBytes +
                                  8 * (2 * kStages + 2 * kQSlots) + 16;
};

// One output tile of the narrow route: kBQ query rows of one (batch,
// head).  Tiles are numbered query tile first, the heaviest causal tiles
// of every (batch, head) before any lighter one, so the light tiles fill
// the tail; at one query tile the (batch, head) pairs run side by side
// (a GQA group's heads next to each other), and their K/V (128 bytes a
// key at hd 32) stay in L2.
template <int BQ, int BK>
__device__ __forceinline__ WgWork nw_work(const WgArgs& a, int tile) {
  const int pairs = a.tiles / a.q_tiles;
  const int bh = tile % pairs;
  WgWork w;
  w.b = bh / a.heads;
  w.h = bh % a.heads;
  w.kh = w.h / (a.heads / a.kv_heads);
  w.q0 = (a.q_tiles - 1 - tile / pairs) * BQ;
  tile_cols<BQ, BK>(a, w);
  return w;
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// The online softmax of one S tile of the narrow route, in registers, as
// wg_softmax but in two halves, so that the exponentials can run in turns
// (nw_exp), and in place (the weights, in f32, overwrite the scores;
// nw_pack rounds them to P's A fragments).  nw_max: the masks of a tile
// that needs them as each row's valid columns [lo, hi) (MASK), the rows'
// new max and shift sh (the scores are turned into log2 units by sl2 in
// the exponentials' FFMA); returns the rows' rescale of O.
template <int BK, bool MASK>
__device__ __forceinline__ float2 nw_max(float* sc, float& m0, float& m1,
                                         float& sh0, float& sh1, int c0,
                                         int lo0, int hi0, int lo1, int hi1,
                                         int t, float sl2) {
  if constexpr (MASK) {
    // column c is valid for a row iff c - lo, as unsigned, is below the
    // row's count of valid columns: one compare a score
    const int d0 = c0 + 2 * t - lo0, d1 = c0 + 2 * t - lo1;
    const unsigned n0 = (unsigned)max(hi0 - lo0, 0);
    const unsigned n1 = (unsigned)max(hi1 - lo1, 0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 8 * j + (e & 1);
        const bool valid = e < 2 ? (unsigned)(d0 + k) < n0
                                 : (unsigned)(d1 + k) < n1;
        if (!valid) sc[4 * j + e] = kNegInf;
      }
  }
  // each row's max in four independent chains (a chain of BK / 4 maxima
  // would wait on each one's latency), then across the quad
  float a[4], b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a[e] = sc[4 * (e >> 1) + (e & 1)];
    b[e] = sc[4 * (e >> 1) + 2 + (e & 1)];
  }
#pragma unroll
  for (int j = 2; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      a[2 * (j & 1) + e] = fmaxf(a[2 * (j & 1) + e], sc[4 * j + e]);
      b[2 * (j & 1) + e] = fmaxf(b[2 * (j & 1) + e], sc[4 * j + 2 + e]);
    }
  float mx0 = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  float mx1 = fmaxf(fmaxf(b[0], b[1]), fmaxf(b[2], b[3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  sh0 = mn0 == kNegInf ? 0.f : -mn0 * sl2;
  sh1 = mn1 == kNegInf ? 0.f : -mn1 * sl2;
  const float2 corr =
      make_float2(mn0 == m0 ? 1.f : ex2(fmaf(m0, sl2, sh0)),
                  mn1 == m1 ? 1.f : ex2(fmaf(m1, sl2, sh1)));
  m0 = mn0;
  m1 = mn1;
  return corr;
}

// nw_exp: the weights exp2(s sl2 + sh), one FFMA and one ex2 each (the
// row sums come out of O += P V)
template <int BK>
__device__ __forceinline__ void nw_exp(float* sc, float sh0, float sh1,
                                       float sl2) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, e < 2 ? sh0 : sh1));
}

// the weights of nw_exp rounded to bf16 as the A fragments of O += P V
// (n-blocks 2 kk and 2 kk + 1 of the S accumulator make k-step kk)
template <int BK>
__device__ __forceinline__ void nw_pack(const float* sc, uint32_t (*pf)[4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pf[j >> 1][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// Persistent, as flash_attn_wg_kernel: the producer thread takes the
// tiles and runs ahead into their Q and K/V; the consumer warpgroup walks
// each tile's key tiles, a key tile's softmax beside the last one's P V.
template <int HD>
__global__ void __launch_bounds__(NwTile<HD>::kThreads,
                                  NwTile<HD>::kMinBlocks)
    flash_attn_nw_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         WgArgs a) {
  using C = NwTile<HD>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kStages = C::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // the Q slots (kBQ rows each), the ring (each stage K's kBK rows, then
  // V's), bf16 ones (the row sums' columns of V), barriers, tile indices
  unsigned char* q_s = smem;
  unsigned char* kv_s = q_s + C::kQSlots * C::kQBytes;
  unsigned char* ones = kv_s + kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + C::kOnesBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + C::kQSlots;
  volatile int* tile_s =
      reinterpret_cast<volatile int*>(q_empty + C::kQSlots);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);                   // a consumer warp each
    }
    for (int s = 0; s < C::kQSlots; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread takes the tiles and issues
    // every TMA load (one box of hd columns a tile of Q, K or V)
    setmaxnreg_dec<C::kProducerRegs>();
    if (tid == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      int i = 0;                           // ring loads
      for (int n = 0;; ++n) {              // tiles of this block
        // the first tile is the block's own: no counter on the path to
        // its loads; the counter hands out the rest from gridDim.x on,
        // and is not touched when every block has one tile at most
        const int tile = n == 0 ? (int)blockIdx.x
                         : a.tiles <= (int)gridDim.x
                             ? a.tiles
                             : (int)gridDim.x + atomicAdd(a.counter, 1);
        const int qn = n % C::kQSlots;
        const uint32_t q_phase = (n / C::kQSlots) & 1;
        if (tile >= a.tiles) {
          // each block's last take overshoots once: the launch's last
          // take of all resets the counter for the next launch
          if (tile == a.tiles + (int)gridDim.x - 1) *a.counter = 0;
          // (with one tile a block, no take reached the counter)
          mbar_wait(&q_empty[qn], q_phase ^ 1);
          tile_s[qn] = -1;
          mbar_arrive(&q_full[qn]);
          break;
        }
        const WgWork w = nw_work<kBQ, kBK>(a, tile);
        auto load_q = [&]() {
          mbar_wait(&q_empty[qn], q_phase ^ 1);
          tile_s[qn] = tile;
          mbar_expect_tx(&q_full[qn], C::kQBytes);
          tma_load_4d(q_s + qn * C::kQBytes, &tm_q, &q_full[qn], 0, w.q0,
                      w.h, w.b);
        };
        for (int it = w.t_begin; it < w.t_end; ++it, ++i) {
          const int s = i % kStages;
          mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::kStageBytes);
          unsigned char* ks = kv_s + s * C::kStageBytes;
          tma_load_4d(ks, &tm_k, &full[s], 0, it * kBK, w.kh, w.b);
          tma_load_4d(ks + C::kTileBytes, &tm_v, &full[s], 0, it * kBK,
                      w.kh, w.b);
          if (it == w.t_begin) load_q();
        }
        if (w.t_begin >= w.t_end) load_q();   // no key to see: Q alone
      }
    }
  } else {
    // ---- consumer warpgroup: the tile's 64 query rows
    setmaxnreg_inc<C::kConsumerRegs>();
    const int warp = (tid / 32) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int S = a.seq;
    const float sl2 = a.scale * kLog2e;
    // the ones, written while the first loads are in flight (the generic
    // writes fenced before wgmma reads them)
    const uint4 one8 = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u,
                                  0x3f803f80u);      // bf16 1.0, 8 times
    for (int i = tid - 128; i < C::kOnesBytes / 16; i += 128)
      reinterpret_cast<uint4*>(ones)[i] = one8;
    fence_proxy_async();
    named_bar_sync(1, 128);
    // descriptors (the start address and LBO fields take bytes / 16): Q
    // and K K-major; V N-major, hd columns a swizzle atom, the next atom
    // (columns hd.. of P V: the ones) LBO bytes on, at the ones tile
    const uint64_t dq = wgmma_desc(q_s, 16, C::kAtom, C::kLayout);
    const uint64_t dk = wgmma_desc(kv_s, 16, C::kAtom, C::kLayout);
    const uint64_t dv =
        wgmma_desc(kv_s + C::kTileBytes,
                   (uint32_t)(ones - (kv_s + C::kTileBytes)), C::kAtom,
                   C::kLayout);

    // S = Q K^T from ring slot s_: a k-step is 32 bytes into the rows
    auto qk = [&](float* sc_, uint64_t dqn_, int s_) {
      const uint64_t dk_ = dk + ((s_ * C::kStageBytes) >> 4);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kBK, 0>(sc_, dqn_ + ((kk * 32) >> 4),
                         dk_ + ((kk * 32) >> 4), kk > 0);
    };
    // O += P V from slot s_ (a k-step is 16 rows of V), and with them
    // the row sums of P, as rounded to bf16: slot s_'s V is s_ stages on
    // from slot 0's, the ones as many bytes nearer (LBO)
    auto pv = [&](float* o_, uint32_t (*pf_)[4], int s_) {
      const uint64_t d = (uint64_t)((s_ * C::kStageBytes) >> 4);
      const uint64_t dv_ = dv + d - (d << 16);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<C::kN, 1>(o_, pf_[kk],
                           dv_ + ((kk * 16 * C::kRowBytes) >> 4), 1);
    };
    // this warp is done with slot s_
    auto release = [&](int s_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s_]);
    };

    // the arguments a step reads, in registers
    const int causal = a.causal, window = a.window;
    const int lim = a.kv_len >= 0 ? min(a.seq_k, a.kv_len) : a.seq_k;
    int s_next = 0;                          // ring slot of the next tile
    uint32_t ph_next = 0;                    // ... and its phase
    auto advance = [&]() {
      if (++s_next == kStages) {
        s_next = 0;
        ph_next ^= 1;
      }
    };
    mbar_wait(&q_full[0], 0);
    int n = 0;
    for (int tile = tile_s[0]; tile >= 0;
         mbar_wait(&q_full[n % C::kQSlots], (n / C::kQSlots) & 1),
             tile = tile_s[n % C::kQSlots]) {
      const int qn = n % C::kQSlots;
      ++n;
      const uint64_t dqn = dq + ((qn * C::kQBytes) >> 4);
      const WgWork w = nw_work<kBQ, kBK>(a, tile);
      const int r_lo = w.q0, r_hi = r_lo + kBQ - 1;
      const int row0 = r_lo + 16 * warp + g, row1 = row0 + 8;
      // each row's valid columns [lo, hi); the tiles [m_lo, m_hi) need
      // no mask (past the window's edge for every row, before the
      // diagonal, kv_len and S_k)
      const int hi0 = causal ? min(lim, row0 + 1) : lim;
      const int hi1 = causal ? min(lim, row1 + 1) : lim;
      const int lo0 = window > 0 ? row0 - window + 1 : 0;
      const int lo1 = window > 0 ? row1 - window + 1 : 0;
      const int m_lo =
          window > 0 && r_hi - window >= 0 ? (r_hi - window) / kBK + 1 : 0;
      const int m_hi = min(lim / kBK, causal ? (r_lo + 1) / kBK : lim);

      // O, and the row sums in its n-block hd / 8 (rows row0, row1 at
      // [hd / 2] and [hd / 2 + 2])
      float o[C::kN / 2];
#pragma unroll
      for (int j = 0; j < C::kN / 2; ++j) o[j] = 0.f;
      float m0 = kNegInf, m1 = kNegInf;
      // O's rescale to a row's new max, skipped by a warp whose 16 rows
      // all kept theirs
      auto rescale = [&](float2 corr) {
        if (!__any_sync(0xffffffffu, corr.x != 1.f || corr.y != 1.f))
          return;
#pragma unroll
        for (int j = 0; j < C::kN / 8; ++j) {
          o[4 * j] *= corr.x;
          o[4 * j + 1] *= corr.x;
          o[4 * j + 2] *= corr.y;
          o[4 * j + 3] *= corr.y;
        }
      };
      if (w.t_begin < w.t_end) {
        // P of the last tile, rounded to bf16 (at the first: 0, so the
        // first step's P V adds 0 times a landed V)
        uint32_t pf[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          pf[kk][0] = pf[kk][1] = pf[kk][2] = pf[kk][3] = 0u;
        int s_last = s_next;                 // the last tile's slot
        // tile j: its S and the last tile's P V issued, S waited, its
        // softmax beside the P V, then that waited (FlashAttention-3's
        // order): S in one register set
        float sc[kBK / 2];
        auto step = [&](auto mask, int j) {
          const int s_cur = s_next;
          mbar_wait(&full[s_cur], ph_next);
          advance();
          pin_regs(o, C::kN / 2);
          pin_regs(&pf[0][0], kBK / 4);
          wgmma_fence();
          qk(sc, dqn, s_cur);
          wgmma_commit();
          pv(o, pf, s_last);
          wgmma_commit();
          wgmma_wait<1>();
          pin_regs(sc, kBK / 2);
          float sh0, sh1;
          float2 corr = nw_max<kBK, decltype(mask)::value != 0>(
              sc, m0, m1, sh0, sh1, j * kBK, lo0, hi0, lo1, hi1, t, sl2);
          nw_exp<kBK>(sc, sh0, sh1, sl2);
          pin_regs(sc, kBK / 2);
          pin_regs(&corr.x, 1);
          pin_regs(&corr.y, 1);
          wgmma_wait<0>();
          pin_regs(o, C::kN / 2);
          if (j > w.t_begin) release(s_last);
          rescale(corr);
          nw_pack<kBK>(sc, pf);
          s_last = s_cur;
        };
        for (int j = w.t_begin; j < w.t_end; ++j) {
          if (j < m_lo || j >= m_hi)
            step(Int<1>{}, j);
          else
            step(Int<0>{}, j);
        }
        // the last tile's P V
        pin_regs(o, C::kN / 2);
        pin_regs(&pf[0][0], kBK / 4);
        wgmma_fence();
        pv(o, pf, s_last);
        wgmma_commit();
        wgmma_wait<0>();
        pin_regs(o, C::kN / 2);
        release(s_last);
      }
      // done with Q and the tile index: the slot may take the next
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[qn]);

      // each lane holds its rows' sums
      const float inv0 = 1.f / fmaxf(o[HD / 2], 1e-30f);
      const float inv1 = 1.f / fmaxf(o[HD / 2 + 2], 1e-30f);
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
// of S, heads and batch, the box (columns, rows); the swizzle spans the
// box's row (64 columns: 128 bytes; hd 32: 64; hd 16: 32), boxes past
// the view's edges filled with zeros.
bool encode_map(CUtensorMap* map, const void* base, const long long* p) {
  CUtensorMapSwizzle swizzle;
  switch (p[7]) {
    case 64: swizzle = CU_TENSOR_MAP_SWIZZLE_128B; break;
    case 32: swizzle = CU_TENSOR_MAP_SWIZZLE_64B; break;
    case 16: swizzle = CU_TENSOR_MAP_SWIZZLE_32B; break;
    default: return false;
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4] = {(cuuint32_t)p[7], (cuuint32_t)p[8], 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)p[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)p[4 + i];
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the dynamic shared memory attribute of a kernel, once a device: it
// holds for later launches (`set` keeps a bit a device)
cudaError_t smem_attr_once(const void* kernel, size_t bytes,
                           unsigned long long* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(*set & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    *set |= bit;
  }
  return cudaSuccess;
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
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      smem_attr_once((const void*)kernel, C::kSmem, &attr_set);
  if (err != cudaSuccess) return err;
  const int grid = tiles < sms ? (int)tiles : sms;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// plan: block_q, block_k, stages, threads, smem bytes (flash_plan)
template <int HD>
cudaError_t launch_nw(const void* q, const void* k, const void* v,
                      WgArgs a, int batch, const int* plan,
                      const long long* maps, cudaStream_t stream) {
  using C = NwTile<HD>;
  if (plan[0] != C::kBQ || plan[1] != C::kBK || plan[2] != C::kStages ||
      plan[3] != C::kThreads || plan[4] != (int)C::kSmem ||
      maps[7] != HD || maps[8] != C::kBQ || maps[16] != HD ||
      maps[17] != C::kBK || maps[25] != HD || maps[26] != C::kBK)
    return cudaErrorInvalidValue;
  a.q_tiles = (a.seq + C::kBQ - 1) / C::kBQ;
  const long long tiles = (long long)batch * a.heads * a.q_tiles;
  const long long slots = (long long)sm_count() * C::kMinBlocks;
  if (tiles > 0x7fffffffLL || slots == 0) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, maps) || !encode_map(&tk, k, maps + 9) ||
      !encode_map(&tv, v, maps + 18))
    return cudaErrorInvalidValue;
  auto kernel = flash_attn_nw_kernel<HD>;
  static unsigned long long attr_set = 0;
  const cudaError_t err =
      smem_attr_once((const void*)kernel, C::kSmem, &attr_set);
  if (err != cudaSuccess) return err;
  const int grid = (int)(tiles < slots ? tiles : slots);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

cudaError_t dispatch_wg(int hd, const void* q, const void* k, const void* v,
                        const WgArgs& a, int batch, const int* plan,
                        const long long* maps, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_nw<16>(q, k, v, a, batch, plan, maps, stream);
    case 32: return launch_nw<32>(q, k, v, a, batch, plan, maps, stream);
    case 64: return launch_wg<64>(q, k, v, a, batch, plan, maps, stream);
    case 96: return launch_wg<96>(q, k, v, a, batch, plan, maps, stream);
    case 128: return launch_wg<128>(q, k, v, a, batch, plan, maps, stream);
    case 256: return launch_wg<256>(q, k, v, a, batch, plan, maps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

enum Route { kCudaCores = 0, kWgmma = 2 };

// route: the plan's (flash_plan); plan: block_q, block_k, stages,
// threads, smem bytes; maps: the wgmma route's tensor maps of q, k and v,
// 9 numbers each (tma_map); counter: one int, 0, that the wgmma route
// counts its tiles on and leaves at 0.  The f32 route reads none.
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
  return cudaErrorInvalidValue;
}
