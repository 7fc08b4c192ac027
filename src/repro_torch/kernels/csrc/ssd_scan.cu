// Mamba2 chunked SSD scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` in
// src/repro/kernels/ssd_scan.py (pallas_call at line 82, kernel body
// `_ssd_kernel` at line 24), and computes what the model's
// `ssm.ssd_scan_ref` computes.  Plain versions:
// repro_torch.kernels.ref.ssd_scan_ref (the model's layout) and
// repro_torch.kernels.ref.ssd_scan_kernel_ref (the Pallas layout).
//
// What it computes: for every (batch, head), the sequence is cut into
// chunks of L rows.  With cs the cumulative sum of dt * a inside a
// chunk, xd = x * dt and the (P, N) state carried from chunk to chunk:
//   y_l    = sum_{s <= l} (c_l . b_s) exp(cs_l - cs_s) xd_s
//            + exp(cs_l) (state c_l)
//   state' = exp(cs_last) state + sum_s exp(cs_last - cs_s) xd_s b_s^T
// Head h reads group h / (H / G) of b and c.  The final state is
// written out.  Rows past S are absent, which is what the plain
// version's padding with dt = 0 rows amounts to, so any S works.  All
// sums are f32; y is rounded once to the requested dtype.  The decay
// exponent is masked before exp (only pairs s <= l are evaluated), so
// the upper triangle, where the segment sum is positive and could
// overflow, never produces inf * 0.  x, dt, b, c and y are read and
// written in place through their strides, so the model's (B, S, H, P)
// views of the conv output need no copy, and the Pallas layout (BH, S,
// P) is the view B = 1, H = G = BH.  No atomics on values: a repeat is
// bit for bit the same.
//
// Two routes, by dtype:
//
// * bf16 x, b, c (y bf16 or f32): namespace wg, one launch.  What bounds
//   it on the H100: at the served prefill burst (mamba2-370m, 8 prompts
//   x 2048 tokens, H 32, P 64, N 128, G 1, L 256) each input read once
//   and each output written once is ~153 MB (x and y 67 MB each, b and c
//   8.4, dt 2.1, the final state 8.4): 0.046 ms at 3.35 TB/s; the causal
//   products alone, ~43 GFLOP, about as long.  The products this route
//   issues, with every f32 operand split in two (below): per (head,
//   chunk) 10.5 MFLOP of scores, 10.5 of W' x, 8.4 of the carried
//   state's term and 8.4 of the chunk's own state, ~77 GFLOP in all,
//   0.078 ms at 989 TFLOP/s.  At zamba2-1.2b's 8 x 1024 (H 64, P 64, N
//   64) ~147 MB (0.044 ms) and ~49 GFLOP issued (0.050 ms).  The design:
//   - one launch, persistent (a block an SM, 384 threads: a producer
//     warpgroup and two consumer warpgroups).  A work item is one chunk
//     of one batch element and head; blocks take items from a ticket
//     counter in chunk order (every item of chunk 0, then chunk 1, ...),
//     never by blockIdx.  Two heads an item sharing the scores of a
//     group were built and timed slower (their registers spilled past
//     the 168 a thread a 384-thread block allows; PERF.md);
//   - the state is chained through L2 in chunk order: an item computes
//     its chunk's own state S = X'^T B, then reads the state entering
//     its chunk, which the item of chunk k - 1 publishes into the
//     final-state buffer (one f32 (P, N) a (batch, head), 8.4 MB at the
//     burst, L2 resident), past L1 (ld.cg), and publishes exp(cs_last)
//     state_in + S for chunk k + 1 (the final state at the last chunk).
//     Each consumer warp that writes the head's state counts itself on
//     the head's flag after its stores (a fence, then an atomic add);
//     the item of chunk k reads once the flag reaches k x the warps a
//     chunk (one thread's acquire load, then a barrier of the two
//     consumer warpgroups).  A wait is only ever on a smaller ticket,
//     which a running block holds, so nothing deadlocks; the last chunk
//     resets the flag (it publishes nothing) and the last ticket taken
//     resets the counter, so every launch leaves them at zero (a CUDA
//     graph replays it as it is).  No (BH, chunks, P, N) workspace, no
//     second launch;
//   - the producer thread loads, through 4-d tensor maps over the
//     strided (B, S, H|G, P|N) views, the item's B and X in 64-row
//     tiles, one mbarrier each, the last tile first (the consumers free
//     the key tiles from the last down as their query tiles stop needing
//     them, so the next item's loads start during this item's last query
//     tiles), and the C tiles into two slots a consumer group; TMA fills
//     rows past S and columns past P or N with zeros.  Each byte of x, b
//     and c is read from device memory once an item (b and c once for
//     each of the H items of a (batch, chunk), from L2 after the first).
//     Two warps of the producer warpgroup work out the next item's
//     per-row values (dt, cumulative decays, the state weights, the
//     scores' decay factors) while the consumers compute this one;
//   - the consumers run every product on wgmma m64nNk16: the chunk's
//     own state X'^T B (X' = exp(cs_last - cs_s) dt_s x_s, split, as the
//     A operand from registers; B read N-major; a 64-column block each
//     group at N 128; two key tiles a product phase), then, a 64-row
//     query tile at a time (the two warpgroups take tiles {T-1, T-4} and
//     {T-2, T-3}), the scores C_i B_j^T with both operands in shared
//     memory (C_i stays in its slot for the tile; tile j + 1's scores
//     run while tile j's W' is worked out), W' = scores o decay o dt_s
//     (masked before exp on the diagonal tile; off it the decay is
//     factored at the key tile's last row, both exponents <= 0), split,
//     as the A operand from registers of W' X_j (X read N-major), and
//     last C_i state_in^T with the split state in shared memory.  P 32
//     runs in P 64's layout and N 32 in N 64's (the extra rows and
//     columns are TMA's zeros and are not stored);
//   - ptxas (CUDA 12.8, sm_90a): 168 registers a thread, no spills (it
//     allocates the consumers at the launch bound whatever setmaxnreg
//     gives them, so every design here fits 168).
//   f32 operands are split into a bf16 high part and a bf16 low part and
//   multiplied twice against the exact bf16 operand, which leaves
//   ~2^-17 of their value: W' against x (so xd is never rounded), the
//   carried state against C, X' against b.  C and B are exact bf16
//   operands.  The decays take ex2 of cs in log2 units (~2^-22
//   relative).  Chunks up to 256 rows (the whole chunk's B and X stay
//   in shared memory); the wrapper's plan refuses longer ones.
//
// * f32 x, b, c (y f32): namespace f32, the CUDA cores (TF32 would round
//   the products), in two launches on the caller's stream, so a
//   sequence's chunks run in parallel instead of one block walking them
//   in order:
//   1. chunk state, one block per (batch * head, chunk), the chunks of a
//      head adjacent: the chunk's cumulative decay cs (written to a
//      (BH, S) f32 workspace) and its local state sum_s exp(cs_last -
//      cs_s) xd_s b_s^T from a zero start, written to a (BH, chunks, P,
//      N) f32 workspace.  The last block of each (batch, head) to arrive
//      (fence, then an arrival counter in device memory that it resets)
//      carries the state across that head's chunks in order while they
//      are still in L2: state_{k+1} = exp(cs_last,k) state_k + S_k,
//      overwriting S_k with the state entering chunk k; the last one is
//      the final state;
//   2. chunk scan, grid (batch * head, chunk, 64-row query tile, the
//      heaviest tiles first): y = ((C B^T) o decay) xd + exp(cs) (C
//      state_in^T), key tiles j <= i of the chunk in turn.
//
// Interface: plain C, bound with ctypes.  `ssd_scan` (the f32 route)
// and `ssd_scan_wg` (the bf16 route) return the first cudaGetLastError()
// of their launches.  They launch on the caller's stream and allocate
// nothing: the wrapper passes the outputs, the f32 route's workspaces
// and the counters, sized by its plan.

#include "hopper.cuh"

namespace {

constexpr int kT = 64;                   // rows per tile
constexpr int kMaxChunk = 1024;

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* init;                     // (B, H, P, N) or null
  void* y;
  float* state;                          // (B, H, P, N)
  float* cs_ws;                          // (B * H, S): cumsum in a chunk
  float* st_ws;                          // (B * H, chunks, P, N)
  int* counters;                         // B * H, 0 between launches
  int heads, groups, seq, chunk, chunks, q_tiles;
  // strides in elements over (batch, seq, head or group); the last dim
  // of x, b, c and y is dense
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
};

// The chunk's dt (loaded by the whole block at once) and the inclusive
// cumsum of dt * a, by warp 0: each lane sums a run of rows, a warp scan
// adds the runs before it.  Every launch that needs cs reads what this
// wrote, so it is computed once.  Ends with a barrier.
template <int kThreads>
__device__ __forceinline__ void chunk_cumsum(const float* dtb,
                                             long long dt_ss, int c0,
                                             int rows, float av, int tid,
                                             float* dt_s, float* cs_s,
                                             float* cs_out) {
  for (int r = tid; r < rows; r += kThreads)
    dt_s[r] = dtb[(long long)(c0 + r) * dt_ss];
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    const int per = (rows + 31) / 32;
    const int r0 = lane * per;
    float run = 0.f;
    for (int k = 0; k < per; ++k) {
      const int r = r0 + k;
      if (r < rows) {
        run += dt_s[r] * av;
        cs_s[r] = run;
      }
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const float before = incl - run;
    for (int k = 0; k < per; ++k) {
      const int r = r0 + k;
      if (r < rows) {
        cs_s[r] += before;
        cs_out[c0 + r] = cs_s[r];
      }
    }
  }
  __syncthreads();
}

// Where a block's operands start: (batch, head) from the flat index.
struct Head {
  int bh, bi, h, g;
};
__device__ __forceinline__ Head head_of(const Args& a, int bh) {
  Head r;
  r.bh = bh;
  r.bi = bh / a.heads;
  r.h = bh % a.heads;
  r.g = r.h / (a.heads / a.groups);
  return r;
}

// The chunk-state block of chunk k of (batch, head) bh: the chunks of
// a head are adjacent in the grid, so they run at about the same time.
__device__ __forceinline__ void chunk_of(const Args& a, int& bh, int& k) {
  bh = blockIdx.x / a.chunks;
  k = blockIdx.x % a.chunks;
}

__device__ __forceinline__ float4 fma4(float e, float4 c, float4 s) {
  return make_float4(fmaf(e, c.x, s.x), fmaf(e, c.y, s.y), fmaf(e, c.z, s.z),
                     fmaf(e, c.w, s.w));
}

// After a chunk-state block has written its state: arrive, and if it is
// the last block of its (batch, head), carry the state across the
// chunks in order, 4 elements a thread at a time with the loads of 8
// chunks in flight.  The chunk-local state S_k is replaced by the state
// entering chunk k.  Every block of the launch reaches this point.
template <int P, int N, int kThreads>
__device__ __forceinline__ void arrive_and_carry(const Args& a, int bh,
                                                 int tid) {
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(a.counters + bh, 1) == a.chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int PN4 = P * N / 4;
  constexpr int kBatch = 8;
  float4* w = reinterpret_cast<float4*>(a.st_ws) +
              (long long)bh * a.chunks * PN4;
  const float* cs = a.cs_ws + (long long)bh * a.seq;
  for (int e = tid; e < PN4; e += kThreads) {
    float4 cur = a.init ? reinterpret_cast<const float4*>(a.init)[
                              (long long)bh * PN4 + e]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < a.chunks; k0 += kBatch) {
      float4 s[kBatch];
      float el[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = k0 + j;
        if (k < a.chunks) {
          s[j] = __ldcg(w + (long long)k * PN4 + e);
          el[j] = __ldcg(cs + min(a.seq, (k + 1) * a.chunk) - 1);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = k0 + j;
        if (k < a.chunks) {
          w[(long long)k * PN4 + e] = cur;
          cur = fma4(expf(el[j]), cur, s[j]);
        }
      }
    }
    reinterpret_cast<float4*>(a.state)[(long long)bh * PN4 + e] = cur;
  }
  if (tid == 0) a.counters[bh] = 0;       // ready for the next launch
}

// ================================================ f32: the CUDA cores ==
namespace f32 {

constexpr int kThreads = 256;            // a 16 x 16 thread grid

template <int P, int N>
__host__ __device__ constexpr size_t state_smem_floats(int chunk) {
  return (size_t)kT * (N + 1) + (size_t)kT * P + 2 * (size_t)chunk;
}

// (1) the chunk's local state, each thread a 4 x 8 (P = 64, N = 128)
// register tile: p = ty + 16 k, n = tx + 16 m; then the arrival, which
// carries the state in the last block of a head
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_chunk_state(Args a) {
  constexpr int NP = N + 1;
  constexpr int PK = P / 16, NK = N / 16;
  extern __shared__ float smem[];
  float* b_s = smem;                     // kT x NP
  float* u_s = b_s + kT * NP;            // kT x P: xd decayed to the end
  float* dt_s = u_s + kT * P;            // chunk
  float* cs_s = dt_s + a.chunk;          // chunk

  int bh, k;
  chunk_of(a, bh, k);
  const Head hd = head_of(a, bh);
  const int c0 = k * a.chunk;
  const int rows = min(a.chunk, a.seq - c0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* xb = static_cast<const float*>(a.x) + hd.bi * a.x_sb +
                    hd.h * a.x_sh;
  const float* dtb = a.dt + hd.bi * a.dt_sb + hd.h * a.dt_sh;
  const float* bb = static_cast<const float*>(a.b) + hd.bi * a.b_sb +
                    hd.g * a.b_sg;

  chunk_cumsum<kThreads>(dtb, a.dt_ss, c0, rows, a.a[hd.h], tid, dt_s,
                         cs_s, a.cs_ws + (long long)hd.bh * a.seq);
  const float cs_last = cs_s[rows - 1];

  float delta[PK][NK];
#pragma unroll
  for (int i = 0; i < PK; ++i)
#pragma unroll
    for (int m = 0; m < NK; ++m) delta[i][m] = 0.f;

  for (int k0 = 0; k0 < rows; k0 += kT) {
    const int n_rows = min(kT, rows - k0);
    __syncthreads();                     // b_s and u_s are free
    for (int i = tid; i < n_rows * N; i += kThreads) {
      const int r = i / N, n = i % N;
      b_s[r * NP + n] = bb[(long long)(c0 + k0 + r) * a.b_ss + n];
    }
    for (int i = tid; i < n_rows * P; i += kThreads) {
      const int r = i / P, p = i % P;
      const int row = k0 + r;
      u_s[r * P + p] = xb[(long long)(c0 + row) * a.x_ss + p] * dt_s[row] *
                       expf(cs_last - cs_s[row]);
    }
    __syncthreads();
    for (int sr = 0; sr < n_rows; ++sr) {
      float u[PK], bv[NK];
#pragma unroll
      for (int i = 0; i < PK; ++i) u[i] = u_s[sr * P + ty + 16 * i];
#pragma unroll
      for (int m = 0; m < NK; ++m) bv[m] = b_s[sr * NP + tx + 16 * m];
#pragma unroll
      for (int i = 0; i < PK; ++i)
#pragma unroll
        for (int m = 0; m < NK; ++m)
          delta[i][m] = fmaf(u[i], bv[m], delta[i][m]);
    }
  }
  float* out = a.st_ws + ((long long)hd.bh * a.chunks + k) * P * N;
#pragma unroll
  for (int i = 0; i < PK; ++i)
#pragma unroll
    for (int m = 0; m < NK; ++m)
      out[(ty + 16 * i) * N + tx + 16 * m] = delta[i][m];
  arrive_and_carry<P, N, kThreads>(a, hd.bh, tid);
}

template <int P, int N>
__host__ __device__ constexpr size_t scan_smem_floats(int chunk) {
  return (size_t)P * (N + 1) + 2 * (size_t)kT * (N + 1) + (size_t)kT * P +
         (size_t)kT * (kT + 1) + 2 * (size_t)chunk;
}

// (2) y of one 64-row query tile of one chunk: for key tiles j <= i,
// C_i B_j^T over N (each thread a 4 x 4 register tile), weighted by
// exp(cs_l - cs_s) under the causal mask, times xd_j into y_i in
// registers; then the carried state's term
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_chunk_y(Args a) {
  constexpr int NP = N + 1;              // padded rows: conflict-free
  constexpr int WP = kT + 1;
  constexpr int PK = P / 16;             // p columns per thread
  extern __shared__ float smem[];
  float* st_s = smem;                    // P x NP state entering the chunk
  float* c_s = st_s + P * NP;            // kT x NP: C of the query tile
  float* b_s = c_s + kT * NP;            // kT x NP: B of the key tile
  float* x_s = b_s + kT * NP;            // kT x P: x * dt of the key tile
  float* w_s = x_s + kT * P;             // kT x WP: decayed scores
  float* dt_s = w_s + kT * WP;           // chunk
  float* cs_s = dt_s + a.chunk;          // chunk

  const Head hd = head_of(a, blockIdx.x);
  const int k = blockIdx.y, c0 = k * a.chunk;
  const int rows = min(a.chunk, a.seq - c0);
  const int qi = a.q_tiles - 1 - (int)blockIdx.z;
  const int q0 = qi * kT;
  if (q0 >= rows) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool has_state = k > 0 || a.init != nullptr;

  const float* xb = static_cast<const float*>(a.x) + hd.bi * a.x_sb +
                    hd.h * a.x_sh;
  const float* dtb = a.dt + hd.bi * a.dt_sb + hd.h * a.dt_sh;
  const float* bb = static_cast<const float*>(a.b) + hd.bi * a.b_sb +
                    hd.g * a.b_sg;
  const float* cb = static_cast<const float*>(a.c) + hd.bi * a.c_sb +
                    hd.g * a.c_sg;
  float* yb = static_cast<float*>(a.y) + hd.bi * a.y_sb + hd.h * a.y_sh;

  const int seen = min(q0 + kT, rows);   // rows this tile reads
  const float* csg = a.cs_ws + (long long)hd.bh * a.seq + c0;
  for (int r = tid; r < seen; r += kThreads) {
    cs_s[r] = csg[r];
    dt_s[r] = dtb[(long long)(c0 + r) * a.dt_ss];
  }
  if (has_state) {
    const float* sg = a.st_ws + ((long long)hd.bh * a.chunks + k) * P * N;
    for (int i = tid; i < P * N; i += kThreads)
      st_s[(i / N) * NP + i % N] = sg[i];
  }
  for (int i = tid; i < kT * N; i += kThreads) {
    const int r = i / N, n = i % N;
    const int row = q0 + r;
    c_s[r * NP + n] = row < rows ? cb[(long long)(c0 + row) * a.c_ss + n]
                                 : 0.f;
  }
  float acc[4][PK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PK; ++j) acc[i][j] = 0.f;

  for (int kj = 0; kj <= qi; ++kj) {
    const int k0 = kj * kT;
    __syncthreads();                     // b_s, x_s and w_s are free
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const int row = k0 + r;
      b_s[r * NP + n] =
          row < rows ? bb[(long long)(c0 + row) * a.b_ss + n] : 0.f;
    }
    for (int i = tid; i < kT * P; i += kThreads) {
      const int r = i / P, p = i % P;
      const int row = k0 + r;
      x_s[r * P + p] =
          row < rows ? xb[(long long)(c0 + row) * a.x_ss + p] * dt_s[row]
                     : 0.f;
    }
    __syncthreads();

    // scores C_i B_j^T: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NP + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * NP + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        // mask before exp: only col <= r < rows is evaluated
        float w = 0.f;
        if (col <= r && r < rows) w = s[i][j] * expf(cs_s[r] - cs_s[col]);
        w_s[(ty + 16 * i) * WP + tx + 16 * j] = w;
      }
    }
    __syncthreads();

    // y_i += W x_j: rows ty + 16 i, columns tx + 16 k
    for (int sr = 0; sr < kT; ++sr) {
      float wv[4], xv[PK];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = w_s[(ty + 16 * i) * WP + sr];
#pragma unroll
      for (int j = 0; j < PK; ++j) xv[j] = x_s[sr * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PK; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
    }
  }

  // the carried state's term exp(cs_l) (state c_l), then write y_i
  float t[4][PK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PK; ++j) t[i][j] = 0.f;
  if (has_state) {
    for (int n = 0; n < N; ++n) {
      float cv[4], sv[PK];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NP + n];
#pragma unroll
      for (int j = 0; j < PK; ++j) sv[j] = st_s[(tx + 16 * j) * NP + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PK; ++j) t[i][j] = fmaf(cv[i], sv[j], t[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < rows) {
      const float e = expf(cs_s[r]);
      float* yr = yb + (long long)(c0 + r) * a.y_ss;
#pragma unroll
      for (int j = 0; j < PK; ++j) yr[tx + 16 * j] = acc[i][j] + e * t[i][j];
    }
  }
}

}  // namespace f32

// ================================================ bf16: wgmma, one launch ==
// Switches of the kernel's parts, all on; tools/k6_ab.py --variants
// turns them off one at a time to trace where the time goes.
#define SSD_PRODUCTS 1
#define SSD_LO_PARTS 1
#define SSD_CHAIN_WAIT 1
#define SSD_STATE_TERM 1
#define SSD_DIAG 1

namespace wg {

using namespace hopper;

constexpr int kRows = 64;                // a tile: 64 rows of a chunk
constexpr int kMaxTiles = 4;
constexpr int kMaxRows = kRows * kMaxTiles;   // the longest chunk
constexpr int kBox = kRows * 128;        // a 64-row x 64-column bf16 box
constexpr int kThreads = 384;            // a producer warpgroup + two
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte aligned base: B and X of
// the item's chunk (kMaxRows rows of 128 bytes a 64-column block), the
// split state entering the chunk (kNCB boxes of 64 rows, the high parts
// then the low parts), two C tiles a consumer group, then two buffers
// (items n and n + 1) of the per-row values (dt, cs in log2 units, the
// state weights, the column factors of the scores' decay; the decay at
// each 64-row tile's last row; cs_last), the barriers and two tickets.
// NP is N padded to 64.
template <int NP>
struct Smem {
  static constexpr int kCSlots = 2;      // C tiles in flight a group
  static constexpr int kNCB = NP / 64;
  static constexpr int kB = 0;
  static constexpr int kX = kB + kNCB * kMaxRows * 128;
  static constexpr int kShi = kX + kMaxRows * 128;
  static constexpr int kSlo = kShi + kNCB * kBox;
  static constexpr int kC = kSlo + kNCB * kBox;
  static constexpr int kAux = kC + 2 * kCSlots * kNCB * kBox;
  static constexpr int kAuxFloats = 4 * kMaxRows + 8;
  static constexpr int kBar = kAux + 2 * kAuxFloats * 4;
  static constexpr int kBars = 23;
  static constexpr int kItem = kBar + 8 * kBars;
  static constexpr int kBytes = 1024 + kItem + 16;
};

struct Args {
  const float* dt;
  const float* a;
  const float* init;                     // (B, H, P, N) or null
  void* y;
  float* state;                          // (B, H, P, N): the chain, then the final state
  int* counters;                         // [0] tickets, [1 + b H + h] flags; 0 between launches
  int batch, seq, heads, groups, head_dim, state_dim, chunk, chunks;
  int q_tiles, items;                    // 64-row tiles a chunk; items
  long long dt_sb, dt_ss, dt_sh;
  long long y_sb, y_ss, y_sh;
};

// Item t: chunk-major, then batch element, then head
struct Item {
  int b, k, h, g, c0, rows;
};
__device__ __forceinline__ Item item_of(const Args& a, int t) {
  const int per_chunk = a.batch * a.heads;
  Item it;
  it.k = t / per_chunk;
  const int r = t % per_chunk;
  it.b = r / a.heads;
  it.h = r % a.heads;
  it.g = it.h / (a.heads / a.groups);
  it.c0 = it.k * a.chunk;
  it.rows = min(a.chunk, a.seq - it.c0);
  return it;
}

// v0, v1 split into high and low bf16 pairs
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// v0 * w0, v1 * w1 (v a pair of bf16) split the same way
__device__ __forceinline__ void split_scaled(uint32_t raw, float w0, float w1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&raw);
  split2(__bfloat162float(v.x) * w0, __bfloat162float(v.y) * w1, hi, lo);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// a compile-time int, to unroll a loop by a runtime bound's value
template <int V>
struct Int {
  static constexpr int value = V;
};

// (row p, column n) of a K-major 64-row operand in 64-column boxes of the
// 128-byte swizzle (the split state: rows p, k = n)
__device__ __forceinline__ int kmajor_off(int p, int n) {
  return (n >> 6) * kBox + p * 128 + ((((n & 63) >> 3) ^ (p & 7)) << 4) +
         (n & 7) * 2;
}

// One persistent block: its producer thread takes items from the ticket
// counter and loads them, two row warps work out their per-row values,
// and its two consumer warpgroups compute them.
template <int NP, typename O>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_wg_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_b,
                       const __grid_constant__ CUtensorMap tm_c, Args a) {
  using L = Smem<NP>;
  constexpr int kNCB = L::kNCB;
  constexpr int kKN = NP / 16;           // k-steps over the state dim
  // the warps that write the head's state: both groups (a 64-column
  // block each) at NP 128, group 0 at NP 64
  constexpr int kHeadWarps = NP == 64 ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* b_s = smem + L::kB;
  unsigned char* x_s = smem + L::kX;
  unsigned char* shi_s = smem + L::kShi;
  unsigned char* slo_s = smem + L::kSlo;
  unsigned char* c_s = smem + L::kC;
  // buffer u of the per-row values: dt, cs, ws, uf (kMaxRows each), ce
  // (4), cs_last
  float* aux_s = reinterpret_cast<float*>(smem + L::kAux);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* it_full = bar;               // 2: ticket n in item_s[n & 1]
  uint64_t* bx_full = bar + 2;           // 4: a 64-row tile of B and X
  uint64_t* bx_empty = bar + 6;          // 4: ... is free
  uint64_t* c_full = bar + 10;           // 2 x 2: a group's C slot ...
  uint64_t* c_empty = bar + 14;          // 2 x 2: ... is free
  uint64_t* cs_full = bar + 18;          // 2: an item's per-row values
  uint64_t* cs_empty = bar + 20;         // 2: ... are free
  uint64_t* st_full = bar + 22;          // the split entering state
  volatile int* item_s = reinterpret_cast<volatile int*>(smem + L::kItem);
  const int tid = threadIdx.x;
  const int T = a.q_tiles;

  if (tid == 0) {
    for (int u = 0; u < 2; ++u) {
      mbar_init(&it_full[u], 1);
      mbar_init(&cs_full[u], 2);         // the two row warps
      mbar_init(&cs_empty[u], 8);        // each consumer warp, an item
    }
    for (int j = 0; j < kMaxTiles; ++j) {
      mbar_init(&bx_full[j], 1);
      mbar_init(&bx_empty[j], 8);        // each consumer warp, an item
    }
    for (int c = 0; c < 2 * L::kCSlots; ++c) {
      mbar_init(&c_full[c], 1);
      mbar_init(&c_empty[c], 4);         // the consuming group's warps
    }
    mbar_init(st_full, 8);               // each consumer warp, an item
    fence_mbar_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup.  Thread 0 takes the items and issues every
    // load; it takes item n + 1's ticket as soon as item n's B and X are
    // issued, so that warps 1 and 2 work out item n + 1's per-row values
    // while the consumers compute item n.  A wait is still only on a
    // smaller ticket, held by a running block.  A fresh barrier's
    // previous phase counts as complete, so each first wait on a free
    // stage passes.
    setmaxnreg_dec<kProducerRegs>();
    const int pw = tid >> 5, lane = tid & 31;
    if (tid == 0) {
      tma_prefetch(&tm_x);
      tma_prefetch(&tm_b);
      tma_prefetch(&tm_c);
      // ticket m into item_s[m & 1]; -1 past the last item
      auto take = [&](int m) {
        const int t = atomicAdd(a.counters, 1);
        // each block's last take overshoots once: the launch's last take
        // of all resets the counter for the next launch
        if (t >= a.items && t == a.items + (int)gridDim.x - 1)
          a.counters[0] = 0;
        item_s[m & 1] = t < a.items ? t : -1;
        mbar_arrive(&it_full[m & 1]);
        return t < a.items ? t : -1;
      };
      int nc[2] = {0, 0};                // C loads of each group
      int t = take(0);
      for (int n = 0; t >= 0; ++n) {
        const Item it = item_of(a, t);
        // the last tile first: the consumers free the key tiles from the
        // last down as their query tiles no longer need them
        for (int j = T - 1; j >= 0; --j) {
          const int row = it.c0 + j * kRows;
          mbar_wait(&bx_empty[j], (n & 1) ^ 1);
          mbar_expect_tx(&bx_full[j], (kNCB + 1) * kBox);
#pragma unroll
          for (int cb = 0; cb < kNCB; ++cb)
            tma_load_4d(b_s + cb * (kMaxRows * 128) + j * kBox, &tm_b,
                        &bx_full[j], cb * 64, row, it.g, it.b);
          tma_load_4d(x_s + j * kBox, &tm_x, &bx_full[j], 0, row, it.h,
                      it.b);
        }
        const int next = take(n + 1);
        // the C tiles, the heaviest query tile first: loads 0 and 3 go
        // to group 0, 1 and 2 to group 1, each group's through its own
        // ring of slots
        for (int q = 0; q < T; ++q) {
          const int i = T - 1 - q;
          const int grp = (q == 0 || q == 3) ? 0 : 1;
          const int m = nc[grp]++;
          const int c = grp * L::kCSlots + m % L::kCSlots;
          mbar_wait(&c_empty[c], ((m / L::kCSlots) & 1) ^ 1);
          mbar_expect_tx(&c_full[c], kNCB * kBox);
#pragma unroll
          for (int cb = 0; cb < kNCB; ++cb)
            tma_load_4d(c_s + (c * kNCB + cb) * kBox, &tm_c, &c_full[c],
                        cb * 64, it.c0 + i * kRows, it.g, it.b);
        }
        t = next;
      }
    } else if (pw == 1 || pw == 2) {
      // ---- the row warps: item m's dt, the cumulative decay (warp 1
      // scans), the state weights exp(cs_last - cs_s) dt_s, cs in log2
      // units and the scores' decay factors, into buffer m & 1
      const int rt = tid - 32;           // 0..63
      for (int m = 0;; ++m) {
        const int u = m & 1;
        mbar_wait(&it_full[u], (m >> 1) & 1);
        const int ticket = item_s[u];
        if (ticket < 0) break;
        const Item it = item_of(a, ticket);
        const int rows = it.rows;
        float* dt_s = aux_s + u * L::kAuxFloats;
        float* cs_s = dt_s + kMaxRows;
        float* ws_s = cs_s + kMaxRows;
        float* uf_s = ws_s + kMaxRows;
        float* ce_s = uf_s + kMaxRows;
        float* el_s = ce_s + 4;
        mbar_wait(&cs_empty[u], ((m >> 1) & 1) ^ 1);
        for (int r = rt; r < kMaxRows; r += 64)
          dt_s[r] = r < rows ? a.dt[it.b * a.dt_sb +
                                    (long long)(it.c0 + r) * a.dt_ss +
                                    (long long)it.h * a.dt_sh]
                             : 0.f;
        named_bar_sync(2, 64);
        if (pw == 1) {
          const float av = a.a[it.h];
          const int per = (rows + 31) / 32;
          const int r0 = lane * per;
          float run = 0.f;
          for (int k = 0; k < per; ++k) {
            const int r = r0 + k;
            if (r < rows) {
              run += dt_s[r] * av;
              cs_s[r] = run;
            }
          }
          float incl = run;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
          }
          const float before = incl - run;
          for (int k = 0; k < per; ++k) {
            const int r = r0 + k;
            if (r < rows) {
              cs_s[r] += before;
              if (r == rows - 1) el_s[0] = cs_s[r];
            }
          }
        }
        named_bar_sync(2, 64);
        for (int r = rt; r < kMaxRows; r += 64) {
          const float c = cs_s[r];
          ws_s[r] = r < rows ? expf(el_s[0] - c) * dt_s[r] : 0.f;
          cs_s[r] = r < rows ? c * kLog2e : 0.f;
        }
        named_bar_sync(2, 64);
        // the scores' decay off the diagonal tiles, factored at the last
        // row e of each key tile: exp2(cs_l - cs_s) = exp2(cs_l - cs_e)
        // exp2(cs_e - cs_s), both exponents <= 0 for s <= e < l
        for (int r = rt; r < kMaxRows; r += 64) {
          const float ce = cs_s[min(r | (kRows - 1), rows - 1)];
          uf_s[r] = r < rows ? ex2(ce - cs_s[r]) * dt_s[r] : 0.f;
          if ((r & (kRows - 1)) == 0) ce_s[r / kRows] = ce;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&cs_full[u]);
      }
    }
    return;
  }

  // ---- consumers: two warpgroups
  setmaxnreg_inc<kConsumerRegs>();
  const int ct = tid - 128;              // 0..255
  const int cw = ct >> 7;                // the group
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int P = a.head_dim, N = a.state_dim;
  // this group's share of the chunk's own state: a 64-column block
  const int ucb = NP == 128 ? cw : 0;
  const bool has_unit = NP == 128 || cw == 0;
  // descriptor bases: the start address field takes byte offsets / 16
  const uint64_t d_bk = wgmma_desc(b_s, 16, 1024);          // B K-major
  const uint64_t d_bn =                                      // B N-major
      wgmma_desc(b_s + ucb * (kMaxRows * 128), kMaxRows * 128, 1024);
  const uint64_t d_x = wgmma_desc(x_s, kMaxRows * 128, 1024);  // N-major
  const uint64_t d_shi = wgmma_desc(shi_s, 16, 1024);       // K-major
  const uint64_t d_slo = wgmma_desc(slo_s, 16, 1024);
  int mc = 0;                            // this group's C loads

  for (int n = 0;; ++n) {
    const int u = n & 1;
    mbar_wait(&it_full[u], (n >> 1) & 1);
    const int ticket = item_s[u];
    if (ticket < 0) break;
    const Item it = item_of(a, ticket);
    const int rows = it.rows;
    const bool has_state = it.k > 0 || a.init != nullptr;
    // the item's dt, cs (log2 units), state weights, decay factors and
    // cs_last, worked out by the row warps
    const float* dt_s = aux_s + u * L::kAuxFloats;
    const float* cs_s = dt_s + kMaxRows;
    const float* ws_s = cs_s + kMaxRows;
    const float* uf_s = ws_s + kMaxRows;
    const float* ce_s = uf_s + kMaxRows;
    const float* el_s = ce_s + 4;
    mbar_wait(&cs_full[u], (n >> 1) & 1);

    // (b) the chunk's own state S = X'^T B of this group's 64 columns:
    // A = X'^T from registers (X's rows read transposed, weighted,
    // split), B N-major, a 64-row tile at a time as the tiles land
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
    // this warp is done with key tiles (lo, hi] of the item: the producer
    // may load the next item's there (X was read by ldmatrix too)
    auto release = [&](int hi, int lo) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0)
        for (int j = hi; j > lo; --j) mbar_arrive(&bx_empty[j]);
    };
    // this group's query tiles: C loads 0 and 3 (group 0) or 1 and 2,
    // tile T - 1 - q, -1 where T has none
    const int qa = cw == 0 ? 0 : 1, qb = cw == 0 ? 3 : 2;
    const int ia = qa < T ? T - 1 - qa : -1, ib = qb < T ? T - 1 - qb : -1;
    // two key tiles a product phase, in the order they are loaded (the
    // last first); a tile below 0 stands in as tile 0 with zero weights,
    // a tile past the sequence's end has zero weights already.  Returns
    // the tile read
    auto x_frags = [&](int j, uint32_t (*ah)[4], uint32_t (*al)[4]) {
      const bool on = j >= 0;
      j = on ? j : 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int s = j * kRows + 16 * kk + (mi >> 1) * 8 + mr;
        const int ch = 2 * warp + (mi & 1);
        uint32_t r[4];
        ldmatrix_x4_trans(r, x_s + s * 128 + ((ch ^ (s & 7)) << 4));
        const int s0 = j * kRows + 16 * kk + 2 * t4;
        float2 w01 = *reinterpret_cast<const float2*>(ws_s + s0);
        float2 w89 = *reinterpret_cast<const float2*>(ws_s + s0 + 8);
        if (!on) w01 = w89 = make_float2(0.f, 0.f);
        split_scaled(r[0], w01.x, w01.y, ah[kk][0], al[kk][0]);
        split_scaled(r[1], w01.x, w01.y, ah[kk][1], al[kk][1]);
        split_scaled(r[2], w89.x, w89.y, ah[kk][2], al[kk][2]);
        split_scaled(r[3], w89.x, w89.y, ah[kk][3], al[kk][3]);
      }
      return j;
    };
    for (int jj = 0; jj < T; jj += 2) {
      const int j0 = T - 1 - jj, j1 = j0 - 1;
      mbar_wait(&bx_full[j0], n & 1);
      if (j1 >= 0) mbar_wait(&bx_full[j1], n & 1);
      if (!has_unit) continue;
      uint32_t ah[2][4][4], al[2][4][4];
      const int t0 = x_frags(j0, ah[0], al[0]);
      const int t1 = x_frags(j1, ah[1], al[1]);
      fence_regs(&ah[0][0][0], 32);
      fence_regs(&al[0][0][0], 32);
      fence_regs(sacc, 32);
      wgmma_fence();
#if SSD_PRODUCTS
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = q == 0 ? t0 : t1;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t d = d_bn + (((j * kRows + 16 * kk) * 128) >> 4);
          wgmma_rs<64, 1>(sacc, ah[q][kk], d, 1);
#if SSD_LO_PARTS
          wgmma_rs<64, 1>(sacc, al[q][kk], d, 1);
#endif
        }
      }
#endif
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc, 32);
    }

    release(T - 1, ia);
    // (c) the chain: wait for the state entering this chunk, publish
    // the state entering the next (exp(cs_last) state_in + S), keep the
    // entering state split in shared memory for the state term.  The
    // head's flag counts the warps that have published its state: the
    // state entering chunk k is there at k x kHeadWarps
    int* flag = a.counters + 1 + (long long)it.b * a.heads + it.h;
#if SSD_CHAIN_WAIT
    if (it.k > 0 && ct == 0) {
      for (uint32_t polls = 0; ld_acquire(flag) != it.k * kHeadWarps;
           ++polls) {
        __nanosleep(32);
        if (polls == (1u << 24)) asm volatile("trap;");
      }
    }
#endif
    named_bar_sync(1, 256);
    // the last chunk publishes nothing: its flag goes back to zero (no
    // one reads it again in this launch)
    if (it.k > 0 && it.k == a.chunks - 1 && ct == 0) *flag = 0;
    // the entering state at this thread's accumulator places, all loads
    // in flight at once (past L1: the last item wrote it on another SM)
    float2 v[16];
    const long long off = ((long long)it.b * a.heads + it.h) * P * N;
    float* st = a.state + off;
    if (has_unit) {
      const float el = expf(el_s[0]);
      const float* in = it.k > 0 ? st : a.init ? a.init + off : nullptr;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = 16 * warp + g + 8 * half;
          const int nn = ucb * 64 + 8 * jn + 2 * t4;
          float2 w = make_float2(0.f, 0.f);
          if (in != nullptr && p < P && nn < N)
            w = __ldcg(reinterpret_cast<const float2*>(in + p * N + nn));
          v[2 * jn + half] = w;
        }
      }
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = 16 * warp + g + 8 * half;
          const int nn = ucb * 64 + 8 * jn + 2 * t4;
          if (p < P && nn < N)
            store2(st + p * N + nn,
                   fmaf(el, v[2 * jn + half].x, sacc[4 * jn + 2 * half]),
                   fmaf(el, v[2 * jn + half].y, sacc[4 * jn + 2 * half + 1]));
        }
      }
      // each warp publishes its share: its stores ordered before the
      // warp barrier, then one lane's fence and count (cumulativity)
      if (it.k < a.chunks - 1) {
        __syncwarp();
        if (lane == 0) {
          __threadfence();
          atomicAdd(flag, 1);
        }
      }
      // off the chain: the entering state split into shared memory for
      // the state term
      if (has_state) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = 16 * warp + g + 8 * half;
            const int nn = ucb * 64 + 8 * jn + 2 * t4;
            uint32_t hi, lo;
            split2(v[2 * jn + half].x, v[2 * jn + half].y, hi, lo);
            const int o = kmajor_off(p, nn);
            *reinterpret_cast<uint32_t*>(shi_s + o) = hi;
            *reinterpret_cast<uint32_t*>(slo_s + o) = lo;
          }
        }
      }
    }
    fence_proxy_async();                 // the split state, for wgmma
    __syncwarp();
    if (lane == 0) mbar_arrive(st_full);
    bool state_ready = false;

    // (d) y, a 64-row query tile at a time: group 0 takes the tiles of C
    // loads 0 and 3 (tiles T-1, T-4), group 1 of loads 1 and 2.  C_i
    // stays in its slot for the tile: the scores and the state term read
    // it there (the group's other slot takes its next tile meanwhile)
    for (int slot = 0; slot < 2; ++slot) {
      const int i = slot == 0 ? ia : ib;
      if (i < 0) break;
      const int c = cw * L::kCSlots + mc % L::kCSlots;
      mbar_wait(&c_full[c], (mc / L::kCSlots) & 1);
      ++mc;
      const uint64_t d_c = wgmma_desc(c_s + c * kNCB * kBox, 16, 1024);
      // the key tiles this group's next query tile does not need
      const int keep = slot == 0 ? ib : -1;
      if (i * kRows < rows) {            // else a tile past the sequence
        const int l0 = i * kRows + 16 * warp + g, l1 = l0 + 8;
        const float cl0 = cs_s[l0], cl1 = cs_s[l1];
        float y[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) y[e] = 0.f;
        // C_i against an operand K-major over the state dim, its 64-column
        // blocks `stride` bytes apart: B_j^T (scores) or the split state
        auto c_products = [&](float* d, uint64_t db, int stride, int acc0) {
#pragma unroll
          for (int kk = 0; kk < kKN; ++kk) {
            const int o = (kk & 3) * 32;
            wgmma_ss<64, 0>(d, d_c + (((kk >> 2) * kBox + o) >> 4),
                            db + (((kk >> 2) * stride + o) >> 4),
                            acc0 || kk > 0);
          }
        };
        auto d_b = [&](int j) { return d_bk + ((j * kBox) >> 4); };

#if SSD_DIAG
        // the chunk's own rows, key tiles j <= i in turn: the scores C_i
        // B_j^T, W' = scores o exp2(cs_l - cs_s) dt_s (split), y += W'
        // X_j.  Unrolled by the tile's index, so that tile j + 1's scores
        // run on the tensor cores while tile j's W' is worked out
        auto diag = [&](auto tile) {
          constexpr int I = decltype(tile)::value;
          float sc[2][32];
          wgmma_fence();
#if SSD_PRODUCTS
          c_products(sc[0], d_b(0), kMaxRows * 128, 0);
#endif
          wgmma_commit();
#pragma unroll
          for (int j = 0; j <= I; ++j) {
            float* cur = sc[j & 1];
            wgmma_wait<0>();
            fence_regs(cur, 32);
            fence_regs(y, 32);
            if (j < I) {
              float* nxt = sc[(j + 1) & 1];
              fence_regs(nxt, 32);
              wgmma_fence();
#if SSD_PRODUCTS
              c_products(nxt, d_b(j + 1), kMaxRows * 128, 0);
#endif
              wgmma_commit();
            }
            uint32_t wh[4][4], wl[4][4];
            if (j < I) {
              // every pair s < l: the factored decay, no mask (rows past
              // S get 0)
              const float ce = ce_s[j];
              const float r0 = l0 < rows ? ex2(cl0 - ce) : 0.f;
              const float r1 = l1 < rows ? ex2(cl1 - ce) : 0.f;
#pragma unroll
              for (int jn = 0; jn < 8; ++jn) {
                const int s = j * kRows + 8 * jn + 2 * t4;
                const float2 f = *reinterpret_cast<const float2*>(uf_s + s);
                split2(cur[4 * jn] * r0 * f.x, cur[4 * jn + 1] * r0 * f.y,
                       wh[jn >> 1][(jn & 1) * 2], wl[jn >> 1][(jn & 1) * 2]);
                split2(cur[4 * jn + 2] * r1 * f.x,
                       cur[4 * jn + 3] * r1 * f.y,
                       wh[jn >> 1][(jn & 1) * 2 + 1],
                       wl[jn >> 1][(jn & 1) * 2 + 1]);
              }
            } else {
              // the diagonal tile: masked before exp, only s <= l < rows
              // is evaluated
#pragma unroll
              for (int jn = 0; jn < 8; ++jn) {
                const int s = j * kRows + 8 * jn + 2 * t4;
                const float2 c2 = *reinterpret_cast<const float2*>(cs_s + s);
                const float2 d2 = *reinterpret_cast<const float2*>(dt_s + s);
                const float w0 = (s <= l0 && l0 < rows)
                                     ? cur[4 * jn] * ex2(cl0 - c2.x) * d2.x
                                     : 0.f;
                const float w1 =
                    (s + 1 <= l0 && l0 < rows)
                        ? cur[4 * jn + 1] * ex2(cl0 - c2.y) * d2.y : 0.f;
                const float w2 = (s <= l1 && l1 < rows)
                                     ? cur[4 * jn + 2] * ex2(cl1 - c2.x) * d2.x
                                     : 0.f;
                const float w3 =
                    (s + 1 <= l1 && l1 < rows)
                        ? cur[4 * jn + 3] * ex2(cl1 - c2.y) * d2.y : 0.f;
                split2(w0, w1, wh[jn >> 1][(jn & 1) * 2],
                       wl[jn >> 1][(jn & 1) * 2]);
                split2(w2, w3, wh[jn >> 1][(jn & 1) * 2 + 1],
                       wl[jn >> 1][(jn & 1) * 2 + 1]);
              }
            }
            fence_regs(&wh[0][0], 16);
            fence_regs(&wl[0][0], 16);
            fence_regs(y, 32);
            wgmma_fence();
#if SSD_PRODUCTS
            const uint64_t dxj = d_x + ((j * kBox) >> 4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t d = dxj + ((16 * kk * 128) >> 4);
              wgmma_rs<64, 1>(y, wh[kk], d, 1);
#if SSD_LO_PARTS
              wgmma_rs<64, 1>(y, wl[kk], d, 1);
#endif
            }
#endif
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(y, 32);
        };
        switch (i) {
          case 0: diag(Int<0>{}); break;
          case 1: diag(Int<1>{}); break;
          case 2: diag(Int<2>{}); break;
          default: diag(Int<3>{}); break;
        }
#endif

        // the carried state's term, after the chunk's own rows (its split
        // state is in shared memory by then): y += exp(cs_l) (C_i
        // state_in^T)
#if SSD_STATE_TERM
        if (has_state) {
          if (!state_ready) {
            mbar_wait(st_full, n & 1);
            state_ready = true;
          }
          float ys[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) ys[e] = 0.f;
          fence_regs(ys, 32);
          wgmma_fence();
#if SSD_PRODUCTS
          c_products(ys, d_shi, kBox, 1);
#if SSD_LO_PARTS
          c_products(ys, d_slo, kBox, 1);
#endif
#endif
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(ys, 32);
          const float e0 = l0 < rows ? exp2f(cl0) : 0.f;
          const float e1 = l1 < rows ? exp2f(cl1) : 0.f;
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            y[4 * jn] = fmaf(e0, ys[4 * jn], y[4 * jn]);
            y[4 * jn + 1] = fmaf(e0, ys[4 * jn + 1], y[4 * jn + 1]);
            y[4 * jn + 2] = fmaf(e1, ys[4 * jn + 2], y[4 * jn + 2]);
            y[4 * jn + 3] = fmaf(e1, ys[4 * jn + 3], y[4 * jn + 3]);
          }
        }
#endif

        // y of the tile's rows below S and its first P columns
        O* yb = static_cast<O*>(a.y) + it.b * a.y_sb +
                (long long)it.h * a.y_sh + (long long)it.c0 * a.y_ss;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int p = 8 * jn + 2 * t4;
          if (p < P) {
            if (l0 < rows)
              store2(yb + (long long)l0 * a.y_ss + p, y[4 * jn],
                     y[4 * jn + 1]);
            if (l1 < rows)
              store2(yb + (long long)l1 * a.y_ss + p, y[4 * jn + 2],
                     y[4 * jn + 3]);
          }
        }
      }
      // the group is done with C_i (the products that read it have
      // completed) and with the key tiles its next tile does not need
      __syncwarp();
      if (lane == 0) mbar_arrive(&c_empty[c]);
      release(i, keep);
    }
    // the item's per-row values are free
    __syncwarp();
    if (lane == 0) mbar_arrive(&cs_empty[u]);
  }
}

// One 4-d map (columns, S, heads or groups, batch) of a bf16 view from
// the wrapper's numbers (flash_attn.tma_map): 4 dims, the byte strides
// of S, heads and batch, the box (64 columns, 64 rows); 128-byte
// swizzle, boxes past the view's extent filled with zeros.
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

template <int NP, typename O>
cudaError_t launch(const void* x, const void* b, const void* c,
                   const Args& a, const int* plan, const long long* maps,
                   cudaStream_t stream) {
  using L = Smem<NP>;
  if (plan[2] != kThreads || plan[3] != L::kBytes) return cudaErrorInvalidValue;
  CUtensorMap tx, tb, tc;
  if (!encode_map(&tx, x, maps) || !encode_map(&tb, b, maps + 9) ||
      !encode_map(&tc, c, maps + 18))
    return cudaErrorInvalidValue;
  auto kernel = ssd_scan_wg_kernel<NP, O>;
  // the shared memory attribute, once a device: it holds for later
  // launches
  static unsigned long long attr_set = 0;   // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    attr_set |= bit;
  }
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidValue;
  const int grid = a.items < sms ? a.items : sms;
  kernel<<<grid, kThreads, L::kBytes, stream>>>(tx, tb, tc, a);
  return cudaGetLastError();
}

template <typename O>
cudaError_t dispatch(int np, const void* x, const void* b, const void* c,
                     const Args& a, const int* plan, const long long* maps,
                     cudaStream_t stream) {
  if (np == 128) return launch<128, O>(x, b, c, a, plan, maps, stream);
  if (np == 64) return launch<64, O>(x, b, c, a, plan, maps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wg

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t bytes,
                   const Args& a, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// the f32 route's two launches of one scan, in stream order
template <int P, int N>
cudaError_t run(const Args& a, int bh, cudaStream_t stream) {
  const dim3 chunk_grid(bh * a.chunks);
  const dim3 scan_grid(bh, a.chunks, a.q_tiles);
  cudaError_t err = launch(
      f32::ssd_scan_chunk_state<P, N>, chunk_grid, f32::kThreads,
      sizeof(float) * f32::state_smem_floats<P, N>(a.chunk), a, stream);
  if (err != cudaSuccess) return err;
  return launch(f32::ssd_scan_chunk_y<P, N>, scan_grid, f32::kThreads,
                sizeof(float) * f32::scan_smem_floats<P, N>(a.chunk), a,
                stream);
}

cudaError_t dispatch_pn(int p, int n, const Args& a, int bh,
                        cudaStream_t stream) {
  if (p == 64) {
    if (n == 128) return run<64, 128>(a, bh, stream);
    if (n == 64) return run<64, 64>(a, bh, stream);
    if (n == 32) return run<64, 32>(a, bh, stream);
  } else if (p == 32) {
    if (n == 128) return run<32, 128>(a, bh, stream);
    if (n == 64) return run<32, 64>(a, bh, stream);
    if (n == 32) return run<32, 32>(a, bh, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The f32 route (f32 x, b, c and y): two launches on the CUDA cores.
extern "C" int ssd_scan(
    const void* x, const void* dt, const void* a_vec, const void* b,
    const void* c, const void* init, void* y, void* state, void* cs_ws,
    void* st_ws, void* counters, int batch, int seq, int heads, int groups,
    int head_dim, int state_dim, int chunk, int chunks, int q_tiles,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
    long long b_sg, long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh, int in_dtype,
    int out_dtype, void* stream) {
  if (batch == 0 || heads == 0) return cudaSuccess;
  if (in_dtype != kF32 || out_dtype != kF32) return cudaErrorInvalidValue;
  if (seq < 1 || chunk < 1 || chunk > kMaxChunk || groups < 1 ||
      heads % groups || chunks < 1 || chunks > 65535 ||
      (long long)chunks * chunk < seq || (chunks - 1) * chunk >= seq ||
      q_tiles != (chunk + kT - 1) / kT)
    return cudaErrorInvalidValue;
  const long long bh = (long long)batch * heads;
  if (bh * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(a_vec),
         b, c, static_cast<const float*>(init), y,
         static_cast<float*>(state), static_cast<float*>(cs_ws),
         static_cast<float*>(st_ws), static_cast<int*>(counters), heads,
         groups, seq, chunk, chunks,
         q_tiles, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
         c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  return dispatch_pn(head_dim, state_dim, a, (int)bh,
                     static_cast<cudaStream_t>(stream));
}

// The bf16 route (bf16 x, b, c; y bf16 or f32): one persistent launch on
// wgmma.  plan: q_tiles, items, threads, smem bytes
// (ssd_plan); maps: the tensor maps of x, b and c, 9 numbers each
// (flash_attn.tma_map of the (B, H|G, S, P|N) views); counters: 1 + B H
// ints, 0, which the launch leaves at 0.
extern "C" int ssd_scan_wg(
    const void* x, const void* dt, const void* a_vec, const void* b,
    const void* c, const void* init, void* y, void* state, void* counters,
    int batch, int seq, int heads, int groups, int head_dim, int state_dim,
    int chunk, int chunks, long long dt_sb, long long dt_ss, long long dt_sh,
    long long y_sb, long long y_ss, long long y_sh, int out_dtype,
    const int* plan, const long long* maps, void* stream) {
  if (batch == 0 || heads == 0) return cudaSuccess;
  const int q_tiles = plan[0], items = plan[1];
  if (seq < 1 || chunk < 1 || chunk > wg::kMaxRows || groups < 1 ||
      heads % groups || chunks < 1 || (long long)chunks * chunk < seq ||
      (chunks - 1) * chunk >= seq ||
      q_tiles != (chunk + wg::kRows - 1) / wg::kRows ||
      (head_dim != 32 && head_dim != 64) ||
      (state_dim != 32 && state_dim != 64 && state_dim != 128) ||
      (long long)batch * chunks * heads != items)
    return cudaErrorInvalidValue;
  const long long dims[3] = {head_dim, state_dim, state_dim};
  for (int m = 0; m < 3; ++m)
    if (maps[9 * m] != dims[m] || maps[9 * m + 7] != 64 ||
        maps[9 * m + 8] != wg::kRows)
      return cudaErrorInvalidValue;
  const wg::Args a{static_cast<const float*>(dt),
                   static_cast<const float*>(a_vec),
                   static_cast<const float*>(init), y,
                   static_cast<float*>(state), static_cast<int*>(counters),
                   batch, seq, heads, groups, head_dim, state_dim, chunk,
                   chunks, q_tiles, items, dt_sb, dt_ss, dt_sh, y_sb, y_ss,
                   y_sh};
  const int np = state_dim == 128 ? 128 : 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == kBF16)
    return wg::dispatch<hopper::bf16>(np, x, b, c, a, plan, maps, s);
  if (out_dtype == kF32)
    return wg::dispatch<float>(np, x, b, c, a, plan, maps, s);
  return cudaErrorInvalidValue;
}
