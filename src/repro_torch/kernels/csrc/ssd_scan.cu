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
// overflow, never produces inf * 0.
//
// Bound on the H100: at the served prefill burst (8 prompts x 2048
// tokens, H 32, P 64, N 128, L 256) the causal products are ~43 GFLOP
// and the bytes ~150 MB (x and y in bf16, b, c, dt, the f32 state), so
// operations and bytes are close, ~0.05 ms either way.
//
// Design: SSD's chunk decomposition, in two launches on the caller's
// stream, so a sequence's chunks run in parallel instead of one block
// walking them in order:
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
// bf16 inputs run their products on the tensor cores (mma.sync
// m16n8k16, f32 sums, 4 warps of 16 rows).  C and B are exact bf16
// operands.  Every f32 operand is split into a bf16 high part and a
// bf16 low part and multiplied twice against the exact operand, which
// leaves ~2^-17 of its value: the decayed weights
// W'_ls = (c_l . b_s) exp(cs_l - cs_s) dt_s against x (so xd is never
// rounded), the carried state against C, and exp(cs_last - cs_s) dt_s
// x_s against b for the chunk state.  f32 inputs keep every product
// in f32 on the CUDA cores (TF32 would round them), with the same split
// into two launches.  x, dt, b, c and y are read and written in place
// through their strides, so the model's (B, S, H, P) views of the conv
// output need no copy, and the Pallas layout (BH, S, P) is the view
// B = 1, H = G = BH.  No atomics: a repeat is bit for bit the same.
//
// Interface: plain C, bound with ctypes; returns the first
// cudaGetLastError() of the two launches.  It launches on the caller's
// stream and allocates nothing: the wrapper passes the two workspaces
// and the counters, sized by its plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;                   // rows per tile
constexpr int kMaxChunk = 1024;

enum DType { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

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

// ========================================= bf16: the tensor cores ==
namespace tc {

constexpr int kWarps = 4;                // 16 rows each
constexpr int kThreads = 32 * kWarps;

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

// 2^x in one MUFU op (relative error ~2^-22; results below 2^-126 flush
// to 0, a decay that small is 0 beside the row's own weight of 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// v = hi + lo + O(2^-17 |v|), both parts bf16
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h, l;
  split_bf16(v0, h.x, l.x);
  split_bf16(v1, h.y, l.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// rows of bf16 in shared memory padded by 16 bytes: ldmatrix reads them
// without bank conflicts
template <int W>
struct Pad {
  static constexpr int kStride = W + 8;
};

// Copy `n_rows` rows of W bf16 (16-byte chunks) starting at row `row0`
// of a strided tensor into a kT-row tile; rows at or past `rows` are
// zero-filled.  Every thread of the block takes part.
template <int W, int kBlockThreads = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int row0, int rows,
                                          int tid) {
  constexpr int kChunks = W / 8;
  constexpr int kStride = Pad<W>::kStride;
  for (int i = tid; i < kT * kChunks; i += kBlockThreads) {
    const int r = i / kChunks, c8 = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(dst + r * kStride + c8,
               src + (long long)(ok ? row : 0) * ss + c8, ok);
  }
}

template <int P, int N>
struct StateSmem {
  // up to 8 warps, each at least 16 rows of P by 16 columns of N
  static constexpr int kWarps = P * N / 256 < 8 ? P * N / 256 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kXS = Pad<P>::kStride, kBS = Pad<N>::kStride;
  // one slot of the row-tile ring: B then X, as they lie in memory
  static constexpr int kSlot = kT * kBS + kT * kXS;
  static size_t bytes(int chunk) {
    return sizeof(bf16) * (2 * (size_t)kSlot + 2 * (size_t)kT * kXS) +
           sizeof(float) * 2 * (size_t)chunk;
  }
};

// (1) the chunk's local state S (P x N) = X'^T B, X'_s = exp(cs_last -
// cs_s) dt_s x_s split into bf16 high and low parts, B exact.  Row tiles
// of B and X stream through a two-slot cp.async ring; warps cut P into
// 16-row tiles and N into equal parts.  Then the arrival, which carries
// the state in the last block of a head.
template <int P, int N>
__global__ void __launch_bounds__(StateSmem<P, N>::kThreads)
    ssd_scan_chunk_state(Args a) {
  using L = StateSmem<P, N>;
  constexpr int kWarps = L::kWarps, kThreads = L::kThreads;
  constexpr int kXS = L::kXS, kBS = L::kBS;
  constexpr int kMT = P / 16;                    // 16-row tiles of P
  constexpr int kNSplit = kWarps / kMT;          // warps along N
  constexpr int kNW = N / kNSplit;               // N columns a warp
  constexpr int kNB = kNW / 8;                   // n-blocks a warp
  static_assert(kMT * kNSplit == kWarps && kNB % 2 == 0, "warp layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // 2 x L::kSlot
  bf16* xh_s = ring + 2 * L::kSlot;                // kT x kXS
  bf16* xl_s = xh_s + kT * kXS;                    // kT x kXS
  float* dt_s = reinterpret_cast<float*>(xl_s + kT * kXS);  // chunk
  float* cs_s = dt_s + a.chunk;                    // chunk

  int bh, k;
  chunk_of(a, bh, k);
  const Head hd = head_of(a, bh);
  const int c0 = k * a.chunk;
  const int rows = min(a.chunk, a.seq - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;

  const bf16* xb = static_cast<const bf16*>(a.x) + hd.bi * a.x_sb +
                   hd.h * a.x_sh + (long long)c0 * a.x_ss;
  const float* dtb = a.dt + hd.bi * a.dt_sb + hd.h * a.dt_sh;
  const bf16* bb = static_cast<const bf16*>(a.b) + hd.bi * a.b_sb +
                   hd.g * a.b_sg + (long long)c0 * a.b_ss;

  auto load_rows = [&](int tile) {
    bf16* bs = ring + (tile & 1) * L::kSlot;
    load_tile<N, kThreads>(bs, bb, a.b_ss, tile * kT, rows, tid);
    load_tile<P, kThreads>(bs + kT * kBS, xb, a.x_ss, tile * kT, rows, tid);
  };
  load_rows(0);
  cp_async_commit();

  chunk_cumsum<kThreads>(dtb, a.dt_ss, c0, rows, a.a[hd.h], tid, dt_s,
                         cs_s, a.cs_ws + (long long)hd.bh * a.seq);
  const float cs_last = cs_s[rows - 1];
  // the weight of row s in the state, in place of dt_s
  for (int r = tid; r < rows; r += kThreads)
    dt_s[r] = expf(cs_last - cs_s[r]) * dt_s[r];

  const int m0 = (warp % kMT) * 16;
  const int n0 = (warp / kMT) * kNW;
  float acc[kNB][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int tiles = (rows + kT - 1) / kT;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * kT;
    // tile `tile` has landed; every warp is done with the last tile's
    // products, so its slot and the split X' are free; the weights are
    // ready
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < tiles) load_rows(tile + 1);
    cp_async_commit();
    const bf16* bs = ring + (tile & 1) * L::kSlot;
    const bf16* xs = bs + kT * kBS;
    // X' = w_s x_s, split, 8 columns a thread
    constexpr int kChunks = P / 8;
    constexpr int kPer = kT * kChunks / kThreads;
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c8 = (i % kChunks) * 8;
      const int row = k0 + r;
      const float w = row < rows ? dt_s[row] : 0.f;
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + r * kXS + c8);
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
      uint4 hv, lv;
      uint32_t* hp = reinterpret_cast<uint32_t*>(&hv);
      uint32_t* lp = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split2(__bfloat162float(xv[2 * e]) * w,
               __bfloat162float(xv[2 * e + 1]) * w, hp[e], lp[e]);
      *reinterpret_cast<uint4*>(xh_s + r * kXS + c8) = hv;
      *reinterpret_cast<uint4*>(xl_s + r * kXS + c8) = lv;
    }
    __syncthreads();

    const int ksteps = (min(kT, rows - k0) + 15) / 16;
    for (int kk = 0; kk < ksteps; ++kk) {
      // A = X'^T: the split tiles hold [s][p], so the transposed load
      const int a_off = (16 * kk + (mi >> 1) * 8 + mr) * kXS + m0 +
                        (mi & 1) * 8;
      uint32_t ah[4], al[4];
      ldmatrix_x4_trans(ah, xh_s + a_off);
      ldmatrix_x4_trans(al, xl_s + a_off);
#pragma unroll
      for (int j = 0; j < kNB; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bs + (16 * kk + (mi & 1) * 8 + mr) * kBS +
                                  n0 + 8 * (j + (mi >> 1)));
        mma_bf16(acc[j], ah, bf[0], bf[1]);
        mma_bf16(acc[j + 1], ah, bf[2], bf[3]);
        mma_bf16(acc[j], al, bf[0], bf[1]);
        mma_bf16(acc[j + 1], al, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  float* out = a.st_ws + ((long long)hd.bh * a.chunks + k) * P * N;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(out + (m0 + g) * N + n) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (m0 + g + 8) * N + n) =
        make_float2(acc[j][2], acc[j][3]);
  }
  arrive_and_carry<P, N, kThreads>(a, hd.bh, tid);
}

template <int P, int N>
struct ScanSmem {
  static constexpr int kXS = Pad<P>::kStride, kBS = Pad<N>::kStride;
  // one slot of the key-tile ring: B_j then X_j
  static constexpr int kSlot = kT * kBS + kT * kXS;
  // the ring's space holds the split state (P rows of N, twice) first
  static constexpr int kRing =
      2 * kSlot > 2 * P * kBS ? 2 * kSlot : 2 * P * kBS;
  static size_t bytes(int chunk) {
    return sizeof(bf16) * ((size_t)kT * kBS + kRing) +
           sizeof(float) * 2 * (size_t)chunk;
  }
};

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// (2) y of one 64-row query tile: the carried state's term first
// (C state_in^T, state split), then for key tiles j <= i the scores
// S = C_i B_j^T, W' = S exp(cs_l - cs_s) dt_s under the causal mask
// (split, kept in registers as the next A operand), y += W' X_j.  Key
// tiles stream through a two-slot cp.async ring.  The decays take ex2
// of cs in log2 units, ~2^-22 relative: far inside y's bf16 rounding.
template <int P, int N, typename O>
__global__ void __launch_bounds__(kThreads) ssd_scan_chunk_y(Args a) {
  using L = ScanSmem<P, N>;
  constexpr int kXS = L::kXS, kBS = L::kBS;
  constexpr int kND = P / 8;             // y n-blocks
  constexpr int kKN = N / 16;            // k-steps over N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);   // kT x kBS
  bf16* ring = c_s + kT * kBS;                      // L::kRing
  float* dt_s = reinterpret_cast<float*>(ring + L::kRing);  // chunk
  float* cs_s = dt_s + a.chunk;                     // chunk

  const Head hd = head_of(a, blockIdx.x);
  const int k = blockIdx.y, c0 = k * a.chunk;
  const int rows = min(a.chunk, a.seq - c0);
  const int qi = a.q_tiles - 1 - (int)blockIdx.z;
  const int q0 = qi * kT;
  if (q0 >= rows) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const bool has_state = k > 0 || a.init != nullptr;

  const bf16* xb = static_cast<const bf16*>(a.x) + hd.bi * a.x_sb +
                   hd.h * a.x_sh + (long long)c0 * a.x_ss;
  const float* dtb = a.dt + hd.bi * a.dt_sb + hd.h * a.dt_sh;
  const bf16* bb = static_cast<const bf16*>(a.b) + hd.bi * a.b_sb +
                   hd.g * a.b_sg + (long long)c0 * a.b_ss;
  const bf16* cb = static_cast<const bf16*>(a.c) + hd.bi * a.c_sb +
                   hd.g * a.c_sg + (long long)c0 * a.c_ss;
  O* yb = static_cast<O*>(a.y) + hd.bi * a.y_sb + hd.h * a.y_sh +
          (long long)c0 * a.y_ss;

  load_tile<N>(c_s, cb + (long long)q0 * a.c_ss, a.c_ss, 0, rows - q0, tid);
  cp_async_commit();
  // cs in log2 units: a pair's decay is one subtraction and one ex2
  constexpr float kLog2e = 1.4426950408889634f;
  const int seen = min(q0 + kT, rows);   // rows this tile reads
  const float* csg = a.cs_ws + (long long)hd.bh * a.seq + c0;
  for (int r = tid; r < seen; r += kThreads) {
    cs_s[r] = csg[r] * kLog2e;
    dt_s[r] = dtb[(long long)(c0 + r) * a.dt_ss];
  }

  const int r_lo = warp * 16;                      // the warp's rows
  const int row0 = q0 + r_lo + g, row1 = row0 + 8; // the lane's rows
  const bf16* c_frag = c_s + (r_lo + (mi & 1) * 8 + mr) * kBS +
                       (mi >> 1) * 8;
  float y[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;

  if (has_state) {
    // y = exp(cs_l) (C_l state^T), the state split in the ring's space
    bf16* sh_s = ring;                             // P x kBS
    bf16* sl_s = ring + P * kBS;
    const float4* sg = reinterpret_cast<const float4*>(
        a.st_ws + ((long long)hd.bh * a.chunks + k) * P * N);
    constexpr int kPer = P * N / 4 / kThreads;     // float4s a thread
    constexpr int kBatch = kPer < 8 ? kPer : 8;
#pragma unroll
    for (int it0 = 0; it0 < kPer; it0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = __ldg(sg + tid + (it0 + j) * kThreads);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = 4 * (tid + (it0 + j) * kThreads);
        const int p = i / N, n = i % N;
        uint2 hi, lo;
        split2(v[j].x, v[j].y, hi.x, lo.x);
        split2(v[j].z, v[j].w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(sh_s + p * kBS + n) = hi;
        *reinterpret_cast<uint2*>(sl_s + p * kBS + n) = lo;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKN; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, c_frag + 16 * kk);
#pragma unroll
      for (int n = 0; n < kND; n += 2) {
        const int off = (8 * (n + (mi >> 1)) + mr) * kBS + 16 * kk +
                        (mi & 1) * 8;
        uint32_t bf[4];
        ldmatrix_x4(bf, sh_s + off);
        mma_bf16(y[n], af, bf[0], bf[1]);
        mma_bf16(y[n + 1], af, bf[2], bf[3]);
        ldmatrix_x4(bf, sl_s + off);
        mma_bf16(y[n], af, bf[0], bf[1]);
        mma_bf16(y[n + 1], af, bf[2], bf[3]);
      }
    }
    const float e0 = row0 < rows ? exp2f(cs_s[row0]) : 0.f;
    const float e1 = row1 < rows ? exp2f(cs_s[row1]) : 0.f;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      y[n][0] *= e0;
      y[n][1] *= e0;
      y[n][2] *= e1;
      y[n][3] *= e1;
    }
    __syncthreads();                     // the ring's space is free again
  }

  auto load_keys = [&](int kj) {
    bf16* bs = ring + (kj & 1) * L::kSlot;
    bf16* xs = bs + kT * kBS;
    load_tile<N>(bs, bb, a.b_ss, kj * kT, rows, tid);
    load_tile<P>(xs, xb, a.x_ss, kj * kT, rows, tid);
  };
  load_keys(0);
  cp_async_commit();

  for (int kj = 0; kj <= qi; ++kj) {
    // tile kj has landed (and C with it); every warp is done with tile
    // kj - 1, whose slot the copy issued below refills
    cp_async_wait<0>();
    __syncthreads();
    if (kj < qi) load_keys(kj + 1);
    cp_async_commit();
    const bf16* bs = ring + (kj & 1) * L::kSlot;
    const bf16* xs = bs + kT * kBS;
    const int k0 = kj * kT;

    // ---- S = C_i B_j^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKN; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, c_frag + 16 * kk);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, bs + (8 * (j + (mi >> 1)) + mr) * kBS + 16 * kk +
                            (mi & 1) * 8);
        mma_bf16(s[j], af, bf[0], bf[1]);
        mma_bf16(s[j + 1], af, bf[2], bf[3]);
      }
    }
    // ---- W' = S exp(cs_l - cs_s) dt_s, masked before exp (col <= row
    // < rows), split into the A fragments of the next product: the C
    // fragment of n-block j is half of k-block j / 2's A fragment
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        w[e] = (col <= row && row < rows)
                   ? s[j][e] * ex2(cs_s[row] - cs_s[col]) * dt_s[col]
                   : 0.f;
      }
      split2(w[0], w[1], ph[j >> 1][(j & 1) * 2], pl[j >> 1][(j & 1) * 2]);
      split2(w[2], w[3], ph[j >> 1][(j & 1) * 2 + 1],
             pl[j >> 1][(j & 1) * 2 + 1]);
    }
    // ---- y += W' X_j (X_j holds [s][p]: the transposed load)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < kND; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, xs + (16 * kk + (mi & 1) * 8 + mr) * kXS +
                                  8 * (n + (mi >> 1)));
        mma_bf16(y[n], ph[kk], bf[0], bf[1]);
        mma_bf16(y[n + 1], ph[kk], bf[2], bf[3]);
        mma_bf16(y[n], pl[kk], bf[0], bf[1]);
        mma_bf16(y[n + 1], pl[kk], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < kND; ++n) {
    const int col = 8 * n + 2 * t;
    if (row0 < rows) store2(yb + (long long)row0 * a.y_ss + col, y[n][0],
                            y[n][1]);
    if (row1 < rows) store2(yb + (long long)row1 * a.y_ss + col, y[n][2],
                            y[n][3]);
  }
}

}  // namespace tc

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

// the two launches of one scan, in stream order
template <typename T, typename O, int P, int N>
cudaError_t run(const Args& a, int bh, cudaStream_t stream) {
  constexpr bool kTc = sizeof(T) == 2;
  const dim3 chunk_grid(bh * a.chunks);
  const dim3 scan_grid(bh, a.chunks, a.q_tiles);
  cudaError_t err;
  if constexpr (kTc) {
    err = launch(tc::ssd_scan_chunk_state<P, N>, chunk_grid,
                 tc::StateSmem<P, N>::kThreads,
                 tc::StateSmem<P, N>::bytes(a.chunk), a, stream);
  } else {
    err = launch(f32::ssd_scan_chunk_state<P, N>, chunk_grid,
                 f32::kThreads,
                 sizeof(float) * f32::state_smem_floats<P, N>(a.chunk), a,
                 stream);
  }
  if (err != cudaSuccess) return err;
  if constexpr (kTc) {
    return launch(tc::ssd_scan_chunk_y<P, N, O>, scan_grid, tc::kThreads,
                  tc::ScanSmem<P, N>::bytes(a.chunk), a, stream);
  } else {
    return launch(f32::ssd_scan_chunk_y<P, N>, scan_grid, f32::kThreads,
                  sizeof(float) * f32::scan_smem_floats<P, N>(a.chunk), a,
                  stream);
  }
}

template <typename T, typename O>
cudaError_t dispatch_pn(int p, int n, const Args& a, int bh,
                        cudaStream_t stream) {
  if (p == 64) {
    if (n == 128) return run<T, O, 64, 128>(a, bh, stream);
    if (n == 64) return run<T, O, 64, 64>(a, bh, stream);
    if (n == 32) return run<T, O, 64, 32>(a, bh, stream);
  } else if (p == 32) {
    if (n == 128) return run<T, O, 32, 128>(a, bh, stream);
    if (n == 64) return run<T, O, 32, 64>(a, bh, stream);
    if (n == 32) return run<T, O, 32, 32>(a, bh, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = head_dim, n = state_dim, nb = (int)bh;
  if (in_dtype == kF32 && out_dtype == kF32)
    return dispatch_pn<float, float>(p, n, a, nb, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return dispatch_pn<bf16, bf16>(p, n, a, nb, s);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return dispatch_pn<bf16, float>(p, n, a, nb, s);
  return cudaErrorInvalidValue;
}
