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
// operations and bytes are close, ~0.05 ms either way.  This first
// version runs on the CUDA cores in f32 and is far from that bound by
// design; tensor-core tiles and splitting a sequence's chunks across
// blocks are later changes.
//
// Design (simple first): one thread block per (batch, head), 256
// threads, which loops over the chunks in order (the TPU kernel's
// sequential grid axis) with the (P, N) state in shared memory.  A
// 256-row chunk does not fit in shared memory in f32, so it is cut into
// 64-row tiles, flash-attention style: for query tile i the block loops
// over key tiles j <= i, forms C_i B_j^T over N (each thread a 4 x 4
// register tile), weights it by exp(cs_l - cs_s) under the causal mask,
// and accumulates its product with xd_j into y_i in registers; then it
// adds the carried-state term and writes y_i.  The state update is
// summed in registers while the last query tile walks every key tile,
// and applied once the chunk's y no longer needs the old state.  The
// cumulative sum is a warp scan.  x, dt, b, c and y are read and
// written in place through their strides, so the model's (B, S, H, P)
// views of the conv output need no copy, and the Pallas layout
// (BH, S, P) is the view B = 1, H = G = BH.  No atomics: a repeat is
// bit for bit the same.
//
// Interface: plain C, bound with ctypes; returns cudaGetLastError() of
// the launch.  It launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;                   // rows per tile
constexpr int kThreads = 256;            // a 16 x 16 thread grid
constexpr int kMaxChunk = 1024;

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
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* init;                     // (B, H, P, N) or null
  void* y;
  float* state;                          // (B, H, P, N)
  int heads, groups, seq, chunk;
  // strides in elements over (batch, seq, head or group); the last dim
  // of x, b, c and y is dense
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
};

template <int P, int N>
__host__ __device__ constexpr size_t smem_floats(int chunk) {
  return (size_t)P * (N + 1) + 2 * (size_t)kT * (N + 1) + (size_t)kT * P +
         (size_t)kT * (kT + 1) + 2 * (size_t)chunk;
}

template <typename T, typename O, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  constexpr int NP = N + 1;              // padded rows: conflict-free
  constexpr int WP = kT + 1;
  constexpr int PK = P / 16;             // p columns per thread
  constexpr int NK = N / 16;             // n columns per thread
  extern __shared__ float smem[];
  float* st_s = smem;                    // P x NP carried state
  float* c_s = st_s + P * NP;            // kT x NP: C of the query tile
  float* b_s = c_s + kT * NP;            // kT x NP: B of the key tile
  float* x_s = b_s + kT * NP;            // kT x P: x * dt of the key tile
  float* w_s = x_s + kT * P;             // kT x WP: decayed scores
  float* dt_s = w_s + kT * WP;           // chunk: dt of the chunk's rows
  float* cs_s = dt_s + a.chunk;          // chunk: cumsum of dt * a

  const int bh = blockIdx.x;
  const int bi = bh / a.heads, h = bh % a.heads;
  const int g = h / (a.heads / a.groups);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float av = a.a[h];

  const T* __restrict__ xb = static_cast<const T*>(a.x) + bi * a.x_sb +
                             h * a.x_sh;
  const float* __restrict__ dtb = a.dt + bi * a.dt_sb + h * a.dt_sh;
  const T* __restrict__ bb = static_cast<const T*>(a.b) + bi * a.b_sb +
                             g * a.b_sg;
  const T* __restrict__ cb = static_cast<const T*>(a.c) + bi * a.c_sb +
                             g * a.c_sg;
  O* __restrict__ yb = static_cast<O*>(a.y) + bi * a.y_sb + h * a.y_sh;

  for (int i = tid; i < P * N; i += kThreads)
    st_s[(i / N) * NP + i % N] =
        a.init ? a.init[(long long)bh * P * N + i] : 0.f;

  for (int c0 = 0; c0 < a.seq; c0 += a.chunk) {
    const int rows = min(a.chunk, a.seq - c0);
    __syncthreads();                     // last chunk's readers are done
    if (tid < 32) {
      // dt and the inclusive cumsum of dt * a: each lane sums a run of
      // rows, a warp scan adds the runs before it
      const int per = (rows + 31) / 32;
      const int r0 = tid * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        const int r = r0 + k;
        if (r < rows) {
          const float d = dtb[(long long)(c0 + r) * a.dt_ss];
          dt_s[r] = d;
          run += d * av;
          cs_s[r] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float before = incl - run;
      for (int k = 0; k < per; ++k) {
        const int r = r0 + k;
        if (r < rows) cs_s[r] += before;
      }
    }
    __syncthreads();
    const float cs_last = cs_s[rows - 1];
    const int tiles = (rows + kT - 1) / kT;

    float delta[PK][NK];                 // this chunk's state increment
#pragma unroll
    for (int k = 0; k < PK; ++k)
#pragma unroll
      for (int m = 0; m < NK; ++m) delta[k][m] = 0.f;

    for (int qi = 0; qi < tiles; ++qi) {
      const int q0 = qi * kT;
      __syncthreads();                   // c_s is free
      for (int i = tid; i < kT * N; i += kThreads) {
        const int r = i / N, n = i % N;
        const int row = q0 + r;
        c_s[r * NP + n] =
            row < rows ? to_float(cb[(long long)(c0 + row) * a.c_ss + n])
                       : 0.f;
      }
      float acc[4][PK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < PK; ++k) acc[i][k] = 0.f;

      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = kj * kT;
        __syncthreads();                 // b_s, x_s and w_s are free
        for (int i = tid; i < kT * N; i += kThreads) {
          const int r = i / N, n = i % N;
          const int row = k0 + r;
          b_s[r * NP + n] =
              row < rows ? to_float(bb[(long long)(c0 + row) * a.b_ss + n])
                         : 0.f;
        }
        for (int i = tid; i < kT * P; i += kThreads) {
          const int r = i / P, p = i % P;
          const int row = k0 + r;
          x_s[r * P + p] =
              row < rows
                  ? to_float(xb[(long long)(c0 + row) * a.x_ss + p]) *
                        dt_s[row]
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
          for (int k = 0; k < PK; ++k) xv[k] = x_s[sr * P + tx + 16 * k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < PK; ++k) acc[i][k] = fmaf(wv[i], xv[k], acc[i][k]);
        }

        if (qi == tiles - 1) {
          // the last query tile walks every key tile once: sum the state
          // increment, p = ty + 16 k, n = tx + 16 m
          const int n_rows = min(kT, rows - k0);
          for (int sr = 0; sr < n_rows; ++sr) {
            const float dec = expf(cs_last - cs_s[k0 + sr]);
            float u[PK], bv[NK];
#pragma unroll
            for (int k = 0; k < PK; ++k) u[k] = x_s[sr * P + ty + 16 * k] * dec;
#pragma unroll
            for (int m = 0; m < NK; ++m) bv[m] = b_s[sr * NP + tx + 16 * m];
#pragma unroll
            for (int k = 0; k < PK; ++k)
#pragma unroll
              for (int m = 0; m < NK; ++m)
                delta[k][m] = fmaf(u[k], bv[m], delta[k][m]);
          }
        }
      }

      // the carried state's term exp(cs_l) (state c_l), then write y_i
      float t[4][PK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < PK; ++k) t[i][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PK];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int k = 0; k < PK; ++k) sv[k] = st_s[(tx + 16 * k) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < PK; ++k) t[i][k] = fmaf(cv[i], sv[k], t[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r < rows) {
          const float e = expf(cs_s[r]);
          O* yr = yb + (long long)(c0 + r) * a.y_ss;
#pragma unroll
          for (int k = 0; k < PK; ++k)
            yr[tx + 16 * k] = from_float<O>(acc[i][k] + e * t[i][k]);
        }
      }
    }

    __syncthreads();                     // every read of the old state done
    const float el = expf(cs_last);
#pragma unroll
    for (int k = 0; k < PK; ++k)
#pragma unroll
      for (int m = 0; m < NK; ++m) {
        float* sp = st_s + (ty + 16 * k) * NP + tx + 16 * m;
        *sp = el * *sp + delta[k][m];
      }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    a.state[(long long)bh * P * N + i] = st_s[(i / N) * NP + i % N];
}

template <typename T, typename O, int P, int N>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<P, N>(a.chunk);
  auto kernel = ssd_scan_kernel<T, O, P, N>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t dispatch_pn(int p, int n, const Args& a, int blocks,
                        cudaStream_t stream) {
  if (p == 64) {
    if (n == 128) return launch<T, O, 64, 128>(a, blocks, stream);
    if (n == 64) return launch<T, O, 64, 64>(a, blocks, stream);
    if (n == 32) return launch<T, O, 64, 32>(a, blocks, stream);
  } else if (p == 32) {
    if (n == 128) return launch<T, O, 32, 128>(a, blocks, stream);
    if (n == 64) return launch<T, O, 32, 64>(a, blocks, stream);
    if (n == 32) return launch<T, O, 32, 32>(a, blocks, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_scan(
    const void* x, const void* dt, const void* a_vec, const void* b,
    const void* c, const void* init, void* y, void* state, int batch,
    int seq, int heads, int groups, int head_dim, int state_dim, int chunk,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
    long long b_sg, long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh, int in_dtype,
    int out_dtype, void* stream) {
  if (batch == 0 || heads == 0) return cudaSuccess;
  if (seq < 1 || chunk < 1 || chunk > kMaxChunk || groups < 1 ||
      heads % groups)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)batch * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(a_vec),
         b, c, static_cast<const float*>(init), y,
         static_cast<float*>(state), heads, groups, seq, chunk,
         x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
         c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = head_dim, n = state_dim, nb = (int)blocks;
  if (in_dtype == kF32 && out_dtype == kF32)
    return dispatch_pn<float, float>(p, n, a, nb, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return dispatch_pn<__nv_bfloat16, __nv_bfloat16>(p, n, a, nb, s);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return dispatch_pn<__nv_bfloat16, float>(p, n, a, nb, s);
  return cudaErrorInvalidValue;
}
