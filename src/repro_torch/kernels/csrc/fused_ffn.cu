// Fused gated FFN, y = (act(x @ Wg) * (x @ Wu)) @ Wd, for Hopper (sm_90a),
// in three routes: two for bf16 (tensor-core tiles for large M, an
// F-split one-launch kernel for small M) and the f32 CUDA-core kernel.
//
// Replaces the Pallas TPU kernel `fused_ffn` in
// src/repro/kernels/fused_ffn.py (pallas_call at line 54, kernel body
// `_fused_ffn_kernel` at line 24).  Plain version:
// repro_torch.kernels.ref.fused_ffn_ref.
//
// What it computes: x (M, D), Wg and Wu (D, F), Wd (F, D), all f32 or
// all bf16; act is silu or the tanh form of gelu (jax.nn.gelu's
// default).  The hidden tile act(x@Wg) * (x@Wu) never goes to device
// memory.  Accumulation: the TPU kernel adds each F tile's partial
// product into its output block in the output's dtype, so in bf16 it
// rounds once per F tile (fused_ffn.py:34-41).  These kernels follow the
// oracle instead: every sum is f32 across all of F, rounded once to the
// output dtype.  No float atomics anywhere: a result repeats bit for bit.
//
// Bound on the H100: at the served shapes (D 256, F 1024) a decode step
// (M = 8) reads the three weight matrices, 1.5 MB in bf16, for 12.6
// MFLOP: bytes bound (~0.5 us).  A prefill burst (M = 8 x 2048) does
// 6 * M * D * F = 25.8 GFLOP on ~18 MB: operations bound on the bf16
// tensor cores (0.026 ms).
//
// bf16, large M (fused_ffn_wg_kernel), on wgmma: one warpgroup (4 warps)
// per 64-row tile of x and 256-column tile of the output (blockIdx.y, D >
// 256 only).  The x tile is staged in shared memory once when D <= 512,
// else streamed with each D chunk.  The loop runs over 32-wide F tiles;
// each F tile is a sequence of chunks, D/256 chunks of [Wg | Wu] (256 x
// 64) and one chunk of Wd (32 x 256), staged with cp.async 16-byte copies
// into a two-slot ring (one barrier a chunk) so the next chunk loads
// while this one computes.  [G | U] = x [Wg | Wu] is one wgmma
// m64n64k16 a k-step, both operands read by the tensor cores from shared
// memory; H = act(G) * U is computed in f32 in registers (fast
// intrinsics), rounded to bf16 and is the register A operand of O += H
// Wd[f-tile, :], a wgmma m64n256k16 (the accumulator fragment of one is
// the A fragment of the next).  O (64 x 256 over the warpgroup) stays in
// f32 registers across all of F and is rounded once.  Each chunk's
// products are committed as one group and waited for only at the next
// chunk, so they overlap the next copy.  The operands use the 128-byte
// swizzled layout (each 16-byte chunk of a 128-byte row XORed with the
// row's index in its 8-row atom): without it the tensor cores' reads
// conflict in shared memory.  Rounding H
// to bf16 adds ~2^-9 relative per term of the last sum; the output's own
// bf16 rounding is the same size.
//
// bf16, small M (fused_ffn_small_kernel, M <= 64, a decode step): bound
// by the weight bytes, so the grid splits F into 16-column slices (two
// 16-byte row segments of Wg/Wu) and the output into 64-column chunks:
// 256 blocks of 8 warps at F 1024, D 256.  Each block stages x (M rows),
// its Wg/Wu slices and its Wd rows with cp.async, computes G and U for
// its slice on mma.sync (warps split D; their f32 partials are added in
// a fixed order), H in f32, and its f32 partial of the output chunk on
// the CUDA cores, written to the workspace.  The last block of a chunk to
// arrive (__threadfence, then a counter in the workspace) adds the
// partials in split order, 16 splits' loads in flight at a time, rounds
// once and resets the counter: one launch, no float atomics.
//
// f32 (fused_ffn_kernel), kept from the first version: the tensor cores
// would compute f32 as TF32.  Grid (64-row tile, 256-column output tile,
// F split); phase A computes the (64, 64) hidden tile into shared memory
// with 4x4 register tiles, phase B adds h @ Wd into 4x16 f32 outputs a
// thread.  Small M splits F across blocks into an f32 workspace that a
// second pass adds in a fixed order.
//
// Any M, D and F for f32; D and F multiples of 8 and 16-byte aligned
// rows for bf16 (the wrapper checks).  Ragged tiles are masked (loads of
// 0 give a hidden value act(0) * 0 == 0).
//
// Interface: plain C, bound with ctypes; each entry returns
// cudaGetLastError() of its launches.  It launches on the caller's
// stream and allocates nothing: the wrapper passes the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;      // rows per block
constexpr int kBF = 64;      // hidden columns per F tile
constexpr int kBD = 256;     // output columns per block
constexpr int kKD = 32;      // D chunk of phase A
constexpr int kThreads = 256;
constexpr int kXP = kKD + 1;
constexpr int kHP = kBF + 1;

enum DType { kF32 = 0, kBF16 = 1 };
enum Act { kSilu = 0, kGelu = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == kSilu) return g / (1.f + expf(-g));
  // tanh approximation: 0.5 g (1 + tanh(sqrt(2/pi) (g + 0.044715 g^3)))
  return 0.5f * g * (1.f + tanhf(0.7978845608028654f *
                                 (g + 0.044715f * g * g * g)));
}

struct Args {
  const void* x;
  const void* wg;
  const void* wu;
  const void* wd;
  void* out;           // written directly when nsplit == 1
  float* ws;           // nsplit x M x D partial sums otherwise
  int m, d, f, nsplit, f_tiles_per_split, act;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ffn_kernel(Args a) {
  extern __shared__ float smem[];
  float* x_s = smem;                     // kBM x kXP
  float* g_s = x_s + kBM * kXP;          // kKD x kBF
  float* u_s = g_s + kKD * kBF;          // kKD x kBF
  float* h_s = u_s + kKD * kBF;          // kBM x kHP
  float* w_s = h_s + kBM * kHP;          // kBF x kBD

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ wg = static_cast<const T*>(a.wg);
  const T* __restrict__ wu = static_cast<const T*>(a.wu);
  const T* __restrict__ wd = static_cast<const T*>(a.wd);

  const int M = a.m, D = a.d, F = a.f;
  const int m0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBD;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float o[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) o[i][j] = 0.f;

  const int ft_begin = blockIdx.z * a.f_tiles_per_split;
  const int ft_end = min(ft_begin + a.f_tiles_per_split,
                         (F + kBF - 1) / kBF);
  for (int ft = ft_begin; ft < ft_end; ++ft) {
    const int f0 = ft * kBF;
    // ---- phase A: the (kBM, kBF) hidden tile
    float g[4][4], u[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += kKD) {
      for (int i = tid; i < kBM * kKD; i += kThreads) {
        const int rr = i / kKD, kk = i % kKD;
        const int row = m0 + rr, col = k0 + kk;
        x_s[rr * kXP + kk] =
            row < M && col < D ? to_float(x[(long long)row * D + col]) : 0.f;
      }
      for (int i = tid; i < kKD * kBF; i += kThreads) {
        const int kk = i / kBF, ff = i % kBF;
        const int row = k0 + kk, col = f0 + ff;
        const bool in = row < D && col < F;
        const long long off = (long long)row * F + col;
        g_s[i] = in ? to_float(wg[off]) : 0.f;
        u_s[i] = in ? to_float(wu[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKD; ++kk) {
        float xv[4], gv[4], uv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = x_s[(ty * 4 + i) * kXP + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gv[j] = g_s[kk * kBF + tx + 16 * j];
          uv[j] = u_s[kk * kBF + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            g[i][j] = fmaf(xv[i], gv[j], g[i][j]);
            u[i][j] = fmaf(xv[i], uv[j], u[i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h_s[(ty * 4 + i) * kHP + tx + 16 * j] =
            activate(g[i][j], a.act) * u[i][j];
    for (int i = tid; i < kBF * kBD; i += kThreads) {
      const int ff = i / kBD, dd = i % kBD;
      const int row = f0 + ff, col = d0 + dd;
      w_s[i] = row < F && col < D ? to_float(wd[(long long)row * D + col])
                                  : 0.f;
    }
    __syncthreads();
    // ---- phase B: out_tile += h @ Wd tile, f32
#pragma unroll 4
    for (int ff = 0; ff < kBF; ++ff) {
      float hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = h_s[(ty * 4 + i) * kHP + ff];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float w = w_s[ff * kBD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(hv[i], w, o[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = d0 + tx + 16 * j;
      if (col >= D) continue;
      const long long off = (long long)row * D + col;
      if (a.nsplit == 1)
        static_cast<T*>(a.out)[off] = from_float<T>(o[i][j]);
      else
        a.ws[(long long)blockIdx.z * M * D + off] = o[i][j];
    }
  }
}

// Adds the F splits in order and rounds once.
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  T* __restrict__ out, long long n,
                                  int nsplit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < nsplit; ++z) s += ws[(long long)z * n + i];
  out[i] = from_float<T>(s);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) *
                       ((size_t)kBM * kXP + 2 * (size_t)kKD * kBF +
                        (size_t)kBM * kHP + (size_t)kBF * kBD);
  auto kernel = fused_ffn_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.m + kBM - 1) / kBM, (a.d + kBD - 1) / kBD, a.nsplit);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long n = (long long)a.m * a.d;
  const int threads = 256;
  sum_splits_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         stream>>>(a.ws, static_cast<T*>(a.out), n, a.nsplit);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16 tensor-core routes --
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the activation of the bf16 routes: silu through the fast exp (ex2
// based, a few ulp for the |g| < 20 of an FFN's gate) and a fast
// division, gelu as in `activate` (tanhf at full f32 precision); both
// far inside the bf16 rounding of H and of the output
__device__ __forceinline__ float activate_fast(float g, int act) {
  if (act == kSilu) return __fdividef(g, 1.f + __expf(-g));
  return activate(g, act);
}

struct TcArgs {
  const bf16* x;
  const bf16* wg;
  const bf16* wu;
  const bf16* wd;
  bf16* out;
  int m, d, f, act;
};

// d (64 x 64 f32) (+)= a (64 x 16, K-major in shared memory) * b
// (16 x 64, N-major in shared memory)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256 f32) (+)= a (64 x 16 bf16, mma.sync A fragments in
// each warp's registers) * b (16 x 256, N-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t a[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ------------------------------------------------- bf16 large M on wgmma
// Shared operands of wgmma in the 128-byte swizzled layout: atoms of 8
// rows x 128 bytes on 1024-byte boundaries, the 16-byte chunk c of row r
// stored at chunk c ^ (r % 8).  x is K-major (a row holds 64 k of one
// row of x); Wg, Wu and Wd stay N-major as they lie in device memory (a
// row holds 64 n of one k; the descriptors ask for B transposed), so
// each 16-byte cp.async lands one chunk.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);                              // 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulators while a wgmma owns them
__device__ __forceinline__ void fence_regs(float* r, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the copies' writes (generic proxy) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

namespace wg {
constexpr int kBM = 64;                   // rows a block: one warpgroup
constexpr int kBF = 32;                   // F columns a tile
constexpr int kBD = 256;                  // output columns a block
constexpr int kKD = 256;                  // D rows of a Wg/Wu chunk
constexpr int kThreads = 128;
constexpr int kSlotA = 2 * kKD * kBF;     // [Wg | Wu], in bf16
constexpr int kSlotX = kBM * kKD;         // + x's chunk when streamed
constexpr int kSlotB = kBF * kBD;         // Wd
__host__ __device__ constexpr int slot_elems(bool xres) {
  return (xres ? kSlotA : kSlotA + kSlotX) > kSlotB
             ? (xres ? kSlotA : kSlotA + kSlotX)
             : kSlotB;
}
__host__ __device__ inline int d_pad(int d) {
  return (d + kKD - 1) / kKD * kKD;
}
__host__ __device__ inline size_t smem_bytes(int d, bool xres) {
  // + 1024: the atoms need a 1024-byte aligned base
  return sizeof(bf16) * ((xres ? (size_t)kBM * d_pad(d) : 0) +
                         2 * (size_t)slot_elems(xres)) +
         1024;
}
}  // namespace wg

template <bool XRES>
__global__ void __launch_bounds__(wg::kThreads)
    fused_ffn_wg_kernel(TcArgs a) {
  constexpr int kBM = wg::kBM, kBF = wg::kBF, kBD = wg::kBD, kKD = wg::kKD;
  constexpr int kThreads = wg::kThreads, kSlot = wg::slot_elems(XRES);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = a.m, D = a.d, F = a.f;
  const int dp = wg::d_pad(D);
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // x: blocks of 64 k, each 64 rows x 128 bytes; resident (all of D) or
  // one kKD chunk in each slot behind [Wg | Wu]
  unsigned char* x_s = smem;
  unsigned char* slots = smem + (XRES ? kBM * dp * 2 : 0);

  const int m0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_a = dp / kKD;                         // Wg/Wu chunks a tile
  const int n_chunks = (F + kBF - 1) / kBF * (n_a + 1);

  // rows r of x, 16-byte chunks kc from column k0: block kc / 8, chunk
  // kc % 8 of row r
  auto load_x = [&](unsigned char* dst, int k0, int chunks) {
    for (int i = tid; i < kBM * chunks; i += kThreads) {
      const int r = i / chunks, kc = i % chunks;
      const int row = m0 + r, col = k0 + kc * 8;
      const bool ok = row < M && col < D;
      cp_async16(dst + (kc >> 3) * (kBM * 128) + swz(r, kc & 7),
                 a.x + (ok ? (long long)row * D + col : 0), ok);
    }
  };
  if (XRES) load_x(x_s, 0, dp / 8);
  auto issue = [&](int i, int slot) {
    unsigned char* base = slots + slot * kSlot * 2;
    const int ft = i / (n_a + 1), c = i % (n_a + 1);
    const int f0 = ft * kBF;
    if (c < n_a) {
      // [Wg | Wu] as one 64-wide B: row k holds Wg's 32 columns of the
      // tile in chunks 0..3 and Wu's in chunks 4..7
      const int k0 = c * kKD;
      for (int j = tid; j < kKD * (kBF / 8); j += kThreads) {
        const int r = j / (kBF / 8), nc = j % (kBF / 8);
        const int kr = k0 + r, col = f0 + nc * 8;
        const bool ok = kr < D && col < F;
        const long long off = ok ? (long long)kr * F + col : 0;
        cp_async16(base + swz(r, nc), a.wg + off, ok);
        cp_async16(base + swz(r, kBF / 8 + nc), a.wu + off, ok);
      }
      if (!XRES) load_x(base + wg::kSlotA * 2, k0, kKD / 8);
    } else {
      // Wd rows f0 + r, columns d0 + 8 nc: 64-column atoms of 32 rows,
      // 4096 bytes apart
      for (int j = tid; j < kBF * (kBD / 8); j += kThreads) {
        const int r = j / (kBD / 8), nc = j % (kBD / 8);
        const int fr = f0 + r, col = d0 + nc * 8;
        const bool ok = fr < F && col < D;
        cp_async16(base + (nc >> 3) * (kBF * 128) + swz(r, nc & 7),
                   a.wd + (ok ? (long long)fr * D + col : 0), ok);
      }
    }
  };

  float o[kBD / 2];                     // 64 x 256 f32 over the warpgroup
  float gu[kBF];                        // [G | U], 64 x 64 f32
#pragma unroll
  for (int i = 0; i < kBD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBF; ++i) gu[i] = 0.f;

  issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < n_chunks; ++i) {
    // chunk i has landed; the products of chunk i - 1 (the last group in
    // flight) are done, so its slot is free for the copy issued below
    cp_async_wait<0>();
    fence_proxy_async();
    wgmma_wait<0>();
    __syncthreads();
    if (i + 1 < n_chunks) issue(i + 1, (i + 1) & 1);
    cp_async_commit();
    const unsigned char* base = slots + (i & 1) * kSlot * 2;
    const int c = i % (n_a + 1);
    if (c < n_a) {
      // ---- [G | U] += x[:, k-chunk] @ [Wg | Wu][k-chunk, f-tile]; a
      // k-step is 32 bytes into x's 128-byte rows and 16 rows of [Wg|Wu]
      fence_regs(gu, kBF);
      wgmma_fence();
#pragma unroll 4
      for (int kk = 0; kk < kKD / 16; ++kk) {
        const int k = (XRES ? c * kKD : 0) + 16 * kk;
        const unsigned char* xb = XRES ? x_s : base + wg::kSlotA * 2;
        wgmma_ss_n64(gu,
                     wgmma_desc(xb + (k >> 6) * (kBM * 128) + (k & 63) * 2,
                                16, 1024),
                     wgmma_desc(base + kk * 16 * 128, 16, 1024), 1);
      }
      wgmma_commit();
    } else {
      // ---- H = act(G) * U as bf16 A fragments, O += H @ Wd[f-tile, :]
      fence_regs(gu, kBF);
      uint32_t hf[kBF / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBF / 16; ++kk)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int n = 2 * kk + h2;            // n-block n of G, 4 + n of U
          float hv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hv[e] = activate_fast(gu[4 * n + e], a.act) *
                    gu[kBF / 2 + 4 * n + e];
          hf[kk][2 * h2] = pack_bf16(hv[0], hv[1]);
          hf[kk][2 * h2 + 1] = pack_bf16(hv[2], hv[3]);
        }
#pragma unroll
      for (int i2 = 0; i2 < kBF; ++i2) gu[i2] = 0.f;
      fence_regs(o, kBD / 2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBF / 16; ++kk)
        wgmma_rs_n256(o, hf[kk],
                      wgmma_desc(base + kk * 16 * 128, kBF * 128, 1024), 1);
      wgmma_commit();
    }
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  fence_regs(o, kBD / 2);

  const int row0 = m0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < kBD / 8; ++n) {
    const int col = d0 + 8 * n + 2 * t;
    if (col >= D) continue;
    if (row0 < M)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (long long)row0 * D + col) =
          __floats2bfloat162_rn(o[4 * n], o[4 * n + 1]);
    if (row1 < M)
      *reinterpret_cast<__nv_bfloat162*>(a.out + (long long)row1 * D + col) =
          __floats2bfloat162_rn(o[4 * n + 2], o[4 * n + 3]);
  }
}

namespace sm {
constexpr int kFS = 16;                   // F columns a block
constexpr int kWR = kFS + 8;              // Wg/Wu slice row, in bf16
constexpr int kDC = 64;                   // output columns a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 64;
__host__ __device__ inline int m_pad(int m) {
  return (m + 15) / 16 * 16;
}
__host__ __device__ inline int d_pad(int d) {
  return (d + 15) / 16 * 16;
}
}  // namespace sm

struct SmallArgs {
  const bf16* x;
  const bf16* wg;
  const bf16* wu;
  const bf16* wd;
  bf16* out;
  float* ws;            // nsplit x M x D partial sums
  int* counters;        // one per output chunk, 0 between launches
  int m, d, f, act, nsplit;
};

__global__ void __launch_bounds__(sm::kThreads)
    fused_ffn_small_kernel(SmallArgs a) {
  constexpr int kFS = sm::kFS, kWR = sm::kWR, kDC = sm::kDC;
  constexpr int kThreads = sm::kThreads, kWarps = sm::kWarps;
  constexpr int kMaxM = sm::kMaxM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = a.m, D = a.d, F = a.f;
  // the layout that the wrapper's small_smem_bytes sizes
  const int mp = sm::m_pad(M), dp = sm::d_pad(D), xs = dp + 8;
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);    // mp x xs
  bf16* wg_s = x_s + mp * xs;                        // dp x kWR
  bf16* wu_s = wg_s + dp * kWR;                      // dp x kWR
  bf16* wd_s = wu_s + dp * kWR;                      // kFS x kDC
  float* red_s = reinterpret_cast<float*>(wd_s + kFS * kDC);
  float* h_s = red_s + kWarps * mp * kFS * 2;        // mp x kFS

  const int split = blockIdx.x, f0 = split * kFS;
  const int d0 = blockIdx.y * kDC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;

  for (int i = tid; i < mp * (dp / 8); i += kThreads) {
    const int r = i / (dp / 8), col = (i % (dp / 8)) * 8;
    const bool ok = r < M && col < D;
    cp_async16(x_s + r * xs + col, a.x + (ok ? (long long)r * D + col : 0),
               ok);
  }
  for (int i = tid; i < dp * (kFS / 8); i += kThreads) {
    const int k = i / (kFS / 8), c = (i % (kFS / 8)) * 8;
    const bool ok = k < D && f0 + c < F;
    const long long off = ok ? (long long)k * F + f0 + c : 0;
    cp_async16(wg_s + k * kWR + c, a.wg + off, ok);
    cp_async16(wu_s + k * kWR + c, a.wu + off, ok);
  }
  for (int i = tid; i < kFS * (kDC / 8); i += kThreads) {
    const int r = i / (kDC / 8), c = (i % (kDC / 8)) * 8;
    const bool ok = f0 + r < F && d0 + c < D;
    cp_async16(wd_s + r * kDC + c,
               a.wd + (ok ? (long long)(f0 + r) * D + d0 + c : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- G, U for the slice: warps split D, partials added in warp order
  float gacc[kMaxM / 16][2][4], uacc[kMaxM / 16][2][4];
#pragma unroll
  for (int i = 0; i < kMaxM / 16; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[i][n][e] = uacc[i][n][e] = 0.f;
  for (int kk = warp; kk < dp / 16; kk += kWarps) {
    uint32_t bg[4], bu[4];          // b0, b1 of n-blocks 0 and 1
    const int off = (16 * kk + (mi & 1) * 8 + mr) * kWR + (mi >> 1) * 8;
    ldmatrix_x4_trans(bg, wg_s + off);
    ldmatrix_x4_trans(bu, wu_s + off);
#pragma unroll
    for (int i = 0; i < kMaxM / 16; ++i) {
      if (16 * i < mp) {
        uint32_t af[4];
        ldmatrix_x4(af, x_s + (16 * i + (mi & 1) * 8 + mr) * xs + 16 * kk +
                            (mi >> 1) * 8);
        mma_bf16(gacc[i][0], af, bg[0], bg[1]);
        mma_bf16(gacc[i][1], af, bg[2], bg[3]);
        mma_bf16(uacc[i][0], af, bu[0], bu[1]);
        mma_bf16(uacc[i][1], af, bu[2], bu[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxM / 16; ++i) {
    if (16 * i < mp) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + (e < 2 ? 0 : 8);
          const int col = 8 * n + 2 * t + (e & 1);
          float* r = red_s + ((warp * mp + row) * kFS + col) * 2;
          r[0] = gacc[i][n][e];
          r[1] = uacc[i][n][e];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < mp * kFS; i += kThreads) {
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      gs += red_s[(w * mp * kFS + i) * 2];
      us += red_s[(w * mp * kFS + i) * 2 + 1];
    }
    h_s[i] = activate_fast(gs, a.act) * us;
  }
  __syncthreads();

  // ---- this slice's f32 share of the output chunk, to the workspace
  for (int i = tid; i < M * kDC; i += kThreads) {
    const int row = i / kDC, c = i % kDC;
    if (d0 + c >= D) continue;
    float acc = 0.f;
#pragma unroll
    for (int ff = 0; ff < kFS; ++ff)
      acc = fmaf(h_s[row * kFS + ff], __bfloat162float(wd_s[ff * kDC + c]),
                 acc);
    a.ws[((long long)split * M + row) * D + d0 + c] = acc;
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(a.counters + blockIdx.y, 1) == a.nsplit - 1;
  __syncthreads();
  if (!last) return;
  // ---- the last block of this chunk adds the splits in order, with 16
  // splits' loads in flight at a time
  __threadfence();
  const long long step = (long long)M * D;
  for (int i = tid; i < M * kDC; i += kThreads) {
    const int row = i / kDC, c = i % kDC;
    if (d0 + c >= D) continue;
    const float* p = a.ws + (long long)row * D + d0 + c;
    float acc = 0.f;
    int sp = 0;
    for (; sp + 16 <= a.nsplit; sp += 16) {
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = __ldcg(p + (sp + r) * step);
#pragma unroll
      for (int r = 0; r < 16; ++r) acc += v[r];
    }
    for (; sp < a.nsplit; ++sp) acc += __ldcg(p + sp * step);
    a.out[(long long)row * D + d0 + c] = __float2bfloat16(acc);
  }
  if (tid == 0) a.counters[blockIdx.y] = 0;          // ready for the next
}

}  // namespace

extern "C" int fused_ffn(const void* x, const void* wg, const void* wu,
                         const void* wd, void* out, void* ws, int m, int d,
                         int f, int nsplit, int f_tiles_per_split, int act,
                         int dtype, void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  Args a{x, wg, wu, wd, out, static_cast<float*>(ws), m, d, f, nsplit,
         f_tiles_per_split, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 entries launch the grid of the wrapper's plan (ffn_plan in
// kernels/fused_ffn.py) as given.
extern "C" int fused_ffn_bf16_tiles(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    void* out, int m, int d, int f, int act,
                                    int x_resident, int row_tiles,
                                    int col_tiles, void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  TcArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
           static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
           static_cast<bf16*>(out), m, d, f, act};
  const size_t bytes = wg::smem_bytes(d, x_resident != 0);
  auto kernel = x_resident ? fused_ffn_wg_kernel<true>
                           : fused_ffn_wg_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(row_tiles, col_tiles);
  kernel<<<grid, wg::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int fused_ffn_bf16_small(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    void* out, void* ws, void* counters,
                                    int m, int d, int f, int act, int nsplit,
                                    int nchunks, int smem_bytes,
                                    void* stream) {
  if (m == 0 || d == 0) return cudaSuccess;
  SmallArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
              static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
              static_cast<bf16*>(out), static_cast<float*>(ws),
              static_cast<int*>(counters), m, d, f, act, nsplit};
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  fused_ffn_small_kernel<<<dim3(nsplit, nchunks), sm::kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
