// LayerNorm forward over the last axis of an (R, C) row-major tensor.
//
// Replaces mxtpu/kernels/layer_norm.py:_ln_fwd_kernel (launched by
// _pallas_ln_fwd).  Per row, in f32, as the TPU kernel does: mean =
// sum(x) / C, then var = sum((x - mean)^2) / C over the centred values
// (not E[x^2] - E[x]^2), rstd = 1 / sqrt(var + eps), y = (x - mean) *
// rstd * gamma + beta in x's type, and the f32 mean and rstd per row.
//
// Bound on the H100: bytes.  At BERT's shape (R = 4096, C = 1024) the
// kernel does ~8 flops per element against reading x and writing y,
// far below the card's flop/byte balance, so the floor is those two
// (R, C) tensors at 3.35 TB/s (5 us in bf16).  At that size what keeps
// a kernel from the floor is latency: each row is two dependent
// reductions, and 8 MiB of bf16 x leaves ~60 KB per SM to keep in
// flight.
//
// Design (the LayerNorm backward's, csrc/layer_norm_bwd.cu).
// ln_fwd_rows_kernel, C <= 8192: a CTA of 8 warps holds 8 / WPR rows at
// a time; a row group of WPR warps takes one row, each thread holding
// E elements of it in registers (LN_FWD_SHAPES: E 16 and WPR 2 at
// C = 1024).
//   * Thread t of a group owns the columns (k * 32 * WPR + t) * VEC + j
//     (k < E / VEC, j < VEC): 16-byte vector loads and stores (8 bf16
//     or 4 f32) where C and every pointer allow, scalar ones otherwise
//     (VEC = 1).  All of a row's x loads are issued before its first
//     reduction, and x stays in registers for the second pass and the
//     write: x is read once, with no shared-memory staging.
//   * Each row sum reduces with warp shuffles (group_sum, common.cuh);
//     a group of several warps adds one exchange through shared memory
//     under a named barrier of its own (double-buffered by the
//     exchange's parity), so no __syncthreads runs per row.
//   * Several rows are in flight per SM: 8 / WPR a CTA, and as many
//     CTAs as the registers allow (launch bounds of 2 at least); the
//     grid gives every row group one row (a grid-stride loop past
//     2^31 - 1 CTAs).
// ln_fwd_wide_kernel, any C (chosen past 8192, which the registers of
// 8 warps hold at 32 elements a thread): one CTA of 512 threads a row
// (grid-stride over the rows), three passes over the row, 16-byte
// vector accesses where allowed: the sum, the sum of squares about the
// mean and the write, with block reductions between them; the second
// and third read of x come from L2 where the row's siblings leave room.
// It takes mxtpu's widest C (131072, the 8-row block in 4 MiB) and any
// beyond; right first, its speed is open.
#include "common.cuh"

constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_WIDE_THREADS = 512;

// (widest C, E, WPR) of the row kernel's instances, as
// kernels/layer_norm.py's LN_FWD_SHAPES
#define LN_FWD_SHAPES(X) \
  X(256, 8, 1) X(512, 16, 1) X(1024, 16, 2) X(2048, 16, 4) X(4096, 16, 8) \
  X(8192, 32, 8)

template <typename T, int VEC, int E, int WPR>
__global__ void __launch_bounds__(LN_THREADS, 2)
    ln_fwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ beta, T* __restrict__ y,
                       float* __restrict__ mean, float* __restrict__ rstd,
                       long long R, int C, float eps) {
  constexpr int NV = E / VEC;
  constexpr int groups = LN_WARPS / WPR;
  constexpr int G = WPR * 32;                        // threads a row
  using P = Pack<T, VEC>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / WPR;
  const int gt = (warp - group * WPR) * 32 + lane;   // thread in group
  __shared__ float red[2][LN_WARPS];
  int parity = 0;
  const long long stride = (long long)gridDim.x * groups;
  for (long long row = (long long)blockIdx.x * groups + group; row < R;
       row += stride) {
    const size_t base = (size_t)row * C;
    P xr[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) xr[k] = ld_pack<T, VEC>(x + base + c);
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if ((k * G + gt) * VEC < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += to_f<T>(xr[k].v[j]);
      }
    const float mu =
        group_sum<WPR>(s, red, parity, warp, lane, group) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if ((k * G + gt) * VEC < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = to_f<T>(xr[k].v[j]) - mu;
          q += d * d;
        }
      }
    const float var =
        group_sum<WPR>(q, red, parity, warp, lane, group) / (float)C;
    const float rs = 1.0f / sqrtf(var + eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) {
        const P gr = ld_pack<T, VEC>(gamma + c);
        const P br = ld_pack<T, VEC>(beta + c);
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = from_f<T>((to_f<T>(xr[k].v[j]) - mu) * rs *
                                 to_f<T>(gr.v[j]) +
                             to_f<T>(br.v[j]));
        st_pack<T, VEC>(y + base + c, o);
      }
    }
    if (gt == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(LN_WIDE_THREADS)
    ln_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ beta, T* __restrict__ y,
                       float* __restrict__ mean, float* __restrict__ rstd,
                       long long R, int C, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float red[LN_WIDE_THREADS / 32];
  const int step = LN_WIDE_THREADS * VEC;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + (size_t)row * C;
    T* yr = y + (size_t)row * C;
    float s = 0.f;
    for (int c = threadIdx.x * VEC; c < C; c += step) {
      const P p = ld_pack<T, VEC>(xr + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += to_f<T>(p.v[j]);
    }
    const float mu = block_sum(s, red) / (float)C;
    float q = 0.f;
    for (int c = threadIdx.x * VEC; c < C; c += step) {
      const P p = ld_pack<T, VEC>(xr + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = to_f<T>(p.v[j]) - mu;
        q += d * d;
      }
    }
    const float var = block_sum(q, red) / (float)C;
    const float rs = 1.0f / sqrtf(var + eps);
    for (int c = threadIdx.x * VEC; c < C; c += step) {
      const P p = ld_pack<T, VEC>(xr + c);
      const P gr = ld_pack<T, VEC>(gamma + c);
      const P br = ld_pack<T, VEC>(beta + c);
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_f<T>((to_f<T>(p.v[j]) - mu) * rs * to_f<T>(gr.v[j]) +
                           to_f<T>(br.v[j]));
      st_pack<T, VEC>(yr + c, o);
    }
    if (threadIdx.x == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

struct LnFwdArgs {
  const void *x, *g, *b;
  void *y, *mean, *rstd;
  long long rows;
  int C, ctas;
  float eps;
};

template <typename T, int VEC, int E, int WPR>
static int launch(const LnFwdArgs& a, cudaStream_t st) {
  if (a.C > 32 * WPR * E) return (int)cudaErrorInvalidValue;
  ln_fwd_rows_kernel<T, VEC, E, WPR><<<a.ctas, LN_THREADS, 0, st>>>(
      (const T*)a.x, (const T*)a.g, (const T*)a.b, (T*)a.y, (float*)a.mean,
      (float*)a.rstd, a.rows, a.C, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_e(int ept, int wpr, const LnFwdArgs& a, cudaStream_t st) {
  if (ept == 0 && wpr == 0) {
    ln_fwd_wide_kernel<T, VEC><<<a.ctas, LN_WIDE_THREADS, 0, st>>>(
        (const T*)a.x, (const T*)a.g, (const T*)a.b, (T*)a.y,
        (float*)a.mean, (float*)a.rstd, a.rows, a.C, a.eps);
    return (int)cudaGetLastError();
  }
#define LN_CASE(MAXC, E, WPR) \
  if (ept == E && wpr == WPR) return launch<T, VEC, E, WPR>(a, st);
  LN_FWD_SHAPES(LN_CASE)
#undef LN_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_t(int vec, int ept, int wpr, const LnFwdArgs& a,
                    cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.g |
                           (uintptr_t)a.b | (uintptr_t)a.y;
    if (a.C % V != 0 || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
    return launch_e<T, V>(ept, wpr, a, st);
  }
  if (vec == 1) return launch_e<T, 1>(ept, wpr, a, st);
  return (int)cudaErrorInvalidValue;
}

// vec: elements per access (16 bytes' worth, or 1); ept, wpr: elements
// a thread holds of a row and warps per row, a pair of LN_FWD_SHAPES
// with 32 * wpr * ept >= C, or (0, 0) for the wide kernel; ctas: the
// grid (kernels/layer_norm.py:_ln_fwd_plan)
extern "C" int mxt_layer_norm_fwd(const void* x, const void* g,
                                  const void* b, void* y, void* mean,
                                  void* rstd, long long rows, int C,
                                  float eps, int vec, int ept, int wpr,
                                  int ctas, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || C < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  const LnFwdArgs a{x, g, b, y, mean, rstd, rows, C, ctas, eps};
  if (dtype == MXT_F32) return launch_t<float>(vec, ept, wpr, a, s);
  if (dtype == MXT_BF16)
    return launch_t<__nv_bfloat16>(vec, ept, wpr, a, s);
  return (int)cudaErrorInvalidValue;
}
