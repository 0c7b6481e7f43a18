// LayerNorm backward over the last axis of an (R, C) row-major tensor,
// from the forward's f32 mean and rstd.
//
// Replaces mxtpu/kernels/layer_norm.py:_ln_bwd_kernel (launched by
// _pallas_ln_bwd).  Per row, in f32:
//   xhat = (x - mean) * rstd,  dyg = dy * gamma,
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)),
// and the parameter gradients dgamma = sum_rows dy * xhat, dbeta =
// sum_rows dy, in gamma's type.
//
// Bound on the H100: bytes.  At the training shape (R = 4096, C = 1024)
// it does ~12 flops per element against reading x and dy and writing
// dx, far below the card's flop/byte balance, so the floor is those
// three (R, C) tensors at 3.35 TB/s (7.5 us in bf16).  What keeps a
// kernel from it at this size is latency, not bandwidth: each row is
// two dependent reductions, and 24 MiB leaves ~190 KB per SM.
//
// Design.  ln_bwd_rows_kernel: a persistent grid of 2-4 CTAs an SM
// (8 warps each) strides over the rows; a row group of WPR warps takes
// one row at a time, each thread holding E elements of it (LN_SHAPES:
// E 16 and WPR 2 at C = 1024, where one warp a row at E = 32, a CTA an
// SM, measured slower on the H100).
//   * Thread t of a group owns the columns (k * 32 * WPR + t) * VEC + j
//     (k < E / VEC, j < VEC), the same in every row: its VEC-wide
//     accesses are 16-byte vector loads and stores (8 bf16 or 4 f32)
//     where C and every pointer allow, scalar ones otherwise (VEC = 1).
//   * All of a row's x, dy and gamma loads are issued before its first
//     reduction; raw x and the f32 dy * gamma stay in registers between
//     the two passes: no shared-memory staging, no second read.
//   * The two row sums reduce with warp shuffles; a group of several
//     warps adds one exchange through shared memory under a named
//     barrier of its own (double-buffered by row parity), so no
//     __syncthreads runs per row.
//   * Each thread accumulates dgamma and dbeta for its columns over all
//     of its rows in registers; at the end the CTA's groups add theirs
//     in a fixed order and the CTA writes one partial row: ~1-4 per SM
//     instead of one per 8 rows.
// ln_bwd_finalize_kernel then sums the partial rows in a fixed order
// and writes dgamma and dbeta in gamma's type.  No float atomics: a
// rerun is bit-equal.  The group layout takes C up to 8 * 32 * 32 =
// 8192.
// ln_bwd_wide_kernel takes any C past that (mxtpu's kernels go to
// 131072): a persistent grid of one CTA of 512 threads an SM, a row at
// a time.  Two passes over the row: x, dy and gamma for the two row
// sums (block reductions), then again (from L2 where it holds them) for
// dx; each thread owns the same columns in every row and adds dy * xhat
// and dy into the CTA's own partial row in device memory (written at
// its first row, added to after), so the same finalize kernel sums the
// partial rows.  Right first; its speed is open.
#include "common.cuh"

constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_WIDE_THREADS = 512;

// (E, WPR) by the widest C each takes, as kernels/layer_norm.py's
// LN_BWD_SHAPES: the fewest elements a thread that keep 2 CTAs an SM
#define LN_SHAPES(X) \
  X(256, 8, 1) X(512, 16, 1) X(1024, 16, 2) X(2048, 16, 4) X(4096, 16, 8) \
  X(8192, 32, 8)

// Registers a thread needs for E elements of T a row, VEC to an access:
// its two accumulators (2 * E), the row's raw x, dy and gamma as they
// arrive (3 * E * sizeof(T) / 4, a register an element on the scalar
// path), the scalar path's per-element offsets (E) and a base of 24.
// From it, the CTAs an SM is meant to hold (the launch bounds: 2, or 1
// where they would spill); kernels/layer_norm.py:_ln_min_blocks sizes
// the grid by the same rule.
template <typename T, int VEC, int E>
constexpr int ln_min_blocks() {
  constexpr int eb = VEC > 1 ? (int)sizeof(T) : 4;
  constexpr int regs = 2 * E + 3 * E * eb / 4 + (VEC > 1 ? 0 : E) + 24;
  return regs <= 112 ? 2 : 1;
}

// part: [2][gridDim.x][C] f32, this CTA's dgamma then dbeta row
template <typename T, int VEC, int E, int WPR>
__global__ void __launch_bounds__(LN_THREADS, (ln_min_blocks<T, VEC, E>()))
    ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part, long long R, int C) {
  constexpr int NV = E / VEC;
  constexpr int groups = LN_WARPS / WPR;
  constexpr int G = WPR * 32;                        // threads a row
  using P = Pack<T, VEC>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / WPR;
  const int gt = (warp - group * WPR) * 32 + lane;   // thread in group
  __shared__ float red[2][LN_WARPS][2];
  extern __shared__ float stage[];                   // [2][C], groups > 1

  float accg[E], accb[E], dyg[E];
#pragma unroll
  for (int i = 0; i < E; ++i) accg[i] = accb[i] = dyg[i] = 0.f;

  int parity = 0;
  const long long stride = (long long)gridDim.x * groups;
  for (long long row = (long long)blockIdx.x * groups + group; row < R;
       row += stride) {
    const size_t base = (size_t)row * C;
    P xr[NV], dr[NV], gr[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) {
        xr[k] = ld_pack<T, VEC>(x + base + c);
        dr[k] = ld_pack<T, VEC>(dy + base + c);
        gr[k] = ld_pack<T, VEC>(gamma + c);
      }
    }
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((k * G + gt) * VEC < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = to_f<T>(dr[k].v[j]);
          const float h = (to_f<T>(xr[k].v[j]) - mu) * rs;
          const float g = d * to_f<T>(gr[k].v[j]);
          dyg[k * VEC + j] = g;
          s1 += g;
          s2 += g * h;
          accg[k * VEC + j] += d * h;
          accb[k * VEC + j] += d;
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (WPR > 1) {
      // one partial per warp, summed in warp order by every thread of
      // the group; the buffer alternates with the row, so a warp that
      // runs ahead into the next row never overwrites one still read
      if (lane == 0) {
        red[parity][warp][0] = s1;
        red[parity][warp][1] = s2;
      }
      bar_sync(1 + group, G);
      s1 = s2 = 0.f;
#pragma unroll
      for (int w = group * WPR; w < (group + 1) * WPR; ++w) {
        s1 += red[parity][w][0];
        s2 += red[parity][w][1];
      }
      parity ^= 1;
    }
    const float c1 = s1 / (float)C, c2 = s2 / (float)C;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float h = (to_f<T>(xr[k].v[j]) - mu) * rs;
          o.v[j] = from_f<T>(rs * (dyg[k * VEC + j] - c1 - h * c2));
        }
        st_pack<T, VEC>(dx + base + c, o);
      }
    }
  }

  // this CTA's partial row: its groups own the same columns and add
  // theirs into shared memory one group after another
  float* pg = part + (size_t)blockIdx.x * C;
  float* pb = part + ((size_t)gridDim.x + blockIdx.x) * C;
  if constexpr (groups == 1) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          pg[c + j] = accg[k * VEC + j];
          pb[c + j] = accb[k * VEC + j];
        }
      }
    }
  } else {
    for (int q = 0; q < groups; ++q) {
      if (group == q) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c = (k * G + gt) * VEC;
          if (c < C) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float a = accg[k * VEC + j], b = accb[k * VEC + j];
              stage[c + j] = q ? stage[c + j] + a : a;
              stage[C + c + j] = q ? stage[C + c + j] + b : b;
            }
          }
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < C; c += LN_THREADS) {
      pg[c] = stage[c];
      pb[c] = stage[C + c];
    }
  }
}

// part as for ln_bwd_rows_kernel; the grid is at most R CTAs, so every
// CTA has a row and writes its partial row
template <typename T, int VEC>
__global__ void __launch_bounds__(LN_WIDE_THREADS)
    ln_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part, long long R, int C) {
  using P = Pack<T, VEC>;
  __shared__ float red[LN_WIDE_THREADS / 32];
  const int step = LN_WIDE_THREADS * VEC;
  float* pg = part + (size_t)blockIdx.x * C;
  float* pb = part + ((size_t)gridDim.x + blockIdx.x) * C;
  bool first = true;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const size_t base = (size_t)row * C;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x * VEC; c < C; c += step) {
      const P xp = ld_pack<T, VEC>(x + base + c);
      const P dp = ld_pack<T, VEC>(dy + base + c);
      const P gp = ld_pack<T, VEC>(gamma + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float h = (to_f<T>(xp.v[j]) - mu) * rs;
        const float g = to_f<T>(dp.v[j]) * to_f<T>(gp.v[j]);
        s1 += g;
        s2 += g * h;
      }
    }
    const float c1 = block_sum(s1, red) / (float)C;
    const float c2 = block_sum(s2, red) / (float)C;
    for (int c = threadIdx.x * VEC; c < C; c += step) {
      const P xp = ld_pack<T, VEC>(x + base + c);
      const P dp = ld_pack<T, VEC>(dy + base + c);
      const P gp = ld_pack<T, VEC>(gamma + c);
      P o;
      float dh[VEC], dd[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = to_f<T>(dp.v[j]);
        const float h = (to_f<T>(xp.v[j]) - mu) * rs;
        o.v[j] = from_f<T>(rs * (d * to_f<T>(gp.v[j]) - c1 - h * c2));
        dh[j] = d * h;
        dd[j] = d;
      }
      st_pack<T, VEC>(dx + base + c, o);
      add_row<VEC>(pg + c, dh, first);
      add_row<VEC>(pb + c, dd, first);
    }
    first = false;
  }
}

// blockDim (32, FIN_LANES): column blockIdx.x * 32 + x; row lane y sums
// the partial rows y, y + FIN_LANES, ... in order, then lane 0 of each
// column adds the lanes in order and writes gamma's type
constexpr int FIN_LANES = 32;

template <typename T>
__global__ void ln_bwd_finalize_kernel(const float* __restrict__ part,
                                       int P, int C, T* __restrict__ dgamma,
                                       T* __restrict__ dbeta) {
  __shared__ float sh[2][FIN_LANES][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int p = ty; p < P; p += FIN_LANES) {
      a += part[(size_t)p * C + c];
      b += part[(size_t)(P + p) * C + c];
    }
  }
  sh[0][ty][tx] = a;
  sh[1][ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < C) {
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < FIN_LANES; ++k) {
      sa += sh[0][k][tx];
      sb += sh[1][k][tx];
    }
    dgamma[c] = from_f<T>(sa);
    dbeta[c] = from_f<T>(sb);
  }
}

struct LnBwdArgs {
  const void *x, *g, *mean, *rstd, *dy;
  void *dx, *dgamma, *dbeta, *part;
  long long rows;
  int C, ctas;
};

template <typename T, int VEC, int E, int WPR>
static int launch(const LnBwdArgs& a, cudaStream_t st) {
  constexpr int groups = LN_WARPS / WPR;
  const size_t smem = groups > 1 ? (size_t)2 * a.C * sizeof(float) : 0;
  if (smem > 48 * 1024 || a.C > 32 * WPR * E)
    return (int)cudaErrorInvalidValue;
  ln_bwd_rows_kernel<T, VEC, E, WPR><<<a.ctas, LN_THREADS, smem, st>>>(
      (const T*)a.x, (const T*)a.g, (const float*)a.mean,
      (const float*)a.rstd, (const T*)a.dy, (T*)a.dx, (float*)a.part,
      a.rows, a.C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_bwd_finalize_kernel<T><<<(a.C + 31) / 32, dim3(32, FIN_LANES), 0, st>>>(
      (const float*)a.part, a.ctas, a.C, (T*)a.dgamma, (T*)a.dbeta);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_wide(const LnBwdArgs& a, cudaStream_t st) {
  if (a.ctas > a.rows) return (int)cudaErrorInvalidValue;
  ln_bwd_wide_kernel<T, VEC><<<a.ctas, LN_WIDE_THREADS, 0, st>>>(
      (const T*)a.x, (const T*)a.g, (const float*)a.mean,
      (const float*)a.rstd, (const T*)a.dy, (T*)a.dx, (float*)a.part,
      a.rows, a.C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_bwd_finalize_kernel<T><<<(a.C + 31) / 32, dim3(32, FIN_LANES), 0, st>>>(
      (const float*)a.part, a.ctas, a.C, (T*)a.dgamma, (T*)a.dbeta);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_e(int ept, int wpr, const LnBwdArgs& a, cudaStream_t st) {
  if (ept == 0 && wpr == 0) return launch_wide<T, VEC>(a, st);
#define LN_CASE(MAXC, E, WPR) \
  if (ept == E && wpr == WPR) return launch<T, VEC, E, WPR>(a, st);
  LN_SHAPES(LN_CASE)
#undef LN_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_t(int vec, int ept, int wpr, const LnBwdArgs& a,
                    cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.g |
                           (uintptr_t)a.dy | (uintptr_t)a.dx;
    if (a.C % V != 0 || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
    return launch_e<T, V>(ept, wpr, a, st);
  }
  if (vec == 1) return launch_e<T, 1>(ept, wpr, a, st);
  return (int)cudaErrorInvalidValue;
}

// vec: elements per access (16 bytes' worth, or 1); ept, wpr: elements a
// thread holds of a row and warps per row, a pair of LN_SHAPES with
// 32 * wpr * ept >= C, or (0, 0) for the wide kernel; ctas: the
// persistent grid, and the rows of part ([2][ctas][C] f32)
extern "C" int mxt_layer_norm_bwd(const void* x, const void* g,
                                  const void* mean, const void* rstd,
                                  const void* dy, void* dx, void* dgamma,
                                  void* dbeta, void* part, long long rows,
                                  int C, int vec, int ept, int wpr, int ctas,
                                  int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || C < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  const LnBwdArgs a{x, g, mean, rstd, dy, dx, dgamma, dbeta, part,
                    rows, C, ctas};
  if (dtype == MXT_F32) return launch_t<float>(vec, ept, wpr, a, s);
  if (dtype == MXT_BF16)
    return launch_t<__nv_bfloat16>(vec, ept, wpr, a, s);
  return (int)cudaErrorInvalidValue;
}
