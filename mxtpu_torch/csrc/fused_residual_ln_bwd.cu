// Fused residual LayerNorm backward: the gradients of
// y = LN(res + dropout(h + bias)) over the last axis of (R, C) row-major
// tensors, from the forward's f32 mean and rstd.
//
// Replaces mxtpu/kernels/layer_norm.py:_frln_bwd_kernel (launched by
// _pallas_frln_bwd).  As there, nothing between the GEMM and the norm
// was saved: each row recomputes the dropout mask from the same two
// threefry key words over the global linear element index row*C + c
// (threefry_bits in common.cuh, the forward's copy) and
// u = res + dropout(h + bias) on chip.  Then, in f32:
//   xhat = (u - mean) * rstd,  dyg = dy * gamma,
//   du = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)),
//   dh = kept ? du * (1/keep) : 0,  dres = du,
// and the parameter gradients dgamma = sum dy * xhat, dbeta = sum dy and
// dbias = sum dh (the gradient of h + bias, so of the dropped-out sum,
// not du).  keep == 1 skips the mask; 1/keep arrives as the f32 constant
// the forward multiplies by, and the keep test is bits <
// round(keep * 2^32) in uint32, as the forward's.
//
// Bound on the H100: bytes and, with dropout, the integer pipes.  At
// the training shape (R = 4096, C = 1024) it reads h, res and dy and
// writes dh and dres, five (R, C) tensors (12.5 us in bf16 at 3.35
// TB/s), for ~20 flops an element; the mask adds ~64 32-bit integer
// instructions an element (threefry2x32's 20 rounds), ~43 of them on
// the ALU pipe (chip_smoke.py reads the mix from the SASS): a little
// under the bf16 bytes' time.
//
// Design (the LayerNorm backward's, csrc/layer_norm_bwd.cu, plus the
// mask and a third parameter gradient).  frln_bwd_rows_kernel, C up to
// 4096: a persistent grid of 1-2 CTAs an SM (8 warps each) strides over
// the rows; a row group of WPR warps takes one row at a time, thread t
// of a group holding the E columns (k * 32 * WPR + t) * VEC + j of it
// (FRLN_SHAPES: E 8 and WPR 4 at C = 1024).
//   * A row's h, res and dy loads (16-byte vectors where C and every
//     pointer allow) are issued first; under them the thread draws the
//     keep bits of its E columns as E independent threefry chains, which
//     keeps the integer pipe fed, into one register.
//   * xhat and dy * gamma stay in registers between the two row sums
//     (warp shuffles; a group of several warps adds one exchange through
//     shared memory under a named barrier of its own, double-buffered by
//     row parity); dh and dres go out as 16-byte stores.
//   * Each thread accumulates dgamma, dbeta and dbias for its columns
//     over all of its rows in registers; at the end the CTA's groups add
//     theirs in group order and the CTA writes one partial row of each.
// frln_bwd_wide_kernel takes any C past 4096 (mxtpu's kernels go to
// 32768, its lax reference any C): a persistent grid of one CTA of 512
// threads an SM, a row at a time, two passes over the row (the sums,
// then dh and dres), the second reading h, res, dy and the vectors again
// from L2; the first pass draws the mask once and stores its keep bits
// (one bit an element, C / 8 bytes) in a row of device memory the
// wrapper gives each CTA; each thread adds into the CTA's partial rows
// in device memory.
// frln_bwd_finalize_kernel sums the partial rows in a fixed order and
// writes dgamma and dbeta in gamma's type and dbias in bias's.  No
// float atomics: a rerun is bit-equal.
#include "common.cuh"

constexpr int FRLN_THREADS = 256;
constexpr int FRLN_WARPS = FRLN_THREADS / 32;

// (widest C, E, WPR) of the row kernel's instances, as
// kernels/layer_norm.py's FRLN_BWD_SHAPES
#define FRLN_SHAPES(X) \
  X(256, 8, 1) X(512, 8, 2) X(1024, 8, 4) X(2048, 8, 8) X(4096, 16, 8)

// Registers a thread needs for E elements of T a row, VEC to an access:
// its three accumulators and the row's xhat and dy * gamma (5 * E), the
// raw h, res and dy as they arrive (3 * E * sizeof(T) / 4, a register an
// element on the scalar path), the scalar path's per-element offsets (E)
// and a base of 32 (the threefry chains' state among it).  From it, the
// CTAs an SM is meant to hold (the launch bounds: 2, or 1 where they
// would spill); kernels/layer_norm.py:_frln_min_blocks sizes the grid by
// the same rule.
template <typename T, int VEC, int E>
constexpr int frln_min_blocks() {
  constexpr int eb = VEC > 1 ? (int)sizeof(T) : 4;
  constexpr int regs = 5 * E + 3 * E * eb / 4 + (VEC > 1 ? 0 : E) + 32;
  return regs <= 128 ? 2 : 1;
}

struct FrlnMask {
  int use;
  uint32_t k0, k1, thresh;
  float inv_keep;
};

// part: [3][gridDim.x][C] f32, this CTA's dgamma, dbeta, dbias rows
template <typename T, int VEC, int E, int WPR>
__global__ void __launch_bounds__(FRLN_THREADS,
                                  (frln_min_blocks<T, VEC, E>()))
    frln_bwd_rows_kernel(const T* __restrict__ h, const T* __restrict__ bias,
                         const T* __restrict__ res,
                         const T* __restrict__ gamma,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const T* __restrict__ dy, T* __restrict__ dh,
                         T* __restrict__ dres, float* __restrict__ part,
                         long long R, int C, FrlnMask m) {
  constexpr int NV = E / VEC;
  constexpr int groups = FRLN_WARPS / WPR;
  constexpr int G = WPR * 32;                        // threads a row
  static_assert(E <= 32, "one register of keep bits");
  using P = Pack<T, VEC>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / WPR;
  const int gt = (warp - group * WPR) * 32 + lane;   // thread in group
  __shared__ float red[2][FRLN_WARPS][2];
  extern __shared__ float stage[];                   // [3][C], groups > 1

  float accg[E], accb[E], accd[E];
#pragma unroll
  for (int i = 0; i < E; ++i) accg[i] = accb[i] = accd[i] = 0.f;

  int parity = 0;
  const long long stride = (long long)gridDim.x * groups;
  for (long long row = (long long)blockIdx.x * groups + group; row < R;
       row += stride) {
    const size_t base = (size_t)row * C;
    P hr[NV], rr[NV], dr[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) {
        hr[k] = ld_pack<T, VEC>(h + base + c);
        rr[k] = ld_pack<T, VEC>(res + base + c);
        dr[k] = ld_pack<T, VEC>(dy + base + c);
      }
    }
    // the keep bits of the thread's columns, bit k * VEC + j
    uint32_t kept = 0;
    if (m.use) {
      const uint32_t rc = (uint32_t)row * (uint32_t)C;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = (k * G + gt) * VEC;
        if (c < C) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            kept |= (uint32_t)(threefry_bits(m.k0, m.k1,
                                             rc + (uint32_t)(c + j)) <
                               m.thresh)
                    << (k * VEC + j);
        }
      }
    }
    const float mu = mean[row], rs = rstd[row];
    float xh[E], dyg[E];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) {
        const P bp = ld_pack<T, VEC>(bias + c);
        const P gp = ld_pack<T, VEC>(gamma + c);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = k * VEC + j;
          float hb = to_f<T>(hr[k].v[j]) + to_f<T>(bp.v[j]);
          if (m.use) hb = (kept >> i) & 1u ? hb * m.inv_keep : 0.f;
          const float u = to_f<T>(rr[k].v[j]) + hb;
          const float d = to_f<T>(dr[k].v[j]);
          const float xv = (u - mu) * rs;
          const float g = d * to_f<T>(gp.v[j]);
          xh[i] = xv;
          dyg[i] = g;
          s1 += g;
          s2 += g * xv;
          accg[i] += d * xv;
          accb[i] += d;
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
        P oh, orr;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = k * VEC + j;
          const float du = rs * (dyg[i] - c1 - xh[i] * c2);
          const float dhv =
              m.use ? ((kept >> i) & 1u ? du * m.inv_keep : 0.f) : du;
          oh.v[j] = from_f<T>(dhv);
          orr.v[j] = from_f<T>(du);
          accd[i] += dhv;
        }
        st_pack<T, VEC>(dh + base + c, oh);
        st_pack<T, VEC>(dres + base + c, orr);
      }
    }
  }

  // this CTA's partial rows: its groups own the same columns and add
  // theirs into shared memory one group after another
  float* pg = part + (size_t)blockIdx.x * C;
  float* pb = part + ((size_t)gridDim.x + blockIdx.x) * C;
  float* pd = part + ((size_t)2 * gridDim.x + blockIdx.x) * C;
  if constexpr (groups == 1) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          pg[c + j] = accg[k * VEC + j];
          pb[c + j] = accb[k * VEC + j];
          pd[c + j] = accd[k * VEC + j];
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
              const int i = k * VEC + j;
              stage[c + j] = q ? stage[c + j] + accg[i] : accg[i];
              stage[C + c + j] = q ? stage[C + c + j] + accb[i] : accb[i];
              stage[2 * C + c + j] =
                  q ? stage[2 * C + c + j] + accd[i] : accd[i];
            }
          }
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < C; c += FRLN_THREADS) {
      pg[c] = stage[c];
      pb[c] = stage[C + c];
      pd[c] = stage[2 * C + c];
    }
  }
}

// u, xhat and dy * gamma of the VEC elements from column c; the keep bit
// of element j is bit `lane` of kw[j]
template <typename T, int VEC>
__device__ __forceinline__ void frln_row_vals(
    const T* __restrict__ h, const T* __restrict__ bias,
    const T* __restrict__ res, const T* __restrict__ gamma,
    const T* __restrict__ dy, size_t base, int c, const uint32_t* kw,
    int lane, const FrlnMask& m, float mu, float rs, float* xh, float* dyg,
    float* d, bool* keep) {
  const Pack<T, VEC> hp = ld_pack<T, VEC>(h + base + c);
  const Pack<T, VEC> bp = ld_pack<T, VEC>(bias + c);
  const Pack<T, VEC> rp = ld_pack<T, VEC>(res + base + c);
  const Pack<T, VEC> gp = ld_pack<T, VEC>(gamma + c);
  const Pack<T, VEC> dp = ld_pack<T, VEC>(dy + base + c);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float hb = to_f<T>(hp.v[j]) + to_f<T>(bp.v[j]);
    keep[j] = !m.use || ((kw[j] >> lane) & 1u);
    if (m.use) hb = keep[j] ? hb * m.inv_keep : 0.f;
    const float u = to_f<T>(rp.v[j]) + hb;
    d[j] = to_f<T>(dp.v[j]);
    xh[j] = (u - mu) * rs;
    dyg[j] = d[j] * to_f<T>(gp.v[j]);
  }
}

// The keep bits' layout: common.cuh ("The keep bits of the wide fused
// residual LayerNorm kernels"), a row of `words` of them a CTA in bits
// (null without the mask).  part as for frln_bwd_rows_kernel; the grid
// is at most R CTAs, so every CTA has a row and writes its partial rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(FRLN_WIDE_THREADS)
    frln_bwd_wide_kernel(const T* __restrict__ h, const T* __restrict__ bias,
                         const T* __restrict__ res,
                         const T* __restrict__ gamma,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const T* __restrict__ dy, T* __restrict__ dh,
                         T* __restrict__ dres, float* __restrict__ part,
                         uint32_t* __restrict__ bits, int words, long long R,
                         int C, FrlnMask m) {
  using P = Pack<T, VEC>;
  __shared__ float red[FRLN_WIDE_WARPS];
  bits += (size_t)blockIdx.x * words;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step = FRLN_WIDE_THREADS * VEC;
  float* pg = part + (size_t)blockIdx.x * C;
  float* pb = part + ((size_t)gridDim.x + blockIdx.x) * C;
  float* pd = part + ((size_t)2 * gridDim.x + blockIdx.x) * C;
  bool first = true;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const size_t base = (size_t)row * C;
    const uint32_t rc = (uint32_t)row * (uint32_t)C;
    const float mu = mean[row], rs = rstd[row];
    // pass 1: the mask, drawn once; the two row sums.  The loop runs
    // while any lane of the warp has columns, so that every lane ballots.
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; (k * FRLN_WIDE_THREADS + warp * 32) * VEC < C; ++k) {
      const int c = (k * FRLN_WIDE_THREADS + threadIdx.x) * VEC;
      const bool in = c < C;
      uint32_t w[VEC] = {};
      if (m.use)
        frln_draw_bits<VEC>(bits + (k * FRLN_WIDE_WARPS + warp) * VEC, w, in,
                            rc + (uint32_t)c, lane, m.k0, m.k1, m.thresh);
      if (in) {
        float xh[VEC], dyg[VEC], d[VEC];
        bool keep[VEC];
        frln_row_vals<T, VEC>(h, bias, res, gamma, dy, base, c, w, lane, m,
                              mu, rs, xh, dyg, d, keep);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1 += dyg[j];
          s2 += dyg[j] * xh[j];
        }
      }
    }
    const float c1 = block_sum(s1, red) / (float)C;
    const float c2 = block_sum(s2, red) / (float)C;
    // pass 2: dh, dres and the partial rows
    for (int k = 0, c = threadIdx.x * VEC; c < C; ++k, c += step) {
      const uint32_t* kw = bits + (k * FRLN_WIDE_WARPS + warp) * VEC;
      float xh[VEC], dyg[VEC], d[VEC], dgv[VEC], dhv[VEC];
      bool keep[VEC];
      frln_row_vals<T, VEC>(h, bias, res, gamma, dy, base, c, kw, lane, m,
                            mu, rs, xh, dyg, d, keep);
      P oh, orr;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float du = rs * (dyg[j] - c1 - xh[j] * c2);
        dhv[j] = m.use ? (keep[j] ? du * m.inv_keep : 0.f) : du;
        oh.v[j] = from_f<T>(dhv[j]);
        orr.v[j] = from_f<T>(du);
        dgv[j] = d[j] * xh[j];
      }
      st_pack<T, VEC>(dh + base + c, oh);
      st_pack<T, VEC>(dres + base + c, orr);
      add_row<VEC>(pg + c, dgv, first);
      add_row<VEC>(pb + c, d, first);
      add_row<VEC>(pd + c, dhv, first);
    }
    first = false;
  }
}

// blockDim (32, FIN_LANES): column blockIdx.x * 32 + x; row lane y sums
// the partial rows y, y + FIN_LANES, ... in order, then lane 0 of each
// column adds the lanes in order and writes dgamma and dbeta in gamma's
// type and dbias in bias's
constexpr int FIN_LANES = 32;

template <typename T>
__global__ void frln_bwd_finalize_kernel(const float* __restrict__ part,
                                         int P, int C, T* __restrict__ dgamma,
                                         T* __restrict__ dbeta,
                                         T* __restrict__ dbias) {
  __shared__ float sh[3][FIN_LANES][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f, d = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int p = ty; p < P; p += FIN_LANES) {
      a += part[(size_t)p * C + c];
      b += part[(size_t)(P + p) * C + c];
      d += part[(size_t)(2 * P + p) * C + c];
    }
  }
  sh[0][ty][tx] = a;
  sh[1][ty][tx] = b;
  sh[2][ty][tx] = d;
  __syncthreads();
  if (ty == 0 && c < C) {
    float sa = 0.f, sb = 0.f, sd = 0.f;
    for (int k = 0; k < FIN_LANES; ++k) {
      sa += sh[0][k][tx];
      sb += sh[1][k][tx];
      sd += sh[2][k][tx];
    }
    dgamma[c] = from_f<T>(sa);
    dbeta[c] = from_f<T>(sb);
    dbias[c] = from_f<T>(sd);
  }
}

struct FrlnBwdArgs {
  const void *h, *bias, *res, *g, *mean, *rstd, *dy;
  void *dh, *dres, *dgamma, *dbeta, *dbias, *part, *bits;
  long long rows;
  int C, ctas;
  FrlnMask m;
};

template <typename T>
static int finalize(const FrlnBwdArgs& a, cudaStream_t st) {
  frln_bwd_finalize_kernel<T><<<(a.C + 31) / 32, dim3(32, FIN_LANES), 0,
                                st>>>((const float*)a.part, a.ctas, a.C,
                                      (T*)a.dgamma, (T*)a.dbeta,
                                      (T*)a.dbias);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int E, int WPR>
static int launch(const FrlnBwdArgs& a, cudaStream_t st) {
  constexpr int groups = FRLN_WARPS / WPR;
  const size_t smem = groups > 1 ? (size_t)3 * a.C * sizeof(float) : 0;
  if (smem > 48 * 1024 || a.C > 32 * WPR * E || a.bits != nullptr)
    return (int)cudaErrorInvalidValue;
  frln_bwd_rows_kernel<T, VEC, E, WPR><<<a.ctas, FRLN_THREADS, smem, st>>>(
      (const T*)a.h, (const T*)a.bias, (const T*)a.res, (const T*)a.g,
      (const float*)a.mean, (const float*)a.rstd, (const T*)a.dy, (T*)a.dh,
      (T*)a.dres, (float*)a.part, a.rows, a.C, a.m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return finalize<T>(a, st);
}

template <typename T, int VEC>
static int launch_wide(const FrlnBwdArgs& a, cudaStream_t st) {
  const int words = a.m.use ? frln_words<VEC>(a.C) : 0;
  if ((a.bits != nullptr) != (a.m.use != 0) || a.ctas > a.rows)
    return (int)cudaErrorInvalidValue;
  frln_bwd_wide_kernel<T, VEC><<<a.ctas, FRLN_WIDE_THREADS, 0, st>>>(
      (const T*)a.h, (const T*)a.bias, (const T*)a.res, (const T*)a.g,
      (const float*)a.mean, (const float*)a.rstd, (const T*)a.dy, (T*)a.dh,
      (T*)a.dres, (float*)a.part, (uint32_t*)a.bits, words, a.rows, a.C,
      a.m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return finalize<T>(a, st);
}

template <typename T, int VEC>
static int launch_e(int ept, int wpr, const FrlnBwdArgs& a,
                    cudaStream_t st) {
  if (ept == 0 && wpr == 0) return launch_wide<T, VEC>(a, st);
#define FRLN_CASE(MAXC, E, WPR) \
  if (ept == E && wpr == WPR) return launch<T, VEC, E, WPR>(a, st);
  FRLN_SHAPES(FRLN_CASE)
#undef FRLN_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_t(int vec, int ept, int wpr, const FrlnBwdArgs& a,
                    cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    const uintptr_t ptrs = (uintptr_t)a.h | (uintptr_t)a.bias |
                           (uintptr_t)a.res | (uintptr_t)a.g |
                           (uintptr_t)a.dy | (uintptr_t)a.dh |
                           (uintptr_t)a.dres;
    if (a.C % V != 0 || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
    return launch_e<T, V>(ept, wpr, a, st);
  }
  if (vec == 1) return launch_e<T, 1>(ept, wpr, a, st);
  return (int)cudaErrorInvalidValue;
}

// vec: elements per access (16 bytes' worth, or 1); ept, wpr: elements a
// thread holds of a row and warps per row, a pair of FRLN_SHAPES with
// 32 * wpr * ept >= C, or (0, 0) for the wide kernel; ctas: the
// persistent grid, and the rows of part ([3][ctas][C] f32); bits: with
// the mask, the wide kernel's keep bits ([ctas][words] uint32), else
// null
// (kernels/layer_norm.py:_frln_bwd_plan)
extern "C" int mxt_fused_residual_ln_bwd(
    const void* h, const void* bias, const void* res, const void* g,
    const void* mean, const void* rstd, const void* dy, void* dh,
    void* dres, void* dgamma, void* dbeta, void* dbias, void* part,
    void* bits, long long rows, int C, int vec, int ept, int wpr, int ctas,
    int use_mask, uint32_t k0, uint32_t k1, uint32_t thresh, float inv_keep,
    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || C < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  const FrlnBwdArgs a{h,     bias,  res,    g,    mean, rstd, dy,
                      dh,    dres,  dgamma, dbeta, dbias, part, bits,
                      rows,  C,     ctas,
                      {use_mask, k0, k1, thresh, inv_keep}};
  if (dtype == MXT_F32) return launch_t<float>(vec, ept, wpr, a, s);
  if (dtype == MXT_BF16) return launch_t<__nv_bfloat16>(vec, ept, wpr, a, s);
  return (int)cudaErrorInvalidValue;
}
