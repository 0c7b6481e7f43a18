// Fused residual LayerNorm forward: y = LN(res + dropout(h + bias)) over
// the last axis of (R, C) row-major tensors.
//
// Replaces mxtpu/kernels/layer_norm.py:_frln_fwd_kernel (launched by
// _pallas_frln_fwd).  Per row, in f32, as the TPU kernel does: u = res +
// dropout(h + bias), mean = sum(u) / C, then var = sum((u - mean)^2) / C
// over the centred values (not E[u^2] - E[u]^2), rstd = 1 / sqrt(var +
// eps), y = (u - mean) * rstd * gamma + beta in h's type, and the f32
// mean and rstd per row.  u never goes to device memory.
//
// The dropout mask is the reference's: 20-round threefry2x32 keyed by
// two uint32 words from the wrapper, counter = the global linear element
// index row*C + c (uint32 arithmetic), an element kept iff its bits are
// below round(keep * 2^32), a kept value (h + bias) * (1/keep) with 1/keep
// the f32 constant the wrapper passes.  keep == 1 (serving) draws no mask.
//
// Bound on the H100: bytes, and with dropout the integer pipes.  At
// BERT's shape (R = 4096, C = 1024) it moves 3 tensors of R*C elements
// (h, res in; y out) for ~10 flops an element, so the floor is those
// bytes at 3.35 TB/s (7.5 us in bf16).  With dropout on, threefry adds
// ~64 32-bit integer instructions an element, ~43 of them on the ALU
// pipe (chip_smoke.py reads the mix from the SASS): 10.8 us at that
// shape, which outlasts the bf16 bytes.
//
// Design (the LayerNorm forward's, csrc/layer_norm.cu, with the fused
// backward's mask, csrc/fused_residual_ln_bwd.cu).
// frln_fwd_rows_kernel, C <= 12288 on the 16-byte path (every C the
// one-CTA-a-row kernel it replaces took), C <= 4096 on the scalar one: a
// CTA of 8 warps holds 8 / WPR rows at a time; a row group of WPR warps
// takes one row, each thread holding E elements of it (FRLN_FWD_SHAPES:
// E 8 and WPR 4 at C = 1024, the backward's; on the H100 no slower than
// LayerNorm's E 16 and WPR 2 at BERT's shape, and faster at a served
// request's 128 rows).
//   * Thread t of a group owns the columns (k * 32 * WPR + t) * VEC + j
//     (k < E / VEC, j < VEC): 16-byte vector loads and stores (8 bf16
//     or 4 f32) where C and every pointer allow, scalar ones otherwise
//     (VEC = 1).  A row's h, res and bias loads are all issued first;
//     under them the thread draws the keep bits of its E columns as E
//     independent threefry chains into one 64-bit word, so the integer
//     pipes work while the loads are in flight.
//   * u = res + dropout(h + bias) is formed in f32 registers and stays
//     there for both sums and the write: h and res are read once, with
//     no shared-memory staging.
//   * Each row sum reduces with warp shuffles (group_sum, common.cuh);
//     a group of several warps adds one exchange through shared memory
//     under a named barrier of its own, so no __syncthreads runs per
//     row.  Sums keep a fixed order: a rerun is bit-equal.
//   * Several rows are in flight per SM: 8 / WPR a CTA, and as many CTAs
//     as the registers allow (frln_fwd_min_blocks); the grid gives every
//     row group one row, capped at 2^31 - 1 CTAs with a grid-stride loop
//     past it, so any R launches.
// frln_fwd_wide_kernel, any C past that (mxtpu's kernels take 32768, its
// lax reference any C): one CTA of 512 threads a row, three passes over
// the row (the sum, the sum of squares about the mean, the write), each
// reading h, bias and res again, from L2 where the row's neighbours
// leave room, 16-byte vector accesses where C and every pointer allow.
// A persistent grid of up to 4 CTAs an SM strides over the rows.  The
// first pass draws the mask once and stores it as one bit an element
// (C / 8 bytes) in a row of device memory the wrapper gives each CTA,
// which the later passes read back from L1 or L2.
#include "common.cuh"

constexpr int FRLN_FWD_THREADS = 256;
constexpr int FRLN_FWD_WARPS = FRLN_FWD_THREADS / 32;

// (widest C, E, WPR) of the row kernel's instances, as
// kernels/layer_norm.py's FRLN_FWD_SHAPES.  The scalar path takes those
// up to FRLN_FWD_SCALAR_MAX_C, the wide kernel past it: a scalar element
// holds a register of its own, so E 32 and 48 fit one CTA an SM, and on
// the H100 took longer than the wide kernel at every C they took
#define FRLN_FWD_SHAPES(X) \
  X(256, 8, 1) X(512, 8, 2) X(1024, 8, 4) X(2048, 8, 8) X(4096, 16, 8) \
  X(8192, 32, 8) X(12288, 48, 8)
constexpr int FRLN_FWD_SCALAR_MAX_C = 4096;

// Registers a thread needs for E elements of T a row, VEC to an access:
// u (E), the raw h, res and bias as they arrive (3 * E * sizeof(T) / 4,
// a register an element on the scalar path), the E threefry chains'
// two words each (2 * E), the scalar path's per-element offsets (E) and
// a base of 32.  From it, the CTAs an SM is meant to hold: the launch
// bounds, 2, or 1 where they would spill.
template <typename T, int VEC, int E>
constexpr int frln_fwd_min_blocks() {
  constexpr int eb = VEC > 1 ? (int)sizeof(T) : 4;
  constexpr int regs = E + 3 * E * eb / 4 + 2 * E + (VEC > 1 ? 0 : E) + 32;
  return regs <= 128 ? 2 : 1;
}

template <typename T, int VEC, int E, int WPR>
__global__ void __launch_bounds__(FRLN_FWD_THREADS,
                                  (frln_fwd_min_blocks<T, VEC, E>()))
    frln_fwd_rows_kernel(const T* __restrict__ h, const T* __restrict__ bias,
                         const T* __restrict__ res,
                         const T* __restrict__ gamma,
                         const T* __restrict__ beta, T* __restrict__ y,
                         float* __restrict__ mean, float* __restrict__ rstd,
                         long long R, int C, float eps, int use_mask,
                         uint32_t k0, uint32_t k1, uint32_t thresh,
                         float inv_keep) {
  constexpr int NV = E / VEC;
  constexpr int groups = FRLN_FWD_WARPS / WPR;
  constexpr int G = WPR * 32;                        // threads a row
  static_assert(E % VEC == 0 && E <= 64, "E keep bits in one word");
  using P = Pack<T, VEC>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / WPR;
  const int gt = (warp - group * WPR) * 32 + lane;   // thread in group
  __shared__ float red[2][FRLN_FWD_WARPS];
  int parity = 0;
  const long long stride = (long long)gridDim.x * groups;
  for (long long row = (long long)blockIdx.x * groups + group; row < R;
       row += stride) {
    const size_t base = (size_t)row * C;
    P hr[NV], rr[NV], br[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * G + gt) * VEC;
      if (c < C) {
        hr[k] = ld_pack<T, VEC>(h + base + c);
        rr[k] = ld_pack<T, VEC>(res + base + c);
        br[k] = ld_pack<T, VEC>(bias + c);
      }
    }
    // the keep bits of the thread's columns, bit k * VEC + j
    uint64_t kept = 0;
    if (use_mask) {
      const uint32_t rc = (uint32_t)row * (uint32_t)C;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = (k * G + gt) * VEC;
        if (c < C) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            kept |= (uint64_t)(threefry_bits(k0, k1,
                                             rc + (uint32_t)(c + j)) <
                               thresh)
                    << (k * VEC + j);
        }
      }
    }
    float u[E];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if ((k * G + gt) * VEC < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = k * VEC + j;
          float hb = to_f<T>(hr[k].v[j]) + to_f<T>(br[k].v[j]);
          if (use_mask) hb = (kept >> i) & 1u ? hb * inv_keep : 0.f;
          u[i] = to_f<T>(rr[k].v[j]) + hb;
          s += u[i];
        }
      }
    const float mu =
        group_sum<WPR>(s, red, parity, warp, lane, group) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if ((k * G + gt) * VEC < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = u[k * VEC + j] - mu;
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
        const P gp = ld_pack<T, VEC>(gamma + c);
        const P bp = ld_pack<T, VEC>(beta + c);
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = from_f<T>((u[k * VEC + j] - mu) * rs * to_f<T>(gp.v[j]) +
                             to_f<T>(bp.v[j]));
        st_pack<T, VEC>(y + base + c, o);
      }
    }
    if (gt == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

// u of the VEC elements from column c: res + dropout(h + bias), the keep
// bit of element j being bit `lane` of kw[j]
template <typename T, int VEC>
__device__ __forceinline__ void frln_u(const Pack<T, VEC>& hp,
                                       const Pack<T, VEC>& bp,
                                       const Pack<T, VEC>& rp,
                                       const uint32_t* kw, int lane,
                                       int use_mask, float inv_keep,
                                       float* u) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float hb = to_f<T>(hp.v[j]) + to_f<T>(bp.v[j]);
    if (use_mask) hb = (kw[j] >> lane) & 1u ? hb * inv_keep : 0.f;
    u[j] = to_f<T>(rp.v[j]) + hb;
  }
}

// The keep bits' layout: common.cuh ("The keep bits of the wide fused
// residual LayerNorm kernels").  bits: a row of `words` of them a CTA
// (null without the mask).
template <typename T, int VEC>
__global__ void __launch_bounds__(FRLN_WIDE_THREADS)
    frln_fwd_wide_kernel(const T* __restrict__ h, const T* __restrict__ bias,
                         const T* __restrict__ res,
                         const T* __restrict__ gamma,
                         const T* __restrict__ beta, T* __restrict__ y,
                         float* __restrict__ mean, float* __restrict__ rstd,
                         uint32_t* __restrict__ bits, int words, long long R,
                         int C, float eps, int use_mask, uint32_t k0,
                         uint32_t k1, uint32_t thresh, float inv_keep) {
  using P = Pack<T, VEC>;
  __shared__ float red[FRLN_WIDE_WARPS];
  bits += (size_t)blockIdx.x * words;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step = FRLN_WIDE_THREADS * VEC;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const size_t base = (size_t)row * C;
    const uint32_t rc = (uint32_t)row * (uint32_t)C;
    // pass 1: the mask, drawn once; the row sum.  The loop runs while
    // any lane of the warp has columns, so that every lane ballots.
    float s = 0.f;
    for (int k = 0; (k * FRLN_WIDE_THREADS + warp * 32) * VEC < C; ++k) {
      const int c = (k * FRLN_WIDE_THREADS + threadIdx.x) * VEC;
      const bool in = c < C;
      uint32_t w[VEC] = {};
      if (use_mask)
        frln_draw_bits<VEC>(bits + (k * FRLN_WIDE_WARPS + warp) * VEC, w, in,
                            rc + (uint32_t)c, lane, k0, k1, thresh);
      if (in) {
        float u[VEC];
        frln_u<T, VEC>(ld_pack<T, VEC>(h + base + c),
                       ld_pack<T, VEC>(bias + c),
                       ld_pack<T, VEC>(res + base + c), w, lane, use_mask,
                       inv_keep, u);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += u[j];
      }
    }
    const float mu = block_sum(s, red) / (float)C;
    // pass 2: the sum of squares about the mean
    float q = 0.f;
    for (int k = 0, c = threadIdx.x * VEC; c < C; ++k, c += step) {
      const uint32_t* kw = bits + (k * FRLN_WIDE_WARPS + warp) * VEC;
      float u[VEC];
      frln_u<T, VEC>(ld_pack<T, VEC>(h + base + c), ld_pack<T, VEC>(bias + c),
                     ld_pack<T, VEC>(res + base + c), kw, lane, use_mask,
                     inv_keep, u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = u[j] - mu;
        q += d * d;
      }
    }
    const float var = block_sum(q, red) / (float)C;
    const float rs = 1.0f / sqrtf(var + eps);
    // pass 3: y
    for (int k = 0, c = threadIdx.x * VEC; c < C; ++k, c += step) {
      const uint32_t* kw = bits + (k * FRLN_WIDE_WARPS + warp) * VEC;
      float u[VEC];
      frln_u<T, VEC>(ld_pack<T, VEC>(h + base + c), ld_pack<T, VEC>(bias + c),
                     ld_pack<T, VEC>(res + base + c), kw, lane, use_mask,
                     inv_keep, u);
      const P gp = ld_pack<T, VEC>(gamma + c);
      const P bp = ld_pack<T, VEC>(beta + c);
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_f<T>((u[j] - mu) * rs * to_f<T>(gp.v[j]) +
                           to_f<T>(bp.v[j]));
      st_pack<T, VEC>(y + base + c, o);
    }
    if (threadIdx.x == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

struct FrlnFwdArgs {
  const void *h, *bias, *res, *g, *b;
  void *y, *mean, *rstd, *bits;
  long long rows;
  int C, ctas, use_mask;
  float eps, inv_keep;
  uint32_t k0, k1, thresh;
};

template <typename T, int VEC, int E, int WPR>
static int launch_rows(const FrlnFwdArgs& a, cudaStream_t st) {
  if (a.C > 32 * WPR * E || a.bits != nullptr)
    return (int)cudaErrorInvalidValue;
  frln_fwd_rows_kernel<T, VEC, E, WPR><<<a.ctas, FRLN_FWD_THREADS, 0, st>>>(
      (const T*)a.h, (const T*)a.bias, (const T*)a.res, (const T*)a.g,
      (const T*)a.b, (T*)a.y, (float*)a.mean, (float*)a.rstd, a.rows, a.C,
      a.eps, a.use_mask, a.k0, a.k1, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_wide(const FrlnFwdArgs& a, cudaStream_t st) {
  const int words = a.use_mask ? frln_words<VEC>(a.C) : 0;
  if ((a.bits != nullptr) != (a.use_mask != 0) || a.ctas > a.rows)
    return (int)cudaErrorInvalidValue;
  frln_fwd_wide_kernel<T, VEC><<<a.ctas, FRLN_WIDE_THREADS, 0, st>>>(
      (const T*)a.h, (const T*)a.bias, (const T*)a.res, (const T*)a.g,
      (const T*)a.b, (T*)a.y, (float*)a.mean, (float*)a.rstd,
      (uint32_t*)a.bits, words, a.rows, a.C, a.eps, a.use_mask, a.k0, a.k1,
      a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_e(int ept, int wpr, const FrlnFwdArgs& a,
                    cudaStream_t st) {
  if (ept == 0 && wpr == 0) return launch_wide<T, VEC>(a, st);
#define FRLN_FWD_CASE(MAXC, E, WPR)                                      \
  if constexpr (VEC > 1 || MAXC <= FRLN_FWD_SCALAR_MAX_C)                \
    if (ept == E && wpr == WPR) return launch_rows<T, VEC, E, WPR>(a, st);
  FRLN_FWD_SHAPES(FRLN_FWD_CASE)
#undef FRLN_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_t(int vec, int ept, int wpr, const FrlnFwdArgs& a,
                    cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    const uintptr_t ptrs = (uintptr_t)a.h | (uintptr_t)a.bias |
                           (uintptr_t)a.res | (uintptr_t)a.g |
                           (uintptr_t)a.b | (uintptr_t)a.y;
    if (a.C % V != 0 || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
    return launch_e<T, V>(ept, wpr, a, st);
  }
  if (vec == 1) return launch_e<T, 1>(ept, wpr, a, st);
  return (int)cudaErrorInvalidValue;
}

// vec: elements per access (16 bytes' worth, or 1); ept, wpr: elements
// a thread holds of a row and warps per row, a pair of FRLN_FWD_SHAPES
// with 32 * wpr * ept >= C (with vec 1, one to FRLN_FWD_SCALAR_MAX_C),
// or (0, 0) for the wide kernel; ctas: the
// grid (kernels/layer_norm.py:_frln_fwd_plan).  bits: with the mask, the
// wide kernel's keep bits ([ctas][words] uint32), else null.
extern "C" int mxt_fused_residual_ln_fwd(
    const void* h, const void* bias, const void* res, const void* g,
    const void* b, void* y, void* mean, void* rstd, void* bits,
    long long rows, int C, float eps, int vec, int ept, int wpr, int ctas,
    int use_mask, uint32_t k0, uint32_t k1, uint32_t thresh, float inv_keep,
    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || C < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  const FrlnFwdArgs a{h,    bias, res,  g,        b,        y,
                      mean, rstd, bits, rows,     C,        ctas,
                      use_mask, eps, inv_keep, k0, k1, thresh};
  if (dtype == MXT_F32) return launch_t<float>(vec, ept, wpr, a, s);
  if (dtype == MXT_BF16)
    return launch_t<__nv_bfloat16>(vec, ept, wpr, a, s);
  return (int)cudaErrorInvalidValue;
}
