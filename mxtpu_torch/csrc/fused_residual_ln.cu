// Fused residual LayerNorm forward: y = LN(res + dropout(h + bias)) over
// the last axis of (R, C) row-major tensors.
//
// Replaces mxtpu/kernels/layer_norm.py:_frln_fwd_kernel (launched by
// _pallas_frln_fwd).  frln_fwd_kernel, C <= 12256: one CTA per row: h,
// bias and res are read once, u = res + dropout(h + bias) is formed in
// shared memory (u never goes to device memory), LayerNorm runs over it
// with f32 statistics, and y plus f32 mean/rstd are written.
// frln_fwd_wide_kernel, any C past that (mxtpu's kernels take 32768, its
// lax reference any C): one CTA of 512 threads a row, three passes over
// the row (the sum, the sum of squares about the mean, the write), each
// reading h, bias and res again, from L2 where the row's neighbours
// leave room, 16-byte vector accesses where C and every pointer allow.
// A persistent grid of up to 4 CTAs an SM strides over the rows.  The
// first pass draws the mask once and stores it as one bit an element
// (C / 8 bytes) in a row of device memory the wrapper gives each CTA,
// which the later passes read back from L1 or L2.
//
// The dropout mask is the reference's: 20-round threefry2x32 keyed by
// two uint32 words from the wrapper, counter = the global linear element
// index row*C + c (uint32 arithmetic), an element kept iff its bits are
// below round(keep * 2^32).  keep == 1 (serving) skips it entirely.
//
// Bound on the H100: bytes, and with dropout the integer pipes.  At the
// serving shape (R = b*T, C = 1024) it moves 3 tensors of R*C elements
// (h, res in; y out) for ~10 flops per element, so the floor is those
// bytes at 3.35 TB/s.  The unfused sequence would also write and
// re-read u; this kernel does not.  With dropout on, threefry adds ~64
// 32-bit integer instructions an element, ~43 of them on the ALU pipe
// (chip_smoke.py reads the mix from the SASS), which outlast the bf16
// bytes.
#include "common.cuh"

template <typename T>
__global__ void frln_fwd_kernel(const T* __restrict__ h,
                                const T* __restrict__ bias,
                                const T* __restrict__ res,
                                const T* __restrict__ gamma,
                                const T* __restrict__ beta,
                                T* __restrict__ y, float* __restrict__ mean,
                                float* __restrict__ rstd, int C, float eps,
                                int use_mask, uint32_t k0, uint32_t k1,
                                uint32_t thresh, float inv_keep) {
  extern __shared__ float sm[];
  float* us = sm;       // C floats: u for this row
  float* red = sm + C;  // one float per warp
  const size_t row = blockIdx.x;
  const size_t base = row * (size_t)C;

  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float hb = to_f<T>(h[base + c]) + to_f<T>(bias[c]);
    if (use_mask) {
      const uint32_t ctr = (uint32_t)row * (uint32_t)C + (uint32_t)c;
      hb = threefry_bits(k0, k1, ctr) < thresh ? hb * inv_keep : 0.f;
    }
    const float u = to_f<T>(res[base + c]) + hb;
    us[c] = u;
    s += u;
  }
  const float mu = block_sum(s, red) / (float)C;
  float q = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = us[c] - mu;
    q += d * d;
  }
  const float var = block_sum(q, red) / (float)C;
  const float rs = 1.0f / sqrtf(var + eps);
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    y[base + c] = from_f<T>((us[c] - mu) * rs * to_f<T>(gamma[c]) +
                            to_f<T>(beta[c]));
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
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

// the widest C of frln_fwd_kernel: a row of f32 plus the per-warp
// scratch in the default 48 KB of dynamic shared memory
constexpr int FRLN_ROW_MAX_C = 48 * 1024 / 4 - 32;

struct FrlnFwdArgs {
  const void *h, *bias, *res, *g, *b;
  void *y, *mean, *rstd, *bits;
  long long rows;
  int C, ctas, use_mask;
  float eps, inv_keep;
  uint32_t k0, k1, thresh;
};

template <typename T>
static int launch_row(const FrlnFwdArgs& a, cudaStream_t st) {
  const int threads = a.C >= 1024 ? 256 : 128;
  if (a.C > FRLN_ROW_MAX_C || a.ctas != a.rows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(a.C + 32) * sizeof(float);
  frln_fwd_kernel<T><<<(unsigned)a.rows, threads, smem, st>>>(
      (const T*)a.h, (const T*)a.bias, (const T*)a.res, (const T*)a.g,
      (const T*)a.b, (T*)a.y, (float*)a.mean, (float*)a.rstd, a.C, a.eps,
      a.use_mask, a.k0, a.k1, a.thresh, a.inv_keep);
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

template <typename T>
static int launch_t(int wide, int vec, const FrlnFwdArgs& a,
                    cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (!wide)
    return vec == 1 && a.bits == nullptr ? launch_row<T>(a, st)
                                         : (int)cudaErrorInvalidValue;
  if (vec == V) {
    const uintptr_t ptrs = (uintptr_t)a.h | (uintptr_t)a.bias |
                           (uintptr_t)a.res | (uintptr_t)a.g |
                           (uintptr_t)a.b | (uintptr_t)a.y;
    if (a.C % V != 0 || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
    return launch_wide<T, V>(a, st);
  }
  if (vec == 1) return launch_wide<T, 1>(a, st);
  return (int)cudaErrorInvalidValue;
}

// wide, vec, ctas: kernels/layer_norm.py:_frln_fwd_plan; wide 0 is
// frln_fwd_kernel (vec 1, a CTA a row: ctas == rows), 1 the wide kernel
// (vec elements an access, a grid of ctas).  bits: with the mask, the
// wide kernel's keep bits ([ctas][words] uint32), else null.
extern "C" int mxt_fused_residual_ln_fwd(
    const void* h, const void* bias, const void* res, const void* g,
    const void* b, void* y, void* mean, void* rstd, void* bits,
    long long rows, int C, float eps, int wide, int vec, int ctas,
    int use_mask, uint32_t k0, uint32_t k1, uint32_t thresh, float inv_keep,
    int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || C < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  const FrlnFwdArgs a{h,    bias, res,  g,        b,        y,
                      mean, rstd, bits, rows,     C,        ctas,
                      use_mask, eps, inv_keep, k0, k1, thresh};
  if (dtype == MXT_F32) return launch_t<float>(wide, vec, a, s);
  if (dtype == MXT_BF16) return launch_t<__nv_bfloat16>(wide, vec, a, s);
  return (int)cudaErrorInvalidValue;
}
