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
// and per-CTA partial rows of dgamma = sum dy * xhat, dbeta = sum dy and
// dbias = sum dh (the gradient of h + bias, so of the dropped-out sum,
// not du), written to f32 buffers of shape (ceil(R / ROWS), C) that
// the wrapper sums in a fixed order: deterministic, no float atomics.
// keep == 1 skips the mask; 1/keep arrives as the f32 constant the
// forward multiplies by, and the keep test is bits < round(keep * 2^32)
// in uint32, as the forward's.
//
// Bound on the H100: bytes.  At the training shape (R = 4096, C = 1024)
// it reads h, res and dy and writes dh and dres, five (R, C) tensors,
// for ~20 flops per element plus threefry's ~100 integer operations
// when dropout is on, below the card's balance point; the partial rows
// add 3 * C * 4 bytes per CTA.  The design reads each input element
// once from device memory and keeps xhat, dyg and the mask's scale on
// chip between the two passes over the row.
#include "common.cuh"

template <typename T>
__global__ void frln_bwd_kernel(
    const T* __restrict__ h, const T* __restrict__ bias,
    const T* __restrict__ res, const T* __restrict__ gamma,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const T* __restrict__ dy, T* __restrict__ dh, T* __restrict__ dres,
    float* __restrict__ dg_part, float* __restrict__ db_part,
    float* __restrict__ dbias_part, long long R, int C, int rows_per_cta,
    int use_mask, uint32_t k0, uint32_t k1, uint32_t thresh,
    float inv_keep) {
  extern __shared__ float sm[];
  float* xh = sm;          // C: xhat of the current row
  float* dg = xh + C;      // C: dy * gamma of the current row
  float* ks = dg + C;      // C: 1/keep where kept, 0 where dropped
  float* pg = ks + C;      // C: partial dgamma
  float* pb = pg + C;      // C: partial dbeta
  float* pbias = pb + C;   // C: partial dbias
  float* red = pbias + C;  // one float per warp
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    pg[c] = pb[c] = pbias[c] = 0.f;

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = r0 + rows_per_cta < R ? r0 + rows_per_cta : R;
  for (long long row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * C;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float hb = to_f<T>(h[base + c]) + to_f<T>(bias[c]);
      float scale = 1.f;
      if (use_mask) {
        const uint32_t ctr = (uint32_t)row * (uint32_t)C + (uint32_t)c;
        scale = threefry_bits(k0, k1, ctr) < thresh ? inv_keep : 0.f;
        hb = scale != 0.f ? hb * inv_keep : 0.f;
      }
      const float u = to_f<T>(res[base + c]) + hb;
      const float d = to_f<T>(dy[base + c]);
      const float xv = (u - mu) * rs;
      const float g = d * to_f<T>(gamma[c]);
      xh[c] = xv;
      dg[c] = g;
      ks[c] = scale;
      s1 += g;
      s2 += g * xv;
      pg[c] += d * xv;
      pb[c] += d;
    }
    const float c1 = block_sum(s1, red) / (float)C;
    const float c2 = block_sum(s2, red) / (float)C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float du = rs * (dg[c] - c1 - xh[c] * c2);
      const float dhv = use_mask ? (ks[c] != 0.f ? du * inv_keep : 0.f)
                                 : du;
      dh[base + c] = from_f<T>(dhv);
      dres[base + c] = from_f<T>(du);
      pbias[c] += dhv;
    }
  }
  const size_t pbase = (size_t)blockIdx.x * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    dg_part[pbase + c] = pg[c];
    db_part[pbase + c] = pb[c];
    dbias_part[pbase + c] = pbias[c];
  }
}

template <typename T>
static int launch(const void* h, const void* bias, const void* res,
                  const void* g, const void* mean, const void* rstd,
                  const void* dy, void* dh, void* dres, void* dg_part,
                  void* db_part, void* dbias_part, long long rows, int C,
                  int rpc, int use_mask, uint32_t k0, uint32_t k1,
                  uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const int threads = C >= 1024 ? 256 : 128;
  const size_t smem = (size_t)(6 * C + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        frln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rpc - 1) / rpc;
  frln_bwd_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      (const T*)h, (const T*)bias, (const T*)res, (const T*)g,
      (const float*)mean, (const float*)rstd, (const T*)dy, (T*)dh,
      (T*)dres, (float*)dg_part, (float*)db_part, (float*)dbias_part, rows,
      C, rpc, use_mask, k0, k1, thresh, inv_keep);
  return (int)cudaGetLastError();
}

extern "C" int mxt_fused_residual_ln_bwd(
    const void* h, const void* bias, const void* res, const void* g,
    const void* mean, const void* rstd, const void* dy, void* dh,
    void* dres, void* dg_part, void* db_part, void* dbias_part,
    long long rows, int C, int rows_per_cta, int use_mask, uint32_t k0,
    uint32_t k1, uint32_t thresh, float inv_keep, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_cta < 1) return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32)
    return launch<float>(h, bias, res, g, mean, rstd, dy, dh, dres, dg_part,
                         db_part, dbias_part, rows, C, rows_per_cta,
                         use_mask, k0, k1, thresh, inv_keep, s);
  if (dtype == MXT_BF16)
    return launch<__nv_bfloat16>(h, bias, res, g, mean, rstd, dy, dh, dres,
                                 dg_part, db_part, dbias_part, rows, C,
                                 rows_per_cta, use_mask, k0, k1, thresh,
                                 inv_keep, s);
  return (int)cudaErrorInvalidValue;
}
