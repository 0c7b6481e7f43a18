// Fused residual LayerNorm forward: y = LN(res + dropout(h + bias)) over
// the last axis of (R, C) row-major tensors.
//
// Replaces mxtpu/kernels/layer_norm.py:_frln_fwd_kernel (launched by
// _pallas_frln_fwd).  One CTA per row: h, bias and res are read once,
// u = res + dropout(h + bias) is formed in shared memory (u never goes
// to device memory), LayerNorm runs over it with f32 statistics, and y
// plus f32 mean/rstd are written.
//
// The dropout mask is the reference's: 20-round threefry2x32 keyed by
// two uint32 words from the wrapper, counter = the global linear element
// index row*C + c (uint32 arithmetic), an element kept iff its bits are
// below round(keep * 2^32).  keep == 1 (serving) skips it entirely.
//
// Bound on the H100: bytes.  At the serving shape (R = b*T, C = 1024)
// it moves 3 tensors of R*C elements (h, res in; y out) for ~10 flops
// per element, so the floor is those bytes at 3.35 TB/s.  The unfused
// sequence would also write and re-read u; this kernel does not.  With
// dropout on, threefry adds ~100 integer ops per element, which stays
// under the integer rate at these sizes.
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

template <typename T>
static int launch(const void* h, const void* bias, const void* res,
                  const void* g, const void* b, void* y, void* mean,
                  void* rstd, long long rows, int C, float eps, int use_mask,
                  uint32_t k0, uint32_t k1, uint32_t thresh, float inv_keep,
                  cudaStream_t stream) {
  const int threads = C >= 1024 ? 256 : 128;
  const size_t smem = (size_t)(C + 32) * sizeof(float);
  frln_fwd_kernel<T><<<(unsigned)rows, threads, smem, stream>>>(
      (const T*)h, (const T*)bias, (const T*)res, (const T*)g, (const T*)b,
      (T*)y, (float*)mean, (float*)rstd, C, eps, use_mask, k0, k1, thresh,
      inv_keep);
  return (int)cudaGetLastError();
}

extern "C" int mxt_fused_residual_ln_fwd(
    const void* h, const void* bias, const void* res, const void* g,
    const void* b, void* y, void* mean, void* rstd, long long rows, int C,
    float eps, int use_mask, uint32_t k0, uint32_t k1, uint32_t thresh,
    float inv_keep, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MXT_F32)
    return launch<float>(h, bias, res, g, b, y, mean, rstd, rows, C, eps,
                         use_mask, k0, k1, thresh, inv_keep, s);
  if (dtype == MXT_BF16)
    return launch<__nv_bfloat16>(h, bias, res, g, b, y, mean, rstd, rows, C,
                                 eps, use_mask, k0, k1, thresh, inv_keep, s);
  return (int)cudaErrorInvalidValue;
}
