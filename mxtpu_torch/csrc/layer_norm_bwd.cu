// LayerNorm backward over the last axis of an (R, C) row-major tensor,
// from the forward's f32 mean and rstd.
//
// Replaces mxtpu/kernels/layer_norm.py:_ln_bwd_kernel (launched by
// _pallas_ln_bwd).  Per row, in f32:
//   xhat = (x - mean) * rstd,  dyg = dy * gamma,
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)),
// and the parameter gradients dgamma = sum_rows dy * xhat, dbeta =
// sum_rows dy.  As the TPU kernel writes one partial row per row block
// and leaves the sum over blocks outside, each CTA here takes ROWS rows
// and writes its partial dgamma and dbeta rows to f32 buffers of shape
// (ceil(R / ROWS), C); the wrapper sums them.  ROWS comes from the
// wrapper, which sizes those buffers.  Every sum has a fixed
// order, so the result is deterministic (no atomics on floats).
//
// Threads own columns c = tid + k * blockDim, the same in every row, so
// the staged row and the partial sums live in shared memory without any
// barrier beyond the two block reductions per row.
//
// Bound on the H100: bytes.  At the training shape (R = 4096, C = 1024)
// it does ~12 flops per element against reading x and dy and writing
// dx, far below the card's flop/byte balance, so the floor is those
// three (R, C) tensors at 3.35 TB/s; the partial rows add 2 * C * 4
// bytes per CTA.  The design reads each input element once from device
// memory and keeps the row's xhat and dyg on chip between the two
// passes.
#include "common.cuh"

template <typename T>
__global__ void ln_bwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ gamma,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              float* __restrict__ dg_part,
                              float* __restrict__ db_part, long long R,
                              int C, int rows_per_cta) {
  extern __shared__ float sm[];
  float* xh = sm;          // C: xhat of the current row
  float* dg = xh + C;      // C: dy * gamma of the current row
  float* pg = dg + C;      // C: partial dgamma of this CTA
  float* pb = pg + C;      // C: partial dbeta of this CTA
  float* red = pb + C;     // one float per warp
  for (int c = threadIdx.x; c < C; c += blockDim.x) pg[c] = pb[c] = 0.f;

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = r0 + rows_per_cta < R ? r0 + rows_per_cta : R;
  for (long long row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * C;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float d = to_f<T>(dy[base + c]);
      const float h = (to_f<T>(x[base + c]) - mu) * rs;
      const float g = d * to_f<T>(gamma[c]);
      xh[c] = h;
      dg[c] = g;
      s1 += g;
      s2 += g * h;
      pg[c] += d * h;
      pb[c] += d;
    }
    const float c1 = block_sum(s1, red) / (float)C;
    const float c2 = block_sum(s2, red) / (float)C;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      dx[base + c] = from_f<T>(rs * (dg[c] - c1 - xh[c] * c2));
  }
  const size_t pbase = (size_t)blockIdx.x * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    dg_part[pbase + c] = pg[c];
    db_part[pbase + c] = pb[c];
  }
}

template <typename T>
static int launch(const void* x, const void* g, const void* mean,
                  const void* rstd, const void* dy, void* dx, void* dg_part,
                  void* db_part, long long rows, int C, int rpc,
                  cudaStream_t stream) {
  const int threads = C >= 1024 ? 256 : 128;
  const size_t smem = (size_t)(4 * C + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + rpc - 1) / rpc;
  ln_bwd_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      (const T*)x, (const T*)g, (const float*)mean, (const float*)rstd,
      (const T*)dy, (T*)dx, (float*)dg_part, (float*)db_part, rows, C, rpc);
  return (int)cudaGetLastError();
}

extern "C" int mxt_layer_norm_bwd(const void* x, const void* g,
                                  const void* mean, const void* rstd,
                                  const void* dy, void* dx, void* dg_part,
                                  void* db_part, long long rows, int C,
                                  int rows_per_cta, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_per_cta < 1) return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32)
    return launch<float>(x, g, mean, rstd, dy, dx, dg_part, db_part, rows,
                         C, rows_per_cta, s);
  if (dtype == MXT_BF16)
    return launch<__nv_bfloat16>(x, g, mean, rstd, dy, dx, dg_part, db_part,
                                 rows, C, rows_per_cta, s);
  return (int)cudaErrorInvalidValue;
}
