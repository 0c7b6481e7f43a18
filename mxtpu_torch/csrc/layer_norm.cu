// LayerNorm forward over the last axis of an (R, C) row-major tensor.
//
// Replaces mxtpu/kernels/layer_norm.py:_ln_fwd_kernel (launched by
// _pallas_ln_fwd).  One CTA per row: the row is read once from device
// memory into shared memory as f32, mean and variance are two block
// reductions over it, and y is written once.  Outputs y (input type)
// plus f32 mean and rstd per row, as the TPU kernel does.
//
// Bound on the H100: bytes.  At the serving path's shape (R = b*T rows,
// C = 1024) the kernel does ~8 flops per element against 8 bytes moved
// per element in f32, far below the card's ~20 flop/byte balance point
// for f32 CUDA-core work, so the floor is one read of x and one write
// of y at 3.35 TB/s.  The design reads x exactly once (shared-memory
// staging keeps the second pass on chip) and writes y exactly once.
#include "common.cuh"

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ gamma,
                              const T* __restrict__ beta,
                              T* __restrict__ y, float* __restrict__ mean,
                              float* __restrict__ rstd, int C, float eps) {
  extern __shared__ float sm[];
  float* xs = sm;       // C floats: the row in f32
  float* red = sm + C;  // one float per warp
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)C;
  T* yr = y + row * (size_t)C;

  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = to_f<T>(xr[c]);
    xs[c] = v;
    s += v;
  }
  const float mu = block_sum(s, red) / (float)C;
  float q = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = xs[c] - mu;
    q += d * d;
  }
  const float var = block_sum(q, red) / (float)C;
  const float rs = 1.0f / sqrtf(var + eps);
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    yr[c] = from_f<T>((xs[c] - mu) * rs * to_f<T>(gamma[c]) +
                      to_f<T>(beta[c]));
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename T>
static int launch(const void* x, const void* g, const void* b, void* y,
                  void* mean, void* rstd, long long rows, int C, float eps,
                  cudaStream_t stream) {
  const int threads = C >= 1024 ? 256 : 128;
  const size_t smem = (size_t)(C + 32) * sizeof(float);
  ln_fwd_kernel<T><<<(unsigned)rows, threads, smem, stream>>>(
      (const T*)x, (const T*)g, (const T*)b, (T*)y, (float*)mean,
      (float*)rstd, C, eps);
  return (int)cudaGetLastError();
}

extern "C" int mxt_layer_norm_fwd(const void* x, const void* g,
                                  const void* b, void* y, void* mean,
                                  void* rstd, long long rows, int C,
                                  float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MXT_F32)
    return launch<float>(x, g, b, y, mean, rstd, rows, C, eps, s);
  if (dtype == MXT_BF16)
    return launch<__nv_bfloat16>(x, g, b, y, mean, rstd, rows, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
