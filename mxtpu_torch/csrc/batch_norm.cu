// Training-mode BatchNorm forward with an optional fused residual add
// and ReLU, over two views of the data:
//   channels-major (N, C, S): x[n][c][s]  (NCHW, S = H*W)
//   channels-minor (R, C):    x[r][c]     (NHWC, R = N*H*W)
//
// Replaces mxtpu/kernels/batch_norm.py:_fwd_kernel (launched by
// _fwd_call) and _fwd_kernel_cm (_fwd_call_cm).  Per channel, in f32:
//   mean = E[x], var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps),
//   scale = g * rstd, shift = b - mean * scale,
//   y = relu?(x * scale + shift (+ r)),
// y in x's type, mean and var f32.
//
// The TPU kernel stages all N*S elements of a channel block in VMEM;
// the ResNet stem's channel is 3.2 M elements, far past a CTA's shared
// memory, so here the reduction is split in three kernels on one
// stream:
//   1. stats: a (channel x chunk) grid; each CTA sums x and x^2 of its
//      chunk (per-thread f32 sums, then a tree over the block) into an
//      f32 workspace part[2][chunks][C];
//   2. finalize: one thread per channel sums its chunks in a fixed
//      order (in double), writes mean and var, and scale and shift
//      into the workspace;
//   3. apply: an elementwise grid-stride pass for y.
// No float atomics, so the result repeats bit for bit.  Channels-major
// CTAs walk a channel's N runs of S contiguous elements; channels-minor
// CTAs put the 32 lanes of a warp on 32 neighbouring channels, so each
// warp reads whole row segments, and split the rows into chunks.  The
// elementwise ops round one at a time (__fmul_rn, __fadd_rn), in the
// plain version's order, so only the sums can differ from it.
//
// Bound on the H100: bytes.  A few flops per element against reading
// x (and r) and writing y; this first version reads x twice (stats,
// then apply) with scalar loads.  Offsets are 64-bit throughout.
#include "common.cuh"

template <typename T>
__global__ void bn_fwd_stats_kernel(const T* __restrict__ x,
                                    float* __restrict__ part, long long S,
                                    int C, long long M, long long per_chunk,
                                    int chunks) {
  // channel c, chunk [i0, i1) of its flattened index i = n * S + s
  const int c = blockIdx.x, chunk = blockIdx.y;
  const long long i0 = (long long)chunk * per_chunk;
  const long long i1 = i0 + per_chunk < M ? i0 + per_chunk : M;
  const long long CS = (long long)C * S;
  float s1 = 0.f, s2 = 0.f;
  long long i = i0 + threadIdx.x;
  if (i < i1) {
    long long n = i / S, s = i - n * S;
    long long off = n * CS + (long long)c * S + s;
    const long long ds = blockDim.x % S, dn = blockDim.x / S;
    for (; i < i1; i += blockDim.x) {
      const float v = to_f<T>(x[off]);
      s1 += v;
      s2 = fmaf(v, v, s2);
      s += ds;
      off += dn * CS + ds;
      if (s >= S) {
        s -= S;
        off += CS - S;
      }
    }
  }
  __shared__ float red[32];
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    part[(size_t)chunk * C + c] = s1;
    part[(size_t)(chunks + chunk) * C + c] = s2;
  }
}

// blockDim = (32, 8): lane x owns channel c0 + x, row lane y takes rows
// r0 + y, r0 + y + 8, ... of the chunk
template <typename T>
__global__ void bn_fwd_cm_stats_kernel(const T* __restrict__ x,
                                       float* __restrict__ part, int C,
                                       long long R, long long per_chunk,
                                       int chunks) {
  const int c = blockIdx.x * 32 + threadIdx.x, chunk = blockIdx.y;
  const long long r0 = (long long)chunk * per_chunk;
  const long long r1 = r0 + per_chunk < R ? r0 + per_chunk : R;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const float v = to_f<T>(x[r * C + c]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
  __shared__ float sh1[8][33], sh2[8][33];
  sh1[threadIdx.y][threadIdx.x] = s1;
  sh2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < (int)blockDim.y; ++k) {
      a += sh1[k][threadIdx.x];
      b += sh2[k][threadIdx.x];
    }
    part[(size_t)chunk * C + c] = a;
    part[(size_t)(chunks + chunk) * C + c] = b;
  }
}

template <typename T>
__device__ __forceinline__ void finalize_body(
    const float* __restrict__ part, int chunks, int C, double n,
    const T* __restrict__ gamma, const T* __restrict__ beta, float eps,
    float* __restrict__ mean, float* __restrict__ var,
    float* __restrict__ coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double a = 0.0, b = 0.0;
  for (int k = 0; k < chunks; ++k) {
    a += (double)part[(size_t)k * C + c];
    b += (double)part[(size_t)(chunks + k) * C + c];
  }
  const double m = a / n;
  double v = b / n - m * m;
  if (!(v > 0.0)) v = 0.0;
  const float mf = (float)m, vf = (float)v;
  const float rs = rsqrtf(__fadd_rn(vf, eps));
  const float sc = __fmul_rn(to_f<T>(gamma[c]), rs);
  mean[c] = mf;
  var[c] = vf;
  coef[c] = sc;
  coef[C + c] = __fsub_rn(to_f<T>(beta[c]), __fmul_rn(mf, sc));
}

template <typename T>
__global__ void bn_fwd_finalize_kernel(const float* part, int chunks, int C,
                                       double n, const T* gamma,
                                       const T* beta, float eps,
                                       float* mean, float* var,
                                       float* coef) {
  finalize_body<T>(part, chunks, C, n, gamma, beta, eps, mean, var, coef);
}

template <typename T>
__global__ void bn_fwd_cm_finalize_kernel(const float* part, int chunks,
                                          int C, double n, const T* gamma,
                                          const T* beta, float eps,
                                          float* mean, float* var,
                                          float* coef) {
  finalize_body<T>(part, chunks, C, n, gamma, beta, eps, mean, var, coef);
}

// y = relu?(x * scale[c] + shift[c] (+ r)) over all A*C*S elements; the
// channel of element i is (i / S) % C, kept by increments (no division
// in the loop).  S = 1 is the channels-minor view.
template <typename T, bool RELU, bool ADD>
__device__ __forceinline__ void apply_body(const T* __restrict__ x,
                                           const T* __restrict__ r,
                                           const float* __restrict__ coef,
                                           T* __restrict__ y,
                                           long long total, int C,
                                           long long S) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long q = i / S;
  long long s = i - q * S;
  int c = (int)(q % C);
  const long long ds = stride % S;
  const int dc = (int)((stride / S) % C);
  for (; i < total; i += stride) {
    float v = __fadd_rn(__fmul_rn(to_f<T>(x[i]), coef[c]), coef[C + c]);
    if (ADD) v = __fadd_rn(v, to_f<T>(r[i]));
    if (RELU) v = fmaxf(v, 0.f);
    y[i] = from_f<T>(v);
    s += ds;
    if (s >= S) {
      s -= S;
      ++c;
    }
    c += dc;
    if (c >= C) c -= C;
  }
}

template <typename T, bool RELU, bool ADD>
__global__ void bn_fwd_apply_kernel(const T* x, const T* r,
                                    const float* coef, T* y,
                                    long long total, int C, long long S) {
  apply_body<T, RELU, ADD>(x, r, coef, y, total, C, S);
}

template <typename T, bool RELU, bool ADD>
__global__ void bn_fwd_cm_apply_kernel(const T* x, const T* r,
                                       const float* coef, T* y,
                                       long long total, int C) {
  apply_body<T, RELU, ADD>(x, r, coef, y, total, C, 1);
}

template <typename T, bool RELU, bool ADD>
static int launch(bool cm, const void* x, const void* r, const void* g,
                  const void* b, void* y, void* mean, void* var, void* work,
                  long long A, int C, long long S, int chunks,
                  long long per_chunk, int apply_blocks, float eps,
                  cudaStream_t st) {
  float* part = (float*)work;
  float* coef = part + (size_t)2 * chunks * C;
  const long long M = A * S;  // elements per channel
  const long long total = M * C;
  if (cm) {
    bn_fwd_cm_stats_kernel<T><<<dim3((C + 31) / 32, chunks), dim3(32, 8), 0,
                                st>>>((const T*)x, part, C, A, per_chunk,
                                      chunks);
  } else {
    bn_fwd_stats_kernel<T><<<dim3(C, chunks), 256, 0, st>>>(
        (const T*)x, part, S, C, M, per_chunk, chunks);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int fb = (C + 127) / 128;
  if (cm) {
    bn_fwd_cm_finalize_kernel<T><<<fb, 128, 0, st>>>(
        part, chunks, C, (double)M, (const T*)g, (const T*)b, eps,
        (float*)mean, (float*)var, coef);
  } else {
    bn_fwd_finalize_kernel<T><<<fb, 128, 0, st>>>(
        part, chunks, C, (double)M, (const T*)g, (const T*)b, eps,
        (float*)mean, (float*)var, coef);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (cm) {
    bn_fwd_cm_apply_kernel<T, RELU, ADD><<<apply_blocks, 256, 0, st>>>(
        (const T*)x, (const T*)r, coef, (T*)y, total, C);
  } else {
    bn_fwd_apply_kernel<T, RELU, ADD><<<apply_blocks, 256, 0, st>>>(
        (const T*)x, (const T*)r, coef, (T*)y, total, C, S);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_t(bool cm, int relu, int add, const void* x,
                    const void* r, const void* g, const void* b, void* y,
                    void* mean, void* var, void* work, long long A, int C,
                    long long S, int chunks, long long per_chunk,
                    int apply_blocks, float eps, cudaStream_t st) {
  if (relu && add)
    return launch<T, true, true>(cm, x, r, g, b, y, mean, var, work, A, C,
                                 S, chunks, per_chunk, apply_blocks, eps,
                                 st);
  if (relu)
    return launch<T, true, false>(cm, x, r, g, b, y, mean, var, work, A, C,
                                  S, chunks, per_chunk, apply_blocks, eps,
                                  st);
  if (add)
    return launch<T, false, true>(cm, x, r, g, b, y, mean, var, work, A, C,
                                  S, chunks, per_chunk, apply_blocks, eps,
                                  st);
  return launch<T, false, false>(cm, x, r, g, b, y, mean, var, work, A, C,
                                 S, chunks, per_chunk, apply_blocks, eps,
                                 st);
}

static int entry(bool cm, const void* x, const void* r, const void* g,
                 const void* b, void* y, void* mean, void* var, void* work,
                 long long A, int C, long long S, int chunks,
                 long long per_chunk, int apply_blocks, float eps, int relu,
                 int add, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (A < 1 || C < 1 || S < 1 || chunks < 1 || chunks > 65535 ||
      per_chunk < 1 || apply_blocks < 1 || (add && r == nullptr) ||
      (cm && S != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32)
    return launch_t<float>(cm, relu, add, x, r, g, b, y, mean, var, work, A,
                           C, S, chunks, per_chunk, apply_blocks, eps, st);
  if (dtype == MXT_BF16)
    return launch_t<__nv_bfloat16>(cm, relu, add, x, r, g, b, y, mean, var,
                                   work, A, C, S, chunks, per_chunk,
                                   apply_blocks, eps, st);
  return (int)cudaErrorInvalidValue;
}

// work: f32, 2 * chunks * C partial sums then 2 * C scale/shift
extern "C" int mxt_bn_fwd(const void* x, const void* r, const void* g,
                          const void* b, void* y, void* mean, void* var,
                          void* work, long long N, int C, long long S,
                          int chunks, long long per_chunk, int apply_blocks,
                          float eps, int relu, int add, int dtype,
                          void* stream) {
  return entry(false, x, r, g, b, y, mean, var, work, N, C, S, chunks,
               per_chunk, apply_blocks, eps, relu, add, dtype, stream);
}

extern "C" int mxt_bn_fwd_cm(const void* x, const void* r, const void* g,
                             const void* b, void* y, void* mean, void* var,
                             void* work, long long R, int C, long long S,
                             int chunks, long long per_chunk,
                             int apply_blocks, float eps, int relu, int add,
                             int dtype, void* stream) {
  return entry(true, x, r, g, b, y, mean, var, work, R, C, S, chunks,
               per_chunk, apply_blocks, eps, relu, add, dtype, stream);
}
