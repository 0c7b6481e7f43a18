// Training-mode BatchNorm backward with the optional fused residual add
// and ReLU, over the channels-major (N, C, S) and channels-minor (R, C)
// views, from the forward's f32 batch mean and rstd = rsqrt(var + eps).
//
// Replaces mxtpu/kernels/batch_norm.py:_bwd_kernel (launched by
// _bwd_call) and _bwd_kernel_cm (_bwd_call_cm).  Per element, in f32:
//   xhat = (x - mean) * rstd,
//   with ReLU: dy' = dy where xhat * g + b (+ r) > 0, else 0 (the mask
//   is recomputed from x, never read from y); dr = dy' in dy's type;
// per channel: dbeta = sum dy', dgamma = sum dy' * xhat (f32 outputs);
// and dx = g * rstd * (dy' - dbeta / n - xhat * dgamma / n).
//
// As the forward (csrc/batch_norm.cu), a split reduction in three
// kernels: stats (partial sums per (channel, chunk) into an f32
// workspace), finalize (chunks summed in a fixed order in double; the
// per-channel g * rstd, dbeta / n and dgamma / n), and an elementwise
// pass for dx and dr.  No float atomics: bit-for-bit repeatable.  The
// elementwise ops round one at a time in the plain version's order, so
// the recomputed mask is the plain version's exactly and only the sums
// can differ from it.
//
// Bound on the H100: bytes — x and dy (and r) read, dx (and dr)
// written; this first version reads x and dy twice.
#include "common.cuh"

// dy' of one element: dy, masked by the recomputed pre-activation sign
template <typename T, bool RELU, bool ADD>
__device__ __forceinline__ float masked_dy(float xh, float g, float b,
                                           const T* __restrict__ r,
                                           long long off, float d) {
  if (RELU) {
    float a = __fadd_rn(__fmul_rn(xh, g), b);
    if (ADD) a = __fadd_rn(a, to_f<T>(r[off]));
    if (!(a > 0.f)) d = 0.f;
  }
  return d;
}

template <typename T, bool RELU, bool ADD>
__global__ void bn_bwd_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const T* __restrict__ dy, const T* __restrict__ gamma,
    const T* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ rstd, float* __restrict__ part, long long S,
    int C, long long M, long long per_chunk, int chunks) {
  const int c = blockIdx.x, chunk = blockIdx.y;
  const float mu = mean[c], rs = rstd[c];
  const float g = to_f<T>(gamma[c]), b = to_f<T>(beta[c]);
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
      const float xh = __fmul_rn(__fsub_rn(to_f<T>(x[off]), mu), rs);
      const float d =
          masked_dy<T, RELU, ADD>(xh, g, b, r, off, to_f<T>(dy[off]));
      s1 += d;
      s2 = fmaf(d, xh, s2);
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
template <typename T, bool RELU, bool ADD>
__global__ void bn_bwd_cm_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const T* __restrict__ dy, const T* __restrict__ gamma,
    const T* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ rstd, float* __restrict__ part, int C,
    long long R, long long per_chunk, int chunks) {
  const int c = blockIdx.x * 32 + threadIdx.x, chunk = blockIdx.y;
  const long long r0 = (long long)chunk * per_chunk;
  const long long r1 = r0 + per_chunk < R ? r0 + per_chunk : R;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const float mu = mean[c], rs = rstd[c];
    const float g = to_f<T>(gamma[c]), b = to_f<T>(beta[c]);
    for (long long row = r0 + threadIdx.y; row < r1; row += blockDim.y) {
      const long long off = row * C + c;
      const float xh = __fmul_rn(__fsub_rn(to_f<T>(x[off]), mu), rs);
      const float d =
          masked_dy<T, RELU, ADD>(xh, g, b, r, off, to_f<T>(dy[off]));
      s1 += d;
      s2 = fmaf(d, xh, s2);
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

// coef: [3][C] = g * rstd, dbeta / n, dgamma / n
template <typename T>
__device__ __forceinline__ void finalize_body(
    const float* __restrict__ part, int chunks, int C, float n,
    const T* __restrict__ gamma, const float* __restrict__ rstd,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    float* __restrict__ coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double a = 0.0, b = 0.0;
  for (int k = 0; k < chunks; ++k) {
    a += (double)part[(size_t)k * C + c];
    b += (double)part[(size_t)(chunks + k) * C + c];
  }
  const float db = (float)a, dg = (float)b;
  dbeta[c] = db;
  dgamma[c] = dg;
  coef[c] = __fmul_rn(to_f<T>(gamma[c]), rstd[c]);
  coef[C + c] = __fdiv_rn(db, n);
  coef[2 * C + c] = __fdiv_rn(dg, n);
}

template <typename T>
__global__ void bn_bwd_finalize_kernel(const float* part, int chunks, int C,
                                       float n, const T* gamma,
                                       const float* rstd, float* dgamma,
                                       float* dbeta, float* coef) {
  finalize_body<T>(part, chunks, C, n, gamma, rstd, dgamma, dbeta, coef);
}

template <typename T>
__global__ void bn_bwd_cm_finalize_kernel(const float* part, int chunks,
                                          int C, float n, const T* gamma,
                                          const float* rstd, float* dgamma,
                                          float* dbeta, float* coef) {
  finalize_body<T>(part, chunks, C, n, gamma, rstd, dgamma, dbeta, coef);
}

// dx (and dr) over all A*C*S elements; channel (i / S) % C kept by
// increments.  S = 1 is the channels-minor view.
template <typename T, bool RELU, bool ADD>
__device__ __forceinline__ void apply_body(
    const T* __restrict__ x, const T* __restrict__ r,
    const T* __restrict__ dy, const T* __restrict__ gamma,
    const T* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ coef,
    T* __restrict__ dx, T* __restrict__ dr, long long total, int C,
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
    const float xh = __fmul_rn(__fsub_rn(to_f<T>(x[i]), mean[c]), rstd[c]);
    const float d = masked_dy<T, RELU, ADD>(xh, to_f<T>(gamma[c]),
                                            to_f<T>(beta[c]), r, i,
                                            to_f<T>(dy[i]));
    if (ADD) dr[i] = from_f<T>(d);
    const float t = __fsub_rn(__fsub_rn(d, coef[C + c]),
                              __fmul_rn(xh, coef[2 * C + c]));
    dx[i] = from_f<T>(__fmul_rn(coef[c], t));
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
__global__ void bn_bwd_apply_kernel(const T* x, const T* r, const T* dy,
                                    const T* gamma, const T* beta,
                                    const float* mean, const float* rstd,
                                    const float* coef, T* dx, T* dr,
                                    long long total, int C, long long S) {
  apply_body<T, RELU, ADD>(x, r, dy, gamma, beta, mean, rstd, coef, dx, dr,
                           total, C, S);
}

template <typename T, bool RELU, bool ADD>
__global__ void bn_bwd_cm_apply_kernel(const T* x, const T* r, const T* dy,
                                       const T* gamma, const T* beta,
                                       const float* mean, const float* rstd,
                                       const float* coef, T* dx, T* dr,
                                       long long total, int C) {
  apply_body<T, RELU, ADD>(x, r, dy, gamma, beta, mean, rstd, coef, dx, dr,
                           total, C, 1);
}

struct BwdArgs {
  const void *x, *r, *dy, *g, *b, *mean, *rstd;
  void *dx, *dr, *dgamma, *dbeta, *work;
  long long A, S, per_chunk;
  int C, chunks, apply_blocks;
};

template <typename T, bool RELU, bool ADD>
static int launch(bool cm, const BwdArgs& a, cudaStream_t st) {
  float* part = (float*)a.work;
  float* coef = part + (size_t)2 * a.chunks * a.C;
  const long long M = a.A * a.S;
  const long long total = M * a.C;
  const T *x = (const T*)a.x, *r = (const T*)a.r, *dy = (const T*)a.dy;
  const T *g = (const T*)a.g, *b = (const T*)a.b;
  const float *mean = (const float*)a.mean, *rstd = (const float*)a.rstd;
  if (cm) {
    bn_bwd_cm_stats_kernel<T, RELU, ADD>
        <<<dim3((a.C + 31) / 32, a.chunks), dim3(32, 8), 0, st>>>(
            x, r, dy, g, b, mean, rstd, part, a.C, a.A, a.per_chunk,
            a.chunks);
  } else {
    bn_bwd_stats_kernel<T, RELU, ADD><<<dim3(a.C, a.chunks), 256, 0, st>>>(
        x, r, dy, g, b, mean, rstd, part, a.S, a.C, M, a.per_chunk,
        a.chunks);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int fb = (a.C + 127) / 128;
  // the reference divides by n = float(N * S), an f32 constant
  const float n = (float)M;
  if (cm) {
    bn_bwd_cm_finalize_kernel<T><<<fb, 128, 0, st>>>(
        part, a.chunks, a.C, n, g, rstd, (float*)a.dgamma, (float*)a.dbeta,
        coef);
  } else {
    bn_bwd_finalize_kernel<T><<<fb, 128, 0, st>>>(
        part, a.chunks, a.C, n, g, rstd, (float*)a.dgamma, (float*)a.dbeta,
        coef);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (cm) {
    bn_bwd_cm_apply_kernel<T, RELU, ADD><<<a.apply_blocks, 256, 0, st>>>(
        x, r, dy, g, b, mean, rstd, coef, (T*)a.dx, (T*)a.dr, total, a.C);
  } else {
    bn_bwd_apply_kernel<T, RELU, ADD><<<a.apply_blocks, 256, 0, st>>>(
        x, r, dy, g, b, mean, rstd, coef, (T*)a.dx, (T*)a.dr, total, a.C,
        a.S);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_t(bool cm, int relu, int add, const BwdArgs& a,
                    cudaStream_t st) {
  if (relu && add) return launch<T, true, true>(cm, a, st);
  if (relu) return launch<T, true, false>(cm, a, st);
  if (add) return launch<T, false, true>(cm, a, st);
  return launch<T, false, false>(cm, a, st);
}

static int entry(bool cm, const BwdArgs& a, int relu, int add, int dtype,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a.A < 1 || a.C < 1 || a.S < 1 || a.chunks < 1 || a.chunks > 65535 ||
      a.per_chunk < 1 || a.apply_blocks < 1 ||
      (add && (a.r == nullptr || a.dr == nullptr)) || (cm && a.S != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32) return launch_t<float>(cm, relu, add, a, st);
  if (dtype == MXT_BF16)
    return launch_t<__nv_bfloat16>(cm, relu, add, a, st);
  return (int)cudaErrorInvalidValue;
}

// work: f32, 2 * chunks * C partial sums then 3 * C coefficients
#define MXT_BN_BWD_ENTRY(NAME, CM)                                          \
  extern "C" int NAME(const void* x, const void* r, const void* dy,        \
                      const void* g, const void* b, const void* mean,      \
                      const void* rstd, void* dx, void* dr, void* dgamma,  \
                      void* dbeta, void* work, long long A, int C,         \
                      long long S, int chunks, long long per_chunk,        \
                      int apply_blocks, int relu, int add, int dtype,      \
                      void* stream) {                                       \
    BwdArgs a{x,  r,      dy,    g,    b,         mean,   rstd,         \
              dx, dr,     dgamma, dbeta, work,    A,      S,            \
              per_chunk, C, chunks, apply_blocks};                         \
    return entry(CM, a, relu, add, dtype, stream);                         \
  }

MXT_BN_BWD_ENTRY(mxt_bn_bwd, false)
MXT_BN_BWD_ENTRY(mxt_bn_bwd_cm, true)
