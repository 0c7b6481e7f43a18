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
// pass for dx (and dr).  No float atomics: bit-for-bit repeatable.  The
// elementwise ops round one at a time in the plain version's order, so
// the recomputed mask is the plain version's exactly and only the sums
// can differ from it.
//
// Bound on the H100: bytes — x and dy (and r) read, dx (and dr)
// written, 5 tensor passes with the add.  The channels-major kernels
// (bn_bwd_stats_kernel, bn_bwd_finalize_kernel, bn_bwd_apply_kernel)
// read x and dy twice with scalar loads.  The channels-minor ones
// (below: bn_bwd_cm_*) use 16-byte vector loads with several rows in
// flight a thread, and with the add the stats pass writes dr, so the
// apply pass reads x and dr only: 7 passes where the bound has 5 (a
// ResNet-50 layer's x, dy and r exceed the 50 MB L2 many times over, so
// no two-pass design reads them once).
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

// dx (and dr) over all A*C*S elements of the channels-major view;
// channel (i / S) % C kept by increments.
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

struct BwdArgs {
  const void *x, *r, *dy, *g, *b, *mean, *rstd;
  void *dx, *dr, *dgamma, *dbeta, *work;
  long long A, S, per_chunk;
  int C, chunks, apply_blocks;
};

template <typename T, bool RELU, bool ADD>
static int launch(const BwdArgs& a, cudaStream_t st) {
  float* part = (float*)a.work;
  float* coef = part + (size_t)2 * a.chunks * a.C;
  const long long M = a.A * a.S;
  const long long total = M * a.C;
  const T *x = (const T*)a.x, *r = (const T*)a.r, *dy = (const T*)a.dy;
  const T *g = (const T*)a.g, *b = (const T*)a.b;
  const float *mean = (const float*)a.mean, *rstd = (const float*)a.rstd;
  bn_bwd_stats_kernel<T, RELU, ADD><<<dim3(a.C, a.chunks), 256, 0, st>>>(
      x, r, dy, g, b, mean, rstd, part, a.S, a.C, M, a.per_chunk, a.chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int fb = (a.C + 127) / 128;
  // the reference divides by n = float(N * S), an f32 constant
  const float n = (float)M;
  bn_bwd_finalize_kernel<T><<<fb, 128, 0, st>>>(
      part, a.chunks, a.C, n, g, rstd, (float*)a.dgamma, (float*)a.dbeta,
      coef);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_bwd_apply_kernel<T, RELU, ADD><<<a.apply_blocks, 256, 0, st>>>(
      x, r, dy, g, b, mean, rstd, coef, (T*)a.dx, (T*)a.dr, total, a.C,
      a.S);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_t(int relu, int add, const BwdArgs& a, cudaStream_t st) {
  if (relu && add) return launch<T, true, true>(a, st);
  if (relu) return launch<T, true, false>(a, st);
  if (add) return launch<T, false, true>(a, st);
  return launch<T, false, false>(a, st);
}

// work: f32, 2 * chunks * C partial sums then 3 * C coefficients
extern "C" int mxt_bn_bwd(const void* x, const void* r, const void* dy,
                          const void* g, const void* b, const void* mean,
                          const void* rstd, void* dx, void* dr, void* dgamma,
                          void* dbeta, void* work, long long A, int C,
                          long long S, int chunks, long long per_chunk,
                          int apply_blocks, int relu, int add, int dtype,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const BwdArgs a{x,  r,  dy,     g,     b,    mean, rstd,      dx,
                  dr, dgamma, dbeta, work, A,    S,    per_chunk, C,
                  chunks, apply_blocks};
  if (a.A < 1 || a.C < 1 || a.S < 1 || a.chunks < 1 || a.chunks > 65535 ||
      a.per_chunk < 1 || a.apply_blocks < 1 ||
      (add && (a.r == nullptr || a.dr == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32) return launch_t<float>(relu, add, a, st);
  if (dtype == MXT_BF16) return launch_t<__nv_bfloat16>(relu, add, a, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// channels-minor (R, C): bn_bwd_cm_stats_kernel, bn_bwd_cm_finalize_kernel,
// bn_bwd_cm_apply_kernel
// ---------------------------------------------------------------------
//
// Geometry, the same in the stats and the apply pass: a grid of
// (channel tiles, row chunks), CTAs of CM_THREADS.  Thread t owns the
// VEC consecutive channels c0 = (tile * tv + t % tv) * VEC and row lane
// t / tv of ly = CM_THREADS / tv, and walks rows r0 + lane, r0 + lane +
// ly, ... of its chunk.  VEC is 16 bytes of T (8 bf16, 4 f32) where C
// and every pointer allow it, else 1; a tile is up to 256 channels, so
// a warp reads 32 * 16 contiguous bytes of a row, or several whole rows
// where C is narrow.  kernels/batch_norm.py:_cm_bwd_plan picks tv and
// the chunks.
constexpr int CM_THREADS = 256;

// rows whose loads one thread issues together: 16 bytes a tensor and
// row (at VEC = 8 two rows already keep 96 bytes a thread in flight)
template <int VEC>
__host__ __device__ constexpr int cm_unroll() {
  return VEC >= 8 ? 2 : 4;
}

// dy masked by the recomputed pre-activation sign, rounded one step at
// a time as the plain version (and masked_dy) does
template <bool RELU, bool ADD>
__device__ __forceinline__ float mask_cm(float xh, float g, float b,
                                         float r, float d) {
  if (RELU) {
    float a = __fadd_rn(__fmul_rn(xh, g), b);
    if (ADD) a = __fadd_rn(a, r);
    if (!(a > 0.f)) d = 0.f;
  }
  return d;
}

// Pass 1: per (chunk, channel) partial sums of d and d * xhat; with the
// add it also writes dr = d (exact: masking rounds nothing), so pass 2
// reads x and dr and neither dy nor r.  The CTA's row lanes add their
// sums through shared memory in lane order.
template <typename T, int VEC, bool RELU, bool ADD>
__global__ void __launch_bounds__(CM_THREADS, 2)
    bn_bwd_cm_stats_kernel(const T* __restrict__ x, const T* __restrict__ r,
                           const T* __restrict__ dy,
                           const T* __restrict__ gamma,
                           const T* __restrict__ beta,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           T* __restrict__ dr, float* __restrict__ part,
                           int C, long long R, long long per_chunk, int tv) {
  using P = Pack<T, VEC>;
  constexpr int U = cm_unroll<VEC>();
  const int ly = CM_THREADS / tv, width = tv * VEC;
  const int lane = threadIdx.x / tv, v = threadIdx.x - lane * tv;
  const int c0 = (blockIdx.x * tv + v) * VEC;
  const long long r0 = (long long)blockIdx.y * per_chunk;
  const long long r1 = r0 + per_chunk < R ? r0 + per_chunk : R;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (lane < ly && c0 < C) {
    float mu[VEC], rs[VEC], g[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = mean[c0 + j];
      rs[j] = rstd[c0 + j];
      g[j] = RELU ? to_f<T>(gamma[c0 + j]) : 0.f;
      b[j] = RELU ? to_f<T>(beta[c0 + j]) : 0.f;
    }
    const size_t step = (size_t)ly * C;
    long long row = r0 + lane;
    size_t off = (size_t)row * C + c0;
    for (; row < r1; row += U * ly, off += U * step) {
      const long long nu = (r1 - row + ly - 1) / ly;   // rows left, >= 1
      P xv[U], dv[U], rv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nu) {
          xv[u] = ld_pack<T, VEC>(x + off + u * step);
          dv[u] = ld_pack<T, VEC>(dy + off + u * step);
          if (ADD) rv[u] = ld_pack<T, VEC>(r + off + u * step);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nu) {
          P o;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float xh =
                __fmul_rn(__fsub_rn(to_f<T>(xv[u].v[j]), mu[j]), rs[j]);
            const float d = mask_cm<RELU, ADD>(
                xh, g[j], b[j], ADD ? to_f<T>(rv[u].v[j]) : 0.f,
                to_f<T>(dv[u].v[j]));
            s1[j] += d;
            s2[j] = fmaf(d, xh, s2[j]);
            if (ADD) o.v[j] = from_f<T>(d);
          }
          if (ADD) st_pack<T, VEC>(dr + off + u * step, o);
        }
      }
    }
  }
  __shared__ float red[2][CM_THREADS * VEC];
  if (lane < ly) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[0][lane * width + v * VEC + j] = s1[j];
      red[1][lane * width + v * VEC + j] = s2[j];
    }
  }
  __syncthreads();
  const int q = threadIdx.x;             // channel of the tile
  const int c = blockIdx.x * width + q;
  if (q < width && c < C) {
    float a = 0.f, bb = 0.f;
    for (int k = 0; k < ly; ++k) {
      a += red[0][k * width + q];
      bb += red[1][k * width + q];
    }
    part[(size_t)blockIdx.y * C + c] = a;
    part[(size_t)(gridDim.y + blockIdx.y) * C + c] = bb;
  }
}

// One warp a channel: lane l adds chunks l, l + 32, ... in double,
// then the lanes meet in a fixed butterfly; coef as finalize_body.
template <typename T>
__global__ void bn_bwd_cm_finalize_kernel(const float* __restrict__ part,
                                          int chunks, int C, float n,
                                          const T* __restrict__ gamma,
                                          const float* __restrict__ rstd,
                                          float* __restrict__ dgamma,
                                          float* __restrict__ dbeta,
                                          float* __restrict__ coef) {
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;   // the whole warp
  double a = 0.0, b = 0.0;
  for (int k = lane; k < chunks; k += 32) {
    a += (double)part[(size_t)k * C + c];
    b += (double)part[(size_t)(chunks + k) * C + c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    const float db = (float)a, dg = (float)b;
    dbeta[c] = db;
    dgamma[c] = dg;
    coef[c] = __fmul_rn(to_f<T>(gamma[c]), rstd[c]);
    coef[C + c] = __fdiv_rn(db, n);
    coef[2 * C + c] = __fdiv_rn(dg, n);
  }
}

// Pass 2: dx over the same geometry, each thread's coefficients in
// registers; d is dr (with the add) or dy masked again from x.  Each
// lane walks its rows in the reverse of pass 1's order, so the rows
// pass 1 touched last (still in L2) come first (measured faster than
// the same order at ResNet-50's four timed shapes on the H100).
template <typename T, int VEC, bool RELU, bool ADD>
__global__ void __launch_bounds__(CM_THREADS, 2)
    bn_bwd_cm_apply_kernel(const T* __restrict__ x, const T* __restrict__ d_in,
                           const T* __restrict__ gamma,
                           const T* __restrict__ beta,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           const float* __restrict__ coef,
                           T* __restrict__ dx, int C, long long R,
                           long long per_chunk, int tv) {
  using P = Pack<T, VEC>;
  constexpr int U = cm_unroll<VEC>();
  const int ly = CM_THREADS / tv;
  const int lane = threadIdx.x / tv, v = threadIdx.x - lane * tv;
  const int c0 = (blockIdx.x * tv + v) * VEC;
  if (lane >= ly || c0 >= C) return;
  const long long r0 = (long long)blockIdx.y * per_chunk;
  const long long r1 = r0 + per_chunk < R ? r0 + per_chunk : R;
  if (r0 + lane >= r1) return;
  const long long n = (r1 - r0 - lane + ly - 1) / ly;   // this lane's rows
  float mu[VEC], rs[VEC], g[VEC], b[VEC], k0[VEC], k1[VEC], k2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = mean[c0 + j];
    rs[j] = rstd[c0 + j];
    g[j] = RELU && !ADD ? to_f<T>(gamma[c0 + j]) : 0.f;
    b[j] = RELU && !ADD ? to_f<T>(beta[c0 + j]) : 0.f;
    k0[j] = coef[c0 + j];
    k1[j] = coef[C + c0 + j];
    k2[j] = coef[2 * C + c0 + j];
  }
  const size_t first = (size_t)(r0 + lane) * C + c0;
  const size_t step = (size_t)ly * C;
  for (long long i = 0; i < n; i += U) {
    size_t off[U];
    P xv[U], dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u < n) {
        off[u] = first + (size_t)(n - 1 - (i + u)) * step;
        xv[u] = ld_pack<T, VEC>(x + off[u]);
        dv[u] = ld_pack<T, VEC>(d_in + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u < n) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh =
              __fmul_rn(__fsub_rn(to_f<T>(xv[u].v[j]), mu[j]), rs[j]);
          const float d = ADD ? to_f<T>(dv[u].v[j])
                              : mask_cm<RELU, false>(xh, g[j], b[j], 0.f,
                                                     to_f<T>(dv[u].v[j]));
          const float t = __fsub_rn(__fsub_rn(d, k1[j]), __fmul_rn(xh, k2[j]));
          o.v[j] = from_f<T>(__fmul_rn(k0[j], t));
        }
        st_pack<T, VEC>(dx + off[u], o);
      }
    }
  }
}

struct CmArgs {
  const void *x, *r, *dy, *g, *b, *mean, *rstd;
  void *dx, *dr, *dgamma, *dbeta, *work;
  long long R, per_chunk;
  int C, tv, chunks;
};

template <typename T, int VEC, bool RELU, bool ADD>
static int launch_cm(const CmArgs& a, cudaStream_t st) {
  float* part = (float*)a.work;
  float* coef = part + (size_t)2 * a.chunks * a.C;
  const T *x = (const T*)a.x, *g = (const T*)a.g, *b = (const T*)a.b;
  const float *mean = (const float*)a.mean, *rstd = (const float*)a.rstd;
  const int vpr = (a.C + VEC - 1) / VEC;        // accesses a row
  const dim3 grid((vpr + a.tv - 1) / a.tv, a.chunks);
  bn_bwd_cm_stats_kernel<T, VEC, RELU, ADD><<<grid, CM_THREADS, 0, st>>>(
      x, (const T*)a.r, (const T*)a.dy, g, b, mean, rstd, (T*)a.dr, part,
      a.C, a.R, a.per_chunk, a.tv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the reference divides by n = float(N * S), an f32 constant
  bn_bwd_cm_finalize_kernel<T><<<(a.C + 7) / 8, 256, 0, st>>>(
      part, a.chunks, a.C, (float)a.R, g, rstd, (float*)a.dgamma,
      (float*)a.dbeta, coef);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_bwd_cm_apply_kernel<T, VEC, RELU, ADD><<<grid, CM_THREADS, 0, st>>>(
      x, ADD ? (const T*)a.dr : (const T*)a.dy, g, b, mean, rstd, coef,
      (T*)a.dx, a.C, a.R, a.per_chunk, a.tv);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_cm_v(int relu, int add, const CmArgs& a,
                       cudaStream_t st) {
  if (relu && add) return launch_cm<T, VEC, true, true>(a, st);
  if (relu) return launch_cm<T, VEC, true, false>(a, st);
  if (add) return launch_cm<T, VEC, false, true>(a, st);
  return launch_cm<T, VEC, false, false>(a, st);
}

template <typename T>
static int launch_cm_t(int vec, int relu, int add, const CmArgs& a,
                       cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.r |
                           (uintptr_t)a.dy | (uintptr_t)a.dx |
                           (uintptr_t)a.dr;
    if (a.C % V != 0 || (ptrs & 15) != 0 || a.tv > CM_THREADS / V)
      return (int)cudaErrorInvalidValue;
    return launch_cm_v<T, V>(relu, add, a, st);
  }
  if (vec == 1) return launch_cm_v<T, 1>(relu, add, a, st);
  return (int)cudaErrorInvalidValue;
}

// (R, C) channels-minor.  vec: channels per access (16 bytes' worth, or
// 1); tv: accesses a channel tile spans (tv * vec <= 256); chunks of
// per_chunk rows.  work: f32, 2 * chunks * C partial sums then 3 * C
// coefficients.
extern "C" int mxt_bn_bwd_cm(const void* x, const void* r, const void* dy,
                             const void* g, const void* b, const void* mean,
                             const void* rstd, void* dx, void* dr,
                             void* dgamma, void* dbeta, void* work,
                             long long R, int C, int vec, int tv, int chunks,
                             long long per_chunk, int relu, int add,
                             int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R < 1 || C < 1 || tv < 1 || tv > CM_THREADS || chunks < 1 ||
      chunks > 65535 || per_chunk < 1 || per_chunk * chunks < R ||
      per_chunk * (chunks - 1) >= R ||
      (add && (r == nullptr || dr == nullptr)))
    return (int)cudaErrorInvalidValue;
  const CmArgs a{x,      r,     dy,   g, b,         mean, rstd, dx,
                 dr,     dgamma, dbeta, work, R, per_chunk, C,   tv,
                 chunks};
  if (dtype == MXT_F32) return launch_cm_t<float>(vec, relu, add, a, st);
  if (dtype == MXT_BF16)
    return launch_cm_t<__nv_bfloat16>(vec, relu, add, a, st);
  return (int)cudaErrorInvalidValue;
}
