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
// pass for dx.  No float atomics: bit-for-bit repeatable.  The
// elementwise ops round one at a time in the plain version's order, so
// the recomputed mask is the plain version's exactly and only the sums
// can differ from it.
//
// Bound on the H100: bytes -- x and dy (and r) read, dx (and dr)
// written, 5 tensor passes with the add.  Both views use 16-byte vector
// accesses where the pointers allow, several words in flight a thread,
// the per-channel values in registers, and with the add the stats pass
// writes dr, so the apply pass reads x and dr only: 7 passes where the
// bound has 5 (3 without the add: 5 passes).  A ResNet-50 layer's x, dy
// and r exceed the 50 MB L2 many times over, so no two-pass design
// reads them once; each apply pass walks its data in the reverse of the
// stats pass's order, so what the stats pass read last comes from L2.
//
// Channels-major (bn_bwd_major_stats_kernel, bn_bwd_finalize_kernel,
// bn_bwd_major_apply_kernel): the runs of S contiguous elements of one
// channel, a CTA a channel and a chunk of runs (common.cuh, "The
// channels-major BatchNorm walk"; kernels/batch_norm.py:_major_plan).
// Channels-minor (bn_bwd_cm_*, below): a thread a channel group of 16
// bytes, rows in lanes (kernels/batch_norm.py:_cm_plan).
#include "common.cuh"

// dy masked by the recomputed pre-activation sign, rounded one step at
// a time as the plain version does
template <bool RELU, bool ADD>
__device__ __forceinline__ float masked(float xh, float g, float b, float r,
                                        float d) {
  if (RELU) {
    float a = __fadd_rn(__fmul_rn(xh, g), b);
    if (ADD) a = __fadd_rn(a, r);
    if (!(a > 0.f)) d = 0.f;
  }
  return d;
}

// Pass 1 (channels-major): per (chunk, channel) partial sums of dy' and
// dy' * xhat, each thread over its slots in order, then major_sums'
// fixed order over the channel's threads; with the add it also writes
// dr = dy' (exact: masking rounds nothing), so pass 3 reads x and dr
// and neither dy nor r.
template <typename T, int VEC, bool PEEL, bool RELU, bool ADD>
__global__ void __launch_bounds__(MAJOR_THREADS, 2)
    bn_bwd_major_stats_kernel(const T* __restrict__ x,
                              const T* __restrict__ r,
                              const T* __restrict__ dy,
                              const T* __restrict__ gamma,
                              const T* __restrict__ beta,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              T* __restrict__ dr, float* __restrict__ part,
                              long long N, int C, long long S, int words,
                              long long per_chunk, int tc) {
  using P = Pack<T, VEC>;
  // three tensors a slot with the add: 8-element words keep 3 slots in
  // flight, 4 spill (ptxas) under the 128 registers of 2 CTAs an SM
  constexpr int U = ADD && VEC >= 8 && !PEEL ? 3 : major_unroll<VEC, PEEL>();
  const int gi = threadIdx.x / tc, tid = threadIdx.x - gi * tc;
  const int c = blockIdx.x * (MAJOR_THREADS / tc) + gi, chunk = blockIdx.y;
  const long long n0 = (long long)chunk * per_chunk;
  const long long runs = N - n0 < per_chunk ? N - n0 : per_chunk;
  const long long items = c < C ? runs * words : 0, total = N * C * S;
  const int cl = c < C ? c : C - 1;  // a channel to read for idle threads
  const float mu = mean[cl], rs = rstd[cl];
  const float g = RELU ? to_f<T>(gamma[cl]) : 0.f;
  const float b = RELU ? to_f<T>(beta[cl]) : 0.f;
  float s1 = 0.f, s2 = 0.f;
  MajorWalk<VEC, PEEL> wk(tid, tc, (n0 * C + c) * S, (long long)C * S, S,
                          words);
  for (long long t = tid; t < items; t += U * tc) {
    MajorWord wd[U];
    bool ok[U];
    P xv[U], dv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wd[u] = wk.word();
      ok[u] = t + u * tc < items && wd[u].lo < wd[u].hi;
      if (ok[u]) {
        xv[u] = ld_word<T, VEC, PEEL>(x, wd[u], total);
        dv[u] = ld_word<T, VEC, PEEL>(dy, wd[u], total);
        if (ADD) rv[u] = ld_word<T, VEC, PEEL>(r, wd[u], total);
      }
      wk.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ok[u]) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh =
              __fmul_rn(__fsub_rn(to_f<T>(xv[u].v[j]), mu), rs);
          const float d = masked<RELU, ADD>(
              xh, g, b, ADD ? to_f<T>(rv[u].v[j]) : 0.f,
              to_f<T>(dv[u].v[j]));
          if (!PEEL || (j >= wd[u].lo && j < wd[u].hi)) {
            s1 += d;
            s2 = fmaf(d, xh, s2);
          }
          if (ADD) o.v[j] = from_f<T>(d);
        }
        if (ADD) st_word<T, VEC, PEEL>(dr, wd[u], o);
      }
    }
  }
  __shared__ float red[2][MAJOR_THREADS / 32];
  major_sums(s1, s2, tc, red);
  const int cc = blockIdx.x * (MAJOR_THREADS / tc) + threadIdx.x;
  if (threadIdx.x < MAJOR_THREADS / tc && cc < C) {
    part[(size_t)chunk * C + cc] = s1;
    part[(size_t)(gridDim.y + chunk) * C + cc] = s2;
  }
}

// coef: [3][C] = g * rstd, dbeta / n, dgamma / n; one thread a channel
// adds its chunks in order in double
template <typename T>
__global__ void bn_bwd_finalize_kernel(const float* __restrict__ part,
                                       int chunks, int C, float n,
                                       const T* __restrict__ gamma,
                                       const float* __restrict__ rstd,
                                       float* __restrict__ dgamma,
                                       float* __restrict__ dbeta,
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

// Pass 3 (channels-major): dx over the same walk, the channel's values
// in registers; d is dr (with the add) or dy masked again from x.  The
// CTAs in the reverse of pass 1's order, each thread's slots backwards
// from its last.
template <typename T, int VEC, bool PEEL, bool RELU, bool ADD>
__global__ void __launch_bounds__(MAJOR_THREADS, 2)
    bn_bwd_major_apply_kernel(const T* __restrict__ x,
                              const T* __restrict__ d_in,
                              const T* __restrict__ gamma,
                              const T* __restrict__ beta,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const float* __restrict__ coef,
                              T* __restrict__ dx, long long N, int C,
                              long long S, int words, long long per_chunk,
                              int tc) {
  using P = Pack<T, VEC>;
  constexpr int U = major_unroll<VEC, PEEL>();
  const long long bl = (long long)gridDim.x * gridDim.y - 1 -
                       ((long long)blockIdx.y * gridDim.x + blockIdx.x);
  const int gi = threadIdx.x / tc, tid = threadIdx.x - gi * tc;
  const int c = (int)(bl % gridDim.x) * (MAJOR_THREADS / tc) + gi;
  const long long n0 = bl / gridDim.x * per_chunk;
  const long long runs = N - n0 < per_chunk ? N - n0 : per_chunk;
  const long long items = runs * words, total = N * C * S;
  if (c >= C || tid >= items) return;
  const long long last = tid + (items - 1 - tid) / tc * tc;
  const float mu = mean[c], rs = rstd[c];
  const float g = RELU && !ADD ? to_f<T>(gamma[c]) : 0.f;
  const float b = RELU && !ADD ? to_f<T>(beta[c]) : 0.f;
  const float k0 = coef[c], k1 = coef[C + c], k2 = coef[2 * C + c];
  MajorWalk<VEC, PEEL> wk(last, tc, (n0 * C + c) * S, (long long)C * S, S,
                          words);
  for (long long t = last; t >= 0; t -= U * tc) {
    MajorWord wd[U];
    bool ok[U];
    P xv[U], dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wd[u] = wk.word();
      ok[u] = t - u * tc >= 0 && wd[u].lo < wd[u].hi;
      if (ok[u]) {
        xv[u] = ld_word<T, VEC, PEEL>(x, wd[u], total);
        dv[u] = ld_word<T, VEC, PEEL>(d_in, wd[u], total);
      }
      wk.prev();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ok[u]) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh =
              __fmul_rn(__fsub_rn(to_f<T>(xv[u].v[j]), mu), rs);
          const float d = ADD ? to_f<T>(dv[u].v[j])
                              : masked<RELU, false>(xh, g, b, 0.f,
                                                    to_f<T>(dv[u].v[j]));
          const float t3 = __fsub_rn(__fsub_rn(d, k1), __fmul_rn(xh, k2));
          o.v[j] = from_f<T>(__fmul_rn(k0, t3));
        }
        st_word<T, VEC, PEEL>(dx, wd[u], o);
      }
    }
  }
}

struct BwdArgs {
  const void *x, *r, *dy, *g, *b, *mean, *rstd;
  void *dx, *dr, *dgamma, *dbeta, *work;
  long long N, S, per_chunk;
  int C, chunks, words, tc;
};

template <typename T, int VEC, bool PEEL, bool RELU, bool ADD>
static int launch(const BwdArgs& a, cudaStream_t st) {
  float* part = (float*)a.work;
  float* coef = part + (size_t)2 * a.chunks * a.C;
  const T *x = (const T*)a.x, *g = (const T*)a.g, *b = (const T*)a.b;
  const float *mean = (const float*)a.mean, *rstd = (const float*)a.rstd;
  const int per_cta = MAJOR_THREADS / a.tc;  // channels a CTA
  const dim3 grid((a.C + per_cta - 1) / per_cta, a.chunks);
  bn_bwd_major_stats_kernel<T, VEC, PEEL, RELU, ADD>
      <<<grid, MAJOR_THREADS, 0, st>>>(x, (const T*)a.r, (const T*)a.dy, g,
                                       b, mean, rstd, (T*)a.dr, part, a.N,
                                       a.C, a.S, a.words, a.per_chunk, a.tc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the reference divides by n = float(N * S), an f32 constant
  bn_bwd_finalize_kernel<T><<<(a.C + 127) / 128, 128, 0, st>>>(
      part, a.chunks, a.C, (float)(a.N * a.S), g, rstd, (float*)a.dgamma,
      (float*)a.dbeta, coef);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_bwd_major_apply_kernel<T, VEC, PEEL, RELU, ADD>
      <<<grid, MAJOR_THREADS, 0, st>>>(
          x, ADD ? (const T*)a.dr : (const T*)a.dy, g, b, mean, rstd, coef,
          (T*)a.dx, a.N, a.C, a.S, a.words, a.per_chunk, a.tc);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, bool PEEL>
static int launch_v(int relu, int add, const BwdArgs& a, cudaStream_t st) {
  if (relu && add) return launch<T, VEC, PEEL, true, true>(a, st);
  if (relu) return launch<T, VEC, PEEL, true, false>(a, st);
  if (add) return launch<T, VEC, PEEL, false, true>(a, st);
  return launch<T, VEC, PEEL, false, false>(a, st);
}

// vec: elements a word (16 bytes' worth where every pointer is 16-byte
// aligned, else 1), its runs peeled where S is not a multiple of it
template <typename T>
static int launch_t(int vec, int relu, int add, const BwdArgs& a,
                    cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == 1) return launch_v<T, 1, false>(relu, add, a, st);
  const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.r | (uintptr_t)a.dy |
                         (uintptr_t)a.dx | (uintptr_t)a.dr;
  if (vec != V || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
  if (a.S % V != 0) return launch_v<T, V, true>(relu, add, a, st);
  return launch_v<T, V, false>(relu, add, a, st);
}

// (N, C, S) channels-major.  vec: elements a word (16 bytes' worth, or
// 1); words: word slots a run (major_words(S, vec)); tc: threads a
// channel (32, 64, 128 or 256); chunks of per_chunk runs.  work: f32,
// 2 * chunks * C partial sums then 3 * C coefficients
extern "C" int mxt_bn_bwd(const void* x, const void* r, const void* dy,
                          const void* g, const void* b, const void* mean,
                          const void* rstd, void* dx, void* dr, void* dgamma,
                          void* dbeta, void* work, long long N, int C,
                          long long S, int vec, int words, int tc,
                          int chunks, long long per_chunk, int relu, int add,
                          int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || C < 1 || S < 1 || S > 0x7fffffffLL || vec < 1 ||
      chunks < 1 || chunks > 65535 || per_chunk < 1 ||
      per_chunk * chunks < N || per_chunk * (chunks - 1) >= N ||
      words != major_words(S, vec) ||
      (tc != 32 && tc != 64 && tc != 128 && tc != 256) ||
      (add && (r == nullptr || dr == nullptr)))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x,    r,     dy,   g, b, mean,      rstd,   dx,    dr,
                  dgamma, dbeta, work, N, S, per_chunk, C,      chunks,
                  words, tc};
  if (dtype == MXT_F32) return launch_t<float>(vec, relu, add, a, st);
  if (dtype == MXT_BF16) return launch_t<__nv_bfloat16>(vec, relu, add, a, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// channels-minor (R, C): bn_bwd_cm_stats_kernel, bn_bwd_cm_finalize_kernel,
// bn_bwd_cm_apply_kernel, over the geometry of common.cuh ("The
// channels-minor BatchNorm geometry")
// ---------------------------------------------------------------------

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
            const float d = masked<RELU, ADD>(
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
// then the lanes meet in a fixed butterfly; coef as
// bn_bwd_finalize_kernel.
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
                              : masked<RELU, false>(xh, g[j], b[j], 0.f,
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
