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
//      chunk (per-thread f32 sums, then a fixed tree over the block)
//      into an f32 workspace part[2][chunks][C];
//   2. finalize: one thread per channel sums its chunks in a fixed
//      order (in double), writes mean and var, and scale and shift
//      into the workspace;
//   3. apply: y from x (and r) and the channel's scale and shift.
// No float atomics, so the result repeats bit for bit.  The elementwise
// ops round one at a time (__fmul_rn, __fadd_rn), in the plain
// version's order, so only the sums can differ from it.
//
// Bound on the H100: bytes.  A few flops per element against reading
// x (and r) and writing y: 3 tensor passes with the add, where the
// two-pass split moves 4 (x is read by both passes; a ResNet-50
// layer's x exceeds the 50 MB L2 many times over).
//
// Channels-major (bn_fwd_major_stats_kernel, bn_fwd_major_apply_kernel)
// walks the runs of S contiguous elements of one channel (common.cuh,
// "The channels-major BatchNorm walk"): a CTA a channel and a chunk of
// runs, 16-byte words where every pointer is 16-byte aligned (a run's
// partial head and tail words masked element by element), 4 words in
// flight a thread, scale and shift in registers.  The apply pass takes
// the CTAs and each thread's words in the reverse of the stats pass's
// order, so the words the stats pass read last, still in L2, come
// first.  kernels/batch_norm.py:_major_plan picks the vector width and
// the chunks.
//
// Channels-minor (bn_fwd_cm_stats_kernel, bn_fwd_cm_finalize_kernel,
// bn_fwd_cm_apply_kernel) takes the backward's geometry (common.cuh,
// "The channels-minor BatchNorm geometry"; kernels/batch_norm.py:
// _cm_plan): a thread owns 16 bytes of neighbouring channels (one
// channel where C or a pointer allows no vector), rows in lanes, four
// rows in flight a thread, the grid one wave of 2 CTAs an SM.  The
// stats pass keeps a thread's x and x^2 sums in registers and adds the
// CTA's row lanes through shared memory in lane order; the finalize
// gives each channel a warp; the apply pass keeps its channels' scale
// and shift in registers and walks each lane's rows backwards, so the
// rows the stats pass read last come from L2.  Offsets are 64-bit
// throughout.
#include "common.cuh"

// Pass 1 (channels-major): per (chunk, channel) partial sums of x and
// x^2, each thread over its slots in order, then major_sums' fixed
// order over the channel's threads
template <typename T, int VEC, bool PEEL>
__global__ void __launch_bounds__(MAJOR_THREADS, 2)
    bn_fwd_major_stats_kernel(const T* __restrict__ x,
                              float* __restrict__ part, long long N, int C,
                              long long S, int words, long long per_chunk,
                              int tc) {
  using P = Pack<T, VEC>;
  constexpr int U = major_unroll<VEC, PEEL>();
  const int g = threadIdx.x / tc, tid = threadIdx.x - g * tc;
  const int c = blockIdx.x * (MAJOR_THREADS / tc) + g, chunk = blockIdx.y;
  const long long n0 = (long long)chunk * per_chunk;
  const long long runs = N - n0 < per_chunk ? N - n0 : per_chunk;
  const long long items = c < C ? runs * words : 0, total = N * C * S;
  float s1 = 0.f, s2 = 0.f;
  MajorWalk<VEC, PEEL> wk(tid, tc, (n0 * C + c) * S, (long long)C * S, S,
                          words);
  for (long long t = tid; t < items; t += U * tc) {
    MajorWord wd[U];
    bool ok[U];
    P xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wd[u] = wk.word();
      ok[u] = t + u * tc < items && wd[u].lo < wd[u].hi;
      if (ok[u]) xv[u] = ld_word<T, VEC, PEEL>(x, wd[u], total);
      wk.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ok[u]) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (!PEEL || (j >= wd[u].lo && j < wd[u].hi)) {
            const float v = to_f<T>(xv[u].v[j]);
            s1 += v;
            s2 = fmaf(v, v, s2);
          }
        }
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

// Pass 3 (channels-major): y over the same walk, scale and shift in
// registers; the CTAs in the reverse of pass 1's order, each thread's
// slots backwards from its last
template <typename T, int VEC, bool PEEL, bool RELU, bool ADD>
__global__ void __launch_bounds__(MAJOR_THREADS, 2)
    bn_fwd_major_apply_kernel(const T* __restrict__ x,
                              const T* __restrict__ r,
                              const float* __restrict__ coef,
                              T* __restrict__ y, long long N, int C,
                              long long S, int words, long long per_chunk,
                              int tc) {
  using P = Pack<T, VEC>;
  constexpr int U = major_unroll<VEC, PEEL>();
  const long long bl = (long long)gridDim.x * gridDim.y - 1 -
                       ((long long)blockIdx.y * gridDim.x + blockIdx.x);
  const int g = threadIdx.x / tc, tid = threadIdx.x - g * tc;
  const int c = (int)(bl % gridDim.x) * (MAJOR_THREADS / tc) + g;
  const long long n0 = bl / gridDim.x * per_chunk;
  const long long runs = N - n0 < per_chunk ? N - n0 : per_chunk;
  const long long items = runs * words, total = N * C * S;
  if (c >= C || tid >= items) return;
  const long long last = tid + (items - 1 - tid) / tc * tc;
  const float sc = coef[c], sh = coef[C + c];
  MajorWalk<VEC, PEEL> wk(last, tc, (n0 * C + c) * S, (long long)C * S, S,
                          words);
  for (long long t = last; t >= 0; t -= U * tc) {
    MajorWord wd[U];
    bool ok[U];
    P xv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wd[u] = wk.word();
      ok[u] = t - u * tc >= 0 && wd[u].lo < wd[u].hi;
      if (ok[u]) {
        xv[u] = ld_word<T, VEC, PEEL>(x, wd[u], total);
        if (ADD) rv[u] = ld_word<T, VEC, PEEL>(r, wd[u], total);
      }
      wk.prev();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ok[u]) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float v = __fadd_rn(__fmul_rn(to_f<T>(xv[u].v[j]), sc), sh);
          if (ADD) v = __fadd_rn(v, to_f<T>(rv[u].v[j]));
          if (RELU) v = fmaxf(v, 0.f);
          o.v[j] = from_f<T>(v);
        }
        st_word<T, VEC, PEEL>(y, wd[u], o);
      }
    }
  }
}

// Pass 2 (channels-major): one thread a channel adds its chunks in
// order in double; mean, var, and scale and shift into coef
template <typename T>
__global__ void bn_fwd_finalize_kernel(const float* __restrict__ part,
                                       int chunks, int C, double n,
                                       const T* __restrict__ gamma,
                                       const T* __restrict__ beta, float eps,
                                       float* __restrict__ mean,
                                       float* __restrict__ var,
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

struct FwdArgs {
  const void *x, *r, *g, *b;
  void *y, *mean, *var, *work;
  long long A, S, per_chunk;
  int C, chunks;
  int words, tc;  // channels-major: word slots a run, threads a channel
  int tv;         // channels-minor: accesses a channel tile spans
  float eps;
};

template <typename T, int VEC, bool PEEL, bool RELU, bool ADD>
static int launch(const FwdArgs& a, cudaStream_t st) {
  float* part = (float*)a.work;
  float* coef = part + (size_t)2 * a.chunks * a.C;
  const int C = a.C;
  const int per_cta = MAJOR_THREADS / a.tc;  // 256 / tc channels a CTA
  const dim3 grid((C + per_cta - 1) / per_cta, a.chunks);
  bn_fwd_major_stats_kernel<T, VEC, PEEL><<<grid, MAJOR_THREADS, 0, st>>>(
      (const T*)a.x, part, a.A, C, a.S, a.words, a.per_chunk, a.tc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_fwd_finalize_kernel<T><<<(C + 127) / 128, 128, 0, st>>>(
      part, a.chunks, C, (double)(a.A * a.S), (const T*)a.g, (const T*)a.b,
      a.eps, (float*)a.mean, (float*)a.var, coef);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_fwd_major_apply_kernel<T, VEC, PEEL, RELU, ADD>
      <<<grid, MAJOR_THREADS, 0, st>>>((const T*)a.x, (const T*)a.r, coef,
                                       (T*)a.y, a.A, C, a.S, a.words,
                                       a.per_chunk, a.tc);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, bool PEEL>
static int launch_v(int relu, int add, const FwdArgs& a, cudaStream_t st) {
  if (relu && add) return launch<T, VEC, PEEL, true, true>(a, st);
  if (relu) return launch<T, VEC, PEEL, true, false>(a, st);
  if (add) return launch<T, VEC, PEEL, false, true>(a, st);
  return launch<T, VEC, PEEL, false, false>(a, st);
}

// vec: elements a channels-major word (16 bytes' worth where every
// pointer is 16-byte aligned, else 1), its runs peeled where S is not a
// multiple of it
template <typename T>
static int launch_t(int vec, int relu, int add, const FwdArgs& a,
                    cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == 1) return launch_v<T, 1, false>(relu, add, a, st);
  const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.r | (uintptr_t)a.y;
  if (vec != V || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
  if (a.S % V != 0) return launch_v<T, V, true>(relu, add, a, st);
  return launch_v<T, V, false>(relu, add, a, st);
}

// (N, C, S) channels-major.  vec: elements a word (16 bytes' worth, or
// 1); words: word slots a run (major_words(S, vec)); tc: threads a
// channel (32, 64, 128 or 256); chunks of per_chunk runs.  work: f32,
// 2 * chunks * C partial sums then 2 * C scale/shift
extern "C" int mxt_bn_fwd(const void* x, const void* r, const void* g,
                          const void* b, void* y, void* mean, void* var,
                          void* work, long long N, int C, long long S,
                          int vec, int words, int tc, int chunks,
                          long long per_chunk, float eps, int relu, int add,
                          int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || C < 1 || S < 1 || S > 0x7fffffffLL || chunks < 1 ||
      chunks > 65535 || per_chunk < 1 || per_chunk * chunks < N ||
      per_chunk * (chunks - 1) >= N || vec < 1 ||
      words != major_words(S, vec) ||
      (tc != 32 && tc != 64 && tc != 128 && tc != 256) ||
      (add && r == nullptr))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{x, r,         g, b,      y,     mean, var, work, N,
                  S, per_chunk, C, chunks, words, tc,   0,   eps};
  if (dtype == MXT_F32) return launch_t<float>(vec, relu, add, a, st);
  if (dtype == MXT_BF16)
    return launch_t<__nv_bfloat16>(vec, relu, add, a, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// channels-minor (R, C)
// ---------------------------------------------------------------------

// rows whose loads one thread of the forward issues together: one
// tensor a row in the stats pass, two with the add in the apply pass,
// so four rows keep 64 bytes (128 with the add) a thread in flight at
// VEC = 8, where the backward's three tensors hold it to two rows
constexpr int CM_FWD_UNROLL = 4;

// rows of row lane `lane` in its chunk [r0, r1): lane, lane + ly, ...
__device__ __forceinline__ long long cm_rows(long long r0, long long r1,
                                             int lane, int ly) {
  return r0 + lane < r1 ? (r1 - r0 - lane + ly - 1) / ly : 0;
}

// Pass 1 (channels-minor): per (chunk, channel) partial sums of x and
// x^2, each thread over its lane's rows in order, then the CTA's row
// lanes in lane order through shared memory
template <typename T, int VEC>
__global__ void __launch_bounds__(CM_THREADS, 2)
    bn_fwd_cm_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                           int C, long long R, long long per_chunk, int tv) {
  using P = Pack<T, VEC>;
  constexpr int U = CM_FWD_UNROLL;
  const int ly = CM_THREADS / tv, width = tv * VEC;
  const int lane = threadIdx.x / tv, v = threadIdx.x - lane * tv;
  const int c0 = (blockIdx.x * tv + v) * VEC;
  const long long r0 = (long long)blockIdx.y * per_chunk;
  const long long r1 = r0 + per_chunk < R ? r0 + per_chunk : R;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (lane < ly && c0 < C) {
    const long long n = cm_rows(r0, r1, lane, ly);
    const size_t step = (size_t)ly * C;
    size_t off = (size_t)(r0 + lane) * C + c0;
    for (long long i = 0; i < n; i += U, off += U * step) {
      P xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u < n) xv[u] = ld_pack<T, VEC>(x + off + u * step);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u < n) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float xf = to_f<T>(xv[u].v[j]);
            s1[j] += xf;
            s2[j] = fmaf(xf, xf, s2[j]);
          }
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
  const int q = threadIdx.x;  // channel of the tile
  const int c = blockIdx.x * width + q;
  if (q < width && c < C) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < ly; ++k) {
      a += red[0][k * width + q];
      b += red[1][k * width + q];
    }
    part[(size_t)blockIdx.y * C + c] = a;
    part[(size_t)(gridDim.y + blockIdx.y) * C + c] = b;
  }
}

// Pass 2 (channels-minor): one warp a channel; lane l adds chunks l,
// l + 32, ... in double, the lanes meet in a fixed butterfly, and lane
// 0 writes mean, var, scale and shift with bn_fwd_finalize_kernel's
// formulas and roundings
template <typename T>
__global__ void bn_fwd_cm_finalize_kernel(const float* __restrict__ part,
                                          int chunks, int C, double n,
                                          const T* __restrict__ gamma,
                                          const T* __restrict__ beta,
                                          float eps, float* __restrict__ mean,
                                          float* __restrict__ var,
                                          float* __restrict__ coef) {
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;  // the whole warp
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
}

// Pass 3 (channels-minor): y over the same geometry, the thread's
// scales and shifts in registers, each lane's rows in the reverse of
// pass 1's order; the element rounds one step at a time
template <typename T, int VEC, bool RELU, bool ADD>
__global__ void __launch_bounds__(CM_THREADS, 2)
    bn_fwd_cm_apply_kernel(const T* __restrict__ x, const T* __restrict__ r,
                           const float* __restrict__ coef,
                           T* __restrict__ y, int C, long long R,
                           long long per_chunk, int tv) {
  using P = Pack<T, VEC>;
  constexpr int U = CM_FWD_UNROLL;
  const int ly = CM_THREADS / tv;
  const int lane = threadIdx.x / tv, v = threadIdx.x - lane * tv;
  const int c0 = (blockIdx.x * tv + v) * VEC;
  if (lane >= ly || c0 >= C) return;
  const long long r0 = (long long)blockIdx.y * per_chunk;
  const long long r1 = r0 + per_chunk < R ? r0 + per_chunk : R;
  const long long n = cm_rows(r0, r1, lane, ly);
  if (n == 0) return;
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sc[j] = coef[c0 + j];
    sh[j] = coef[C + c0 + j];
  }
  const size_t step = (size_t)ly * C;
  // this lane's last row first
  size_t off = (size_t)(r0 + lane) * C + c0 + (size_t)(n - 1) * step;
  for (long long i = 0; i < n; i += U, off -= U * step) {
    P xv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u < n) {
        xv[u] = ld_pack<T, VEC>(x + off - u * step);
        if (ADD) rv[u] = ld_pack<T, VEC>(r + off - u * step);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u < n) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float t = __fadd_rn(__fmul_rn(to_f<T>(xv[u].v[j]), sc[j]), sh[j]);
          if (ADD) t = __fadd_rn(t, to_f<T>(rv[u].v[j]));
          if (RELU) t = fmaxf(t, 0.f);
          o.v[j] = from_f<T>(t);
        }
        st_pack<T, VEC>(y + off - u * step, o);
      }
    }
  }
}

template <typename T, int VEC, bool RELU, bool ADD>
static int launch_cm(const FwdArgs& a, cudaStream_t st) {
  float* part = (float*)a.work;
  float* coef = part + (size_t)2 * a.chunks * a.C;
  const int vpr = (a.C + VEC - 1) / VEC;  // accesses a row
  const dim3 grid((vpr + a.tv - 1) / a.tv, a.chunks);
  bn_fwd_cm_stats_kernel<T, VEC><<<grid, CM_THREADS, 0, st>>>(
      (const T*)a.x, part, a.C, a.A, a.per_chunk, a.tv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_fwd_cm_finalize_kernel<T><<<(a.C + 7) / 8, 256, 0, st>>>(
      part, a.chunks, a.C, (double)a.A, (const T*)a.g, (const T*)a.b, a.eps,
      (float*)a.mean, (float*)a.var, coef);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_fwd_cm_apply_kernel<T, VEC, RELU, ADD><<<grid, CM_THREADS, 0, st>>>(
      (const T*)a.x, (const T*)a.r, coef, (T*)a.y, a.C, a.A, a.per_chunk,
      a.tv);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_cm_v(int relu, int add, const FwdArgs& a,
                       cudaStream_t st) {
  if (relu && add) return launch_cm<T, VEC, true, true>(a, st);
  if (relu) return launch_cm<T, VEC, true, false>(a, st);
  if (add) return launch_cm<T, VEC, false, true>(a, st);
  return launch_cm<T, VEC, false, false>(a, st);
}

template <typename T>
static int launch_cm_t(int vec, int relu, int add, const FwdArgs& a,
                       cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.r | (uintptr_t)a.y;
    if (a.C % V != 0 || (ptrs & 15) != 0 || a.tv > CM_THREADS / V)
      return (int)cudaErrorInvalidValue;
    return launch_cm_v<T, V>(relu, add, a, st);
  }
  if (vec == 1) return launch_cm_v<T, 1>(relu, add, a, st);
  return (int)cudaErrorInvalidValue;
}

// (R, C) channels-minor.  vec: channels per access (16 bytes' worth, or
// 1); tv: accesses a channel tile spans (tv * vec <= 256); chunks of
// per_chunk rows.  work: as mxt_bn_fwd's
extern "C" int mxt_bn_fwd_cm(const void* x, const void* r, const void* g,
                             const void* b, void* y, void* mean, void* var,
                             void* work, long long R, int C, int vec, int tv,
                             int chunks, long long per_chunk, float eps,
                             int relu, int add, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R < 1 || C < 1 || tv < 1 || tv > CM_THREADS || chunks < 1 ||
      chunks > 65535 || per_chunk < 1 || per_chunk * chunks < R ||
      per_chunk * (chunks - 1) >= R || (add && r == nullptr))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{x, r,         g, b,      y, mean, var, work, R,
                  1, per_chunk, C, chunks, 0, 0,    tv,  eps};
  if (dtype == MXT_F32) return launch_cm_t<float>(vec, relu, add, a, st);
  if (dtype == MXT_BF16)
    return launch_cm_t<__nv_bfloat16>(vec, relu, add, a, st);
  return (int)cudaErrorInvalidValue;
}
