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
// the chunks.  Channels-minor CTAs put the 32 lanes of a warp on 32
// neighbouring channels, so each warp reads whole row segments, split
// the rows into chunks, and apply y in a grid-stride pass with scalar
// loads.  Offsets are 64-bit throughout.
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
__global__ void bn_fwd_cm_apply_kernel(const T* x, const T* r,
                                       const float* coef, T* y,
                                       long long total, int C) {
  apply_body<T, RELU, ADD>(x, r, coef, y, total, C, 1);
}

struct FwdArgs {
  const void *x, *r, *g, *b;
  void *y, *mean, *var, *work;
  long long A, S, per_chunk;
  int C, chunks;
  int words, tc;     // channels-major only
  int apply_blocks;  // channels-minor only
  float eps;
};

template <typename T, int VEC, bool PEEL, bool RELU, bool ADD>
static int launch(bool cm, const FwdArgs& a, cudaStream_t st) {
  float* part = (float*)a.work;
  float* coef = part + (size_t)2 * a.chunks * a.C;
  const long long M = a.A * a.S;  // elements per channel
  const int C = a.C;
  // channels-major: 256 / tc channels a CTA
  const int per_cta = MAJOR_THREADS / a.tc;
  const dim3 grid((C + per_cta - 1) / per_cta, a.chunks);
  if (cm) {
    bn_fwd_cm_stats_kernel<T><<<dim3((C + 31) / 32, a.chunks), dim3(32, 8),
                                0, st>>>((const T*)a.x, part, C, a.A,
                                         a.per_chunk, a.chunks);
  } else {
    bn_fwd_major_stats_kernel<T, VEC, PEEL><<<grid, MAJOR_THREADS, 0, st>>>(
        (const T*)a.x, part, a.A, C, a.S, a.words, a.per_chunk, a.tc);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int fb = (C + 127) / 128;
  if (cm) {
    bn_fwd_cm_finalize_kernel<T><<<fb, 128, 0, st>>>(
        part, a.chunks, C, (double)M, (const T*)a.g, (const T*)a.b, a.eps,
        (float*)a.mean, (float*)a.var, coef);
  } else {
    bn_fwd_finalize_kernel<T><<<fb, 128, 0, st>>>(
        part, a.chunks, C, (double)M, (const T*)a.g, (const T*)a.b, a.eps,
        (float*)a.mean, (float*)a.var, coef);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (cm) {
    bn_fwd_cm_apply_kernel<T, RELU, ADD><<<a.apply_blocks, 256, 0, st>>>(
        (const T*)a.x, (const T*)a.r, coef, (T*)a.y, M * C, C);
  } else {
    bn_fwd_major_apply_kernel<T, VEC, PEEL, RELU, ADD>
        <<<grid, MAJOR_THREADS, 0, st>>>((const T*)a.x, (const T*)a.r, coef,
                                         (T*)a.y, a.A, C, a.S, a.words,
                                         a.per_chunk, a.tc);
  }
  return (int)cudaGetLastError();
}

template <typename T, int VEC, bool PEEL>
static int launch_v(bool cm, int relu, int add, const FwdArgs& a,
                    cudaStream_t st) {
  if (relu && add) return launch<T, VEC, PEEL, true, true>(cm, a, st);
  if (relu) return launch<T, VEC, PEEL, true, false>(cm, a, st);
  if (add) return launch<T, VEC, PEEL, false, true>(cm, a, st);
  return launch<T, VEC, PEEL, false, false>(cm, a, st);
}

// vec: elements a channels-major word (16 bytes' worth where every
// pointer is 16-byte aligned, else 1), its runs peeled where S is not a
// multiple of it; the channels-minor kernels take vec = 1
template <typename T>
static int launch_t(bool cm, int vec, int relu, int add, const FwdArgs& a,
                    cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec == 1) return launch_v<T, 1, false>(cm, relu, add, a, st);
  const uintptr_t ptrs = (uintptr_t)a.x | (uintptr_t)a.r | (uintptr_t)a.y;
  if (cm || vec != V || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
  if (a.S % V != 0) return launch_v<T, V, true>(cm, relu, add, a, st);
  return launch_v<T, V, false>(cm, relu, add, a, st);
}

static int entry(bool cm, int vec, int relu, int add, int dtype,
                 const FwdArgs& a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a.A < 1 || a.C < 1 || a.S < 1 || a.chunks < 1 || a.chunks > 65535 ||
      a.per_chunk < 1 || (add && a.r == nullptr))
    return (int)cudaErrorInvalidValue;
  if (cm ? a.S != 1 || a.apply_blocks < 1
         : a.per_chunk * a.chunks < a.A ||
               a.per_chunk * (a.chunks - 1) >= a.A || vec < 1 ||
               a.S > 0x7fffffffLL || a.words != major_words(a.S, vec) ||
               (a.tc != 32 && a.tc != 64 && a.tc != 128 && a.tc != 256))
    return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32) return launch_t<float>(cm, vec, relu, add, a, st);
  if (dtype == MXT_BF16)
    return launch_t<__nv_bfloat16>(cm, vec, relu, add, a, st);
  return (int)cudaErrorInvalidValue;
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
  const FwdArgs a{x, r,      g, b,     y,     mean, var, work, N,
                  S, per_chunk, C, chunks, words, tc, 0, eps};
  return entry(false, vec, relu, add, dtype, a, stream);
}

// (R, C) channels-minor: chunks of per_chunk rows, apply_blocks blocks of
// the elementwise pass.  work: as mxt_bn_fwd's
extern "C" int mxt_bn_fwd_cm(const void* x, const void* r, const void* g,
                             const void* b, void* y, void* mean, void* var,
                             void* work, long long R, int C, long long S,
                             int chunks, long long per_chunk,
                             int apply_blocks, float eps, int relu, int add,
                             int dtype, void* stream) {
  const FwdArgs a{x, r,         g, b,      y, mean, var, work, R,
                  S, per_chunk, C, chunks, 0, 256,  apply_blocks, eps};
  return entry(true, 1, relu, add, dtype, a, stream);
}
