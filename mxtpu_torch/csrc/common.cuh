// Shared helpers of the mxtpu_torch kernels: dtype conversion,
// warp/block reductions and the dropout mask's threefry2x32.  Each kernel source is compiled on its own
// with nvcc (plain C interface, loaded with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers
enum { MXT_F32 = 0, MXT_BF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// VEC consecutive elements of T in one access: 16 bytes (one LDG.128 /
// STG.128) where VEC * sizeof(T) == 16, a scalar access where VEC == 1.
// The address must be aligned to the pack's size.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> ld_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void st_pack(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// value rounded to T and back: what a cast to the input type keeps
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of v over the block; every thread gets the same value.  `red`
// holds one float per warp.  Starts with a barrier so a previous
// call's readers are done with `red`.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

// bar.sync on named barrier `id` (1-15; 0 is __syncthreads) for
// `threads` threads, a multiple of 32: a row group's own exchange
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The sum of v over the WPR warps of a row group (the forward row
// kernels of LayerNorm and of the fused residual LayerNorm; red holds
// two rows of a float a warp of the CTA): warp shuffles, then (WPR > 1)
// one exchange through red[parity] under the group's own named barrier;
// parity flips with each exchange, so a warp that runs ahead into the
// next exchange never overwrites a value still read
template <int WPR, int W>
__device__ __forceinline__ float group_sum(float v, float (*red)[W],
                                           int& parity, int warp, int lane,
                                           int group) {
  v = warp_sum(v);
  if (WPR > 1) {
    if (lane == 0) red[parity][warp] = v;
    bar_sync(1 + group, WPR * 32);
    v = 0.f;
#pragma unroll
    for (int w = group * WPR; w < (group + 1) * WPR; ++w) v += red[parity][w];
    parity ^= 1;
  }
  return v;
}

// p[0, VEC) = v (first) or p + v, in 16-byte accesses where VEC >= 4
// (p is then 16-byte aligned: C is a multiple of VEC); a CTA's partial
// row of parameter gradients in device memory (the wide LayerNorm
// backwards)
template <int VEC>
__device__ __forceinline__ void add_row(float* p, const float* v,
                                        bool first) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      float4* q = reinterpret_cast<float4*>(p + j);
      float4 a = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *q;
      a.x += v[j];
      a.y += v[j + 1];
      a.z += v[j + 2];
      a.w += v[j + 3];
      *q = a;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = first ? v[j] : p[j] + v[j];
  }
}

// ---------------------------------------------------------------------
// The channels-minor BatchNorm geometry (csrc/batch_norm.cu and
// csrc/batch_norm_bwd.cu, bn_*_cm_*_kernel), the same in every pass: a
// grid of (channel tiles, row chunks), CTAs of CM_THREADS.  Thread t
// owns the VEC consecutive channels c0 = (tile * tv + t % tv) * VEC and
// row lane t / tv of ly = CM_THREADS / tv, and walks rows r0 + lane,
// r0 + lane + ly, ... of its chunk (a stats pass in that order, an
// apply pass backwards).  VEC is 16 bytes of T (8 bf16, 4 f32) where C
// and every pointer allow it, else 1; a tile is up to 256 channels, so
// a warp reads 32 * 16 contiguous bytes of a row, or several whole rows
// where C is narrow.  kernels/batch_norm.py:_cm_plan picks tv and the
// chunks.
constexpr int CM_THREADS = 256;

// rows whose loads one thread of the backward issues together: 16
// bytes a tensor and row (at VEC = 8 two rows already keep 96 bytes a
// thread in flight)
template <int VEC>
__host__ __device__ constexpr int cm_unroll() {
  return VEC >= 8 ? 2 : 4;
}

// ---------------------------------------------------------------------
// The channels-major BatchNorm walk (csrc/batch_norm.cu and
// csrc/batch_norm_bwd.cu, bn_*_major_*_kernel).  x is viewed as (N, C,
// S); run (n, c) is the S contiguous elements from (n * C + c) * S.  A
// CTA of MAJOR_THREADS owns 256 / tc channels, tc threads each (tc a
// power of two from 32 to 256), and a chunk of runs.  A channel's
// threads read its runs as words of VEC elements on VEC-aligned
// addresses: `words` slots a run (the most words any run of the tensor
// touches), thread t taking slots t, t + tc, ... of the chunk's runs in
// order.  Where S is a multiple of VEC every run starts on a word and
// every word is full.  Where it is not (PEEL) runs start on multiples
// of gcd(S, VEC) elements: a word the run covers only in part (its head
// or its tail) is loaded whole where it lies inside the tensor and used
// element by element, and stored element by element, and a slot past a
// run's last word is empty.  kernels/batch_norm.py:_major_plan mirrors
// it.
constexpr int MAJOR_THREADS = 256;

// words of vec elements that a run of S elements touches at most: runs
// start on multiples of gcd(S, vec) elements past a vec boundary
inline long long major_words(long long S, int vec) {
  long long a = S, b = vec;
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return (vec - a + S - 1) / vec + 1;
}

// slots a thread issues together: one 16-byte word a tensor and slot
// (two on the peeled 8-element path, whose masks take registers),
// eight elements on the scalar path
template <int VEC, bool PEEL>
__host__ __device__ constexpr int major_unroll() {
  return VEC == 1 ? 8 : PEEL && VEC >= 8 ? 2 : 4;
}

// one word of a run: its first element e0 and the run's part of it,
// elements [lo, hi) (empty where hi <= lo)
struct MajorWord {
  long long e0;
  int lo, hi;
};

// A thread's slot (run i, word w) of its channel's chunk, kept as the
// run's first element and w, and the slot tc after (next) or before
// (prev) it, by increments.
template <int VEC, bool PEEL>
struct MajorWalk {
  long long start;  // first element of the slot's run
  int w;            // the slot's word in its run
  const int words, dw;
  const long long dstart, CS, S;

  __device__ __forceinline__ MajorWalk(long long t, int tc, long long start0,
                                       long long CS_, long long S_,
                                       int words_)
      : words(words_), dw(tc % words_), dstart((long long)(tc / words_) * CS_),
        CS(CS_), S(S_) {
    const long long i = t / words_;
    w = (int)(t - i * words_);
    start = start0 + i * CS_;
  }
  __device__ __forceinline__ MajorWord word() const {
    if (!PEEL) return {start + (long long)w * VEC, 0, VEC};
    const long long e0 =
        ((long long)((unsigned long long)start / VEC) + w) * VEC;
    const long long d = start - e0;  // > 0 only in a run's first word
    return {e0, d > 0 ? (int)d : 0, d + S < VEC ? (int)(d + S) : VEC};
  }
  __device__ __forceinline__ void next() {
    w += dw;
    start += dstart;
    if (w >= words) {
      w -= words;
      start += CS;
    }
  }
  __device__ __forceinline__ void prev() {
    w -= dw;
    start -= dstart;
    if (w < 0) {
      w += words;
      start -= CS;
    }
  }
};

// the word's VEC elements: one 16-byte load where the word lies inside
// the tensor's `total` elements, else the run's elements one by one
template <typename T, int VEC, bool PEEL>
__device__ __forceinline__ Pack<T, VEC> ld_word(const T* __restrict__ p,
                                                const MajorWord& wd,
                                                long long total) {
  if (!PEEL || wd.e0 + VEC <= total) return ld_pack<T, VEC>(p + wd.e0);
  Pack<T, VEC> v;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    v.v[j] = j >= wd.lo && j < wd.hi ? p[wd.e0 + j] : from_f<T>(0.f);
  return v;
}

// the run's elements of the word: one 16-byte store where it covers
// the whole word, else one store an element
template <typename T, int VEC, bool PEEL>
__device__ __forceinline__ void st_word(T* __restrict__ p,
                                        const MajorWord& wd,
                                        const Pack<T, VEC>& v) {
  if (!PEEL || (wd.lo == 0 && wd.hi == VEC)) {
    st_pack<T, VEC>(p + wd.e0, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j >= wd.lo && j < wd.hi) p[wd.e0 + j] = v.v[j];
}

// The channel sums of a CTA of the walk: each warp's xor butterfly,
// then the channel's tc / 32 warps added in order (block_sum's order
// where tc = 256); thread g < 256 / tc gets channel g's two sums.
__device__ __forceinline__ void major_sums(float& s1, float& s2, int tc,
                                           float (*red)[MAJOR_THREADS / 32]) {
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = s1;
    red[1][threadIdx.x >> 5] = s2;
  }
  __syncthreads();
  const int wpc = tc >> 5;
  s1 = s2 = 0.f;
  if (threadIdx.x < MAJOR_THREADS / tc) {
    for (int k = 0; k < wpc; ++k) {
      s1 += red[0][threadIdx.x * wpc + k];
      s2 += red[1][threadIdx.x * wpc + k];
    }
  }
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, second counter word 0: returns the first
// output word, as mxtpu's _mask_bits does.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t ctr) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = ctr + ks[0];
  uint32_t x1 = ks[1];
#pragma unroll
  for (int grp = 0; grp < 5; ++grp) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[grp & 1][i]);
      x1 ^= x0;
    }
    x0 += ks[(grp + 1) % 3];
    x1 += ks[(grp + 2) % 3] + (uint32_t)(grp + 1);
  }
  return x0;
}

// ---------------------------------------------------------------------
// The keep bits of the wide fused residual LayerNorm kernels
// (frln_fwd_wide_kernel, frln_bwd_wide_kernel): a CTA of
// FRLN_WIDE_THREADS takes a row, thread t the VEC columns
// (k * FRLN_WIDE_THREADS + t) * VEC + j of it, k = 0, 1, ...  The first
// pass draws the mask once; the keep bits of slot k, warp w and element
// j are the 32 lanes' bits of word (k * FRLN_WIDE_WARPS + w) * VEC + j,
// kept in a row of device memory a CTA (C / 8 bytes, 16 KB at
// C = 131072, which L1 and L2 hold).  kernels/layer_norm.py:_frln_words
// and _mask_scratch mirror it.
constexpr int FRLN_WIDE_THREADS = 512;
constexpr int FRLN_WIDE_WARPS = FRLN_WIDE_THREADS / 32;

// words of keep bits a row: VEC words a warp and slot
template <int VEC>
inline int frln_words(int C) {
  const int step = FRLN_WIDE_THREADS * VEC;
  return (C + step - 1) / step * FRLN_WIDE_WARPS * VEC;
}

// Draw the keep bits of a lane's VEC elements from counter ctr0 (its
// first element's) with one ballot an element into w[0, VEC) (every
// lane's registers, which the drawing pass reads) and its warp's words
// kw[0, VEC) (lane j stores word j, which the later passes read after a
// __syncthreads); `in` is false for a lane past the row, whose bits are
// 0.  Every lane of the warp calls it.
template <int VEC>
__device__ __forceinline__ void frln_draw_bits(uint32_t* kw, uint32_t* w,
                                               bool in, uint32_t ctr0,
                                               int lane, uint32_t k0,
                                               uint32_t k1, uint32_t thresh) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const bool kept =
        in && threefry_bits(k0, k1, ctr0 + (uint32_t)j) < thresh;
    w[j] = __ballot_sync(0xffffffffu, kept);
    if (lane == j) kw[j] = w[j];
  }
}
