// Flash attention backward: two kernels, dq and dk/dv.
// q, dO: (BH, Tq, D); k, v: (BH, Tk, D) row-major, f32 or bf16; lse and
// delta = rowsum(dO * O): (BH, Tq) f32.  Outputs dq (BH, Tq, D) and dk,
// dv (BH, Tk, D) in the input type.
//
// Replaces mxtpu/kernels/flash_attention.py:_flash_backward, i.e.
// _fa_dq_kernel (kv innermost) and _fa_dkv_kernel (q innermost).  The
// TPU kernels carry their f32 sums in VMEM scratch across a sequential
// grid axis; here one CTA owns a tile of rows and loops over the other
// axis itself, with the sums in registers:
//   dq kernel:   one CTA per (bh, 32 query rows), loop over 32-key tiles;
//   dk/dv kernel: one CTA per (bh, 32 keys), loop over 32-row q tiles.
// Each output element is summed by one thread in a fixed order, so both
// kernels are deterministic and need no atomics.
//
// Per (query i, key j), all in f32 (no TF32; the reference casts dO and
// the inputs to f32 too, and unlike the forward never rounds p):
//   s = (q_i . k_j) * scale,  p = exp(s - lse_i),
//   dp = dO_i . v_j,          ds = p * (dp - delta_i) * scale,
//   dq_i += ds * k_j,  dk_j += ds * q_i,  dv_j += p * dO_i.
// A masked pair (key past Tk, or j > i + diag when causal) has p = 0,
// which is what exp(-1e30 - lse) gives in the reference; a row with no
// visible key (lse = +1e30) has p = 0 everywhere, so nothing NaN or inf
// can arise.  Tiles wholly above the diagonal are skipped with the
// reference's test  j*bk <= i*bq + diag + bq - 1.
//
// Layout.  dq kernel: 4 warps of 8 query rows; lane j scores key j of
// the tile against the warp's rows, then ds is broadcast by shuffle and
// each lane accumulates its D/32 columns of dq.  dk/dv kernel: 4 warps
// of 8 keys; lane i scores query row i of the q tile against the warp's
// keys, then p and ds are broadcast by shuffle and each lane
// accumulates its columns of dk and dv.  The tile read along its rows
// by lane (k, v in the dq kernel; q, dO in the dk/dv kernel) has an odd
// shared-memory stride (D + 1), so the lanes hit 32 different banks.
//
// Bound on the H100 at the training shape (BH = 512, T = 128, D = 64):
// dq does 6*BH*T*T*D flops, dk/dv 8*BH*T*T*D; in f32 (67 TFLOP/s on the
// CUDA cores) operations bound them, in bf16 (989 TFLOP/s on the tensor
// cores) the bytes do (q, k, v, dO in, dq, dk, dv out, lse and delta).
// This first version does its products as scalar f32 FMAs from shared
// memory; mma/wgmma tiles are later work.
#include "common.cuh"

#define BQ 32     // query rows per tile
#define BK 32     // keys per tile
#define NWARP 4
#define RPW (BQ / NWARP)  // dq kernel: query rows per warp
#define KPW (BK / NWARP)  // dk/dv kernel: keys per warp
#define MAXNC 4           // columns per lane: D <= 128

template <typename T, int NC>
__global__ void __launch_bounds__(NWARP * 32)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dlt, T* __restrict__ dq,
                     int Tq, int Tk, int D, float scale, int causal,
                     int diag, int nq) {
  extern __shared__ float sm[];
  float* Qs = sm;                 // BQ x D
  float* Os = Qs + BQ * D;        // BQ x D: dO rows
  float* Ks = Os + BQ * D;        // BK x (D + 1)
  float* Vs = Ks + BK * (D + 1);  // BK x (D + 1)
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * Tk * D;

  for (int e = tid; e < BQ * D; e += NWARP * 32) {
    const int r = e / D, c = e - r * D;
    const bool in = q0 + r < Tq;
    const size_t g = qoff + (size_t)(q0 + r) * D + c;
    Qs[e] = in ? to_f<T>(q[g]) : 0.f;
    Os[e] = in ? to_f<T>(dout[g]) : 0.f;
  }

  const int row0 = q0 + warp * RPW;
  float L[RPW], E[RPW], acc[RPW][NC];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const bool in = row0 + r < Tq;
    L[r] = in ? lse[(size_t)bh * Tq + row0 + r] : 0.f;
    E[r] = in ? dlt[(size_t)bh * Tq + row0 + r] : 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }

  const int nk = (Tk + BK - 1) / BK;
  const int last_visible = q0 + BQ - 1 + diag;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    if (causal && k0 > last_visible) break;
    __syncthreads();  // Qs/Os written, or the previous tile consumed
    for (int e = tid; e < BK * D; e += NWARP * 32) {
      const int r = e / D, c = e - r * D;
      const bool in = k0 + r < Tk;
      const size_t g = koff + (size_t)(k0 + r) * D + c;
      Ks[r * (D + 1) + c] = in ? to_f<T>(k[g]) : 0.f;
      Vs[r * (D + 1) + c] = in ? to_f<T>(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RPW], dp[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    const float* vr = Vs + lane * (D + 1);
    const float* qw = Qs + warp * RPW * D;
    const float* ow = Os + warp * RPW * D;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        s[r] = fmaf(qw[r * D + d], kd, s[r]);
        dp[r] = fmaf(ow[r * D + d], vd, dp[r]);
      }
    }

    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      const bool ok = row < Tq && key < Tk && (!causal || key <= row + diag);
      const float p = ok ? expf(s[r] * scale - L[r]) : 0.f;
      const float ds = p * (dp[r] - E[r]) * scale;
      for (int j = 0; j < BK; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
        const float* kj = Ks + j * (D + 1);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[r][i] = fmaf(dsj, kj[d], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + r;
    if (row >= Tq) continue;
    T* out = dq + qoff + (size_t)row * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[d] = from_f<T>(acc[r][i]);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(NWARP * 32)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dlt, T* __restrict__ dk,
                      T* __restrict__ dv, int Tq, int Tk, int D,
                      float scale, int causal, int diag, int nkt) {
  extern __shared__ float sm[];
  float* Ks = sm;                 // BK x D
  float* Vs = Ks + BK * D;        // BK x D
  float* Qs = Vs + BK * D;        // BQ x (D + 1)
  float* Os = Qs + BQ * (D + 1);  // BQ x (D + 1): dO rows
  float* Ls = Os + BQ * (D + 1);  // BQ: lse of the tile's rows
  float* Es = Ls + BQ;            // BQ: delta of the tile's rows
  const int bh = blockIdx.x / nkt;
  const int k0 = (blockIdx.x - bh * nkt) * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * Tk * D;

  for (int e = tid; e < BK * D; e += NWARP * 32) {
    const int r = e / D, c = e - r * D;
    const bool in = k0 + r < Tk;
    const size_t g = koff + (size_t)(k0 + r) * D + c;
    Ks[e] = in ? to_f<T>(k[g]) : 0.f;
    Vs[e] = in ? to_f<T>(v[g]) : 0.f;
  }

  const int key0 = k0 + warp * KPW;
  float ak[KPW][NC], av[KPW][NC];
#pragma unroll
  for (int r = 0; r < KPW; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) ak[r][i] = av[r][i] = 0.f;

  const int nq = (Tq + BQ - 1) / BQ;
  for (int t = 0; t < nq; ++t) {
    const int q0 = t * BQ;
    if (causal && k0 > q0 + BQ - 1 + diag) continue;
    __syncthreads();  // Ks/Vs written, or the previous tile consumed
    for (int e = tid; e < BQ * D; e += NWARP * 32) {
      const int r = e / D, c = e - r * D;
      const bool in = q0 + r < Tq;
      const size_t g = qoff + (size_t)(q0 + r) * D + c;
      Qs[r * (D + 1) + c] = in ? to_f<T>(q[g]) : 0.f;
      Os[r * (D + 1) + c] = in ? to_f<T>(dout[g]) : 0.f;
    }
    if (tid < BQ) {
      const bool in = q0 + tid < Tq;
      Ls[tid] = in ? lse[(size_t)bh * Tq + q0 + tid] : 0.f;
      Es[tid] = in ? dlt[(size_t)bh * Tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[KPW], dp[KPW];
#pragma unroll
    for (int r = 0; r < KPW; ++r) s[r] = dp[r] = 0.f;
    const float* qr = Qs + lane * (D + 1);
    const float* orow = Os + lane * (D + 1);
    const float* kw = Ks + warp * KPW * D;
    const float* vw = Vs + warp * KPW * D;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], od = orow[d];
#pragma unroll
      for (int r = 0; r < KPW; ++r) {
        s[r] = fmaf(qd, kw[r * D + d], s[r]);
        dp[r] = fmaf(od, vw[r * D + d], dp[r]);
      }
    }

    const int row = q0 + lane;
    const float Lr = Ls[lane], Er = Es[lane];
    float p[KPW], ds[KPW];
#pragma unroll
    for (int r = 0; r < KPW; ++r) {
      const int key = key0 + r;
      const bool ok = row < Tq && key < Tk && (!causal || key <= row + diag);
      p[r] = ok ? expf(s[r] * scale - Lr) : 0.f;
      ds[r] = p[r] * (dp[r] - Er) * scale;
    }
    for (int i = 0; i < BQ; ++i) {
      const float* qi = Qs + i * (D + 1);
      const float* oi = Os + i * (D + 1);
#pragma unroll
      for (int r = 0; r < KPW; ++r) {
        const float pi = __shfl_sync(0xffffffffu, p[r], i);
        const float dsi = __shfl_sync(0xffffffffu, ds[r], i);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) {
            av[r][c] = fmaf(pi, oi[d], av[r][c]);
            ak[r][c] = fmaf(dsi, qi[d], ak[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KPW; ++r) {
    const int key = key0 + r;
    if (key >= Tk) continue;
    T* ko = dk + koff + (size_t)key * D;
    T* vo = dv + koff + (size_t)key * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        ko[d] = from_f<T>(ak[r][c]);
        vo[d] = from_f<T>(av[r][c]);
      }
    }
  }
}

template <typename Kern>
static int allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NC>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dlt,
                     void* dq, int BH, int Tq, int Tk, int D, float scale,
                     int causal, int diag, cudaStream_t stream) {
  const int nq = (Tq + BQ - 1) / BQ;
  const size_t smem =
      (size_t)(2 * BQ * D + 2 * BK * (D + 1)) * sizeof(float);
  const int e = allow_smem(fa_bwd_dq_kernel<T, NC>, smem);
  if (e) return e;
  fa_bwd_dq_kernel<T, NC><<<(unsigned)((long long)BH * nq), NWARP * 32,
                            smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dlt, (T*)dq, Tq, Tk, D, scale,
      causal, diag, nq);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dlt,
                      void* dk, void* dv, int BH, int Tq, int Tk, int D,
                      float scale, int causal, int diag,
                      cudaStream_t stream) {
  const int nkt = (Tk + BK - 1) / BK;
  const size_t smem =
      (size_t)(2 * BK * D + 2 * BQ * (D + 1) + 2 * BQ) * sizeof(float);
  const int e = allow_smem(fa_bwd_dkv_kernel<T, NC>, smem);
  if (e) return e;
  fa_bwd_dkv_kernel<T, NC><<<(unsigned)((long long)BH * nkt), NWARP * 32,
                             smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)dlt, (T*)dk, (T*)dv, Tq, Tk, D,
      scale, causal, diag, nkt);
  return (int)cudaGetLastError();
}

// NC = columns per lane = ceil(D / 32), a template argument so that the
// column loops unroll without dead iterations
#define FA_DISPATCH(T, FN, ...)                                   \
  switch ((D + 31) / 32) {                                        \
    case 1: return FN<T, 1>(__VA_ARGS__);                         \
    case 2: return FN<T, 2>(__VA_ARGS__);                         \
    case 3: return FN<T, 3>(__VA_ARGS__);                         \
    default: return FN<T, 4>(__VA_ARGS__);                        \
  }

extern "C" int mxt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dlt, void* dq, int BH, int Tq, int Tk,
    int D, float scale, int causal, int diag, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 32 * MAXNC) return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32) {
    FA_DISPATCH(float, launch_dq, q, k, v, dout, lse, dlt, dq, BH, Tq, Tk,
                D, scale, causal, diag, s)
  }
  if (dtype == MXT_BF16) {
    FA_DISPATCH(__nv_bfloat16, launch_dq, q, k, v, dout, lse, dlt, dq, BH,
                Tq, Tk, D, scale, causal, diag, s)
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dlt, void* dk, void* dv, int BH, int Tq,
    int Tk, int D, float scale, int causal, int diag, int dtype,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 32 * MAXNC) return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32) {
    FA_DISPATCH(float, launch_dkv, q, k, v, dout, lse, dlt, dk, dv, BH, Tq,
                Tk, D, scale, causal, diag, s)
  }
  if (dtype == MXT_BF16) {
    FA_DISPATCH(__nv_bfloat16, launch_dkv, q, k, v, dout, lse, dlt, dk, dv,
                BH, Tq, Tk, D, scale, causal, diag, s)
  }
  return (int)cudaErrorInvalidValue;
}
