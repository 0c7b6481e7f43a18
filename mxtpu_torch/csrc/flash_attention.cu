// Flash attention forward: blockwise attention with an online softmax.
// q: (BH, Tq, D), k/v: (BH, Tk, D) row-major; outputs O (BH, Tq, D) in
// the input type and the per-row logsumexp lse (BH, Tq) in f32.
//
// Replaces mxtpu/kernels/flash_attention.py:_fa_kernel (launched by
// _flash_forward).  The TPU kernel walks kv blocks along a sequential
// grid axis and carries m, l and acc in VMEM scratch; here one CTA owns
// (bh, a tile of BQ query rows) and the kv tiles are a loop inside it,
// with m, l and acc in registers (f32).  Scores are q.k in true f32 FMA
// (no TF32), scaled after the product as the reference does.  Keys past
// Tk are masked in the kernel, so any Tq/Tk works without padding.  The
// causal mask keeps key j for query i iff j <= i + delta (delta = Tk -
// Tq by default); kv tiles wholly above the diagonal are skipped.
// Masked scores take the reference's -1e30 sentinel, and a row that
// sees no key at all outputs O = 0 with lse = +1e30 (the TPU kernel's
// convention; SDPA would give NaN there).
//
// Layout: 4 warps, each owning BQ/4 query rows.  Lane j of a warp
// scores key j of the 32-key tile against the warp's rows; p is
// broadcast by shuffle and each lane accumulates D/32 output columns.
//
// Bound on the H100: at the serving shape (b*16 heads, T = 128, D = 64,
// f32) the work is 4*BH*T*T*D flops on CUDA cores (f32 without TF32:
// 67 TFLOP/s) against 4*BH*T*D*4 bytes, i.e. ~T/4 = 32 flop/byte, above
// the ~20 flop/byte balance point, so operations bound it.  This first
// version keeps q/k/v tiles in shared memory and does the products with
// scalar FMAs; wgmma/mma tiles are later work.
#include "common.cuh"

#define BQ 32      // query rows per CTA
#define BK 32      // keys per kv tile (one per lane)
#define NWARP 4
#define RPW (BQ / NWARP)  // query rows per warp
#define MAXI 4            // output columns per lane: D <= 128
#define NEG_SENTINEL (-1e30f)

template <typename T>
__global__ void __launch_bounds__(NWARP * 32)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int Tq, int Tk, int D,
                  float scale, int causal, int delta, int nq) {
  extern __shared__ float sm[];
  float* Qs = sm;                 // BQ x D
  float* Ks = Qs + BQ * D;        // BK x (D + 1): odd stride, no conflicts
  float* Vs = Ks + BK * (D + 1);  // BK x D
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * Tk * D;

  for (int e = tid; e < BQ * D; e += NWARP * 32) {
    const int r = e / D, c = e - r * D;
    Qs[e] = q0 + r < Tq ? to_f<T>(q[qoff + (size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][MAXI];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_SENTINEL;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < MAXI; ++i) acc[r][i] = 0.f;
  }

  const int nk = (Tk + BK - 1) / BK;
  const int last_visible = q0 + BQ - 1 + delta;  // causal tile skip
  const int row0 = q0 + warp * RPW;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    if (causal && k0 > last_visible) break;
    __syncthreads();  // Qs written / previous tile consumed
    for (int e = tid; e < BK * D; e += NWARP * 32) {
      const int r = e / D, c = e - r * D;
      const bool in = k0 + r < Tk;
      const size_t g = koff + (size_t)(k0 + r) * D + c;
      Ks[r * (D + 1) + c] = in ? to_f<T>(k[g]) : 0.f;
      Vs[e] = in ? to_f<T>(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    const float* qr = Qs + warp * RPW * D;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = fmaf(qr[r * D + d], kd, s[r]);
    }

    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const bool ok = key < Tk && (!causal || key <= row0 + r + delta);
      const float sv = ok ? s[r] * scale : NEG_SENTINEL;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sv - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      // p enters the p.v product in the input type, as the reference's
      // p.astype(v.dtype) does
      const float pt = round_to<T>(p);
      float pv[MAXI];
#pragma unroll
      for (int i = 0; i < MAXI; ++i) pv[i] = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pt, j);
        const float* vr = Vs + j * D;
#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
          const int d = lane + 32 * i;
          if (d < D) pv[i] = fmaf(pj, vr[d], pv[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MAXI; ++i) acc[r][i] = acc[r][i] * alpha + pv[i];
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + r;
    if (row >= Tq) continue;
    const bool masked = m[r] == NEG_SENTINEL;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + qoff + (size_t)row * D;
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_f<T>(masked ? 0.f : acc[r][i] / safe);
    }
    if (lane == 0)
      lse[(size_t)bh * Tq + row] = masked ? -NEG_SENTINEL : m[r] + logf(safe);
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Tq, int Tk, int D, float scale,
                  int causal, int delta, cudaStream_t stream) {
  const int nq = (Tq + BQ - 1) / BQ;
  const size_t smem = (size_t)(BQ * D + BK * (D + 1) + BK * D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fa_fwd_kernel<T><<<(unsigned)((long long)BH * nq), NWARP * 32, smem,
                     stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                               (float*)lse, Tq, Tk, D, scale, causal, delta,
                               nq);
  return (int)cudaGetLastError();
}

extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int BH, int Tq, int Tk, int D,
                                       float scale, int causal, int delta,
                                       int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 32 * MAXI) return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32)
    return launch<float>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal,
                         delta, s);
  if (dtype == MXT_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, BH, Tq, Tk, D, scale,
                                 causal, delta, s);
  return (int)cudaErrorInvalidValue;
}
