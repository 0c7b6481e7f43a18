// Flash attention forward: blockwise attention with an online softmax.
// q: (BH, Tq, D), k/v: (BH, Tk, D) row-major; outputs O (BH, Tq, D) in
// the input type and the per-row logsumexp lse (BH, Tq) in f32.
//
// Replaces mxtpu/kernels/flash_attention.py:_fa_kernel (launched by
// _flash_forward).  The TPU kernel walks kv blocks along a sequential
// grid axis and carries m, l and acc in VMEM scratch; here one CTA owns
// (bh, a tile of query rows) and the kv tiles are a loop inside it,
// with m, l and acc in registers (f32).  Scores are scaled after the
// product as the reference does.  Keys past Tk are masked in the
// kernel, so any Tq/Tk works without padding.  The causal mask keeps
// key j for query i iff j <= i + delta (delta = Tk - Tq by default); kv
// tiles wholly above the diagonal are skipped.  Masked scores take the
// reference's -1e30 sentinel, and a row that sees no key at all outputs
// O = 0 with lse = +1e30 (the TPU kernel's convention; SDPA would give
// NaN there).  Two kernels, by dtype:
//
// bf16: fa_fwd_wgmma_kernel, on the tensor cores.  One warpgroup per
// CTA owns (bh, 64 query rows).  TMA loads the Q tile once and the K
// and V tiles of 64 keys through a 2-stage ring, each completed on an
// mbarrier (hopper.cuh).  S = Q.K^T is an SS wgmma (m64n64k16, D/16
// k-steps) into f32 registers; the online softmax reduces each row over
// the 4 threads that hold it; p = exp(s - m) is rounded to bf16 in
// registers, as the reference's p.astype(v.dtype), and becomes the A
// operand of O += P.V, an RS wgmma with V's tile MN-major.  Bound on
// the H100 at the training shape (BH 512, T 128, D 64): the bytes (q,
// k, v read once, O written: 33.5 MB, 0.010 ms) against 2.2 us of
// tensor-core work.  D <= 128 and D % 8 == 0 (TMA's 16-byte row
// stride; the wrapper zero-pads other head dims).  CTAs are issued
// longest first (the causal tiles nearest the end of the sequence).
//
// f32: fa_fwd_kernel, true f32 FMAs on the CUDA cores (no TF32, which
// is all wgmma offers for f32).  4 warps own 32 query rows; lane j of a
// warp scores key j of the 32-key tile against the warp's rows; p is
// broadcast by shuffle and each lane accumulates D/32 output columns.
// At the serving shape (b*16 heads, T = 128, D = 64) the work, 4*BH*
// T*T*D flops at 67 TFLOP/s, bounds it (~T/4 = 32 flop/byte, above the
// f32 balance point).
#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16: wgmma + TMA --------------------------------------------------

// NCH boxes of 64 head-dim columns (D <= 64: 1, D <= 128: 2)
template <int NCH>
__global__ void __launch_bounds__(128)
    fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int BH, int Tq, int Tk,
                        int D, float scale, int causal, int delta, int nq) {
  extern __shared__ uint8_t fa_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[2], bar_v[2];
  uint8_t* Qs = align1024(fa_raw);          // NCH boxes
  uint8_t* Ks = Qs + NCH * HOP_TILE_BYTES;  // 2 stages x NCH boxes
  uint8_t* Vs = Ks + 2 * NCH * HOP_TILE_BYTES;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * WG_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int nk = (Tk + WG_ROWS - 1) / WG_ROWS;
  if (causal) {
    const int last = q0 + WG_ROWS - 1 + delta;  // last key any row sees
    nk = min(nk, last < 0 ? 0 : last / WG_ROWS + 1);
  }

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, NCH * HOP_TILE_BYTES);
    for (int c = 0; c < NCH; ++c)
      tma_load_3d(Qs + c * HOP_TILE_BYTES, &tq, &bar_q, 64 * c, q0, bh);
    for (int t = 0; t < min(nk, 2); ++t)
      tma_load_pair<NCH>(Ks, Vs, &tk, &tv, &bar_k[t], &bar_v[t], t, t, bh);
  }

  // this thread's two rows (accumulator layout, hopper.cuh)
  const int row_a = q0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int cq = 2 * (lane & 3);
  float acc[32 * NCH];
#pragma unroll
  for (int i = 0; i < 32 * NCH; ++i) acc[i] = 0.f;
  float m_a = NEG_SENTINEL, m_b = NEG_SENTINEL, l_a = 0.f, l_b = 0.f;
  mbar_wait(&bar_q, 0);

  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    const uint32_t ph = (t >> 1) & 1;
    mbar_wait(&bar_k[s], ph);
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n64k16(
            sc, kmajor_desc(Qs + c * HOP_TILE_BYTES, kk),
            kmajor_desc(Ks + (s * NCH + c) * HOP_TILE_BYTES, kk),
            (c | kk) != 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = t * WG_ROWS;
    float mx_a = NEG_SENTINEL, mx_b = NEG_SENTINEL;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int key = k0 + 8 * (r >> 2) + cq + (r & 1);
      const int row = (r & 2) ? row_b : row_a;
      const bool ok = key < Tk && (!causal || key <= row + delta);
      sc[r] = ok ? sc[r] * scale : NEG_SENTINEL;
      if (r & 2)
        mx_b = fmaxf(mx_b, sc[r]);
      else
        mx_a = fmaxf(mx_a, sc[r]);
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f((m_a - mn_a) * LOG2E);
    const float al_b = exp2f((m_b - mn_b) * LOG2E);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float p = exp2f((sc[r] - ((r & 2) ? mn_b : mn_a)) * LOG2E);
      sc[r] = p;
      if (r & 2)
        sum_b += p;
      else
        sum_a += p;
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o_);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o_);
    }
    l_a = al_a * l_a + sum_a;
    l_b = al_b * l_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int i = 0; i < 32 * NCH; ++i) acc[i] *= (i & 2) ? al_b : al_a;

    // p in bf16, as the A operand of P.V (hopper.cuh)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

    mbar_wait(&bar_v[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn<NCH>(acc, pa[kk],
                       mnmajor_desc(Vs + s * NCH * HOP_TILE_BYTES, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // every thread's wgmmas are done with stage s
    if (tid == 0 && t + 2 < nk)  // kv tile t + 2 into the freed stage
      tma_load_pair<NCH>(Ks, Vs, &tk, &tv, &bar_k[s], &bar_v[s], s, t + 2,
                         bh);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row_b : row_a;
    if (row >= Tq) continue;
    const float m = h ? m_b : m_a, l = h ? l_b : l_a;
    const bool masked = m == NEG_SENTINEL;
    const float safe = l == 0.f ? 1.f : l;
    __nv_bfloat16* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < 8 * NCH; ++j) {
      const int col = 8 * j + cq;
      if (col < D) {
        const float x0 = masked ? 0.f : acc[4 * j + 2 * h] / safe;
        const float x1 = masked ? 0.f : acc[4 * j + 2 * h + 1] / safe;
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(x0, x1);
      }
    }
    if ((lane & 3) == 0)
      lse[(size_t)bh * Tq + row] = masked ? -NEG_SENTINEL : m + logf(safe);
  }
}

template <int NCH>
static int launch_wgmma(const void* q, const void* k, const void* v,
                        void* o, void* lse, int BH, int Tq, int Tk, int D,
                        float scale, int causal, int delta,
                        cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = hop_map_bf16(&mq, q, BH, Tq, D)) ||
      (e = hop_map_bf16(&mk, k, BH, Tk, D)) ||
      (e = hop_map_bf16(&mv, v, BH, Tk, D)))
    return e;
  const int nq = (Tq + WG_ROWS - 1) / WG_ROWS;
  const size_t smem = (size_t)5 * NCH * HOP_TILE_BYTES + 1024;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_wgmma_kernel<NCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fa_fwd_wgmma_kernel<NCH><<<(unsigned)((long long)BH * nq), 128, smem,
                              stream>>>(mq, mk, mv, (__nv_bfloat16*)o,
                                        (float*)lse, BH, Tq, Tk, D, scale,
                                        causal, delta, nq);
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
  if (dtype == MXT_BF16) {
    if (D % 8) return (int)cudaErrorInvalidValue;  // the wrapper pads
    return D <= 64 ? launch_wgmma<1>(q, k, v, o, lse, BH, Tq, Tk, D, scale,
                                     causal, delta, s)
                   : launch_wgmma<2>(q, k, v, o, lse, BH, Tq, Tk, D, scale,
                                     causal, delta, s);
  }
  return (int)cudaErrorInvalidValue;
}
