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
// f32: fa_fwd_f32_wgmma_kernel, on the tensor cores as well, at f32
// accuracy without TF32: every f32 operand is split exactly into three
// bf16 parts and each product is the six part products that matter
// (hopper.cuh, split3), as the TPU computes f32 at Precision.HIGHEST.
// Bound on the H100 at the serving shape (b*16 heads, T = 128, D = 64):
// the bytes (f32 q, k, v read once, O written: 67.1 MB, 0.020 ms)
// against the six products' 0.013 ms of tensor-core work, so the split
// is done in the kernel, where a prepass would write and read back 1.5x
// the f32 bytes of q, k and v.  A CTA holds 64*NWG query rows of one
// (b, h), one consumer warpgroup per 64; thread 0 issues the TMA loads
// of Q and, through a ring of STAGES, of each 64-key tile of K and V as
// f32 boxes (64 x 64, unswizzled).  All threads split them into bf16
// parts in the swizzled boxes the descriptors read (split_box): Q once,
// each K/V tile once for the CTA's rows.  S = Q.K^T is six SS wgmmas a
// k-step; the online softmax runs in f32 registers, p is never rounded
// (the reference's p.astype(v.dtype) is f32 here), and P is split in
// registers into three RS A-fragments for O += P.V, six RS wgmmas with
// V's parts MN-major.  Shared memory (1 KB alignment beside):
//   NCH 1 (D <= 64):  NWG 2, 2 stages: Q parts 48 KB, K/V parts 48 KB,
//                     f32 ring 64 KB = 160 KB, 256 threads, 144
//                     registers (ptxas, no spills);
//   NCH 2 (D <= 128): NWG 1, 1 stage:  Q parts 48 KB, K/V parts 96 KB,
//                     f32 ring 64 KB = 208 KB, 128 threads, 180
//                     registers.
// With one stage the next tile's load still runs under this tile's
// products: a stage is free as soon as its tile is split.  Q's f32 box
// lands in the K/V parts' room, split before the first tile.  Times:
// PERF.md.
#include "common.cuh"
#include "hopper.cuh"

#define NEG_SENTINEL (-1e30f)

// ---- f32: six bf16 products on wgmma + TMA ------------------------------

template <int NCH>
struct F32Fwd {
  static constexpr int NWG = NCH == 1 ? 2 : 1;  // consumer warpgroups
  static constexpr int STAGES = NCH == 1 ? 2 : 1;
  static constexpr int ROWS = 64 * NWG;  // query rows of a CTA
  static constexpr int QP = 3 * NWG * NCH * HOP_TILE_BYTES;  // Q's parts
  static constexpr int VP = 3 * NCH * HOP_TILE_BYTES;  // V's beside K's
  static constexpr int STAGE = 2 * NCH * HOP_F32_BOX;  // f32 K, then V
  static constexpr int SMEM = QP + 2 * VP + STAGES * STAGE + 1024;
};

template <int NCH>
__global__ void __launch_bounds__(128 * F32Fwd<NCH>::NWG)
    fa_fwd_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            float* __restrict__ o, float* __restrict__ lse,
                            int BH, int Tq, int Tk, int D, float scale,
                            int causal, int delta, int nq) {
  using F = F32Fwd<NCH>;
  constexpr int NT = 128 * F::NWG;
  extern __shared__ uint8_t fa_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_kv[F::STAGES];
  // Q's parts: part p, warpgroup w, column box c at ((p*NWG + w)*NCH + c)
  // boxes; K's parts: part p, box c at (p*NCH + c), V's the same at VP
  uint8_t* qp = align1024(fa_raw);
  uint8_t* kp = qp + F::QP;
  uint8_t* vp = kp + F::VP;
  uint8_t* ring = vp + F::VP;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * F::ROWS;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;

  int nk = (Tk + WG_ROWS - 1) / WG_ROWS;
  if (causal) {
    const int last = q0 + F::ROWS - 1 + delta;  // last key any row sees
    nk = min(nk, last < 0 ? 0 : last / WG_ROWS + 1);
  }
  auto load_kv = [&](int t) {  // kv tile t into stage t % STAGES
    const int s = t % F::STAGES;
    uint8_t* st = ring + s * F::STAGE;
    mbar_expect_tx(&bar_kv[s], F::STAGE);
    for (int c = 0; c < NCH; ++c) {
      tma_load_3d(st + c * HOP_F32_BOX, &tk, &bar_kv[s], 64 * c,
                  WG_ROWS * t, bh);
      tma_load_3d(st + (NCH + c) * HOP_F32_BOX, &tv, &bar_kv[s], 64 * c,
                  WG_ROWS * t, bh);
    }
  };

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < F::STAGES; ++s) mbar_init(&bar_kv[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // Q's f32 boxes into the K/V parts' room
    mbar_expect_tx(&bar_q, F::NWG * NCH * HOP_F32_BOX);
    for (int w = 0; w < F::NWG; ++w)
      for (int c = 0; c < NCH; ++c)
        tma_load_3d(kp + (w * NCH + c) * HOP_F32_BOX, &tq, &bar_q, 64 * c,
                    q0 + WG_ROWS * w, bh);
    for (int t = 0; t < min(nk, F::STAGES); ++t) load_kv(t);
  }
  mbar_wait(&bar_q, 0);
#pragma unroll
  for (int b = 0; b < F::NWG * NCH; ++b) {
    uint8_t* dst = qp + b * HOP_TILE_BYTES;
    split_box<NT>(reinterpret_cast<const float*>(kp + b * HOP_F32_BOX), dst,
                  dst + F::NWG * NCH * HOP_TILE_BYTES,
                  dst + 2 * F::NWG * NCH * HOP_TILE_BYTES, tid);
  }
  fence_async_smem();  // the parts, visible to wgmma
  __syncthreads();     // and Q's f32 boxes read before K/V parts land

  // this thread's two rows (accumulator layout, hopper.cuh)
  const int row_a = q0 + WG_ROWS * wg + warp * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  const int cq = 2 * (lane & 3);
  const uint8_t* qw = qp + wg * NCH * HOP_TILE_BYTES;
  constexpr int QPART = F::NWG * NCH * HOP_TILE_BYTES;  // Q part stride
  constexpr int KPART = NCH * HOP_TILE_BYTES;           // K/V part stride
  float acc[32 * NCH];
#pragma unroll
  for (int i = 0; i < 32 * NCH; ++i) acc[i] = 0.f;
  float m_a = NEG_SENTINEL, m_b = NEG_SENTINEL, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int s = t % F::STAGES;
    mbar_wait(&bar_kv[s], (t / F::STAGES) & 1);
    const uint8_t* st = ring + s * F::STAGE;
#pragma unroll
    for (int b = 0; b < 2 * NCH; ++b) {  // K's boxes, then V's
      uint8_t* dst = (b < NCH ? kp : vp) + (b % NCH) * HOP_TILE_BYTES;
      split_box<NT>(reinterpret_cast<const float*>(st + b * HOP_F32_BOX),
                    dst, dst + KPART, dst + 2 * KPART, tid);
    }
    fence_async_smem();
    __syncthreads();  // parts written; stage s read by every thread
    if (tid == 0 && t + F::STAGES < nk) load_kv(t + F::STAGES);

    // S = Q.K^T: six products, the smallest first
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int pp = 0; pp < 6; ++pp)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n64k16(
              sc,
              kmajor_desc(qw + split_a(pp) * QPART + c * HOP_TILE_BYTES, kk),
              kmajor_desc(kp + split_b(pp) * KPART + c * HOP_TILE_BYTES, kk),
              (pp | c | kk) != 0);
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
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float p = expf(sc[r] - ((r & 2) ? mn_b : mn_a));
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

    // P, never rounded: three bf16 A fragments (hopper.cuh)
    uint32_t pa[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_pack3(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], pa[0][kk][j],
                    pa[1][kk][j], pa[2][kk][j]);

    // O += P.V: six products, the smallest first
    wgmma_fence();
#pragma unroll
    for (int pp = 0; pp < 6; ++pp)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn<NCH>(acc, pa[split_a(pp)][kk],
                         mnmajor_desc(vp + split_b(pp) * KPART, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with the parts
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row_b : row_a;
    if (row >= Tq) continue;
    const float m = h ? m_b : m_a, l = h ? l_b : l_a;
    const bool masked = m == NEG_SENTINEL;
    const float safe = l == 0.f ? 1.f : l;
    float* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < 8 * NCH; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) =
            masked ? make_float2(0.f, 0.f)
                   : make_float2(acc[4 * j + 2 * h] / safe,
                                 acc[4 * j + 2 * h + 1] / safe);
    }
    if ((lane & 3) == 0)
      lse[(size_t)bh * Tq + row] = masked ? -NEG_SENTINEL : m + logf(safe);
  }
}

template <int NCH>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      void* lse, int BH, int Tq, int Tk, int D, float scale,
                      int causal, int delta, cudaStream_t stream) {
  using F = F32Fwd<NCH>;
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = hop_map_f32(&mq, q, BH, Tq, D)) ||
      (e = hop_map_f32(&mk, k, BH, Tk, D)) ||
      (e = hop_map_f32(&mv, v, BH, Tk, D)) ||
      (e = (int)cudaFuncSetAttribute(
           fa_fwd_f32_wgmma_kernel<NCH>,
           cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM)))
    return e;
  const int nq = (Tq + F::ROWS - 1) / F::ROWS;
  fa_fwd_f32_wgmma_kernel<NCH>
      <<<(unsigned)((long long)BH * nq), 128 * F::NWG, F::SMEM, stream>>>(
          mq, mk, mv, (float*)o, (float*)lse, BH, Tq, Tk, D, scale, causal,
          delta, nq);
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
  // D % 8: TMA's 16-byte row stride in bf16 (the wrapper pads both)
  if (D < 1 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32)
    return D <= 64 ? launch_f32<1>(q, k, v, o, lse, BH, Tq, Tk, D, scale,
                                   causal, delta, s)
                   : launch_f32<2>(q, k, v, o, lse, BH, Tq, Tk, D, scale,
                                   causal, delta, s);
  if (dtype == MXT_BF16)
    return D <= 64 ? launch_wgmma<1>(q, k, v, o, lse, BH, Tq, Tk, D, scale,
                                     causal, delta, s)
                   : launch_wgmma<2>(q, k, v, o, lse, BH, Tq, Tk, D, scale,
                                     causal, delta, s);
  return (int)cudaErrorInvalidValue;
}
