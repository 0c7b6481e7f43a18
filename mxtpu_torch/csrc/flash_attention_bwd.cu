// Flash attention backward: two kernels a dtype, dq and dk/dv, all on
// Hopper's tensor cores (wgmma, with TMA loads).
// q, dO: (BH, Tq, D); k, v: (BH, Tk, D) row-major, f32 or bf16, D <= 128
// and D % 8 == 0 (TMA's 16-byte row stride in bf16; the wrapper zero-pads
// D); lse and delta = rowsum(dO * O): (BH, Tq) f32.  Outputs dq (BH, Tq,
// D) and dk, dv (BH, Tk, D) in the input type.
//
// Replaces mxtpu/kernels/flash_attention.py:_flash_backward, i.e.
// _fa_dq_kernel (kv innermost) and _fa_dkv_kernel (q innermost).  The
// TPU kernels carry their f32 sums in VMEM scratch across a sequential
// grid axis; here one CTA owns a tile of rows and loops over the other
// axis itself, with the sums in registers:
//   dq kernels:    a CTA per (bh, 64 query rows a warpgroup), loop over
//                  64-key tiles;
//   dk/dv kernels: a CTA per (bh, 64 keys a warpgroup), loop over 64-row
//                  q tiles.
// Each output element is summed by one thread in a fixed order, so every
// kernel is deterministic and needs no atomics.
//
// Per (query i, key j), all in f32 (the reference casts dO and the inputs
// to f32 too, and unlike the forward never rounds p):
//   s = (q_i . k_j) * scale,  p = exp(s - lse_i),
//   dp = dO_i . v_j,          ds = p * (dp - delta_i) * scale,
//   dq_i += ds * k_j,  dk_j += ds * q_i,  dv_j += p * dO_i.
// A masked pair (key past Tk, or j > i + diag when causal) has p = 0,
// which is what exp(-1e30 - lse) gives in the reference; a row with no
// visible key (lse = +1e30) has p = 0 everywhere, so nothing NaN or inf
// can arise.  Tiles wholly above the diagonal are skipped, and CTAs are
// issued longest first.
//
// bf16: fa_bwd_dq_wgmma_kernel and fa_bwd_dkv_wgmma_kernel, one bf16
// product per product of the inputs, P and dS split hi + lo.  f32:
// fa_bwd_dq_f32_wgmma_kernel and fa_bwd_dkv_f32_wgmma_kernel, every f32
// operand split exactly into three bf16 parts and each product the six
// part products that matter (hopper.cuh, split3), as the TPU computes
// f32 at Precision.HIGHEST; no TF32.  Every D <= 128, Tq, Tk and diag
// runs on these four kernels: no shape has another.
//
// Bound on the H100 at the training shape (BH = 512, T = 128, D = 64):
// dq does 6*BH*T*T*D flops, dk/dv 8*BH*T*T*D.  In bf16 (989 TFLOP/s) the
// bytes bound both (q, k, v, dO read, dq or dk and dv written, lse and
// delta); in f32 too, with six bf16 products a product: dq 84.4 MB
// (0.025 ms) against 0.020 ms of tensor-core work, dk/dv 101.2 MB (0.030
// ms) against 0.026 ms.  Times: PERF.md.
#include "common.cuh"
#include "hopper.cuh"

template <typename Kern>
static int allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---- bf16 dq: wgmma + TMA -----------------------------------------------
//
// The dk/dv kernel below mirrored, queries on the rows.  One warpgroup
// per CTA owns (bh, 64 query rows).  TMA loads the Q and dO tiles once,
// then the tiles of 64 keys of K and V through a 2-stage ring on
// mbarriers (hopper.cuh):
//   S  = Q.K^T  and  dP = dO.V^T         SS wgmmas, K and V K-major;
//   P  = exp(scale*S - lse_row)          0 where masked or past Tk;
//   dS = P * (dP - delta_row) * scale    all f32, in the registers;
//   dQ += dS.K                           RS wgmma, K MN-major.
// lse and delta are per row: two rows a thread, read once.  The
// reference never rounds ds, so dS enters as a hi+lo pair of bf16
// fragments (split_pack), as P^T and dS^T are in dk/dv: four
// products a tile.  At T = 128 the kernel is bound by its bytes (q, k,
// v, dO read, dq written, lse and delta).  Each dq element is summed by
// one CTA in key-tile order: deterministic, no atomics.  Causal: the
// loop stops at the last key tile the query tile sees, and CTAs are
// issued longest first (the query tiles at the end of the sequence).
// dq leaves as 4-byte stores straight from the accumulator (a TMA store
// staged through shared memory was tried and was no faster at BERT's
// shape).

// x as hi + lo, two bf16x2 fragments (the A operand of an RS wgmma)
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

template <int NCH>
__global__ void __launch_bounds__(128)
    fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ dlt,
                           __nv_bfloat16* __restrict__ dq, int BH, int Tq,
                           int Tk, int D, float scale, int causal,
                           int diag) {
  extern __shared__ uint8_t fq_raw[];
  __shared__ __align__(8) uint64_t bar_qo, bar_k[2], bar_v[2];
  uint8_t* Qs = align1024(fq_raw);          // NCH boxes
  uint8_t* Os = Qs + NCH * HOP_TILE_BYTES;  // NCH boxes: dO
  uint8_t* Ks = Os + NCH * HOP_TILE_BYTES;  // 2 stages x NCH boxes
  uint8_t* Vs = Ks + 2 * NCH * HOP_TILE_BYTES;
  const int nq = (Tq + WG_ROWS - 1) / WG_ROWS;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * WG_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int nk = (Tk + WG_ROWS - 1) / WG_ROWS;
  if (causal) {
    const int last = q0 + WG_ROWS - 1 + diag;  // last key any row sees
    nk = min(nk, last < 0 ? 0 : last / WG_ROWS + 1);
  }

  if (tid == 0) {
    mbar_init(&bar_qo, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_qo, 2 * NCH * HOP_TILE_BYTES);
    for (int c = 0; c < NCH; ++c) {
      tma_load_3d(Qs + c * HOP_TILE_BYTES, &tq, &bar_qo, 64 * c, q0, bh);
      tma_load_3d(Os + c * HOP_TILE_BYTES, &tdo, &bar_qo, 64 * c, q0, bh);
    }
    for (int t = 0; t < min(nk, 2); ++t)
      tma_load_pair<NCH>(Ks, Vs, &tk, &tv, &bar_k[t], &bar_v[t], t, t, bh);
  }

  // this thread's two rows (accumulator layout, hopper.cuh), their lse
  // and delta
  const int row_a = q0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int cq = 2 * (lane & 3);
  const size_t rbase = (size_t)bh * Tq;
  const float L_a = row_a < Tq ? lse[rbase + row_a] : 0.f;
  const float L_b = row_b < Tq ? lse[rbase + row_b] : 0.f;
  const float E_a = row_a < Tq ? dlt[rbase + row_a] : 0.f;
  const float E_b = row_b < Tq ? dlt[rbase + row_b] : 0.f;
  float acc[32 * NCH];
#pragma unroll
  for (int i = 0; i < 32 * NCH; ++i) acc[i] = 0.f;
  mbar_wait(&bar_qo, 0);

  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    const uint32_t ph = (t >> 1) & 1;
    float sc[32], dp[32];
    mbar_wait(&bar_k[s], ph);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n64k16(
            sc, kmajor_desc(Qs + c * HOP_TILE_BYTES, kk),
            kmajor_desc(Ks + (s * NCH + c) * HOP_TILE_BYTES, kk),
            (c | kk) != 0);
    mbar_wait(&bar_v[s], ph);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n64k16(
            dp, kmajor_desc(Os + c * HOP_TILE_BYTES, kk),
            kmajor_desc(Vs + (s * NCH + c) * HOP_TILE_BYTES, kk),
            (c | kk) != 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P and dS in f32, then dS as hi + lo bf16 fragments
    const int k0 = t * WG_ROWS;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int key = k0 + 8 * (r >> 2) + cq + (r & 1);
      const bool b = (r & 2) != 0;
      const int row = b ? row_b : row_a;
      const bool ok =
          row < Tq && key < Tk && (!causal || key <= row + diag);
      const float p =
          ok ? exp2f((sc[r] * scale - (b ? L_b : L_a)) * LOG2E) : 0.f;
      dp[r] = p * (dp[r] - (b ? E_b : E_a)) * scale;
    }
    uint32_t dh[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 8 * kk + 2 * j;
        split_pack(dp[r], dp[r + 1], dh[kk][j], dl[kk][j]);
      }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bk = mnmajor_desc(Ks + s * NCH * HOP_TILE_BYTES, kk);
      wgmma_rs_mn<NCH>(acc, dh[kk], bk);
      wgmma_rs_mn<NCH>(acc, dl[kk], bk);
    }
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
    __nv_bfloat16* out = dq + (rbase + row) * D;
#pragma unroll
    for (int j = 0; j < 8 * NCH; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int NCH>
static int launch_dq_wgmma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* dlt, void* dq, int BH, int Tq,
                           int Tk, int D, float scale, int causal, int diag,
                           cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  int e;
  if ((e = hop_map_bf16(&mq, q, BH, Tq, D)) ||
      (e = hop_map_bf16(&mk, k, BH, Tk, D)) ||
      (e = hop_map_bf16(&mv, v, BH, Tk, D)) ||
      (e = hop_map_bf16(&mo, dout, BH, Tq, D)))
    return e;
  const int nq = (Tq + WG_ROWS - 1) / WG_ROWS;
  const size_t smem = (size_t)6 * NCH * HOP_TILE_BYTES + 1024;
  e = allow_smem(fa_bwd_dq_wgmma_kernel<NCH>, smem);
  if (e) return e;
  fa_bwd_dq_wgmma_kernel<NCH><<<(unsigned)((long long)BH * nq), 128, smem,
                                 stream>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)dlt,
      (__nv_bfloat16*)dq, BH, Tq, Tk, D, scale, causal, diag);
  return (int)cudaGetLastError();
}

// ---- bf16 dk/dv: wgmma + TMA --------------------------------------------
//
// One warpgroup per CTA owns (bh, 64 keys).  TMA loads the K and V
// tiles once, then the tiles of 64 query rows of Q and dO through a
// 2-stage ring on mbarriers (hopper.cuh).  Keys are the rows of every
// product, so lse and delta are per column and nothing goes back
// through shared memory:
//   S^T  = K.Q^T  and  dP^T = V.dO^T     SS wgmmas, Q and dO K-major;
//   P^T  = exp(scale*S^T - lse_col)      0 where masked or past Tq;
//   dS^T = P^T * (dP^T - delta_col) * scale            all f32;
//   dV  += P^T.dO  and  dK += dS^T.Q     RS wgmmas, dO and Q MN-major.
// The reference never rounds p or ds, and one bf16 rounding of P^T and
// dS^T before the last two products costs up to 6e-2 at causal T =
// 4096, past the 2e-2 gate; so each enters as a hi+lo pair of bf16
// fragments, x = bf16(x) + bf16(x - bf16(x)), two wgmmas into one f32
// accumulator, and the error is that of the output's one rounding.  Six
// products a tile; at T = 128 the kernel stays bound by its bytes (q, k,
// v, dO read, dk, dv written, lse and delta).  Each dk/dv element is
// summed by one CTA in q-tile order: deterministic, no atomics.  Causal:
// the loop starts at the first q tile that sees key k0.  CTAs are issued
// longest first (the key tiles at the start of the sequence).

template <int NCH>
__global__ void __launch_bounds__(128)
    fa_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ dlt,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int BH, int Tq,
                            int Tk, int D, float scale, int causal,
                            int diag) {
  extern __shared__ uint8_t fb_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_q[2], bar_o[2];
  uint8_t* Ks = align1024(fb_raw);          // NCH boxes
  uint8_t* Vs = Ks + NCH * HOP_TILE_BYTES;  // NCH boxes
  uint8_t* Qs = Vs + NCH * HOP_TILE_BYTES;  // 2 stages x NCH boxes
  uint8_t* Os = Qs + 2 * NCH * HOP_TILE_BYTES;
  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * WG_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int nq = (Tq + WG_ROWS - 1) / WG_ROWS;
  int t0 = 0;  // q tile t sees key k0 iff 64 t + 63 + diag >= k0
  if (causal) {
    const int first = k0 - diag - (WG_ROWS - 1);
    t0 = first <= 0 ? 0 : (first + WG_ROWS - 1) / WG_ROWS;
  }
  const int n = nq - t0;

  if (tid == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_q[s], 1);
      mbar_init(&bar_o[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_kv, 2 * NCH * HOP_TILE_BYTES);
    for (int c = 0; c < NCH; ++c) {
      tma_load_3d(Ks + c * HOP_TILE_BYTES, &tk, &bar_kv, 64 * c, k0, bh);
      tma_load_3d(Vs + c * HOP_TILE_BYTES, &tv, &bar_kv, 64 * c, k0, bh);
    }
    for (int i = 0; i < min(n, 2); ++i)
      tma_load_pair<NCH>(Qs, Os, &tq, &tdo, &bar_q[i], &bar_o[i], i, t0 + i,
                         bh);
  }

  // this thread's two keys (accumulator rows, hopper.cuh)
  const int key_a = k0 + warp * 16 + (lane >> 2), key_b = key_a + 8;
  const int cq = 2 * (lane & 3);
  float ak[32 * NCH], av[32 * NCH];
#pragma unroll
  for (int i = 0; i < 32 * NCH; ++i) ak[i] = av[i] = 0.f;
  mbar_wait(&bar_kv, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    const int q0 = (t0 + i) * WG_ROWS;
    // lse and delta of this thread's 16 columns (query rows)
    float L[16], E[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int row = q0 + 8 * (j >> 1) + cq + (j & 1);
      const bool in = row < Tq;
      L[j] = in ? lse[(size_t)bh * Tq + row] : 0.f;
      E[j] = in ? dlt[(size_t)bh * Tq + row] : 0.f;
    }
    float st[32], dpt[32];
    mbar_wait(&bar_q[s], ph);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n64k16(
            st, kmajor_desc(Ks + c * HOP_TILE_BYTES, kk),
            kmajor_desc(Qs + (s * NCH + c) * HOP_TILE_BYTES, kk),
            (c | kk) != 0);
    mbar_wait(&bar_o[s], ph);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n64k16(
            dpt, kmajor_desc(Vs + c * HOP_TILE_BYTES, kk),
            kmajor_desc(Os + (s * NCH + c) * HOP_TILE_BYTES, kk),
            (c | kk) != 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T in f32, then each as hi + lo bf16 fragments
    uint32_t ph_[4][4], pl_[4][4], dh_[4][4], dl_[4][4];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int j = 2 * (r >> 2) + (r & 1);  // this thread's column index
      const int row = q0 + 8 * (r >> 2) + cq + (r & 1);
      const int key = (r & 2) ? key_b : key_a;
      const bool ok = row < Tq && (!causal || key <= row + diag);
      const float p = ok ? exp2f((st[r] * scale - L[j]) * LOG2E) : 0.f;
      st[r] = p;
      dpt[r] = p * (dpt[r] - E[j]) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 8 * kk + 2 * j;
        split_pack(st[r], st[r + 1], ph_[kk][j], pl_[kk][j]);
        split_pack(dpt[r], dpt[r + 1], dh_[kk][j], dl_[kk][j]);
      }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bo = mnmajor_desc(Os + s * NCH * HOP_TILE_BYTES, kk);
      wgmma_rs_mn<NCH>(av, ph_[kk], bo);
      wgmma_rs_mn<NCH>(av, pl_[kk], bo);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bq = mnmajor_desc(Qs + s * NCH * HOP_TILE_BYTES, kk);
      wgmma_rs_mn<NCH>(ak, dh_[kk], bq);
      wgmma_rs_mn<NCH>(ak, dl_[kk], bq);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(av);
    fence_regs(ak);
    __syncthreads();  // every thread's wgmmas are done with stage s
    if (tid == 0 && i + 2 < n)  // q tile t0 + i + 2 into the freed stage
      tma_load_pair<NCH>(Qs, Os, &tq, &tdo, &bar_q[s], &bar_o[s], s,
                         t0 + i + 2, bh);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? key_b : key_a;
    if (key >= Tk) continue;
    __nv_bfloat16* ko = dk + ((size_t)bh * Tk + key) * D;
    __nv_bfloat16* vo = dv + ((size_t)bh * Tk + key) * D;
#pragma unroll
    for (int j = 0; j < 8 * NCH; ++j) {
      const int col = 8 * j + cq;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(ko + col) =
            pack_bf16(ak[4 * j + 2 * h], ak[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(vo + col) =
            pack_bf16(av[4 * j + 2 * h], av[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int NCH>
static int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dlt, void* dk, void* dv, int BH,
                            int Tq, int Tk, int D, float scale, int causal,
                            int diag, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  int e;
  if ((e = hop_map_bf16(&mq, q, BH, Tq, D)) ||
      (e = hop_map_bf16(&mk, k, BH, Tk, D)) ||
      (e = hop_map_bf16(&mv, v, BH, Tk, D)) ||
      (e = hop_map_bf16(&mo, dout, BH, Tq, D)))
    return e;
  const int nkt = (Tk + WG_ROWS - 1) / WG_ROWS;
  const size_t smem = (size_t)6 * NCH * HOP_TILE_BYTES + 1024;
  e = allow_smem(fa_bwd_dkv_wgmma_kernel<NCH>, smem);
  if (e) return e;
  fa_bwd_dkv_wgmma_kernel<NCH><<<(unsigned)((long long)BH * nkt), 128, smem,
                                  stream>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)dlt,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, BH, Tq, Tk, D, scale, causal,
      diag);
  return (int)cudaGetLastError();
}

// ---- f32 dq and dk/dv: six bf16 products on wgmma + TMA -----------------
//
// The bf16 kernels above at f32 accuracy.  A CTA holds NWG consumer
// warpgroups, each owning 64 rows: query rows in dq (its Q and dO), keys
// in dk/dv (its K and V).  The other side streams through in 64-row
// tiles shared by the warpgroups (K and V in dq, Q and dO in dk/dv).
// Thread 0 issues every load as TMA f32 boxes (64 x 64, unswizzled) into
// a ring of SLOTS one-operand slots, in the order the tiles are split
// (F32Ring): the owned tiles, then each streamed tile's two operands.
// All threads split each into three bf16 parts in the swizzled boxes the
// descriptors read (split_box): the owned tiles once, each streamed tile
// once for the CTA's rows.  The split is done in the kernel because both
// kernels are bound by their bytes at the training shape, and a prepass
// would write and read back 1.5x the f32 bytes of q, k, v and dO.
//   dq:    S = Q.K^T and dP = dO.V^T, six SS wgmmas each a k-step, K and
//          V K-major; P = exp(scale*S - lse) and dS = P*(dP - delta)*
//          scale in f32 registers, never rounded; dS split in registers
//          into three RS A-fragments (split_pack3); dQ += dS.K, six RS
//          wgmmas a k-step, K's parts MN-major.
//   dk/dv: S^T = K.Q^T and dP^T = V.dO^T the same way; P^T and dS^T
//          each split three ways; dV += P^T.dO and dK += dS^T.Q, six RS
//          wgmmas each a k-step, dO's and Q's parts MN-major.
// The pairs go smallest first (split_a, split_b) into one f32
// accumulator.  V's (dO's) split runs under the products of S (S^T).
// Shared memory (1 KB alignment beside), alike in both kernels:
//   NCH 1 (D <= 64):  NWG 2 (256 threads), owned parts 2 x 2 x 24 KB,
//                     streamed parts 2 x 24 KB, 5 slots of 16 KB: 224 KB;
//   NCH 2 (D <= 128): NWG 1 (128 threads), owned parts 2 x 48 KB,
//                     streamed parts 2 x 48 KB, 1 slot of 32 KB: 224 KB;
//                     each load runs under the products before its split.
// Registers: dk/dv at NCH 2 holds dK and dV (128 a thread), so it waits
// for dV's products before it splits dS^T: the fragments of P^T and of
// dS^T are never live together.

template <int NCH>
struct F32Bwd {
  static constexpr int NWG = NCH == 1 ? 2 : 1;  // consumer warpgroups
  static constexpr int NT = 128 * NWG;
  static constexpr int ROWS = 64 * NWG;         // owned rows of a CTA
  static constexpr int PART = NCH * HOP_TILE_BYTES;  // a bf16 part, 64 rows
  static constexpr int TILE = 3 * PART;              // its three parts
  static constexpr int SLOT = NCH * HOP_F32_BOX;     // 64 rows in f32
  static constexpr int SLOTS = NCH == 1 ? 5 : 1;
  static constexpr int OWN = 2 * NWG;  // owned tiles: the first loads
  static constexpr int SMEM = 2 * NWG * TILE + 2 * TILE + SLOTS * SLOT + 1024;
};

// The loads of an f32 backward CTA, in the order they are split.  Item
// j < OWN is owned operand j / NWG (map a, then b) of warpgroup j % NWG,
// rows own0 + 64 (j % NWG); item OWN + 2 i + e is operand e (map c, d)
// of streamed tile t0 + i.  Item j lands in slot j % SLOTS, on its
// barrier, whose phase j / SLOTS it completes.
template <int NCH>
struct F32Ring {
  using F = F32Bwd<NCH>;
  const CUtensorMap *a, *b, *c, *d;
  uint8_t* ring;
  uint64_t* bar;
  int own0, t0, bh, items;

  __device__ __forceinline__ void load(int j) const {
    const int s = j % F::SLOTS;
    const CUtensorMap* map;
    int row;
    if (j < F::OWN) {
      map = j < F::NWG ? a : b;
      row = own0 + WG_ROWS * (j % F::NWG);
    } else {
      map = (j & 1) ? d : c;  // OWN is even
      row = WG_ROWS * (t0 + ((j - F::OWN) >> 1));
    }
    mbar_expect_tx(&bar[s], F::SLOT);
    for (int cc = 0; cc < NCH; ++cc)
      tma_load_3d(ring + s * F::SLOT + cc * HOP_F32_BOX, map, &bar[s],
                  64 * cc, row, bh);
  }

  // wait for item j and split it into the parts at `parts` (part p, box
  // cc at p * PART + cc * 8 KB); once every thread has, item j + SLOTS
  // goes into the freed slot
  __device__ __forceinline__ void split(int j, uint8_t* parts,
                                        int tid) const {
    const int s = j % F::SLOTS;
    mbar_wait(&bar[s], (j / F::SLOTS) & 1);
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      uint8_t* dst = parts + cc * HOP_TILE_BYTES;
      split_box<F::NT>(reinterpret_cast<const float*>(ring + s * F::SLOT +
                                                      cc * HOP_F32_BOX),
                       dst, dst + F::PART, dst + 2 * F::PART, tid);
    }
    fence_async_smem();  // the parts, visible to wgmma
    __syncthreads();     // and the slot read by every thread
    if (tid == 0 && j + F::SLOTS < items) load(j + F::SLOTS);
  }
};

// D (+)= A.B^T over 64 * NCH columns as six SS products, both operands'
// parts K-major (part p, box c at p * PART + c * 8 KB)
template <int NCH>
__device__ __forceinline__ void six_ss(float (&d)[32], const uint8_t* a,
                                       const uint8_t* b) {
  constexpr int PART = F32Bwd<NCH>::PART;
#pragma unroll
  for (int pp = 0; pp < 6; ++pp)
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n64k16(
            d, kmajor_desc(a + split_a(pp) * PART + c * HOP_TILE_BYTES, kk),
            kmajor_desc(b + split_b(pp) * PART + c * HOP_TILE_BYTES, kk),
            (pp | c | kk) != 0);
}

// x (a 64 x 64 f32 accumulator) as three RS A-fragments per k-step
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&f)[3][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_pack3(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1], f[0][kk][j],
                  f[1][kk][j], f[2][kk][j]);
}

// O (64 x 64*NCH) += X.B as six RS products: X's fragments, B's parts
// MN-major (k-steps down its 64 rows)
template <int NCH>
__device__ __forceinline__ void six_rs(float (&o)[32 * NCH],
                                       const uint32_t (&f)[3][4][4],
                                       const uint8_t* b) {
#pragma unroll
  for (int pp = 0; pp < 6; ++pp)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn<NCH>(o, f[split_a(pp)][kk],
                       mnmajor_desc(b + split_b(pp) * F32Bwd<NCH>::PART, kk));
}

// rows row_a and row_a + 8 of a 64 x 64*NCH f32 accumulator (hopper.cuh)
// into out (rows of D floats), rows past `rows` and columns past D left
template <int NCH>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&x)[32 * NCH],
                                           int row_a, int rows, int D,
                                           int cq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= rows) continue;
    float* o = out + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < 8 * NCH; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<float2*>(o + col) =
            make_float2(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
    }
  }
}

template <int NCH>
__global__ void __launch_bounds__(128 * F32Bwd<NCH>::NWG)
    fa_bwd_dq_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ dlt,
                               float* __restrict__ dq, int BH, int Tq,
                               int Tk, int D, float scale, int causal,
                               int diag) {
  using F = F32Bwd<NCH>;
  extern __shared__ uint8_t fq32_raw[];
  __shared__ __align__(8) uint64_t bar[F::SLOTS];
  uint8_t* qp = align1024(fq32_raw);    // Q's parts, TILE a warpgroup
  uint8_t* op = qp + F::NWG * F::TILE;  // dO's parts
  uint8_t* kp = op + F::NWG * F::TILE;  // the key tile's K parts
  uint8_t* vp = kp + F::TILE;           // and V parts
  const int nq = (Tq + F::ROWS - 1) / F::ROWS;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * F::ROWS;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;

  int nk = (Tk + WG_ROWS - 1) / WG_ROWS;
  if (causal) {
    const int last = q0 + F::ROWS - 1 + diag;  // last key any row sees
    nk = min(nk, last < 0 ? 0 : last / WG_ROWS + 1);
  }
  const F32Ring<NCH> ring{&tq, &tdo, &tk, &tv, vp + F::TILE, bar,
                          q0, 0, bh, F::OWN + 2 * nk};

  // this thread's two rows (accumulator layout, hopper.cuh)
  const int row_a = q0 + WG_ROWS * wg + warp * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  const int cq = 2 * (lane & 3);
  float acc[32 * NCH];
#pragma unroll
  for (int i = 0; i < 32 * NCH; ++i) acc[i] = 0.f;

  if (nk > 0) {
    if (tid == 0) {
      for (int s = 0; s < F::SLOTS; ++s) mbar_init(&bar[s], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < min(F::SLOTS, ring.items); ++j) ring.load(j);
    const size_t rbase = (size_t)bh * Tq;
    const float L_a = row_a < Tq ? lse[rbase + row_a] : 0.f;
    const float L_b = row_b < Tq ? lse[rbase + row_b] : 0.f;
    const float E_a = row_a < Tq ? dlt[rbase + row_a] : 0.f;
    const float E_b = row_b < Tq ? dlt[rbase + row_b] : 0.f;
    for (int j = 0; j < F::OWN; ++j)
      ring.split(j, (j < F::NWG ? qp : op) + (j % F::NWG) * F::TILE, tid);
    const uint8_t* qw = qp + wg * F::TILE;
    const uint8_t* ow = op + wg * F::TILE;

    for (int t = 0; t < nk; ++t) {
      float sc[32], dp[32];
      ring.split(F::OWN + 2 * t, kp, tid);
      wgmma_fence();
      six_ss<NCH>(sc, qw, kp);  // S = Q.K^T
      wgmma_commit();
      ring.split(F::OWN + 2 * t + 1, vp, tid);  // under S's products
      wgmma_fence();
      six_ss<NCH>(dp, ow, vp);  // dP = dO.V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P and dS in f32, never rounded
      const int k0 = t * WG_ROWS;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int key = k0 + 8 * (r >> 2) + cq + (r & 1);
        const bool b = (r & 2) != 0;
        const int row = b ? row_b : row_a;
        const bool ok =
            row < Tq && key < Tk && (!causal || key <= row + diag);
        const float p = ok ? expf(sc[r] * scale - (b ? L_b : L_a)) : 0.f;
        dp[r] = p * (dp[r] - (b ? E_b : E_a)) * scale;
      }
      uint32_t df[3][4][4];
      split_frags(dp, df);

      wgmma_fence();
      six_rs<NCH>(acc, df, kp);  // dQ += dS.K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncthreads();  // every warpgroup is done with K's and V's parts
    }
  }
  store_rows<NCH>(dq + (size_t)bh * Tq * D, acc, row_a, Tq, D, cq);
}

template <int NCH>
__global__ void __launch_bounds__(128 * F32Bwd<NCH>::NWG)
    fa_bwd_dkv_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ dlt,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int BH, int Tq,
                                int Tk, int D, float scale, int causal,
                                int diag) {
  using F = F32Bwd<NCH>;
  extern __shared__ uint8_t fkv32_raw[];
  __shared__ __align__(8) uint64_t bar[F::SLOTS];
  uint8_t* kp = align1024(fkv32_raw);   // K's parts, TILE a warpgroup
  uint8_t* vp = kp + F::NWG * F::TILE;  // V's parts
  uint8_t* qp = vp + F::NWG * F::TILE;  // the q tile's Q parts
  uint8_t* op = qp + F::TILE;           // and dO parts
  const int bh = blockIdx.x % BH;
  const int k0 = (int)(blockIdx.x / BH) * F::ROWS;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;

  const int nq = (Tq + WG_ROWS - 1) / WG_ROWS;
  int t0 = 0;  // q tile t sees key k0 iff 64 t + 63 + diag >= k0
  if (causal) {
    const int first = k0 - diag - (WG_ROWS - 1);
    t0 = first <= 0 ? 0 : (first + WG_ROWS - 1) / WG_ROWS;
  }
  const int n = max(nq - t0, 0);
  const F32Ring<NCH> ring{&tk, &tv, &tq, &tdo, op + F::TILE, bar,
                          k0, t0, bh, F::OWN + 2 * n};

  // this thread's two keys (accumulator rows, hopper.cuh)
  const int key_a = k0 + WG_ROWS * wg + warp * 16 + (lane >> 2);
  const int key_b = key_a + 8;
  const int cq = 2 * (lane & 3);
  float ak[32 * NCH], av[32 * NCH];
#pragma unroll
  for (int i = 0; i < 32 * NCH; ++i) ak[i] = av[i] = 0.f;

  if (n > 0) {
    if (tid == 0) {
      for (int s = 0; s < F::SLOTS; ++s) mbar_init(&bar[s], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < min(F::SLOTS, ring.items); ++j) ring.load(j);
    for (int j = 0; j < F::OWN; ++j)
      ring.split(j, (j < F::NWG ? kp : vp) + (j % F::NWG) * F::TILE, tid);
    const uint8_t* kw = kp + wg * F::TILE;
    const uint8_t* vw = vp + wg * F::TILE;

    for (int i = 0; i < n; ++i) {
      const int q0 = (t0 + i) * WG_ROWS;
      float st[32], dpt[32];
      ring.split(F::OWN + 2 * i, qp, tid);
      wgmma_fence();
      six_ss<NCH>(st, kw, qp);  // S^T = K.Q^T
      wgmma_commit();
      ring.split(F::OWN + 2 * i + 1, op, tid);  // under S^T's products
      wgmma_fence();
      six_ss<NCH>(dpt, vw, op);  // dP^T = V.dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T in f32: this thread's 16 columns (query rows), each
      // with its lse and delta read once, against its two keys
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int row = q0 + 8 * (j >> 1) + cq + (j & 1);
        const bool in = row < Tq;
        const float L = in ? lse[(size_t)bh * Tq + row] : 0.f;
        const float E = in ? dlt[(size_t)bh * Tq + row] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * (j >> 1) + 2 * h + (j & 1);
          const int key = h ? key_b : key_a;
          const bool ok = in && (!causal || key <= row + diag);
          const float p = ok ? expf(st[r] * scale - L) : 0.f;
          st[r] = p;
          dpt[r] = p * (dpt[r] - E) * scale;
        }
      }
      uint32_t pf[3][4][4];
      split_frags(st, pf);
      wgmma_fence();
      six_rs<NCH>(av, pf, op);  // dV += P^T.dO
      wgmma_commit();
      if constexpr (NCH == 2) {  // P^T's fragments free before dS^T's
        wgmma_wait_all();
        fence_regs(av);
      }
      uint32_t df[3][4][4];
      split_frags(dpt, df);
      wgmma_fence();
      six_rs<NCH>(ak, df, qp);  // dK += dS^T.Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(av);
      fence_regs(ak);
      __syncthreads();  // every warpgroup is done with Q's and dO's parts
    }
  }
  const size_t kbase = (size_t)bh * Tk * D;
  store_rows<NCH>(dk + kbase, ak, key_a, Tk, D, cq);
  store_rows<NCH>(dv + kbase, av, key_a, Tk, D, cq);
}

// the tensor maps of f32 q, k, v and dO, and the kernel's shared memory
template <typename Kern>
static int f32_prepare(Kern kern, int smem, CUtensorMap (&m)[4],
                       const void* q, const void* k, const void* v,
                       const void* dout, int BH, int Tq, int Tk, int D) {
  int e;
  if ((e = hop_map_f32(&m[0], q, BH, Tq, D)) ||
      (e = hop_map_f32(&m[1], k, BH, Tk, D)) ||
      (e = hop_map_f32(&m[2], v, BH, Tk, D)) ||
      (e = hop_map_f32(&m[3], dout, BH, Tq, D)))
    return e;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int NCH>
static int launch_dq_f32(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dlt,
                         void* dq, int BH, int Tq, int Tk, int D,
                         float scale, int causal, int diag,
                         cudaStream_t stream) {
  using F = F32Bwd<NCH>;
  CUtensorMap m[4];
  const int e = f32_prepare(fa_bwd_dq_f32_wgmma_kernel<NCH>, F::SMEM, m, q,
                            k, v, dout, BH, Tq, Tk, D);
  if (e) return e;
  const int nq = (Tq + F::ROWS - 1) / F::ROWS;
  fa_bwd_dq_f32_wgmma_kernel<NCH>
      <<<(unsigned)((long long)BH * nq), F::NT, F::SMEM, stream>>>(
          m[0], m[1], m[2], m[3], (const float*)lse, (const float*)dlt,
          (float*)dq, BH, Tq, Tk, D, scale, causal, diag);
  return (int)cudaGetLastError();
}

template <int NCH>
static int launch_dkv_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* dlt, void* dk, void* dv, int BH,
                          int Tq, int Tk, int D, float scale, int causal,
                          int diag, cudaStream_t stream) {
  using F = F32Bwd<NCH>;
  CUtensorMap m[4];
  const int e = f32_prepare(fa_bwd_dkv_f32_wgmma_kernel<NCH>, F::SMEM, m,
                            q, k, v, dout, BH, Tq, Tk, D);
  if (e) return e;
  const int nkt = (Tk + F::ROWS - 1) / F::ROWS;
  fa_bwd_dkv_f32_wgmma_kernel<NCH>
      <<<(unsigned)((long long)BH * nkt), F::NT, F::SMEM, stream>>>(
          m[0], m[1], m[2], m[3], (const float*)lse, (const float*)dlt,
          (float*)dk, (float*)dv, BH, Tq, Tk, D, scale, causal, diag);
  return (int)cudaGetLastError();
}

// D % 8: TMA's 16-byte row stride in bf16 (the wrapper zero-pads D in
// both dtypes); NCH boxes of 64 head-dim columns (D <= 64: 1, else 2)
extern "C" int mxt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dlt, void* dq, int BH, int Tq, int Tk,
    int D, float scale, int causal, int diag, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32)
    return D <= 64 ? launch_dq_f32<1>(q, k, v, dout, lse, dlt, dq, BH, Tq,
                                      Tk, D, scale, causal, diag, s)
                   : launch_dq_f32<2>(q, k, v, dout, lse, dlt, dq, BH, Tq,
                                      Tk, D, scale, causal, diag, s);
  if (dtype == MXT_BF16)
    return D <= 64 ? launch_dq_wgmma<1>(q, k, v, dout, lse, dlt, dq, BH, Tq,
                                        Tk, D, scale, causal, diag, s)
                   : launch_dq_wgmma<2>(q, k, v, dout, lse, dlt, dq, BH, Tq,
                                        Tk, D, scale, causal, diag, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dlt, void* dk, void* dv, int BH, int Tq,
    int Tk, int D, float scale, int causal, int diag, int dtype,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D < 1 || D > 128 || D % 8) return (int)cudaErrorInvalidValue;
  if (dtype == MXT_F32)
    return D <= 64 ? launch_dkv_f32<1>(q, k, v, dout, lse, dlt, dk, dv, BH,
                                       Tq, Tk, D, scale, causal, diag, s)
                   : launch_dkv_f32<2>(q, k, v, dout, lse, dlt, dk, dv, BH,
                                       Tq, Tk, D, scale, causal, diag, s);
  if (dtype == MXT_BF16)
    return D <= 64 ? launch_dkv_wgmma<1>(q, k, v, dout, lse, dlt, dk, dv, BH,
                                         Tq, Tk, D, scale, causal, diag, s)
                   : launch_dkv_wgmma<2>(q, k, v, dout, lse, dlt, dk, dv, BH,
                                         Tq, Tk, D, scale, causal, diag, s);
  return (int)cudaErrorInvalidValue;
}
