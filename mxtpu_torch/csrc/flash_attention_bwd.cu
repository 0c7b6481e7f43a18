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
// bf16: fa_bwd_dq_wgmma_kernel and fa_bwd_dkv_wgmma_kernel, on the
// tensor cores (below); f32: the scalar kernels described here.
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
// The scalar (f32) kernels do their products as f32 FMAs from shared
// memory.
#include "common.cuh"
#include "hopper.cuh"

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
    if (D % 8) return (int)cudaErrorInvalidValue;  // the wrapper pads
    return D <= 64 ? launch_dq_wgmma<1>(q, k, v, dout, lse, dlt, dq, BH, Tq,
                                        Tk, D, scale, causal, diag, s)
                   : launch_dq_wgmma<2>(q, k, v, dout, lse, dlt, dq, BH, Tq,
                                        Tk, D, scale, causal, diag, s);
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
    if (D % 8) return (int)cudaErrorInvalidValue;  // the wrapper pads
    return D <= 64 ? launch_dkv_wgmma<1>(q, k, v, dout, lse, dlt, dk, dv, BH,
                                         Tq, Tk, D, scale, causal, diag, s)
                   : launch_dkv_wgmma<2>(q, k, v, dout, lse, dlt, dk, dv, BH,
                                         Tq, Tk, D, scale, causal, diag, s);
  }
  return (int)cudaErrorInvalidValue;
}
