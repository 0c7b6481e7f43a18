// The whole recurrence of one layer and direction of the fused RNN op
// (LSTM and GRU), forward and backward, as one persistent launch each;
// called by mxtpu_torch/kernels/rnn_scan.py.
//
// Replaces no Pallas kernel.  mxtpu lowers the RNN op to one lax.scan a
// layer and direction (mxtpu/ndarray/rnn_impl.py _scan_dir, :77-116);
// the port's per-step path (csrc/rnn_cell.cu) issues a torch GEMM
// (h . W_h2h^T) and a cell launch a step, and autograd adds a cell
// backward, two GEMMs and the gradient sums a step: at T 35 some 35
// launches a direction forward and more backward, each shorter than its
// own launch latency, so the host set the layer's time.  Here one
// launch runs every step: the i2h product of every step is hoisted out
// (the wrapper's addmm, as before), and dW_h2h is one GEMM over the
// (T N) rows after the backward launch.
//
// What bounds it: at the LM's width (T 35, N 20, H 1500, G 4 gates) a
// direction's forward is 2 T N G H H = 12.6 GFLOP of recurrent products,
// 0.188 ms at 67 TFLOP/s in f32 (CUDA cores; no TF32, the port keeps
// strict f32), 0.0127 ms in bf16 at 989 TFLOP/s against ~45 MB of bytes
// (0.0135 ms); the backward has the same product count.  The products
// depend on each other step to step, so what the design fights is the
// step's latency: a grid-wide barrier, W_h2h's reads and the h
// exchange.
//
// The design (one shared by the four kernels):
// * Persistence.  One CTA per SM (grid = min(SMs, H)), 256 threads in
//   bf16 and 384 in f32 (the plan's TH), launched with
//   cudaLaunchCooperativeKernel, which refuses a grid that cannot be
//   co-resident (the wrapper raises; a barrier never waits on a CTA that
//   was not scheduled).
// * Work split by hidden unit.  CTA k owns the U_k = H / P (+1 for the
//   first H % P) contiguous units from j0_k = k (H / P) + min(k, H % P);
//   the forward computes all G gate rows g H + j of its units, so the
//   cell and the carried c stay inside the CTA (c in shared memory
//   across all T steps).  The backward splits W_h2h by its COLUMNS (the
//   CTA's units as input units): each CTA sums dh_{t-1}[:, j] over all
//   G H rows itself, in a fixed order, with no atomics.  The row i of a
//   CTA is unit i % U of gate block i / U: W row (i / U) H + j0 + i % U
//   (kernels/rnn_scan.py:unit_slices; tests/test_torch_rnn_scan.py
//   emulates the split at H 1500 and 1003 over 132 CTAs).
// * The batch.  It runs in ceil(N / 32) chunks of CN rows (padded to NB
//   = 8 ceil(CN / 8)), one after another inside the launch, each through
//   every step with its own carried state; the weights are staged once.
// * Weights.  bf16: the CTA's slice of W_h2h (its G U rows forward, its
//   U columns backward, 144 KB a CTA at H 1500) is loaded into shared
//   memory once and stays there for every step.  f32: the slice is 288
//   KB, over the 227 KB a CTA has.  Its first KW columns are staged in
//   shared memory once a launch; the rest is copied from device memory
//   (L2: W is 36 MB of the 50 MB) a chunk a step beside the state, into
//   the double buffer the products read.  The plan (scan_plan) gives the
//   buffers the widest chunk that fits (384 columns) and the staged
//   share what is left: at H 1500 none forward, 2432 of 6016 columns
//   backward.  What the share buys, on an H100 (chip_smoke.py's
//   rnn_scan_times and rnn_scan_step_costs, staged against every column
//   copied, kw = 0): within a few per cent either way; a forward step
//   adds ~26 us at N 20 either way.  The f32 step is bound by the
//   products' operand loads and FMAs, not by W's reads.
// * Each step.  bf16: mma.sync m16n8k16 with f32 accumulators, swap-AB
//   (the CTA's weight rows are M, the padded batch NB is N), the 8 warps
//   splitting K, their partial tiles summed in warp order through shared
//   memory; the B fragments are read straight from the exchange buffer
//   as 16-byte loads, each lane's 8 contiguous elements feeding two k16
//   products (the same permutation of k on A and B).  f32: register
//   tiles, a lane RL rows x CL batch columns (6 x 6 at the LM's N 20),
//   rows in passes of RP, both operands from shared memory, K split
//   between lanes and warps, the partials summed by shuffles and then in
//   warp order (prod_f32).
//   Then the cell for the CTA's (unit, batch) pairs, h_t (or dhh_t)
//   written to its output and to the exchange ring, and one grid-wide
//   barrier.
// * Exchange and memory order.  h_t (forward) and dhh_t (backward) are
//   exchanged through a ring of two zero-padded buffers, (NB, KB) each
//   (KB = 32 ceil(K / 32)), allocated by the wrapper with torch.zeros,
//   so padded columns read as 0 and every vector load is aligned (ys
//   itself is not, at odd H); the forward's first step of batch chunk c
//   reads the chunk's h0 from slot 2 + c.  Step s writes slot s & 1 and
//   reads slot (s + 1) & 1: a CTA that runs ahead never overwrites what
//   another still reads; a barrier also closes a chunk's last step, so
//   the next chunk's first step never writes a slot still being read.
//   (A later chunk of fewer rows leaves the previous chunk's values in
//   the padded rows; they reach only padded output columns.)  The
//   barrier is a counter the wrapper zeroes: __syncthreads, then one
//   thread adds with red.release.gpu and spins on ld.acquire.gpu until
//   every CTA of the step arrived, then __syncthreads (CUTLASS's grid
//   barrier).  The exchanged values change inside the launch, so they
//   are read with ld.global.cg / cp.async.cg (L2, never a stale L1
//   line); only what no CTA writes goes through the read-only path.
// * Rounding points follow the plain scan (kernels/rnn_scan.py): in bf16
//   h.W^T (and dhh.W) is rounded to bf16 as torch.matmul's output is,
//   before the add; the activations, the saved gates and the carried dc
//   stay f32; c is carried rounded to the type, as the plain step's c.
//   Every sum runs in a fixed order, so two calls are bit-equal.
//
// Limits (kernels/rnn_scan.py:scan_plan, the only place the plan is
// reckoned; the launch checks what its indexing needs, plan_ok): any N;
// bf16 the CTA's rows G ceil(H / P) <= 64 (4 M tiles) and the weight
// slice within 227 KB of shared memory (LSTM H up to 1632 at a batch
// chunk of <= 24 rows, 1584 at 32; the GRU's 1980 and 1888); f32 a plan
// whose smallest chunk (32 columns) fits (LSTM H up to 43560 at N 20 on
// 132 SMs).  Other shapes take the per-step cell kernels.
//
// Layouts (row-major, contiguous, checked by the wrapper; t is time):
//   forward:  pre (T, N, G H); wp: W_h2h (G H, H) packed a CTA a block
//             (rows i of CTA k = W rows (i / U) H + j0 + i % U; bf16
//             [R][KB] for stage_w, f32 [KB / 4][R][4] for prod_f32);
//             b_rn (H), GRU; c0 (N, H), LSTM; hx (2 + chunks, NB, KB)
//             zeros but chunk c's h0 in slot 2 + c -> ys (T, N, H), hT,
//             cT (N, H), saved (T, N, 4 H) f32 (LSTM: sig i, sig f, tanh
//             g, sig o; GRU: r, z, n, hh_n + b_rn), cs (T, N, H) = c_t,
//             LSTM
//   backward: dy (T, N, H), dhT, dcT (N, H), saved, cs, c0 (LSTM), ys, h0
//             (GRU), wp (CTA k's rows u = W's columns j0 + u, k over
//             W's G H rows), dx (2, NB, KB) zeros -> dpre (T, N, G H), dhh
//             (T, N, G H) (GRU; for the LSTM dhh = dpre), dh0, dc0 (N, H)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int THREADS = 256;         // bf16's CTA
constexpr int WARPS = THREADS / 32;
constexpr int F32_THREADS_MAX = 384;  // f32's CTA (the plan's TH) at most
constexpr int SMEM_MAX = 232448;  // a CTA's shared memory on sm_90
constexpr int MT_MAX = 4;         // M tiles of 16 rows (bf16)
enum { LSTM = 0, GRU = 1 };

// ---------------------------------------------------------------------
// the plan: shared-memory carve and work split, computed on the host
// (kernels/rnn_scan.py:scan_plan, the one place it is reckoned) and
// passed as PLAN_INTS ints in this order
// ---------------------------------------------------------------------
struct Plan {
  int R, RP, NB, K, KB, KST, KC, KW, RG, CG, KSI, RL, CL, HALF;
  int off_red, off_out, off_st, bytes, CN, TH;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

// what the kernels' indexing needs of a plan (else the launch is refused)
inline bool plan_ok(const Plan& p, int bf, int N, int H, int grid) {
  const bool f32 = p.RG >= 1 && p.CG >= 1 && p.KSI >= 1 &&
                   p.RG * p.CG * p.KSI == 32 && p.RP == p.RG * p.RL &&
                   (p.RL == 2 || p.RL == 4 || p.RL == 6 || p.RL == 8) &&
                   (p.CL == 6 || p.CL == 8) && p.CL * p.CG == p.NB &&
                   p.KC >= 32 && p.KC % 32 == 0 && p.KW >= 0 &&
                   p.KW % 32 == 0 && p.KW <= p.KB &&
                   p.HALF >= p.NB * (p.KC + 4) &&
                   (p.KW == p.KB || p.HALF >= p.NB * (p.KC + 4) + p.KC * p.RP);
  const bool b16 = p.RP % 16 == 0 && p.RP <= 16 * MT_MAX && p.R <= p.RP &&
                   p.KST >= p.KB && p.KST % 8 == 0;
  return N >= 1 && H >= 1 && grid >= 1 && grid <= H && p.CN >= 1 &&
         (bf ? p.TH == THREADS : p.TH % 32 == 0 && p.TH >= 32 &&
                                     p.TH <= F32_THREADS_MAX) &&
         p.CN <= p.NB && p.NB % 8 == 0 && p.NB <= 32 && p.KB % 32 == 0 &&
         p.K <= p.KB && p.bytes <= SMEM_MAX && (bf ? b16 : f32);
}

// ---------------------------------------------------------------------
// element access
// ---------------------------------------------------------------------
__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// a value another CTA wrote in this launch: from L2, never from L1
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const bf16* p) {
  unsigned short v;
  asm volatile("ld.global.cg.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __bfloat162float(__ushort_as_bfloat16(v));
}
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.sigmoid's 1 / (1 + exp(-x)), as csrc/rnn_cell.cu
__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// the CTA's writes before __syncthreads are ordered before thread 0's
// release (bar.sync, then red.release.gpu: cumulative), and every read
// after the closing __syncthreads after its acquire; CUTLASS's grid
// barrier (cutlass/barrier.h) is the same pattern
__device__ __forceinline__ void grid_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr)
                 : "memory");
    // co-residency makes every CTA arrive; a barrier still waiting
    // after ~10 s traps (the launch fails) rather than hang the card
    for (unsigned spins = 0;; ++spins) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(ctr)
                   : "memory");
      if (v >= target) break;
      if (spins > (1u << 24)) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------
// out[i][n] = sum_k A[i][k] B[n][k] for the CTA's rows i < R, bf16 on the
// tensor cores.  A: shared [R][KST]; B: the exchange slot in device
// memory, [NB][KB].  Lane (g = lane / 4, q = lane % 4) reads the 16
// bytes at k = 32 kb + 8 q of its rows: elements 0-3 are its k16
// fragment of the first product (a0/a2, b0/b1 pairs), 4-7 of the second;
// A and B share that permutation, so each product sums its 16 k once.
// Warp w owns k blocks [w nkb / 8, (w + 1) nkb / 8); the 8 partial tiles
// are summed in warp order.
// ---------------------------------------------------------------------
template <int NT>
__device__ void prod_bf16(const bf16* As, const Plan& pl, int R,
                          const bf16* Bg, float* red, float* out) {
  constexpr int NB = NT * 8;
  constexpr int KBB = NT <= 2 ? 8 : (NT == 3 ? 6 : 4);  // B loads in flight
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int MT = pl.RP / 16, nkb = pl.KB / 32, KST = pl.KST;
  const int lo = w * nkb / WARPS, hi = (w + 1) * nkb / WARPS;
  float acc[MT_MAX][NT][4];
#pragma unroll
  for (int m = 0; m < MT_MAX; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.0f;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int kb0 = lo; kb0 < hi; kb0 += KBB) {
    uint4 b[KBB][NT];
#pragma unroll
    for (int d = 0; d < KBB; ++d)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        b[d][n] = kb0 + d < hi
                      ? __ldcg(reinterpret_cast<const uint4*>(
                            Bg + (size_t)(n * 8 + g) * pl.KB +
                            (kb0 + d) * 32 + q * 8))
                      : zero;
#pragma unroll
    for (int d = 0; d < KBB; ++d) {
      if (kb0 + d >= hi) break;
      const int kc = (kb0 + d) * 32 + q * 8;
#pragma unroll
      for (int m = 0; m < MT_MAX; ++m) {
        if (m >= MT) break;
        const int r0 = m * 16 + g, r1 = r0 + 8;
        const uint4 a0 = r0 < R ? *reinterpret_cast<const uint4*>(
                                      As + (size_t)r0 * KST + kc)
                                : zero;
        const uint4 a1 = r1 < R ? *reinterpret_cast<const uint4*>(
                                      As + (size_t)r1 * KST + kc)
                                : zero;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma16816(acc[m][n], a0.x, a1.x, a0.y, a1.y, b[d][n].x, b[d][n].y);
          mma16816(acc[m][n], a0.z, a1.z, a0.w, a1.w, b[d][n].z, b[d][n].w);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT_MAX; ++m) {
    if (m >= MT) break;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int row = m * 16 + g, col = n * 8 + q * 2;
      float* r0 = red + ((size_t)w * pl.RP + row) * NB + col;
      float* r1 = r0 + 8 * NB;
      r0[0] = acc[m][n][0];
      r0[1] = acc[m][n][1];
      r1[0] = acc[m][n][2];
      r1[1] = acc[m][n][3];
    }
  }
  __syncthreads();
  for (int e = tid; e < R * NB; e += THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w2 = 0; w2 < WARPS; ++w2) s += red[(size_t)w2 * pl.RP * NB + e];
    out[e] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// all but the newest committed group done
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// out[i][n] = sum_k A[i][k] B[n][k] for the CTA's rows i < R, f32 on the
// CUDA cores, in register tiles.  A: the CTA's block of the packed
// weights, [KB / 4][pl.R][4] (rup(K, 32) / 4 groups of 4 k, each the
// CTA's rows side by side, zero past K and past the CTA's rows;
// kernels/rnn_scan.py packs it): its first KW columns staged in shared
// memory once a launch (Ws, the same layout), the rest copied a chunk at
// a time beside the state's.  B: the exchange slot, [NB][KB].  A step
// walks k in chunks of at most KC columns (never straddling KW), each
// copied with cp.async.cg into one of two buffers of HALF floats (the
// state [NB][KC + 4], then past KW the chunk's weight rows [KC / 4][RP]
// [4]) while the other buffer's chunk is summed; red shares their space.
// The rows run in passes of RP = RG RL.  Lane l of warp w: rest = l %
// (RG CG) gives rows rg + i RG (i < RL) of the pass and columns cg + j CG
// (j < CL) of the batch, rg = rest % RG, cg = rest / RG; its k phase is
// w KSI + l / (RG CG) of KS = 8 KSI, walking 4-k groups q = phase,
// phase + KS, ...  A lane's RL x CL tile costs RL + CL 16-byte loads for
// 4 RL CL FMAs (the SM's loads deliver 128 bytes a clock, its FMAs 128,
// so RL, CL >= 6 keep the FMAs the bound); the KSI phases of a warp are
// summed by shuffles in a fixed order, the 8 warps' through red in warp
// order.
// ---------------------------------------------------------------------
template <int RL, int CL>
__device__ void prod_f32(const float* __restrict__ Ag, const float* Ws,
                         const Plan& pl, int R, const float* Bg, float* buf,
                         float* red, float* out) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int RG = pl.RG, CG = pl.CG, RC = RG * CG, RP = pl.RP, NB = pl.NB;
  const int KB = pl.KB, KC = pl.KC, KW = pl.KW, RA = pl.R, BS = KC + 4;
  const int nw = blockDim.x >> 5, KS = nw * pl.KSI;
  const int phase = w * pl.KSI + lane / RC;
  const int rest = lane % RC, rg = rest % RG, cg = rest / RG;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto last = [&](int k) { return min(k + KC, k < KW ? KW : KB); };
  for (int r0 = 0; r0 < R; r0 += RP) {
    // chunk c of the state (and past KW of the pass's weight rows) into
    // buffer c & 1
    auto fetch = [&](int c, int k0, int k1) {
      const int per = (k1 - k0) / 4;
      float* b = buf + (size_t)(c & 1) * pl.HALF;
      for (int e = tid; e < NB * per; e += blockDim.x) {
        const int n = e / per, q = e - n * per;
        cp_async16(b + (size_t)n * BS + 4 * q,
                   Bg + (size_t)n * KB + k0 + 4 * q);
      }
      if (k0 >= KW) {
        const int rows = min(RP, RA - r0);
        float* a = b + (size_t)NB * BS;
        for (int e = tid; e < per * rows; e += blockDim.x) {
          const int q = e / rows, i = e - q * rows;
          cp_async16(a + ((size_t)q * RP + i) * 4,
                     Ag + ((size_t)(k0 / 4 + q) * RA + r0 + i) * 4);
        }
      }
      cp_async_commit();
    };
    float acc[RL][CL];
#pragma unroll
    for (int i = 0; i < RL; ++i)
#pragma unroll
      for (int j = 0; j < CL; ++j) acc[i][j] = 0.0f;
    int k0 = 0, k1 = last(0);
    fetch(0, k0, k1);
    for (int c = 0; k0 < KB; ++c) {
      const int k2 = k1 < KB ? last(k1) : KB;
      if (k1 < KB) {
        fetch(c + 1, k1, k2);
        cp_async_wait_one();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      const int per = (k1 - k0) / 4;
      const float* b = buf + (size_t)(c & 1) * pl.HALF;
      // the weights: staged (rows r0 + ..., stride RA) or this chunk's
      // copy (rows 0 .., stride RP)
      const bool staged = k0 < KW;
      const float4* A = staged
          ? reinterpret_cast<const float4*>(Ws) + (size_t)(k0 / 4) * RA + r0
          : reinterpret_cast<const float4*>(b + (size_t)NB * BS);
      const int as = staged ? RA : RP;
      for (int q = phase; q < per; q += KS) {
        float4 a[RL], x[CL];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const int row = rg + i * RG;
          a[i] = r0 + row < RA ? A[(size_t)q * as + row] : zero;
        }
#pragma unroll
        for (int j = 0; j < CL; ++j)
          x[j] = *reinterpret_cast<const float4*>(
              b + (size_t)(cg + j * CG) * BS + 4 * q);
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < CL; ++j) {
            float s = acc[i][j];
            s = fmaf(a[i].x, x[j].x, s);
            s = fmaf(a[i].y, x[j].y, s);
            s = fmaf(a[i].z, x[j].z, s);
            s = fmaf(a[i].w, x[j].w, s);
            acc[i][j] = s;
          }
      }
      __syncthreads();  // buffer c & 1 (and red, its space) free again
      k0 = k1;
      k1 = k2;
    }
    // the warp's k phases, then the warps' partials, in a fixed order
    for (int m = RC; m < 32; m <<= 1)
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < CL; ++j)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], m);
    if (lane < RC)
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < CL; ++j)
          red[((size_t)w * RP + rg + i * RG) * NB + cg + j * CG] = acc[i][j];
    __syncthreads();
    const int rows = min(RP, R - r0);
    for (int e = tid; e < rows * NB; e += blockDim.x) {
      float s = 0.0f;
      for (int w2 = 0; w2 < nw; ++w2) s += red[(size_t)w2 * RP * NB + e];
      out[(size_t)r0 * NB + e] = s;
    }
    __syncthreads();
  }
}

// the weights' on-chip share, once a launch, from the CTA's block of the
// packed weights (kernels/rnn_scan.py packs it; forward its rows i = W
// rows (i / U) H + j0 + i % U, backward its rows u = W's columns j0 + u,
// zero past K and past the CTA's rows): bf16 all of [pl.R][KB], as
// 16-byte words into rows of KST; f32 the first KW columns, [KW / 4][pl.R]
// [4] as they lie
__device__ void stage_w(const bf16* __restrict__ wp, bf16* As,
                        const Plan& pl, int R) {
  const int words = pl.KB / 8;
  const uint4* src = reinterpret_cast<const uint4*>(wp);
  for (int e = threadIdx.x; e < R * words; e += blockDim.x) {
    const int i = e / words, c = e - i * words;
    *reinterpret_cast<uint4*>(As + (size_t)i * pl.KST + 8 * c) = src[e];
  }
  __syncthreads();
}
__device__ void stage_w(const float* __restrict__ wp, float* As,
                        const Plan& pl, int) {
  const int words = pl.KW / 4 * pl.R;
  const float4* src = reinterpret_cast<const float4*>(wp);
  for (int e = threadIdx.x; e < words; e += blockDim.x)
    reinterpret_cast<float4*>(As)[e] = __ldg(src + e);
  __syncthreads();
}

// h . W_slice^T (or dhh . W[:, slice]) of one step into out: bf16 on the
// tensor cores (P1 = NB / 8), f32 in P1 x P2 register tiles
template <typename T, int P1, int P2>
__device__ __forceinline__ void product(const T* wp, unsigned char* smem,
                                        const Plan& pl, int R, const T* Bg,
                                        float* red, float* out) {
  if constexpr (sizeof(T) == 2)
    prod_bf16<P1>(reinterpret_cast<const bf16*>(smem), pl, R, Bg, red, out);
  else
    prod_f32<P1, P2>(wp, reinterpret_cast<const float*>(smem), pl, R, Bg,
                     red, red, out);
}

struct FwdArgs {
  const void* pre;
  const void* wp;
  const void* b_rn;
  const void* c0;
  void* hx;
  void* ys;
  void* hT;
  void* cT;
  float* saved;
  void* cs;
  unsigned* bar;
  int T, N, H, reverse;
  Plan pl;
};

struct BwdArgs {
  const void* dy;
  const void* dhT;
  const void* dcT;
  const float* saved;
  const void* cs;
  const void* c0;
  const void* ys;
  const void* h0;
  const void* wp;
  void* dx;
  void* dpre;
  void* dhh;
  void* dh0;
  void* dc0;
  unsigned* bar;
  int T, N, H, reverse;
  Plan pl;
};

// The batch runs in chunks of at most CN rows (one chunk where N <= 32),
// one after another in the launch: the weights are staged once, and each
// chunk runs every step with its own carried state.  A barrier closes
// every step but the launch's last, so that a chunk's first step never
// writes a slot of the ring that a CTA still reads for the chunk before.
template <typename T, int MODE, int P1, int P2>
__device__ void scan_fwd(const FwdArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = MODE == LSTM ? 4 : 3;
  const int P = gridDim.x, k = blockIdx.x, N = a.N, H = a.H, TT = a.T;
  const int base = H / P, rem = H % P;
  const int U = base + (k < rem), j0 = k * base + min(k, rem), R = G * U;
  const Plan& pl = a.pl;
  const int KB = pl.KB, CN = pl.CN, NB = pl.NB;
  float* red = reinterpret_cast<float*>(smem + pl.off_red);
  float* out = reinterpret_cast<float*>(smem + pl.off_out);
  float* cst = reinterpret_cast<float*>(smem + pl.off_st);
  const T* pre = static_cast<const T*>(a.pre);
  const T* wp = static_cast<const T*>(a.wp) + (size_t)k * pl.R * KB;
  T* hx = static_cast<T*>(a.hx);
  T* ys = static_cast<T*>(a.ys);
  T* cs = static_cast<T*>(a.cs);
  stage_w(wp, reinterpret_cast<T*>(smem), pl, R);
  unsigned arrived = 0;
  for (int n0 = 0; n0 < N; n0 += CN) {
    const int nc = min(CN, N - n0);
    const bool last = n0 + CN >= N;
    if (MODE == LSTM)
      for (int e = threadIdx.x; e < U * nc; e += blockDim.x) {
        const int n = e / U, u = e - n * U;
        cst[u * NB + n] =
            ld(static_cast<const T*>(a.c0), (int64_t)(n0 + n) * H + j0 + u);
      }
    __syncthreads();
    for (int s = 0; s < TT; ++s) {
      const int t = a.reverse ? TT - 1 - s : s;
      // step 0 reads the chunk's h0 (slot 2 + chunk), step s > 0 the slot
      // step s - 1 wrote
      const T* hprev =
          hx + (size_t)(s == 0 ? 2 + n0 / CN : (s + 1) & 1) * NB * KB;
      T* hcur = hx + (size_t)(s & 1) * NB * KB;
      product<T, P1, P2>(wp, smem, pl, R, hprev, red, out);
      for (int e = threadIdx.x; e < U * nc; e += blockDim.x) {
        const int n = e / U, u = e - n * U, j = j0 + u;
        const int64_t row = (int64_t)t * N + n0 + n;
        const int64_t pr = row * G * H + j, sv = row * 4 * H + j,
                      hi = row * H + j, fin = (int64_t)(n0 + n) * H + j;
        float h;
        if (MODE == LSTM) {
          const float gi = sigm(ld(pre, pr) + rnd<T>(out[u * NB + n]));
          const float gf =
              sigm(ld(pre, pr + H) + rnd<T>(out[(U + u) * NB + n]));
          const float gg =
              tanhf(ld(pre, pr + 2 * H) + rnd<T>(out[(2 * U + u) * NB + n]));
          const float go =
              sigm(ld(pre, pr + 3 * H) + rnd<T>(out[(3 * U + u) * NB + n]));
          const float c2 = gf * cst[u * NB + n] + gi * gg;
          cst[u * NB + n] = rnd<T>(c2);
          h = go * tanhf(c2);
          st(cs, hi, c2);
          a.saved[sv] = gi;
          a.saved[sv + H] = gf;
          a.saved[sv + 2 * H] = gg;
          a.saved[sv + 3 * H] = go;
          if (s == TT - 1) st(static_cast<T*>(a.cT), fin, c2);
        } else {
          const float r = sigm(ld(pre, pr) + rnd<T>(out[u * NB + n]));
          const float z =
              sigm(ld(pre, pr + H) + rnd<T>(out[(U + u) * NB + n]));
          const float hn = rnd<T>(out[(2 * U + u) * NB + n]) +
                           ld(static_cast<const T*>(a.b_rn), j);
          const float nv = tanhf(ld(pre, pr + 2 * H) + r * hn);
          h = (1.0f - z) * nv + z * ldcg(hprev + (size_t)n * KB + j);
          a.saved[sv] = r;
          a.saved[sv + H] = z;
          a.saved[sv + 2 * H] = nv;
          a.saved[sv + 3 * H] = hn;
        }
        st(ys, hi, h);
        st(hcur, (int64_t)n * KB + j, h);
        if (s == TT - 1) st(static_cast<T*>(a.hT), fin, h);
      }
      if (!(last && s == TT - 1)) grid_barrier(a.bar, ++arrived * P);
    }
  }
}

template <typename T, int MODE, int P1, int P2>
__device__ void scan_bwd(const BwdArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = MODE == LSTM ? 4 : 3;
  const int P = gridDim.x, k = blockIdx.x, N = a.N, H = a.H, TT = a.T;
  const int base = H / P, rem = H % P;
  const int U = base + (k < rem), j0 = k * base + min(k, rem);
  const Plan& pl = a.pl;
  const int KB = pl.KB, CN = pl.CN, NB = pl.NB;
  const int umax = base + (rem > 0);
  float* red = reinterpret_cast<float*>(smem + pl.off_red);
  float* rec = reinterpret_cast<float*>(smem + pl.off_out);
  float* dcs = reinterpret_cast<float*>(smem + pl.off_st);  // LSTM's dc
  float* dir = dcs + umax * NB;                              // GRU's z dh
  const T* dy = static_cast<const T*>(a.dy);
  const T* cs = static_cast<const T*>(a.cs);
  const T* ys = static_cast<const T*>(a.ys);
  const T* wp = static_cast<const T*>(a.wp) + (size_t)k * pl.R * KB;
  T* dx = static_cast<T*>(a.dx);
  T* dpre = static_cast<T*>(a.dpre);
  T* dhh = static_cast<T*>(a.dhh);
  stage_w(wp, reinterpret_cast<T*>(smem), pl, U);
  unsigned arrived = 0;
  for (int n0 = 0; n0 < N; n0 += CN) {
    const int nc = min(CN, N - n0);
    for (int e = threadIdx.x; e < U * nc; e += blockDim.x) {
      const int n = e / U, u = e - n * U;
      dcs[u * NB + n] = MODE == LSTM
          ? ld(static_cast<const T*>(a.dcT), (int64_t)(n0 + n) * H + j0 + u)
          : 0.0f;
      dir[u * NB + n] = 0.0f;
    }
    __syncthreads();
    for (int p = 0; p <= TT; ++p) {
      if (p > 0)  // rec = dhh_{later step} . W[:, slice], rounded to T
        product<T, P1, P2>(wp, smem, pl, U,
                           dx + (size_t)((p + 1) & 1) * NB * KB, red, rec);
      if (p == TT) break;
      const int s = TT - 1 - p;                  // the forward's step index
      const int t = a.reverse ? TT - 1 - s : s;  // its time
      const int tp = a.reverse ? t + 1 : t - 1;  // the time of step s - 1
      T* dcur = dx + (size_t)(p & 1) * NB * KB;
      for (int e = threadIdx.x; e < U * nc; e += blockDim.x) {
        const int n = e / U, u = e - n * U, j = j0 + u, ng = n0 + n;
        const int64_t row = (int64_t)t * N + ng, hi = row * H + j;
        const int64_t pr = row * G * H + j, sv = row * 4 * H + j;
        const float x = p == 0 ? ld(static_cast<const T*>(a.dhT),
                                    (int64_t)ng * H + j)
                               : rnd<T>(rec[u * NB + n]);
        const float dhv = (ld(dy, hi) + x) + dir[u * NB + n];
        if (MODE == LSTM) {
          const float gi = a.saved[sv], gf = a.saved[sv + H],
                      gg = a.saved[sv + 2 * H], go = a.saved[sv + 3 * H];
          const float cp = s == 0 ? ld(static_cast<const T*>(a.c0),
                                       (int64_t)ng * H + j)
                                  : ld(cs, ((int64_t)tp * N + ng) * H + j);
          const float tc = tanhf(ld(cs, hi));
          const float dct = dcs[u * NB + n] + dhv * go * (1.0f - tc * tc);
          const float d0 = dct * gg * gi * (1.0f - gi);
          const float d1 = dct * cp * gf * (1.0f - gf);
          const float d2 = dct * gi * (1.0f - gg * gg);
          const float d3 = dhv * tc * go * (1.0f - go);
          dcs[u * NB + n] = dct * gf;
          st(dpre, pr, d0);
          st(dpre, pr + H, d1);
          st(dpre, pr + 2 * H, d2);
          st(dpre, pr + 3 * H, d3);
          T* dr = dcur + (size_t)n * KB + j;
          st(dr, 0, d0);
          st(dr, H, d1);
          st(dr, 2 * H, d2);
          st(dr, 3 * H, d3);
        } else {
          const float r = a.saved[sv], z = a.saved[sv + H],
                      nv = a.saved[sv + 2 * H], hn = a.saved[sv + 3 * H];
          const float hp = s == 0 ? ld(static_cast<const T*>(a.h0),
                                       (int64_t)ng * H + j)
                                  : ld(ys, ((int64_t)tp * N + ng) * H + j);
          const float dn = dhv * (1.0f - z) * (1.0f - nv * nv);
          const float dz = dhv * (hp - nv) * z * (1.0f - z);
          const float dr_ = dn * hn * r * (1.0f - r);
          dir[u * NB + n] = dhv * z;
          st(dpre, pr, dr_);
          st(dpre, pr + H, dz);
          st(dpre, pr + 2 * H, dn);
          st(dhh, pr, dr_);
          st(dhh, pr + H, dz);
          st(dhh, pr + 2 * H, dn * r);
          T* dq = dcur + (size_t)n * KB + j;
          st(dq, 0, dr_);
          st(dq, H, dz);
          st(dq, 2 * H, dn * r);
        }
      }
      grid_barrier(a.bar, ++arrived * P);
    }
    for (int e = threadIdx.x; e < U * nc; e += blockDim.x) {
      const int n = e / U, u = e - n * U, j = j0 + u;
      const int64_t fin = (int64_t)(n0 + n) * H + j;
      st(static_cast<T*>(a.dh0), fin,
         rnd<T>(rec[u * NB + n]) + dir[u * NB + n]);
      if (MODE == LSTM) st(static_cast<T*>(a.dc0), fin, dcs[u * NB + n]);
    }
    if (n0 + CN < N) grid_barrier(a.bar, ++arrived * P);
  }
}

// the kernels (one name each, for the profiler); bf16 <NT, 0>, f32 <RL,
// CL>
template <typename T, int P1, int P2>
__global__ void __launch_bounds__(sizeof(T) == 2 ? THREADS : F32_THREADS_MAX, 1)
    lstm_scan_fwd_kernel(FwdArgs a) {
  scan_fwd<T, LSTM, P1, P2>(a);
}
template <typename T, int P1, int P2>
__global__ void __launch_bounds__(sizeof(T) == 2 ? THREADS : F32_THREADS_MAX, 1)
    gru_scan_fwd_kernel(FwdArgs a) {
  scan_fwd<T, GRU, P1, P2>(a);
}
template <typename T, int P1, int P2>
__global__ void __launch_bounds__(sizeof(T) == 2 ? THREADS : F32_THREADS_MAX, 1)
    lstm_scan_bwd_kernel(BwdArgs a) {
  scan_bwd<T, LSTM, P1, P2>(a);
}
template <typename T, int P1, int P2>
__global__ void __launch_bounds__(sizeof(T) == 2 ? THREADS : F32_THREADS_MAX, 1)
    gru_scan_bwd_kernel(BwdArgs a) {
  scan_bwd<T, GRU, P1, P2>(a);
}

template <typename Args>
int launch(const void* kern, const Args& a, int grid, void* stream) {
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.pl.bytes);
  if (e == cudaSuccess) {
    void* args[] = {const_cast<Args*>(&a)};
    e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(a.pl.TH), args,
                                    (size_t)a.pl.bytes, (cudaStream_t)stream);
  }
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(e != cudaSuccess ? e : last);
}

template <typename T, int P1, int P2>
const void* kernel(int fwd, int mode) {
  if (fwd)
    return mode == LSTM ? (const void*)lstm_scan_fwd_kernel<T, P1, P2>
                        : (const void*)gru_scan_fwd_kernel<T, P1, P2>;
  return mode == LSTM ? (const void*)lstm_scan_bwd_kernel<T, P1, P2>
                      : (const void*)gru_scan_bwd_kernel<T, P1, P2>;
}

const void* pick(int bf, int fwd, int mode, const Plan& p) {
  if (bf) {
    switch (p.NB / 8) {
      case 1: return kernel<bf16, 1, 0>(fwd, mode);
      case 2: return kernel<bf16, 2, 0>(fwd, mode);
      case 3: return kernel<bf16, 3, 0>(fwd, mode);
      case 4: return kernel<bf16, 4, 0>(fwd, mode);
    }
    return nullptr;
  }
  const int key = p.RL * 10 + p.CL;
  switch (key) {
    case 26: return kernel<float, 2, 6>(fwd, mode);
    case 28: return kernel<float, 2, 8>(fwd, mode);
    case 46: return kernel<float, 4, 6>(fwd, mode);
    case 48: return kernel<float, 4, 8>(fwd, mode);
    case 66: return kernel<float, 6, 6>(fwd, mode);
    case 68: return kernel<float, 6, 8>(fwd, mode);
    case 86: return kernel<float, 8, 6>(fwd, mode);
    case 88: return kernel<float, 8, 8>(fwd, mode);
  }
  return nullptr;
}

// the plan's ints (n of them) into a Plan, or false where they are not
// one the kernels can run
bool read_plan(const int* ints, int n, int bf, int N, int H, int grid,
               Plan* pl) {
  if (n != PLAN_INTS) return false;
  memcpy(pl, ints, sizeof(Plan));
  return plan_ok(*pl, bf, N, H, grid);
}

}  // namespace

extern "C" int mxt_rnn_scan_plan_ints() { return PLAN_INTS; }

extern "C" int mxt_rnn_scan_fwd(int mode, int is_bf16, const int* plan,
                                int n_plan, const void* pre, const void* wp,
                                const void* b_rn, const void* c0, void* hx,
                                void* ys, void* hT, void* cT, void* saved,
                                void* cs, void* bar, int T, int N, int H,
                                int reverse, int grid, void* stream) {
  FwdArgs a = {pre, wp, b_rn, c0, hx, ys, hT, cT, (float*)saved,
               cs, (unsigned*)bar, T, N, H, reverse, {}};
  if (!read_plan(plan, n_plan, is_bf16, N, H, grid, &a.pl) || T <= 0 ||
      (mode != LSTM && mode != GRU))
    return (int)cudaErrorInvalidValue;
  return launch(pick(is_bf16, 1, mode, a.pl), a, grid, stream);
}

extern "C" int mxt_rnn_scan_bwd(int mode, int is_bf16, const int* plan,
                                int n_plan, const void* dy, const void* dhT,
                                const void* dcT, const void* saved,
                                const void* cs, const void* c0,
                                const void* ys, const void* h0,
                                const void* wp, void* dx, void* dpre,
                                void* dhh, void* dh0, void* dc0, void* bar,
                                int T, int N, int H, int reverse, int grid,
                                void* stream) {
  BwdArgs a = {dy, dhT, dcT, (const float*)saved, cs, c0, ys, h0,
               wp, dx, dpre, dhh, dh0, dc0, (unsigned*)bar, T, N, H,
               reverse, {}};
  if (!read_plan(plan, n_plan, is_bf16, N, H, grid, &a.pl) || T <= 0 ||
      (mode != LSTM && mode != GRU))
    return (int)cudaErrorInvalidValue;
  return launch(pick(is_bf16, 0, mode, a.pl), a, grid, stream);
}
