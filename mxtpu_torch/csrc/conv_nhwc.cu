// 2-D convolution over NHWC data, stride 1, no dilation, zero padding of
// KH/2 rows and KW/2 columns on each side, output H x W:
//   y[n][h][w][o] = sum_{kh, kw, c} xp[n][h + kh][w + kw][c] * w[kh][kw][c][o]
// x (N, H, W, C), w (KH, KW, C, O) HWIO, y (N, H, W, O) in x's type,
// products and sums in f32.
//
// Replaces tools/probe_conv_strategies.py:pallas_conv (its body
// _conv_kernel): the TPU kernel pads x in HBM, stages a block of bn whole
// images and all of w in VMEM and accumulates KH*KW shifted (bn*H*W, C) x
// (C, O) MXU products into an f32 VMEM scratch.  On the H100 it is an
// implicit GEMM, M = N*H*W output pixels by O outputs over K = KH*KW*C:
// each CTA owns an output tile and walks (kh, kw, C-chunk) in one loop.
// The padding is predicated inside the loads (a load that falls off the
// image fills zeros), so no padded copy of x is written to HBM.  For an
// even kernel this keeps the reference's convention (pad KH/2 on both
// sides, keep the top-left H x W), which is not XLA's SAME.
//
// bf16: 128 x 128 output tile per CTA of 8 warps (each 64 x 32), K in
// chunks of 32; A (the gathered pixels) and B (w's rows) go through a
// 3-stage cp.async ring in shared memory (16-byte loads, zero-fill past
// the image, past C and past O), ldmatrix into mma.sync m16n8k16 with f32
// accumulators, then one rounding to bf16.
// f32: true f32 FMAs (no TF32), 64 x 64 tile per CTA of 256 threads
// (4 x 4 outputs each), K in chunks of 16, double-buffered through
// registers into shared memory.
//
// Bounds (the wrapper refuses the rest): C and O multiples of 8 (a
// 16-byte load never straddles the end of a row), N*H*W < 2^30 (the
// pixel index is 32-bit; offsets are 64-bit), 16-byte aligned x, w, y.
// Any N, H, W, KH, KW.
//
// Bound on the H100: operations.  At the probe's shapes (b256, 14^2 x 256
// and the like) the work is 2*N*H*W*C*O*KH*KW = 59.2 GFLOP over ~40 MB,
// ~1500 flop/byte.  This first version uses mma.sync, which reaches a
// fraction of the wgmma peak; wgmma, TMA and a deeper pipeline are later
// work.
#include "common.cuh"

// ---------------------------------------------------------------- bf16
#define BM 128
#define BN 128
#define BK 32
#define STAGES 3
#define NTHREADS 256
#define A_LD (BK + 8)  // 80-byte rows: ldmatrix reads are conflict-free
#define B_LD (BN + 8)  // 272-byte rows
#define A_STAGE (BM * A_LD)
#define B_STAGE (BK * B_LD)
#define SMEM_BF16 (STAGES * (A_STAGE + B_STAGE) * 2)

// ----------------------------------------------------------------- f32
#define FBM 64
#define FBN 64
#define FBK 16

struct ConvShape {
  int H, W, C, KW, O, M, ph, pw, cchunks, iters;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(NTHREADS)
    conv_nhwc_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ y, ConvShape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * BN;

  // A loader: pixel rows tid/4 and tid/4 + 64 of the tile, 8 channels
  // at (tid % 4) * 8 of the chunk; the pixels are decoded once
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;
  int a_n[2], a_h[2], a_w[2];
  bool a_in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + a_row + i * 64;
    a_in[i] = m < s.M;
    const int mm = a_in[i] ? m : 0;
    const int t = mm / s.W;
    a_w[i] = mm - t * s.W;
    a_n[i] = t / s.H;
    a_h[i] = t - a_n[i] * s.H;
  }
  // B loader: k rows tid/16 and tid/16 + 16 of the chunk, 8 outputs at
  // (tid % 16) * 8 of the tile
  const int b_row = tid >> 4, b_col = (tid & 15) * 8;
  const bool b_in = o0 + b_col < s.O;

  auto load = [&](int stage, int it) {
    const int khw = it / s.cchunks;
    const int c0 = (it - khw * s.cchunks) * BK;
    const int kh = khw / s.KW, kw = khw - kh * s.KW;
    __nv_bfloat16* as = As + stage * A_STAGE;
    __nv_bfloat16* bs = Bs + stage * B_STAGE;
    const int c = c0 + a_col;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ih = a_h[i] + kh - s.ph, iw = a_w[i] + kw - s.pw;
      const bool ok = a_in[i] && c < s.C && (unsigned)ih < (unsigned)s.H &&
                      (unsigned)iw < (unsigned)s.W;
      const __nv_bfloat16* src =
          ok ? x + ((((size_t)a_n[i] * s.H + ih) * s.W + iw) * s.C + c) : x;
      cp_async16(as + (a_row + i * 64) * A_LD + a_col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = b_row + i * 16;
      const bool ok = b_in && c0 + r < s.C;
      const __nv_bfloat16* src =
          ok ? w + (((size_t)khw * s.C + c0 + r) * s.O + o0 + b_col) : w;
      cp_async16(bs + r * B_LD + b_col, src, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // warp tile: rows wm..wm+63, columns wn..wn+31 of the CTA tile
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < s.iters) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < s.iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk `it` landed; chunk it-1's readers are done
    const int nxt = it + STAGES - 1;
    if (nxt < s.iters) load(nxt % STAGES, nxt);
    cp_async_commit();  // an empty group keeps the count in step
    const __nv_bfloat16* as = As + (it % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = Bs + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm + mi * 16 + (lane & 15)) * A_LD + kk +
                                (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * B_LD + wn + nj * 16 +
                                 (lane >> 4) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni): rows g and g + 8, columns 2t and 2t + 1
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = o0 + wn + ni * 8 + t4 * 2;
      if (col >= s.O) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row < s.M)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * s.O + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * half],
                                    acc[mi][ni][2 * half + 1]);
      }
    }
}

__global__ void __launch_bounds__(256)
    conv_nhwc_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, float* __restrict__ y,
                         ConvShape s) {
  __shared__ __align__(16) float As[2][FBK][FBM + 4];  // k-major pixels
  __shared__ __align__(16) float Bs[2][FBK][FBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * FBM, o0 = blockIdx.y * FBN;

  // A loader: pixel row tid/4, 4 channels at (tid % 4) * 4 of the chunk
  const int a_row = tid >> 2, a_col = (tid & 3) * 4;
  const int m = m0 + a_row;
  const bool a_in = m < s.M;
  const int mm = a_in ? m : 0;
  const int t = mm / s.W;
  const int a_w = mm - t * s.W, a_n = t / s.H, a_h = t - a_n * s.H;
  // B loader: k row tid/16, 4 outputs at (tid % 16) * 4
  const int b_row = tid >> 4, b_col = (tid & 15) * 4;
  const bool b_in = o0 + b_col < s.O;

  float4 ra, rb;
  auto fetch = [&](int it) {
    const int khw = it / s.cchunks;
    const int c0 = (it - khw * s.cchunks) * FBK;
    const int kh = khw / s.KW, kw = khw - kh * s.KW;
    const int c = c0 + a_col;
    const int ih = a_h + kh - s.ph, iw = a_w + kw - s.pw;
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_in && c < s.C && (unsigned)ih < (unsigned)s.H &&
        (unsigned)iw < (unsigned)s.W)
      ra = *reinterpret_cast<const float4*>(
          x + ((((size_t)a_n * s.H + ih) * s.W + iw) * s.C + c));
    rb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b_in && c0 + b_row < s.C)
      rb = *reinterpret_cast<const float4*>(
          w + (((size_t)khw * s.C + c0 + b_row) * s.O + o0 + b_col));
  };
  auto store = [&](int buf) {
    As[buf][a_col + 0][a_row] = ra.x;
    As[buf][a_col + 1][a_row] = ra.y;
    As[buf][a_col + 2][a_row] = ra.z;
    As[buf][a_col + 3][a_row] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_row][b_col]) = rb;
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (s.iters > 0) {
    fetch(0);
    store(0);
  }
  __syncthreads();
  for (int it = 0; it < s.iters; ++it) {
    const int buf = it & 1;
    if (it + 1 < s.iters) fetch(it + 1);  // global loads in flight
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // buf ^ 1 was last read in iteration it - 1, before its barrier
    if (it + 1 < s.iters) store(buf ^ 1);
    __syncthreads();
  }

  const int col = o0 + tx * 4;
  if (col >= s.O) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row < s.M)
      *reinterpret_cast<float4*>(y + (size_t)row * s.O + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

extern "C" int mxt_conv_nhwc(const void* x, const void* w, void* y, int N,
                             int H, int W, int C, int KH, int KW, int O,
                             int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ConvShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.KW = KW;
  s.O = O;
  s.M = N * H * W;  // the wrapper holds N*H*W < 2^30
  s.ph = KH / 2;
  s.pw = KW / 2;
  if (dtype == MXT_BF16) {
    s.cchunks = (C + BK - 1) / BK;
    s.iters = KH * KW * s.cchunks;
    cudaError_t e = cudaFuncSetAttribute(
        conv_nhwc_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BF16);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((s.M + BM - 1) / BM, (O + BN - 1) / BN);
    conv_nhwc_bf16_kernel<<<grid, NTHREADS, SMEM_BF16, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (__nv_bfloat16*)y, s);
    return (int)cudaGetLastError();
  }
  if (dtype == MXT_F32) {
    s.cchunks = (C + FBK - 1) / FBK;
    s.iters = KH * KW * s.cchunks;
    dim3 grid((s.M + FBM - 1) / FBM, (O + FBN - 1) / FBN);
    conv_nhwc_f32_kernel<<<grid, 256, 0, st>>>((const float*)x,
                                               (const float*)w, (float*)y, s);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
