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
// No padded copy of x is written to HBM.  For an even kernel the
// padding keeps the reference's convention (pad KH/2 on both sides, keep
// the top-left H x W), which is not XLA's SAME.
//
// bf16 (conv_nhwc_wgmma_kernel): wgmma + TMA, warp-specialized and
// persistent (one CTA an SM walks its share of the output tiles).  A
// tile is 128*MW output pixels of the flattened N*H*W (so it may span
// rows and images) by BN outputs: 128 x 256, 256 x 128 or 256 x 64,
// the widest that O fills.  K is walked as (kh, kw, 64-channel chunk).
// One producer thread issues, per chunk, MW TMA im2col loads of A (128
// pixels x 64 channels each, every pixel read at its tap's offset; the map's
// bounding box makes the padding, TMA's zero fill the rest: off the
// image, past C, past the last pixel) and BN/64 tiled loads of B from w
// viewed as (KH*KW, C, O), so that a chunk past C comes as zeros and
// never runs into the next tap's rows, into a ring of up to 8 stages on
// full/empty mbarriers; it runs on into the next tile while the
// consumers store.  Two consumer warpgroups each run MW 64 x BN SS
// wgmmas over the stage (A K-major, B MN-major), keep one chunk's
// products in flight, and release a stage when its products are done.
// f32 accumulators, one rounding to bf16 into swizzled staging boxes in
// shared memory, stored by TMA while the next tile's products run (4-byte
// stores straight from the accumulators, scattered over 8 rows a warp,
// stalled the consumers for a large share of the kernel's time).
// f32 (conv_nhwc_f32_wgmma_kernel): the same kernel over operands split
// exactly into three bf16 parts (hopper.cuh, split3), with no TF32: a
// prepass (conv_split_f32_kernel) writes x as three bf16 NHWC arrays
// stacked as 3N images and w as three (KH*KW, C, O) arrays stacked as
// 3*KH*KW taps, and the loop walks (pair, kh, kw, chunk) over the six
// (x part, w part) pairs that matter, smallest first, into the same f32
// accumulators: six times the bf16 kernel's products, as the TPU does
// f32 at Precision.HIGHEST.  A load that runs past the last image of a
// part reads the next part's first pixels: they land only in rows past
// N*H*W, which the store drops.  y is f32: the epilogue stages and
// stores each tile in two halves of BN/2 columns (f32 boxes of 64 rows
// x 32 columns, 128-byte swizzle) through the bf16 kernel's staging
// room.  The prepass is compute-light (at 14^2 x 256: 51 MB read, 77 MB
// written) beside the 6 x 59.2 GFLOP.  The scalar f32 kernel
// (conv_nhwc_f32_kernel: 64 x 64 tile per CTA of 256 threads, 4 x 4
// outputs each, true f32 FMAs) stays only for KH or KW above 255, which
// the im2col loads cannot take.
//
// Bounds (the wrapper pads C and O to multiples of 8 and refuses the
// rest): C and O multiples of 8 (TMA's 16-byte strides; the scalar
// kernel's float4 loads), KH and KW at most 255 on the tensor cores
// (the im2col offsets and corners; bf16 refuses larger kernels, f32
// takes the scalar kernel there), N*H*W < 2^30 (the pixel index is
// 32-bit; offsets are 64-bit), 16-byte aligned x, w, y.  Any N, H, W.
//
// Bound on the H100: operations.  At the probe's shapes (b256, 14^2 x 256
// and the like) the work is 2*N*H*W*C*O*KH*KW = 59.2 GFLOP over ~40 MB,
// ~1500 flop/byte; six times that in f32.
#include "common.cuh"
#include "hopper.cuh"

// ------------------------------------------------------- tensor cores
#define CBK 64                     // channels per K chunk
#define PIX 128                    // pixels per im2col load
#define A_LOAD (PIX * CBK * 2)     // 16 KB

// ------------------------------------------- scalar f32 (KH or KW > 255)
#define FBM 64
#define FBN 64
#define FBK 16

struct ConvShape {
  int N, H, W, C, KW, O, M, ph, pw, cchunks, iters, taps;
};

// The tensor-core kernels' output tile: 128*MW pixels (two consumer
// warpgroups of MW 64-row blocks) by BN outputs.  Shared memory: a ring
// whose stage holds MW im2col loads of A and BN/64 boxes of B (bf16 in
// both kernels), as many stages as fit beside the output staging (each
// warpgroup's MW x BN/64 boxes of 8 KB: its bf16 tile, or half its f32
// tile) in 216 KB, at most 8
template <int BN, int MW>
struct ConvTile {
  static constexpr int BM = 128 * MW;
  static constexpr int A_BYTES = MW * A_LOAD;
  static constexpr int STAGE = A_BYTES + BN / 64 * HOP_TILE_BYTES;
  static constexpr int STG = MW * BN / 64 * HOP_TILE_BYTES;
  static constexpr int RING = 216 * 1024 - 2 * STG;
  static constexpr int STAGES = RING / STAGE < 8 ? RING / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 2 * STG + 1024;
};

// The body of both kernels.  SPLIT: x and w are the stacked bf16 parts
// of f32 operands, the loop runs over the six pairs, y is f32
template <int BN, int MW, bool SPLIT>
__device__ __forceinline__ void conv_body(const CUtensorMap& tx,
                                          const CUtensorMap& tw,
                                          const CUtensorMap& ty,
                                          const ConvShape& s, int m_tiles,
                                          int tiles) {
  using R = ConvTile<BN, MW>;
  constexpr int PAIRS = SPLIT ? 6 : 1;
  extern __shared__ uint8_t cv_raw[];
  __shared__ __align__(8) uint64_t bar_full[R::STAGES];
  __shared__ __align__(8) uint64_t bar_empty[R::STAGES];
  uint8_t* ring = align1024(cv_raw);
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int i = 0; i < R::STAGES; ++i) {
      mbar_init(&bar_full[i], 1);
      mbar_init(&bar_empty[i], 256);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Persistent: CTA b takes tiles b, b + gridDim.x, ...; pixel tiles
  // vary fastest, so the CTAs running at once share their B columns.
  // The ring's chunk count `it` runs on across tiles.
  if (wg == 2) {  // producer warpgroup: one thread issues every load
    regs_dec<40>();
    if (tid != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * R::BM, o0 = (tile / m_tiles) * BN;
      int ln[MW], lh[MW], lw[MW];  // each load's first pixel base
#pragma unroll
      for (int j = 0; j < MW; ++j) {
        const int m = m0 + PIX * j, t = m / s.W;
        ln[j] = t / s.H;
        lh[j] = t - ln[j] * s.H - s.ph;
        lw[j] = m - t * s.W - s.pw;
      }
      // chunk ci of pair `pair`, counted on without a division: the one
      // thread that issues every load sits on the ring's critical path
      for (int pair = 0, ci = 0; pair < PAIRS; ++it) {
        const int st = it % R::STAGES;
        if (it >= R::STAGES)  // the chunk that last used the stage is done
          mbar_wait(&bar_empty[st], ((it / R::STAGES) - 1) & 1);
        const int khw = ci / s.cchunks;
        const int c0 = (ci - khw * s.cchunks) * CBK;
        const int kh = khw / s.KW, kw = khw - kh * s.KW;
        // x's part: images + part * N; w's part: taps + part * KH*KW
        const int xn = SPLIT ? split_a(pair) * s.N : 0;
        const int wt = SPLIT ? split_b(pair) * s.taps : 0;
        uint8_t* a = ring + st * R::STAGE;
        mbar_expect_tx(&bar_full[st], R::STAGE);
#pragma unroll
        for (int j = 0; j < MW; ++j)
          tma_load_im2col(a + j * A_LOAD, &tx, &bar_full[st], c0, lw[j],
                          lh[j], ln[j] + xn, kw, kh);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(a + R::A_BYTES + j * HOP_TILE_BYTES, &tw,
                      &bar_full[st], o0 + 64 * j, c0, khw + wt);
        if (++ci == s.iters) {
          ci = 0;
          ++pair;
        }
      }
    }
  } else {  // consumer warpgroup wg: MW 64-row blocks from 64*MW*wg
    regs_inc<232>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const bool lead = (tid & 127) == 0;
    uint8_t* stg = ring + R::STAGES * R::STAGE + wg * R::STG;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * R::BM, o0 = (tile / m_tiles) * BN;
      float acc[MW][BN / 2];
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0.f;
      for (int c = 0; c < PAIRS * s.iters; ++c, ++it) {
        const int st = it % R::STAGES;
        mbar_wait(&bar_full[st], (it / R::STAGES) & 1);
        const uint8_t* a =
            ring + st * R::STAGE + wg * MW * HOP_TILE_BYTES;
        const uint8_t* b = ring + st * R::STAGE + R::A_BYTES;
#pragma unroll
        for (int i = 0; i < MW; ++i) fence_regs(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_tb<BN>(acc[i],
                            kmajor_desc(a + i * HOP_TILE_BYTES, kk),
                            mnmajor_desc(b, kk), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done
#pragma unroll
        for (int i = 0; i < MW; ++i) fence_regs(acc[i]);
        if (c > 0) mbar_arrive(&bar_empty[(it - 1) % R::STAGES]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MW; ++i) fence_regs(acc[i]);
      mbar_arrive(&bar_empty[(it - 1) % R::STAGES]);

      // y through shared memory: once the previous stores have read the
      // staging boxes, put the accumulators into them (bf16: rounded, in
      // one pass; f32: half the columns a pass) and let TMA store them
      // (rows past N*H*W and columns past O are dropped) while the next
      // tile's products run
#pragma unroll
      for (int hf = 0; hf < (SPLIT ? 2 : 1); ++hf) {
        if (lead) bulk_wait_read();
        named_sync(1 + wg, 128);
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          uint8_t* boxes = stg + i * (BN / 64) * HOP_TILE_BYTES;
          if constexpr (!SPLIT)
            stage_acc<BN / 64>(boxes, acc[i], warp, lane);
          else if (hf == 0)
            stage_acc_f32<BN / 64, 0>(boxes, acc[i], warp, lane);
          else
            stage_acc_f32<BN / 64, 1>(boxes, acc[i], warp, lane);
        }
        fence_async_smem();
        named_sync(1 + wg, 128);
        if (lead) {
          // a box is 64 columns of bf16 or 32 of f32
          const int cols = SPLIT ? 32 : 64;
#pragma unroll
          for (int i = 0; i < MW; ++i)
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_store_3d(&ty,
                           stg + (i * (BN / 64) + j) * HOP_TILE_BYTES,
                           o0 + hf * (BN / 2) + cols * j,
                           m0 + 64 * (MW * wg + i), 0);
          bulk_commit();
        }
      }
    }
    if (lead) bulk_wait();
  }
}

template <int BN, int MW>
__global__ void __launch_bounds__(384, 1)
    conv_nhwc_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           const __grid_constant__ CUtensorMap ty,
                           ConvShape s, int m_tiles, int tiles) {
  conv_body<BN, MW, false>(tx, tw, ty, s, m_tiles, tiles);
}

template <int BN, int MW>
__global__ void __launch_bounds__(384, 1)
    conv_nhwc_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                               const __grid_constant__ CUtensorMap tw,
                               const __grid_constant__ CUtensorMap ty,
                               ConvShape s, int m_tiles, int tiles) {
  conv_body<BN, MW, true>(tx, tw, ty, s, m_tiles, tiles);
}

// x (na floats) and w (nb floats), each a multiple of 4, into their
// three bf16 parts: part p of x at xs + p * na, of w at ws + p * nb
__global__ void __launch_bounds__(256)
    conv_split_f32_kernel(const float4* __restrict__ x,
                          const float4* __restrict__ w,
                          uint2* __restrict__ xs, uint2* __restrict__ ws,
                          long long na4, long long nb4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < na4 + nb4; i += (long long)gridDim.x * blockDim.x) {
    const bool in_x = i < na4;
    const long long k = in_x ? i : i - na4, n = in_x ? na4 : nb4;
    const float4 v = in_x ? x[k] : w[k];
    uint2* out = in_x ? xs : ws;
    uint32_t h[4], m[4], l[4];
    split3(v.x, h[0], m[0], l[0]);
    split3(v.y, h[1], m[1], l[1]);
    split3(v.z, h[2], m[2], l[2]);
    split3(v.w, h[3], m[3], l[3]);
    out[k] = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    out[n + k] = make_uint2(m[0] | (m[1] << 16), m[2] | (m[3] << 16));
    out[2 * n + k] = make_uint2(l[0] | (l[1] << 16), l[2] | (l[3] << 16));
  }
}

static int sm_count(int* sms) {
  int dev, e;
  if ((e = (int)cudaGetDevice(&dev))) return e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// x and w: bf16 operands, or (SPLIT) the stacked bf16 parts of f32 ones
template <int BN, int MW, bool SPLIT>
static int launch_wgmma(const void* x, const void* w, void* y,
                        const ConvShape& s, cudaStream_t stream) {
  using R = ConvTile<BN, MW>;
  constexpr int PARTS = SPLIT ? 3 : 1;
  const auto kern = SPLIT ? conv_nhwc_f32_wgmma_kernel<BN, MW>
                          : conv_nhwc_wgmma_kernel<BN, MW>;
  CUtensorMap mx, mw, my;
  int e, sms;
  if ((e = hop_map_im2col_bf16(&mx, x, PARTS * s.N, s.H, s.W, s.C, s.ph,
                               s.pw, PIX)) ||
      (e = hop_map_bf16(&mw, w, PARTS * s.taps, s.C, s.O)) ||
      (e = SPLIT ? hop_map_f32_out(&my, y, 1, s.M, s.O)
                 : hop_map_bf16(&my, y, 1, s.M, s.O)) ||
      (e = sm_count(&sms)) ||
      (e = (int)cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM)))
    return e;
  const int m_tiles = (s.M + R::BM - 1) / R::BM;
  const int tiles = m_tiles * ((s.O + BN - 1) / BN);
  kern<<<tiles < sms ? tiles : sms, 384, R::SMEM, stream>>>(mx, mw, my, s,
                                                           m_tiles, tiles);
  return (int)cudaGetLastError();
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

// the tensor-core kernel at the widest of 256 x 128, 128 x 256 and 256 x
// 64 (pixels x outputs) that O fills (PERF.md records every tile's
// times at the probe's shapes)
template <bool SPLIT>
static int conv_wgmma(const void* x, const void* w, void* y,
                      const ConvShape& s, cudaStream_t st) {
  if (s.O <= 64) return launch_wgmma<64, 2, SPLIT>(x, w, y, s, st);
  if (s.O % 256 == 0) return launch_wgmma<256, 1, SPLIT>(x, w, y, s, st);
  return launch_wgmma<128, 2, SPLIT>(x, w, y, s, st);
}

// f32 on the tensor cores: the split prepass into xs (3 x's numel) and
// ws (3 w's numel), then the kernel over the six pairs
static int conv_f32_split(const void* x, const void* w, void* y, void* xs,
                          void* ws, const ConvShape& s, cudaStream_t st) {
  int sms, e;
  if ((e = sm_count(&sms))) return e;
  const long long na4 = (long long)s.M * s.C / 4;
  const long long nb4 = (long long)s.taps * s.C * s.O / 4;
  const long long blocks = (na4 + nb4 + 255) / 256;
  conv_split_f32_kernel<<<(unsigned)(blocks < 8LL * sms ? blocks : 8LL * sms),
                          256, 0, st>>>((const float4*)x, (const float4*)w,
                                        (uint2*)xs, (uint2*)ws, na4, nb4);
  if ((e = (int)cudaGetLastError())) return e;
  return conv_wgmma<true>(xs, ws, y, s, st);
}

static ConvShape shape_of(int N, int H, int W, int C, int KH, int KW, int O,
                          int chunk) {
  ConvShape s;
  s.N = N;
  s.H = H;
  s.W = W;
  s.C = C;
  s.KW = KW;
  s.O = O;
  s.M = N * H * W;  // the wrapper holds N*H*W < 2^30
  s.ph = KH / 2;
  s.pw = KW / 2;
  s.cchunks = (C + chunk - 1) / chunk;
  s.iters = KH * KW * s.cchunks;
  s.taps = KH * KW;
  return s;
}

// xs, ws: scratch of 3 x.numel() and 3 w.numel() bf16 for f32 with KH,
// KW <= 255 (the split's parts), else unused
extern "C" int mxt_conv_nhwc(const void* x, const void* w, void* y, void* xs,
                             void* ws, int N, int H, int W, int C, int KH,
                             int KW, int O, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C % 8 || O % 8) return (int)cudaErrorInvalidValue;  // the wrapper pads
  const bool wide = KH > 255 || KW > 255;  // past the im2col loads
  if (dtype == MXT_BF16) {
    if (wide) return (int)cudaErrorInvalidValue;
    return conv_wgmma<false>(x, w, y, shape_of(N, H, W, C, KH, KW, O, CBK),
                             st);
  }
  if (dtype == MXT_F32 && !wide) {
    if (!xs || !ws) return (int)cudaErrorInvalidValue;
    return conv_f32_split(x, w, y, xs, ws,
                          shape_of(N, H, W, C, KH, KW, O, CBK), st);
  }
  if (dtype == MXT_F32) {
    const ConvShape s = shape_of(N, H, W, C, KH, KW, O, FBK);
    dim3 grid((s.M + FBM - 1) / FBM, (O + FBN - 1) / FBN);
    conv_nhwc_f32_kernel<<<grid, 256, 0, st>>>((const float*)x,
                                               (const float*)w, (float*)y, s);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
