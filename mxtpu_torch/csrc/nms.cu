// Greedy non-maximum suppression over boxes in score order: the one
// suppression sweep of the detection ops (MultiBoxDetection, Proposal,
// _contrib_box_nms), called by mxtpu_torch/kernels/nms.py.
//
// Replaces no TPU kernel.  mxtpu runs the sweep as one lax.fori_loop on
// the device (mxtpu/ndarray/detection_impl.py _greedy_nms_keep,
// mxtpu/ndarray/contrib.py _nms_single): row i, if alive, kills every
// later row whose (class-masked) IoU with it exceeds the threshold.  As
// a Python loop of tensor ops on the card that is 3-4 launches a row,
// thousands a call; here it is one call of two kernels.
//
// What bounds it: the sweep is sequential in rows, so latency, not
// bytes or flops (the IoU pairs are ~14 flops each, a few us of the
// card's f32 rate at n = 6000).  The design keeps the sequential part
// short and lets it read only shared memory:
//   1. nms_mask_kernel: the relation "IoU > threshold and j > i" of every
//      row i < n_iter as bits, into a scratch [batch][n_iter][words] the
//      wrapper allocates, words = 4 * ceil(n / 128) so that a row is a
//      whole number of 16-byte chunks.  A CTA is a tile of 128 rows x
//      128 columns, the column boxes staged once in shared memory for
//      all 128 rows; four neighbouring threads take a row, 32 columns
//      each (one word, its 32 pairs unrolled), so a tile has 16 warps to
//      hide the pairs' latency.  The grid holds only the tiles on or
//      above the diagonal (a triangular tile index).  A row whose keep0
//      bit is clear is skipped: it never becomes a source, so the sweep
//      never reads its words (they stay as torch.empty left them).  The
//      threshold is decided without the division where the quotient is
//      clearly on one side (over_threshold below).
//   2. nms_sweep_kernel, one CTA an image, up to PREFETCH_MAX_BOXES: the
//      keep bits in shared memory; the mask rows of each block of 32
//      rows, from word 4 * floor(k / 4) of its first row to the end of
//      its last, come into a ring of stages in shared memory (2 to
//      MAX_STAGES, as many as fit, no more than the blocks: the whole
//      mask where it fits) by one TMA bulk copy a block (cp.async.bulk,
//      completed on the stage's mbarrier) that a producer thread issues
//      ahead.  Warp 0 settles a block's own rows from shared memory
//      alone: lane r holds row r's diagonal word, and one ballot tells
//      whether any live row overlaps a later live row; if none, the
//      block stands, else thread 0 walks it with the 32 diagonal words
//      in registers, a predicated step a row (a live row clears the later
//      rows it overlaps, a dead one does nothing).  No shuffle and no
//      global load is on the chain.  One barrier publishes the block's
//      sources; then the warps OR their later words, read from the stage
//      16 bytes a lane and folded by a warp-wide redux (one vote skips a
//      chunk no source overlaps, most of them), out of the keep bits,
//      warp 0 taking word k + 1's chunk alone so that it settles block
//      k + 1 while the others finish.
//      (A first build walked only the live rows by __ffs, a shared-memory
//      load each, and copied a row a cp.async.bulk: 0.37 ms of sweep at
//      b2 x n6000 on an H100 against 0.53 for the old shuffle chain, and
//      slower than it at n256.  The ballot, the register walk, the redux ORs and one
//      copy a block replaced them: a bulk copy costs its issuing thread
//      far more than the bytes it skips.)
//   3. nms_sweep_wide_kernel past PREFETCH_MAX_BOXES (two stages and the
//      keep bits no longer fit in a CTA's 227 KB): the same sweep reading
//      the mask from global memory, its settle a shuffle a row, up to
//      MAX_BOXES (the keep bits in 48 KB).
// The IoU is the plain version's f32 arithmetic, each operation rounded
// on its own (__fmul_rn and the like, so no FMA contraction), in the
// same order, and its minima and maxima pass a NaN on as torch's do
// (min.NaN / max.NaN), so the keep mask equals the plain loop's bit for
// bit, NaN boxes included (a NaN IoU suppresses nothing).
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MASK_TILE = 128;        // rows and columns of a mask CTA
constexpr int MASK_THREADS = 4 * MASK_TILE;  // a word of a row a thread
constexpr int SWEEP_THREADS = 256;    // threads of a sweep CTA
constexpr int MAX_STAGES = 16;        // the sweep's ring of mask blocks
constexpr int SMEM_LIMIT = 232448;    // bytes of shared memory a CTA may use
// the largest n whose two stages and keep bits fit in SMEM_LIMIT
constexpr int PREFETCH_MAX_BOXES = 28000;
// the wide sweep keeps an image's keep bits in 48 KB of shared memory
constexpr int MAX_BOXES = 393216;

// 32-bit words of a mask row: whole 16-byte chunks
constexpr int mask_words(int n) {
  return (n + MASK_TILE - 1) / MASK_TILE * (MASK_TILE / 32);
}
constexpr size_t sweep_smem(int n, int stages) {
  return ((size_t)stages * 32 + 1) * mask_words(n) * sizeof(uint32_t);
}
static_assert(sweep_smem(PREFETCH_MAX_BOXES, 2) + 64 <= SMEM_LIMIT,
              "two stages of the prefetch limit must fit a CTA");
static_assert(MAX_BOXES / 8 == 48 * 1024, "wide keep bits fill 48 KB");

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return Box{v.x, v.y, v.z, v.w};
}

// torch.minimum / torch.maximum / clamp_min: NaN if either is NaN (the
// sign of a zero result may differ from torch's; no decision reads it)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (x2 - x1) * (y2 - y1) clamped at 0, or with the +1-pixel convention
// (x2 - x1 + 1) * (y2 - y1 + 1) unclamped (Proposal's _pixel_iou)
template <bool PIXEL>
__device__ __forceinline__ float box_area(const Box& a) {
  if (PIXEL)
    return __fmul_rn(__fadd_rn(__fsub_rn(a.x2, a.x1), 1.0f),
                     __fadd_rn(__fsub_rn(a.y2, a.y1), 1.0f));
  return nan_max(__fmul_rn(__fsub_rn(a.x2, a.x1), __fsub_rn(a.y2, a.y1)),
                 0.0f);
}

// RN(inter / uni) > thr without the division where it is decided
// otherwise; thr_up is the next f32 above thr.  For finite inter >= 0
// and finite uni >= 1e-12 (the union's clamp), RN is monotone, so:
//  - inter > RN(thr_up * uni): inter is at least the f32 after it, which
//    lies above thr_up * uni; the quotient exceeds thr_up, and its
//    rounding is >= thr_up > thr: true;
//  - inter < RN(thr * uni): inter is at most the f32 before it, which
//    lies below thr * uni; the quotient is below thr, and its rounding
//    <= thr: false.
// (Gradual underflow holds both for a tiny product; an overflowing
// thr_up * uni is inf, which no inter exceeds.)  Inside that band of
// ~2 ulps, and for a NaN or infinite inter or uni, the division decides
// as the plain version does.
__device__ __forceinline__ bool over_threshold(float inter, float uni,
                                               float thr, float thr_up) {
  const bool above = inter > __fmul_rn(thr_up, uni);
  const bool below = inter < __fmul_rn(thr, uni);
  if ((above || below) && nan_max(inter, uni) <= FLT_MAX) return above;
  return __fdiv_rn(inter, uni) > thr;
}

// the intersection and the union max(area_a + area_b - inter, 1e-12) of
// the row's box a and the column's box b
template <bool PIXEL>
__device__ __forceinline__ void iou_parts(const Box& a, const Box& b,
                                          float area_a, float area_b,
                                          float* inter, float* uni) {
  float w = __fsub_rn(nan_min(a.x2, b.x2), nan_max(a.x1, b.x1));
  float h = __fsub_rn(nan_min(a.y2, b.y2), nan_max(a.y1, b.y1));
  if (PIXEL) {
    w = __fadd_rn(w, 1.0f);
    h = __fadd_rn(h, 1.0f);
  }
  *inter = __fmul_rn(nan_max(w, 0.0f), nan_max(h, 0.0f));
  *uni = nan_max(__fsub_rn(__fadd_rn(area_a, area_b), *inter), 1e-12f);
}

// bit (i, j) of the mask: j > i and the IoU, 0 across classes when ids
// are given, exceeds thr.  Tile t of an image is (rb, cb) with rb <= cb,
// numbered row by row: row rb starts at rb * ct - rb * (rb - 1) / 2.
// Four neighbouring threads take a row, a word of 32 columns each, so
// that a thread's 32 pairs unroll and its row's words store together.
template <bool PIXEL, bool IDS>
__global__ void __launch_bounds__(MASK_THREADS)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ ids,
                    const uint8_t* __restrict__ keep0, int n, int n_iter,
                    int words, int ct, float thr,
                    uint32_t* __restrict__ mask) {
  __shared__ float4 cbox[MASK_TILE];
  __shared__ float carea[MASK_TILE];
  __shared__ float cid[MASK_TILE];
  const int64_t tile = blockIdx.x;
  const int b = blockIdx.y, t = threadIdx.x;
  const double q = 2.0 * ct + 1.0;
  int rb = (int)((q - sqrt(q * q - 8.0 * (double)tile)) * 0.5);
  auto start = [ct](int64_t r) { return r * ct - r * (r - 1) / 2; };
  while (rb > 0 && start(rb) > tile) --rb;
  while (start(rb + 1) <= tile) ++rb;
  const int cb = rb + (int)(tile - start(rb));
  const float* bb = boxes + (size_t)b * n * 4;
  const int j0 = cb * MASK_TILE;
  if (t < MASK_TILE && j0 + t < n) {
    const Box v = load_box(bb + (size_t)(j0 + t) * 4);
    cbox[t] = make_float4(v.x1, v.y1, v.x2, v.y2);
    carea[t] = box_area<PIXEL>(v);
    if (IDS) cid[t] = ids[(size_t)b * n + j0 + t];
  }
  __syncthreads();
  const int i = rb * MASK_TILE + (t >> 2), wd = t & 3;
  // rows past n_iter suppress nothing; a row keep0 clears is never a
  // source, so the sweep never reads its words
  if (i >= n_iter || !keep0[(size_t)b * n + i]) return;
  const Box a = load_box(bb + (size_t)i * 4);
  const float area_a = box_area<PIXEL>(a);
  const float id_a = IDS ? ids[(size_t)b * n + i] : 0.0f;
  const float thr_up = nextafterf(thr, INFINITY);
  const bool zero_over = 0.0f > thr;  // the IoU across classes
  // this thread's columns 32 * wd + [lo, hi): later than i, before n
  const int c0 = 32 * wd;
  const int lo = max(0, i + 1 - j0 - c0), hi = min(32, n - j0 - c0);
  uint32_t word = 0u;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c < lo || c >= hi) continue;
    bool over = zero_over;  // across classes: IoU 0
    if (!IDS || id_a == cid[c0 + c]) {
      const float4 v = cbox[c0 + c];
      float inter, uni;
      iou_parts<PIXEL>(a, Box{v.x, v.y, v.z, v.w}, area_a, carea[c0 + c],
                       &inter, &uni);
      over = over_threshold(inter, uni, thr, thr_up);
    }
    word |= (uint32_t)over << c;
  }
  mask[((size_t)b * n_iter + i) * words + (MASK_TILE / 32) * cb + wd] = word;
}

// keep0's bytes as keep bits, a word a thread
__device__ __forceinline__ void keep_bits(const uint8_t* k0, int n,
                                          uint32_t* alive) {
  const int nw = (n + 31) >> 5;
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    uint32_t bits = 0;
    for (int s = 0; s < 32; ++s) {
      const int i = (w << 5) + s;
      if (i < n && k0[i]) bits |= 1u << s;
    }
    alive[w] = bits;
  }
}

__device__ __forceinline__ void write_keep(const uint32_t* alive, int n,
                                           uint8_t* keep) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    keep[i] = (uint8_t)((alive[i >> 5] >> (i & 31)) & 1u);
}

// one row of `bytes` from global into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(SWEEP_THREADS)
    nms_sweep_kernel(const uint32_t* __restrict__ mask,
                     const uint8_t* __restrict__ keep0, int n, int n_iter,
                     int words, int stages, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                                // [stages][32][words]
  uint32_t* alive = smem + (size_t)stages * 32 * words;  // keep bits
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ uint32_t sources[2];  // the live rows of blocks k, k + 1
  const int b = blockIdx.x, t = threadIdx.x;
  const int nw = (n + 31) >> 5, nblk = (n_iter + 31) >> 5;
  const int producer = SWEEP_THREADS - 32;  // lane 0 of the last warp
  const uint32_t* m = mask + (size_t)b * n_iter * words;
  // block k's rows into stage s in one copy: from word 4 * floor(k / 4)
  // of its first row to the end of its last (the rows lie one after
  // another; the sweep reads no word left of k)
  auto issue = [&](int k, int s) {
    const int rows = min(32, n_iter - (k << 5));
    const int w0 = k & ~3;
    const uint32_t bytes = (uint32_t)(rows * words - w0) * 4u;
    mbar_expect_tx(&full[s], bytes);
    bulk_load(ring + (size_t)s * 32 * words + w0,
              m + (size_t)(k << 5) * words + w0, bytes, &full[s]);
  };
  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == producer)
    for (int k = 0; k < min(stages, nblk); ++k) issue(k, k);
  keep_bits(keep0 + (size_t)b * n, n, alive);
  __syncthreads();
  int s = 0;             // block k's stage and its fill's parity
  uint32_t parity = 0u;
  for (int k = 0; k < nblk; ++k) {
    const uint32_t* st = ring + (size_t)s * 32 * words;
    if (t < 32) {
      // warp 0 settles the block's own rows.  Word k is final here:
      // thread 0 ORed block k - 1 into it last.  Lane r holds row r's
      // diagonal word; where no live row overlaps a later live row the
      // block stands as it is, else thread 0 walks its rows in order,
      // the diagonal words in registers: a live row clears the later
      // rows it overlaps, a dead one does nothing.  A row still live
      // when its step comes is a source.
      mbar_wait(&full[s], parity);
      __syncwarp();  // thread 0's OR into word k, seen by the warp
      const int rows = min(32, n_iter - (k << 5));
      uint32_t word = alive[k];
      const uint32_t d = t < rows ? st[t * words + k] : 0u;
      if (__ballot_sync(0xffffffffu, ((word >> t) & 1u) && (d & word)) &&
          t == 0) {
        uint32_t diag[32];
#pragma unroll
        for (int r = 0; r < 32; ++r)
          diag[r] = r < rows ? st[r * words + k] : 0u;
#pragma unroll
        for (int r = 0; r < 32; ++r)
          if ((word >> r) & 1u) word &= ~diag[r];
      }
      if (t == 0) {
        alive[k] = word;
        sources[k & 1] = rows == 32 ? word : word & ((1u << rows) - 1u);
      }
    }
    __syncthreads();  // one barrier a block
    // every read of block k - 1's stage is done: refill it
    if (t == producer && k > 0 && k - 1 + stages < nblk)
      issue(k - 1 + stages, s == 0 ? stages - 1 : s - 1);
    if (t >= 32) mbar_wait(&full[s], parity);  // the copy, seen by all
    const uint32_t src = sources[k & 1];
    if (src) {
      // the sources' later words, 4 at a time (a 16-byte chunk): lane r
      // loads row r's chunk if row r is a source, a warp-wide OR
      // (redux) folds the 32 rows, lanes 0-3 clear the chunk's words.
      // Warp 0 takes word k + 1's chunk alone (then settles block
      // k + 1), warps 1.. the later chunks in turn
      const int warp = t >> 5, lane = t & 31, nq = (nw + 3) >> 2;
      const int q0 = (k + 1) >> 2;
      const int step = warp == 0 ? nq : SWEEP_THREADS / 32 - 1;
      for (int q = warp == 0 ? q0 : q0 + warp; q < nq; q += step) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if ((src >> lane) & 1u)
          v = *reinterpret_cast<const uint4*>(st + lane * words + 4 * q);
        // most chunks overlap no source: one vote skips them
        if (!__any_sync(0xffffffffu, (v.x | v.y | v.z | v.w) != 0u)) continue;
        const uint32_t a0 = __reduce_or_sync(0xffffffffu, v.x);
        const uint32_t a1 = __reduce_or_sync(0xffffffffu, v.y);
        const uint32_t a2 = __reduce_or_sync(0xffffffffu, v.z);
        const uint32_t a3 = __reduce_or_sync(0xffffffffu, v.w);
        const int w = 4 * q + lane;
        if (lane < 4 && w > k && w < nw)
          alive[w] &= ~(lane == 0 ? a0 : lane == 1 ? a1 : lane == 2 ? a2 : a3);
      }
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1u;
    }
  }
  __syncthreads();
  write_keep(alive, n, keep + (size_t)b * n);
}

__global__ void __launch_bounds__(SWEEP_THREADS)
    nms_sweep_wide_kernel(const uint32_t* __restrict__ mask,
                          const uint8_t* __restrict__ keep0, int n,
                          int n_iter, int words,
                          uint8_t* __restrict__ keep) {
  extern __shared__ uint32_t alive[];  // (n + 31) / 32 keep words
  __shared__ uint32_t sources;         // the live rows of the block
  const int b = blockIdx.x, t = threadIdx.x;
  const int nw = (n + 31) >> 5;
  keep_bits(keep0 + (size_t)b * n, n, alive);
  __syncthreads();
  const uint32_t* m = mask + (size_t)b * n_iter * words;
  const int nblk = (n_iter + 31) >> 5;
  for (int k = 0; k < nblk; ++k) {
    const int rows = min(32, n_iter - (k << 5));
    if (t < 32) {
      // the block's own rows in order: a live row clears the later
      // rows of the block it overlaps (its diagonal word)
      const uint32_t diag =
          t < rows ? m[(size_t)((k << 5) + t) * words + k] : 0u;
      uint32_t word = alive[k], src = 0;
      for (int s = 0; s < rows; ++s) {
        const uint32_t d = __shfl_sync(0xffffffffu, diag, s);
        if ((word >> s) & 1u) {
          src |= 1u << s;
          word &= ~d;
        }
      }
      if (t == 0) {
        alive[k] = word;
        sources = src;
      }
    }
    __syncthreads();
    const uint32_t src = sources;
    if (src) {
      const uint32_t* rows_k = m + (size_t)(k << 5) * words;
      for (int w = k + 1 + t; w < nw; w += blockDim.x) {
        // unrolled: the live rows' words load together, then one OR
        uint32_t acc = 0;
#pragma unroll
        for (int s = 0; s < 32; ++s)
          if ((src >> s) & 1u) acc |= rows_k[(size_t)s * words + w];
        alive[w] &= ~acc;
      }
    }
    __syncthreads();
  }
  write_keep(alive, n, keep + (size_t)b * n);
}

template <bool PIXEL, bool IDS>
void launch_mask(const float* boxes, const float* ids, const uint8_t* keep0,
                 int batch, int n, int n_iter, int words, float thr,
                 uint32_t* mask, cudaStream_t st) {
  const int64_t ct = (n + MASK_TILE - 1) / MASK_TILE;
  const int64_t rt = (n_iter + MASK_TILE - 1) / MASK_TILE;
  const dim3 grid((unsigned)(rt * ct - rt * (rt - 1) / 2), batch);
  nms_mask_kernel<PIXEL, IDS><<<grid, MASK_THREADS, 0, st>>>(
      boxes, ids, keep0, n, n_iter, words, (int)ct, thr, mask);
}

// the ring's depth: as many stages as fit, 2 to MAX_STAGES, no more than
// the blocks (0 past the prefetch limit: the wide sweep)
int sweep_stages(int n, int n_iter) {
  if (n > PREFETCH_MAX_BOXES) return 0;
  const int nblk = (n_iter + 31) / 32;
  int s = MAX_STAGES;
  while (s > 2 && sweep_smem(n, s) + 64 > SMEM_LIMIT) --s;
  return nblk < s ? (nblk > 0 ? nblk : 1) : s;
}

}  // namespace

// boxes (batch, n, 4) f32 in score order, ids (batch, n) f32 or null,
// keep0 and keep (batch, n) bytes, mask scratch of batch * n_iter *
// words uint32, 16-byte aligned, with words = 4 * ceil(n / 128) (unused
// when n_iter is 0).
extern "C" int mxt_nms(const void* boxes, const void* ids, const void* keep0,
                       void* keep, void* mask, int batch, int n, int n_iter,
                       float thr, int pixel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch <= 0 || n <= 0 || n > MAX_BOXES || n_iter < 0 || n_iter > n ||
      batch > 65535 || ((uintptr_t)mask & 15u) || ((uintptr_t)boxes & 15u))
    return (int)cudaErrorInvalidValue;
  const int words = mask_words(n);
  const uint8_t* k0 = (const uint8_t*)keep0;
  if (n_iter > 0) {
    const float* b = (const float*)boxes;
    const float* d = (const float*)ids;
    uint32_t* m = (uint32_t*)mask;
    if (pixel && d)
      launch_mask<true, true>(b, d, k0, batch, n, n_iter, words, thr, m, st);
    else if (pixel)
      launch_mask<true, false>(b, d, k0, batch, n, n_iter, words, thr, m, st);
    else if (d)
      launch_mask<false, true>(b, d, k0, batch, n, n_iter, words, thr, m, st);
    else
      launch_mask<false, false>(b, d, k0, batch, n, n_iter, words, thr, m,
                                st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int stages = sweep_stages(n, n_iter);
  if (stages == 0) {
    const size_t smem = (size_t)((n + 31) / 32) * sizeof(uint32_t);
    nms_sweep_wide_kernel<<<batch, SWEEP_THREADS, smem, st>>>(
        (const uint32_t*)mask, k0, n, n_iter, words, (uint8_t*)keep);
    return (int)cudaGetLastError();
  }
  const size_t smem = sweep_smem(n, stages);
  if (smem > 48 * 1024) {  // the current device's attribute
    const cudaError_t err = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<batch, SWEEP_THREADS, smem, st>>>(
      (const uint32_t*)mask, k0, n, n_iter, words, stages, (uint8_t*)keep);
  return (int)cudaGetLastError();
}
