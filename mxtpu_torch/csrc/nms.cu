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
// small:
//   1. nms_mask_kernel, a grid of 64 x 64 tiles of (row, column) pairs
//      a batch image: the relation "IoU > threshold and j > i" of every
//      row i < n_iter as bits, 2 words of 32 columns a tile row, into a
//      scratch [batch][n_iter][words] the wrapper allocates.  Tiles
//      below the diagonal have no j > i and exit.
//   2. nms_sweep_kernel, one CTA an image: the keep bits in shared
//      memory, swept 32 rows at a time.  Warp 0 settles the block's own
//      32 rows in order from their diagonal words (one shuffle a row);
//      then every thread ORs the later words of the block's live rows
//      (their loads unrolled, all in flight at once) and clears them
//      from the keep bits: two barriers per 32 rows.
// The IoU is the plain version's f32 arithmetic, each operation rounded
// on its own (__fmul_rn and the like, so no FMA contraction), in the
// same order, and its minima and maxima pass a NaN on as torch's do
// (fminf and fmaxf would drop it), so the keep mask equals the plain
// loop's bit for bit, NaN boxes included (a NaN IoU suppresses nothing).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MASK_TILE = 64;        // rows and columns of a mask CTA
constexpr int SWEEP_THREADS = 256;   // threads of a sweep CTA

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* p) {
  return Box{p[0], p[1], p[2], p[3]};
}

// torch.minimum / torch.maximum / clamp_min: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
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

// inter / max(area_a + area_b - inter, 1e-12) with a the row, b the
// column
template <bool PIXEL>
__device__ __forceinline__ float pair_iou(const Box& a, const Box& b,
                                          float area_a, float area_b) {
  float w = __fsub_rn(nan_min(a.x2, b.x2), nan_max(a.x1, b.x1));
  float h = __fsub_rn(nan_min(a.y2, b.y2), nan_max(a.y1, b.y1));
  if (PIXEL) {
    w = __fadd_rn(w, 1.0f);
    h = __fadd_rn(h, 1.0f);
  }
  const float inter = __fmul_rn(nan_max(w, 0.0f), nan_max(h, 0.0f));
  const float uni =
      nan_max(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  return __fdiv_rn(inter, uni);
}

// bit (i, j) of the mask: j > i and the IoU, 0 across classes when ids
// are given, exceeds thr
template <bool PIXEL, bool IDS>
__global__ void __launch_bounds__(MASK_TILE)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ ids, int n, int n_iter,
                    int words, float thr, uint32_t* __restrict__ mask) {
  const int rb = blockIdx.y, cb = blockIdx.x, b = blockIdx.z;
  if (cb < rb) return;  // every column of the tile is left of every row
  __shared__ Box cbox[MASK_TILE];
  __shared__ float carea[MASK_TILE];
  __shared__ float cid[MASK_TILE];
  const float* bb = boxes + (size_t)b * n * 4;
  const int t = threadIdx.x, j0 = cb * MASK_TILE;
  if (j0 + t < n) {
    const Box v = load_box(bb + (size_t)(j0 + t) * 4);
    cbox[t] = v;
    carea[t] = box_area<PIXEL>(v);
    if (IDS) cid[t] = ids[(size_t)b * n + j0 + t];
  }
  __syncthreads();
  const int i = rb * MASK_TILE + t;
  if (i >= n_iter) return;  // rows past n_iter suppress nothing
  const Box a = load_box(bb + (size_t)i * 4);
  const float area_a = box_area<PIXEL>(a);
  const float id_a = IDS ? ids[(size_t)b * n + i] : 0.0f;
  const int ncol = min(MASK_TILE, n - j0);
  uint32_t bits[2] = {0u, 0u};
  for (int c = 0; c < ncol; ++c) {
    if (j0 + c <= i) continue;
    float v = pair_iou<PIXEL>(a, cbox[c], area_a, carea[c]);
    if (IDS && !(id_a == cid[c])) v = 0.0f;
    if (v > thr) bits[c >> 5] |= 1u << (c & 31);
  }
  uint32_t* row = mask + ((size_t)b * n_iter + i) * words + 2 * cb;
  row[0] = bits[0];
  row[1] = bits[1];
}

__global__ void __launch_bounds__(SWEEP_THREADS)
    nms_sweep_kernel(const uint32_t* __restrict__ mask,
                     const uint8_t* __restrict__ keep0, int n, int n_iter,
                     int words, uint8_t* __restrict__ keep) {
  extern __shared__ uint32_t alive[];  // (n + 31) / 32 keep words
  __shared__ uint32_t sources;         // the live rows of the block
  const int b = blockIdx.x, t = threadIdx.x;
  const int nw = (n + 31) >> 5;
  const uint8_t* k0 = keep0 + (size_t)b * n;
  for (int w = t; w < nw; w += blockDim.x) {
    uint32_t bits = 0;
    for (int s = 0; s < 32; ++s) {
      const int i = (w << 5) + s;
      if (i < n && k0[i]) bits |= 1u << s;
    }
    alive[w] = bits;
  }
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
  for (int i = t; i < n; i += blockDim.x)
    keep[(size_t)b * n + i] = (uint8_t)((alive[i >> 5] >> (i & 31)) & 1u);
}

template <bool PIXEL, bool IDS>
void launch_mask(const float* boxes, const float* ids, int batch, int n,
                 int n_iter, int words, float thr, uint32_t* mask,
                 cudaStream_t st) {
  const dim3 grid((n + MASK_TILE - 1) / MASK_TILE,
                  (n_iter + MASK_TILE - 1) / MASK_TILE, batch);
  nms_mask_kernel<PIXEL, IDS>
      <<<grid, MASK_TILE, 0, st>>>(boxes, ids, n, n_iter, words, thr, mask);
}

}  // namespace

// boxes (batch, n, 4) f32 in score order, ids (batch, n) f32 or null,
// keep0 and keep (batch, n) bytes, mask scratch of batch * n_iter *
// words uint32 with words = 2 * ceil(n / 64) (unused when n_iter is 0).
extern "C" int mxt_nms(const void* boxes, const void* ids, const void* keep0,
                       void* keep, void* mask, int batch, int n, int n_iter,
                       float thr, int pixel, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch <= 0 || n <= 0 || n_iter < 0 || n_iter > n || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int words = 2 * ((n + MASK_TILE - 1) / MASK_TILE);
  if (n_iter > 0) {
    const float* b = (const float*)boxes;
    const float* d = (const float*)ids;
    uint32_t* m = (uint32_t*)mask;
    if (pixel && d)
      launch_mask<true, true>(b, d, batch, n, n_iter, words, thr, m, st);
    else if (pixel)
      launch_mask<true, false>(b, d, batch, n, n_iter, words, thr, m, st);
    else if (d)
      launch_mask<false, true>(b, d, batch, n, n_iter, words, thr, m, st);
    else
      launch_mask<false, false>(b, d, batch, n, n_iter, words, thr, m, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)((n + 31) / 32) * sizeof(uint32_t);
  nms_sweep_kernel<<<batch, SWEEP_THREADS, smem, st>>>(
      (const uint32_t*)mask, (const uint8_t*)keep0, n, n_iter, words,
      (uint8_t*)keep);
  return (int)cudaGetLastError();
}
