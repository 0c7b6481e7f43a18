// Hopper (sm_90a) building blocks of the bf16 tensor-core kernels (flash
// attention, the NHWC conv): TMA tile and im2col loads completed on
// mbarriers, wgmma matrix descriptors for tiles that TMA wrote with the
// 128-byte swizzle, and the wgmma instructions the kernels issue.  Host
// side: the tensor maps, encoded each call by libcuda's
// cuTensorMapEncodeTiled / cuTensorMapEncodeIm2col, reached through the
// runtime (cudaGetDriverEntryPointByVersion), so a library needs no
// -lcuda.
//
// Tiles.  Every tile is a TMA box of 64 rows x 64 bf16 columns (128
// bytes a row, 8 KB), 1024-byte aligned, swizzled: the 16-byte chunk c
// of row r sits at chunk c ^ (r % 8).  A head dim above 64 takes a
// second box for columns 64..127.  Rows past T and columns past D come
// zero-filled from TMA.  Such a tile is read by wgmma in two ways:
//  - K-major (the row index is the product's M or N, the column its K):
//    8-row groups 1024 bytes apart (SBO); a k-step of 16 columns moves
//    the start 32 bytes along the row;
//  - MN-major (the row index is K, the column index N, as for V in
//    P.V): the 8-row groups are the K steps (SBO 1024 bytes), the next
//    64 columns of N are the next box (LBO 8 KB); a k-step of 16 rows
//    moves the start 2048 bytes.
// An im2col load writes the same layout: one 128-byte row of 64
// channels per pixel, so 64 of its pixel rows are a K-major tile.
//
// f32 on the tensor cores (split3, split_box, split_pack3): each f32
// operand is split exactly into three bf16 parts, x = hi + mid + lo,
// and a product a.b is the sum of the six part products that matter,
// taken into one f32 accumulator smallest first: lo.hi, hi.lo, mid.mid,
// mid.hi, hi.mid, hi.hi (the three dropped, mid.lo, lo.mid and lo.lo,
// are below 2^-24 of the product).  That is what the TPU does for
// Precision.HIGHEST (six bf16 passes); it is not TF32, which keeps 10
// bits of each operand.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HOP_TILE_BYTES (64 * 64 * 2)  // one 64 x 64 bf16 box
#define WG_ROWS 64                      // rows of a tile: one wgmma's M
#define LOG2E 1.4426950408889634f

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory rounded up to the 1024-byte alignment that the
// 128-byte swizzle needs (the launch asks for 1 KB more)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// one arrival (of the count given to mbar_init)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------

// one box at (column c, row r, batch b) of a 3-D tensor map into smem;
// completes `bytes` of transactions on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int r,
                                            int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(r), "r"(b)
      : "memory");
}

// im2col box of a map over NHWC x (hop_map_im2col_bf16): the map's
// pixels-per-load consecutive pixels from (n, h, w) on, walked W first,
// then H, then N, inside the map's bounding box, each shifted by the
// filter tap (kh, kw); channels c .. c + 63 of each, zero past the
// image and past C
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int w,
                                                int h, int n, int kw,
                                                int kh) {
  const uint16_t ow = (uint16_t)kw, oh = (uint16_t)kh;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(ow), "h"(oh)
      : "memory");
}

// one swizzled box of smem to (column c, row r, batch b) of a 3-D
// tensor map; rows and columns past the array are not written.  Runs
// asynchronously: commit it (bulk_commit) and wait (bulk_wait_read)
// before the box is written again
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c, int r,
                                             int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c), "r"(r), "r"(b)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the committed stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of the n threads (a multiple of 32) that name barrier id
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// rows 64*t .. 64*t + 63 of two (BH, T, D) arrays (K and V, or Q and dO)
// of head bh into stage s of their 2-stage rings, each on its barrier
template <int NCH>
__device__ __forceinline__ void tma_load_pair(uint8_t* ring_a, uint8_t* ring_b,
                                              const CUtensorMap* map_a,
                                              const CUtensorMap* map_b,
                                              uint64_t* bar_a, uint64_t* bar_b,
                                              int s, int t, int bh) {
  mbar_expect_tx(bar_a, NCH * HOP_TILE_BYTES);
  for (int c = 0; c < NCH; ++c)
    tma_load_3d(ring_a + (s * NCH + c) * HOP_TILE_BYTES, map_a, bar_a,
                64 * c, 64 * t, bh);
  mbar_expect_tx(bar_b, NCH * HOP_TILE_BYTES);
  for (int c = 0; c < NCH; ++c)
    tma_load_3d(ring_b + (s * NCH + c) * HOP_TILE_BYTES, map_b, bar_b,
                64 * c, 64 * t, bh);
}

// ---- wgmma ------------------------------------------------------------

// matrix descriptor of a 128-byte-swizzled operand at smem address p
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= (uint64_t)1 << 62;  // layout: 128-byte swizzle
  return d;
}

// K-major tile: the row is M (or N), k-step kk starts 32 bytes further
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile,
                                                int kk) {
  return sw128_desc(tile + 32 * kk, 16, 1024);
}

// MN-major tile(s): the row is K, boxes of 64 columns 8 KB apart
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile,
                                                 int kk) {
  return sw128_desc(tile + 2048 * kk, HOP_TILE_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a warpgroup's register budget in a warp-specialized kernel (all four
// warps execute it; the kernel's branches by role must not reconverge)
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// keeps the compiler from touching accumulator registers across the
// asynchronous wgmma: every use after a wait depends on this
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two f32 as a bf16x2 register (lo in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the exact three-way split of f32 --------------------------------

// x = hi + mid + lo exactly, each part a bf16 (its 16 bits returned in
// the low half of h, m, l).  By truncation: hi is x with its low 16 bits
// cleared, mid the same of x - hi, lo the rest rounded to bf16, which is
// exact: x has 24 significant bits, hi takes the first 8, mid the next
// 8 of the rest and lo what remains (at most 8).  Truncation never
// overflows (rounding hi to nearest would, near FLT_MAX).  Each rest has
// x's sign or is zero; it takes x's sign bit, so that -0 splits as -0
// parts.  Exact wherever x's lowest set bit is at least 2^-133, the
// smallest bf16 subnormal: every normal |x| >= 2^-110; below that the
// lost part is under 2^-133.  A non-finite x splits as (x, 0, 0) (a nan
// stays a nan in hi), so inf and nan propagate as in f32.
__device__ __forceinline__ void split3(float x, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  const uint32_t b = __float_as_uint(x), sign = b & 0x80000000u;
  const float hi = __uint_as_float(b & 0xFFFF0000u);
  const uint32_t r1 = __float_as_uint(__fsub_rn(x, hi)) | sign;
  const float mid = __uint_as_float(r1 & 0xFFFF0000u);
  const float r2 =
      __uint_as_float(__float_as_uint(__fsub_rn(__uint_as_float(r1), mid)) |
                      sign);
  const bool finite = (b & 0x7F800000u) != 0x7F800000u;
  h = (b >> 16) | (!finite && (b & 0x007FFFFFu) ? 0x40u : 0u);
  m = finite ? r1 >> 16 : 0u;
  l = finite ? (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r2)) : 0u;
}

// The part of pair i (0..5, smallest product first) that each side
// takes: 0 hi, 1 mid, 2 lo.  A: lo hi mid mid hi hi; B: hi lo mid hi
// mid hi.
__host__ __device__ constexpr int split_a(int i) {
  return i == 0 ? 2 : (i == 2 || i == 3) ? 1 : 0;
}
__host__ __device__ constexpr int split_b(int i) {
  return i == 1 ? 2 : (i == 2 || i == 4) ? 1 : 0;
}

#define HOP_F32_BOX (64 * 64 * 4)  // one 64 x 64 f32 box, unswizzled

// A 64 x 64 f32 box as TMA loads it with no swizzle (row-major, 256
// bytes a row) into three 64 x 64 bf16 boxes hi, mid, lo in the
// 128-byte swizzle that the descriptors read (see the top of this
// file), by the NT threads t = 0 .. NT - 1.  Each thread takes 4
// columns a step: a 16-byte read (consecutive threads, consecutive
// addresses) and an 8-byte write into each part (16 threads fill one
// 128-byte row), so neither side has bank conflicts.
template <int NT>
__device__ __forceinline__ void split_box(const float* src, uint8_t* hi,
                                          uint8_t* mid, uint8_t* lo,
                                          int t) {
#pragma unroll
  for (int e = t; e < 64 * 16; e += NT) {
    const int r = e >> 4, q = e & 15;
    const float4 v = reinterpret_cast<const float4*>(src)[e];
    uint32_t h[4], m[4], l[4];
    split3(v.x, h[0], m[0], l[0]);
    split3(v.y, h[1], m[1], l[1]);
    split3(v.z, h[2], m[2], l[2]);
    split3(v.w, h[3], m[3], l[3]);
    const int off = r * 128 + ((((q >> 1) ^ (r & 7))) << 4) + ((q & 1) << 3);
    *reinterpret_cast<uint2*>(hi + off) =
        make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    *reinterpret_cast<uint2*>(mid + off) =
        make_uint2(m[0] | (m[1] << 16), m[2] | (m[3] << 16));
    *reinterpret_cast<uint2*>(lo + off) =
        make_uint2(l[0] | (l[1] << 16), l[2] | (l[3] << 16));
  }
}

// two f32 as three bf16x2 registers (x0 in the low halves): the parts
// of an RS wgmma's A fragment (layout below)
__device__ __forceinline__ void split_pack3(float x0, float x1, uint32_t& h,
                                            uint32_t& m, uint32_t& l) {
  uint32_t h0, m0, l0, h1, m1, l1;
  split3(x0, h0, m0, l0);
  split3(x1, h1, m1, l1);
  h = h0 | (h1 << 16);
  m = m0 | (m1 << 16);
  l = l0 | (l1 << 16);
}

// Accumulator layout of m64nN (f32): thread (warp w, lane l) holds, for
// each group j of 8 columns, d[4j + e] at row 16w + l/4 + 8*(e >> 1),
// column 8j + 2*(l % 4) + (e & 1).  The A-register fragment of an RS
// wgmma over k-columns 16kk..16kk+15 is exactly d[8kk .. 8kk + 7] of
// such an accumulator, packed in pairs: so an accumulator turns into
// the next product's A operand without going through shared memory.

// A 64 x 64*NB f32 accumulator of a warpgroup, rounded to bf16, into NB
// swizzled 64 x 64 boxes at `boxes` (the layout TMA loads and stores):
// element (r, c) sits in box c / 64, row r, 16-byte chunk (c % 64) / 8
// ^ (r % 8).  The 8 rows a warp writes at once fall in 8 different
// chunks, so the writes are free of bank conflicts.
template <int NB>
__device__ __forceinline__ void stage_acc(uint8_t* boxes,
                                          const float (&d)[32 * NB],
                                          int warp, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    uint8_t* row = boxes + r * 128 + 4 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
      *reinterpret_cast<uint32_t*>(row + (j >> 3) * HOP_TILE_BYTES +
                                   (((j & 7) ^ (r & 7)) << 4)) =
          pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// D(64x64, f32) (+)= A(64x16, smem) * B(16x64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_m64n64k16(
    float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64x64, f32) += A(64x16, registers) * B(16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64k16_mn(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D(64x128, f32) += A(64x16, registers) * B(16x128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128k16_mn(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// O (64 x 64*NCH) += A (registers) * B (NCH boxes, MN-major)
template <int NCH>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32 * NCH],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (NCH == 1)
    wgmma_rs_m64n64k16_mn(d, a, db, 1);
  else
    wgmma_rs_m64n128k16_mn(d, a, db, 1);
}

// Columns [HALF * 32 NB, (HALF + 1) * 32 NB) of a 64 x 64*NB f32
// accumulator of a warpgroup into NB swizzled boxes of 64 rows x 32 f32
// (128 bytes a row, 8 KB; the f32 map's box, hop_map_3d): element (r, c)
// of the half sits in box c / 32, row r, 16-byte chunk (c % 32) / 4 ^
// (r % 8).  A warp's 8-byte writes of one instruction fall two to a
// chunk over the 8 rows: no more than the two passes 256 bytes take.
template <int NB, int HALF>
__device__ __forceinline__ void stage_acc_f32(uint8_t* boxes,
                                              const float (&d)[32 * NB],
                                              int warp, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    uint8_t* row = boxes + r * 128 + 8 * (lane & 1);
#pragma unroll
    for (int jj = 0; jj < 4 * NB; ++jj) {
      const int j = HALF * 4 * NB + jj;
      const int chunk = 2 * (jj & 3) + ((lane >> 1) & 1);
      *reinterpret_cast<float2*>(row + (jj >> 2) * HOP_TILE_BYTES +
                                 ((chunk ^ (r & 7)) << 4)) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// SS products with B MN-major (the transpose bit), N = 64, 128, 256:
// B is N/64 boxes of 64 K-rows x 64 N-columns, 8 KB apart (mnmajor_desc)
// D(64x64, f32) (+)= A(64x16, smem, K-major) * B(16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_ss_m64n64k16_tb(
    float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64x128, f32) (+)= A(64x16, smem, K-major) * B(16x128, smem, MN-major)
__device__ __forceinline__ void wgmma_ss_m64n128k16_tb(
    float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64x256, f32) (+)= A(64x16, smem, K-major) * B(16x256, smem, MN-major)
__device__ __forceinline__ void wgmma_ss_m64n256k16_tb(
    float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[BN / 2], uint64_t da,
                                            uint64_t db, int acc) {
  if constexpr (BN == 64)
    wgmma_ss_m64n64k16_tb(d, da, db, acc);
  else if constexpr (BN == 128)
    wgmma_ss_m64n128k16_tb(d, da, db, acc);
  else
    wgmma_ss_m64n256k16_tb(d, da, db, acc);
}

// ---- host: tensor maps ------------------------------------------------

// a libcuda entry point by name, or nullptr
static void* hop_libcuda_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault,
                                       &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    return nullptr;
  return fn;
}

// The tensor map of a contiguous (BH, T, D) array of `type` (elements
// of `esize` bytes), 16-byte aligned with a 16-byte row stride: boxes of
// 64 rows x `cols` elements, zeros outside the array.  Returns 0 or a
// cudaError_t.
static int hop_map_3d(CUtensorMap* map, const void* ptr,
                      CUtensorMapDataType type, int esize, int BH, int T,
                      int D, int cols, CUtensorMapSwizzle swizzle) {
  static const auto encode = reinterpret_cast<decltype(
      &cuTensorMapEncodeTiled)>(hop_libcuda_fn("cuTensorMapEncodeTiled"));
  if (!encode) return (int)cudaErrorSymbolNotFound;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) || (D * esize) % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * esize,
                                 (cuuint64_t)T * D * esize};
  const cuuint32_t box[3] = {(cuuint32_t)cols, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// bf16 (BH, T, D), D % 8 == 0: boxes of 64 x 64, 128-byte swizzle
static int hop_map_bf16(CUtensorMap* map, const void* ptr, int BH, int T,
                        int D) {
  return hop_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, BH, T, D,
                    64, CU_TENSOR_MAP_SWIZZLE_128B);
}

// f32 (BH, T, D), D % 4 == 0, read by split_box: boxes of 64 x 64, no
// swizzle
static int hop_map_f32(CUtensorMap* map, const void* ptr, int BH, int T,
                       int D) {
  return hop_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, BH, T, D,
                    64, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// f32 (BH, T, D) written from stage_acc_f32's boxes: 64 x 32, 128-byte
// swizzle
static int hop_map_f32_out(CUtensorMap* map, const void* ptr, int BH, int T,
                           int D) {
  return hop_map_3d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, BH, T, D,
                    32, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The im2col tensor map of a contiguous bf16 NHWC array x (C % 8 == 0,
// 16-byte aligned) for a stride-1 convolution that pads ph rows and pw
// columns before the image and keeps H x W outputs.  A load
// (tma_load_im2col) gives `pixels` rows of 64 channels, 128-byte
// swizzled: the output pixels from (n, h, w) on in row-major order,
// each read at (h - ph + kh, w - pw + kw) of its image for the tap
// (kh, kw) the load names, zeros off the image.  The bounding box of
// the walk (both corners -ph, -pw: the upper corner counts from the
// image's last row and column) spans exactly H x W base pixels; the
// load's coordinates are those of its first pixel's base, (h - ph,
// w - pw).  Returns 0 or a cudaError_t.
static int hop_map_im2col_bf16(CUtensorMap* map, const void* x, int N, int H,
                               int W, int C, int ph, int pw, int pixels) {
  static const auto encode = reinterpret_cast<decltype(
      &cuTensorMapEncodeIm2col)>(hop_libcuda_fn("cuTensorMapEncodeIm2col"));
  if (!encode) return (int)cudaErrorSymbolNotFound;
  if ((reinterpret_cast<uintptr_t>(x) & 15) || C % 8)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const int lower[2] = {-pw, -ph}, upper[2] = {-pw, -ph};  // (w, h)
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, lower, upper, 64, (cuuint32_t)pixels, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
