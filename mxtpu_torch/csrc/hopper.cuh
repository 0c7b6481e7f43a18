// Hopper (sm_90a) building blocks of the bf16 flash kernels: TMA tile
// loads completed on mbarriers, wgmma matrix descriptors for tiles that
// TMA wrote with the 128-byte swizzle, and the wgmma instructions the
// kernels issue.  Host side: the 3-D tensor maps over (BH, T, D) arrays,
// encoded each call by libcuda's cuTensorMapEncodeTiled, reached
// through the runtime (cudaGetDriverEntryPointByVersion), so a library
// needs no -lcuda.
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

// Accumulator layout of m64nN (f32): thread (warp w, lane l) holds, for
// each group j of 8 columns, d[4j + e] at row 16w + l/4 + 8*(e >> 1),
// column 8j + 2*(l % 4) + (e & 1).  The A-register fragment of an RS
// wgmma over k-columns 16kk..16kk+15 is exactly d[8kk .. 8kk + 7] of
// such an accumulator, packed in pairs: so an accumulator turns into
// the next product's A operand without going through shared memory.

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

// ---- host: tensor maps ------------------------------------------------

typedef CUresult (*hop_encode_fn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static hop_encode_fn hop_load_encode() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                       cudaEnableDefault,
                                       &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<hop_encode_fn>(fn);
}

// The tensor map of a contiguous bf16 (BH, T, D) array, D % 8 == 0 (a
// 16-byte row stride), 16-byte aligned: boxes of 64 x 64, 128-byte
// swizzle, zeros outside the array.  Returns 0 or a cudaError_t.
static int hop_map_bf16(CUtensorMap* map, const void* ptr, int BH, int T,
                        int D) {
  static const hop_encode_fn encode = hop_load_encode();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) || D % 8)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
