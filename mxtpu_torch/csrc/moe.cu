// Switch-MoE routing on the card: the router's top-1 choice with its ordered
// capacity slots, the dispatch of tokens into expert slots, and the
// gate-weighted combine back, forward and backward; called by
// mxtpu_torch/kernels/moe.py.
//
// Replaces no Pallas kernel.  mxtpu routes with dense one-hot einsums
// (mxtpu/parallel/moe.py: switch_router :37, moe_ffn :73, 'td,tec->ecd'
// and 'ecd,tec->td' in f32), a layout XLA tiles onto the TPU's matrix unit.
// Each slot holds at most one token and each token at most one slot, so
// those einsums compute a permutation: at bench.py's moe_ffn shape (T 8192,
// E 8, C 1280, D 1024) each is 172 GFLOP of f32 multiply-adds on the CUDA
// cores (TF32 stays off) whose result is a gather.  Here the gather is the
// kernel, and on finite inputs it gives the same bits: dispatch copies
// x[t] (x * 1.0 plus zeros is exact), combine writes round_f32(expert_out *
// gate_p) (one product plus zeros), cast to the compute type.
//
// What bounds them:
//   moe_route_kernel: latency.  T x E f32 logits in, a few words a token
//     out (~0.4 MB at bench's shape, 0.1 us of bytes).  The slot of a
//     token is its ORDERED rank among the tokens routed to its expert
//     before it (mxtpu's cumsum over T): an atomic counter would hand out
//     ranks in race order and drop other tokens than the reference does.
//     So one thread block cluster of ROUTE_CLUSTER CTAs takes T in rounds
//     of ROUTE_CLUSTER x ROUTE_THREADS tokens, a CTA a contiguous chunk
//     of ROUTE_THREADS in rank order (bench's T 8192 is one round on 8
//     SMs).  A thread takes a token: its softmax (each exp computed once
//     and kept in registers up to ROUTE_EREG experts, in probs past it
//     until the sum divides it), the argmax (first maximum wins, as
//     jnp.argmax), its rank in its warp from __match_any_sync.
//     A warp an expert scans the 32 warps' counts with shuffles and sums
//     their probabilities; the CTA publishes its counts and sums in its
//     shared memory, and after cluster.sync() each CTA reads those of the
//     CTAs ranked before it through distributed shared memory
//     (map_shared_rank): its exclusive base per expert, the round's
//     totals, carried into the next round.  No atomic decides a rank.
//     The load-balancing sums are taken in one fixed order (a warp's
//     lanes and then a CTA's warps by xor butterflies, the CTAs in rank
//     order, the rounds in order), so two calls give the same bits.  Once
//     the totals are known, the CTA owning expert e (e % ROUTE_CLUSTER)
//     writes -1 into its empty slots [count_e, C): token_of_slot is
//     written once, with no zeroing pass.
//   moe_dispatch_kernel / moe_dispatch_bwd_kernel: bytes.  One warp a row
//     copies it with 16-byte accesses where the row and the pointers
//     allow: expert_in[s] = x[token_of_slot[s]] (0 for an empty slot), and
//     backward dx[t] = d_expert_in[slot_of_token[t]] (0 for a dropped
//     token).  At bench's shape 16.8 MB of x in and 21.0 MB out.
//   moe_combine_kernel: bytes.  y[t] = cast(f32(expert_out[slot]) *
//     gate_p[t]), 0 for a dropped token; one warp a token row.
//   moe_combine_bwd_kernel: bytes.  One warp a slot: d_expert_out[s] =
//     cast(gate_p[t] * f32(dy[t])) (0 for an empty slot) and d_gate_p[t] =
//     the f32 dot of expert_out[s] and dy[t], reduced across the warp.
// Fusing the gathers into the expert GEMMs' prologue and epilogue is
// later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ROUTE_THREADS = 1024;  // tokens a CTA takes a round
constexpr int ROUTE_WARPS = ROUTE_THREADS / 32;
constexpr int ROUTE_CLUSTER = 8;     // CTAs of the one cluster (portable)
constexpr int MAX_EXPERTS = 128;     // shared memory < 48 KB
constexpr int ROUTE_EREG = 8;        // up to this E, exps in registers
constexpr int ROW_THREADS = 256;                   // row kernels: a warp a row
constexpr int ROW_WARPS = ROW_THREADS / 32;
static_assert(ROUTE_WARPS == 32, "a warp's lanes scan the CTA's warps");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// EREG: with E <= EREG a token's exps stay in registers, with 0 they
// wait in probs until their sum divides them
template <int EREG>
__global__ void __cluster_dims__(ROUTE_CLUSTER, 1, 1)
    __launch_bounds__(ROUTE_THREADS)
moe_route_kernel(const float* __restrict__ logits, int T, int E, int C,
                 float* __restrict__ probs, int* __restrict__ expert,
                 float* __restrict__ gate_p, int* __restrict__ slot_of_token,
                 int* __restrict__ token_of_slot, float* __restrict__ frac,
                 float* __restrict__ mean_p) {
  extern __shared__ int smem[];
  int* warp_cnt = smem;                                    // [warps][E]
  float* warp_psum = (float*)(warp_cnt + ROUTE_WARPS * E);  // [warps][E]
  int* pub_cnt = (int*)(warp_psum + ROUTE_WARPS * E);  // [2][E], read by
  float* pub_psum = (float*)(pub_cnt + 2 * E);         // the cluster
  int* base = (int*)(pub_psum + 2 * E);                     // [E]
  int* carry_cnt = base + E;                                // [E]
  float* carry_psum = (float*)(carry_cnt + E);              // [E]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int e = tid; e < E; e += ROUTE_THREADS) {
    carry_cnt[e] = 0;
    carry_psum[e] = 0.0f;
  }
  const int64_t per_round = (int64_t)ROUTE_CLUSTER * ROUTE_THREADS;
  int par = 0;  // which half of pub_* this round publishes in
  for (int64_t t0 = 0; t0 < T; t0 += per_round, par ^= 1) {
    const int64_t t = t0 + (int64_t)rank * ROUTE_THREADS + tid;
    const bool valid = t < T;
    const float* row = logits + (valid ? t : 0) * E;
    float* prow = probs + (valid ? t : 0) * E;
    // softmax as jax.nn.softmax: exp(x - max) / sum, the sum in expert
    // order, each exp computed once
    float m = 0.0f, s = 0.0f, bp = 0.0f, ex[EREG > 0 ? EREG : 1];
    int best = -1;
    if (valid) {
      m = row[0];
      if constexpr (EREG > 0) {
#pragma unroll
        for (int e = 1; e < EREG; ++e)
          if (e < E) m = fmaxf(m, row[e]);
#pragma unroll
        for (int e = 0; e < EREG; ++e)
          if (e < E) {
            ex[e] = expf(row[e] - m);
            s += ex[e];
          }
      } else {
        for (int e = 1; e < E; ++e) m = fmaxf(m, row[e]);
        for (int e = 0; e < E; ++e) {
          const float x = expf(row[e] - m);
          s += x;
          prow[e] = x;
        }
      }
    }
    // this warp's row of counts: zeroed by the warp
    for (int e = lane; e < E; e += 32) warp_cnt[w * E + e] = 0;
    // the probabilities, the argmax (the first maximum wins) and the
    // warp's sum of each expert's probability
    auto prob = [&](int e, float x) {
      float p = 0.0f;
      if (valid) {
        p = x / s;
        prow[e] = p;
        if (best < 0 || p > bp) {
          best = e;
          bp = p;
        }
      }
      p = warp_sum(p);
      if (lane == 0) warp_psum[w * E + e] = p;
    };
    if constexpr (EREG > 0) {
#pragma unroll
      for (int e = 0; e < EREG; ++e)
        if (e < E) prob(e, ex[e]);
    } else {
      for (int e = 0; e < E; ++e) prob(e, valid ? prow[e] : 0.0f);
    }
    if (valid) {
      expert[t] = best;
      gate_p[t] = bp;
    }
    // each group of lanes sharing an expert writes its size from its
    // lowest lane
    const unsigned same = __match_any_sync(0xffffffffu, best);
    const int rank_w = __popc(same & below);
    __syncwarp();
    if (valid && rank_w == 0) warp_cnt[w * E + best] = __popc(same);
    __syncthreads();
    // a warp an expert: each warp's count becomes the number of earlier
    // tokens of the CTA routed to the expert (a shuffle scan over the
    // warps); the CTA's total and probability sum are published
    for (int e = w; e < E; e += ROUTE_WARPS) {
      const int c = warp_cnt[lane * E + e];
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      warp_cnt[lane * E + e] = incl - c;
      if (lane == 31) pub_cnt[par * E + e] = incl;
      const float ps = warp_sum(warp_psum[lane * E + e]);
      if (lane == 0) pub_psum[par * E + e] = ps;
    }
    cluster.sync();
    // the counts of the CTAs ranked before this one give its base; the
    // round's totals (probability sums in rank order) are carried
    for (int e = tid; e < E; e += ROUTE_THREADS) {
      int before = 0, total = 0;
      float ps = 0.0f;
#pragma unroll
      for (int r = 0; r < ROUTE_CLUSTER; ++r) {
        const int v =
            cluster.map_shared_rank(pub_cnt, (unsigned)r)[par * E + e];
        before += r < rank ? v : 0;
        total += v;
        ps +=
            cluster.map_shared_rank(pub_psum, (unsigned)r)[par * E + e];
      }
      base[e] = carry_cnt[e] + before;
      carry_cnt[e] += total;
      carry_psum[e] += ps;
    }
    __syncthreads();
    if (valid) {
      const int pos = base[best] + warp_cnt[w * E + best] + rank_w;
      int slot = -1;
      if (pos < C) {
        slot = best * C + pos;
        token_of_slot[slot] = (int)t;
      }
      slot_of_token[t] = slot;
    }
    __syncwarp();  // the warp's reads of its row before the next zeroing
  }
  // the empty slots of the experts this CTA owns
  for (int e = rank; e < E; e += ROUTE_CLUSTER) {
    const int filled = min(carry_cnt[e], C);
    for (int s = filled + tid; s < C; s += ROUTE_THREADS)
      token_of_slot[(int64_t)e * C + s] = -1;
  }
  if (rank == 0)
    for (int e = tid; e < E; e += ROUTE_THREADS) {
      frac[e] = (float)carry_cnt[e] / (float)T;
      mean_p[e] = carry_psum[e] / (float)T;
    }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// out[r] = src[idx[r]] (a row of `units` words), 0 where idx[r] < 0
template <typename U>
__device__ __forceinline__ void gather_row(const U* __restrict__ src,
                                           const int* __restrict__ idx,
                                           U* __restrict__ out, int64_t rows,
                                           int units) {
  const int64_t r = (int64_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = idx[r];
  U* o = out + r * units;
  if (s < 0) {
    for (int u = lane; u < units; u += 32) o[u] = U{};
    return;
  }
  const U* i = src + (int64_t)s * units;
  for (int u = lane; u < units; u += 32) o[u] = i[u];
}

template <typename U>
__global__ void __launch_bounds__(ROW_THREADS)
moe_dispatch_kernel(const U* __restrict__ x, const int* __restrict__ token_of_slot,
                    U* __restrict__ expert_in, int64_t slots, int units) {
  gather_row<U>(x, token_of_slot, expert_in, slots, units);
}

template <typename U>
__global__ void __launch_bounds__(ROW_THREADS)
moe_dispatch_bwd_kernel(const U* __restrict__ d_expert_in,
                        const int* __restrict__ slot_of_token,
                        U* __restrict__ dx, int64_t tokens, int units) {
  gather_row<U>(d_expert_in, slot_of_token, dx, tokens, units);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// VEC elements of T loaded or stored in one access (16 bytes when the
// wrapper found the rows and pointers aligned, else one element)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(ROW_THREADS)
moe_combine_kernel(const T* __restrict__ expert_out,
                   const int* __restrict__ slot_of_token,
                   const float* __restrict__ gate_p, T* __restrict__ y,
                   int64_t tokens, int D) {
  const int64_t t = (int64_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (t >= tokens) return;
  const int lane = threadIdx.x & 31;
  const int s = slot_of_token[t];
  const float g = gate_p[t];
  Pack<T, VEC>* yo = reinterpret_cast<Pack<T, VEC>*>(y + t * D);
  const Pack<T, VEC>* src =
      reinterpret_cast<const Pack<T, VEC>*>(expert_out + (int64_t)(s < 0 ? 0 : s) * D);
  for (int u = lane; u < D / VEC; u += 32) {
    Pack<T, VEC> out;
    if (s < 0) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) out.v[k] = from_f<T>(0.0f);
    } else {
      const Pack<T, VEC> in = src[u];
#pragma unroll
      for (int k = 0; k < VEC; ++k) out.v[k] = from_f<T>(__fmul_rn(to_f(in.v[k]), g));
    }
    yo[u] = out;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(ROW_THREADS)
moe_combine_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ expert_out,
                       const int* __restrict__ token_of_slot,
                       const float* __restrict__ gate_p, T* __restrict__ d_expert_out,
                       float* __restrict__ d_gate_p, int64_t slots, int D) {
  const int64_t s = (int64_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (s >= slots) return;
  const int lane = threadIdx.x & 31;
  const int t = token_of_slot[s];
  Pack<T, VEC>* de = reinterpret_cast<Pack<T, VEC>*>(d_expert_out + s * D);
  if (t < 0) {
    for (int u = lane; u < D / VEC; u += 32) {
      Pack<T, VEC> z;
#pragma unroll
      for (int k = 0; k < VEC; ++k) z.v[k] = from_f<T>(0.0f);
      de[u] = z;
    }
    return;
  }
  const float g = gate_p[t];
  const Pack<T, VEC>* dyr = reinterpret_cast<const Pack<T, VEC>*>(dy + (int64_t)t * D);
  const Pack<T, VEC>* eo = reinterpret_cast<const Pack<T, VEC>*>(expert_out + s * D);
  float acc = 0.0f;
  for (int u = lane; u < D / VEC; u += 32) {
    const Pack<T, VEC> a = dyr[u];
    const Pack<T, VEC> b = eo[u];
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float dv = to_f(a.v[k]);
      out.v[k] = from_f<T>(__fmul_rn(g, dv));
      acc = fmaf(to_f(b.v[k]), dv, acc);
    }
    de[u] = out;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) d_gate_p[t] = acc;
}

inline bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

inline unsigned row_grid(int64_t rows) {
  return (unsigned)((rows + ROW_WARPS - 1) / ROW_WARPS);
}

// a gather of `rows` rows of `row_bytes` bytes, in the widest word that
// the row size and both pointers allow
template <bool BWD>
int launch_gather(const void* src, const int* idx, void* out, int64_t rows,
                  int64_t row_bytes, cudaStream_t st) {
  if (rows <= 0 || row_bytes <= 0 ||
      (rows + ROW_WARPS - 1) / ROW_WARPS > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = row_grid(rows);
#define MXT_GATHER(U)                                                        \
  do {                                                                       \
    const int units = (int)(row_bytes / sizeof(U));                          \
    if (BWD)                                                                 \
      moe_dispatch_bwd_kernel<U><<<grid, ROW_THREADS, 0, st>>>(              \
          (const U*)src, idx, (U*)out, rows, units);                         \
    else                                                                     \
      moe_dispatch_kernel<U><<<grid, ROW_THREADS, 0, st>>>(                  \
          (const U*)src, idx, (U*)out, rows, units);                         \
  } while (0)
  if (row_bytes % 16 == 0 && aligned(src, 16) && aligned(out, 16))
    MXT_GATHER(uint4);
  else if (row_bytes % 4 == 0 && aligned(src, 4) && aligned(out, 4))
    MXT_GATHER(uint32_t);
  else if (row_bytes % 2 == 0 && aligned(src, 2) && aligned(out, 2))
    MXT_GATHER(uint16_t);
  else
    MXT_GATHER(uint8_t);
#undef MXT_GATHER
  return (int)cudaGetLastError();
}

template <typename T>
int launch_combine(const void* eo, const int* slot_of_token, const float* gate_p,
                   void* y, int64_t tokens, int D, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const unsigned grid = row_grid(tokens);
  if (D % V == 0 && aligned(eo, 16) && aligned(y, 16))
    moe_combine_kernel<T, V><<<grid, ROW_THREADS, 0, st>>>(
        (const T*)eo, slot_of_token, gate_p, (T*)y, tokens, D);
  else
    moe_combine_kernel<T, 1><<<grid, ROW_THREADS, 0, st>>>(
        (const T*)eo, slot_of_token, gate_p, (T*)y, tokens, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_combine_bwd(const void* dy, const void* eo, const int* token_of_slot,
                       const float* gate_p, void* d_eo, float* d_gate,
                       int64_t slots, int D, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const unsigned grid = row_grid(slots);
  if (D % V == 0 && aligned(dy, 16) && aligned(eo, 16) && aligned(d_eo, 16))
    moe_combine_bwd_kernel<T, V><<<grid, ROW_THREADS, 0, st>>>(
        (const T*)dy, (const T*)eo, token_of_slot, gate_p, (T*)d_eo, d_gate,
        slots, D);
  else
    moe_combine_bwd_kernel<T, 1><<<grid, ROW_THREADS, 0, st>>>(
        (const T*)dy, (const T*)eo, token_of_slot, gate_p, (T*)d_eo, d_gate,
        slots, D);
  return (int)cudaGetLastError();
}

}  // namespace

// logits (T, E) f32 -> probs (T, E) f32, expert, gate_p, slot_of_token (T),
// token_of_slot (E * C), frac and mean_p (E); 1 <= E <= MAX_EXPERTS.
extern "C" int mxt_moe_route(const void* logits, int T, int E, int C,
                             void* probs, void* expert, void* gate_p,
                             void* slot_of_token, void* token_of_slot,
                             void* frac, void* mean_p, void* stream) {
  if (T <= 0 || E <= 0 || E > MAX_EXPERTS || C <= 0 ||
      (int64_t)E * C > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * ROUTE_WARPS * E + 7 * E) * sizeof(int);
  auto kernel = E <= ROUTE_EREG ? moe_route_kernel<ROUTE_EREG>
                                : moe_route_kernel<0>;
  kernel<<<ROUTE_CLUSTER, ROUTE_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)logits, T, E, C, (float*)probs, (int*)expert,
      (float*)gate_p, (int*)slot_of_token, (int*)token_of_slot, (float*)frac,
      (float*)mean_p);
  return (int)cudaGetLastError();
}

// expert_in (E * C rows) = x rows by token_of_slot, 0 where it is -1
extern "C" int mxt_moe_dispatch(const void* x, const void* token_of_slot,
                                void* expert_in, int64_t slots,
                                int64_t row_bytes, void* stream) {
  return launch_gather<false>(x, (const int*)token_of_slot, expert_in, slots,
                              row_bytes, (cudaStream_t)stream);
}

// dx (T rows) = d_expert_in rows by slot_of_token, 0 where it is -1
extern "C" int mxt_moe_dispatch_bwd(const void* d_expert_in,
                                    const void* slot_of_token, void* dx,
                                    int64_t tokens, int64_t row_bytes,
                                    void* stream) {
  return launch_gather<true>(d_expert_in, (const int*)slot_of_token, dx,
                             tokens, row_bytes, (cudaStream_t)stream);
}

// dtype: 0 f32, 1 bf16, 2 f16
extern "C" int mxt_moe_combine(const void* expert_out,
                               const void* slot_of_token, const void* gate_p,
                               void* y, int64_t tokens, int D, int dtype,
                               void* stream) {
  if (tokens <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* sot = (const int*)slot_of_token;
  const float* g = (const float*)gate_p;
  if (dtype == 0)
    return launch_combine<float>(expert_out, sot, g, y, tokens, D, st);
  if (dtype == 1)
    return launch_combine<__nv_bfloat16>(expert_out, sot, g, y, tokens, D, st);
  if (dtype == 2)
    return launch_combine<__half>(expert_out, sot, g, y, tokens, D, st);
  return (int)cudaErrorInvalidValue;
}

// d_expert_out (E * C, D) and d_gate_p (T, zeroed by the caller: a dropped
// token's stays 0)
extern "C" int mxt_moe_combine_bwd(const void* dy, const void* expert_out,
                                   const void* token_of_slot,
                                   const void* gate_p, void* d_expert_out,
                                   void* d_gate_p, int64_t slots, int D,
                                   int dtype, void* stream) {
  if (slots <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* tos = (const int*)token_of_slot;
  const float* g = (const float*)gate_p;
  float* dg = (float*)d_gate_p;
  if (dtype == 0)
    return launch_combine_bwd<float>(dy, expert_out, tos, g, d_expert_out, dg,
                                     slots, D, st);
  if (dtype == 1)
    return launch_combine_bwd<__nv_bfloat16>(dy, expert_out, tos, g,
                                             d_expert_out, dg, slots, D, st);
  if (dtype == 2)
    return launch_combine_bwd<__half>(dy, expert_out, tos, g, d_expert_out,
                                      dg, slots, D, st);
  return (int)cudaErrorInvalidValue;
}
