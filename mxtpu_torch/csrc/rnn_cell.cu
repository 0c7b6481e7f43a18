// The gate math of one recurrence step of the fused RNN op (LSTM and GRU),
// forward and backward, called by mxtpu_torch/kernels/rnn_cell.py.
//
// Replaces no Pallas kernel.  mxtpu lowers the RNN op to one lax.scan a
// layer and direction (mxtpu/ndarray/rnn_impl.py _scan_dir, :77-116) and
// XLA fuses the scan body's elementwise part into one fusion a step; here
// a step is a torch GEMM (h . W_h2h^T) and one launch of these kernels.
// The i2h GEMM of every step is hoisted out of the loop, as mxtpu does.
//
// What bounds it: bytes.  A step reads pre_t and h.W^T (G·H a row each)
// and the carried state, and writes h, c and what the backward needs, a
// few flops an element: at the LM's N 20, H 1500 about 1.8 MB in f32,
// 0.5 us at 3.35 TB/s, under a launch's own latency.  The design is the
// simple one: one thread an (n, j) element of the (N, H) state, each
// reading its G gate columns j, H + j, ... of both inputs (neighbouring
// threads on neighbouring addresses in each), all arithmetic in f32
// (expf / tanhf), inputs and outputs f32 or bf16.  The activated gates
// are saved in f32 whatever the type, so the bf16 backward rounds only
// its inputs and outputs.  The RNN op now runs the whole recurrence of a
// layer and direction as one persistent launch that keeps W_h2h and the
// state on chip across steps (csrc/rnn_scan.cu) wherever that kernel's
// limits allow; these per-step kernels serve the shapes past them (a
// bf16 weight slice over a CTA's shared memory).
//
// Layouts (row-major, contiguous, checked by the wrapper):
//   LSTM forward:  pre, hh (N, 4H) gates [i, f, g, o]; c_prev (N, H) ->
//                  h, c (N, H), gates (N, 4H) f32 = [sig i, sig f,
//                  tanh g, sig o]
//   LSTM backward: dh, dc (N, H), gates, c_prev, c -> dgates (N, 4H) (the
//                  gradient of pre and of hh alike), dc_prev (N, H)
//   GRU forward:   pre (N, 3H) = W_i x + b_i + [b_hr, b_hz, 0], hh (N, 3H)
//                  = h_prev . W_h^T, b_rn (H), h_prev (N, H) -> h (N, H),
//                  saved (N, 4H) f32 = [r, z, n, hh_n + b_rn]
//   GRU backward:  dh (N, H), saved, h_prev -> dpre (N, 3H), dhh (N, 3H),
//                  dh_prev (N, H)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// torch.sigmoid's 1 / (1 + exp(-x))
__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const T* __restrict__ pre, const T* __restrict__ hh,
                const T* __restrict__ c_prev, T* __restrict__ h,
                T* __restrict__ c, float* __restrict__ gates, int n, int H) {
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (int64_t)n * H) return;
  const int64_t row = e / H, j = e - row * H;
  const int64_t g0 = row * 4 * H + j;
  const float i = sigm(ld(pre, g0) + ld(hh, g0));
  const float f = sigm(ld(pre, g0 + H) + ld(hh, g0 + H));
  const float g = tanhf(ld(pre, g0 + 2 * H) + ld(hh, g0 + 2 * H));
  const float o = sigm(ld(pre, g0 + 3 * H) + ld(hh, g0 + 3 * H));
  const float c2 = f * ld(c_prev, e) + i * g;
  st(c, e, c2);
  st(h, e, o * tanhf(c2));
  gates[g0] = i;
  gates[g0 + H] = f;
  gates[g0 + 2 * H] = g;
  gates[g0 + 3 * H] = o;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const T* __restrict__ dh, const T* __restrict__ dc,
                const float* __restrict__ gates, const T* __restrict__ c_prev,
                const T* __restrict__ c, T* __restrict__ dgates,
                T* __restrict__ dc_prev, int n, int H) {
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (int64_t)n * H) return;
  const int64_t row = e / H, j = e - row * H;
  const int64_t g0 = row * 4 * H + j;
  const float i = gates[g0], f = gates[g0 + H], g = gates[g0 + 2 * H],
              o = gates[g0 + 3 * H];
  const float tc = tanhf(ld(c, e));
  const float dhv = ld(dh, e);
  const float dct = ld(dc, e) + dhv * o * (1.0f - tc * tc);
  st(dgates, g0, dct * g * i * (1.0f - i));
  st(dgates, g0 + H, dct * ld(c_prev, e) * f * (1.0f - f));
  st(dgates, g0 + 2 * H, dct * i * (1.0f - g * g));
  st(dgates, g0 + 3 * H, dhv * tc * o * (1.0f - o));
  st(dc_prev, e, dct * f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(const T* __restrict__ pre, const T* __restrict__ hh,
               const T* __restrict__ b_rn, const T* __restrict__ h_prev,
               T* __restrict__ h, float* __restrict__ saved, int n, int H) {
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (int64_t)n * H) return;
  const int64_t row = e / H, j = e - row * H;
  const int64_t g0 = row * 3 * H + j, s0 = row * 4 * H + j;
  const float r = sigm(ld(pre, g0) + ld(hh, g0));
  const float z = sigm(ld(pre, g0 + H) + ld(hh, g0 + H));
  const float hn = ld(hh, g0 + 2 * H) + ld(b_rn, j);
  const float nv = tanhf(ld(pre, g0 + 2 * H) + r * hn);
  st(h, e, (1.0f - z) * nv + z * ld(h_prev, e));
  saved[s0] = r;
  saved[s0 + H] = z;
  saved[s0 + 2 * H] = nv;
  saved[s0 + 3 * H] = hn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(const T* __restrict__ dh, const float* __restrict__ saved,
               const T* __restrict__ h_prev, T* __restrict__ dpre,
               T* __restrict__ dhh, T* __restrict__ dh_prev, int n, int H) {
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (int64_t)n * H) return;
  const int64_t row = e / H, j = e - row * H;
  const int64_t g0 = row * 3 * H + j, s0 = row * 4 * H + j;
  const float r = saved[s0], z = saved[s0 + H], nv = saved[s0 + 2 * H],
              hn = saved[s0 + 3 * H];
  const float dhv = ld(dh, e);
  const float dn = dhv * (1.0f - z) * (1.0f - nv * nv);
  const float dz = dhv * (ld(h_prev, e) - nv) * z * (1.0f - z);
  const float dr = dn * hn * r * (1.0f - r);
  st(dpre, g0, dr);
  st(dpre, g0 + H, dz);
  st(dpre, g0 + 2 * H, dn);
  st(dhh, g0, dr);
  st(dhh, g0 + H, dz);
  st(dhh, g0 + 2 * H, dn * r);
  st(dh_prev, e, dhv * z);
}

inline bool bad(int n, int H) {
  return n <= 0 || H <= 0 || (int64_t)n * H > ((int64_t)1 << 31) * THREADS;
}

inline dim3 grid_of(int n, int H) {
  return dim3((unsigned)(((int64_t)n * H + THREADS - 1) / THREADS));
}

}  // namespace

extern "C" int mxt_lstm_fwd(const void* pre, const void* hh,
                            const void* c_prev, void* h, void* c, void* gates,
                            int n, int H, int bf16, void* stream) {
  if (bad(n, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* gs = (float*)gates;
  if (bf16)
    lstm_fwd_kernel<__nv_bfloat16><<<grid_of(n, H), THREADS, 0, st>>>(
        (const __nv_bfloat16*)pre, (const __nv_bfloat16*)hh,
        (const __nv_bfloat16*)c_prev, (__nv_bfloat16*)h, (__nv_bfloat16*)c,
        gs, n, H);
  else
    lstm_fwd_kernel<float><<<grid_of(n, H), THREADS, 0, st>>>(
        (const float*)pre, (const float*)hh, (const float*)c_prev, (float*)h,
        (float*)c, gs, n, H);
  return (int)cudaGetLastError();
}

extern "C" int mxt_lstm_bwd(const void* dh, const void* dc, const void* gates,
                            const void* c_prev, const void* c, void* dgates,
                            void* dc_prev, int n, int H, int bf16,
                            void* stream) {
  if (bad(n, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* gs = (const float*)gates;
  if (bf16)
    lstm_bwd_kernel<__nv_bfloat16><<<grid_of(n, H), THREADS, 0, st>>>(
        (const __nv_bfloat16*)dh, (const __nv_bfloat16*)dc, gs,
        (const __nv_bfloat16*)c_prev, (const __nv_bfloat16*)c,
        (__nv_bfloat16*)dgates, (__nv_bfloat16*)dc_prev, n, H);
  else
    lstm_bwd_kernel<float><<<grid_of(n, H), THREADS, 0, st>>>(
        (const float*)dh, (const float*)dc, gs, (const float*)c_prev,
        (const float*)c, (float*)dgates, (float*)dc_prev, n, H);
  return (int)cudaGetLastError();
}

extern "C" int mxt_gru_fwd(const void* pre, const void* hh, const void* b_rn,
                           const void* h_prev, void* h, void* saved, int n,
                           int H, int bf16, void* stream) {
  if (bad(n, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* sv = (float*)saved;
  if (bf16)
    gru_fwd_kernel<__nv_bfloat16><<<grid_of(n, H), THREADS, 0, st>>>(
        (const __nv_bfloat16*)pre, (const __nv_bfloat16*)hh,
        (const __nv_bfloat16*)b_rn, (const __nv_bfloat16*)h_prev,
        (__nv_bfloat16*)h, sv, n, H);
  else
    gru_fwd_kernel<float><<<grid_of(n, H), THREADS, 0, st>>>(
        (const float*)pre, (const float*)hh, (const float*)b_rn,
        (const float*)h_prev, (float*)h, sv, n, H);
  return (int)cudaGetLastError();
}

extern "C" int mxt_gru_bwd(const void* dh, const void* saved,
                           const void* h_prev, void* dpre, void* dhh,
                           void* dh_prev, int n, int H, int bf16,
                           void* stream) {
  if (bad(n, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* sv = (const float*)saved;
  if (bf16)
    gru_bwd_kernel<__nv_bfloat16><<<grid_of(n, H), THREADS, 0, st>>>(
        (const __nv_bfloat16*)dh, sv, (const __nv_bfloat16*)h_prev,
        (__nv_bfloat16*)dpre, (__nv_bfloat16*)dhh, (__nv_bfloat16*)dh_prev, n,
        H);
  else
    gru_bwd_kernel<float><<<grid_of(n, H), THREADS, 0, st>>>(
        (const float*)dh, sv, (const float*)h_prev, (float*)dpre,
        (float*)dhh, (float*)dh_prev, n, H);
  return (int)cudaGetLastError();
}
