// Head-major multi-head attention, forward (K5) and backward (K6), sm_90a.
//
// Replaces the TPU kernels of avsiam_tpu/ops/attention.py:
//   K5 _pallas_fwd (_fwd_kernel, _attn_fwd_math): o = (e . v) / sum(e) per
//      head, e = exp(s * D^-1/2 + key bias - max), s = q k^T;
//   K6 _pallas_bwd (_bwd_kernel, _attn_bwd_math): dq, dk, dv.
// They serve head widths the token-major K1/K2 do not take (ViT-H's D = 80),
// every D up to 128.
//
// Layout: q, k and v are [B, N, H, D] tensors that share strides (batch sB,
// token sN, head D, channel 1), such as the three (3, H, D) slices of the
// packed [B, N, 3C] qkv projection, read in place; out, do, dq, dk and dv are
// contiguous [B, N, H, D]. The TPU kernels' [B, H, Np, D] transposes and
// their 128-row pad are TPU tiling: keys past N are masked in the kernel.
// key_valid [B, N] (or null) gives masked keys a -1e30 bias, as
// _bias_from_valid does.
//
// K5: one block per (64-query tile, head, sample) walks the key tiles with an
// online softmax in f32 (the TPU kernel takes the whole row at once; the sum
// is the same), normalising after the PV product. It is K1's forward body
// (attention_fwd.cuh: scores, p and the output in registers, a cp.async
// ring for the key tiles), and like K1 it saves each row's max and
// 1/denominator to stats [B, H, N, 2] for the backward.
//
// K6 (redesigned) reads those statistics and the output: the two kernels of
// attention_bwd.cuh, a dq kernel (which also writes delta = rowsum(do * o))
// and a dk/dv kernel, seven N^2 D products in all, no atomics. What differs
// from the JAX VJP: JAX keeps only q, k, v and the bias, and its backward
// recomputes the softmax; the port also keeps the forward's output (the
// tensor the output projection reads, so no extra memory) and its [B, H, N,
// 2] statistics. The gradients are the same function.
//
// What bounds them on the H100: at ViT-H's lengths (N <= 512) and D = 80 the
// N^2 D products are small (a few GFLOP a call) and the bytes a few MB, so
// the bound is microseconds and latency rules: the exp, the tiles' trips
// through shared memory, blocks waiting on loads, and grids of 64-384
// blocks on 132 SMs. The forward body keeps scores, p and the output in
// registers and rings its loads (attention_fwd.cuh). K6 keeps scores, p, dp
// and ds in registers (mma.sync m16n8k16, the accumulator fragments feeding
// the next product's A operand), double buffers its tiles with cp.async,
// and does seven products from the forward's output and statistics (the
// backward that recomputes the statistics takes nine). Products take bf16
// operands (an f32 call too) with f32 accumulation, as the TPU kernels do;
// p and ds are rounded to bf16 before their products (the TPU kernel
// rounds e and r * do, e * (dp - c) and r * q instead: the same sums up to
// where the rounding falls).

#include <initializer_list>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

namespace {

// The kernels take the head width dh at run time; the template width D, the
// tiles', is dh rounded up to a multiple of 16 (attention_common.cuh).
template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
attn_hm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                   T* __restrict__ out, float* __restrict__ stats, int N, int H, int dh,
                   long long sB, int sN, float scale) {
  const int b = blockIdx.z;
  const size_t boff = (size_t)b * sB;
  attn_fwd_body<T, D, VEC>(q + boff, k + boff, v + boff, sN, key_valid,
                           out + (size_t)b * N * H * dh, H * dh, stats, b, blockIdx.y,
                           blockIdx.x * BQ, N, H, dh, scale);
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
attn_hm_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                      const T* __restrict__ out, const T* __restrict__ dout,
                      const float* __restrict__ stats, float* __restrict__ delta,
                      T* __restrict__ dq, int N, int H, int dh, long long sB, int sN,
                      float scale) {
  const int b = blockIdx.z, C = H * dh;
  const size_t boff = (size_t)b * sB, goff = (size_t)b * N * C;
  attn_bwd_dq_body<T, D, VEC>(q + boff, k + boff, v + boff, sN, out + goff, dout + goff, C,
                              stats, delta, key_valid, dq + goff, C, b, blockIdx.y,
                              blockIdx.x * BQ, N, H, dh, scale);
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
attn_hm_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                        const T* __restrict__ dout, const float* __restrict__ stats,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int N, int H, int dh, long long sB, int sN,
                        float scale) {
  constexpr int SPLIT = D / dkdv_width<D>();
  const int b = blockIdx.z, C = H * dh;
  const int k0 = blockIdx.x / SPLIT * BK, c0 = blockIdx.x % SPLIT * dkdv_width<D>();
  const size_t boff = (size_t)b * sB, goff = (size_t)b * N * C;
  attn_bwd_dkdv_body<T, D, VEC>(q + boff, k + boff, v + boff, sN, dout + goff, C, stats, delta,
                                key_valid, dk + goff, dv + goff, C, b, blockIdx.y, k0, c0, N, H,
                                dh, scale);
}

template <typename T, int D, bool VEC>
int launch_fwd(const void* q, const void* k, const void* v, const void* key_valid,
               void* out, void* stats, int B, int N, int H, int dh, long long sB, int sN,
               float scale, cudaStream_t stream) {
  const int smem = FwdRing<D>::BYTES;
  cudaError_t err = allow_smem(attn_hm_fwd_kernel<T, D, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  attn_hm_fwd_kernel<T, D, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(out),
      static_cast<float*>(stats), N, H, dh, sB, sN, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool VEC>
int launch_bwd(const void* q, const void* k, const void* v, const void* key_valid,
               const void* out, const void* dout, const void* stats, void* delta, void* dq,
               void* dk, void* dv, int B, int N, int H, int dh, long long sB, int sN,
               float scale, cudaStream_t stream) {
  const int smem_q = DqSmem<D>::BYTES, smem_kv = DkvSmem<D>::BYTES;
  cudaError_t err = allow_smem(attn_hm_bwd_dq_kernel<T, D, VEC>, smem_q);
  if (err == cudaSuccess) err = allow_smem(attn_hm_bwd_dkdv_kernel<T, D, VEC>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((N + BQ - 1) / BQ, H, B);
  attn_hm_bwd_dq_kernel<T, D, VEC><<<grid_q, THREADS, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<const float*>(stats),
      static_cast<float*>(delta), static_cast<T*>(dq), N, H, dh, sB, sN, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int SPLIT = D / dkdv_width<D>();  // blocks per key tile
  dim3 grid_kv((N + BK - 1) / BK * SPLIT, H, B);
  attn_hm_bwd_dkdv_kernel<T, D, VEC><<<grid_kv, THREADS, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), N, H, dh, sB, sN, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// CALL(T, tile width, VEC) for the dtype and every head width D from 1 to
// 128, in the tiles of the widths the models use: 16, 32, 64, 80 (ViT-H)
// and 128, the least one that holds D. VEC where every row read and written
// takes 16-byte pieces.
#define HM_WIDTHS(CALL, T, VEC)                   \
  switch ((D + 15) / 16) {                        \
    case 1: return CALL(T, 16, VEC);              \
    case 2: return CALL(T, 32, VEC);              \
    case 3:                                       \
    case 4: return CALL(T, 64, VEC);              \
    case 5: return CALL(T, 80, VEC);              \
    case 6:                                       \
    case 7:                                       \
    case 8: return CALL(T, 128, VEC);             \
    default: return (int)cudaErrorInvalidValue;  \
  }
#define HM_DISPATCH(CALL, VEC16)                                                 \
  if (D <= 0 || D > 128) return (int)cudaErrorInvalidValue;                      \
  if (dtype == 1 && (VEC16)) HM_WIDTHS(CALL, bf16, true)                         \
  if (dtype == 1) HM_WIDTHS(CALL, bf16, false)                                   \
  if (dtype == 0) HM_WIDTHS(CALL, float, false)                                  \
  return (int)cudaErrorInvalidValue;

// whether every pointer is 16-byte aligned
static inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [B, N, H, D] with strides
// (sB, sN, D, 1), in elements, D <= 128; key_valid: [B, N] bytes or null;
// out: contiguous [B, N, H, D]; stats: [B, H, N, 2] f32 (row max, 1/denom).
extern "C" int avsiam_attn_hm_fwd(const void* q, const void* k, const void* v,
                                  const void* key_valid, void* out, void* stats, int B, int N,
                                  int H, int D, long long sB, long long sN, int dtype,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HM_FWD(T, DP, VEC) \
  launch_fwd<T, DP, VEC>(q, k, v, key_valid, out, stats, B, N, H, D, sB, (int)sN, scale, s)
  const bool vec = D % 8 == 0 && sN % 8 == 0 && sB % 8 == 0 && aligned16({q, k, v, out});
  HM_DISPATCH(HM_FWD, vec)
#undef HM_FWD
}

// out (K5's output), dout, dq, dk, dv: contiguous [B, N, H, D], every element
// of dq, dk and dv written; stats: K5's [B, H, N, 2]; delta: [B, H, N] f32
// scratch (rowsum(dout * out), written by the dq kernel).
extern "C" int avsiam_attn_hm_bwd(const void* q, const void* k, const void* v,
                                  const void* key_valid, const void* out, const void* dout,
                                  const void* stats, void* delta, void* dq, void* dk, void* dv,
                                  int B, int N, int H, int D, long long sB, long long sN,
                                  int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HM_BWD(T, DP, VEC)                                                                \
  launch_bwd<T, DP, VEC>(q, k, v, key_valid, out, dout, stats, delta, dq, dk, dv, B, N, H, D, \
                         sB, (int)sN, scale, s)
  const bool vec = D % 8 == 0 && sN % 8 == 0 && sB % 8 == 0 &&
                   aligned16({q, k, v, out, dout, dq, dk, dv});
  HM_DISPATCH(HM_BWD, vec)
#undef HM_BWD
}
