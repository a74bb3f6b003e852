// Token-major multi-head attention, forward (K1) and backward (K2), sm_90a.
//
// Replaces the TPU kernels of avsiam_tpu/ops/attention.py:
//   K1 _pallas_fwd_tm (_fwd_kernel_tm): softmax(q k^T D^-1/2 + key bias) v per
//      head, read from the raw [B, N, 3C] qkv projection (channel order
//      (3, H, D)), written token-major to [B, N, C];
//   K2 _pallas_bwd_tm (_bwd_kernel_tm, _bwd_tm_one): its backward, written as
//      the [B, N, 3C] cotangent.
// q, k and v are read in place from [B, N, 3C] through strides (no
// transposes); ragged N is masked in the kernels (keys past N get -inf).
// They take every head width D that divides 128, as the JAX token-major
// kernel does (D < 16 in 16-wide tiles whose other channels are zeros).
//
// What bounds them on the H100: at AVSiam's lengths (N <= 708) and head
// widths (D = 64 encoder, 32 decoder) the N^2 D products of a call are a few
// GFLOP and its bytes (q, k, v, o read or written once) a few MB, so the
// bound is microseconds. What limits a kernel is latency: the exp of every
// score, the tiles' trips through shared memory, blocks waiting on their
// loads, and grids of 48-192 blocks at most encoder shapes, on 132 SMs that
// could each hold four.
//
// K1's forward body (attention_fwd.cuh, shared with K5) keeps scores,
// probabilities and the output accumulator in registers: mma.sync m16n8k16
// with the warp's q fragments held for the whole key walk, the online
// softmax in base 2 on the score fragments, p fed from them as the A operand
// of the PV product, and K, V and the key bias through a two-stage cp.async
// ring with one barrier per key tile. No N^2 tile reaches device memory or
// shared memory. It saves, per (sample, head, row), the max m of s * scale +
// bias in natural units and 1/denom (the TPU kernel's statistics) for the
// backward. A logsumexp would be one float, but a row whose keys are all
// masked has m = -1e30 and its logsumexp -1e30 + log N rounds back to -1e30,
// losing the 1/N.
//
// K2 runs K6's backward bodies (attention_bwd.cuh) on the packed layout:
// q, k and v are the three C-wide column blocks of each qkv row (ld = 3 C),
// out and do rows C apart, and dq, dk and dv the three column blocks of each
// dqkv row. Two kernels, one owner per output element, no atomics: a dq
// kernel per 64-query tile (which also writes delta = rowsum(do * o), the TPU
// kernel's c), then a dk/dv kernel per 64-key tile. Scores, p, dp and ds stay
// in registers (mma.sync m16n8k16), and the next key or query tile comes
// through a two-stage cp.async ring. p is exp2(fmaf(s, scale log2e, bias
// log2e) - m log2e) r, the forward's expression (attention_fwd.cuh), so the
// saved m in natural units (exactly -1e30 for an all-masked sample) gives
// an exponent of exactly 0 there.

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

namespace {

// The kernels take the head width dh at run time; the template width D, the
// tiles', is dh rounded up to a multiple of 16 (attention_common.cuh).
template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ key_valid,
                T* __restrict__ out, float* __restrict__ stats, int N, int H, int dh,
                float scale) {
  const int b = blockIdx.z, C = H * dh, ld = 3 * C;
  const T* base = qkv + (size_t)b * N * ld;
  attn_fwd_body<T, D, VEC>(base, base + C, base + 2 * C, ld, key_valid,
                           out + (size_t)b * N * C, C, stats, b, blockIdx.y, blockIdx.x * BQ, N,
                           H, dh, scale);
}

// dq (and delta) of one 64-query tile, and dk, dv of one 64-key tile: K6's
// bodies on the [B, N, 3C] qkv and dqkv of sample blockIdx.z.
template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ key_valid,
                   const T* __restrict__ out, const T* __restrict__ dout,
                   const float* __restrict__ stats, float* __restrict__ delta,
                   T* __restrict__ dqkv, int N, int H, int dh, float scale) {
  const int b = blockIdx.z, C = H * dh, ld = 3 * C;
  const size_t boff = (size_t)b * N * ld, ooff = (size_t)b * N * C;
  const T* base = qkv + boff;
  attn_bwd_dq_body<T, D, VEC>(base, base + C, base + 2 * C, ld, out + ooff, dout + ooff, C,
                              stats, delta, key_valid, dqkv + boff, ld, b, blockIdx.y,
                              blockIdx.x * BQ, N, H, dh, scale);
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ key_valid,
                     const T* __restrict__ dout, const float* __restrict__ stats,
                     const float* __restrict__ delta, T* __restrict__ dqkv, int N,
                     int H, int dh, float scale) {
  constexpr int SPLIT = D / dkdv_width<D>();
  const int b = blockIdx.z, C = H * dh, ld = 3 * C;
  const int k0 = blockIdx.x / SPLIT * BK, c0 = blockIdx.x % SPLIT * dkdv_width<D>();
  const size_t boff = (size_t)b * N * ld;
  const T* base = qkv + boff;
  T* g = dqkv + boff;
  attn_bwd_dkdv_body<T, D, VEC>(base, base + C, base + 2 * C, ld, dout + (size_t)b * N * C, C,
                                stats, delta, key_valid, g + C, g + 2 * C, ld, b, blockIdx.y, k0,
                                c0, N, H, dh, scale);
}

template <typename T, int D, bool VEC>
int launch_fwd(const void* qkv, const void* key_valid, void* out, void* stats, int B,
               int N, int H, int dh, float scale, cudaStream_t stream) {
  const int smem = FwdRing<D>::BYTES;
  cudaError_t err = allow_smem(attn_fwd_kernel<T, D, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<T, D, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(key_valid),
      static_cast<T*>(out), static_cast<float*>(stats), N, H, dh, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool VEC>
int launch_bwd(const void* qkv, const void* key_valid, const void* out,
               const void* dout, const void* stats, void* delta, void* dqkv, int B,
               int N, int H, int dh, float scale, cudaStream_t stream) {
  const int smem_q = DqSmem<D>::BYTES, smem_kv = DkvSmem<D>::BYTES;
  cudaError_t err = allow_smem(attn_bwd_dq_kernel<T, D, VEC>, smem_q);
  if (err == cudaSuccess) err = allow_smem(attn_bwd_dkdv_kernel<T, D, VEC>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((N + BQ - 1) / BQ, H, B);
  attn_bwd_dq_kernel<T, D, VEC><<<grid_q, THREADS, smem_q, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(key_valid),
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(delta),
      static_cast<T*>(dqkv), N, H, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int SPLIT = D / dkdv_width<D>();  // blocks per key tile
  dim3 grid_kv((N + BK - 1) / BK * SPLIT, H, B);
  attn_bwd_dkdv_kernel<T, D, VEC><<<grid_kv, THREADS, smem_kv, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(key_valid),
      static_cast<const T*>(dout), static_cast<const float*>(stats),
      static_cast<const float*>(delta), static_cast<T*>(dqkv), N, H, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// CALL(T, tile width, VEC) for the dtype and head width D: every D that
// divides 128 (the JAX token-major kernel's widths), in tiles of 16, 32, 64
// or 128. bf16 rows of D >= 8 channels take 16-byte pieces (C, 3C and h D
// are multiples of 8, and the wrappers pass 16-byte aligned tensors).
#define TM_DISPATCH(CALL)                                          \
  if (D <= 0 || 128 % D != 0) return (int)cudaErrorInvalidValue;   \
  if (dtype == 1) {                                                \
    if (D < 8) return CALL(bf16, 16, false);                       \
    if (D <= 16) return CALL(bf16, 16, true);                      \
    if (D == 32) return CALL(bf16, 32, true);                      \
    if (D == 64) return CALL(bf16, 64, true);                      \
    return CALL(bf16, 128, true);                                  \
  }                                                                \
  if (dtype == 0) {                                                \
    if (D <= 16) return CALL(float, 16, false);                    \
    if (D == 32) return CALL(float, 32, false);                    \
    if (D == 64) return CALL(float, 64, false);                    \
    return CALL(float, 128, false);                                \
  }                                                                \
  return (int)cudaErrorInvalidValue;

// dtype: 0 = float32, 1 = bfloat16. key_valid: [B, N] bytes or null.
// stats: [B, H, N, 2] float32 (row max, 1/denom), written by the forward.
// D, the head width, divides 128.
extern "C" int avsiam_attn_fwd(const void* qkv, const void* key_valid, void* out,
                               void* stats, int B, int N, int H, int D, int dtype,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TM_FWD(T, DP, VEC) \
  launch_fwd<T, DP, VEC>(qkv, key_valid, out, stats, B, N, H, D, scale, s)
  TM_DISPATCH(TM_FWD)
#undef TM_FWD
}

// delta: [B, H, N] float32 scratch. dqkv: [B, N, 3C], every element written.
extern "C" int avsiam_attn_bwd(const void* qkv, const void* key_valid, const void* out,
                               const void* dout, const void* stats, void* delta,
                               void* dqkv, int B, int N, int H, int D, int dtype,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TM_BWD(T, DP, VEC) \
  launch_bwd<T, DP, VEC>(qkv, key_valid, out, dout, stats, delta, dqkv, B, N, H, D, scale, s)
  TM_DISPATCH(TM_BWD)
#undef TM_BWD
}
