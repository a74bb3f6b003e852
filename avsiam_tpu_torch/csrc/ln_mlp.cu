// Fused LayerNorm -> fc1 -> GELU -> fc2 -> residual forward (K3), sm_90a.
//
// Replaces the TPU kernel avsiam_tpu/ops/mlp.py:_lnfwd_call (_lnfwd_kernel),
// the transformer block's whole MLP sub-block x + fc2(gelu(fc1(LN(x)))):
//   - LN statistics in f32 with flax's formula (mean-of-squares variance,
//     clamped at 0; multiplier rstd * scale), normalised rows kept in bf16;
//   - fc1 with bf16 operands and f32 accumulation, plus b1; the pre-GELU
//     hidden is also written out (the backward's saved residual);
//   - GELU in f32 in the A&S 'ans' form the Pallas kernel uses for 'erf';
//   - fc2 with bf16 operands and f32 accumulation; then x + T(y + b2), the
//     residual add in the activation type T.
//
// What bounds it on the H100: its FLOPs (4 T D H) at T of thousands of rows;
// its bytes are x and out ([T, D]) plus the hidden it must emit ([T, H]).
// The design keeps LN(x), the f32 hidden and the activation of a 32-row tile
// on chip: a block normalises its rows into shared memory, then walks its
// share of the hidden dimension in chunks of 64 columns (fc1 chunk -> bias,
// hidden out, GELU -> fc2 partial product), holding the [32, D] f32 output
// accumulator in registers (wmma fragments) across its chunks. Products run
// on the tensor cores through nvcuda::wmma; weight fragments are read from
// device memory (L2-resident across blocks).
//
// One block per SM fits (its registers), and a block's time grows with the
// chunks it walks, so the pass-1 calls (T of 156 to 1024 rows, 5 to 32 row
// tiles) would leave most SMs idle. The hidden dimension is therefore split
// into `splits` contiguous ranges, one block per (row tile, range); each
// block writes its f32 partial fc2 sum to a workspace [splits, rows, D], and
// a second kernel adds the partials in a fixed order (deterministic, no
// atomics), then b2 and the residual. An f32 call stores f32 but multiplies
// bf16 operands. wgmma, TMA-fed weight tiles and larger row tiles are later
// work.
//
// Weights use nn.Linear's layout: w1 [H, D] (fc1.weight), w2 [D, H]
// (fc2.weight); biases and LN parameters are f32.

#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 32;        // rows per block
constexpr int HC = 64;        // hidden columns per chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = HC + 4;   // f32 hidden tile row stride
constexpr int LDG = HC + 8;   // bf16 activation tile row stride

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

template <int D>
struct MlpSmem {
  static constexpr int LDN = D + 8;
  static constexpr int NS = 0;
  static constexpr int HS = align128(NS + BM * LDN * 2);
  static constexpr int GS = align128(HS + BM * LDH * 4);
  static constexpr int BYTES = GS + BM * LDG * 2;
};

// 0.5 x (1 + erf(x / sqrt 2)) with Abramowitz & Stegun 7.1.26 erf
__device__ __forceinline__ float gelu_ans(float x) {
  const float z = x * 0.70710678118654752f;
  const float a = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  const float e = 1.f - poly * expf(-a * a);
  const float erf = z > 0.f ? e : (z < 0.f ? -e : 0.f);
  return 0.5f * x * (1.f + erf);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  T* __restrict__ hpre, float* __restrict__ partial, int rows,
                  int H, int splits, float eps) {
  using SM = MlpSmem<D>;
  constexpr int LDN = SM::LDN;
  constexpr int YC = D / 128;  // output column fragments per warp (x 2 row tiles)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ns = reinterpret_cast<bf16*>(smem + SM::NS);
  float* Hs = reinterpret_cast<float*>(smem + SM::HS);
  bf16* Gs = reinterpret_cast<bf16*>(smem + SM::GS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * BM;
  const int chunks = H / HC;  // this block walks chunks [c_begin, c_end)
  const int c_begin = (int)((long long)blockIdx.y * chunks / splits);
  const int c_end = (int)((long long)(blockIdx.y + 1) * chunks / splits);

  // 1. LayerNorm of the row tile, f32 statistics -> bf16 rows in Ns
  for (int r = warp; r < BM; r += WARPS) {
    const int n = r0 + r;
    bf16* nrow = Ns + r * LDN;
    if (n >= rows) {
      for (int c = lane; c < D; c += 32) nrow[c] = __float2bfloat16(0.f);
      continue;
    }
    const T* xr = x + (size_t)n * D;
    float s = 0.f, ss = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = to_f32(xr[c]);
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / D;
    const float var = fmaxf(0.f, ss / D - mu * mu);
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < D; c += 32)
      nrow[c] = __float2bfloat16((to_f32(xr[c]) - mu) * (rstd * ln_g[c]) + ln_b[c]);
  }

  FragC y[2][YC];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < YC; ++j) wmma::fill_fragment(y[rt][j], 0.f);
  __syncthreads();

  const int frt = warp >> 2, fct = warp & 3;  // this warp's fc1 fragment
  for (int h0 = c_begin * HC; h0 < c_end * HC; h0 += HC) {
    // 2. h = LN(x) . w1[h0:h0+HC]^T, one 16x16 fragment per warp
    {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      const bf16* wcol = w1 + (size_t)(h0 + fct * 16) * D;
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        FragA fa;
        FragBc fb;
        wmma::load_matrix_sync(fa, Ns + frt * 16 * LDN + kk, LDN);
        wmma::load_matrix_sync(fb, wcol + kk, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Hs + frt * 16 * LDH + fct * 16, acc, LDH, wmma::mem_row_major);
    }
    __syncthreads();
    // 3. + b1; the pre-GELU hidden goes out; f32 GELU -> bf16 tile Gs
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC, n = r0 + r;
      const float hv = Hs[r * LDH + c] + b1[h0 + c];
      if (n < rows) hpre[(size_t)n * H + h0 + c] = from_f32<T>(hv);
      Gs[r * LDG + c] = __float2bfloat16(gelu_ans(hv));
    }
    __syncthreads();
    // 4. y += g . w2[:, h0:h0+HC]^T on this warp's output columns
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      FragA fa0, fa1;
      wmma::load_matrix_sync(fa0, Gs + kk, LDG);
      wmma::load_matrix_sync(fa1, Gs + 16 * LDG + kk, LDG);
#pragma unroll
      for (int j = 0; j < YC; ++j) {
        FragBc fb;
        wmma::load_matrix_sync(fb, w2 + (size_t)((warp * YC + j) * 16) * H + h0 + kk, H);
        wmma::mma_sync(y[0][j], fa0, fb, y[0][j]);
        wmma::mma_sync(y[1][j], fa1, fb, y[1][j]);
      }
    }
  }

  // 5. this block's partial sum goes to partial[blockIdx.y] (rows padded to
  // the row tiles, so whole fragments are stored)
  const int rows_pad = gridDim.x * BM;
  float* part = partial + ((size_t)blockIdx.y * rows_pad + r0) * D;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < YC; ++j)
      wmma::store_matrix_sync(part + (size_t)rt * 16 * D + (warp * YC + j) * 16, y[rt][j], D,
                              wmma::mem_row_major);
}

// out = x + T(sum_s partial[s] + b2): the partials in order s = 0, 1, ...,
// then the residual add in T
template <typename T>
__global__ void ln_mlp_epilogue_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                                       const float* __restrict__ b2, T* __restrict__ out,
                                       int rows, int rows_pad, int D, int splits) {
  const size_t n = (size_t)rows * D, stride = (size_t)rows_pad * D;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[s * stride + i];
    const float m = to_f32(from_f32<T>(acc + b2[i % D]));
    out[i] = from_f32<T>(to_f32(x[i]) + m);
  }
}

template <typename T, int D>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, void* hpre,
           void* partial, int rows, int H, int splits, float eps, cudaStream_t stream) {
  const int smem = MlpSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (rows + BM - 1) / BM;
  ln_mlp_fwd_kernel<T, D><<<dim3(tiles, splits), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<T*>(hpre),
      static_cast<float*>(partial), rows, H, splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)rows * D;
  const int blocks = (int)((n + 1023) / 1024 < 4096 ? (n + 1023) / 1024 : 4096);
  ln_mlp_epilogue_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(partial),
      static_cast<const float*>(b2), static_cast<T*>(out), rows, tiles * BM, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, out, hpre). D in {512, 768},
// H a multiple of 64, 1 <= splits <= H / 64. out [rows, D], hpre [rows, H];
// partial: f32 scratch [splits, ceil(rows / 32) * 32, D].
extern "C" int avsiam_ln_mlp_fwd(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* out, void* hpre, void* partial,
                                 int rows, int D, int H, int splits, int dtype, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % HC != 0 || rows <= 0 || splits < 1 || splits > H / HC)
    return (int)cudaErrorInvalidValue;
#define AVSIAM_LN_MLP(TYPE, DIM) \
  return launch<TYPE, DIM>(x, ln_g, ln_b, w1, b1, w2, b2, out, hpre, partial, rows, H, \
                           splits, eps, s)
  if (dtype == 1 && D == 768) AVSIAM_LN_MLP(bf16, 768);
  if (dtype == 1 && D == 512) AVSIAM_LN_MLP(bf16, 512);
  if (dtype == 0 && D == 768) AVSIAM_LN_MLP(float, 768);
  if (dtype == 0 && D == 512) AVSIAM_LN_MLP(float, 512);
#undef AVSIAM_LN_MLP
  return (int)cudaErrorInvalidValue;
}
