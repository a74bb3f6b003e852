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
// The chunk loop, the partial store and the epilogue are shared with K4
// (mlp_tile.cuh). D is a run-time width (any multiple of 128); past D =
// 768 fc2's output columns are cut into column groups across the grid's z,
// so the f32 accumulator stays at most [32, 768] a block (mlp_tile.cuh). One block per SM fits (its registers), and a block's time
// grows with the chunks it walks, so the pass-1 calls (T of 156 to 1024
// rows, 5 to 32 row tiles) would leave most SMs idle. The hidden dimension
// is therefore split
// into `splits` contiguous ranges, one block per (row tile, range); each
// block writes its f32 partial fc2 sum to a workspace [splits, rows, D], and
// a second kernel adds the partials in a fixed order (deterministic, no
// atomics), then b2 and the residual. An f32 call stores f32 but multiplies
// bf16 operands. wgmma, TMA-fed weight tiles and larger row tiles are later
// work.
//
// Weights use nn.Linear's layout: w1 [H, D] (fc1.weight), w2 [D, H]
// (fc2.weight); biases and LN parameters are f32.

#include "mlp_tile.cuh"

namespace {

template <typename T, int YC>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  T* __restrict__ hpre, float* __restrict__ partial, int rows,
                  int D, int H, int splits, float eps) {
  const MlpSmem sm(D);
  const int LDN = sm.ldn;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ns = reinterpret_cast<bf16*>(smem + sm.ns);
  float* Hs = reinterpret_cast<float*>(smem + sm.hs);
  bf16* Gs = reinterpret_cast<bf16*>(smem + sm.gs);

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
  zero_rows_acc<YC>(y);
  __syncthreads();
  // 2.-4. fc1 -> + b1, hidden out (column group 0) -> GELU -> fc2 on this
  // block's columns over its chunks
  const int c0 = blockIdx.z * 128 * YC;
  fwd_chunks<T, YC>(Ns, Hs, Gs, w1, b1, w2, blockIdx.z == 0 ? hpre : nullptr, r0, rows, D, H,
                    c0, c_begin, c_end, y);
  // 5. the partial sum over those chunks
  store_partial<YC>(partial, y, r0, c0, D);
}

template <typename T, int YC>
int launch(const void* x, const void* ln_g, const void* ln_b, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, void* hpre,
           void* partial, int rows, int D, int H, int splits, float eps, cudaStream_t stream) {
  const int smem = MlpSmem(D).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_fwd_kernel<T, YC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (rows + BM - 1) / BM;
  ln_mlp_fwd_kernel<T, YC><<<dim3(tiles, splits, D / (128 * YC)), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<T*>(hpre),
      static_cast<float*>(partial), rows, D, H, splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_epilogue<T, true, true>(x, partial, b2, out, rows, tiles * BM, D, splits,
                                             stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, out, hpre). D a multiple of 128 cut
// into `groups` fc2 column groups of 128 YC columns, 1 <= YC <= 6; H a
// multiple of 64, 1 <= splits <= H / 64. out [rows, D], hpre [rows, H];
// partial: f32 scratch [splits, ceil(rows / 32) * 32, D].
extern "C" int avsiam_ln_mlp_fwd(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* out, void* hpre, void* partial,
                                 int rows, int D, int H, int splits, int groups, int dtype,
                                 float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % HC != 0 || rows <= 0 || splits < 1 || splits > H / HC || !mlp_groups_ok(D, groups))
    return (int)cudaErrorInvalidValue;
  const int yc = D / 128 / groups;
#define AVSIAM_LN_MLP(TYPE, YC) \
  if (yc == YC)                 \
  return launch<TYPE, YC>(x, ln_g, ln_b, w1, b1, w2, b2, out, hpre, partial, rows, D, H, splits, eps, s)
#define AVSIAM_LN_MLP_ALL(TYPE)                                                          \
  AVSIAM_LN_MLP(TYPE, 1); AVSIAM_LN_MLP(TYPE, 2); AVSIAM_LN_MLP(TYPE, 3); \
  AVSIAM_LN_MLP(TYPE, 4); AVSIAM_LN_MLP(TYPE, 5); AVSIAM_LN_MLP(TYPE, 6)
  if (dtype == 1) { AVSIAM_LN_MLP_ALL(bf16); }
  if (dtype == 0) { AVSIAM_LN_MLP_ALL(float); }
#undef AVSIAM_LN_MLP_ALL
#undef AVSIAM_LN_MLP
  return (int)cudaErrorInvalidValue;
}
