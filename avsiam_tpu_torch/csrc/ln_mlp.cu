// Fused LayerNorm -> fc1 -> GELU -> fc2 -> residual forward (K3), sm_90a:
// the LayerNorm rows kernel here, then K4's fc1 and fc2 passes (mlp.cu).
//
// Replaces the TPU kernel avsiam_tpu/ops/mlp.py:_lnfwd_call (_lnfwd_kernel),
// the transformer block's whole MLP sub-block x + fc2(gelu(fc1(LN(x)))):
//   - LN statistics in f32 with flax's formula (mean-of-squares variance,
//     clamped at 0; multiplier rstd * scale), normalised rows in bf16;
//   - fc1 with bf16 operands and f32 accumulation, plus b1; the pre-GELU
//     hidden is also written out (the backward's saved residual);
//   - GELU in f32 in the A&S 'ans' form the Pallas kernel uses for 'erf';
//   - fc2 with bf16 operands and f32 accumulation; then x + T(y + b2), the
//     residual add in the activation type T.
//
// What bounds it on the H100: its FLOPs (4 T D H) at T of hundreds to
// thousands of rows; its bytes are x and out ([T, D]), the weights and the
// hidden it must emit ([T, H]). The TPU kernel keeps a row block's LN(x),
// hidden and activation in VMEM; here the products are K4's two passes on
// TMA and wgmma (mlp.cu: the fc1 pass, 128-row tiles over 64-wide D slabs;
// the fc2 pass, 128 x 128 tiles of out over H's slabs, with b2 and the
// residual in its epilogue), whose A operand comes from device memory by
// TMA. So LN(x) goes there first: ln_mlp_rows_kernel, a warp a row, writes
// n = LN(x) in bf16 [T, D] (2.2 MB at T 1416, D 768; the fc1 pass reads it
// D / 64 slabs at a time, from L2). Its own bound is those bytes, x read
// and n written.
//
// LN parameters are f32.

#include "common.cuh"

namespace {

constexpr int LN_ROWS_WARPS = 8;  // rows per block, a warp each

// 16 bytes of T as f32 values (8 of bf16, 4 of f32)
__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  union {
    uint4 u;
    __nv_bfloat162 h[4];
  } q;
  q.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(q.h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// n [rows, D] bf16 = LN(x) with f32 statistics; D a multiple of 128, rows
// of x 16-byte aligned. Each lane takes 16-byte runs of its row, so a warp
// reads 512 contiguous bytes at a time; x is read twice (the second time
// from L1/L2).
template <typename T>
__global__ void __launch_bounds__(LN_ROWS_WARPS * 32)
ln_mlp_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, bf16* __restrict__ n, int rows, int D,
                   float eps) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte run
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane * V; c < D; c += 32 * V) {
    float v[V];
    load16(xr + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / D;
  const float var = fmaxf(0.f, ss / D - mu * mu);
  const float rstd = rsqrtf(var + eps);
  bf16* nr = n + (size_t)row * D;
  for (int c = lane * V; c < D; c += 32 * V) {
    float v[V];
    load16(xr + c, v);
    unsigned packed[V / 2];
#pragma unroll
    for (int i = 0; i < V; i += 2) {
      const float n0 = (v[i] - mu) * (rstd * ln_g[c + i]) + ln_b[c + i];
      const float n1 = (v[i + 1] - mu) * (rstd * ln_g[c + i + 1]) + ln_b[c + i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(n0, n1);
      packed[i / 2] = *reinterpret_cast<const unsigned*>(&h);
    }
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(nr + c) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    else
      *reinterpret_cast<uint2*>(nr + c) = make_uint2(packed[0], packed[1]);
  }
}

template <typename T>
int launch_rows(const void* x, const void* ln_g, const void* ln_b, void* n, int rows, int D,
                float eps, cudaStream_t stream) {
  const int blocks = (rows + LN_ROWS_WARPS - 1) / LN_ROWS_WARPS;
  ln_mlp_rows_kernel<T><<<blocks, LN_ROWS_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<bf16*>(n), rows, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// K3's LayerNorm: n [rows, D] bf16 = LN(x [rows, D]) with f32 ln_g, ln_b
// [D]. dtype: 0 = float32, 1 = bfloat16 (x). D a multiple of 128.
extern "C" int avsiam_ln_mlp_rows(const void* x, const void* ln_g, const void* ln_b, void* n,
                                  int rows, int D, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || D % 128 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_rows<bf16>(x, ln_g, ln_b, n, rows, D, eps, s);
  if (dtype == 0) return launch_rows<float>(x, ln_g, ln_b, n, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
