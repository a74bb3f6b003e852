// What the MLP forward's passes (K3 ln_mlp.cu, K4 mlp.cu) and the
// backward's gh pass share, sm_90a: GELU in f32 in the A&S 'ans' form the
// Pallas kernels use for 'erf', pair loads of a [rows, D] row tensor, and
// the epilogue that adds a split product's f32 partial sums in a fixed
// order (deterministic, no atomics), then b2 and, for K3, the residual.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

// erf(z) by Abramowitz & Stegun 7.1.26, and the exp(-z^2) it takes
__device__ __forceinline__ float erf_ans(float z, float& eexp) {
  const float a = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  eexp = expf(-a * a);
  const float e = 1.f - poly * eexp;
  return z > 0.f ? e : (z < 0.f ? -e : 0.f);
}

// 0.5 x (1 + erf(x / sqrt 2)) with the A&S erf
__device__ __forceinline__ float gelu_ans(float x) {
  float eexp;
  return 0.5f * x * (1.f + erf_ans(x * 0.70710678118654752f, eexp));
}

// gelu(x) and gelu'(x) in the 'ans' form with one exp: the A&S erf's
// exp(-z^2), z = x / sqrt 2, is the Gaussian pdf's exp(-x^2 / 2)
// (avsiam_tpu/ops/gelu.py:gelu_act_grad_f32)
__device__ __forceinline__ void gelu_ans_act_grad(float x, float& act, float& grad) {
  float eexp;
  const float cdf = 0.5f * (1.f + erf_ans(x * 0.70710678118654752f, eexp));
  act = x * cdf;
  grad = cdf + x * eexp * 0.39894228040143268f;
}

// two neighbouring values of a row tensor as f32 (8 bytes of f32, 4 of bf16)
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// out = [x +] T(sum_s partial[s] [+ b2]) over [rows, D]: the partials ([splits,
// rows, D]) in order s = 0, 1, ..., then the residual add (K3) in T
template <typename T, bool BIAS, bool RESID>
__global__ void mlp_epilogue_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                                    const float* __restrict__ b2, T* __restrict__ out, int rows,
                                    int D, int splits) {
  const size_t n = (size_t)rows * D;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[s * n + i];
    if (BIAS) acc += b2[i % D];
    if (RESID) {
      const float m = to_f32(from_f32<T>(acc));
      out[i] = from_f32<T>(to_f32(x[i]) + m);
    } else {
      out[i] = from_f32<T>(acc);
    }
  }
}

template <typename T, bool BIAS, bool RESID>
cudaError_t launch_epilogue(const void* x, const void* partial, const void* b2, void* out,
                            int rows, int D, int splits, cudaStream_t stream) {
  const long long n = (long long)rows * D;
  const int blocks = (int)((n + 1023) / 1024 < 4096 ? (n + 1023) / 1024 : 4096);
  mlp_epilogue_kernel<T, BIAS, RESID><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(partial),
      static_cast<const float*>(b2), static_cast<T*>(out), rows, D, splits);
  return cudaGetLastError();
}

}  // namespace
