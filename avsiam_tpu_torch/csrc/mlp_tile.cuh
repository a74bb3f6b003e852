// What the MLP forward's passes (K3 ln_mlp.cu, K4 mlp.cu) and the
// backward's gh pass share, sm_90a: GELU and GELU' in f32 in each form the
// Pallas kernels take ('erf' as 'ans'), pair loads of a [rows, D] row
// tensor, and the epilogue that adds a split product's f32 partial sums in a fixed
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

// The GELU forms of the fused MLP, in f32, as avsiam_tpu/ops/gelu.py
// computes them (the codes are avsiam_tpu_torch/ops/gelu.py KERNEL_CODES;
// an 'erf' request runs as 'ans', as the Pallas kernels run it):
//   ANS    0.5 x (1 + erf(x / sqrt 2)), erf by A&S 7.1.26;
//   TANH   0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)));
//   CHEB   x Phi(x), Phi = 0.5 + u r(u^2) on u = x clipped to +-5.5241, r a
//          Chebyshev series in u^2 by Clenshaw's recurrence;
//   TANH5  0.5 x (1 + tanh(z q(z^2))), z = x / sqrt 2 clipped to +-4, q a
//          5-term polynomial.
// The build keeps tanhf and expf accurate (no --use_fast_math).
enum GeluForm : int { GELU_ANS = 0, GELU_TANH = 1, GELU_CHEB = 2, GELU_TANH5 = 3 };

constexpr float INV_SQRT_2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;
constexpr float TANH_C = 0.79788456080286536f;  // sqrt(2 / pi)

// the Chebyshev CDF's clip and coefficients (avsiam_tpu/ops/gelu.py:81-101)
constexpr float PHI_XB = 5.5241f;
__constant__ float PHI_COEF[16] = {
    1.7453262166e-01f,  -1.2245549191e-01f, 5.6471478729e-02f,  -2.6176051971e-02f,
    1.1596678412e-02f,  -4.8265382104e-03f, 1.8749111940e-03f,  -6.7851131750e-04f,
    2.2884733538e-04f,  -7.2054287449e-05f, 2.1223857706e-05f,  -5.8650471743e-06f,
    1.5224583179e-06f,  -3.7438715481e-07f, 8.4960083070e-08f,  -2.0862519096e-08f};

// the tanh composite's clip and q (avsiam_tpu/ops/gelu.py:151-160)
constexpr float T5_ZC = 4.f;
constexpr float T5_C0 = 1.1283580408023280f, T5_C1 = 1.0293362111282685e-01f,
                T5_C2 = -4.9766147444393120e-04f, T5_C3 = -4.1481581200152707e-04f,
                T5_C4 = 3.2207836663742104e-05f;

__device__ __forceinline__ float phi_cheb(float x) {
  const float u = fminf(fmaxf(x, -PHI_XB), PHI_XB);
  const float t = u * u * (2.f / (PHI_XB * PHI_XB)) - 1.f, t2 = 2.f * t;
  float b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int k = 15; k >= 1; --k) {
    const float b0 = t2 * b1 - b2 + PHI_COEF[k];
    b2 = b1;
    b1 = b0;
  }
  return 0.5f + u * (t * b1 - b2 + PHI_COEF[0]);
}

// gelu(x) and gelu'(x) of form G in f32. ANS takes one exp for both (the
// A&S erf's exp(-z^2), z = x / sqrt 2, is the Gaussian pdf's exp(-x^2 /
// 2)); TANH and TANH5 differentiate the approximation itself, TANH5 on the
// clipped z (avsiam_tpu/ops/gelu.py:gelu_act_grad_f32, gelu_grad_f32).
template <int G>
__device__ __forceinline__ void gelu_act_grad(float x, float& act, float& grad) {
  if constexpr (G == GELU_ANS) {
    float eexp;
    const float cdf = 0.5f * (1.f + erf_ans(x * INV_SQRT_2, eexp));
    act = x * cdf;
    grad = cdf + x * eexp * INV_SQRT_2PI;
  } else if constexpr (G == GELU_TANH) {
    const float t = tanhf(TANH_C * (x + 0.044715f * x * x * x));
    act = 0.5f * x * (1.f + t);
    grad = 0.5f * (1.f + t) +
           0.5f * x * (1.f - t * t) * (TANH_C * (1.f + 3.f * 0.044715f * x * x));
  } else if constexpr (G == GELU_CHEB) {
    const float cdf = phi_cheb(x);
    act = x * cdf;
    grad = cdf + x * expf(-0.5f * x * x) * INV_SQRT_2PI;
  } else {
    const float z = fminf(fmaxf(x * INV_SQRT_2, -T5_ZC), T5_ZC), u = z * z;
    const float q = (((T5_C4 * u + T5_C3) * u + T5_C2) * u + T5_C1) * u + T5_C0;
    const float qp = ((4.f * T5_C4 * u + 3.f * T5_C3) * u + 2.f * T5_C2) * u + T5_C1;
    const float t = tanhf(z * q);
    act = 0.5f * x * (1.f + t);
    grad = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * (q + 2.f * u * qp) * INV_SQRT_2;
  }
}

// gelu(x) of form G in f32
template <int G>
__device__ __forceinline__ float gelu_act(float x) {
  if constexpr (G == GELU_ANS) {
    float eexp;
    return 0.5f * x * (1.f + erf_ans(x * INV_SQRT_2, eexp));
  } else if constexpr (G == GELU_TANH) {
    return 0.5f * x * (1.f + tanhf(TANH_C * (x + 0.044715f * x * x * x)));
  } else if constexpr (G == GELU_CHEB) {
    return x * phi_cheb(x);
  } else {
    const float z = fminf(fmaxf(x * INV_SQRT_2, -T5_ZC), T5_ZC), u = z * z;
    const float q = (((T5_C4 * u + T5_C3) * u + T5_C2) * u + T5_C1) * u + T5_C0;
    return 0.5f * x * (1.f + tanhf(z * q));
  }
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
