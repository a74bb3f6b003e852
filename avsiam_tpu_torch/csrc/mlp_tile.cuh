// The row-tile MLP forward shared by K3 (ln_mlp.cu) and K4 (mlp.cu), sm_90a.
//
// A block holds a 32-row tile of the MLP input in shared memory (bf16, the
// caller fills it: LN(x) for K3, x for K4) and walks its share of the hidden
// dimension in chunks of 64 columns: fc1 chunk -> + b1 (pre-GELU hidden out,
// optionally) -> f32 GELU -> fc2 partial product into a [32, 128 YC] f32
// accumulator held in registers (wmma fragments, YC a warp per 16-row tile).
// Each block then writes its partial fc2 sum to a workspace [splits, rows,
// D]; `mlp_epilogue_kernel` adds the partials in a fixed order
// (deterministic, no atomics).
//
// D is a run-time width (any multiple of 128). fc2's D output columns are
// cut into D / (128 YC) column groups, one block each (the grid's z): YC =
// D / 128 up to D = 768 (one group), so no block holds more than 6
// fragments a warp per row tile (96 registers; D = 1280 whole would take
// 160). A group past the first recomputes the fc1 chunks, and only the
// first writes the pre-GELU hidden.
//
// Weights use nn.Linear's layout: w1 [H, D] (fc1.weight), w2 [D, H]
// (fc2.weight); biases are f32.
#pragma once

#include <math.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 32;        // rows per block
constexpr int HC = 64;        // hidden columns per chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = HC + 4;   // f32 hidden tile row stride
constexpr int LDG = HC + 8;   // bf16 activation tile row stride

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;

// shared memory of a row tile of width D: bf16 rows, the f32 fc1 chunk and
// its bf16 activation
struct MlpSmem {
  int ldn, ns, hs, gs, bytes;
  __host__ __device__ explicit MlpSmem(int D)
      : ldn(D + 8), ns(0), hs(align128(BM * (D + 8) * 2)),
        gs(align128(hs + BM * LDH * 4)), bytes(gs + BM * LDG * 2) {}
};
constexpr int MAX_YC = 6;  // fc2 fragments a warp per 16-row tile

// D's fc2 columns cut into `groups` column groups of 128 YC columns, YC <=
// MAX_YC, with the row tile within a block's shared memory
inline bool mlp_groups_ok(int D, int groups) {
  return D > 0 && D % 128 == 0 && groups >= 1 && (D / 128) % groups == 0 &&
         D / 128 / groups <= MAX_YC && MlpSmem(D).bytes <= 227 * 1024;
}

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

// 16 bytes of T values stored as bf16 at p (16 bytes from bf16, 8 from f32)
__device__ __forceinline__ void store_bf16(bf16* p, const uint4& v, bf16) {
  *reinterpret_cast<uint4*>(p) = v;
}
__device__ __forceinline__ void store_bf16(bf16* p, const uint4& v, float) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(__uint_as_float(v.x), __uint_as_float(v.y));
  const __nv_bfloat162 hi = __floats2bfloat162_rn(__uint_as_float(v.z), __uint_as_float(v.w));
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [r0, r0 + ROWS) of `cols` columns (ROWS * cols a multiple of NT 16-byte
// loads), row r at src + r * ld, into a bf16 tile with row stride `ldd`;
// zeros past `rows`. 16-byte loads, NT threads, each issuing its loads in
// groups of 8 so that their latencies overlap. Rows must start 16-byte
// aligned.
template <typename T, int ROWS, int NT>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, size_t ld, bf16* dst,
                                          int ldd, int cols, int r0, int rows) {
  constexpr int V = 16 / sizeof(T);  // values per load
  constexpr int G = 8;
  const int PER_ROW = cols / V;
  const int N = ROWS * PER_ROW / NT;  // loads per thread
  for (int k0 = 0; k0 < N; k0 += G) {
    uint4 v[G];
#pragma unroll
    for (int k = 0; k < G && k0 + k < N; ++k) {
      const int i = threadIdx.x + (k0 + k) * NT, n = r0 + i / PER_ROW;
      v[k] = n < rows ? reinterpret_cast<const uint4*>(src + (size_t)n * ld)[i % PER_ROW]
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < G && k0 + k < N; ++k) {
      const int i = threadIdx.x + (k0 + k) * NT;
      store_bf16(dst + (i / PER_ROW) * ldd + (i % PER_ROW) * V, v[k], T());
    }
  }
}

template <int YC>
__device__ __forceinline__ void zero_rows_acc(FragC (&y)[2][YC]) {
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < YC; ++j) wmma::fill_fragment(y[rt][j], 0.f);
}

// Chunks [c_begin, c_end) of the hidden dimension for the row tile in Ns
// (width D, row stride LDN): y += gelu(Ns . w1[chunk]^T + b1) . w2[c0 +
// this warp's output columns, chunk]^T, the block's columns starting at c0;
// the pre-GELU hidden goes to hpre (rows < `rows`) unless it is null. Starts
// and ends with every warp past a __syncthreads.
template <typename T, int YC>
__device__ __forceinline__ void fwd_chunks(const bf16* Ns, float* Hs, bf16* Gs,
                                           const bf16* __restrict__ w1,
                                           const float* __restrict__ b1,
                                           const bf16* __restrict__ w2, T* __restrict__ hpre,
                                           int r0, int rows, int D, int H, int c0, int c_begin,
                                           int c_end, FragC (&y)[2][YC]) {
  const int LDN = D + 8;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int frt = warp >> 2, fct = warp & 3;  // this warp's fc1 fragment
  for (int h0 = c_begin * HC; h0 < c_end * HC; h0 += HC) {
    // h = Ns . w1[h0:h0+HC]^T, one 16x16 fragment per warp
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
    // + b1; the pre-GELU hidden goes out; f32 GELU -> bf16 tile Gs
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC, n = r0 + r;
      const float hv = Hs[r * LDH + c] + b1[h0 + c];
      if (hpre != nullptr && n < rows) hpre[(size_t)n * H + h0 + c] = from_f32<T>(hv);
      Gs[r * LDG + c] = __float2bfloat16(gelu_ans(hv));
    }
    __syncthreads();
    // y += g . w2[:, h0:h0+HC]^T on this warp's output columns
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      FragA fa0, fa1;
      wmma::load_matrix_sync(fa0, Gs + kk, LDG);
      wmma::load_matrix_sync(fa1, Gs + 16 * LDG + kk, LDG);
#pragma unroll
      for (int j = 0; j < YC; ++j) {
        FragBc fb;
        wmma::load_matrix_sync(fb, w2 + (size_t)(c0 + (warp * YC + j) * 16) * H + h0 + kk, H);
        wmma::mma_sync(y[0][j], fa0, fb, y[0][j]);
        wmma::mma_sync(y[1][j], fa1, fb, y[1][j]);
      }
    }
  }
}

// This block's [32, 128 YC] partial sum goes to columns c0.. of
// partial[blockIdx.y] (rows padded to the row tiles, so whole fragments are
// stored; row stride D)
template <int YC>
__device__ __forceinline__ void store_partial(float* __restrict__ partial, FragC (&y)[2][YC],
                                              int r0, int c0, int D) {
  const int warp = threadIdx.x >> 5;
  const int rows_pad = gridDim.x * BM;
  float* part = partial + ((size_t)blockIdx.y * rows_pad + r0) * D;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < YC; ++j)
      wmma::store_matrix_sync(part + (size_t)rt * 16 * D + c0 + (warp * YC + j) * 16, y[rt][j],
                              D, wmma::mem_row_major);
}

// out = [x +] T(sum_s partial[s] [+ b2]): the partials in order s = 0, 1, ...,
// then the residual add (K3) in T
template <typename T, bool BIAS, bool RESID>
__global__ void mlp_epilogue_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                                    const float* __restrict__ b2, T* __restrict__ out, int rows,
                                    int rows_pad, int D, int splits) {
  const size_t n = (size_t)rows * D, stride = (size_t)rows_pad * D;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[s * stride + i];
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
                            int rows, int rows_pad, int D, int splits, cudaStream_t stream) {
  const long long n = (long long)rows * D;
  const int blocks = (int)((n + 1023) / 1024 < 4096 ? (n + 1023) / 1024 : 4096);
  mlp_epilogue_kernel<T, BIAS, RESID><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(partial),
      static_cast<const float*>(b2), static_cast<T*>(out), rows, rows_pad, D, splits);
  return cudaGetLastError();
}

}  // namespace
