// LayerNorm backward (K10), sm_90a.
//
// Replaces the TPU kernel of avsiam_tpu/ops/layernorm.py: _ln_bwd_pallas
// (_ln_bwd_kernel). Per row of x [R, C] and its cotangent dy, with flax's
// float32 statistics (the clamped mean of squares minus the squared mean,
// then rsqrt(var + eps)) and xhat = (x - mu) * rstd:
//   dx     = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//            dxhat = dy * scale, stored in x's dtype;
//   dgamma = sum over rows of dy * xhat, dbeta = sum over rows of dy (f32).
//
// What bounds it on the H100: bytes. It reads x and dy once and writes dx
// once, 3 * R * C values, and does about 15 operations a value; at 3.35 TB/s
// a [5664, 512] bf16 call needs 5.2 us and the step's encoder calls ([98,
// 768] to [1416, 768]) 0.1-2 us. At those sizes a call is latency-bound: what
// counts is how many loads are in flight at once and how few steps of the
// reduction run in series.
//
// Two kernels, the form torch's native LayerNorm backward takes, each
// spread over the card:
//   rows: a warp owns 1-4 consecutive rows (ln_bwd_rows_per_warp in
//     ops/layernorm.py), holds one in registers (each lane C / 32 values,
//     read and written with 16-byte loads) and issues the next row's loads
//     before it reduces the current one. The row statistics and the two row
//     means are warp reductions; it writes dx and the row's (mu, rstd) to a
//     [R, 2] f32 scratch. Blocks of 4 warps, so that at the step's shapes
//     the grid is 25-708 blocks, several on each SM; no column sums are
//     kept, so a lane holds only the row.
//   cols: a block per (64-column stripe, row range), 8 warps, reads x and
//     dy again (from L2: the rows kernel has just read them) with each
//     row's (mu, rstd): a warp takes 4 rows of 128 bytes at once (2 of 256
//     in f32), so every load is whole cache lines. Each lane keeps the
//     dgamma and dbeta sums of its 8 columns (4 in f32); the block adds them
//     over its lanes by shuffles and over its warps in shared memory, in
//     warp order.
//     The row ranges of a stripe (1-8, ln_bwd_col_splits) are one
//     thread-block cluster, and its first block adds the others' sums from
//     their shared memory (distributed shared memory), in rank order. At
//     the step's shapes (R >= 128: 8 ranges) that is 96 blocks at C = 768
//     and 64 at C = 512. (Clusters of 16, more warps, wider or narrower
//     stripes and loading rows ahead were measured no faster overall.)
// Every sum runs in an order fixed by R and C alone, and no atomics are
// used, so dgamma and dbeta give the same bits every call. Rows past R are
// never read, so they cannot reach the sums (the TPU kernel masks the
// ragged block instead).

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int ROW_WARPS = 4;
constexpr int ROW_THREADS = ROW_WARPS * 32;
constexpr int COL_WARPS = 8;
constexpr int COL_THREADS = COL_WARPS * 32;
constexpr int MAX_SPLITS = 8;  // a portable cluster
constexpr int STRIPE = 64;     // columns a block of the cols kernel owns
constexpr int MAX_C = 1280;  // ViT-H's width
constexpr int MAX_ROWS_PER_WARP = 4;

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 16 bytes of a row, as loaded; converted to f32 by unpack
__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* out, bf16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(in[2 * k], in[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// The lane's NV vectors of row r of x and dy (zeros past the row's nvec).
template <int NV>
__device__ __forceinline__ void load_row(uint4 (&xr)[NV], uint4 (&gr)[NV], const uint4* x,
                                         const uint4* dy, size_t r, int nvec, int lane) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    if (v < nvec) {
      xr[j] = x[r * nvec + v];
      gr[j] = dy[r * nvec + v];
    } else {
      xr[j] = gr[j] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// NV: 16-byte vectors a lane holds of one row (C <= 32 * NV * VEC).
template <typename T, int NV>
__global__ void __launch_bounds__(ROW_THREADS)
ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ scale, T* __restrict__ dx,
                   float2* __restrict__ stats, int R, int C, int rows_per_warp, float eps) {
  constexpr int VEC = Vec<T>::N;
  constexpr int L = NV * VEC;  // values a lane holds
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * ROW_WARPS + (threadIdx.x >> 5)) * rows_per_warp;
  const int r1 = min(r0 + rows_per_warp, R);
  if (r0 >= R) return;
  const int nvec = C / VEC;
  const float inv_c = 1.f / (float)C;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(dy);
  const float4* sv = reinterpret_cast<const float4*>(scale);

  uint4 xr[NV], gr[NV];
  load_row<NV>(xr, gr, xv, gv, r0, nvec, lane);
  for (int r = r0; r < r1; ++r) {
    float a[L], g[L];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack(xr[j], a + j * VEC, T());
      unpack(gr[j], g + j * VEC, T());
    }
    // the next row's loads are in flight while this one is reduced
    if (r + 1 < r1) load_row<NV>(xr, gr, xv, gv, r + 1, nvec, lane);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      s += a[i];
      s2 += a[i] * a[i];
    }
    const float mu = warp_sum(s) * inv_c;
    const float var = fmaxf(0.f, warp_sum(s2) * inv_c - mu * mu);
    const float rstd = rsqrtf(var + eps);
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = lane + 32 * j;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        // columns past C hold x = dy = 0 and scale 0: they add nothing
        const float4 sc = v < nvec ? sv[(v * VEC + e) / 4] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float scs[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = j * VEC + e + k;
          const float xh = (a[i] - mu) * rstd;
          const float d = g[i] * scs[k];
          a[i] = xh;
          g[i] = d;
          c1 += d;
          c2 += d * xh;
        }
      }
    }
    c1 = warp_sum(c1) * inv_c;
    c2 = warp_sum(c2) * inv_c;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = lane + 32 * j;
      if (v >= nvec) continue;
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int i = j * VEC + e;
        out[e] = rstd * (g[i] - c1 - a[i] * c2);
      }
      store_vec(dx + (size_t)r * C + v * VEC, out);
    }
    if (lane == 0) stats[r] = make_float2(mu, rstd);
  }
}

// dgamma and dbeta of the 64 columns from blockIdx.x * 64: the cluster of
// gridDim.y blocks splits the rows into ranges, each block adds its range's
// sums in shared memory, and block 0 of the cluster adds the blocks' sums
// in rank order through distributed shared memory.
template <typename T>
__global__ void __launch_bounds__(COL_THREADS)
ln_bwd_cols_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float2* __restrict__ stats, float* __restrict__ dgamma,
                   float* __restrict__ dbeta, int R, int C) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LANES = STRIPE / VEC;       // lanes a row of the stripe takes
  constexpr int STEP = 32 / LANES;          // rows a warp reads at once
  __shared__ float red[COL_WARPS][2][STRIPE];
  __shared__ float sums[2][STRIPE];         // this block's, read by rank 0
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int splits = gridDim.y, k = blockIdx.y;
  const int per_split = (R + splits - 1) / splits;
  const int r1 = min((k + 1) * per_split, R);
  const int cv = lane % LANES, sub = lane / LANES;  // vector in the stripe, row slot
  const int nvec = C / VEC, v = blockIdx.x * LANES + cv;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(dy);

  float sg[VEC], sb[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sg[e] = sb[e] = 0.f;
  // each lane adds its rows in row order (loading several rows ahead, by
  // unrolling or by hand, measured no faster)
  for (int r = k * per_split + warp * STEP + sub; r < r1; r += COL_WARPS * STEP) {
    const float2 st = stats[r];
    float a[VEC], g[VEC];
    unpack(xv[(size_t)r * nvec + v], a, T());
    unpack(gv[(size_t)r * nvec + v], g, T());
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sg[e] += g[e] * ((a[e] - st.x) * st.y);
      sb[e] += g[e];
    }
  }
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1)  // over the warp's row slots
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], o);
      sb[e] += __shfl_xor_sync(0xffffffffu, sb[e], o);
    }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[warp][0][cv * VEC + e] = sg[e];
      red[warp][1][cv * VEC + e] = sb[e];
    }
  }
  __syncthreads();
  if (tid < 2 * STRIPE) {  // the warps' sums in warp order
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < COL_WARPS; ++w) t += red[w][tid / STRIPE][tid % STRIPE];
    sums[tid / STRIPE][tid % STRIPE] = t;
  }
  cluster.sync();
  if (k == 0 && tid < 2 * STRIPE) {  // the blocks' sums in rank order
    float t = 0.f;
    for (int i = 0; i < splits; ++i)
      t += cluster.map_shared_rank(&sums[0][0], i)[tid];
    const int c = blockIdx.x * STRIPE + tid % STRIPE;
    (tid < STRIPE ? dgamma : dbeta)[c] = t;
  }
  cluster.sync();  // no block leaves while rank 0 reads its sums
}

template <typename T, int NV>
int launch(const void* x, const void* dy, const void* scale, void* dx, void* dgamma,
           void* dbeta, void* stats, int R, int C, int rows_per_warp, int splits, float eps,
           cudaStream_t stream) {
  const int rows_per_block = ROW_WARPS * rows_per_warp;
  ln_bwd_rows_kernel<T, NV><<<(R + rows_per_block - 1) / rows_per_block, ROW_THREADS, 0,
                              stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(scale),
      static_cast<T*>(dx), static_cast<float2*>(stats), R, C, rows_per_warp, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C / STRIPE, splits, 1);
  cfg.blockDim = dim3(COL_THREADS, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, ln_bwd_cols_kernel<T>, static_cast<const T*>(x),
                                 static_cast<const T*>(dy),
                                 static_cast<const float2*>(stats),
                                 static_cast<float*>(dgamma), static_cast<float*>(dbeta), R, C);
}

template <typename T>
int dispatch(int nv, const void* x, const void* dy, const void* scale, void* dx,
             void* dgamma, void* dbeta, void* stats, int R, int C, int rows_per_warp,
             int splits, float eps, cudaStream_t s) {
  // only the widths up to MAX_C are built: 5 vectors a lane in bf16, 10 in f32
#define LN_CASE(NV)                                                                       \
  case NV:                                                                                \
    if constexpr (NV <= (MAX_C / Vec<T>::N + 31) / 32)                                    \
      return launch<T, NV>(x, dy, scale, dx, dgamma, dbeta, stats, R, C, rows_per_warp,    \
                           splits, eps, s);                                               \
    break;
  switch (nv) {
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4) LN_CASE(5)
    LN_CASE(6) LN_CASE(7) LN_CASE(8) LN_CASE(9) LN_CASE(10)
  }
#undef LN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, dy, dx: [R, C] (C a multiple of 128,
// at most 1280, rows 16-byte aligned); scale: [C] f32; dgamma, dbeta: [C]
// f32; stats: [R, 2] f32 scratch (each row's mu and rstd); rows_per_warp:
// 1-4; splits: 1-MAX_SPLITS, the row ranges (a cluster's blocks) of the cols
// kernel.
extern "C" int avsiam_ln_bwd(const void* x, const void* dy, const void* scale, void* dx,
                             void* dgamma, void* dbeta, void* stats, int R, int C,
                             int rows_per_warp, int splits, int dtype, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || rows_per_warp < 1 || rows_per_warp > MAX_ROWS_PER_WARP || splits < 1 ||
      splits > MAX_SPLITS || C % 128 != 0 || C > MAX_C)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return dispatch<bf16>((C / Vec<bf16>::N + 31) / 32, x, dy, scale, dx, dgamma, dbeta,
                          stats, R, C, rows_per_warp, splits, eps, s);
  if (dtype == 0)
    return dispatch<float>((C / Vec<float>::N + 31) / 32, x, dy, scale, dx, dgamma, dbeta,
                           stats, R, C, rows_per_warp, splits, eps, s);
  return (int)cudaErrorInvalidValue;
}
