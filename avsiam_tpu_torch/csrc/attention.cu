// Token-major multi-head attention, forward (K1) and backward (K2), sm_90a.
//
// Replaces the TPU kernels of avsiam_tpu/ops/attention.py:
//   K1 _pallas_fwd_tm (_fwd_kernel_tm): softmax(q k^T D^-1/2 + key bias) v per
//      head, read from the raw [B, N, 3C] qkv projection (channel order
//      (3, H, D)), written token-major to [B, N, C];
//   K2 _pallas_bwd_tm (_bwd_kernel_tm, _bwd_tm_one): its backward, written as
//      the [B, N, 3C] cotangent.
//
// What bounds it on the H100: at AVSiam's lengths (N <= 708) and head widths
// (D = 64 encoder, 32 decoder) the four N^2*D products per head are small and
// the work is dominated by the softmax's exp and the score-tile traffic
// through shared memory; the bytes (q, k, v, o read or written once) are a few
// MB per call. The design keeps every N^2 tile on chip: one block per
// (query tile, head, sample) streams key tiles with an online softmax in f32
// (flash-attention style), so no score matrix reaches device memory.
// q, k and v are read in place from [B, N, 3C] through strides (no transposes),
// ragged N is masked in the kernel (keys past N get -inf), and products run
// on the tensor cores through nvcuda::wmma with bf16 operands and f32
// accumulation. An f32 call stores f32 but still multiplies bf16 operands.
//
// The forward saves, per (sample, head, row), the running max m and 1/denom
// (the TPU kernel's statistics) for the backward. A logsumexp would be one
// float, but a row whose keys are all invalid has m = -1e30 and its
// logsumexp -1e30 + log N rounds back to -1e30, losing the 1/N.
//
// The backward is deterministic and uses no atomics: a dq kernel walks the
// key tiles of one query tile (and writes delta_i = rowsum(do_i * o_i), the
// TPU kernel's c), then a dk/dv kernel walks the query tiles of one key tile.
//
// Tiles are 64 x 64 and each of the 4 warps owns 16 rows of a tile. These
// kernels are the simple, correct first form; wgmma, TMA and warp
// specialisation are later work.

#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // key rows per tile
constexpr int WARPS = 4;     // each warp owns 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;  // f32 score tile row stride (floats)
constexpr int LDP = BK + 8;  // bf16 probability tile row stride

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

// Rows [row0, row0 + 64) of D channels starting at column `col` of a row-major
// [N, ld] matrix, into a bf16 tile [64][D + 8]; rows past N become zeros.
template <typename T, int D>
__device__ void load_tile(bf16* dst, const T* src, int row0, int N, int ld,
                          int col, int tid) {
  constexpr int LDB = D + 8;
  constexpr int PER_ROW = D / 8;
  for (int c = tid; c < 64 * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int d0 = (c % PER_ROW) * 8;
    const int n = row0 + r;
    bf16* out = dst + r * LDB + d0;
    if (n < N) {
      const T* in = src + (size_t)n * ld + col + d0;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(in);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) out[i] = __float2bfloat16(in[i]);
      }
    } else {
      *reinterpret_cast<uint4*>(out) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// S[rows of this warp][0:64] = A[rows] . B[0:64]^T over D channels (f32).
template <int D>
__device__ __forceinline__ void warp_scores(float* S, const bf16* A,
                                            const bf16* B, int wr) {
  constexpr int LDB = D + 8;
  FragC acc[BK / 16];
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, A + wr * LDB + kk, LDB);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      FragBc fb;
      wmma::load_matrix_sync(fb, B + j * 16 * LDB + kk, LDB);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wmma::store_matrix_sync(S + wr * LDS + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// acc[0:D/16] += P[rows of this warp][0:64] . M[0:64][0:D]
template <int D>
__device__ __forceinline__ void warp_pv(FragC* acc, const bf16* P, const bf16* M,
                                        int wr) {
  constexpr int LDB = D + 8;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, P + wr * LDP + kk, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBr fb;
      wmma::load_matrix_sync(fb, M + kk * LDB + j * 16, LDB);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

__device__ __forceinline__ float key_bias(const uint8_t* key_valid, int b, int N,
                                          int j) {
  if (j >= N) return -INFINITY;  // past the ragged end: not a key at all
  if (key_valid != nullptr && !key_valid[(size_t)b * N + j]) return -1e30f;
  return 0.f;
}

// ---------------------------------------------------------------- forward
template <int D>
struct FwdSmem {
  static constexpr int LDB = D + 8;
  static constexpr int LDO = D + 4;
  static constexpr int Q = 0;
  static constexpr int K = align128(Q + BQ * LDB * 2);
  static constexpr int V = align128(K + BK * LDB * 2);
  static constexpr int S = align128(V + BK * LDB * 2);
  static constexpr int P = align128(S + BQ * LDS * 4);
  static constexpr int O = align128(P + BQ * LDP * 2);
  static constexpr int M = align128(O + BQ * LDO * 4);
  static constexpr int L = M + BQ * 4;
  static constexpr int BIAS = L + BQ * 4;
  static constexpr int BYTES = BIAS + BK * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ key_valid,
                T* __restrict__ out, float* __restrict__ stats, int N, int H,
                float scale) {
  using SM = FwdSmem<D>;
  constexpr int LDB = SM::LDB, LDO = SM::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::V);
  float* Ss = reinterpret_cast<float*>(smem + SM::S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::P);
  float* Os = reinterpret_cast<float*>(smem + SM::O);
  float* Ms = reinterpret_cast<float*>(smem + SM::M);
  float* Ls = reinterpret_cast<float*>(smem + SM::L);
  float* Bs = reinterpret_cast<float*>(smem + SM::BIAS);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int C = H * D, ld = 3 * C;
  const T* base = qkv + (size_t)b * N * ld;

  load_tile<T, D>(Qs, base, q0, N, ld, h * D, tid);
  for (int i = tid; i < BQ * LDO; i += THREADS) Os[i] = 0.f;
  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D>(Ks, base, k0, N, ld, C + h * D, tid);
    load_tile<T, D>(Vs, base, k0, N, ld, 2 * C + h * D, tid);
    if (tid < BK) Bs[tid] = key_bias(key_valid, b, N, k0 + tid);
    __syncthreads();

    warp_scores<D>(Ss, Qs, Ks, wr);
    __syncwarp();
    // online softmax; lane owns columns lane and lane + 32. Key k0 < N is
    // always a key, so m_new is finite and exp(m_old - m_new) never NaN.
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const float s0 = Ss[row * LDS + lane] * scale + Bs[lane];
      const float s1 = Ss[row * LDS + lane + 32] * scale + Bs[lane + 32];
      const float m_old = Ms[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float rowsum = warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);
      Ps[row * LDP + lane] = __float2bfloat16(p0);
      Ps[row * LDP + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < D; d += 32) Os[row * LDO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        Ms[row] = m_new;
        Ls[row] = Ls[row] * alpha + rowsum;
      }
    }
    __syncwarp();
    FragC acc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::load_matrix_sync(acc[j], Os + wr * LDO + j * 16, LDO, wmma::mem_row_major);
    warp_pv<D>(acc, Ps, Vs, wr);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(Os + wr * LDO + j * 16, acc[j], LDO, wmma::mem_row_major);
    __syncwarp();
  }

  // normalisation after PV: one reciprocal per row
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r, n = q0 + row;
    if (n >= N) break;
    const float inv = 1.f / Ls[row];
    T* o = out + ((size_t)b * N + n) * C + h * D;
    for (int d = lane; d < D; d += 32) o[d] = from_f32<T>(Os[row * LDO + d] * inv);
    if (lane == 0) {
      float* st = stats + (((size_t)b * H + h) * N + n) * 2;
      st[0] = Ms[row];
      st[1] = inv;
    }
  }
}

// ------------------------------------------------------------ backward dq
template <int D>
struct BwdQSmem {
  static constexpr int LDB = D + 8;
  static constexpr int Q = 0;
  static constexpr int DO = align128(Q + BQ * LDB * 2);
  static constexpr int K = align128(DO + BQ * LDB * 2);
  static constexpr int V = align128(K + BK * LDB * 2);
  static constexpr int S = align128(V + BK * LDB * 2);
  static constexpr int DP = align128(S + BQ * LDS * 4);
  static constexpr int DS = align128(DP + BQ * LDS * 4);
  static constexpr int ROW = align128(DS + BQ * LDP * 2);  // m, 1/denom, delta
  static constexpr int BIAS = ROW + 3 * BQ * 4;
  static constexpr int BYTES = BIAS + BK * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ key_valid,
                   const T* __restrict__ out, const T* __restrict__ dout,
                   const float* __restrict__ stats, float* __restrict__ delta,
                   T* __restrict__ dqkv, int N, int H, float scale) {
  using SM = BwdQSmem<D>;
  constexpr int LDB = SM::LDB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::Q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + SM::DO);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::V);
  float* Ss = reinterpret_cast<float*>(smem + SM::S);
  float* DPs = reinterpret_cast<float*>(smem + SM::DP);
  bf16* DSs = reinterpret_cast<bf16*>(smem + SM::DS);
  float* Ms = reinterpret_cast<float*>(smem + SM::ROW);
  float* Rs = Ms + BQ;
  float* Dl = Rs + BQ;
  float* Bs = reinterpret_cast<float*>(smem + SM::BIAS);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int C = H * D, ld = 3 * C;
  const T* base = qkv + (size_t)b * N * ld;

  load_tile<T, D>(Qs, base, q0, N, ld, h * D, tid);
  load_tile<T, D>(DOs, dout + (size_t)b * N * C, q0, N, C, h * D, tid);
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r, n = q0 + row;
    float m = 0.f, rinv = 0.f, dl = 0.f;
    if (n < N) {
      const size_t off = ((size_t)b * N + n) * C + h * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc += to_f32(out[off + d]) * to_f32(dout[off + d]);
      dl = warp_sum(acc);
      const float* st = stats + (((size_t)b * H + h) * N + n) * 2;
      m = st[0];
      rinv = st[1];
      if (lane == 0) delta[((size_t)b * H + h) * N + n] = dl;
    }
    if (lane == 0) {
      Ms[row] = m;
      Rs[row] = rinv;
      Dl[row] = dl;
    }
  }

  FragC dq[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq[j], 0.f);

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(Ks, base, k0, N, ld, C + h * D, tid);
    load_tile<T, D>(Vs, base, k0, N, ld, 2 * C + h * D, tid);
    if (tid < BK) Bs[tid] = key_bias(key_valid, b, N, k0 + tid);
    __syncthreads();

    warp_scores<D>(Ss, Qs, Ks, wr);    // s = q k^T
    warp_scores<D>(DPs, DOs, Vs, wr);  // dp = do v^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const bool live = q0 + row < N;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float p = 0.f;
        if (live) p = expf(Ss[row * LDS + c] * scale + Bs[c] - Ms[row]) * Rs[row];
        DSs[row * LDP + c] = __float2bfloat16(p * (DPs[row * LDS + c] - Dl[row]));
      }
    }
    __syncwarp();
    warp_pv<D>(dq, DSs, Ks, wr);  // dq += ds k
  }

#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(Ss + wr * LDS + j * 16, dq[j], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r, n = q0 + row;
    if (n >= N) break;
    T* g = dqkv + ((size_t)b * N + n) * ld + h * D;
    for (int d = lane; d < D; d += 32) g[d] = from_f32<T>(Ss[row * LDS + d] * scale);
  }
}

// --------------------------------------------------------- backward dk, dv
template <int D>
struct BwdKVSmem {
  static constexpr int LDB = D + 8;
  static constexpr int K = 0;
  static constexpr int V = align128(K + BK * LDB * 2);
  static constexpr int Q = align128(V + BK * LDB * 2);
  static constexpr int DO = align128(Q + BQ * LDB * 2);
  static constexpr int S = align128(DO + BQ * LDB * 2);
  static constexpr int DP = align128(S + BK * LDS * 4);
  static constexpr int P = align128(DP + BK * LDS * 4);
  static constexpr int DS = align128(P + BK * LDP * 2);
  static constexpr int COL = align128(DS + BK * LDP * 2);  // m, 1/denom, delta
  static constexpr int BIAS = COL + 3 * BQ * 4;
  static constexpr int BYTES = BIAS + BK * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ key_valid,
                     const T* __restrict__ dout, const float* __restrict__ stats,
                     const float* __restrict__ delta, T* __restrict__ dqkv, int N,
                     int H, float scale) {
  using SM = BwdKVSmem<D>;
  constexpr int LDB = SM::LDB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::V);
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::Q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + SM::DO);
  float* Ss = reinterpret_cast<float*>(smem + SM::S);
  float* DPs = reinterpret_cast<float*>(smem + SM::DP);
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::P);
  bf16* DSs = reinterpret_cast<bf16*>(smem + SM::DS);
  float* Qm = reinterpret_cast<float*>(smem + SM::COL);
  float* Qr = Qm + BQ;
  float* Qd = Qr + BQ;
  float* Kb = reinterpret_cast<float*>(smem + SM::BIAS);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int C = H * D, ld = 3 * C;
  const T* base = qkv + (size_t)b * N * ld;

  load_tile<T, D>(Ks, base, k0, N, ld, C + h * D, tid);
  load_tile<T, D>(Vs, base, k0, N, ld, 2 * C + h * D, tid);
  if (tid < BK) Kb[tid] = key_bias(key_valid, b, N, k0 + tid);

  FragC dk[D / 16], dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();
    load_tile<T, D>(Qs, base, q0, N, ld, h * D, tid);
    load_tile<T, D>(DOs, dout + (size_t)b * N * C, q0, N, C, h * D, tid);
    if (tid < BQ) {
      const int n = q0 + tid;
      const size_t i = ((size_t)b * H + h) * N + n;
      Qm[tid] = n < N ? stats[2 * i] : 0.f;
      Qr[tid] = n < N ? stats[2 * i + 1] : 0.f;
      Qd[tid] = n < N ? delta[i] : 0.f;
    }
    __syncthreads();

    warp_scores<D>(Ss, Ks, Qs, wr);    // s^T = k q^T   (rows: this warp's keys)
    warp_scores<D>(DPs, Vs, DOs, wr);  // dp^T = v do^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float p = 0.f;
        if (q0 + c < N) p = expf(Ss[row * LDS + c] * scale + Kb[row] - Qm[c]) * Qr[c];
        Ps[row * LDP + c] = __float2bfloat16(p);
        DSs[row * LDP + c] = __float2bfloat16(p * (DPs[row * LDS + c] - Qd[c]));
      }
    }
    __syncwarp();
    warp_pv<D>(dv, Ps, DOs, wr);  // dv += p^T do
    warp_pv<D>(dk, DSs, Qs, wr);  // dk += ds^T q
  }

#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(Ss + wr * LDS + j * 16, dk[j], LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(DPs + wr * LDS + j * 16, dv[j], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r, n = k0 + row;
    if (n >= N) break;
    T* g = dqkv + ((size_t)b * N + n) * ld + h * D;
    for (int d = lane; d < D; d += 32) {
      g[C + d] = from_f32<T>(Ss[row * LDS + d] * scale);
      g[2 * C + d] = from_f32<T>(DPs[row * LDS + d]);
    }
  }
}

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int launch_fwd(const void* qkv, const void* key_valid, void* out, void* stats, int B,
               int N, int H, float scale, cudaStream_t stream) {
  const int smem = FwdSmem<D>::BYTES;
  cudaError_t err = allow_smem(attn_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  attn_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(key_valid),
      static_cast<T*>(out), static_cast<float*>(stats), N, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const void* qkv, const void* key_valid, const void* out,
               const void* dout, const void* stats, void* delta, void* dqkv, int B,
               int N, int H, float scale, cudaStream_t stream) {
  const int smem_q = BwdQSmem<D>::BYTES, smem_kv = BwdKVSmem<D>::BYTES;
  cudaError_t err = allow_smem(attn_bwd_dq_kernel<T, D>, smem_q);
  if (err == cudaSuccess) err = allow_smem(attn_bwd_dkdv_kernel<T, D>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((N + BQ - 1) / BQ, H, B);
  attn_bwd_dq_kernel<T, D><<<grid_q, THREADS, smem_q, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(key_valid),
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(delta),
      static_cast<T*>(dqkv), N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((N + BK - 1) / BK, H, B);
  attn_bwd_dkdv_kernel<T, D><<<grid_kv, THREADS, smem_kv, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(key_valid),
      static_cast<const T*>(dout), static_cast<const float*>(stats),
      static_cast<const float*>(delta), static_cast<T*>(dqkv), N, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. key_valid: [B, N] bytes or null.
// stats: [B, H, N, 2] float32 (row max, 1/denom), written by the forward.
extern "C" int avsiam_attn_fwd(const void* qkv, const void* key_valid, void* out,
                               void* stats, int B, int N, int H, int D, int dtype,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch_fwd<bf16, 64>(qkv, key_valid, out, stats, B, N, H, scale, s);
  if (dtype == 1 && D == 32) return launch_fwd<bf16, 32>(qkv, key_valid, out, stats, B, N, H, scale, s);
  if (dtype == 0 && D == 64) return launch_fwd<float, 64>(qkv, key_valid, out, stats, B, N, H, scale, s);
  if (dtype == 0 && D == 32) return launch_fwd<float, 32>(qkv, key_valid, out, stats, B, N, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

// delta: [B, H, N] float32 scratch. dqkv: [B, N, 3C], every element written.
extern "C" int avsiam_attn_bwd(const void* qkv, const void* key_valid, const void* out,
                               const void* dout, const void* stats, void* delta,
                               void* dqkv, int B, int N, int H, int D, int dtype,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_bwd<bf16, 64>(qkv, key_valid, out, dout, stats, delta, dqkv, B, N, H, scale, s);
  if (dtype == 1 && D == 32)
    return launch_bwd<bf16, 32>(qkv, key_valid, out, dout, stats, delta, dqkv, B, N, H, scale, s);
  if (dtype == 0 && D == 64)
    return launch_bwd<float, 64>(qkv, key_valid, out, dout, stats, delta, dqkv, B, N, H, scale, s);
  if (dtype == 0 && D == 32)
    return launch_bwd<float, 32>(qkv, key_valid, out, dout, stats, delta, dqkv, B, N, H, scale, s);
  return (int)cudaErrorInvalidValue;
}
