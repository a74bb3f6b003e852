// K2's backward bodies (attention.cu), sm_90a, on nvcuda::wmma: the first
// form of the attention backward, kept until K2 moves onto K6's bodies in
// attention_bwd.cuh (which read the same saved statistics); this file then
// goes. The forward of K1 and K5 is attention_fwd.cuh, and the tile
// geometry, key bias and tile loads are attention_common.cuh's.
//
// Each of a block's 4 warps owns 16 rows of a 64-row tile. Operands sit in
// shared memory as bf16 tiles [64][D + 8]; products run on the tensor cores
// through nvcuda::wmma (16 x 16 x 16, bf16 operands, f32 accumulation) and
// their results go through shared memory as f32 tiles [64][LDS]. The bodies
// (attn_bwd_dq_walk, attn_bwd_dkdv_tile) take K2's head widths, D = 32 and
// 64, only, and read the forward's statistics in natural units: p = exp(s *
// scale + bias - m) r.
#pragma once

#include <mma.h>

#include "attention_common.cuh"

using namespace nvcuda;

namespace {

constexpr int LDS = BK + 4;  // f32 score tile row stride (floats)
constexpr int LDP = BK + 8;  // bf16 probability tile row stride

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

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

// ------------------------------------------------------------ backward dq
template <int D>
struct BwdQSmem {
  static_assert(D <= 64, "the backward bodies take K2's head widths");
  static constexpr int LDB = D + 8;
  static constexpr int Q = 0;
  static constexpr int DO = align128(Q + BQ * LDB * 2);
  static constexpr int K = align128(DO + BQ * LDB * 2);
  static constexpr int V = align128(K + BK * LDB * 2);
  static constexpr int S = align128(V + BK * LDB * 2);
  static constexpr int DP = align128(S + BQ * LDS * 4);
  static constexpr int DS = align128(DP + BQ * LDS * 4);
  static constexpr int ROW = align128(DS + BQ * LDP * 2);  // m, 1/denom, c
  static constexpr int BIAS = ROW + 3 * BQ * 4;
  static constexpr int BYTES = BIAS + BK * 4;
};

// The tiles of a dq block in its dynamic shared memory.
template <int D>
struct BwdQTiles {
  bf16 *Qs, *DOs, *Ks, *Vs, *DSs;
  float *Ss, *DPs, *Ms, *Rs, *Cs, *Bs;

  __device__ __forceinline__ explicit BwdQTiles(unsigned char* smem) {
    using SM = BwdQSmem<D>;
    Qs = reinterpret_cast<bf16*>(smem + SM::Q);
    DOs = reinterpret_cast<bf16*>(smem + SM::DO);
    Ks = reinterpret_cast<bf16*>(smem + SM::K);
    Vs = reinterpret_cast<bf16*>(smem + SM::V);
    Ss = reinterpret_cast<float*>(smem + SM::S);
    DPs = reinterpret_cast<float*>(smem + SM::DP);
    DSs = reinterpret_cast<bf16*>(smem + SM::DS);
    Ms = reinterpret_cast<float*>(smem + SM::ROW);
    Rs = Ms + BQ;
    Cs = Rs + BQ;
    Bs = reinterpret_cast<float*>(smem + SM::BIAS);
  }
};

// The dq walk of a block whose Qs and DOs hold its 64 queries' q and do and
// whose Ms, Rs and Cs hold each row's max, 1/denom and c = rowsum(dp * p):
// over the key tiles, ds = p * (dp - c) and dq += ds k; then scale * dq goes
// to the rows of dq, `ldq` elements apart, from the sample's first row,
// restaged through each warp's own rows of the s tile.
template <typename T, int D>
__device__ __forceinline__ void attn_bwd_dq_walk(
    const BwdQTiles<D>& t, const T* k, const T* v, int ld, const uint8_t* key_valid,
    T* dq, int ldq, int b, int h, int q0, int N, float scale) {
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int col = h * D;

  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(t.Ks, k, k0, N, ld, col, tid);
    load_tile<T, D>(t.Vs, v, k0, N, ld, col, tid);
    if (tid < BK) t.Bs[tid] = key_bias(key_valid, b, N, k0 + tid);
    __syncthreads();

    warp_scores<D>(t.Ss, t.Qs, t.Ks, wr);    // s = q k^T
    warp_scores<D>(t.DPs, t.DOs, t.Vs, wr);  // dp = do v^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = wr + r;
      const bool live = q0 + row < N;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float p = 0.f;
        if (live) p = expf(t.Ss[row * LDS + c] * scale + t.Bs[c] - t.Ms[row]) * t.Rs[row];
        t.DSs[row * LDP + c] = __float2bfloat16(p * (t.DPs[row * LDS + c] - t.Cs[row]));
      }
    }
    __syncwarp();
    warp_pv<D>(acc, t.DSs, t.Ks, wr);  // dq += ds k
  }

#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(t.Ss + wr * LDS + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r, n = q0 + row;
    if (n >= N) break;
    T* g = dq + (size_t)n * ldq + col;
    for (int d = lane; d < D; d += 32) g[d] = from_f32<T>(t.Ss[row * LDS + d] * scale);
  }
}

// --------------------------------------------------------- backward dk, dv
template <int D>
struct BwdKVSmem {
  static_assert(D <= 64, "the backward bodies take K2's head widths");
  static constexpr int LDB = D + 8;
  static constexpr int K = 0;
  static constexpr int V = align128(K + BK * LDB * 2);
  static constexpr int Q = align128(V + BK * LDB * 2);
  static constexpr int DO = align128(Q + BQ * LDB * 2);
  static constexpr int S = align128(DO + BQ * LDB * 2);
  static constexpr int DP = align128(S + BK * LDS * 4);
  static constexpr int P = align128(DP + BK * LDS * 4);
  static constexpr int DS = align128(P + BK * LDP * 2);
  static constexpr int COL = align128(DS + BK * LDP * 2);  // m, 1/denom, c
  static constexpr int BIAS = COL + 3 * BQ * 4;
  static constexpr int BYTES = BIAS + BK * 4;
};

// dk and dv of the 64 keys from k0 of head h of sample b: walks the query
// tiles, recomputing s^T and dp^T, with each query row's max and 1/denom
// read from stats [B, H, N, 2] and its c from delta [B, H, N]. dout is the
// contiguous [B, N, H * D] cotangent; dk and dv get rows `ldg` elements apart
// from the sample's first row, restaged through each warp's own rows of the
// s and dp tiles.
template <typename T, int D>
__device__ __forceinline__ void attn_bwd_dkdv_tile(
    const T* q, const T* k, const T* v, int ld, const uint8_t* key_valid,
    const T* dout, const float* stats, const float* delta, T* dk, T* dv, int ldg,
    int b, int h, int k0, int N, int H, float scale) {
  using SM = BwdKVSmem<D>;
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
  float* Qc = Qr + BQ;
  float* Kb = reinterpret_cast<float*>(smem + SM::BIAS);

  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int C = H * D, col = h * D;

  load_tile<T, D>(Ks, k, k0, N, ld, col, tid);
  load_tile<T, D>(Vs, v, k0, N, ld, col, tid);
  if (tid < BK) Kb[tid] = key_bias(key_valid, b, N, k0 + tid);

  FragC gk[D / 16], gv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(gk[j], 0.f);
    wmma::fill_fragment(gv[j], 0.f);
  }

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();
    load_tile<T, D>(Qs, q, q0, N, ld, col, tid);
    load_tile<T, D>(DOs, dout + (size_t)b * N * C, q0, N, C, col, tid);
    if (tid < BQ) {
      const int n = q0 + tid;
      const size_t i = ((size_t)b * H + h) * N + n;
      Qm[tid] = n < N ? stats[2 * i] : 0.f;
      Qr[tid] = n < N ? stats[2 * i + 1] : 0.f;
      Qc[tid] = n < N ? delta[i] : 0.f;
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
        DSs[row * LDP + c] = __float2bfloat16(p * (DPs[row * LDS + c] - Qc[c]));
      }
    }
    __syncwarp();
    warp_pv<D>(gv, Ps, DOs, wr);  // dv += p^T do
    warp_pv<D>(gk, DSs, Qs, wr);  // dk += ds^T q
  }

#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(Ss + wr * LDS + j * 16, gk[j], LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(DPs + wr * LDS + j * 16, gv[j], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = wr + r, n = k0 + row;
    if (n >= N) break;
    const size_t off = (size_t)n * ldg + col;
    for (int d = lane; d < D; d += 32) {
      dk[off + d] = from_f32<T>(Ss[row * LDS + d] * scale);
      dv[off + d] = from_f32<T>(DPs[row * LDS + d]);
    }
  }
}

}  // namespace
