// The attention backward from the forward's saved row statistics, sm_90a:
// the bodies of K6 (attention_hm.cu, head-major q, k, v) and K2
// (attention.cu, the packed [B, N, 3C] qkv), which differ only in where the
// operands and gradients live.
//
// Per (sample, head): q, k and v rows `ld` elements apart from the sample's
// first row, the head's dh channels at [h dh, h dh + dh) (dh <= D, the
// tiles' width: attention_common.cuh); the output o, its
// cotangent do and the gradients rows `ldo` (or `ldg`) apart; stats
// [B, H, N, 2] = each row's max m and 1/denominator r of s * scale + bias,
// s = q k^T, as the forward saved them. Then
//   p = exp(s * scale + bias - m) * r,   dp = do v^T,
//   delta = rowsum(do * o)  (= rowsum(p * dp)),   ds = p * (dp - delta),
//   dq = scale * ds k,   dk = scale * ds^T q,   dv = p^T do.
// Two kernels, one owner per output element, no atomics, the same bits
// every call:
//   dq: a block per 64-query tile writes delta for its rows, then walks the
//     key tiles: s, dp, ds and dq += ds k (three products);
//   dk/dv: a block per 64-key tile walks the query tiles: s^T = k q^T,
//     dp^T = v do^T, dv += p^T do and dk += ds^T q (four products); at
//     the tile width 128, two blocks per key tile, each with half
//     the channels of dk and dv (so that the accumulators fit the
//     registers without spilling), each forming s and dp itself.
// The backward that recomputes the statistics takes nine.
//
// Scores never leave registers. Each of the 4 warps owns 16 rows of the
// tile; the products are mma.sync m16n8k16 (bf16 operands, f32
// accumulation), p and ds are formed on the f32 accumulator fragments, and
// those fragments, rounded to bf16, are the A operand of the next product
// (mma.cuh). The dk/dv kernel computes s^T and dp^T directly, so p^T and
// ds^T sit in the A position too. Operand tiles sit in shared memory as bf16
// [64][D + 8] (the pad puts the 8 rows an ldmatrix reads in 8 bank groups,
// D = 80 included), double buffered: cp.async brings the next key (or
// query) tile while the tensor cores work on the current one. An f32 call
// multiplies bf16 operands as well, its tiles converted through registers.
// The exponentials run in base 2 on s * scale * log2(e) + bias * log2(e).
#pragma once

#include "attention_common.cuh"

namespace {

template <int D>
struct DqSmem {
  static constexpr int TILE = tile_bytes<D>();
  static constexpr int Q = 0, DO = TILE, K = 2 * TILE, V = 4 * TILE;  // K, V: two stages
  static constexpr int BIAS = 6 * TILE;  // f32 [2][BK], base 2
  static constexpr int BYTES = BIAS + 2 * BK * 4;
};

template <int D>
struct DkvSmem {
  static constexpr int TILE = tile_bytes<D>();
  static constexpr int K = 0, V = TILE, Q = 2 * TILE, DO = 4 * TILE;  // Q, DO: two stages
  static constexpr int ROW = 6 * TILE;  // f32 [2][3][BQ]: m log2(e), r, delta per query
  static constexpr int BYTES = ROW + 2 * 3 * BQ * 4;
};

// sum of a[i] b[i] over 8 values, in order (16-byte aligned)
__device__ __forceinline__ float dot8(const bf16* a, const bf16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xp[i]), w = __bfloat1622float2(yp[i]);
    s += u.x * w.x;
    s += u.y * w.y;
  }
  return s;
}
__device__ __forceinline__ float dot8(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += a[i] * b[i];
  return s;
}

// dq of the 64 queries from q0 of head h of sample b; also writes delta
// [B, H, N] for them.
template <typename T, int D, bool VEC>
__device__ __forceinline__ void attn_bwd_dq_body(
    const T* q, const T* k, const T* v, int ld, const T* out, const T* dout, int ldo,
    const float* stats, float* delta, const uint8_t* key_valid, T* dq, int ldg, int b, int h,
    int q0, int N, int H, int dh, float scale) {
  using SM = DqSmem<D>;
  constexpr int LDT = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::Q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + SM::DO);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::V);
  float* Bs = reinterpret_cast<float*>(smem + SM::BIAS);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int col = h * dh, nk = (N + BK - 1) / BK;
  const float sl2 = scale * LOG2E;

  // group 0: q, do and key tile 0; group 1: key tile 1
  stage_tile<T, D, VEC>(Qs, q, q0, N, ld, col, dh, tid);
  stage_tile<T, D, VEC>(DOs, dout, q0, N, ldo, col, dh, tid);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < nk) {
      stage_tile<T, D, VEC>(Ks + j * BK * LDT, k, j * BK, N, ld, col, dh, tid);
      stage_tile<T, D, VEC>(Vs + j * BK * LDT, v, j * BK, N, ld, col, dh, tid);
      if (tid < BK) Bs[j * BK + tid] = key_bias(key_valid, b, N, j * BK + tid) * LOG2E;
    }
    cp_async_commit();
  }

  // delta, m and r of row wr + lane / 2 (two lanes a row, half the channels
  // each); rows past N get zeros, so their p is 0
  float dl = 0.f, ml = 0.f, rl = 0.f;
  {
    const int n = q0 + wr + (lane >> 1);
    const size_t i = ((size_t)b * H + h) * N + n;
    if (n < N) {
      const T* o = out + (size_t)n * ldo + col;
      const T* g = dout + (size_t)n * ldo + col;
      if constexpr (VEC) {
        for (int c = (lane & 1) * 8; c < dh; c += 16) dl += dot8(o + c, g + c);
      } else {
        for (int c = lane & 1; c < dh; c += 2) dl += to_f32(o[c]) * to_f32(g[c]);
      }
      ml = stats[2 * i] * LOG2E;
      rl = stats[2 * i + 1];
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (n < N && (lane & 1) == 0) delta[i] = dl;
  }
  // this thread's fragment rows wr + g and wr + g + 8 were lanes 2 g, 2 g + 16
  const int src0 = 2 * (lane >> 2), src1 = src0 + 16;
  const float m0 = __shfl_sync(0xffffffffu, ml, src0), m1 = __shfl_sync(0xffffffffu, ml, src1);
  const float r0 = __shfl_sync(0xffffffffu, rl, src0), r1 = __shfl_sync(0xffffffffu, rl, src1);
  const float d0 = __shfl_sync(0xffffffffu, dl, src0), d1 = __shfl_sync(0xffffffffu, dl, src1);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<1>();  // key tile j has landed
    __syncthreads();
    const int st = j & 1;
    const bf16* Kt = Ks + st * BK * LDT;
    const bf16* Vt = Vs + st * BK * LDT;
    const float* bt = Bs + st * BK;
    float p[8][4], ds[8][4];
    warp_abt<D>(p, Qs, Kt, wr, lane);  // s = q k^T
#pragma unroll
    for (int f = 0; f < 8; ++f) {  // p = exp(s scale + bias - m) r
      const float2 kb = *reinterpret_cast<const float2*>(bt + 8 * f + 2 * (lane & 3));
      p[f][0] = exp2f(fmaf(p[f][0], sl2, kb.x) - m0) * r0;
      p[f][1] = exp2f(fmaf(p[f][1], sl2, kb.y) - m0) * r0;
      p[f][2] = exp2f(fmaf(p[f][2], sl2, kb.x) - m1) * r1;
      p[f][3] = exp2f(fmaf(p[f][3], sl2, kb.y) - m1) * r1;
    }
    warp_abt<D>(ds, DOs, Vt, wr, lane);  // dp = do v^T
#pragma unroll
    for (int f = 0; f < 8; ++f) {  // ds = p (dp - delta)
      ds[f][0] = p[f][0] * (ds[f][0] - d0);
      ds[f][1] = p[f][1] * (ds[f][1] - d0);
      ds[f][2] = p[f][2] * (ds[f][2] - d1);
      ds[f][3] = p[f][3] * (ds[f][3] - d1);
    }
    warp_pm<D>(acc, ds, Kt, lane);  // dq += ds k
    __syncthreads();                // every warp is done with stage st
    if (j + 2 < nk) {
      stage_tile<T, D, VEC>(Ks + st * BK * LDT, k, (j + 2) * BK, N, ld, col, dh, tid);
      stage_tile<T, D, VEC>(Vs + st * BK * LDT, v, (j + 2) * BK, N, ld, col, dh, tid);
      if (tid < BK) Bs[st * BK + tid] = key_bias(key_valid, b, N, (j + 2) * BK + tid) * LOG2E;
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<T, D>(dq, acc, scale, q0 + wr, N, ldg, col, dh, lane);
}

// dk and dv of the 64 keys from k0 of head h of sample b, from the row
// statistics and the delta the dq kernel wrote: their DO channels from c0
// (DO = D, or D / 2 where the two [64, D] accumulators would not fit the
// registers: two blocks then share a key tile, each computing s and dp).
template <int D>
__host__ __device__ constexpr int dkdv_width() { return D == 128 ? D / 2 : D; }

template <typename T, int D, bool VEC>
__device__ __forceinline__ void attn_bwd_dkdv_body(
    const T* q, const T* k, const T* v, int ld, const T* dout, int ldo, const float* stats,
    const float* delta, const uint8_t* key_valid, T* dk, T* dv, int ldg, int b, int h, int k0,
    int c0, int N, int H, int dh, float scale) {
  constexpr int DO = dkdv_width<D>();
  using SM = DkvSmem<D>;
  constexpr int LDT = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::V);
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::Q);
  bf16* DOs = reinterpret_cast<bf16*>(smem + SM::DO);
  float* Rw = reinterpret_cast<float*>(smem + SM::ROW);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int col = h * dh, nq = (N + BQ - 1) / BQ;
  const float sl2 = scale * LOG2E;
  const size_t row_base = ((size_t)b * H + h) * N;

  // group 0: k, v and query tile 0; group 1: query tile 1
  stage_tile<T, D, VEC>(Ks, k, k0, N, ld, col, dh, tid);
  stage_tile<T, D, VEC>(Vs, v, k0, N, ld, col, dh, tid);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < nq) {
      stage_tile<T, D, VEC>(Qs + i * BQ * LDT, q, i * BQ, N, ld, col, dh, tid);
      stage_tile<T, D, VEC>(DOs + i * BQ * LDT, dout, i * BQ, N, ldo, col, dh, tid);
      if (tid < BQ) {
        const int n = i * BQ + tid;
        float* rw = Rw + i * 3 * BQ;
        rw[tid] = n < N ? stats[2 * (row_base + n)] * LOG2E : 0.f;
        rw[BQ + tid] = n < N ? stats[2 * (row_base + n) + 1] : 0.f;
        rw[2 * BQ + tid] = n < N ? delta[row_base + n] : 0.f;
      }
    }
    cp_async_commit();
  }
  // the bias of this thread's fragment rows (keys k0 + wr + g and + 8)
  const float kb0 = key_bias(key_valid, b, N, k0 + wr + (lane >> 2)) * LOG2E;
  const float kb1 = key_bias(key_valid, b, N, k0 + wr + (lane >> 2) + 8) * LOG2E;

  float gk[DO / 8][4], gv[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  for (int i = 0; i < nq; ++i) {
    cp_async_wait<1>();  // query tile i has landed
    __syncthreads();
    const int st = i & 1;
    const bf16* Qt = Qs + st * BQ * LDT;
    const bf16* DOt = DOs + st * BQ * LDT;
    const float* rw = Rw + st * 3 * BQ;
    float p[8][4], ds[8][4];
    warp_abt<D>(p, Ks, Qt, wr, lane);  // s^T = k q^T: rows keys, columns queries
#pragma unroll
    for (int f = 0; f < 8; ++f) {  // p^T = exp(s scale + bias - m) r
      const int c = 8 * f + 2 * (lane & 3);
      const float2 m = *reinterpret_cast<const float2*>(rw + c);
      const float2 r = *reinterpret_cast<const float2*>(rw + BQ + c);
      p[f][0] = exp2f(fmaf(p[f][0], sl2, kb0) - m.x) * r.x;
      p[f][1] = exp2f(fmaf(p[f][1], sl2, kb0) - m.y) * r.y;
      p[f][2] = exp2f(fmaf(p[f][2], sl2, kb1) - m.x) * r.x;
      p[f][3] = exp2f(fmaf(p[f][3], sl2, kb1) - m.y) * r.y;
    }
    warp_abt<D>(ds, Vs, DOt, wr, lane);  // dp^T = v do^T
#pragma unroll
    for (int f = 0; f < 8; ++f) {  // ds^T = p^T (dp^T - delta)
      const float2 dl = *reinterpret_cast<const float2*>(rw + 2 * BQ + 8 * f + 2 * (lane & 3));
      ds[f][0] = p[f][0] * (ds[f][0] - dl.x);
      ds[f][1] = p[f][1] * (ds[f][1] - dl.y);
      ds[f][2] = p[f][2] * (ds[f][2] - dl.x);
      ds[f][3] = p[f][3] * (ds[f][3] - dl.y);
    }
    warp_pm<DO, LDT>(gv, p, DOt + c0, lane);  // dv += p^T do
    warp_pm<DO, LDT>(gk, ds, Qt + c0, lane);  // dk += ds^T q
    __syncthreads();               // every warp is done with stage st
    if (i + 2 < nq) {
      const int n0 = (i + 2) * BQ;
      stage_tile<T, D, VEC>(Qs + st * BQ * LDT, q, n0, N, ld, col, dh, tid);
      stage_tile<T, D, VEC>(DOs + st * BQ * LDT, dout, n0, N, ldo, col, dh, tid);
      if (tid < BQ) {
        const int n = n0 + tid;
        float* rws = Rw + st * 3 * BQ;
        rws[tid] = n < N ? stats[2 * (row_base + n)] * LOG2E : 0.f;
        rws[BQ + tid] = n < N ? stats[2 * (row_base + n) + 1] : 0.f;
        rws[2 * BQ + tid] = n < N ? delta[row_base + n] : 0.f;
      }
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  const int dho = min(dh - c0, DO);  // this block's channels of the head
  store_rows<T, DO>(dk, gk, scale, k0 + wr, N, ldg, col + c0, dho, lane);
  store_rows<T, DO>(dv, gv, 1.f, k0 + wr, N, ldg, col + c0, dho, lane);
}

}  // namespace
