// The attention forward body of K1 (attention.cu, token-major) and K5
// (attention_hm.cu, head-major), sm_90a. The two kernels differ only in
// where q, k and v live; both call attn_fwd_body.
//
// Per (sample, head) and for the 64 queries from q0: o = softmax(s * scale +
// bias) v, s = q k^T, with the row statistics stats[b, h, n] = (m, 1 / l):
// m the row's max of s * scale + bias in natural units, l = rowsum(exp(s *
// scale + bias - m)).
//
// What bounds it on the H100: at the step's shapes a call's products are
// 0.04-8 GFLOP and its bytes a few MB, a bound of 0.3-8 us. The grids are
// 48-384 blocks at every shape but the decoder's, so one block walks its key
// tiles alone on its SM and the time is the latency of that walk; the
// decoder's 1,536 blocks are throughput-bound, where the softmax's
// instructions per score weigh more than the tensor cores' share.
//
// One block per (64-query tile, head, sample), 4 warps of 16 query rows.
// The warp's q rows are loaded once and held as A fragments for the whole
// walk over the key tiles. K, V and the key bias come through a two-stage
// cp.async ring: tile j + 2 is issued as soon as every warp is done with
// tile j, so a tile is in flight during the products of the one before it,
// with one __syncthreads per tile. Scores, probabilities and the output
// accumulator never leave registers: s = q k^T is eight m16n8 C fragments
// per warp (warp_abt), the online softmax runs on them (each thread owns
// rows g and g + 8 of its warp's 16, 16 values of each per tile: the row max
// over those, then over the quad by two shuffles), p is rounded to bf16 in
// pairs as soon as it is formed and fed as the A operand of o += p v
// (warp_pm), and o, D / 8 C fragments, is rescaled by alpha per row. Row
// sums stay per thread until the walk ends, then are added over the quad.
// Rows past N are computed and not written. The exponentials are single
// special-function instructions (exp2_ftz: a p below 2^-126 is 0), and a
// tile with no bias takes its max over the raw scores. Shared memory: q and
// two stages of k and v, bf16 [64][D + 8], plus the bias in natural units
// and times log2e (staged twice, so that neither form is held in registers
// across the softmax): 46 KB at D = 64, 56 KB at D = 80. An f32 call stages
// its tiles through registers and multiplies bf16 operands as well.
//
// The statistics are a contract with the backward bodies that K2 and K6
// share (attention_bwd.cuh), which compute p = exp2(fmaf(s, scale log2e,
// bias log2e) - m log2e) r. So m must be the natural-unit max, and for a
// sample whose keys are all masked it must be exactly -1e30 (the bias), or
// the backward would raise exp2 of a residue of order 1e23. This body
// computes p with the same expression, so the forward's and the backward's
// p are one formula, and tracks the max in natural units
// as max(fmaf(s, scale, bias)). For an all-masked row every key's value is
// fmaf(s, scale, -1e30) = -1e30 exactly (|s scale| is far below half an ulp
// of 1e30), so m = -1e30; its base-2 form m log2e is the same f32 product as
// the keys' bias log2e, so each exponent is exactly 0, p = 1, l = N and o
// is the mean of v. A max tracked in base 2 and saved as m2 / log2e would
// not round back to -1e30, and an exponent formed as fmaf(x, log2e, -m
// log2e) would leave the residue. Keys past N have bias -inf and p = 0;
// key 0 is always a key, so m is finite after the first tile and alpha =
// exp2(m_old log2e - m_new log2e) is 0 there (m_old = -inf), never NaN.
#pragma once

#include "attention_common.cuh"

namespace {

template <int D>
struct FwdRing {
  static constexpr int TILE = tile_bytes<D>();
  static constexpr int Q = 0, K = TILE, V = 3 * TILE;  // K, V: two stages
  static constexpr int BIAS = 5 * TILE;  // f32 [2][2][BK]: natural units, times log2e
  static constexpr int BYTES = BIAS + 4 * BK * 4;
};

// Issue key tile j (k, v and the bias, natural and times log2e) into ring
// stage j % 2.
template <typename T, int D, bool VEC>
__device__ __forceinline__ void fwd_stage_keys(bf16* Ks, bf16* Vs, float* Bs, const T* k,
                                               const T* v, int ld, const uint8_t* key_valid,
                                               int b, int j, int N, int col, int dh, int tid) {
  const int st = j & 1;
  stage_tile<T, D, VEC>(Ks + st * BK * (D + 8), k, j * BK, N, ld, col, dh, tid);
  stage_tile<T, D, VEC>(Vs + st * BK * (D + 8), v, j * BK, N, ld, col, dh, tid);
  if (tid < BK) {
    const float kb = key_bias(key_valid, b, N, j * BK + tid);
    Bs[2 * st * BK + tid] = kb;
    Bs[(2 * st + 1) * BK + tid] = __fmul_rn(kb, LOG2E);
  }
}

// The forward of the 64 queries from q0 of head h (dh channels, dh <= D) of
// sample b: the output to rows `ldo` elements apart from the sample's first
// output row (channels from h dh), and, if stats is not null, each row's
// (m, 1 / l) to stats[b, h, n, 0:2].
template <typename T, int D, bool VEC>
__device__ __forceinline__ void attn_fwd_body(const T* q, const T* k, const T* v, int ld,
                                              const uint8_t* key_valid, T* out, int ldo,
                                              float* stats, int b, int h, int q0, int N, int H,
                                              int dh, float scale) {
  using SM = FwdRing<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::V);
  float* Bs = reinterpret_cast<float*>(smem + SM::BIAS);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int col = h * dh, nk = (N + BK - 1) / BK;
  const float sl2 = scale * LOG2E;

  // group 0: q and key tile 0; group 1: key tile 1
  stage_tile<T, D, VEC>(Qs, q, q0, N, ld, col, dh, tid);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < nk) fwd_stage_keys<T, D, VEC>(Ks, Vs, Bs, k, v, ld, key_valid, b, j, N, col, dh, tid);
    cp_async_commit();
  }
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_a<D>(qa, Qs, wr, lane);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8, natural units
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<1>();  // key tile j has landed
    __syncthreads();
    const int st = j & 1;
    const bf16* Kt = Ks + st * BK * (D + 8);
    const bf16* Vt = Vs + st * BK * (D + 8);
    const float* bt = Bs + 2 * st * BK;
    float p[8][4];
    warp_abt<D>(p, qa, Kt, lane);  // s = q k^T
    // A tile of keys all below N and none masked has bias 0 (every tile but
    // the last when no key_valid is given): the max of fmaf(s, scale, 0) is
    // the max of s times scale, rounding being monotone.
    const bool unbiased = key_valid == nullptr && (j + 1) * BK <= N;
    float t0 = -INFINITY, t1 = -INFINITY;
    if (unbiased) {
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        t0 = fmaxf(t0, fmaxf(p[f][0], p[f][1]));
        t1 = fmaxf(t1, fmaxf(p[f][2], p[f][3]));
      }
    } else {
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const float2 kb = *reinterpret_cast<const float2*>(bt + 8 * f + 2 * (lane & 3));
        t0 = fmaxf(t0, fmaxf(fmaf(p[f][0], scale, kb.x), fmaf(p[f][1], scale, kb.y)));
        t1 = fmaxf(t1, fmaxf(fmaf(p[f][2], scale, kb.x), fmaf(p[f][3], scale, kb.y)));
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {  // over the quad that shares the rows
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, x));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, x));
    }
    if (unbiased) {
      t0 = __fmul_rn(t0, scale);
      t1 = __fmul_rn(t1, scale);
    }
    const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
    // the products by log2e are rounded on their own (__fmul_rn is never
    // contracted into an FMA): m log2e - m log2e must be exactly 0
    const float b0 = __fmul_rn(n0, LOG2E), b1 = __fmul_rn(n1, LOG2E);
    const float a0 = exp2_ftz(__fmul_rn(m0, LOG2E) - b0);
    const float a1 = exp2_ftz(__fmul_rn(m1, LOG2E) - b1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }
    uint32_t pa[4][4];  // p rounded to bf16, the A operand of o += p v
#pragma unroll
    for (int f = 0; f < 8; ++f) {  // p = exp(s scale + bias - m), K6's expression
      const float2 k2 = unbiased ? make_float2(0.f, 0.f)
                                 : *reinterpret_cast<const float2*>(bt + BK + 8 * f + 2 * (lane & 3));
      p[f][0] = exp2_ftz(fmaf(p[f][0], sl2, k2.x) - b0);
      p[f][1] = exp2_ftz(fmaf(p[f][1], sl2, k2.y) - b0);
      p[f][2] = exp2_ftz(fmaf(p[f][2], sl2, k2.x) - b1);
      p[f][3] = exp2_ftz(fmaf(p[f][3], sl2, k2.y) - b1);
      l0 += p[f][0] + p[f][1];
      l1 += p[f][2] + p[f][3];
      if (f & 1) pack_a(pa[f / 2], p[f - 1], p[f]);
    }
    warp_pm<D>(o, pa, Vt, lane);  // o += p v
    __syncthreads();             // every warp is done with stage st
    if (j + 2 < nk)
      fwd_stage_keys<T, D, VEC>(Ks, Vs, Bs, k, v, ld, key_valid, b, j + 2, N, col, dh, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    o[d][0] *= i0;
    o[d][1] *= i0;
    o[d][2] *= i1;
    o[d][3] *= i1;
  }
  store_rows<T, D>(out, o, 1.f, q0 + wr, N, ldo, col, dh, lane);
  if (stats != nullptr && (lane & 3) == 0) {
    const int n = q0 + wr + (lane >> 2);
    float* st = stats + (((size_t)b * H + h) * N + n) * 2;
    if (n < N) *reinterpret_cast<float2*>(st) = make_float2(m0, i0);
    if (n + 8 < N) *reinterpret_cast<float2*>(st + 16) = make_float2(m1, i1);
  }
}

}  // namespace
