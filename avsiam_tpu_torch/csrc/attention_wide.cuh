// Head-major attention at head widths above 128: the bodies of K5's and
// K6's wide path (attention_hm.cu), sm_90a.
//
// The narrow bodies (attention_fwd.cuh, attention_bwd.cuh) hold a head's
// whole width in one tile and their accumulators in registers, which caps
// the tile at 128 channels. Here the head's channels are cut two ways:
//   - every product over the head width (s = q k^T, dp = do v^T) runs in
//     chunks of WC = 64 channels, each chunk of both operands staged through
//     shared memory in turn and accumulated into the same f32 fragments, so
//     any width fits the same shared memory;
//   - the outputs (o, dq, dk, dv) are cut into slices on a grid axis: a
//     block writes only its own slice of WS_FWD (o), WS_DQ (dq) or WS_DKDV
//     (dk, dv) channels, and forms the full scores itself. Every block of a tile
//     computes the same s, dp, row max and row sum, with the same
//     instructions in the same order, so the slices agree bit for bit.
// One owner per output element, a fixed summation order and no atomics, as
// in the narrow bodies. The row statistics (m, 1 / l) and delta are written
// by slice 0 alone. The statistics keep the narrow forward's contract
// (attention_fwd.cuh): m in natural units as max(fmaf(s, scale, bias)),
// -1e30 exactly for a sample whose keys are all masked, and p =
// exp2(fmaf(s, scale log2e, bias log2e) - m log2e), the expression the
// backward bodies use.
//
// Simple first: each chunk is staged (cp.async for 16-byte rows, else
// through registers) and waited for before its products, with no ring, and
// the query rows (forward, dq) or key rows (dk/dv) are staged again for
// every tile of the walk. The dk/dv accumulators of a 64-channel slice take
// what the narrow 128 tile's split takes (attention_bwd.cuh). The forward's
// slice is 64 channels too: at 128, its 16-byte-row form spilled 8 bytes
// (168 registers). Shared memory: 28 KB (forward), 54 KB (dq), 56 KB
// (dk/dv), whatever the width.
#pragma once

#include "attention_bwd.cuh"  // attention_common.cuh, dot8

namespace {

constexpr int WC = 64;        // channels of a staged chunk of s or dp
constexpr int WS_FWD = 64;    // o channels per block
constexpr int WS_DQ = 128;    // dq channels per block
constexpr int WS_DKDV = 64;   // dk and dv channels per block

__host__ __device__ constexpr int wide_slices(int dh, int ws) { return (dh + ws - 1) / ws; }

struct WideFwdSmem {
  static constexpr int QC = 0, KC = tile_bytes<WC>();
  static constexpr int V = 2 * tile_bytes<WC>();  // the slice of v
  static constexpr int BIAS = V + tile_bytes<WS_FWD>();  // f32 [2][BK]
  static constexpr int BYTES = BIAS + 2 * BK * 4;
};

struct WideDqSmem {
  static constexpr int QC = 0, DOC = tile_bytes<WC>(), KC = 2 * tile_bytes<WC>(),
                       VC = 3 * tile_bytes<WC>();
  static constexpr int KS = 4 * tile_bytes<WC>();  // the slice of k
  static constexpr int BIAS = KS + tile_bytes<WS_DQ>();  // f32 [BK], base 2
  static constexpr int BYTES = BIAS + BK * 4;
};

struct WideDkvSmem {
  static constexpr int KC = 0, VC = tile_bytes<WC>(), QC = 2 * tile_bytes<WC>(),
                       DOC = 3 * tile_bytes<WC>();
  static constexpr int QS = 4 * tile_bytes<WC>();  // the slices of q and do
  static constexpr int DOS = QS + tile_bytes<WS_DKDV>();
  static constexpr int ROW = DOS + tile_bytes<WS_DKDV>();  // f32 [3][BQ]
  static constexpr int BYTES = ROW + 3 * BQ * 4;
};

// Wait for the staged tiles and make them visible to every warp.
__device__ __forceinline__ void staged() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Channels [c0, c0 + WC) of the head (those below dh) of rows row0 .. + 64
// into a bf16 chunk [64][WC + 8].
template <typename T, bool VEC>
__device__ __forceinline__ void stage_chunk(bf16* dst, const T* src, int row0, int N, int ld,
                                            int col, int c0, int dh, int tid) {
  stage_tile<T, WC, VEC>(dst, src, row0, N, ld, col + c0, min(WC, dh - c0), tid);
}

// c += A[wr : wr + 16] . B[0 : 64]^T over the WC channels of two chunks.
__device__ __forceinline__ void chunk_abt(float (&c)[8][4], const bf16* A, const bf16* B,
                                          int wr, int lane) {
#pragma unroll
  for (int kd = 0; kd < WC; kd += 16) {
    uint32_t a[4];
    ldsm_x4(a, A + (wr + (lane & 15)) * (WC + 8) + kd + ((lane >> 4) << 3));
    abt_step<WC>(c, a, B, kd, lane);
  }
}

// The forward of the 64 queries from q0 of head h (dh > 128 channels) of
// sample b: output channels [s0, s0 + WS_FWD) of the head to rows `ldo`
// apart; slice 0 also writes each row's (m, 1 / l) to stats[b, h, n, 0:2].
template <typename T, bool VEC>
__device__ __forceinline__ void attn_wide_fwd_body(const T* q, const T* k, const T* v, int ld,
                                                   const uint8_t* key_valid, T* out, int ldo,
                                                   float* stats, int b, int h, int q0, int s0,
                                                   int N, int H, int dh, float scale) {
  using SM = WideFwdSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qc = reinterpret_cast<bf16*>(smem + SM::QC);
  bf16* Kc = reinterpret_cast<bf16*>(smem + SM::KC);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::V);
  float* Bs = reinterpret_cast<float*>(smem + SM::BIAS);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int col = h * dh, nk = (N + BK - 1) / BK;
  const float sl2 = scale * LOG2E;

  float o[WS_FWD / 8][4];
#pragma unroll
  for (int j = 0; j < WS_FWD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8, natural units
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  for (int j = 0; j < nk; ++j) {
    float p[8][4];
    zero_frags(p);
    for (int c0 = 0; c0 < dh; c0 += WC) {  // s = q k^T, a chunk at a time
      __syncthreads();                     // every warp is done with the chunks
      stage_chunk<T, VEC>(Qc, q, q0, N, ld, col, c0, dh, tid);
      stage_chunk<T, VEC>(Kc, k, j * BK, N, ld, col, c0, dh, tid);
      if (c0 == 0 && tid < BK) {
        const float kb = key_bias(key_valid, b, N, j * BK + tid);
        Bs[tid] = kb;
        Bs[BK + tid] = __fmul_rn(kb, LOG2E);
      }
      staged();
      chunk_abt(p, Qc, Kc, wr, lane);
    }
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float2 kb = *reinterpret_cast<const float2*>(Bs + 8 * f + 2 * (lane & 3));
      t0 = fmaxf(t0, fmaxf(fmaf(p[f][0], scale, kb.x), fmaf(p[f][1], scale, kb.y)));
      t1 = fmaxf(t1, fmaxf(fmaf(p[f][2], scale, kb.x), fmaf(p[f][3], scale, kb.y)));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {  // over the quad that shares the rows
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, x));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, x));
    }
    const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
    const float b0 = __fmul_rn(n0, LOG2E), b1 = __fmul_rn(n1, LOG2E);
    const float a0 = exp2_ftz(__fmul_rn(m0, LOG2E) - b0);
    const float a1 = exp2_ftz(__fmul_rn(m1, LOG2E) - b1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int d = 0; d < WS_FWD / 8; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }
#pragma unroll
    for (int f = 0; f < 8; ++f) {  // p = exp(s scale + bias - m), K6's expression
      const float2 k2 = *reinterpret_cast<const float2*>(Bs + BK + 8 * f + 2 * (lane & 3));
      p[f][0] = exp2_ftz(fmaf(p[f][0], sl2, k2.x) - b0);
      p[f][1] = exp2_ftz(fmaf(p[f][1], sl2, k2.y) - b0);
      p[f][2] = exp2_ftz(fmaf(p[f][2], sl2, k2.x) - b1);
      p[f][3] = exp2_ftz(fmaf(p[f][3], sl2, k2.y) - b1);
      l0 += p[f][0] + p[f][1];
      l1 += p[f][2] + p[f][3];
    }
    // the last chunk loop's barrier saw every warp done with the slice
    stage_tile<T, WS_FWD, VEC>(Vs, v, j * BK, N, ld, col + s0, min(WS_FWD, dh - s0), tid);
    staged();
    warp_pm<WS_FWD>(o, p, Vs, lane);  // o += p v, this block's channels
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int d = 0; d < WS_FWD / 8; ++d) {
    o[d][0] *= i0;
    o[d][1] *= i0;
    o[d][2] *= i1;
    o[d][3] *= i1;
  }
  store_rows<T, WS_FWD>(out, o, 1.f, q0 + wr, N, ldo, col + s0, min(WS_FWD, dh - s0), lane);
  if (s0 == 0 && stats != nullptr && (lane & 3) == 0) {
    const int n = q0 + wr + (lane >> 2);
    float* st = stats + (((size_t)b * H + h) * N + n) * 2;
    if (n < N) *reinterpret_cast<float2*>(st) = make_float2(m0, i0);
    if (n + 8 < N) *reinterpret_cast<float2*>(st + 16) = make_float2(m1, i1);
  }
}

// dq channels [s0, s0 + WS_DQ) of the 64 queries from q0 of head h of
// sample b; slice 0 also writes delta [B, H, N] for them.
template <typename T, bool VEC>
__device__ __forceinline__ void attn_wide_dq_body(
    const T* q, const T* k, const T* v, int ld, const T* out, const T* dout, int ldo,
    const float* stats, float* delta, const uint8_t* key_valid, T* dq, int ldg, int b, int h,
    int q0, int s0, int N, int H, int dh, float scale) {
  using SM = WideDqSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qc = reinterpret_cast<bf16*>(smem + SM::QC);
  bf16* DOc = reinterpret_cast<bf16*>(smem + SM::DOC);
  bf16* Kc = reinterpret_cast<bf16*>(smem + SM::KC);
  bf16* Vc = reinterpret_cast<bf16*>(smem + SM::VC);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::KS);
  float* Bs = reinterpret_cast<float*>(smem + SM::BIAS);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int col = h * dh, nk = (N + BK - 1) / BK;
  const float sl2 = scale * LOG2E;

  // delta, m and r of row wr + lane / 2 over the whole head (two lanes a
  // row), as the narrow dq body forms them; rows past N get zeros
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
    if (s0 == 0 && n < N && (lane & 1) == 0) delta[i] = dl;
  }
  const int src0 = 2 * (lane >> 2), src1 = src0 + 16;
  const float m0 = __shfl_sync(0xffffffffu, ml, src0), m1 = __shfl_sync(0xffffffffu, ml, src1);
  const float r0 = __shfl_sync(0xffffffffu, rl, src0), r1 = __shfl_sync(0xffffffffu, rl, src1);
  const float d0 = __shfl_sync(0xffffffffu, dl, src0), d1 = __shfl_sync(0xffffffffu, dl, src1);

  float acc[WS_DQ / 8][4];
#pragma unroll
  for (int j = 0; j < WS_DQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    float p[8][4], ds[8][4];
    zero_frags(p);
    zero_frags(ds);
    for (int c0 = 0; c0 < dh; c0 += WC) {  // s = q k^T and dp = do v^T
      __syncthreads();
      stage_chunk<T, VEC>(Qc, q, q0, N, ld, col, c0, dh, tid);
      stage_chunk<T, VEC>(DOc, dout, q0, N, ldo, col, c0, dh, tid);
      stage_chunk<T, VEC>(Kc, k, j * BK, N, ld, col, c0, dh, tid);
      stage_chunk<T, VEC>(Vc, v, j * BK, N, ld, col, c0, dh, tid);
      if (c0 == 0 && tid < BK) Bs[tid] = key_bias(key_valid, b, N, j * BK + tid) * LOG2E;
      staged();
      chunk_abt(p, Qc, Kc, wr, lane);
      chunk_abt(ds, DOc, Vc, wr, lane);
    }
#pragma unroll
    for (int f = 0; f < 8; ++f) {  // p = exp(s scale + bias - m) r; ds = p (dp - delta)
      const float2 kb = *reinterpret_cast<const float2*>(Bs + 8 * f + 2 * (lane & 3));
      p[f][0] = exp2f(fmaf(p[f][0], sl2, kb.x) - m0) * r0;
      p[f][1] = exp2f(fmaf(p[f][1], sl2, kb.y) - m0) * r0;
      p[f][2] = exp2f(fmaf(p[f][2], sl2, kb.x) - m1) * r1;
      p[f][3] = exp2f(fmaf(p[f][3], sl2, kb.y) - m1) * r1;
      ds[f][0] = p[f][0] * (ds[f][0] - d0);
      ds[f][1] = p[f][1] * (ds[f][1] - d0);
      ds[f][2] = p[f][2] * (ds[f][2] - d1);
      ds[f][3] = p[f][3] * (ds[f][3] - d1);
    }
    stage_tile<T, WS_DQ, VEC>(Ks, k, j * BK, N, ld, col + s0, min(WS_DQ, dh - s0), tid);
    staged();
    warp_pm<WS_DQ>(acc, ds, Ks, lane);  // dq += ds k, this block's channels
  }
  store_rows<T, WS_DQ>(dq, acc, scale, q0 + wr, N, ldg, col + s0, min(WS_DQ, dh - s0), lane);
}

// dk and dv channels [s0, s0 + WS_DKDV) of the 64 keys from k0 of head h of
// sample b, from the row statistics and the delta the dq kernel wrote.
template <typename T, bool VEC>
__device__ __forceinline__ void attn_wide_dkdv_body(
    const T* q, const T* k, const T* v, int ld, const T* dout, int ldo, const float* stats,
    const float* delta, const uint8_t* key_valid, T* dk, T* dv, int ldg, int b, int h, int k0,
    int s0, int N, int H, int dh, float scale) {
  using SM = WideDkvSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kc = reinterpret_cast<bf16*>(smem + SM::KC);
  bf16* Vc = reinterpret_cast<bf16*>(smem + SM::VC);
  bf16* Qc = reinterpret_cast<bf16*>(smem + SM::QC);
  bf16* DOc = reinterpret_cast<bf16*>(smem + SM::DOC);
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::QS);
  bf16* DOs = reinterpret_cast<bf16*>(smem + SM::DOS);
  float* Rw = reinterpret_cast<float*>(smem + SM::ROW);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int col = h * dh, nq = (N + BQ - 1) / BQ, ws = min(WS_DKDV, dh - s0);
  const float sl2 = scale * LOG2E;
  const size_t row_base = ((size_t)b * H + h) * N;
  const float kb0 = key_bias(key_valid, b, N, k0 + wr + (lane >> 2)) * LOG2E;
  const float kb1 = key_bias(key_valid, b, N, k0 + wr + (lane >> 2) + 8) * LOG2E;

  float gk[WS_DKDV / 8][4], gv[WS_DKDV / 8][4];
#pragma unroll
  for (int j = 0; j < WS_DKDV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;

  for (int i = 0; i < nq; ++i) {
    float p[8][4], ds[8][4];
    zero_frags(p);
    zero_frags(ds);
    for (int c0 = 0; c0 < dh; c0 += WC) {  // s^T = k q^T and dp^T = v do^T
      __syncthreads();
      stage_chunk<T, VEC>(Kc, k, k0, N, ld, col, c0, dh, tid);
      stage_chunk<T, VEC>(Vc, v, k0, N, ld, col, c0, dh, tid);
      stage_chunk<T, VEC>(Qc, q, i * BQ, N, ld, col, c0, dh, tid);
      stage_chunk<T, VEC>(DOc, dout, i * BQ, N, ldo, col, c0, dh, tid);
      if (c0 == 0 && tid < BQ) {
        const int n = i * BQ + tid;
        Rw[tid] = n < N ? stats[2 * (row_base + n)] * LOG2E : 0.f;
        Rw[BQ + tid] = n < N ? stats[2 * (row_base + n) + 1] : 0.f;
        Rw[2 * BQ + tid] = n < N ? delta[row_base + n] : 0.f;
      }
      staged();
      chunk_abt(p, Kc, Qc, wr, lane);
      chunk_abt(ds, Vc, DOc, wr, lane);
    }
#pragma unroll
    for (int f = 0; f < 8; ++f) {  // p^T and ds^T = p^T (dp^T - delta)
      const int c = 8 * f + 2 * (lane & 3);
      const float2 m = *reinterpret_cast<const float2*>(Rw + c);
      const float2 r = *reinterpret_cast<const float2*>(Rw + BQ + c);
      const float2 dl = *reinterpret_cast<const float2*>(Rw + 2 * BQ + c);
      p[f][0] = exp2f(fmaf(p[f][0], sl2, kb0) - m.x) * r.x;
      p[f][1] = exp2f(fmaf(p[f][1], sl2, kb0) - m.y) * r.y;
      p[f][2] = exp2f(fmaf(p[f][2], sl2, kb1) - m.x) * r.x;
      p[f][3] = exp2f(fmaf(p[f][3], sl2, kb1) - m.y) * r.y;
      ds[f][0] = p[f][0] * (ds[f][0] - dl.x);
      ds[f][1] = p[f][1] * (ds[f][1] - dl.y);
      ds[f][2] = p[f][2] * (ds[f][2] - dl.x);
      ds[f][3] = p[f][3] * (ds[f][3] - dl.y);
    }
    stage_tile<T, WS_DKDV, VEC>(Qs, q, i * BQ, N, ld, col + s0, ws, tid);
    stage_tile<T, WS_DKDV, VEC>(DOs, dout, i * BQ, N, ldo, col + s0, ws, tid);
    staged();
    warp_pm<WS_DKDV>(gv, p, DOs, lane);   // dv += p^T do
    warp_pm<WS_DKDV>(gk, ds, Qs, lane);   // dk += ds^T q
  }
  store_rows<T, WS_DKDV>(dk, gk, scale, k0 + wr, N, ldg, col + s0, ws, lane);
  store_rows<T, WS_DKDV>(dv, gv, 1.f, k0 + wr, N, ldg, col + s0, ws, lane);
}

}  // namespace
