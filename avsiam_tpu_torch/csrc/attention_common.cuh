// What the attention bodies of both directions share (sm_90a): the tile
// geometry, the key bias, the staging of operand tiles into shared memory
// and the warp-level products on the tensor cores. The forward body
// (attention_fwd.cuh, K1 and K5) and the backward bodies
// (attention_bwd.cuh, K2 and K6) include it.
//
// A block owns a 64-row tile of queries or keys and 4 warps, each warp 16
// rows of it. q, k and v are read as rows `ld` elements apart from a
// sample's first row, the head's channels at [h dh, h dh + dh). The
// template width D is the tiles': a multiple of 16 from 16 to 128, the
// products' 16-deep steps; the head's width dh <= D is a run-time value,
// and the channels from dh up to D are zeros in shared memory (they add
// nothing to q k^T and give output columns that are not stored). Operand
// tiles sit in shared memory as bf16 [64][D + 8]: the pad puts the 8 rows
// an ldmatrix reads in 8 bank groups, D = 80 included. A tile is staged
// with 16-byte loads where its rows allow them (bf16, dh, ld and the first
// channel multiples of 8, the source 16-byte aligned), else value by
// value (the template flag VEC, which the launchers set from the dtype,
// the strides and the pointers). The products are
// mma.sync m16n8k16 with bf16 operands and f32 accumulation (mma.cuh); their
// results stay in registers as 16 x 8 C fragments, and those fragments,
// rounded to bf16 in pairs, are the A operand of the next product.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // key rows per tile
constexpr int WARPS = 4;     // each warp owns 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int tile_bytes() { return 64 * (D + 8) * 2; }

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The additive bias of key j of sample b, in natural units: -inf past the
// ragged end (not a key at all), -1e30 for a masked key (the JAX package's
// _bias_from_valid), 0 otherwise.
__device__ __forceinline__ float key_bias(const uint8_t* key_valid, int b, int N, int j) {
  if (j >= N) return -INFINITY;
  if (key_valid != nullptr && !key_valid[(size_t)b * N + j]) return -1e30f;
  return 0.f;
}

// Rows [row0, row0 + 64) of dh channels starting at column `col` of a
// row-major [N, ld] matrix, into a bf16 tile [64][D + 8]; rows past N and
// channels from dh on become zeros. VEC: the rows take 16-byte pieces (bf16,
// dh, ld and col multiples of 8, src 16-byte aligned), else value by value.
template <typename T, int D, bool VEC>
__device__ void load_tile(bf16* dst, const T* src, int row0, int N, int ld, int col, int dh,
                          int tid) {
  constexpr int LDB = D + 8;
  constexpr int PER_ROW = D / 8;
  for (int c = tid; c < 64 * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int d0 = (c % PER_ROW) * 8;
    const int n = row0 + r;
    bf16* out = dst + r * LDB + d0;
    if (n < N && d0 < dh) {
      const T* in = src + (size_t)n * ld + col + d0;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(in);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          out[i] = d0 + i < dh ? __float2bfloat16(to_f32(in[i])) : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(out) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// load_tile by cp.async for VEC rows (complete after cp_async_wait; the
// pieces from dh on are zero-filled), else through registers.
template <typename T, int D, bool VEC>
__device__ __forceinline__ void stage_tile(bf16* dst, const T* src, int row0, int N, int ld,
                                           int col, int dh, int tid) {
  if constexpr (VEC) {
    constexpr int PER_ROW = D / 8;
    for (int c = tid; c < 64 * PER_ROW; c += THREADS) {
      const int r = c / PER_ROW, d0 = (c % PER_ROW) * 8, n = row0 + r;
      const bool ok = n < N && d0 < dh;
      cp_async16(dst + r * (D + 8) + d0, src + (ok ? (size_t)n * ld + col + d0 : 0), ok);
    }
  } else {
    load_tile<T, D, false>(dst, src, row0, N, ld, col, dh, tid);
  }
}

// The A fragments of rows wr .. wr + 16 of a bf16 tile [64][D + 8], one per
// 16 channels.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* A, int wr,
                                       int lane) {
#pragma unroll
  for (int s = 0; s < D / 16; ++s)
    ldsm_x4(a[s], A + (wr + (lane & 15)) * (D + 8) + 16 * s + ((lane >> 4) << 3));
}

// c += a . B[0 : 64, kd : kd + 16]^T: one 16-deep step of warp_abt, a the A
// fragment of channels kd .. kd + 16.
template <int D>
__device__ __forceinline__ void abt_step(float (&c)[8][4], const uint32_t (&a)[4],
                                         const bf16* B, int kd, int lane) {
  constexpr int LDT = D + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b[4];  // B rows 16 j .. 16 j + 16 as two 8-column fragments
    ldsm_x4(b, B + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * LDT + kd +
                   (((lane >> 3) & 1) << 3));
    mma_bf16(c[2 * j], a, b[0], b[1]);
    mma_bf16(c[2 * j + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ void zero_frags(float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// c = A[wr : wr + 16] . B[0 : 64]^T over D channels, B a bf16 tile
// [64][D + 8] and A the warp's rows held as fragments (load_a): the warp's
// 16 x 64 tile as eight 16 x 8 C fragments.
template <int D>
__device__ __forceinline__ void warp_abt(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* B, int lane) {
  zero_frags(c);
#pragma unroll
  for (int s = 0; s < D / 16; ++s) abt_step<D>(c, a[s], B, 16 * s, lane);
}

// The same with A a bf16 tile [64][D + 8] in shared memory, each step's A
// fragment read just before its products.
template <int D>
__device__ __forceinline__ void warp_abt(float (&c)[8][4], const bf16* A, const bf16* B, int wr,
                                         int lane) {
  zero_frags(c);
#pragma unroll
  for (int kd = 0; kd < D; kd += 16) {
    uint32_t a[4];
    ldsm_x4(a, A + (wr + (lane & 15)) * (D + 8) + kd + ((lane >> 4) << 3));
    abt_step<D>(c, a, B, kd, lane);
  }
}

// acc += a . M[16 kk : 16 kk + 16, 0 : D]: one 16-deep step of warp_pm, a
// the A fragment of rows wr .. wr + 16, M a bf16 tile of rows LDT apart
// ([64][D + 8] unless LDT says otherwise: D columns of a wider tile); acc
// holds 16 x D as D / 8 fragments.
template <int D, int LDT = D + 8>
__device__ __forceinline__ void pm_step(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                        const bf16* M, int kk, int lane) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t b[4];  // M rows 16 kk .. + 16, columns 16 j .. + 16, transposed
    ldsm_x4_t(b, M + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDT + 16 * j +
                     ((lane >> 4) << 3));
    mma_bf16(acc[2 * j], a, b[0], b[1]);
    mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// acc += P . M over 64 rows of M: P the warp's 16 x 64 f32 C fragments,
// each step's pair rounded to bf16 (pack_a) just before its products.
template <int D, int LDT = D + 8>
__device__ __forceinline__ void warp_pm(float (&acc)[D / 8][4], const float (&p)[8][4],
                                        const bf16* M, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    pack_a(a, p[2 * kk], p[2 * kk + 1]);
    pm_step<D, LDT>(acc, a, M, kk, lane);
  }
}

// The same with P already rounded to bf16 A fragments, one per 16 rows of M.
template <int D>
__device__ __forceinline__ void warp_pm(float (&acc)[D / 8][4], const uint32_t (&a)[4][4],
                                        const bf16* M, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pm_step<D>(acc, a[kk], M, kk, lane);
}

// The warp's 16 x D result, scaled, to rows row0 + g and row0 + g + 8 of a
// row-major output `ld` elements apart (channels from col); rows past N and
// channels from dh on are not written. Pairs of channels go out as one
// store where they are aligned to it, else value by value.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4], float scale,
                                           int row0, int N, int ld, int col, int dh, int lane) {
  const int n = row0 + (lane >> 2), c = 2 * (lane & 3);
  const bool pairs = dh % 2 == 0 && ld % 2 == 0 && col % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(dst) & (2 * sizeof(T) - 1)) == 0;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int ch = c + 8 * j;
    if (ch >= dh) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = n + 8 * half;
      if (row >= N) continue;
      T* p = dst + (size_t)row * ld + col + ch;
      const float v0 = acc[j][2 * half] * scale, v1 = acc[j][2 * half + 1] * scale;
      if (pairs) {
        store_pair(p, v0, v1);
      } else {
        p[0] = from_f32<T>(v0);
        if (ch + 1 < dh) p[1] = from_f32<T>(v1);
      }
    }
  }
}

}  // namespace
