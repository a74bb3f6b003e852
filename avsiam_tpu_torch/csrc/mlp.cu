// The transformer MLP fc2(gelu(fc1(x))) and its backward (K4, K7, K8, K9),
// sm_90a. Replaces the TPU kernels of avsiam_tpu/ops/mlp.py:
//   K4 _fwd_call (_fwd_kernel)               -> mlp_fwd_kernel
//   K7 _bwd_call (_bwd_fused_kernel)          -> mlp_bwd_dx_kernel + mlp_bwd_dw_kernel
//   K8 _bwd_call_split (_bwd_dx_kernel)       -> mlp_bwd_dx_kernel, stashing gh and act
//   K9 weight_grads (_dw_kernel)              -> mlp_dw_kernel
//
// Numerics, as the Pallas kernels have them: bf16 operands with f32
// accumulation (an f32 call stores f32 but multiplies bf16 operands), the
// pre-GELU hidden hpre = x w1^T + b1 in f32, GELU and GELU' in f32 in the
// A&S 'ans' form, gh = (do w2) * gelu'(hpre) in f32. dx and dw1 take gh in
// bf16; K7's db1 sums the f32 gh, K9's sums the stored gh.
//
// What bounds them on the H100: their FLOPs (4 T D H forward, 10 T D H
// backward) at T of hundreds to thousands of rows. The TPU kernels keep the
// [T, H] hidden out of device memory, and so do K4 and K7 here; K8 writes gh
// and act ([T, H] each) by design, for K9 to read.
//
// K4 is K3 without the LayerNorm and the residual: the same row tiles and
// hidden ranges (mlp_tile.cuh), with the hidden split across blocks and the
// f32 partials added in a fixed order.
//
// The TPU backward accumulates dw/db over its sequential grid of row
// blocks. Blocks on the H100 run in parallel, so here every output element
// has one owner that sums in a fixed order (deterministic, no atomics):
//   - dx: as K4, a block per (32-row tile, hidden range) recomputes hpre, dh
//     and gh chunk by chunk and accumulates gh w1 in registers; the f32
//     partials of the hidden ranges are added by the epilogue kernel;
//   - K7's weight gradients: a block per 16 hidden columns walks all rows,
//     recomputing hpre and dh for its columns (w1 rows and w2 columns kept in
//     shared memory), and accumulates dw1 [16, D] and dw2 [D, 16] in
//     registers. The recomputation costs 4 T D H FLOPs over the Pallas
//     kernel's 10 T D H; no [T, H] tensor touches device memory;
//   - K9: a block per 192 x 96 (or 128 x 128) tile of dw walks all rows,
//     below.
// wgmma and TMA-fed tiles for K4, K7 and K8 are later work.
//
// K9 (redesigned). What bounds it on the H100: at ViT-B's widths
// (m, n = 768, 3072) and T of 156-1416 rows a call is 2 T m n FLOPs (1-7
// GFLOP) and writes a 9.4 MB f32 dw, so the bound is about equal parts
// tensor-core rate and the dw write (about 5 us at T = 1024). The wmma form
// before this one (64 x 64 tiles of 4 warps, synchronous loads) re-read
// every input from L2 48 or 12 times and never overlapped a load with a
// product. This one: 192 x 96 tiles, so each input is read from L2 by 4 to
// 32 blocks, and dw1/dw2 at ViT-B are 128 tiles, one wave on 132 SMs; TMA
// loads of 64-row slabs into a ring of mbarrier-tracked stages; and wgmma
// on both operands in their reduction-major (MN-major) layout, swizzled so
// the tensor cores read shared memory without bank conflicts. On an NVIDIA
// H100 80GB HBM3 (700 W), per phase-C step of chip_smoke.py: the wmma form
// 9.22 ms; mma.sync fed by ldmatrix.trans from a cp.async ring, 5.28 ms with
// 128 x 192 tiles and 32-row slabs and 3.94 ms with 96 x 192 tiles and
// 64-row slabs; wgmma on the cp.async ring 3.54 ms, where issuing the loads
// from every thread held it back. 128 x 128 tiles would be 144 at ViT-B's
// widths, a second wave, so they serve the decoder's. What bounds it now: the f32
// write at the end and the slabs' L2 traffic (36 KB per block per 64 rows,
// the same rows read by many blocks), which TMA multicast across a cluster
// would cut.
//
// Weights use nn.Linear's layout: w1 [H, D] (fc1.weight), w2 [D, H]
// (fc2.weight); biases are f32. Gradients likewise: dw1 [H, D], dw2 [D, H].

#include <cuda.h>

#include "mlp_tile.cuh"
#include "mma.cuh"

namespace {

// ------------------------------------------------------------------ K4
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const T* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               T* __restrict__ hpre, float* __restrict__ partial, int rows, int H,
               int splits) {
  using SM = MlpSmem<D>;
  constexpr int LDN = SM::LDN;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ns = reinterpret_cast<bf16*>(smem + SM::NS);
  float* Hs = reinterpret_cast<float*>(smem + SM::HS);
  bf16* Gs = reinterpret_cast<bf16*>(smem + SM::GS);

  const int r0 = blockIdx.x * BM;
  const int chunks = H / HC;
  const int c_begin = (int)((long long)blockIdx.y * chunks / splits);
  const int c_end = (int)((long long)(blockIdx.y + 1) * chunks / splits);
  load_tile<T, BM, D, LDN, THREADS>(x, D, Ns, r0, rows);  // the row tile in bf16
  FragC y[2][D / 128];
  zero_rows_acc<D>(y);
  __syncthreads();
  fwd_chunks<T, D>(Ns, Hs, Gs, w1, b1, w2, hpre, r0, rows, H, c_begin, c_end, y);
  store_partial<D>(partial, y, r0);
}

// --------------------------------------------------------- dx (K7, K8)
template <int D>
struct DxSmem {
  static constexpr int LDN = D + 8;
  static constexpr int XS = 0;
  static constexpr int DS = align128(XS + BM * LDN * 2);
  static constexpr int HS = align128(DS + BM * LDN * 2);  // f32 hpre chunk
  static constexpr int PS = align128(HS + BM * LDH * 4);  // f32 dh chunk
  static constexpr int GS = align128(PS + BM * LDH * 4);  // bf16 gh chunk
  static constexpr int BYTES = GS + BM * LDG * 2;
};

// dx = T(gh_bf16 w1) with gh = (do w2) * gelu'(x w1^T + b1), a block per
// (row tile, hidden range); gh and act go out in T when gh_out is not null
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_dx_kernel(const T* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const T* __restrict__ dout, T* __restrict__ gh_out, T* __restrict__ act_out,
                  float* __restrict__ partial, int rows, int H, int splits) {
  using SM = DxSmem<D>;
  constexpr int LDN = SM::LDN;
  constexpr int YC = D / 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + SM::XS);
  bf16* Ds = reinterpret_cast<bf16*>(smem + SM::DS);
  float* Hs = reinterpret_cast<float*>(smem + SM::HS);
  float* Ps = reinterpret_cast<float*>(smem + SM::PS);
  bf16* Gs = reinterpret_cast<bf16*>(smem + SM::GS);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = blockIdx.x * BM;
  const int chunks = H / HC;
  const int c_begin = (int)((long long)blockIdx.y * chunks / splits);
  const int c_end = (int)((long long)(blockIdx.y + 1) * chunks / splits);
  load_tile<T, BM, D, LDN, THREADS>(x, D, Xs, r0, rows);
  load_tile<T, BM, D, LDN, THREADS>(dout, D, Ds, r0, rows);
  FragC y[2][YC];
  zero_rows_acc<D>(y);
  __syncthreads();

  const int frt = warp >> 2, fct = warp & 3;  // this warp's hidden fragment
  for (int h0 = c_begin * HC; h0 < c_end * HC; h0 += HC) {
    // hpre chunk = x . w1[h0:h0+HC]^T and dh chunk = do . w2[:, h0:h0+HC]
    {
      FragC acc_h, acc_d;
      wmma::fill_fragment(acc_h, 0.f);
      wmma::fill_fragment(acc_d, 0.f);
      const bf16* w1c = w1 + (size_t)(h0 + fct * 16) * D;
      const bf16* w2c = w2 + h0 + fct * 16;
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 16) {
        FragA fa;
        FragBc fb;
        FragBr fr;
        wmma::load_matrix_sync(fa, Xs + frt * 16 * LDN + kk, LDN);
        wmma::load_matrix_sync(fb, w1c + kk, D);
        wmma::mma_sync(acc_h, fa, fb, acc_h);
        wmma::load_matrix_sync(fa, Ds + frt * 16 * LDN + kk, LDN);
        wmma::load_matrix_sync(fr, w2c + (size_t)kk * H, H);
        wmma::mma_sync(acc_d, fa, fr, acc_d);
      }
      wmma::store_matrix_sync(Hs + frt * 16 * LDH + fct * 16, acc_h, LDH, wmma::mem_row_major);
      wmma::store_matrix_sync(Ps + frt * 16 * LDH + fct * 16, acc_d, LDH, wmma::mem_row_major);
    }
    __syncthreads();
    // gh = dh * gelu'(hpre + b1) in f32 -> bf16 tile Gs; the stash
    for (int i = tid; i < BM * HC; i += THREADS) {
      const int r = i / HC, c = i % HC, n = r0 + r;
      float act, grad;
      gelu_ans_act_grad(Hs[r * LDH + c] + b1[h0 + c], act, grad);
      const float g = Ps[r * LDH + c] * grad;
      Gs[r * LDG + c] = __float2bfloat16(g);
      if (gh_out != nullptr && n < rows) {
        gh_out[(size_t)n * H + h0 + c] = from_f32<T>(g);
        act_out[(size_t)n * H + h0 + c] = from_f32<T>(act);
      }
    }
    __syncthreads();
    // dx += gh . w1[h0:h0+HC] on this warp's output columns
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      FragA fa0, fa1;
      wmma::load_matrix_sync(fa0, Gs + kk, LDG);
      wmma::load_matrix_sync(fa1, Gs + 16 * LDG + kk, LDG);
#pragma unroll
      for (int j = 0; j < YC; ++j) {
        FragBr fb;
        wmma::load_matrix_sync(fb, w1 + (size_t)(h0 + kk) * D + (warp * YC + j) * 16, D);
        wmma::mma_sync(y[0][j], fa0, fb, y[0][j]);
        wmma::mma_sync(y[1][j], fa1, fb, y[1][j]);
      }
    }
  }
  store_partial<D>(partial, y, r0);
}

// --------------------------------------------- K7's weight gradients
constexpr int HB = 16;        // hidden columns per block
constexpr int LDW = HB + 8;   // bf16 row stride of [*, HB] tiles
constexpr int LDP = HB + 4;   // f32 row stride of [*, HB] tiles

template <int D>
struct DwSmem {
  static constexpr int LDN = D + 8;
  static constexpr int XS = 0;                                 // bf16 [BM, D] x rows
  static constexpr int DS = align128(XS + BM * LDN * 2);       // bf16 [BM, D] do rows
  static constexpr int W1S = align128(DS + BM * LDN * 2);      // bf16 [HB, D] w1 rows
  static constexpr int W2S = align128(W1S + HB * LDN * 2);     // bf16 [D, HB] w2 columns
  static constexpr int PS = align128(W2S + D * LDW * 2);       // f32 [2][4][16, HB] products
  static constexpr int GFS = align128(PS + 8 * 16 * LDP * 4);  // f32 [BM, HB] gh
  static constexpr int GS = align128(GFS + BM * LDP * 4);      // bf16 [BM, HB] gh
  static constexpr int AS = align128(GS + BM * LDW * 2);       // bf16 [BM, HB] act
  static constexpr int DB2 = align128(AS + BM * LDW * 2);      // f32 [D] db2 (block 0)
  static constexpr int BYTES = DB2 + D * 4;
};

// Block b owns hidden columns [16 b, 16 b + 16): dw1 rows, dw2 columns and
// db1 entries; block 0 also owns db2. Each walks every row tile in order.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_dw_kernel(const T* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const T* __restrict__ dout, float* __restrict__ dw1, float* __restrict__ db1,
                  float* __restrict__ dw2, float* __restrict__ db2, int rows, int H) {
  using SM = DwSmem<D>;
  constexpr int LDN = SM::LDN;
  constexpr int NF = D / 128;  // dw1 column / dw2 row fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + SM::XS);
  bf16* Ds = reinterpret_cast<bf16*>(smem + SM::DS);
  bf16* W1s = reinterpret_cast<bf16*>(smem + SM::W1S);
  bf16* W2s = reinterpret_cast<bf16*>(smem + SM::W2S);
  float* Ps = reinterpret_cast<float*>(smem + SM::PS);
  float* GFs = reinterpret_cast<float*>(smem + SM::GFS);
  bf16* Gs = reinterpret_cast<bf16*>(smem + SM::GS);
  bf16* As = reinterpret_cast<bf16*>(smem + SM::AS);
  float* DB2s = reinterpret_cast<float*>(smem + SM::DB2);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int hr = blockIdx.x * HB;
  const bool owns_db2 = blockIdx.x == 0;
  for (int i = tid; i < HB * D; i += THREADS) {
    const int h = i / D, d = i - h * D;
    W1s[h * LDN + d] = w1[(size_t)(hr + h) * D + d];
  }
  for (int i = tid; i < D * HB; i += THREADS) {
    const int d = i / HB, h = i % HB;
    W2s[d * LDW + h] = w2[(size_t)d * H + hr + h];
  }
  if (owns_db2)
    for (int d = tid; d < D; d += THREADS) DB2s[d] = 0.f;

  FragC acc1[NF], acc2[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::fill_fragment(acc1[f], 0.f);
    wmma::fill_fragment(acc2[f], 0.f);
  }
  float db1_acc = 0.f;
  // warp -> (product job, half of the D contraction): jobs 0/1 hpre rows
  // 0-15/16-31, jobs 2/3 dh rows 0-15/16-31
  const int job = warp & 3, kh = warp >> 2;
  for (int r0 = 0; r0 < rows; r0 += BM) {
    load_tile<T, BM, D, LDN, THREADS>(x, D, Xs, r0, rows);
    load_tile<T, BM, D, LDN, THREADS>(dout, D, Ds, r0, rows);
    if (owns_db2 && !std::is_same<T, bf16>::value)  // f32: from the unrounded values
      for (int d = tid; d < D; d += THREADS) {
        float s = 0.f;
        for (int r = 0; r < BM && r0 + r < rows; ++r) s += to_f32(dout[(size_t)(r0 + r) * D + d]);
        DB2s[d] += s;
      }
    __syncthreads();
    if (owns_db2 && std::is_same<T, bf16>::value)  // bf16: the tile holds do exactly
      for (int d = tid; d < D; d += THREADS) {
        float s = 0.f;
        for (int r = 0; r < BM; ++r) s += __bfloat162float(Ds[r * LDN + d]);
        DB2s[d] += s;
      }
    {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      const bf16* arow = (job < 2 ? Xs : Ds) + (job & 1) * 16 * LDN;
#pragma unroll 4
      for (int kk = kh * (D / 2); kk < (kh + 1) * (D / 2); kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, arow + kk, LDN);
        if (job < 2) {
          FragBc fb;
          wmma::load_matrix_sync(fb, W1s + kk, LDN);
          wmma::mma_sync(acc, fa, fb, acc);
        } else {
          FragBr fb;
          wmma::load_matrix_sync(fb, W2s + kk * LDW, LDW);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
      wmma::store_matrix_sync(Ps + (kh * 4 + job) * 16 * LDP, acc, LDP, wmma::mem_row_major);
    }
    __syncthreads();
    // hpre = x w1^T + b1, dh = do w2 (the two halves of D added);
    // gh = dh * gelu'(hpre), act = gelu(hpre); zeros past rows
    for (int i = tid; i < BM * HB; i += THREADS) {
      const int r = i / HB, c = i % HB, rt = r >> 4, rr = r & 15;
      const float hv = Ps[rt * 16 * LDP + rr * LDP + c] + Ps[(4 + rt) * 16 * LDP + rr * LDP + c] +
                       b1[hr + c];
      const float dh = Ps[(2 + rt) * 16 * LDP + rr * LDP + c] +
                       Ps[(6 + rt) * 16 * LDP + rr * LDP + c];
      float act, grad;
      gelu_ans_act_grad(hv, act, grad);
      const bool live = r0 + r < rows;
      const float g = live ? dh * grad : 0.f;
      GFs[r * LDP + c] = g;
      Gs[r * LDW + c] = __float2bfloat16(g);
      As[r * LDW + c] = __float2bfloat16(live ? act : 0.f);
    }
    __syncthreads();
    if (tid < HB)
      for (int r = 0; r < BM; ++r) db1_acc += GFs[r * LDP + tid];
#pragma unroll
    for (int kk = 0; kk < BM; kk += 16) {
      FragAc ga;  // gh^T [HB, 16 rows]
      wmma::load_matrix_sync(ga, Gs + kk * LDW, LDW);
      FragBr ab;  // act [16 rows, HB]
      wmma::load_matrix_sync(ab, As + kk * LDW, LDW);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int j = warp * NF + f;
        FragBr xb;  // x [16 rows, 16 columns j]
        wmma::load_matrix_sync(xb, Xs + kk * LDN + j * 16, LDN);
        wmma::mma_sync(acc1[f], ga, xb, acc1[f]);
        FragAc da;  // do^T [16 columns j, 16 rows]
        wmma::load_matrix_sync(da, Ds + kk * LDN + j * 16, LDN);
        wmma::mma_sync(acc2[f], da, ab, acc2[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int j = warp * NF + f;
    wmma::store_matrix_sync(dw1 + (size_t)hr * D + j * 16, acc1[f], D, wmma::mem_row_major);
    wmma::store_matrix_sync(dw2 + (size_t)(j * 16) * H + hr, acc2[f], H, wmma::mem_row_major);
  }
  if (tid < HB) db1[hr + tid] = db1_acc;
  if (owns_db2)
    for (int d = tid; d < D; d += THREADS) db2[d] = DB2s[d];
}

// ------------------------------------------------------------------ K9
// bf16 (the step path): mlp_dw_tc_kernel. A block owns a BM x BN tile of
// dw (192 x 96, or 128 x 128 where 192 and 96 do not divide the widths; the
// caller picks), one warpgroup per 64 of its rows, and walks the rows of g
// and a in 64-row slabs. One thread issues TMA loads of the slabs into a
// 4-stage ring, two slabs in flight while the tensor cores work on a third;
// each stage's mbarrier counts the bytes in. The TMA boxes land in wgmma's
// swizzled MN-major layout (GmmaLayout, mma.cuh), since both operands are
// reduction-major in memory: g^T is A (64 dw rows per warpgroup), a is B
// (BN columns), with the transpose bits set. Each warpgroup keeps one
// slab's wgmma group in flight while it issues the next. The blocks of tile
// column 0 also sum db from the g slabs in shared memory: each thread two
// columns over a fixed quarter of every slab's rows, the quarters then
// added in order. One owner per output element, no atomics, the same bits
// every call.
constexpr int DW_BK = 64;  // rows of a and g per slab
constexpr int DW_STAGES = 4;

template <int BM, int BN>
struct DwTcSmem {
  using LA = GmmaLayout<BM, DW_BK>;  // g slab: A = g^T
  using LB = GmmaLayout<BN, DW_BK>;  // a slab: B
  static constexpr int THREADS = BM / 64 * 128;
  static constexpr int STAGE = LA::BYTES + LB::BYTES;  // a multiple of 1 KB
  static constexpr int DB = DW_STAGES * STAGE;         // f32 [4][BM] db quarters
  static constexpr int BAR = DB + 4 * BM * 4;          // an mbarrier per stage
  static constexpr int BYTES = BAR + 8 * DW_STAGES + 1024;  // + room to align to 1 KB
};

// slab `s` (rows s * DW_BK ..) of g and a into a ring stage, by TMA
template <int BM, int BN>
__device__ __forceinline__ void dw_issue_slab(unsigned char* stage, uint64_t* bar,
                                              const CUtensorMap* gmap, const CUtensorMap* amap,
                                              int n0, int m0, int s) {
  using SM = DwTcSmem<BM, BN>;
  using LA = typename SM::LA;
  using LB = typename SM::LB;
  mbar_expect_tx(bar, SM::STAGE);
#pragma unroll
  for (int c = 0; c < BM / LA::BOX; ++c)
    tma_load_2d(stage + c * LA::LBO, gmap, n0 + c * LA::BOX, s * DW_BK, bar);
#pragma unroll
  for (int c = 0; c < BN / LB::BOX; ++c)
    tma_load_2d(stage + LA::BYTES + c * LB::LBO, amap, m0 + c * LB::BOX, s * DW_BK, bar);
}

template <int N> struct Wgmma;
template <> struct Wgmma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t a, uint64_t b) {
    wgmma_m64n96(d, a, b);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    wgmma_m64n128(d, a, b);
  }
};

// gmap, amap: TMA maps of g [rows, n] and a [rows, m] with boxes of DW_BK
// rows by GmmaLayout's BOX columns and its swizzle
template <int BM, int BN>
__global__ void __launch_bounds__(DwTcSmem<BM, BN>::THREADS, 1)
mlp_dw_tc_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap amap,
                 float* __restrict__ dw, float* __restrict__ db, int rows, int m, int n) {
  using SM = DwTcSmem<BM, BN>;
  using LA = typename SM::LA;
  using LB = typename SM::LB;
  constexpr int PAIRS = BM / 2;  // db column pairs, one per thread of each quarter
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + SM::BAR);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int n0 = blockIdx.y * BM, m0 = blockIdx.x * BN;
  const bool owns_db = blockIdx.x == 0, db_thread = tid < 4 * PAIRS;
  const int slabs = (rows + DW_BK - 1) / DW_BK;

  if (tid == 0) {
    for (int i = 0; i < DW_STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    for (int s = 0; s < DW_STAGES - 2 && s < slabs; ++s)
      dw_issue_slab<BM, BN>(smem + s * SM::STAGE, bars + s, &gmap, &amap, n0, m0, s);
  }
  __syncthreads();  // the barriers are initialised

  float acc[BN / 2];  // the warpgroup's 64 x BN accumulator, BN / 2 a thread
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  float db0 = 0.f, db1 = 0.f;  // columns dbc, dbc + 1 over rows quarter tid / PAIRS
  const int dbc = 2 * (tid % PAIRS), dbq = (tid / PAIRS) * (DW_BK / 4);

  for (int s = 0; s < slabs; ++s) {
    mbar_wait(bars + s % DW_STAGES, (s / DW_STAGES) & 1);  // slab s has landed
    __syncthreads();  // and every warpgroup is done with slab s - 2
    const int next = s + DW_STAGES - 2;  // into the stage slab s - 2 held
    if (tid == 0 && next < slabs) {
      fence_proxy_async();  // after the db reads of that stage
      dw_issue_slab<BM, BN>(smem + (next % DW_STAGES) * SM::STAGE, bars + next % DW_STAGES, &gmap,
                            &amap, n0, m0, next);
    }
    const unsigned char* As = smem + (s % DW_STAGES) * SM::STAGE;
    const unsigned char* Bs = As + LA::BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_BK / 16; ++kk)
      Wgmma<BN>::run(acc, LA::desc(As + wg * (64 / LA::BOX) * LA::LBO + kk * LA::KSTEP),
                     LB::desc(Bs + kk * LB::KSTEP));
    wgmma_commit();
    if (owns_db && db_thread) {
#pragma unroll
      for (int r = 0; r < DW_BK / 4; ++r) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            As + LA::chunk(dbq + r, dbc >> 3) + (dbc & 7) * 2));
        db0 += v.x;
        db1 += v.y;
      }
    }
    wgmma_wait<1>();  // slab s - 1's products are done
  }
  wgmma_wait<0>();

  const int row = n0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), col = m0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    store_pair(dw + (size_t)row * m + col + 8 * j, acc[4 * j], acc[4 * j + 1]);
    store_pair(dw + (size_t)(row + 8) * m + col + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (owns_db) {
    float* q = reinterpret_cast<float*>(smem + SM::DB);
    if (db_thread) {
      q[(tid / PAIRS) * BM + dbc] = db0;
      q[(tid / PAIRS) * BM + dbc + 1] = db1;
    }
    __syncthreads();
    if (tid < BM) db[n0 + tid] = ((q[tid] + q[BM + tid]) + q[2 * BM + tid]) + q[3 * BM + tid];
  }
}

// float32 storage (off the step path): the first form, a block of 4 warps per
// 64 x 64 tile of dw walking all rows in order through wmma; db sums the
// unrounded f32 g
constexpr int DW_TILE = 64;   // dw tile edge
constexpr int DW_ROWS = 32;   // rows per step
constexpr int DW_THREADS = 128;
constexpr int LDT = DW_TILE + 8;

// dw [n, m] = g^T a and db [n] = sum of g's rows (block column 0), a block
// per 64 x 64 tile of dw walking all rows in order
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
mlp_dw_kernel(const T* __restrict__ a, const T* __restrict__ g, float* __restrict__ dw,
              float* __restrict__ db, int rows, int m, int n) {
  __shared__ __align__(128) bf16 As[DW_ROWS * LDT];
  __shared__ __align__(128) bf16 Gs[DW_ROWS * LDT];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * DW_TILE, n0 = blockIdx.y * DW_TILE;
  const bool owns_db = blockIdx.x == 0;
  FragC acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);
  float db_acc = 0.f;
  for (int r0 = 0; r0 < rows; r0 += DW_ROWS) {
    load_tile<T, DW_ROWS, DW_TILE, LDT, DW_THREADS>(a + m0, m, As, r0, rows);
    load_tile<T, DW_ROWS, DW_TILE, LDT, DW_THREADS>(g + n0, n, Gs, r0, rows);
    if (owns_db && tid < DW_TILE && !std::is_same<T, bf16>::value)  // f32: unrounded
      for (int r = 0; r < DW_ROWS && r0 + r < rows; ++r)
        db_acc += to_f32(g[(size_t)(r0 + r) * n + n0 + tid]);
    __syncthreads();
    if (owns_db && tid < DW_TILE && std::is_same<T, bf16>::value)  // bf16: the tile
      for (int r = 0; r < DW_ROWS; ++r) db_acc += __bfloat162float(Gs[r * LDT + tid]);
#pragma unroll
    for (int kk = 0; kk < DW_ROWS; kk += 16) {
      FragAc ga;  // g^T [16 of this warp's n, 16 rows]
      wmma::load_matrix_sync(ga, Gs + kk * LDT + warp * 16, LDT);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        FragBr ab;
        wmma::load_matrix_sync(ab, As + kk * LDT + f * 16, LDT);
        wmma::mma_sync(acc[f], ga, ab, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(dw + (size_t)(n0 + warp * 16) * m + m0 + f * 16, acc[f], m,
                            wmma::mem_row_major);
  if (owns_db && tid < DW_TILE) db[n0 + tid] = db_acc;
}

// ------------------------------------------------------------ launches
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int launch_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, void* hpre, void* partial, int rows, int H, int splits,
               cudaStream_t stream) {
  const int smem = MlpSmem<D>::BYTES;
  cudaError_t err = allow_smem(mlp_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (rows + BM - 1) / BM;
  mlp_fwd_kernel<T, D><<<dim3(tiles, splits), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<T*>(hpre), static_cast<float*>(partial), rows,
      H, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_epilogue<T, true, false>(nullptr, partial, b2, out, rows, tiles * BM, D,
                                              splits, stream);
}

template <typename T, int D>
int launch_dx(const void* x, const void* w1, const void* b1, const void* w2, const void* dout,
              void* dx, void* gh, void* act, void* partial, int rows, int H, int splits,
              cudaStream_t stream) {
  const int smem = DxSmem<D>::BYTES;
  cudaError_t err = allow_smem(mlp_bwd_dx_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (rows + BM - 1) / BM;
  mlp_bwd_dx_kernel<T, D><<<dim3(tiles, splits), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const T*>(dout), static_cast<T*>(gh),
      static_cast<T*>(act), static_cast<float*>(partial), rows, H, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_epilogue<T, false, false>(nullptr, partial, nullptr, dx, rows, tiles * BM,
                                               D, splits, stream);
}

template <typename T, int D>
int launch_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* dout,
               void* dx, void* dw1, void* db1, void* dw2, void* db2, void* partial, int rows,
               int H, int splits, cudaStream_t stream) {
  int err = launch_dx<T, D>(x, w1, b1, w2, dout, dx, nullptr, nullptr, partial, rows, H,
                            splits, stream);
  if (err != 0) return err;
  const int smem = DwSmem<D>::BYTES;
  cudaError_t e = allow_smem(mlp_bwd_dw_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_dw_kernel<T, D><<<H / HB, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const T*>(dout), static_cast<float*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dw2), static_cast<float*>(db2), rows, H);
  return (int)cudaGetLastError();
}

bool bad_shape(int rows, int H, int splits) {
  return H % HC != 0 || rows <= 0 || splits < 1 || splits > H / HC;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dout, out, hpre, dx, gh, act, a, g).
// D in {512, 768}, H a multiple of 64, 1 <= splits <= H / 64. partial: f32
// scratch [splits, ceil(rows / 32) * 32, D]. Each returns cudaGetLastError().

// K4: out [rows, D]; hpre [rows, H] or null
extern "C" int avsiam_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, void* hpre, void* partial, int rows,
                              int D, int H, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(rows, H, splits)) return (int)cudaErrorInvalidValue;
#define AVSIAM_MLP(TYPE, DIM) \
  return launch_fwd<TYPE, DIM>(x, w1, b1, w2, b2, out, hpre, partial, rows, H, splits, s)
  if (dtype == 1 && D == 768) AVSIAM_MLP(bf16, 768);
  if (dtype == 1 && D == 512) AVSIAM_MLP(bf16, 512);
  if (dtype == 0 && D == 768) AVSIAM_MLP(float, 768);
  if (dtype == 0 && D == 512) AVSIAM_MLP(float, 512);
#undef AVSIAM_MLP
  return (int)cudaErrorInvalidValue;
}

// K7: dx [rows, D] in the activation type; dw1 [H, D], db1 [H], dw2 [D, H],
// db2 [D] in f32
extern "C" int avsiam_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* dout, void* dx, void* dw1, void* db1, void* dw2,
                              void* db2, void* partial, int rows, int D, int H, int splits,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(rows, H, splits)) return (int)cudaErrorInvalidValue;
#define AVSIAM_MLP(TYPE, DIM)                                                                  \
  return launch_bwd<TYPE, DIM>(x, w1, b1, w2, dout, dx, dw1, db1, dw2, db2, partial, rows, H, \
                               splits, s)
  if (dtype == 1 && D == 768) AVSIAM_MLP(bf16, 768);
  if (dtype == 1 && D == 512) AVSIAM_MLP(bf16, 512);
  if (dtype == 0 && D == 768) AVSIAM_MLP(float, 768);
  if (dtype == 0 && D == 512) AVSIAM_MLP(float, 512);
#undef AVSIAM_MLP
  return (int)cudaErrorInvalidValue;
}

// K8: dx [rows, D], gh [rows, H], act [rows, H], all in the activation type
extern "C" int avsiam_mlp_bwd_dx(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* dout, void* dx, void* gh, void* act, void* partial,
                                 int rows, int D, int H, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(rows, H, splits) || gh == nullptr || act == nullptr)
    return (int)cudaErrorInvalidValue;
#define AVSIAM_MLP(TYPE, DIM) \
  return launch_dx<TYPE, DIM>(x, w1, b1, w2, dout, dx, gh, act, partial, rows, H, splits, s)
  if (dtype == 1 && D == 768) AVSIAM_MLP(bf16, 768);
  if (dtype == 1 && D == 512) AVSIAM_MLP(bf16, 512);
  if (dtype == 0 && D == 768) AVSIAM_MLP(float, 768);
  if (dtype == 0 && D == 512) AVSIAM_MLP(float, 512);
#undef AVSIAM_MLP
  return (int)cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                       cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// the TMA map of a row-major bf16 [rows, cols] matrix in boxes of DW_BK rows
// by L::BOX columns, swizzled as L lays them out
template <typename L>
bool dw_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)L::BOX, (cuuint32_t)DW_BK};
  const cuuint32_t steps[2] = {1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;  // rows past the end: zeros
}

template <int BM, int BN>
int launch_dw_tc(const void* a, const void* g, void* dw, void* db, int rows, int m, int n,
                 cudaStream_t stream) {
  using SM = DwTcSmem<BM, BN>;
  CUtensorMap gmap, amap;
  if (!dw_map<typename SM::LA>(&gmap, g, rows, n) || !dw_map<typename SM::LB>(&amap, a, rows, m))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mlp_dw_tc_kernel<BM, BN>, SM::BYTES);
  if (err != cudaSuccess) return (int)err;
  mlp_dw_tc_kernel<BM, BN><<<dim3(m / BN, n / BM), SM::THREADS, SM::BYTES, stream>>>(
      gmap, amap, static_cast<float*>(dw), static_cast<float*>(db), rows, m, n);
  return (int)cudaGetLastError();
}

// K9: a [rows, m], g [rows, n] -> dw [n, m] = g^T a, db [n] = column sums of
// g, in f32. bf16 takes a bm x bn tile, 192 x 96 or 128 x 128, that divides
// [n, m]; the float32 form takes m and n multiples of 64 and ignores bm, bn.
extern "C" int avsiam_mlp_dw(const void* a, const void* g, void* dw, void* db, int rows, int m,
                             int n, int bm, int bn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || m % DW_TILE != 0 || n % DW_TILE != 0 || m <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(m / DW_TILE, n / DW_TILE);
  if (dtype == 1) {
    if (bm == 192 && bn == 96 && n % 192 == 0 && m % 96 == 0)
      return launch_dw_tc<192, 96>(a, g, dw, db, rows, m, n, s);
    if (bm == 128 && bn == 128 && n % 128 == 0 && m % 128 == 0)
      return launch_dw_tc<128, 128>(a, g, dw, db, rows, m, n, s);
    return (int)cudaErrorInvalidValue;
  } else if (dtype == 0)
    mlp_dw_kernel<float><<<grid, DW_THREADS, 0, s>>>(static_cast<const float*>(a),
                                                     static_cast<const float*>(g),
                                                     static_cast<float*>(dw),
                                                     static_cast<float*>(db), rows, m, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
