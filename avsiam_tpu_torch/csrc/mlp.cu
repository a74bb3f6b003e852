// The transformer MLP fc2(gelu(fc1(x))) and its backward (K4, K7, K8, K9),
// sm_90a. Replaces the TPU kernels of avsiam_tpu/ops/mlp.py:
//   K4 _fwd_call (_fwd_kernel)            -> mlp_fc1_kernel + mlp_fc2_kernel (+ epilogue)
//   K7 _bwd_call (_bwd_fused_kernel)      -> mlp_gh_kernel (+ db1 fold) + mlp_dx_kernel + K9 twice
//   K8 _bwd_call_split (_bwd_dx_kernel)   -> mlp_gh_kernel + mlp_dx_kernel
//   K9 weight_grads (_dw_kernel)          -> mlp_dw_tc_kernel (bf16), mlp_dw_kernel (f32)
// K3 (ln_mlp.cu) runs its LayerNorm rows kernel, then K4's two passes.
// Beside them, the GELU-backward pass of the 'fres' and 'lnfres' backwards,
// mlp_gelu_bwd_kernel + colsum_fold_kernel, replaces no TPU kernel: the JAX
// package's _fres_mlp_bwd and _lnfres_mlp_bwd are plain XLA, whose fusions
// take the elementwise tail between the products in one pass. Here it reads
// dh = do w2 (f32, a cuBLAS product) and the saved hpre, and writes gh =
// dh gelu'(hpre) and act = gelu(hpre) in the storage type, and each 128-row
// tile's f32 column sums of the stored gh, which colsum_fold_kernel adds in
// row-tile order into db1 (so db1 sums gh after its cast, as 'fres' does).
// What bounds it on the H100: its bytes, 10 a hidden element in bf16 (dh 4,
// hpre 2, gh 2, act 2), plus the column sums (H floats a 128-row tile).
//
// Numerics, as the Pallas kernels have them: bf16 operands with f32
// accumulation (an f32 call stores f32 but multiplies bf16 operands), the
// pre-GELU hidden hpre = x w1^T + b1 in f32, GELU and GELU' in f32 in the
// asked form (a template parameter of the fc1 and gh passes' epilogues:
// 'ans', 'tanh', 'cheb' or 'tanh5', mlp_tile.cuh; 'erf' runs as 'ans'),
// the activation act = gelu(hpre) in bf16, gh = (do w2) *
// gelu'(hpre) in f32. dx and dw1 take gh in bf16; K7's db1 sums the f32 gh,
// K9's sums the stored gh.
//
// What bounds them on the H100: their FLOPs (4 T D H forward, 10 T D H
// backward) at T of hundreds to thousands of rows.
//
// The passes, each block owning its output tiles. The forward's two and the
// dx pass share one product loop (slab_product): a 128-row block walks
// 64-wide slabs of its reduction, fed by one thread's TMA loads into a ring
// of mbarrier-tracked stages, and multiplies them on wgmma from swizzled
// shared memory (the layouts in mma.cuh); the gh pass runs the same ring
// with two products a slab.
//   - the forward (K3, K4). The TPU kernels keep a row block's hidden in
//     VMEM between fc1 and fc2; on this card that needs a [128, D] f32
//     accumulator a block (384 KB at D 768, above an SM's registers). So
//     the forward is two passes, and act ([T, H] bf16, transient) goes
//     through device memory, as K7's gh and act do: a design choice for
//     this card, not a change of function:
//       the fc1 pass, mlp_fc1_kernel: a block owns a 128-row by 64-hidden
//       tile of hpre, walks D's slabs (a 3-stage ring of 72 KB, three
//       blocks an SM, so that one's epilogue overlaps another's products),
//       adds b1 and writes hpre in the storage type where asked and act in
//       bf16. 128-wide hidden tiles (two blocks an SM) were timed beside
//       them at the step shapes: slower at ViT-B's, faster at the
//       decoder's and some of ViT-H's (PERF.md §6); one width serves;
//       the fc2 pass, mlp_fc2_kernel: the dx pass with a K-major B, a block
//       per 128 x 128 tile of out walking H's slabs of act and w2; b2 (and
//       K3's residual) in registers, or, where H is split across blocks,
//       in the partial-sum epilogue.
//   - the backward (K7 and K8 share it). The TPU kernels recompute hpre
//     tile by tile and keep gh and act in VMEM; K7 also accumulates dw/db
//     over its sequential grid of row blocks. Here three parts:
//   - the gh pass, mlp_gh_kernel: a block owns a 128-row by 128-hidden tile,
//     walks D in 64-wide slabs (TMA into a 3-stage mbarrier ring) and
//     accumulates x w1^T and do w2 in registers (two 64 x 128 f32 products
//     a warpgroup); its epilogue adds b1, forms act and gelu' in f32, gh,
//     and writes gh and act [T, H] in the storage type (and gh in bf16 for
//     the dx pass where that type is f32), and, for K7, each row tile's f32
//     column sums of gh to a [row tiles, H] workspace that a second kernel
//     folds in row-tile order into db1. D enters only as the reduction
//     length;
//   - the dx pass, mlp_dx_kernel: dx = gh_bf16 w1, a block per 128 x 128 tile
//     of dx walking H in 64-wide slabs (a 4-stage ring, one wgmma group in
//     flight while the next is issued); where the dx tiles alone would
//     leave SMs idle, H is split across blocks and an epilogue adds the f32
//     partials in a fixed order;
//   - K7's weight gradients are K9 on (x, gh) and (act, do): dw1 and dw2
//     with K9's db2; K9's db1 (from the cast gh) is discarded for the f32
//     fold above. So K7 writes gh and act ([T, H] each, transient, freed
//     after K9), which the TPU kernel kept in VMEM: a design choice for this
//     card, not a change of function. K8 returns them.
// One owner per output element, a fixed summation order, no float atomics:
// the same bits every call. What bounds the gh pass on the H100: its
// epilogue (f32 GELU and GELU' and two scattered [128, 128] stores, with
// nothing to overlap them) is a large share of a block's time, and the
// products wait on the slabs' L2 traffic (64 KB a slab, read by every
// block of a row or hidden tile); a 64-row tile with two blocks an SM, whose
// epilogues overlap, moved twice the weight bytes and was slower. A
// persistent block overlapping one tile's epilogue with the next tile's
// products, and TMA multicast of the weight slabs across a cluster, are
// the levers left.
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
#include <mma.h>

#include <type_traits>

#include "mlp_tile.cuh"
#include "mma.cuh"

namespace {

using namespace nvcuda;

// ------------------------------------ the slab product (K3, K4, K7, K8)
constexpr int SLAB_BM = 128;  // rows per block, 64 a warpgroup
constexpr int SLAB_THREADS = SLAB_BM / 64 * 128;

// The B operand of a slab product, BN columns by 64 reduction values:
// K-major, a [BN, 64] slab of a matrix whose rows are BN's (one TMA box of
// 64 columns by BN rows), or MN-major, a [64, BN] slab of one whose rows are
// the reduction's (BN / BOX boxes of BOX columns by 64 rows)
template <int BN, bool KMAJOR> struct SlabB;
template <int BN> struct SlabB<BN, true> {
  using L = GmmaKLayout<BN>;
  static constexpr int BYTES = L::BYTES, TRANS = 0;
  static __device__ __forceinline__ void load(unsigned char* dst, const CUtensorMap* map, int n0,
                                              int k0, uint64_t* bar) {
    tma_load_2d(dst, map, k0, n0, bar);
  }
  static __device__ __forceinline__ uint64_t desc(const unsigned char* p, int kk) {
    return L::desc(p, 0, kk);
  }
};
template <int BN> struct SlabB<BN, false> {
  using L = GmmaLayout<BN, 64>;
  static constexpr int BYTES = L::BYTES, TRANS = 1;
  static __device__ __forceinline__ void load(unsigned char* dst, const CUtensorMap* map, int n0,
                                              int k0, uint64_t* bar) {
#pragma unroll
    for (int c = 0; c < BN / L::BOX; ++c)
      tma_load_2d(dst + c * L::LBO, map, n0 + c * L::BOX, k0, bar);
  }
  static __device__ __forceinline__ uint64_t desc(const unsigned char* p, int kk) {
    return L::desc(p + kk * L::KSTEP);
  }
};

// a ring of STAGES slabs: A [SLAB_BM, 64] (K-major) and B, then the mbarriers
template <int BN, bool KB, int STAGES>
struct SlabSmem {
  using LA = GmmaKLayout<SLAB_BM>;
  using B = SlabB<BN, KB>;
  static constexpr int BK = LA::BK;                    // reduction values per slab
  static constexpr int STAGE = LA::BYTES + B::BYTES;   // a multiple of 1 KB
  static constexpr int BAR = STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * STAGES + 1024;  // + room to align to 1 KB
};

// dynamic shared memory rounded up to a 1 KB boundary (the swizzle follows
// address bits)
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// acc = this warpgroup's 64 rows (of the block's SLAB_BM from r0) of A
// times B's BN columns from n0, over the slabs [s0, s0 + n) of 64 reduction
// values. amap: A [rows, K] in boxes of 64 columns by SLAB_BM rows; bmap as
// SlabB loads it; bf16 with the 128-byte swizzle. One thread issues TMA
// loads AHEAD slabs ahead into the ring; each warpgroup keeps STAGES - 1 -
// AHEAD (0 or 1) wgmma groups in flight while it issues the next, so a stage
// is reloaded only after every product that read it.
template <int BN, bool KB, int STAGES, int AHEAD>
__device__ __forceinline__ void slab_product(unsigned char* smem, const CUtensorMap* amap,
                                             const CUtensorMap* bmap, int r0, int n0, int s0,
                                             int n, float (&acc)[BN / 2]) {
  using SM = SlabSmem<BN, KB, STAGES>;
  using LA = typename SM::LA;
  using B = typename SM::B;
  constexpr int IN_FLIGHT = STAGES - 1 - AHEAD;
  static_assert(IN_FLIGHT == 0 || IN_FLIGHT == 1, "slab ring depth");
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + SM::BAR);
  const int tid = threadIdx.x, wg = tid >> 7;
  auto issue = [&](int i) {  // slab s0 + i into its ring stage
    unsigned char* st = smem + (i % STAGES) * SM::STAGE;
    uint64_t* bar = bars + i % STAGES;
    const int k0 = (s0 + i) * SM::BK;
    mbar_expect_tx(bar, SM::STAGE);
    tma_load_2d(st, amap, k0, r0, bar);
    B::load(st + LA::BYTES, bmap, n0, k0, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    for (int i = 0; i < AHEAD && i < n; ++i) issue(i);
  }
  __syncthreads();  // the barriers are initialised
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    mbar_wait(bars + i % STAGES, (i / STAGES) & 1);  // slab i has landed
    __syncthreads();  // and every warpgroup is done with the stage slab i + AHEAD takes
    if (tid == 0 && i + AHEAD < n) {
      fence_proxy_async();
      issue(i + AHEAD);
    }
    const unsigned char* st = smem + (i % STAGES) * SM::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SM::BK / 16; ++kk)
      Wgmma<BN, 0, B::TRANS>::run(acc, LA::desc(st, wg * 64, kk), B::desc(st + LA::BYTES, kk));
    wgmma_commit();
    wgmma_wait<IN_FLIGHT>();
  }
  wgmma_wait<0>();
}

// f(row, col, v0, v1) for each pair of neighbouring columns this thread
// holds of its warpgroup's 64 x BN accumulator, the block's rows from r0
// and columns from c0: rows ra and ra + 8, columns 8 j + 2 t (+ 1)
template <int BN, typename F>
__device__ __forceinline__ void for_pairs(const float (&acc)[BN / 2], int r0, int c0, F&& f) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int ra = r0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int cb = c0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      f(ra + 8 * half, cb + 8 * j, acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
}

// the slab range [s0, s0 + n) of this block's part (the grid's z) of `slabs`
__device__ __forceinline__ void split_range(int slabs, int& s0, int& n) {
  s0 = (int)((long long)blockIdx.z * slabs / gridDim.z);
  n = (int)((long long)(blockIdx.z + 1) * slabs / gridDim.z) - s0;
}

// ------------------------------------------------- the fc1 pass (K3, K4)
constexpr int FC1_BH = 64;  // hidden columns per block (rows: SLAB_BM)
constexpr int FC1_STAGES = 3;

// xmap: the bf16 rows [rows, D] (x, or K3's LN(x)); wmap: w1 [H, D] in
// boxes of 64 columns by FC1_BH rows. hpre [rows, H] in T, or null; act
// [rows, H] bf16, gelu of form G. H is a multiple of FC1_BH, so every
// column tile is whole.
template <typename T, int G>
__global__ void __launch_bounds__(SLAB_THREADS, 3)
mlp_fc1_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ b1, T* __restrict__ hpre, bf16* __restrict__ act,
               int rows, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  const int h0 = blockIdx.x * FC1_BH, r0 = blockIdx.y * SLAB_BM;
  float acc[FC1_BH / 2];
  slab_product<FC1_BH, true, FC1_STAGES, FC1_STAGES - 1>(smem, &xmap, &wmap, r0, h0, 0, D / 64,
                                                         acc);
  for_pairs<FC1_BH>(acc, r0, h0, [&](int row, int col, float v0, float v1) {
    if (row >= rows) return;
    const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
    const float a0 = v0 + bb.x, a1 = v1 + bb.y;
    const size_t o = (size_t)row * H + col;
    if (hpre != nullptr) store_pair(hpre + o, a0, a1);
    store_pair(act + o, gelu_act<G>(a0), gelu_act<G>(a1));
  });
}

// ------------------------------------------------- the fc2 pass (K3, K4)
constexpr int FC2_BN = 128;  // out columns per block
constexpr int FC2_STAGES = 4;

// amap: act [rows, H] bf16 in boxes of 64 columns by SLAB_BM rows; wmap: w2
// [D, H] in boxes of 64 by FC2_BN. With one range of H (the grid's z) the
// block writes out = T(act w2^T + b2), for K3 (RESID) x + that in T, else
// its f32 partial product to partial[z] ([rows, D] each).
template <typename T, bool RESID>
__global__ void __launch_bounds__(SLAB_THREADS, 1)
mlp_fc2_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ b2, const T* __restrict__ x, T* __restrict__ out,
               float* __restrict__ partial, int rows, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  const int n0 = blockIdx.x * FC2_BN, r0 = blockIdx.y * SLAB_BM;
  int s0, n;
  split_range(H / 64, s0, n);
  float acc[FC2_BN / 2];
  slab_product<FC2_BN, true, FC2_STAGES, FC2_STAGES - 2>(smem, &amap, &wmap, r0, n0, s0, n, acc);
  float* part = partial == nullptr ? nullptr : partial + (size_t)blockIdx.z * rows * D;
  for_pairs<FC2_BN>(acc, r0, n0, [&](int row, int col, float v0, float v1) {
    if (row >= rows) return;
    const size_t o = (size_t)row * D + col;
    if (part != nullptr) {
      store_pair(part + o, v0, v1);
      return;
    }
    const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
    float y0 = v0 + bb.x, y1 = v1 + bb.y;
    if (RESID) {  // x + T(y + b2) in T, as mlp_epilogue_kernel adds it
      const float2 xv = load_pair(x + o);
      y0 = xv.x + to_f32(from_f32<T>(y0));
      y1 = xv.y + to_f32(from_f32<T>(y1));
    }
    store_pair(out + o, y0, y1);
  });
}

// ------------------------------------------------- the gh pass (K7, K8)
constexpr int GH_BH = 128;  // hidden columns per block (rows: SLAB_BM)
constexpr int GH_STAGES = 3;
constexpr int GH_WARPS = SLAB_THREADS / 32;

struct GhSmem {
  using LX = GmmaKLayout<SLAB_BM>;        // x and do slabs [BM, 64]: A, K-major
  using LW1 = GmmaKLayout<GH_BH>;         // w1 slab [BH, 64]: B of hpre, K-major
  using LW2 = GmmaLayout<GH_BH, LX::BK>;  // w2 slab [64, BH]: B of dh, MN-major
  static constexpr int BK = LX::BK;       // D values per slab
  static constexpr int X = 0;
  static constexpr int DO = X + LX::BYTES;
  static constexpr int W1 = DO + LX::BYTES;
  static constexpr int W2 = W1 + LW1::BYTES;
  static constexpr int STAGE = W2 + LW2::BYTES;  // 64 KB, a multiple of 1 KB
  static constexpr int RED = GH_STAGES * STAGE;  // f32 [warps][BH] column sums
  static constexpr int BAR = RED + GH_WARPS * GH_BH * 4;
  static constexpr int BYTES = BAR + 8 * GH_STAGES + 1024;  // + room to align to 1 KB
};

// slab s (D columns s * 64 ..) of x, do, w1 and w2 into a ring stage, by TMA
__device__ __forceinline__ void gh_issue_slab(unsigned char* st, uint64_t* bar,
                                              const CUtensorMap* xmap, const CUtensorMap* dmap,
                                              const CUtensorMap* w1map, const CUtensorMap* w2map,
                                              int r0, int h0, int s) {
  using SM = GhSmem;
  using LW2 = SM::LW2;
  const int d0 = s * SM::BK;
  mbar_expect_tx(bar, SM::STAGE);
  tma_load_2d(st + SM::X, xmap, d0, r0, bar);
  tma_load_2d(st + SM::DO, dmap, d0, r0, bar);
  tma_load_2d(st + SM::W1, w1map, d0, h0, bar);
#pragma unroll
  for (int c = 0; c < GH_BH / LW2::BOX; ++c)
    tma_load_2d(st + SM::W2 + c * LW2::LBO, w2map, h0 + c * LW2::BOX, d0, bar);
}

// xmap, dmap: x and do [rows, D] in boxes of 64 columns by SLAB_BM rows; w1map:
// w1 [H, D] in boxes of 64 by GH_BH; w2map: w2 [D, H] in boxes of 64 by 64;
// all bf16 with the 128-byte swizzle. gh, act [rows, H] in T; gh16 the bf16
// gh for the dx pass (written only where T is not bf16); colsum, when not
// null, [row tiles, H] f32 column sums of each row tile's f32 gh. GELU and
// GELU' of form G.
template <typename T, int G>
__global__ void __launch_bounds__(SLAB_THREADS, 1)
mlp_gh_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dmap,
              const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
              const float* __restrict__ b1, T* __restrict__ gh, T* __restrict__ act,
              bf16* __restrict__ gh16, float* __restrict__ colsum, int rows, int D, int H) {
  using SM = GhSmem;
  using LX = SM::LX;
  using LW1 = SM::LW1;
  using LW2 = SM::LW2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + SM::BAR);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int h0 = blockIdx.x * GH_BH, r0 = blockIdx.y * SLAB_BM;
  const int slabs = D / SM::BK;

  if (tid == 0) {
    for (int i = 0; i < GH_STAGES; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
    for (int s = 0; s < GH_STAGES - 1 && s < slabs; ++s)
      gh_issue_slab(smem + s * SM::STAGE, bars + s, &xmap, &dmap, &w1map, &w2map, r0, h0, s);
  }
  __syncthreads();  // the barriers are initialised

  float hacc[GH_BH / 2], dacc[GH_BH / 2];  // x w1^T and do w2, 64 x BH a warpgroup
#pragma unroll
  for (int i = 0; i < GH_BH / 2; ++i) hacc[i] = dacc[i] = 0.f;

  for (int s = 0; s < slabs; ++s) {
    mbar_wait(bars + s % GH_STAGES, (s / GH_STAGES) & 1);  // slab s has landed
    __syncthreads();  // and every warpgroup is done with slab s - 1
    const int next = s + GH_STAGES - 1;  // into the stage slab s - 1 held
    if (tid == 0 && next < slabs) {
      fence_proxy_async();
      gh_issue_slab(smem + (next % GH_STAGES) * SM::STAGE, bars + next % GH_STAGES, &xmap,
                    &dmap, &w1map, &w2map, r0, h0, next);
    }
    const unsigned char* st = smem + (s % GH_STAGES) * SM::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SM::BK / 16; ++kk) {
      wgmma_m64n128<0, 0>(hacc, LX::desc(st + SM::X, wg * 64, kk),
                          LW1::desc(st + SM::W1, 0, kk));
      wgmma_m64n128<0, 1>(dacc, LX::desc(st + SM::DO, wg * 64, kk),
                          LW2::desc(st + SM::W2 + kk * LW2::KSTEP));
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

  // epilogue: this thread's rows ra and ra + 8, columns 8 j + 2 t (+1)
  float* red = reinterpret_cast<float*>(smem + SM::RED);
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < GH_BH / 8; ++j) {
    const int c = 8 * j + 2 * t, col = h0 + c;
    float s0 = 0.f, s1 = 0.f;
    if (col < H) {
      const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = ra + 8 * half, i = 4 * j + 2 * half;
        if (row >= rows) continue;
        float a0, a1, q0, q1;
        gelu_act_grad<G>(hacc[i] + bb.x, a0, q0);
        gelu_act_grad<G>(hacc[i + 1] + bb.y, a1, q1);
        const float g0 = dacc[i] * q0, g1 = dacc[i + 1] * q1;
        const size_t o = (size_t)row * H + col;
        store_pair(gh + o, g0, g1);
        store_pair(act + o, a0, a1);
        if (!std::is_same<T, bf16>::value) store_pair(gh16 + o, g0, g1);
        s0 += g0;
        s1 += g1;
      }
    }
    if (colsum != nullptr) {  // the warp's 16 rows, in a fixed order
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) {
        red[warp * GH_BH + c] = s0;
        red[warp * GH_BH + c + 1] = s1;
      }
    }
  }
  if (colsum != nullptr) {  // the warps' sums, in row order
    __syncthreads();
    if (tid < GH_BH && h0 + tid < H) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < GH_WARPS; ++w) s += red[w * GH_BH + tid];
      colsum[(size_t)blockIdx.y * H + h0 + tid] = s;
    }
  }
}

// db1 [H] = the row tiles' column sums added in row-tile order
__global__ void colsum_fold_kernel(const float* __restrict__ parts, float* __restrict__ out,
                                   int tiles, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int i = 0; i < tiles; ++i) s += parts[(size_t)i * H + h];
  out[h] = s;
}

// --------------------------------- the GELU-backward pass ('fres', 'lnfres')
constexpr int GB_ROWS = 128;  // rows a block: one row of column sums (the gh pass's tile)
constexpr int GB_COLS = 128;  // hidden columns a block, 4 a lane
constexpr int GB_WARPS = 8;   // each walks GB_ROWS / GB_WARPS of the block's rows
constexpr int GB_BATCH = 4;   // rows a lane loads before it computes on them

// four neighbouring values of a row tensor as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four f32 values stored as neighbours in a row tensor of T, in one store
__device__ __forceinline__ void store_quad(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_quad(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// gh [rows, H] = dh gelu'(hpre) and act = gelu(hpre) in T, from the f32 dh
// and the saved hpre in T; colsum[blockIdx.y] gets the block's 128 rows'
// f32 column sums of the stored gh (each warp's rows in order, then the
// warps in order). A lane owns 4 neighbouring columns and walks its warp's
// rows GB_BATCH at a time, every load of a batch issued before the first
// GELU.
template <typename T, int G>
__global__ void __launch_bounds__(GB_WARPS * 32)
mlp_gelu_bwd_kernel(const float* __restrict__ dh, const T* __restrict__ hpre, T* __restrict__ gh,
                    T* __restrict__ act, float* __restrict__ colsum, int rows, int H) {
  constexpr int WROWS = GB_ROWS / GB_WARPS;
  __shared__ float red[GB_WARPS][GB_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * GB_COLS + 4 * lane;
  const int r0 = blockIdx.y * GB_ROWS + warp * WROWS;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < H) {
#pragma unroll 1
    for (int b = 0; b < WROWS; b += GB_BATCH) {
      float4 d[GB_BATCH], x[GB_BATCH];
#pragma unroll
      for (int i = 0; i < GB_BATCH; ++i) {
        const int row = r0 + b + i;
        if (row < rows) {
          const size_t o = (size_t)row * H + col;
          d[i] = load_quad(dh + o);
          x[i] = load_quad(hpre + o);
        }
      }
#pragma unroll
      for (int i = 0; i < GB_BATCH; ++i) {
        const int row = r0 + b + i;
        if (row >= rows) break;
        const float dv[4] = {d[i].x, d[i].y, d[i].z, d[i].w};
        const float xv[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
        float a[4], g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float q;
          gelu_act_grad<G>(xv[j], a[j], q);
          // the stored gh, as db1 sums it
          g[j] = to_f32(from_f32<T>(dv[j] * q));
          s[j] += g[j];
        }
        const size_t o = (size_t)row * H + col;
        store_quad(gh + o, g);
        store_quad(act + o, a);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[warp][4 * lane + j] = s[j];
  __syncthreads();
  const int c = threadIdx.x, h = blockIdx.x * GB_COLS + c;
  if (c < GB_COLS && h < H) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < GB_WARPS; ++w) t += red[w][c];
    colsum[(size_t)blockIdx.y * H + h] = t;
  }
}

// ------------------------------------------------- the dx pass (K7, K8)
constexpr int DX_BN = 128;  // dx columns per block
constexpr int DX_STAGES = 4;
using DxSmem = SlabSmem<DX_BN, false, DX_STAGES>;

// gmap: gh16 [rows, H] in boxes of 64 columns by SLAB_BM rows; wmap: w1 [H,
// D] in boxes of 64 by 64; both bf16 with the 128-byte swizzle. The grid's
// z cuts H's slabs into contiguous ranges: with one range the block writes
// dx in T, else its f32 partial product to partial[z] ([rows, D] each).
template <typename T>
__global__ void __launch_bounds__(SLAB_THREADS, 1)
mlp_dx_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap wmap,
              T* __restrict__ dx, float* __restrict__ partial, int rows, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  const int n0 = blockIdx.x * DX_BN, r0 = blockIdx.y * SLAB_BM;
  int s0, n;
  split_range(H / 64, s0, n);
  float acc[DX_BN / 2];
  slab_product<DX_BN, false, DX_STAGES, DX_STAGES - 2>(smem, &gmap, &wmap, r0, n0, s0, n, acc);
  float* part = partial == nullptr ? nullptr : partial + (size_t)blockIdx.z * rows * D;
  for_pairs<DX_BN>(acc, r0, n0, [&](int row, int col, float v0, float v1) {
    if (row >= rows) return;
    const size_t o = (size_t)row * D + col;
    if (part != nullptr)
      store_pair(part + o, v0, v1);
    else
      store_pair(dx + o, v0, v1);
  });
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
  unsigned char* smem = smem_1k(smem_raw);
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
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;

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
    load_tile<T, DW_ROWS, DW_THREADS>(a + m0, m, As, LDT, DW_TILE, r0, rows);
    load_tile<T, DW_ROWS, DW_THREADS>(g + n0, n, Gs, LDT, DW_TILE, r0, rows);
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

// the TMA map of a row-major bf16 [rows, cols] matrix in boxes of box_rows
// rows by box_cols columns, swizzled by `sw` bytes (64 or 128); reads past
// the matrix give zeros
bool tma_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols, int box_rows,
             int sw) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K9's map: boxes of DW_BK rows by L::BOX columns, swizzled as L lays them out
template <typename L>
bool dw_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  return tma_map(map, ptr, rows, cols, L::BOX, DW_BK, L::SW);
}

template <typename T, int G>
int launch_gh(const void* x16, const void* w1, const void* b1, const void* w2, const void* do16,
              void* gh, void* act, void* gh16, void* colsum, void* db1, int rows, int D, int H,
              cudaStream_t stream) {
  using SM = GhSmem;
  CUtensorMap xmap, dmap, w1map, w2map;
  if (!tma_map(&xmap, x16, rows, D, SM::BK, SLAB_BM, 128) ||
      !tma_map(&dmap, do16, rows, D, SM::BK, SLAB_BM, 128) ||
      !tma_map(&w1map, w1, H, D, SM::BK, GH_BH, 128) ||
      !tma_map(&w2map, w2, D, H, SM::LW2::BOX, SM::BK, SM::LW2::SW))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mlp_gh_kernel<T, G>, SM::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (rows + SLAB_BM - 1) / SLAB_BM;
  mlp_gh_kernel<T, G><<<dim3((H + GH_BH - 1) / GH_BH, tiles), SLAB_THREADS, SM::BYTES, stream>>>(
      xmap, dmap, w1map, w2map, static_cast<const float*>(b1), static_cast<T*>(gh),
      static_cast<T*>(act), static_cast<bf16*>(gh16), static_cast<float*>(colsum), rows, D, H);
  err = cudaGetLastError();
  if (err != cudaSuccess || colsum == nullptr) return (int)err;
  colsum_fold_kernel<<<(H + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(colsum),
                                                          static_cast<float*>(db1), tiles, H);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_gelu_bwd(const void* dh, const void* hpre, void* gh, void* act, void* colsum,
                    void* db1, int rows, int H, cudaStream_t stream) {
  const int tiles = (rows + GB_ROWS - 1) / GB_ROWS;
  mlp_gelu_bwd_kernel<T, G><<<dim3((H + GB_COLS - 1) / GB_COLS, tiles), GB_WARPS * 32, 0,
                              stream>>>(static_cast<const float*>(dh), static_cast<const T*>(hpre),
                                        static_cast<T*>(gh), static_cast<T*>(act),
                                        static_cast<float*>(colsum), rows, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  colsum_fold_kernel<<<(H + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(colsum),
                                                          static_cast<float*>(db1), tiles, H);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_fc1(const void* x16, const void* w1, const void* b1, void* hpre, void* act, int rows,
               int D, int H, cudaStream_t stream) {
  using SM = SlabSmem<FC1_BH, true, FC1_STAGES>;
  CUtensorMap xmap, wmap;
  if (!tma_map(&xmap, x16, rows, D, SM::BK, SLAB_BM, 128) ||
      !tma_map(&wmap, w1, H, D, SM::BK, FC1_BH, 128))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mlp_fc1_kernel<T, G>, SM::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / FC1_BH, (rows + SLAB_BM - 1) / SLAB_BM);
  mlp_fc1_kernel<T, G><<<grid, SLAB_THREADS, SM::BYTES, stream>>>(
      xmap, wmap, static_cast<const float*>(b1), static_cast<T*>(hpre), static_cast<bf16*>(act),
      rows, D, H);
  return (int)cudaGetLastError();
}

template <typename T, bool RESID>
int launch_fc2(const void* act, const void* w2, const void* b2, const void* x, void* out,
               void* partial, int rows, int D, int H, int splits, cudaStream_t stream) {
  using SM = SlabSmem<FC2_BN, true, FC2_STAGES>;
  CUtensorMap amap, wmap;
  if (!tma_map(&amap, act, rows, H, SM::BK, SLAB_BM, 128) ||
      !tma_map(&wmap, w2, D, H, SM::BK, FC2_BN, 128))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mlp_fc2_kernel<T, RESID>, SM::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(D / FC2_BN, (rows + SLAB_BM - 1) / SLAB_BM, splits);
  mlp_fc2_kernel<T, RESID><<<grid, SLAB_THREADS, SM::BYTES, stream>>>(
      amap, wmap, static_cast<const float*>(b2), static_cast<const T*>(x), static_cast<T*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, rows, D, H);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_epilogue<T, true, RESID>(x, partial, b2, out, rows, D, splits, stream);
}

template <typename T>
int launch_dx(const void* gh16, const void* w1, void* dx, void* partial, int rows, int D, int H,
              int splits, cudaStream_t stream) {
  using SM = DxSmem;
  CUtensorMap gmap, wmap;
  if (!tma_map(&gmap, gh16, rows, H, SM::BK, SLAB_BM, 128) ||
      !tma_map(&wmap, w1, H, D, SM::B::L::BOX, SM::BK, SM::B::L::SW))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mlp_dx_kernel<T>, SM::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(D / DX_BN, (rows + SLAB_BM - 1) / SLAB_BM, splits);
  mlp_dx_kernel<T><<<grid, SLAB_THREADS, SM::BYTES, stream>>>(
      gmap, wmap, static_cast<T*>(dx), splits > 1 ? static_cast<float*>(partial) : nullptr,
      rows, D, H);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_epilogue<T, false, false>(nullptr, partial, nullptr, dx, rows, D, splits,
                                               stream);
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
}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, out, hpre, dx, gh, act, a, g). Each
// returns cudaGetLastError().

// CALL(TYPE, G) for the asked dtype and GELU form
#define AVSIAM_GELU_FORM(CALL, TYPE)         \
  switch (gelu) {                            \
    case GELU_ANS: CALL(TYPE, GELU_ANS);     \
    case GELU_TANH: CALL(TYPE, GELU_TANH);   \
    case GELU_CHEB: CALL(TYPE, GELU_CHEB);   \
    case GELU_TANH5: CALL(TYPE, GELU_TANH5); \
    default: return (int)cudaErrorInvalidValue; \
  }
#define AVSIAM_GELU_DISPATCH(CALL)                  \
  if (dtype == 1) AVSIAM_GELU_FORM(CALL, bf16)      \
  if (dtype == 0) AVSIAM_GELU_FORM(CALL, float)     \
  return (int)cudaErrorInvalidValue;

// The fc1 pass of K3 and K4: x16 [rows, D] bf16 (D a multiple of 64), w1
// [H, D] bf16, b1 [H] f32 (H a multiple of 64); hpre [rows, H] in dtype
// (or null), act [rows, H] bf16; gelu the form's GeluForm code.
extern "C" int avsiam_mlp_fc1(const void* x16, const void* w1, const void* b1, void* hpre,
                              void* act, int rows, int D, int H, int dtype, int gelu,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || H <= 0 || D % 64 != 0 || H % FC1_BH != 0)
    return (int)cudaErrorInvalidValue;
#define AVSIAM_FC1(TYPE, G) return launch_fc1<TYPE, G>(x16, w1, b1, hpre, act, rows, D, H, s)
  AVSIAM_GELU_DISPATCH(AVSIAM_FC1)
#undef AVSIAM_FC1
}

// The fc2 pass of K3 and K4: out [rows, D] in dtype = act16 [rows, H]
// (bf16) w2^T (w2 [D, H] bf16) + b2 ([D] f32), plus the residual x ([rows,
// D] in dtype) where it is not null. D a multiple of 128, H of 64; 1 <=
// splits <= H / 64 ranges of H; partial: f32 scratch [splits, rows, D]
// where splits > 1 (else unused).
extern "C" int avsiam_mlp_fc2(const void* act16, const void* w2, const void* b2, const void* x,
                              void* out, void* partial, int rows, int D, int H, int splits,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || H <= 0 || D % FC2_BN != 0 || H % 64 != 0 || splits < 1 ||
      splits > H / 64 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
#define AVSIAM_FC2(TYPE)                                                                    \
  return x != nullptr                                                                       \
             ? launch_fc2<TYPE, true>(act16, w2, b2, x, out, partial, rows, D, H, splits, s) \
             : launch_fc2<TYPE, false>(act16, w2, b2, x, out, partial, rows, D, H, splits, s)
  if (dtype == 1) AVSIAM_FC2(bf16);
  if (dtype == 0) AVSIAM_FC2(float);
#undef AVSIAM_FC2
  return (int)cudaErrorInvalidValue;
}

// The gh pass of K7 and K8. x16, do16 [rows, D] bf16; w1 [H, D], w2 [D, H]
// bf16; b1 [H] f32; D and H multiples of 64. gh, act [rows, H] in dtype;
// gh16 [rows, H] bf16 (gh itself for bfloat16). For K7's db1: colsum, f32
// scratch [ceil(rows / 128), H], and db1 [H] f32; for K8 both null. gelu:
// the form's GeluForm code.
extern "C" int avsiam_mlp_bwd_gh(const void* x16, const void* w1, const void* b1, const void* w2,
                                 const void* do16, void* gh, void* act, void* gh16, void* colsum,
                                 void* db1, int rows, int D, int H, int dtype, int gelu,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || H <= 0 || D % GhSmem::BK != 0 || H % 64 != 0 ||
      (colsum == nullptr) != (db1 == nullptr))
    return (int)cudaErrorInvalidValue;
  // gh16 is gh itself for bfloat16
#define AVSIAM_GH(TYPE, G)                                                                \
  return launch_gh<TYPE, G>(x16, w1, b1, w2, do16, gh, act,                               \
                            std::is_same<TYPE, bf16>::value ? gh : gh16, colsum, db1, rows, \
                            D, H, s)
  AVSIAM_GELU_DISPATCH(AVSIAM_GH)
#undef AVSIAM_GH
}

// The GELU-backward pass of the 'fres' and 'lnfres' backwards: dh [rows, H]
// f32 (do w2, a cuBLAS product), hpre [rows, H] in dtype; gh = dh
// gelu'(hpre) and act = gelu(hpre) [rows, H] in dtype; colsum, f32 scratch
// [ceil(rows / 128), H]; db1 [H] f32, the column sums of the stored gh folded
// in row-tile order. H a multiple of 4, every row tensor 16-byte aligned.
// gelu: the form's GeluForm code.
extern "C" int avsiam_mlp_gelu_bwd(const void* dh, const void* hpre, void* gh, void* act,
                                   void* colsum, void* db1, int rows, int H, int dtype, int gelu,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || H <= 0 || H % 4 != 0) return (int)cudaErrorInvalidValue;
#define AVSIAM_GELU_BWD(TYPE, G) \
  return launch_gelu_bwd<TYPE, G>(dh, hpre, gh, act, colsum, db1, rows, H, s)
  AVSIAM_GELU_DISPATCH(AVSIAM_GELU_BWD)
#undef AVSIAM_GELU_BWD
}

// The dx pass of K7 and K8: dx [rows, D] in dtype = gh16 [rows, H] (bf16)
// w1 [H, D] (bf16), f32 accumulation. D a multiple of 128, H of 64; 1 <=
// splits <= H / 64 ranges of H; partial: f32 scratch [splits, rows, D]
// where splits > 1 (else unused).
extern "C" int avsiam_mlp_bwd_dx(const void* gh16, const void* w1, void* dx, void* partial,
                                 int rows, int D, int H, int splits, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || H <= 0 || D % DX_BN != 0 || H % 64 != 0 || splits < 1 ||
      splits > H / 64 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_dx<bf16>(gh16, w1, dx, partial, rows, D, H, splits, s);
  if (dtype == 0) return launch_dx<float>(gh16, w1, dx, partial, rows, D, H, splits, s);
  return (int)cudaErrorInvalidValue;
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
