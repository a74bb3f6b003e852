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
//   - K9: a block per 64 x 64 tile of dw walks all rows.
// wgmma, TMA-fed tiles and a row split of the weight gradients are later work.
//
// Weights use nn.Linear's layout: w1 [H, D] (fc1.weight), w2 [D, H]
// (fc2.weight); biases are f32. Gradients likewise: dw1 [H, D], dw2 [D, H].

#include "mlp_tile.cuh"

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

// K9: a [rows, m], g [rows, n] -> dw [n, m] = g^T a, db [n] = column sums of
// g, in f32; m and n multiples of 64
extern "C" int avsiam_mlp_dw(const void* a, const void* g, void* dw, void* db, int rows, int m,
                             int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || m % DW_TILE != 0 || n % DW_TILE != 0 || m <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(m / DW_TILE, n / DW_TILE);
  if (dtype == 1)
    mlp_dw_kernel<bf16><<<grid, DW_THREADS, 0, s>>>(static_cast<const bf16*>(a),
                                                    static_cast<const bf16*>(g),
                                                    static_cast<float*>(dw),
                                                    static_cast<float*>(db), rows, m, n);
  else if (dtype == 0)
    mlp_dw_kernel<float><<<grid, DW_THREADS, 0, s>>>(static_cast<const float*>(a),
                                                     static_cast<const float*>(g),
                                                     static_cast<float*>(dw),
                                                     static_cast<float*>(db), rows, m, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
