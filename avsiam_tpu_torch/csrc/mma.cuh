// Tensor-core and copy helpers of the redesigned kernels (K6, K9), sm_90a:
// mma.sync m16n8k16 with bf16 operands and f32 accumulators, ldmatrix and
// cp.async (K6); wgmma m64nNk16 with operands in swizzled shared memory, fed
// by TMA loads that complete on mbarriers (K9).
//
// K-major wgmma operands (GmmaKLayout) serve the MLP passes (K3, K4, K7,
// K8), whose x, do, act and gh rows and w1 and w2 rows are
// reduction-contiguous.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A 16 x 16, four 32-bit registers of two bf16 each: a0 = (g, 2t..2t+1),
//     a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
//   B 16 x 8: b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g);
//   C 16 x 8 f32: c0, c1 = (g, 2t), (g, 2t + 1); c2, c3 = (g + 8, 2t..).
// So the C tiles of two neighbouring 8-column blocks, rounded to bf16 in
// pairs, are the A fragment of one 16-deep step (pack_a): a product's result
// feeds the next product from registers. A wgmma m64nN accumulator holds, in
// warp w of the warpgroup, rows 16 w + g (+ 8) in the same layout: d[4 j ..
// 4 j + 3] is the C tile of columns 8 j .. 8 j + 7.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 (16 contiguous bytes), and r[i] receives matrix i's element
// pair (row g, columns 2t, 2t + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same with each matrix transposed: r[i] receives (rows 2t, 2t + 1,
// column g) of matrix i as stored.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b on the tensor cores (f32 accumulation)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16-deep step from the f32 C tiles c0 (columns 0-7 of
// the step) and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes from global to shared memory without passing through registers;
// when !valid nothing is read and the 16 bytes become zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x by the special-function unit alone; a result below 2^-126 is flushed
// to 0 (exp2f adds a range test and two multiplies to keep it).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two values stored as a pair at p (8 bytes of f32, 4 of bf16).
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------------ wgmma
// Shared-memory operand layouts for MN-major (transposed) wgmma operands,
// stored as K rows of W values. The rows are cut into swizzle atoms of 8 K
// rows by SW bytes of MN values (SW = 128: 64 values, 1 KB; SW = 64: 32
// values, 512 B); in an atom each 16-byte chunk of row r is stored at chunk
// index XOR (r for 128, r / 2 for 64), so the 8 rows a tensor-core read
// takes fall in different banks. K-adjacent atoms are contiguous (the
// descriptor's stride byte offset), MN-adjacent ones `rows / 8` atoms apart
// (its leading byte offset): each column of atoms is what one TMA box of
// SW / 2 columns by `rows` rows writes with the same swizzle. The swizzle
// follows address bits, so each operand region starts on a 1 KB boundary.
template <int W, int ROWS>
struct GmmaLayout {
  static constexpr int SW = W % 64 == 0 ? 128 : 64;  // swizzle bytes
  static constexpr int BOX = SW / 2;                 // values per atom row
  static_assert(W % BOX == 0 && ROWS % 16 == 0, "MN-major wgmma operand layout");
  static constexpr int ATOM = 8 * SW;                // bytes of an atom
  static constexpr int LBO = ROWS / 8 * ATOM;        // MN-adjacent atoms
  static constexpr int KSTEP = 2 * ATOM;             // bytes per 16 K rows
  static constexpr int BYTES = ROWS * W * 2;
  // byte offset of the 16-byte chunk c (values 8 c .. 8 c + 7) of row k
  static __device__ __forceinline__ int chunk(int k, int c) {
    constexpr int PER = BOX / 8;  // chunks per atom row
    const int r = k & 7, x = SW == 128 ? r : r >> 1;
    return (c / PER) * LBO + (k >> 3) * ATOM + r * SW + (((c % PER) ^ x) << 4);
  }
  // the descriptor of the operand whose rows start at p (an atom boundary)
  static __device__ __forceinline__ uint64_t desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
           ((uint64_t)(ATOM >> 4) << 32) | ((uint64_t)(SW == 128 ? 1 : 2) << 62);
  }
};

// K-major (not transposed) wgmma operand: ROWS rows (M or N) of 64
// reduction values, 128 bytes a row, in the 128-byte swizzle: each 8-row
// atom of 1 KB stores chunk c of row r at chunk c XOR (r % 8). One TMA box
// of 64 columns by ROWS rows with CU_TENSOR_MAP_SWIZZLE_128B writes exactly
// this. The descriptor's stride byte offset steps 8 rows (1 KB); its
// leading byte offset is unused for a swizzled K-major operand; a 16-deep
// step k starts 32 k bytes into the row (the swizzle follows the address
// bits, so the region starts on a 1 KB boundary).
template <int ROWS>
struct GmmaKLayout {
  static_assert(ROWS % 8 == 0, "K-major wgmma operand layout");
  static constexpr int BK = 64;  // reduction values per row
  static constexpr int BYTES = ROWS * BK * 2;
  // the descriptor of rows r0 .. (a multiple of 8), 16-deep step k
  static __device__ __forceinline__ uint64_t desc(const void* base, int r0, int k) {
    const uint32_t a = smem_u32(base) + r0 * 128 + k * 32;
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
           ((uint64_t)1 << 62);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA writes, wgmma reads) of the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------ TMA and mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of TMA transfers before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the end of the barrier's phase of the given parity. A transfer
// lands in microseconds; a wait past about a second means one was lost, and
// the kernel traps, so that its launch reports an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int i = 0; i < (1 << 22); ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}
// TMA: the box at column x, row y of the tensor `map` describes, into dst
// (laid out as the map's swizzle says); completes `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// d += A B, m64n96k16: A [64 x 16] and B [16 x 96] from shared memory, both
// MN-major (stored K-row by K-row, so both transposed), d f32 [64 x 96]
__device__ __forceinline__ void wgmma_m64n96(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B, m64n128k16: A [64 x 16] and B [16 x 128] from shared memory, d
// f32 [64 x 128]; TA, TB = 1 where the operand is MN-major (stored K-row by
// K-row, so transposed), 0 where it is K-major (GmmaKLayout)
template <int TA = 1, int TB = 1>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d += A B, m64n64k16: A [64 x 16] and B [16 x 64] from shared memory, d f32
// [64 x 64]; TA, TB as for m64n128
template <int TA = 1, int TB = 1>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d += A B with N columns (64, 96 or 128): a 64 x N f32 accumulator of N / 2
// values a thread; TA, TB as above (m64n96 only MN-major)
template <int N, int TA = 1, int TB = 1> struct Wgmma;
template <int TA, int TB> struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    wgmma_m64n64<TA, TB>(d, a, b);
  }
};
template <> struct Wgmma<96, 1, 1> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t a, uint64_t b) {
    wgmma_m64n96(d, a, b);
  }
};
template <int TA, int TB> struct Wgmma<128, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    wgmma_m64n128<TA, TB>(d, a, b);
  }
};

}  // namespace
