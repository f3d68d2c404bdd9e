// Hopper building blocks of the single-pass attention kernels (attention.cu
// forward, attention_bwd.cu backward, for T <= 256): TMA loads of a head's
// column stripe into swizzled shared memory, completed on an mbarrier, and
// warpgroup matrix products (wgmma) that read those tiles in place.
//
// A stripe tile holds R token rows of one head, its head dim zero-padded to
// HDP (16, 32, 64 or 128). TMA writes it in the 32-, 64- or 128-byte
// swizzled layout whose rows are HDP * 2 bytes (HDP <= 64), or as two
// 64-column panels of 128-byte rows (HDP = 128), R rows apart. wgmma reads
// the same tile two ways:
//  * K-major (rows = the product's M or N, the head dim contracted): the
//    descriptor starts at the row and at the 16-column step's 32 bytes
//    within the swizzled row; SBO = 8 rows (one swizzle atom).
//  * N-major (rows = the contracted tokens, the head dim = N, trans-b):
//    16 rows per k-step = two swizzle atoms; SBO = 8 rows again.
// Tiles start at 1024-byte boundaries so every swizzle atom is aligned and
// the descriptors' base offset is 0.
//
// The tensor map views q, k, v (or do) as a 4-D tensor {hd, heads, T, B}
// with strides {hd, ld, T ld} elements: a box {min(HDP, 64), 1, R, 1} at
// (column, head, token row, image) reads one head's stripe, and the
// columns past hd and the rows past T fall outside the tensor, so TMA fills
// them with zeros. That is the zero padding of the head dim and of the
// token rows; no neighbouring head's or image's data enters a product.
// cuTensorMapEncodeTiled comes from libcuda through
// cudaGetDriverEntryPoint, so the library does not link libcuda.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace pdm_hop {

using pdm_attn::smem_addr;

constexpr int kRows = 64;       // wgmma M: query rows per strip, keys per chunk
constexpr int kMaxChunks = 4;   // T <= 256 in one pass
constexpr int kMaxTokens = kRows * kMaxChunks;
constexpr int kWgThreads = 128; // one warpgroup
constexpr int kWgs = 2;         // warpgroups per block
constexpr int kThreads = kWgs * kWgThreads;

// Geometry of a stripe tile at padded head dim HDP.
template <int HDP>
struct Stripe {
  static_assert(HDP == 16 || HDP == 32 || HDP == 64 || HDP == 128, "HDP");
  static constexpr int kBW = HDP < 64 ? HDP : 64;     // columns per swizzled row
  static constexpr int kRB = kBW * 2;                 // bytes per row
  static constexpr int kPanels = HDP / kBW;           // 1, or 2 at HDP 128
  static constexpr int kKSteps = HDP / 16;            // k16 steps over the head dim
  static constexpr int kStepsPerRow = kRB / 32;
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kRB == 128 ? 1 : (kRB == 64 ? 2 : 3);
  static constexpr int kSBO = 8 * kRB;                // one swizzle atom
  __host__ __device__ static constexpr int bytes(int rows) { return rows * HDP * 2; }
};

__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  uint64_t d = (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFFu) << 32;
  d |= layout << 62;
  return d;
}

// K-major operand: rows [row0, row0 + 64) of a tile of `rows` rows, head-dim
// columns [16 kk, 16 kk + 16)
template <int HDP>
__device__ __forceinline__ uint64_t desc_k(const char* tile, int rows, int row0,
                                           int kk) {
  using S = Stripe<HDP>;
  const char* p = tile + (kk / S::kStepsPerRow) * rows * S::kRB + row0 * S::kRB +
                  (kk % S::kStepsPerRow) * 32;
  return make_desc(p, 16, S::kSBO, S::kLayout);
}

// N-major operand: tile rows [16 j, 16 j + 16) contracted, head-dim panel n
// (columns [64 n, 64 n + kBW)) as N
template <int HDP>
__device__ __forceinline__ uint64_t desc_mn(const char* tile, int rows, int j, int n) {
  using S = Stripe<HDP>;
  const char* p = tile + n * rows * S::kRB + j * 16 * S::kRB;
  return make_desc(p, rows * S::kRB, S::kSBO, S::kLayout);
}

// ---------------------------------------------------------------------------
// mbarrier and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of TMA transactions on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the barrier's phase `phase` to complete. A load that never
// completes (a fault in its tensor map) traps after ~2^28 polls, seconds,
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
}

// one box of the 4-D stripe map at (column, head, token row, image)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head, int row,
                                         int img) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(head),
      "r"(row), "r"(img)
      : "memory");
}

// rows [row0, row0 + rows) of head h of image b (the map's box rows) into
// a stripe tile of tile_rows rows (both panels at HDP 128; by default the
// box fills the tile)
template <int HDP>
__device__ __forceinline__ void load_stripe(char* tile, const CUtensorMap* map,
                                            uint64_t* bar, int rows, int h,
                                            int row0, int b, int tile_rows = 0) {
  using S = Stripe<HDP>;
  const int panel = (tile_rows ? tile_rows : rows) * S::kRB;
#pragma unroll
  for (int p = 0; p < S::kPanels; ++p) tma_load(tile + p * panel, map, bar, p * 64, h, row0, b);
}

// the block's warpgroups meet (named barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void wgs_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// 2^x on the MUFU unit (-inf gives +0; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep registers that an in-flight wgmma reads or writes where they are
// until after its wait (no reordering, no reuse of the physical registers)
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// d (64 x 64, fp32) += A (64 x 16, K-major, shared) * B (64 x 16, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 16, fp32) += A (64 x 16, bf16 registers) * B (16 x 16, N-major, shared)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 registers) * B (16 x 32, N-major, shared)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, N-major, shared)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}



// d (64 x 128, fp32) += A (64 x 16, K-major, shared) * B (128 x 16, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 192, fp32) += A (64 x 16, K-major, shared) * B (192 x 16, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16, K-major, shared) * B (256 x 16, K-major, shared)
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


// S-type product over NC 64-row chunks of B at once: m64n(64 NC)k16
template <int NC>
__device__ __forceinline__ void wgmma_ss(float (&d)[NC * 32], uint64_t da, uint64_t db) {
  if constexpr (NC == 1) wgmma_ss_n64(d, da, db);
  else if constexpr (NC == 2) wgmma_ss_n128(d, da, db);
  else if constexpr (NC == 3) wgmma_ss_n192(d, da, db);
  else wgmma_ss_n256(d, da, db);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// ---------------------------------------------------------------------------
// accumulator <-> A fragments
//
// A 64 x N fp32 accumulator (wgmma m64nN): warp w holds rows 16 w + g
// (registers 4 i, 4 i + 1) and 16 w + g + 8 (4 i + 2, 4 i + 3) at columns
// 8 i + 2 tq + {0, 1}, g = lane / 4, tq = lane % 4. The A fragment of the
// 16-column slice jj is registers 8 jj .. 8 jj + 7 rounded to bf16 in pairs.

template <int R>
__device__ __forceinline__ void pack_slice(uint32_t (&a)[4], const float (&s)[R],
                                           int jj) {
  a[0] = pdm_attn::pack_bf16(s[8 * jj + 0], s[8 * jj + 1]);
  a[1] = pdm_attn::pack_bf16(s[8 * jj + 2], s[8 * jj + 3]);
  a[2] = pdm_attn::pack_bf16(s[8 * jj + 4], s[8 * jj + 5]);
  a[3] = pdm_attn::pack_bf16(s[8 * jj + 6], s[8 * jj + 7]);
}

// the value of accumulator register 4 i + e, as packed by pack_slice
__device__ __forceinline__ float unpack(const uint32_t (&a)[4], int i, int e) {
  const uint32_t u = a[(i & 1) * 2 + (e >> 1)];
  return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
}

// Rows 16 w + g (+ 8) of a 64 x HDP accumulator (panels of kBW columns;
// w the warp in its warpgroup),
// times `mul`, as bf16 into a contiguous (B, T, C) tensor at head column
// col0: rows >= n_tok and columns >= hd are padding and are not written.
template <int HDP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out,
                                          const float (&acc)[Stripe<HDP>::kPanels]
                                                            [Stripe<HDP>::kBW / 2],
                                          float mul, long long row_base, int row0,
                                          int n_tok, int C, int col0, int hd) {
  using S = Stripe<HDP>;
  const int warp = (threadIdx.x & (kWgThreads - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n_tok) continue;
    __nv_bfloat16* o = out + (row_base + row) * C + col0;
#pragma unroll
    for (int n = 0; n < S::kPanels; ++n)
#pragma unroll
      for (int i = 0; i < S::kBW / 8; ++i) {
        const int col = n * 64 + i * 8 + 2 * tq;
        if (col < hd)
          *reinterpret_cast<uint32_t*>(o + col) = pdm_attn::pack_bf16(
              acc[n][4 * i + 2 * r] * mul, acc[n][4 * i + 2 * r + 1] * mul);
      }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// The 4-D map {hd, heads, T, B} (strides {hd, ld, T ld} elements) over bf16
// stripes at `base`, boxes {min(HDP, 64), 1, box_rows, 1}, swizzled for
// HDP's row width. Returns false if the encoding is refused.
template <int HDP>
static inline bool stripe_map(CUtensorMap* map, const void* base, int B, int n_tok,
                              int heads, int hd, long long ld, int box_rows) {
  using S = Stripe<HDP>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)n_tok,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)ld * 2,
                                 (cuuint64_t)n_tok * ld * 2};
  const cuuint32_t box[4] = {(cuuint32_t)S::kBW, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = S::kRB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : S::kRB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The persistent kernels' grid and ring: one block per SM (or per work
// item, if fewer), and two stages of shared memory where two fit in the
// block's opt-in limit beside `reserved` bytes of static memory, else one.
struct Ring {
  int blocks, stages;
};

static inline Ring ring_for(int items, int stage_bytes, int reserved) {
  static int sms[64] = {0}, optin[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  dev &= 63;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  Ring r;
  r.blocks = items < sms[dev] ? items : sms[dev];
  r.stages = 2 * stage_bytes + 1024 + reserved <= optin[dev] ? 2 : 1;
  return r;
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in, once.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the 1024-byte aligned start of a kernel's dynamic shared memory
__device__ __forceinline__ char* aligned_smem(char* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

}  // namespace pdm_hop
