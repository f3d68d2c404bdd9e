// Hopper building blocks of the single-pass attention kernels (attention.cu
// forward, attention_bwd.cu backward, for T <= 256) and of the whole
// attention block (attention_block*.cu): TMA loads of a head's column
// stripe into swizzled shared memory, completed on an mbarrier, warpgroup
// matrix products (wgmma) that read those tiles in place, the single-pass
// strip functions (fwd_strip, dq_strip, dkdv_strip) over a row layout
// (PlainRows: one image; PackedRows: several images a 64-row strip), and
// a TMA ring for streamed products (StageRing, ring_sweep).
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



template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n16t(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32t(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n48t(float (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64t(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n96t(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128t(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n192t(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256t(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x N, fp32) += A (64 x 16) * B (16 x N), both from shared memory; TA / TB
// 1: the operand is MN-major (its M or N dimension contiguous in a row)
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 || N == 128 ||
                N == 192 || N == 256, "wgmma N");
  if constexpr (N == 16) wgmma_ss_n16t<TA, TB>(d, da, db);
  else if constexpr (N == 32) wgmma_ss_n32t<TA, TB>(d, da, db);
  else if constexpr (N == 48) wgmma_ss_n48t<TA, TB>(d, da, db);
  else if constexpr (N == 64) wgmma_ss_n64t<TA, TB>(d, da, db);
  else if constexpr (N == 96) wgmma_ss_n96t<TA, TB>(d, da, db);
  else if constexpr (N == 128) wgmma_ss_n128t<TA, TB>(d, da, db);
  else if constexpr (N == 192) wgmma_ss_n192t<TA, TB>(d, da, db);
  else if constexpr (N == 256) wgmma_ss_n256t<TA, TB>(d, da, db);
}

// S-type product over NC 64-row chunks of B at once: m64n(64 NC)k16
template <int NC>
__device__ __forceinline__ void wgmma_ss(float (&d)[NC * 32], uint64_t da, uint64_t db) {
  wgmma_ss_t<64 * NC>(d, da, db);
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

// ---------------------------------------------------------------------------
// token rows of an (image, head) tile
//
// A tile holds 64-row strips. PlainRows: one image, tile row t is token t,
// keys [0, n_tok) (rows past n_tok are TMA's zero fill). PackedRows (the
// whole-block kernels at T <= 64): each strip holds P = 64 / Tr images,
// image img0 + row / Tr at rows Tr apart (Tr a power of two >= T, so a
// strip is exactly 64 rows and TMA zero-fills the rows t >= T of each
// image); a query attends only to the valid keys of its own image (the
// block-diagonal mask), and its key strip is its own (key0).

struct PlainRows {
  static constexpr bool kPacked = false;
  int n_tok;
  long long base, lbase;  // b n_tok, and (b heads + h) n_tok
  // first tile row of strip st's keys
  __device__ __forceinline__ int key0(int) const { return 0; }
  __device__ __forceinline__ bool masks(int rows) const { return n_tok < rows; }
  // key `key` (from key0) for query tile row `row`
  __device__ __forceinline__ bool key_ok(int, int key) const { return key < n_tok; }
  // whether tile row `row` holds a token (not padding)
  __device__ __forceinline__ bool has(int row) const { return row < n_tok; }
  // a token row's row of (B, T, .) tensors
  __device__ __forceinline__ long long grow(int row) const { return base + row; }
  // a token row's index into (B, heads, T) row statistics
  __device__ __forceinline__ long long lidx(int row) const { return lbase + row; }
};

struct PackedRows {
  static constexpr bool kPacked = true;
  int n_tok, B, img0, trs, heads, h;  // Tr = 1 << trs
  __device__ __forceinline__ int key0(int st) const { return st * 64; }
  __device__ __forceinline__ bool masks(int) const { return true; }
  __device__ __forceinline__ bool key_ok(int row, int key) const {
    return ((key ^ row) & (64 - (1 << trs))) == 0 && (key & ((1 << trs) - 1)) < n_tok;
  }
  // query tile row and key tile row of one image (dk/dv)
  __device__ __forceinline__ bool same_image(int row, int key) const {
    return ((key ^ row) >> trs) == 0;
  }
  __device__ __forceinline__ bool has(int row) const {
    return (row & ((1 << trs) - 1)) < n_tok && img0 + (row >> trs) < B;
  }
  __device__ __forceinline__ long long grow(int row) const {
    return (long long)(img0 + (row >> trs)) * n_tok + (row & ((1 << trs) - 1));
  }
  __device__ __forceinline__ long long lidx(int row) const {
    return ((long long)(img0 + (row >> trs)) * heads + h) * n_tok + (row & ((1 << trs) - 1));
  }
};

// Rows 16 w + g (+ 8) of a 64 x HDP accumulator (panels of kBW columns; w
// the warp in its warpgroup) for tile rows row0.., times `mul`, as bf16
// into a (B, T, .) tensor with token rows `ld` apart at column col0:
// padding rows and columns >= hd are not written.
template <int HDP, class L>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[Stripe<HDP>::kPanels]
                                                             [Stripe<HDP>::kBW / 2],
                                           float mul, const L& lay, int row0, long long ld,
                                           int col0, int hd) {
  using S = Stripe<HDP>;
  const int warp = (threadIdx.x & (kWgThreads - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (!lay.has(row)) continue;
    __nv_bfloat16* o = out + lay.grow(row) * ld + col0;
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

// A 4-byte store at (row, col) of a stripe tile of HD <= 64 columns, in
// the swizzled layout TMA writes: 16-byte unit u of row r at u ^ (the
// row's bits above the swizzle span), Swizzle<3|2|1, 4, 3>.
template <int HD>
__device__ __forceinline__ void st_tile(char* tile, int row, int col, uint32_t v) {
  static_assert(HD == 16 || HD == 32 || HD == 64, "HD");
  constexpr uint32_t M = HD == 64 ? 7 : HD == 32 ? 3 : 1;
  const uint32_t o = row * HD * 2 + col * 2;
  *reinterpret_cast<uint32_t*>(tile + (o ^ (((o >> 7) & M) << 4))) = v;
}

// The warp's 16 rows of a 64 x HDP accumulator (HDP <= 64, rows row0 +
// 16 w..) times `mul`, rounded to bf16, to rows `ld` apart at column col0
// through the warp's buffer `buf` (16 rows of HDP * 2 + 16 bytes): each
// store instruction writes whole row segments of HDP * 2 bytes. Padding
// rows are not written.
template <int HDP, class L>
__device__ __forceinline__ void store_staged(__nv_bfloat16* out, const float (&acc)[HDP / 2],
                                             float mul, const L& lay, int row0, long long ld,
                                             int col0, char* buf) {
  static_assert(HDP <= 64, "one panel");
  constexpr int RS = HDP * 2 + 16, VR = HDP / 8;
  const int warp = (threadIdx.x & (kWgThreads - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i)
      *reinterpret_cast<uint32_t*>(buf + (g + 8 * r) * RS + (i * 8 + 2 * tq) * 2) =
          pdm_attn::pack_bf16(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * VR; e += 32) {
    const int rr = e / VR, v = e - rr * VR;
    const int row = row0 + warp * 16 + rr;
    if (lay.has(row))
      *reinterpret_cast<uint4*>(out + lay.grow(row) * ld + col0 + v * 8) =
          *reinterpret_cast<const uint4*>(buf + rr * RS + v * 16);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// the single-pass attention of one 64-row strip, forward and backward
// (rows 1 and 2; the whole-block kernels run them on their own tiles)

constexpr float kLog2e = 1.4426950408889634f;

// One 64-row query strip st of an (image, head) whose q, k, v stripes are
// in shared memory (q_rows and kv_rows rows; strip st's keys are NC 64-row
// chunks from lay.key0(st)): S, the softmax, P v, the strip's output
// through store(acc, mul, tile row0) and, if lse is not null, its
// logsumexp. NC is a template parameter so that no branch sits between a
// product's issue and its wait.
template <int HDP, int NC, class L, typename Store>
__device__ __forceinline__ void fwd_strip(const char* qs, const char* ks, const char* vs,
                                          int q_rows, int kv_rows, int st, const L& lay,
                                          float scale_log2, Store store, float* lse) {
  using S = Stripe<HDP>;
  const int warp = (threadIdx.x & (kWgThreads - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = lay.key0(st);

  // S = q k^T: the strip's 64 rows against all its keys, m64n(64 NC)k16
  float s[NC * 32];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < S::kKSteps; ++kk)
    wgmma_ss<NC>(s, desc_k<HDP>(qs, q_rows, st * kRows, kk), desc_k<HDP>(ks, kv_rows, k0, kk));
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(s);

  // keys outside the row's own (padding; another packed image) at -inf
  if (lay.masks(NC * kRows)) {
#pragma unroll
    for (int i = 0; i < NC * 32; ++i)
      if (!lay.key_ok(st * kRows + warp * 16 + g + 8 * ((i >> 1) & 1),
                      (i >> 2) * 8 + 2 * tq + (i & 1)))
        s[i] = -INFINITY;
  }
  // exact row max and softmax sum of rows g and g + 8; the scale folds
  // into the exponent, p = 2^(s c - m c) with c = scale log2(e)
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
  m[0] = pdm_attn::quad_max(m[0]);
  m[1] = pdm_attn::quad_max(m[1]);
  const float mc[2] = {m[0] * scale_log2, m[1] * scale_log2};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -mc[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
  l[0] = pdm_attn::quad_sum(l[0]);
  l[1] = pdm_attn::quad_sum(l[1]);
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // p = exp(s - m) / l rounded to bf16: the A fragments of P v
  uint32_t pa[NC * 4][4];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] *= inv_l[(i >> 1) & 1];
#pragma unroll
  for (int j = 0; j < NC * 4; ++j) pack_slice(pa[j], s, j);

  // O = P v
  float o[S::kPanels][S::kBW / 2];
#pragma unroll
  for (int n = 0; n < S::kPanels; ++n)
#pragma unroll
    for (int i = 0; i < S::kBW / 2; ++i) o[n][i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NC * 4; ++j)
#pragma unroll
    for (int n = 0; n < S::kPanels; ++n)
      wgmma_rs<S::kBW>(o[n], pa[j], desc_mn<HDP>(vs, kv_rows, k0 / 16 + j, n));
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int n = 0; n < S::kPanels; ++n) reg_fence(o[n]);
  reg_fence(pa);

  store(o, 1.f, st * kRows);
  if (lse != nullptr && tq == 0) {
    const float ln2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = st * kRows + warp * 16 + g + 8 * r;
      if (lay.has(row)) lse[lay.lidx(row)] = mc[r] * ln2 + logf(l[r]);
    }
  }
}

// dq and D of one 64-row query strip st: qs, dos hold its q and do
// (q_rows rows, the strip at q_row0), ks, vs the keys' k and v (kv_rows
// rows, the strip's keys NC 64-row chunks from lay.key0(st)). With
// kWaitDoV, do and v are awaited on dov_bar (phase) after S. dq goes out
// through store(acc, scale, tile row0), D to dsum.
template <int HDP, int NC, bool kWaitDoV, class L, typename Store>
__device__ __forceinline__ void dq_strip(const char* qs, const char* dos, const char* ks,
                                         const char* vs, uint64_t* dov_bar, int phase,
                                         int q_rows, int q_row0, int kv_rows, int st,
                                         const L& lay, const float* __restrict__ lse,
                                         Store store, float* __restrict__ dsum, float scale,
                                         float scale_log2) {
  using S = Stripe<HDP>;
  const int warp = (threadIdx.x & (kWgThreads - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = lay.key0(st);
  // lse of rows g and g + 8 in log2 units; +inf for padding makes P = 0
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = st * kRows + warp * 16 + g + 8 * r;
    lse2[r] = lay.has(row) ? lse[lay.lidx(row)] * kLog2e : INFINITY;
  }

  // S = q k^T over the strip's whole key row, m64n(64 NC)k16
  float s[NC * 32];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < S::kKSteps; ++kk)
    wgmma_ss<NC>(s, desc_k<HDP>(qs, q_rows, q_row0, kk), desc_k<HDP>(ks, kv_rows, k0, kk));
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(s);

  // P = exp(s - lse), rounded to bf16 as it is packed (keys outside the
  // row's own: 0)
  uint32_t pa[NC * 4][4];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] = ex2(fmaf(s[i], scale_log2, -lse2[(i >> 1) & 1]));
  if (lay.masks(NC * kRows)) {
#pragma unroll
    for (int i = 0; i < NC * 32; ++i)
      if (!lay.key_ok(st * kRows + warp * 16 + g + 8 * ((i >> 1) & 1),
                      (i >> 2) * 8 + 2 * tq + (i & 1)))
        s[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NC * 4; ++j) pack_slice(pa[j], s, j);

  // dp = do v^T (in the same registers), D = sum_k P * dp
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] = 0.f;
  if constexpr (kWaitDoV) mbar_wait(dov_bar, phase);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < S::kKSteps; ++kk)
    wgmma_ss<NC>(s, desc_k<HDP>(dos, q_rows, q_row0, kk), desc_k<HDP>(vs, kv_rows, k0, kk));
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(s);
  float D[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NC * 32; ++i)
    D[(i >> 1) & 1] += unpack(pa[i >> 3], i >> 2, i & 3) * s[i];
  D[0] = pdm_attn::quad_sum(D[0]);
  D[1] = pdm_attn::quad_sum(D[1]);

  // ds = P dp - P D, rounded to bf16 as it is repacked (the A operand of
  // ds k)
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) {
    const float p = unpack(pa[i >> 3], i >> 2, i & 3);
    s[i] = p * s[i] - p * D[(i >> 1) & 1];
  }
#pragma unroll
  for (int j = 0; j < NC * 4; ++j) pack_slice(pa[j], s, j);
  float acc[S::kPanels][S::kBW / 2];
#pragma unroll
  for (int n = 0; n < S::kPanels; ++n)
#pragma unroll
    for (int i = 0; i < S::kBW / 2; ++i) acc[n][i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NC * 4; ++j)
#pragma unroll
    for (int n = 0; n < S::kPanels; ++n)
      wgmma_rs<S::kBW>(acc[n], pa[j], desc_mn<HDP>(ks, kv_rows, k0 / 16 + j, n));
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int n = 0; n < S::kPanels; ++n) reg_fence(acc[n]);
  reg_fence(pa);

  store(acc, scale, st * kRows);
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = st * kRows + warp * 16 + g + 8 * r;
      if (lay.has(row)) dsum[lay.lidx(row)] = D[r];
    }
  }
}

// dk and dv of one 64-key strip kt: ks, vs hold its k and v (k_rows rows,
// the strip at k_row0), qs, dos the queries' q and do (q_rows rows; the
// strip's queries are NC 64-row chunks from lay.key0(kt)); lse_s and d_s
// the queries' lse (log2 units, +inf for padding) and D (0 for padding) by
// tile row. The queries go by in groups of QC 64-row chunks (two where NC
// is even and HDP <= 64): products m64n(64 QC)k16 and three waits a group.
// dk and dv go out through store(0, acc, scale, tile row0) and
// store(1, acc, 1, tile row0).
template <int HDP, int NC, class L, typename Store>
__device__ __forceinline__ void dkdv_strip(const char* ks, const char* vs, const char* qs,
                                           const char* dos, int k_rows, int k_row0,
                                           int q_rows, int kt, const L& lay,
                                           const float* lse_s, const float* d_s, Store store,
                                           float scale, float scale_log2) {
  using S = Stripe<HDP>;
  // query chunks a group (one at HDP 128, where dk and dv take 128 registers)
  constexpr int QC = NC % 2 == 0 && HDP <= 64 ? 2 : 1;
  const int warp = (threadIdx.x & (kWgThreads - 1)) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qb = lay.key0(kt);
  float dk_acc[S::kPanels][S::kBW / 2], dv_acc[S::kPanels][S::kBW / 2];
#pragma unroll
  for (int n = 0; n < S::kPanels; ++n)
#pragma unroll
    for (int i = 0; i < S::kBW / 2; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  float sc[QC * 32], dp[QC * 32];
  uint32_t pa[QC * 4][4];
#pragma unroll 1
  for (int q0 = qb; q0 < qb + NC * kRows; q0 += QC * kRows) {
    // S^T = k q^T: rows are the strip's keys, columns the group's queries
#pragma unroll
    for (int i = 0; i < QC * 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::kKSteps; ++kk)
      wgmma_ss<QC>(sc, desc_k<HDP>(ks, k_rows, k_row0, kk), desc_k<HDP>(qs, q_rows, q0, kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);
    // P^T = exp(s - lse), rounded to bf16 as it is packed (a packed key
    // and a query of another image: 0)
#pragma unroll
    for (int i = 0; i < QC * 32; i += 2) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + q0 + (i >> 2) * 8 + 2 * tq);
      sc[i] = ex2(fmaf(sc[i], scale_log2, -l2.x));
      sc[i + 1] = ex2(fmaf(sc[i + 1], scale_log2, -l2.y));
    }
    if constexpr (L::kPacked) {
#pragma unroll
      for (int i = 0; i < QC * 32; ++i)
        if (!lay.same_image(q0 + (i >> 2) * 8 + 2 * tq + (i & 1),
                            kt * kRows + warp * 16 + g + 8 * ((i >> 1) & 1)))
          sc[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < QC * 4; ++j) pack_slice(pa[j], sc, j);
    // dv += P^T do and dp^T = v do^T
#pragma unroll
    for (int i = 0; i < QC * 32; ++i) dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < QC * 4; ++j)
#pragma unroll
      for (int n = 0; n < S::kPanels; ++n)
        wgmma_rs<S::kBW>(dv_acc[n], pa[j], desc_mn<HDP>(dos, q_rows, q0 / 16 + j, n));
#pragma unroll
    for (int kk = 0; kk < S::kKSteps; ++kk)
      wgmma_ss<QC>(dp, desc_k<HDP>(vs, k_rows, k_row0, kk), desc_k<HDP>(dos, q_rows, q0, kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dp);
#pragma unroll
    for (int n = 0; n < S::kPanels; ++n) reg_fence(dv_acc[n]);
    reg_fence(pa);
    // ds^T = P dp - P D (P the rounded values), rounded to bf16 as it is
    // packed; dk += ds^T q
#pragma unroll
    for (int i = 0; i < QC * 32; i += 2) {
      const float2 d2 = *reinterpret_cast<const float2*>(d_s + q0 + (i >> 2) * 8 + 2 * tq);
      const float p0 = unpack(pa[i >> 3], i >> 2, i & 3);
      const float p1 = unpack(pa[i >> 3], i >> 2, (i + 1) & 3);
      sc[i] = p0 * dp[i] - p0 * d2.x;
      sc[i + 1] = p1 * dp[i + 1] - p1 * d2.y;
    }
#pragma unroll
    for (int j = 0; j < QC * 4; ++j) pack_slice(pa[j], sc, j);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < QC * 4; ++j)
#pragma unroll
      for (int n = 0; n < S::kPanels; ++n)
        wgmma_rs<S::kBW>(dk_acc[n], pa[j], desc_mn<HDP>(qs, q_rows, q0 / 16 + j, n));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < S::kPanels; ++n) reg_fence(dk_acc[n]);
    reg_fence(pa);
  }

  store(0, dk_acc, scale, kt * kRows);
  store(1, dv_acc, 1.f, kt * kRows);
}

// ---------------------------------------------------------------------------
// a TMA ring for streamed products (the whole-block kernels)
//
// S stages of `stage` bytes. Thread 0 of the block issues every stage's
// loads (its full barrier: one arrival plus the bytes); both warpgroups run
// their wgmma on the stages in order, and each warp arrives on the stage's
// empty barrier once its products are done, so thread 0 refills a stage as
// soon as all eight warps are through with it: no block-wide barrier per
// stage. RingPos counts chunks over all sweeps of the ring: `next` the next
// one to consume (every thread), `issued` the next one to issue (thread 0's
// count). When a sweep has issued all its chunks, it issues into the stages
// it frees the first chunks of the sweep after it (its Ahead), so those
// loads are in flight through the sweep's last products and epilogues;
// ring_prefetch does the same between sweeps. A chunk issued ahead may
// bring only part of its bytes (its barrier expects them all): the sweep
// that consumes it issues the rest (its `rest`) before its first wait.

template <int S>
struct StageRing {
  uint64_t full[S], empty[S];
};

struct RingPos {
  int next, issued;
};

// n chunks of the next sweep, tx bytes each, issued by load(i, stage, bar)
template <typename Load>
struct Ahead {
  int n;
  uint32_t tx;
  Load load;
};

template <typename Load>
__device__ __forceinline__ Ahead<Load> ahead(int n, uint32_t tx, Load load) {
  return Ahead<Load>{n, tx, load};
}

struct NoLoad {
  template <typename... A>
  __device__ __forceinline__ void operator()(A...) const {}
};

// thread 0, before the block's first barrier
template <int S>
__device__ __forceinline__ void ring_init(StageRing<S>& r) {
  for (int st = 0; st < S; ++st) {
    mbar_init(&r.full[st], 1);
    mbar_init(&r.empty[st], kThreads / 32);
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// thread 0: wait until chunk n's stage is free, then arm its barrier for
// tx bytes
template <int S>
__device__ __forceinline__ uint64_t* ring_arm(StageRing<S>& r, int n, uint32_t tx) {
  const int st = n % S;
  if (n >= S) mbar_wait(&r.empty[st], ((n / S) - 1) & 1);
  mbar_expect_tx(&r.full[st], tx);
  return &r.full[st];
}

// Between sweeps (every warp through the last one): thread 0 issues the
// first chunks of the next sweep into the free stages.
template <int S, typename Load>
__device__ __forceinline__ void ring_prefetch(StageRing<S>& r, char* ring, int stage,
                                              RingPos& pos, const Ahead<Load>& a) {
  if (threadIdx.x != 0) return;
  while (pos.issued < pos.next + S && pos.issued - pos.next < a.n) {
    const int n = pos.issued++;
    a.load(n - pos.next, ring + (n % S) * stage, ring_arm(r, n, a.tx));
  }
}

// One sweep of nk chunks through the ring, run by every thread of the
// block: load(i, stage, bar) issues chunk i's loads (thread 0; `tx` bytes
// in all), rest(i, stage, bar) the rest of a chunk issued ahead, mma(i,
// stage) the warpgroup's products on it, after(i) what follows chunk i (an
// epilogue) once thread 0 has refilled its stage, so the loads of later
// chunks (and of `next_sweep`'s first ones) stay in flight through it.
template <int S, typename Load, typename Rest, typename Mma, typename After, typename NextLoad>
__device__ __forceinline__ void ring_sweep(StageRing<S>& r, char* ring, int stage, RingPos& pos,
                                           int nk, uint32_t tx, Load load, Rest rest, Mma mma,
                                           After after, const Ahead<NextLoad>& next_sweep) {
  const int base = pos.next;
  auto issue = [&]() {  // thread 0: the next chunk in order, if any
    const int n = pos.issued, i = n - base;
    if (i < nk) {
      load(i, ring + (n % S) * stage, ring_arm(r, n, tx));
    } else if (i - nk < next_sweep.n) {
      next_sweep.load(i - nk, ring + (n % S) * stage, ring_arm(r, n, next_sweep.tx));
    } else {
      return;
    }
    ++pos.issued;
  };
  if (threadIdx.x == 0) {
    for (int n = base; n < pos.issued && n < base + nk; ++n)
      rest(n - base, ring + (n % S) * stage, &r.full[n % S]);
    while (pos.issued < base + S && pos.issued < base + nk + next_sweep.n) issue();
  }
#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int n = base + i, st = n % S;
    mbar_wait(&r.full[st], (n / S) & 1);
    wgmma_fence();
    mma(i, ring + st * stage);
    wgmma_commit();
    wgmma_wait_all();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[st]);
    if (threadIdx.x == 0) issue();
    after(i);
  }
  pos.next = base + nk;
}

// a sweep with nothing issued ahead of it or by it
template <int S, typename Load, typename Mma, typename After>
__device__ __forceinline__ void ring_sweep(StageRing<S>& r, char* ring, int stage, RingPos& pos,
                                           int nk, uint32_t tx, Load load, Mma mma,
                                           After after) {
  ring_sweep<S>(r, ring, stage, pos, nk, tx, load, NoLoad{}, mma, after,
                Ahead<NoLoad>{0, 0u, NoLoad{}});
}

// generic stores to global memory become visible to later TMA reads
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// generic stores to shared memory become visible to later wgmma reads
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA box loads of 2-D and 3-D maps at (column, row[, image])
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int img) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row),
      "r"(img)
      : "memory");
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

static inline CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A bf16 map of `rank` dimensions (dims innermost first, strides in
// elements for dimensions 1..), boxes `box`, swizzled for the box's row of
// box[0] elements. Returns false if the encoding is refused.
static inline bool encode_map(CUtensorMap* map, const void* base, int rank,
                              const long long* dims, const long long* strides,
                              const int* box) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    elem[i] = 1;
    if (i > 0) st[i - 1] = (cuuint64_t)strides[i - 1] * 2;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, st,
                bx, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(box[0] * 2),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 4-D map {hd, heads, T, B} (strides {hd, ld, T ld} elements) over bf16
// stripes at `base`, boxes {min(HDP, 64), 1, box_rows, box_imgs}, swizzled
// for HDP's row width. Returns false if the encoding is refused.
template <int HDP>
static inline bool stripe_map(CUtensorMap* map, const void* base, int B, int n_tok,
                              int heads, int hd, long long ld, int box_rows,
                              int box_imgs = 1) {
  const long long dims[4] = {hd, heads, n_tok, B};
  const long long strides[3] = {hd, ld, n_tok * ld};
  const int box[4] = {Stripe<HDP>::kBW, 1, box_rows, box_imgs};
  return encode_map(map, base, 4, dims, strides, box);
}

// The 3-D map {cols, T, B} (token rows ld elements apart) over bf16 rows at
// `base`, boxes {box_cols, box_rows, box_imgs}.
static inline bool rows_map(CUtensorMap* map, const void* base, int B, int n_tok, int cols,
                            long long ld, int box_cols, int box_rows, int box_imgs) {
  const long long dims[3] = {cols, n_tok, B};
  const long long strides[2] = {ld, n_tok * ld};
  const int box[3] = {box_cols, box_rows, box_imgs};
  return encode_map(map, base, 3, dims, strides, box);
}

// The 2-D map {cols, rows} over a contiguous bf16 matrix, boxes {box_cols,
// box_rows}.
static inline bool mat_map(CUtensorMap* map, const void* base, long long rows, int cols,
                           int box_cols, int box_rows) {
  const long long dims[2] = {cols, rows};
  const long long strides[1] = {cols};
  const int box[2] = {box_cols, box_rows};
  return encode_map(map, base, 2, dims, strides, box);
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
