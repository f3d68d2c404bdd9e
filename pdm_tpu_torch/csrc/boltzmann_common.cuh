// Building blocks of the Boltzmann-moment kernels (boltzmann_sweep.cu,
// boltzmann_moments.cu): the dataset Gram of a query tile against a
// 128-column dataset tile, the online-softmax moment update, and the
// exact merge of two parts' accumulators.
//
// Layouts. Queries and the dataset come transposed, contraction (D) major:
// a query operand is (D, Bp) and the dataset (D, Np), so a tile of TK
// contraction rows is TK contiguous row segments in device memory and lands
// in shared memory with no register staging: one TMA box per operand (fp32)
// or 16-byte cp.async copies (bf16). Contraction rows past D are
// zero-filled by the copy, so D needs no padding and the extra products
// add exact zeros.
//
// Gram engines, each for one query operand or for two at once (the sweep's
// x0 and eps share every dataset tile load):
//   * fp32 on the CUDA cores (FFMA), never TF32: the tall engine
//     (TallGram), 128 query rows a tile, each thread an 8 x 8 patch of one
//     Gram (256 threads) or a 4 x 8 patch of each of two (512 threads).
//     Each Gram entry is one FFMA chain over the contraction in order.
//   * bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulate), one
//     pass (hi*hi) or three (hi*hi + hi*lo + lo*hi), 64-row tiles: each warp
//     owns 16 rows x 64 columns of each Gram; A and B fragments come from
//     the (k-major) tiles through ldmatrix.trans.
// Each runs a ring over the contraction (TMA for fp32, cp.async for bf16)
// and leaves the tile's Grams in registers, each accumulator at the
// (row, column) its comments give.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_hopper.cuh"
#include "common.cuh"

namespace pdm_boltz {

constexpr int kTB = 64;        // query rows per tile
constexpr int kTN = 128;       // dataset columns per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kStages = 3;     // cp.async pipeline depth

using pdm_attn::ldsm_x4_trans;
using pdm_attn::mma_bf16;
using pdm_attn::smem_addr;

// 16 bytes global -> shared; zero-filled when !pred (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The operands of one tile pair: query operands (D, ld_q), dataset (D, ld_y),
// each hi and (bf16_3x) lo. Pointers are to element (0, row0) / (0, col0).
struct GramOperands {
  const void* x_hi;
  const void* x_lo;
  const void* e_hi;
  const void* e_lo;
  const void* y_hi;
  const void* y_lo;
  int D;
  long long ld_q;  // elements between contraction rows of the queries
  long long ld_y;  // ... of the dataset
};

// Runs a contraction of n_k steps through a ring of ST stages:
// load(slot, step) issues step's copies, compute(slot, step) consumes it.
template <int ST, typename Load, typename Compute>
__device__ __forceinline__ void ring_pipeline(int n_k, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // step kt is in; every thread is done with kt - 1
    const int nk = kt + ST - 1;
    if (nk < n_k) load(nk % ST, nk);
    cp_async_commit();
    compute(kt % ST, kt);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller
}

// The contraction of one tile over D rows, TK a stage, in the kStages ring:
// `load(stage, kt)` issues the copies of step kt, `compute(stage)` consumes it.
template <int TK, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int D, Load load, Compute compute) {
  ring_pipeline<kStages>((D + TK - 1) / TK, load, [&](int stage, int) { compute(stage); });
}

// ---------------------------------------------------------------------------
// A TMA ring: ST shared-memory stages, each filled by TMA tile copies
// (cp.async.bulk.tensor) and completed on its `full` mbarrier. Thread 0
// issues every stage's copies: before it refills a stage it waits on the
// stage's `empty` mbarrier, on which each warp arrives once it is done with
// the stage. The consumers wait only for the stage they read, so there is
// no block-wide barrier per stage and no thread computes a copy's address
// but thread 0. A stage is refilled one step after it was read (thread 0
// first computes its own step), so ST - 2 stages are in flight ahead of the
// slowest warp. `step` counts the stages consumed, the same in every
// thread, and carries the barriers' phases from one run to the next, so
// one ring serves any number of runs and runs of different contents.

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the generic proxy's earlier accesses to shared memory are ordered before
// later TMA (async proxy) writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the box at (column col, row row) of a 2-D tensor map
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// Wait for the phase of parity `phase` of an mbarrier to complete. The
// thread sleeps in try_wait (a suspend-time hint of 10 ms) instead of
// spinning: a spinning warp takes issue slots from the warps computing
// beside it (the row-7 Gram ran 15% slower). A variant that read the
// clock and trapped after 2 s of waiting cost the payload kernel 3%, so
// the wait is unbounded, as CUTLASS's; every stage it waits for is issued.
__device__ __forceinline__ void ring_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1, 10000000;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

template <int ST>
struct TmaRing {
  static constexpr int kBarBytes = 2 * ST * 8;
  uint64_t* full;
  uint64_t* empty;
  uint32_t step;

  // Every thread of the block calls it once, before the first run; `bars`
  // is kBarBytes of 8-byte aligned shared memory.
  __device__ void init(uint64_t* bars) {
    full = bars;
    empty = bars + ST;
    step = 0;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < ST; ++s) {
        pdm_hop::mbar_init(full + s, 1);
        pdm_hop::mbar_init(empty + s, blockDim.x / 32);
      }
      pdm_hop::fence_barrier_init();
    }
    __syncthreads();
  }

  // n steps: issue(slot, kt, bar) issues step kt's copies (`bytes` in all)
  // into stage slot on bar, compute(slot, kt) consumes it. Every thread of
  // the block calls it; the region's earlier contents are dead on entry and
  // the ring's on return.
  template <typename Issue, typename Compute>
  __device__ __forceinline__ void run(int n, uint32_t bytes, Issue issue, Compute compute) {
    fence_proxy_async();
    __syncthreads();  // the block is done with the region
    auto fill = [&](int kt) {
      const uint32_t g = step + kt;
      const int slot = g % ST;
      if (g >= ST) ring_wait(empty + slot, ((g / ST) + 1) & 1);  // use g - ST is read
      pdm_hop::mbar_expect_tx(full + slot, bytes);
      issue(slot, kt, full + slot);
    };
    if (threadIdx.x == 0)
      for (int kt = 0; kt < ST - 1 && kt < n; ++kt) fill(kt);
    for (int kt = 0; kt < n; ++kt) {
      const uint32_t g = step + kt;
      const int slot = g % ST;
      ring_wait(full + slot, (g / ST) & 1);
      compute(slot, kt);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
      if (threadIdx.x == 0 && kt + ST - 1 < n) fill(kt + ST - 1);
    }
    step += n;
    __syncthreads();  // every warp is done with the ring
  }
};

// The 2-D map over a row-major fp32 array (rows, cols) with ld elements
// between rows (ld * 4 a multiple of 16, base 16-byte aligned), boxes of
// box_rows x box_cols; boxes past the array read zeros. Returns false if
// the encoding is refused.
static inline bool tile_map(CUtensorMap* map, const void* base, long long rows, long long cols,
                            long long ld, int box_rows, int box_cols) {
  pdm_hop::EncodeTiledFn encode = pdm_hop::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores, tall: 128 query rows against a 128-column tile.
//
// Each of the block's threads owns a PR x PC patch of each of NQ Grams,
// made of float4 runs (PR / 4 rows kRS apart, PC / 4 columns kCS apart);
// the warp's lanes take 8 consecutive column groups and 4 row groups, so
// every shared read is one broadcast wavefront. A tile's contraction runs
// through a TMA ring (TmaRing) of ST stages of TK rows: a stage is the
// TK x 128 boxes of each query operand and of the dataset, contraction
// rows past D read as zeros. The 128-row tile reads half the query bytes
// per product of a 64-row one.

// The tensor maps of the tall kernels: query operands (D, Bp), the
// dataset (D, Np), the payload (n, K); kernels take them as a
// __grid_constant__ parameter, so TMA reads them in place.
struct TallMaps {
  CUtensorMap q0, q1, y, v;
};

template <int PR, int PC, int NQ, int TK, int ST>
struct TallGram {
  static constexpr int kRows = 128, kCols = 128;
  static constexpr int kRG = kRows / PR, kCG = kCols / PC;
  static constexpr int kThreads = kRG * kCG;
  static constexpr int kRS = kRows / (PR / 4), kCS = kCols / (PC / 4);
  static constexpr int kTK = TK;
  static constexpr int kStageFloats = TK * (NQ * kRows + kCols);
  static constexpr int kSmem = ST * kStageFloats * 4;
  using Ring = TmaRing<ST>;

  // the thread's row group rg and column group cg
  __device__ static void patch(int& rg, int& cg) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    cg = (warp % (kCG / 8)) * 8 + (lane & 7);
    rg = (warp / (kCG / 8)) * 4 + (lane >> 3);
  }
  // tile row of acc[.][i][.], tile column of acc[.][.][j]
  __device__ static int row(int rg, int i) { return rg * 4 + (i >> 2) * kRS + (i & 3); }
  __device__ static int col(int cg, int j) { return cg * 4 + (j >> 2) * kCS + (j & 3); }

  // acc[q] = the Gram of query operand q (maps.q0, then maps.q1), rows
  // [row0, row0 + 128), against dataset columns [col0, col0 + 128) of
  // maps.y, over D contraction rows; `smem` (128-byte aligned) holds the
  // ring's stages
  __device__ static void run(float (&acc)[NQ][PR][PC], const TallMaps& maps, int row0,
                             int col0, int D, float* smem, Ring& ring) {
    run_from(acc, maps, row0, col0, 0, 0, D, smem, ring);
  }

  // The same over the n_k contraction rows that start at row kq of the
  // query maps and at row ky of maps.y (a split-K product's chunk)
  __device__ static void run_from(float (&acc)[NQ][PR][PC], const TallMaps& maps, int row0,
                                  int col0, int kq, int ky, int n_k, float* smem, Ring& ring) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[q][i][j] = 0.f;
    auto issue = [&](int slot, int kt, uint64_t* bar) {
      float* xs = smem + slot * kStageFloats;
      tma_load_2d(xs, &maps.q0, bar, row0, kq + kt * TK);
      if constexpr (NQ == 2) tma_load_2d(xs + TK * kRows, &maps.q1, bar, row0, kq + kt * TK);
      tma_load_2d(xs + NQ * TK * kRows, &maps.y, bar, col0, ky + kt * TK);
    };
    int rg, cg;
    patch(rg, cg);
    auto compute = [&](int slot, int) {
      const float* xs = smem + slot * kStageFloats;
      const float* ys = xs + NQ * TK * kRows;
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float xr[NQ][PR], yr[PC];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int v = 0; v < PR / 4; ++v) {
            const float4 t =
                *reinterpret_cast<const float4*>(xs + (q * TK + kk) * kRows + rg * 4 + v * kRS);
            xr[q][4 * v] = t.x;
            xr[q][4 * v + 1] = t.y;
            xr[q][4 * v + 2] = t.z;
            xr[q][4 * v + 3] = t.w;
          }
#pragma unroll
        for (int v = 0; v < PC / 4; ++v) {
          const float4 t = *reinterpret_cast<const float4*>(ys + kk * kCols + cg * 4 + v * kCS);
          yr[4 * v] = t.x;
          yr[4 * v + 1] = t.y;
          yr[4 * v + 2] = t.z;
          yr[4 * v + 3] = t.w;
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int i = 0; i < PR; ++i)
#pragma unroll
            for (int j = 0; j < PC; ++j) acc[q][i][j] = fmaf(xr[q][i], yr[j], acc[q][i][j]);
      }
    };
    ring.run((n_k + TK - 1) / TK, kStageFloats * 4, issue, compute);
  }
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

constexpr int kTK16 = 32;         // contraction rows per stage (two k16 steps)
constexpr int kSQ = kTB + 8;      // shared row stride of a query tile (bf16)
constexpr int kSY = kTN + 8;      // ... of a dataset tile
constexpr int kQTile = kTK16 * kSQ;  // elements of one query tile
constexpr int kYTile = kTK16 * kSY;

// bf16 elements of one ring slot: the hi tiles of each query operand and of
// the dataset, then (bf16_3x) their lo tiles in the same order
template <bool kThree, bool kTwo>
__host__ __device__ constexpr int stage_elems16() {
  return ((kTwo ? 2 : 1) * kQTile + kYTile) * (kThree ? 2 : 1);
}
template <bool kThree, bool kTwo>
__host__ __device__ constexpr int smem_gram16() {
  return kStages * stage_elems16<kThree, kTwo>() * 2;
}

// ax/ae[n][e]: tile row wr*16 + g + 8*(e >> 1), column wc*64 + 8n + 2tq + (e & 1).
// ae is untouched unless kTwo.
template <bool kThree, bool kTwo>
__device__ __forceinline__ void gram_bf16(float (&ax)[8][4], float (&ae)[8][4],
                                          const GramOperands& op, __nv_bfloat16* smem) {
  using bf = __nv_bfloat16;
  constexpr int kQ = kTwo ? 2 : 1;
  constexpr int kHalf = kQ * kQTile + kYTile;  // elements of the hi (or lo) tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ax[n][e] = 0.f;
      if constexpr (kTwo) ae[n][e] = 0.f;
    }

  // query operand w: 0 x_hi, 1 e_hi, 2 x_lo, 3 e_lo
  const bf* src_q[4] = {static_cast<const bf*>(op.x_hi), static_cast<const bf*>(op.e_hi),
                        static_cast<const bf*>(op.x_lo), static_cast<const bf*>(op.e_lo)};
  const bf* src_y[2] = {static_cast<const bf*>(op.y_hi), static_cast<const bf*>(op.y_lo)};
  auto tile_q = [&](int stage, int w) {
    return smem + stage * stage_elems16<kThree, kTwo>() + (w >> 1) * kHalf + (w & 1) * kQTile;
  };
  auto tile_y = [&](int stage, int lo) {
    return smem + stage * stage_elems16<kThree, kTwo>() + lo * kHalf + kQ * kQTile;
  };

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kTK16;
    {  // queries: 32 rows x 8 vectors of 8 bf16
      const int k = tid >> 3, c8 = (tid & 7) * 8;
      const bool ok = k0 + k < op.D;
      const long long off = ok ? (long long)(k0 + k) * op.ld_q + c8 : 0;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if ((w & 1) && !kTwo) continue;
        if (w >= 2 && !kThree) continue;
        cp_async16(tile_q(stage, w) + k * kSQ + c8, src_q[w] + off, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // dataset: 32 rows x 16 vectors
      const int idx = tid + i * kThreads;
      const int k = idx >> 4, c8 = (idx & 15) * 8;
      const bool ok = k0 + k < op.D;
      const long long off = ok ? (long long)(k0 + k) * op.ld_y + c8 : 0;
#pragma unroll
      for (int lo = 0; lo < (kThree ? 2 : 1); ++lo)
        cp_async16(tile_y(stage, lo) + k * kSY + c8, src_y[lo] + off, ok);
    }
  };

  auto compute = [&](int stage) {
#pragma unroll
    for (int ks = 0; ks < kTK16; ks += 16) {
      // A (16 x 16, rows m, cols k) from the k-major tile: matrices
      // (m 0-7 | m 8-15) x (k 0-7 | k 8-15), transposed on load
      const int qa = (ks + (lane & 7) + (lane >> 4) * 8) * kSQ + wr * 16 + ((lane >> 3) & 1) * 8;
      uint32_t axh[4], aeh[4], axl[4], ael[4];
      ldsm_x4_trans(axh, tile_q(stage, 0) + qa);
      if constexpr (kTwo) ldsm_x4_trans(aeh, tile_q(stage, 1) + qa);
      if constexpr (kThree) {
        ldsm_x4_trans(axl, tile_q(stage, 2) + qa);
        if constexpr (kTwo) ldsm_x4_trans(ael, tile_q(stage, 3) + qa);
      }
      const int kb = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int yb = kb * kSY + wc * 64 + np * 16 + (lane >> 4) * 8;
        uint32_t bh[4];
        ldsm_x4_trans(bh, tile_y(stage, 0) + yb);
        mma_bf16(ax[2 * np], axh, bh[0], bh[1]);
        mma_bf16(ax[2 * np + 1], axh, bh[2], bh[3]);
        if constexpr (kTwo) {
          mma_bf16(ae[2 * np], aeh, bh[0], bh[1]);
          mma_bf16(ae[2 * np + 1], aeh, bh[2], bh[3]);
        }
        if constexpr (kThree) {
          uint32_t bl[4];
          ldsm_x4_trans(bl, tile_y(stage, 1) + yb);
          mma_bf16(ax[2 * np], axh, bl[0], bl[1]);
          mma_bf16(ax[2 * np + 1], axh, bl[2], bl[3]);
          mma_bf16(ax[2 * np], axl, bh[0], bh[1]);
          mma_bf16(ax[2 * np + 1], axl, bh[2], bh[3]);
          if constexpr (kTwo) {
            mma_bf16(ae[2 * np], aeh, bl[0], bl[1]);
            mma_bf16(ae[2 * np + 1], aeh, bl[2], bl[3]);
            mma_bf16(ae[2 * np], ael, bh[0], bh[1]);
            mma_bf16(ae[2 * np + 1], ael, bh[2], bh[3]);
          }
        }
      }
    }
  };
  pipeline<kTK16>(op.D, load, compute);
}

// ---------------------------------------------------------------------------
// the moment update

// -h / T, the TPU kernel's expansion of the energy (the moments kernels and
// their VJP: one expression, so the VJP's logits are the forward's)
__device__ __forceinline__ float logit(float xsq, float s, float invt, float gram, float ysq) {
  return -((xsq - s * gram) + (s * s) * ysq) * invt;
}

// Online-softmax accumulators of one query row at one temperature: running
// max m of the logits, and s0 = sum p, s1 = sum p g, s2 = sum p g^2,
// sy = sum p v with p = exp(l - m) and g = m - l (the shift-stabilized
// energy over T, >= 0 where the weight is).
struct Moments {
  float m, s0, s1, s2, sy;
};

__device__ __forceinline__ Moments empty_moments() {
  return Moments{-INFINITY, 0.f, 0.f, 0.f, 0.f};
}

// Move `a` to the new running max m_new (> -inf) and add the sums of one
// tile's columns taken at that max: ps = sum p, pg = sum p g, pgg =
// sum p g^2, pv = sum p v. Returns exp(m_old - m_new), the factor that
// rescales sums kept elsewhere (0 while `a` was empty).
__device__ __forceinline__ float fold_moments(Moments& a, float m_new, float ps, float pg,
                                              float pgg, float pv) {
  const bool finite = a.m > -INFINITY;
  const float scale = finite ? expf(a.m - m_new) : 0.f;
  const float delta = finite ? m_new - a.m : 0.f;
  const float s0 = a.s0, s1 = a.s1;
  a.s0 = s0 * scale + ps;
  a.s1 = (s1 + delta * s0) * scale + pg;
  a.s2 = (a.s2 + (2.f * delta) * s1 + (delta * delta) * s0) * scale + pgg;
  a.sy = a.sy * scale + pv;
  a.m = m_new;
  return scale;
}

// e^x for x <= 0 on the MUFU unit: 2^(x log2 e). ex2.approx's relative
// error is about 2^-22; rounding x log2 e adds |x| 2^-24 relative, which
// grows with |x| but is weighed by the term itself: a term's error
// e^x |x| 2^-24 stays below 2^-24 / e of the largest term (1) at every x.
// Results below 2^-126 flush to 0. It rounds p differently from expf
// (the moments kernels' and the plain version's): a change of rounding
// point that the sweep's tolerance covers. With expf the epilogue-bound
// sweeps ran 5-15% (bf16) to ~30% (fp32 at D 1) slower (PERF.md).
__device__ __forceinline__ float exp_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

constexpr int kTPT = 8;  // temperatures a thread updates at once

// Add the logits l_tc = -(invt[t] c0[c] + irt[t] d0[c]) - esq, c < ncols,
// to the accumulators a[t] of one row at kTPT temperatures (as the TPU
// kernel's per-tile update): each column's C0 and D0 are read once for all
// of them. Per temperature the max first, then the sums at the new max,
// with the old sums rescaled, summed over c in order; a temperature whose
// max is still -inf adds nothing. The max is taken over u = invt c0 + irt
// d0 (max_c fl(-u_c - esq) = fl(-min_c u_c - esq): rounding is monotone),
// and g = m - l is -(l - m) exactly.
template <bool kWithValues>
__device__ __forceinline__ void update_moments(Moments (&a)[kTPT], const float* c0,
                                               const float* d0, const float* __restrict__ v,
                                               int ncols, const float (&invt)[kTPT],
                                               const float (&irt)[kTPT], float esq) {
  float m_new[kTPT];
#pragma unroll
  for (int t = 0; t < kTPT; ++t) m_new[t] = INFINITY;
#pragma unroll 2
  for (int c = 0; c < ncols; ++c) {
    const float cc = c0[c], dd = d0[c];
#pragma unroll
    for (int t = 0; t < kTPT; ++t) m_new[t] = fminf(m_new[t], fmaf(invt[t], cc, irt[t] * dd));
  }
  float ps[kTPT], pg[kTPT], pgg[kTPT], pv[kTPT];
#pragma unroll
  for (int t = 0; t < kTPT; ++t) {
    m_new[t] = fmaxf(a[t].m, -m_new[t] - esq);
    ps[t] = pg[t] = pgg[t] = pv[t] = 0.f;
  }
#pragma unroll 2
  for (int c = 0; c < ncols; ++c) {
    const float cc = c0[c], dd = d0[c];
    const float vc = kWithValues ? v[c] : 0.f;
#pragma unroll
    for (int t = 0; t < kTPT; ++t) {
      const float l = -fmaf(invt[t], cc, irt[t] * dd) - esq;
      const float x = l - m_new[t];  // -g
      const float p = exp_neg(x);
      const float pgc = -(p * x);
      ps[t] += p;
      pg[t] += pgc;
      pgg[t] = fmaf(-pgc, x, pgg[t]);
      if constexpr (kWithValues) pv[t] = fmaf(p, vc, pv[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kTPT; ++t)
    if (m_new[t] > -INFINITY) fold_moments(a[t], m_new[t], ps[t], pg[t], pgg[t], pv[t]);
}

// Exact merge of `b` into `a`: the shift-stabilized join of two disjoint
// parts' accumulators (ops/boltzmann.py::merge_moments).
__device__ __forceinline__ void merge_into(Moments& a, const Moments& b) {
  const float m_g = fmaxf(a.m, b.m);
  if (m_g == -INFINITY) return;
  const bool fa = a.m > -INFINITY, fb = b.m > -INFINITY;
  const float ca = fa ? expf(a.m - m_g) : 0.f, da = fa ? m_g - a.m : 0.f;
  const float cb = fb ? expf(b.m - m_g) : 0.f, db = fb ? m_g - b.m : 0.f;
  Moments r;
  r.m = m_g;
  r.s0 = a.s0 * ca + b.s0 * cb;
  r.s1 = (a.s1 + da * a.s0) * ca + (b.s1 + db * b.s0) * cb;
  r.s2 = (a.s2 + 2.f * da * a.s1 + da * da * a.s0) * ca +
         (b.s2 + 2.f * db * b.s1 + db * db * b.s0) * cb;
  r.sy = a.sy * ca + b.sy * cb;
  a = r;
}

}  // namespace pdm_boltz
