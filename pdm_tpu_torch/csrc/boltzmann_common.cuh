// Building blocks of the Boltzmann-moment kernels (boltzmann_sweep.cu): the
// dataset Gram of a 64-row query tile against a 128-column dataset tile,
// and the online-softmax moment update of one query row.
//
// Layouts. Queries and the dataset come transposed, contraction (D) major:
// a query operand is (D, Bp) and the dataset (D, Np), so a tile of TK
// contraction rows is TK contiguous row segments in device memory and lands
// in shared memory with 16-byte cp.async copies and no register staging.
// Contraction rows past D are zero-filled by the copy, so D needs no
// padding and the extra products add exact zeros.
//
// Two Gram engines, each for one query operand or for two at once
// (kTwo: x0 and eps share every dataset tile load, as the two Grams of the
// sweep do; the single-temperature moments kernel has x alone and runs
// the one-operand form, which neither loads nor multiplies a second one):
//   * fp32 on the CUDA cores (FFMA), never TF32. 256 threads, each owns a
//     4-row x 8-column patch of each Gram (32 accumulators an operand); per
//     contraction step it reads a float4 of queries per operand and two of
//     the dataset from shared memory (broadcast across the warp).
//   * bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulate), one
//     pass (hi*hi) or three (hi*hi + hi*lo + lo*hi): each warp owns 16
//     rows x 64 columns of each Gram; A and B fragments come from the
//     (k-major) tiles through ldmatrix.trans.
// Both run a 3-stage cp.async pipeline over the contraction and leave the
// tile's Grams in registers, each accumulator at the (row, column) their
// comments give. The online-softmax moment update and the exact merge of
// two parts' accumulators follow.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
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

// Runs the contraction of one tile: `load(stage, kt)` issues the copies of
// contraction step kt into ring slot `stage`, `compute(stage)` consumes it.
template <int TK, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int D, Load load, Compute compute) {
  const int n_k = (D + TK - 1) / TK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step kt is in; every thread is done with kt - 1
    const int nk = kt + kStages - 1;
    if (nk < n_k) load(nk % kStages, nk);
    cp_async_commit();
    compute(kt % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the caller
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores

constexpr int kTK32 = 16;  // contraction rows per stage

// floats of one ring slot: kTK32 rows of each query operand, then of the dataset
template <bool kTwo>
__host__ __device__ constexpr int stage_floats32() {
  return kTK32 * ((kTwo ? 2 : 1) * kTB + kTN);
}
template <bool kTwo>
__host__ __device__ constexpr int smem_gram32() {
  return kStages * stage_floats32<kTwo>() * 4;
}

// ax/ae[i][j]: tile row r0 + i, tile column c0 + j (j < 4) or c0 + 28 + j
// (j >= 4), with r0, c0 from fp32_patch. ae is untouched unless kTwo.
__device__ __forceinline__ void fp32_patch(int& r0, int& c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r0 = (warp & 3) * 16 + (lane >> 3) * 4;
  c0 = (warp >> 2) * 64 + (lane & 7) * 4;
}

__device__ __forceinline__ int fp32_col(int c0, int j) { return j < 4 ? c0 + j : c0 + 28 + j; }

template <bool kTwo>
__device__ __forceinline__ void gram_fp32(float (&ax)[4][8], float (&ae)[4][8],
                                          const GramOperands& op, float* smem) {
  constexpr int kQ = kTwo ? 2 : 1;  // query operands
  const float* xg = static_cast<const float*>(op.x_hi);
  const float* eg = static_cast<const float*>(op.e_hi);
  const float* yg = static_cast<const float*>(op.y_hi);
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ax[i][j] = 0.f;
      if constexpr (kTwo) ae[i][j] = 0.f;
    }

  auto load = [&](int stage, int kt) {
    float* xs = smem + stage * stage_floats32<kTwo>();
    float* ys = xs + kQ * kTK32 * kTB;
    const int k0 = kt * kTK32;
    {  // queries: 16 rows x 16 float4, one per thread per operand
      const int k = tid >> 4, c4 = (tid & 15) * 4;
      const bool ok = k0 + k < op.D;
      const long long off = ok ? (long long)(k0 + k) * op.ld_q + c4 : 0;
      cp_async16(xs + k * kTB + c4, xg + off, ok);
      if constexpr (kTwo) cp_async16(xs + kTK32 * kTB + k * kTB + c4, eg + off, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // dataset: 16 rows x 32 float4
      const int idx = tid + i * kThreads;
      const int k = idx >> 5, c4 = (idx & 31) * 4;
      const bool ok = k0 + k < op.D;
      const long long off = ok ? (long long)(k0 + k) * op.ld_y + c4 : 0;
      cp_async16(ys + k * kTN + c4, yg + off, ok);
    }
  };
  int r0, c0;
  fp32_patch(r0, c0);
  auto compute = [&](int stage) {
    const float* xs = smem + stage * stage_floats32<kTwo>();
    const float* ys = xs + kQ * kTK32 * kTB;
#pragma unroll
    for (int kk = 0; kk < kTK32; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + kk * kTB + r0);
      const float4 y0 = *reinterpret_cast<const float4*>(ys + kk * kTN + c0);
      const float4 y1 = *reinterpret_cast<const float4*>(ys + kk * kTN + c0 + 32);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float yr[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) ax[i][j] = fmaf(xr[i], yr[j], ax[i][j]);
      if constexpr (kTwo) {
        const float4 ev = *reinterpret_cast<const float4*>(xs + (kTK32 + kk) * kTB + r0);
        const float er[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) ae[i][j] = fmaf(er[i], yr[j], ae[i][j]);
      }
    }
  };
  pipeline<kTK32>(op.D, load, compute);
}

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

// Add the logits l_c = -(invt * c0[c] + irt * d0[c]) - esq, c < ncols, to
// `a` (as the TPU kernel's per-tile update): the max first, then the sums
// at the new max, with the old sums rescaled. A row whose max is still
// -inf adds nothing.
template <bool kWithValues>
__device__ __forceinline__ void update_moments(Moments& a, const float* c0, const float* d0,
                                               const float* __restrict__ v, int ncols,
                                               float invt, float irt, float esq) {
  float mx = -INFINITY;
  for (int c = 0; c < ncols; ++c) mx = fmaxf(mx, -(invt * c0[c] + irt * d0[c]) - esq);
  const float m_new = fmaxf(a.m, mx);
  if (m_new == -INFINITY) return;
  float ps = 0.f, pg = 0.f, pgg = 0.f, pv = 0.f;
  for (int c = 0; c < ncols; ++c) {
    const float l = -(invt * c0[c] + irt * d0[c]) - esq;
    const float p = expf(l - m_new);
    const float g = m_new - l;
    const float pgc = p * g;
    ps += p;
    pg += pgc;
    pgg += pgc * g;
    if constexpr (kWithValues) pv += p * v[c];
  }
  fold_moments(a, m_new, ps, pg, pgg, pv);
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
