// The vector-Jacobian product of the Boltzmann posterior mean for Hopper
// (sm_90a): the backward of row 7's moments kernel (boltzmann_moments.cu)
// when the payload is the dataset itself, as the analytic denoiser's is.
//
// Replaces no TPU kernel. The JAX package differentiates the XLA path of
// the moments (pdm_tpu/ops/boltzmann.py::boltzmann_moments_xla, its
// lax.scan under jax.grad); on the card row 7's kernel is the only route
// to the moments, so their gradient needs a kernel of its own. For queries
// x (B, D), the dataset y (N, D), per-row inverse temperature invt_i and
// dataset scale s_i, the forward gave p_ij = exp(l_ij - log_z_i), l_ij =
// -invt_i h_ij, and mean_i = sum_j p_ij y_j. For a cotangent c_i of mean_i:
//   u_ij = c_i.y_j,  w_ij = p_ij (u_ij - c_i.mean_i)          (dL/dl_ij)
//   dL/dx_i    = -invt_i (W_i x_i - s_i sum_j w_ij y_j),  W_i = sum_j w_ij
//   dL/dinvt_i = -sum_j w_ij h_ij = -A_i / invt_i,  A_i = sum_j w_ij (log_z_i - l_ij)
//   dL/ds_i    = -invt_i sum_j w_ij (2 s_i ysq_j - x_i.y_j)
// W_i is ~0 only up to rounding and is computed; A is shift-stabilized as
// the forward's e1_hat: sum_j w_ij = 0, so the energy is taken from log_z
// (log_z - l = -log p >= 0) and W's rounding is not multiplied by log_z.
// p is normalized against the forward's saved log_z, so the logits must be
// the forward's own, bit for bit: x.y is summed as row 7's engines sum it
// and the logit goes through the same expression (logit, then __fsub_rn).
//
// What bounds it on the H100: operations. Two Grams, x.y and c.y (2 B N D
// each), and the product w.Y (2 B N D): at B = 256, N = 50,000, D = 3072,
// 236 GFLOP, 3.5 ms at fp32's 67 TFLOP/s on the CUDA cores, against
// ~0.7 GB of inputs (0.2 ms). The product is fp32 in every mode, the
// Grams in the forward's mode. At D <= 4 (the schedule CLI's D = 1) the
// products are a few FFMAs a pair, and expf and the epilogue bound it.
//
// Two paths, chosen by the wrapper (ops/boltzmann_kernel.py::plan_vjp):
//
// * small D (fp32, D <= 4): one fused kernel. A thread owns a query row,
//   its x, c, row terms and running sums in registers; a block of 128 rows
//   walks a chunk of the dataset, its columns staged in shared memory and
//   read by every thread at once (broadcast). Per column: both Grams (D
//   FFMAs each, from 0 in contraction order: the tall engine's chain
//   without its zero-filled rows, which add exact zeros), w, the W, A, S
//   terms and the D sums of w y. One write per chunk. There are no tiles,
//   so no zero rows or columns are multiplied.
// * large D: two kernels. (1) The Grams and w: block (i, c) owns a query
//   tile i and a chunk c of the dataset (a run of 128-column sub-tiles);
//   per sub-tile both Grams on row 7's engine (fp32: TallGram, 128 rows,
//   512 threads with a 4 x 8 patch of each Gram, x, c and the dataset's
//   pack through one TMA ring; the bf16 modes: gram_bf16 with two query
//   operands on the mma.sync tiles, 64 rows), w from the Grams in
//   registers, written to a workspace w^T (columns, Bp), and the W, A, S
//   terms summed in registers for the whole chunk. (2) The product w.Y,
//   fp32 in every mode, split over K: block (i, k, c) owns a 128 x 128
//   output tile (query rows i, dataset dimensions k) and a chunk c of
//   dataset points, and runs the tall engine (8 x 16 patches, w^T and the
//   row-major dataset through a TMA ring) over the whole chunk, its
//   accumulators in registers; one write per chunk. The workspace holds at
//   most a bounded number of columns; larger calls run (1) and (2) once per
//   segment of the dataset.
// Then a merge kernel adds the chunks' sums in order and finishes the
// gradients. No atomics: every sum has a fixed order, so two calls agree
// bitwise.

#include <math.h>
#include <stdint.h>

#include "boltzmann_common.cuh"

namespace {

using namespace pdm_boltz;

enum Mode : int { kFp32 = 0, kBf16x3 = 1, kBf16 = 2 };

constexpr int kTBT = 128;  // query rows of a tall tile (fp32) and of a product tile

// fp32 Grams: two query operands (x and c), kGR x 8 patches of each (a
// row's terms are then held by 16 threads, 8 lanes in each of two warps),
// 32-row stages 4 deep (the sweep's configuration)
constexpr int kGR = 4, kGramBlocks = 1;
using VjpGram = TallGram<kGR, 8, 2, 32, 4>;
constexpr int kTallThreads = VjpGram::kThreads;
// the product: one operand (w^T), 8 x 16 patches (128 threads, 128
// accumulators a thread), 32-row stages 3 deep, two blocks an SM: 4% faster
// than row 7's 8 x 8 patches at CIFAR-10 scale (PERF.md section 6)
constexpr int kPR = 8, kPC = 16, kProductBlocks = 2;
using ProductGram = TallGram<kPR, kPC, 1, 32, 3>;
constexpr int kProductSmem = ProductGram::kSmem + ProductGram::Ring::kBarBytes;

constexpr int kSmallThreads = 128;  // query rows of a small-D block, one a thread
constexpr int kSmallCols = 512;     // dataset columns of a small-D stage

// Per row the W, A, S partials of the two halves of a Grams block that
// share it (2, 3, rows), then the row's five terms (5, rows); then (fp32)
// the ring's mbarriers, after the Gram's ring.
template <int kRows>
__host__ __device__ constexpr int smem_rows() {
  return (2 * 3 + 5) * kRows * 4;
}
constexpr int kTallSmem = VjpGram::kSmem + smem_rows<kTBT>() + VjpGram::Ring::kBarBytes;
template <int kMode>
__host__ __device__ constexpr int tiled_smem() {
  return smem_gram16<kMode == kBf16x3, true>() + smem_rows<kTB>();
}

struct VjpArgs {
  const void* x_hi;  // (D, Bp) fp32 or bf16: the queries transposed, zero-padded rows
  const void* x_lo;  // bf16_3x only
  const void* c_hi;  // (D, Bp): the cotangent, likewise
  const void* c_lo;
  const void* y_hi;  // (D, Np): the dataset's pack
  const void* y_lo;
  const float* ysq;   // (Np,) 0.5|y|^2
  const float* rows;  // (5, Bp): 0.5|x|^2, invt, s, log_z, c.mean
  float* partials;    // (chunks, 3, Bp): W, A, S
  float* out;         // small D: sy (chunks, Bp, D); large D: w^T (segment columns, Bp)
  int Bp, D, Np, n_true;
  int sub0, n_sub;      // the segment: 128-column sub-tiles [sub0, sub0 + n_sub)
  int per_chunk;        // sub-tiles a chunk
  int chunk0;           // the segment's first chunk in partials (and sy)
};

__device__ __forceinline__ const void* offset(const void* p, long long elems) {
  return p == nullptr ? nullptr : static_cast<const __nv_bfloat16*>(p) + elems;
}

// A thread's running sums of one query row over the chunk: sum w,
// sum w (log_z - l), sum w (2 s ysq - x.y).
struct RowSums {
  float w, a, sy;
};

// A query row's terms: 0.5|x|^2, invt, s, log_z, c.mean.
struct RowTerms {
  float xsq, invt, s, log_z, cm;
};

// The block's rows' terms into rt (5, kRows) (shared memory: registers are
// the Grams').
template <int kRows>
__device__ __forceinline__ void load_rows(const VjpArgs& a, float* rt, int row0) {
  for (int i = threadIdx.x; i < 5 * kRows; i += blockDim.x) {
    const int k = i / kRows, r = i - k * kRows;
    rt[i] = a.rows[(long long)k * a.Bp + row0 + r];
  }
  __syncthreads();
}

template <int kRows>
__device__ __forceinline__ RowTerms row_terms(const float* rt, int r) {
  return RowTerms{rt[r], rt[kRows + r], rt[2 * kRows + r], rt[3 * kRows + r], rt[4 * kRows + r]};
}

// The [begin, end) sub-tiles of chunk `chunk` of the segment.
__device__ __forceinline__ void chunk_range(const VjpArgs& a, int chunk, int& begin, int& end) {
  begin = a.sub0 + chunk * a.per_chunk;
  end = a.sub0 + min((chunk + 1) * a.per_chunk, a.n_sub);
}

// w of a row against one column from its Grams g = x.y and u = c.y; adds
// the row's terms (0 and nothing added for a column past N).
__device__ __forceinline__ float weight(RowSums& t, const RowTerms& r, float g, float u,
                                        float ysq, bool live) {
  if (!live) return 0.f;
  // -log p; __fsub_rn keeps the logit's last product out of an FMA, so l
  // is rounded as the forward rounded it
  const float gz = __fsub_rn(r.log_z, logit(r.xsq, r.s, r.invt, g, ysq));
  const float w = expf(-gz) * (u - r.cm);
  t.w += w;
  t.a = fmaf(w, gz, t.a);
  t.sy = fmaf(w, (2.f * r.s) * ysq - g, t.sy);
  return w;
}

// The chunk's W, A, S of the block's kRows rows: each row's terms are held
// by the threads of one shuffle group (lanes `lanes` apart, joined in a
// fixed order) in each of two halves of the block; red (2, 3, kRows) joins
// the halves.
template <int kRows>
__device__ __forceinline__ void store_row_sums(const VjpArgs& a, float* red, const RowSums& t, int r,
                                               int half, bool leader, int row0, int chunk) {
  if (leader) {
    red[(half * 3 + 0) * kRows + r] = t.w;
    red[(half * 3 + 1) * kRows + r] = t.a;
    red[(half * 3 + 2) * kRows + r] = t.sy;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int q = threadIdx.x;
    float* p = a.partials + (long long)chunk * 3 * a.Bp + row0 + q;
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k * a.Bp] = red[k * kRows + q] + red[(3 + k) * kRows + q];
  }
}

__device__ __forceinline__ void shuffle_sum(RowSums& t, int off) {
  t.w += __shfl_xor_sync(0xffffffffu, t.w, off);
  t.a += __shfl_xor_sync(0xffffffffu, t.a, off);
  t.sy += __shfl_xor_sync(0xffffffffu, t.sy, off);
}

// ---------------------------------------------------------------------------
// small D (fp32): block (i, c) owns rows [128 i, 128 i + 128), one a
// thread, and chunk c; the chunk's columns kSmallCols at a time in shared
// memory, column j's y_0..y_{D-1} at s[j * kS], its 0.5|y|^2 at
// s[j * kS + kS - 1], read as one or two vectors.

template <int kD>
__global__ void __launch_bounds__(kSmallThreads) vjp_small_kernel(const VjpArgs a) {
  constexpr int kS = kD < 2 ? 2 : (kD < 4 ? 4 : 8);
  __shared__ __align__(16) float s[kSmallCols * kS];
  const int row = blockIdx.x * kSmallThreads + threadIdx.x, chunk = blockIdx.y;
  const float* xt = static_cast<const float*>(a.x_hi);
  const float* ct = static_cast<const float*>(a.c_hi);
  const float* yt = static_cast<const float*>(a.y_hi);
  float xr[kD], cr[kD], sy[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    xr[d] = xt[(long long)d * a.Bp + row];
    cr[d] = ct[(long long)d * a.Bp + row];
    sy[d] = 0.f;
  }
  const RowTerms r{a.rows[row], a.rows[a.Bp + row], a.rows[2 * a.Bp + row],
                   a.rows[3 * a.Bp + row], a.rows[4 * a.Bp + row]};
  RowSums t{0.f, 0.f, 0.f};
  int sub_begin, sub_end;
  chunk_range(a, chunk, sub_begin, sub_end);
  const int c_end = min(sub_end * kTN, a.n_true);  // columns past N add nothing
  for (int c0 = sub_begin * kTN; c0 < c_end; c0 += kSmallCols) {
    const int n = min(kSmallCols, c_end - c0);
    __syncthreads();  // the last stage is read
    for (int j = threadIdx.x; j < n; j += kSmallThreads) {
#pragma unroll
      for (int d = 0; d < kD; ++d) s[j * kS + d] = yt[(long long)d * a.Np + c0 + j];
      s[j * kS + kS - 1] = a.ysq[c0 + j];
    }
    __syncthreads();  // the stage is in
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float v[kS];
      if constexpr (kS == 2) {
        const float2 q = *reinterpret_cast<const float2*>(s + j * kS);
        v[0] = q.x;
        v[1] = q.y;
      } else {
#pragma unroll
        for (int h = 0; h < kS / 4; ++h) {
          const float4 q = *reinterpret_cast<const float4*>(s + j * kS + 4 * h);
          v[4 * h] = q.x;
          v[4 * h + 1] = q.y;
          v[4 * h + 2] = q.z;
          v[4 * h + 3] = q.w;
        }
      }
      float g = 0.f, u = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) g = fmaf(xr[d], v[d], g);
#pragma unroll
      for (int d = 0; d < kD; ++d) u = fmaf(cr[d], v[d], u);
      const float w = weight(t, r, g, u, v[kS - 1], true);
#pragma unroll
      for (int d = 0; d < kD; ++d) sy[d] = fmaf(w, v[d], sy[d]);
    }
  }
  const int slot = a.chunk0 + chunk;
  float* p = a.partials + (long long)slot * 3 * a.Bp + row;
  p[0] = t.w;
  p[a.Bp] = t.a;
  p[2 * a.Bp] = t.sy;
#pragma unroll
  for (int d = 0; d < kD; ++d) a.out[((long long)slot * a.Bp + row) * kD + d] = sy[d];
}

// ---------------------------------------------------------------------------
// large D, (1): the Grams and w

// fp32: block (i, c) owns rows [128 i, 128 i + 128) and chunk c; per
// sub-tile both Grams on VjpGram (x, c and the dataset's pack through the
// TMA ring of `maps`), then w, each run of 4 rows a thread holds in a
// column one 16-byte store into w^T.
__global__ void __launch_bounds__(kTallThreads, kGramBlocks)
    vjp_grams_tall_kernel(const VjpArgs a, const __grid_constant__ TallMaps maps) {
  using G = VjpGram;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + G::kSmem);
  float* rt = red + 2 * 3 * kTBT;
  G::Ring gram_ring;
  gram_ring.init(reinterpret_cast<uint64_t*>(rt + 5 * kTBT));
  const int row0 = blockIdx.x * kTBT, chunk = blockIdx.y;
  load_rows<kTBT>(a, rt, row0);
  int sub_begin, sub_end;
  chunk_range(a, chunk, sub_begin, sub_end);
  int rg, cg;
  G::patch(rg, cg);
  RowSums t[kGR] = {};
  for (int sub = sub_begin; sub < sub_end; ++sub) {
    const int col0 = sub * kTN;
    float acc[2][kGR][8];
    G::run(acc, maps, row0, col0, a.D, reinterpret_cast<float*>(smem), gram_ring);
    float* wt = a.out + (long long)(col0 - a.sub0 * kTN) * a.Bp + row0 + rg * 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = G::col(cg, j);
      const bool live = col0 + c < a.n_true;
      const float ysq = a.ysq[col0 + c];
      float w[kGR];
#pragma unroll
      for (int i = 0; i < kGR; ++i)
        w[i] = weight(t[i], row_terms<kTBT>(rt, G::row(rg, i)), acc[0][i][j], acc[1][i][j], ysq,
                      live);
#pragma unroll
      for (int h = 0; h < kGR / 4; ++h)
        *reinterpret_cast<float4*>(wt + (long long)c * a.Bp + h * G::kRS) =
            float4{w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]};
    }
  }
  // a row's 16 threads: lanes 1, 2, 4 apart in each of two warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kGR; ++i) {
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1) shuffle_sum(t[i], off);
  }
#pragma unroll
  for (int i = 0; i < kGR; ++i) {
    store_row_sums<kTBT>(a, red, t[i], G::row(rg, i), warp & 1, (lane & 7) == 0, row0,
                         a.chunk0 + chunk);
    __syncthreads();  // red is read before the next row's sums
  }
}

// The bf16 modes: block (i, c) owns rows [64 i, 64 i + 64) and chunk c;
// per sub-tile both Grams on the mma.sync tiles (gram_bf16 with x and c as
// its two query operands), then w into w^T.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) vjp_grams_tiled_kernel(const VjpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + smem_gram16<kMode == kBf16x3, true>());
  float* rt = red + 2 * 3 * kTB;
  const int row0 = blockIdx.x * kTB, chunk = blockIdx.y;
  load_rows<kTB>(a, rt, row0);
  int sub_begin, sub_end;
  chunk_range(a, chunk, sub_begin, sub_end);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, wr = warp & 3, wc = warp >> 2;
  RowSums t[2] = {};  // rows wr * 16 + g + 8 h
  for (int sub = sub_begin; sub < sub_end; ++sub) {
    const int col0 = sub * kTN;
    const GramOperands op{offset(a.x_hi, row0), offset(a.x_lo, row0), offset(a.c_hi, row0),
                          offset(a.c_lo, row0), offset(a.y_hi, col0), offset(a.y_lo, col0),
                          a.D, a.Bp, a.Np};
    float ax[8][4], ac[8][4];
    gram_bf16<kMode == kBf16x3, true>(ax, ac, op, reinterpret_cast<__nv_bfloat16*>(smem));
    float* wt = a.out + (long long)(col0 - a.sub0 * kTN) * a.Bp + row0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, r = wr * 16 + g + 8 * h;
        const int c = wc * 64 + 8 * n + 2 * tq + (e & 1);
        wt[(long long)c * a.Bp + r] =
            weight(t[h], row_terms<kTB>(rt, r), ax[n][e], ac[n][e], a.ysq[col0 + c],
                   col0 + c < a.n_true);
      }
  }
  // a row's 8 threads: lanes 1 and 2 apart in each of warps wr and wr + 4
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    shuffle_sum(t[h], 1);
    shuffle_sum(t[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    store_row_sums<kTB>(a, red, t[h], wr * 16 + g + 8 * h, wc, tq == 0, row0, a.chunk0 + chunk);
    __syncthreads();  // red is read before the next row's sums
  }
}

// ---------------------------------------------------------------------------
// large D, (2): the product w.Y, split over K

struct ProductArgs {
  float* sy;  // (chunks, Bp, D)
  int Bp, D, sub0, n_sub, per_chunk, chunk0;
};

// Block (i, k, c): sy[chunk0 + c][128 i + r][128 k + e] = sum over the
// chunk's points j of w^T[j][128 i + r] y[j][128 k + e]: the tall engine
// with w^T (maps.q0, the segment's columns as rows) as its query operand
// and the row-major dataset (maps.y, points as rows) as its dataset, the
// chunk's rows of each through the ring; one store per output.
__global__ void __launch_bounds__(ProductGram::kThreads, kProductBlocks)
    vjp_product_kernel(const ProductArgs a, const __grid_constant__ TallMaps maps) {
  using G = ProductGram;
  extern __shared__ __align__(128) unsigned char smem[];
  G::Ring ring;
  ring.init(reinterpret_cast<uint64_t*>(smem + G::kSmem));
  const int row0 = blockIdx.x * kTBT, k0 = blockIdx.y * kTN, chunk = blockIdx.z;
  const int j0 = chunk * a.per_chunk * kTN;  // the chunk's first point in the segment
  const int j1 = min((chunk + 1) * a.per_chunk, a.n_sub) * kTN;
  float acc[1][kPR][kPC];
  G::run_from(acc, maps, row0, k0, j0, a.sub0 * kTN + j0, j1 - j0, reinterpret_cast<float*>(smem),
              ring);
  int rg, cg;
  G::patch(rg, cg);
  const bool vec4 = a.D % 4 == 0;
#pragma unroll
  for (int i = 0; i < kPR; ++i) {
    float* dst = a.sy + ((long long)(a.chunk0 + chunk) * a.Bp + row0 + G::row(rg, i)) * a.D + k0;
#pragma unroll
    for (int h = 0; h < kPC / 4; ++h) {
      const int c = G::col(cg, 4 * h);
      if (vec4) {
        if (k0 + c < a.D)
          *reinterpret_cast<float4*>(dst + c) =
              float4{acc[0][i][4 * h], acc[0][i][4 * h + 1], acc[0][i][4 * h + 2],
                     acc[0][i][4 * h + 3]};
      } else {  // rows of D % 4 != 0 floats are not 16-byte aligned
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + c + e < a.D) dst[c + e] = acc[0][i][4 * h + e];
      }
    }
  }
}

// ---------------------------------------------------------------------------

// One block per query row b < B: add the chunks' sums in order, then
// dx[b] = -invt (W x - s sum w y), dinvt = -A / invt, ds = -invt S.
__global__ void vjp_merge_kernel(const float* __restrict__ partials,
                                 const float* __restrict__ sy, const float* __restrict__ rows,
                                 const float* __restrict__ x, float* __restrict__ dx,
                                 float* __restrict__ dpar, int B, int Bp, int D, int n_chunks,
                                 int n_sy_chunks) {
  const int b = blockIdx.x;
  float w = 0.f, aa = 0.f, ss = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float* p = partials + (long long)c * 3 * Bp + b;
    w += p[0];
    aa += p[Bp];
    ss += p[2 * Bp];
  }
  const float invt = rows[Bp + b], s = rows[2 * Bp + b];
  if (threadIdx.x == 0) {
    dpar[b] = -aa / invt;
    dpar[B + b] = -invt * ss;
  }
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    float v = 0.f;
    for (int c = 0; c < n_sy_chunks; ++c) v += sy[((long long)c * Bp + b) * D + k];
    dx[(long long)b * D + k] = -invt * (w * x[(long long)b * D + k] - s * v);
  }
}

using KernelFn = void (*)(const VjpArgs);

struct Kernel {
  KernelFn fn;
  int smem;
};

// The bf16 modes' Grams kernel for `mode`, its shared memory size set.
cudaError_t select_tiled(int mode, Kernel* k) {
  switch (mode) {
    case kBf16x3: *k = Kernel{vjp_grams_tiled_kernel<kBf16x3>, tiled_smem<kBf16x3>()}; break;
    case kBf16: *k = Kernel{vjp_grams_tiled_kernel<kBf16>, tiled_smem<kBf16>()}; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
}

cudaError_t select_small(int D, KernelFn* fn) {
  switch (D) {
    case 1: *fn = vjp_small_kernel<1>; break;
    case 2: *fn = vjp_small_kernel<2>; break;
    case 3: *fn = vjp_small_kernel<3>; break;
    case 4: *fn = vjp_small_kernel<4>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename F>
cudaError_t set_smem(F* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool segment_ok(int sub0, int n_sub, int per_chunk, int chunk0, int Np) {
  return sub0 >= 0 && n_sub > 0 && per_chunk > 0 && chunk0 >= 0 &&
         (long long)sub0 + n_sub <= Np / kTN;
}

}  // namespace

// Resident blocks per SM of the VJP's kernels: kernel 0 the large-D Grams
// kernel of `mode`, 1 the product; 2 + D the small-D kernel for D (mode 0).
extern "C" int pdm_boltzmann_moments_vjp_blocks_per_sm(int mode, int kernel, int* out) {
  cudaError_t err = cudaSuccess;
  if (kernel == 0 && mode == kFp32) {
    err = set_smem(vjp_grams_tall_kernel, kTallSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, vjp_grams_tall_kernel,
                                                          kTallThreads, kTallSmem);
  } else if (kernel == 0) {
    Kernel k;
    err = select_tiled(mode, &k);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k.fn, kThreads, k.smem);
  } else if (kernel == 1) {
    err = set_smem(vjp_product_kernel, kProductSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, vjp_product_kernel,
                                                          ProductGram::kThreads, kProductSmem);
  } else {
    KernelFn fn;
    err = mode == kFp32 ? select_small(kernel - 2, &fn) : cudaErrorInvalidValue;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kSmallThreads, 0);
  }
  return static_cast<int>(err);
}

// The small-D launch (fp32, 1 <= D <= 4): queries and cotangent (D, Bp)
// fp32, Bp a multiple of 128; the pack (D, Np) fp32 and ysq (Np,), Np a
// multiple of 128; rows (5, Bp); partials (chunks, 3, Bp) and sy (chunks,
// Bp, D); the segment's sub-tiles [sub0, sub0 + n_sub) in chunks of
// per_chunk, written from slot chunk0. Returns cudaGetLastError().
extern "C" int pdm_boltzmann_moments_vjp_small(const void* x, const void* c, const void* y,
                                               const void* ysq, const void* rows, void* partials,
                                               void* sy, int Bp, int D, int Np, int n_true,
                                               int sub0, int n_sub, int per_chunk, int chunk0,
                                               void* stream) {
  KernelFn fn;
  if (Bp <= 0 || Bp % kSmallThreads != 0 || Np % kTN != 0 || n_true <= 0 || n_true > Np ||
      n_true <= Np - kTN || !segment_ok(sub0, n_sub, per_chunk, chunk0, Np) || x == nullptr ||
      c == nullptr || y == nullptr || ysq == nullptr || rows == nullptr || partials == nullptr ||
      sy == nullptr || select_small(D, &fn) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  const VjpArgs a{x, nullptr, c, nullptr, y, nullptr,
                  static_cast<const float*>(ysq), static_cast<const float*>(rows),
                  static_cast<float*>(partials), static_cast<float*>(sy), Bp, D, Np, n_true,
                  sub0, n_sub, per_chunk, chunk0};
  const int n_chunks = (n_sub + per_chunk - 1) / per_chunk;
  fn<<<dim3(Bp / kSmallThreads, n_chunks), kSmallThreads, 0,
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The large-D Grams launch over one segment. Queries and cotangent (D, Bp),
// Bp a multiple of 128, fp32 (mode 0) or bf16 hi and for mode 1 lo; the
// pack (D, Np) likewise, Np a multiple of 128; ysq (Np,); rows (5, Bp);
// partials (chunks, 3, Bp); w (n_sub * 128, Bp) fp32, its row j the
// segment's column sub0 * 128 + j. Returns cudaGetLastError().
extern "C" int pdm_boltzmann_moments_vjp_grams(const void* x_hi, const void* x_lo,
                                               const void* c_hi, const void* c_lo,
                                               const void* y_hi, const void* y_lo,
                                               const void* ysq, const void* rows, void* partials,
                                               void* w, int Bp, int D, int Np, int n_true,
                                               int sub0, int n_sub, int per_chunk, int chunk0,
                                               int mode, void* stream) {
  const bool three = mode == kBf16x3;
  if (mode < kFp32 || mode > kBf16 || Bp <= 0 || Bp % kTBT != 0 || Np % kTN != 0 || D <= 0 ||
      n_true <= 0 || n_true > Np || n_true <= Np - kTN ||
      !segment_ok(sub0, n_sub, per_chunk, chunk0, Np) || x_hi == nullptr || c_hi == nullptr ||
      y_hi == nullptr || ysq == nullptr || rows == nullptr || partials == nullptr ||
      w == nullptr || (x_lo != nullptr) != three || (c_lo != nullptr) != three ||
      (y_lo != nullptr) != three)
    return static_cast<int>(cudaErrorInvalidValue);
  const VjpArgs a{x_hi, x_lo, c_hi, c_lo, y_hi, y_lo,
                  static_cast<const float*>(ysq), static_cast<const float*>(rows),
                  static_cast<float*>(partials), static_cast<float*>(w), Bp, D, Np, n_true,
                  sub0, n_sub, per_chunk, chunk0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n_sub + per_chunk - 1) / per_chunk;
  if (mode == kFp32) {
    cudaError_t err = set_smem(vjp_grams_tall_kernel, kTallSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int kTK = VjpGram::kTK;
    TallMaps maps{};
    if (!tile_map(&maps.q0, x_hi, D, Bp, Bp, kTK, kTBT) ||
        !tile_map(&maps.q1, c_hi, D, Bp, Bp, kTK, kTBT) ||
        !tile_map(&maps.y, y_hi, D, Np, Np, kTK, kTN))
      return static_cast<int>(cudaErrorInvalidValue);
    vjp_grams_tall_kernel<<<dim3(Bp / kTBT, n_chunks), kTallThreads, kTallSmem, s>>>(a, maps);
    return static_cast<int>(cudaGetLastError());
  }
  Kernel k;
  const cudaError_t err = select_tiled(mode, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  k.fn<<<dim3(Bp / kTB, n_chunks), kThreads, k.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The large-D product launch over one segment: w (n_sub * 128, Bp) fp32
// (the Grams launch's), the dataset y (n_true, D) fp32 row-major with ldy
// floats between rows (ldy a multiple of 4 and at least D, y 16-byte
// aligned); sy (chunks, Bp, D), the segment's chunks of per_chunk
// sub-tiles written from slot chunk0. Returns cudaGetLastError().
extern "C" int pdm_boltzmann_moments_vjp_product(const void* w, const void* y, void* sy, int Bp,
                                                 int D, int ldy, int n_true, int sub0, int n_sub,
                                                 int per_chunk, int chunk0, void* stream) {
  if (Bp <= 0 || Bp % kTBT != 0 || D <= 0 || ldy < D || ldy % 4 != 0 || n_true <= 0 ||
      sub0 < 0 || n_sub <= 0 || per_chunk <= 0 || chunk0 < 0 ||
      (long long)sub0 * kTN >= n_true || w == nullptr || y == nullptr || sy == nullptr ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(vjp_product_kernel, kProductSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kTK = ProductGram::kTK;
  TallMaps maps{};
  if (!tile_map(&maps.q0, w, (long long)n_sub * kTN, Bp, Bp, kTK, kTBT) ||
      !tile_map(&maps.y, y, n_true, D, ldy, kTK, kTN))
    return static_cast<int>(cudaErrorInvalidValue);
  const ProductArgs a{static_cast<float*>(sy), Bp, D, sub0, n_sub, per_chunk, chunk0};
  const int n_chunks = (n_sub + per_chunk - 1) / per_chunk;
  vjp_product_kernel<<<dim3(Bp / kTBT, (D + kTN - 1) / kTN, n_chunks), ProductGram::kThreads,
                       kProductSmem, static_cast<cudaStream_t>(stream)>>>(a, maps);
  return static_cast<int>(cudaGetLastError());
}

// The merge launch: partials (n_chunks, 3, Bp), sy (n_sy_chunks, Bp, D),
// rows (5, Bp) and x (B, D) fp32 -> dx (B, D), dpar (2, B): d invt, d s.
extern "C" int pdm_boltzmann_moments_vjp_merge(const void* partials, const void* sy,
                                               const void* rows, const void* x, void* dx,
                                               void* dpar, int B, int Bp, int D, int n_chunks,
                                               int n_sy_chunks, void* stream) {
  if (B <= 0 || B > Bp || D <= 0 || n_chunks <= 0 || n_sy_chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  vjp_merge_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<const float*>(sy),
      static_cast<const float*>(rows), static_cast<const float*>(x), static_cast<float*>(dx),
      static_cast<float*>(dpar), B, Bp, D, n_chunks, n_sy_chunks);
  return static_cast<int>(cudaGetLastError());
}
