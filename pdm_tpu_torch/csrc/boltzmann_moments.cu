// Single-temperature Boltzmann moments and posterior mean for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/boltzmann_pallas.py::_kernel (launched
// by _pallas_moments). For queries x (B, D), a dataset y (N, D), a per-row
// inverse temperature invt_i and dataset scale s_i, the posterior of row i
// over the dataset has the logits
//   l_ij = -h_ij * invt_i,  h_ij = 0.5|x_i|^2 - s_i x_i.y_j + s_i^2 0.5|y_j|^2,
// and the kernel returns, per row, log_z, the shift (max logit), the
// shift-stabilized moments e1_hat and e2_hat of g = -l, and optionally the
// posterior mean of an (N, K) payload, sum_j p_ij v_j. This is the analytic
// denoiser's op: x = xt, invt = 1 / (1 - alpha_bar), s = sqrt(alpha_bar),
// v = y.
//
// What bounds it on the H100: operations. The Gram is 2 B N D per pass and
// the payload product 2 B N K; at CIFAR-10 scale with the data as payload
// (B = 1000, N = 50,000, D = K = 3072) both are 3.07e11 flops, 9.2 ms in
// fp32 on the CUDA cores (67 TFLOP/s) against ~0.2 ms to read the inputs.
// The payload product runs in fp32 in every mode; the Gram in the mode's
// arithmetic (fp32 FFMA, never TF32, or bf16 mma.sync in one or three
// passes).
//
// Design. Block (i, c) owns a query tile i and dataset chunk c (a run of
// 128-column sub-tiles); a second launch joins the chunks exactly: mean =
// sum_c exp(m_c - m_g) sy_c / s0_g. For each sub-tile the block computes
// the Gram, turns it into logits in shared memory (column-major, so a
// row's columns are a conflict-free stride), and updates each row's
// online-softmax accumulators (in registers across the chunk) with two or
// four threads per row that join their max and sums by shuffles. With a
// payload it turns the tile into p = exp(l - m) in place (0 past N) and
// multiplies it into the payload. The payload's (rows x K) sums do not fit
// on one SM at K = 3072 (the TPU kernel keeps them in VMEM), so three
// kernels share the work, chosen by the wrapper per call
// (ops/boltzmann_kernel.py::kernel_choice):
//  * tall (every fp32 call): 128-row tiles, the Gram and the
//    product p (128 x 128) . V (128 x 128-column K-tile) both on the tall
//    fp32 engine (boltzmann_common.cuh: 8 x 8 patches), the queries, the
//    dataset and V through TMA rings (V of K % 4 != 0 by cp.async), V's
//    ring running over all K-tiles of a sub-tile; after each K-tile the
//    block adds the product into its slice of a partials buffer
//    (n_chunks, Bp, K), rescaling the old sums by the row's exp(m_old -
//    m_new) in the same read-modify-write (~9.8 GB a call at the scale
//    above; PERF.md gives what it costs);
//  * cluster (bf16 modes, K % 4 == 0 up to 3072): a cluster of C <= 8
//    blocks shares a 64-row tile and a chunk walked in groups of C
//    256-column tiles; block r computes the logits of its tile of the
//    group, the cluster joins the maxima and sums through distributed
//    shared memory, and every block multiplies the whole group's p into its
//    own 128 or 384 payload columns, kept in registers for the chunk, so
//    the partials are written once per chunk. In fp32 it ran slower than
//    the tall kernel: one block an SM (its registers hold the sums), and
//    not every SM can join a cluster of 8;
//  * tiled (the bf16 modes' other calls: no payload, K above 3072, or
//    K % 4 != 0): 64-row tiles, the product one
//    128-column K-tile at a time, each its own cp.async ring, and the
//    read-modify-write per K-tile as the tall.
// A payload of K % 4 != 0 (rows not 16-byte aligned) is read with 4-byte
// copies and its sums written one float at a time.
// The payload is read row-major (N, K), the contraction-major layout the
// product needs: for the denoiser it is the caller's own fp32 data, so
// nothing is copied. Padded query rows compute harmless values that are
// never read; columns past N are left out of the update and get p = 0.
// No atomics: every sum runs in a fixed order, so two calls agree bitwise.

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "boltzmann_common.cuh"

namespace {

using namespace pdm_boltz;

enum Mode : int { kFp32 = 0, kBf16x3 = 1, kBf16 = 2 };
// the payload: none, rows of K % 4 == 0 floats (16-byte copies), any K (4-byte copies)
enum Payload : int { kNone = 0, kVec4 = 1, kScalar = 2 };

constexpr int kLS = kTB + 8;   // shared stride of the logit tile L[column][row]
constexpr int kTKV = 128;      // payload columns per K-tile
constexpr int kTNV = 16;       // dataset points per stage of the payload ring
constexpr int kSmemLogits = kTN * kLS * 4;
constexpr int kSmemRingV = kStages * kTNV * kTKV * 4;

// the mma.sync engine's ring (the 64-row kernels run the bf16 modes only)
template <int kMode>
__host__ __device__ constexpr int smem_gram() {
  return smem_gram16<kMode == kBf16x3, false>();
}

// The logit tile overlays the Gram's ring (free once the Gram is done), the
// payload ring follows the logit tile, the rows' rescale factors follow both.
template <int kPayload>
__host__ __device__ constexpr int smem_main() {
  return kSmemLogits + (kPayload != kNone ? kSmemRingV : 0);
}
template <int kMode, int kPayload>
__host__ __device__ constexpr int smem_bytes() {
  return (smem_gram<kMode>() > smem_main<kPayload>() ? smem_gram<kMode>()
                                                     : smem_main<kPayload>()) +
         kTB * 4;
}

struct MomentsArgs {
  const void* x_hi;     // (D, Bp) fp32 or bf16: the queries transposed, zero-padded rows
  const void* x_lo;     // bf16_3x only
  const void* y_hi;     // (D, Np): the dataset
  const void* y_lo;
  const float* ysq;     // (Np,) 0.5|y|^2
  const float* xsq;     // (Bp,) 0.5|x|^2
  const float* invt;    // (Bp,) inverse temperature
  const float* scale;   // (Bp,) dataset scale s
  const float* values;  // (n_true, K) payload, row-major, or null
  float* partials;      // (n_chunks, 4, Bp): m, s0, s1, s2
  float* sy;            // (n_chunks, Bp, K): payload sums, or null
  int Bp, D, Np, n_true, K, per_chunk;
};

__device__ __forceinline__ const void* offset(const void* p, long long elems) {
  return p == nullptr ? nullptr : static_cast<const __nv_bfloat16*>(p) + elems;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// The logits of the block's rows against dataset columns [col0, col0 + kTN)
// into L[column * kLS + row] (the mma.sync engine: bf16 modes).
template <int kMode>
__device__ __forceinline__ void tile_logits(const MomentsArgs& a, int row0, int col0,
                                            unsigned char* smem, float* L) {
  static_assert(kMode != kFp32, "fp32 runs the tall kernel");
  const GramOperands op{offset(a.x_hi, row0), offset(a.x_lo, row0), nullptr, nullptr,
                        offset(a.y_hi, col0), offset(a.y_lo, col0), a.D, a.Bp, a.Np};
  float ax[8][4], unused[8][4];
  gram_bf16<kMode == kBf16x3, false>(ax, unused, op, reinterpret_cast<__nv_bfloat16*>(smem));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (warp & 3) * 16 + g + 8 * h;
    const float xsq = a.xsq[row0 + r], s = a.scale[row0 + r], invt = a.invt[row0 + r];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const int c = (warp >> 2) * 64 + 8 * n + 2 * tq + (e & 1);
        L[c * kLS + r] = logit(xsq, s, invt, ax[n][e], a.ysq[col0 + c]);
      }
  }
  __syncthreads();
}

// The moment update of one sub-tile with four threads per row: thread
// (row r, part) takes columns part + 4j < ncols; the four join their max
// and sums by shuffles (lanes 8 and 16 apart), so each holds the row's
// accumulators. With a payload it turns the tile into p = exp(l - m_new)
// in place (0 past ncols) and returns exp(m_old - m_new), the factor of the
// payload sums kept in the partials buffer.
template <bool kWithValues>
__device__ __forceinline__ float update_row(Moments& acc, float* L, int r, int part, int ncols) {
  float mx = -INFINITY;
  for (int c = part; c < ncols; c += 4) mx = fmaxf(mx, L[c * kLS + r]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
  const float m_new = fmaxf(acc.m, mx);
  const bool live = m_new > -INFINITY;  // false only while every logit is -inf
  float ps = 0.f, pg = 0.f, pgg = 0.f;
  const int end = kWithValues ? kTN : ncols;
  for (int c = part; c < end; c += 4) {
    float p = 0.f;
    if (live && c < ncols) {
      const float l = L[c * kLS + r];
      p = expf(l - m_new);
      const float g = m_new - l;
      const float pgc = p * g;
      ps += p;
      pg += pgc;
      pgg += pgc * g;
    }
    if constexpr (kWithValues) L[c * kLS + r] = p;
  }
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1) {
    ps += __shfl_xor_sync(0xffffffffu, ps, off);
    pg += __shfl_xor_sync(0xffffffffu, pg, off);
    pgg += __shfl_xor_sync(0xffffffffu, pgg, off);
  }
  if (!live) return 1.f;
  return fold_moments(acc, m_new, ps, pg, pgg, 0.f);
}

// acc[i][j] of the tiled kernel's payload product: tile row r0 + i, column
// c0 + j (j < 4) or c0 + 28 + j (j >= 4)
__device__ __forceinline__ void fp32_patch(int& r0, int& c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r0 = (warp & 3) * 16 + (lane >> 3) * 4;
  c0 = (warp >> 2) * 64 + (lane & 7) * 4;
}

__device__ __forceinline__ int fp32_col(int c0, int j) { return j < 4 ? c0 + j : c0 + 28 + j; }

// sy[chunk][row0 + r][:] = rescale * sy + p . V[col0, col0 + kTN) (or, on
// the chunk's first sub-tile, the product alone), one K-tile at a time:
// each thread a 4 x 8 patch (fp32_patch) of the tile, p from L, V through
// the ring.
template <int kPayload>
__device__ __forceinline__ void payload_product(const MomentsArgs& a, const float* L, float* ring,
                                                const float* row_c, int row0, int col0,
                                                int chunk, bool first) {
  const int tid = threadIdx.x;
  int r0, c0;
  fp32_patch(r0, c0);
  float* slice = a.sy + ((long long)chunk * a.Bp + row0) * a.K;
  for (int k0 = 0; k0 < a.K; k0 += kTKV) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    auto load = [&](int stage, int nt) {
      float* vs = ring + stage * kTNV * kTKV;
      const int n0 = col0 + nt * kTNV;
      if constexpr (kPayload == kVec4) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // 16 points x 32 float4
          const int idx = tid + i * kThreads;
          const int n = idx >> 5, c4 = (idx & 31) * 4;
          const bool ok = n0 + n < a.n_true && k0 + c4 < a.K;
          const float* src = ok ? a.values + (long long)(n0 + n) * a.K + k0 + c4 : a.values;
          cp_async16(vs + n * kTKV + c4, src, ok);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // 16 points x 128 floats
          const int idx = tid + i * kThreads;
          const int n = idx >> 7, c = idx & (kTKV - 1);
          const bool ok = n0 + n < a.n_true && k0 + c < a.K;
          const float* src = ok ? a.values + (long long)(n0 + n) * a.K + k0 + c : a.values;
          cp_async4(vs + n * kTKV + c, src, ok);
        }
      }
    };
    int step = 0;  // contraction step of the next compute (they run in order)
    auto compute = [&](int stage) {
      const float* vs = ring + stage * kTNV * kTKV;
      const float* ps = L + step * kTNV * kLS;
#pragma unroll
      for (int kk = 0; kk < kTNV; ++kk) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + kk * kLS + r0);
        const float4 v0 = *reinterpret_cast<const float4*>(vs + kk * kTKV + c0);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + kk * kTKV + c0 + 32);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
        const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
      }
      ++step;
    };
    pipeline<kTNV>(kTN, load, compute);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      const float c = row_c[r];
      float* dst = slice + (long long)r * a.K + k0;
      if constexpr (kPayload == kVec4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = c0 + 32 * h;
          if (k0 + col >= a.K) continue;
          float4 v{acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
          if (!first) {
            const float4 old = *reinterpret_cast<const float4*>(dst + col);
            v = float4{old.x * c + v.x, old.y * c + v.y, old.z * c + v.z, old.w * c + v.w};
          }
          *reinterpret_cast<float4*>(dst + col) = v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = fp32_col(c0, j);
          if (k0 + col >= a.K) continue;
          dst[col] = first ? acc[i][j] : dst[col] * c + acc[i][j];
        }
      }
    }
  }
}

template <int kMode, int kPayload>
__global__ void __launch_bounds__(kThreads, 2) moments_partials_kernel(const MomentsArgs a) {
  constexpr bool kWithValues = kPayload != kNone;
  extern __shared__ __align__(16) unsigned char smem[];
  float* L = reinterpret_cast<float*>(smem);
  float* ring = L + kTN * kLS;
  float* row_c = reinterpret_cast<float*>(smem + smem_bytes<kMode, kPayload>() - kTB * 4);
  const int row0 = blockIdx.x * kTB;
  const int chunk = blockIdx.y;
  const int n_sub = a.Np / kTN;
  const int sub0 = chunk * a.per_chunk;
  const int sub1 = min(sub0 + a.per_chunk, n_sub);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int urow = warp * 8 + (lane & 7), part = lane >> 3;  // this thread's row in the update

  Moments acc = empty_moments();
  for (int sub = sub0; sub < sub1; ++sub) {
    const int col0 = sub * kTN;
    tile_logits<kMode>(a, row0, col0, smem, L);
    const float c = update_row<kWithValues>(acc, L, urow, part, min(kTN, a.n_true - col0));
    if constexpr (kWithValues) {
      if (part == 0) row_c[urow] = c;
      __syncthreads();  // p and the rescale factors are in
      payload_product<kPayload>(a, L, ring, row_c, row0, col0, chunk, sub == sub0);
    }
    __syncthreads();  // L is read before the next Gram reuses it
  }
  if (part == 0) {
    float* p = a.partials + (long long)chunk * 4 * a.Bp + row0 + urow;
    p[0] = acc.m;
    p[a.Bp] = acc.s0;
    p[2 * a.Bp] = acc.s1;
    p[3 * a.Bp] = acc.s2;
  }
}

// One block per query row b < B: join the chunks' partials (merge_into),
// finalize, and with a payload mean[b] = sum_c exp(m_c - m_g) sy_c[b] / s0_g.
__global__ void moments_merge_kernel(const float* __restrict__ partials,
                                     const float* __restrict__ sy, float* __restrict__ out,
                                     float* __restrict__ mean, int B, int Bp, int n_chunks, int K) {
  const int b = blockIdx.x;
  Moments acc = empty_moments();
  for (int c = 0; c < n_chunks; ++c) {
    const float* p = partials + (long long)c * 4 * Bp + b;
    merge_into(acc, Moments{p[0], p[Bp], p[2 * Bp], p[3 * Bp], 0.f});
  }
  if (threadIdx.x == 0) {
    out[b] = acc.m + logf(acc.s0);
    out[B + b] = acc.m;
    out[2 * B + b] = acc.s1 / acc.s0;
    out[3 * B + b] = acc.s2 / acc.s0;
  }
  if (sy == nullptr) return;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float v = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float m = partials[(long long)c * 4 * Bp + b];
      const float w = m > -INFINITY ? expf(m - acc.m) : 0.f;
      v += w * sy[((long long)c * Bp + b) * K + k];
    }
    mean[(long long)b * K + k] = v / acc.s0;
  }
}

// ---------------------------------------------------------------------------
// The tall kernel (fp32): 128 query rows a block on the tall engine, one
// query operand, 256 threads with 8 x 8 patches.

constexpr int kTBT = 128;            // query rows of a tall tile
constexpr int kLST = kTBT + 16;      // shared stride of its logit tile (conflict-free update)
constexpr int kTKP = 16;             // payload points per ring stage
constexpr int kPSlot = kTKP * kTKV;  // floats of a payload ring slot
constexpr int kPStages = 4;          // payload ring depth

// The Gram's engine: 32-row stages 3 deep without a payload, 16-row
// stages 6 deep with one (each fastest there; both 96 KB).
template <int kPayload>
using MomentsGram = TallGram<8, 8, 1, kPayload == kNone ? 32 : 16, kPayload == kNone ? 3 : 6>;
using PayloadRing = TmaRing<kPStages>;

// The logit tile, then the payload ring's region, then per row the
// rescale factor and the three terms of the logit (0.5|x|^2, s, 1/T), then
// the payload ring's and the Gram's mbarriers. The Gram's ring spans the
// logit tile and the region: both are free while the Gram runs.
constexpr int kSmemLogitsT = kTN * kLST * 4;
constexpr int kSmemRegion = kPStages * kPSlot * 4;
template <int kPayload>
__host__ __device__ constexpr int tall_smem() {
  static_assert(MomentsGram<kPayload>::kSmem <= kSmemLogitsT + kSmemRegion, "the Gram's ring");
  return kSmemLogitsT + kSmemRegion + 4 * kTBT * 4 + PayloadRing::kBarBytes +
         MomentsGram<kPayload>::Ring::kBarBytes;
}

// The block's payload sums, one 128-column K-tile at a time: p (the 128 x
// 128 tile in L) times V's rows [col0, col0 + 128), through one ring over
// all K-tiles (kTKP points a stage; V by TMA boxes of `maps.v`, or by
// 4-byte cp.async copies for rows of K % 4 != 0 floats, which TMA cannot
// address); after a K-tile's last stage, sy = rescale * sy + the product
// (the product alone on the chunk's first sub-tile), and its accumulators
// restart.
template <int kPayload>
__device__ __forceinline__ void tall_payload(const MomentsArgs& a, const TallMaps& maps,
                                             const float* L, float* region, PayloadRing& ring,
                                             const float* rscale, int row0, int col0, int chunk,
                                             bool first) {
  using G = MomentsGram<kPayload>;
  constexpr int kSteps = kTN / kTKP;  // ring stages per K-tile
  const int tid = threadIdx.x;
  int rg, cg;
  G::patch(rg, cg);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto issue = [&](int slot, int step, uint64_t* bar) {
    tma_load_2d(region + slot * kPSlot, &maps.v, bar, (step / kSteps) * kTKV,
                col0 + (step % kSteps) * kTKP);
  };
  auto load = [&](int slot, int step) {  // kScalar: kTKP points x 128 floats
    const int k0 = (step / kSteps) * kTKV, n0 = col0 + (step % kSteps) * kTKP;
#pragma unroll
    for (int i = 0; i < kPSlot / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int n = idx >> 7, c = idx & (kTKV - 1);
      const bool ok = n0 + n < a.n_true && k0 + c < a.K;
      const float* src = ok ? a.values + (long long)(n0 + n) * a.K + k0 + c : a.values;
      cp_async4(region + slot * kPSlot + n * kTKV + c, src, ok);
    }
  };
  auto compute = [&](int slot, int step) {
    const float* vs = region + slot * kPSlot;
    const float* ps = L + (step % kSteps) * kTKP * kLST;
#pragma unroll
    for (int kk = 0; kk < kTKP; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + kk * kLST + rg * 4);
      const float4 pb = *reinterpret_cast<const float4*>(ps + kk * kLST + G::kRS + rg * 4);
      const float4 va = *reinterpret_cast<const float4*>(vs + kk * kTKV + cg * 4);
      const float4 vb = *reinterpret_cast<const float4*>(vs + kk * kTKV + G::kCS + cg * 4);
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float vr[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
    }
    if (step % kSteps != kSteps - 1) return;
    const int k0 = (step / kSteps) * kTKV;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = G::row(rg, i);
      const float f = rscale[r];
      float* dst = a.sy + ((long long)chunk * a.Bp + row0 + r) * a.K + k0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h * G::kCS + cg * 4;
        if constexpr (kPayload == kVec4) {
          float4 v{acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
          if (k0 + c < a.K) {
            if (!first) {
              const float4 old = *reinterpret_cast<const float4*>(dst + c);
              v = float4{old.x * f + v.x, old.y * f + v.y, old.z * f + v.z, old.w * f + v.w};
            }
            *reinterpret_cast<float4*>(dst + c) = v;
          }
        } else {  // rows of K % 4 != 0 floats are not 16-byte aligned
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + c + e < a.K)
              dst[c + e] = first ? acc[i][4 * h + e] : dst[c + e] * f + acc[i][4 * h + e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][4 * h + e] = 0.f;
      }
    }
  };
  const int n = ((a.K + kTKV - 1) / kTKV) * kSteps;
  if constexpr (kPayload == kVec4)
    ring.run(n, kPSlot * 4, issue, compute);
  else
    ring_pipeline<kPStages>(n, load, compute);
}

// The logits of the block's 128 rows (terms in rterm: 0.5|x|^2, s, 1/T)
// against dataset columns [col0, col0 + 128) into L[column * kLST + row],
// through the engine G, its ring over L and the region.
template <typename G>
__device__ __forceinline__ void tall_logits(const MomentsArgs& a, const TallMaps& maps, int row0,
                                            int col0, typename G::Ring& ring, const float* rterm,
                                            float* L) {
  float acc[1][8][8];
  G::run(acc, maps, row0, col0, a.D, L, ring);
  int rg, cg;
  G::patch(rg, cg);
  float xsq[8], s[8], invt[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = G::row(rg, i);
    xsq[i] = rterm[r];
    s[i] = rterm[kTBT + r];
    invt[i] = rterm[2 * kTBT + r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = G::col(cg, j);
    const float ysq = a.ysq[col0 + c];
    float l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) l[i] = logit(xsq[i], s[i], invt[i], acc[0][i][j], ysq);
    *reinterpret_cast<float4*>(L + c * kLST + rg * 4) = float4{l[0], l[1], l[2], l[3]};
    *reinterpret_cast<float4*>(L + c * kLST + G::kRS + rg * 4) = float4{l[4], l[5], l[6], l[7]};
  }
  __syncthreads();  // the logit tile is in
}

// Block (i, c) owns query rows [128 i, 128 i + 128) and dataset chunk c,
// as the tiled kernel; per 128-column sub-tile: the Gram (MomentsGram, the
// queries and the dataset through the TMA ring of `maps`), the logits into
// L[column * kLST + row], the moment update with two threads per row, and
// with a payload p in place and tall_payload.
template <int kPayload>
__global__ void __launch_bounds__(kThreads, 2)
    moments_tall_kernel(const MomentsArgs a, const __grid_constant__ TallMaps maps) {
  using G = MomentsGram<kPayload>;
  constexpr bool kWithValues = kPayload != kNone;
  extern __shared__ __align__(128) unsigned char smem[];
  float* L = reinterpret_cast<float*>(smem);
  float* region = L + kTN * kLST;
  float* rscale = region + kSmemRegion / 4;
  float* rterm = rscale + kTBT;  // three planes: 0.5|x|^2, s, 1/T
  uint64_t* bars = reinterpret_cast<uint64_t*>(rterm + 3 * kTBT);
  PayloadRing ring;
  ring.init(bars);
  typename G::Ring gram_ring;
  gram_ring.init(bars + PayloadRing::kBarBytes / 8);
  const int row0 = blockIdx.x * kTBT, chunk = blockIdx.y;
  for (int r = threadIdx.x; r < kTBT; r += kThreads) {
    rterm[r] = a.xsq[row0 + r];
    rterm[kTBT + r] = a.scale[row0 + r];
    rterm[2 * kTBT + r] = a.invt[row0 + r];
  }
  const int n_sub = a.Np / kTN;
  const int sub0 = chunk * a.per_chunk;
  const int sub1 = min(sub0 + a.per_chunk, n_sub);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int urow = warp * 16 + (lane & 15), part = lane >> 4;  // this thread's row in the update

  Moments mom = empty_moments();
  for (int sub = sub0; sub < sub1; ++sub) {
    const int col0 = sub * kTN;
    tall_logits<G>(a, maps, row0, col0, gram_ring, rterm, L);
    const int ncols = min(kTN, a.n_true - col0);
    float mx = -INFINITY;
    for (int c = part; c < ncols; c += 2) mx = fmaxf(mx, L[c * kLST + urow]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(mom.m, mx);
    const bool live = m_new > -INFINITY;  // false only while every logit is -inf
    float ps = 0.f, pg = 0.f, pgg = 0.f;
    for (int c = part; c < (kWithValues ? kTN : ncols); c += 2) {
      float p = 0.f;
      if (live && c < ncols) {
        const float l = L[c * kLST + urow];
        p = expf(l - m_new);
        const float g = m_new - l;
        const float pgc = p * g;
        ps += p;
        pg += pgc;
        pgg += pgc * g;
      }
      if constexpr (kWithValues) L[c * kLST + urow] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 16);
    pg += __shfl_xor_sync(0xffffffffu, pg, 16);
    pgg += __shfl_xor_sync(0xffffffffu, pgg, 16);
    const float scale = live ? fold_moments(mom, m_new, ps, pg, pgg, 0.f) : 1.f;
    if constexpr (kWithValues) {
      if (part == 0) rscale[urow] = scale;
      __syncthreads();  // p and the rescale factors are in
      tall_payload<kPayload>(a, maps, L, region, ring, rscale, row0, col0, chunk, sub == sub0);
    }
  }
  if (part == 0) {
    float* p = a.partials + (long long)chunk * 4 * a.Bp + row0 + urow;
    p[0] = mom.m;
    p[a.Bp] = mom.s0;
    p[2 * a.Bp] = mom.s1;
    p[3 * a.Bp] = mom.s2;
  }
}

// ---------------------------------------------------------------------------
// The cluster kernel (bf16 modes): the payload sums stay on chip for the
// whole chunk.

namespace cg = cooperative_groups;

constexpr int kTW = 2 * kTN;    // dataset columns of a cluster tile (256)
constexpr int kRowF = 5 * kTB;  // per-row floats: max, three sums, rescale

// One slot of the payload ring: kTNV points of the block's kW payload
// columns, then the same points' p for the 64 rows (point-major).
template <int kW>
__host__ __device__ constexpr int pslot_floats() {
  return kTNV * kW + kTNV * kTB;
}

// The logit tile, then a region that holds the Gram's ring during the
// Gram and the payload ring after it, then the per-row floats.
template <int kMode, int kW>
__host__ __device__ constexpr int cluster_region() {
  return kPStages * pslot_floats<kW>() * 4 > smem_gram<kMode>()
             ? kPStages * pslot_floats<kW>() * 4
             : smem_gram<kMode>();
}
template <int kMode, int kW>
__host__ __device__ constexpr int cluster_smem() {
  return kTW * kLS * 4 + cluster_region<kMode, kW>() + kRowF * 4;
}

// The cluster tiles' threads: row group rg (0-7) and column group cg
// (0-31); the payload accumulator acc[i][4q + e] is row cl_row(rg, i),
// column 128 q + 4 cg + e of the block's kW columns.
__device__ __forceinline__ void cl_patch(int& rg, int& cg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  rg = (warp >> 2) * 4 + (lane >> 3);
  cg = (warp & 3) * 8 + (lane & 7);
}
__device__ __forceinline__ int cl_row(int rg, int i) { return (i < 4 ? 0 : 28) + rg * 4 + i; }

// Row r's max over L's first ncols columns, with four threads per row
// (columns part + 4j), joined by shuffles.
__device__ __forceinline__ float tile_max(const float* L, int r, int part, int ncols) {
  float mx = -INFINITY;
  for (int c = part; c < ncols; c += 4) mx = fmaxf(mx, L[c * kLS + r]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
  return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
}

// The cluster's p . V for one group: every tile of the group (n_valid of
// them, tile0 + j held by block j), taken from block (rank + t) % n_valid
// at turn t, times the block's payload columns [k0, k0 + kW), into acc.
// One ring runs over the group's points: V through cp.async, and p, read
// from the owner's shared memory (distributed shared memory for a peer),
// held in registers across one stage's products and then stored into the
// slot.
template <int kW>
__device__ __forceinline__ void payload_group(const MomentsArgs& a, cg::cluster_group& cluster,
                                              float* L, float* ring, float (&acc)[8][kW / 32],
                                              int rank, int n_valid, int tile0, int k0) {
  constexpr int kQ = kW / 128;
  constexpr int kV = kTNV * kW;
  constexpr int kSlot = pslot_floats<kW>();
  constexpr int kSteps = kTW / kTNV;  // ring stages per tile
  const int tid = threadIdx.x;
  int rg, cg;
  cl_patch(rg, cg);
  auto p_src = [&](int s) {
    const int j = (rank + s / kSteps) % n_valid;
    const float* owner = cluster.map_shared_rank(L, j);
    return *reinterpret_cast<const float4*>(owner + ((s % kSteps) * kTNV + (tid >> 4)) * kLS +
                                            (tid & 15) * 4);
  };
  auto load = [&](int slot, int s) {
    float* vs = ring + slot * kSlot;
    const int n0 = (tile0 + (rank + s / kSteps) % n_valid) * kTW + (s % kSteps) * kTNV;
#pragma unroll
    for (int i = 0; i < kV / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int n = idx / (kW / 4), c4 = (idx % (kW / 4)) * 4;
      const bool ok = n0 + n < a.n_true && k0 + c4 < a.K;
      const float* src = ok ? a.values + (long long)(n0 + n) * a.K + k0 + c4 : a.values;
      cp_async16(vs + n * kW + c4, src, ok);
    }
  };
  const int n_steps = n_valid * kSteps;
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < n_steps) {
      load(s, s);
      *reinterpret_cast<float4*>(ring + s * kSlot + kV + tid * 4) = p_src(s);
    }
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();  // stage s is in; every thread is done with s - 1
    const int ns = s + kPStages - 1;
    float4 pn = float4{0.f, 0.f, 0.f, 0.f};
    if (ns < n_steps) {
      load(ns % kPStages, ns);
      pn = p_src(ns);
    }
    cp_async_commit();
    const float* vs = ring + (s % kPStages) * kSlot;
    const float* ps = vs + kV;
#pragma unroll
    for (int kk = 0; kk < kTNV; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + kk * kTB + rg * 4);
      const float4 pb = *reinterpret_cast<const float4*>(ps + kk * kTB + 32 + rg * 4);
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(vs + kk * kW + q * 128 + cg * 4);
        const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * q + e] = fmaf(pr[i], vr[e], acc[i][4 * q + e]);
      }
    }
    if (ns < n_steps)
      *reinterpret_cast<float4*>(ring + (ns % kPStages) * kSlot + kV + tid * 4) = pn;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next Gram
}

// Grid (C, row tiles, chunks) in clusters of C blocks along x. The blocks
// of a cluster share a 64-row query tile and a chunk of the dataset, a run
// of 256-column tiles walked in groups of C: block `rank` computes the
// logits of tile t0 + g C + rank (two 128-column halves through the
// mma.sync engine), the cluster joins the rows' maxima and sums through
// distributed shared memory (every block folds the same numbers in rank
// order, so all hold the same accumulators), and each block multiplies
// the whole group's p into its own kW payload columns, kept in registers
// for the chunk.
template <int kMode, int kW>
__global__ void __launch_bounds__(kThreads, 1) moments_cluster_kernel(const MomentsArgs a) {
  constexpr int kA = kW / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float* L = reinterpret_cast<float*>(smem);
  unsigned char* region = smem + kTW * kLS * 4;
  float* rows = reinterpret_cast<float*>(region + cluster_region<kMode, kW>());
  float* rmax = rows;
  float* rsum = rows + kTB;  // three planes: sum p, sum p g, sum p g^2
  float* rscale = rows + 4 * kTB;
  const int C = gridDim.x, rank = blockIdx.x;
  const int row0 = blockIdx.y * kTB, chunk = blockIdx.z;
  const int n_tiles = (a.Np + kTW - 1) / kTW;
  const int t0 = chunk * a.per_chunk;
  const int t1 = min(t0 + a.per_chunk, n_tiles);
  const int n_groups = t1 > t0 ? (t1 - t0 + C - 1) / C : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int urow = warp * 8 + (lane & 7), part = lane >> 3;  // this thread's row in the update
  int rg, cg;
  cl_patch(rg, cg);

  float acc[8][kA];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kA; ++j) acc[i][j] = 0.f;
  Moments mom = empty_moments();
  for (int g = 0; g < n_groups; ++g) {
    const int tile0 = t0 + g * C;
    const int n_valid = min(C, t1 - tile0);
    const bool mine = rank < n_valid;
    const int col0 = (tile0 + rank) * kTW;
    const int ncols = mine ? min(kTW, a.n_true - col0) : 0;
    if (mine) {
      tile_logits<kMode>(a, row0, col0, region, L);
      if (a.Np - col0 > kTN) tile_logits<kMode>(a, row0, col0 + kTN, region, L + kTN * kLS);
    }
    const float mx = tile_max(L, urow, part, ncols);
    if (part == 0) rmax[urow] = mx;
    cluster.sync();  // every block's maxima are in
    float m_new = mom.m;
    for (int j = 0; j < C; ++j) m_new = fmaxf(m_new, *cluster.map_shared_rank(rmax + urow, j));
    const bool live = m_new > -INFINITY;  // false only while every logit is -inf
    float ps = 0.f, pg = 0.f, pgg = 0.f;
    for (int c = part; c < (mine ? kTW : 0); c += 4) {
      float p = 0.f;
      if (live && c < ncols) {
        const float l = L[c * kLS + urow];
        p = expf(l - m_new);
        const float gg = m_new - l;
        const float pgc = p * gg;
        ps += p;
        pg += pgc;
        pgg += pgc * gg;
      }
      L[c * kLS + urow] = p;
    }
#pragma unroll
    for (int off = 8; off <= 16; off <<= 1) {
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
      pg += __shfl_xor_sync(0xffffffffu, pg, off);
      pgg += __shfl_xor_sync(0xffffffffu, pgg, off);
    }
    if (part == 0) {
      rsum[urow] = ps;
      rsum[kTB + urow] = pg;
      rsum[2 * kTB + urow] = pgg;
    }
    cluster.sync();  // every block's p tile and sums are in
    float scale = 1.f;
    if (live) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < C; ++j) {
        const float* r = cluster.map_shared_rank(rsum, j);
        s0 += r[urow];
        s1 += r[kTB + urow];
        s2 += r[2 * kTB + urow];
      }
      scale = fold_moments(mom, m_new, s0, s1, s2, 0.f);
    }
    if (part == 0) rscale[urow] = scale;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = rscale[cl_row(rg, i)];
#pragma unroll
      for (int j = 0; j < kA; ++j) acc[i][j] *= f;
    }
    payload_group<kW>(a, cluster, L, reinterpret_cast<float*>(region), acc, rank, n_valid,
                      tile0, rank * kW);
    cluster.sync();  // no block reads this group's tiles any more
  }
  if (rank == 0 && part == 0) {
    float* p = a.partials + (long long)chunk * 4 * a.Bp + row0 + urow;
    p[0] = mom.m;
    p[a.Bp] = mom.s0;
    p[2 * a.Bp] = mom.s1;
    p[3 * a.Bp] = mom.s2;
  }
  const int k0 = rank * kW;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = a.sy + ((long long)chunk * a.Bp + row0 + cl_row(rg, i)) * a.K + k0;
#pragma unroll
    for (int q = 0; q < kW / 128; ++q) {
      const int c = q * 128 + cg * 4;
      if (k0 + c < a.K)
        *reinterpret_cast<float4*>(dst + c) =
            float4{acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]};
    }
  }
}

// Launch (row_tiles > 0) or count the clusters the card holds at once
// (row_tiles == 0, into *slots).
template <int kMode, int kW>
cudaError_t run_cluster(const MomentsArgs& a, int C, int row_tiles, int n_chunks,
                        cudaStream_t stream, int* slots) {
  auto kernel = moments_cluster_kernel<kMode, kW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         cluster_smem<kMode, kW>());
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, row_tiles > 0 ? row_tiles : 1, row_tiles > 0 ? n_chunks : 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = cluster_smem<kMode, kW>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (row_tiles == 0) return cudaOccupancyMaxActiveClusters(slots, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t cluster_by_mode(int mode, int width, const MomentsArgs& a, int C, int row_tiles,
                            int n_chunks, cudaStream_t s, int* slots) {
  switch (mode * 2 + (width == 384 ? 1 : 0)) {
    case 2: return run_cluster<kBf16x3, 128>(a, C, row_tiles, n_chunks, s, slots);
    case 3: return run_cluster<kBf16x3, 384>(a, C, row_tiles, n_chunks, s, slots);
    case 4: return run_cluster<kBf16, 128>(a, C, row_tiles, n_chunks, s, slots);
    case 5: return run_cluster<kBf16, 384>(a, C, row_tiles, n_chunks, s, slots);
    default: return cudaErrorInvalidValue;
  }
}

using PartialsFn = void (*)(const MomentsArgs);
// The tall kernel for a payload form, its shared memory size set: launch
// it (per_sm null) or count its resident blocks per SM into *per_sm.
template <int kPayload>
cudaError_t run_tall(const MomentsArgs& a, int n_chunks, cudaStream_t stream, int* per_sm) {
  using G = MomentsGram<kPayload>;
  auto kernel = moments_tall_kernel<kPayload>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tall_smem<kPayload>());
  if (err != cudaSuccess) return err;
  if (per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads,
                                                         tall_smem<kPayload>());
  TallMaps maps{};
  if (!tile_map(&maps.q0, a.x_hi, a.D, a.Bp, a.Bp, G::kTK, kTBT) ||
      !tile_map(&maps.y, a.y_hi, a.D, a.Np, a.Np, G::kTK, kTN) ||
      (kPayload == kVec4 && !tile_map(&maps.v, a.values, a.n_true, a.K, a.K, kTKP, kTKV)))
    return cudaErrorInvalidValue;
  kernel<<<dim3(a.Bp / kTBT, n_chunks), kThreads, tall_smem<kPayload>(), stream>>>(a, maps);
  return cudaGetLastError();
}

cudaError_t tall_by_payload(int payload, const MomentsArgs& a, int n_chunks, cudaStream_t s,
                            int* per_sm) {
  switch (payload) {
    case kNone: return run_tall<kNone>(a, n_chunks, s, per_sm);
    case kVec4: return run_tall<kVec4>(a, n_chunks, s, per_sm);
    case kScalar: return run_tall<kScalar>(a, n_chunks, s, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

struct Kernel {
  PartialsFn fn;
  int smem;
};

template <int kMode, int kPayload>
Kernel kernel_of() {
  return Kernel{moments_partials_kernel<kMode, kPayload>, smem_bytes<kMode, kPayload>()};
}

// The tiled kernel for (mode 1 or 2, payload), its shared memory size set.
cudaError_t select_kernel(int mode, int payload, Kernel* k) {
  switch (mode * 3 + payload) {
    case 3: *k = kernel_of<kBf16x3, kNone>(); break;
    case 4: *k = kernel_of<kBf16x3, kVec4>(); break;
    case 5: *k = kernel_of<kBf16x3, kScalar>(); break;
    case 6: *k = kernel_of<kBf16, kNone>(); break;
    case 7: *k = kernel_of<kBf16, kVec4>(); break;
    case 8: *k = kernel_of<kBf16, kScalar>(); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
}

}  // namespace

// Resident blocks per SM of the tiled kernel for (mode 1 or 2, payload).
extern "C" int pdm_boltzmann_moments_blocks_per_sm(int mode, int payload, int* out) {
  Kernel k;
  cudaError_t err = select_kernel(mode, payload, &k);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k.fn, kThreads, k.smem);
  return static_cast<int>(err);
}

// The tiled launch. Queries (D, Bp) with Bp a multiple of 64, the dataset
// (D, Np) with Np a multiple of 128, bf16 hi (and lo for mode 1; mode 0,
// fp32, runs the tall kernel). payload 0: values and sy null; 1: K % 4 == 0
// and values 16-byte aligned; 2: any K. Returns cudaGetLastError().
extern "C" int pdm_boltzmann_moments_partials(
    const void* x_hi, const void* x_lo, const void* y_hi, const void* y_lo, const void* ysq,
    const void* xsq, const void* invt, const void* scale, const void* values, void* partials,
    void* sy, int Bp, int D, int Np, int n_true, int K, int n_chunks, int per_chunk, int mode,
    int payload, void* stream) {
  const bool with_values = payload != kNone;
  if (Bp % kTB != 0 || Np % kTN != 0 || D <= 0 || n_true <= 0 || n_true > Np ||
      n_true <= Np - kTN || n_chunks <= 0 || per_chunk <= 0 ||
      (long long)n_chunks * per_chunk < Np / kTN || with_values != (values != nullptr) ||
      with_values != (sy != nullptr) || (with_values && K <= 0) ||
      (payload == kVec4 && (K % 4 != 0 || reinterpret_cast<uintptr_t>(values) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel k;
  const cudaError_t err = select_kernel(mode, payload, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  const MomentsArgs a{x_hi, x_lo, y_hi, y_lo,
                      static_cast<const float*>(ysq), static_cast<const float*>(xsq),
                      static_cast<const float*>(invt), static_cast<const float*>(scale),
                      static_cast<const float*>(values), static_cast<float*>(partials),
                      static_cast<float*>(sy), Bp, D, Np, n_true, K, per_chunk};
  k.fn<<<dim3(Bp / kTB, n_chunks), kThreads, k.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The merge launch: partials (n_chunks, 4, Bp) and sy (n_chunks, Bp, K) or
// null -> out (4, B) planes log_z, shift, e1_hat, e2_hat, and mean (B, K).
extern "C" int pdm_boltzmann_moments_merge(const void* partials, const void* sy, void* out,
                                           void* mean, int B, int Bp, int n_chunks, int K,
                                           void* stream) {
  if (B <= 0 || B > Bp || n_chunks <= 0 || (sy != nullptr) != (mean != nullptr) ||
      (sy != nullptr && K <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  moments_merge_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<const float*>(sy),
      static_cast<float*>(out), static_cast<float*>(mean), B, Bp, n_chunks, K);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the tall kernel for mode 0 (fp32) and a payload form.
extern "C" int pdm_boltzmann_moments_tall_blocks_per_sm(int mode, int payload, int* out) {
  if (mode != kFp32) return static_cast<int>(cudaErrorInvalidValue);
  const MomentsArgs a{};
  return static_cast<int>(tall_by_payload(payload, a, 0, nullptr, out));
}

// The tall launch: arguments as pdm_boltzmann_moments_partials with Bp a
// multiple of 128 and mode 0 (fp32: no lo parts); per_chunk in 128-column
// sub-tiles.
extern "C" int pdm_boltzmann_moments_tall(
    const void* x_hi, const void* x_lo, const void* y_hi, const void* y_lo, const void* ysq,
    const void* xsq, const void* invt, const void* scale, const void* values, void* partials,
    void* sy, int Bp, int D, int Np, int n_true, int K, int n_chunks, int per_chunk, int mode,
    int payload, void* stream) {
  const bool with_values = payload != kNone;
  if (mode != kFp32 || x_lo != nullptr || y_lo != nullptr || Bp % kTBT != 0 ||
      Np % kTN != 0 || D <= 0 || n_true <= 0 || n_true > Np || n_true <= Np - kTN ||
      n_chunks <= 0 || per_chunk <= 0 || (long long)n_chunks * per_chunk < Np / kTN ||
      with_values != (values != nullptr) || with_values != (sy != nullptr) ||
      (with_values && K <= 0) ||
      (payload == kVec4 && (K % 4 != 0 || reinterpret_cast<uintptr_t>(values) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const MomentsArgs a{x_hi, nullptr, y_hi, nullptr,
                      static_cast<const float*>(ysq), static_cast<const float*>(xsq),
                      static_cast<const float*>(invt), static_cast<const float*>(scale),
                      static_cast<const float*>(values), static_cast<float*>(partials),
                      static_cast<float*>(sy), Bp, D, Np, n_true, K, per_chunk};
  return static_cast<int>(
      tall_by_payload(payload, a, n_chunks, static_cast<cudaStream_t>(stream), nullptr));
}

// Clusters of the cluster kernel the card holds at once, for (mode 1 or 2,
// width, cluster size).
extern "C" int pdm_boltzmann_moments_cluster_slots(int mode, int width, int cluster, int* out) {
  const MomentsArgs a{};
  return static_cast<int>(cluster_by_mode(mode, width, a, cluster, 0, 0, nullptr, out));
}

// The cluster launch (bf16 modes): grid (cluster, Bp / 64, n_chunks),
// per_chunk in 256-column tiles; a payload of K % 4 == 0 columns (values
// 16-byte aligned), width 128 or 384 payload columns a block, with cluster
// blocks covering K and none to spare. Other arguments as
// pdm_boltzmann_moments_partials.
extern "C" int pdm_boltzmann_moments_cluster(
    const void* x_hi, const void* x_lo, const void* y_hi, const void* y_lo, const void* ysq,
    const void* xsq, const void* invt, const void* scale, const void* values, void* partials,
    void* sy, int Bp, int D, int Np, int n_true, int K, int n_chunks, int per_chunk, int mode,
    int width, int cluster, void* stream) {
  if (Bp % kTB != 0 || Np % kTN != 0 || D <= 0 || n_true <= 0 || n_true > Np ||
      n_true <= Np - kTN || n_chunks <= 0 || per_chunk <= 0 ||
      (long long)n_chunks * per_chunk * kTW < Np || cluster < 1 || cluster > 8 ||
      (mode != kBf16x3 && mode != kBf16) || (width != 128 && width != 384) ||
      values == nullptr || sy == nullptr || K <= 0 || K % 4 != 0 ||
      reinterpret_cast<uintptr_t>(values) % 16 != 0 || cluster * width < K ||
      (cluster - 1) * width >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  const MomentsArgs a{x_hi, x_lo, y_hi, y_lo,
                      static_cast<const float*>(ysq), static_cast<const float*>(xsq),
                      static_cast<const float*>(invt), static_cast<const float*>(scale),
                      static_cast<const float*>(values), static_cast<float*>(partials),
                      static_cast<float*>(sy), Bp, D, Np, n_true, K, per_chunk};
  return static_cast<int>(cluster_by_mode(mode, width, a, cluster, Bp / kTB, n_chunks,
                                          static_cast<cudaStream_t>(stream), nullptr));
}
