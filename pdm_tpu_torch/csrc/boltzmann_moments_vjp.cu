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
//
// What bounds it on the H100: operations. Two Grams, x.y and c.y (2 B N D
// each), and the product w.Y (2 B N D): at B = 256, N = 50,000, D = 3072,
// 236 GFLOP, 3.5 ms at fp32's 67 TFLOP/s on the CUDA cores, against
// ~0.7 GB of inputs (0.2 ms). The product is fp32 in every mode, the
// Grams in the forward's mode.
//
// Design. Block (i, c) owns a query tile i and a chunk c of the dataset
// (a run of 128-column sub-tiles); p comes from the forward's saved
// log_z, so there is no running max and the chunks' sums simply add. Per
// sub-tile the block computes both Grams with the forward's engine, so
// the logits are the forward's own, bit for bit, and p is normalized
// against the log_z they gave: fp32 on the tall FFMA engine (TallGram,
// 128 rows, 512 threads with a 4 x 8 patch of each Gram, x, c and the
// dataset's pack through one TMA ring), the bf16 modes on the mma.sync
// tiles (gram_bf16 with two query operands, 64 rows, 256 threads). From
// the Grams in registers each thread makes its w, adds its rows' W, A and
// S terms in registers for the whole chunk, and stores w into a shared
// tile; then w (rows x 128) times the sub-tile's 128 dataset rows (the
// fp32 row-major dataset, one 128-column K-tile at a time through a
// cp.async ring) is added into the chunk's slice of a partials buffer
// (n_chunks, Bp, D), read-modify-write, as row 7's payload sums. A
// second kernel adds the chunks in order and finishes the gradients. No
// atomics: every sum has a fixed order, so two calls agree bitwise.

#include <math.h>
#include <stdint.h>

#include "boltzmann_common.cuh"

namespace {

using namespace pdm_boltz;

enum Mode : int { kFp32 = 0, kBf16x3 = 1, kBf16 = 2 };

constexpr int kTBT = 128;        // query rows of a tall tile (fp32)
constexpr int kLST = kTBT + 16;  // shared stride of its w tile w[column][row]
constexpr int kLS = kTB + 8;     // ... of a 64-row tile's
constexpr int kTKV = 128;        // dataset columns of a K-tile of the product
constexpr int kTNV = 16;         // dataset points per stage of the product's ring
constexpr int kSmemRingY = kStages * kTNV * kTKV * 4;

// fp32: two query operands (x and c), 4 x 8 patches of each, 32-row
// stages 4 deep (the sweep's configuration)
using VjpGram = TallGram<4, 8, 2, 32, 4>;
constexpr int kTallThreads = VjpGram::kThreads;

// The w tile, then the product's ring, overlay the Gram's ring (each is
// free while the other runs); then per row the W, A, S partials of the two
// halves of the block that share it (2, 3, rows) and the row's five terms
// (5, rows); then (fp32) the ring's mbarriers.
template <int kLd>
__host__ __device__ constexpr int smem_main() {
  return kTN * kLd * 4 + kSmemRingY;
}
template <int kRows>
__host__ __device__ constexpr int smem_rows() {
  return (2 * 3 + 5) * kRows * 4;
}
constexpr int kTallRegion =
    VjpGram::kSmem > smem_main<kLST>() ? VjpGram::kSmem : smem_main<kLST>();
constexpr int kTallSmem = kTallRegion + smem_rows<kTBT>() + VjpGram::Ring::kBarBytes;

template <int kMode>
__host__ __device__ constexpr int tiled_region() {
  return smem_gram16<kMode == kBf16x3, true>() > smem_main<kLS>()
             ? smem_gram16<kMode == kBf16x3, true>()
             : smem_main<kLS>();
}
template <int kMode>
__host__ __device__ constexpr int tiled_smem() {
  return tiled_region<kMode>() + smem_rows<kTB>();
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
  const float* y;     // (n_true, D) the dataset, row-major fp32
  float* partials;    // (n_chunks, 3, Bp): W, A, S
  float* sy;          // (n_chunks, Bp, D): sum_j w_ij y_j
  int Bp, D, Np, n_true, per_chunk;
};

__device__ __forceinline__ const void* offset(const void* p, long long elems) {
  return p == nullptr ? nullptr : static_cast<const __nv_bfloat16*>(p) + elems;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// A thread's running sums of one query row over the chunk: sum w,
// sum w (log_z - l), sum w (2 s ysq - x.y).
struct RowSums {
  float w, a, sy;
};

// The block's rows' terms into rt (5, kRows): 0.5|x|^2, invt, s, log_z,
// c.mean (shared memory: registers are the Grams').
template <int kRows>
__device__ __forceinline__ void load_rows(const VjpArgs& a, float* rt, int row0) {
  for (int i = threadIdx.x; i < 5 * kRows; i += blockDim.x) {
    const int k = i / kRows, r = i - k * kRows;
    rt[i] = a.rows[(long long)k * a.Bp + row0 + r];
  }
  __syncthreads();
}

// w of row r against one column from its Grams g = x.y and u = c.y; adds
// the row's terms (0 and nothing added for a column past N).
template <int kRows>
__device__ __forceinline__ float weight(RowSums& t, const float* rt, int r, float g, float u,
                                        float ysq, bool live) {
  if (!live) return 0.f;
  const float s = rt[2 * kRows + r];
  // -log p; __fsub_rn keeps the logit's last product out of an FMA, so l
  // is rounded as the forward rounded it
  const float gz = __fsub_rn(rt[3 * kRows + r], logit(rt[r], s, rt[kRows + r], g, ysq));
  const float w = expf(-gz) * (u - rt[4 * kRows + r]);
  t.w += w;
  t.a = fmaf(w, gz, t.a);
  t.sy = fmaf(w, (2.f * s) * ysq - g, t.sy);
  return w;
}

// sy[chunk][row0 + r][:] (+)= w . Y[col0, col0 + kTN) for the kRows x kTN
// tile w in L[column * kLd + row] (written once on the chunk's first
// sub-tile, then read, added to and written back), one 128-column K-tile
// of Y at a time through a cp.async ring of kTNV points a stage; each of
// the kRows * 4 threads a 4 x 8 patch: rows 4 (tid >> 4) + i, columns
// 4 (tid & 15) + e and 64 + 4 (tid & 15) + e.
template <int kRows, int kLd, bool kVec4>
__device__ __forceinline__ void wy_product(const VjpArgs& a, const float* L, float* ring, int row0,
                                           int col0, int chunk, bool first) {
  constexpr int kT = kRows * 4;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 4;
  float* slice = a.sy + ((long long)chunk * a.Bp + row0) * a.D;
  for (int k0 = 0; k0 < a.D; k0 += kTKV) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    auto load = [&](int stage, int nt) {
      float* vs = ring + stage * kTNV * kTKV;
      const int n0 = col0 + nt * kTNV;
      if constexpr (kVec4) {
#pragma unroll
        for (int i = 0; i < kTNV * kTKV / 4 / kT; ++i) {  // kTNV points x 32 float4
          const int idx = tid + i * kT;
          const int n = idx >> 5, c4 = (idx & 31) * 4;
          const bool ok = n0 + n < a.n_true && k0 + c4 < a.D;
          const float* src = ok ? a.y + (long long)(n0 + n) * a.D + k0 + c4 : a.y;
          cp_async16(vs + n * kTKV + c4, src, ok);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kTNV * kTKV / kT; ++i) {  // kTNV points x 128 floats
          const int idx = tid + i * kT;
          const int n = idx >> 7, c = idx & (kTKV - 1);
          const bool ok = n0 + n < a.n_true && k0 + c < a.D;
          const float* src = ok ? a.y + (long long)(n0 + n) * a.D + k0 + c : a.y;
          cp_async4(vs + n * kTKV + c, src, ok);
        }
      }
    };
    int step = 0;  // contraction step of the next compute (they run in order)
    auto compute = [&](int stage) {
      const float* vs = ring + stage * kTNV * kTKV;
      const float* ws = L + step * kTNV * kLd;
#pragma unroll
      for (int kk = 0; kk < kTNV; ++kk) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + kk * kLd + r0);
        const float4 v0 = *reinterpret_cast<const float4*>(vs + kk * kTKV + c0);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + kk * kTKV + c0 + 64);
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
        const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wr[i], vr[j], acc[i][j]);
      }
      ++step;
    };
    pipeline<kTNV>(kTN, load, compute);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* dst = slice + (long long)(r0 + i) * a.D + k0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + 64 * h;
        if constexpr (kVec4) {
          if (k0 + col >= a.D) continue;
          float4 v{acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
          if (!first) {
            const float4 old = *reinterpret_cast<const float4*>(dst + col);
            v = float4{old.x + v.x, old.y + v.y, old.z + v.z, old.w + v.w};
          }
          *reinterpret_cast<float4*>(dst + col) = v;
        } else {  // rows of D % 4 != 0 floats are not 16-byte aligned
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + col + e < a.D)
              dst[col + e] = first ? acc[i][4 * h + e] : dst[col + e] + acc[i][4 * h + e];
        }
      }
    }
  }
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

// fp32: block (i, c) owns rows [128 i, 128 i + 128) and chunk c; per
// sub-tile both Grams on VjpGram (x, c and the dataset's pack through the
// TMA ring of `maps`), w into L[column * kLST + row], then the product.
template <bool kVec4>
__global__ void __launch_bounds__(kTallThreads, 1)
    vjp_tall_kernel(const VjpArgs a, const __grid_constant__ TallMaps maps) {
  using G = VjpGram;
  extern __shared__ __align__(128) unsigned char smem[];
  float* L = reinterpret_cast<float*>(smem);
  float* ring = L + kTN * kLST;
  float* red = reinterpret_cast<float*>(smem + kTallRegion);
  float* rt = red + 2 * 3 * kTBT;
  G::Ring gram_ring;
  gram_ring.init(reinterpret_cast<uint64_t*>(rt + 5 * kTBT));
  const int row0 = blockIdx.x * kTBT, chunk = blockIdx.y;
  load_rows<kTBT>(a, rt, row0);
  const int n_sub = a.Np / kTN;
  const int sub0 = chunk * a.per_chunk;
  const int sub1 = min(sub0 + a.per_chunk, n_sub);
  int rg, cg;
  G::patch(rg, cg);
  RowSums t[4] = {};
  for (int sub = sub0; sub < sub1; ++sub) {
    const int col0 = sub * kTN;
    float acc[2][4][8];
    G::run(acc, maps, row0, col0, a.D, reinterpret_cast<float*>(smem), gram_ring);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = G::col(cg, j);
      const bool live = col0 + c < a.n_true;
      const float ysq = a.ysq[col0 + c];
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = weight<kTBT>(t[i], rt, G::row(rg, i), acc[0][i][j], acc[1][i][j], ysq, live);
      *reinterpret_cast<float4*>(L + c * kLST + rg * 4) = float4{w[0], w[1], w[2], w[3]};
    }
    __syncthreads();  // the w tile is in
    wy_product<kTBT, kLST, kVec4>(a, L, ring, row0, col0, chunk, sub == sub0);
  }
  // a row's 16 threads: lanes 1, 2, 4 apart in each of two warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1) shuffle_sum(t[i], off);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    store_row_sums<kTBT>(a, red, t[i], G::row(rg, i), warp & 1, (lane & 7) == 0, row0, chunk);
    __syncthreads();  // red is read before the next row's sums
  }
}

// The bf16 modes: block (i, c) owns rows [64 i, 64 i + 64) and chunk c;
// per sub-tile both Grams on the mma.sync tiles (gram_bf16 with x and c as
// its two query operands), w into L[column * kLS + row], then the product.
template <int kMode, bool kVec4>
__global__ void __launch_bounds__(kThreads, 2) vjp_tiled_kernel(const VjpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* L = reinterpret_cast<float*>(smem);
  float* ring = L + kTN * kLS;
  float* red = reinterpret_cast<float*>(smem + tiled_region<kMode>());
  float* rt = red + 2 * 3 * kTB;
  const int row0 = blockIdx.x * kTB, chunk = blockIdx.y;
  load_rows<kTB>(a, rt, row0);
  const int n_sub = a.Np / kTN;
  const int sub0 = chunk * a.per_chunk;
  const int sub1 = min(sub0 + a.per_chunk, n_sub);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3, wr = warp & 3, wc = warp >> 2;
  RowSums t[2] = {};  // rows wr * 16 + g + 8 h
  for (int sub = sub0; sub < sub1; ++sub) {
    const int col0 = sub * kTN;
    const GramOperands op{offset(a.x_hi, row0), offset(a.x_lo, row0), offset(a.c_hi, row0),
                          offset(a.c_lo, row0), offset(a.y_hi, col0), offset(a.y_lo, col0),
                          a.D, a.Bp, a.Np};
    float ax[8][4], ac[8][4];
    gram_bf16<kMode == kBf16x3, true>(ax, ac, op, reinterpret_cast<__nv_bfloat16*>(smem));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, r = wr * 16 + g + 8 * h;
        const int c = wc * 64 + 8 * n + 2 * tq + (e & 1);
        L[c * kLS + r] =
            weight<kTB>(t[h], rt, r, ax[n][e], ac[n][e], a.ysq[col0 + c], col0 + c < a.n_true);
      }
    __syncthreads();  // the w tile is in
    wy_product<kTB, kLS, kVec4>(a, L, ring, row0, col0, chunk, sub == sub0);
  }
  // a row's 8 threads: lanes 1 and 2 apart in each of warps wr and wr + 4
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    shuffle_sum(t[h], 1);
    shuffle_sum(t[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    store_row_sums<kTB>(a, red, t[h], wr * 16 + g + 8 * h, wc, tq == 0, row0, chunk);
    __syncthreads();  // red is read before the next row's sums
  }
}

// One block per query row b < B: add the chunks' sums in order, then
// dx[b] = -invt (W x - s sum w y), dinvt = -A / invt, ds = -invt S.
__global__ void vjp_merge_kernel(const float* __restrict__ partials,
                                 const float* __restrict__ sy, const float* __restrict__ rows,
                                 const float* __restrict__ x, float* __restrict__ dx,
                                 float* __restrict__ dpar, int B, int Bp, int D, int n_chunks) {
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
    for (int c = 0; c < n_chunks; ++c) v += sy[((long long)c * Bp + b) * D + k];
    dx[(long long)b * D + k] = -invt * (w * x[(long long)b * D + k] - s * v);
  }
}

using VjpFn = void (*)(const VjpArgs);

struct Kernel {
  VjpFn fn;
  int smem;
};

// The bf16 modes' kernel for (mode, vec4), its shared memory size set.
cudaError_t select_tiled(int mode, int vec4, Kernel* k) {
  switch (mode * 2 + vec4) {
    case 2: *k = Kernel{vjp_tiled_kernel<kBf16x3, false>, tiled_smem<kBf16x3>()}; break;
    case 3: *k = Kernel{vjp_tiled_kernel<kBf16x3, true>, tiled_smem<kBf16x3>()}; break;
    case 4: *k = Kernel{vjp_tiled_kernel<kBf16, false>, tiled_smem<kBf16>()}; break;
    case 5: *k = Kernel{vjp_tiled_kernel<kBf16, true>, tiled_smem<kBf16>()}; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
}

// The fp32 kernel for vec4: launch it (per_sm null) or count its resident
// blocks per SM into *per_sm.
template <bool kVec4>
cudaError_t run_tall(const VjpArgs& a, int n_chunks, cudaStream_t stream, int* per_sm) {
  auto kernel = vjp_tall_kernel<kVec4>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTallSmem);
  if (err != cudaSuccess) return err;
  if (per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kTallThreads,
                                                         kTallSmem);
  constexpr int kTK = VjpGram::kTK;
  TallMaps maps{};
  if (!tile_map(&maps.q0, a.x_hi, a.D, a.Bp, a.Bp, kTK, kTBT) ||
      !tile_map(&maps.q1, a.c_hi, a.D, a.Bp, a.Bp, kTK, kTBT) ||
      !tile_map(&maps.y, a.y_hi, a.D, a.Np, a.Np, kTK, kTN))
    return cudaErrorInvalidValue;
  kernel<<<dim3(a.Bp / kTBT, n_chunks), kTallThreads, kTallSmem, stream>>>(a, maps);
  return cudaGetLastError();
}

cudaError_t tall_by_vec4(int vec4, const VjpArgs& a, int n_chunks, cudaStream_t s, int* per_sm) {
  return vec4 ? run_tall<true>(a, n_chunks, s, per_sm) : run_tall<false>(a, n_chunks, s, per_sm);
}

}  // namespace

// Resident blocks per SM of the VJP's partials kernel for (mode, vec4).
extern "C" int pdm_boltzmann_moments_vjp_blocks_per_sm(int mode, int vec4, int* out) {
  if (mode == kFp32) {
    const VjpArgs a{};
    return static_cast<int>(tall_by_vec4(vec4 != 0, a, 0, nullptr, out));
  }
  Kernel k;
  cudaError_t err = select_tiled(mode, vec4 != 0, &k);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k.fn, kThreads, k.smem);
  return static_cast<int>(err);
}

// The partials launch. Queries and cotangent (D, Bp), Bp a multiple of
// 128 (mode 0, fp32) or 64 (modes 1 and 2, bf16 hi and for mode 1 lo);
// the pack (D, Np), Np a multiple of 128; rows (5, Bp); y (n_true, D)
// fp32 row-major, 16-byte aligned with D % 4 == 0 when vec4; partials
// (n_chunks, 3, Bp) and sy (n_chunks, Bp, D); per_chunk in 128-column
// sub-tiles. Returns cudaGetLastError().
extern "C" int pdm_boltzmann_moments_vjp(const void* x_hi, const void* x_lo, const void* c_hi,
                                         const void* c_lo, const void* y_hi, const void* y_lo,
                                         const void* ysq, const void* rows, const void* y,
                                         void* partials, void* sy, int Bp, int D, int Np,
                                         int n_true, int n_chunks, int per_chunk, int mode,
                                         int vec4, void* stream) {
  const bool three = mode == kBf16x3;
  const int tile = mode == kFp32 ? kTBT : kTB;
  if (mode < kFp32 || mode > kBf16 || Bp % tile != 0 || Np % kTN != 0 || D <= 0 ||
      n_true <= 0 || n_true > Np || n_true <= Np - kTN || n_chunks <= 0 || per_chunk <= 0 ||
      (long long)n_chunks * per_chunk < Np / kTN || x_hi == nullptr || c_hi == nullptr ||
      y_hi == nullptr || ysq == nullptr || rows == nullptr || y == nullptr ||
      partials == nullptr || sy == nullptr || (x_lo != nullptr) != three ||
      (c_lo != nullptr) != three || (y_lo != nullptr) != three ||
      (vec4 && (D % 4 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const VjpArgs a{x_hi, x_lo, c_hi, c_lo, y_hi, y_lo,
                  static_cast<const float*>(ysq), static_cast<const float*>(rows),
                  static_cast<const float*>(y), static_cast<float*>(partials),
                  static_cast<float*>(sy), Bp, D, Np, n_true, per_chunk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kFp32) return static_cast<int>(tall_by_vec4(vec4 != 0, a, n_chunks, s, nullptr));
  Kernel k;
  const cudaError_t err = select_tiled(mode, vec4 != 0, &k);
  if (err != cudaSuccess) return static_cast<int>(err);
  k.fn<<<dim3(Bp / kTB, n_chunks), kThreads, k.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The merge launch: partials (n_chunks, 3, Bp), sy (n_chunks, Bp, D),
// rows (5, Bp) and x (B, D) fp32 -> dx (B, D), dpar (2, B): d invt, d s.
extern "C" int pdm_boltzmann_moments_vjp_merge(const void* partials, const void* sy,
                                               const void* rows, const void* x, void* dx,
                                               void* dpar, int B, int Bp, int D, int n_chunks,
                                               void* stream) {
  if (B <= 0 || B > Bp || D <= 0 || n_chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  vjp_merge_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<const float*>(sy),
      static_cast<const float*>(rows), static_cast<const float*>(x), static_cast<float*>(dx),
      static_cast<float*>(dpar), B, Bp, D, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
