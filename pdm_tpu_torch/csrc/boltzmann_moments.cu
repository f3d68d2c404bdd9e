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
// passes, boltzmann_common.cuh's engines in their one-operand form).
//
// Design. As the sweep (boltzmann_sweep.cu), block (i, c) owns query tile
// i (64 rows) and dataset chunk c (a run of 128-column sub-tiles); a
// second launch joins the chunks. For each sub-tile the block computes the
// Gram, turns it into logits in shared memory (column-major, so a row's
// columns are a conflict-free stride), and updates each row's online-
// softmax accumulators with four threads per row that combine their partial
// max and sums by shuffles. The accumulators stay in registers across the
// chunk. The payload's (64 x K) accumulator does not: the TPU kernel keeps
// it in VMEM, but at K = 3072 it is 768 KB against the SM's 227 KB of
// shared memory. So the block turns the logit tile into p = exp(l - m) in
// place and runs a second tiled product, p (64 x 128) . V (128 x K), one
// 128-column K-tile at a time (fp32 FFMA, V streamed through a cp.async
// ring), and adds it into its own (64 x K) slice of a global partials
// buffer (n_chunks, Bp, K), rescaling the old sums by the row's
// exp(m_old - m_new) in the same read-modify-write. That traffic (2 x 64 x
// K x 4 bytes per row tile and sub-tile, ~10 GB per call at the scale
// above) is the price of this first design. The merge launch joins the
// chunks exactly: mean = sum_c exp(m_c - m_g) sy_c / s0_g. The payload is
// read row-major (N, K), the contraction-major layout the product needs: for
// the denoiser it is the caller's own fp32 data, so nothing is copied.
// Padded query rows compute harmless values that are never read; columns
// past N are left out of the update and get p = 0.

#include <math.h>
#include <stdint.h>

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

template <int kMode>
__host__ __device__ constexpr int smem_gram() {
  return kMode == kFp32 ? smem_gram32<false>() : smem_gram16<kMode == kBf16x3, false>();
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

template <int kMode>
__device__ __forceinline__ const void* offset(const void* p, long long elems) {
  if (p == nullptr) return nullptr;
  if constexpr (kMode == kFp32) return static_cast<const float*>(p) + elems;
  return static_cast<const __nv_bfloat16*>(p) + elems;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// -h / T, the TPU kernel's expansion of the energy
__device__ __forceinline__ float logit(float xsq, float s, float invt, float gram, float ysq) {
  return -((xsq - s * gram) + (s * s) * ysq) * invt;
}

// The logits of the block's rows against dataset columns [col0, col0 + kTN)
// into L[column * kLS + row].
template <int kMode>
__device__ __forceinline__ void tile_logits(const MomentsArgs& a, int row0, int col0,
                                            unsigned char* smem, float* L) {
  const GramOperands op{offset<kMode>(a.x_hi, row0), offset<kMode>(a.x_lo, row0), nullptr,
                        nullptr, offset<kMode>(a.y_hi, col0), offset<kMode>(a.y_lo, col0),
                        a.D, a.Bp, a.Np};
  if constexpr (kMode == kFp32) {
    float ax[4][8], unused[4][8];
    gram_fp32<false>(ax, unused, op, reinterpret_cast<float*>(smem));
    int r0, c0;
    fp32_patch(r0, c0);
    float xsq[4], s[4], invt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + r0 + i;
      xsq[i] = a.xsq[r];
      s[i] = a.scale[r];
      invt[i] = a.invt[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = fp32_col(c0, j);
      const float ysq = a.ysq[col0 + c];
      const float4 l{logit(xsq[0], s[0], invt[0], ax[0][j], ysq),
                     logit(xsq[1], s[1], invt[1], ax[1][j], ysq),
                     logit(xsq[2], s[2], invt[2], ax[2][j], ysq),
                     logit(xsq[3], s[3], invt[3], ax[3][j], ysq)};
      *reinterpret_cast<float4*>(L + c * kLS + r0) = l;
    }
  } else {
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

using PartialsFn = void (*)(const MomentsArgs);
struct Kernel {
  PartialsFn fn;
  int smem;
};

template <int kMode, int kPayload>
Kernel kernel_of() {
  return Kernel{moments_partials_kernel<kMode, kPayload>, smem_bytes<kMode, kPayload>()};
}

// The partials kernel for (mode, payload), its shared memory size set.
cudaError_t select_kernel(int mode, int payload, Kernel* k) {
  switch (mode * 3 + payload) {
    case 0: *k = kernel_of<kFp32, kNone>(); break;
    case 1: *k = kernel_of<kFp32, kVec4>(); break;
    case 2: *k = kernel_of<kFp32, kScalar>(); break;
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

// Resident blocks per SM of the partials kernel for (mode, payload).
extern "C" int pdm_boltzmann_moments_blocks_per_sm(int mode, int payload, int* out) {
  Kernel k;
  cudaError_t err = select_kernel(mode, payload, &k);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k.fn, kThreads, k.smem);
  return static_cast<int>(err);
}

// The partials launch. Queries (D, Bp) with Bp a multiple of 64, the dataset
// (D, Np) with Np a multiple of 128; fp32 for mode 0, bf16 hi (and lo for
// mode 1) otherwise. payload 0: values and sy null; 1: K % 4 == 0 and values
// 16-byte aligned; 2: any K. Returns cudaGetLastError().
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
