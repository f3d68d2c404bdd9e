// Fused multi-temperature Boltzmann sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/boltzmann_sweep.py::_sweep_kernel
// (launched by _sweep_pallas). For queries x0, eps (B, D), a dataset y
// (N, D) and temperatures T_t, every temperature's posterior over the
// dataset has the logits
//   l_ij(T) = -C0_ij / T - D0_ij / sqrt(T) - esq_i,
//   C0 = 0.5|x0|^2 - x0.y + 0.5|y|^2,  D0 = x0.eps - eps.y,  esq = 0.5|eps|^2,
// so two Grams serve all temperatures; the kernel returns, per (T, row),
// log_z, the shift (max logit), the shift-stabilized moments e1_hat and
// e2_hat of g = -l, and optionally the posterior mean of an (N, 1) payload.
//
// What bounds it on the H100: the Grams' operations, 4 B N D per pass. At
// CIFAR-10 scale (B = 1024, N = 50,000, D = 3072) that is 6.29e11 flops:
// 9.39 ms in fp32 on the CUDA cores (67 TFLOP/s), 0.64 ms per bf16 pass on
// the tensor cores; the per-temperature epilogue adds ~13 operations per
// (row, point, T). The inputs are read once in the bound (D (B + N) words).
//
// Design. The TPU kernel walks the dataset axis sequentially on one core,
// carrying the accumulators of every temperature in VMEM. Here the dataset
// is split across blocks instead: block (i, c) owns query tile i (64 rows)
// and dataset chunk c (a run of 128-column sub-tiles), so B = 1024 gives
// 16 x ~16 blocks for 132 SMs, one wave. For each sub-tile the block
// computes both Grams (boltzmann_common.cuh: fp32 FFMA, never TF32, or bf16
// mma.sync in one or three passes), turns them into C0 and D0 in shared
// memory, and then each thread takes (row, temperature) pairs and updates
// their accumulators with the online-softmax step (update_moments). The
// accumulators live in the block's own slice of a global partials buffer
// (n_chunks, n_q, NT, Bp), since 5 x 64 x NT floats do not fit in shared
// memory for NT up to ~200; no other block touches the slice. A second
// launch joins the chunks' partials per (T, row) with the exact
// shift-stabilized merge and writes the finished moments. Padded query
// rows compute harmless values that are never read; padded dataset
// columns are left out of the epilogue's loop (ncols).

#include <math.h>
#include <stdint.h>

#include "boltzmann_common.cuh"

namespace {

using namespace pdm_boltz;

enum Mode : int { kFp32 = 0, kBf16x3 = 1, kBf16 = 2 };

constexpr int kES = kTN + 1;  // shared row stride of C0 / D0 (odd: no bank conflicts)
constexpr int kSmemEpi = 2 * kTB * kES * 4;

template <int kMode>
__host__ __device__ constexpr int smem_bytes() {
  const int gram = kMode == kFp32 ? smem_gram32<true>() : smem_gram16<kMode == kBf16x3, true>();
  return gram > kSmemEpi ? gram : kSmemEpi;
}

struct SweepArgs {
  const void* x_hi;  // (D, Bp) fp32 or bf16: x0 transposed, zero-padded rows
  const void* x_lo;  // bf16_3x only
  const void* e_hi;  // (D, Bp): eps
  const void* e_lo;
  const void* y_hi;  // (D, Np): the dataset
  const void* y_lo;
  const float* ysq;     // (Np,) 0.5|y|^2
  const float* xsq;     // (Bp,) 0.5|x0|^2
  const float* xe;      // (Bp,) x0.eps
  const float* esq;     // (Bp,) 0.5|eps|^2
  const float* values;  // (Np,) payload, zero-padded, or null
  const float* invt;    // (NT,) 1/T
  const float* irt;     // (NT,) 1/sqrt(T)
  float* partials;      // (n_chunks, n_q, NT, Bp)
  int Bp, D, Np, n_true, NT, per_chunk, n_q;
};

template <int kMode>
__device__ __forceinline__ const void* offset(const void* p, long long elems) {
  if (p == nullptr) return nullptr;
  if constexpr (kMode == kFp32) return static_cast<const float*>(p) + elems;
  return static_cast<const __nv_bfloat16*>(p) + elems;
}

// C0 and D0 of the block's rows against dataset columns [col0, col0 + kTN)
// into shared memory (row stride kES).
template <int kMode>
__device__ __forceinline__ void tile_energies(const SweepArgs& a, int row0, int col0,
                                              unsigned char* smem, float* cs, float* ds) {
  GramOperands op{offset<kMode>(a.x_hi, row0), offset<kMode>(a.x_lo, row0),
                  offset<kMode>(a.e_hi, row0), offset<kMode>(a.e_lo, row0),
                  offset<kMode>(a.y_hi, col0), offset<kMode>(a.y_lo, col0),
                  a.D, a.Bp, a.Np};
  if constexpr (kMode == kFp32) {
    float ax[4][8], ae[4][8];
    gram_fp32<true>(ax, ae, op, reinterpret_cast<float*>(smem));
    int r0, c0;
    fp32_patch(r0, c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      const float xsq = a.xsq[row0 + r], xe = a.xe[row0 + r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = fp32_col(c0, j);
        cs[r * kES + c] = (xsq - ax[i][j]) + a.ysq[col0 + c];
        ds[r * kES + c] = xe - ae[i][j];
      }
    }
  } else {
    float ax[8][4], ae[8][4];
    gram_bf16<kMode == kBf16x3, true>(ax, ae, op, reinterpret_cast<__nv_bfloat16*>(smem));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (warp & 3) * 16 + g + 8 * (e >> 1);
        const int c = (warp >> 2) * 64 + 8 * n + 2 * tq + (e & 1);
        cs[r * kES + c] = (a.xsq[row0 + r] - ax[n][e]) + a.ysq[col0 + c];
        ds[r * kES + c] = a.xe[row0 + r] - ae[n][e];
      }
  }
  __syncthreads();
}

template <int kMode, bool kWithValues>
__global__ void __launch_bounds__(kThreads, 2) sweep_partials_kernel(const SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // C0 / D0 reuse the Gram's ring, which is free once the Gram is done
  float* cs = reinterpret_cast<float*>(smem);
  float* ds = cs + kTB * kES;
  const int row0 = blockIdx.x * kTB;
  const int chunk = blockIdx.y;
  const int n_sub = a.Np / kTN;
  const int sub0 = chunk * a.per_chunk;
  const int sub1 = min(sub0 + a.per_chunk, n_sub);
  const long long q_stride = (long long)a.NT * a.Bp;
  float* part = a.partials + (long long)chunk * a.n_q * q_stride;

  for (int sub = sub0; sub < sub1; ++sub) {
    const int col0 = sub * kTN;
    tile_energies<kMode>(a, row0, col0, smem, cs, ds);
    const int ncols = min(kTN, a.n_true - col0);
    const float* v = kWithValues ? a.values + col0 : nullptr;
    // a warp takes 32 consecutive rows at one temperature: conflict-free
    // shared reads (odd stride) and coalesced accumulator traffic
    for (int p = threadIdx.x; p < kTB * a.NT; p += kThreads) {
      const int r = p % kTB, t = p / kTB;
      float* acc = part + (long long)t * a.Bp + row0 + r;
      Moments m = empty_moments();
      if (sub != sub0) {
        m.m = acc[0];
        m.s0 = acc[q_stride];
        m.s1 = acc[2 * q_stride];
        m.s2 = acc[3 * q_stride];
        if (kWithValues) m.sy = acc[4 * q_stride];
      }
      update_moments<kWithValues>(m, cs + r * kES, ds + r * kES, v, ncols, a.invt[t],
                                  a.irt[t], a.esq[row0 + r]);
      acc[0] = m.m;
      acc[q_stride] = m.s0;
      acc[2 * q_stride] = m.s1;
      acc[3 * q_stride] = m.s2;
      if (kWithValues) acc[4 * q_stride] = m.sy;
    }
    __syncthreads();  // C0 / D0 are read before the next Gram reuses the ring
  }
}

// One thread per (T, row < B): join the chunks' partials, finalize.
__global__ void sweep_merge_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                   int B, int Bp, int NT, int n_chunks, int n_q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NT * B) return;
  const int t = i / B, b = i - t * B;
  const long long q_stride = (long long)NT * Bp;
  Moments acc = empty_moments();
  for (int c = 0; c < n_chunks; ++c) {
    const float* p = partials + (long long)c * n_q * q_stride + (long long)t * Bp + b;
    Moments m{p[0], p[q_stride], p[2 * q_stride], p[3 * q_stride],
              n_q > 4 ? p[4 * q_stride] : 0.f};
    merge_into(acc, m);
  }
  const long long plane = (long long)NT * B;
  out[i] = acc.m + logf(acc.s0);
  out[plane + i] = acc.m;
  out[2 * plane + i] = acc.s1 / acc.s0;
  out[3 * plane + i] = acc.s2 / acc.s0;
  if (n_q > 4) out[4 * plane + i] = acc.sy / acc.s0;
}

template <int kMode, bool kWithValues>
cudaError_t prepare() {
  return cudaFuncSetAttribute(sweep_partials_kernel<kMode, kWithValues>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<kMode>());
}

template <int kMode, bool kWithValues>
cudaError_t launch(const SweepArgs& a, int n_chunks, cudaStream_t stream) {
  const cudaError_t err = prepare<kMode, kWithValues>();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Bp / kTB, n_chunks);
  sweep_partials_kernel<kMode, kWithValues>
      <<<grid, kThreads, smem_bytes<kMode>(), stream>>>(a);
  return cudaGetLastError();
}

template <int kMode, bool kWithValues>
cudaError_t blocks_per_sm(int* out) {
  cudaError_t err = prepare<kMode, kWithValues>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, sweep_partials_kernel<kMode, kWithValues>, kThreads, smem_bytes<kMode>());
}

template <bool kWithValues>
cudaError_t by_mode(int mode, const SweepArgs& a, int n_chunks, cudaStream_t s) {
  switch (mode) {
    case kFp32: return launch<kFp32, kWithValues>(a, n_chunks, s);
    case kBf16x3: return launch<kBf16x3, kWithValues>(a, n_chunks, s);
    case kBf16: return launch<kBf16, kWithValues>(a, n_chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Resident blocks per SM of the partials kernel for (mode, with_values).
extern "C" int pdm_boltzmann_sweep_blocks_per_sm(int mode, int with_values, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (mode * 2 + (with_values ? 1 : 0)) {
    case 0: err = blocks_per_sm<kFp32, false>(out); break;
    case 1: err = blocks_per_sm<kFp32, true>(out); break;
    case 2: err = blocks_per_sm<kBf16x3, false>(out); break;
    case 3: err = blocks_per_sm<kBf16x3, true>(out); break;
    case 4: err = blocks_per_sm<kBf16, false>(out); break;
    case 5: err = blocks_per_sm<kBf16, true>(out); break;
  }
  return static_cast<int>(err);
}

// The partials launch. Query operands (D, Bp) with Bp a multiple of 64, the
// dataset (D, Np) with Np a multiple of 128; fp32 for mode 0, bf16 hi (and
// lo for mode 1) otherwise. values null for no payload. Returns
// cudaGetLastError().
extern "C" int pdm_boltzmann_sweep_partials(
    const void* x_hi, const void* x_lo, const void* e_hi, const void* e_lo,
    const void* y_hi, const void* y_lo, const void* ysq, const void* xsq,
    const void* xe, const void* esq, const void* values, const void* invt,
    const void* irt, void* partials, int Bp, int D, int Np, int n_true, int NT,
    int n_chunks, int per_chunk, int mode, void* stream) {
  if (Bp % kTB != 0 || Np % kTN != 0 || D <= 0 || NT <= 0 || n_true <= 0 ||
      n_true > Np || n_chunks <= 0 || per_chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SweepArgs a{x_hi, x_lo, e_hi, e_lo, y_hi, y_lo,
              static_cast<const float*>(ysq), static_cast<const float*>(xsq),
              static_cast<const float*>(xe), static_cast<const float*>(esq),
              static_cast<const float*>(values), static_cast<const float*>(invt),
              static_cast<const float*>(irt), static_cast<float*>(partials),
              Bp, D, Np, n_true, NT, per_chunk, values ? 5 : 4};
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = values ? by_mode<true>(mode, a, n_chunks, s)
                                 : by_mode<false>(mode, a, n_chunks, s);
  return static_cast<int>(err);
}

// The merge launch: partials (n_chunks, n_q, NT, Bp) -> out (n_q, NT, B)
// planes log_z, shift, e1_hat, e2_hat (and the payload mean when n_q = 5).
extern "C" int pdm_boltzmann_sweep_merge(const void* partials, void* out, int B, int Bp,
                                         int NT, int n_chunks, int n_q, void* stream) {
  if (B <= 0 || B > Bp || NT <= 0 || n_chunks <= 0 || (n_q != 4 && n_q != 5))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = NT * B;
  const int threads = 256;
  sweep_merge_kernel<<<(n + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), B, Bp, NT, n_chunks, n_q);
  return static_cast<int>(cudaGetLastError());
}
