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
// is split across blocks instead: block (i, c) owns query tile i and
// dataset chunk c (a run of 128-column sub-tiles). fp32 takes 128-row
// tiles (sweep_tall_kernel: both Grams on the tall fp32 engine fed by a
// TMA ring, 512 threads with 4 x 8 patches of each, one block an SM), the
// bf16 modes
// 64-row tiles (sweep_partials_kernel: mma.sync in one or three passes,
// two blocks an SM). For each sub-tile the block computes both Grams,
// turns them into C0 and D0 in shared memory, and then each thread takes
// one row and a run of 8 temperatures: it reads each column's C0 and D0
// once for all 8 and updates their accumulators with the online-softmax
// step (update_moments: the max over u = C0/T + D0/sqrt(T) first, then the
// sums, e^x on the MUFU unit). The accumulators live in the block's own
// slice of a global partials buffer (n_chunks, n_q, NT, Bp), since 5 x
// rows x NT floats do not fit in shared memory for NT up to ~200; no other
// block touches the slice. A second launch joins the chunks' partials per
// (T, row) with the exact shift-stabilized merge and writes the finished
// moments. No atomics: two calls agree bitwise. Padded query rows compute
// harmless values that are never read; padded dataset columns are left
// out of the epilogue's loop (ncols). In fp32 the epilogue runs after the
// Grams on the same warps, with nothing beside it on the SM.

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
  return smem_gram16<kMode == kBf16x3, true>() > kSmemEpi ? smem_gram16<kMode == kBf16x3, true>()
                                                          : kSmemEpi;
}

// the tall kernel (fp32): 128 rows, two query operands (x0 and eps), 512
// threads with 4 x 8 patches of each, 32-row stages 4 deep (192 KB; 16- and
// 8-row stages and 3 deep ran slower)
using SweepGram = TallGram<4, 8, 2, 32, 4>;
constexpr int kTBT = 128;
constexpr int kTallThreads = SweepGram::kThreads;
// the ring under C0 / D0, then its mbarriers
constexpr int kSmemTallTiles =
    SweepGram::kSmem > 2 * kTBT * kES * 4 ? SweepGram::kSmem : 2 * kTBT * kES * 4;
constexpr int kSmemTall = kSmemTallTiles + SweepGram::Ring::kBarBytes;

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

__device__ __forceinline__ const void* offset(const void* p, long long elems) {
  return p == nullptr ? nullptr : static_cast<const __nv_bfloat16*>(p) + elems;
}

// C0 and D0 of the block's rows against dataset columns [col0, col0 + kTN)
// into shared memory (row stride kES), through the mma.sync engine (bf16
// modes).
template <int kMode>
__device__ __forceinline__ void tile_energies(const SweepArgs& a, int row0, int col0,
                                              unsigned char* smem, float* cs, float* ds) {
  static_assert(kMode != kFp32, "fp32 runs the tall kernel");
  const GramOperands op{offset(a.x_hi, row0), offset(a.x_lo, row0), offset(a.e_hi, row0),
                        offset(a.e_lo, row0), offset(a.y_hi, col0), offset(a.y_lo, col0),
                        a.D, a.Bp, a.Np};
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
  __syncthreads();
}

// The per-temperature epilogue of one sub-tile: a thread per row and run
// of kTPT temperatures of the block's kRows rows (a warp takes 32
// consecutive rows: conflict-free shared reads at the odd row stride,
// coalesced accumulator traffic), the accumulators read from and written
// back to the block's slice of the partials buffer. The last run's
// temperatures past NT repeat the last one and are not written.
template <int kRows, int kBlock, bool kWithValues>
__device__ __forceinline__ void sweep_epilogue(const SweepArgs& a, const float* cs,
                                               const float* ds, int row0, int col0, bool first,
                                               float* part) {
  const long long q_stride = (long long)a.NT * a.Bp;
  const int ncols = min(kTN, a.n_true - col0);
  const float* v = kWithValues ? a.values + col0 : nullptr;
  const int n_runs = (a.NT + kTPT - 1) / kTPT;
  for (int w = threadIdx.x; w < kRows * n_runs; w += kBlock) {
    const int r = w % kRows, t0 = (w / kRows) * kTPT;
    Moments m[kTPT];
    float invt[kTPT], irt[kTPT];
#pragma unroll
    for (int k = 0; k < kTPT; ++k) {
      const int t = min(t0 + k, a.NT - 1);
      invt[k] = a.invt[t];
      irt[k] = a.irt[t];
      m[k] = empty_moments();
      if (!first) {
        const float* acc = part + (long long)t * a.Bp + row0 + r;
        m[k].m = acc[0];
        m[k].s0 = acc[q_stride];
        m[k].s1 = acc[2 * q_stride];
        m[k].s2 = acc[3 * q_stride];
        if (kWithValues) m[k].sy = acc[4 * q_stride];
      }
    }
    update_moments<kWithValues>(m, cs + r * kES, ds + r * kES, v, ncols, invt, irt,
                                a.esq[row0 + r]);
#pragma unroll
    for (int k = 0; k < kTPT; ++k) {
      if (t0 + k >= a.NT) break;
      float* acc = part + (long long)(t0 + k) * a.Bp + row0 + r;
      acc[0] = m[k].m;
      acc[q_stride] = m[k].s0;
      acc[2 * q_stride] = m[k].s1;
      acc[3 * q_stride] = m[k].s2;
      if (kWithValues) acc[4 * q_stride] = m[k].sy;
    }
  }
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
  float* part = a.partials + (long long)chunk * a.n_q * a.NT * a.Bp;
  for (int sub = sub0; sub < sub1; ++sub) {
    const int col0 = sub * kTN;
    tile_energies<kMode>(a, row0, col0, smem, cs, ds);
    sweep_epilogue<kTB, kThreads, kWithValues>(a, cs, ds, row0, col0, sub == sub0, part);
    __syncthreads();  // C0 / D0 are read before the next Gram reuses the ring
  }
}

// fp32: block (i, c) owns rows [128 i, 128 i + 128) and chunk c; per
// sub-tile both Grams through SweepGram (x0, eps and the dataset through
// the TMA ring of `maps`), C0 / D0 into shared memory, the epilogue.
template <bool kWithValues>
__global__ void __launch_bounds__(kTallThreads, 1)
    sweep_tall_kernel(const SweepArgs a, const __grid_constant__ TallMaps maps) {
  using G = SweepGram;
  extern __shared__ __align__(128) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  float* ds = cs + kTBT * kES;
  G::Ring ring;
  ring.init(reinterpret_cast<uint64_t*>(smem + kSmemTallTiles));
  const int row0 = blockIdx.x * kTBT;
  const int chunk = blockIdx.y;
  const int n_sub = a.Np / kTN;
  const int sub0 = chunk * a.per_chunk;
  const int sub1 = min(sub0 + a.per_chunk, n_sub);
  float* part = a.partials + (long long)chunk * a.n_q * a.NT * a.Bp;
  int rg, cg;
  G::patch(rg, cg);
  for (int sub = sub0; sub < sub1; ++sub) {
    const int col0 = sub * kTN;
    {
      float acc[2][4][8];
      G::run(acc, maps, row0, col0, a.D, reinterpret_cast<float*>(smem), ring);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = G::row(rg, i);
        const float xsq = a.xsq[row0 + r], xe = a.xe[row0 + r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = G::col(cg, j);
          cs[r * kES + c] = (xsq - acc[0][i][j]) + a.ysq[col0 + c];
          ds[r * kES + c] = xe - acc[1][i][j];
        }
      }
    }
    __syncthreads();  // C0 / D0 are in
    sweep_epilogue<kTBT, kTallThreads, kWithValues>(a, cs, ds, row0, col0, sub == sub0, part);
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
  if constexpr (kMode == kFp32)
    return cudaFuncSetAttribute(sweep_tall_kernel<kWithValues>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemTall);
  else
    return cudaFuncSetAttribute(sweep_partials_kernel<kMode, kWithValues>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes<kMode>());
}

// fp32 runs the tall kernel (128-row blocks), the bf16 modes the 64-row one
template <int kMode, bool kWithValues>
cudaError_t launch(const SweepArgs& a, int n_chunks, cudaStream_t stream) {
  const cudaError_t err = prepare<kMode, kWithValues>();
  if (err != cudaSuccess) return err;
  if constexpr (kMode == kFp32) {
    if (a.Bp % kTBT != 0) return cudaErrorInvalidValue;
    constexpr int kTK = SweepGram::kTK;
    TallMaps maps{};
    if (!tile_map(&maps.q0, a.x_hi, a.D, a.Bp, a.Bp, kTK, kTBT) ||
        !tile_map(&maps.q1, a.e_hi, a.D, a.Bp, a.Bp, kTK, kTBT) ||
        !tile_map(&maps.y, a.y_hi, a.D, a.Np, a.Np, kTK, kTN))
      return cudaErrorInvalidValue;
    sweep_tall_kernel<kWithValues>
        <<<dim3(a.Bp / kTBT, n_chunks), kTallThreads, kSmemTall, stream>>>(a, maps);
  } else {
    sweep_partials_kernel<kMode, kWithValues>
        <<<dim3(a.Bp / kTB, n_chunks), kThreads, smem_bytes<kMode>(), stream>>>(a);
  }
  return cudaGetLastError();
}

template <int kMode, bool kWithValues>
cudaError_t blocks_per_sm(int* out) {
  cudaError_t err = prepare<kMode, kWithValues>();
  if (err != cudaSuccess) return err;
  if constexpr (kMode == kFp32)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, sweep_tall_kernel<kWithValues>,
                                                         kTallThreads, kSmemTall);
  else
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

// Resident blocks per SM of the mode's partials kernel, with or without values.
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

// The partials launch. Query operands (D, Bp) with Bp a multiple of 128 in
// fp32 (mode 0) and of 64 in bf16 (hi, and lo for mode 1), the dataset
// (D, Np) with Np a multiple of 128. values null for no payload. Returns
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
