// GroupNorm with an optional fused SiLU, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/groupnorm.py::_fwd_kernel (launched
// by _fgn_call). Same function over x (B, S, C) with `groups` groups of
// cpg = C / groups channels: fp32 statistics from the sum and the sum of
// squares, var = max(E[x^2] - E[x]^2, 0), then
// y = (x - mean) * (rsqrt(var + eps) * gamma) + beta, optionally
// y * sigmoid(y), rounded once to x's dtype. gamma and beta are fp32 (C,).
//
// What bounds it on the H100: bytes. The flagship's largest call
// (B=64, S=1024, C=384, bf16) reads 50 MB and writes 50 MB, about 30 us at
// 3.35 TB/s; the arithmetic is a few operations per element.
//
// Design (groupnorm_common.cuh), the TPU kernel's idea on this card: the
// TPU kernel holds an image's (S, C) tile in VMEM, reads it once and folds
// group sums from channel sums with a membership matmul. Here an image's
// rows are split across the kr blocks of a cluster (and its channels, in
// whole groups, across kc clusters where the tile is large): each block
// copies its rows x cb share, row segments of at least two 32-byte
// sectors, into shared memory with 16-byte cp.async copies, sums each
// channel over its rows, folds them into group sums, and the cluster adds
// its blocks' group sums through distributed shared memory in rank order.
// The block then normalises its tile from shared memory and writes it
// out: x is read from device memory once. Where the share does not fit in
// shared memory the plan streams (hold = 0): the same passes re-read whole
// rows from device memory. One launch a call, no atomics.

#include <math.h>
#include <stdint.h>

#include "groupnorm_common.cuh"

namespace {

using namespace pdm_gn;

template <typename T, int VEC, bool HOLD, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ out, const GnPlan p,
                      int S, int C, int groups, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.z;
  const int cpg = C / groups, gb = p.cb / cpg;
  const int row0 = blockIdx.x * p.rows;
  const int c0 = blockIdx.y * p.cb;
  const Geom geo{p.lanes_v, p.lanes_p, p.cb / VEC, p.cb, max(0, min(p.rows, S - row0))};
  const long long base = ((long long)b * S + row0) * C + c0;
  const T* src = x + base;
  const Layout L = layout(smem, p, gb, 1);
  T* tile = reinterpret_cast<T*>(L.tile);
  issue_params(L.par, gamma + c0, beta + c0, p.cb);
  if constexpr (HOLD) issue_tile<T, VEC, 1>(tile, src, geo, C);
  cp_async_wait_all();
  __syncthreads();

  // channel sums of x and x^2 over the block's rows, then group sums
  channel_sums<VEC>(geo, L.red, L.chan, [&](int cv, int lane, float(&a)[VEC], float(&q)[VEC]) {
#pragma unroll 4
    for (int r = lane; r < geo.nrows; r += geo.P) {
      const Vec<T, VEC> v = load<T, VEC, HOLD>(tile, src, p.cb, C, r, cv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = pdm::to_float(v.v[k]);
        a[k] += f;
        q[k] = fmaf(f, f, q[k]);
      }
    }
  });
  fold_groups<false>(L.chan, p.cb, cpg, gb, nullptr, L.gpart);
  cluster_sync(cluster, p.kr);  // every block's group sums are in
  group_stats(cluster, L.gpart, L.gstat, gb, (float)S * (float)cpg, eps);
  cluster_arrive(p.kr);
  __syncthreads();

  // y = (x - mean) * (inv * gamma) + beta, then the SiLU, from the tile
  const int t = threadIdx.x;
  if (t < geo.V * geo.P) {
    const int lane = t / geo.V;
    for (int cv = t % geo.V; cv < geo.vpr; cv += geo.V) {
      float mean[VEC], mul[VEC], bet[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int ch = cv * VEC + k, g = ch / cpg;
        mean[k] = L.gstat[g];
        mul[k] = L.gstat[gb + g] * L.par[ch];
        bet[k] = L.par[p.cb + ch];
      }
#pragma unroll 4
      for (int r = lane; r < geo.nrows; r += geo.P) {
        const Vec<T, VEC> v = load<T, VEC, HOLD>(tile, src, p.cb, C, r, cv);
        Vec<T, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          float y = (pdm::to_float(v.v[k]) - mean[k]) * mul[k] + bet[k];
          if constexpr (SILU) y *= sigmoid(y);
          o.v[k] = pdm::from_float<T>(y);
        }
        *reinterpret_cast<Vec<T, VEC>*>(out + base + r * (long long)C + cv * VEC) = o;
      }
    }
  }
  cluster_wait(p.kr);  // no peer reads this block's group sums any more
}

template <typename T, int VEC, bool HOLD>
cudaError_t launch_hold(const T* x, const float* gamma, const float* beta, T* out,
                        const GnPlan& p, int B, int S, int C, int groups, float eps, int silu,
                        cudaStream_t stream) {
  if (silu)
    return launch(group_norm_fwd_kernel<T, VEC, HOLD, true>, p, B, stream, x, gamma, beta, out,
                  p, S, C, groups, eps);
  return launch(group_norm_fwd_kernel<T, VEC, HOLD, false>, p, B, stream, x, gamma, beta, out, p,
                S, C, groups, eps);
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* x, const float* gamma, const float* beta, void* out,
                       const GnPlan& p, int B, int S, int C, int groups, float eps, int silu,
                       cudaStream_t stream) {
  auto* xt = static_cast<const T*>(x);
  auto* ot = static_cast<T*>(out);
  if (p.hold)
    return launch_hold<T, VEC, true>(xt, gamma, beta, ot, p, B, S, C, groups, eps, silu, stream);
  return launch_hold<T, VEC, false>(xt, gamma, beta, ot, p, B, S, C, groups, eps, silu, stream);
}

template <typename T>
cudaError_t launch_dtype(const void* x, const float* gamma, const float* beta, void* out,
                         const GnPlan& p, int B, int S, int C, int groups, float eps, int silu,
                         cudaStream_t stream) {
  switch (p.vec) {
    case 1: return launch_vec<T, 1>(x, gamma, beta, out, p, B, S, C, groups, eps, silu, stream);
    case 2: return launch_vec<T, 2>(x, gamma, beta, out, p, B, S, C, groups, eps, silu, stream);
    case 4: return launch_vec<T, 4>(x, gamma, beta, out, p, B, S, C, groups, eps, silu, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: contiguous (B, S, C) of dtype `dtype`, aligned to the plan's
// vectors; gamma, beta: (C,) fp32; plan: from
// ops/groupnorm.py::plan_group_norm. silu: 0 or 1. Returns
// cudaErrorInvalidValue for a plan the kernel cannot run, else
// cudaGetLastError().
extern "C" int pdm_group_norm_fwd(const void* x, const void* gamma, const void* beta,
                                  void* out, const pdm_gn::GnPlan* plan, int B, int S, int C,
                                  int groups, float eps, int silu, int dtype, void* stream) {
  const int esz = dtype == pdm::kFloat32 ? 4 : 2;
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) ||
      !pdm_gn::plan_ok(*plan, B, S, C, groups, 1, esz))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* bt = static_cast<const float*>(beta);
  const cudaError_t err =
      dtype == pdm::kFloat32
          ? launch_dtype<float>(x, g, bt, out, *plan, B, S, C, groups, eps, silu, s)
          : launch_dtype<__nv_bfloat16>(x, g, bt, out, *plan, B, S, C, groups, eps, silu, s);
  return static_cast<int>(err);
}
