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

// ---------------------------------------------------------------------
// Row 3s: GroupNorm of an image whose rows are split across ranks (the
// spatial layout of parallel/model_parallel.py). No TPU kernel of its own:
// JAX's GSPMD partitions the TPU kernel's statistics into per-device sums
// and a psum over the model axis. Two launches with an fp32 all-reduce of
// the (B, G, 2) sums between them (ops/groupnorm.py::split_group_norm_act):
//
//   pdm_group_norm_stats: per (image, group), sum x and sum x^2 over the
//     rank's rows, in row 3's order: the same plan (cluster of kr blocks
//     over the rows, kc channel slices), channel sums over the P lanes in
//     lane order, the fold into groups, the cluster's blocks added in rank
//     order. The plan streams (no tile in shared memory: x is read once).
//     At one rank its sums are row 3's.
//   pdm_group_norm_apply: mean = s / n, var = max(q / n - mean^2, 0),
//     inv = 1 / sqrt(var + eps) of the all-reduced sums (n: the group's
//     elements over all ranks), then y = (x - mean) * (inv * gamma) + beta
//     and the SiLU, rounded once to x's dtype: row 3's arithmetic.
//
// What bounds them: bytes. The statistics read x once; the apply reads x
// and writes y, each block first turning the sums into each channel's
// mean, inv * gamma and beta in shared memory. Against row 3, the split
// reads x twice (row 3 holds it in shared memory between its passes).

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ sums, const GnPlan p,
                        int S, int C, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.z;
  const int cpg = C / groups, gb = p.cb / cpg;
  const int row0 = blockIdx.x * p.rows;
  const int c0 = blockIdx.y * p.cb;
  const Geom geo{p.lanes_v, p.lanes_p, p.cb / VEC, p.cb, max(0, min(p.rows, S - row0))};
  const T* src = x + ((long long)b * S + row0) * C + c0;
  const Layout L = layout(smem, p, gb, 1);

  channel_sums<VEC>(geo, L.red, L.chan, [&](int cv, int lane, float(&a)[VEC], float(&q)[VEC]) {
#pragma unroll 4
    for (int r = lane; r < geo.nrows; r += geo.P) {
      const Vec<T, VEC> v = load<T, VEC, false>(nullptr, src, p.cb, C, r, cv);
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
  if (blockIdx.x == 0) {
    for (int g = threadIdx.x; g < gb; g += blockDim.x) {
      float s = 0.f, q = 0.f;
#pragma unroll 8
      for (int k = 0; k < p.kr; ++k) {
        const float* pk = peer(cluster, L.gpart, k, p.kr);
        s += pk[g];
        q += pk[gb + g];
      }
      float* o = sums + ((long long)b * groups + c0 / cpg + g) * 2;
      o[0] = s;
      o[1] = q;
    }
  }
  cluster_sync(cluster, p.kr);  // block 0 has read every peer's sums
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float* __restrict__ sums,
                        T* __restrict__ out, int S, int C, int groups, int rows, float n,
                        float eps) {
  extern __shared__ __align__(16) float chan[];  // mean, inv * gamma, beta of each channel
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, S - r0);
  const int cpg = C / groups;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* s = sums + ((long long)b * groups + c / cpg) * 2;
    const float mean = s[0] / n;
    const float var = fmaxf(s[1] / n - mean * mean, 0.f);
    chan[c] = mean;
    chan[C + c] = (1.f / sqrtf(var + eps)) * gamma[c];
    chan[2 * C + c] = beta[c];
  }
  __syncthreads();
  const int vpr = C / VEC;
  const long long base = ((long long)b * S + r0) * C;
  for (int e = threadIdx.x; e < nr * vpr; e += blockDim.x) {
    const int r = e / vpr, cv = e - r * vpr;
    const long long off = base + (long long)r * C + cv * VEC;
    const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(x + off);
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = cv * VEC + k;
      float y = (pdm::to_float(v.v[k]) - chan[c]) * chan[C + c] + chan[2 * C + c];
      if constexpr (SILU) y *= sigmoid(y);
      o.v[k] = pdm::from_float<T>(y);
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + off) = o;
  }
}

// a plain launch of an apply kernel: grid (row blocks, B), 256 threads
template <typename... KArgs, typename... Args>
cudaError_t launch_apply(void (*kernel)(KArgs...), int S, int rows, int B, int smem,
                         cudaStream_t stream, Args... args) {
  if (rows < 1 || smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((S + rows - 1) / rows, B), kMaxThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stats_dtype(const void* x, float* sums, const GnPlan& p, int B, int S, int C,
                        int groups, cudaStream_t s) {
  auto* xt = static_cast<const T*>(x);
  switch (p.vec) {
    case 1: return launch(group_norm_stats_kernel<T, 1>, p, B, s, xt, sums, p, S, C, groups);
    case 2: return launch(group_norm_stats_kernel<T, 2>, p, B, s, xt, sums, p, S, C, groups);
    case 4: return launch(group_norm_stats_kernel<T, 4>, p, B, s, xt, sums, p, S, C, groups);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int VEC>
cudaError_t apply_vec(const void* x, const float* gamma, const float* beta, const float* sums,
                      void* out, int B, int S, int C, int groups, int rows, float n, float eps,
                      int silu, cudaStream_t s) {
  auto* xt = static_cast<const T*>(x);
  auto* ot = static_cast<T*>(out);
  const int smem = 3 * C * (int)sizeof(float);
  if (silu)
    return launch_apply(group_norm_apply_kernel<T, VEC, true>, S, rows, B, smem, s, xt, gamma,
                        beta, sums, ot, S, C, groups, rows, n, eps);
  return launch_apply(group_norm_apply_kernel<T, VEC, false>, S, rows, B, smem, s, xt, gamma,
                      beta, sums, ot, S, C, groups, rows, n, eps);
}

template <typename T>
cudaError_t apply_dtype(const void* x, const float* gamma, const float* beta, const float* sums,
                        void* out, int B, int S, int C, int groups, int rows, int vec, float n,
                        float eps, int silu, cudaStream_t s) {
  switch (vec) {
    case 1: return apply_vec<T, 1>(x, gamma, beta, sums, out, B, S, C, groups, rows, n, eps, silu, s);
    case 2: return apply_vec<T, 2>(x, gamma, beta, sums, out, B, S, C, groups, rows, n, eps, silu, s);
    case 4: return apply_vec<T, 4>(x, gamma, beta, sums, out, B, S, C, groups, rows, n, eps, silu, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: contiguous (B, S, C) of dtype `dtype`; sums: contiguous (B, groups, 2)
// fp32, written whole (sum x, sum x^2 of each group over the S rows);
// plan: ops/groupnorm.py::plan_split_stats (row 3's plan, streaming).
extern "C" int pdm_group_norm_stats(const void* x, void* sums, const pdm_gn::GnPlan* plan, int B,
                                    int S, int C, int groups, int dtype, void* stream) {
  const int esz = dtype == pdm::kFloat32 ? 4 : 2;
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) || plan->hold != 0 ||
      !pdm_gn::plan_ok(*plan, B, S, C, groups, 1, esz))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(sums);
  const cudaError_t err = dtype == pdm::kFloat32
                              ? stats_dtype<float>(x, o, *plan, B, S, C, groups, s)
                              : stats_dtype<__nv_bfloat16>(x, o, *plan, B, S, C, groups, s);
  return static_cast<int>(err);
}

// x, out: contiguous (B, S, C) of dtype `dtype`, aligned to vec elements;
// gamma, beta: (C,) fp32; sums: (B, groups, 2) fp32, summed over every
// rank's rows; n: the elements of a group over all ranks (rows * C /
// groups); rows: rows a block; vec: 1, 2 or 4 dividing C. silu: 0 or 1.
extern "C" int pdm_group_norm_apply(const void* x, const void* gamma, const void* beta,
                                    const void* sums, void* out, int B, int S, int C, int groups,
                                    int rows, int vec, float n, float eps, int silu, int dtype,
                                    void* stream) {
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) || B <= 0 || S <= 0 ||
      groups <= 0 || C % groups || C % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* bt = static_cast<const float*>(beta);
  auto* sm = static_cast<const float*>(sums);
  const cudaError_t err =
      dtype == pdm::kFloat32
          ? apply_dtype<float>(x, g, bt, sm, out, B, S, C, groups, rows, vec, n, eps, silu, s)
          : apply_dtype<__nv_bfloat16>(x, g, bt, sm, out, B, S, C, groups, rows, vec, n, eps,
                                       silu, s);
  return static_cast<int>(err);
}
