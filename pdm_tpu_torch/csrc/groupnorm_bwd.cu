// GroupNorm with an optional fused SiLU, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/groupnorm.py::_bwd_kernel (launched
// by _fgn_bwd). Same function over x (B, S, C), groups of cpg = C / groups
// channels, and the cotangent dy of the forward's output: statistics are
// recomputed from x in fp32 as the forward does (var = max(E[x^2] -
// E[x]^2, 0)), n = (x - mean) * inv with inv = rsqrt(var + eps), then
//   dz = dy                                   (no activation)
//   dz = dy * s * (1 + z * (1 - s)), z = n * gamma + beta, s = sigmoid(z)
//   dgamma_part[b, c] = sum_s dz * n,  dbeta_part[b, c] = sum_s dz
//   dn = dz * gamma
//   dx = inv * (dn - mean_g(dn) - n * mean_g(dn * n))
// in fp32, dx written in x's dtype. The per-image partials are summed over
// B outside the kernel, as the JAX code does. The group means come from
// the channel totals (mean_g(dn) = sum_c gamma_c dbeta_c / n, and
// mean_g(dn * n) = sum_c gamma_c dgamma_c / n), the same sums in another
// order.
//
// What bounds it on the H100: bytes. The flagship's largest call (B=128,
// S=1024, C=384, bf16) must read x and dy and write dx, 302 MB, about
// 90 us at 3.35 TB/s; the arithmetic is ~25 operations per element, an
// exponential and a reciprocal among them with the SiLU.
//
// Design (groupnorm_common.cuh), as the forward: the kr blocks of a
// cluster split an image's rows (kc clusters its channels, in whole
// groups); each block copies its share of x and dy into shared memory once
// and runs three passes over it: the statistics of x (group sums, added
// across the cluster in rank order through distributed shared memory);
// the channel partials of dgamma and dbeta (added across the cluster in
// rank order; the first block writes the image's partials), each thread
// writing dn = dz gamma over the dy it read, so the SiLU's VJP runs once;
// dx. Any number of channels a group: group sums are folded from channel
// sums. Where the share does not fit in shared memory the plan streams
// (hold = 0) and each pass re-reads whole rows (dx recomputes dz). One
// launch a call, no atomics, so a call is bitwise repeatable.

#include <math.h>
#include <stdint.h>

#include "groupnorm_common.cuh"

namespace {

using namespace pdm_gn;

__device__ __forceinline__ float silu_vjp(float dy, float z) {
  const float s = sigmoid(z);
  return dy * (s * (1.f + z * (1.f - s)));
}

template <typename T, int VEC, bool HOLD, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      T* __restrict__ dx, float* __restrict__ dgamma_part,
                      float* __restrict__ dbeta_part, const GnPlan p, int S, int C,
                      int groups, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.z;
  const int cpg = C / groups, gb = p.cb / cpg;
  const int row0 = blockIdx.x * p.rows;
  const int c0 = blockIdx.y * p.cb;
  const Geom geo{p.lanes_v, p.lanes_p, p.cb / VEC, p.cb, max(0, min(p.rows, S - row0))};
  const long long base = ((long long)b * S + row0) * C + c0;
  const T* xs = x + base;
  const T* ds = dy + base;
  const Layout L = layout(smem, p, gb, 2);
  const float n = (float)S * (float)cpg;
  // the tile: x, then an fp32 slot an element: dy (in x's dtype, at the
  // slot's start), then dn = dz * gamma, written over it by the thread
  // that read it
  constexpr int F = 4 / sizeof(T);
  const T* xt = reinterpret_cast<const T*>(L.tile);
  float* dn_t = reinterpret_cast<float*>(L.tile + x_tile_bytes(p, sizeof(T)));
  const T* dy_t = reinterpret_cast<const T*>(dn_t);
  issue_params(L.par, gamma + c0, beta + c0, p.cb);
  if constexpr (HOLD) {
    issue_tile<T, VEC, 1>(reinterpret_cast<T*>(L.tile), xs, geo, C);
    issue_tile<T, VEC, F>(reinterpret_cast<T*>(dn_t), ds, geo, C);
  }
  cp_async_wait_all();
  __syncthreads();

  // the thread's channels: mean, inv, gamma and beta
  auto params = [&](int cv, float(&mean)[VEC], float(&inv)[VEC], float(&gam)[VEC],
                    float(&bet)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = cv * VEC + k, g = ch / cpg;
      mean[k] = L.gstat[g];
      inv[k] = L.gstat[gb + g];
      gam[k] = L.par[ch];
      bet[k] = L.par[p.cb + ch];
    }
  };
  // dz of one vector from x and dy
  auto dz_of = [&](const Vec<T, VEC>& vx, const Vec<T, VEC>& vd, const float(&mean)[VEC],
                   const float(&inv)[VEC], const float(&gam)[VEC], const float(&bet)[VEC],
                   float(&nh)[VEC], float(&dz)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      nh[k] = (pdm::to_float(vx.v[k]) - mean[k]) * inv[k];
      dz[k] = pdm::to_float(vd.v[k]);
      if constexpr (SILU) dz[k] = silu_vjp(dz[k], nh[k] * gam[k] + bet[k]);
    }
  };

  // pass 1: statistics of x, as the forward
  channel_sums<VEC>(geo, L.red, L.chan, [&](int cv, int lane, float(&a)[VEC], float(&q)[VEC]) {
#pragma unroll 4
    for (int r = lane; r < geo.nrows; r += geo.P) {
      const Vec<T, VEC> v = load<T, VEC, HOLD>(xt, xs, p.cb, C, r, cv);
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
  group_stats(cluster, L.gpart, L.gstat, gb, n, eps);
  __syncthreads();

  // pass 2: channel partials of dgamma (sum dz * n) and dbeta (sum dz);
  // with the tile on chip, dn = dz * gamma replaces dy in its slot
  channel_sums<VEC>(geo, L.red, L.chan, [&](int cv, int lane, float(&dg)[VEC], float(&db)[VEC]) {
    float mean[VEC], inv[VEC], gam[VEC], bet[VEC];
    params(cv, mean, inv, gam, bet);
#pragma unroll 4
    for (int r = lane; r < geo.nrows; r += geo.P) {
      const int e = r * p.cb + cv * VEC;
      const Vec<T, VEC> vx = load<T, VEC, HOLD>(xt, xs, p.cb, C, r, cv);
      const Vec<T, VEC> vd = HOLD ? *reinterpret_cast<const Vec<T, VEC>*>(dy_t + e * F)
                                  : load<T, VEC, false>(nullptr, ds, p.cb, C, r, cv);
      float nh[VEC], dz[VEC];
      dz_of(vx, vd, mean, inv, gam, bet, nh, dz);
      Vec<float, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        dg[k] = fmaf(dz[k], nh[k], dg[k]);
        db[k] += dz[k];
        o.v[k] = dz[k] * gam[k];
      }
      if constexpr (HOLD) *reinterpret_cast<Vec<float, VEC>*>(dn_t + e) = o;
    }
  });
  cluster_sync(cluster, p.kr);  // every block's channel partials are in
  // the image's channel totals, over the cluster in rank order
  for (int ch = threadIdx.x; ch < p.cb; ch += blockDim.x) {
    float dg = 0.f, db = 0.f;
#pragma unroll 8
    for (int k = 0; k < p.kr; ++k) {
      const float* pk = peer(cluster, L.chan, k, p.kr);
      dg += pk[ch];
      db += pk[p.cb + ch];
    }
    L.tot[ch] = dg;
    L.tot[p.cb + ch] = db;
    if (blockIdx.x == 0) {
      dgamma_part[(long long)b * C + c0 + ch] = dg;
      dbeta_part[(long long)b * C + c0 + ch] = db;
    }
  }
  cluster_arrive(p.kr);
  __syncthreads();
  // gm[g] = sum_c gamma_c dgamma_c, gm[gb + g] = sum_c gamma_c dbeta_c
  fold_groups<true>(L.tot, p.cb, cpg, gb, L.par, L.gm);
  __syncthreads();

  // pass 3: dx = inv * (dn - mean_g(dn) - n * mean_g(dn * n)), dn from
  // its slot (or recomputed from dy when the plan streams)
  const int t = threadIdx.x;
  if (t < geo.V * geo.P) {
    const int lane = t / geo.V;
    for (int cv = t % geo.V; cv < geo.vpr; cv += geo.V) {
      float mean[VEC], inv[VEC], gam[VEC], bet[VEC], m1[VEC], m2[VEC];
      params(cv, mean, inv, gam, bet);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int g = (cv * VEC + k) / cpg;
        m1[k] = L.gm[gb + g] / n;  // mean_g(dn)
        m2[k] = L.gm[g] / n;       // mean_g(dn * n)
      }
#pragma unroll 4
      for (int r = lane; r < geo.nrows; r += geo.P) {
        const Vec<T, VEC> vx = load<T, VEC, HOLD>(xt, xs, p.cb, C, r, cv);
        float nh[VEC], dn[VEC];
        if constexpr (HOLD) {
          const Vec<float, VEC> vn =
              *reinterpret_cast<const Vec<float, VEC>*>(dn_t + r * p.cb + cv * VEC);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            nh[k] = (pdm::to_float(vx.v[k]) - mean[k]) * inv[k];
            dn[k] = vn.v[k];
          }
        } else {
          float dz[VEC];
          dz_of(vx, load<T, VEC, false>(nullptr, ds, p.cb, C, r, cv), mean, inv, gam, bet,
                nh, dz);
#pragma unroll
          for (int k = 0; k < VEC; ++k) dn[k] = dz[k] * gam[k];
        }
        Vec<T, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          o.v[k] = pdm::from_float<T>(inv[k] * (dn[k] - m1[k] - nh[k] * m2[k]));
        *reinterpret_cast<Vec<T, VEC>*>(dx + base + r * (long long)C + cv * VEC) = o;
      }
    }
  }
  cluster_wait(p.kr);  // no peer reads this block's channel partials any more
}

template <typename T, int VEC, bool HOLD>
cudaError_t launch_hold(const T* x, const T* dy, const float* gamma, const float* beta, T* dx,
                        float* dg, float* db, const GnPlan& p, int B, int S, int C, int groups,
                        float eps, int silu, cudaStream_t stream) {
  if (silu)
    return launch(group_norm_bwd_kernel<T, VEC, HOLD, true>, p, B, stream, x, dy, gamma, beta,
                  dx, dg, db, p, S, C, groups, eps);
  return launch(group_norm_bwd_kernel<T, VEC, HOLD, false>, p, B, stream, x, dy, gamma, beta, dx,
                dg, db, p, S, C, groups, eps);
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* x, const void* dy, const float* gamma, const float* beta,
                       void* dx, float* dg, float* db, const GnPlan& p, int B, int S, int C,
                       int groups, float eps, int silu, cudaStream_t stream) {
  auto* xt = static_cast<const T*>(x);
  auto* dt = static_cast<const T*>(dy);
  auto* ot = static_cast<T*>(dx);
  if (p.hold)
    return launch_hold<T, VEC, true>(xt, dt, gamma, beta, ot, dg, db, p, B, S, C, groups, eps,
                                     silu, stream);
  return launch_hold<T, VEC, false>(xt, dt, gamma, beta, ot, dg, db, p, B, S, C, groups, eps,
                                    silu, stream);
}

template <typename T>
cudaError_t launch_dtype(const void* x, const void* dy, const float* gamma, const float* beta,
                         void* dx, float* dg, float* db, const GnPlan& p, int B, int S, int C,
                         int groups, float eps, int silu, cudaStream_t s) {
  switch (p.vec) {
    case 1: return launch_vec<T, 1>(x, dy, gamma, beta, dx, dg, db, p, B, S, C, groups, eps, silu, s);
    case 2: return launch_vec<T, 2>(x, dy, gamma, beta, dx, dg, db, p, B, S, C, groups, eps, silu, s);
    case 4: return launch_vec<T, 4>(x, dy, gamma, beta, dx, dg, db, p, B, S, C, groups, eps, silu, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy, dx: contiguous (B, S, C) of dtype `dtype`, aligned to the plan's
// vectors; gamma, beta: (C,) fp32; dgamma_part, dbeta_part:
// contiguous (B, C) fp32, written whole; plan: from
// ops/groupnorm.py::plan_group_norm. Any C % groups == 0. silu: 0 or 1.
// Returns cudaErrorInvalidValue for a plan the kernel cannot run, else
// cudaGetLastError().
extern "C" int pdm_group_norm_bwd(const void* x, const void* dy, const void* gamma,
                                  const void* beta, void* dx, void* dgamma_part,
                                  void* dbeta_part, const pdm_gn::GnPlan* plan, int B, int S,
                                  int C, int groups, float eps, int silu, int dtype,
                                  void* stream) {
  const int esz = dtype == pdm::kFloat32 ? 4 : 2;
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) ||
      !pdm_gn::plan_ok(*plan, B, S, C, groups, 2, esz))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* bt = static_cast<const float*>(beta);
  auto* dg = static_cast<float*>(dgamma_part);
  auto* db = static_cast<float*>(dbeta_part);
  const cudaError_t err =
      dtype == pdm::kFloat32
          ? launch_dtype<float>(x, dy, g, bt, dx, dg, db, *plan, B, S, C, groups, eps, silu, s)
          : launch_dtype<__nv_bfloat16>(x, dy, g, bt, dx, dg, db, *plan, B, S, C, groups, eps,
                                        silu, s);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------
// Row 4s: the backward of row 3s, for an image whose rows are split across
// ranks. No TPU kernel of its own (GSPMD partitions the TPU backward's sums
// and psums them). Two launches with an fp32 all-reduce of the (B, G, 2)
// group sums between them (ops/groupnorm.py::split_group_norm_act):
//
//   pdm_group_norm_bwd_stats: from x, dy and the forward's all-reduced
//     sums (mean and inv recomputed as row 3s's apply does), per channel
//     and image the partial dgamma = sum dz * n_hat and dbeta = sum dz over
//     the rank's rows (row 4's pass 2: the same plan, streaming), and per
//     (image, group) sum dn and sum dn * n_hat (dn = dz * gamma), folded
//     from the channel totals as row 4 folds them.
//   pdm_group_norm_bwd_apply: dx = inv * (dn - sum dn / n - n_hat *
//     sum dn n_hat / n) from the all-reduced group sums: row 4's pass 3,
//     with dz recomputed from x and dy.
//
// What bounds them: bytes. The statistics read x and dy; the apply reads
// them again and writes dx (row 4 holds x and dn in shared memory).

namespace {

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            const float* __restrict__ sums, float* __restrict__ gsums,
                            float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
                            const GnPlan p, int S, int C, int groups, float n, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.z;
  const int cpg = C / groups, gb = p.cb / cpg;
  const int row0 = blockIdx.x * p.rows;
  const int c0 = blockIdx.y * p.cb;
  const Geom geo{p.lanes_v, p.lanes_p, p.cb / VEC, p.cb, max(0, min(p.rows, S - row0))};
  const long long base = ((long long)b * S + row0) * C + c0;
  const T* xs = x + base;
  const T* ds = dy + base;
  const Layout L = layout(smem, p, gb, 2);
  issue_params(L.par, gamma + c0, beta + c0, p.cb);
  for (int g = threadIdx.x; g < gb; g += blockDim.x) {
    const float* s = sums + ((long long)b * groups + c0 / cpg + g) * 2;
    const float mean = s[0] / n;
    const float var = fmaxf(s[1] / n - mean * mean, 0.f);
    L.gstat[g] = mean;
    L.gstat[gb + g] = 1.f / sqrtf(var + eps);
  }
  cp_async_wait_all();
  __syncthreads();

  channel_sums<VEC>(geo, L.red, L.chan, [&](int cv, int lane, float(&dg)[VEC], float(&db)[VEC]) {
    float mean[VEC], inv[VEC], gam[VEC], bet[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = cv * VEC + k, g = ch / cpg;
      mean[k] = L.gstat[g];
      inv[k] = L.gstat[gb + g];
      gam[k] = L.par[ch];
      bet[k] = L.par[p.cb + ch];
    }
#pragma unroll 4
    for (int r = lane; r < geo.nrows; r += geo.P) {
      const Vec<T, VEC> vx = load<T, VEC, false>(nullptr, xs, p.cb, C, r, cv);
      const Vec<T, VEC> vd = load<T, VEC, false>(nullptr, ds, p.cb, C, r, cv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float nh = (pdm::to_float(vx.v[k]) - mean[k]) * inv[k];
        float dz = pdm::to_float(vd.v[k]);
        if constexpr (SILU) dz = silu_vjp(dz, nh * gam[k] + bet[k]);
        dg[k] = fmaf(dz, nh, dg[k]);
        db[k] += dz;
      }
    }
  });
  cluster_sync(cluster, p.kr);  // every block's channel partials are in
  if (blockIdx.x == 0) {
    // the image's channel totals over the cluster in rank order, then
    // gm[g] = sum_c gamma_c dgamma_c = sum dn n_hat, gm[gb + g] = sum dn
    for (int ch = threadIdx.x; ch < p.cb; ch += blockDim.x) {
      float dg = 0.f, db = 0.f;
#pragma unroll 8
      for (int k = 0; k < p.kr; ++k) {
        const float* pk = peer(cluster, L.chan, k, p.kr);
        dg += pk[ch];
        db += pk[p.cb + ch];
      }
      L.tot[ch] = dg;
      L.tot[p.cb + ch] = db;
      dgamma_part[(long long)b * C + c0 + ch] = dg;
      dbeta_part[(long long)b * C + c0 + ch] = db;
    }
    __syncthreads();
    fold_groups<true>(L.tot, p.cb, cpg, gb, L.par, L.gm);
    __syncthreads();
    for (int g = threadIdx.x; g < gb; g += blockDim.x) {
      float* o = gsums + ((long long)b * groups + c0 / cpg + g) * 2;
      o[0] = L.gm[gb + g];
      o[1] = L.gm[g];
    }
  }
  cluster_sync(cluster, p.kr);  // block 0 has read every peer's partials
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            const float* __restrict__ sums, const float* __restrict__ gsums,
                            T* __restrict__ dx, int S, int C, int groups, int rows, float n,
                            float eps) {
  // mean, inv, gamma, beta, mean_g(dn), mean_g(dn n_hat) of each channel
  extern __shared__ __align__(16) float chan[];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, S - r0);
  const int cpg = C / groups;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long g2 = ((long long)b * groups + c / cpg) * 2;
    const float mean = sums[g2] / n;
    const float var = fmaxf(sums[g2 + 1] / n - mean * mean, 0.f);
    chan[c] = mean;
    chan[C + c] = 1.f / sqrtf(var + eps);
    chan[2 * C + c] = gamma[c];
    chan[3 * C + c] = beta[c];
    chan[4 * C + c] = gsums[g2] / n;
    chan[5 * C + c] = gsums[g2 + 1] / n;
  }
  __syncthreads();
  const int vpr = C / VEC;
  const long long base = ((long long)b * S + r0) * C;
  for (int e = threadIdx.x; e < nr * vpr; e += blockDim.x) {
    const int r = e / vpr, cv = e - r * vpr;
    const long long off = base + (long long)r * C + cv * VEC;
    const Vec<T, VEC> vx = *reinterpret_cast<const Vec<T, VEC>*>(x + off);
    const Vec<T, VEC> vd = *reinterpret_cast<const Vec<T, VEC>*>(dy + off);
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = cv * VEC + k;
      const float inv = chan[C + c], gam = chan[2 * C + c];
      const float nh = (pdm::to_float(vx.v[k]) - chan[c]) * inv;
      float dz = pdm::to_float(vd.v[k]);
      if constexpr (SILU) dz = silu_vjp(dz, nh * gam + chan[3 * C + c]);
      const float dn = dz * gam;
      o.v[k] = pdm::from_float<T>(inv * (dn - chan[4 * C + c] - nh * chan[5 * C + c]));
    }
    *reinterpret_cast<Vec<T, VEC>*>(dx + off) = o;
  }
}

template <typename T, bool SILU>
cudaError_t bwd_stats_silu(const void* x, const void* dy, const float* gamma, const float* beta,
                           const float* sums, float* gsums, float* dg, float* db,
                           const GnPlan& p, int B, int S, int C, int groups, float n, float eps,
                           cudaStream_t s) {
  auto* xt = static_cast<const T*>(x);
  auto* dt = static_cast<const T*>(dy);
  switch (p.vec) {
    case 1: return launch(group_norm_bwd_stats_kernel<T, 1, SILU>, p, B, s, xt, dt, gamma, beta,
                          sums, gsums, dg, db, p, S, C, groups, n, eps);
    case 2: return launch(group_norm_bwd_stats_kernel<T, 2, SILU>, p, B, s, xt, dt, gamma, beta,
                          sums, gsums, dg, db, p, S, C, groups, n, eps);
    case 4: return launch(group_norm_bwd_stats_kernel<T, 4, SILU>, p, B, s, xt, dt, gamma, beta,
                          sums, gsums, dg, db, p, S, C, groups, n, eps);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int VEC, bool SILU>
cudaError_t bwd_apply_vec(const void* x, const void* dy, const float* gamma, const float* beta,
                          const float* sums, const float* gsums, void* dx, int B, int S, int C,
                          int groups, int rows, float n, float eps, cudaStream_t s) {
  auto* kernel = group_norm_bwd_apply_kernel<T, VEC, SILU>;
  const int smem = 6 * C * (int)sizeof(float);
  if (rows < 1 || smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((S + rows - 1) / rows, B), kMaxThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta, sums, gsums,
      static_cast<T*>(dx), S, C, groups, rows, n, eps);
  return cudaGetLastError();
}

template <typename T, bool SILU>
cudaError_t bwd_apply_silu(const void* x, const void* dy, const float* gamma, const float* beta,
                           const float* sums, const float* gsums, void* dx, int B, int S, int C,
                           int groups, int rows, int vec, float n, float eps, cudaStream_t s) {
  switch (vec) {
    case 1: return bwd_apply_vec<T, 1, SILU>(x, dy, gamma, beta, sums, gsums, dx, B, S, C,
                                             groups, rows, n, eps, s);
    case 2: return bwd_apply_vec<T, 2, SILU>(x, dy, gamma, beta, sums, gsums, dx, B, S, C,
                                             groups, rows, n, eps, s);
    case 4: return bwd_apply_vec<T, 4, SILU>(x, dy, gamma, beta, sums, gsums, dx, B, S, C,
                                             groups, rows, n, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy: contiguous (B, S, C) of dtype `dtype`; gamma, beta: (C,) fp32;
// sums: the forward's all-reduced (B, groups, 2) fp32; gsums: (B, groups,
// 2) fp32, written whole (sum dn, sum dn * n_hat over the S rows);
// dgamma_part, dbeta_part: (B, C) fp32, written whole; plan:
// ops/groupnorm.py::plan_split_stats(backward=True) (row 4's, streaming);
// n: a group's elements over all ranks. silu: 0 or 1.
extern "C" int pdm_group_norm_bwd_stats(const void* x, const void* dy, const void* gamma,
                                        const void* beta, const void* sums, void* gsums,
                                        void* dgamma_part, void* dbeta_part,
                                        const pdm_gn::GnPlan* plan, int B, int S, int C,
                                        int groups, float n, float eps, int silu, int dtype,
                                        void* stream) {
  const int esz = dtype == pdm::kFloat32 ? 4 : 2;
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) || plan->hold != 0 ||
      !pdm_gn::plan_ok(*plan, B, S, C, groups, 2, esz))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* bt = static_cast<const float*>(beta);
  auto* sm = static_cast<const float*>(sums);
  auto* gs = static_cast<float*>(gsums);
  auto* dg = static_cast<float*>(dgamma_part);
  auto* db = static_cast<float*>(dbeta_part);
  cudaError_t err;
  if (dtype == pdm::kFloat32)
    err = silu ? bwd_stats_silu<float, true>(x, dy, g, bt, sm, gs, dg, db, *plan, B, S, C,
                                             groups, n, eps, s)
               : bwd_stats_silu<float, false>(x, dy, g, bt, sm, gs, dg, db, *plan, B, S, C,
                                              groups, n, eps, s);
  else
    err = silu ? bwd_stats_silu<__nv_bfloat16, true>(x, dy, g, bt, sm, gs, dg, db, *plan, B, S,
                                                     C, groups, n, eps, s)
               : bwd_stats_silu<__nv_bfloat16, false>(x, dy, g, bt, sm, gs, dg, db, *plan, B,
                                                      S, C, groups, n, eps, s);
  return static_cast<int>(err);
}

// x, dy, dx: contiguous (B, S, C) of dtype `dtype`, aligned to vec
// elements; sums, gsums: the all-reduced (B, groups, 2) fp32 of the
// forward and of pdm_group_norm_bwd_stats; rows: rows a block; vec: 1, 2
// or 4 dividing C; n: a group's elements over all ranks. silu: 0 or 1.
extern "C" int pdm_group_norm_bwd_apply(const void* x, const void* dy, const void* gamma,
                                        const void* beta, const void* sums, const void* gsums,
                                        void* dx, int B, int S, int C, int groups, int rows,
                                        int vec, float n, float eps, int silu, int dtype,
                                        void* stream) {
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) || B <= 0 || S <= 0 ||
      groups <= 0 || C % groups || C % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* bt = static_cast<const float*>(beta);
  auto* sm = static_cast<const float*>(sums);
  auto* gs = static_cast<const float*>(gsums);
  cudaError_t err;
  if (dtype == pdm::kFloat32)
    err = silu ? bwd_apply_silu<float, true>(x, dy, g, bt, sm, gs, dx, B, S, C, groups, rows,
                                             vec, n, eps, s)
               : bwd_apply_silu<float, false>(x, dy, g, bt, sm, gs, dx, B, S, C, groups, rows,
                                              vec, n, eps, s);
  else
    err = silu ? bwd_apply_silu<__nv_bfloat16, true>(x, dy, g, bt, sm, gs, dx, B, S, C, groups,
                                                     rows, vec, n, eps, s)
               : bwd_apply_silu<__nv_bfloat16, false>(x, dy, g, bt, sm, gs, dx, B, S, C,
                                                      groups, rows, vec, n, eps, s);
  return static_cast<int>(err);
}
