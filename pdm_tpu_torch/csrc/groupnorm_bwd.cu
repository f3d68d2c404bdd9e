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
