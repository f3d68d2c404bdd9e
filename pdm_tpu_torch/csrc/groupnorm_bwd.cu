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
// 90 us at 3.35 TB/s; the arithmetic is ~20 operations per element.
//
// Design: one block per (group, image), like the forward, in three passes
// over the group's S x cpg values (statistics; the channel partials; dx).
// The second and third reads mostly hit the 50 MB L2. Each thread owns one
// VEC-channel column vector of the group and walks rows, so it keeps its
// channels' partials in registers; the block then reduces each channel's
// column through shared memory, one warp per channel sum, in a fixed order
// (no atomics, so the result is the same on every run). It inherits the
// forward's narrow-strip access (a strip of cpg elements of rows C apart),
// which wastes most of each 32-byte sector at cpg = 4.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using pdm::Vec;

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;    // vector loads in flight per thread
constexpr int kMaxCpg = 256;  // channels per group this kernel takes

template <typename T, int VEC>
__device__ __forceinline__ void load_vecs(Vec<T, VEC> (&r)[kUnroll], const T* p,
                                          int s0, int rpi, int S, long long C) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int s = s0 + u * rpi;
    if (s < S) {
      r[u] = *reinterpret_cast<const Vec<T, VEC>*>(p + s * C);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) r[u].v[k] = pdm::from_float<T>(0.f);
    }
  }
}

__device__ __forceinline__ float silu_vjp(float dy, float z) {
  const float s = 1.f / (1.f + expf(-z));
  return dy * (s * (1.f + z * (1.f - s)));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ dx,
                      float* __restrict__ dgamma_part,
                      float* __restrict__ dbeta_part, int S, int C, int cpg,
                      float eps, int silu) {
  __shared__ float scratch[32];
  __shared__ float red[2 * 4 * kMaxThreads];  // per-thread channel partials
  __shared__ float chan[2 * kMaxCpg];         // channel totals: dgamma, dbeta
  const int g = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int vpr = cpg / VEC;         // vectors per row of the group
  const int rpi = blockDim.x / vpr;  // rows per sweep of the block
  const bool owner = t < rpi * vpr;
  const int cv = t % vpr, r0 = t / vpr;
  const int c = cv * VEC;
  const int step = rpi * kUnroll;
  const long long base = (long long)b * S * C + (long long)g * cpg + c;

  // pass 1: statistics, as the forward
  float sum = 0.f, sq = 0.f;
  if (owner) {
    for (int s0 = r0; s0 < S; s0 += step) {
      Vec<T, VEC> r[kUnroll];
      load_vecs<T, VEC>(r, x + base, s0, rpi, S, C);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float val = pdm::to_float(r[u].v[k]);
          sum += val;
          sq = fmaf(val, val, sq);
        }
    }
  }
  sum = pdm::block_sum(sum, scratch);
  sq = pdm::block_sum(sq, scratch);
  const float n = (float)S * (float)cpg;
  const float mean = sum / n;
  const float var = fmaxf(sq / n - mean * mean, 0.f);
  const float inv = 1.f / sqrtf(var + eps);

  float gam[VEC], bet[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    gam[k] = gamma[g * cpg + c + k];
    bet[k] = beta[g * cpg + c + k];
  }

  // pass 2: this thread's channel partials of dgamma and dbeta
  float dg[VEC], db[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) dg[k] = db[k] = 0.f;
  if (owner) {
    for (int s0 = r0; s0 < S; s0 += step) {
      Vec<T, VEC> rx[kUnroll], rd[kUnroll];
      load_vecs<T, VEC>(rx, x + base, s0, rpi, S, C);
      load_vecs<T, VEC>(rd, dy + base, s0, rpi, S, C);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u * rpi >= S) continue;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float nh = (pdm::to_float(rx[u].v[k]) - mean) * inv;
          float dz = pdm::to_float(rd[u].v[k]);
          if (silu) dz = silu_vjp(dz, nh * gam[k] + bet[k]);
          dg[k] = fmaf(dz, nh, dg[k]);
          db[k] += dz;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    red[k * blockDim.x + t] = dg[k];
    red[(VEC + k) * blockDim.x + t] = db[k];
  }
  __syncthreads();
  // channel totals: one warp per (kind, channel), over the threads that
  // own the channel's vector (t = cv, cv + vpr, ...), in a fixed order
  const int n_warps = blockDim.x >> 5;
  for (int job = warp; job < 2 * cpg; job += n_warps) {
    const int kind = job / cpg, ch = job - kind * cpg;  // kind 0: dgamma
    const int jcv = ch / VEC, k = ch - jcv * VEC;
    const float* col = red + (kind * VEC + k) * blockDim.x + jcv;
    float acc = 0.f;
    for (int i = lane; i < rpi; i += 32) acc += col[i * vpr];
    acc = pdm::warp_sum(acc);
    if (lane == 0) {
      chan[job] = acc;
      (kind ? dbeta_part : dgamma_part)[(long long)b * C + g * cpg + ch] = acc;
    }
  }
  __syncthreads();
  float m1 = 0.f, m2 = 0.f;  // sums of dn and of dn * n over the group
  for (int ch = t; ch < cpg; ch += blockDim.x) {
    const float gm = gamma[g * cpg + ch];
    m1 = fmaf(gm, chan[cpg + ch], m1);
    m2 = fmaf(gm, chan[ch], m2);
  }
  m1 = pdm::block_sum(m1, scratch) / n;
  m2 = pdm::block_sum(m2, scratch) / n;

  // pass 3: dx = inv * (dn - mean_g(dn) - n * mean_g(dn * n))
  if (!owner) return;
  for (int s0 = r0; s0 < S; s0 += step) {
    Vec<T, VEC> rx[kUnroll], rd[kUnroll];
    load_vecs<T, VEC>(rx, x + base, s0, rpi, S, C);
    load_vecs<T, VEC>(rd, dy + base, s0, rpi, S, C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * rpi;
      if (s >= S) continue;
      Vec<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float nh = (pdm::to_float(rx[u].v[k]) - mean) * inv;
        float dz = pdm::to_float(rd[u].v[k]);
        if (silu) dz = silu_vjp(dz, nh * gam[k] + bet[k]);
        const float dn = dz * gam[k];
        o.v[k] = pdm::from_float<T>(inv * (dn - m1 - nh * m2));
      }
      *reinterpret_cast<Vec<T, VEC>*>(dx + base + (long long)s * C) = o;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* x, const void* dy, const float* gamma,
                       const float* beta, void* dx, float* dg, float* db, int B,
                       int S, int C, int groups, float eps, int silu,
                       cudaStream_t stream) {
  const int cpg = C / groups;
  const int vpr = cpg / VEC;
  // enough threads for kUnroll vectors each, in whole warps, at least one
  // row's vectors, at most 256
  int threads = ((S * vpr + kUnroll - 1) / kUnroll + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const int min_threads = (vpr + 31) / 32 * 32;
  threads = threads < min_threads ? min_threads : threads;
  const dim3 grid(groups, B);
  group_norm_bwd_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta,
      static_cast<T*>(dx), dg, db, S, C, cpg, eps, silu);
  return cudaGetLastError();
}

// The widest vector the group width and the pointers allow.
template <typename T>
cudaError_t launch(const void* x, const void* dy, const float* gamma,
                   const float* beta, void* dx, float* dg, float* db, int B,
                   int S, int C, int groups, float eps, int silu,
                   cudaStream_t stream) {
  const int cpg = C / groups;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx);
  if (cpg % 4 == 0 && addr % (4 * sizeof(T)) == 0)
    return launch_vec<T, 4>(x, dy, gamma, beta, dx, dg, db, B, S, C, groups, eps, silu, stream);
  if (cpg % 2 == 0 && addr % (2 * sizeof(T)) == 0)
    return launch_vec<T, 2>(x, dy, gamma, beta, dx, dg, db, B, S, C, groups, eps, silu, stream);
  return launch_vec<T, 1>(x, dy, gamma, beta, dx, dg, db, B, S, C, groups, eps, silu, stream);
}

}  // namespace

// x, dy, dx: contiguous (B, S, C) of dtype `dtype`; gamma, beta: (C,) fp32;
// dgamma_part, dbeta_part: contiguous (B, C) fp32, written whole. C /
// groups at most 256. silu: 0 or 1. Returns cudaGetLastError().
extern "C" int pdm_group_norm_bwd(const void* x, const void* dy,
                                  const void* gamma, const void* beta, void* dx,
                                  void* dgamma_part, void* dbeta_part, int B,
                                  int S, int C, int groups, float eps, int silu,
                                  int dtype, void* stream) {
  if (groups <= 0 || C % groups || C / groups > kMaxCpg)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* bt = static_cast<const float*>(beta);
  auto* dg = static_cast<float*>(dgamma_part);
  auto* db = static_cast<float*>(dbeta_part);
  cudaError_t err;
  if (dtype == pdm::kFloat32)
    err = launch<float>(x, dy, g, bt, dx, dg, db, B, S, C, groups, eps, silu, s);
  else if (dtype == pdm::kBFloat16)
    err = launch<__nv_bfloat16>(x, dy, g, bt, dx, dg, db, B, S, C, groups, eps, silu, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
