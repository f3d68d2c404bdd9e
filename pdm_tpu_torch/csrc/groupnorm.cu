// GroupNorm with an optional fused SiLU, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/groupnorm.py::_fwd_kernel (launched
// by _fgn_call). Same function over x (B, S, C) with `groups` groups of
// cpg = C / groups channels: fp32 statistics from the sum and the sum of
// squares, var = max(E[x^2] - E[x]^2, 0), then
// y = (x - mean) * (rsqrt(var + eps) * gamma) + beta, optionally
// y * sigmoid(y), written in x's dtype. gamma and beta are fp32 (C,).
//
// What bounds it on the H100: bytes. The flagship's largest call
// (B=64, S=1024, C=384, bf16) reads 50 MB and writes 50 MB, about 30 us at
// 3.35 TB/s; the arithmetic is a few operations per element.
//
// Design: the TPU kernel holds one image's whole (S, C) tile in VMEM and
// forms group sums with membership matmuls. Here one block per (group,
// image) reduces its S x cpg values (cpg = 4..16 on the flagship) with
// per-thread fp32 partial sums and one block-wide shuffle reduction, then
// makes a second pass that normalizes and applies the SiLU epilogue. The
// second read of x mostly hits the 50 MB L2, since the block's first pass
// just brought the same lines in. Nothing crosses blocks, so no atomics
// and no second launch. A group's row segment is cpg elements wide and
// rows are C apart: threads read it in vectors of VEC = 4 elements (2 or 1
// when cpg or the alignment forbids), each thread keeping UNROLL loads in
// flight, since a latency-bound loop of one scalar load at a time left
// the first version at a fifth of the memory rate. Neighbouring groups'
// blocks run together and read the rest of each 32-byte sector from L2.
// Blocks are sized to the group (32 to 256 threads), so the 4x4 mid-block
// groups of 128 values do not idle 7 of 8 warps.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;  // vector loads in flight per thread

using pdm::Vec;

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ out,
                      int S, int C, int cpg, float eps, int silu) {
  __shared__ float scratch[32];
  const int g = blockIdx.x, b = blockIdx.y;
  const long long base = (long long)b * S * C + (long long)g * cpg;
  const int vpr = cpg / VEC;  // vectors per row of the group
  const int n_vec = S * vpr;
  const int step = blockDim.x * kUnroll;

  float sum = 0.f, sq = 0.f;
  for (int v0 = threadIdx.x; v0 < n_vec; v0 += step) {
    Vec<T, VEC> r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < n_vec) {
        const int s = v / vpr, c = (v - s * vpr) * VEC;
        r[u] = *reinterpret_cast<const Vec<T, VEC>*>(x + base + (long long)s * C + c);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) r[u].v[k] = pdm::from_float<T>(0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
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

  for (int v0 = threadIdx.x; v0 < n_vec; v0 += step) {
    Vec<T, VEC> r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < n_vec) {
        const int s = v / vpr, c = (v - s * vpr) * VEC;
        r[u] = *reinterpret_cast<const Vec<T, VEC>*>(x + base + (long long)s * C + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v >= n_vec) continue;
      const int s = v / vpr, c = (v - s * vpr) * VEC;
      Vec<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int ch = g * cpg + c + k;
        float y = (pdm::to_float(r[u].v[k]) - mean) * (inv * gamma[ch]) + beta[ch];
        if (silu) y = y / (1.f + expf(-y));
        o.v[k] = pdm::from_float<T>(y);
      }
      *reinterpret_cast<Vec<T, VEC>*>(out + base + (long long)s * C + c) = o;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* x, const float* gamma, const float* beta,
                       void* out, int B, int S, int C, int groups, float eps,
                       int silu, cudaStream_t stream) {
  const int cpg = C / groups;
  const int n_vec = S * (cpg / VEC);
  // enough threads for kUnroll vectors each, in whole warps, at most 256
  int threads = ((n_vec + kUnroll - 1) / kUnroll + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const dim3 grid(groups, B);
  group_norm_fwd_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(out), S, C, cpg,
      eps, silu);
  return cudaGetLastError();
}

// The widest vector the group width and the pointers allow.
template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   void* out, int B, int S, int C, int groups, float eps,
                   int silu, cudaStream_t stream) {
  const int cpg = C / groups;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (cpg % 4 == 0 && addr % (4 * sizeof(T)) == 0)
    return launch_vec<T, 4>(x, gamma, beta, out, B, S, C, groups, eps, silu, stream);
  if (cpg % 2 == 0 && addr % (2 * sizeof(T)) == 0)
    return launch_vec<T, 2>(x, gamma, beta, out, B, S, C, groups, eps, silu, stream);
  return launch_vec<T, 1>(x, gamma, beta, out, B, S, C, groups, eps, silu, stream);
}

}  // namespace

// x, out: contiguous (B, S, C) of dtype `dtype`; gamma, beta: (C,) fp32.
// silu: 0 or 1. Returns cudaGetLastError().
extern "C" int pdm_group_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* out, int B, int S,
                                  int C, int groups, float eps, int silu,
                                  int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<const float*>(gamma);
  auto* bt = static_cast<const float*>(beta);
  cudaError_t err;
  if (dtype == pdm::kFloat32)
    err = launch<float>(x, g, bt, out, B, S, C, groups, eps, silu, s);
  else if (dtype == pdm::kBFloat16)
    err = launch<__nv_bfloat16>(x, g, bt, out, B, S, C, groups, eps, silu, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
