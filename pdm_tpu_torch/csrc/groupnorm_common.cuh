// Shared parts of the GroupNorm kernels (groupnorm.cu, groupnorm_bwd.cu):
// the launch plan, the shared-memory layout, the tile load, the per-channel
// sums over a block's rows and their fold into group sums.
//
// A block owns `rows` rows of one image across `cb` = C / kc channels
// (whole groups): grid (kr, kc, B), the kr blocks of an image's channel
// slice one thread-block cluster. The plan comes from the wrapper
// (ops/groupnorm.py::plan_group_norm, a pure function); the kernels check
// it and take it as given.
//
// Thread mapping of every pass over the block's elements: its row segment
// is vpr = cb / vec vectors of vec elements; thread t < V * P takes column
// vector cv = t % V (then cv + V, ... while cv < vpr) and row lane
// p = t / V (rows p, p + P, ... < the block's rows). Neighbouring threads
// read neighbouring vectors of a row, so every access is coalesced (and
// free of bank conflicts in shared memory) and a thread's channels stay
// fixed: it keeps their fp32 sums in registers. Four-element vectors: eight
// would hold twice the per-channel constants in registers and measured
// slower. The block then adds the P lanes of each channel in lane order
// (through `red`) and folds the cpg channels of each group in a fixed
// order; no atomics anywhere, so a call is bitwise repeatable.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace pdm_gn {

namespace cg = cooperative_groups;
using pdm::Vec;

constexpr int kMaxThreads = 256;
constexpr int kMaxClusterBlocks = 8;  // kr: the portable cluster size
constexpr int kMaxSmem = 232448;      // a block's shared memory on sm_90

// Mirrors ops/groupnorm.py::GroupNormPlan field by field.
struct GnPlan {
  int kr;       // blocks per image along S: one cluster
  int kc;       // blocks per image along C, each of whole groups
  int rows;     // rows per block (the last blocks may hold fewer, or none)
  int cb;       // channels per block: C / kc
  int vec;      // elements per vector: 4 where the shape allows
  int lanes_v;  // V: column vectors a pass covers at once
  int lanes_p;  // P: row lanes
  int threads;  // block size: V * P rounded up to whole warps
  int hold;     // 1: the tile stays in shared memory; 0: passes re-read it
  int smem;     // dynamic shared memory bytes
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Shared memory in floats before the tile: red (2 V P vec), the block's
// gamma and beta (2 cb), the channel sums (2 cb; with the backward's
// channel totals 4 cb), the group sums
// exchanged across the cluster (2 gb), the group statistics (2 gb; with
// the backward's group means of dn and dn * n, 4 gb). nq is 1 for the
// forward, 2 for the backward. Then the tile: x (esz bytes an element)
// and, in the backward, an fp32 slot an element that holds dy, then
// dn = dz gamma.
__host__ __device__ inline int floats_before_tile(const GnPlan& p, int gb, int nq) {
  return round4(2 * p.lanes_v * p.lanes_p * p.vec) + (1 + nq) * round4(2 * p.cb) +
         (1 + nq) * round4(2 * gb);
}

// The x tile's bytes, rounded up to 16 (the backward's fp32 slots follow).
__host__ __device__ inline int x_tile_bytes(const GnPlan& p, int esz) {
  return (p.rows * p.cb * esz + 15) / 16 * 16;
}

__host__ inline int smem_bytes(const GnPlan& p, int gb, int nq, int esz) {
  const int tile = x_tile_bytes(p, esz) + (nq == 2 ? 4 * p.rows * p.cb : 0);
  return 4 * floats_before_tile(p, gb, nq) + (p.hold ? tile : 0);
}

// The plan is one the kernels can run for this shape.
__host__ inline bool plan_ok(const GnPlan& p, int B, int S, int C, int groups, int nq,
                             int esz) {
  if (B <= 0 || S <= 0 || groups <= 0 || C % groups) return false;
  const int cpg = C / groups;
  if (p.kr < 1 || p.kr > kMaxClusterBlocks || p.kc < 1 || C % p.kc || p.cb != C / p.kc ||
      p.cb % cpg)
    return false;
  if (p.rows < 1 || (long long)p.rows * p.kr < S) return false;
  if (!(p.vec == 1 || p.vec == 2 || p.vec == 4) || p.cb % p.vec)
    return false;
  const int vpr = p.cb / p.vec;
  if (p.lanes_v < 1 || p.lanes_v > vpr || p.lanes_p < 1) return false;
  if (p.threads % 32 || p.threads > kMaxThreads || p.lanes_v * p.lanes_p > p.threads)
    return false;
  if (p.hold != 0 && p.hold != 1) return false;
  const int need = smem_bytes(p, p.cb / cpg, nq, esz);
  return need <= p.smem && p.smem <= kMaxSmem;
}

struct Layout {
  float* red;    // 2 * V * P * vec
  float* par;    // 2 * cb: gamma, then beta, of the block's channels
  float* chan;   // 2 * cb: a pass's channel sums (exchanged in the backward)
  float* tot;    // 2 * cb: the backward's channel totals over the cluster
  float* gpart;  // 2 * gb: the block's group sums (exchanged)
  float* gstat;  // 2 * gb: mean and rsqrt(var + eps) of each group
  float* gm;     // 2 * gb: the backward's group sums of gamma * dgamma, gamma * dbeta
  unsigned char* tile;
};

__device__ inline Layout layout(unsigned char* base, const GnPlan& p, int gb, int nq) {
  Layout L;
  float* f = reinterpret_cast<float*>(base);
  L.red = f;
  f += round4(2 * p.lanes_v * p.lanes_p * p.vec);
  L.par = f;
  f += round4(2 * p.cb);
  L.chan = f;
  f += round4(2 * p.cb);
  L.tot = f;
  if (nq == 2) f += round4(2 * p.cb);
  L.gpart = f;
  f += round4(2 * gb);
  L.gstat = f;
  f += round4(2 * gb);
  L.gm = f;
  if (nq == 2) f += round4(2 * gb);
  L.tile = reinterpret_cast<unsigned char*>(f);
  return L;
}

// The element geometry of one block.
struct Geom {
  int V, P, vpr, cb, nrows;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Barriers across the cluster's kr blocks (a block barrier when kr is 1).
// The split one: arrive once this block has read its peers' shared memory,
// wait before it exits (a peer may still be reading ours).
__device__ __forceinline__ void cluster_sync(cg::cluster_group& cluster, int kr) {
  if (kr == 1)
    __syncthreads();
  else
    cluster.sync();
}
__device__ __forceinline__ void cluster_arrive(int kr) {
  if (kr > 1) asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait(int kr) {
  if (kr > 1) asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Block k's copy of `local` (this block's own when the cluster is one block).
__device__ __forceinline__ const float* peer(cg::cluster_group& cluster, float* local, int k,
                                             int kr) {
  return kr == 1 ? local : cluster.map_shared_rank(local, k);
}

// Issue the copy of the block's rows x cb share of `src` (row stride C)
// into `tile` (row stride cb) with cp.async, a vector a thread; element
// e of the share lands at tile[e * F] onwards (F = 1: packed; F = 2: a bf16
// vector at the start of an fp32 slot). The caller waits
// (cp_async_wait_all) and syncs.
template <typename T, int VEC, int F>
__device__ __forceinline__ void issue_tile(T* tile, const T* src, const Geom& g, long long C) {
  if constexpr (F == 1) {
    // packed: 16-byte copies wherever the rows allow, whatever VEC is
    const int row_bytes = g.cb * (int)sizeof(T);
    if (row_bytes % 16 == 0 && (C * sizeof(T)) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      const int chunks = row_bytes / 16, n = g.nrows * chunks;
      auto* d = reinterpret_cast<unsigned char*>(tile);
      auto* s = reinterpret_cast<const unsigned char*>(src);
      for (int v = threadIdx.x; v < n; v += blockDim.x) {
        const int r = v / chunks, c = v - r * chunks;
        cp_async<16>(d + r * row_bytes + c * 16, s + r * C * (long long)sizeof(T) + c * 16);
      }
      return;
    }
  }
  const int n = g.nrows * g.vpr;
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int r = v / g.vpr, cv = v - r * g.vpr;
    T* d = tile + (r * g.cb + cv * VEC) * F;
    const T* s = src + r * C + cv * VEC;
    if constexpr (VEC * sizeof(T) >= 4)
      cp_async<VEC * sizeof(T)>(d, s);
    else
      *d = *s;
  }
}

// Issue the copy of the block's gamma and beta into par (cp.async, with
// the tile's copies).
__device__ __forceinline__ void issue_params(float* par, const float* gamma, const float* beta,
                                             int cb) {
  for (int i = threadIdx.x; i < cb; i += blockDim.x) {
    cp_async<4>(par + i, gamma + i);
    cp_async<4>(par + cb + i, beta + i);
  }
}

// Vector (r, cv) of the block's share: from the tile in shared memory, or
// from device memory (row stride C) when the plan streams.
template <typename T, int VEC, bool HOLD>
__device__ __forceinline__ Vec<T, VEC> load(const T* tile, const T* src, int cb, long long C,
                                            int r, int cv) {
  if constexpr (HOLD)
    return *reinterpret_cast<const Vec<T, VEC>*>(tile + r * cb + cv * VEC);
  else
    return *reinterpret_cast<const Vec<T, VEC>*>(src + r * C + cv * VEC);
}

// For each of the block's channels, the sums over its rows of two
// per-element quantities, into out[0, cb) and out[cb, 2 cb).
// elem(cv, lane, a, b) adds its rows' terms to a[VEC] and b[VEC].
template <int VEC, typename Elem>
__device__ __forceinline__ void channel_sums(const Geom& g, float* red, float* out, Elem elem) {
  const int t = threadIdx.x;
  const int n = g.V * g.P;
  const int cvi = t % g.V, lane = t / g.V;
  for (int cv0 = 0; cv0 < g.vpr; cv0 += g.V) {
    float a[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = b[k] = 0.f;
    if (t < n && cv0 + cvi < g.vpr) elem(cv0 + cvi, lane, a, b);
    if (t < n) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        red[t * VEC + k] = a[k];
        red[(n + t) * VEC + k] = b[k];
      }
    }
    __syncthreads();
    const int width = min(g.V, g.vpr - cv0) * VEC;
    for (int j = t; j < width; j += blockDim.x) {
      float sa = 0.f, sb = 0.f;
#pragma unroll 8
      for (int p = 0; p < g.P; ++p) {
        sa += red[p * g.V * VEC + j];
        sb += red[(n + p * g.V) * VEC + j];
      }
      out[cv0 * VEC + j] = sa;
      out[g.cb + cv0 * VEC + j] = sb;
    }
    __syncthreads();
  }
}

// Group sums of the block's channel sums: out[g] = sum over the group's
// channels c of w_c in[c], out[gb + g] of w_c in[cb + c] (w = 1 when
// WEIGHTED is false), in channel order: a thread a group up to 32 channels
// a group, else a warp a group (lanes over the channels, then a shuffle
// tree). The caller syncs before reading out.
template <bool WEIGHTED>
__device__ __forceinline__ void fold_groups(const float* in, int cb, int cpg, int gb,
                                            const float* w, float* out) {
  if (cpg <= 32) {
    for (int g = threadIdx.x; g < gb; g += blockDim.x) {
      float a = 0.f, b = 0.f;
#pragma unroll 4
      for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
        if constexpr (WEIGHTED) {
          a = fmaf(w[c], in[c], a);
          b = fmaf(w[c], in[cb + c], b);
        } else {
          a += in[c];
          b += in[cb + c];
        }
      }
      out[g] = a;
      out[gb + g] = b;
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int g = warp; g < gb; g += n_warps) {
    float a = 0.f, b = 0.f;
    for (int c = g * cpg + lane; c < (g + 1) * cpg; c += 32) {
      if constexpr (WEIGHTED) {
        a = fmaf(w[c], in[c], a);
        b = fmaf(w[c], in[cb + c], b);
      } else {
        a += in[c];
        b += in[cb + c];
      }
    }
    a = pdm::warp_sum(a);
    b = pdm::warp_sum(b);
    if (lane == 0) {
      out[g] = a;
      out[gb + g] = b;
    }
  }
}

// Each group's mean and rsqrt(var + eps), var = max(E[x^2] - E[x]^2, 0),
// from the group sums of every block of the cluster, added in rank order
// (so every block gets the same values). n = S * cpg values a group.
__device__ __forceinline__ void group_stats(cg::cluster_group& cluster, float* gpart,
                                            float* gstat, int gb, float n, float eps) {
  const int kr = static_cast<int>(cluster.num_blocks());
  for (int g = threadIdx.x; g < gb; g += blockDim.x) {
    float s = 0.f, q = 0.f;
#pragma unroll 8
    for (int k = 0; k < kr; ++k) {
      const float* pk = peer(cluster, gpart, k, kr);
      s += pk[g];
      q += pk[gb + g];
    }
    const float mean = s / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    gstat[g] = mean;
    gstat[gb + g] = 1.f / sqrtf(var + eps);
  }
}

// sigmoid(z) with e^-z and the reciprocal on the MUFU unit (ex2.approx and
// rcp.approx: a few ulp of fp32, well inside the kernels' tolerances; the
// IEEE reciprocal cost the backward ~18% at the flagship's shapes)
__device__ __forceinline__ float sigmoid(float z) { return __fdividef(1.f, 1.f + __expf(-z)); }

// Launch with the plan's grid (kr, kc, B), clusters of kr blocks along x.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), const GnPlan& p, int B, cudaStream_t stream,
                   Args... args) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.kr, p.kc, B);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.kr;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace pdm_gn
