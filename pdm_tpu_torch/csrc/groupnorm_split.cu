// Rows 3s and 4s: GroupNorm(+SiLU) forward and backward of an image whose
// rows are split across the ranks of a model group (the spatial layout of
// parallel/model_parallel.py), for Hopper (sm_90a).
//
// No TPU kernel of their own: JAX's GSPMD partitions the statistics of
// pdm_tpu/ops/groupnorm.py::_fgn_call (_fgn_bwd) into per-device sums and
// a psum over the model axis. Here each direction is two launches with an
// fp32 all-reduce of (B, G, 2) sums between them
// (ops/groupnorm.py::split_group_norm_act):
//
//   pdm_group_norm_stats (3s): per (image, group), sum x and sum x^2 over
//     the rank's rows.
//   pdm_group_norm_apply (3s): mean = s / n, var = max(q / n - mean^2, 0),
//     inv = 1 / sqrt(var + eps) of the all-reduced sums (n: a group's
//     elements over all ranks), y = (x - mean) * (inv * gamma) + beta and
//     the SiLU, rounded once to x's dtype (row 3's arithmetic).
//   pdm_group_norm_bwd_stats (4s): with n_hat = (x - mean) * inv and dz
//     the cotangent after the SiLU's VJP, per (image, group) sum dn and
//     sum dn * n_hat (dn = dz * gamma, folded from the image's channel
//     totals as row 4 folds them), and dgamma = sum dz * n_hat, dbeta =
//     sum dz over the rank's rows of every image.
//   pdm_group_norm_bwd_apply (4s): dx = inv * (dn - sum dn / n - n_hat *
//     sum dn n_hat / n) from the all-reduced group sums.
//
// What bounds them on the H100: bytes. At the flagship's first level split
// in two (B 64, S 512, C 128, bf16) the statistics read 8.4 MB (2.5 us at
// 3.35 TB/s), the backward's 16.8 MB; each launch does a few to ~25
// operations an element.
//
// Design: a streaming reduction (row 3's cluster plan, built to hold an
// image in shared memory, gives 64 blocks for the 132 SMs at B 8, S 32768,
// half a 256 x 256 image's first level). The plan
// (ops/groupnorm.py::plan_split, mirrored by SplitPlan) cuts each image's
// rows into `slabs` slabs of `rows` rows, one block a slab, grid (slabs,
// B), enough blocks for a full wave of the card at every shape. A block's
// thread t takes column vector t % V and rows t / V, t / V + P, ... (V * P
// threads): 16-byte vectors along C (8 bf16 or 4 fp32, narrower only where
// C or the pointers' alignment refuse them), kUnroll rows loaded before
// any is added, so each thread keeps four independent 16-byte loads (eight
// in the backward, x and dy) in flight. A thread's channels stay fixed, so
// their sums live in registers, and so do the backward's per-channel
// constants (mean, inv, gamma, beta), made once a block in shared memory
// (made by each thread for its own channels, their divides and square
// roots held every thread's first load back); the P lanes are then added
// in lane order through shared memory.
//
// Across blocks the sums fold in a fixed order, so two calls are bitwise
// equal: each block writes its slab's partials to scratch the wrapper
// allocates, takes a ticket from an atomic counter (the ticket only says
// which block arrives last; no sum goes through an atomic), and the last
// block of each image adds the image's partials in slab order. In the
// backward the last image to finish then adds the images' channel totals
// in image order: dgamma and dbeta leave the kernel summed over the batch.
// Each last block resets its counter to 0 for the next call (the wrapper
// keeps one zeroed counter buffer per device and stream).
//
// The apply kernels run the same plan. Each block first turns the
// all-reduced sums into per-channel coefficients in shared memory (3s:
// mean, inv * gamma, beta; 4s: dx = a dz + b x + c with z = a x + d, a =
// inv gamma, b = -inv^2 m2, c = inv (mean inv m2 - m1), d = beta - mean a,
// m1 = sum dn / n, m2 = sum dn n_hat / n); a thread copies its channels'
// into registers and streams its rows, kUnroll loads ahead.

#include <math.h>
#include <stdint.h>

#include "groupnorm_common.cuh"

namespace pdm_gn_split {

// Mirrors ops/groupnorm.py::SplitPlan field by field.
struct SplitPlan {
  int vec;      // elements a vector
  int lanes_v;  // V: column vectors a pass covers
  int lanes_p;  // P: row lanes
  int threads;  // block size: V * P rounded up to whole warps
  int rows;     // rows a slab (the last slab may hold fewer)
  int slabs;    // slabs an image: ceil(S / rows)
};

}  // namespace pdm_gn_split

namespace {

using pdm::Vec;
using pdm_gn::fold_groups;
using pdm_gn::sigmoid;
using pdm_gn_split::SplitPlan;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // rows a thread loads before it adds or writes any
constexpr int kFold = 8;    // partial-sum rows a thread loads before it adds any

bool split_plan_ok(const SplitPlan& p, int B, int S, int C, int groups, int esz) {
  if (B <= 0 || S <= 0 || groups <= 0 || C % groups) return false;
  if (!(p.vec == 1 || p.vec == 2 || p.vec == 4 || p.vec == 8) || p.vec * esz > 16 ||
      C % p.vec)
    return false;
  const int vpr = C / p.vec;
  if (p.lanes_v < 1 || p.lanes_v > vpr || p.lanes_p < 1) return false;
  if (p.threads % 32 || p.threads > kThreads || p.lanes_v * p.lanes_p > p.threads)
    return false;
  return p.rows >= 1 && p.slabs >= 1 && (long long)p.rows * p.slabs >= S &&
         (long long)p.rows * (p.slabs - 1) < S;
}

// Floats of a statistics kernel's first shared array: the lanes' sums (2 V
// P vec), then, in the last blocks, the folds' runs (4 kThreads at most);
// a multiple of 4, so that the next array is 16-byte aligned.
__host__ __device__ inline int red_floats(const SplitPlan& p) {
  const int lanes = (2 * p.lanes_v * p.lanes_p * p.vec + 3) / 4 * 4;
  return lanes > 4 * kThreads ? lanes : 4 * kThreads;
}

// Shared memory of a statistics kernel in floats: that array, then in the
// backward each channel's mean, inv, gamma and beta (4 C) and the image's
// totals (2 C), then the channel sums (2 C) and the group sums (2 G).
int stats_floats(const SplitPlan& p, int C, int groups, int nq) {
  return red_floats(p) + (nq == 2 ? 6 * C : 0) + 2 * C + 2 * groups;
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> ld(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

// Whether this block is the last of `total` to reach `counter`; every
// thread's global writes before the call are visible to the last block,
// which resets the counter. A block barrier, then one thread's acq_rel
// atomic at device scope: its release carries the block's writes, its
// acquire the other blocks' (lighter than a fence.sc before a relaxed
// atomic, which measured slower). The ticket orders nothing but who folds.
__device__ __forceinline__ bool last_to_arrive(int* counter, int total, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    const bool last = old == total - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// out[j] = sum over i < n of src[i * width + j] (j < width), in a fixed
// order: the threads split a row into vectors of W floats and the rows
// into Q contiguous runs; each thread adds its run's rows in order, kFold
// loads ahead, and the runs are added in run order through `buf` (Q width
// <= 4 kThreads floats). The loads skip L1 (other blocks wrote them).
template <int W>
__device__ __forceinline__ void fold_rows_w(const float* src, int n, int width, float* out,
                                            float* buf) {
  using V = Vec<float, W>;
  const int cols = width / W, t = threadIdx.x;
  const int lanes = min(cols, (int)blockDim.x);
  const int Q = max(1, min(n, (int)blockDim.x / lanes));
  const int run = (n + Q - 1) / Q, q = t / lanes;
  const V* s = reinterpret_cast<const V*>(src);
  if (q < Q) {
    const int i0 = q * run, i1 = min(n, i0 + run);
    for (int c = t % lanes; c < cols; c += lanes) {
      float acc[W];
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = 0.f;
      int i = i0;
      for (; i + kFold <= i1; i += kFold) {
        V v[kFold];
#pragma unroll
        for (int u = 0; u < kFold; ++u) {
          const V* a = s + (long long)(i + u) * cols + c;
          if constexpr (W == 4) {
            const float4 f = __ldcg(reinterpret_cast<const float4*>(a));
            v[u].v[0] = f.x, v[u].v[1] = f.y, v[u].v[2] = f.z, v[u].v[3] = f.w;
          } else {
            v[u].v[0] = __ldcg(reinterpret_cast<const float*>(a));
          }
        }
#pragma unroll
        for (int u = 0; u < kFold; ++u)
#pragma unroll
          for (int k = 0; k < W; ++k) acc[k] += v[u].v[k];
      }
      for (; i < i1; ++i)
#pragma unroll
        for (int k = 0; k < W; ++k) acc[k] += __ldcg(src + (long long)i * width + c * W + k);
      float* dst = Q == 1 ? out : buf + q * width;
#pragma unroll
      for (int k = 0; k < W; ++k) dst[c * W + k] = acc[k];
    }
  }
  if (Q == 1) return;
  __syncthreads();
  for (int j = t; j < width; j += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < Q; ++k) acc += buf[k * width + j];
    out[j] = acc;
  }
}

__device__ __forceinline__ void fold_rows(const float* src, int n, int width, float* out,
                                          float* buf) {
  if (width % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0)
    fold_rows_w<4>(src, n, width, out, buf);
  else
    fold_rows_w<1>(src, n, width, out, buf);
}

// For each channel c of the slab, the sums over its rows of two
// per-element terms into out[c] and out[C + c]. Each thread adds its rows
// of column vector cv in row order, kUnroll loads ahead (src.load(r, cv)
// returns one row's vectors, src.add adds their terms), then the P lanes
// are added in lane order through `red`. Src::Consts holds a thread's
// per-channel constants (src.consts(cv)).
template <int VEC, class Src>
__device__ __forceinline__ void slab_sums(const SplitPlan& p, int C, int nrows, float* red,
                                          float* out, const Src& src) {
  const int t = threadIdx.x, n = p.lanes_v * p.lanes_p;
  const int cvi = t % p.lanes_v, lane = t / p.lanes_v;
  const int vpr = C / VEC;
  for (int cv0 = 0; cv0 < vpr; cv0 += p.lanes_v) {
    const int cv = cv0 + cvi;
    float a[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = b[k] = 0.f;
    if (t < n && cv < vpr) {
      const typename Src::Consts k = src.consts(cv);
      int r = lane;
      for (; r + (kUnroll - 1) * p.lanes_p < nrows; r += kUnroll * p.lanes_p) {
        typename Src::Item it[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) it[u] = src.load(r + u * p.lanes_p, cv);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) src.add(it[u], k, a, b);
      }
      for (; r < nrows; r += p.lanes_p) src.add(src.load(r, cv), k, a, b);
    }
    if (t < n) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        red[t * VEC + k] = a[k];
        red[(n + t) * VEC + k] = b[k];
      }
    }
    __syncthreads();
    const int width = min(p.lanes_v, vpr - cv0) * VEC;
    for (int j = t; j < width; j += blockDim.x) {
      float sa = 0.f, sb = 0.f;
#pragma unroll 8
      for (int q = 0; q < p.lanes_p; ++q) {
        sa += red[q * p.lanes_v * VEC + j];
        sb += red[(n + q * p.lanes_v) * VEC + j];
      }
      out[cv0 * VEC + j] = sa;
      out[C + cv0 * VEC + j] = sb;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// row 3s
// ---------------------------------------------------------------------

// x and x^2 of a slab (rows of stride C from the slab's first)
template <typename T, int VEC>
struct XTerms {
  const T* x;
  int C;
  struct Consts {};
  using Item = Vec<T, VEC>;
  __device__ Consts consts(int) const { return {}; }
  __device__ Item load(int r, int cv) const { return ld<T, VEC>(x + (long long)r * C + cv * VEC); }
  __device__ void add(const Item& v, const Consts&, float (&a)[VEC], float (&q)[VEC]) const {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float f = pdm::to_float(v.v[k]);
      a[k] += f;
      q[k] = fmaf(f, f, q[k]);
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
split_stats_kernel(const T* __restrict__ x, float* __restrict__ sums, float* __restrict__ part,
                   int* __restrict__ counters, const SplitPlan p, int S, int C, int groups) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  const int slab = blockIdx.x, b = blockIdx.y;
  const int cpg = C / groups;
  const int row0 = slab * p.rows, nrows = min(p.rows, S - row0);
  float* red = smem;
  float* chan = red + red_floats(p);
  float* gsum = chan + 2 * C;
  slab_sums<VEC>(p, C, nrows, red, chan, XTerms<T, VEC>{x + ((long long)b * S + row0) * C, C});
  fold_groups<false>(chan, C, cpg, groups, nullptr, gsum);
  __syncthreads();
  float* mine = part + ((long long)b * p.slabs + slab) * 2 * groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    mine[2 * g] = gsum[g];
    mine[2 * g + 1] = gsum[groups + g];
  }
  if (last_to_arrive(counters + b, p.slabs, &flag))
    fold_rows(part + (long long)b * p.slabs * 2 * groups, p.slabs, 2 * groups,
              sums + (long long)b * 2 * groups, red);
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
split_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ sums,
                   T* __restrict__ out, const SplitPlan p, int S, int C, int groups, float n,
                   float eps) {
  extern __shared__ __align__(16) float coef[];  // mean, inv * gamma, beta of each channel
  const int slab = blockIdx.x, b = blockIdx.y;
  const int cpg = C / groups;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* s = sums + ((long long)b * groups + c / cpg) * 2;
    const float mean = s[0] / n;
    const float var = fmaxf(s[1] / n - mean * mean, 0.f);
    coef[c] = mean;
    coef[C + c] = (1.f / sqrtf(var + eps)) * gamma[c];
    coef[2 * C + c] = beta[c];
  }
  __syncthreads();
  const int t = threadIdx.x, nt = p.lanes_v * p.lanes_p;
  if (t >= nt) return;
  const int row0 = slab * p.rows, nrows = min(p.rows, S - row0);
  const long long base = ((long long)b * S + row0) * C;
  const int vpr = C / VEC, lane = t / p.lanes_v;
  for (int cv = t % p.lanes_v; cv < vpr; cv += p.lanes_v) {
    float mean[VEC], mul[VEC], add[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = cv * VEC + k;
      mean[k] = coef[c];
      mul[k] = coef[C + c];
      add[k] = coef[2 * C + c];
    }
    auto norm = [&](const Vec<T, VEC>& v) {
      Vec<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float y = (pdm::to_float(v.v[k]) - mean[k]) * mul[k] + add[k];
        if constexpr (SILU) y *= sigmoid(y);
        o.v[k] = pdm::from_float<T>(y);
      }
      return o;
    };
    int r = lane;
    for (; r + (kUnroll - 1) * p.lanes_p < nrows; r += kUnroll * p.lanes_p) {
      Vec<T, VEC> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = ld<T, VEC>(x + base + (long long)(r + u * p.lanes_p) * C + cv * VEC);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        *reinterpret_cast<Vec<T, VEC>*>(out + base + (long long)(r + u * p.lanes_p) * C +
                                        cv * VEC) = norm(v[u]);
    }
    for (; r < nrows; r += p.lanes_p) {
      const long long off = base + (long long)r * C + cv * VEC;
      *reinterpret_cast<Vec<T, VEC>*>(out + off) = norm(ld<T, VEC>(x + off));
    }
  }
}

// ---------------------------------------------------------------------
// row 4s
// ---------------------------------------------------------------------

__device__ __forceinline__ float silu_vjp(float dy, float z) {
  const float s = sigmoid(z);
  return dy * (s * (1.f + z * (1.f - s)));
}

// dz * n_hat and dz of a slab (x and dy rows of stride C), n_hat from the
// all-reduced forward sums; `k` holds each channel's mean, inv, gamma and
// beta (4 C floats, made once a block)
template <typename T, int VEC, bool SILU>
struct DzTerms {
  const T* x;
  const T* dy;
  const float* k;
  int C;
  struct Consts {
    float mean[VEC], inv[VEC], gam[VEC], bet[VEC];
  };
  struct Item {
    Vec<T, VEC> x, d;
  };
  __device__ Consts consts(int cv) const {
    Consts c;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ch = cv * VEC + j;
      c.mean[j] = k[ch];
      c.inv[j] = k[C + ch];
      c.gam[j] = k[2 * C + ch];
      c.bet[j] = k[3 * C + ch];
    }
    return c;
  }
  __device__ Item load(int r, int cv) const {
    const long long off = (long long)r * C + cv * VEC;
    return {ld<T, VEC>(x + off), ld<T, VEC>(dy + off)};
  }
  __device__ void add(const Item& it, const Consts& c, float (&dg)[VEC],
                      float (&db)[VEC]) const {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float nh = (pdm::to_float(it.x.v[j]) - c.mean[j]) * c.inv[j];
      float dz = pdm::to_float(it.d.v[j]);
      if constexpr (SILU) dz = silu_vjp(dz, nh * c.gam[j] + c.bet[j]);
      dg[j] = fmaf(dz, nh, dg[j]);
      db[j] += dz;
    }
  }
};

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
split_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ sums, float* __restrict__ gsums,
                       float* __restrict__ dparams, float* __restrict__ part,
                       float* __restrict__ totals, int* __restrict__ counters,
                       const SplitPlan p, int B, int S, int C, int groups, float n, float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  const int slab = blockIdx.x, b = blockIdx.y;
  const int cpg = C / groups;
  const int row0 = slab * p.rows, nrows = min(p.rows, S - row0);
  float* red = smem;
  float* kc = red + red_floats(p);
  float* tot = kc + 4 * C;
  float* chan = tot + 2 * C;
  float* gm = chan + 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* s = sums + ((long long)b * groups + c / cpg) * 2;
    const float mean = s[0] / n;
    const float var = fmaxf(s[1] / n - mean * mean, 0.f);
    kc[c] = mean;
    kc[C + c] = 1.f / sqrtf(var + eps);
    kc[2 * C + c] = gamma[c];
    kc[3 * C + c] = beta[c];
  }
  __syncthreads();
  const long long base = ((long long)b * S + row0) * C;
  slab_sums<VEC>(p, C, nrows, red, chan, DzTerms<T, VEC, SILU>{x + base, dy + base, kc, C});
  // the slab's dgamma (chan[0, C)) and dbeta (chan[C, 2C)) partials
  float* mine = part + ((long long)b * p.slabs + slab) * 2 * C;
  for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) mine[j] = chan[j];
  if (!last_to_arrive(counters + b, p.slabs, &flag)) return;
  // the image's channel totals in slab order, then gm[g] = sum_c gamma_c
  // dgamma_c = sum dn n_hat and gm[G + g] = sum_c gamma_c dbeta_c = sum dn
  fold_rows(part + (long long)b * p.slabs * 2 * C, p.slabs, 2 * C, tot, red);
  __syncthreads();
  fold_groups<true>(tot, C, cpg, groups, gamma, gm);
  float* img = totals + (long long)b * 2 * C;
  for (int j = threadIdx.x; j < 2 * C; j += blockDim.x) img[j] = tot[j];
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float* o = gsums + ((long long)b * groups + g) * 2;
    o[0] = gm[groups + g];
    o[1] = gm[g];
  }
  // the last image to finish adds the images' totals in image order
  if (last_to_arrive(counters + B, B, &flag)) fold_rows(totals, B, 2 * C, dparams, red);
}

template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
split_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ sums, const float* __restrict__ gsums,
                       T* __restrict__ dx, const SplitPlan p, int S, int C, int groups, float n,
                       float eps) {
  // dx = a dz + b x + c, z = a x + d: a, b, c, d of each channel
  extern __shared__ __align__(16) float coef[];
  const int slab = blockIdx.x, b = blockIdx.y;
  const int cpg = C / groups;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long g2 = ((long long)b * groups + c / cpg) * 2;
    const float mean = sums[g2] / n;
    const float var = fmaxf(sums[g2 + 1] / n - mean * mean, 0.f);
    const float inv = 1.f / sqrtf(var + eps);
    const float m1 = gsums[g2] / n, m2 = gsums[g2 + 1] / n;
    const float a = inv * gamma[c];
    coef[c] = a;
    coef[C + c] = -inv * inv * m2;
    coef[2 * C + c] = inv * (mean * inv * m2 - m1);
    coef[3 * C + c] = beta[c] - mean * a;
  }
  __syncthreads();
  const int t = threadIdx.x, nt = p.lanes_v * p.lanes_p;
  if (t >= nt) return;
  const int row0 = slab * p.rows, nrows = min(p.rows, S - row0);
  const long long base = ((long long)b * S + row0) * C;
  const int vpr = C / VEC, lane = t / p.lanes_v;
  for (int cv = t % p.lanes_v; cv < vpr; cv += p.lanes_v) {
    float ca[VEC], cb[VEC], cc[VEC], cd[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = cv * VEC + k;
      ca[k] = coef[c];
      cb[k] = coef[C + c];
      cc[k] = coef[2 * C + c];
      cd[k] = coef[3 * C + c];
    }
    auto grad = [&](const Vec<T, VEC>& vx, const Vec<T, VEC>& vd) {
      Vec<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xf = pdm::to_float(vx.v[k]);
        float dz = pdm::to_float(vd.v[k]);
        if constexpr (SILU) dz = silu_vjp(dz, fmaf(ca[k], xf, cd[k]));
        o.v[k] = pdm::from_float<T>(fmaf(ca[k], dz, fmaf(cb[k], xf, cc[k])));
      }
      return o;
    };
    int r = lane;
    for (; r + (kUnroll - 1) * p.lanes_p < nrows; r += kUnroll * p.lanes_p) {
      Vec<T, VEC> vx[kUnroll], vd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = base + (long long)(r + u * p.lanes_p) * C + cv * VEC;
        vx[u] = ld<T, VEC>(x + off);
        vd[u] = ld<T, VEC>(dy + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        *reinterpret_cast<Vec<T, VEC>*>(dx + base + (long long)(r + u * p.lanes_p) * C +
                                        cv * VEC) = grad(vx[u], vd[u]);
    }
    for (; r < nrows; r += p.lanes_p) {
      const long long off = base + (long long)r * C + cv * VEC;
      *reinterpret_cast<Vec<T, VEC>*>(dx + off) = grad(ld<T, VEC>(x + off), ld<T, VEC>(dy + off));
    }
  }
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

// grid (slabs, B), the plan's threads, `floats` of dynamic shared memory
template <typename... KArgs, typename... Args>
cudaError_t launch_split(void (*kernel)(KArgs...), const SplitPlan& p, int B, int floats,
                   cudaStream_t stream, Args... args) {
  const int smem = 4 * floats;
  if (smem > pdm_gn::kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(p.slabs, B), p.threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// F<T, VEC>::run(args...) for the plan's vector width (16 bytes at most)
template <template <typename, int> class F, typename T, typename... Args>
cudaError_t by_vec(int vec, Args... args) {
  switch (vec) {
    case 1: return F<T, 1>::run(args...);
    case 2: return F<T, 2>::run(args...);
    case 4: return F<T, 4>::run(args...);
    case 8:
      if constexpr (sizeof(T) <= 2) return F<T, 8>::run(args...);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int> class F, typename... Args>
cudaError_t by_type(int dtype, int vec, Args... args) {
  if (dtype == pdm::kFloat32) return by_vec<F, float>(vec, args...);
  if (dtype == pdm::kBFloat16) return by_vec<F, __nv_bfloat16>(vec, args...);
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
struct Stats {
  static cudaError_t run(const void* x, float* sums, float* part, int* counters,
                         const SplitPlan& p, int B, int S, int C, int groups, cudaStream_t s) {
    return launch_split(split_stats_kernel<T, VEC>, p, B, stats_floats(p, C, groups, 1), s,
                  static_cast<const T*>(x), sums, part, counters, p, S, C, groups);
  }
};

template <typename T, int VEC>
struct Apply {
  static cudaError_t run(const void* x, const float* gamma, const float* beta,
                         const float* sums, void* out, const SplitPlan& p, int B, int S, int C,
                         int groups, float n, float eps, int silu, cudaStream_t s) {
    auto* xt = static_cast<const T*>(x);
    auto* ot = static_cast<T*>(out);
    if (silu)
      return launch_split(split_apply_kernel<T, VEC, true>, p, B, 3 * C, s, xt, gamma, beta,
                          sums, ot, p, S, C, groups, n, eps);
    return launch_split(split_apply_kernel<T, VEC, false>, p, B, 3 * C, s, xt, gamma, beta,
                        sums, ot, p, S, C, groups, n, eps);
  }
};

template <typename T, int VEC>
struct BwdStats {
  static cudaError_t run(const void* x, const void* dy, const float* gamma, const float* beta,
                         const float* sums, float* gsums, float* dparams, float* part,
                         float* totals, int* counters, const SplitPlan& p, int B, int S, int C,
                         int groups, float n, float eps, int silu, cudaStream_t s) {
    auto* xt = static_cast<const T*>(x);
    auto* dt = static_cast<const T*>(dy);
    const int floats = stats_floats(p, C, groups, 2);
    if (silu)
      return launch_split(split_bwd_stats_kernel<T, VEC, true>, p, B, floats, s, xt, dt, gamma,
                          beta, sums, gsums, dparams, part, totals, counters, p, B, S, C,
                          groups, n, eps);
    return launch_split(split_bwd_stats_kernel<T, VEC, false>, p, B, floats, s, xt, dt, gamma,
                        beta, sums, gsums, dparams, part, totals, counters, p, B, S, C, groups,
                        n, eps);
  }
};

template <typename T, int VEC>
struct BwdApply {
  static cudaError_t run(const void* x, const void* dy, const float* gamma, const float* beta,
                         const float* sums, const float* gsums, void* dx, const SplitPlan& p,
                         int B, int S, int C, int groups, float n, float eps, int silu,
                         cudaStream_t s) {
    auto* xt = static_cast<const T*>(x);
    auto* dt = static_cast<const T*>(dy);
    auto* ot = static_cast<T*>(dx);
    if (silu)
      return launch_split(split_bwd_apply_kernel<T, VEC, true>, p, B, 4 * C, s, xt, dt, gamma,
                          beta, sums, gsums, ot, p, S, C, groups, n, eps);
    return launch_split(split_bwd_apply_kernel<T, VEC, false>, p, B, 4 * C, s, xt, dt, gamma,
                        beta, sums, gsums, ot, p, S, C, groups, n, eps);
  }
};

int esize(int dtype) { return dtype == pdm::kFloat32 ? 4 : 2; }

}  // namespace

// Every entry: x (and dy, out, dx) contiguous (B, S, C) of dtype `dtype`,
// aligned to the plan's vectors; gamma, beta (C,) fp32; sums, gsums (B,
// groups, 2) fp32; plan from ops/groupnorm.py::plan_split; n a group's
// elements over all ranks; silu 0 or 1. Returns cudaErrorInvalidValue for
// a plan the kernels cannot run, else cudaGetLastError().

// sums: written whole (sum x, sum x^2 of each group over the S rows);
// part: (B, slabs, groups, 2) fp32 scratch; counters: B zeroed int32,
// left zero.
extern "C" int pdm_group_norm_stats(const void* x, void* sums, void* part, void* counters,
                                    const SplitPlan* plan, int B, int S, int C, int groups,
                                    int dtype, void* stream) {
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) ||
      !split_plan_ok(*plan, B, S, C, groups, esize(dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type<Stats>(
      dtype, plan->vec, x, static_cast<float*>(sums), static_cast<float*>(part),
      static_cast<int*>(counters), *plan, B, S, C, groups, static_cast<cudaStream_t>(stream)));
}

extern "C" int pdm_group_norm_apply(const void* x, const void* gamma, const void* beta,
                                    const void* sums, void* out, const SplitPlan* plan, int B,
                                    int S, int C, int groups, float n, float eps, int silu,
                                    int dtype, void* stream) {
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) ||
      !split_plan_ok(*plan, B, S, C, groups, esize(dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type<Apply>(
      dtype, plan->vec, x, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(sums), out, *plan, B, S, C, groups, n, eps, silu,
      static_cast<cudaStream_t>(stream)));
}

// gsums: written whole (sum dn, sum dn * n_hat of each group over the S
// rows); dparams: (2, C) fp32, written whole (dgamma, dbeta over the S rows
// of every image); part: (B, slabs, 2, C) and totals: (B, 2, C) fp32
// scratch; counters: B + 1 zeroed int32, left zero.
extern "C" int pdm_group_norm_bwd_stats(const void* x, const void* dy, const void* gamma,
                                        const void* beta, const void* sums, void* gsums,
                                        void* dparams, void* part, void* totals,
                                        void* counters, const SplitPlan* plan, int B, int S,
                                        int C, int groups, float n, float eps, int silu,
                                        int dtype, void* stream) {
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) ||
      !split_plan_ok(*plan, B, S, C, groups, esize(dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type<BwdStats>(
      dtype, plan->vec, x, dy, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(sums),
      static_cast<float*>(gsums), static_cast<float*>(dparams), static_cast<float*>(part),
      static_cast<float*>(totals), static_cast<int*>(counters), *plan, B, S, C, groups, n, eps,
      silu, static_cast<cudaStream_t>(stream)));
}

extern "C" int pdm_group_norm_bwd_apply(const void* x, const void* dy, const void* gamma,
                                        const void* beta, const void* sums, const void* gsums,
                                        void* dx, const SplitPlan* plan, int B, int S, int C,
                                        int groups, float n, float eps, int silu, int dtype,
                                        void* stream) {
  if ((dtype != pdm::kFloat32 && dtype != pdm::kBFloat16) ||
      !split_plan_ok(*plan, B, S, C, groups, esize(dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type<BwdApply>(
      dtype, plan->vec, x, dy, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(sums),
      static_cast<const float*>(gsums), dx, *plan, B, S, C, groups, n, eps, silu,
      static_cast<cudaStream_t>(stream)));
}
