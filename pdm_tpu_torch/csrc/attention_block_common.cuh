// Building blocks shared by the whole-attention-block kernels
// (attention_block.cu, forward; attention_block_bwd.cu, backward).
//
// Both run one thread-block cluster per group of images and one block per
// head (cluster rank j = head j), 8 warps. In fp32 the products run on the
// CUDA cores, thread t owning token row t, with the head's k and v (and, in
// the backward, q and datt parked in a device-memory scratch) in shared
// memory, one image a cluster.
//
// bf16 (the main path) runs on Hopper's machinery (attention_hopper.cuh):
// two warpgroups, wgmma products, operands brought in by TMA. A block's
// token rows are 64-row strips (BlockPlan): at T > 64 one image, T / 64
// strips rounded up to an even count; at T <= 64 two strips of P = 64 / Tr
// images each (packed, Tr the power of two >= T: the block-diagonal mask
// of PackedRows), so both warpgroups work at the mid block's T 16. The
// streamed products (the projections, the out projection, dh) go through a
// three-stage TMA ring (StageRing) of 64-deep stages: a strip pair's
// 64-column chunk of the activations (two 128-byte swizzled 64 x 64 boxes,
// one per warpgroup) and the weight rows or columns of head j for that
// chunk, read in
// place from nn.Linear's (C_out, C_in) weights. The projections round once
// straight into head j's swizzled q, k, v (and datt) tiles beside the
// ring, which the single-pass attention (fwd_strip, dq_strip, dkdv_strip)
// reads in place; outputs leave through per-warp staging rows in shared
// memory, so each store writes whole row segments.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_common.cuh"
#include "attention_hopper.cuh"

namespace pdm_block {

using namespace pdm_attn;
namespace cg = cooperative_groups;

constexpr int kThreads = pdm_hop::kThreads;  // 8 warps, two warpgroups
constexpr int kMaxTok = 256;   // tokens a block keeps resident
constexpr int kKT = 32;        // contraction depth of one fp32 stage
using pdm_hop::kLog2e;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float load_bias(const void* b, int i, int bias_bf16) {
  return bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i])
                   : static_cast<const float*>(b)[i];
}

// ---------------------------------------------------------------------------
// bf16: the launch plan (ops/attention_block.py::plan_block makes it; the
// kernels take it as it comes and refuse one they cannot run)

constexpr int kStages = 3;              // TMA ring depth
constexpr int kChunk = 64;              // contraction columns per stage
constexpr int kBox = kChunk * 64 * 2;   // one strip's 64 x 64 bf16 box

struct BlockPlan {
  int nc;         // 64-key chunks of a query strip (1: packed)
  int strips;     // 64-row strips of a block's tiles (even)
  int trs;        // log2 of a packed image's rows Tr (6 at T > 64)
  int per_strip;  // P: images per strip
  int imgs;       // images per group (one cluster's tiles)
  int groups;     // groups of images: ceil(B / imgs)
  int stages;     // ring depth
  int smem;       // dynamic shared memory of the launch
};

// a stage: a strip pair's boxes and the weight rows of the widest sweep
// (q, k, v: 3 HD rows of 64 columns forward; q, k: 2 HD backward)
__host__ __device__ constexpr int stage_bytes(int hd, bool backward) {
  return 2 * kBox + (backward ? 2 : 3) * hd * 128;
}
// a head's tiles: q, k, v (and datt) of every strip
__host__ __device__ constexpr int tiles_bytes(int strips, int hd, bool backward) {
  return (backward ? 4 : 3) * strips * 64 * hd * 2;
}

// What the kernels rely on: the strips hold every key (a strip's keys are
// nc 64-row chunks, at most 4), a packed strip holds P whole images of Tr
// >= T rows, the groups cover B, and the ring and tiles fit the shared
// memory asked for, which the device allows.
__host__ inline bool plan_ok(const BlockPlan& p, int B, int n_tok, int heads, int hd,
                             bool backward) {
  if (B < 1 || n_tok < 1 || n_tok > kMaxTok || heads < 1 || heads > 8 ||
      !(hd == 16 || hd == 32 || hd == 64) || p.stages != kStages || p.strips < 2 ||
      p.strips % 2 || p.groups < 1 || (long long)p.groups * p.imgs < B)
    return false;
  const bool packed = p.nc == 1 && n_tok <= 64;
  if (packed) {
    if (p.strips != 2 || p.trs < 0 || p.trs > 6 || (1 << p.trs) < n_tok ||
        p.per_strip << p.trs != 64 || p.imgs != 2 * p.per_strip)
      return false;
  } else if (p.nc < 2 || p.nc > 4 || p.nc * 64 < n_tok || p.strips < p.nc ||
             p.per_strip != 1 || p.imgs != 1) {
    return false;
  }
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return false;
  return p.smem >= p.stages * stage_bytes(hd, backward) +
                       tiles_bytes(p.strips, hd, backward) + 1024 &&
         p.smem <= optin;
}

// The rows of a block's tiles: image img0 (T > 64) or images img0.. packed
// Tr = 2^trs rows apart (T <= 64).
template <bool Packed>
using Rows = typename std::conditional<Packed, pdm_hop::PackedRows, pdm_hop::PlainRows>::type;

template <bool Packed>
__device__ __forceinline__ Rows<Packed> block_rows(int n_tok, int B, int img0, int trs,
                                                   int heads, int h) {
  if constexpr (Packed) {
    return pdm_hop::PackedRows{n_tok, B, img0, trs, heads, h};
  } else {
    return pdm_hop::PlainRows{n_tok, (long long)img0 * n_tok,
                              ((long long)img0 * heads + h) * n_tok};
  }
}

// Strip s of a block as TMA coordinates (token row, image) of a rows map
// whose boxes are {64, 64, 1} (T > 64) or {64, Tr, P} (packed)
struct StripAt {
  int row, img;
};
template <bool Packed>
__device__ __forceinline__ StripAt strip_at(int s, int img0, int per_strip) {
  return Packed ? StripAt{0, img0 + s * per_strip} : StripAt{s * 64, img0};
}

// A stage's boxes of strips 2p and 2p + 1 from the rows map `map` at
// column col (thread 0)
template <bool Packed>
__device__ __forceinline__ void load_pair(char* st, const CUtensorMap* map, uint64_t* bar,
                                          int col, int p, int img0, int per_strip) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const StripAt at = strip_at<Packed>(2 * p + s, img0, per_strip);
    pdm_hop::tma_load_3d(st + s * kBox, map, bar, col, at.row, at.img);
  }
}

// the A operand of warpgroup wg's strip in a stage: K-major, 64 rows
__device__ __forceinline__ uint64_t desc_a(const char* stage, int wg, int kk) {
  return pdm_hop::desc_k<64>(stage + wg * kBox, 64, 0, kk);
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
}

// The loads of chunk i of a projection sweep over the strip pairs: the
// pair's 64-column chunk kc of the rows map `h` and head j's HD rows of
// the NP weights for those columns (tx bytes in all).
template <int HD, int NP, bool Packed>
struct ProjLoad {
  static constexpr uint32_t tx = 2 * kBox + NP * HD * 128;
  const CUtensorMap* h;
  const CUtensorMap* w[NP];
  int nkc, j, img0, per_strip;
  __device__ __forceinline__ void operator()(int i, char* st, uint64_t* bar) const {
    const int p = i / nkc, kc = (i - p * nkc) * kChunk;
    load_pair<Packed>(st, h, bar, kc, p, img0, per_strip);
#pragma unroll
    for (int part = 0; part < NP; ++part)
      pdm_hop::tma_load_2d(st + 2 * kBox + part * HD * 128, w[part], bar, kc, j * HD);
  }
};

// NP projections of head j (h W_i[j rows]^T + b_i, the bias in fp32,
// rounded once) written straight into the swizzled tiles[i]: one ring
// sweep of `ld`'s chunks over the strip pairs, one wgmma m64n(NP HD)k16
// per 16 columns, a pair's epilogue while the next pair's chunks load (and
// then `next_sweep`'s first ones). The thread's biases are read once,
// before the sweep.
template <int HD, int NP, bool Packed, int S, typename NextLoad = pdm_hop::NoLoad>
__device__ __forceinline__ void project_tiles(
    pdm_hop::StageRing<S>& ring, char* ring_mem, int stage, pdm_hop::RingPos& pos,
    const ProjLoad<HD, NP, Packed>& ld, const void* const (&b)[NP], char* const (&tiles)[NP],
    int pairs, int bias_bf16,
    const pdm_hop::Ahead<NextLoad>& next_sweep = pdm_hop::Ahead<NextLoad>{0, 0u, NextLoad{}}) {
  using namespace pdm_hop;
  const int wg = threadIdx.x / kWgThreads, warp = (threadIdx.x & (kWgThreads - 1)) >> 5;
  const int g = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int nkc = ld.nkc;
  float bias[NP][HD / 8][2];
#pragma unroll
  for (int part = 0; part < NP; ++part)
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[part][i][e] = load_bias(b[part], ld.j * HD + i * 8 + 2 * tq + e, bias_bf16);
  float acc[NP * HD / 2];
  zero(acc);
  ring_sweep<S>(
      ring, ring_mem, stage, pos, pairs * nkc, ld.tx, ld, NoLoad{},
      [&](int, const char* st) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_t<NP * HD>(acc, desc_a(st, wg, kk),
                              desc_k<64>(st + 2 * kBox, NP * HD, 0, kk));
      },
      [&](int i) {
        if ((i + 1) % nkc) return;
        reg_fence(acc);
        const int row0 = (2 * (i / nkc) + wg) * 64 + warp * 16 + g;
#pragma unroll
        for (int part = 0; part < NP; ++part)
#pragma unroll
          for (int c = 0; c < HD / 8; ++c)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int k = 4 * (part * HD / 8 + c) + 2 * r;
              st_tile<HD>(tiles[part], row0 + 8 * r, c * 8 + 2 * tq,
                          pack_bf16(acc[k] + bias[part][c][0], acc[k + 1] + bias[part][c][1]));
            }
        zero(acc);
      },
      next_sweep);
}

// One ring sweep of the strip pairs' products with N = HD columns of head
// j: load(p, kc, stage, bar) issues a chunk's boxes (tx bytes land in the
// block's stage), rest(p, kc, stage, bar) those of a chunk issued ahead
// that did not come with it, the B operand at stage + 2 kBox (K-major
// weight rows, or N-major weight columns when NM), and store(p, acc) the
// pair's epilogue.
template <int HD, bool NM, int S, typename Load, typename Rest, typename Store,
          typename NextLoad = pdm_hop::NoLoad>
__device__ __forceinline__ void head_sweep(
    pdm_hop::StageRing<S>& ring, char* ring_mem, int stage, pdm_hop::RingPos& pos, int pairs,
    int nkc, uint32_t tx, Load load, Rest rest, Store store,
    const pdm_hop::Ahead<NextLoad>& next_sweep = pdm_hop::Ahead<NextLoad>{0, 0u, NextLoad{}}) {
  using namespace pdm_hop;
  const int wg = threadIdx.x / kWgThreads;
  float acc[HD / 2];
  zero(acc);
  ring_sweep<S>(
      ring, ring_mem, stage, pos, pairs * nkc, tx,
      [&](int i, char* st, uint64_t* bar) {
        const int p = i / nkc;
        load(p, i - p * nkc, st, bar);
      },
      [&](int i, char* st, uint64_t* bar) {
        const int p = i / nkc;
        rest(p, i - p * nkc, st, bar);
      },
      [&](int, const char* st) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (NM)
            wgmma_ss_t<HD, 0, 1>(acc, desc_a(st, wg, kk), desc_mn<HD>(st + 2 * kBox, 64, kk, 0));
          else
            wgmma_ss_t<HD>(acc, desc_a(st, wg, kk), desc_k<64>(st + 2 * kBox, HD, 0, kk));
        }
      },
      [&](int i) {
        if ((i + 1) % nkc) return;
        reg_fence(acc);
        store(i / nkc, acc);
        zero(acc);
      },
      next_sweep);
}

// Warp `warp`'s staging rows (16 rows of rs bytes) while the ring's
// weight regions take loads: in the stages' activation boxes, warp after
// warp, stage 0's from byte `head` on.
__host__ __device__ constexpr bool box_rows_fit(int head, int rs) {
  return (2 * kBox - head) / (16 * rs) + (kStages - 1) * (2 * kBox / (16 * rs)) >= kThreads / 32;
}
__device__ __forceinline__ char* box_rows(char* mem, int stage, int head, int rs, int warp) {
  const int per0 = (2 * kBox - head) / (16 * rs), per = 2 * kBox / (16 * rs);
  if (warp < per0) return mem + head + warp * 16 * rs;
  const int w = warp - per0;
  return mem + (1 + w / per) * stage + (w % per) * 16 * rs;
}

// Up to three row-major matrices stacked along their rows (the q, k and
// v projection weights, each `part` rows, rows `ld` elements apart), read
// as one: row r of the stack.
template <typename T>
struct Stack {
  const T* p[3];
  int part;
  long long ld;
  __device__ __forceinline__ const T* row(int r) const {
    const int i = r / part;
    return p[i] + (long long)(r - i * part) * ld;
  }
};

template <typename T>
__device__ __forceinline__ Stack<T> stack1(const T* p, int part, long long ld) {
  Stack<T> s;
  s.p[0] = s.p[1] = s.p[2] = p;
  s.part = part;
  s.ld = ld;
  return s;
}

// ---------------------------------------------------------------------------
// fp32: thread t owns token row t

// acc[n] = sum_k a[k] B(k, n) for the thread's row `a` (global, contiguous
// along k; read through L2, as it may have been written by this kernel)
// and n < HD; B(k, n) is the stack's row n, column k (NT) or row k,
// column col0 + n, staged through `wc` (32 x HD) in shared memory.
template <int HD, bool NT>
__device__ void row_gemm_f32(float (&acc)[HD], const float* a, bool active,
                             const Stack<float>& b, int col0, int K, float* wc) {
#pragma unroll
  for (int n = 0; n < HD; ++n) acc[n] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < kKT * HD; e += kThreads) {
      const int kk = e / HD, n = e - kk * HD;
      float v = 0.f;
      if (k0 + kk < K) v = NT ? b.row(n)[k0 + kk] : b.row(k0 + kk)[col0 + n];
      wc[e] = v;
    }
    __syncthreads();
    if (!active) continue;
    const int nk = min(kKT, K - k0);
    for (int kk = 0; kk < nk; ++kk) {
      const float av = __ldcg(a + k0 + kk);
      const float* w = wc + kk * HD;
#pragma unroll
      for (int n = 0; n < HD; ++n) acc[n] = fmaf(av, w[n], acc[n]);
    }
  }
}

// q . k over HD for rows in shared memory `stride` floats apart (scalar
// loads: the rows need not be 16-byte aligned)
template <int HD>
__device__ __forceinline__ float dot_f32(const float (&qr)[HD], const float* kr) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    s0 = fmaf(qr[d], kr[d], s0);
    s1 = fmaf(qr[d + 1], kr[d + 1], s1);
    s2 = fmaf(qr[d + 2], kr[d + 2], s2);
    s3 = fmaf(qr[d + 3], kr[d + 3], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// att = softmax(q k^T * scale) v for the thread's query row against the
// k, v rows in shared memory (`stride` floats apart), as row 1's fp32
// kernel: pass 1 m and l, pass 2 the normalized p times v. Returns the
// row's logsumexp.
template <int HD>
__device__ float attend_row_f32(float (&att)[HD], const float (&qr)[HD], const float* ks,
                                const float* vs, int stride, int n_tok, float scale) {
  float m = -INFINITY, l = 0.f;
  for (int k = 0; k < n_tok; ++k) {
    const float s = dot_f32<HD>(qr, ks + k * stride) * scale;
    if (s > m) {
      l = l * expf(m - s) + 1.f;
      m = s;
    } else {
      l += expf(s - m);
    }
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) att[d] = 0.f;
  for (int k = 0; k < n_tok; ++k) {
    const float p = expf(dot_f32<HD>(qr, ks + k * stride) * scale - m) / l;
    const float* vr = vs + k * stride;
#pragma unroll
    for (int d = 0; d < HD; ++d) att[d] = fmaf(p, vr[d], att[d]);
  }
  return m + logf(l);
}

// ---------------------------------------------------------------------------

// One cluster of `heads` blocks per group of images: grid (heads, groups),
// the kernel's dynamic shared memory set.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int heads, int groups, int smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads, groups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = heads;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace pdm_block
