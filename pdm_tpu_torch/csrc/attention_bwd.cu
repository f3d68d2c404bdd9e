// Spatial multi-head softmax attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/attention.py::_bwd_kernel (launched
// by _fsa_bwd). Same function and the same rounding points, per (image,
// head), from q, k, v, the forward's per-row logsumexp lse (fp32) and the
// cotangent do (already in the input dtype):
//   P  = exp(q k^T * scale - lse), rounded to the input dtype
//   dv = P^T do
//   dp = do v^T                          (fp32)
//   ds = P * dp - P * sum_k(P * dp), rounded to the input dtype
//   dq = (ds k) * scale,  dk = (ds^T q) * scale
// with fp32 accumulation and outputs in the input dtype. The row sums
// D = sum_k P * dp are taken from the rounded P, as the reference does
// (not FlashAttention's rowsum(do * o), which differs by a rounding).
//
// Layout: q, k, v are (B, T, C) with C = heads * hd, token rows `ld` apart
// (the column thirds of the fused qkv projection); do is contiguous (B,
// T, C); dq, dk, dv are (B, T, C) with token rows `ldo` apart (C, or 3C
// for the column thirds of the whole block's dqkv on its staged plan);
// lse and D are (B, heads, T) fp32.
//
// What bounds it on the H100: at the flagship's B=128, T=256, C=256 in
// bf16 the call must read q, k, v, do (4 x 16.8 MB) and lse, and write
// dq, dk, dv: ~117 MB, 35 us at 3.35 TB/s; its 10 B T^2 C = 21.5 GFLOP take
// 22 us at the bf16 tensor-core peak. Both bounds are close, so the design
// keeps every T x T tile in registers and reads each operand tile from
// shared memory.
//
// Design: the TPU kernel holds an image's whole T x T tiles in VMEM and
// runs five matmuls; here nothing T x T reaches device memory and no block
// writes another's output, so there are no atomics and every sum runs in a
// fixed order (the backward is deterministic). Two launches per call, by
// shape:
//
// * bf16, T <= 256 (every flagship shape): the single-pass Hopper kernels.
//   Both are persistent (one block per SM, two warpgroups) over items of
//   (pair of 64-row strips, head, image), warpgroup w taking strip w of the
//   pair. Thread 0 loads an item's operands once through TMA into one stage
//   of a two-stage ring of swizzled shared memory (two mbarriers a stage,
//   so the first product starts while the rest is in flight) and the next
//   item's into the other stage, so loads overlap compute. Every product
//   runs on wgmma, 7 products of 2 B T^2 C in all (the old design ran 9):
//   1. dq: an item holds the pair's q and do and the head's whole k and v.
//      S = q k^T and dp = do v^T (one wgmma m64n(64 NC)k16 per 16 head-dim
//      columns, NC = T / 64 rounded up) stay in registers for the strip's
//      whole row: P = exp(s - lse) is rounded to bf16 as it is packed, D =
//      sum_k P * dp comes from that rounded P exactly, ds = P dp - P D is
//      rounded as it is repacked in the same registers, the A operand of
//      dq = ds k (k read N-major). One sweep over the keys, where the old
//      kernel took two.
//   2. dk, dv: an item holds the pair's k and v and the head's whole q and
//      do, with the head's lse and D staged in shared memory. Over groups
//      of 128 queries (64 where NC is odd or HDP is 128): S^T = k q^T,
//      P^T (from the saved lse), dv += P^T do and dp^T = v do^T (issued
//      together), ds^T from the saved D, dk += ds^T q. dk and dv
//      accumulate in registers.
// * bf16, 256 < T <= 1024: the two-pass kernels on mma.sync (4 warps x 16
//   rows, 64-key tiles in padded shared memory): dq sweeps the keys once
//   for D and again for ds k; dk/dv recompute P^T and dp^T per query tile.
// * fp32 (parity runs, not the main path): the CUDA cores with one thread
//   per query row (dq) or key row (dk, dv). At HD 128 their row registers
//   spill, and dk/dv's shared memory (82 KB) is dynamic.
//
// head dims: any multiple of 8 up to 128, zero-padded in shared memory to
// the instantiated HDP of 16, 32, 64 or 128 (TMA fills the columns past hd
// with zeros; padded output columns are never written).
//
// Trouble met in the single-pass kernels, and what they do about it: a
// stage is 96 KB at HDP 64 and T 256 (two fit in a block's 227 KB; at HDP
// 128 one), dynamic, opted into with cudaFuncSetAttribute; tensor maps come
// through cudaGetDriverEntryPoint; the mid block's T = 16 is padded by
// TMA's zero fill to the 64 rows wgmma needs, padded keys get P = 0 in dq
// (their k rows are zeros, so their scores are not -inf), padded queries
// get lse = +inf and D = 0 in dk/dv, and padded rows are never stored.
// Registers: dq holds P (64 packed registers) beside dp (128 fp32) at
// T 256; the chunk count is a template parameter so that no branch sits
// between a product's issue and its wait. The elementwise work between
// products sets much of the time, so P and ds are rounded only where they
// are packed (the packing rounds to nearest even, as the reference's cast
// does) and padded keys are masked only when T is not a multiple of 64.

#include "attention_hopper.cuh"

namespace {

using namespace pdm_attn;

using pdm_hop::kLog2e;

// ---------------------------------------------------------------------------
// bf16, T <= 256: single pass on wgmma
//
// Both kernels are persistent (one block per SM, two warpgroups) over items
// of (pair of 64-row strips, head, image); warpgroup w takes strip w of the
// pair. An item's operands land in one stage of a two-stage ring through
// TMA, the next item's in the other, so loads overlap compute; the pair's
// two strips share the item's whole-head stripes.

// the item's strip pair, head and image
struct Item {
  int pair, h, b;
};
__device__ __forceinline__ Item decode(int item, int pairs, int heads) {
  Item it;
  it.pair = item % pairs;
  const int rest = item / pairs;
  it.h = rest % heads;
  it.b = rest / heads;
  return it;
}

template <int HDP, int NC>
__global__ void __launch_bounds__(pdm_hop::kThreads, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              __nv_bfloat16* __restrict__ dq,
                              float* __restrict__ dsum, int n_items, int n_tok,
                              int heads, int hd, float scale, float scale_log2,
                              int stages, long long ldo) {
  using namespace pdm_hop;
  using S = Stripe<HDP>;
  constexpr int rows = NC * kRows;
  constexpr int pairs = (NC + 1) / 2, pair_rows = (NC < 2 ? NC : 2) * kRows;
  constexpr int pair_tile = S::bytes(pair_rows), tile = S::bytes(rows);
  constexpr int stage = 2 * pair_tile + 2 * tile;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t bar[2][2];  // [stage]: q and k; do and v

  char* base = aligned_smem(smem_raw);
  const int G = gridDim.x, wg = threadIdx.x / kWgThreads;

  auto issue = [&](int item, int st) {
    const Item it = decode(item, pairs, heads);
    char* qs = base + st * stage;
    char* dos = qs + pair_tile;
    char* ks = dos + pair_tile;
    char* vs = ks + tile;
    mbar_expect_tx(&bar[st][0], pair_tile + tile);
    load_stripe<HDP>(qs, &tm_q, &bar[st][0], pair_rows, it.h, it.pair * 2 * kRows, it.b);
    load_stripe<HDP>(ks, &tm_k, &bar[st][0], rows, it.h, 0, it.b);
    mbar_expect_tx(&bar[st][1], pair_tile + tile);
    load_stripe<HDP>(dos, &tm_do, &bar[st][1], pair_rows, it.h, it.pair * 2 * kRows,
                     it.b);
    load_stripe<HDP>(vs, &tm_v, &bar[st][1], rows, it.h, 0, it.b);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&bar[st][0], 1);
      mbar_init(&bar[st][1], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int st = 0; st < stages; ++st)
      if (blockIdx.x + st * G < n_items) issue(blockIdx.x + st * G, st);

  for (int i = 0;; ++i) {
    const int item = blockIdx.x + i * G;
    if (item >= n_items) break;
    const int st = i % stages, phase = (i / stages) & 1;
    const Item it = decode(item, pairs, heads);
    const char* qs = base + st * stage;
    const int strip = it.pair * 2 + wg;
    mbar_wait(&bar[st][0], phase);
    const PlainRows lay{n_tok, (long long)it.b * n_tok,
                        ((long long)it.b * heads + it.h) * n_tok};
    if (strip < NC)
      dq_strip<HDP, NC, true>(qs, qs + pair_tile, qs + 2 * pair_tile, qs + 2 * pair_tile + tile,
                        &bar[st][1], phase, pair_rows, wg * kRows, rows, strip, lay, lse,
                        [&](const auto& acc, float mul, int row0) {
                          store_rows<HDP>(dq, acc, mul, lay, row0, ldo, it.h * hd, hd);
                        },
                        dsum, scale, scale_log2);
    else
      mbar_wait(&bar[st][1], phase);
    wgs_sync();  // the stage is consumed
    if (threadIdx.x == 0 && item + stages * G < n_items) issue(item + stages * G, st);
  }
}

template <int HDP, int NC>
__global__ void __launch_bounds__(pdm_hop::kThreads, 1)
attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse,
                                const float* __restrict__ dsum,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int n_items,
                                int n_tok, int heads, int hd, float scale,
                                float scale_log2, int stages, long long ldo) {
  using namespace pdm_hop;
  using S = Stripe<HDP>;
  constexpr int rows = NC * kRows;
  constexpr int pairs = (NC + 1) / 2, pair_rows = (NC < 2 ? NC : 2) * kRows;
  constexpr int pair_tile = S::bytes(pair_rows), tile = S::bytes(rows);
  constexpr int stage = 2 * pair_tile + 2 * tile;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t bar[2][2];  // [stage]: k and q; v and do
  __shared__ __align__(8) float lse_s[kMaxTokens];
  __shared__ __align__(8) float d_s[kMaxTokens];

  char* base = aligned_smem(smem_raw);
  const int G = gridDim.x, wg = threadIdx.x / kWgThreads;

  auto issue = [&](int item, int st) {
    const Item it = decode(item, pairs, heads);
    char* ks = base + st * stage;
    char* vs = ks + pair_tile;
    char* qs = vs + pair_tile;
    char* dos = qs + tile;
    mbar_expect_tx(&bar[st][0], pair_tile + tile);
    load_stripe<HDP>(ks, &tm_k, &bar[st][0], pair_rows, it.h, it.pair * 2 * kRows, it.b);
    load_stripe<HDP>(qs, &tm_q, &bar[st][0], rows, it.h, 0, it.b);
    mbar_expect_tx(&bar[st][1], pair_tile + tile);
    load_stripe<HDP>(vs, &tm_v, &bar[st][1], pair_rows, it.h, it.pair * 2 * kRows, it.b);
    load_stripe<HDP>(dos, &tm_do, &bar[st][1], rows, it.h, 0, it.b);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&bar[st][0], 1);
      mbar_init(&bar[st][1], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int st = 0; st < stages; ++st)
      if (blockIdx.x + st * G < n_items) issue(blockIdx.x + st * G, st);

  for (int i = 0;; ++i) {
    const int item = blockIdx.x + i * G;
    if (item >= n_items) break;
    const int st = i % stages, phase = (i / stages) & 1;
    const Item it = decode(item, pairs, heads);
    const char* ks = base + st * stage;
    const long long lrow = ((long long)it.b * heads + it.h) * n_tok;
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      lse_s[r] = r < n_tok ? lse[lrow + r] * kLog2e : INFINITY;
      d_s[r] = r < n_tok ? dsum[lrow + r] : 0.f;
    }
    wgs_sync();  // lse_s and d_s are the item's
    mbar_wait(&bar[st][0], phase);
    mbar_wait(&bar[st][1], phase);
    const int kt = it.pair * 2 + wg;
    const PlainRows lay{n_tok, (long long)it.b * n_tok,
                        ((long long)it.b * heads + it.h) * n_tok};
    if (kt < NC)
      dkdv_strip<HDP, NC>(ks, ks + pair_tile, ks + 2 * pair_tile, ks + 2 * pair_tile + tile,
                          pair_rows, wg * kRows, rows, kt, lay, lse_s, d_s,
                          [&](int which, const auto& acc, float mul, int row0) {
                            store_rows<HDP>(which ? dv : dk, acc, mul, lay, row0, ldo,
                                            it.h * hd, hd);
                          },
                          scale, scale_log2);
    wgs_sync();  // the stage, lse_s and d_s are consumed
    if (threadIdx.x == 0 && item + stages * G < n_items) issue(item + stages * G, st);
  }
}

// ---------------------------------------------------------------------------
// bf16, 256 < T <= 1024: two passes on mma.sync

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           __nv_bfloat16* __restrict__ dq,
                           float* __restrict__ dsum, int n_tok, int heads, int hd,
                           long long ld, long long ldo, float scale, float scale_log2) {
  constexpr int S = HD + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * S];  // q, do, then k
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * S];

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int C = heads * hd;
  const bool busy = q0 + warp * 16 < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const long long dimg = (long long)b * n_tok * C + (long long)h * hd;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_rows<HD>(ks, q + img, q0, n_tok, ld, S, hd);
  __syncthreads();
  load_a<HD>(qa, ks, warp, lane);
  __syncthreads();
  load_rows<HD>(ks, dout + dimg, q0, n_tok, C, S, hd);
  __syncthreads();
  load_a<HD>(da, ks, warp, lane);

  // lse of rows g and g + 8 in log2 units; +inf past n_tok makes P = 0
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < n_tok ? lse[lrow + row] * kLog2e : INFINITY;
  }

  float s[kTile / 8][4], dp[kTile / 8][4];
  // sweep 1: D = sum_k P * dp (each thread sums its own columns)
  float D[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    __syncthreads();
    load_rows<HD>(ks, k + img, k0, n_tok, ld, S, hd);
    load_rows<HD>(vs, v + img, k0, n_tok, ld, S, hd);
    __syncthreads();
    if (!busy) continue;
    tile_scores<HD>(s, qa, ks, lane, k0, n_tok, scale_log2);
    tile_dot<HD>(dp, da, vs, lane);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        D[e >> 1] += round_bf16(exp2f(s[n][e] - lse2[e >> 1])) * dp[n][e];
  }
  D[0] = quad_sum(D[0]);
  D[1] = quad_sum(D[1]);

  // sweep 2: ds = P * dp - P * D rounded to bf16, dq += ds k
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    __syncthreads();
    load_rows<HD>(ks, k + img, k0, n_tok, ld, S, hd);
    load_rows<HD>(vs, v + img, k0, n_tok, ld, S, hd);
    __syncthreads();
    if (!busy) continue;
    tile_scores<HD>(s, qa, ks, lane, k0, n_tok, scale_log2);
    tile_dot<HD>(dp, da, vs, lane);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = round_bf16(exp2f(s[n][e] - lse2[e >> 1]));
        const float pdp = p * dp[n][e];
        s[n][e] = round_bf16(pdp - p * D[e >> 1]);
      }
    uint32_t a[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) pack_a(a[j], s, j);
    tile_product<HD>(acc, a, ks, lane);
  }

  if (!busy) return;
  store_rows<HD>(dq + (long long)h * hd, acc, scale, (long long)b * n_tok,
                 q0 + warp * 16, n_tok, ldo, lane, hd);
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < n_tok) dsum[lrow + row] = D[r];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int n_tok,
                             int heads, int hd, long long ld, long long ldo, float scale,
                             float scale_log2) {
  constexpr int S = HD + 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * S];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * S];
  __shared__ float lse_s[kTile];  // log2 units, +inf past n_tok
  __shared__ float d_s[kTile];

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int C = heads * hd;
  const bool busy = k0 + warp * 16 < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const long long dimg = (long long)b * n_tok * C + (long long)h * hd;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  // A fragments of this warp's 16 key rows of k and of v
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_rows<HD>(qs, k + img, k0, n_tok, ld, S, hd);
  load_rows<HD>(dos, v + img, k0, n_tok, ld, S, hd);
  __syncthreads();
  load_a<HD>(ka, qs, warp, lane);
  load_a<HD>(va, dos, warp, lane);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  float p[kTile / 8][4], dp[kTile / 8][4];
  uint32_t a[kTile / 16][4];
  for (int q0 = 0; q0 < n_tok; q0 += kTile) {
    __syncthreads();
    load_rows<HD>(qs, q + img, q0, n_tok, ld, S, hd);
    load_rows<HD>(dos, dout + dimg, q0, n_tok, C, S, hd);
    for (int i = threadIdx.x; i < kTile; i += kTcThreads) {
      const int row = q0 + i;
      lse_s[i] = row < n_tok ? lse[lrow + row] * kLog2e : INFINITY;
      d_s[i] = row < n_tok ? dsum[lrow + row] : 0.f;
    }
    __syncthreads();
    if (!busy) continue;
    // P^T: rows are this warp's keys, columns the tile's queries
    tile_dot<HD>(p, ka, qs, lane);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = round_bf16(
            exp2f(p[n][e] * scale_log2 - lse_s[n * 8 + 2 * tq + (e & 1)]));
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) pack_a(a[j], p, j);
    tile_product<HD>(dv_acc, a, dos, lane);  // dv += P^T do
    tile_dot<HD>(dp, va, dos, lane);         // dp^T = v do^T
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pdp = p[n][e] * dp[n][e];
        dp[n][e] = round_bf16(pdp - p[n][e] * d_s[n * 8 + 2 * tq + (e & 1)]);
      }
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) pack_a(a[j], dp, j);
    tile_product<HD>(dk_acc, a, qs, lane);  // dk += ds^T q
  }

  if (!busy) return;
  const long long row_base = (long long)b * n_tok;
  store_rows<HD>(dk + (long long)h * hd, dk_acc, scale, row_base, k0 + warp * 16,
                 n_tok, ldo, lane, hd);
  store_rows<HD>(dv + (long long)h * hd, dv_acc, 1.f, row_base, k0 + warp * 16,
                 n_tok, ldo, lane, hd);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores

template <int HD>
__global__ void __launch_bounds__(kBQ)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ dq,
                            float* __restrict__ dsum, int n_tok, int heads, int hd,
                            long long ld, long long ldo, float scale) {
  constexpr int BK = kTileElems / HD;
  __shared__ __align__(16) float ks[kTileElems];
  __shared__ __align__(16) float vs[kTileElems];

  const int h = blockIdx.y, b = blockIdx.z;
  const int t = blockIdx.x * kBQ + threadIdx.x;
  const bool active = t < n_tok;
  const int C = heads * hd;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const long long drow = ((long long)b * n_tok + t) * C + (long long)h * hd;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  float qr[HD], dor[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active && d < hd ? q[img + (long long)t * ld + d] : 0.f;
    dor[d] = active && d < hd ? dout[drow + d] : 0.f;
  }
  const float l = active ? lse[lrow + t] : 0.f;

  // sweep 1: D = sum_k P * dp
  float D = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += BK) {
    load_tile_f32<HD>(ks, k + img, k0, n_tok, ld, hd);
    load_tile_f32<HD>(vs, v + img, k0, n_tok, ld, hd);
    __syncthreads();
    const int nk = min(BK, n_tok - k0);
    if (active) {
      for (int j = 0; j < nk; ++j) {
        const float p = expf(dot_row<HD>(qr, ks + j * HD) * scale - l);
        D += p * dot_row<HD>(dor, vs + j * HD);
      }
    }
    __syncthreads();
  }

  // sweep 2: ds = P * dp - P * D, dq += ds k
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += BK) {
    load_tile_f32<HD>(ks, k + img, k0, n_tok, ld, hd);
    load_tile_f32<HD>(vs, v + img, k0, n_tok, ld, hd);
    __syncthreads();
    const int nk = min(BK, n_tok - k0);
    if (active) {
      for (int j = 0; j < nk; ++j) {
        const float p = expf(dot_row<HD>(qr, ks + j * HD) * scale - l);
        const float pdp = p * dot_row<HD>(dor, vs + j * HD);
        const float ds = pdp - p * D;
        const float4* k4 = reinterpret_cast<const float4*>(ks + j * HD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 kk = k4[d4];
          acc[4 * d4 + 0] = fmaf(ds, kk.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(ds, kk.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(ds, kk.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(ds, kk.w, acc[4 * d4 + 3]);
        }
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d < hd) dq[((long long)b * n_tok + t) * ldo + (long long)h * hd + d] = acc[d] * scale;
    dsum[lrow + t] = D;
  }
}

constexpr int kBQT = 16;  // query rows per shared tile of the fp32 dk/dv kernel

// dynamic shared memory of the fp32 dk/dv kernel (floats): the block's own
// key rows of k and v (padded: thread t reads row t conflict-free), a tile
// of q and do rows, and their lse and D
template <int HD>
constexpr int dkdv_f32_smem() {
  return 2 * kBQ * (HD + 1) + 2 * kBQT * HD + 2 * kBQT;
}

template <int HD>
__global__ void __launch_bounds__(kBQ)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int n_tok, int heads, int hd, long long ld, long long ldo,
                              float scale) {
  constexpr int P = HD + 1;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                  // kBQT x HD (16-byte aligned first)
  float* dos = qs + kBQT * HD;
  float* kown = dos + kBQT * HD;       // kBQ x P
  float* vown = kown + kBQ * P;
  float* lse_s = vown + kBQ * P;       // kBQT
  float* d_s = lse_s + kBQT;

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kBQ;
  const int t = k0 + threadIdx.x;
  const bool active = t < n_tok;
  const int C = heads * hd;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const long long dimg = (long long)b * n_tok * C + (long long)h * hd;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  for (int e = threadIdx.x; e < kBQ * HD; e += kBQ) {
    const int r = e / HD, c = e - r * HD;
    const int row = k0 + r;
    const bool ok = row < n_tok && c < hd;
    kown[r * P + c] = ok ? k[img + (long long)row * ld + c] : 0.f;
    vown[r * P + c] = ok ? v[img + (long long)row * ld + c] : 0.f;
  }

  float dk_acc[HD], dv_acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  const float* kr = kown + threadIdx.x * P;
  const float* vr = vown + threadIdx.x * P;

  for (int q0 = 0; q0 < n_tok; q0 += kBQT) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBQT * HD; e += kBQ) {
      const int r = e / HD, c = e - r * HD;
      const int row = q0 + r;
      const bool ok = row < n_tok && c < hd;
      qs[e] = ok ? q[img + (long long)row * ld + c] : 0.f;
      dos[e] = ok ? dout[dimg + (long long)row * C + c] : 0.f;
    }
    if (threadIdx.x < kBQT) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < n_tok ? lse[lrow + row] : INFINITY;
      d_s[threadIdx.x] = row < n_tok ? dsum[lrow + row] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int nq = min(kBQT, n_tok - q0);
    for (int j = 0; j < nq; ++j) {
      const float* qj = qs + j * HD;
      const float* dj = dos + j * HD;
      float s0 = 0.f, s1 = 0.f, p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        s0 = fmaf(kr[d], qj[d], s0);
        s1 = fmaf(kr[d + 1], qj[d + 1], s1);
        p0 = fmaf(vr[d], dj[d], p0);
        p1 = fmaf(vr[d + 1], dj[d + 1], p1);
      }
      const float p = expf((s0 + s1) * scale - lse_s[j]);
      const float ds = p * (p0 + p1) - p * d_s[j];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dv_acc[d] = fmaf(p, dj[d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, qj[d], dk_acc[d]);
      }
    }
  }

  if (active) {
    const long long o = ((long long)b * n_tok + t) * ldo + (long long)h * hd;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      if (d < hd) {
        dk[o + d] = dk_acc[d] * scale;
        dv[o + d] = dv_acc[d];
      }
    }
  }
}

// ---------------------------------------------------------------------------

// the four stripe maps of a single-pass kernel: q, k, v and do with their
// box rows (the strip's 64 or the head's whole padded T)
template <int HDP>
bool bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
              const void* dout, int B, int n_tok, int heads, int hd, long long ld,
              int q_rows, int kv_rows) {
  const int C = heads * hd;
  return pdm_hop::stripe_map<HDP>(&m[0], q, B, n_tok, heads, hd, ld, q_rows) &&
         pdm_hop::stripe_map<HDP>(&m[1], k, B, n_tok, heads, hd, ld, kv_rows) &&
         pdm_hop::stripe_map<HDP>(&m[2], v, B, n_tok, heads, hd, ld, kv_rows) &&
         pdm_hop::stripe_map<HDP>(&m[3], dout, B, n_tok, heads, hd, C, q_rows);
}

template <int HDP, int NC>
cudaError_t launch_dq_wgmma(const CUtensorMap (&m)[4], const float* lse, void* dq,
                            float* dsum, int B, int n_tok, int heads, int hd,
                            long long ldo, float scale, cudaStream_t stream) {
  using S = pdm_hop::Stripe<HDP>;
  const int pair_rows = (NC < 2 ? NC : 2) * pdm_hop::kRows;
  const int items = B * heads * ((NC + 1) / 2);
  const int stage = 2 * S::bytes(pair_rows) + 2 * S::bytes(NC * pdm_hop::kRows);
  const pdm_hop::Ring ring = pdm_hop::ring_for(items, stage, 64);
  const int smem = ring.stages * stage + 1024;
  auto kernel = attention_bwd_dq_wgmma_kernel<HDP, NC>;
  cudaError_t err = pdm_hop::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ring.blocks, pdm_hop::kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, static_cast<__nv_bfloat16*>(dq), dsum, items, n_tok,
      heads, hd, scale, scale * kLog2e, ring.stages, ldo);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, void* dq, float* dsum,
                      int B, int n_tok, int heads, int hd, long long ld, long long ldo,
                      float scale, cudaStream_t stream) {
  if (dtype == pdm::kBFloat16 && n_tok <= pdm_hop::kMaxTokens) {
    const int nc = (n_tok + pdm_hop::kRows - 1) / pdm_hop::kRows;
    const int rows = nc * pdm_hop::kRows, pair_rows = (nc < 2 ? nc : 2) * pdm_hop::kRows;
    CUtensorMap m[4];
    if (!bwd_maps<HD>(m, q, k, v, dout, B, n_tok, heads, hd, ld, pair_rows, rows))
      return cudaErrorInvalidValue;
    switch (nc) {
      case 1: return launch_dq_wgmma<HD, 1>(m, lse, dq, dsum, B, n_tok, heads, hd, ldo, scale, stream);
      case 2: return launch_dq_wgmma<HD, 2>(m, lse, dq, dsum, B, n_tok, heads, hd, ldo, scale, stream);
      case 3: return launch_dq_wgmma<HD, 3>(m, lse, dq, dsum, B, n_tok, heads, hd, ldo, scale, stream);
      default: return launch_dq_wgmma<HD, 4>(m, lse, dq, dsum, B, n_tok, heads, hd, ldo, scale, stream);
    }
  } else if (dtype == pdm::kBFloat16) {
    const dim3 grid((n_tok + kTile - 1) / kTile, heads, B);
    attention_bwd_dq_tc_kernel<HD><<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, static_cast<__nv_bfloat16*>(dq), dsum, n_tok, heads, hd, ld, ldo, scale,
        scale * kLog2e);
  } else if (dtype == pdm::kFloat32) {
    const dim3 grid((n_tok + kBQ - 1) / kBQ, heads, B);
    attention_bwd_dq_f32_kernel<HD><<<grid, kBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        static_cast<float*>(dq), dsum, n_tok, heads, hd, ld, ldo, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int HDP, int NC>
cudaError_t launch_dkdv_wgmma(const CUtensorMap (&m)[4], const float* lse,
                              const float* dsum, void* dk, void* dv, int B, int n_tok,
                              int heads, int hd, long long ldo, float scale,
                              cudaStream_t stream) {
  using S = pdm_hop::Stripe<HDP>;
  const int pair_rows = (NC < 2 ? NC : 2) * pdm_hop::kRows;
  const int items = B * heads * ((NC + 1) / 2);
  const int stage = 2 * S::bytes(pair_rows) + 2 * S::bytes(NC * pdm_hop::kRows);
  const pdm_hop::Ring ring =
      pdm_hop::ring_for(items, stage, 2 * pdm_hop::kMaxTokens * 4 + 64);
  const int smem = ring.stages * stage + 1024;
  auto kernel = attention_bwd_dkdv_wgmma_kernel<HDP, NC>;
  cudaError_t err = pdm_hop::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ring.blocks, pdm_hop::kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), items, n_tok, heads, hd, scale, scale * kLog2e,
      ring.stages, ldo);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkdv(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* dsum,
                        void* dk, void* dv, int B, int n_tok, int heads, int hd,
                        long long ld, long long ldo, float scale, cudaStream_t stream) {
  if (dtype == pdm::kBFloat16 && n_tok <= pdm_hop::kMaxTokens) {
    const int nc = (n_tok + pdm_hop::kRows - 1) / pdm_hop::kRows;
    const int rows = nc * pdm_hop::kRows, pair_rows = (nc < 2 ? nc : 2) * pdm_hop::kRows;
    CUtensorMap m[4];
    if (!bwd_maps<HD>(m, q, k, v, dout, B, n_tok, heads, hd, ld, rows, pair_rows))
      return cudaErrorInvalidValue;
    switch (nc) {
      case 1: return launch_dkdv_wgmma<HD, 1>(m, lse, dsum, dk, dv, B, n_tok, heads, hd, ldo, scale, stream);
      case 2: return launch_dkdv_wgmma<HD, 2>(m, lse, dsum, dk, dv, B, n_tok, heads, hd, ldo, scale, stream);
      case 3: return launch_dkdv_wgmma<HD, 3>(m, lse, dsum, dk, dv, B, n_tok, heads, hd, ldo, scale, stream);
      default: return launch_dkdv_wgmma<HD, 4>(m, lse, dsum, dk, dv, B, n_tok, heads, hd, ldo, scale, stream);
    }
  } else if (dtype == pdm::kBFloat16) {
    const dim3 grid((n_tok + kTile - 1) / kTile, heads, B);
    attention_bwd_dkdv_tc_kernel<HD><<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, dsum, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        n_tok, heads, hd, ld, ldo, scale, scale * kLog2e);
  } else if (dtype == pdm::kFloat32) {
    const dim3 grid((n_tok + kBQ - 1) / kBQ, heads, B);
    const int smem = dkdv_f32_smem<HD>() * 4;
    auto kernel = attention_bwd_dkdv_f32_kernel<HD>;
    cudaError_t err = pdm_hop::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBQ, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
        static_cast<float*>(dk), static_cast<float*>(dv), n_tok, heads, hd, ld, ldo, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, T, heads*hd) rows `ld` elements apart; dout: contiguous
// (B, T, heads*hd) of the same dtype; lse: contiguous (B, heads, T) fp32
// from the forward. Writes dq (q's dtype, token rows `ldo` elements apart:
// heads*hd for a contiguous dq, 3 heads*hd for the dq third of a (B, T,
// 3C) dqkv) and dsum, the row sums D (B, heads, T) fp32 that
// pdm_attention_bwd_dkdv reads. dtype:
// pdm::kFloat32 or pdm::kBFloat16 (bf16: 16-byte aligned stripes, ld a
// multiple of 8). hd: a multiple of 8 up to 128. Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported argument or
// a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int pdm_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, void* dq,
                                    void* dsum, int B, int n_tok, int heads,
                                    int hd, long long ld, long long ldo, float scale,
                                    int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* D = static_cast<float*>(dsum);
  cudaError_t err;
  if (hd < 8 || hd > 128 || hd % 8) {
    err = cudaErrorInvalidValue;
  } else if (hd <= 16) {
    err = launch_dq<16>(dtype, q, k, v, dout, l, dq, D, B, n_tok, heads, hd, ld, ldo, scale, s);
  } else if (hd <= 32) {
    err = launch_dq<32>(dtype, q, k, v, dout, l, dq, D, B, n_tok, heads, hd, ld, ldo, scale, s);
  } else if (hd <= 64) {
    err = launch_dq<64>(dtype, q, k, v, dout, l, dq, D, B, n_tok, heads, hd, ld, ldo, scale, s);
  } else {
    err = launch_dq<128>(dtype, q, k, v, dout, l, dq, D, B, n_tok, heads, hd, ld, ldo, scale, s);
  }
  return static_cast<int>(err);
}

// As pdm_attention_bwd_dq, reading its dsum; writes dk and dv (q's dtype,
// token rows `ldo` elements apart).
extern "C" int pdm_attention_bwd_dkdv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dsum,
                                      void* dk, void* dv, int B, int n_tok,
                                      int heads, int hd, long long ld, long long ldo,
                                      float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* D = static_cast<const float*>(dsum);
  cudaError_t err;
  if (hd < 8 || hd > 128 || hd % 8) {
    err = cudaErrorInvalidValue;
  } else if (hd <= 16) {
    err = launch_dkdv<16>(dtype, q, k, v, dout, l, D, dk, dv, B, n_tok, heads, hd, ld, ldo, scale, s);
  } else if (hd <= 32) {
    err = launch_dkdv<32>(dtype, q, k, v, dout, l, D, dk, dv, B, n_tok, heads, hd, ld, ldo, scale, s);
  } else if (hd <= 64) {
    err = launch_dkdv<64>(dtype, q, k, v, dout, l, D, dk, dv, B, n_tok, heads, hd, ld, ldo, scale, s);
  } else {
    err = launch_dkdv<128>(dtype, q, k, v, dout, l, D, dk, dv, B, n_tok, heads, hd, ld, ldo, scale, s);
  }
  return static_cast<int>(err);
}
