// The whole attention block, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/attention_block.py::_bwd_kernel
// (launched by _fab_bwd). Same function and rounding points, from h, the
// weights and biases, the forward's per-head lse and the cotangent do
// (already in the input dtype):
//   q, k, v  recomputed as the forward does (rounded once)
//   datt     = do W_out, rounded
//   att      recomputed as the forward does (normalized P, rounded)
//   dW_out   = do^T att (fp32)
//   P = exp(q k^T scale - lse) rounded, dv = P^T datt, dp = datt v^T,
//   ds = P dp - P sum_k(P dp) rounded, dq = ds k scale, dk = ds^T q scale
//   dqkv     = (dq, dk, dv) rounded to the input dtype
//   dh       = dqkv W_qkv, dW_qkv = dqkv^T h, db_qkv = sum dqkv (fp32)
// Products accumulate in fp32. db_out is not here: the wrapper sums the
// unrounded cotangent (the JAX package ignores the kernel's own).
//
// What bounds it on the H100: at the flagship's B = 128, T = 256, C = 256
// in bf16 the three kernels must read h, do and lse and write dh (~34 MB
// at first sight) and do ~77 GFLOP (qkv and datt recomputed 4 B T C^2 x 2,
// the attention forward 4 B T^2 C, its VJP 8 B T^2 C, dh 6 B T C^2, the
// weight gradients 8 B T C^2): ~0.08 ms at the bf16 tensor-core peak, so
// bound by operations. The per-image results dqkv (B T 3C) and att
// (B T C) go to device memory once and are read once by the weight
// gradients, ~67 MB more at this shape.
//
// Design. The TPU kernel accumulates the weight gradients in one fp32
// block that every program of its sequential grid adds into; here blocks
// run in parallel and nothing carries over between them, so three kernels:
//  1. per image one cluster, one block per head (as the forward): block j
//     recomputes q_j, k_j, v_j and datt_j = do W_out[:, j cols] into shared
//     memory (streamed through the cp.async ring), recomputes att_j (to
//     device memory), runs the attention VJP from shared memory (dq and the
//     row sums D by query strips, then dk and dv by key strips, as row 2)
//     and writes its dqkv columns; after a cluster barrier it computes dh's
//     columns [j HD, (j+1) HD) = dqkv W_qkv[:, j cols], streaming every
//     head's dqkv back through L2 (they are in device memory for kernel 2
//     anyway, so no accumulator waits in shared memory for its peers);
//  2. a split-K product over the B T rows: block (output tile of 64 x 64,
//     row chunk) computes its chunk's dW_qkv / dW_out tile (and, for the
//     first column tile, db_qkv's column sums) into its own fp32 partials
//     slice;
//  3. a merge that adds the chunks' partials in a fixed order and writes
//     the gradients in the parameters' dtypes.
// No atomics: the result is deterministic.
//
// bf16 (the main path) runs on the tensor cores (mma.sync m16n8k16);
// fp32 (parity runs) on the CUDA cores, thread t owning token row t, with
// q and datt parked in a (B, T, 2C) fp32 scratch that the dk/dv sweep
// reads in tiles (a head's q, k, v and datt do not fit a block's shared
// memory in fp32).

#include "attention_block_common.cuh"

namespace {

using namespace pdm_block;
using bf = __nv_bfloat16;

// ---------------------------------------------------------------------------
// kernel 1, bf16: tensor cores

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_block_bwd_tc_kernel(const bf* __restrict__ h, const bf* wq, const bf* wk, const bf* wv,
                              const void* bq, const void* bk, const void* bv, const bf* wout,
                              const float* __restrict__ lse, const bf* __restrict__ dout, bf* dqkv,
                              bf* __restrict__ att, bf* __restrict__ dh, int n_tok, int heads,
                              float scale, float scale_log2, int bias_bf16) {
  constexpr int S = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int C = heads * HD;
  const int tp = round_up(n_tok, kTile);
  const int n_strips = (n_tok + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  bf* qs = reinterpret_cast<bf*>(smem_raw);
  bf* ks = qs + tile_elems(tp, HD);
  bf* vs = ks + tile_elems(tp, HD);
  bf* das = vs + tile_elems(tp, HD);
  bf* ring = das + tile_elems(tp, HD);
  float* lse_s = reinterpret_cast<float*>(ring + ring_elems(tp, HD));  // log2 units
  float* d_s = lse_s + tp;
  const long long img = (long long)b * n_tok * C;
  const long long img3 = 3 * img;
  const long long lrow = ((long long)b * heads + j) * n_tok;

  bf* const qkv[3] = {qs, ks, vs};
  const bf* const w[3] = {wq, wk, wv};
  const void* const bias[3] = {bq, bk, bv};
  project_qkv<HD>(qkv, h + img, w, bias, bias_bf16, j, n_tok, C, tp, ring);

  {  // datt_j = do W_out[:, j cols], rounded
    Acc<HD> acc;
    zero<HD>(acc);
    stream_gemm<HD, false>(acc, dout + img, C, n_tok, n_strips, stack1(wout, C, C), j * HD, C,
                           ring, tp);
    for_each_pair<HD>(acc, n_strips, [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(das + row * S + col) = pack_bf16(v0, v1);
    });
    zero_rows<HD>(das, n_strips * 16, tp);
  }
  for (int r = threadIdx.x; r < tp; r += kThreads) {
    lse_s[r] = r < n_tok ? lse[lrow + r] * kLog2e : INFINITY;  // P = 0 past T
    d_s[r] = 0.f;
  }
  __syncthreads();

  // att_j recomputed as the forward, to device memory for dW_out
#pragma unroll 1
  for (int s = 0; s < kStrips; ++s) {
    const int strip = warp + s * kWarps;
    if (strip >= n_strips) continue;
    float o[HD / 8][4], m[2], l[2];
    attend_strip<HD>(o, m, l, qs, ks, vs, strip, n_tok, scale_log2);
    store_rows<HD>(att + j * HD, o, 1.f, (long long)b * n_tok, strip * 16, n_tok, C, lane);
  }

  // dq and D by query strips (row 2's dq kernel, operands resident)
  float sc[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll 1
  for (int s = 0; s < kStrips; ++s) {
    const int strip = warp + s * kWarps;
    if (strip >= n_strips) continue;
    uint32_t qa[HD / 16][4], da[HD / 16][4];
    load_a<HD>(qa, qs, strip, lane);
    load_a<HD>(da, das, strip, lane);
    float lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lse2[r] = lse_s[strip * 16 + g + 8 * r];
    float D[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < n_tok; k0 += kTile) {
      tile_scores<HD>(sc, qa, ks + k0 * S, lane, k0, n_tok, scale_log2);
      tile_dot<HD>(dp, da, vs + k0 * S, lane);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          D[e >> 1] += round_bf16(exp2f(sc[n][e] - lse2[e >> 1])) * dp[n][e];
    }
    D[0] = quad_sum(D[0]);
    D[1] = quad_sum(D[1]);
    float acc[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    for (int k0 = 0; k0 < n_tok; k0 += kTile) {
      tile_scores<HD>(sc, qa, ks + k0 * S, lane, k0, n_tok, scale_log2);
      tile_dot<HD>(dp, da, vs + k0 * S, lane);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = round_bf16(exp2f(sc[n][e] - lse2[e >> 1]));
          sc[n][e] = round_bf16(p * dp[n][e] - p * D[e >> 1]);
        }
      uint32_t a[kTile / 16][4];
#pragma unroll
      for (int jj = 0; jj < kTile / 16; ++jj) pack_a(a[jj], sc, jj);
      tile_product<HD>(acc, a, ks + k0 * S, lane);
    }
    store_rows<HD>(dqkv + j * HD, acc, scale, (long long)b * n_tok, strip * 16, n_tok, 3 * C,
                   lane);
    if (tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = strip * 16 + g + 8 * r;
        if (row < n_tok) d_s[row] = D[r];
      }
    }
  }
  __syncthreads();

  // dk and dv by key strips (row 2's dk/dv kernel, operands resident)
#pragma unroll 1
  for (int s = 0; s < kStrips; ++s) {
    const int strip = warp + s * kWarps;
    if (strip >= n_strips) continue;
    uint32_t ka[HD / 16][4], va[HD / 16][4];
    load_a<HD>(ka, ks, strip, lane);
    load_a<HD>(va, vs, strip, lane);
    float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;
    uint32_t a[kTile / 16][4];
    for (int q0 = 0; q0 < n_tok; q0 += kTile) {
      tile_dot<HD>(sc, ka, qs + q0 * S, lane);  // P^T: the strip's keys x the tile's queries
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = round_bf16(
              exp2f(sc[n][e] * scale_log2 - lse_s[q0 + n * 8 + 2 * tq + (e & 1)]));
#pragma unroll
      for (int jj = 0; jj < kTile / 16; ++jj) pack_a(a[jj], sc, jj);
      tile_product<HD>(dv_acc, a, das + q0 * S, lane);  // dv += P^T datt
      tile_dot<HD>(dp, va, das + q0 * S, lane);         // dp^T = v datt^T
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sc[n][e];
          dp[n][e] = round_bf16(p * dp[n][e] - p * d_s[q0 + n * 8 + 2 * tq + (e & 1)]);
        }
#pragma unroll
      for (int jj = 0; jj < kTile / 16; ++jj) pack_a(a[jj], dp, jj);
      tile_product<HD>(dk_acc, a, qs + q0 * S, lane);  // dk += ds^T q
    }
    const long long row_base = (long long)b * n_tok;
    store_rows<HD>(dqkv + C + j * HD, dk_acc, scale, row_base, strip * 16, n_tok, 3 * C, lane);
    store_rows<HD>(dqkv + 2 * C + j * HD, dv_acc, 1.f, row_base, strip * 16, n_tok, 3 * C,
                   lane);
  }

  // every head's dqkv is in device memory: dh's columns of head j
  __threadfence();
  cluster.sync();
  {
    Stack<bf> wqkv;
    wqkv.p[0] = wq;
    wqkv.p[1] = wk;
    wqkv.p[2] = wv;
    wqkv.part = C;
    wqkv.ld = C;
    Acc<HD> acc;
    zero<HD>(acc);
    stream_gemm<HD, false>(acc, dqkv + img3, 3 * C, n_tok, n_strips, wqkv, j * HD, 3 * C, ring,
                           tp);
    for_each_pair<HD>(acc, n_strips, [&](int row, int col, float v0, float v1) {
      if (row < n_tok)
        *reinterpret_cast<uint32_t*>(dh + img + (long long)row * C + j * HD + col) =
            pack_bf16(v0, v1);
    });
  }
}

// ---------------------------------------------------------------------------
// kernel 1, fp32: CUDA cores

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_block_bwd_f32_kernel(const float* __restrict__ h, const float* wq, const float* wk,
                               const float* wv, const void* bq, const void* bk, const void* bv,
                               const float* wout, const float* __restrict__ lse,
                               const float* __restrict__ dout, float* dqkv, float* __restrict__ att,
                               float* __restrict__ dh, float* scratch, int n_tok, int heads,
                               float scale, int bias_bf16) {
  constexpr int P = HD + 1;  // thread-owned rows: an odd stride, no bank conflicts
  constexpr int kQT = 16;    // query rows per tile of the dk/dv sweep
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // n_tok x P
  float* vs = ks + n_tok * P;
  float* wc = vs + n_tok * P;                       // kKT x HD
  float* qt = wc + kKT * HD;                        // kQT x HD
  float* dt = qt + kQT * HD;
  float* lse_s = dt + kQT * HD;
  float* d_s = lse_s + n_tok;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int C = heads * HD;
  const int t = threadIdx.x;
  const bool active = t < n_tok;
  const int tr = active ? t : 0;
  const long long img = (long long)b * n_tok * C;
  const long long img3 = 3 * img;
  // scratch row t of image b: q_j at columns j HD.., datt_j at C + j HD..
  float* srow = scratch + 2 * img + (long long)tr * 2 * C + j * HD;

  float acc[HD];
  const float* const w[3] = {wq, wk, wv};
  const void* const bias[3] = {bq, bk, bv};
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    row_gemm_f32<HD, true>(acc, h + img + (long long)tr * C, active,
                           stack1(w[p] + (long long)j * HD * C, HD, C), 0, C, wc);
    if (!active) continue;
#pragma unroll
    for (int n = 0; n < HD; ++n) {
      const float v = acc[n] + load_bias(bias[p], j * HD + n, bias_bf16);
      if (p == 0) srow[n] = v;
      else (p == 1 ? ks : vs)[t * P + n] = v;
    }
  }
  row_gemm_f32<HD, false>(acc, dout + img + (long long)tr * C, active, stack1(wout, C, C),
                          j * HD, C, wc);
  if (active) {
#pragma unroll
    for (int n = 0; n < HD; ++n) srow[C + n] = acc[n];
    lse_s[t] = lse[((long long)b * heads + j) * n_tok + t];
  }
  __syncthreads();

  if (active) {
    float qr[HD], dar[HD];
#pragma unroll
    for (int n = 0; n < HD; ++n) qr[n] = srow[n];
    // att_t recomputed as the forward
    attend_row_f32<HD>(acc, qr, ks, vs, P, n_tok, scale);
#pragma unroll
    for (int n = 0; n < HD; ++n) att[img + (long long)t * C + j * HD + n] = acc[n];
#pragma unroll
    for (int n = 0; n < HD; ++n) dar[n] = srow[C + n];
    const float l = lse_s[t];
    float D = 0.f;
    for (int k = 0; k < n_tok; ++k) {
      const float p = expf(dot_f32<HD>(qr, ks + k * P) * scale - l);
      D += p * dot_f32<HD>(dar, vs + k * P);
    }
#pragma unroll
    for (int n = 0; n < HD; ++n) acc[n] = 0.f;
    for (int k = 0; k < n_tok; ++k) {
      const float* kr = ks + k * P;
      const float p = expf(dot_f32<HD>(qr, kr) * scale - l);
      const float ds = p * dot_f32<HD>(dar, vs + k * P) - p * D;
#pragma unroll
      for (int n = 0; n < HD; ++n) acc[n] = fmaf(ds, kr[n], acc[n]);
    }
#pragma unroll
    for (int n = 0; n < HD; ++n) dqkv[img3 + (long long)t * 3 * C + j * HD + n] = acc[n] * scale;
    d_s[t] = D;
  }
  __syncthreads();

  // dk, dv of key row t over query tiles of q and datt from the scratch
  float dk_acc[HD], dv_acc[HD];
#pragma unroll
  for (int n = 0; n < HD; ++n) dk_acc[n] = dv_acc[n] = 0.f;
  const float* kr = ks + tr * P;
  const float* vr = vs + tr * P;
  for (int q0 = 0; q0 < n_tok; q0 += kQT) {
    const int nq = min(kQT, n_tok - q0);
    __syncthreads();
    for (int e = threadIdx.x; e < nq * HD; e += kThreads) {
      const int r = e / HD, c = e - r * HD;
      const float* src = scratch + 2 * img + (long long)(q0 + r) * 2 * C + j * HD + c;
      qt[e] = __ldcg(src);
      dt[e] = __ldcg(src + C);
    }
    __syncthreads();
    if (!active) continue;
    for (int jj = 0; jj < nq; ++jj) {
      const float* qj = qt + jj * HD;
      const float* dj = dt + jj * HD;
      float s0 = 0.f, s1 = 0.f, p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        s0 = fmaf(kr[d], qj[d], s0);
        s1 = fmaf(kr[d + 1], qj[d + 1], s1);
        p0 = fmaf(vr[d], dj[d], p0);
        p1 = fmaf(vr[d + 1], dj[d + 1], p1);
      }
      const float p = expf((s0 + s1) * scale - lse_s[q0 + jj]);
      const float ds = p * (p0 + p1) - p * d_s[q0 + jj];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dv_acc[d] = fmaf(p, dj[d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, qj[d], dk_acc[d]);
      }
    }
  }
  if (active) {
    float* o = dqkv + img3 + (long long)t * 3 * C + j * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      o[C + d] = dk_acc[d] * scale;
      o[2 * C + d] = dv_acc[d];
    }
  }

  // every head's dqkv is in device memory: dh's columns of head j
  __threadfence();
  cluster.sync();
  Stack<float> wqkv;
  wqkv.p[0] = wq;
  wqkv.p[1] = wk;
  wqkv.p[2] = wv;
  wqkv.part = C;
  wqkv.ld = C;
  row_gemm_f32<HD, false>(acc, dqkv + img3 + (long long)tr * 3 * C, active, wqkv, j * HD,
                          3 * C, wc);
  if (active) {
#pragma unroll
    for (int n = 0; n < HD; ++n) dh[img + (long long)t * C + j * HD + n] = acc[n];
  }
}

// ---------------------------------------------------------------------------
// kernels 2 and 3: the weight and bias gradients
//
// Output rows o of the stacked (4C x C) weight gradient: [0, 3C) are
// dW_q, dW_k, dW_v (G = dqkv, H = h), [3C, 4C) dW_out (G = do, H = att);
// the tile of rows o0.. and columns c0.. over a row chunk r of the B T
// rows is sum_r G[r, o] H[r, c]. A chunk's partials: the 4C x C tile
// sums, then db_qkv's 3C column sums of dqkv.

constexpr int kWT = 64;        // output tile edge
constexpr int kWR = 32;        // rows per stage (bf16)
constexpr int kWS = kWT + 8;   // shared row stride (bf16)
constexpr int kWThreads = 128;

struct WgradTile {
  const void* g;
  const void* h;
  int ldg, o0, o_lim, o_out, c0;
  bool sums;
};

__device__ __forceinline__ WgradTile wgrad_tile(const void* h, const void* dout,
                                                const void* dqkv, const void* att, int C) {
  const int nq = (3 * C + kWT - 1) / kWT;
  const bool qkv = static_cast<int>(blockIdx.y) < nq;
  WgradTile t;
  t.g = qkv ? dqkv : dout;
  t.h = qkv ? h : att;
  t.ldg = qkv ? 3 * C : C;
  t.o0 = (qkv ? blockIdx.y : blockIdx.y - nq) * kWT;
  t.o_lim = qkv ? 3 * C : C;
  t.o_out = qkv ? 0 : 3 * C;  // row offset in the stacked gradient
  t.c0 = blockIdx.x * kWT;
  t.sums = qkv && blockIdx.x == 0;
  return t;
}

__global__ void __launch_bounds__(kWThreads)
attention_block_wgrad_tc_kernel(const bf* h, const bf* dout, const bf* dqkv, const bf* att,
                                float* __restrict__ partials, int R, int C, int rows_per_chunk) {
  __shared__ __align__(16) bf gs[2][kWR * kWS];
  __shared__ __align__(16) bf hs[2][kWR * kWS];
  const WgradTile tile = wgrad_tile(h, dout, dqkv, att, C);
  const bf* G = static_cast<const bf*>(tile.g);
  const bf* H = static_cast<const bf*>(tile.h);
  const int r_begin = blockIdx.z * rows_per_chunk;
  const int r_end = min(R, r_begin + rows_per_chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  auto load = [&](int r0, int buf) {
    for (int e = threadIdx.x; e < kWR * (kWT / 8); e += kWThreads) {
      const int r = e / (kWT / 8), c = (e - r * (kWT / 8)) * 8;
      const int row = r0 + r;
      const bool ok_g = row < r_end && tile.o0 + c < tile.o_lim;
      const bool ok_h = row < r_end && tile.c0 + c < C;
      cp_async16(gs[buf] + r * kWS + c, ok_g ? G + (long long)row * tile.ldg + tile.o0 + c : G,
                 ok_g);
      cp_async16(hs[buf] + r * kWS + c, ok_h ? H + (long long)row * C + tile.c0 + c : H, ok_h);
    }
  };

  float acc[kWT / 8][4];
#pragma unroll
  for (int n = 0; n < kWT / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float colsum = 0.f;
  const int n_t = r_end > r_begin ? (r_end - r_begin + kWR - 1) / kWR : 0;
  if (n_t > 0) {
    load(r_begin, 0);
    cp_async_commit();
  }
  for (int it = 0; it < n_t; ++it) {
    if (it + 1 < n_t) {
      load(r_begin + (it + 1) * kWR, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf* gb = gs[it & 1];
    const bf* hb = hs[it & 1];
#pragma unroll
    for (int kk = 0; kk < kWR / 16; ++kk) {
      // A = G^T (o x r): ldmatrix.trans of the (r x o) tile
      uint32_t a[4];
      ldsm_x4_trans(a, gb + (kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kWS + warp * 16 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int dp = 0; dp < kWT / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, hb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kWS + dp * 16 +
                              (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
        mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    if (tile.sums && threadIdx.x < kWT) {
      for (int r = 0; r < kWR; ++r) colsum += __bfloat162float(gb[r * kWS + threadIdx.x]);
    }
    __syncthreads();
  }

  float* part = partials + (long long)blockIdx.z * (4LL * C * C + 3 * C);
#pragma unroll
  for (int n = 0; n < kWT / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = tile.o0 + warp * 16 + g + 8 * (e >> 1);
      const int c = tile.c0 + n * 8 + 2 * tq + (e & 1);
      if (o < tile.o_lim && c < C) part[(long long)(tile.o_out + o) * C + c] = acc[n][e];
    }
  }
  if (tile.sums && threadIdx.x < kWT && tile.o0 + threadIdx.x < tile.o_lim)
    part[4LL * C * C + tile.o0 + threadIdx.x] = colsum;
}

constexpr int kWF = 16;  // rows per stage (fp32)

__global__ void __launch_bounds__(256)
attention_block_wgrad_f32_kernel(const float* h, const float* dout, const float* dqkv,
                                 const float* att, float* __restrict__ partials, int R, int C,
                                 int rows_per_chunk) {
  __shared__ float gs[kWF * kWT];
  __shared__ float hs[kWF * kWT];
  const WgradTile tile = wgrad_tile(h, dout, dqkv, att, C);
  const float* G = static_cast<const float*>(tile.g);
  const float* H = static_cast<const float*>(tile.h);
  const int r_begin = blockIdx.z * rows_per_chunk;
  const int r_end = min(R, r_begin + rows_per_chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  float colsum = 0.f;
  for (int r0 = r_begin; r0 < r_end; r0 += kWF) {
    for (int e = threadIdx.x; e < kWF * kWT; e += 256) {
      const int r = e / kWT, c = e - r * kWT;
      const int row = r0 + r;
      gs[e] = row < r_end && tile.o0 + c < tile.o_lim
                  ? G[(long long)row * tile.ldg + tile.o0 + c] : 0.f;
      hs[e] = row < r_end && tile.c0 + c < C ? H[(long long)row * C + tile.c0 + c] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kWF; ++r) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = gs[r * kWT + ty * 4 + i];
        bv[i] = hs[r * kWT + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
    }
    if (tile.sums && threadIdx.x < kWT)
      for (int r = 0; r < kWF; ++r) colsum += gs[r * kWT + threadIdx.x];
    __syncthreads();
  }
  float* part = partials + (long long)blockIdx.z * (4LL * C * C + 3 * C);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = tile.o0 + ty * 4 + i, c = tile.c0 + tx * 4 + k;
      if (o < tile.o_lim && c < C) part[(long long)(tile.o_out + o) * C + c] = acc[i][k];
    }
  if (tile.sums && threadIdx.x < kWT && tile.o0 + threadIdx.x < tile.o_lim)
    part[4LL * C * C + tile.o0 + threadIdx.x] = colsum;
}

__device__ __forceinline__ void store_as(void* dst, long long i, float v, int as_bf16) {
  if (as_bf16) static_cast<bf*>(dst)[i] = __float2bfloat16(v);
  else static_cast<float*>(dst)[i] = v;
}

__global__ void __launch_bounds__(256)
attention_block_wgrad_merge_kernel(const float* __restrict__ partials, void* dwq, void* dwk,
                                   void* dwv, void* dwout, void* dbq, void* dbk, void* dbv, int C,
                                   int n_chunks, int w_bf16, int b_bf16) {
  const long long cc = (long long)C * C;
  const long long stride = 4 * cc + 3 * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < stride;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_chunks; ++k) s += partials[k * stride + i];
    if (i < 4 * cc) {
      const int part = static_cast<int>(i / cc);
      void* dst = part == 0 ? dwq : part == 1 ? dwk : part == 2 ? dwv : dwout;
      store_as(dst, i - part * cc, s, w_bf16);
    } else {
      const long long k = i - 4 * cc;
      const int part = static_cast<int>(k / C);
      store_as(part == 0 ? dbq : part == 1 ? dbk : dbv, k - part * C, s, b_bf16);
    }
  }
}

// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_bwd(int dtype, const void* h, const void* wq, const void* wk, const void* wv,
                       const void* bq, const void* bk, const void* bv, const void* wout,
                       const float* lse, const void* dout, void* dqkv, void* att, void* dh,
                       void* scratch, int B, int n_tok, int heads, float scale, int bias_bf16,
                       cudaStream_t stream) {
  if (n_tok < 1 || n_tok > kMaxTok || heads < 1 || heads > 8 || B < 1)
    return cudaErrorInvalidValue;
  if (dtype == pdm::kBFloat16) {
    const int tp = round_up(n_tok, kTile);
    const int smem = (4 * tile_elems(tp, HD) + ring_elems(tp, HD)) * 2 + 2 * tp * 4;
    return launch_cluster(attention_block_bwd_tc_kernel<HD>, heads, B, smem, stream,
                          static_cast<const bf*>(h), static_cast<const bf*>(wq),
                          static_cast<const bf*>(wk), static_cast<const bf*>(wv), bq, bk, bv,
                          static_cast<const bf*>(wout), lse, static_cast<const bf*>(dout),
                          static_cast<bf*>(dqkv), static_cast<bf*>(att), static_cast<bf*>(dh),
                          n_tok, heads, scale, scale * kLog2e, bias_bf16);
  }
  if (dtype == pdm::kFloat32) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const int smem = (2 * n_tok * (HD + 1) + kKT * HD + 2 * 16 * HD + 2 * n_tok) * 4;
    return launch_cluster(attention_block_bwd_f32_kernel<HD>, heads, B, smem, stream,
                          static_cast<const float*>(h), static_cast<const float*>(wq),
                          static_cast<const float*>(wk), static_cast<const float*>(wv), bq, bk,
                          bv, static_cast<const float*>(wout), lse,
                          static_cast<const float*>(dout), static_cast<float*>(dqkv),
                          static_cast<float*>(att), static_cast<float*>(dh),
                          static_cast<float*>(scratch), n_tok, heads, scale, bias_bf16);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel 1. h, dout (the cotangent in h's dtype): contiguous (B, T, C);
// wq, wk, wv, wout: contiguous (C, C) nn.Linear weights of h's dtype;
// bq, bk, bv: (C,) of bias_dtype; lse: (B, heads, T) fp32 from the
// forward. Writes dqkv (B, T, 3C), att (B, T, C) and dh (B, T, C) in h's
// dtype. fp32 needs scratch, a (B, T, 2C) fp32 buffer (bf16: unused).
// hd: 16, 32 or 64; heads <= 8; T <= 256. Returns the launch's CUDA error.
extern "C" int pdm_attention_block_bwd(const void* h, const void* wq, const void* wk,
                                       const void* wv, const void* bq, const void* bk,
                                       const void* bv, const void* wout, const void* lse,
                                       const void* dout, void* dqkv, void* att, void* dh,
                                       void* scratch, int B, int n_tok, int heads, int hd,
                                       float scale, int dtype, int bias_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  const int bb = bias_dtype == pdm::kBFloat16;
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_bwd<16>(dtype, h, wq, wk, wv, bq, bk, bv, wout, l, dout, dqkv, att, dh, scratch, B, n_tok, heads, scale, bb, s); break;
    case 32: err = launch_bwd<32>(dtype, h, wq, wk, wv, bq, bk, bv, wout, l, dout, dqkv, att, dh, scratch, B, n_tok, heads, scale, bb, s); break;
    case 64: err = launch_bwd<64>(dtype, h, wq, wk, wv, bq, bk, bv, wout, l, dout, dqkv, att, dh, scratch, B, n_tok, heads, scale, bb, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Kernel 2. The (4C x C) weight-gradient partials and db_qkv's column
// sums of each of n_chunks row chunks of the R = B T rows into partials
// (n_chunks, 4 C C + 3 C) fp32, from kernel 1's dqkv and att, h and dout.
extern "C" int pdm_attention_block_wgrad(const void* h, const void* dout, const void* dqkv,
                                         const void* att, void* partials, int R, int C,
                                         int n_chunks, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 8 || C % 8 || n_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per = round_up((R + n_chunks - 1) / n_chunks, kWR);
  const dim3 grid((C + kWT - 1) / kWT, (3 * C + kWT - 1) / kWT + (C + kWT - 1) / kWT, n_chunks);
  auto* out = static_cast<float*>(partials);
  if (dtype == pdm::kBFloat16) {
    attention_block_wgrad_tc_kernel<<<grid, kWThreads, 0, s>>>(
        static_cast<const bf*>(h), static_cast<const bf*>(dout), static_cast<const bf*>(dqkv),
        static_cast<const bf*>(att), out, R, C, per);
  } else if (dtype == pdm::kFloat32) {
    attention_block_wgrad_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(dout),
        static_cast<const float*>(dqkv), static_cast<const float*>(att), out, R, C, per);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3. Sums kernel 2's partials over the chunks in order and writes
// dW_q, dW_k, dW_v, dW_out ((C, C), w_dtype) and db_q, db_k, db_v ((C,),
// b_dtype).
extern "C" int pdm_attention_block_wgrad_merge(const void* partials, void* dwq, void* dwk,
                                               void* dwv, void* dwout, void* dbq, void* dbk,
                                               void* dbv, int C, int n_chunks, int w_dtype,
                                               int b_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long n = 4LL * C * C + 3 * C;
  const int blocks = static_cast<int>((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  attention_block_wgrad_merge_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(partials), dwq, dwk, dwv,
                                            dwout, dbq, dbk, dbv, C, n_chunks,
                                            w_dtype == pdm::kBFloat16,
                                            b_dtype == pdm::kBFloat16);
  return static_cast<int>(cudaGetLastError());
}
