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
//  1. per group of images one cluster, one block per head j (the forward's
//     BlockPlan, two warpgroups): q_j and k_j, then v_j (h W^T + b), then
//     datt_j = do W_out[:, j cols] stream through the three-stage TMA ring
//     (64-deep stages of 32 KB; W_out's columns read N-major in place),
//     above 64 tokens each sweep's last stages bringing the next one's
//     first chunks, and
//     round straight into head j's four swizzled tiles beside the ring
//     (225 KB in all at T 256, HD 64: one block an SM); thread 0 then
//     issues the weight columns of dh's first three stages, and each
//     warpgroup runs, on its strips, row 1's single-pass attention (att,
//     to device memory for dW_out), then row 2's dq pass (S and dp in
//     registers, D and ds from one sweep of the keys, dq = ds k) and its
//     dk/dv pass (S^T, P^T, dv += P^T datt, dp^T, dk += ds^T q), all on
//     wgmma, writing dqkv through per-warp staging rows in the ring's
//     activation boxes (whole rows a store); after a cluster barrier dh's
//     columns of head j = dqkv W_{q,k,v}[:, j cols] stream through the
//     ring (dqkv from L2: an image's 3 T C values, 384 KB at the flagship,
//     do not fit a block's shared memory; at T <= 64 a group's 192 KB are
//     spread over the cluster, PERF.md says what reading them there could
//     save);
//  2. the weight and bias gradients as a split-K product over the B T
//     rows on wgmma: block (128 x 256 output tile, row chunk) takes both
//     operands MN-major from TMA (two 64 x 64 boxes of dqkv or do and four
//     of h or att per 64-row stage, four stages), db_qkv's column sums
//     from the stage in shared memory, and writes its fp32 partials slice;
//  3. a merge that adds the chunks' partials in a fixed order and writes
//     the gradients in the parameters' dtypes.
// No atomics: the result is deterministic.
//
// fp32 (parity runs) runs on the CUDA cores, thread t owning token row t,
// with q and datt parked in a (B, T, 2C) fp32 scratch that the dk/dv sweep
// reads in tiles (a head's q, k, v and datt do not fit a block's shared
// memory in fp32), and 64 x 64 weight-gradient tiles.

#include "attention_block_common.cuh"

namespace {

using namespace pdm_block;
using bf = __nv_bfloat16;

// ---------------------------------------------------------------------------
// kernel 1, bf16: wgmma on TMA

struct BwdMaps {
  CUtensorMap h, dout, dqkv;     // rows maps: A operands of the ring
  CUtensorMap wq, wk, wv;        // weight rows, boxes {64, HD} (K-major)
  CUtensorMap wq_n, wk_n, wv_n, wout_n;  // weight columns, boxes {HD, 64} (N-major)
};

// The backward's streamed loads that take weight columns N-major: datt's
// chunk i (the pair's boxes of do, W_out's 64 rows of head j's columns)
// and dh's (the pair's boxes of dqkv, W_{q,k,v}'s; DhWLoad issues the
// weight columns, which come while the attention VJP runs, and DhActLoad
// the boxes, after every head's dqkv is written).
template <int HD, bool Packed>
struct DattLoad {
  const CUtensorMap *dout, *wout_n;
  int nkc, j, img0, per_strip;
  __device__ __forceinline__ void operator()(int i, char* st, uint64_t* bar) const {
    const int p = i / nkc, kc = (i - p * nkc) * kChunk;
    load_pair<Packed>(st, dout, bar, kc, p, img0, per_strip);
    pdm_hop::tma_load_2d(st + 2 * kBox, wout_n, bar, j * HD, kc);
  }
};

template <int HD>
struct DhWLoad {
  const CUtensorMap* w[3];
  int nkc, j;
  __device__ __forceinline__ void operator()(int i, char* st, uint64_t* bar) const {
    const int k = i % (3 * nkc), part = k / nkc;
    pdm_hop::tma_load_2d(st + 2 * kBox, w[part], bar, j * HD, (k - part * nkc) * kChunk);
  }
};

template <bool Packed>
struct DhActLoad {
  const CUtensorMap* dqkv;
  int C, nkc, img0, per_strip;
  __device__ __forceinline__ void operator()(int p, int k, char* st, uint64_t* bar) const {
    const int part = k / nkc;
    load_pair<Packed>(st, dqkv, bar, part * C + (k - part * nkc) * kChunk, p, img0, per_strip);
  }
};

template <int HD, int NC>
__global__ void __launch_bounds__(kThreads, 1)
attention_block_bwd_wgmma_kernel(const __grid_constant__ BwdMaps m, const void* bq,
                                 const void* bk, const void* bv, const float* __restrict__ lse,
                                 bf* __restrict__ att, bf* dqkv, bf* __restrict__ dh,
                                 float* dsum, int B, int n_tok, int heads, int trs,
                                 float scale, float scale_log2, int bias_bf16) {
  using namespace pdm_hop;
  constexpr bool kPacked = NC == 1;
  constexpr int kStrips = kPacked ? 2 : NC + (NC & 1);
  constexpr int kPairs = kStrips / 2;
  constexpr int kRowsT = kStrips * 64;
  constexpr int kTile = Stripe<HD>::bytes(kRowsT);
  constexpr int kStage = stage_bytes(HD, true);
  constexpr uint32_t kNTx = 2 * kBox + 64 * HD * 2;  // a pair's boxes, 64 weight rows N-major
  constexpr int kRun = kPacked ? 2 : NC;              // strips with tokens
  constexpr int kStat = 2 * kMaxTok * 4;              // lse and D by tile row
  static_assert(box_rows_fit(kStat, HD * 2 + 16), "VJP staging");
  extern __shared__ char smem_tma[];
  __shared__ StageRing<kStages> ring;

  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  const int C = heads * HD;
  const int wg = threadIdx.x / kWgThreads, warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int nkc = (C + kChunk - 1) / kChunk;
  const int per = kPacked ? 64 >> trs : 1;
  const int img0 = kPacked ? blockIdx.y * 2 * per : blockIdx.y;
  const Rows<kPacked> lay = block_rows<kPacked>(n_tok, B, img0, trs, heads, j);
  char* mem = aligned_smem(smem_tma);  // the ring, then the q, k, v, datt tiles
  char* qs = mem + kStages * kStage;
  char* ks = qs + kTile;
  char* vs = ks + kTile;
  char* das = vs + kTile;
  if (threadIdx.x == 0) {
    ring_init(ring);
    fence_barrier_init();
  }
  __syncthreads();

  // 1. q, k, v and datt of head j, straight into the tiles: three sweeps,
  // each one's last stages bringing the next one's first chunks above 64
  // tokens (at T <= 64, four chunks a sweep, that cost 6%: PERF.md)
  RingPos pos{0, 0};
  const int ahead_n = kPacked ? 0 : kPairs * nkc;
  const ProjLoad<HD, 2, kPacked> qk{&m.h, {&m.wq, &m.wk}, nkc, j, img0, per};
  const ProjLoad<HD, 1, kPacked> pv{&m.h, {&m.wv}, nkc, j, img0, per};
  const DattLoad<HD, kPacked> datt{&m.dout, &m.wout_n, nkc, j, img0, per};
  {
    const void* const b2[2] = {bq, bk};
    char* const t2[2] = {qs, ks};
    project_tiles<HD, 2, kPacked>(ring, mem, kStage, pos, qk, b2, t2, kPairs, bias_bf16,
                                  ahead(ahead_n, pv.tx, pv));
    const void* const b1[1] = {bv};
    char* const t1[1] = {vs};
    project_tiles<HD, 1, kPacked>(ring, mem, kStage, pos, pv, b1, t1, kPairs, bias_bf16,
                                  ahead(ahead_n, kNTx, datt));
  }
  head_sweep<HD, true>(
      ring, mem, kStage, pos, kPairs, nkc, kNTx,
      [&](int p, int kc, char* st, uint64_t* bar) { datt(p * nkc + kc, st, bar); }, NoLoad{},
      [&](int p, const float (&acc)[HD / 2]) {  // datt, rounded, into its tile
        const int row0 = (2 * p + wg) * 64 + (warp & 3) * 16 + g;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st_tile<HD>(das, row0 + 8 * r, i * 8 + 2 * tq,
                        pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]));
      });
  fence_proxy_async_shared();  // the tiles' generic stores, before wgmma reads them
  __syncthreads();

  // 2. head j's attention VJP, while dh's weight columns for its first
  // stages load; the ring's activation boxes hold the queries' lse and D by
  // tile row and each warp's staging rows for att, dq, dk, dv
  const DhWLoad<HD> dh_w{{&m.wq_n, &m.wk_n, &m.wv_n}, nkc, j};
  ring_prefetch(ring, mem, kStage, pos, ahead(kPairs * 3 * nkc, kNTx, dh_w));
  float* lse_s = reinterpret_cast<float*>(mem);  // log2 units
  float* d_s = lse_s + kMaxTok;
  char* buf = box_rows(mem, kStage, kStat, HD * 2 + 16, warp);
#pragma unroll 1
  for (int s = wg; s < kRun; s += 2) {
    // att recomputed as the forward, then dq and D
    fwd_strip<HD, NC>(qs, ks, vs, kRowsT, kRowsT, s, lay, scale_log2,
                      [&](const auto& o, float mul, int row0) {
                        store_staged<HD>(att, o[0], mul, lay, row0, C, j * HD, buf);
                      },
                      nullptr);
    dq_strip<HD, NC, false>(qs, das, ks, vs, nullptr, 0, kRowsT, s * 64, kRowsT, s, lay, lse,
                            [&](const auto& acc, float mul, int row0) {
                              store_staged<HD>(dqkv, acc[0], mul, lay, row0, 3LL * C, j * HD,
                                               buf);
                            },
                            dsum, scale, scale_log2);
  }
  __syncthreads();  // D of every row is written
  for (int r = threadIdx.x; r < kRowsT; r += pdm_block::kThreads) {
    const bool has = lay.has(r);
    lse_s[r] = has ? lse[lay.lidx(r)] * kLog2e : INFINITY;  // P = 0 for padding
    d_s[r] = has ? dsum[lay.lidx(r)] : 0.f;
  }
  __syncthreads();
#pragma unroll 1
  for (int s = wg; s < kRun; s += 2)
    dkdv_strip<HD, NC>(ks, vs, qs, das, kRowsT, s * 64, kRowsT, s, lay, lse_s, d_s,
                       [&](int which, const auto& acc, float mul, int row0) {
                         store_staged<HD>(dqkv, acc[0], mul, lay, row0, 3LL * C,
                                          (1 + which) * C + j * HD, buf);
                       },
                       scale, scale_log2);

  // 3. every head's dqkv is written: dh's columns of head j, staged
  // through the idle tiles
  fence_proxy_async_shared();
  fence_proxy_async_global();
  cluster.sync();
  fence_proxy_async_global();
  char* hbuf = qs + warp * 16 * (HD * 2 + 16);
  const DhActLoad<kPacked> dh_a{&m.dqkv, C, nkc, img0, per};
  head_sweep<HD, true>(
      ring, mem, kStage, pos, kPairs, 3 * nkc, kNTx,
      [&](int p, int k, char* st, uint64_t* bar) {
        dh_a(p, k, st, bar);
        dh_w(p * 3 * nkc + k, st, bar);
      },
      dh_a,
      [&](int p, const float (&acc)[HD / 2]) {
        store_staged<HD>(dh, acc, 1.f, lay, (2 * p + wg) * 64, C, j * HD, hbuf);
      });
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

constexpr int kWO = 128;  // bf16 output tile: rows (two warpgroups of 64)
constexpr int kWC = 256;  // and columns (one wgmma m64n256k16 a 16-row step)
constexpr int kWStage = kWO * 64 * 2 + kWC * 64 * 2;  // 48 KB: 2 + 4 boxes of 64 x 64

struct WgradMaps {
  CUtensorMap dqkv, dout, h, att;  // 2-D {width, B T}, boxes {64, 64}
};

__global__ void __launch_bounds__(kThreads, 1)
attention_block_wgrad_wgmma_kernel(const __grid_constant__ WgradMaps m,
                                   float* __restrict__ partials, int R, int C,
                                   int rows_per_chunk, int n_ctiles) {
  using namespace pdm_hop;
  extern __shared__ char smem_tma[];
  __shared__ StageRing<kStages> ring;
  __shared__ float red[pdm_block::kThreads];
  const int nq = (3 * C + kWO - 1) / kWO;
  const int otile = blockIdx.x / n_ctiles, c0 = (blockIdx.x % n_ctiles) * kWC;
  const bool qkv = otile < nq;
  const CUtensorMap* G = qkv ? &m.dqkv : &m.dout;
  const CUtensorMap* H = qkv ? &m.h : &m.att;
  const int o0 = (qkv ? otile : otile - nq) * kWO;
  const int o_lim = qkv ? 3 * C : C, o_out = qkv ? 0 : 3 * C;
  const bool sums = qkv && c0 == 0;
  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(R, r_begin + rows_per_chunk);
  const int nk = r_end > r_begin ? (r_end - r_begin + 63) / 64 : 0;
  const int wg = threadIdx.x / kWgThreads, warp = (threadIdx.x & 127) >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  char* mem = aligned_smem(smem_tma);
  if (threadIdx.x == 0) {
    ring_init(ring);
    fence_barrier_init();
  }
  __syncthreads();

  float acc[kWC / 2];
#pragma unroll
  for (int i = 0; i < kWC / 2; ++i) acc[i] = 0.f;
  // db_qkv: thread t sums column t % 128 of the G tile over half of each
  // stage's rows (the 128-byte swizzle: 16-byte unit u of row r sits at
  // unit u ^ (r % 8))
  const int sc = threadIdx.x & (kWO - 1), half = threadIdx.x / kWO;
  float colsum = 0.f;
  RingPos pos{0, 0};
  ring_sweep<kStages>(
      ring, mem, kWStage, pos, nk, kWStage,
      [&](int i, char* st, uint64_t* bar) {
        const int r0 = r_begin + i * 64;
#pragma unroll
        for (int p = 0; p < kWO / 64; ++p) tma_load_2d(st + p * kBox, G, bar, o0 + p * 64, r0);
#pragma unroll
        for (int p = 0; p < kWC / 64; ++p)
          tma_load_2d(st + (kWO / 64 + p) * kBox, H, bar, c0 + p * 64, r0);
      },
      [&](int, const char* st) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_t<kWC, 1, 1>(acc, desc_mn<64>(st + wg * kBox, 64, kk, 0),
                                desc_mn<64>(st + (kWO / 64) * kBox, 64, kk, 0));
        if (sums) {
          const char* panel = st + (sc >> 6) * kBox;
          const int u = (sc & 63) >> 3, e = sc & 7;
#pragma unroll 8
          for (int r = half * 32; r < half * 32 + 32; ++r)
            colsum += __bfloat162float(*reinterpret_cast<const bf*>(
                panel + r * 128 + ((u ^ (r & 7)) << 4) + e * 2));
        }
      },
      [](int) {});
  reg_fence(acc);

  float* part = partials + (long long)blockIdx.y * (4LL * C * C + 3 * C);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = o0 + wg * 64 + warp * 16 + g + 8 * r;
    if (o >= o_lim) continue;
    float* row = part + (long long)(o_out + o) * C;
#pragma unroll
    for (int i = 0; i < kWC / 8; ++i) {
      const int c = c0 + i * 8 + 2 * tq;
      if (c < C)
        *reinterpret_cast<float2*>(row + c) = make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
  if (sums) {
    red[threadIdx.x] = colsum;
    __syncthreads();
    if (threadIdx.x < kWO && o0 + threadIdx.x < o_lim)
      part[4LL * C * C + o0 + threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + kWO];
  }
}

constexpr int kWT = 64;  // fp32 output tile edge

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

template <int HD, int NC>
cudaError_t launch_bwd_wgmma(const BwdMaps& m, const BlockPlan& p, const void* bq,
                             const void* bk, const void* bv, const float* lse, void* att,
                             void* dqkv, void* dh, float* dsum, int B, int n_tok, int heads,
                             float scale, int bias_bf16, cudaStream_t stream) {
  return launch_cluster(attention_block_bwd_wgmma_kernel<HD, NC>, heads, p.groups, p.smem,
                        stream, m, bq, bk, bv, lse, static_cast<bf*>(att),
                        static_cast<bf*>(dqkv), static_cast<bf*>(dh), dsum, B, n_tok, heads,
                        p.trs, scale, scale * kLog2e, bias_bf16);
}

// the tensor maps of a bf16 launch
template <int HD>
bool bwd_maps(BwdMaps* m, const BlockPlan& p, const void* h, const void* dout,
              const void* wq, const void* wk, const void* wv, const void* wout,
              const void* dqkv, int B, int n_tok, int heads) {
  using namespace pdm_hop;
  const int C = heads * HD;
  const bool packed = p.nc == 1;
  const int box_rows = packed ? 1 << p.trs : 64, box_imgs = packed ? p.per_strip : 1;
  return rows_map(&m->h, h, B, n_tok, C, C, kChunk, box_rows, box_imgs) &&
         rows_map(&m->dout, dout, B, n_tok, C, C, kChunk, box_rows, box_imgs) &&
         rows_map(&m->dqkv, dqkv, B, n_tok, 3 * C, 3LL * C, kChunk, box_rows, box_imgs) &&
         mat_map(&m->wq, wq, C, C, kChunk, HD) && mat_map(&m->wk, wk, C, C, kChunk, HD) &&
         mat_map(&m->wv, wv, C, C, kChunk, HD) && mat_map(&m->wq_n, wq, C, C, HD, kChunk) &&
         mat_map(&m->wk_n, wk, C, C, HD, kChunk) && mat_map(&m->wv_n, wv, C, C, HD, kChunk) &&
         mat_map(&m->wout_n, wout, C, C, HD, kChunk);
}

template <int HD>
cudaError_t launch_bwd(int dtype, const BlockPlan* plan, const void* h, const void* wq,
                       const void* wk, const void* wv, const void* bq, const void* bk,
                       const void* bv, const void* wout, const float* lse, const void* dout,
                       void* dqkv, void* att, void* dh, void* scratch, float* dsum, int B,
                       int n_tok, int heads, float scale, int bias_bf16, cudaStream_t stream) {
  if (n_tok < 1 || n_tok > kMaxTok || heads < 1 || heads > 8 || B < 1)
    return cudaErrorInvalidValue;
  if (dtype == pdm::kBFloat16) {
    if (plan == nullptr || dsum == nullptr || !plan_ok(*plan, B, n_tok, heads, HD, true))
      return cudaErrorInvalidValue;
    BwdMaps m;
    if (!bwd_maps<HD>(&m, *plan, h, dout, wq, wk, wv, wout, dqkv, B, n_tok, heads))
      return cudaErrorInvalidValue;
    switch (plan->nc) {
      case 1: return launch_bwd_wgmma<HD, 1>(m, *plan, bq, bk, bv, lse, att, dqkv, dh, dsum, B, n_tok, heads, scale, bias_bf16, stream);
      case 2: return launch_bwd_wgmma<HD, 2>(m, *plan, bq, bk, bv, lse, att, dqkv, dh, dsum, B, n_tok, heads, scale, bias_bf16, stream);
      case 3: return launch_bwd_wgmma<HD, 3>(m, *plan, bq, bk, bv, lse, att, dqkv, dh, dsum, B, n_tok, heads, scale, bias_bf16, stream);
      default: return launch_bwd_wgmma<HD, 4>(m, *plan, bq, bk, bv, lse, att, dqkv, dh, dsum, B, n_tok, heads, scale, bias_bf16, stream);
    }
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
// dtype. bf16 needs the scratch dsum (B, heads, T) fp32 and the launch
// plan of ops/attention_block.py::plan_block (checked here); fp32 needs
// scratch, a (B, T, 2C) fp32 buffer. hd: 16, 32 or 64; heads <= 8;
// T <= 256. Returns the launch's CUDA error.
extern "C" int pdm_attention_block_bwd(const void* h, const void* wq, const void* wk,
                                       const void* wv, const void* bq, const void* bk,
                                       const void* bv, const void* wout, const void* lse,
                                       const void* dout, void* dqkv, void* att, void* dh,
                                       void* scratch, void* dsum, const void* plan, int B,
                                       int n_tok, int heads, int hd, float scale, int dtype,
                                       int bias_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* p = static_cast<const BlockPlan*>(plan);
  auto* D = static_cast<float*>(dsum);
  const int bb = bias_dtype == pdm::kBFloat16;
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_bwd<16>(dtype, p, h, wq, wk, wv, bq, bk, bv, wout, l, dout, dqkv, att, dh, scratch, D, B, n_tok, heads, scale, bb, s); break;
    case 32: err = launch_bwd<32>(dtype, p, h, wq, wk, wv, bq, bk, bv, wout, l, dout, dqkv, att, dh, scratch, D, B, n_tok, heads, scale, bb, s); break;
    case 64: err = launch_bwd<64>(dtype, p, h, wq, wk, wv, bq, bk, bv, wout, l, dout, dqkv, att, dh, scratch, D, B, n_tok, heads, scale, bb, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Kernel 2. The (4C x C) weight-gradient partials and db_qkv's column
// sums of each of n_chunks row chunks of the R = B T rows into partials
// (n_chunks, 4 C C + 3 C) fp32, from kernel 1's dqkv and att, h and dout.
// bf16: 128 x 256 output tiles on wgmma, chunks of a multiple of 64 rows;
// fp32: 64 x 64 tiles on the CUDA cores.
extern "C" int pdm_attention_block_wgrad(const void* h, const void* dout, const void* dqkv,
                                         const void* att, void* partials, int R, int C,
                                         int n_chunks, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (R < 1 || C < 8 || C % 8 || n_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* out = static_cast<float*>(partials);
  if (dtype == pdm::kBFloat16) {
    using pdm_hop::mat_map;
    WgradMaps m;
    if (!mat_map(&m.dqkv, dqkv, R, 3 * C, 64, 64) || !mat_map(&m.dout, dout, R, C, 64, 64) ||
        !mat_map(&m.h, h, R, C, 64, 64) || !mat_map(&m.att, att, R, C, 64, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    const int per = round_up((R + n_chunks - 1) / n_chunks, 64);
    const int n_ctiles = (C + kWC - 1) / kWC;
    const int n_otiles = (3 * C + kWO - 1) / kWO + (C + kWO - 1) / kWO;
    const int smem = kStages * kWStage + 1024;
    cudaError_t err = pdm_hop::allow_smem(attention_block_wgrad_wgmma_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_block_wgrad_wgmma_kernel<<<dim3(n_otiles * n_ctiles, n_chunks), kThreads, smem,
                                         s>>>(m, out, R, C, per, n_ctiles);
  } else if (dtype == pdm::kFloat32) {
    const int per = (R + n_chunks - 1) / n_chunks;
    const dim3 grid((C + kWT - 1) / kWT, (3 * C + kWT - 1) / kWT + (C + kWT - 1) / kWT, n_chunks);
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
