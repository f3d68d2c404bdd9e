// Spatial multi-head softmax attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/attention.py::_fwd_kernel (launched
// by _fsa_call). Same function: per (image, head), out = softmax(q k^T *
// scale) v with the softmax in fp32, the normalized probabilities rounded
// to the input dtype before the PV product (as the TPU kernel does), fp32
// accumulation, and the per-row logsumexp written in fp32 for a backward.
//
// Layout: q, k, v are (B, T, C) with C = heads * hd and token rows `ld`
// elements apart (ld = 3C when they are the column thirds of one fused qkv
// projection, C when contiguous). Each head's column stripe is read in
// place: no head-split transposes. hd is any multiple of 8 up to 128; the
// kernels zero-pad it to the next instantiated width HDP of 16, 32, 64 or
// 128 (zero columns add nothing to q k^T, padded output columns are never
// written).
//
// What bounds it on the H100: at the flagship's B=64, T=256, C=256 in bf16
// the call must move ~33.6 MB (10 us at 3.35 TB/s) and do 4.3 GFLOP (4.3 us
// at the bf16 tensor-core peak), so it is memory-bound at best.
//
// Three kernels, chosen by shape in the launcher:
//
// * bf16, T <= 256 (every flagship shape: T 256, and 16 in the mid block):
//   attention_fwd_wgmma_kernel, one pass. One block (one warpgroup) per
//   (head, image), two blocks per SM. Thread 0 loads the head's whole q, k
//   and v stripes once through TMA (q and k on one mbarrier, v on a
//   second); then for each 64-row query strip:
//     S = q k^T       one wgmma m64n(64 NC)k16 per 16 head-dim columns
//                     (NC = T / 64 rounded up, a template parameter), both
//                     operands read in place from the swizzled tiles; the
//                     strip's whole score row (64 x 256 fp32) stays in
//                     registers,
//     softmax         exact row max and sum (quad shuffles), p = exp(s - m)
//                     / l rounded to bf16 in registers (the reference's
//                     rounding of the normalized P, with nothing recomputed),
//     O = P v         wgmma m64nHDPk16 with P repacked in registers as the A
//                     operand and v as the N-major B operand,
//   and the strip's output and logsumexp go straight from registers to
//   device memory. K and v cross L2 once per (image, head) and every score
//   is computed once: 2 B T^2 C products (the old design computed the
//   scores twice). The two blocks on an SM overlap one's softmax with the
//   other's products. The products and the softmax, not the loads, set
//   the time, so a persistent variant (two warpgroups walking the items
//   over a two-stage ring of loads) gained nothing and is not kept.
// * bf16, 256 < T <= 1024: attention_fwd_tc_kernel, the two-pass kernel. A
//   64-row score strip no longer fits in registers, and the reference
//   rounds the NORMALIZED probabilities, so pass 1 finds each row's max and
//   softmax sum (online rescaling) and pass 2 recomputes the scores, forms
//   p = exp(s - m) / l, rounds it like the reference and accumulates P V.
//   Tensor cores through mma.sync m16n8k16, 4 warps x 16 query rows, K/V
//   tiles of 64 keys in padded shared memory rows.
// * fp32 (parity runs, not the main path): attention_fwd_f32_kernel on the
//   CUDA cores, one thread per query row, two passes, K/V tiles in shared
//   memory read as broadcasts. Full fp32 products (no TF32). At HDP 128 the
//   row's q and output accumulators (256 registers) spill.
//
// Trouble met in the single-pass kernel, and what it does about it:
//  * dynamic shared memory: 3 stripes of 256 rows are 96 KB at HDP 64 (two
//    blocks an SM) and 192 KB at 128, above the static 48 KB, so the
//    launcher opts in with cudaFuncSetAttribute;
//  * a branch between a wgmma's issue and its wait (a runtime chunk count)
//    makes ptxas fence or serialize the products, and naming the last chunk
//    by a runtime index put the score registers in local memory: the chunk
//    count is a template parameter and the padding mask tests every key;
//  * wgmma wants swizzled tiles: TMA writes them (32/64/128-byte swizzle by
//    HDP) and the descriptors read them in place, 1024-byte aligned;
//  * tensor maps come from cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPoint (no libcuda link);
//  * the mid block's T = 16 is below wgmma's 64 rows: the map's token
//    extent is T, so TMA zero-fills the padded rows, the padded keys are
//    masked to p = 0, and padded rows are never stored;
//  * registers: the 64 x 256 fp32 score strip is 128 registers a thread;
//    P packs into 64 as the scores die, the output accumulator is HDP / 2.

#include "attention_hopper.cuh"

namespace {

using namespace pdm_attn;

// ---------------------------------------------------------------------------
// bf16, T <= 256: one pass on wgmma

// One warpgroup per (head, image): thread 0 loads the head's q, k, v
// stripes (64 NC rows each) through TMA, then the strips run in turn.
template <int HDP, int NC>
__global__ void __launch_bounds__(pdm_hop::kWgThreads, 1)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int n_tok, int heads, int hd,
                           float scale_log2) {
  using namespace pdm_hop;
  using S = Stripe<HDP>;
  constexpr int rows = NC * kRows;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t bar[NC + 2];  // k, v, then q strip by strip

  const int h = blockIdx.x, b = blockIdx.y;
  char* qs = aligned_smem(smem_raw);
  char* ks = qs + S::bytes(rows);
  char* vs = ks + S::bytes(rows);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NC + 2; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // k and the first strip's q, then v, then the other strips' q: the
    // first strip starts once 64 NC + 64 rows have landed
    mbar_expect_tx(&bar[0], S::bytes(rows));
    load_stripe<HDP>(ks, &tm_k, &bar[0], rows, h, 0, b);
    for (int st = 0; st < NC; ++st) {
      mbar_expect_tx(&bar[2 + st], S::bytes(kRows));
      load_stripe<HDP>(qs + st * kRows * S::kRB, &tm_q, &bar[2 + st], kRows, h,
                       st * kRows, b, rows);
      if (st == 0) {
        mbar_expect_tx(&bar[1], S::bytes(rows));
        load_stripe<HDP>(vs, &tm_v, &bar[1], rows, h, 0, b);
      }
    }
  }
  const PlainRows lay{n_tok, (long long)b * n_tok, ((long long)b * heads + h) * n_tok};
  mbar_wait(&bar[0], 0);
#pragma unroll 1
  for (int st = 0; st < NC; ++st) {
    mbar_wait(&bar[2 + st], 0);
    if (st == 0) mbar_wait(&bar[1], 0);
    fwd_strip<HDP, NC>(qs, ks, vs, rows, rows, st, lay, scale_log2,
                       [&](const auto& o, float mul, int row0) {
                         store_rows<HDP>(out, o, mul, lay, row0, (long long)heads * hd,
                                         h * hd, hd);
                       },
                       lse);
  }
}

// ---------------------------------------------------------------------------
// bf16, 256 < T <= 1024: two passes on mma.sync

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attention_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int n_tok, int heads, int hd,
                        long long ld, float scale_log2) {
  constexpr int S = HD + 8;  // padded smem row: 8 rows hit 8 bank groups
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * S];  // q first, then k
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * S];

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool busy = q0 + warp * 16 < n_tok;  // warp has a real query row
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const __nv_bfloat16* kb = k + img;
  const __nv_bfloat16* vb = v + img;

  load_rows<HD>(ks, q + img, q0, n_tok, ld, S, hd);
  __syncthreads();
  uint32_t qa[HD / 16][4];  // A fragments of this warp's 16 query rows
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], ks + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);

  // pass 1: row max m and softmax sum l (log2 units) of rows g and g + 8;
  // each thread sums its own columns against the quad's shared max
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kTile / 8][4];
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    __syncthreads();  // the previous tile (or q) is consumed
    load_rows<HD>(ks, kb, k0, n_tok, ld, S, hd);
    __syncthreads();
    if (!busy) continue;
    tile_scores<HD>(s, qa, ks, lane, k0, n_tok, scale_log2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));  // finite: k0 < n_tok
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
        sum += exp2f(s[n][2 * r] - m_new) + exp2f(s[n][2 * r + 1] - m_new);
      l[r] = l[r] * exp2f(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // pass 2: p = exp(s - m) / l rounded to bf16, o += p v
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // ldmatrix.trans x4 over V rows: matrices (keys +0..7 | +8..15) x (d +0 | +8)
  const int vkey_off = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol_off = (lane >> 4) * 8;
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    __syncthreads();
    load_rows<HD>(ks, kb, k0, n_tok, ld, S, hd);
    load_rows<HD>(vs, vb, k0, n_tok, ld, S, hd);
    __syncthreads();
    if (!busy) continue;
    tile_scores<HD>(s, qa, ks, lane, k0, n_tok, scale_log2);
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      // the accumulators of key tiles 2j and 2j+1 are exactly the A
      // fragment of the 16-key slice j
      uint32_t pa[4];
      pa[0] = pack_bf16(exp2f(s[2 * j][0] - m[0]) * inv_l[0],
                        exp2f(s[2 * j][1] - m[0]) * inv_l[0]);
      pa[1] = pack_bf16(exp2f(s[2 * j][2] - m[1]) * inv_l[1],
                        exp2f(s[2 * j][3] - m[1]) * inv_l[1]);
      pa[2] = pack_bf16(exp2f(s[2 * j + 1][0] - m[0]) * inv_l[0],
                        exp2f(s[2 * j + 1][1] - m[0]) * inv_l[0]);
      pa[3] = pack_bf16(exp2f(s[2 * j + 1][2] - m[1]) * inv_l[1],
                        exp2f(s[2 * j + 1][3] - m[1]) * inv_l[1]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vfr[4];
        ldsm_x4_trans(vfr, vs + (j * 16 + vkey_off) * S + dp * 16 + vcol_off);
        mma_bf16(o[2 * dp], pa, vfr[0], vfr[1]);
        mma_bf16(o[2 * dp + 1], pa, vfr[2], vfr[3]);
      }
    }
  }

  if (!busy) return;
  const int C = heads * hd;
  const float ln2 = 0.6931471805599453f;
  store_rows<HD>(out + (long long)h * hd, o, 1.f, (long long)b * n_tok,
                 q0 + warp * 16, n_tok, C, lane, hd);
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < n_tok)
        lse[((long long)b * heads + h) * n_tok + row] = m[r] * ln2 + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores

template <int HD>
__global__ void __launch_bounds__(kBQ)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int n_tok, int heads, int hd,
                         long long ld, float scale) {
  constexpr int BK = kTileElems / HD;
  __shared__ __align__(16) float ks[kTileElems];
  __shared__ __align__(16) float vs[kTileElems];

  const int h = blockIdx.y, b = blockIdx.z;
  const int t = blockIdx.x * kBQ + threadIdx.x;
  const bool active = t < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const float* kb = k + img;
  const float* vb = v + img;

  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d)
    qr[d] = active && d < hd ? q[img + (long long)t * ld + d] : 0.f;

  // pass 1: row max m and softmax sum l = sum_j exp(s_j - m)
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += BK) {
    load_tile_f32<HD>(ks, kb, k0, n_tok, ld, hd);
    __syncthreads();
    const int nk = min(BK, n_tok - k0);
    if (active) {
      for (int j = 0; j < nk; ++j) {
        const float s = dot_row<HD>(qr, ks + j * HD) * scale;
        if (s > m) {
          l = l * expf(m - s) + 1.f;
          m = s;
        } else {
          l += expf(s - m);
        }
      }
    }
    __syncthreads();
  }

  // pass 2: p = exp(s - m) / l, acc += p v
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += BK) {
    load_tile_f32<HD>(ks, kb, k0, n_tok, ld, hd);
    load_tile_f32<HD>(vs, vb, k0, n_tok, ld, hd);
    __syncthreads();
    const int nk = min(BK, n_tok - k0);
    if (active) {
      for (int j = 0; j < nk; ++j) {
        const float p = expf(dot_row<HD>(qr, ks + j * HD) * scale - m) / l;
        const float4* v4 = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = v4[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    const int C = heads * hd;
    float* o = out + ((long long)b * n_tok + t) * C + (long long)h * hd;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d < hd) o[d] = acc[d];
    lse[((long long)b * heads + h) * n_tok + t] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------

template <int HDP, int NC>
cudaError_t launch_wgmma(const CUtensorMap (&m)[3], void* out, float* lse, int B,
                         int n_tok, int heads, int hd, float scale,
                         cudaStream_t stream) {
  const int smem = 3 * pdm_hop::Stripe<HDP>::bytes(NC * pdm_hop::kRows) + 1024;
  auto kernel = attention_fwd_wgmma_kernel<HDP, NC>;
  cudaError_t err = pdm_hop::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, B), pdm_hop::kWgThreads, smem, stream>>>(
      m[0], m[1], m[2], static_cast<__nv_bfloat16*>(out), lse, n_tok, heads, hd,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out,
                         float* lse, int B, int n_tok, int heads, int hd,
                         long long ld, float scale, cudaStream_t stream) {
  const int nc = (n_tok + pdm_hop::kRows - 1) / pdm_hop::kRows;
  const int rows = nc * pdm_hop::kRows;
  CUtensorMap m[3];
  if (!pdm_hop::stripe_map<HDP>(&m[0], q, B, n_tok, heads, hd, ld, pdm_hop::kRows) ||
      !pdm_hop::stripe_map<HDP>(&m[1], k, B, n_tok, heads, hd, ld, rows) ||
      !pdm_hop::stripe_map<HDP>(&m[2], v, B, n_tok, heads, hd, ld, rows))
    return cudaErrorInvalidValue;
  switch (nc) {
    case 1: return launch_wgmma<HDP, 1>(m, out, lse, B, n_tok, heads, hd, scale, stream);
    case 2: return launch_wgmma<HDP, 2>(m, out, lse, B, n_tok, heads, hd, scale, stream);
    case 3: return launch_wgmma<HDP, 3>(m, out, lse, B, n_tok, heads, hd, scale, stream);
    default: return launch_wgmma<HDP, 4>(m, out, lse, B, n_tok, heads, hd, scale, stream);
  }
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* out, float* lse, int B, int n_tok, int heads, int hd,
                   long long ld, float scale, cudaStream_t stream) {
  if (dtype == pdm::kBFloat16 && n_tok <= pdm_hop::kMaxTokens) {
    return launch_wgmma<HD>(q, k, v, out, lse, B, n_tok, heads, hd, ld, scale, stream);
  } else if (dtype == pdm::kBFloat16) {
    const dim3 grid((n_tok + kTile - 1) / kTile, heads, B);
    attention_fwd_tc_kernel<HD><<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        lse, n_tok, heads, hd, ld, scale * 1.4426950408889634f);
  } else if (dtype == pdm::kFloat32) {
    const dim3 grid((n_tok + kBQ - 1) / kBQ, heads, B);
    attention_fwd_f32_kernel<HD><<<grid, kBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, n_tok,
        heads, hd, ld, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, T, heads*hd) rows `ld` elements apart; out: contiguous
// (B, T, heads*hd) of the same dtype; lse: contiguous (B, heads, T) fp32.
// dtype: pdm::kFloat32 or pdm::kBFloat16 (bf16: 16-byte aligned head
// stripes, ld a multiple of 8). hd: a multiple of 8 up to 128. bf16 at
// T <= 256 runs the single-pass kernel, longer rows the two-pass one.
// Returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// argument or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int pdm_attention_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int n_tok,
                                 int heads, int hd, long long ld, float scale,
                                 int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (hd < 8 || hd > 128 || hd % 8) {
    err = cudaErrorInvalidValue;
  } else if (hd <= 16) {
    err = launch<16>(dtype, q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s);
  } else if (hd <= 32) {
    err = launch<32>(dtype, q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s);
  } else if (hd <= 64) {
    err = launch<64>(dtype, q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s);
  } else {
    err = launch<128>(dtype, q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s);
  }
  return static_cast<int>(err);
}
