// Spatial multi-head softmax attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel pdm_tpu/ops/attention.py::_fwd_kernel (launched
// by _fsa_call). Same function: per (image, head), out = softmax(q k^T *
// scale) v with the softmax in fp32, the normalized probabilities rounded
// to the input dtype before the PV product (as the TPU kernel does), fp32
// accumulation, and the per-row logsumexp written in fp32 for a backward.
//
// Layout: q, k, v are (B, T, C) with C = heads * HD and token rows `ld`
// elements apart (ld = 3C when they are the column thirds of one fused qkv
// projection, C when contiguous). Each head's column stripe is read in
// place: no head-split transposes.
//
// What bounds it on the H100: at the flagship's B=64, T=256, C=256 in bf16
// the call must move ~33.6 MB (10 us at 3.35 TB/s) and do 4.3 GFLOP (4.3 us
// at the bf16 tensor-core peak), so it is memory-bound at best.
//
// Design: the TPU kernel holds the whole T x T score tile of an image in
// VMEM; a Hopper block has 227 KB of shared memory and far fewer
// registers, so nothing T x T is ever materialized here. One block per
// (query tile, head, image); K/V head stripes stream through shared memory
// in tiles. Because the reference rounds the NORMALIZED probabilities,
// there are two passes over the keys: the first finds each row's max and
// softmax sum (online rescaling, so any T works), the second forms
// p = exp(s - m) / l, rounds it like the reference, and accumulates P V.
//
// * bf16 (the main path): tensor cores through mma.sync m16n8k16 with fp32
//   accumulators. 4 warps x 16 query rows; q fragments stay in registers;
//   K and V tiles of 64 keys sit in padded shared memory rows (ldmatrix
//   hits distinct banks); the score accumulators of pass 2 are rounded to
//   bf16 and reused in place as the A operand of the PV product.
// * fp32: CUDA cores, one thread per query row, K/V tiles converted to
//   fp32 in shared memory and read as broadcasts. Full fp32 products (no
//   TF32), for parity runs; not on the main path.

#include "attention_common.cuh"

namespace {

using namespace pdm_attn;

// ---------------------------------------------------------------------------
// bf16: tensor cores

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attention_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int n_tok, int heads,
                        long long ld, float scale_log2) {
  constexpr int S = HD + 8;  // padded smem row: 8 rows hit 8 bank groups
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * S];
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * S];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * S];

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool busy = q0 + warp * 16 < n_tok;  // warp has a real query row
  const long long img = (long long)b * n_tok * ld + (long long)h * HD;
  const __nv_bfloat16* kb = k + img;
  const __nv_bfloat16* vb = v + img;

  load_rows<HD>(qs, q + img, q0, n_tok, ld, S);
  __syncthreads();
  uint32_t qa[HD / 16][4];  // A fragments of this warp's 16 query rows
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);

  // pass 1: row max m and softmax sum l (log2 units) of rows g and g + 8;
  // each thread sums its own columns against the quad's shared max
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kTile / 8][4];
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_rows<HD>(ks, kb, k0, n_tok, ld, S);
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
    load_rows<HD>(ks, kb, k0, n_tok, ld, S);
    load_rows<HD>(vs, vb, k0, n_tok, ld, S);
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
  const int C = heads * HD;
  const float ln2 = 0.6931471805599453f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= n_tok) continue;
    __nv_bfloat16* orow = out + ((long long)b * n_tok + row) * C + (long long)h * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(orow + d * 8 + 2 * tq) =
          pack_bf16(o[d][2 * r], o[d][2 * r + 1]);
    if (tq == 0)
      lse[((long long)b * heads + h) * n_tok + row] =
          m[r] * ln2 + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores

template <int HD>
__global__ void __launch_bounds__(kBQ)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int n_tok, int heads,
                         long long ld, float scale) {
  constexpr int BK = kTileElems / HD;
  __shared__ __align__(16) float ks[kTileElems];
  __shared__ __align__(16) float vs[kTileElems];

  const int h = blockIdx.y, b = blockIdx.z;
  const int t = blockIdx.x * kBQ + threadIdx.x;
  const bool active = t < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * HD;
  const float* kb = k + img;
  const float* vb = v + img;

  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = active ? q[img + (long long)t * ld + d] : 0.f;

  // pass 1: row max m and softmax sum l = sum_j exp(s_j - m)
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += BK) {
    load_tile_f32<HD>(ks, kb, k0, n_tok, ld);
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
    load_tile_f32<HD>(ks, kb, k0, n_tok, ld);
    load_tile_f32<HD>(vs, vb, k0, n_tok, ld);
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
    const int C = heads * HD;
    float* o = out + ((long long)b * n_tok + t) * C + (long long)h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = acc[d];
    lse[((long long)b * heads + h) * n_tok + t] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* out, float* lse, int B, int n_tok, int heads,
                   long long ld, float scale, cudaStream_t stream) {
  if (dtype == pdm::kBFloat16) {
    const dim3 grid((n_tok + kTile - 1) / kTile, heads, B);
    attention_fwd_tc_kernel<HD><<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        lse, n_tok, heads, ld, scale * 1.4426950408889634f);
  } else if (dtype == pdm::kFloat32) {
    const dim3 grid((n_tok + kBQ - 1) / kBQ, heads, B);
    attention_fwd_f32_kernel<HD><<<grid, kBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, n_tok,
        heads, ld, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, T, heads*hd) rows `ld` elements apart; out: contiguous
// (B, T, heads*hd) of the same dtype; lse: contiguous (B, heads, T) fp32.
// dtype: pdm::kFloat32 or pdm::kBFloat16 (bf16: 16-byte aligned head
// stripes). hd: 16, 32 or 64. Returns cudaGetLastError().
extern "C" int pdm_attention_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int n_tok,
                                 int heads, int hd, long long ld, float scale,
                                 int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch<16>(dtype, q, k, v, out, l, B, n_tok, heads, ld, scale, s); break;
    case 32: err = launch<32>(dtype, q, k, v, out, l, B, n_tok, heads, ld, scale, s); break;
    case 64: err = launch<64>(dtype, q, k, v, out, l, B, n_tok, heads, ld, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
