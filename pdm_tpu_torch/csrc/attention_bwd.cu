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
// Layout: q, k, v are (B, T, C) with C = heads * HD, token rows `ld` apart
// (the column thirds of the fused qkv projection); do, dq, dk, dv are
// contiguous (B, T, C); lse and D are (B, heads, T) fp32.
//
// What bounds it on the H100: at the flagship's B=128, T=256, C=256 in
// bf16 the call must read q, k, v, do (4 x 16.8 MB) and lse, and write
// dq, dk, dv: ~117 MB, 35 us at 3.35 TB/s; its 10 B T^2 C = 21.5 GFLOP take
// 22 us at the bf16 tensor-core peak. Both bounds are close, so the design
// keeps every T x T tile in registers and reads each operand tile from
// shared memory.
//
// Design: the TPU kernel holds an image's whole T x T tiles in VMEM and
// runs five matmuls; here nothing T x T is materialized and no block
// writes another's output, so there are no atomics. Two kernels:
//  1. dq: one block per (query tile of 64, head, image), 4 warps x 16 query
//     rows. Sweep 1 over 64-key tiles recomputes P and dp on the tensor
//     cores and sums D; sweep 2 recomputes them, forms ds (bf16, in the
//     score accumulators' registers, reused as the A operand) and
//     accumulates ds k. Writes dq and D.
//  2. dk, dv: one block per (key tile of 64, head, image), 4 warps x 16 key
//     rows, over 64-query tiles: P^T (from k q^T and the saved lse) times
//     do gives dv, dp^T = v do^T and the saved D give ds^T, and ds^T q
//     gives dk.
// The bf16 kernels use mma.sync m16n8k16 through the helpers of
// attention_common.cuh. fp32 (parity runs, not the main path) runs on the
// CUDA cores with one thread per query row (dq) or key row (dk, dv).

#include "attention_common.cuh"

namespace {

using namespace pdm_attn;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           __nv_bfloat16* __restrict__ dq,
                           float* __restrict__ dsum, int n_tok, int heads,
                           long long ld, float scale, float scale_log2) {
  constexpr int S = HD + 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * S];  // q, then do
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * S];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * S];

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int C = heads * HD;
  const bool busy = q0 + warp * 16 < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * HD;
  const long long dimg = (long long)b * n_tok * C + (long long)h * HD;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_rows<HD>(qs, q + img, q0, n_tok, ld, S);
  __syncthreads();
  load_a<HD>(qa, qs, warp, lane);
  __syncthreads();
  load_rows<HD>(qs, dout + dimg, q0, n_tok, C, S);
  __syncthreads();
  load_a<HD>(da, qs, warp, lane);

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
    load_rows<HD>(ks, k + img, k0, n_tok, ld, S);
    load_rows<HD>(vs, v + img, k0, n_tok, ld, S);
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
    load_rows<HD>(ks, k + img, k0, n_tok, ld, S);
    load_rows<HD>(vs, v + img, k0, n_tok, ld, S);
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
  store_rows<HD>(dq + h * HD, acc, scale, (long long)b * n_tok,
                 q0 + warp * 16, n_tok, C, lane);
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
                             int heads, long long ld, float scale,
                             float scale_log2) {
  constexpr int S = HD + 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * S];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * S];
  __shared__ float lse_s[kTile];  // log2 units, +inf past n_tok
  __shared__ float d_s[kTile];

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int C = heads * HD;
  const bool busy = k0 + warp * 16 < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * HD;
  const long long dimg = (long long)b * n_tok * C + (long long)h * HD;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  // A fragments of this warp's 16 key rows of k and of v
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_rows<HD>(qs, k + img, k0, n_tok, ld, S);
  load_rows<HD>(dos, v + img, k0, n_tok, ld, S);
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
    load_rows<HD>(qs, q + img, q0, n_tok, ld, S);
    load_rows<HD>(dos, dout + dimg, q0, n_tok, C, S);
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
  store_rows<HD>(dk + h * HD, dk_acc, scale, row_base, k0 + warp * 16, n_tok, C, lane);
  store_rows<HD>(dv + h * HD, dv_acc, 1.f, row_base, k0 + warp * 16, n_tok, C, lane);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores

template <int HD>
__global__ void __launch_bounds__(kBQ)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ dq,
                            float* __restrict__ dsum, int n_tok, int heads,
                            long long ld, float scale) {
  constexpr int BK = kTileElems / HD;
  __shared__ __align__(16) float ks[kTileElems];
  __shared__ __align__(16) float vs[kTileElems];

  const int h = blockIdx.y, b = blockIdx.z;
  const int t = blockIdx.x * kBQ + threadIdx.x;
  const bool active = t < n_tok;
  const int C = heads * HD;
  const long long img = (long long)b * n_tok * ld + (long long)h * HD;
  const long long drow = ((long long)b * n_tok + t) * C + (long long)h * HD;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  float qr[HD], dor[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? q[img + (long long)t * ld + d] : 0.f;
    dor[d] = active ? dout[drow + d] : 0.f;
  }
  const float l = active ? lse[lrow + t] : 0.f;

  // sweep 1: D = sum_k P * dp
  float D = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += BK) {
    load_tile_f32<HD>(ks, k + img, k0, n_tok, ld);
    load_tile_f32<HD>(vs, v + img, k0, n_tok, ld);
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
    load_tile_f32<HD>(ks, k + img, k0, n_tok, ld);
    load_tile_f32<HD>(vs, v + img, k0, n_tok, ld);
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
    for (int d = 0; d < HD; ++d) dq[drow + d] = acc[d] * scale;
    dsum[lrow + t] = D;
  }
}

constexpr int kBQT = 16;  // query rows per shared tile of the fp32 dk/dv kernel

template <int HD>
__global__ void __launch_bounds__(kBQ)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int n_tok, int heads, long long ld, float scale) {
  constexpr int P = HD + 1;  // padded rows: thread t reads row t conflict-free
  __shared__ float kown[kBQ * P];
  __shared__ float vown[kBQ * P];
  __shared__ __align__(16) float qs[kBQT * HD];
  __shared__ __align__(16) float dos[kBQT * HD];
  __shared__ float lse_s[kBQT], d_s[kBQT];

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * kBQ;
  const int t = k0 + threadIdx.x;
  const bool active = t < n_tok;
  const int C = heads * HD;
  const long long img = (long long)b * n_tok * ld + (long long)h * HD;
  const long long dimg = (long long)b * n_tok * C + (long long)h * HD;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  for (int e = threadIdx.x; e < kBQ * HD; e += kBQ) {
    const int r = e / HD, c = e - r * HD;
    const int row = k0 + r;
    kown[r * P + c] = row < n_tok ? k[img + (long long)row * ld + c] : 0.f;
    vown[r * P + c] = row < n_tok ? v[img + (long long)row * ld + c] : 0.f;
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
      qs[e] = row < n_tok ? q[img + (long long)row * ld + c] : 0.f;
      dos[e] = row < n_tok ? dout[dimg + (long long)row * C + c] : 0.f;
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
    const long long o = ((long long)b * n_tok + t) * C + (long long)h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[o + d] = dk_acc[d] * scale;
      dv[o + d] = dv_acc[d];
    }
  }
}

// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, void* dq, float* dsum,
                      int B, int n_tok, int heads, long long ld, float scale,
                      cudaStream_t stream) {
  if (dtype == pdm::kBFloat16) {
    const dim3 grid((n_tok + kTile - 1) / kTile, heads, B);
    attention_bwd_dq_tc_kernel<HD><<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, static_cast<__nv_bfloat16*>(dq), dsum, n_tok, heads, ld, scale,
        scale * kLog2e);
  } else if (dtype == pdm::kFloat32) {
    const dim3 grid((n_tok + kBQ - 1) / kBQ, heads, B);
    attention_bwd_dq_f32_kernel<HD><<<grid, kBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        static_cast<float*>(dq), dsum, n_tok, heads, ld, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkdv(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* dsum,
                        void* dk, void* dv, int B, int n_tok, int heads,
                        long long ld, float scale, cudaStream_t stream) {
  if (dtype == pdm::kBFloat16) {
    const dim3 grid((n_tok + kTile - 1) / kTile, heads, B);
    attention_bwd_dkdv_tc_kernel<HD><<<grid, kTcThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        lse, dsum, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        n_tok, heads, ld, scale, scale * kLog2e);
  } else if (dtype == pdm::kFloat32) {
    const dim3 grid((n_tok + kBQ - 1) / kBQ, heads, B);
    attention_bwd_dkdv_f32_kernel<HD><<<grid, kBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, dsum,
        static_cast<float*>(dk), static_cast<float*>(dv), n_tok, heads, ld, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, T, heads*hd) rows `ld` elements apart; dout: contiguous
// (B, T, heads*hd) of the same dtype; lse: contiguous (B, heads, T) fp32
// from the forward. Writes dq (contiguous, q's dtype) and dsum, the row
// sums D (B, heads, T) fp32 that pdm_attention_bwd_dkdv reads. dtype:
// pdm::kFloat32 or pdm::kBFloat16 (bf16: 16-byte aligned stripes). hd: 16,
// 32 or 64. Returns cudaGetLastError().
extern "C" int pdm_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, void* dq,
                                    void* dsum, int B, int n_tok, int heads,
                                    int hd, long long ld, float scale, int dtype,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* D = static_cast<float*>(dsum);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_dq<16>(dtype, q, k, v, dout, l, dq, D, B, n_tok, heads, ld, scale, s); break;
    case 32: err = launch_dq<32>(dtype, q, k, v, dout, l, dq, D, B, n_tok, heads, ld, scale, s); break;
    case 64: err = launch_dq<64>(dtype, q, k, v, dout, l, dq, D, B, n_tok, heads, ld, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As pdm_attention_bwd_dq, reading its dsum; writes dk and dv (contiguous,
// q's dtype).
extern "C" int pdm_attention_bwd_dkdv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dsum,
                                      void* dk, void* dv, int B, int n_tok,
                                      int heads, int hd, long long ld,
                                      float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* D = static_cast<const float*>(dsum);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_dkdv<16>(dtype, q, k, v, dout, l, D, dk, dv, B, n_tok, heads, ld, scale, s); break;
    case 32: err = launch_dkdv<32>(dtype, q, k, v, dout, l, D, dk, dv, B, n_tok, heads, ld, scale, s); break;
    case 64: err = launch_dkdv<64>(dtype, q, k, v, dout, l, D, dk, dv, B, n_tok, heads, ld, scale, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
