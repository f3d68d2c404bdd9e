// The whole attention block, forward, for Hopper (sm_90a):
// out = x + (attention(h W_qkv^T + b_qkv) W_out^T + b_out).
//
// Replaces the TPU kernel pdm_tpu/ops/attention_block.py::_fwd_kernel
// (launched by _fab_fwd). Same function and rounding points: qkv = h W^T
// + b in fp32 rounded once to the input dtype; per-head fp32 softmax with
// the normalized probabilities rounded before P V; the attention output
// rounded before the out projection; x + (att W_out^T + b_out) in fp32
// rounded once. Also writes the per-head row logsumexp (B, heads, T) fp32
// for the backward.
//
// Layout: x, h, out are contiguous (B, T, C), C = heads * HD; the four
// weights are nn.Linear's (C_out, C_in), read in place; the biases are
// fp32 or bf16 (bias_bf16).
//
// What bounds it on the H100: at the flagship's B = 64, T = 256, C = 256,
// 4 heads, in bf16 one call must read x and h and write out (~25 MB, 7.5
// us at 3.35 TB/s) and do 2 B T C (4C) + 4 B T^2 C = 12.9 GFLOP (13 us
// at the bf16 tensor-core peak): bound by operations.
//
// Design. The TPU kernel holds an image's whole chain in VMEM (h, the
// (C, 3C) and (C, C) weights, q/k/v, the attention output); here the bf16
// weights alone (384 + 128 KB) exceed a block's 227 KB. So one cluster of
// `heads` blocks per image, one block per head (at most 8):
//  1. block j projects its own q_j, k_j, v_j: h and its 3 HD weight rows
//     stream in 32-deep tiles through a two-stage cp.async ring, the fp32
//     bias is added and the result rounded once into shared memory;
//  2. it runs head j's attention from shared memory (row 1's two passes:
//     max and sum, then the normalized P rounded and P v), writes the
//     lse, and keeps att_j rounded in shared memory (aliasing the ring);
//  3. after a cluster barrier it computes output columns [j HD, (j+1) HD)
//     as sum_i att_i W_out[j rows, i cols]^T, reading each peer's att_i
//     through distributed shared memory, adds b_out and x in fp32 and
//     rounds once; a closing cluster barrier keeps every att_i alive until
//     its peers have read it.
// Nothing goes through atomics: the result is deterministic.
//
// * bf16 (the main path): mma.sync m16n8k16, fp32 accumulation, 8 warps
//   each owning the 16-row strips w and w + 8.
// * fp32 (parity runs): the CUDA cores, thread t owning token row t; q_t
//   stays in registers, k and v in shared memory (read as broadcasts),
//   att_t in rows of HD + 1 floats that the peers read.

#include "attention_block_common.cuh"

namespace {

using namespace pdm_block;

// ---------------------------------------------------------------------------
// bf16: tensor cores

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_block_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* wq,
                              const __nv_bfloat16* wk, const __nv_bfloat16* wv, const void* bq,
                              const void* bk, const void* bv,
                              const __nv_bfloat16* __restrict__ wout, const void* bout,
                              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int n_tok,
                              int heads, float scale_log2, int bias_bf16) {
  constexpr int S = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int C = heads * HD;
  const int tp = round_up(n_tok, kTile);
  const int n_strips = (n_tok + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  __nv_bfloat16* qs = smem;
  __nv_bfloat16* ks = qs + tile_elems(tp, HD);
  __nv_bfloat16* vs = ks + tile_elems(tp, HD);
  __nv_bfloat16* ring = vs + tile_elems(tp, HD);
  __nv_bfloat16* atts = ring;  // the ring is free once q, k, v are projected
  const long long img = (long long)b * n_tok * C;

  __nv_bfloat16* const qkv[3] = {qs, ks, vs};
  const __nv_bfloat16* const w[3] = {wq, wk, wv};
  const void* const bias[3] = {bq, bk, bv};
  project_qkv<HD>(qkv, h + img, w, bias, bias_bf16, j, n_tok, C, tp, ring);

  // head j's attention, rounded into atts; its lse to global
#pragma unroll 1
  for (int s = 0; s < kStrips; ++s) {
    const int strip = warp + s * kWarps;
    if (strip >= n_strips) continue;
    float o[HD / 8][4], m[2], l[2];
    attend_strip<HD>(o, m, l, qs, ks, vs, strip, n_tok, scale_log2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = strip * 16 + g + 8 * r;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<uint32_t*>(atts + row * S + d * 8 + 2 * tq) =
            pack_bf16(o[d][2 * r], o[d][2 * r + 1]);
      if (tq == 0 && row < n_tok)
        lse[((long long)b * heads + j) * n_tok + row] = m[r] * kLn2 + logf(l[r]);
    }
  }
  cluster.sync();  // every head's att is complete

  // output columns [j HD, (j + 1) HD): sum over heads i of att_i times
  // W_out[j HD.., i HD..]^T; att_i copied from block i's shared memory
  Acc<HD> acc;
  zero<HD>(acc);
  __nv_bfloat16* a_loc = qs;  // q, k, v are no longer needed
  __nv_bfloat16* w_loc = ks;
  const int rows = n_strips * 16;
  constexpr int kVec = HD / 8;
#pragma unroll 1
  for (int i = 0; i < heads; ++i) {
    const __nv_bfloat16* peer = cluster.map_shared_rank(atts, i);
    for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
      const int r = e / kVec, c = (e - r * kVec) * 8;
      *reinterpret_cast<uint4*>(a_loc + r * S + c) =
          *reinterpret_cast<const uint4*>(peer + r * S + c);
    }
    for (int e = threadIdx.x; e < HD * kVec; e += kThreads) {
      const int r = e / kVec, c = (e - r * kVec) * 8;
      *reinterpret_cast<uint4*>(w_loc + r * S + c) = *reinterpret_cast<const uint4*>(
          wout + (long long)(j * HD + r) * C + i * HD + c);
    }
    __syncthreads();
    mma_nt<HD, HD / 16>(acc, a_loc, S, w_loc, S, n_strips);
    __syncthreads();
  }
  for_each_pair<HD>(acc, n_strips, [&](int row, int col, float v0, float v1) {
    if (row >= n_tok) return;
    const int cc = j * HD + col;
    const long long off = img + (long long)row * C + cc;
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
    const float o0 = __low2float(xv) + (v0 + load_bias(bout, cc, bias_bf16));
    const float o1 = __high2float(xv) + (v1 + load_bias(bout, cc + 1, bias_bf16));
    *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(o0, o1);
  });
  cluster.sync();  // no peer reads atts any more
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_block_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                               const float* wq, const float* wk, const float* wv, const void* bq,
                               const void* bk, const void* bv, const float* __restrict__ wout,
                               const void* bout, float* __restrict__ out, float* __restrict__ lse,
                               int n_tok, int heads, float scale, int bias_bf16) {
  constexpr int P = HD + 1;  // thread-owned rows: an odd stride, no bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // n_tok x HD, broadcast reads
  float* vs = ks + n_tok * HD;
  float* atts = vs + n_tok * HD;                    // n_tok x P
  float* wc = atts + n_tok * P;                     // max(kKT, HD) x HD staging
  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int C = heads * HD;
  const int t = threadIdx.x;
  const bool active = t < n_tok;
  const long long img = (long long)b * n_tok * C;
  const float* hrow = h + img + (long long)(active ? t : 0) * C;

  float qr[HD], acc[HD];
  const float* const w[3] = {wq, wk, wv};
  const void* const bias[3] = {bq, bk, bv};
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    row_gemm_f32<HD, true>(acc, hrow, active, stack1(w[p] + (long long)j * HD * C, HD, C), 0,
                           C, wc);
    if (!active) continue;
#pragma unroll
    for (int n = 0; n < HD; ++n) {
      const float v = acc[n] + load_bias(bias[p], j * HD + n, bias_bf16);
      if (p == 0) qr[n] = v;
      else (p == 1 ? ks : vs)[t * HD + n] = v;
    }
  }
  __syncthreads();
  if (active) {
    const float l = attend_row_f32<HD>(acc, qr, ks, vs, HD, n_tok, scale);
#pragma unroll
    for (int d = 0; d < HD; ++d) atts[t * P + d] = acc[d];
    lse[((long long)b * heads + j) * n_tok + t] = l;
  }
  cluster.sync();

  float a[HD];
#pragma unroll
  for (int n = 0; n < HD; ++n) acc[n] = 0.f;
#pragma unroll 1
  for (int i = 0; i < heads; ++i) {
    const float* peer = cluster.map_shared_rank(atts, i);
    for (int e = threadIdx.x; e < HD * HD; e += kThreads) {
      const int n = e / HD, d = e - n * HD;
      wc[e] = wout[(long long)(j * HD + n) * C + i * HD + d];
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) a[d] = peer[t * P + d];
#pragma unroll 4
      for (int n = 0; n < HD; ++n) acc[n] += dot_f32<HD>(a, wc + n * HD);
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < HD; ++n) {
      const long long off = img + (long long)t * C + j * HD + n;
      out[off] = x[off] + (acc[n] + load_bias(bout, j * HD + n, bias_bf16));
    }
  }
  cluster.sync();  // no peer reads atts any more
}

// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_fwd(int dtype, const void* x, const void* h, const void* wq, const void* wk,
                       const void* wv, const void* bq, const void* bk, const void* bv,
                       const void* wout, const void* bout, void* out, float* lse, int B,
                       int n_tok, int heads, float scale, int bias_bf16, cudaStream_t stream) {
  if (n_tok < 1 || n_tok > kMaxTok || heads < 1 || heads > 8 || B < 1)
    return cudaErrorInvalidValue;
  if (dtype == pdm::kBFloat16) {
    using bf = __nv_bfloat16;
    const int tp = round_up(n_tok, kTile);
    const int ring = ring_elems(tp, HD) > tile_elems(tp, HD) ? ring_elems(tp, HD)
                                                             : tile_elems(tp, HD);
    const int smem = (3 * tile_elems(tp, HD) + ring) * 2;
    return launch_cluster(attention_block_fwd_tc_kernel<HD>, heads, B, smem, stream,
                          static_cast<const bf*>(x), static_cast<const bf*>(h),
                          static_cast<const bf*>(wq), static_cast<const bf*>(wk),
                          static_cast<const bf*>(wv), bq, bk, bv, static_cast<const bf*>(wout),
                          bout, static_cast<bf*>(out), lse, n_tok, heads,
                          scale * kLog2e, bias_bf16);
  }
  if (dtype == pdm::kFloat32) {
    const int wc = (kKT > HD ? kKT : HD) * HD;
    const int smem = (2 * n_tok * HD + n_tok * (HD + 1) + wc) * 4;
    return launch_cluster(attention_block_fwd_f32_kernel<HD>, heads, B, smem, stream,
                          static_cast<const float*>(x), static_cast<const float*>(h),
                          static_cast<const float*>(wq), static_cast<const float*>(wk),
                          static_cast<const float*>(wv), bq, bk, bv,
                          static_cast<const float*>(wout), bout, static_cast<float*>(out),
                          lse, n_tok, heads, scale, bias_bf16);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, h, out: contiguous (B, T, heads*hd); wq, wk, wv, wout: contiguous
// (C, C) nn.Linear weights of x's dtype; bq, bk, bv, bout: (C,) of
// bias_dtype; lse: contiguous (B, heads, T) fp32. dtype, bias_dtype:
// pdm::kFloat32 or pdm::kBFloat16 (bf16: 16-byte aligned tensors). hd:
// 16, 32 or 64; heads <= 8; T <= 256. Returns the launch's CUDA error.
extern "C" int pdm_attention_block_fwd(const void* x, const void* h, const void* wq,
                                       const void* wk, const void* wv, const void* bq,
                                       const void* bk, const void* bv, const void* wout,
                                       const void* bout, void* out, void* lse, int B,
                                       int n_tok, int heads, int hd, float scale, int dtype,
                                       int bias_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  const int bb = bias_dtype == pdm::kBFloat16;
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_fwd<16>(dtype, x, h, wq, wk, wv, bq, bk, bv, wout, bout, out, l, B, n_tok, heads, scale, bb, s); break;
    case 32: err = launch_fwd<32>(dtype, x, h, wq, wk, wv, bq, bk, bv, wout, bout, out, l, B, n_tok, heads, scale, bb, s); break;
    case 64: err = launch_fwd<64>(dtype, x, h, wq, wk, wv, bq, bk, bv, wout, bout, out, l, B, n_tok, heads, scale, bb, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
