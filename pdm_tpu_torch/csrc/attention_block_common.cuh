// Building blocks shared by the whole-attention-block kernels
// (attention_block.cu, forward; attention_block_bwd.cu, backward).
//
// Both run one thread-block cluster per image and one block per head
// (cluster rank j = head j), 8 warps, with the head's q, k, v (and, in the
// backward, datt) resident in shared memory. In bf16 the products run on
// the tensor cores (mma.sync m16n8k16 through attention_common.cuh), warp
// w owning the 16-row strips w and w + 8 of the T tokens; in fp32 they run
// on the CUDA cores, thread t owning token row t.
//
// bf16 shared-memory layout: resident (Tp x HD) tiles in rows of HD + 8
// elements (Tp = T rounded up to 64, the attention's key tile), then a
// two-stage cp.async ring for the streamed products: an A tile (Tp x 32)
// in rows of 40 elements (80 bytes: eight rows of an ldmatrix hit eight
// distinct bank groups) and a B tile, HD x 32 (rows of 40) or 32 x HD
// (rows of HD + 8).
#pragma once

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace pdm_block {

using namespace pdm_attn;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTok = 256;   // tokens a block keeps resident
constexpr int kStrips = kMaxTok / 16 / kWarps;  // 16-row strips per warp
constexpr int kKT = 32;        // contraction depth of one streamed stage
constexpr int kSK = kKT + 8;   // its shared row stride (elements)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// bf16 elements of one resident (Tp x HD) tile and of the streamed ring
__host__ __device__ constexpr int tile_elems(int tp, int hd) { return tp * (hd + 8); }
// a B tile: HD rows of kKT (NT) or kKT rows of HD (NN)
__host__ __device__ constexpr int b_elems(int hd) {
  return hd * kSK > kKT * (hd + 8) ? hd * kSK : kKT * (hd + 8);
}
__host__ __device__ constexpr int stage_elems(int tp, int hd) { return tp * kSK + b_elems(hd); }
__host__ __device__ constexpr int ring_elems(int tp, int hd) { return 2 * stage_elems(tp, hd); }

// 16 bytes global -> shared; zero-filled when !pred (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float load_bias(const void* b, int i, int bias_bf16) {
  return bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i])
                   : static_cast<const float*>(b)[i];
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
// bf16: per-warp accumulators of its strips, 16 rows x HD columns each

template <int HD>
using Acc = float[kStrips][HD / 8][4];

template <int HD>
__device__ __forceinline__ void zero(Acc<HD>& acc) {
#pragma unroll
  for (int s = 0; s < kStrips; ++s)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) acc[s][n][0] = acc[s][n][1] = acc[s][n][2] = acc[s][n][3] = 0.f;
}

// acc += A B^T over KS 16-deep steps: A rows of the warp's strips (stride
// sa), B the HD rows of a shared tile (stride sb), both contiguous along
// the contraction.
template <int HD, int KS>
__device__ __forceinline__ void mma_nt(Acc<HD>& acc, const __nv_bfloat16* a_s, int sa,
                                       const __nv_bfloat16* b_s, int sb, int n_strips) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_off = (lane & 7) + (lane >> 4) * 8;
  const int col_off = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int s = 0; s < kStrips; ++s) {
    const int strip = warp + s * kWarps;
    if (strip >= n_strips) continue;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_s + (strip * 16 + (lane & 15)) * sa + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_s + (np * 16 + row_off) * sb + kk * 16 + col_off);
        mma_bf16(acc[s][2 * np], a, b[0], b[1]);
        mma_bf16(acc[s][2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc += A B over KS 16-deep steps: B a shared (16 KS x HD) tile whose
// rows run along the contraction (stride sb).
template <int HD, int KS>
__device__ __forceinline__ void mma_nn(Acc<HD>& acc, const __nv_bfloat16* a_s, int sa,
                                       const __nv_bfloat16* b_s, int sb, int n_strips) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_off = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col_off = (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < kStrips; ++s) {
    const int strip = warp + s * kWarps;
    if (strip >= n_strips) continue;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_s + (strip * 16 + (lane & 15)) * sa + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_s + (kk * 16 + row_off) * sb + dp * 16 + col_off);
        mma_bf16(acc[s][2 * dp], a, b[0], b[1]);
        mma_bf16(acc[s][2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc += A (T x K, rows lda apart in global memory; rows past n_tok read
// as zero) times B over the whole contraction K, streamed through the
// two-stage ring. NT: B is the stack's HD rows (B^T's columns), each
// contiguous along K. Otherwise B is the stack's K rows, the HD columns
// from col0 on. K is a multiple of 8.
template <int HD, bool NT>
__device__ void stream_gemm(Acc<HD>& acc, const __nv_bfloat16* __restrict__ a, long long lda,
                            int n_tok, int n_strips, const Stack<__nv_bfloat16>& b, int col0,
                            int K, __nv_bfloat16* ring, int tp) {
  const int rows = n_strips * 16;
  __nv_bfloat16* a_buf[2] = {ring, ring + stage_elems(tp, HD)};
  __nv_bfloat16* b_buf[2] = {ring + tp * kSK, ring + stage_elems(tp, HD) + tp * kSK};
  auto load = [&](int kt, int buf) {
    const int k0 = kt * kKT;
    constexpr int kVec = kKT / 8;  // 16-byte vectors per A row
    for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
      const int r = e / kVec, c = (e - r * kVec) * 8;
      const bool ok = r < n_tok && k0 + c < K;
      cp_async16(a_buf[buf] + r * kSK + c, ok ? a + (long long)r * lda + k0 + c : a, ok);
    }
    if (NT) {
      for (int e = threadIdx.x; e < HD * kVec; e += kThreads) {
        const int r = e / kVec, c = (e - r * kVec) * 8;
        const bool ok = k0 + c < K;
        const __nv_bfloat16* src = b.row(r);
        cp_async16(b_buf[buf] + r * kSK + c, ok ? src + k0 + c : src, ok);
      }
    } else {
      constexpr int kCol = HD / 8;  // 16-byte vectors per B row
      for (int e = threadIdx.x; e < kKT * kCol; e += kThreads) {
        const int r = e / kCol, c = (e - r * kCol) * 8;
        const bool ok = k0 + r < K;
        const __nv_bfloat16* src = b.row(ok ? k0 + r : 0) + col0 + c;
        cp_async16(b_buf[buf] + r * (HD + 8) + c, src, ok);
      }
    }
  };
  const int n_k = (K + kKT - 1) / kKT;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      load(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (NT)
      mma_nt<HD, kKT / 16>(acc, a_buf[kt & 1], kSK, b_buf[kt & 1], kSK, n_strips);
    else
      mma_nn<HD, kKT / 16>(acc, a_buf[kt & 1], kSK, b_buf[kt & 1], HD + 8, n_strips);
    __syncthreads();
  }
}

// Visit each accumulator pair of the warp's strips: f(row, col, v0, v1)
// for columns col, col + 1 of token row `row` (rows of every strip, also
// those past T).
template <int HD, typename F>
__device__ __forceinline__ void for_each_pair(const Acc<HD>& acc, int n_strips, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int s = 0; s < kStrips; ++s) {
    const int strip = warp + s * kWarps;
    if (strip >= n_strips) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * tq;
      f(strip * 16 + g, col, acc[s][n][0], acc[s][n][1]);
      f(strip * 16 + g + 8, col, acc[s][n][2], acc[s][n][3]);
    }
  }
}

// Zero rows [from, tp) of a resident tile (read by the 64-row attention
// tiles past the last strip).
template <int HD>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* t, int from, int tp) {
  constexpr int kVec = (HD + 8) / 8;
  for (int e = threadIdx.x; e < (tp - from) * kVec; e += kThreads)
    reinterpret_cast<uint4*>(t + from * (HD + 8))[e] = make_uint4(0u, 0u, 0u, 0u);
}

// q, k, v of head j (columns j HD.. of h W_x^T + b_x) for every token,
// rounded once to bf16 into the resident tiles qkv[0..2].
template <int HD>
__device__ void project_qkv(__nv_bfloat16* const (&qkv)[3], const __nv_bfloat16* h_img,
                            const __nv_bfloat16* const (&w)[3], const void* const (&bias)[3],
                            int bias_bf16, int j, int n_tok, int C, int tp,
                            __nv_bfloat16* ring) {
  const int n_strips = (n_tok + 15) / 16;
  Acc<HD> acc;
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    zero<HD>(acc);
    stream_gemm<HD, true>(acc, h_img, C, n_tok, n_strips,
                          stack1(w[p] + (long long)j * HD * C, HD, C), 0, C, ring, tp);
    __nv_bfloat16* dst = qkv[p];
    const void* b = bias[p];
    for_each_pair<HD>(acc, n_strips, [&](int row, int col, float v0, float v1) {
      const float b0 = load_bias(b, j * HD + col, bias_bf16);
      const float b1 = load_bias(b, j * HD + col + 1, bias_bf16);
      *reinterpret_cast<uint32_t*>(dst + row * (HD + 8) + col) = pack_bf16(v0 + b0, v1 + b1);
    });
    zero_rows<HD>(dst, n_strips * 16, tp);
  }
  __syncthreads();
}

// Softmax attention of one 16-row query strip against the resident k, v
// tiles, as the forward kernel of row 1: pass 1 the rows' max m and sum l
// (log2 units), pass 2 P = exp2(s - m) / l rounded to bf16 and o += P v.
template <int HD>
__device__ void attend_strip(float (&o)[HD / 8][4], float (&m)[2], float (&l)[2],
                             const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                             const __nv_bfloat16* vs, int strip, int n_tok,
                             float scale_log2) {
  constexpr int S = HD + 8;
  const int lane = threadIdx.x & 31;
  uint32_t qa[HD / 16][4];
  load_a<HD>(qa, qs, strip, lane);
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  float s[kTile / 8][4];
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    tile_scores<HD>(s, qa, ks + k0 * S, lane, k0, n_tok, scale_log2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
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
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    tile_scores<HD>(s, qa, ks + k0 * S, lane, k0, n_tok, scale_log2);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = round_bf16(exp2f(s[n][e] - m[e >> 1]) * inv_l[e >> 1]);
    uint32_t a[kTile / 16][4];
#pragma unroll
    for (int jj = 0; jj < kTile / 16; ++jj) pack_a(a[jj], s, jj);
    tile_product<HD>(o, a, vs + k0 * S, lane);
  }
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

// One cluster of `heads` blocks per image: grid (heads, B), the kernel's
// dynamic shared memory set.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int heads, int B, int smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads, B, 1);
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
