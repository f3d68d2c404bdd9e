// The whole attention block's projections, for the staged launch plan
// (Hopper, sm_90a).
//
// The cluster kernels (attention_block.cu, attention_block_bwd.cu) keep one
// head's q, k, v tiles of a whole image in a block's shared memory, so they
// take head dims 16, 32 and 64, at most 8 heads and at most 256 tokens.
// Every other geometry the JAX gate admits (one head of 512 at T 256 in the
// 256x256 family: q, k and v alone are 768 KB) runs staged through device
// memory, with the same function and rounding points as the TPU kernels
// pdm_tpu/ops/attention_block.py::_fwd_kernel and ::_bwd_kernel:
//   forward   qkv = h W_qkv^T + b (fp32, rounded once), row 1's kernels on
//             its column thirds (att rounded, lse saved), out = x + (att
//             W_out^T + b_out) (fp32, rounded once): three launches;
//   backward  qkv and att recomputed as the forward does, datt = do W_out
//             (rounded), row 2's kernels from the saved lse writing dq, dk,
//             dv (rounded once, after the scale) into the column thirds of
//             one (B, T, 3C) dqkv, dh = dqkv W_qkv (fp32, rounded once),
//             then attention_block_bwd.cu's split-K weight-gradient kernel
//             and its merge: eight launches.
// This file holds the products that the TPU kernel computes in its own
// body and that rows 1 and 2 do not: the projections, one kernel for all
// four,
//   out[r, seg_n * n_seg + n] = sum_seg_k sum_k A_seg_k[r, k] W(k, n)
//                               (+ bias[n]) (+ res[r, n]),
// A row-major (R rows, `lda` apart, one pointer per K segment), W one of
// up to three nn.Linear weights read in place, either K-major (W[n][k]:
// h W^T, att W_out^T) or N-major (W[k][n]: do W_out, dqkv W_qkv), one per
// K or N segment, fp32 accumulation and one rounding at the store.
//
// What bounds it on the H100: at the family's B 8, T 256, C 512 the qkv
// projection reads h (2 MB) and the weights (1.5 MB) and writes qkv (6 MB)
// for 3.2 GFLOP: 3.3 us at the bf16 tensor-core peak against 2.8 us of
// traffic, so operations bound it, barely; the C-wide products are a third
// of that.
//
// Design (bf16): 128 x 64 output tiles, two warpgroups of 64 rows, a
// four-stage TMA ring (attention_hopper.cuh's ring_sweep) of 64-deep
// stages: two 64 x 64 boxes of A and the tile's 64 x 64 box of W,
// 128-byte swizzled and read in place by wgmma m64n64k16 (64 columns
// rather than 128: twice the blocks on the family's C 512, half the
// registers). Boxes past a segment's
// edge are TMA's zero fill, so a K segment that is not a multiple of 64
// adds nothing of its neighbour. The epilogue loads its bias and residual
// before any store, adds them in fp32 and stores bf16 pairs. A simple
// first kernel: no persistent blocks, no overlap of one tile's epilogue
// with the next one's loads.
// fp32 (parity runs) runs on the CUDA cores, full fp32 products (no TF32),
// 64 x 64 tiles, 4 x 4 outputs a thread.

#include "attention_block_common.cuh"

namespace {

using bf = __nv_bfloat16;

constexpr int kPM = 128;   // output rows a tile (two warpgroups of 64)
constexpr int kPN = 64;    // output columns a tile
constexpr int kPK = 64;    // contraction depth a stage
constexpr int kPStages = 4;
constexpr int kPBox = 64 * kPK * 2;  // one 64 x 64 bf16 box
constexpr int kPStage = 3 * kPBox;   // A's two boxes, W's 64 x 64

struct ProjArgs {
  int R, lda, ldo, nk_seg, k_seg, nn_seg, n_seg, w_kmajor, bias_bf16;
  const void* bias[3];
  const void* res;  // residual (R rows, ldo apart) or null
  void* out;
};

struct ProjMaps {
  CUtensorMap a[3], w[3];
};

__device__ __forceinline__ float bias_at(const void* b, int bias_bf16, int n) {
  if (b == nullptr) return 0.f;
  return bias_bf16 ? __bfloat162float(static_cast<const bf*>(b)[n])
                   : static_cast<const float*>(b)[n];
}

// KMajor: W read as W[n][k] (h W^T), else W[k][n]; a template parameter,
// so that no branch sits between a chunk's products.
template <bool KMajor>
__global__ void __launch_bounds__(pdm_hop::kThreads, 1)
block_proj_wgmma_kernel(const __grid_constant__ ProjMaps m, const ProjArgs p) {
  using namespace pdm_hop;
  extern __shared__ char smem_tma[];
  __shared__ StageRing<kPStages> ring;
  const int n_tiles = (p.n_seg + kPN - 1) / kPN;
  const int sn = blockIdx.y / n_tiles, n0 = (blockIdx.y % n_tiles) * kPN;
  const int r0 = blockIdx.x * kPM;
  const int kc_seg = (p.k_seg + kPK - 1) / kPK;  // chunks of one K segment
  const int nk = p.nk_seg * kc_seg;
  const int wg = threadIdx.x / kWgThreads, warp = (threadIdx.x & 127) >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  char* mem = aligned_smem(smem_tma);
  if (threadIdx.x == 0) {
    ring_init(ring);
    fence_barrier_init();
  }
  __syncthreads();

  float acc[kPN / 2];
#pragma unroll
  for (int i = 0; i < kPN / 2; ++i) acc[i] = 0.f;
  RingPos pos{0, 0};
  ring_sweep<kPStages>(
      ring, mem, kPStage, pos, nk, kPStage,
      [&](int i, char* st, uint64_t* bar) {
        const int sk = i / kc_seg, k0 = (i - sk * kc_seg) * kPK;
        const CUtensorMap* w = &m.w[sk + sn];
        tma_load_2d(st, &m.a[sk], bar, k0, r0);
        tma_load_2d(st + kPBox, &m.a[sk], bar, k0, r0 + 64);
        if (KMajor)
          tma_load_2d(st + 2 * kPBox, w, bar, k0, n0);
        else
          tma_load_2d(st + 2 * kPBox, w, bar, n0, k0);
      },
      [&](int, const char* st) {
        const char* a = st + wg * kPBox;
        const char* w = st + 2 * kPBox;
#pragma unroll
        for (int kk = 0; kk < kPK / 16; ++kk) {
          if constexpr (KMajor)
            wgmma_ss_t<kPN, 0, 0>(acc, desc_k<64>(a, 64, 0, kk), desc_k<64>(w, kPN, 0, kk));
          else
            wgmma_ss_t<kPN, 0, 1>(acc, desc_k<64>(a, 64, 0, kk), desc_mn<64>(w, 64, kk, 0));
        }
      },
      [](int) {});
  reg_fence(acc);

  // acc: rows 16 warp + g (+ 8) of the warpgroup's 64, columns 8 i + 2 tq.
  // Every bias and residual value the thread needs is loaded before its
  // first store, so the loads overlap (the store may alias them for all
  // the compiler knows, and would otherwise wait out each load in turn).
  bf* out = static_cast<bf*>(p.out);
  const bf* res = static_cast<const bf*>(p.res);
  const void* bias = p.bias[sn];
  const int row0 = r0 + wg * 64 + warp * 16 + g;
  float2 bv[kPN / 8];
  uint32_t rv[2][kPN / 8];
#pragma unroll
  for (int i = 0; i < kPN / 8; ++i) {
    const int n = n0 + i * 8 + 2 * tq;
    const bool col = n < p.n_seg;  // n_seg is even: a pair is whole
    bv[i] = make_float2(col ? bias_at(bias, p.bias_bf16, n) : 0.f,
                        col ? bias_at(bias, p.bias_bf16, n + 1) : 0.f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long o = (long long)(row0 + 8 * r) * p.ldo + (long long)sn * p.n_seg + n;
      rv[r][i] = res != nullptr && col && row0 + 8 * r < p.R
                     ? *reinterpret_cast<const uint32_t*>(res + o) : 0u;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.R) continue;
#pragma unroll
    for (int i = 0; i < kPN / 8; ++i) {
      const int n = n0 + i * 8 + 2 * tq;
      if (n >= p.n_seg) continue;
      const float v0 = acc[4 * i + 2 * r] + bv[i].x +
                       __uint_as_float(rv[r][i] << 16);
      const float v1 = acc[4 * i + 2 * r + 1] + bv[i].y +
                       __uint_as_float(rv[r][i] & 0xffff0000u);
      const long long o = (long long)row * p.ldo + (long long)sn * p.n_seg + n;
      *reinterpret_cast<uint32_t*>(out + o) = pdm_attn::pack_bf16(v0, v1);
    }
  }
}

template <bool KMajor>
cudaError_t launch_proj_wgmma(const ProjMaps& m, const ProjArgs& p, cudaStream_t s) {
  const int smem = kPStages * kPStage + 1024;
  auto kernel = block_proj_wgmma_kernel<KMajor>;
  cudaError_t err = pdm_hop::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.R + kPM - 1) / kPM, p.nn_seg * ((p.n_seg + kPN - 1) / kPN));
  kernel<<<grid, pdm_hop::kThreads, smem, s>>>(m, p);
  return cudaGetLastError();
}

// fp32: 64 x 64 tiles, 256 threads, K in steps of 16 through shared memory
constexpr int kFT = 64;
constexpr int kFK = 16;

struct ProjPtrs {
  const float* a[3];
  const float* w[3];
};

__global__ void __launch_bounds__(256)
block_proj_f32_kernel(const ProjPtrs q, const ProjArgs p) {
  __shared__ float as[kFK][kFT + 1];
  __shared__ float ws[kFK][kFT + 1];
  const int n_tiles = (p.n_seg + kFT - 1) / kFT;
  const int sn = blockIdx.y / n_tiles, n0 = (blockIdx.y % n_tiles) * kFT;
  const int r0 = blockIdx.x * kFT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int sk = 0; sk < p.nk_seg; ++sk) {
    const float* a = q.a[sk];
    const float* w = q.w[sk + sn];
    for (int k0 = 0; k0 < p.k_seg; k0 += kFK) {
      for (int e = threadIdx.x; e < kFK * kFT; e += 256) {
        const int kk = e % kFK, rr = e / kFK;  // A: 16 consecutive k of a row
        const int row = r0 + rr, k = k0 + kk;
        as[kk][rr] = row < p.R && k < p.k_seg ? a[(long long)row * p.lda + k] : 0.f;
        int nn, kw;  // W(k, n): K-major rows n, N-major rows k
        if (p.w_kmajor) {
          kw = e % kFK;
          nn = e / kFK;
        } else {
          nn = e % kFT;
          kw = e / kFT;
        }
        const int n = n0 + nn, kg = k0 + kw;
        float wv = 0.f;
        if (n < p.n_seg && kg < p.k_seg)
          wv = p.w_kmajor ? w[(long long)n * p.k_seg + kg] : w[(long long)kg * p.n_seg + n];
        ws[kw][nn] = wv;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = as[kk][ty * 4 + i];
          bv[i] = ws[kk][tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* out = static_cast<float*>(p.out);
  const float* res = static_cast<const float*>(p.res);
  const void* bias = p.bias[sn];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= p.R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.n_seg) continue;
      const long long o = (long long)row * p.ldo + (long long)sn * p.n_seg + n;
      float v = acc[i][j] + bias_at(bias, p.bias_bf16, n);
      if (res != nullptr) v += res[o];
      out[o] = v;
    }
  }
}

// a 2-D bf16 map over `rows` rows of `cols` elements, `ld` apart
bool strided_map(CUtensorMap* map, const void* base, long long rows, int cols, long long ld,
                 int box_cols, int box_rows) {
  const long long dims[2] = {cols, rows};
  const long long strides[1] = {ld};
  const int box[2] = {box_cols, box_rows};
  return pdm_hop::encode_map(map, base, 2, dims, strides, box);
}

}  // namespace

// One projection of the staged whole block (see the note at the top):
// out (R rows `ldo` apart, columns seg_n * n_seg + n) = sum over nk_seg K
// segments of A_seg (R x k_seg, rows `lda` apart, pointers a0..a2) times
// W_seg (w0..w2, contiguous: n_seg x k_seg when w_kmajor, k_seg x n_seg
// otherwise; weight sk + sn serves K segment sk and N segment sn, so one
// of nk_seg and nn_seg is 1), plus bias_seg (b0..b2 of n_seg, fp32 or
// bf16 by bias_bf16; null: none), plus res (R rows `ldo` apart; null:
// none), in fp32, stored in the operands' dtype. bf16 needs 16-byte
// aligned operands and lda, ldo, k_seg and n_seg multiples of 8. Returns
// the launch's CUDA error.
extern "C" int pdm_block_project(const void* a0, const void* a1, const void* a2, int lda,
                                 int nk_seg, int k_seg, const void* w0, const void* w1,
                                 const void* w2, int w_kmajor, const void* b0, const void* b1,
                                 const void* b2, int bias_bf16, const void* res, void* out,
                                 int ldo, int R, int nn_seg, int n_seg, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (R < 1 || k_seg < 1 || n_seg < 1 || nk_seg < 1 || nk_seg > 3 || nn_seg < 1 ||
      nn_seg > 3 || (nk_seg > 1 && nn_seg > 1) || n_seg % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* as[3] = {a0, a1, a2};
  const void* wt[3] = {w0, w1, w2};
  ProjArgs p{R, lda, ldo, nk_seg, k_seg, nn_seg, n_seg, w_kmajor, bias_bf16,
             {b0, b1, b2}, res, out};
  const int n_w = nk_seg > nn_seg ? nk_seg : nn_seg;
  for (int i = 0; i < n_w; ++i)
    if (as[i < nk_seg ? i : 0] == nullptr || wt[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == pdm::kBFloat16) {
    if (lda % 8 || ldo % 8 || k_seg % 8 || n_seg % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    ProjMaps m;
    for (int i = 0; i < nk_seg; ++i)
      if (!strided_map(&m.a[i], as[i], R, k_seg, lda, 64, 64))
        return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < n_w; ++i) {
      const bool ok = w_kmajor ? pdm_hop::mat_map(&m.w[i], wt[i], n_seg, k_seg, 64, 64)
                               : pdm_hop::mat_map(&m.w[i], wt[i], k_seg, n_seg, 64, 64);
      if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(w_kmajor ? launch_proj_wgmma<true>(m, p, s)
                                     : launch_proj_wgmma<false>(m, p, s));
  } else if (dtype == pdm::kFloat32) {
    ProjPtrs q;
    for (int i = 0; i < 3; ++i) {
      q.a[i] = static_cast<const float*>(as[i]);
      q.w[i] = static_cast<const float*>(wt[i]);
    }
    const dim3 grid((R + kFT - 1) / kFT, nn_seg * ((n_seg + kFT - 1) / kFT));
    block_proj_f32_kernel<<<grid, 256, 0, s>>>(q, p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
