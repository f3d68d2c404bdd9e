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
// of that. At the single-head 32x32's B 64, T 256, C 256 the forward's two
// projections move ~59 MB for 8.6 GFLOP: bytes bound them (17.6 us).
//
// Design (bf16): 128 x 128 output tiles, persistent: one block an SM walks
// the tiles blockIdx.x, blockIdx.x + gridDim.x, ... (an output row tile's
// column tiles side by side, so A's rows come from L2 after the first).
// A block is a producer warp and two consumer warpgroups, one a tile's
// 64-row half. The producer keeps a four-stage TMA ring of 64-deep chunks
// in flight across tile boundaries, so a tile's epilogue runs while the
// next tile's first chunks load; a stage carries A's 128 x 64 box and W's
// 128 x 64 (K-major, or two 64 x 64 N-major panels). Boxes are 128-byte
// swizzled and read in place by wgmma m64n128k16; boxes past a segment's
// edge are TMA's zero fill, so a K segment that is not a multiple of 64
// adds nothing of its neighbour. The epilogue adds the bias (held in
// registers while the column tile stays) and the residual in fp32, rounds
// once, writes the warpgroup's swizzled 64 x 128 staging tile with
// stmatrix, and one thread stores it with TMA (a map per N segment, so a
// store clips at the segment's edge and at the last row); the next
// epilogue waits only for that store to have read the tile. Development
// variants with parts cut out showed where a tile's time went: with the
// bias loaded by 32 scalar loads a thread each tile, and the arguments
// copied to local memory by an indexed bias pointer, the epilogue took
// most of the qkv projection at the single-head 32x32's shape; keeping a
// block's W columns resident in shared memory (half the loads) moved no
// time, and giving each warpgroup tiles and a ring of its own lost time.
// The predecessor
// (128 x 64 tiles, one a block, A
// re-read once per 64 output columns, bf16 pairs stored from registers)
// took 0.0913 ms for row 5's three launches at that shape, 1.66x the
// library's (H100 80GB HBM3 at 700 W, PERF.md).
// fp32 (parity runs) runs on the CUDA cores, full fp32 products (no TF32),
// 64 x 64 tiles, 4 x 4 outputs a thread.

#include "attention_block_common.cuh"

namespace {

using bf = __nv_bfloat16;

constexpr int kPM = 128;   // output rows a tile (two warpgroups of 64)
constexpr int kPN = 128;   // output columns a tile
constexpr int kPK = 64;    // contraction depth a stage
constexpr int kPStages = 4;
constexpr int kPBox = 64 * kPK * 2;          // one 64 x 64 bf16 box
constexpr int kPChunk = 2 * kPBox;           // A's 128 x 64, or W's 128 x 64
constexpr int kPOut = 64 * kPN * 2;          // a warpgroup's output staging tile
constexpr int kPConsumers = 2 * pdm_hop::kWgThreads;
constexpr int kPThreads = kPConsumers + 32;  // and the producer warp

struct ProjArgs {
  int R, lda, ldo, nk_seg, k_seg, nn_seg, n_seg, w_kmajor, bias_bf16;
  const void* bias[3];
  const void* res;  // residual (R rows, ldo apart) or null
  void* out;
};

struct ProjMaps {
  CUtensorMap a[3], w[3];  // A's K segments (boxes 64 x 128), the weights
  CUtensorMap o[3];        // out's N segments (boxes 64 x 64), for the stores
};

// ops/attention_block.py::ProjectPlan, field for field
struct ProjPlan {
  int tiles, blocks, stages, smem;
};

bool plan_ok(const ProjPlan* p, int R, int nn_seg, int n_seg) {
  if (p == nullptr) return false;
  const long long tiles = (long long)((R + kPM - 1) / kPM) * nn_seg * ((n_seg + kPN - 1) / kPN);
  return tiles == p->tiles && tiles <= 0x7fffffffLL && p->blocks >= 1 &&
         p->blocks <= p->tiles && p->stages == kPStages &&
         p->smem == kPStages * 2 * kPChunk + 2 * kPOut + 1024;
}

__device__ __forceinline__ float bias_at(const void* b, int bias_bf16, int n) {
  if (b == nullptr) return 0.f;
  return bias_bf16 ? __bfloat162float(static_cast<const bf*>(b)[n])
                   : static_cast<const float*>(b)[n];
}

// a 64 x 64 box of shared memory to a 2-D map at (column, row), through
// the bulk-async group of the issuing thread
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int col,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(pdm_attn::smem_addr(src)), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the issuing thread's stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// four 8 x 8 bf16 matrices from their mma fragments (a register each) to
// shared memory, each lane giving the address of one matrix row (lanes
// 8 j .. 8 j + 7: matrix j's rows)
__device__ __forceinline__ void stmatrix_x4(const void* row, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   pdm_attn::smem_addr(row)),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// the 128 threads of consumer warpgroup wg meet (named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// KMajor: W read as W[n][k] (h W^T), else W[k][n]; a template parameter,
// so that no branch sits between a chunk's products.
template <bool KMajor>
__global__ void __launch_bounds__(kPThreads, 1)
block_proj_wgmma_kernel(const __grid_constant__ ProjMaps m, const ProjArgs p, int tiles) {
  using namespace pdm_hop;
  extern __shared__ char smem_tma[];
  __shared__ __align__(8) uint64_t full[kPStages], empty[kPStages];
  __shared__ __align__(8) float bsm[2][kPN];  // each warpgroup's tile's bias, fp32
  const int ntps = (p.n_seg + kPN - 1) / kPN;  // column tiles of one N segment
  const int n_nt = p.nn_seg * ntps;              // column tiles
  const int kc_seg = (p.k_seg + kPK - 1) / kPK;  // chunks of one K segment
  const int nk = p.nk_seg * kc_seg;
  const int wg = threadIdx.x / kWgThreads;  // 0, 1: consumers; 2: the producer warp
  char* ring = aligned_smem(smem_tma);
  char* staging = ring + kPStages * 2 * kPChunk;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kPStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kPConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: every chunk of every tile of the block, in order;
    // chunk n (counted over the block's tiles) into stage n % kPStages:
    // A's 128 x 64 box and W's 128 columns at its depth
    if (threadIdx.x == kPConsumers) {
      int n = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int rt = t / n_nt, sn = (t - rt * n_nt) / ntps;
        const int n0 = (t - rt * n_nt - sn * ntps) * kPN;
        for (int i = 0; i < nk; ++i, ++n) {
          const int st = n % kPStages;
          if (n >= kPStages) mbar_wait(&empty[st], ((n / kPStages) - 1) & 1);
          mbar_expect_tx(&full[st], 2 * kPChunk);
          char* dst = ring + st * 2 * kPChunk;
          const int sk = i / kc_seg, k0 = (i - sk * kc_seg) * kPK;
          tma_load_2d(dst, &m.a[sk], &full[st], k0, rt * kPM);
          const CUtensorMap* w = &m.w[sk + sn];
          char* wd = dst + kPChunk;
          if (KMajor) {
            tma_load_2d(wd, w, &full[st], k0, n0);
          } else {
#pragma unroll
            for (int q = 0; q < kPN / 64; ++q)
              tma_load_2d(wd + q * kPBox, w, &full[st], n0 + q * 64, k0);
          }
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  char* staged = staging + wg * kPOut;  // two 64 x 64 swizzled boxes
  const bf* res = static_cast<const bf*>(p.res);
  int n = 0, bias_tile = -1;
  bool stored = false;
  float2 bv[kPN / 8];  // the bias of the thread's columns, while the column tile stays
#pragma unroll
  for (int i = 0; i < kPN / 8; ++i) bv[i] = make_float2(0.f, 0.f);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t / n_nt, sn = (t - rt * n_nt) / ntps;
    const int n0 = (t - rt * n_nt - sn * ntps) * kPN;
    const int r0 = rt * kPM + wg * 64;  // this warpgroup's rows

    float acc[kPN / 2];
#pragma unroll
    for (int i = 0; i < kPN / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int i = 0; i < nk; ++i, ++n) {
      const int st = n % kPStages;
      mbar_wait(&full[st], (n / kPStages) & 1);
      const char* a = ring + st * 2 * kPChunk;
      const char* w = a + kPChunk;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPK / 16; ++kk) {
        if constexpr (KMajor)
          wgmma_ss_t<kPN, 0, 0>(acc, desc_k<64>(a, kPM, wg * 64, kk), desc_k<64>(w, kPN, 0, kk));
        else
          wgmma_ss_t<kPN, 0, 1>(acc, desc_k<64>(a, kPM, wg * 64, kk), desc_mn<64>(w, 64, kk, 0));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // acc: rows 16 warp + g (+ 8) of the warpgroup's 64, columns 8 i + 2
    // tq. A new column tile's 128 bias values (0 without a bias) go through
    // shared memory in fp32, one a thread, into registers (32 scalar loads
    // a thread, each tile, held the qkv projection back; the bias pointer
    // is selected, not indexed, so the arguments stay out of local memory).
    // Every residual value the thread needs is loaded before the first
    // store, so the loads overlap.
    const void* bias = sn == 0 ? p.bias[0] : sn == 1 ? p.bias[1] : p.bias[2];
    const int ct = t - rt * n_nt;
    const bool new_bias = ct != bias_tile;
    if (new_bias) {
      const int c = n0 + (threadIdx.x & 127);
      bsm[wg][threadIdx.x & 127] = c < p.n_seg ? bias_at(bias, p.bias_bf16, c) : 0.f;
      bias_tile = ct;
    }
    const int row0 = r0 + warp * 16 + g;
    uint32_t rv[2][kPN / 8];
#pragma unroll
    for (int i = 0; i < kPN / 8; ++i) rv[0][i] = rv[1][i] = 0u;
    if (res != nullptr) {
#pragma unroll
      for (int i = 0; i < kPN / 8; ++i) {
        const int c = n0 + i * 8 + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (c < p.n_seg && row0 + 8 * r < p.R)
            rv[r][i] = *reinterpret_cast<const uint32_t*>(
                res + (long long)(row0 + 8 * r) * p.ldo + (long long)sn * p.n_seg + c);
      }
    }
    // the warpgroup's last store has read the staging tile
    if (stored && (threadIdx.x & 127) == 0) bulk_wait_read();
    wg_sync(wg);
    if (new_bias) {
#pragma unroll
      for (int i = 0; i < kPN / 8; ++i)
        bv[i] = *reinterpret_cast<const float2*>(&bsm[wg][i * 8 + 2 * tq]);
    }
    // the values rounded once, as bf16 pairs in their fragments' places,
    // into the swizzled staging tile by stmatrix: columns 8 i .. 8 i + 15
    // of the warp's 16 rows a store (lane l: row l % 8 + 8 ((l / 8) % 2),
    // column 8 (i + l / 16))
    const int srow = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int i = 0; i < kPN / 8; i += 2) {
      uint32_t f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ii = i + (j >> 1), r = j & 1;
        const float v0 = acc[4 * ii + 2 * r] + bv[ii].x + __uint_as_float(rv[r][ii] << 16);
        const float v1 = acc[4 * ii + 2 * r + 1] + bv[ii].y +
                         __uint_as_float(rv[r][ii] & 0xffff0000u);
        f[j] = pdm_attn::pack_bf16(v0, v1);
      }
      const uint32_t o = srow * 128 + ((i % 8) + (lane >> 4)) * 16;
      stmatrix_x4(staged + (i / 8) * kPBox + (o ^ ((srow & 7) << 4)), f[0], f[1], f[2], f[3]);
    }
    fence_proxy_async_shared();
    wg_sync(wg);
    if ((threadIdx.x & 127) == 0 && r0 < p.R) {
#pragma unroll
      for (int q = 0; q < kPN / 64; ++q)
        if (n0 + q * 64 < p.n_seg) tma_store_2d(&m.o[sn], staged + q * kPBox, n0 + q * 64, r0);
      bulk_commit();
      stored = true;
    }
  }
  if ((threadIdx.x & 127) == 0 && stored) bulk_wait();
}

template <bool KMajor>
cudaError_t launch_proj_wgmma(const ProjMaps& m, const ProjArgs& p, const ProjPlan& plan,
                              cudaStream_t s) {
  auto kernel = block_proj_wgmma_kernel<KMajor>;
  cudaError_t err = pdm_hop::allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<plan.blocks, kPThreads, plan.smem, s>>>(m, p, plan.tiles);
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
// aligned operands, lda, ldo, k_seg and n_seg multiples of 8, and `plan`,
// ops/attention_block.py::plan_project's (refused unless it is this
// shape's); fp32 takes none. Returns the launch's CUDA error.
extern "C" int pdm_block_project(const void* a0, const void* a1, const void* a2, int lda,
                                 int nk_seg, int k_seg, const void* w0, const void* w1,
                                 const void* w2, int w_kmajor, const void* b0, const void* b1,
                                 const void* b2, int bias_bf16, const void* res, void* out,
                                 int ldo, int R, int nn_seg, int n_seg, int dtype,
                                 void* stream, const void* plan) {
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
    const auto* pl = static_cast<const ProjPlan*>(plan);
    if (lda % 8 || ldo % 8 || k_seg % 8 || n_seg % 8 ||
        !plan_ok(pl, R, nn_seg, n_seg))
      return static_cast<int>(cudaErrorInvalidValue);
    ProjMaps m;
    for (int i = 0; i < nk_seg; ++i)
      if (!strided_map(&m.a[i], as[i], R, k_seg, lda, 64, kPM))
        return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < n_w; ++i) {
      const bool ok = w_kmajor ? pdm_hop::mat_map(&m.w[i], wt[i], n_seg, k_seg, 64, kPN)
                               : pdm_hop::mat_map(&m.w[i], wt[i], k_seg, n_seg, 64, 64);
      if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int i = 0; i < nn_seg; ++i)
      if (!strided_map(&m.o[i], static_cast<bf*>(out) + (long long)i * n_seg, R, n_seg, ldo,
                       64, 64))
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(w_kmajor ? launch_proj_wgmma<true>(m, p, *pl, s)
                                     : launch_proj_wgmma<false>(m, p, *pl, s));
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
