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
// Design (bf16, the main path). The TPU kernel holds an image's whole
// chain in VMEM; here the bf16 weights alone (512 KB) exceed a block's
// 227 KB. One cluster of `heads` blocks per group of images (one image at
// T > 64; 2 P packed images at T <= 64, see BlockPlan), one block per head,
// two warpgroups, each warpgroup a 64-row strip at a time:
//  1. q_j, k_j, v_j = h W_{q,k,v}[j rows]^T + b: one sweep of the
//     three-stage TMA ring over the strip pairs (64-column chunks of h and
//     of the three weights' HD rows of head j; thread 0 refills a stage
//     once all eight warps are through with it), one wgmma m64n(3 HD)k16
//     per 16 columns, fp32 bias, rounded once straight into head j's
//     swizzled q, k, v tiles beside the ring;
//  2. thread 0 issues W_out's HD rows of head j for the out projection's
//     first three stages into the ring's weight regions; meanwhile each
//     warpgroup runs row 1's single-pass attention on its strips
//     (fwd_strip: the strip's whole score row in registers, P normalized
//     then rounded, P v from registers), writing the lse and att (rounded)
//     to the att scratch (B, T, C) through per-warp staging rows in the
//     ring's activation boxes, whole rows a store;
//  3. after a cluster barrier (every head's att written), the out
//     projection streams att's 64-column chunks (all heads) and W_out's
//     rows through the same ring, the first stages' att boxes completing
//     the barriers their W_out rows armed; the epilogue stages the fp32
//     product in the idle tiles and adds b_out and x in fp32, 16 bytes a
//     lane, its loads of x issued before its stores.
// No copy loop and no block-wide barrier per stage: every operand arrives
// by TMA on an mbarrier. The att scratch costs 2 B T C bytes of L2 traffic
// each way. Shared memory: the ring (3 x 40 KB at HD 64) beside the three
// tiles (96 KB at T 256) and 1 KB: one block an SM, one group of images a
// cluster (clusters that walk several groups were 2.6-4% slower at T 256,
// PERF.md). What bounds it in practice (PERF.md): each block's products
// are 64-192 columns wide, so a stage brings 24-40 KB for 1-3 MFLOP and
// the sweeps are bound by the ring's traffic from L2; at T <= 64 the
// packing keeps both warpgroups busy (4 images a strip at T 16). Nothing
// goes through atomics: the result is deterministic.
//
// fp32 (parity runs): the CUDA cores, one image a cluster, thread t owning
// token row t; q_t stays in registers, k and v in shared memory (read as
// broadcasts), att_t in rows of HD + 1 floats that the peers read.

#include "attention_block_common.cuh"

namespace {

using namespace pdm_block;
using bf = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA

struct FwdMaps {
  CUtensorMap h, att;            // rows maps of h and of the att scratch
  CUtensorMap wq, wk, wv, wout;  // weight rows: boxes {64, HD}
};

// The out projection's loads of chunk (pair p, column chunk kc): W_out's
// HD rows of head j for those columns (WoutLoad: issued while the
// attention runs) and the pair's boxes of the att scratch (AttLoad: after
// every head's att is written).
template <int HD>
struct WoutLoad {
  const CUtensorMap* w;
  int nkc, j;
  __device__ __forceinline__ void operator()(int i, char* st, uint64_t* bar) const {
    pdm_hop::tma_load_2d(st + 2 * kBox, w, bar, (i % nkc) * kChunk, j * HD);
  }
};

template <bool Packed>
struct AttLoad {
  const CUtensorMap* att;
  int img0, per_strip;
  __device__ __forceinline__ void operator()(int p, int kc, char* st, uint64_t* bar) const {
    load_pair<Packed>(st, att, bar, kc * kChunk, p, img0, per_strip);
  }
};

template <int HD, int NC>
__global__ void __launch_bounds__(kThreads, 1)
attention_block_fwd_wgmma_kernel(const __grid_constant__ FwdMaps m, const bf* __restrict__ x,
                                 const void* bq, const void* bk, const void* bv,
                                 const void* bout, bf* att, bf* __restrict__ out,
                                 float* __restrict__ lse, int B, int n_tok, int heads,
                                 int trs, float scale_log2, int bias_bf16) {
  using namespace pdm_hop;
  constexpr bool kPacked = NC == 1;
  constexpr int kStrips = kPacked ? 2 : NC + (NC & 1);
  constexpr int kPairs = kStrips / 2;
  constexpr int kRowsT = kStrips * 64;
  constexpr int kTile = Stripe<HD>::bytes(kRowsT);
  constexpr int kStage = stage_bytes(HD, false);
  constexpr uint32_t kOutTx = 2 * kBox + HD * 128;
  static_assert(box_rows_fit(0, HD * 2 + 16), "att staging");
  extern __shared__ char smem_tma[];
  __shared__ StageRing<kStages> ring;

  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  const int C = heads * HD, nkc = (C + kChunk - 1) / kChunk;
  const int wg = threadIdx.x / kWgThreads, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = kPacked ? 64 >> trs : 1;
  const int imgs = kPacked ? 2 * per : 1;
  char* mem = aligned_smem(smem_tma);  // the ring, then the q, k, v tiles
  char* qs = mem + kStages * kStage;
  char* ks = qs + kTile;
  char* vs = ks + kTile;
  // a warp's staging rows of att during the attention, in the activation
  // boxes of the idle ring, while W_out's rows land beside them
  char* abuf = box_rows(mem, kStage, 0, HD * 2 + 16, warp);
  // the out projection's epilogue stages the fp32 product through the idle
  // tiles; a lane then adds 8 columns of x and b_out and writes 16 bytes of
  // a row, its x loads all issued before its first store
  constexpr int kRS = HD * 4 + 16, kVR = HD / 8, kIt = 16 * kVR / 32;
  char* fbuf = qs + warp * 16 * kRS;
  const int g = lane >> 2, tq = lane & 3;
  const int vc = (lane % kVR) * 8;  // the lane's 8 columns, the same in every row it takes
  float bo[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) bo[q] = load_bias(bout, j * HD + vc + q, bias_bf16);
  const void* const b[3] = {bq, bk, bv};
  char* const t[3] = {qs, ks, vs};
  if (threadIdx.x == 0) {
    ring_init(ring);
    fence_barrier_init();
  }
  __syncthreads();

  const int img0 = blockIdx.y * imgs;
  RingPos pos{0, 0};
  const Rows<kPacked> lay = block_rows<kPacked>(n_tok, B, img0, trs, heads, j);
  const ProjLoad<HD, 3, kPacked> proj{&m.h, {&m.wq, &m.wk, &m.wv}, nkc, j, img0, per};

  // 1. q, k, v of head j, straight into the tiles
  project_tiles<HD, 3, kPacked>(ring, mem, kStage, pos, proj, b, t, kPairs, bias_bf16);
  fence_proxy_async_shared();  // the tiles' generic stores, before wgmma reads them
  __syncthreads();

  // 2. the attention of head j, att staged into the att scratch in whole
  // rows, while W_out's rows for the out projection's first stages load
  const WoutLoad<HD> wout{&m.wout, nkc, j};
  ring_prefetch(ring, mem, kStage, pos, ahead(kPairs * nkc, kOutTx, wout));
#pragma unroll 1
  for (int s = wg; s < (kPacked ? 2 : NC); s += 2)
    fwd_strip<HD, NC>(qs, ks, vs, kRowsT, kRowsT, s, lay, scale_log2,
                      [&](const auto& o, float mul, int row0) {
                        store_staged<HD>(att, o[0], mul, lay, row0, C, j * HD, abuf);
                      },
                      lse);

  // 3. every head's att is written: the out projection of head j's columns
  fence_proxy_async_shared();
  fence_proxy_async_global();
  cluster.sync();
  fence_proxy_async_global();
  const AttLoad<kPacked> att_ld{&m.att, img0, per};
  head_sweep<HD, false>(
      ring, mem, kStage, pos, kPairs, nkc, kOutTx,
      [&](int p, int kc, char* st, uint64_t* bar) {
        att_ld(p, kc, st, bar);
        wout(p * nkc + kc, st, bar);
      },
      att_ld,
      [&](int p, const float (&acc)[HD / 2]) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < HD / 8; ++i)
            *reinterpret_cast<float2*>(fbuf + (g + 8 * r) * kRS + (i * 8 + 2 * tq) * 4) =
                make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
        __syncwarp();
        const int row0 = (2 * p + wg) * 64 + (warp & 3) * 16;
        long long off[kIt];
        uint4 xv[kIt];
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          const int rr = (lane + 32 * it) / kVR;
          off[it] = lay.has(row0 + rr) ? lay.grow(row0 + rr) * C + j * HD + vc : -1;
          if (off[it] >= 0) xv[it] = *reinterpret_cast<const uint4*>(x + off[it]);
        }
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          if (off[it] < 0) continue;
          const int rr = (lane + 32 * it) / kVR;
          const float* a = reinterpret_cast<const float*>(fbuf + rr * kRS) + vc;
          const uint32_t xw[4] = {xv[it].x, xv[it].y, xv[it].z, xv[it].w};
          uint32_t o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            o[q] = pack_bf16(__uint_as_float(xw[q] << 16) + (a[2 * q] + bo[2 * q]),
                             __uint_as_float(xw[q] & 0xffff0000u) + (a[2 * q + 1] + bo[2 * q + 1]));
          *reinterpret_cast<uint4*>(out + off[it]) = make_uint4(o[0], o[1], o[2], o[3]);
        }
        __syncwarp();
      });
}

template <int HD, int NC>
cudaError_t launch_fwd_wgmma(const FwdMaps& m, const BlockPlan& p, const void* x,
                             const void* bq, const void* bk, const void* bv, const void* bout,
                             void* att, void* out, float* lse, int B, int n_tok, int heads,
                             float scale, int bias_bf16, cudaStream_t stream) {
  return launch_cluster(attention_block_fwd_wgmma_kernel<HD, NC>, heads, p.groups, p.smem,
                        stream, m, static_cast<const bf*>(x), bq, bk, bv, bout,
                        static_cast<bf*>(att), static_cast<bf*>(out), lse, B, n_tok, heads,
                        p.trs, scale * kLog2e, bias_bf16);
}

// the tensor maps of a bf16 launch
template <int HD>
bool fwd_maps(FwdMaps* m, const BlockPlan& p, const void* h, const void* wq, const void* wk,
              const void* wv, const void* wout, const void* att, int B, int n_tok, int heads) {
  using namespace pdm_hop;
  const int C = heads * HD;
  const bool packed = p.nc == 1;
  const int box_rows = packed ? 1 << p.trs : 64, box_imgs = packed ? p.per_strip : 1;
  return rows_map(&m->h, h, B, n_tok, C, C, kChunk, box_rows, box_imgs) &&
         rows_map(&m->att, att, B, n_tok, C, C, kChunk, box_rows, box_imgs) &&
         mat_map(&m->wq, wq, C, C, kChunk, HD) && mat_map(&m->wk, wk, C, C, kChunk, HD) &&
         mat_map(&m->wv, wv, C, C, kChunk, HD) && mat_map(&m->wout, wout, C, C, kChunk, HD);
}

template <int HD>
cudaError_t launch_fwd_bf16(const BlockPlan& p, const void* x, const void* h, const void* wq,
                            const void* wk, const void* wv, const void* bq, const void* bk,
                            const void* bv, const void* wout, const void* bout, void* out,
                            float* lse, void* att, int B, int n_tok, int heads, float scale,
                            int bias_bf16, cudaStream_t stream) {
  FwdMaps m;
  if (!fwd_maps<HD>(&m, p, h, wq, wk, wv, wout, att, B, n_tok, heads))
    return cudaErrorInvalidValue;
  switch (p.nc) {
    case 1: return launch_fwd_wgmma<HD, 1>(m, p, x, bq, bk, bv, bout, att, out, lse, B, n_tok, heads, scale, bias_bf16, stream);
    case 2: return launch_fwd_wgmma<HD, 2>(m, p, x, bq, bk, bv, bout, att, out, lse, B, n_tok, heads, scale, bias_bf16, stream);
    case 3: return launch_fwd_wgmma<HD, 3>(m, p, x, bq, bk, bv, bout, att, out, lse, B, n_tok, heads, scale, bias_bf16, stream);
    default: return launch_fwd_wgmma<HD, 4>(m, p, x, bq, bk, bv, bout, att, out, lse, B, n_tok, heads, scale, bias_bf16, stream);
  }
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
cudaError_t launch_fwd(int dtype, const BlockPlan* plan, const void* x, const void* h,
                       const void* wq, const void* wk, const void* wv, const void* bq,
                       const void* bk, const void* bv, const void* wout, const void* bout,
                       void* out, float* lse, void* att, int B, int n_tok, int heads,
                       float scale, int bias_bf16, cudaStream_t stream) {
  if (n_tok < 1 || n_tok > kMaxTok || heads < 1 || heads > 8 || B < 1)
    return cudaErrorInvalidValue;
  if (dtype == pdm::kBFloat16) {
    if (plan == nullptr || att == nullptr || !plan_ok(*plan, B, n_tok, heads, HD, false))
      return cudaErrorInvalidValue;
    return launch_fwd_bf16<HD>(*plan, x, h, wq, wk, wv, bq, bk, bv, wout, bout, out, lse, att,
                               B, n_tok, heads, scale, bias_bf16, stream);
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
// pdm::kFloat32 or pdm::kBFloat16 (bf16: 16-byte aligned tensors, the
// scratch att (B, T, C) and the launch plan of
// ops/attention_block.py::plan_block, checked here; fp32: both unused). hd: 16, 32 or 64; heads <= 8; T <= 256. Returns the launch's
// CUDA error (cudaErrorInvalidValue for an argument or plan refused).
extern "C" int pdm_attention_block_fwd(const void* x, const void* h, const void* wq,
                                       const void* wk, const void* wv, const void* bq,
                                       const void* bk, const void* bv, const void* wout,
                                       const void* bout, void* out, void* lse, void* att,
                                       const void* plan, int B, int n_tok,
                                       int heads, int hd, float scale, int dtype,
                                       int bias_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  auto* p = static_cast<const BlockPlan*>(plan);
  const int bb = bias_dtype == pdm::kBFloat16;
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_fwd<16>(dtype, p, x, h, wq, wk, wv, bq, bk, bv, wout, bout, out, l, att, B, n_tok, heads, scale, bb, s); break;
    case 32: err = launch_fwd<32>(dtype, p, x, h, wq, wk, wv, bq, bk, bv, wout, bout, out, l, att, B, n_tok, heads, scale, bb, s); break;
    case 64: err = launch_fwd<64>(dtype, p, x, h, wq, wk, wv, bq, bk, bv, wout, bout, out, l, att, B, n_tok, heads, scale, bb, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
