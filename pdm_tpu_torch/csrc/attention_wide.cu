// Spatial softmax attention at wide head dims (every multiple of 8 above
// 128), forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels pdm_tpu/ops/attention.py::_fwd_kernel (launched
// by _fsa_call) and ::_bwd_kernel (launched by _fsa_bwd) at the head dims
// that attention.cu and attention_bwd.cu do not instantiate: a UNet whose
// config says attention_head_dim null has one head per attention block, so
// its head dim is the block's width (256 in a single-head 32x32 DDPM, 512
// in the 256x256 google/ddpm-*-256 family). Same functions and rounding
// points as those kernels (see their notes): fp32 logits scaled after the
// product, the softmax over the whole row, P normalized and then rounded
// to the input dtype before P v, the per-row logsumexp saved; the backward
// from that lse with P and ds rounded where the reference rounds them and
// the row sums D = sum_k P * dp taken from the rounded P.
//
// Layout as theirs: q, k, v are (B, T, C), C = heads * hd, token rows `ld`
// apart (the column thirds of the fused qkv projection); do and out are
// contiguous (B, T, C); dq, dk, dv are (B, T, C) with token rows `ldo`
// apart (C, or 3C for the column thirds of the whole block's dqkv); lse
// and D are (B, heads, T) fp32.
//
// Why kernels of their own: the narrow kernels keep a whole head-dim row
// in registers (a warp's 16 x HD output accumulator, the fp32 kernels' q
// and output rows), 256 and more fp32 registers a thread at HD 512. Here
// no register array spans the head dim, so no head dim is too wide.
//
// The bf16 forward at T <= 256 (every driven shape: the single-head 32x32
// DDPM's T 256 and 16, the family's 256 and 64) is one pass on wgmma
// (wide1p below): a strip's whole score row S (64 x 64 NC fp32,
// NC = T / 64 rounded up) stays in registers while the head dim is
// contracted over 64-column chunks that a four-stage TMA ring brings;
// then the exact softmax, P normalized and rounded in registers as the A
// operand of O = P v, v's 64-column chunks coming through the same ring
// (loaded while the softmax runs), each output chunk stored through
// per-warp staging rows. Two warpgroups a block take two strips of one
// head and share every k and v chunk (one at NC 1); the output chunks
// are split over blocks only as far as the card's SMs hold them, each
// split recomputing the same S in the same order. Its two-pass
// predecessor (below, kept for T > 256) computed each score tile 2 n_oc
// times (two passes times hd / 128 output blocks) on mma.sync with no
// load ahead: at the family's B 8, T 256 0.0959 ms, the one pass 0.0129
// (H100 80GB HBM3 at 700 W, PERF.md).
//
// The rest is the simple first design:
//  * the head dim is contracted in chunks (64 columns in bf16, 32 in
//    fp32): q k^T (and do v^T) accumulate chunk by chunk over tiles staged
//    in shared memory, the last chunk zero-filled past hd, so the score
//    tile alone (64 queries x 64 keys in bf16, 32 keys a thread in fp32)
//    stays in registers;
//  * the output's head dim is cut across blocks: a block writes 128 (bf16)
//    or 64 (fp32) output columns of its 64 rows, and recomputes the scores
//    it needs.
// Every block of a row computes bitwise the same scores, lse and D (one
// fixed summation order), so no block reads another's results and
// nothing is atomic: two calls give the same bits.
//
// What bounds it on the H100: the 256x256 family's call, B 8, T 256, one
// head of 512 in bf16, must move ~8.4 MB (2.5 us at 3.35 TB/s) and do
// 1.07 GFLOP (1.1 us at the bf16 tensor-core peak). The backward computes
// more than that: the dq kernel its scores and dp twice per output block,
// the dk kernel once per output block, and every operand chunk crosses L2
// once per tile that uses it, with two barriers around each chunk and no
// load ahead. Its time beside the bound is in PERF.md.
//
// Two-pass kernels, all with 128 (bf16) or 64 (fp32) threads:
//  * bf16 (mma.sync m16n8k16, fp32 accumulate; the fragments and tile
//    helpers of attention_common.cuh): grid (query tiles of 64, heads x
//    n_oc, B) for the forward above T 256 and dq; (key tiles of 64, heads
//    x n_oc x 2, B) for dk and dv, each block one of the two (a dv block
//    needs no dp).
//  * fp32 on the CUDA cores (full fp32 products, no TF32), one thread per
//    query row (forward, dq) or key row (dk, dv), tiles of 32 rows, the
//    other side's rows read from shared memory as broadcasts.

#include "attention_common.cuh"
#include "attention_hopper.cuh"

namespace {

using namespace pdm_attn;

constexpr float kLog2e = 1.4426950408889634f;

// bf16: head-dim columns per contraction chunk, output columns per block,
// and the padded shared-memory rows of their tiles (8 rows hit 8 bank
// groups, as attention_common.cuh's tiles)
constexpr int kDC = 64;
constexpr int kSC = kDC + 8;
constexpr int kOC = 128;
constexpr int kSO = kOC + 8;
static_assert(kTile * kSO <= 2 * kTile * kSC, "an output tile overlays two chunk tiles");

// fp32: rows (threads) per block, rows per shared tile of the other side,
// head-dim columns per contraction chunk, output columns per block
constexpr int kFQ = 64;
constexpr int kFK = 32;
constexpr int kFD = 32;
constexpr int kFO = 64;

__host__ __device__ constexpr int out_blocks(int hd, int width) {
  return (hd + width - 1) / width;
}

// ---------------------------------------------------------------------------
// bf16 building blocks

// acc += x y^T over one 64-column chunk: this warp's 16 rows of the x tile
// against the 64 rows of the y tile (both kTile x kSC), as load_a and
// tile_dot do at HD 64, accumulating
__device__ __forceinline__ void chunk_dot(float (&acc)[kTile / 8][4],
                                          const __nv_bfloat16* xt,
                                          const __nv_bfloat16* yt, int warp,
                                          int lane) {
  const int row_off = (lane & 7) + (lane >> 4) * 8;
  const int col_off = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kDC / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, xt + (warp * 16 + (lane & 15)) * kSC + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, yt + (np * 16 + row_off) * kSC + kk * 16 + col_off);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&t)[kTile / 8][4]) {
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
}

// One operand pair of a score tile: rows [xr0, xr0 + 64) of the x stripe
// against rows [yr0, yr0 + 64) of the y stripe, contracted over hd.
struct Pair {
  const __nv_bfloat16* x;
  long long ldx;
  int xr0;
  const __nv_bfloat16* y;
  long long ldy;
  int yr0;
};

// s (= x y^T of pair a) and, when `two`, t (= x y^T of pair b), chunk by
// chunk over the head dim; rows past n_tok and columns past hd are zero.
// Called by every thread of the block; `busy` warps compute. `at_chunk0`
// runs between the first chunk's barriers (for staging per-tile values).
template <typename F>
__device__ __forceinline__ void score_tiles(float (&s)[kTile / 8][4],
                                            float (&t)[kTile / 8][4], bool two,
                                            const Pair& a, const Pair& b,
                                            __nv_bfloat16* sm, int n_tok, int hd,
                                            bool busy, int warp, int lane,
                                            F at_chunk0) {
  zero(s);
  zero(t);
  __nv_bfloat16* xa = sm;
  __nv_bfloat16* ya = sm + kTile * kSC;
  __nv_bfloat16* xb = sm + 2 * kTile * kSC;
  __nv_bfloat16* yb = sm + 3 * kTile * kSC;
  for (int d0 = 0; d0 < hd; d0 += kDC) {
    __syncthreads();  // the previous chunk (or output tile) is consumed
    load_rows<kDC>(xa, a.x + d0, a.xr0, n_tok, a.ldx, kSC, hd - d0);
    load_rows<kDC>(ya, a.y + d0, a.yr0, n_tok, a.ldy, kSC, hd - d0);
    if (two) {
      load_rows<kDC>(xb, b.x + d0, b.xr0, n_tok, b.ldx, kSC, hd - d0);
      load_rows<kDC>(yb, b.y + d0, b.yr0, n_tok, b.ldy, kSC, hd - d0);
    }
    if (d0 == 0) at_chunk0();
    __syncthreads();
    if (busy) {
      chunk_dot(s, xa, ya, warp, lane);
      if (two) chunk_dot(t, xb, yb, warp, lane);
    }
  }
}

// scores in log2 units (times scale * log2(e)), keys past n_tok at -inf
__device__ __forceinline__ void scale_mask(float (&s)[kTile / 8][4], int lane,
                                           int k0, int n_tok, float scale_log2) {
  const int tq = lane & 3;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * tq + (e & 1);
      s[n][e] = key < n_tok ? s[n][e] * scale_log2 : -INFINITY;
    }
}

// ---------------------------------------------------------------------------
// bf16 forward: two passes over the keys, as attention.cu's two-pass kernel

__global__ void __launch_bounds__(kTcThreads)
attention_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int n_tok, int heads, int hd,
                          long long ld, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sm[2 * kTile * kSC];  // q, k chunks
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kSO];      // v's columns

  const int n_oc = out_blocks(hd, kOC);
  const int h = blockIdx.y / n_oc, oc = blockIdx.y % n_oc, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool busy = q0 + warp * 16 < n_tok;
  const int C = heads * hd;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  auto nothing = [] {};

  float s[kTile / 8][4], unused[kTile / 8][4];
  // pass 1: row max m and softmax sum l (log2 units) of rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    const Pair qk{q + img, ld, q0, k + img, ld, k0};
    score_tiles(s, unused, false, qk, qk, sm, n_tok, hd, busy, warp, lane, nothing);
    if (!busy) continue;
    scale_mask(s, lane, k0, n_tok, scale_log2);
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

  // pass 2: p = exp(s - m) / l rounded to bf16, o += p v over this block's
  // output columns [oc * 128, oc * 128 + 128)
  float o[kOC / 8][4];
#pragma unroll
  for (int d = 0; d < kOC / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  uint32_t a[kTile / 16][4];
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    const Pair qk{q + img, ld, q0, k + img, ld, k0};
    score_tiles(s, unused, false, qk, qk, sm, n_tok, hd, busy, warp, lane, nothing);
    if (busy) {
      scale_mask(s, lane, k0, n_tok, scale_log2);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = exp2f(s[n][e] - m[e >> 1]) * inv_l[e >> 1];
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) pack_a(a[j], s, j);  // rounds to bf16
    }
    __syncthreads();  // vs is consumed
    load_rows<kOC>(vs, v + img + oc * kOC, k0, n_tok, ld, kSO, hd - oc * kOC);
    __syncthreads();
    if (busy) tile_product<kOC>(o, a, vs, lane);
  }

  if (!busy) return;
  store_rows<kOC>(out + (long long)h * hd + oc * kOC, o, 1.f, (long long)b * n_tok,
                  q0 + warp * 16, n_tok, C, lane, hd - oc * kOC);
  if (oc == 0 && tq == 0) {
    const float ln2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < n_tok)
        lse[((long long)b * heads + h) * n_tok + row] = m[r] * ln2 + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward at T <= 256: one pass on wgmma (the redesign of row 1w)
//
// A block is one 64-row query strip of one (image, head) and a range of the
// output's 64-column chunks, one warpgroup. Thread 0 keeps a four-stage TMA
// ring of 64-column head-dim chunks in flight: first the strip's q chunk
// and the head's k chunk (all NC 64-row key chunks in one box), contracted
// into the strip's whole score row S (64 x 64 NC fp32, in registers) by
// wgmma; then v's column chunks of the block's output range, which the same
// ring brings while the softmax runs. The softmax is exact (row max and sum
// over the whole row), P is normalized and rounded to bf16 in registers as
// the A operand of O = P v (wgmma, v N-major), and each 64-column output
// chunk is stored through per-warp staging rows. The scores are computed
// once per block: the output chunks are split over gridDim.y blocks only to
// fill the card (32 strips at the family's B 8, T 256), each split
// recomputing the same S in the same order, so every split writes bitwise
// the values an unsplit block would.

namespace wide1p {

constexpr int kStages = 4;
constexpr int kChunk = 64;                    // head-dim columns a chunk
constexpr int kQBytes = 64 * kChunk * 2;      // a strip's rows of one chunk
constexpr int kRowBytes = kChunk * 2 + 16;    // a staging row (padded)

struct Maps {
  CUtensorMap q, k, v;  // 4-D stripe maps {hd, heads, T, B}: boxes of 64 rows (q), 64 NC (k, v)
};

__host__ __device__ constexpr int stage_bytes(int nc, int wg) {
  return wg * kQBytes + nc * 64 * kChunk * 2;
}

// the warp's 16 rows of a 64 x 64 fp32 accumulator, rounded to bf16, to
// output rows `ld` apart at head-dim column col0 of the head's stripe `o`
// through the warp's staging rows `buf`: whole 16-byte vectors a store,
// rows past n_tok and columns past hd not written (hd is a multiple of 8)
__device__ __forceinline__ void store_chunk(__nv_bfloat16* o, const float (&acc)[32],
                                            int row0, int n_tok, long long ld, int col0,
                                            int hd, char* buf) {
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(buf + (g + 8 * r) * kRowBytes + (i * 8 + 2 * tq) * 2) =
          pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * 8; e += 32) {
    const int rr = e >> 3, vv = e & 7;
    const int row = row0 + warp * 16 + rr, col = col0 + vv * 8;
    if (row < n_tok && col < hd)
      *reinterpret_cast<uint4*>(o + (long long)row * ld + col) =
          *reinterpret_cast<const uint4*>(buf + rr * kRowBytes + vv * 16);
  }
  __syncwarp();
}

// A block: WG warpgroups, one 64-row query strip each (strips WG p ..
// WG p + WG - 1 of one (image, head), sharing every k and v chunk), and
// the output chunks [c0, c0 + per_split) of blockIdx.y's split.
template <int NC, int WG>
__global__ void __launch_bounds__(WG * pdm_hop::kWgThreads, 1)
attention_fwd_wide_wgmma_kernel(const __grid_constant__ Maps m, __nv_bfloat16* __restrict__ out,
                                float* __restrict__ lse, int n_tok, int heads, int hd,
                                int per_split, float scale_log2) {
  using pdm_hop::desc_k;
  using pdm_hop::desc_mn;
  constexpr int kGroups = (NC + WG - 1) / WG;  // blocks of strips a head
  constexpr int kKV = NC * 64 * kChunk * 2;    // a chunk of the head's key rows
  constexpr int kStage = stage_bytes(NC, WG);
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(16) char staging[4 * WG][16 * kRowBytes];

  const int grp = blockIdx.x % kGroups, rest = blockIdx.x / kGroups;
  const int h = rest % heads, b = rest / heads;
  const int wg = threadIdx.x >> 7;
  const int strip = grp * WG + wg;
  const int live = NC - grp * WG < WG ? NC - grp * WG : WG;  // strips with rows
  const int n_dc = (hd + kChunk - 1) / kChunk;
  const int c0 = blockIdx.y * per_split;
  const int n_vc = min(n_dc, c0 + per_split) - c0;
  const int total = n_dc + n_vc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  char* ring = pdm_hop::aligned_smem(smem_raw);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      pdm_hop::mbar_init(&full[st], 1);
      pdm_hop::mbar_init(&empty[st], 4 * WG);
    }
    pdm_hop::fence_barrier_init();
  }
  __syncthreads();
  // thread 0: chunk n of the sweep (the live strips' q and the head's k
  // at head-dim chunk n, then v's output chunk c0 + n - n_dc) into stage
  // n % kStages: k (or v) first, then the strips' q boxes
  auto issue = [&](int n) {
    const int st = n % kStages;
    if (n >= kStages) pdm_hop::mbar_wait(&empty[st], ((n / kStages) - 1) & 1);
    char* dst = ring + st * kStage;
    if (n < n_dc) {
      pdm_hop::mbar_expect_tx(&full[st], kKV + live * kQBytes);
      pdm_hop::tma_load(dst, &m.k, &full[st], n * kChunk, h, 0, b);
      for (int w = 0; w < live; ++w)
        pdm_hop::tma_load(dst + kKV + w * kQBytes, &m.q, &full[st], n * kChunk, h,
                          (grp * WG + w) * 64, b);
    } else {
      pdm_hop::mbar_expect_tx(&full[st], kKV);
      pdm_hop::tma_load(dst, &m.v, &full[st], (c0 + n - n_dc) * kChunk, h, 0, b);
    }
  };
  if (threadIdx.x == 0)
    for (int n = 0; n < kStages && n < total; ++n) issue(n);
  // the warp is done with chunk n's stage; thread 0 refills it
  auto release = [&](int n) {
    if (lane == 0) pdm_hop::mbar_arrive(&empty[n % kStages]);
    if (threadIdx.x == 0 && n + kStages < total) issue(n + kStages);
    __syncwarp();
  };
  const bool mine = wg < live;

  // S = q k^T over the head dim, chunk by chunk
  float s[NC * 32];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] = 0.f;
#pragma unroll 1
  for (int n = 0; n < n_dc; ++n) {
    const int st = n % kStages;
    pdm_hop::mbar_wait(&full[st], (n / kStages) & 1);
    const char* ks = ring + st * kStage;
    if (mine) {
      const char* qs = ks + kKV + wg * kQBytes;
      pdm_hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        pdm_hop::wgmma_ss<NC>(s, desc_k<64>(qs, 64, 0, kk), desc_k<64>(ks, NC * 64, 0, kk));
      pdm_hop::wgmma_commit();
      pdm_hop::wgmma_wait_all();
      pdm_hop::reg_fence(s);
    }
    release(n);
  }

  // keys past n_tok at -inf; exact row max and sum of rows g and g + 8,
  // the scale folded into the exponent
  if (n_tok < NC * 64) {
#pragma unroll
    for (int i = 0; i < NC * 32; ++i)
      if ((i >> 2) * 8 + 2 * tq + (i & 1) >= n_tok) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  const float mc[2] = {mx[0] * scale_log2, mx[1] * scale_log2};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) {
    s[i] = pdm_hop::ex2(fmaf(s[i], scale_log2, -mc[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  uint32_t pa[NC * 4][4];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] *= inv_l[(i >> 1) & 1];
#pragma unroll
  for (int j = 0; j < NC * 4; ++j) pdm_hop::pack_slice(pa[j], s, j);
  if (mine && blockIdx.y == 0 && tq == 0) {
    const float ln2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = strip * 64 + (warp & 3) * 16 + g + 8 * r;
      if (row < n_tok)
        lse[((long long)b * heads + h) * n_tok + row] = mc[r] * ln2 + logf(l[r]);
    }
  }

  // O = P v, one 64-column output chunk at a time
  const int C = heads * hd;
  __nv_bfloat16* o_head = out + (long long)b * n_tok * C + (long long)h * hd;
#pragma unroll 1
  for (int j = 0; j < n_vc; ++j) {
    const int n = n_dc + j, st = n % kStages;
    pdm_hop::mbar_wait(&full[st], (n / kStages) & 1);
    const char* vs = ring + st * kStage;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    if (mine) {
      pdm_hop::wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < NC * 4; ++jj)
        pdm_hop::wgmma_rs<64>(o, pa[jj], desc_mn<64>(vs, NC * 64, jj, 0));
      pdm_hop::wgmma_commit();
      pdm_hop::wgmma_wait_all();
      pdm_hop::reg_fence(o);
      pdm_hop::reg_fence(pa);
    }
    release(n);
    if (mine)
      store_chunk(o_head, o, strip * 64, n_tok, C, (c0 + j) * kChunk, hd, staging[warp]);
  }
}

// The launch at NC key chunks, WG warpgroups a block and `splits` blocks
// over the output chunks of each group of strips.
template <int NC, int WG>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int n_tok, int heads, int hd, long long ld, float scale,
                   int splits, cudaStream_t stream) {
  Maps m;
  if (!pdm_hop::stripe_map<64>(&m.q, q, B, n_tok, heads, hd, ld, 64) ||
      !pdm_hop::stripe_map<64>(&m.k, k, B, n_tok, heads, hd, ld, NC * 64) ||
      !pdm_hop::stripe_map<64>(&m.v, v, B, n_tok, heads, hd, ld, NC * 64))
    return cudaErrorInvalidValue;
  const long long items = (long long)B * heads * ((NC + WG - 1) / WG);
  const int n_dc = (hd + kChunk - 1) / kChunk;
  splits = splits < 1 ? 1 : (splits > n_dc ? n_dc : splits);
  const int per_split = (n_dc + splits - 1) / splits;
  splits = (n_dc + per_split - 1) / per_split;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = kStages * stage_bytes(NC, WG) + 1024;
  auto kernel = attention_fwd_wide_wgmma_kernel<NC, WG>;
  cudaError_t err = pdm_hop::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(items), splits), WG * pdm_hop::kWgThreads, smem,
           stream>>>(m, static_cast<__nv_bfloat16*>(out), lse, n_tok, heads, hd, per_split,
                     scale * kLog2e);
  return cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The launch plan: two strips a block where a head has two or more (they
// share k and v), and the output chunks split over as many blocks as keep
// the grid within the card's SMs.
template <int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int n_tok, int heads, int hd, long long ld, float scale,
                   cudaStream_t stream) {
  constexpr int WG = NC >= 2 ? 2 : 1;
  const long long items = (long long)B * heads * ((NC + WG - 1) / WG);
  const int splits = static_cast<int>(sm_count() / items);
  return launch<NC, WG>(q, k, v, out, lse, B, n_tok, heads, hd, ld, scale, splits, stream);
}

}  // namespace wide1p

// ---------------------------------------------------------------------------
// bf16 backward, dq and D: two sweeps over the keys, as attention_bwd.cu's
// two-pass dq kernel

__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dq_wide_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ dsum, int n_tok, int heads,
                             int hd, long long ld, long long ldo, float scale,
                             float scale_log2) {
  // q, k, do, v chunks; k's output columns overlay the first two
  __shared__ __align__(16) __nv_bfloat16 sm[4 * kTile * kSC];

  const int n_oc = out_blocks(hd, kOC);
  const int h = blockIdx.y / n_oc, oc = blockIdx.y % n_oc, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int C = heads * hd;
  const bool busy = q0 + warp * 16 < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const long long dimg = (long long)b * n_tok * C + (long long)h * hd;
  const long long lrow = ((long long)b * heads + h) * n_tok;
  auto nothing = [] {};

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
    const Pair qk{q + img, ld, q0, k + img, ld, k0};
    const Pair dov{dout + dimg, C, q0, v + img, ld, k0};
    score_tiles(s, dp, true, qk, dov, sm, n_tok, hd, busy, warp, lane, nothing);
    if (!busy) continue;
    scale_mask(s, lane, k0, n_tok, scale_log2);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        D[e >> 1] += round_bf16(exp2f(s[n][e] - lse2[e >> 1])) * dp[n][e];
  }
  D[0] = quad_sum(D[0]);
  D[1] = quad_sum(D[1]);

  // sweep 2: ds = P * dp - P * D rounded to bf16, dq += ds k over this
  // block's output columns
  float acc[kOC / 8][4];
#pragma unroll
  for (int d = 0; d < kOC / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  uint32_t a[kTile / 16][4];
  __nv_bfloat16* ko = sm;
  for (int k0 = 0; k0 < n_tok; k0 += kTile) {
    const Pair qk{q + img, ld, q0, k + img, ld, k0};
    const Pair dov{dout + dimg, C, q0, v + img, ld, k0};
    score_tiles(s, dp, true, qk, dov, sm, n_tok, hd, busy, warp, lane, nothing);
    if (busy) {
      scale_mask(s, lane, k0, n_tok, scale_log2);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = round_bf16(exp2f(s[n][e] - lse2[e >> 1]));
          const float pdp = p * dp[n][e];
          s[n][e] = round_bf16(pdp - p * D[e >> 1]);
        }
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) pack_a(a[j], s, j);
    }
    __syncthreads();  // the chunks are consumed
    load_rows<kOC>(ko, k + img + oc * kOC, k0, n_tok, ld, kSO, hd - oc * kOC);
    __syncthreads();
    if (busy) tile_product<kOC>(acc, a, ko, lane);
  }

  if (!busy) return;
  store_rows<kOC>(dq + (long long)h * hd + oc * kOC, acc, scale, (long long)b * n_tok,
                  q0 + warp * 16, n_tok, ldo, lane, hd - oc * kOC);
  if (oc == 0 && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < n_tok) dsum[lrow + row] = D[r];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, dk or dv: a sweep over the queries per block, as
// attention_bwd.cu's two-pass dk/dv kernel; blockIdx.y's low bit picks dv

__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dkdv_wide_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dsum,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int n_tok,
                               int heads, int hd, long long ld, long long ldo, float scale,
                               float scale_log2) {
  // k, q, v, do chunks; q's or do's output columns overlay the first two
  __shared__ __align__(16) __nv_bfloat16 sm[4 * kTile * kSC];
  __shared__ float lse_s[kTile];  // the query tile's lse, log2 units, +inf past n_tok
  __shared__ float d_s[kTile];    // and its D, 0 past n_tok

  const int n_oc = out_blocks(hd, kOC);
  const bool is_dv = blockIdx.y & 1;
  const int rest = blockIdx.y >> 1;
  const int h = rest / n_oc, oc = rest % n_oc, b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int C = heads * hd;
  const bool busy = k0 + warp * 16 < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const long long dimg = (long long)b * n_tok * C + (long long)h * hd;
  const long long lrow = ((long long)b * heads + h) * n_tok;

  float acc[kOC / 8][4];
#pragma unroll
  for (int d = 0; d < kOC / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float p[kTile / 8][4], dp[kTile / 8][4];
  uint32_t a[kTile / 16][4];
  __nv_bfloat16* ot = sm;
  float* lse_t = lse_s;
  float* d_t = d_s;
  for (int q0 = 0; q0 < n_tok; q0 += kTile) {
    // S^T and dp^T: rows are this warp's keys, columns the tile's queries
    const Pair kq{k + img, ld, k0, q + img, ld, q0};
    const Pair vdo{v + img, ld, k0, dout + dimg, C, q0};
    score_tiles(p, dp, !is_dv, kq, vdo, sm, n_tok, hd, busy, warp, lane, [&] {
      for (int i = threadIdx.x; i < kTile; i += kTcThreads) {
        const int row = q0 + i;
        lse_t[i] = row < n_tok ? lse[lrow + row] * kLog2e : INFINITY;
        d_t[i] = row < n_tok ? dsum[lrow + row] : 0.f;
      }
    });
    if (busy) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * tq + (e & 1);
          p[n][e] = round_bf16(exp2f(p[n][e] * scale_log2 - lse_s[col]));
          if (!is_dv) {
            const float pdp = p[n][e] * dp[n][e];
            dp[n][e] = round_bf16(pdp - p[n][e] * d_s[col]);
          }
        }
      if (is_dv) {
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) pack_a(a[j], p, j);
      } else {
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) pack_a(a[j], dp, j);
      }
    }
    __syncthreads();  // the chunks are consumed
    if (is_dv)
      load_rows<kOC>(ot, dout + dimg + oc * kOC, q0, n_tok, C, kSO, hd - oc * kOC);
    else
      load_rows<kOC>(ot, q + img + oc * kOC, q0, n_tok, ld, kSO, hd - oc * kOC);
    __syncthreads();
    if (busy) tile_product<kOC>(acc, a, ot, lane);  // dv += P^T do, dk += ds^T q
  }

  if (!busy) return;
  store_rows<kOC>((is_dv ? dv : dk) + (long long)h * hd + oc * kOC, acc,
                  is_dv ? 1.f : scale, (long long)b * n_tok, k0 + warp * 16, n_tok, ldo,
                  lane, hd - oc * kOC);
}

// ---------------------------------------------------------------------------
// fp32 building blocks (CUDA cores)

// s[j] = x . y_{r0 + j} for the kFK rows of the y stripe from r0 (zero past
// n_tok), contracted over hd in chunks of kFD through the shared tile ts;
// x is this thread's row (null: an inactive thread, zeros). Called by
// every thread of the block.
__device__ __forceinline__ void scores_f32(float (&s)[kFK], float* ts,
                                           const float* x, const float* __restrict__ y,
                                           long long ldy, int r0, int n_tok, int hd) {
#pragma unroll
  for (int j = 0; j < kFK; ++j) s[j] = 0.f;
  for (int d0 = 0; d0 < hd; d0 += kFD) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kFK * kFD; e += kFQ) {
      const int r = e / kFD, c = e - r * kFD;
      const int row = r0 + r;
      ts[e] = row < n_tok && d0 + c < hd ? y[(long long)row * ldy + d0 + c] : 0.f;
    }
    __syncthreads();
    float xc[kFD];
#pragma unroll
    for (int c = 0; c < kFD; ++c) xc[c] = x && d0 + c < hd ? x[d0 + c] : 0.f;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      const float4* y4 = reinterpret_cast<const float4*>(ts + j * kFD);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < kFD / 4; ++c4) {
        const float4 yy = y4[c4];
        s0 = fmaf(xc[4 * c4 + 0], yy.x, s0);
        s1 = fmaf(xc[4 * c4 + 1], yy.y, s1);
        s2 = fmaf(xc[4 * c4 + 2], yy.z, s2);
        s3 = fmaf(xc[4 * c4 + 3], yy.w, s3);
      }
      s[j] += (s0 + s1) + (s2 + s3);
    }
  }
}

// rows [r0, r0 + kFK) of a stripe, columns [c0, c0 + kFO), into the dense
// tile ot (zero past n_tok and past hd). Called by every thread, between
// barriers.
__device__ __forceinline__ void load_out_f32(float* ot, const float* __restrict__ src,
                                             long long ld, int r0, int c0, int n_tok,
                                             int hd) {
  for (int e = threadIdx.x; e < kFK * kFO; e += kFQ) {
    const int r = e / kFO, c = e - r * kFO;
    const int row = r0 + r;
    ot[e] = row < n_tok && c0 + c < hd ? src[(long long)row * ld + c0 + c] : 0.f;
  }
}

// acc[c] += w * ot row j, over this block's kFO output columns
__device__ __forceinline__ void axpy_row(float (&acc)[kFO], float w, const float* otj) {
  const float4* o4 = reinterpret_cast<const float4*>(otj);
#pragma unroll
  for (int c4 = 0; c4 < kFO / 4; ++c4) {
    const float4 oo = o4[c4];
    acc[4 * c4 + 0] = fmaf(w, oo.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(w, oo.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(w, oo.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(w, oo.w, acc[4 * c4 + 3]);
  }
}

__device__ __forceinline__ void store_out_f32(float* dst, const float (&acc)[kFO],
                                              float mul, int c0, int hd) {
#pragma unroll
  for (int c = 0; c < kFO; ++c)
    if (c0 + c < hd) dst[c0 + c] = acc[c] * mul;
}

// ---------------------------------------------------------------------------
// fp32 forward: a thread a query row, two passes, as attention.cu's fp32
// kernel

__global__ void __launch_bounds__(kFQ)
attention_fwd_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out,
                              float* __restrict__ lse, int n_tok, int heads, int hd,
                              long long ld, float scale) {
  __shared__ __align__(16) float ts[kFK * kFD];
  __shared__ __align__(16) float ot[kFK * kFO];

  const int n_oc = out_blocks(hd, kFO);
  const int h = blockIdx.y / n_oc, oc = blockIdx.y % n_oc, b = blockIdx.z;
  const int t = blockIdx.x * kFQ + threadIdx.x;
  const bool active = t < n_tok;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const float* xrow = active ? q + img + (long long)t * ld : nullptr;

  float s[kFK];
  // pass 1: row max m and softmax sum l = sum_j exp(s_j - m)
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += kFK) {
    scores_f32(s, ts, xrow, k + img, ld, k0, n_tok, hd);
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      if (k0 + j >= n_tok) break;
      const float sj = s[j] * scale;
      if (sj > m) {
        l = l * expf(m - sj) + 1.f;
        m = sj;
      } else {
        l += expf(sj - m);
      }
    }
  }

  // pass 2: p = exp(s - m) / l, acc += p v over this block's columns
  float acc[kFO];
#pragma unroll
  for (int c = 0; c < kFO; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += kFK) {
    scores_f32(s, ts, xrow, k + img, ld, k0, n_tok, hd);
    __syncthreads();  // ot is consumed
    load_out_f32(ot, v + img, ld, k0, oc * kFO, n_tok, hd);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      if (k0 + j >= n_tok) break;
      axpy_row(acc, expf(s[j] * scale - m) / l, ot + j * kFO);
    }
  }

  if (!active) return;
  const int C = heads * hd;
  store_out_f32(out + ((long long)b * n_tok + t) * C + (long long)h * hd, acc, 1.f,
                oc * kFO, hd);
  if (oc == 0) lse[((long long)b * heads + h) * n_tok + t] = m + logf(l);
}

// ---------------------------------------------------------------------------
// fp32 backward, dq and D: a thread a query row, two sweeps over the keys

__global__ void __launch_bounds__(kFQ)
attention_bwd_dq_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse, float* __restrict__ dq,
                                 float* __restrict__ dsum, int n_tok, int heads, int hd,
                                 long long ld, long long ldo, float scale) {
  __shared__ __align__(16) float ts[kFK * kFD];
  __shared__ __align__(16) float ot[kFK * kFO];

  const int n_oc = out_blocks(hd, kFO);
  const int h = blockIdx.y / n_oc, oc = blockIdx.y % n_oc, b = blockIdx.z;
  const int t = blockIdx.x * kFQ + threadIdx.x;
  const bool active = t < n_tok;
  const int C = heads * hd;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const long long drow = ((long long)b * n_tok + t) * C + (long long)h * hd;
  const long long lrow = ((long long)b * heads + h) * n_tok;
  const float* qrow = active ? q + img + (long long)t * ld : nullptr;
  const float* dorow = active ? dout + drow : nullptr;
  const float lt = active ? lse[lrow + t] : 0.f;

  float s[kFK], dp[kFK];
  // sweep 1: D = sum_k P * dp
  float D = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += kFK) {
    scores_f32(s, ts, qrow, k + img, ld, k0, n_tok, hd);
    scores_f32(dp, ts, dorow, v + img, ld, k0, n_tok, hd);
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      if (k0 + j >= n_tok) break;
      D += expf(s[j] * scale - lt) * dp[j];
    }
  }

  // sweep 2: ds = P * dp - P * D, dq += ds k over this block's columns
  float acc[kFO];
#pragma unroll
  for (int c = 0; c < kFO; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < n_tok; k0 += kFK) {
    scores_f32(s, ts, qrow, k + img, ld, k0, n_tok, hd);
    scores_f32(dp, ts, dorow, v + img, ld, k0, n_tok, hd);
    __syncthreads();  // ot is consumed
    load_out_f32(ot, k + img, ld, k0, oc * kFO, n_tok, hd);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      if (k0 + j >= n_tok) break;
      const float p = expf(s[j] * scale - lt);
      const float pdp = p * dp[j];
      axpy_row(acc, pdp - p * D, ot + j * kFO);
    }
  }

  if (!active) return;
  store_out_f32(dq + ((long long)b * n_tok + t) * ldo + (long long)h * hd, acc, scale,
                oc * kFO, hd);
  if (oc == 0) dsum[lrow + t] = D;
}

// ---------------------------------------------------------------------------
// fp32 backward, dk or dv: a thread a key row, a sweep over the queries;
// blockIdx.y's low bit picks dv

__global__ void __launch_bounds__(kFQ)
attention_bwd_dkdv_wide_f32_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ dsum,
                                   float* __restrict__ dk, float* __restrict__ dv,
                                   int n_tok, int heads, int hd, long long ld,
                                   long long ldo, float scale) {
  __shared__ __align__(16) float ts[kFK * kFD];
  __shared__ __align__(16) float ot[kFK * kFO];

  const int n_oc = out_blocks(hd, kFO);
  const bool is_dv = blockIdx.y & 1;
  const int rest = blockIdx.y >> 1;
  const int h = rest / n_oc, oc = rest % n_oc, b = blockIdx.z;
  const int t = blockIdx.x * kFQ + threadIdx.x;
  const bool active = t < n_tok;
  const int C = heads * hd;
  const long long img = (long long)b * n_tok * ld + (long long)h * hd;
  const long long dimg = (long long)b * n_tok * C + (long long)h * hd;
  const long long lrow = ((long long)b * heads + h) * n_tok;
  const float* krow = active ? k + img + (long long)t * ld : nullptr;
  const float* vrow = active ? v + img + (long long)t * ld : nullptr;

  float s[kFK], dp[kFK];
  float acc[kFO];
#pragma unroll
  for (int c = 0; c < kFO; ++c) acc[c] = 0.f;
  for (int q0 = 0; q0 < n_tok; q0 += kFK) {
    scores_f32(s, ts, krow, q + img, ld, q0, n_tok, hd);  // k_t . q_j
    if (!is_dv) scores_f32(dp, ts, vrow, dout + dimg, C, q0, n_tok, hd);  // v_t . do_j
    __syncthreads();  // ot is consumed
    if (is_dv)
      load_out_f32(ot, dout + dimg, C, q0, oc * kFO, n_tok, hd);
    else
      load_out_f32(ot, q + img, ld, q0, oc * kFO, n_tok, hd);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kFK; ++j) {
      if (q0 + j >= n_tok) break;
      const float p = expf(s[j] * scale - lse[lrow + q0 + j]);
      axpy_row(acc, is_dv ? p : p * dp[j] - p * dsum[lrow + q0 + j], ot + j * kFO);
    }
  }

  if (!active) return;
  store_out_f32((is_dv ? dv : dk) + ((long long)b * n_tok + t) * ldo + (long long)h * hd,
                acc, is_dv ? 1.f : scale, oc * kFO, hd);
}

// ---------------------------------------------------------------------------

bool bad_shape(int B, int n_tok, int heads, int hd, int y_blocks) {
  return B < 1 || B > 65535 || n_tok < 1 || heads < 1 || hd < 8 || hd % 8 ||
         y_blocks > 65535;
}

// the bf16 two-pass forward at any T
cudaError_t launch_two_pass(const void* q, const void* k, const void* v, void* out, float* l,
                            int B, int n_tok, int heads, int hd, long long ld, float scale,
                            cudaStream_t s) {
  const int y = heads * out_blocks(hd, kOC);
  if (bad_shape(B, n_tok, heads, hd, y)) return cudaErrorInvalidValue;
  attention_fwd_wide_kernel<<<dim3((n_tok + kTile - 1) / kTile, y, B), kTcThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), l, n_tok,
      heads, hd, ld, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// As pdm_attention_fwd (attention.cu), at any head dim that is a multiple
// of 8 and any T; the wrapper sends it head dims above 128. bf16 at
// T <= 256 runs the one-pass wgmma kernel (16-byte aligned stripes, ld a
// multiple of 8), longer rows the two-pass one (grid y, heads x output
// blocks, at most 65535).
extern "C" int pdm_attention_wide_fwd(const void* q, const void* k, const void* v,
                                      void* out, void* lse, int B, int n_tok,
                                      int heads, int hd, long long ld, float scale,
                                      int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == pdm::kBFloat16 && n_tok <= pdm_hop::kMaxTokens) {
    if (bad_shape(B, n_tok, heads, hd, 1)) return cudaErrorInvalidValue;
    switch ((n_tok + 63) / 64) {
      case 1: err = wide1p::launch<1>(q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s); break;
      case 2: err = wide1p::launch<2>(q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s); break;
      case 3: err = wide1p::launch<3>(q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s); break;
      default: err = wide1p::launch<4>(q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s);
    }
    return static_cast<int>(err);
  } else if (dtype == pdm::kBFloat16) {
    return static_cast<int>(launch_two_pass(q, k, v, out, l, B, n_tok, heads, hd, ld, scale, s));
  } else if (dtype == pdm::kFloat32) {
    const int y = heads * out_blocks(hd, kFO);
    if (bad_shape(B, n_tok, heads, hd, y)) return cudaErrorInvalidValue;
    attention_fwd_wide_f32_kernel<<<dim3((n_tok + kFQ - 1) / kFQ, y, B), kFQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), l, n_tok, heads, hd, ld,
        scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 two-pass forward at any T, the one the one-pass kernel replaced
// at T <= 256: for timing the two designs side by side on one card (the
// wrappers never call it).
extern "C" int pdm_attention_wide_fwd_two_pass(const void* q, const void* k, const void* v,
                                               void* out, void* lse, int B, int n_tok,
                                               int heads, int hd, long long ld, float scale,
                                               int dtype, void* stream) {
  if (dtype != pdm::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_two_pass(q, k, v, out, static_cast<float*>(lse), B, n_tok,
                                          heads, hd, ld, scale,
                                          static_cast<cudaStream_t>(stream)));
}

// As pdm_attention_bwd_dq (attention_bwd.cu), at the same head dims.
extern "C" int pdm_attention_wide_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, void* dq,
                                         void* dsum, int B, int n_tok, int heads,
                                         int hd, long long ld, long long ldo, float scale,
                                         int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* D = static_cast<float*>(dsum);
  if (dtype == pdm::kBFloat16) {
    const int y = heads * out_blocks(hd, kOC);
    if (bad_shape(B, n_tok, heads, hd, y)) return cudaErrorInvalidValue;
    attention_bwd_dq_wide_kernel<<<dim3((n_tok + kTile - 1) / kTile, y, B), kTcThreads,
                                   0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), l,
        static_cast<__nv_bfloat16*>(dq), D, n_tok, heads, hd, ld, ldo, scale,
        scale * kLog2e);
  } else if (dtype == pdm::kFloat32) {
    const int y = heads * out_blocks(hd, kFO);
    if (bad_shape(B, n_tok, heads, hd, y)) return cudaErrorInvalidValue;
    attention_bwd_dq_wide_f32_kernel<<<dim3((n_tok + kFQ - 1) / kFQ, y, B), kFQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l,
        static_cast<float*>(dq), D, n_tok, heads, hd, ld, ldo, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// As pdm_attention_bwd_dkdv (attention_bwd.cu), at the same head dims:
// one launch whose blocks write dk or dv.
extern "C" int pdm_attention_wide_bwd_dkdv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* dsum, void* dk, void* dv, int B,
                                           int n_tok, int heads, int hd, long long ld,
                                           long long ldo, float scale, int dtype,
                                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* D = static_cast<const float*>(dsum);
  if (dtype == pdm::kBFloat16) {
    const int y = 2 * heads * out_blocks(hd, kOC);
    if (bad_shape(B, n_tok, heads, hd, y)) return cudaErrorInvalidValue;
    attention_bwd_dkdv_wide_kernel<<<dim3((n_tok + kTile - 1) / kTile, y, B),
                                     kTcThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), l,
        D, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n_tok, heads,
        hd, ld, ldo, scale, scale * kLog2e);
  } else if (dtype == pdm::kFloat32) {
    const int y = 2 * heads * out_blocks(hd, kFO);
    if (bad_shape(B, n_tok, heads, hd, y)) return cudaErrorInvalidValue;
    attention_bwd_dkdv_wide_f32_kernel<<<dim3((n_tok + kFQ - 1) / kFQ, y, B), kFQ, 0,
                                         s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, D,
        static_cast<float*>(dk), static_cast<float*>(dv), n_tok, heads, hd, ld, ldo,
        scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
