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
// load ahead: at the family's B 8, T 256 0.0950 ms, the one pass 0.0129
// (H100 80GB HBM3 at 700 W, PERF.md).
//
// The bf16 backward at T <= 256 (every driven shape again) is two
// launches on wgmma (wide_bwd below): a dq kernel that computes a strip's
// S and dp once each, over the whole key row in registers, then P, D and
// ds in registers, dq = ds k chunk by chunk, and P and ds into a bf16
// scratch; then a dk/dv kernel that takes ds^T q and P^T do as products
// over the query axis. At the family's B 8, T 256, one head of 512 the
// design it replaced (below, kept for T > 256) computed each pair's S 16
// times and dp 12 (31 products of T T hd where 5 suffice) on mma.sync
// with no load ahead: 0.2320 ms, and 0.7927 at the single-head 32x32's
// B 128, T 256, one head of 256, 5.3x cuDNN's (H100 80GB HBM3 at 700 W,
// PERF.md).
//
// What bounds them on the H100: the family's forward, B 8, T 256, one
// head of 512 in bf16, must move ~8.4 MB (2.5 us at 3.35 TB/s) and do
// 1.07 GFLOP (1.1 us at the bf16 tensor-core peak); its backward ~14.7 MB
// (4.4 us) and 2.7 GFLOP (2.7 us), so bytes bound both, barely. Few
// strips fill the card (32 at the family's shape): the one-pass kernels
// keep every operand chunk in flight on a TMA ring rather than wait on
// it, and the backward's scratch adds 4 B heads T^2 bytes each way.
//
// Above T 256 and in fp32 the simple first design:
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
// bf16 backward at T <= 256: S and dp once per strip on wgmma (the redesign
// of row 2w)
//
// Two kernels, launched as row 2's dq and dk/dv entries, planned by
// ops/attention.py::plan_wide_bwd (Plan below, checked against the shape).
//  * dq: a block is WG 64-row query strips of one (image, head), one
//    warpgroup each, sharing every k and v chunk (WG 2 where the card
//    still fills, else 1). Thread 0 keeps a four-stage TMA ring of
//    64-column head-dim chunks in flight over three sweeps: k with the
//    strips' q (S = q k^T, the strip's whole key row in registers, m64
//    n(64 NC) k16), then v with the strips' do (dp = do v^T in the same
//    registers), then k again as the B operand of dq = ds k, one 64-column
//    output chunk at a time. In between, in registers: P = exp(s - lse)
//    rounded to bf16 (the A fragments), D = sum_k P dp from the rounded P
//    over the whole row, ds = P dp - P D rounded to bf16; P and ds go to a
//    (B heads, Tp, Tp) bf16 scratch each (Tp = 64 NC, padding rows and
//    keys written as zeros) through per-warp staging rows.
//  * dk/dv: dk = ds^T q scale and dv = P^T do as products over the query
//    axis: a block is one 64-key strip, 128 output columns and one of dk
//    or dv, one warpgroup; all NC stages (the scratch's 64 x 64 box read
//    MN-major as A, two 64-column panels of q or do as B) are issued at
//    once.
// S and dp are computed once per (query strip, key strip) pair: 5 products
// of T T hd in all, where the two-pass design computed 31 at hd 512. Each
// output is written by one block in one fixed order, nothing is atomic:
// two calls give the same bits.

namespace wide_bwd {

constexpr int kStages = 4;
constexpr int kChunk = 64;                   // head-dim columns a chunk
constexpr int kBox = 64 * kChunk * 2;        // a 64 x 64 bf16 box
constexpr int kRowBytes = kChunk * 2 + 16;   // a staging row (padded)
constexpr int kKvCols = 128;                 // output columns of a dk/dv block

// ops/attention.py::WideBwdPlan, field for field
struct Plan {
  int one_pass, nc, wg, dq_x, dq_y, dq_z, dq_smem, kv_x, kv_y, kv_z, kv_smem;
  long long scratch;
};

// The plan of a call at this shape (the strips a dq block, wg, chosen by
// the caller), as plan_wide_bwd gives it.
inline Plan expected(int B, int n_tok, int heads, int hd, bool bf16, int wg) {
  const int nc = (n_tok + 63) / 64;
  if (bf16 && n_tok <= pdm_hop::kMaxTokens) {
    const long long bh = (long long)B * heads;
    const long long n_nt = (hd + kKvCols - 1) / kKvCols;
    const long long dq_x = bh * ((nc + wg - 1) / wg), kv_x = bh * nc * n_nt * 2;
    const long long tp = 64LL * nc;
    return Plan{1, nc, wg, (int)dq_x, 1, 1, kStages * (nc + wg) * kBox + 1024, (int)kv_x, 1, 1,
                nc * 3 * kBox + 1024, 2 * bh * tp * tp};
  }
  const int n_oc = out_blocks(hd, bf16 ? kOC : kFO);
  return Plan{0, nc, 1, nc, heads * n_oc, B, 0, nc, 2 * heads * n_oc, B, 0, 0};
}

inline bool plan_ok(const Plan* p, int B, int n_tok, int heads, int hd, bool bf16) {
  if (p == nullptr || p->wg < 1 || p->wg > 2 || (p->wg == 2 && p->nc < 2)) return false;
  const Plan e = expected(B, n_tok, heads, hd, bf16, p->wg);
  const long long bh = (long long)B * heads;
  const long long n_nt = (hd + kKvCols - 1) / kKvCols;
  if (e.one_pass && (bh * ((e.nc + p->wg - 1) / p->wg) > 0x7fffffffLL ||
                     bh * e.nc * n_nt * 2 > 0x7fffffffLL))
    return false;
  return p->one_pass == e.one_pass && p->nc == e.nc && p->dq_x == e.dq_x &&
         p->dq_y == e.dq_y && p->dq_z == e.dq_z && p->dq_smem == e.dq_smem &&
         p->kv_x == e.kv_x && p->kv_y == e.kv_y && p->kv_z == e.kv_z &&
         p->kv_smem == e.kv_smem && p->scratch == e.scratch && e.dq_y <= 65535 &&
         e.dq_z <= 65535 && e.kv_y <= 65535 && e.kv_z <= 65535;
}

// a bf16 pair into the warp's staging rows at (row, column)
__device__ __forceinline__ void stage(char* buf, int row, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(buf + row * kRowBytes + col * 2) = v;
}

// the warp's staged 16 x 64 tile to rows `ld` apart at dst (its first
// row): whole 16-byte vectors, rows >= rows and columns >= cols not
// written (cols a multiple of 8)
__device__ __forceinline__ void flush(__nv_bfloat16* dst, long long ld, int rows, int cols,
                                      char* buf) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * 8; e += 32) {
    const int rr = e >> 3, vv = e & 7;
    if (rr < rows && vv * 8 < cols)
      *reinterpret_cast<uint4*>(dst + (long long)rr * ld + vv * 8) =
          *reinterpret_cast<const uint4*>(buf + rr * kRowBytes + vv * 16);
  }
  __syncwarp();
}

// columns [64 h, 64 h + 64) of the warp's 16 rows of a 64 x N fp32
// accumulator (wgmma m64nN: registers 4 i + 2 r + e at row g + 8 r, column
// 8 i + 2 tq + e), times mul, rounded to bf16, into the staging rows
template <int R>
__device__ __forceinline__ void stage_acc(char* buf, const float (&acc)[R], int h, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int a = 4 * (8 * h + i) + 2 * r;
      stage(buf, g + 8 * r, i * 8 + 2 * tq, pdm_attn::pack_bf16(acc[a] * mul, acc[a + 1] * mul));
    }
}

// The warp's 16 rows of a 64 x 64 NC bf16 tile held as A fragments
// (pack_slice's layout) to rows `ld` apart at dst, every row and column:
// the P and ds scratch
template <int NC>
__device__ __forceinline__ void store_frags(__nv_bfloat16* dst, const uint32_t (&a)[NC * 4][4],
                                            long long ld, char* buf) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint32_t(&f)[4] = a[4 * c + jj];
      stage(buf, g, 16 * jj + 2 * tq, f[0]);
      stage(buf, g + 8, 16 * jj + 2 * tq, f[1]);
      stage(buf, g, 16 * jj + 8 + 2 * tq, f[2]);
      stage(buf, g + 8, 16 * jj + 8 + 2 * tq, f[3]);
    }
    flush(dst + c * 64, ld, 16, 64, buf);
  }
}

struct DqMaps {
  CUtensorMap q, k, v, dout;  // 4-D stripe maps: boxes of 64 rows (q, do), 64 NC (k, v)
};

// dq and D of WG query strips (strips WG p .. WG p + WG - 1 of one (image,
// head)), and their rows of the P and ds scratch.
template <int NC, int WG>
__global__ void __launch_bounds__(WG * pdm_hop::kWgThreads, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ DqMaps m, const float* __restrict__ lse,
                              __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum,
                              __nv_bfloat16* __restrict__ p_out,
                              __nv_bfloat16* __restrict__ ds_out, int n_tok, int heads, int hd,
                              long long ldo, float scale, float scale_log2) {
  using pdm_hop::desc_k;
  using pdm_hop::desc_mn;
  constexpr int kGroups = (NC + WG - 1) / WG;  // blocks of strips a head
  constexpr int kKV = NC * kBox;               // a chunk of the head's key rows
  constexpr int kStage = kKV + WG * kBox;
  constexpr int kTp = NC * 64;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(16) char staging[4 * WG][16 * kRowBytes];

  const int grp = blockIdx.x % kGroups, bh = blockIdx.x / kGroups;
  const int h = bh % heads, b = bh / heads;
  const int wg = threadIdx.x >> 7;
  const int live = NC - grp * WG < WG ? NC - grp * WG : WG;  // strips with rows
  const int n_dc = (hd + kChunk - 1) / kChunk;
  const int total = 3 * n_dc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = (grp * WG + wg) * 64 + (warp & 3) * 16;  // the warp's first row
  char* ring = pdm_hop::aligned_smem(smem_raw);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      pdm_hop::mbar_init(&full[st], 1);
      pdm_hop::mbar_init(&empty[st], 4 * WG);
    }
    pdm_hop::fence_barrier_init();
  }
  __syncthreads();
  // thread 0: chunk n of the three sweeps into stage n % kStages: the
  // head's k (sweeps 0 and 2) or v (sweep 1) at head-dim chunk n % n_dc,
  // then the live strips' q (sweep 0) or do (sweep 1)
  auto issue = [&](int n) {
    const int st = n % kStages;
    if (n >= kStages) pdm_hop::mbar_wait(&empty[st], ((n / kStages) - 1) & 1);
    char* dst = ring + st * kStage;
    const int sweep = n / n_dc, col = (n - sweep * n_dc) * kChunk;
    const int strips = sweep == 2 ? 0 : live;
    pdm_hop::mbar_expect_tx(&full[st], kKV + strips * kBox);
    pdm_hop::tma_load(dst, sweep == 1 ? &m.v : &m.k, &full[st], col, h, 0, b);
    for (int w = 0; w < strips; ++w)
      pdm_hop::tma_load(dst + kKV + w * kBox, sweep == 1 ? &m.dout : &m.q, &full[st], col, h,
                        (grp * WG + w) * 64, b);
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

  // lse of rows g and g + 8 in log2 units; +inf past n_tok makes P = 0
  const long long lrow = ((long long)b * heads + h) * n_tok;
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    lse2[r] = row < n_tok ? lse[lrow + row] * kLog2e : INFINITY;
  }

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
      const char* qs = ks + kKV + wg * kBox;
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

  // P = exp(s - lse) rounded to bf16 as it is packed (keys past n_tok: 0)
  uint32_t pa[NC * 4][4];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] = pdm_hop::ex2(fmaf(s[i], scale_log2, -lse2[(i >> 1) & 1]));
  if (n_tok < NC * 64) {
#pragma unroll
    for (int i = 0; i < NC * 32; ++i)
      if ((i >> 2) * 8 + 2 * tq + (i & 1) >= n_tok) s[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NC * 4; ++j) pdm_hop::pack_slice(pa[j], s, j);
  const long long sbase = (long long)bh * kTp * kTp + (long long)wrow * kTp;
  if (mine) store_frags<NC>(p_out + sbase, pa, kTp, staging[warp]);

  // dp = do v^T (in the same registers), D = sum_k P dp from the rounded P
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) s[i] = 0.f;
#pragma unroll 1
  for (int j = 0; j < n_dc; ++j) {
    const int n = n_dc + j, st = n % kStages;
    pdm_hop::mbar_wait(&full[st], (n / kStages) & 1);
    const char* vs = ring + st * kStage;
    if (mine) {
      const char* dos = vs + kKV + wg * kBox;
      pdm_hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        pdm_hop::wgmma_ss<NC>(s, desc_k<64>(dos, 64, 0, kk), desc_k<64>(vs, NC * 64, 0, kk));
      pdm_hop::wgmma_commit();
      pdm_hop::wgmma_wait_all();
      pdm_hop::reg_fence(s);
    }
    release(n);
  }
  float D[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NC * 32; ++i)
    D[(i >> 1) & 1] += pdm_hop::unpack(pa[i >> 3], i >> 2, i & 3) * s[i];
  D[0] = quad_sum(D[0]);
  D[1] = quad_sum(D[1]);

  // ds = P dp - P D, rounded to bf16 as it is repacked (the A operand of
  // ds k)
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) {
    const float p = pdm_hop::unpack(pa[i >> 3], i >> 2, i & 3);
    s[i] = p * s[i] - p * D[(i >> 1) & 1];
  }
#pragma unroll
  for (int j = 0; j < NC * 4; ++j) pdm_hop::pack_slice(pa[j], s, j);
  if (mine) {
    store_frags<NC>(ds_out + sbase, pa, kTp, staging[warp]);
    if (tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wrow + g + 8 * r;
        if (row < n_tok) dsum[lrow + row] = D[r];
      }
    }
  }

  // dq = ds k times the scale, one 64-column output chunk at a time
  __nv_bfloat16* dq_rows = dq + ((long long)b * n_tok + wrow) * ldo + (long long)h * hd;
#pragma unroll 1
  for (int j = 0; j < n_dc; ++j) {
    const int n = 2 * n_dc + j, st = n % kStages;
    pdm_hop::mbar_wait(&full[st], (n / kStages) & 1);
    const char* ks = ring + st * kStage;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (mine) {
      pdm_hop::wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < NC * 4; ++jj)
        pdm_hop::wgmma_rs<64>(acc, pa[jj], desc_mn<64>(ks, NC * 64, jj, 0));
      pdm_hop::wgmma_commit();
      pdm_hop::wgmma_wait_all();
      pdm_hop::reg_fence(acc);
      pdm_hop::reg_fence(pa);
    }
    release(n);
    if (mine) {
      stage_acc(staging[warp], acc, 0, scale);
      flush(dq_rows + j * kChunk, ldo, n_tok - wrow, hd - j * kChunk, staging[warp]);
    }
  }
}

struct KvMaps {
  CUtensorMap q, dout;  // 4-D stripe maps, boxes of 64 rows
  CUtensorMap p, ds;    // 3-D maps {Tp, Tp, B heads} of the scratch, boxes 64 x 64
};

// dk (ds^T q, times the scale) or dv (P^T do) of one 64-key strip, over
// 128 output columns: blockIdx.x = ((b heads + h) NC + strip) n_nt + tile,
// times 2, plus 1 for dv.
template <int NC>
__global__ void __launch_bounds__(pdm_hop::kWgThreads, 1)
attention_bwd_kv_wgmma_kernel(const __grid_constant__ KvMaps m, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int n_tok, int heads, int hd,
                              long long ldo, float scale) {
  using pdm_hop::desc_mn;
  constexpr int kStage = 3 * kBox;  // the scratch's box, two panels of q or do
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[NC];
  __shared__ __align__(16) char staging[4][16 * kRowBytes];

  const int n_nt = (hd + kKvCols - 1) / kKvCols;
  const bool is_dv = blockIdx.x & 1;
  int x = blockIdx.x >> 1;
  const int nt = x % n_nt;
  x /= n_nt;
  const int kt = x % NC, bh = x / NC;
  const int h = bh % heads, b = bh / heads;
  const int n0 = nt * kKvCols;
  const int panels = hd - n0 > 64 ? 2 : 1;  // a panel wholly past hd is not loaded
  const int warp = threadIdx.x >> 5;
  const int wrow = kt * 64 + warp * 16;
  char* ring = pdm_hop::aligned_smem(smem_raw);

  if (threadIdx.x == 0) {
    for (int j = 0; j < NC; ++j) pdm_hop::mbar_init(&full[j], 1);
    pdm_hop::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < NC; ++j) {
      char* st = ring + j * kStage;
      pdm_hop::mbar_expect_tx(&full[j], (1 + panels) * kBox);
      pdm_hop::tma_load_3d(st, is_dv ? &m.p : &m.ds, &full[j], kt * 64, j * 64, bh);
      for (int p = 0; p < panels; ++p)
        pdm_hop::tma_load(st + (1 + p) * kBox, is_dv ? &m.dout : &m.q, &full[j], n0 + p * 64, h,
                          j * 64, b);
    }
  }

  // acc (64 keys x 128 columns) += (P or ds)^T (64 keys x 64 queries, the
  // scratch box MN-major) times (do or q) (64 queries x 128, N-major)
  float acc[kKvCols / 2];
#pragma unroll
  for (int i = 0; i < kKvCols / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    pdm_hop::mbar_wait(&full[j], 0);
    const char* st = ring + j * kStage;
    pdm_hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pdm_hop::wgmma_ss_t<kKvCols, 1, 1>(acc, desc_mn<64>(st, 64, kk, 0),
                                         desc_mn<64>(st + kBox, 64, kk, 0));
    pdm_hop::wgmma_commit();
    pdm_hop::wgmma_wait_all();
    pdm_hop::reg_fence(acc);
  }

  __nv_bfloat16* rows =
      (is_dv ? dv : dk) + ((long long)b * n_tok + wrow) * ldo + (long long)h * hd + n0;
  const float mul = is_dv ? 1.f : scale;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    stage_acc(staging[warp], acc, p, mul);
    flush(rows + p * 64, ldo, n_tok - wrow, hd - n0 - p * 64, staging[warp]);
  }
}

template <int NC, int WG>
cudaError_t launch_dq_wg(const Plan& p, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, void* dq, float* dsum, void* scratch,
                      int B, int n_tok, int heads, int hd, long long ld, long long ldo,
                      float scale, cudaStream_t stream) {
  DqMaps m;
  if (!pdm_hop::stripe_map<64>(&m.q, q, B, n_tok, heads, hd, ld, 64) ||
      !pdm_hop::stripe_map<64>(&m.k, k, B, n_tok, heads, hd, ld, NC * 64) ||
      !pdm_hop::stripe_map<64>(&m.v, v, B, n_tok, heads, hd, ld, NC * 64) ||
      !pdm_hop::stripe_map<64>(&m.dout, dout, B, n_tok, heads, hd, (long long)heads * hd, 64))
    return cudaErrorInvalidValue;
  auto kernel = attention_bwd_dq_wgmma_kernel<NC, WG>;
  cudaError_t err = pdm_hop::allow_smem(kernel, p.dq_smem);
  if (err != cudaSuccess) return err;
  auto* P = static_cast<__nv_bfloat16*>(scratch);
  kernel<<<p.dq_x, WG * pdm_hop::kWgThreads, p.dq_smem, stream>>>(
      m, lse, static_cast<__nv_bfloat16*>(dq), dsum, P, P + p.scratch / 2, n_tok, heads, hd,
      ldo, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dq(const Plan& p, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, void* dq, float* dsum, void* scratch,
                      int B, int n_tok, int heads, int hd, long long ld, long long ldo,
                      float scale, cudaStream_t stream) {
  if constexpr (NC >= 2) {
    if (p.wg == 2)
      return launch_dq_wg<NC, 2>(p, q, k, v, dout, lse, dq, dsum, scratch, B, n_tok, heads, hd, ld,
                              ldo, scale, stream);
  }
  return launch_dq_wg<NC, 1>(p, q, k, v, dout, lse, dq, dsum, scratch, B, n_tok, heads, hd, ld,
                          ldo, scale, stream);
}

template <int NC>
cudaError_t launch_kv(const Plan& p, const void* q, const void* dout, const void* scratch,
                      void* dk, void* dv, int B, int n_tok, int heads, int hd, long long ld,
                      long long ldo, float scale, cudaStream_t stream) {
  KvMaps m;
  const auto* P = static_cast<const __nv_bfloat16*>(scratch);
  const long long bh = (long long)B * heads;
  if (!pdm_hop::stripe_map<64>(&m.q, q, B, n_tok, heads, hd, ld, 64) ||
      !pdm_hop::stripe_map<64>(&m.dout, dout, B, n_tok, heads, hd, (long long)heads * hd, 64) ||
      !pdm_hop::rows_map(&m.p, P, static_cast<int>(bh), NC * 64, NC * 64, NC * 64, 64, 64, 1) ||
      !pdm_hop::rows_map(&m.ds, P + p.scratch / 2, static_cast<int>(bh), NC * 64, NC * 64,
                         NC * 64, 64, 64, 1))
    return cudaErrorInvalidValue;
  auto kernel = attention_bwd_kv_wgmma_kernel<NC>;
  cudaError_t err = pdm_hop::allow_smem(kernel, p.kv_smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.kv_x, pdm_hop::kWgThreads, p.kv_smem, stream>>>(
      m, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n_tok, heads, hd, ldo,
      scale);
  return cudaGetLastError();
}

}  // namespace wide_bwd

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
    const int y = heads * out_blocks(hd, kOC);
    if (bad_shape(B, n_tok, heads, hd, y)) return cudaErrorInvalidValue;
    attention_fwd_wide_kernel<<<dim3((n_tok + kTile - 1) / kTile, y, B), kTcThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), l, n_tok,
        heads, hd, ld, scale * kLog2e);
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

// As pdm_attention_bwd_dq (attention_bwd.cu), at the same head dims, with
// two more arguments: `plan` (ops/attention.py::plan_wide_bwd's, refused
// unless it is this shape's) and `scratch`, plan->scratch bf16 elements
// for the one-pass design's P and ds (bf16 at T <= 256), else unused.
extern "C" int pdm_attention_wide_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, void* dq,
                                         void* dsum, int B, int n_tok, int heads,
                                         int hd, long long ld, long long ldo, float scale,
                                         int dtype, void* stream, void* scratch,
                                         const void* plan) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* D = static_cast<float*>(dsum);
  const auto* p = static_cast<const wide_bwd::Plan*>(plan);
  const bool bf16 = dtype == pdm::kBFloat16;
  if ((!bf16 && dtype != pdm::kFloat32) || bad_shape(B, n_tok, heads, hd, 1) ||
      !wide_bwd::plan_ok(p, B, n_tok, heads, hd, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->one_pass) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    switch (p->nc) {
      case 1: err = wide_bwd::launch_dq<1>(*p, q, k, v, dout, l, dq, D, scratch, B, n_tok, heads, hd, ld, ldo, scale, s); break;
      case 2: err = wide_bwd::launch_dq<2>(*p, q, k, v, dout, l, dq, D, scratch, B, n_tok, heads, hd, ld, ldo, scale, s); break;
      case 3: err = wide_bwd::launch_dq<3>(*p, q, k, v, dout, l, dq, D, scratch, B, n_tok, heads, hd, ld, ldo, scale, s); break;
      default: err = wide_bwd::launch_dq<4>(*p, q, k, v, dout, l, dq, D, scratch, B, n_tok, heads, hd, ld, ldo, scale, s);
    }
    return static_cast<int>(err);
  }
  const dim3 grid(p->dq_x, p->dq_y, p->dq_z);
  if (bf16) {
    attention_bwd_dq_wide_kernel<<<grid, kTcThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), l,
        static_cast<__nv_bfloat16*>(dq), D, n_tok, heads, hd, ld, ldo, scale,
        scale * kLog2e);
  } else {
    attention_bwd_dq_wide_f32_kernel<<<grid, kFQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l,
        static_cast<float*>(dq), D, n_tok, heads, hd, ld, ldo, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// As pdm_attention_bwd_dkdv (attention_bwd.cu), at the same head dims, with
// pdm_attention_wide_bwd_dq's `scratch` (its P and ds, read here by the
// one-pass design) and `plan`: one launch whose blocks write dk or dv.
extern "C" int pdm_attention_wide_bwd_dkdv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* dsum, void* dk, void* dv, int B,
                                           int n_tok, int heads, int hd, long long ld,
                                           long long ldo, float scale, int dtype,
                                           void* stream, const void* scratch,
                                           const void* plan) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* D = static_cast<const float*>(dsum);
  const auto* p = static_cast<const wide_bwd::Plan*>(plan);
  const bool bf16 = dtype == pdm::kBFloat16;
  if ((!bf16 && dtype != pdm::kFloat32) || bad_shape(B, n_tok, heads, hd, 1) ||
      !wide_bwd::plan_ok(p, B, n_tok, heads, hd, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p->one_pass) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    switch (p->nc) {
      case 1: err = wide_bwd::launch_kv<1>(*p, q, dout, scratch, dk, dv, B, n_tok, heads, hd, ld, ldo, scale, s); break;
      case 2: err = wide_bwd::launch_kv<2>(*p, q, dout, scratch, dk, dv, B, n_tok, heads, hd, ld, ldo, scale, s); break;
      case 3: err = wide_bwd::launch_kv<3>(*p, q, dout, scratch, dk, dv, B, n_tok, heads, hd, ld, ldo, scale, s); break;
      default: err = wide_bwd::launch_kv<4>(*p, q, dout, scratch, dk, dv, B, n_tok, heads, hd, ld, ldo, scale, s);
    }
    return static_cast<int>(err);
  }
  const dim3 grid(p->kv_x, p->kv_y, p->kv_z);
  if (bf16) {
    attention_bwd_dkdv_wide_kernel<<<grid, kTcThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), l,
        D, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n_tok, heads,
        hd, ld, ldo, scale, scale * kLog2e);
  } else {
    attention_bwd_dkdv_wide_f32_kernel<<<grid, kFQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, D,
        static_cast<float*>(dk), static_cast<float*>(dv), n_tok, heads, hd, ld, ldo,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}
