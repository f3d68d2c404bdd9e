// Building blocks shared by the two-pass attention kernels (attention.cu,
// forward; attention_bwd.cu, backward; T > 256, and fp32): tensor-core
// fragments through ldmatrix and mma.sync m16n8k16 (bf16 in, fp32
// accumulate), tile loads of one head's column stripe into shared memory
// (zero-padded from the head dim hd to the instantiated HD), and the fp32
// CUDA-core helpers. The single-pass Hopper kernels' blocks are in
// attention_hopper.cuh.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, tq = lane % 4):
//   A (16x16, row-major): a[0] row g, cols 2tq..2tq+1; a[1] row g+8, same
//     cols; a[2] row g, cols 2tq+8..; a[3] row g+8, cols 2tq+8..
//   C (16x8): c[0..1] row g, cols 2tq..2tq+1; c[2..3] row g+8.
// So the accumulators of two neighbouring 16x8 C tiles, rounded to bf16 in
// pairs, are exactly the A fragment of one 16x16 slice (see pack_a).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace pdm_attn {

constexpr int kTile = 64;        // rows per block (16 per warp), and rows
                                 // per shared-memory tile
constexpr int kTcThreads = 128;  // 4 warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Rows [row0, row0 + kTile) of one head stripe (hd bf16 each, rows `ld`
// apart) into shared memory rows `stride` elements apart, zero-padded to HD
// columns; rows past n_tok are zero. 16-byte loads: the wrapper checks the
// alignment (hd is a multiple of 8).
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int n_tok, long long ld,
                                          int stride, int hd = HD) {
  constexpr int kVecs = HD / 8;  // uint4 per row
  for (int e = threadIdx.x; e < kTile * kVecs; e += kTcThreads) {
    const int r = e / kVecs, c = e - r * kVecs;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_tok && c * 8 < hd)
      val = *reinterpret_cast<const uint4*>(src + (long long)row * ld + c * 8);
    *reinterpret_cast<uint4*>(dst + r * stride + c * 8) = val;
  }
}

// A fragments of this warp's 16 rows (rows warp*16.. of a shared tile)
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4],
                                       const __nv_bfloat16* tile, int warp,
                                       int lane) {
  constexpr int S = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(a[kk], tile + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
}

// acc = a b^T for this warp's 16 rows against the 64 rows of a shared tile
// (contraction over HD): acc[n] holds tile rows 8n + 2*tq + {0, 1} of the
// warp's rows g ([0], [1]) and g + 8 ([2], [3]).
template <int HD>
__device__ __forceinline__ void tile_dot(float (&acc)[kTile / 8][4],
                                         const uint32_t (&a)[HD / 16][4],
                                         const __nv_bfloat16* tile, int lane) {
  constexpr int S = HD + 8;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // ldmatrix x4 over tile rows: matrices (rows +0..7 | +8..15) x (cols +0 | +8)
  const int row_off = (lane & 7) + (lane >> 4) * 8;
  const int col_off = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, tile + (np * 16 + row_off) * S + kk * 16 + col_off);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// s = q k^T for this warp's 16 rows and the tile's 64 keys, in log2 units
// (times scale * log2(e)), keys past n_tok at -inf.
template <int HD>
__device__ __forceinline__ void tile_scores(float (&s)[kTile / 8][4],
                                            const uint32_t (&qa)[HD / 16][4],
                                            const __nv_bfloat16* ks, int lane,
                                            int k0, int n_tok, float scale_log2) {
  tile_dot<HD>(s, qa, ks, lane);
  const int tq = lane & 3;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * tq + (e & 1);
      s[n][e] = key < n_tok ? s[n][e] * scale_log2 : -INFINITY;
    }
  }
}

// The A fragment of the 16-column slice j of a 16 x 64 accumulator whose
// values are already rounded to bf16 (exact in the packing).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&m)[kTile / 8][4], int j) {
  a[0] = pack_bf16(m[2 * j][0], m[2 * j][1]);
  a[1] = pack_bf16(m[2 * j][2], m[2 * j][3]);
  a[2] = pack_bf16(m[2 * j + 1][0], m[2 * j + 1][1]);
  a[3] = pack_bf16(m[2 * j + 1][2], m[2 * j + 1][3]);
}

// acc (16 x HD) += a (16 x 64, as four 16-column A slices) times the 64 x HD
// shared tile (contraction over its 64 rows)
template <int HD>
__device__ __forceinline__ void tile_product(float (&acc)[HD / 8][4],
                                             const uint32_t (&a)[kTile / 16][4],
                                             const __nv_bfloat16* tile, int lane) {
  constexpr int S = HD + 8;
  // ldmatrix.trans x4 over tile rows: matrices (rows +0..7 | +8..15) x (d +0 | +8)
  const int row_off = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col_off = (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, tile + (j * 16 + row_off) * S + dp * 16 + col_off);
      mma_bf16(acc[2 * dp], a[j], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[j], b[2], b[3]);
    }
  }
}

// Rows g and g + 8 of a 16 x HD accumulator, times `mul`, as bf16 into the
// contiguous (B, T, C) tensor `out` at token rows row_base + {g, g+8};
// columns past hd are padding and are not written.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[HD / 8][4],
                                           float mul, long long row_base,
                                           int row0, int n_tok, int C, int lane,
                                           int hd = HD) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_tok) continue;
    __nv_bfloat16* o = out + (row_base + row) * C;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      if (d * 8 < hd)
        *reinterpret_cast<uint32_t*>(o + d * 8 + 2 * tq) =
            pack_bf16(acc[d][2 * r] * mul, acc[d][2 * r + 1] * mul);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores

constexpr int kBQ = 64;           // rows (threads) per block
constexpr int kTileElems = 4096;  // elements per shared-memory tile

// rows [k0, k0 + kTileElems / HD) of one head stripe (hd columns) into a
// dense tile of HD columns, zero-padded
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int k0, int n_tok, long long ld,
                                              int hd = HD) {
  constexpr int BK = kTileElems / HD;
  for (int e = threadIdx.x; e < BK * HD; e += kBQ) {
    const int r = e / HD, c = e - r * HD;
    const int row = k0 + r;
    dst[e] = row < n_tok && c < hd ? src[(long long)row * ld + c] : 0.f;
  }
}

// q . k over HD with four independent partial sums
template <int HD>
__device__ __forceinline__ float dot_row(const float (&qr)[HD], const float* kr) {
  const float4* k4 = reinterpret_cast<const float4*>(kr);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 kk = k4[d4];
    s0 = fmaf(qr[4 * d4 + 0], kk.x, s0);
    s1 = fmaf(qr[4 * d4 + 1], kk.y, s1);
    s2 = fmaf(qr[4 * d4 + 2], kk.z, s2);
    s3 = fmaf(qr[4 * d4 + 3], kk.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

}  // namespace pdm_attn
