// Tensor-core building blocks of the EGCL edge program at C = 32, fast mode
// (bf16 operands, fp32 accumulation), for Hopper (sm_90a). Shared by the
// forward kernel (egcl_tile.cu); written so that a backward kernel can
// include the same staging, geometry, fragment helpers and s1 -> m chain.
//
// One warp owns one center. A row tile is 16 of its edges: the 16 rows of a
// bf16 mma.sync.m16n8k16 product whose 32 output channels are 4 n-tiles of 8.
// With g = lane / 4 and t = lane % 4 the PTX fragments are
//   A (16x16, row):  a0 = (row g,   k 2t, 2t+1)    a1 = (row g+8, k 2t, 2t+1)
//                    a2 = (row g,   k 2t+8, 2t+9)  a3 = (row g+8, k 2t+8, 2t+9)
//   B (16x8,  col):  b0 = (k 2t, 2t+1, col g)      b1 = (k 2t+8, 2t+9, col g)
//   C (16x8,  f32):  c0, c1 = (row g,   col 2t, 2t+1)
//                    c2, c3 = (row g+8, col 2t, 2t+1)
// (the lower k or column index in the lower 16 bits). So the accumulators of
// n-tiles 2j and 2j+1, rounded to bf16 pairs, ARE the A fragment of the next
// layer's k-step j: the edge MLP chains in registers with no shared-memory
// round trip. A row's 32 channels sit in the 4 lanes of a quad (8 each), so a
// LayerNorm is two xor-shuffles, and the sum over the 16 edges is c0 + c2
// followed by xor-shuffles over 4, 8 and 16.
//
// Weights come from ops/kernels/egcl.py::pack_params_tile: rounded to bf16 on
// the host and ordered so that a lane's (b0, b1) of one (k-step, n-tile) block
// is one 64-bit shared-memory load; biases, LayerNorm parameters and wc1
// (bf16 values) are fp32.
//
// Numerics are those of egcl.cu in FAST mode: fp32 gathers, geometry,
// LayerNorm and sums; every MLP product on bf16-rounded operands
// (round-to-nearest-even) with fp32 accumulation. Only the order of the fp32
// sums differs (the tensor core's, and biases enter as the accumulators'
// initial value).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace egcl_tile {

constexpr int kC = 32;        // channels
constexpr int kNT = kC / 8;   // n-tiles of 8 channels
constexpr int kRows = 16;     // edges per row tile
// Row stride of the staging tile in bf16; a row holds 48 (h_col 32 | geometry
// 12 + 4 zeros). 56 (28 words) puts the 8 rows of an
// A-fragment load on distinct multiples of 4 banks, so the 32 lanes hit 32
// banks; 112 bytes keeps every row 16-byte aligned.
constexpr int kStride = 56;
constexpr unsigned kFull = 0xffffffffu;

// Word (32-bit) offsets into the packed buffer. A fragment block is one
// (k-step, n-tile) pair: 32 lanes x (b0, b1) = 64 words.
struct Layout {
  static constexpr int kBlock = 64;
  static constexpr int w1 = 0;                          // 5 k-steps: h_col 2, geo 1, h_row 2
  static constexpr int w1_hrow = w1 + 3 * kNT * kBlock;
  static constexpr int w2 = w1 + 5 * kNT * kBlock;      // 2 k-steps (dense, zeros off the heads)
  static constexpr int wc0 = w2 + 2 * kNT * kBlock;     // 2 k-steps
  static constexpr int wn0 = wc0 + 2 * kNT * kBlock;    // 4 k-steps: h 2, agg_m 2
  static constexpr int wn1 = wn0 + 4 * kNT * kBlock;    // 2 k-steps
  static constexpr int vectors = wn1 + 2 * kNT * kBlock;
  static constexpr int b1 = vectors;                    // fp32 [32] each
  static constexpr int b2 = b1 + kC;
  static constexpr int lns = b2 + kC;
  static constexpr int lnb = lns + kC;
  static constexpr int bc0 = lnb + kC;
  static constexpr int wc1 = bc0 + kC;
  static constexpr int bn0 = wc1 + kC;
  static constexpr int bn1 = bn0 + kC;
  static constexpr int total = bn1 + kC;
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// SiLU whose result is rounded to bf16 by every caller: the fast exponential
// and divide are within 2 ulp of fp32, far inside a bf16 step.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// d += a (16x16 bf16) * b (16x8 bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// This lane's (b0, b1) of block (j, n) of the matrix at word offset `off`.
__device__ __forceinline__ uint2 b_frag(const uint32_t* w, int off, int j, int n, int lane) {
  return reinterpret_cast<const uint2*>(w + off + (j * kNT + n) * Layout::kBlock)[lane];
}

// acc[n] += A[j] * W[j][n] over KS k-steps and the 4 n-tiles.
template <int KS>
__device__ __forceinline__ void product(float (&acc)[kNT][4], const uint32_t (&a)[KS][4],
                                        const uint32_t* w, int off, int lane) {
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int n = 0; n < kNT; ++n) mma(acc[n], a[j], b_frag(w, off, j, n, lane));
}

// Accumulators [16 x 32] -> the two A fragments of the next layer.
__device__ __forceinline__ void to_a(const float (&acc)[kNT][4], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a[j][0] = pack2(acc[2 * j][0], acc[2 * j][1]);
    a[j][1] = pack2(acc[2 * j][2], acc[2 * j][3]);
    a[j][2] = pack2(acc[2 * j + 1][0], acc[2 * j + 1][1]);
    a[j][3] = pack2(acc[2 * j + 1][2], acc[2 * j + 1][3]);
  }
}

// One vector [32] whose every row is the same -> A fragments (rows g and g+8
// equal): v[n] = channels 8n + 2t, 8n + 2t + 1 of the vector.
__device__ __forceinline__ void row_to_a(const float2 (&v)[kNT], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a[j][0] = a[j][1] = pack2(v[2 * j].x, v[2 * j].y);
    a[j][2] = a[j][3] = pack2(v[2 * j + 1].x, v[2 * j + 1].y);
  }
}

// This lane's channels 8n + 2t, 8n + 2t + 1 of the fp32 vector at word offset `off`.
__device__ __forceinline__ float2 vec2(const uint32_t* w, int off, int n, int t) {
  return *reinterpret_cast<const float2*>(w + off + 8 * n + 2 * t);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ void unit(float& a, float& b, float& c) {
  const float inv = sqrtf(a * a + b * b + c * c + 1e-20f) + 1e-8f;
  a /= inv; b /= inv; c /= inv;
}

// Edge geometry (ops/pallas/egcl_kernel.py:97-114): rel = xi - xc and
// g = [radial, dist, dot, a0,b0,c0, a1,b1,c1, a2,b2,c2]; _safe_unit
// n = sqrt(n^2 + 1e-20), v / (n + 1e-8); the frame is the identity when
// |a|, |b| or |c| < 1e-6 (coincident or collinear points).
__device__ __forceinline__ void edge_geometry(float xi0, float xi1, float xi2, float xc0,
                                              float xc1, float xc2, float (&rel)[3],
                                              float (&g)[12]) {
  const float r0 = xi0 - xc0, r1 = xi1 - xc1, r2 = xi2 - xc2;
  rel[0] = r0; rel[1] = r1; rel[2] = r2;
  g[0] = r0 * r0 + r1 * r1 + r2 * r2;
  g[1] = sqrtf(g[0] + 1e-20f);
  g[2] = xi0 * xc0 + xi1 * xc1 + xi2 * xc2;
  float a0 = r0, a1 = r1, a2 = r2;
  unit(a0, a1, a2);
  float b0 = xi1 * xc2 - xi2 * xc1, b1 = xi2 * xc0 - xi0 * xc2, b2 = xi0 * xc1 - xi1 * xc0;
  unit(b0, b1, b2);
  const float c0 = a1 * b2 - a2 * b1, c1 = a2 * b0 - a0 * b2, c2 = a0 * b1 - a1 * b0;
  const float cn = sqrtf(c0 * c0 + c1 * c1 + c2 * c2 + 1e-20f);
  const float an = sqrtf(a0 * a0 + a1 * a1 + a2 * a2 + 1e-20f);
  const float bn = sqrtf(b0 * b0 + b1 * b1 + b2 * b2 + 1e-20f);
  if (an < 1e-6f || bn < 1e-6f || cn < 1e-6f) {
    g[3] = 1.f; g[4] = 0.f; g[5] = 0.f;
    g[6] = 0.f; g[7] = 1.f; g[8] = 0.f;
    g[9] = 0.f; g[10] = 0.f; g[11] = 1.f;
  } else {
    g[3] = a0; g[4] = b0; g[5] = c0;
    g[6] = a1; g[7] = b1; g[8] = c1;
    g[9] = a2; g[10] = b2; g[11] = c2;
  }
}

// Stage edges row0 .. row0 + 15 of `center` into the warp's tile as bf16
// rows [h_col 32 | geometry 12 | 0 0 0 0]. Lane l and lane l + 16 both take
// edge row0 + (l % 16): they load its neighbor index and x_j and compute its
// geometry once (lanes 0-15 write it); all 32 lanes then copy the 16 gathered
// h_j rows with 16-byte loads, 8 lanes a row. An edge at or beyond K is
// staged from the center itself (finite values) and reported invalid: the
// caller masks it out of every sum. Returns whether this lane's edge is
// valid, and its rel.
__device__ __forceinline__ bool stage_edges(const float* __restrict__ h,
                                            const float* __restrict__ x,
                                            const int* __restrict__ nbr, int center, int base,
                                            int K, int row0, float xi0, float xi1, float xi2,
                                            __nv_bfloat16* tile, int lane, float (&rel)[3]) {
  const int row = lane & 15;
  const bool valid = row0 + row < K;
  const int j_nb = valid ? base + nbr[(size_t)center * K + row0 + row] : center;
  const float xc0 = x[(size_t)j_nb * 3 + 0];
  const float xc1 = x[(size_t)j_nb * 3 + 1];
  const float xc2 = x[(size_t)j_nb * 3 + 2];
  float g[12];
  edge_geometry(xi0, xi1, xi2, xc0, xc1, xc2, rel, g);
  __syncwarp();   // the previous tile's fragment loads are done
  if (lane < kRows) {
    uint4* dst = reinterpret_cast<uint4*>(tile + row * kStride + kC);
    dst[0] = make_uint4(pack2(g[0], g[1]), pack2(g[2], g[3]), pack2(g[4], g[5]),
                        pack2(g[6], g[7]));
    dst[1] = make_uint4(pack2(g[8], g[9]), pack2(g[10], g[11]), 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * i + (lane >> 3), chunk = lane & 7;
    const int src = __shfl_sync(kFull, j_nb, r);
    const float4 v = reinterpret_cast<const float4*>(h + (size_t)src * kC)[chunk];
    *reinterpret_cast<uint2*>(tile + r * kStride + 4 * chunk) =
        make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
  }
  __syncwarp();
  return valid;
}

// A fragments of the staged tile's 3 k-steps (h_col 2, geometry 1).
__device__ __forceinline__ void staged_a(const __nv_bfloat16* tile, int lane,
                                         uint32_t (&a)[3][4]) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(tile + g * kStride) + t;
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(tile + (g + 8) * kStride) + t;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a[j][0] = lo[8 * j];
    a[j][1] = hi[8 * j];
    a[j][2] = lo[8 * j + 4];
    a[j][3] = hi[8 * j + 4];
  }
}

// The h_row block of the first edge layer, the same for every edge of the
// center: b1 + W1_hrow h_i as accumulator values (hr[n] = channels 8n + 2t,
// 8n + 2t + 1). `ahi` is row_to_a of h_i.
__device__ __forceinline__ void hrow_block(const uint32_t (&ahi)[2][4], const uint32_t* w,
                                           int lane, float2 (&hr)[kNT]) {
  const int t = lane & 3;
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float2 b = vec2(w, Layout::b1, n, t);
    acc[n][0] = acc[n][2] = b.x;
    acc[n][1] = acc[n][3] = b.y;
  }
  product<2>(acc, ahi, w, Layout::w1_hrow, lane);
#pragma unroll
  for (int n = 0; n < kNT; ++n) hr[n] = make_float2(acc[n][0], acc[n][1]);
}

// First edge layer on a staged tile: s1 = silu(hr + [h_col | geo] W1), fp32.
__device__ __forceinline__ void first_layer(const __nv_bfloat16* tile, const float2 (&hr)[kNT],
                                            const uint32_t* w, int lane,
                                            float (&s1)[kNT][4]) {
  uint32_t a[3][4];
  staged_a(tile, lane, a);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    s1[n][0] = s1[n][2] = hr[n].x;
    s1[n][1] = s1[n][3] = hr[n].y;
  }
  product<3>(s1, a, w, Layout::w1, lane);
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) s1[n][q] = silu(s1[n][q]);
}

// Head layer: m = b2 + s1 W2, W2 block-diagonal in heads of width wh. With
// wh <= 16 the 8 channels of n-tile n read only k-step n / 2; the other
// k-step's block is exactly zero and is skipped.
__device__ __forceinline__ void head_layer(const float (&s1)[kNT][4], const uint32_t* w,
                                           int wh, int lane,
                                           float (&m)[kNT][4]) {
  const int t = lane & 3;
  uint32_t a[2][4];
  to_a(s1, a);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float2 b = vec2(w, Layout::b2, n, t);
    m[n][0] = m[n][2] = b.x;
    m[n][1] = m[n][3] = b.y;
  }
  if (wh <= 16) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) mma(m[n], a[n / 2], b_frag(w, Layout::w2, n / 2, n, lane));
  } else {
    product<2>(m, a, w, Layout::w2, lane);
  }
}

// LayerNorm over the 32 channels of rows g and g + 8, in place (biased
// variance, eps 1e-5).
__device__ __forceinline__ void layer_norm(float (&m)[kNT][4], const uint32_t* w, int lane) {
  const int t = lane & 3;
  float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    s_lo += m[n][0] + m[n][1];
    s_hi += m[n][2] + m[n][3];
  }
  const float mu_lo = quad_sum(s_lo) * (1.0f / kC), mu_hi = quad_sum(s_hi) * (1.0f / kC);
  float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    m[n][0] -= mu_lo; m[n][1] -= mu_lo;
    m[n][2] -= mu_hi; m[n][3] -= mu_hi;
    v_lo += m[n][0] * m[n][0] + m[n][1] * m[n][1];
    v_hi += m[n][2] * m[n][2] + m[n][3] * m[n][3];
  }
  const float r_lo = rsqrtf(quad_sum(v_lo) * (1.0f / kC) + 1e-5f);
  const float r_hi = rsqrtf(quad_sum(v_hi) * (1.0f / kC) + 1e-5f);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float2 sc = vec2(w, Layout::lns, n, t);
    const float2 bi = vec2(w, Layout::lnb, n, t);
    m[n][0] = m[n][0] * r_lo * sc.x + bi.x;
    m[n][1] = m[n][1] * r_lo * sc.y + bi.y;
    m[n][2] = m[n][2] * r_hi * sc.x + bi.x;
    m[n][3] = m[n][3] * r_hi * sc.y + bi.y;
  }
}

// Coordinate scalar of rows g and g + 8: s = wc1 . bf16(silu(bc0 + m Wc0)),
// the same value in the 4 lanes of the quad.
__device__ __forceinline__ void coord_scalar(const float (&m)[kNT][4], const uint32_t* w,
                                             int lane, float& s_lo,
                                             float& s_hi) {
  const int t = lane & 3;
  uint32_t a[2][4];
  to_a(m, a);
  float cm[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float2 b = vec2(w, Layout::bc0, n, t);
    cm[n][0] = cm[n][2] = b.x;
    cm[n][1] = cm[n][3] = b.y;
  }
  product<2>(cm, a, w, Layout::wc0, lane);
  s_lo = 0.f; s_hi = 0.f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const float2 wc = vec2(w, Layout::wc1, n, t);
    s_lo = fmaf(wc.x, round_bf16(silu(cm[n][0])), s_lo);
    s_lo = fmaf(wc.y, round_bf16(silu(cm[n][1])), s_lo);
    s_hi = fmaf(wc.x, round_bf16(silu(cm[n][2])), s_hi);
    s_hi = fmaf(wc.y, round_bf16(silu(cm[n][3])), s_hi);
  }
  s_lo = quad_sum(s_lo);
  s_hi = quad_sum(s_hi);
}

// The value of row (lane % 16), given rows g (lo) and g + 8 (hi) per quad.
__device__ __forceinline__ float row_value(float lo, float hi, int lane) {
  const int src = 4 * (lane & 7);
  const float a = __shfl_sync(kFull, lo, src), b = __shfl_sync(kFull, hi, src);
  return (lane & 8) ? b : a;
}

}  // namespace egcl_tile
