// Tensor-core building blocks of the EGCL edge program in fast mode (bf16
// operands, fp32 accumulation), for Hopper (sm_90a). Shared by the forward
// kernel (egcl_tile.cu) and the backward kernel (egcl_backward_tile.cu):
// the bf16 staging tile (the geometry and staging code is egcl_edge.cuh's),
// fragment helpers and the s1 -> m -> coord chain, split
// where the backward keeps a pre-activation (first_layer_pre, normalize,
// coord_pre).
//
// Every block is a template on CP, the compiled channel width, built at two
// widths: CP = 32 runs C = 32, CP = kPadded = 48 runs 32 < C <= 36 (KITTI's
// C = 33) with the channels C .. 47 as zero pads. The pads are zero in every
// weight and vector (ops/kernels/egcl.py::pack_params_tile), in the staged
// h_col (never written, zeroed once) and so in every activation and
// cotangent fragment (each stage of a pad channel is 0 + 0-weighted sums;
// LayerNorm and its backward mask the pad terms out); h is read and written
// at its true stride C, and the mean and variance divide by the true C.
// 48 is the least multiple of 16 above 36: the chain below turns n-tiles 2j
// and 2j + 1 into k-step j, so a width is whole k-steps.
//
// One warp owns one center. A row tile is 16 of its edges: the 16 rows of a
// bf16 mma.sync.m16n8k16 product whose CP output channels are CP / 8 n-tiles
// of 8 (4 at CP = 32, 6 at 48). With g = lane / 4 and t = lane % 4 the PTX
// fragments are
//   A (16x16, row):  a0 = (row g,   k 2t, 2t+1)    a1 = (row g+8, k 2t, 2t+1)
//                    a2 = (row g,   k 2t+8, 2t+9)  a3 = (row g+8, k 2t+8, 2t+9)
//   B (16x8,  col):  b0 = (k 2t, 2t+1, col g)      b1 = (k 2t+8, 2t+9, col g)
//   C (16x8,  f32):  c0, c1 = (row g,   col 2t, 2t+1)
//                    c2, c3 = (row g+8, col 2t, 2t+1)
// (the lower k or column index in the lower 16 bits). So the accumulators of
// n-tiles 2j and 2j+1, rounded to bf16 pairs, ARE the A fragment of the next
// layer's k-step j: the edge MLP chains in registers with no shared-memory
// round trip. A row's CP channels sit in the 4 lanes of a quad (CP / 4
// each), so a LayerNorm is two xor-shuffles, and the sum over the 16 edges is
// c0 + c2 followed by xor-shuffles over 4, 8 and 16.
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
// initial value). At CP = 32 the arithmetic is that of the first tile
// kernels, operation for operation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "egcl_edge.cuh"

namespace egcl_tile {

using egcl_edge::kFull;
using egcl_edge::kRows;

// The padded width built beside CP = 32: it runs 32 < C <= 36.
constexpr int kPadded = 48;
constexpr int kBlock = 64;   // words of a fragment block: 32 lanes x (b0, b1)

// The widths of one instantiation.
template <int CP>
struct Dims {
  static_assert(CP == 32 || CP == kPadded, "the two widths built");
  static constexpr int kNT = CP / 8;    // n-tiles of 8 channels
  static constexpr int kKS = CP / 16;   // k-steps of CP inputs
  // Row stride of the staging tile in bf16; a row holds CP + 16 (h_col CP |
  // geometry 12 + 4 zeros). The A-fragment loads of the 8 rows g read words
  // g (kStride / 2) + t: a word stride of 28 (56) or 36 (72) puts the rows on
  // distinct multiples of 4 banks, so the 32 lanes hit 32 banks; 112 and 144
  // bytes keep every row 16-byte aligned.
  static constexpr int kStride = CP == 32 ? 56 : 72;
  static_assert(kStride >= CP + 16 && (kStride / 2) % 8 == 4 && kStride % 8 == 0, "rows");
};

// Word (32-bit) offsets into the packed buffer. A fragment block is one
// (k-step, n-tile) pair: 32 lanes x (b0, b1) = 64 words.
template <int CP>
struct Layout {
  static constexpr int NT = Dims<CP>::kNT, KS = Dims<CP>::kKS;
  static constexpr int w1 = 0;                              // h_col KS, geo 1, h_row KS k-steps
  static constexpr int w1_hrow = w1 + (KS + 1) * NT * kBlock;
  static constexpr int w2 = w1 + (2 * KS + 1) * NT * kBlock;  // KS (dense, zeros off the heads)
  static constexpr int wc0 = w2 + KS * NT * kBlock;           // KS
  static constexpr int wn0 = wc0 + KS * NT * kBlock;          // 2 KS: h KS, agg_m KS
  static constexpr int wn1 = wn0 + 2 * KS * NT * kBlock;      // KS
  static constexpr int vectors = wn1 + KS * NT * kBlock;
  static constexpr int b1 = vectors;                          // fp32 [CP] each
  static constexpr int b2 = b1 + CP;
  static constexpr int lns = b2 + CP;
  static constexpr int lnb = lns + CP;
  static constexpr int bc0 = lnb + CP;
  static constexpr int wc1 = bc0 + CP;
  static constexpr int bn0 = wc1 + CP;
  static constexpr int bn1 = bn0 + CP;
  static constexpr int total = bn1 + CP;
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

// This lane's (b0, b1) of block (j, n) of a matrix at word offset `off` whose
// k-steps hold NT n-tiles each.
template <int NT>
__device__ __forceinline__ uint2 b_frag_nt(const uint32_t* w, int off, int j, int n, int lane) {
  return reinterpret_cast<const uint2*>(w + off + (j * NT + n) * kBlock)[lane];
}

// The same for the CP-channel matrices of `Layout<CP>`.
template <int CP>
__device__ __forceinline__ uint2 b_frag(const uint32_t* w, int off, int j, int n, int lane) {
  return b_frag_nt<Dims<CP>::kNT>(w, off, j, n, lane);
}

// acc[n] += A[j] * W[j][n] over KS k-steps and the CP / 8 n-tiles.
template <int CP, int KS>
__device__ __forceinline__ void product(float (&acc)[Dims<CP>::kNT][4], const uint32_t (&a)[KS][4],
                                        const uint32_t* w, int off, int lane) {
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int n = 0; n < Dims<CP>::kNT; ++n) mma(acc[n], a[j], b_frag<CP>(w, off, j, n, lane));
}

// Accumulators [16 x CP] -> the CP / 16 A fragments of the next layer.
template <int CP>
__device__ __forceinline__ void to_a(const float (&acc)[Dims<CP>::kNT][4],
                                     uint32_t (&a)[Dims<CP>::kKS][4]) {
#pragma unroll
  for (int j = 0; j < Dims<CP>::kKS; ++j) {
    a[j][0] = pack2(acc[2 * j][0], acc[2 * j][1]);
    a[j][1] = pack2(acc[2 * j][2], acc[2 * j][3]);
    a[j][2] = pack2(acc[2 * j + 1][0], acc[2 * j + 1][1]);
    a[j][3] = pack2(acc[2 * j + 1][2], acc[2 * j + 1][3]);
  }
}

// One vector [CP] whose every row is the same -> A fragments (rows g and g+8
// equal): v[n] = channels 8n + 2t, 8n + 2t + 1 of the vector.
template <int CP>
__device__ __forceinline__ void row_to_a(const float2 (&v)[Dims<CP>::kNT],
                                         uint32_t (&a)[Dims<CP>::kKS][4]) {
#pragma unroll
  for (int j = 0; j < Dims<CP>::kKS; ++j) {
    a[j][0] = a[j][1] = pack2(v[2 * j].x, v[2 * j].y);
    a[j][2] = a[j][3] = pack2(v[2 * j + 1].x, v[2 * j + 1].y);
  }
}

// This lane's channels 8n + 2t, 8n + 2t + 1 of the fp32 vector at word offset `off`.
__device__ __forceinline__ float2 vec2(const uint32_t* w, int off, int n, int t) {
  return *reinterpret_cast<const float2*>(w + off + 8 * n + 2 * t);
}

// Channels 8n + 2t, 8n + 2t + 1 of row `row` of a [rows][c] tensor, n < CP / 8:
// at CP = 32 (c = 32) one 8-byte load, above it one word a real channel at
// the true stride c, the pads 0.
template <int CP>
__device__ __forceinline__ float2 load2(const float* __restrict__ t, size_t row, int c, int n,
                                        int tq) {
  const int ch = 8 * n + 2 * tq;
  if constexpr (CP == 32) {
    return *reinterpret_cast<const float2*>(t + row * 32 + ch);
  } else {
    const float* r = t + row * c;
    return make_float2(ch < c ? r[ch] : 0.f, ch + 1 < c ? r[ch + 1] : 0.f);
  }
}

// The real channels of v (channels 8n + 2t, 8n + 2t + 1) into row `row` of a
// [rows][c] tensor.
template <int CP>
__device__ __forceinline__ void store2(float* __restrict__ t, size_t row, int c, int n, int tq,
                                       float2 v) {
  const int ch = 8 * n + 2 * tq;
  if constexpr (CP == 32) {
    *reinterpret_cast<float2*>(t + row * 32 + ch) = v;
  } else {
    float* r = t + row * c;
    if (ch < c) r[ch] = v.x;
    if (ch + 1 < c) r[ch + 1] = v.y;
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Rows of the bf16 staging tile for egcl_edge::stage_edges: [h_col CP |
// geometry 12 | 0 0 0 0], kStride elements.
template <int CP>
struct StageBf16 {
  using T = __nv_bfloat16;
  static constexpr int kStride = Dims<CP>::kStride;
  __device__ __forceinline__ static void geo(T* dst, const float (&g)[12], const float (&)[3],
                                             int) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(pack2(g[0], g[1]), pack2(g[2], g[3]), pack2(g[4], g[5]),
                      pack2(g[6], g[7]));
    d[1] = make_uint4(pack2(g[8], g[9]), pack2(g[10], g[11]), 0u, 0u);
  }
  __device__ __forceinline__ static void h4(T* dst, float4 v) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
  }
  __device__ __forceinline__ static void h1(T* dst, float v) { *dst = __float2bfloat16_rn(v); }
};

// Stage edges row0 .. row0 + 15 of `center` into the warp's bf16 tile
// (egcl_edge::stage_edges) from h at its true width c; returns whether this
// lane's edge is valid, and its rel.
template <int CP>
__device__ __forceinline__ bool stage_edges(const float* __restrict__ h,
                                            const float* __restrict__ x,
                                            const int* __restrict__ nbr, int center, int base,
                                            int K, int row0, float xi0, float xi1, float xi2,
                                            __nv_bfloat16* tile, int lane, float (&rel)[3],
                                            int c) {
  return egcl_edge::stage_edges<StageBf16<CP>, CP>(h, x, nbr, center, base, K, row0, xi0, xi1,
                                                   xi2, tile, lane, rel, c);
}

// A fragments of the staged tile's CP / 16 + 1 k-steps (h_col CP / 16, geometry 1).
template <int CP>
__device__ __forceinline__ void staged_a(const __nv_bfloat16* tile, int lane,
                                         uint32_t (&a)[Dims<CP>::kKS + 1][4]) {
  constexpr int S = Dims<CP>::kStride;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(tile + g * S) + t;
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(tile + (g + 8) * S) + t;
#pragma unroll
  for (int j = 0; j < Dims<CP>::kKS + 1; ++j) {
    a[j][0] = lo[8 * j];
    a[j][1] = hi[8 * j];
    a[j][2] = lo[8 * j + 4];
    a[j][3] = hi[8 * j + 4];
  }
}

// The h_row block of the first edge layer, the same for every edge of the
// center: b1 + W1_hrow h_i as accumulator values (hr[n] = channels 8n + 2t,
// 8n + 2t + 1). `ahi` is row_to_a of h_i.
template <int CP>
__device__ __forceinline__ void hrow_block(const uint32_t (&ahi)[Dims<CP>::kKS][4],
                                           const uint32_t* w, int lane,
                                           float2 (&hr)[Dims<CP>::kNT]) {
  constexpr int NT = Dims<CP>::kNT;
  const int t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 b = vec2(w, Layout<CP>::b1, n, t);
    acc[n][0] = acc[n][2] = b.x;
    acc[n][1] = acc[n][3] = b.y;
  }
  product<CP, Dims<CP>::kKS>(acc, ahi, w, Layout<CP>::w1_hrow, lane);
#pragma unroll
  for (int n = 0; n < NT; ++n) hr[n] = make_float2(acc[n][0], acc[n][1]);
}

// First edge layer on a staged tile before its SiLU: u = hr + [h_col | geo] W1.
template <int CP>
__device__ __forceinline__ void first_layer_pre(const __nv_bfloat16* tile,
                                                const float2 (&hr)[Dims<CP>::kNT],
                                                const uint32_t* w, int lane,
                                                float (&u)[Dims<CP>::kNT][4]) {
  uint32_t a[Dims<CP>::kKS + 1][4];
  staged_a<CP>(tile, lane, a);
#pragma unroll
  for (int n = 0; n < Dims<CP>::kNT; ++n) {
    u[n][0] = u[n][2] = hr[n].x;
    u[n][1] = u[n][3] = hr[n].y;
  }
  product<CP, Dims<CP>::kKS + 1>(u, a, w, Layout<CP>::w1, lane);
}

// First edge layer on a staged tile: s1 = silu(hr + [h_col | geo] W1), fp32.
template <int CP>
__device__ __forceinline__ void first_layer(const __nv_bfloat16* tile,
                                            const float2 (&hr)[Dims<CP>::kNT], const uint32_t* w,
                                            int lane, float (&s1)[Dims<CP>::kNT][4]) {
  first_layer_pre<CP>(tile, hr, w, lane, s1);
#pragma unroll
  for (int n = 0; n < Dims<CP>::kNT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) s1[n][q] = silu(s1[n][q]);
}

// Head layer: m = b2 + s1 W2, W2 block-diagonal in heads of width wh. At
// CP = 32 with wh <= 16 the 8 channels of n-tile n read only k-step n / 2;
// the other k-step's block is exactly zero and is skipped. Above CP = 32 the
// product is dense: heads of a width dividing 32 < C <= 36 need not align
// with the k-steps, and the zero blocks add exact zeros.
template <int CP>
__device__ __forceinline__ void head_layer(const float (&s1)[Dims<CP>::kNT][4],
                                           const uint32_t* w, int wh, int lane,
                                           float (&m)[Dims<CP>::kNT][4]) {
  const int t = lane & 3;
  uint32_t a[Dims<CP>::kKS][4];
  to_a<CP>(s1, a);
#pragma unroll
  for (int n = 0; n < Dims<CP>::kNT; ++n) {
    const float2 b = vec2(w, Layout<CP>::b2, n, t);
    m[n][0] = m[n][2] = b.x;
    m[n][1] = m[n][3] = b.y;
  }
  if (CP == 32 && wh <= 16) {
#pragma unroll
    for (int n = 0; n < Dims<CP>::kNT; ++n)
      mma(m[n], a[n / 2], b_frag<CP>(w, Layout<CP>::w2, n / 2, n, lane));
  } else {
    product<CP, Dims<CP>::kKS>(m, a, w, Layout<CP>::w2, lane);
  }
}

// Whether this lane's channel 8n + 2t + q (q = 0, 1) is real at width c.
template <int CP>
__device__ __forceinline__ bool real(int n, int t, int q, int c) {
  return CP == 32 || 8 * n + 2 * t + q < c;
}

// LayerNorm's normalisation over the c channels of rows g and g + 8, in
// place: m becomes vhat = (m - mean) * r with r = rsqrt(var + 1e-5) (biased
// variance), and r_lo, r_hi are the rows' r. The pad channels are 0 on entry
// and stay 0 (their (0 - mean)² is masked out of the variance).
template <int CP>
__device__ __forceinline__ void normalize(float (&m)[Dims<CP>::kNT][4], float& r_lo,
                                          float& r_hi, int c, int lane) {
  constexpr int NT = Dims<CP>::kNT;
  const int t = lane & 3;
  const float inv_c = CP == 32 ? 1.0f / 32 : 1.0f / c;
  float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s_lo += m[n][0] + m[n][1];
    s_hi += m[n][2] + m[n][3];
  }
  const float mu_lo = quad_sum(s_lo) * inv_c, mu_hi = quad_sum(s_hi) * inv_c;
  float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const bool r0 = real<CP>(n, t, 0, c), r1 = real<CP>(n, t, 1, c);
    m[n][0] = r0 ? m[n][0] - mu_lo : 0.f; m[n][1] = r1 ? m[n][1] - mu_lo : 0.f;
    m[n][2] = r0 ? m[n][2] - mu_hi : 0.f; m[n][3] = r1 ? m[n][3] - mu_hi : 0.f;
    v_lo += m[n][0] * m[n][0] + m[n][1] * m[n][1];
    v_hi += m[n][2] * m[n][2] + m[n][3] * m[n][3];
  }
  r_lo = rsqrtf(quad_sum(v_lo) * inv_c + 1e-5f);
  r_hi = rsqrtf(quad_sum(v_hi) * inv_c + 1e-5f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    m[n][0] *= r_lo; m[n][1] *= r_lo;
    m[n][2] *= r_hi; m[n][3] *= r_hi;
  }
}

// LayerNorm's affine part: m = vhat * ln_scale + ln_bias.
template <int CP>
__device__ __forceinline__ void ln_affine(const float (&vhat)[Dims<CP>::kNT][4],
                                          const uint32_t* w, int lane,
                                          float (&m)[Dims<CP>::kNT][4]) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < Dims<CP>::kNT; ++n) {
    const float2 sc = vec2(w, Layout<CP>::lns, n, t);
    const float2 bi = vec2(w, Layout<CP>::lnb, n, t);
    m[n][0] = vhat[n][0] * sc.x + bi.x;
    m[n][1] = vhat[n][1] * sc.y + bi.y;
    m[n][2] = vhat[n][2] * sc.x + bi.x;
    m[n][3] = vhat[n][3] * sc.y + bi.y;
  }
}

// LayerNorm over the c channels of rows g and g + 8, in place (biased
// variance, eps 1e-5).
template <int CP>
__device__ __forceinline__ void layer_norm(float (&m)[Dims<CP>::kNT][4], const uint32_t* w,
                                           int c, int lane) {
  float r_lo, r_hi;
  normalize<CP>(m, r_lo, r_hi, c, lane);
  ln_affine<CP>(m, w, lane, m);
}

// The coordinate MLP's hidden layer before its SiLU: cm = bc0 + m Wc0.
template <int CP>
__device__ __forceinline__ void coord_pre(const float (&m)[Dims<CP>::kNT][4], const uint32_t* w,
                                          int lane, float (&cm)[Dims<CP>::kNT][4]) {
  const int t = lane & 3;
  uint32_t a[Dims<CP>::kKS][4];
  to_a<CP>(m, a);
#pragma unroll
  for (int n = 0; n < Dims<CP>::kNT; ++n) {
    const float2 b = vec2(w, Layout<CP>::bc0, n, t);
    cm[n][0] = cm[n][2] = b.x;
    cm[n][1] = cm[n][3] = b.y;
  }
  product<CP, Dims<CP>::kKS>(cm, a, w, Layout<CP>::wc0, lane);
}

// s = wc1 . bf16(silu(cm)) of rows g and g + 8, the same value in the 4
// lanes of the quad.
template <int CP>
__device__ __forceinline__ void coord_sum(const float (&cm)[Dims<CP>::kNT][4], const uint32_t* w,
                                          int lane, float& s_lo, float& s_hi) {
  const int t = lane & 3;
  s_lo = 0.f; s_hi = 0.f;
#pragma unroll
  for (int n = 0; n < Dims<CP>::kNT; ++n) {
    const float2 wc = vec2(w, Layout<CP>::wc1, n, t);
    s_lo = fmaf(wc.x, round_bf16(silu(cm[n][0])), s_lo);
    s_lo = fmaf(wc.y, round_bf16(silu(cm[n][1])), s_lo);
    s_hi = fmaf(wc.x, round_bf16(silu(cm[n][2])), s_hi);
    s_hi = fmaf(wc.y, round_bf16(silu(cm[n][3])), s_hi);
  }
  s_lo = quad_sum(s_lo);
  s_hi = quad_sum(s_hi);
}

// Coordinate scalar of rows g and g + 8: s = wc1 . bf16(silu(bc0 + m Wc0)),
// the same value in the 4 lanes of the quad.
template <int CP>
__device__ __forceinline__ void coord_scalar(const float (&m)[Dims<CP>::kNT][4],
                                             const uint32_t* w, int lane, float& s_lo,
                                             float& s_hi) {
  float cm[Dims<CP>::kNT][4];
  coord_pre<CP>(m, w, lane, cm);
  coord_sum<CP>(cm, w, lane, s_lo, s_hi);
}

// The value of row (lane % 16), given rows g (lo) and g + 8 (hi) per quad.
__device__ __forceinline__ float row_value(float lo, float hi, int lane) {
  const int src = 4 * (lane & 7);
  const float a = __shfl_sync(kFull, lo, src), b = __shfl_sync(kFull, hi, src);
  return (lane & 8) ? b : a;
}

}  // namespace egcl_tile
