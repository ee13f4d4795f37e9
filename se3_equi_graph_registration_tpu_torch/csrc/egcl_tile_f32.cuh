// fp32 building blocks of the EGCL edge program at C = 32, accurate mode, for
// Hopper (sm_90a): register-blocked products on plain FFMA. Shared by the
// forward kernel (egcl_tile_f32.cu) and the backward kernel
// (egcl_backward_tile_f32.cu); the staging and the geometry are egcl_edge.cuh's.
// Split where the backward keeps a pre-activation: first_layer_pre (u),
// normalize (vhat and each row's rstd), coord_pre (cm).
//
// One warp owns one center. A row tile is 16 of its edges; a product's output
// is a [16 edges x 32 channels] fp32 tile in registers, 16 values a lane: with
// rg = lane / 8 and cg = lane % 8, lane (rg, cg) owns rows rg, rg + 4, rg + 8,
// rg + 12 (acc[i] is row rg + 4i) and channels 4cg .. 4cg + 3 (acc[i][j] is
// channel 4cg + j). A row's 32 channels sit in the 8 lanes of a row group, so
// LayerNorm and the coordinate scalar reduce by 3 xor-shuffles; the sum over
// edges is the lane's 4 rows, then 2 xor-shuffles across the row groups.
//
// A product acc += A W reads its operand A from a per-warp [edge][channel]
// tile in shared memory and W ([in][out], 32 outputs a row) from the block's
// copy of the weights. Each step of 4 inputs loads 4 float4 of A (rows rg +
// 4i, inputs k .. k + 3; the 8 lanes of a row group read the same words) and
// 4 float4 of W (input k + q, outputs 4cg .. 4cg + 3; the 4 row groups read
// the same words) and issues 64 FFMA: 8 FFMA a shared load. The tile strides
// (52 and 36 words) put the 4 rows one step reads in 4 disjoint groups of 4
// banks, and a row of W is 32 consecutive words: no bank conflicts.
//
// Numerics are those of egcl.cu in ACCURATE mode: fp32 throughout, no TF32,
// no bf16, no tensor cores; only the order of the fp32 sums differs (biases
// enter as the accumulators' initial value, the h_row block is one product a
// center), and the SiLU's exponential and divide are the fast ones (silu
// below: ~1e-7 absolute).

#pragma once

#include <cuda_runtime.h>

#include "egcl_edge.cuh"

namespace egcl_f32 {

using egcl_edge::kC;
using egcl_edge::kFull;
using egcl_edge::kRows;

// The staged row (fp32 words): h_col 32 | geometry 12 | rel 3 | the
// neighbor's row (int bits) | the coordinate scalar (backward) | 3 spare.
constexpr int kTS = 52;
constexpr int kGeo = 32, kRel = 44, kNbr = 47, kScale = 48;
// Row stride of the per-warp activation and cotangent tiles [16][32].
constexpr int kXS = 36;

// Word offsets in ops/kernels/egcl.py::pack_params_f32's buffer. Matrices are
// [in][out], 32 outputs a row, except w1g_t (16: 12 and 4 zeros). The
// forward's edge weights and vectors first, then the backward's transposed
// matrices (a cotangent times the weight it went through: the torch [out][in]
// layout), then the node MLP: the backward copies the prefix up to `node`,
// the forward the whole buffer.
struct Layout {
  static constexpr int w1 = 0;              // [44][32]: h_col 32, geometry 12
  static constexpr int w1hr = w1 + 44 * kC; // [32][32]
  static constexpr int w2 = w1hr + kC * kC; // [32][32], zeros off the heads
  static constexpr int wc0 = w2 + kC * kC;
  static constexpr int b1 = wc0 + kC * kC;  // [32] each
  static constexpr int b2 = b1 + kC;
  static constexpr int lns = b2 + kC;
  static constexpr int lnb = lns + kC;
  static constexpr int bc0 = lnb + kC;
  static constexpr int wc1 = bc0 + kC;
  static constexpr int wc0_t = wc1 + kC;         // dm = dcm Wc0
  static constexpr int w2_t = wc0_t + kC * kC;   // ds1 = dv W2
  static constexpr int w1hc_t = w2_t + kC * kC;  // dh_col = du W1hc
  static constexpr int w1hr_t = w1hc_t + kC * kC;  // dh_row = (Σ du) W1hr
  static constexpr int w1g_t = w1hr_t + kC * kC;   // dgeo = du W1g: [32][16]
  static constexpr int node = w1g_t + kC * 16;
  static constexpr int wn0 = node;               // [64][32]: h 32, agg_m 32
  static constexpr int wn1 = wn0 + 2 * kC * kC;
  static constexpr int bn0 = wn1 + kC * kC;
  static constexpr int bn1 = bn0 + kC;
  static constexpr int total = bn1 + kC;
};
static_assert(Layout::node % 4 == 0 && Layout::total % 4 == 0, "16-byte aligned rows");

// Rows of the fp32 staging tile for egcl_edge::stage_edges.
struct StageF32 {
  using T = float;
  static constexpr int kStride = kTS;
  __device__ __forceinline__ static void geo(float* dst, const float (&g)[12],
                                             const float (&rel)[3], int j_nb) {
    float4* d = reinterpret_cast<float4*>(dst);
    d[0] = make_float4(g[0], g[1], g[2], g[3]);
    d[1] = make_float4(g[4], g[5], g[6], g[7]);
    d[2] = make_float4(g[8], g[9], g[10], g[11]);
    d[3] = make_float4(rel[0], rel[1], rel[2], __int_as_float(j_nb));
  }
  __device__ __forceinline__ static void h4(float* dst, float4 v) {
    *reinterpret_cast<float4*>(dst) = v;
  }
};

__device__ __forceinline__ bool stage_edges(const float* __restrict__ h,
                                            const float* __restrict__ x,
                                            const int* __restrict__ nbr, int center, int base,
                                            int K, int row0, float xi0, float xi1, float xi2,
                                            float* tile, int lane, float (&rel)[3]) {
  return egcl_edge::stage_edges<StageF32>(h, x, nbr, center, base, K, row0, xi0, xi1, xi2,
                                          tile, lane, rel);
}

// SiLU and its derivative on the fast exponential and divide. __expf is
// within 2 + floor(1.173 |v|) ulp of expf; where that grows (v < -2) the SiLU
// itself is below 0.3 and falls with e^v, so the absolute error stays under
// ~1e-7; __fdividef is within 2 ulp, and returns 0 once 1 + e^-v passes
// 2^126 (v < -87), where the SiLU is ~1e-36. Far inside the 1e-4-of-scale
// tolerance; the exact expf and IEEE division cost ~20 instructions a SiLU,
// 64 an edge in the forward.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ float dsilu(float v) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-v));
  return s * (1.0f + v * (1.0f - s));
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// This lane's channels 4cg .. 4cg + 3 of the vector at word offset `off`.
__device__ __forceinline__ float4 vec4(const float* w, int off, int cg) {
  return *reinterpret_cast<const float4*>(w + off + 4 * cg);
}

// Sums over the 8 lanes of a row group (one row's 32 channels) and over the 4
// row groups (the same channels of the other rows).
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v + __shfl_xor_sync(kFull, v, 4);
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 8);
  return v + __shfl_xor_sync(kFull, v, 16);
}

// acc[i][j] = v[j] for every row.
__device__ __forceinline__ void fill(float (&acc)[4][4], float4 v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
  }
}

// One step of 4 inputs: acc[i][j] += sum_q A[(rg + 4i) SA + k + q] W[(k + q) 32 + 4cg + j].
template <int SA>
__device__ __forceinline__ void step(float (&acc)[4][4], const float* A, const float* W, int k,
                                     int rg, int cg) {
  float4 a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (rg + 4 * i) * SA + k);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 w = *reinterpret_cast<const float4*>(W + (k + q) * kC + 4 * cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = comp(a[i], q);
      acc[i][0] = fmaf(av, w.x, acc[i][0]);
      acc[i][1] = fmaf(av, w.y, acc[i][1]);
      acc[i][2] = fmaf(av, w.z, acc[i][2]);
      acc[i][3] = fmaf(av, w.w, acc[i][3]);
    }
  }
}

// acc += A[:, 0:KIN] W, W [KIN][32].
template <int SA, int KIN>
__device__ __forceinline__ void product(float (&acc)[4][4], const float* A, const float* W,
                                        int rg, int cg) {
  static_assert(KIN % 4 == 0, "inputs in steps of 4");
#pragma unroll
  for (int k = 0; k < KIN; k += 4) step<SA>(acc, A, W, k, rg, cg);
}

// acc += A W for a block-diagonal W [32][32] in heads of width wh: this
// lane's 4 channels read only the inputs of their heads, [k0, k0 + max(wh, 4))
// (with wh < 4 the zero entries of the lane's other heads are read too).
template <int SA>
__device__ __forceinline__ void head_product(float (&acc)[4][4], const float* A,
                                             const float* W, int wh, int rg, int cg) {
  const int kw = wh > 4 ? wh : 4;
  const int k0 = (4 * cg / kw) * kw;
  for (int k = k0; k < k0 + kw; k += 4) step<SA>(acc, A, W, k, rg, cg);
}

// acc[i][j] += sum_k A[(rg + 4i) SA + k] W[k 16 + 2cg + j] over 32 inputs: an
// output of 16 channels (W [32][16]), 2 a lane.
template <int SA>
__device__ __forceinline__ void product16(float (&acc)[4][2], const float* A, const float* W,
                                          int rg, int cg) {
#pragma unroll
  for (int k = 0; k < kC; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg + 4 * i) * SA + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 w = *reinterpret_cast<const float2*>(W + (k + q) * 16 + 2 * cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = comp(a[i], q);
        acc[i][0] = fmaf(av, w.x, acc[i][0]);
        acc[i][1] = fmaf(av, w.y, acc[i][1]);
      }
    }
  }
}

// Registers -> rows of an [edge][channel] tile of stride kXS.
__device__ __forceinline__ void store_rows(const float (&acc)[4][4], float* X, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(X + (rg + 4 * i) * kXS + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The h_row block of the first edge layer, the same for every edge of the
// center: b1 + h_i W1hr, channels 4cg .. 4cg + 3 (each row group sums 8 of
// the 32 inputs, then the groups add up).
__device__ __forceinline__ float4 hrow_block(const float* __restrict__ h, int center,
                                             const float* w, int rg, int cg) {
  const float4* hp = reinterpret_cast<const float4*>(h + (size_t)center * kC + 8 * rg);
  const float4 h0 = hp[0], h1 = hp[1];
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float hv = q < 4 ? comp(h0, q) : comp(h1, q - 4);
    const float4 wv = vec4(w, Layout::w1hr + (8 * rg + q) * kC, cg);
    p[0] = fmaf(hv, wv.x, p[0]);
    p[1] = fmaf(hv, wv.y, p[1]);
    p[2] = fmaf(hv, wv.z, p[2]);
    p[3] = fmaf(hv, wv.w, p[3]);
  }
  const float4 b = vec4(w, Layout::b1, cg);
  return make_float4(b.x + group_sum(p[0]), b.y + group_sum(p[1]), b.z + group_sum(p[2]),
                     b.w + group_sum(p[3]));
}

// First edge layer on the staged tile before its SiLU: u = hr + [h_col | geo] W1.
__device__ __forceinline__ void first_layer_pre(const float* tile, float4 hr, const float* w,
                                                int rg, int cg, float (&u)[4][4]) {
  fill(u, hr);
  product<kTS, 44>(u, tile, w + Layout::w1, rg, cg);
}

// Head layer on the s1 tile: v = b2 + s1 W2 (block-diagonal).
__device__ __forceinline__ void head_layer(const float* S1, const float* w, int wh, int rg,
                                           int cg, float (&v)[4][4]) {
  fill(v, vec4(w, Layout::b2, cg));
  head_product<kXS>(v, S1, w + Layout::w2, wh, rg, cg);
}

// LayerNorm's normalisation over each row's 32 channels, in place: v becomes
// vhat = (v - mean) * r with r = rsqrt(var + 1e-5) (biased variance).
__device__ __forceinline__ void normalize(float (&v)[4][4], float (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mu = row_sum((v[i][0] + v[i][1]) + (v[i][2] + v[i][3])) * (1.0f / kC);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[i][j] -= mu;
      s = fmaf(v[i][j], v[i][j], s);
    }
    r[i] = rsqrtf(row_sum(s) * (1.0f / kC) + 1e-5f);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] *= r[i];
  }
}

// LayerNorm's affine part: m = vhat * ln_scale + ln_bias.
__device__ __forceinline__ void ln_affine(const float (&vhat)[4][4], const float* w, int cg,
                                          float (&m)[4][4]) {
  const float4 sc = vec4(w, Layout::lns, cg), bi = vec4(w, Layout::lnb, cg);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i][0] = fmaf(vhat[i][0], sc.x, bi.x);
    m[i][1] = fmaf(vhat[i][1], sc.y, bi.y);
    m[i][2] = fmaf(vhat[i][2], sc.z, bi.z);
    m[i][3] = fmaf(vhat[i][3], sc.w, bi.w);
  }
}

// The coordinate MLP's hidden layer before its SiLU, on the m tile: cm = bc0 + m Wc0.
__device__ __forceinline__ void coord_pre(const float* M, const float* w, int rg, int cg,
                                          float (&cm)[4][4]) {
  fill(cm, vec4(w, Layout::bc0, cg));
  product<kXS, kC>(cm, M, w + Layout::wc0, rg, cg);
}

// The coordinate scalar of each of this lane's rows: s = wc1 . silu(cm), the
// same value in the 8 lanes of the row group.
__device__ __forceinline__ void coord_sum(const float (&cm)[4][4], const float* w, int cg,
                                          float (&s)[4]) {
  const float4 wc = vec4(w, Layout::wc1, cg);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float p = wc.x * silu(cm[i][0]);
    p = fmaf(wc.y, silu(cm[i][1]), p);
    p = fmaf(wc.z, silu(cm[i][2]), p);
    p = fmaf(wc.w, silu(cm[i][3]), p);
    s[i] = row_sum(p);
  }
}

// v[i] for i = sel, 0 <= sel < 4.
__device__ __forceinline__ float pick(const float (&v)[4], int sel) {
  return sel == 0 ? v[0] : sel == 1 ? v[1] : sel == 2 ? v[2] : v[3];
}

}  // namespace egcl_f32
