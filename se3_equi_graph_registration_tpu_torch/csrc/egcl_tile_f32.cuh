// fp32 building blocks of the EGCL edge program in accurate mode, for Hopper
// (sm_90a): register-blocked products on plain FFMA. Shared by the forward
// kernel (egcl_tile_f32.cu) and the backward kernel
// (egcl_backward_tile_f32.cu); the staging and the geometry are egcl_edge.cuh's.
// Split where the backward keeps a pre-activation: first_layer_pre (u),
// normalize (vhat and each row's rstd), coord_pre (cm).
//
// Every block is a template on CP, the compiled channel width, built at two
// widths: CP = 32 runs C = 32, CP = kPadded = 36 runs 32 < C <= 36 (KITTI's
// C = 33) with the channels C .. 35 as zero pads. The pads are zero in every
// weight and vector (ops/kernels/egcl.py::pack_params_f32), in the staged
// h_col (never written, zeroed once), and in every activation and cotangent
// tile (each stage of a pad channel is 0 + 0-weighted sums; LayerNorm and
// its backward mask the pad terms out); h is read and written at its true
// stride C, and the mean and variance divide by the true C.
//
// One warp owns one center. A row tile is 16 of its edges; a product's output
// is a [16 edges x CP channels] fp32 tile in registers: with rg = lane / 8
// and cg = lane % 8, lane (rg, cg) owns rows rg, rg + 4, rg + 8, rg + 12
// (acc[i] is row rg + 4i) and channels 4cg .. 4cg + 3 (acc[i][j], j < 4);
// above CP = 32 a fifth slot acc[i][4] holds the tail channel 32 + cg in
// the lanes cg < kTail = CP - 32 and stays 0 in the others (their tail
// weights read as 0, their tail never stored), as a pad channel would. A
// row's channels sit in the 8 lanes of a row group, so LayerNorm and the
// coordinate scalar reduce by 3 xor-shuffles; the sum over edges is the
// lane's 4 rows, then 2 xor-shuffles across the row groups. At CP = 36 a
// product pays 20 FFMA a lane an input for 33 real channels of 36 inputs,
// against 16 for 32 at C = 32.
//
// A product acc += A W reads its operand A from a per-warp [edge][channel]
// tile in shared memory and W ([in][out], CP outputs a row) from the block's
// copy of the weights. Each step of 4 inputs loads 4 float4 of A (rows rg +
// 4i, inputs k .. k + 3; the 8 lanes of a row group read the same words) and
// per input a float4 of W (outputs 4cg .. 4cg + 3; the 4 row groups read the
// same words), above CP = 32 also one tail word (output 32 + cg): 64 FFMA
// for 8 shared loads at CP = 32, 80 for 12 at CP = 36.
//
// Strides (fp32 words). The staged tile's row is [h_col CP | geometry 12 |
// rel 3 | neighbor row | coordinate scalar | spare]: kTS = CP + 17 rounded
// up to 16 bytes, 52 at CP = 32 and 56 at 36. The activation and cotangent
// tiles' row is CP channels: kXS = 36 at both widths. One float4 step of A
// reads 4 consecutive rows at stride S, a 4-bank group each at bank (r S)
// mod 32: S mod 32 = 20 (52), 24 (56) or 4 (36) puts the 4 groups on 16
// distinct banks (conflict_free), and the 8 lanes of a row group read one
// address: no bank conflicts. A row of W is CP consecutive words, the
// float4s on banks 0-31 and the tail words on kTail consecutive banks.
//
// Shared memory per block and blocks per SM (H100: 227 KB of 1,024 bytes a
// block, 65,536 registers an SM):
//   forward,  CP = 32: weights 12,416 words + 8 warps x 1,504 = 95.5 KB;
//             2 blocks of 8 warps an SM at 128 registers a thread;
//   forward,  CP = 36: 15,552 + 16 warps x 1,580 = 159.5 KB; 1 block of 16
//             warps at 128 registers;
//   backward, CP = 32: 9,280 (weights up to the node MLP) + 4,812 (gradient
//             copies) + 16 warps x 2,624 = 219.0 KB; 1 block of 16 warps;
//   backward, CP = 36: 11,592 + 6,456 + 14 warps x 2,696 = 217.9 KB; 1 block
//             of 14 warps, up to 144 registers a thread.
//
// Numerics are those of egcl.cu in ACCURATE mode: fp32 throughout, no TF32,
// no bf16, no tensor cores; only the order of the fp32 sums differs (biases
// enter as the accumulators' initial value, the h_row block is one product a
// center), and the SiLU's exponential and divide are the fast ones (silu
// below: ~1e-7 absolute). At CP = 32 the arithmetic is that of the first
// fp32 tile kernels, operation for operation.

#pragma once

#include <cuda_runtime.h>

#include "egcl_edge.cuh"

namespace egcl_f32 {

using egcl_edge::kFull;
using egcl_edge::kRows;

// The padded width built beside CP = 32: it runs 32 < C <= kPadded.
constexpr int kPadded = 36;

// Whether 4 consecutive rows of stride s (fp32 words) put their float4s on 4
// disjoint groups of 4 banks.
constexpr bool conflict_free(int s) { return s % 4 == 0 && s % 32 != 0 && s % 32 != 16; }

// The widths of one instantiation.
template <int CP>
struct Dims {
  static_assert(CP == 32 || CP == kPadded, "the two widths built");
  static constexpr int kJ = CP == 32 ? 4 : 5;               // channels a lane
  static constexpr int kTail = CP - 32;                     // lanes cg < kTail own 32 + cg
  static constexpr int kTS = (CP + 17 + 3) / 4 * 4;         // staged row: 52, 56, 60
  static constexpr int kGeo = CP, kRel = CP + 12, kNbr = CP + 15, kScale = CP + 16;
  static constexpr int kXS = CP % 8 == 4 ? CP : CP + 4;     // activation row: 36, 36, 44
  static_assert(kScale < kTS && conflict_free(kTS) && conflict_free(kXS) && kXS >= CP, "rows");
};

// Word offsets in ops/kernels/egcl.py::pack_params_f32's buffer. Matrices are
// [in][out], CP outputs a row, except w1g_t (16: 12 and 4 zeros). The
// forward's edge weights and vectors first, then the backward's transposed
// matrices (a cotangent times the weight it went through: the torch [out][in]
// layout), then the node MLP: the backward copies the prefix up to `node`,
// the forward the whole buffer.
template <int CP>
struct Layout {
  static constexpr int w1 = 0;               // [CP + 12][CP]: h_col CP, geometry 12
  static constexpr int w1hr = w1 + (CP + 12) * CP;  // [CP][CP]
  static constexpr int w2 = w1hr + CP * CP;  // [CP][CP], zeros off the heads
  static constexpr int wc0 = w2 + CP * CP;
  static constexpr int b1 = wc0 + CP * CP;   // [CP] each
  static constexpr int b2 = b1 + CP;
  static constexpr int lns = b2 + CP;
  static constexpr int lnb = lns + CP;
  static constexpr int bc0 = lnb + CP;
  static constexpr int wc1 = bc0 + CP;
  static constexpr int wc0_t = wc1 + CP;          // dm = dcm Wc0
  static constexpr int w2_t = wc0_t + CP * CP;    // ds1 = dv W2
  static constexpr int w1hc_t = w2_t + CP * CP;   // dh_col = du W1hc
  static constexpr int w1hr_t = w1hc_t + CP * CP; // dh_row = (Σ du) W1hr
  static constexpr int w1g_t = w1hr_t + CP * CP;  // dgeo = du W1g: [CP][16]
  static constexpr int node = w1g_t + CP * 16;
  static constexpr int wn0 = node;                // [2 CP][CP]: h CP, agg_m CP
  static constexpr int wn1 = wn0 + 2 * CP * CP;
  static constexpr int bn0 = wn1 + CP * CP;
  static constexpr int bn1 = bn0 + CP;
  static constexpr int total = bn1 + CP;
  static_assert(node % 4 == 0 && total % 4 == 0 && CP % 4 == 0, "16-byte aligned rows");
};

// Rows of the fp32 staging tile for egcl_edge::stage_edges.
template <int CP>
struct StageF32 {
  using T = float;
  static constexpr int kStride = Dims<CP>::kTS;
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

template <int CP>
__device__ __forceinline__ bool stage_edges(const float* __restrict__ h,
                                            const float* __restrict__ x,
                                            const int* __restrict__ nbr, int center, int base,
                                            int K, int row0, float xi0, float xi1, float xi2,
                                            float* tile, int lane, float (&rel)[3], int c) {
  return egcl_edge::stage_edges<StageF32<CP>, CP>(h, x, nbr, center, base, K, row0, xi0, xi1,
                                                  xi2, tile, lane, rel, c);
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

// This lane's channels of the vector at word offset `off`.
template <int CP>
__device__ __forceinline__ void vec(const float* w, int off, int cg, float (&v)[Dims<CP>::kJ]) {
  const float4 a = *reinterpret_cast<const float4*>(w + off + 4 * cg);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  if constexpr (Dims<CP>::kJ == 5) v[4] = cg < Dims<CP>::kTail ? w[off + 32 + cg] : 0.f;
}

// Sums over the 8 lanes of a row group (one row's channels) and over the 4
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

// The sum of one row's slots in this lane.
template <int NJ>
__device__ __forceinline__ float lane_sum(const float (&v)[NJ]) {
  const float s = (v[0] + v[1]) + (v[2] + v[3]);
  if constexpr (NJ == 5) return s + v[4];
  return s;
}

// acc[i][j] = v[j] for every row.
template <int NJ>
__device__ __forceinline__ void fill(float (&acc)[4][NJ], const float (&v)[NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = v[j];
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// One step of 4 inputs: acc[i][j] += sum_q A[(rg + 4i) SA + k + q] W[(k + q) CP + chan(j)].
template <int CP, int SA>
__device__ __forceinline__ void step(float (&acc)[4][Dims<CP>::kJ], const float* A, const float* W,
                                     int k, int rg, int cg) {
  float4 a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (rg + 4 * i) * SA + k);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 w = *reinterpret_cast<const float4*>(W + (k + q) * CP + 4 * cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = comp(a[i], q);
      acc[i][0] = fmaf(av, w.x, acc[i][0]);
      acc[i][1] = fmaf(av, w.y, acc[i][1]);
      acc[i][2] = fmaf(av, w.z, acc[i][2]);
      acc[i][3] = fmaf(av, w.w, acc[i][3]);
    }
    if constexpr (Dims<CP>::kJ == 5) {
      const float wt = cg < Dims<CP>::kTail ? W[(k + q) * CP + 32 + cg] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][4] = fmaf(comp(a[i], q), wt, acc[i][4]);
    }
  }
}

// acc += A[:, 0:KIN] W, W [KIN][CP].
template <int CP, int SA, int KIN>
__device__ __forceinline__ void product(float (&acc)[4][Dims<CP>::kJ], const float* A, const float* W,
                                        int rg, int cg) {
  static_assert(KIN % 4 == 0, "inputs in steps of 4");
#pragma unroll
  for (int k = 0; k < KIN; k += 4) step<CP, SA>(acc, A, W, k, rg, cg);
}

// acc += A W for a block-diagonal W [CP][CP] in heads of width wh. At CP = 32
// this lane's 4 channels read only the inputs of their heads, [k0, k0 +
// max(wh, 4)) (with wh < 4 the zero entries of the lane's other heads are
// read too). Above CP = 32 the product is dense: the heads of a width in
// (32, CP] need not align with a lane's channels, and the zero blocks add
// exact zeros.
template <int CP, int SA>
__device__ __forceinline__ void head_product(float (&acc)[4][Dims<CP>::kJ], const float* A,
                                             const float* W, int wh, int rg, int cg) {
  if constexpr (CP == 32) {
    const int kw = wh > 4 ? wh : 4;
    const int k0 = (4 * cg / kw) * kw;
    for (int k = k0; k < k0 + kw; k += 4) step<CP, SA>(acc, A, W, k, rg, cg);
  } else {
    product<CP, SA, CP>(acc, A, W, rg, cg);
  }
}

// acc[i][j] += sum_k A[(rg + 4i) SA + k] W[k 16 + 2cg + j] over CP inputs: an
// output of 16 channels (W [CP][16]), 2 a lane.
template <int CP, int SA>
__device__ __forceinline__ void product16(float (&acc)[4][2], const float* A, const float* W,
                                          int rg, int cg) {
#pragma unroll
  for (int k = 0; k < CP; k += 4) {
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

// o[j] += Σ_q v[q] W[q CP + chan(j)] over q < NIN: one vector (shared memory)
// times NIN rows of a weight, this lane's channels.
template <int CP, int NIN>
__device__ __forceinline__ void vec_product(float (&o)[Dims<CP>::kJ], const float* v, const float* W,
                                            int cg) {
#pragma unroll
  for (int k = 0; k < NIN; k += 4) {
    float vv[4];
    if constexpr (NIN % 4 == 0) {
      const float4 t = *reinterpret_cast<const float4*>(v + k);
      vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) vv[q] = k + q < NIN ? v[k + q] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k + q < NIN) {
        float wv[Dims<CP>::kJ];
        vec<CP>(W, (k + q) * CP, cg, wv);
#pragma unroll
        for (int j = 0; j < Dims<CP>::kJ; ++j) o[j] = fmaf(vv[q], wv[j], o[j]);
      }
    }
  }
}

// Registers -> rows of an [edge][channel] tile of stride kXS.
template <int CP>
__device__ __forceinline__ void store_rows(const float (&acc)[4][Dims<CP>::kJ], float* X, int rg,
                                           int cg) {
  constexpr int S = Dims<CP>::kXS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(X + (rg + 4 * i) * S + 4 * cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if constexpr (Dims<CP>::kJ == 5)
      if (cg < Dims<CP>::kTail) X[(rg + 4 * i) * S + 32 + cg] = acc[i][4];
  }
}

// This lane's channels of a [CP] vector in shared memory.
template <int CP>
__device__ __forceinline__ void store_vec(float* v, const float (&a)[Dims<CP>::kJ], int cg) {
  *reinterpret_cast<float4*>(v + 4 * cg) = make_float4(a[0], a[1], a[2], a[3]);
  if constexpr (Dims<CP>::kJ == 5)
    if (cg < Dims<CP>::kTail) v[32 + cg] = a[4];
}

// Channels 4cg .. 4cg + 3 (and 32 + cg) of row `row` of a [rows][c] tensor
// at its true stride c, the pads 0. At CP = 32 (c = 32) one float4.
template <int CP>
__device__ __forceinline__ void load_row(const float* __restrict__ t, int row, int c, int cg,
                                         float (&v)[Dims<CP>::kJ]) {
  if constexpr (CP == 32) {
    const float4 a = *reinterpret_cast<const float4*>(t + (size_t)row * 32 + 4 * cg);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const float* r = t + (size_t)row * c;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = r[4 * cg + j];      // channels < 32 < c
    v[4] = cg < Dims<CP>::kTail && 32 + cg < c ? r[32 + cg] : 0.f;
  }
}

// The real channels of v into row `row` of a [rows][c] tensor.
template <int CP>
__device__ __forceinline__ void store_row(float* __restrict__ t, int row, int c, int cg,
                                          const float (&v)[Dims<CP>::kJ]) {
  if constexpr (CP == 32) {
    *reinterpret_cast<float4*>(t + (size_t)row * 32 + 4 * cg) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    float* r = t + (size_t)row * c;
#pragma unroll
    for (int j = 0; j < 4; ++j) r[4 * cg + j] = v[j];
    if (cg < Dims<CP>::kTail && 32 + cg < c) r[32 + cg] = v[4];
  }
}

// The h_row block of the first edge layer, the same for every edge of the
// center: b1 + h_i W1hr, this lane's channels (each row group sums CP / 4 of
// the CP inputs, then the groups add up).
template <int CP>
__device__ __forceinline__ void hrow_block(const float* __restrict__ h, int center, int c,
                                           const float* w, int rg, int cg,
                                           float (&hr)[Dims<CP>::kJ]) {
  constexpr int NJ = Dims<CP>::kJ, NQ = CP / 4;
  float hv[NQ];
  if constexpr (CP == 32) {
    const float4* hp = reinterpret_cast<const float4*>(h + (size_t)center * 32 + 8 * rg);
    const float4 h0 = hp[0], h1 = hp[1];
#pragma unroll
    for (int q = 0; q < 8; ++q) hv[q] = q < 4 ? comp(h0, q) : comp(h1, q - 4);
  } else {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int in = NQ * rg + q;
      hv[q] = in < c ? h[(size_t)center * c + in] : 0.f;
    }
  }
  float p[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) p[j] = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float wv[NJ];
    vec<CP>(w, Layout<CP>::w1hr + (NQ * rg + q) * CP, cg, wv);
#pragma unroll
    for (int j = 0; j < NJ; ++j) p[j] = fmaf(hv[q], wv[j], p[j]);
  }
  float b[NJ];
  vec<CP>(w, Layout<CP>::b1, cg, b);
#pragma unroll
  for (int j = 0; j < NJ; ++j) hr[j] = b[j] + group_sum(p[j]);
}

// First edge layer on the staged tile before its SiLU: u = hr + [h_col | geo] W1.
template <int CP>
__device__ __forceinline__ void first_layer_pre(const float* tile, const float (&hr)[Dims<CP>::kJ],
                                                const float* w, int rg, int cg,
                                                float (&u)[4][Dims<CP>::kJ]) {
  fill(u, hr);
  product<CP, Dims<CP>::kTS, CP + 12>(u, tile, w + Layout<CP>::w1, rg, cg);
}

// Head layer on the s1 tile: v = b2 + s1 W2 (block-diagonal).
template <int CP>
__device__ __forceinline__ void head_layer(const float* S1, const float* w, int wh, int rg,
                                           int cg, float (&v)[4][Dims<CP>::kJ]) {
  float b[Dims<CP>::kJ];
  vec<CP>(w, Layout<CP>::b2, cg, b);
  fill(v, b);
  head_product<CP, Dims<CP>::kXS>(v, S1, w + Layout<CP>::w2, wh, rg, cg);
}

// LayerNorm's normalisation over each row's c channels, in place: v becomes
// vhat = (v - mean) * r with r = rsqrt(var + 1e-5) (biased variance). The
// pad channels are 0 on entry and stay 0 (their (0 - mean)² is masked out of
// the variance); `tail` says whether this lane's channel 32 + cg is real.
template <int CP>
__device__ __forceinline__ void normalize(float (&v)[4][Dims<CP>::kJ], float (&r)[4], int c,
                                          bool tail) {
  const float inv_c = 1.0f / c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mu = row_sum(lane_sum(v[i])) * inv_c;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < Dims<CP>::kJ; ++j) {
      v[i][j] = j < 4 || tail ? v[i][j] - mu : 0.f;
      s = fmaf(v[i][j], v[i][j], s);
    }
    r[i] = rsqrtf(row_sum(s) * inv_c + 1e-5f);
#pragma unroll
    for (int j = 0; j < Dims<CP>::kJ; ++j) v[i][j] *= r[i];
  }
}

// LayerNorm's affine part: m = vhat * ln_scale + ln_bias.
template <int CP>
__device__ __forceinline__ void ln_affine(const float (&vhat)[4][Dims<CP>::kJ], const float* w,
                                          int cg, float (&m)[4][Dims<CP>::kJ]) {
  float sc[Dims<CP>::kJ], bi[Dims<CP>::kJ];
  vec<CP>(w, Layout<CP>::lns, cg, sc);
  vec<CP>(w, Layout<CP>::lnb, cg, bi);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Dims<CP>::kJ; ++j) m[i][j] = fmaf(vhat[i][j], sc[j], bi[j]);
}

// The coordinate MLP's hidden layer before its SiLU, on the m tile: cm = bc0 + m Wc0.
template <int CP>
__device__ __forceinline__ void coord_pre(const float* M, const float* w, int rg, int cg,
                                          float (&cm)[4][Dims<CP>::kJ]) {
  float b[Dims<CP>::kJ];
  vec<CP>(w, Layout<CP>::bc0, cg, b);
  fill(cm, b);
  product<CP, Dims<CP>::kXS, CP>(cm, M, w + Layout<CP>::wc0, rg, cg);
}

// The coordinate scalar of each of this lane's rows: s = wc1 . silu(cm), the
// same value in the 8 lanes of the row group.
template <int CP>
__device__ __forceinline__ void coord_sum(const float (&cm)[4][Dims<CP>::kJ], const float* w, int cg,
                                          float (&s)[4]) {
  float wc[Dims<CP>::kJ];
  vec<CP>(w, Layout<CP>::wc1, cg, wc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float p = wc[0] * silu(cm[i][0]);
#pragma unroll
    for (int j = 1; j < Dims<CP>::kJ; ++j) p = fmaf(wc[j], silu(cm[i][j]), p);
    s[i] = row_sum(p);
  }
}

// v[i] for i = sel, 0 <= sel < 4.
__device__ __forceinline__ float pick(const float (&v)[4], int sel) {
  return sel == 0 ? v[0] : sel == 1 ? v[1] : sel == 2 ? v[2] : v[3];
}

}  // namespace egcl_f32
