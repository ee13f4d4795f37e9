// Backward of the fused EGCL layer's edge program ('center' direction, 'frame'
// so3 mode), accurate mode (fp32), for Hopper (sm_90a), on fp32
// register-blocked edge tiles, built at two channel widths
// (egcl_tile_f32.cuh): CP = 32 for C = 32 and CP = 36 for 32 < C <= 36
// (KITTI's C = 33, pads zero).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_backward.py::_egcl_bwd_kernel (wrapper egcl_backward_pallas, custom VJP
// egcl_fused_diff) in accurate mode at those widths with whole heads: h
// [B, N, C], x [B, N, 3], nbr [B, N, K] int32 and the cotangents dagg_m
// [B, N, C], dagg_x [B, N, 3] -> dh, dx and the gradients of the 11 edge and
// coord parameters. It computes what egcl_backward.cu computes in ACCURATE
// mode, in another order of the fp32 sums; egcl_backward.cu stays for fast
// mode at C != 32 and for the other widths.
//
// What bounds it: the useful work is ~17.8 kFLOP an edge at C = 32, 4 heads
// (~23.7 at C = 33, one head) against ~4·(C+4) gathered bytes, so fp32
// operations: 0.558 ms at B=64, C=32 on the fp32 pipes. egcl_backward.cu
// read a weight or an accumulator word from shared memory for every FMA, and
// each warp kept its own copy of the matrix gradients (15 KB at C = 32),
// which capped the warps in flight at 8 a block; at C = 33 its lane l holds
// channels l and l + 32, one live lane of 32 in the second pass. Here one
// warp owns a center and its 16 edges are the rows of fp32 tiles
// (egcl_tile_f32.cuh), in the structure of the fast-mode
// egcl_backward_tile.cu:
//   - the forward is recomputed from the header, keeping u (the first layer
//     before its SiLU), vhat and each row's rstd in registers; s1 and m go
//     to per-warp [edge][channel] tiles;
//   - the backward's products are register-blocked like the forward's: dm =
//     dagg_m + dcm Wc0, ds1 = dv W2 (at CP = 32 the heads' inputs only),
//     dgeo = du W1g, dh_col = du W1hc, dh_row = (Σ du) W1hr once a center;
//     the transposed weights are packed on the host
//     (ops/kernels/egcl.py::pack_params_f32); each cotangent (dcm, dv, du)
//     goes through one per-warp tile in turn;
//   - the LayerNorm backward reduces across the 8 lanes of a row, the pad
//     channels masked out (their dv would be -r mean(g));
//   - dh_col goes onto the neighbor by atomicAdd; the geometry backward is
//     scalar, one lane an edge, from a per-warp dgeo scratch; dx of the
//     center sums by shuffles, of the neighbor by atomicAdd;
//   - the parameter gradients are tile products over the 16 edges,
//     gW[in][out] = Σ_e A[e][in] D[e][out], CP/4 inputs x CP/8 outputs a
//     lane (W2's only on its head blocks when CP = 32 and heads are at most
//     8 wide), added into one block-wide fp32 copy by shared atomics and
//     flushed once a block by global atomics into the gradients at the true
//     width C (pad entries are never flushed); the vector gradients are
//     summed over each tile's rows across lanes and added into the same
//     copy. No per-warp copy: 16 warps fit a block at CP = 32, 14 at 36.
// K other than 16 runs as row tiles of 16; a row at or beyond K is staged
// from the center with dscale = 0 and dagg_m = 0, so each of its cotangents is
// exactly 0 and it adds nothing; its scatter and geometry backward are skipped.

#include "egcl_tile_f32.cuh"

namespace {

using namespace egcl_f32;
using egcl_edge::geometry_bwd;

constexpr int kSmemWords = 232448 / 4;   // the shared memory a block can use

// The row stride of the block's [in][out] gradient copies: the least s > CP
// at which a product's atomics (CP/4 inputs a row group, 8 outputs a row)
// put the 4 row groups on 4 disjoint groups of 8 banks, (CP/4) s mod 32 = 8
// or 24: 33 at CP = 32, 40 at 36 (at 37 two groups share banks; egcl_f32_sweep.py
// timed 37 with 15 warps against 40 with 14).
constexpr int grad_stride(int cp, int s) {
  return (cp / 4 * s) % 32 == 8 || (cp / 4 * s) % 32 == 24 ? s : grad_stride(cp, s + 1);
}

template <int CP>
struct Bwd {
  static constexpr int kGS = grad_stride(CP, CP + 1);
  static constexpr int kDgS = 17;      // row stride of the per-warp dgeo scratch [edge][16]
  static_assert(kGS == (CP == 32 ? 33 : 40), "the strides of the header comment");
};

// The gradients' offsets in the output `grads`: egcl_backward.cu's Offsets
// at the true width c, the matrices [in][out] and the vectors in the order
// of EDGE_PARAMS.
struct GradOut {
  int w1hc, w1g, b1, w2, b2, wc0, bc0, total;
  __device__ explicit GradOut(int c)
      : w1hc(c * c), w1g(2 * c * c), b1(2 * c * c + 12 * c), w2(b1 + c), b2(w2 + c * c),
        wc0(b2 + 3 * c), bc0(wc0 + c * c), total(bc0 + 2 * c) {}
};

// The vector gradients in the block's copy.
enum { kVB1, kVB2, kVLns, kVLnb, kVBc0, kVWc1, kVecs };

// Word offsets in dynamic shared memory.
template <int CP>
struct Smem {
  static constexpr int kGS = Bwd<CP>::kGS, kXS = Dims<CP>::kXS;
  static constexpr int gw1 = Layout<CP>::node;          // [CP + 12][kGS]: h_col CP, geometry 12
  static constexpr int gwc0 = gw1 + (CP + 12) * kGS;    // [CP][kGS] each
  static constexpr int gw2 = gwc0 + CP * kGS;
  static constexpr int gw1hr = gw2 + CP * kGS;
  static constexpr int gvec = gw1hr + CP * kGS;         // [kVecs][CP]
  static constexpr int warps = (gvec + kVecs * CP + 3) / 4 * 4;
  // per warp: the staged tile [16][kTS]; the s1, m and cotangent tiles
  // [16][kXS] (m's space holds the dgeo scratch [16][kDgS] once read); h_i
  // and Σ du [CP] each
  static constexpr int s1 = kRows * Dims<CP>::kTS;
  static constexpr int m = s1 + kRows * kXS;
  static constexpr int d = m + kRows * kXS;
  static constexpr int vec = d + kRows * kXS;
  static constexpr int per_warp = vec + 2 * CP;
  // Warps (centers in flight) per block, one block an SM: as many as the
  // shared memory holds, at most 16. Latency bounds the kernel: at CP = 32,
  // 16 warps at 128 registers, with ~200 bytes of spills, beat 12 and 8
  // warps without (egcl_f32_sweep.py times them; PERF.md §6); at CP = 36,
  // 14 warps with up to 144 registers a thread.
  static constexpr int fit = (kSmemWords - warps) / per_warp;
  static constexpr int kWarps = fit < 16 ? fit : 16;
  static constexpr int total = warps + kWarps * per_warp;
  static_assert(per_warp % 4 == 0 && kRows * Bwd<CP>::kDgS <= kRows * kXS, "tile layout");
  static_assert(kWarps >= 8 && total <= kSmemWords, "the shared memory of a block");
};

// G[(a0 + NA rg + a) kGS + cg + 8j] += Σ_e A[e SA + a0 + NA rg + a] D[e kXS + cg + 8j]
// over the tile's 16 edges: this lane's NA inputs x CP/8 outputs of gW = Aᵀ D.
template <int CP, int SA, int NA>
__device__ __forceinline__ void grad_product(float* G, const float* A, int a0, const float* D,
                                             int rg, int cg) {
  constexpr int NJ = Dims<CP>::kJ, kGS = Bwd<CP>::kGS, kXS = Dims<CP>::kXS;
  const int in0 = a0 + NA * rg;
  float acc[NA][NJ];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < kRows; ++e) {
    float av[NA];
    if constexpr (NA % 4 == 0) {
#pragma unroll
      for (int q = 0; q < NA / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(A + e * SA + in0 + 4 * q);
        av[4 * q] = v.x; av[4 * q + 1] = v.y; av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
      }
    } else if constexpr (NA % 2 == 0) {
#pragma unroll
      for (int q = 0; q < NA / 2; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(A + e * SA + in0 + 2 * q);
        av[2 * q] = v.x; av[2 * q + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int a = 0; a < NA; ++a) av[a] = A[e * SA + in0 + a];
    }
    float dv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dv[j] = j < 4 || cg < Dims<CP>::kTail ? D[e * kXS + cg + 8 * j] : 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] = fmaf(av[a], dv[j], acc[a][j]);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < 4 || cg < Dims<CP>::kTail) atomicAdd(G + (in0 + a) * kGS + cg + 8 * j, acc[a][j]);
}

// W2's gradient on its head blocks at CP = 32 when heads are at most 8 wide
// (they then tile the 8-channel groups): lane o owns output o and inputs
// 8 floor(o / 8) .. + 7, G[o kG2 + a] += Σ_e S1[e][8 floor(o / 8) + a] DV[e][o]
// (with heads narrower than 8 the group's other entries are structural zeros
// and the flush drops them). A quarter of the dense product's work.
constexpr int kG2 = 9;    // row stride of that [out][8] copy: o kG2 + a hits 32 banks
__device__ __forceinline__ void grad_heads8(float* G, const float* S1, const float* DV,
                                            int lane) {
  constexpr int kXS = Dims<32>::kXS;
  const int in0 = lane & ~7;
  float acc[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) acc[a] = 0.f;
#pragma unroll 4
  for (int e = 0; e < kRows; ++e) {
    const float4 s0 = *reinterpret_cast<const float4*>(S1 + e * kXS + in0);
    const float4 s1 = *reinterpret_cast<const float4*>(S1 + e * kXS + in0 + 4);
    const float dv = DV[e * kXS + lane];
    acc[0] = fmaf(s0.x, dv, acc[0]); acc[1] = fmaf(s0.y, dv, acc[1]);
    acc[2] = fmaf(s0.z, dv, acc[2]); acc[3] = fmaf(s0.w, dv, acc[3]);
    acc[4] = fmaf(s1.x, dv, acc[4]); acc[5] = fmaf(s1.y, dv, acc[5]);
    acc[6] = fmaf(s1.z, dv, acc[6]); acc[7] = fmaf(s1.w, dv, acc[7]);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) atomicAdd(G + lane * kG2 + a, acc[a]);
}

// g[channel j] += this tile's v[j] summed over the 4 row groups.
template <int CP>
__device__ __forceinline__ void add_vec(float* g, const float (&v)[Dims<CP>::kJ], int rg, int cg) {
#pragma unroll
  for (int j = 0; j < Dims<CP>::kJ; ++j) {
    const float s = group_sum(v[j]);
    if (rg == 0 && (j < 4 || cg < Dims<CP>::kTail)) atomicAdd(g + (j < 4 ? 4 * cg + j : 32 + cg), s);
  }
}

template <int CP>
__global__ void __launch_bounds__(Smem<CP>::kWarps * 32, 1)
egcl_bwd_tile_f32_kernel(const float* __restrict__ h, const float* __restrict__ x,
                         const int* __restrict__ nbr, const float* __restrict__ params,
                         const float* __restrict__ dagg_m, const float* __restrict__ dagg_x,
                         float* __restrict__ dh_center, float* __restrict__ dx_center,
                         float* __restrict__ dh_nbr, float* __restrict__ dx_nbr,
                         float* __restrict__ grads, int total, int N, int K, int c_arg, int wh) {
  using D = Dims<CP>;
  using L = Layout<CP>;
  using S = Smem<CP>;
  constexpr int NJ = D::kJ, NQ = CP / 4, kGS = Bwd<CP>::kGS, kDgS = Bwd<CP>::kDgS;
  constexpr int kTS = D::kTS, kXS = D::kXS, kWarps = S::kWarps;
  const int c = CP == 32 ? 32 : c_arg;   // the true width
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  for (int i = threadIdx.x; i < L::node / 4; i += blockDim.x)
    reinterpret_cast<float4*>(w)[i] = reinterpret_cast<const float4*>(params)[i];
  for (int i = threadIdx.x; i < S::warps - S::gw1; i += blockDim.x) smem[S::gw1 + i] = 0.f;
  float* gW1 = smem + S::gw1;
  float* gWc0 = smem + S::gwc0;
  float* gW2 = smem + S::gw2;
  float* gW1hr = smem + S::gw1hr;
  float* gvec = smem + S::gvec;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const bool tail = cg < Dims<CP>::kTail && 32 + cg < c;   // this lane owns channel 32 + cg
                                                           // and it is real (CP > 32)
  float* T = smem + S::warps + warp * S::per_warp;
  float* S1 = T + S::s1;
  float* M = T + S::m;
  float* Dt = T + S::d;
  float* V = T + S::vec;
  float* dgs = M;   // the dgeo scratch, once the Wc0 gradient has read m
  if constexpr (CP != 32)               // the pad columns of h_col, never staged
    for (int i = lane; i < kRows * kTS; i += 32) T[i] = 0.f;
  __syncthreads();

  for (int center = blockIdx.x * kWarps + warp; center < total;
       center += gridDim.x * kWarps) {
    const int base = center - center % N;          // b·N
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];
    const float dax0 = dagg_x[(size_t)center * 3 + 0];
    const float dax1 = dagg_x[(size_t)center * 3 + 1];
    const float dax2 = dagg_x[(size_t)center * 3 + 2];
    float hr[NJ], dm0[NJ];
    hrow_block<CP>(h, center, c, w, rg, cg, hr);
    load_row<CP>(dagg_m, center, c, cg, dm0);
    if (rg == 0) {
      float hi[NJ];
      load_row<CP>(h, center, c, cg, hi);
      store_vec<CP>(V, hi, cg);
    }
    float dus[NJ];   // Σ du over this lane's rows, this lane's channels
#pragma unroll
    for (int j = 0; j < NJ; ++j) dus[j] = 0.f;
    float dxi[3] = {0.f, 0.f, 0.f};

    for (int row0 = 0; row0 < K; row0 += kRows) {
      float rel[3];
      const bool valid = stage_edges<CP>(h, x, nbr, center, base, K, row0, xi0, xi1, xi2, T,
                                         lane, rel, c);
      bool vr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vr[i] = row0 + rg + 4 * i < K;

      // ---- forward recompute, keeping u, vhat and r ----
      float u[4][NJ], vh[4][NJ], r[4], d[4][NJ];
      first_layer_pre<CP>(T, hr, w, rg, cg, u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) d[i][j] = silu(u[i][j]);
      store_rows<CP>(d, S1, rg, cg);
      __syncwarp();
      head_layer<CP>(S1, w, wh, rg, cg, vh);
      normalize<CP>(vh, r, c, tail);
      ln_affine<CP>(vh, w, cg, d);
      store_rows<CP>(d, M, rg, cg);
      __syncwarp();
      coord_pre<CP>(M, w, rg, cg, d);                  // cm
      {
        float s[4];
        coord_sum<CP>(d, w, cg, s);
        if (cg < 4) T[(rg + 4 * cg) * kTS + D::kScale] = pick(s, cg);
      }

      // ---- coord MLP backward: dscale per row, dcm = dsilu(cm) wc1 dscale ----
      {
        float ds[4], gb[NJ], gw[NJ], wcv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) gb[j] = gw[j] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* rr = T + (rg + 4 * i) * kTS + D::kRel;
          ds[i] = vr[i] ? dax0 * rr[0] + dax1 * rr[1] + dax2 * rr[2] : 0.f;
        }
        vec<CP>(w, L::wc1, cg, wcv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float cm = d[i][j];
            gw[j] = fmaf(ds[i], silu(cm), gw[j]);
            d[i][j] = dsilu(cm) * (wcv[j] * ds[i]);
            gb[j] += d[i][j];
          }
        add_vec<CP>(gvec + kVWc1 * CP, gw, rg, cg);
        add_vec<CP>(gvec + kVBc0 * CP, gb, rg, cg);
      }
      store_rows<CP>(d, Dt, rg, cg);
      __syncwarp();
      grad_product<CP, kXS, NQ>(gWc0, M, 0, Dt, rg, cg);   // gWc0 += mᵀ dcm

      // ---- dm = dagg_m + dcm Wc0 (0 on rows beyond K), LayerNorm backward ----
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) d[i][j] = vr[i] ? dm0[j] : 0.f;
      product<CP, kXS, CP>(d, Dt, w + L::wc0_t, rg, cg);
      {
        float gs[NJ], gbi[NJ], gb2[NJ], scv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) gs[j] = gbi[j] = gb2[j] = 0.f;
        vec<CP>(w, L::lns, cg, scv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sg = 0.f, sv = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            gs[j] = fmaf(d[i][j], vh[i][j], gs[j]);
            gbi[j] += d[i][j];
            d[i][j] *= scv[j];
            sg += d[i][j];
            sv = fmaf(d[i][j], vh[i][j], sv);
          }
          const float inv_c = 1.0f / c;
          const float mg = row_sum(sg) * inv_c, mv = row_sum(sv) * inv_c;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            d[i][j] = j < 4 || tail ? r[i] * (d[i][j] - mg - vh[i][j] * mv) : 0.f;
            gb2[j] += d[i][j];
          }
        }
        add_vec<CP>(gvec + kVLns * CP, gs, rg, cg);
        add_vec<CP>(gvec + kVLnb * CP, gbi, rg, cg);
        add_vec<CP>(gvec + kVB2 * CP, gb2, rg, cg);
      }
      __syncwarp();   // every lane has read dcm
      store_rows<CP>(d, Dt, rg, cg);
      __syncwarp();
      if (CP == 32 && wh <= 8)                        // gW2 += s1ᵀ dv on the head blocks
        grad_heads8(gW2, S1, Dt, lane);
      else                                            // dense; the flush keeps the heads
        grad_product<CP, kXS, NQ>(gW2, S1, 0, Dt, rg, cg);

      // ---- ds1 = dv W2 (the heads' inputs), du = dsilu(u) ds1 ----
      zero(d);
      head_product<CP, kXS>(d, Dt, w + L::w2_t, wh, rg, cg);
      {
        float gb1[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) gb1[j] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            d[i][j] *= dsilu(u[i][j]);
            gb1[j] += d[i][j];
          }
#pragma unroll
        for (int j = 0; j < NJ; ++j) dus[j] += gb1[j];
        add_vec<CP>(gvec + kVB1 * CP, gb1, rg, cg);
      }
      __syncwarp();   // every lane has read dv
      store_rows<CP>(d, Dt, rg, cg);
      __syncwarp();

      // ---- products of du: dgeo (to the scratch), dh_col (onto the neighbor) ----
      {
        float g2[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) g2[i][0] = g2[i][1] = 0.f;
        product16<CP, kXS>(g2, Dt, w + L::w1g_t, rg, cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dgs[(rg + 4 * i) * kDgS + 2 * cg] = g2[i][0];
          dgs[(rg + 4 * i) * kDgS + 2 * cg + 1] = g2[i][1];
        }
      }
      zero(d);
      product<CP, kXS, CP>(d, Dt, w + L::w1hc_t, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (vr[i]) {
          const int j_nb = __float_as_int(T[(rg + 4 * i) * kTS + D::kNbr]);
          float* dst = dh_nbr + (size_t)j_nb * c;
#pragma unroll
          for (int j = 0; j < 4; ++j) atomicAdd(dst + 4 * cg + j, d[i][j]);
          if constexpr (NJ == 5)
            if (tail) atomicAdd(dst + 32 + cg, d[i][4]);
        }
      }
      // gW1 += [h_col | geometry]ᵀ du
      grad_product<CP, kTS, NQ>(gW1, T, 0, Dt, rg, cg);
      grad_product<CP, kTS, 3>(gW1, T, D::kGeo, Dt, rg, cg);
      __syncwarp();   // dgeo is written

      // ---- geometry backward, one lane an edge ----
      if (lane < kRows && valid) {
        const float* row = T + lane * kTS;
        const int j_nb = __float_as_int(row[D::kNbr]);
        float dxn[3];
        geometry_bwd(xi0, xi1, xi2, x[(size_t)j_nb * 3 + 0], x[(size_t)j_nb * 3 + 1],
                     x[(size_t)j_nb * 3 + 2], dax0, dax1, dax2, row[D::kScale],
                     dgs + lane * kDgS, dxi, dxn);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 0, dxn[0]);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 1, dxn[1]);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 2, dxn[2]);
      }
    }

    // ---- per center: dh_row = (Σ du) W1hr, gW1hr += h_i ⊗ Σ du ----
#pragma unroll
    for (int j = 0; j < NJ; ++j) dus[j] = group_sum(dus[j]);
    if (rg == 1) store_vec<CP>(V + CP, dus, cg);
    __syncwarp();
    {
      float p[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) p[j] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float dv = V[CP + NQ * rg + q];
        float wv[NJ];
        vec<CP>(w, L::w1hr_t + (NQ * rg + q) * CP, cg, wv);
#pragma unroll
        for (int j = 0; j < NJ; ++j) p[j] = fmaf(dv, wv[j], p[j]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) p[j] = group_sum(p[j]);
      if (rg == 0) store_row<CP>(dh_center, center, c, cg, p);
    }
#pragma unroll
    for (int a = 0; a < NQ; ++a) {
      const float hv = V[NQ * rg + a];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < 4 || cg < Dims<CP>::kTail)
          atomicAdd(gW1hr + (NQ * rg + a) * kGS + cg + 8 * j, hv * V[CP + cg + 8 * j]);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      dxi[0] += __shfl_xor_sync(kFull, dxi[0], o);
      dxi[1] += __shfl_xor_sync(kFull, dxi[1], o);
      dxi[2] += __shfl_xor_sync(kFull, dxi[2], o);
    }
    if (lane == 0) {
      dx_center[(size_t)center * 3 + 0] = dxi[0];
      dx_center[(size_t)center * 3 + 1] = dxi[1];
      dx_center[(size_t)center * 3 + 2] = dxi[2];
    }
    __syncwarp();   // V is read before the next center writes it
  }

  // ---- flush: the block's copy into grads at the true width, one global
  // atomic an entry ----
  __syncthreads();
  const GradOut go(c);
  for (int i = threadIdx.x; i < go.total; i += blockDim.x) {
    const int out = i % c;
    float s;
    if (i < go.w1hc) {
      s = gW1hr[(i / c) * kGS + out];
    } else if (i < go.b1) {                       // W1hc, then W1g, as gW1 holds them
      const int in = (i - go.w1hc) / c;           // h_col rows 0 .. c-1, geometry from CP
      s = gW1[(in < c ? in : in - c + CP) * kGS + out];
    } else if (i < go.w2) {
      s = gvec[kVB1 * CP + out];
    } else if (i < go.b2) {
      const int in = (i - go.w2) / c;
      if (in / wh != out / wh) continue;          // a structural zero of the block-diagonal w2
      s = CP == 32 && wh <= 8 ? gW2[out * kG2 + in % 8] : gW2[in * kGS + out];
    } else if (i < go.wc0) {                      // b2, ln_scale, ln_bias
      s = gvec[(kVB2 + (i - go.b2) / c) * CP + out];
    } else if (i < go.bc0) {
      s = gWc0[((i - go.wc0) / c) * kGS + out];
    } else {                                      // bc0, wc1
      s = gvec[(kVBc0 + (i - go.bc0) / c) * CP + out];
    }
    atomicAdd(grads + i, s);
  }
}

template <int CP>
int launch(const void* h, const void* x, const void* nbr, const void* params,
           const void* dagg_m, const void* dagg_x, void* dh_center, void* dx_center,
           void* dh_nbr, void* dx_nbr, void* grads, int B, int N, int K, int C, int head_width,
           cudaStream_t s) {
  const auto kernel = egcl_bwd_tile_f32_kernel<CP>;
  const int smem = Smem<CP>::total * (int)sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int total = B * N;
  const int need = (total + Smem<CP>::kWarps - 1) / Smem<CP>::kWarps;
  const int grid = need < sms ? need : sms;   // resident blocks; each flushes once
  const int threads = Smem<CP>::kWarps * 32;
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(x), static_cast<const int*>(nbr),
      static_cast<const float*>(params), static_cast<const float*>(dagg_m),
      static_cast<const float*>(dagg_x), static_cast<float*>(dh_center),
      static_cast<float*>(dx_center), static_cast<float*>(dh_nbr), static_cast<float*>(dx_nbr),
      static_cast<float*>(grads), total, N, K, C, head_width);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B,N,C], x [B,N,3] f32 (the layer inputs), nbr [B,N,K] int32 in [0, N),
// params: the buffer of ops/kernels/egcl.py::pack_params_f32 at the width
// that runs C (32 for C = 32, 36 for 32 < C <= 36), dagg_m [B,N,C], dagg_x
// [B,N,3]. Outputs: dh_center [B,N,C] and dx_center [B,N,3] (written),
// dh_nbr, dx_nbr and grads (egcl_backward.cu's layout at C) accumulated with
// atomics: the caller zero-fills them.
extern "C" int egcl_backward_tile_f32_launch(const void* h, const void* x, const void* nbr,
                                             const void* params, const void* dagg_m,
                                             const void* dagg_x, void* dh_center,
                                             void* dx_center, void* dh_nbr, void* dx_nbr,
                                             void* grads, int B, int N, int K, int C,
                                             int head_width, void* stream) {
  if (K < 1 || head_width < 1 || C % head_width) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32)
    return launch<32>(h, x, nbr, params, dagg_m, dagg_x, dh_center, dx_center, dh_nbr, dx_nbr,
                      grads, B, N, K, C, head_width, s);
  if (32 < C && C <= kPadded)
    return launch<kPadded>(h, x, nbr, params, dagg_m, dagg_x, dh_center, dx_center, dh_nbr, dx_nbr,
                      grads, B, N, K, C, head_width, s);
  return (int)cudaErrorInvalidValue;
}
