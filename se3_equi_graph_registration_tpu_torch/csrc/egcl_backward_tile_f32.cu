// Backward of the fused EGCL layer's edge program ('center' direction, 'frame'
// so3 mode), accurate mode (fp32) at C = 32, for Hopper (sm_90a), on fp32
// register-blocked edge tiles.
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_backward.py::_egcl_bwd_kernel (wrapper egcl_backward_pallas, custom VJP
// egcl_fused_diff) in accurate mode for the default shape: h [B, N, 32], x
// [B, N, 3], nbr [B, N, K] int32 and the cotangents dagg_m [B, N, 32], dagg_x
// [B, N, 3] -> dh, dx and the gradients of the 11 edge and coord parameters.
// It computes what egcl_backward.cu computes in ACCURATE mode, in another
// order of the fp32 sums; egcl_backward.cu stays for other widths.
//
// What bounds it: the useful work is ~17.8 kFLOP an edge against ~4·(C+4)
// gathered bytes, so fp32 operations: 0.558 ms at B=64 on the fp32 pipes.
// egcl_backward.cu read a weight or an accumulator word from shared memory
// for every FMA, and each warp kept its own copy of the matrix gradients
// (15 KB), which capped the warps in flight at 8 a block. Here one warp owns
// a center and its 16 edges are the rows of fp32 tiles (egcl_tile_f32.cuh),
// in the structure of the fast-mode egcl_backward_tile.cu:
//   - the forward is recomputed from the header, keeping u (the first layer
//     before its SiLU), vhat and each row's rstd in registers; s1 and m go
//     to per-warp [edge][channel] tiles;
//   - the backward's products are register-blocked like the forward's, 8
//     FFMA a shared load: dm = dagg_m + dcm Wc0, ds1 = dv W2 (the heads'
//     inputs only), dgeo = du W1g, dh_col = du W1hc, dh_row = (Σ du) W1hr once
//     a center; the transposed weights are packed on the host
//     (ops/kernels/egcl.py::pack_params_f32); each cotangent (dcm, dv, du) goes
//     through one per-warp tile in turn;
//   - the LayerNorm backward reduces across the 8 lanes of a row;
//   - dh_col goes onto the neighbor by atomicAdd; the geometry backward is
//     scalar, one lane an edge, from a per-warp dgeo scratch; dx of the
//     center sums by shuffles, of the neighbor by atomicAdd;
//   - the parameter gradients are tile products over the 16 edges,
//     gW[in][out] = Σ_e A[e][in] D[e][out], 8 inputs x 4 outputs a lane (5.3
//     FFMA a shared load; W2's only on its head blocks when heads are at most
//     8 wide), added into one block-wide fp32 copy by shared
//     atomics and flushed once a block by global atomics; the vector
//     gradients are summed over each tile's rows across lanes and added
//     into the same copy. No per-warp copy: 16 warps fit a block.
// K other than 16 runs as row tiles of 16; a row at or beyond K is staged
// from the center with dscale = 0 and dagg_m = 0, so each of its cotangents is
// exactly 0 and it adds nothing; its scatter and geometry backward are skipped.

#include "egcl_tile_f32.cuh"

namespace {

using namespace egcl_f32;
using egcl_edge::geometry_bwd;

// Warps (centers in flight) per block; one block an SM (the shared memory,
// 219 KB). Latency bounds the kernel: 16 warps at 128 registers, with ~200
// bytes of spills, beat 12 and 8 warps without (egcl_f32_sweep.py times
// them; PERF.md §6).
constexpr int kWarps = 16;
constexpr int kGS = 33;   // row stride of the block's [in][out] gradient copies: odd, so
                          // a product's atomics (8 inputs a row group) hit 32 banks
constexpr int kDgS = 17;  // row stride of the per-warp dgeo scratch [edge][16]

// Offsets in the output `grads` (egcl_backward.cu's Offsets at C = 32): the
// matrices [in][out] and the vectors in the order of EDGE_PARAMS.
struct GradOut {
  static constexpr int w1hr = 0, w1hc = 1024, w1g = 2048, b1 = 2432, w2 = 2464, b2 = 3488,
                       lns = 3520, lnb = 3552, wc0 = 3584, bc0 = 4608, wc1 = 4640,
                       total = 4672;
};

// The vector gradients in the block's copy.
enum { kVB1, kVB2, kVLns, kVLnb, kVBc0, kVWc1, kVecs };

// Word offsets in dynamic shared memory.
struct Smem {
  static constexpr int gw1 = Layout::node;              // [44][kGS]: h_col 32, geometry 12
  static constexpr int gwc0 = gw1 + 44 * kGS;           // [32][kGS] each
  static constexpr int gw2 = gwc0 + kC * kGS;
  static constexpr int gw1hr = gw2 + kC * kGS;
  static constexpr int gvec = gw1hr + kC * kGS;         // [kVecs][32]
  static constexpr int warps = (gvec + kVecs * kC + 3) / 4 * 4;
  // per warp: the staged tile [16][kTS]; the s1, m and cotangent tiles
  // [16][kXS] (m's space holds the dgeo scratch [16][kDgS] once read); h_i
  // and Σ du [32] each
  static constexpr int s1 = kRows * kTS;
  static constexpr int m = s1 + kRows * kXS;
  static constexpr int d = m + kRows * kXS;
  static constexpr int vec = d + kRows * kXS;
  static constexpr int per_warp = vec + 2 * kC;
  static constexpr int total = warps + kWarps * per_warp;
};
static_assert(Smem::per_warp % 4 == 0 && kRows * kDgS <= kRows * kXS, "tile layout");

// G[(a0 + NA rg + a) kGS + cg + 8j] += Σ_e A[e SA + a0 + NA rg + a] D[e kXS + cg + 8j]
// over the tile's 16 edges: this lane's NA inputs x 4 outputs of gW = Aᵀ D.
template <int SA, int NA>
__device__ __forceinline__ void grad_product(float* G, const float* A, int a0, const float* D,
                                             int rg, int cg) {
  const int in0 = a0 + NA * rg;
  float acc[NA][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < kRows; ++e) {
    float av[NA];
    if constexpr (NA % 4 == 0) {
#pragma unroll
      for (int q = 0; q < NA / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(A + e * SA + in0 + 4 * q);
        av[4 * q] = v.x; av[4 * q + 1] = v.y; av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int a = 0; a < NA; ++a) av[a] = A[e * SA + in0 + a];
    }
    float dv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dv[j] = D[e * kXS + cg + 8 * j];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(av[a], dv[j], acc[a][j]);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(G + (in0 + a) * kGS + cg + 8 * j, acc[a][j]);
}

// W2's gradient on its head blocks when heads are at most 8 wide (they then
// tile the 8-channel groups): lane o owns output o and inputs
// 8 floor(o / 8) .. + 7, G[o kG2 + a] += Σ_e S1[e][8 floor(o / 8) + a] DV[e][o]
// (with heads narrower than 8 the group's other entries are structural zeros
// and the flush drops them). A quarter of the dense product's work.
constexpr int kG2 = 9;    // row stride of that [out][8] copy: o kG2 + a hits 32 banks
__device__ __forceinline__ void grad_heads8(float* G, const float* S1, const float* DV,
                                            int lane) {
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

// g[4cg + j] += this tile's v[j] summed over the 4 row groups.
__device__ __forceinline__ void add_vec(float* g, const float (&v)[4], int rg, int cg) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float s = group_sum(v[j]);
    if (rg == 0) atomicAdd(g + 4 * cg + j, s);
  }
}

__global__ void __launch_bounds__(kWarps * 32, 1)
egcl_bwd_tile_f32_kernel(const float* __restrict__ h, const float* __restrict__ x,
                         const int* __restrict__ nbr, const float* __restrict__ params,
                         const float* __restrict__ dagg_m, const float* __restrict__ dagg_x,
                         float* __restrict__ dh_center, float* __restrict__ dx_center,
                         float* __restrict__ dh_nbr, float* __restrict__ dx_nbr,
                         float* __restrict__ grads, int total, int N, int K, int wh) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  for (int i = threadIdx.x; i < Layout::node / 4; i += blockDim.x)
    reinterpret_cast<float4*>(w)[i] = reinterpret_cast<const float4*>(params)[i];
  for (int i = threadIdx.x; i < Smem::warps - Smem::gw1; i += blockDim.x) smem[Smem::gw1 + i] = 0.f;
  __syncthreads();
  float* gW1 = smem + Smem::gw1;
  float* gWc0 = smem + Smem::gwc0;
  float* gW2 = smem + Smem::gw2;
  float* gW1hr = smem + Smem::gw1hr;
  float* gvec = smem + Smem::gvec;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  float* T = smem + Smem::warps + warp * Smem::per_warp;
  float* S1 = T + Smem::s1;
  float* M = T + Smem::m;
  float* D = T + Smem::d;
  float* V = T + Smem::vec;
  float* dgs = M;   // the dgeo scratch, once the Wc0 gradient has read m

  for (int center = blockIdx.x * kWarps + warp; center < total;
       center += gridDim.x * kWarps) {
    const int base = center - center % N;          // b·N
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];
    const float dax0 = dagg_x[(size_t)center * 3 + 0];
    const float dax1 = dagg_x[(size_t)center * 3 + 1];
    const float dax2 = dagg_x[(size_t)center * 3 + 2];
    const float4 hr = hrow_block(h, center, w, rg, cg);
    const float4 dm0 = *reinterpret_cast<const float4*>(dagg_m + (size_t)center * kC + 4 * cg);
    if (rg == 0)
      *reinterpret_cast<float4*>(V + 4 * cg) =
          *reinterpret_cast<const float4*>(h + (size_t)center * kC + 4 * cg);
    float dus[4] = {0.f, 0.f, 0.f, 0.f};   // Σ du over this lane's rows, channels 4cg + j
    float dxi[3] = {0.f, 0.f, 0.f};

    for (int row0 = 0; row0 < K; row0 += kRows) {
      float rel[3];
      const bool valid = stage_edges(h, x, nbr, center, base, K, row0, xi0, xi1, xi2, T, lane,
                                     rel);
      bool vr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vr[i] = row0 + rg + 4 * i < K;

      // ---- forward recompute, keeping u, vhat and r ----
      float u[4][4], vh[4][4], r[4], d[4][4];
      first_layer_pre(T, hr, w, rg, cg, u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = silu(u[i][j]);
      store_rows(d, S1, rg, cg);
      __syncwarp();
      head_layer(S1, w, wh, rg, cg, vh);
      normalize(vh, r);
      ln_affine(vh, w, cg, d);
      store_rows(d, M, rg, cg);
      __syncwarp();
      coord_pre(M, w, rg, cg, d);                  // cm
      {
        float s[4];
        coord_sum(d, w, cg, s);
        if (cg < 4) T[(rg + 4 * cg) * kTS + kScale] = pick(s, cg);
      }

      // ---- coord MLP backward: dscale per row, dcm = dsilu(cm) wc1 dscale ----
      {
        float ds[4], gb[4] = {0.f, 0.f, 0.f, 0.f}, gw[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* rr = T + (rg + 4 * i) * kTS + kRel;
          ds[i] = vr[i] ? dax0 * rr[0] + dax1 * rr[1] + dax2 * rr[2] : 0.f;
        }
        const float4 wc = vec4(w, Layout::wc1, cg);
        const float wcv[4] = {wc.x, wc.y, wc.z, wc.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float c = d[i][j];
            gw[j] = fmaf(ds[i], silu(c), gw[j]);
            d[i][j] = dsilu(c) * (wcv[j] * ds[i]);
            gb[j] += d[i][j];
          }
        add_vec(gvec + kVWc1 * kC, gw, rg, cg);
        add_vec(gvec + kVBc0 * kC, gb, rg, cg);
      }
      store_rows(d, D, rg, cg);
      __syncwarp();
      grad_product<kXS, 8>(gWc0, M, 0, D, rg, cg);   // gWc0 += mᵀ dcm

      // ---- dm = dagg_m + dcm Wc0 (0 on rows beyond K), LayerNorm backward ----
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i][0] = vr[i] ? dm0.x : 0.f;
        d[i][1] = vr[i] ? dm0.y : 0.f;
        d[i][2] = vr[i] ? dm0.z : 0.f;
        d[i][3] = vr[i] ? dm0.w : 0.f;
      }
      product<kXS, kC>(d, D, w + Layout::wc0_t, rg, cg);
      {
        float gs[4] = {0.f, 0.f, 0.f, 0.f}, gbi[4] = {0.f, 0.f, 0.f, 0.f};
        float gb2[4] = {0.f, 0.f, 0.f, 0.f};
        const float4 sc = vec4(w, Layout::lns, cg);
        const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sg = 0.f, sv = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            gs[j] = fmaf(d[i][j], vh[i][j], gs[j]);
            gbi[j] += d[i][j];
            d[i][j] *= scv[j];
            sg += d[i][j];
            sv = fmaf(d[i][j], vh[i][j], sv);
          }
          const float mg = row_sum(sg) * (1.0f / kC), mv = row_sum(sv) * (1.0f / kC);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            d[i][j] = r[i] * (d[i][j] - mg - vh[i][j] * mv);
            gb2[j] += d[i][j];
          }
        }
        add_vec(gvec + kVLns * kC, gs, rg, cg);
        add_vec(gvec + kVLnb * kC, gbi, rg, cg);
        add_vec(gvec + kVB2 * kC, gb2, rg, cg);
      }
      __syncwarp();   // every lane has read dcm
      store_rows(d, D, rg, cg);
      __syncwarp();
      if (wh <= 8)                                    // gW2 += s1ᵀ dv on the head blocks
        grad_heads8(gW2, S1, D, lane);
      else                                            // dense; the flush keeps the heads
        grad_product<kXS, 8>(gW2, S1, 0, D, rg, cg);

      // ---- ds1 = dv W2 (the heads' inputs), du = dsilu(u) ds1 ----
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
      head_product<kXS>(d, D, w + Layout::w2_t, wh, rg, cg);
      {
        float gb1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            d[i][j] *= dsilu(u[i][j]);
            gb1[j] += d[i][j];
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) dus[j] += gb1[j];
        add_vec(gvec + kVB1 * kC, gb1, rg, cg);
      }
      __syncwarp();   // every lane has read dv
      store_rows(d, D, rg, cg);
      __syncwarp();

      // ---- products of du: dgeo (to the scratch), dh_col (onto the neighbor) ----
      {
        float g2[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) g2[i][0] = g2[i][1] = 0.f;
        product16<kXS>(g2, D, w + Layout::w1g_t, rg, cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dgs[(rg + 4 * i) * kDgS + 2 * cg] = g2[i][0];
          dgs[(rg + 4 * i) * kDgS + 2 * cg + 1] = g2[i][1];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
      product<kXS, kC>(d, D, w + Layout::w1hc_t, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (vr[i]) {
          const int j_nb = __float_as_int(T[(rg + 4 * i) * kTS + kNbr]);
          float* dst = dh_nbr + (size_t)j_nb * kC + 4 * cg;
#pragma unroll
          for (int j = 0; j < 4; ++j) atomicAdd(dst + j, d[i][j]);
        }
      }
      // gW1 += [h_col | geometry]ᵀ du
      grad_product<kTS, 8>(gW1, T, 0, D, rg, cg);
      grad_product<kTS, 3>(gW1, T, kGeo, D, rg, cg);
      __syncwarp();   // dgeo is written

      // ---- geometry backward, one lane an edge ----
      if (lane < kRows && valid) {
        const float* row = T + lane * kTS;
        const int j_nb = __float_as_int(row[kNbr]);
        float dxn[3];
        geometry_bwd(xi0, xi1, xi2, x[(size_t)j_nb * 3 + 0], x[(size_t)j_nb * 3 + 1],
                     x[(size_t)j_nb * 3 + 2], dax0, dax1, dax2, row[kScale], dgs + lane * kDgS,
                     dxi, dxn);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 0, dxn[0]);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 1, dxn[1]);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 2, dxn[2]);
      }
    }

    // ---- per center: dh_row = (Σ du) W1hr, gW1hr += h_i ⊗ Σ du ----
#pragma unroll
    for (int j = 0; j < 4; ++j) dus[j] = group_sum(dus[j]);
    if (rg == 1) *reinterpret_cast<float4*>(V + kC + 4 * cg) = make_float4(dus[0], dus[1], dus[2], dus[3]);
    __syncwarp();
    {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float dv = V[kC + 8 * rg + q];
        const float4 wv = vec4(w, Layout::w1hr_t + (8 * rg + q) * kC, cg);
        p[0] = fmaf(dv, wv.x, p[0]);
        p[1] = fmaf(dv, wv.y, p[1]);
        p[2] = fmaf(dv, wv.z, p[2]);
        p[3] = fmaf(dv, wv.w, p[3]);
      }
      const float4 out = make_float4(group_sum(p[0]), group_sum(p[1]), group_sum(p[2]),
                                     group_sum(p[3]));
      if (rg == 0) *reinterpret_cast<float4*>(dh_center + (size_t)center * kC + 4 * cg) = out;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float hv = V[8 * rg + a];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        atomicAdd(gW1hr + (8 * rg + a) * kGS + cg + 8 * j, hv * V[kC + cg + 8 * j]);
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

  // ---- flush: the block's copy into grads, one global atomic an entry ----
  __syncthreads();
  for (int i = threadIdx.x; i < GradOut::total; i += blockDim.x) {
    const int out = i % kC;
    float s;
    if (i < GradOut::w1hc) {
      s = gW1hr[(i / kC) * kGS + out];
    } else if (i < GradOut::b1) {                 // W1hc, then W1g, as gW1 holds them
      s = gW1[((i - GradOut::w1hc) / kC) * kGS + out];
    } else if (i < GradOut::w2) {
      s = gvec[kVB1 * kC + out];
    } else if (i < GradOut::b2) {
      const int in = (i - GradOut::w2) / kC;
      if (in / wh != out / wh) continue;          // a structural zero of the block-diagonal w2
      s = wh <= 8 ? gW2[out * kG2 + in % 8] : gW2[in * kGS + out];
    } else if (i < GradOut::wc0) {                // b2, ln_scale, ln_bias
      s = gvec[(kVB2 + (i - GradOut::b2) / kC) * kC + out];
    } else if (i < GradOut::bc0) {
      s = gWc0[((i - GradOut::wc0) / kC) * kGS + out];
    } else {                                      // bc0, wc1
      s = gvec[(kVBc0 + (i - GradOut::bc0) / kC) * kC + out];
    }
    atomicAdd(grads + i, s);
  }
}

}  // namespace

// h [B,N,32], x [B,N,3] f32 (the layer inputs), nbr [B,N,K] int32 in [0, N),
// params: the buffer of ops/kernels/egcl.py::pack_params_f32, dagg_m
// [B,N,32], dagg_x [B,N,3]. Outputs: dh_center [B,N,32] and dx_center [B,N,3]
// (written), dh_nbr, dx_nbr and grads (egcl_backward.cu's layout)
// accumulated with atomics: the caller zero-fills them.
extern "C" int egcl_backward_tile_f32_launch(const void* h, const void* x, const void* nbr,
                                             const void* params, const void* dagg_m,
                                             const void* dagg_x, void* dh_center,
                                             void* dx_center, void* dh_nbr, void* dx_nbr,
                                             void* grads, int B, int N, int K, int head_width,
                                             void* stream) {
  if (K < 1 || head_width < 1 || kC % head_width) return (int)cudaErrorInvalidValue;
  const int smem = Smem::total * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      egcl_bwd_tile_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int total = B * N;
  const int need = (total + kWarps - 1) / kWarps;
  const int grid = need < sms ? need : sms;   // resident blocks; each flushes once
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  egcl_bwd_tile_f32_kernel<<<grid, kWarps * 32, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(x), static_cast<const int*>(nbr),
      static_cast<const float*>(params), static_cast<const float*>(dagg_m),
      static_cast<const float*>(dagg_x), static_cast<float*>(dh_center),
      static_cast<float*>(dx_center), static_cast<float*>(dh_nbr), static_cast<float*>(dx_nbr),
      static_cast<float*>(grads), total, N, K, head_width);
  return (int)cudaGetLastError();
}
