// Backward of the fused EGCL layer's edge program ('center' direction, 'frame'
// so3 mode), fast mode at C = 32, on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_backward.py::_egcl_bwd_kernel (wrapper egcl_backward_pallas, custom VJP
// egcl_fused_diff) for the trained shape: h [B, N, 32], x [B, N, 3], nbr
// [B, N, K] int32 and the cotangents dagg_m [B, N, 32], dagg_x [B, N, 3] ->
// dh, dx and the gradients of the 11 edge and coord parameters. It computes
// what egcl_backward.cu computes in FAST mode (bf16 product operands, rounded
// where the plain version rounds them, fp32 sums; fp32 gathers, geometry and
// its backward, LayerNorm statistics and vector gradients) in another order
// of the fp32 sums. egcl_backward.cu stays for accurate mode and other widths.
//
// What bounds it: the useful work is ~17.8 kFLOP an edge against ~4·(C+4)
// gathered bytes, so operations, and at the bf16 tensor rate those take tens
// of microseconds. egcl_backward.cu ran them as scalar FMAs, one lane an
// output channel, each reading a weight or an accumulator word from shared
// memory. Here one warp owns a center and its 16 edges are the 16 rows of
// bf16 mma.sync.m16n8k16 tiles, as in the forward (egcl_tile.cuh):
//   - the forward is recomputed from the header, keeping u (the first layer
//     before its SiLU), vhat and each row's rsqrt(var + eps), and cm (the
//     coord layer before its SiLU); s1 and m go to per-warp shared memory as
//     bf16 [edge][channel] operand tiles;
//   - the backward's products run on accumulator fragments (an accumulator
//     rounded to bf16 pairs is the next A fragment): dm = dagg_m + dcm Wc0,
//     ds1 = dv W2 (the zero head blocks skipped), [dh_col | dh_row] = du
//     [W1hc | W1hr], dgeo = du W1g; the transposed weights are ready B
//     fragments (ops/kernels/egcl.py::pack_params_tile_bwd);
//   - the LayerNorm backward reduces inside a quad, as the forward does;
//   - dh_col goes onto the neighbor by atomicAdd; dh_row is summed over each
//     tile's rows by shuffles and written once a center;
//   - the geometry backward is scalar, one lane an edge, from a per-warp fp32
//     dgeo scratch; dx of the center sums by shuffles, of the neighbor by
//     atomicAdd;
//   - the parameter gradients are tile products over the 16 edges,
//     gW[out][in] = sum_e D[e][out] A[e][in] (M = out, K = edges, N = in), with
//     D and A read as 16-bit pairs from the [edge][channel] tiles (dcm, dv, du;
//     m, s1, the staged h_col and geometry; h_i from registers); the results
//     go into one block-wide fp32 copy by shared-memory atomics and are
//     flushed once a block by global atomics; the vector gradients (fp32)
//     are summed over each tile's rows by recursive halving across lanes,
//     one register a lane a vector, so that 16 warps fit at 128 registers.
// K other than 16 runs as row tiles of 16; a row at or beyond K is staged
// from the center with dscale = 0 and dagg_m = 0, so each of its cotangents is
// exactly 0 and it adds nothing; its scatter and geometry backward are skipped.

#include "egcl_tile.cuh"

namespace {

using namespace egcl_tile;
using egcl_edge::geometry_bwd;

// Warps (centers in flight) per block, and blocks an SM. Latency bounds the
// kernel, so warps in flight set its pace. The first build of this kernel
// held the vector gradients and dh_row in registers across the tile loop:
// 237 registers, 8 warps, 1.773 ms a launch at B=64; this one holds 16
// warps at 128 registers with no spill: 1.142 ms (chip_smoke.py, separate
// calls, NVIDIA H100 80GB HBM3 at 700 W). A sweep of warps a block in a
// scratch copy ran 12 warps between the two, and the 237-register source
// forced to 16 warps spilled and ran slower than this one. The shared memory
// below (195 KB at 16 warps) allows one block an SM.
constexpr int kWarps = 16;
constexpr int kBlocksPerSM = 1;
constexpr int kXS = 40;   // row stride (bf16) of the [edge][channel] operand tiles:
                          // a fragment's 16-bit loads hit 32 distinct banks
constexpr int kGS = 36;   // row stride (fp32) of the block's [in][out] gradient copies:
                          // an accumulator's shared atomics hit 32 distinct banks
constexpr int kDgS = 17;  // row stride (fp32) of the per-warp dgeo scratch [edge][16]

// Word offsets in pack_params_tile_bwd's buffer: cotangent @ W as B fragments.
struct BwdLayout {
  static constexpr int wc0 = 0;                             // 2 k-steps x 4 n-tiles
  static constexpr int w2 = wc0 + 8 * Layout::kBlock;       // 2 x 4, dense
  static constexpr int w1h = w2 + 8 * Layout::kBlock;       // 2 x 8: [W1hc | W1hr]
  static constexpr int w1g = w1h + 16 * Layout::kBlock;     // 2 x 2: W1g, 16 outputs
  static constexpr int total = w1g + 4 * Layout::kBlock;
};

// Offsets in the output `grads` (egcl_backward.cu's Offsets at C = 32): the
// matrices [in][out] and the vectors in the order of EDGE_PARAMS.
struct GradOut {
  static constexpr int w1hr = 0, w1hc = 1024, w1g = 2048, b1 = 2432, w2 = 2464, b2 = 3488,
                       lns = 3520, lnb = 3552, wc0 = 3584, bc0 = 4608, wc1 = 4640,
                       total = 4672;
};

// The vector gradients, in registers and in the block's copy.
enum { kVB1, kVB2, kVLns, kVLnb, kVBc0, kVWc1, kVecs };

// Word offsets in dynamic shared memory.
struct Smem {
  static constexpr int wf = 0;                          // pack_params_tile
  static constexpr int wb = wf + Layout::total;         // pack_params_tile_bwd
  static constexpr int gmat = wb + BwdLayout::total;    // W1hr, W1hc, W2, Wc0: [32][kGS]
  static constexpr int gw1g = gmat + 4 * kC * kGS;      // W1g: [16][kGS]
  static constexpr int gvec = gw1g + 16 * kGS;          // [kVecs][32]
  static constexpr int warps = gvec + kVecs * kC;
  // per warp: the staged tile [16][kStride] bf16, 5 operand tiles [16][kXS]
  // bf16 (s1, m, dcm, dv, du), the dgeo scratch [16][kDgS] fp32
  static constexpr int ops = kRows * kStride / 2;
  static constexpr int dgeo = ops + 5 * kRows * kXS / 2;
  static constexpr int per_warp = dgeo + kRows * kDgS;
  static constexpr int total = warps + kWarps * per_warp;
};
static_assert(Smem::warps % 4 == 0 && Smem::per_warp % 4 == 0, "16-byte aligned tiles");

// The sum over the 8 row groups g (lanes xor 4, 8, 16) of a lane's 8 values
// v[2n + q] of channels 8n + 2t + q, by recursive halving: lane (g, t)
// returns channel 8 (g >> 1) + 2t + (g & 1) of the sum: 7 shuffles for 8
// values, and one register a lane to hold the result instead of 8.
__device__ __forceinline__ float group_sum(const float (&v)[8], int lane) {
  const int g = lane >> 2;
  const bool h2 = g & 4, h1 = g & 2, h0 = g & 1;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h2 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFull, h2 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (h1 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, h1 ? a[i] : a[i + 2], 8);
  return (h0 ? b[1] : b[0]) + __shfl_xor_sync(kFull, h0 ? b[0] : b[1], 4);
}

__device__ __forceinline__ float dsilu(float v) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-v));
  return s * (1.0f + v * (1.0f - s));
}

// Accumulators [16 x 32] -> bf16 rows of the [edge][channel] tile X.
__device__ __forceinline__ void store_rows(const float (&acc)[kNT][4], __nv_bfloat16* X,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t* lo = reinterpret_cast<uint32_t*>(X + g * kXS) + t;
  uint32_t* hi = reinterpret_cast<uint32_t*>(X + (g + 8) * kXS) + t;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    lo[4 * n] = pack2(acc[n][0], acc[n][1]);
    hi[4 * n] = pack2(acc[n][2], acc[n][3]);
  }
}

// X[e][ch] in the low half, X[e + 1][ch] in the high half: two edges of one
// channel, the pair a fragment holds along K when the edges are K.
__device__ __forceinline__ uint32_t edge_pair(const __nv_bfloat16* X, int stride, int e, int ch) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(X);
  return (uint32_t)u[e * stride + ch] | ((uint32_t)u[(e + 1) * stride + ch] << 16);
}

// The A fragment of D^T for m-tile mt (channels 16 mt .. 16 mt + 15 as rows,
// the 16 edges as K), D an [edge][channel] tile.
__device__ __forceinline__ void at_frag(const __nv_bfloat16* D, int stride, int mt, int lane,
                                        uint32_t (&a)[4]) {
  const int g = lane >> 2, t = lane & 3, c = 16 * mt + g;
  a[0] = edge_pair(D, stride, 2 * t, c);
  a[1] = edge_pair(D, stride, 2 * t, c + 8);
  a[2] = edge_pair(D, stride, 2 * t + 8, c);
  a[3] = edge_pair(D, stride, 2 * t + 8, c + 8);
}

// The B fragment of X for the 8 channels ch0 .. ch0 + 7 as columns, the 16
// edges as K, X an [edge][channel] tile.
__device__ __forceinline__ uint2 bt_frag(const __nv_bfloat16* X, int stride, int ch0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  return make_uint2(edge_pair(X, stride, 2 * t, ch0 + g), edge_pair(X, stride, 2 * t + 8, ch0 + g));
}

// G[in][out] += one accumulator of out rows 16 mt + g (+8), in columns in0 + 2t (+1).
__device__ __forceinline__ void add_grad(float* G, const float (&d)[4], int mt, int in0,
                                         int lane) {
  const int o = 16 * mt + (lane >> 2), i = in0 + 2 * (lane & 3);
  atomicAdd(G + i * kGS + o, d[0]);
  atomicAdd(G + (i + 1) * kGS + o, d[1]);
  atomicAdd(G + i * kGS + o + 8, d[2]);
  atomicAdd(G + (i + 1) * kGS + o + 8, d[3]);
}

// G[in][out] += sum over the tile's 16 edges of D[e][out] X[e][ch0 + in] for
// NT n-tiles of X; `ad` holds the two m-tiles of D^T. With `diag`, only the
// blocks whose 16 outputs and 8 inputs share a head (head width <= 16).
template <int NT>
__device__ __forceinline__ void grad_product(float* G, const uint32_t (&ad)[2][4],
                                             const __nv_bfloat16* X, int stride, int ch0,
                                             bool diag, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint2 b = bt_frag(X, stride, ch0 + 8 * nt, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (diag && mt != nt / 2) continue;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma(d, ad[mt], b);
      add_grad(G, d, mt, 8 * nt, lane);
    }
  }
}

// DBG also writes, per edge, dcm_in, dv and du (fp32) to dbg [B·N, K, 96]:
// the staged checks of the backward's fragment plumbing.
template <bool DBG>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
egcl_bwd_tile_kernel(const float* __restrict__ h, const float* __restrict__ x,
                     const int* __restrict__ nbr, const uint32_t* __restrict__ params,
                     const uint32_t* __restrict__ params_bwd,
                     const float* __restrict__ dagg_m, const float* __restrict__ dagg_x,
                     float* __restrict__ dh_center, float* __restrict__ dx_center,
                     float* __restrict__ dh_nbr, float* __restrict__ dx_nbr,
                     float* __restrict__ grads, float* __restrict__ dbg, int total, int N,
                     int K, int wh) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* w = smem + Smem::wf;
  uint32_t* wb = smem + Smem::wb;
  float* gacc = reinterpret_cast<float*>(smem + Smem::gmat);
  for (int i = threadIdx.x; i < Layout::total; i += blockDim.x) w[i] = params[i];
  for (int i = threadIdx.x; i < BwdLayout::total; i += blockDim.x) wb[i] = params_bwd[i];
  for (int i = threadIdx.x; i < Smem::warps - Smem::gmat; i += blockDim.x) gacc[i] = 0.f;
  __syncthreads();
  float* gW1hr = gacc;
  float* gW1hc = gacc + kC * kGS;
  float* gW2 = gacc + 2 * kC * kGS;
  float* gWc0 = gacc + 3 * kC * kGS;
  float* gW1g = reinterpret_cast<float*>(smem + Smem::gw1g);
  float* gvec = reinterpret_cast<float*>(smem + Smem::gvec);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* mine = smem + Smem::warps + warp * Smem::per_warp;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(mine);
  __nv_bfloat16* S1 = reinterpret_cast<__nv_bfloat16*>(mine + Smem::ops);
  __nv_bfloat16* M = S1 + kRows * kXS;
  __nv_bfloat16* DC = M + kRows * kXS;
  __nv_bfloat16* DV = DC + kRows * kXS;
  __nv_bfloat16* DU = DV + kRows * kXS;
  float* dgs = reinterpret_cast<float*>(mine + Smem::dgeo);

  // vector gradients of channel 8 (g >> 1) + 2t + (g & 1), over the warp's centers
  float vg[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) vg[v] = 0.f;
  const int my_c = 8 * (g >> 1) + 2 * t + (g & 1);

  for (int center = blockIdx.x * kWarps + warp; center < total;
       center += gridDim.x * kWarps) {
    const int base = center - center % N;          // b·N
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];
    const float dax0 = dagg_x[(size_t)center * 3 + 0];
    const float dax1 = dagg_x[(size_t)center * 3 + 1];
    const float dax2 = dagg_x[(size_t)center * 3 + 2];
    float2 hr[kNT];
    {
      float2 hi[kNT];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        hi[n] = *reinterpret_cast<const float2*>(h + (size_t)center * kC + 8 * n + 2 * t);
      uint32_t ahi[2][4];
      row_to_a(hi, ahi);
      hrow_block(ahi, w, lane, hr);
    }
    // dh_row = sum over the edges of du W1hr: channels 8g + 2t (+1) in lanes g < 4
    float2 dhs = make_float2(0.f, 0.f);
    float dxi[3] = {0.f, 0.f, 0.f};

    for (int row0 = 0; row0 < K; row0 += kRows) {
      float rel[3];
      const bool valid = stage_edges(h, x, nbr, center, base, K, row0, xi0, xi1, xi2, tile,
                                     lane, rel);
      const bool v_lo = row0 + g < K, v_hi = row0 + g + 8 < K;

      // ---- forward recompute, keeping u, vhat, r and cm ----
      float u[kNT][4], vh[kNT][4], cm[kNT][4];
      first_layer_pre(tile, hr, w, lane, u);
      {
        float s1[kNT][4];
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) s1[n][q] = silu(u[n][q]);
        store_rows(s1, S1, lane);
        head_layer(s1, w, wh, lane, vh);
      }
      float r_lo, r_hi;
      normalize(vh, r_lo, r_hi);
      {
        float m[kNT][4];
        ln_affine(vh, w, lane, m);
        store_rows(m, M, lane);
        coord_pre(m, w, lane, cm);
      }
      float s_lo, s_hi;
      coord_sum(cm, w, lane, s_lo, s_hi);
      const float scale_e = row_value(s_lo, s_hi, lane);

      // ---- coord MLP backward: dscale per edge, then dcm_in ----
      const float ds_e = valid ? dax0 * rel[0] + dax1 * rel[1] + dax2 * rel[2] : 0.f;
      const float dsr_lo = round_bf16(__shfl_sync(kFull, ds_e, g));
      const float dsr_hi = round_bf16(__shfl_sync(kFull, ds_e, g + 8));
      float d[kNT][4];    // dcm_in, then dm, then dv, then du
      {
        float sb[8], sw[8];   // this tile's rows g, g + 8 of the bc0 and wc1 sums
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float2 wc = vec2(w, Layout::wc1, n, t);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float ds = q < 2 ? dsr_lo : dsr_hi;
            const float c = cm[n][q];
            d[n][q] = dsilu(c) * ((q & 1 ? wc.y : wc.x) * ds);
            const float pw = ds * round_bf16(silu(c));
            if (q < 2) {
              sb[2 * n + q] = d[n][q];
              sw[2 * n + q] = pw;
            } else {
              sb[2 * n + q - 2] += d[n][q];
              sw[2 * n + q - 2] += pw;
            }
          }
        }
        vg[kVBc0] += group_sum(sb, lane);
        vg[kVWc1] += group_sum(sw, lane);
      }
      store_rows(d, DC, lane);
      if (DBG) {
        float* lo = dbg + ((size_t)center * K + row0 + g) * 96 + 2 * t;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (v_lo) *reinterpret_cast<float2*>(lo + 8 * n) = make_float2(d[n][0], d[n][1]);
          if (v_hi)
            *reinterpret_cast<float2*>(lo + 8 * 96 + 8 * n) = make_float2(d[n][2], d[n][3]);
        }
      }

      // ---- dm = dagg_m + dcm_in Wc0 (0 on rows beyond K) ----
      {
        uint32_t a[2][4];
        to_a(d, a);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float2 dm0 =
              *reinterpret_cast<const float2*>(dagg_m + (size_t)center * kC + 8 * n + 2 * t);
          d[n][0] = v_lo ? dm0.x : 0.f;
          d[n][1] = v_lo ? dm0.y : 0.f;
          d[n][2] = v_hi ? dm0.x : 0.f;
          d[n][3] = v_hi ? dm0.y : 0.f;
        }
        product<2>(d, a, wb, BwdLayout::wc0, lane);
      }

      // ---- LayerNorm backward: dv = r (dm·lns - mean(dm·lns) - vhat mean(dm·lns·vhat)) ----
      {
        float sg_lo = 0.f, sg_hi = 0.f, sv_lo = 0.f, sv_hi = 0.f;
        {
          float ss[8], sb[8];   // this tile's ln_scale and ln_bias sums
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              ss[2 * n + q] = d[n][q] * vh[n][q] + d[n][q + 2] * vh[n][q + 2];
              sb[2 * n + q] = d[n][q] + d[n][q + 2];
            }
          vg[kVLns] += group_sum(ss, lane);
          vg[kVLnb] += group_sum(sb, lane);
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float2 sc = vec2(w, Layout::lns, n, t);
#pragma unroll
          for (int q = 0; q < 4; ++q) d[n][q] *= (q & 1) ? sc.y : sc.x;
          sg_lo += d[n][0] + d[n][1];
          sg_hi += d[n][2] + d[n][3];
          sv_lo += d[n][0] * vh[n][0] + d[n][1] * vh[n][1];
          sv_hi += d[n][2] * vh[n][2] + d[n][3] * vh[n][3];
        }
        const float mg_lo = quad_sum(sg_lo) * (1.0f / kC), mg_hi = quad_sum(sg_hi) * (1.0f / kC);
        const float mv_lo = quad_sum(sv_lo) * (1.0f / kC), mv_hi = quad_sum(sv_hi) * (1.0f / kC);
        float sb[8];
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool lo = q < 2;
            d[n][q] = (lo ? r_lo : r_hi) *
                      (d[n][q] - (lo ? mg_lo : mg_hi) - vh[n][q] * (lo ? mv_lo : mv_hi));
          }
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int q = 0; q < 2; ++q) sb[2 * n + q] = d[n][q] + d[n][q + 2];
        vg[kVB2] += group_sum(sb, lane);
      }
      store_rows(d, DV, lane);
      if (DBG) {
        float* lo = dbg + ((size_t)center * K + row0 + g) * 96 + 32 + 2 * t;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (v_lo) *reinterpret_cast<float2*>(lo + 8 * n) = make_float2(d[n][0], d[n][1]);
          if (v_hi)
            *reinterpret_cast<float2*>(lo + 8 * 96 + 8 * n) = make_float2(d[n][2], d[n][3]);
        }
      }

      // ---- ds1 = dv W2 (block-diagonal: with heads <= 16 wide, n-tile n
      // reads k-step n / 2 only), du = dsilu(u) ds1 ----
      {
        uint32_t a[2][4];
        to_a(d, a);
#pragma unroll
        for (int n = 0; n < kNT; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
        if (wh <= 16) {
#pragma unroll
          for (int n = 0; n < kNT; ++n) mma(d[n], a[n / 2], b_frag(wb, BwdLayout::w2, n / 2, n, lane));
        } else {
          product<2>(d, a, wb, BwdLayout::w2, lane);
        }
      }
      {
        float sb[8];
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[n][q] *= dsilu(u[n][q]);
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int q = 0; q < 2; ++q) sb[2 * n + q] = d[n][q] + d[n][q + 2];
        vg[kVB1] += group_sum(sb, lane);
      }
      store_rows(d, DU, lane);
      if (DBG) {
        float* lo = dbg + ((size_t)center * K + row0 + g) * 96 + 64 + 2 * t;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (v_lo) *reinterpret_cast<float2*>(lo + 8 * n) = make_float2(d[n][0], d[n][1]);
          if (v_hi)
            *reinterpret_cast<float2*>(lo + 8 * 96 + 8 * n) = make_float2(d[n][2], d[n][3]);
        }
      }

      // ---- products of du: dgeo, dh_col (onto the neighbor), dh_row ----
      {
        uint32_t a[2][4];
        to_a(d, a);
        float dg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dhc[kNT][4], dhr[kNT][4];
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) dhc[n][q] = dhr[n][q] = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int n = 0; n < 2; ++n) mma(dg[n], a[j], b_frag_nt<2>(wb, BwdLayout::w1g, j, n, lane));
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            mma(dhc[n], a[j], b_frag_nt<8>(wb, BwdLayout::w1h, j, n, lane));
            mma(dhr[n], a[j], b_frag_nt<8>(wb, BwdLayout::w1h, j, n + kNT, lane));
          }
        }
        // dh_row: the tile's 16 rows, then the 8 quads; lanes g < 4 keep n-tile g
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float2 s = make_float2(dhr[n][0] + dhr[n][2], dhr[n][1] + dhr[n][3]);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s.x += __shfl_xor_sync(kFull, s.x, o);
            s.y += __shfl_xor_sync(kFull, s.y, o);
          }
          if (g == n) {
            dhs.x += s.x;
            dhs.y += s.y;
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          dgs[g * kDgS + 8 * n + 2 * t] = dg[n][0];
          dgs[g * kDgS + 8 * n + 2 * t + 1] = dg[n][1];
          dgs[(g + 8) * kDgS + 8 * n + 2 * t] = dg[n][2];
          dgs[(g + 8) * kDgS + 8 * n + 2 * t + 1] = dg[n][3];
        }
        if (v_lo) {
          float* dst = dh_nbr + (size_t)(base + nbr[(size_t)center * K + row0 + g]) * kC + 2 * t;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            atomicAdd(dst + 8 * n, dhc[n][0]);
            atomicAdd(dst + 8 * n + 1, dhc[n][1]);
          }
        }
        if (v_hi) {
          float* dst =
              dh_nbr + (size_t)(base + nbr[(size_t)center * K + row0 + g + 8]) * kC + 2 * t;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            atomicAdd(dst + 8 * n, dhc[n][2]);
            atomicAdd(dst + 8 * n + 1, dhc[n][3]);
          }
        }
      }
      __syncwarp();   // dgeo and the operand tiles are written

      // ---- geometry backward, one lane an edge ----
      if (lane < kRows && valid) {
        const int j_nb = base + nbr[(size_t)center * K + row0 + lane];
        float dxn[3];
        geometry_bwd(xi0, xi1, xi2, x[(size_t)j_nb * 3 + 0], x[(size_t)j_nb * 3 + 1],
                     x[(size_t)j_nb * 3 + 2], dax0, dax1, dax2, scale_e, dgs + lane * kDgS,
                     dxi, dxn);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 0, dxn[0]);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 1, dxn[1]);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + 2, dxn[2]);
      }

      // ---- parameter gradients: sums over the tile's 16 edges as products ----
      {
        uint32_t ad[2][4];
        at_frag(DC, kXS, 0, lane, ad[0]);
        at_frag(DC, kXS, 1, lane, ad[1]);
        grad_product<4>(gWc0, ad, M, kXS, 0, false, lane);
        at_frag(DV, kXS, 0, lane, ad[0]);
        at_frag(DV, kXS, 1, lane, ad[1]);
        grad_product<4>(gW2, ad, S1, kXS, 0, wh <= 16, lane);
        at_frag(DU, kXS, 0, lane, ad[0]);
        at_frag(DU, kXS, 1, lane, ad[1]);
        grad_product<4>(gW1hc, ad, tile, kStride, 0, false, lane);
        grad_product<2>(gW1g, ad, tile, kStride, kC, false, lane);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {   // B of h_i repeated along the edges
          const float hv = h[(size_t)center * kC + 8 * nt + g];
          const uint2 b = make_uint2(pack2(hv, hv), pack2(hv, hv));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float dd[4] = {0.f, 0.f, 0.f, 0.f};
            mma(dd, ad[mt], b);
            add_grad(gW1hr, dd, mt, 8 * nt, lane);
          }
        }
      }
    }

    if (g < kNT) *reinterpret_cast<float2*>(dh_center + (size_t)center * kC + 8 * g + 2 * t) = dhs;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      dxi[0] += __shfl_xor_sync(kFull, dxi[0], o);
      dxi[1] += __shfl_xor_sync(kFull, dxi[1], o);
      dxi[2] += __shfl_xor_sync(kFull, dxi[2], o);
    }
    if (lane == 0) {
      dx_center[(size_t)center * 3 + 0] = dxi[0];
      dx_center[(size_t)center * 3 + 1] = dxi[1];
      dx_center[(size_t)center * 3 + 2] = dxi[2];
    }
  }

  // ---- flush: the warps' vector gradients into the block's copy, then the
  // block's copy into grads, one global atomic an entry ----
#pragma unroll
  for (int v = 0; v < kVecs; ++v) atomicAdd(gvec + v * kC + my_c, vg[v]);
  __syncthreads();
  for (int i = threadIdx.x; i < GradOut::total; i += blockDim.x) {
    float s;
    if (i < GradOut::w1g) {               // W1hr, then W1hc, as gacc holds them
      const int mat = i / GradOut::w1hc, in = (i % GradOut::w1hc) / kC;
      s = gacc[mat * kC * kGS + in * kGS + i % kC];
    } else if (i < GradOut::b1) {
      s = gW1g[((i - GradOut::w1g) / kC) * kGS + i % kC];
    } else if (i < GradOut::w2) {
      s = gvec[kVB1 * kC + i - GradOut::b1];
    } else if (i < GradOut::b2) {
      const int in = (i - GradOut::w2) / kC, out = i % kC;
      if (in / wh != out / wh) continue;  // a structural zero of the block-diagonal w2
      s = gW2[in * kGS + out];
    } else if (i < GradOut::wc0) {        // b2, ln_scale, ln_bias
      s = gvec[(kVB2 + (i - GradOut::b2) / kC) * kC + i % kC];
    } else if (i < GradOut::bc0) {
      s = gWc0[((i - GradOut::wc0) / kC) * kGS + i % kC];
    } else {                              // bc0, wc1
      s = gvec[(kVBc0 + (i - GradOut::bc0) / kC) * kC + i % kC];
    }
    atomicAdd(grads + i, s);
  }
}

// out [32, 32] f32 = D^T A over 16 edges, D and A [16, 32] bf16 row-major
// ([edge][channel]): one transposed-operand product as the parameter
// gradients run it, to hold at_frag, bt_frag and add_grad against a.T @ b.
__global__ void bwd_tile_probe_kernel(const __nv_bfloat16* __restrict__ d,
                                      const __nv_bfloat16* __restrict__ a,
                                      float* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 D[kRows * kXS];
  __shared__ __align__(16) __nv_bfloat16 A[kRows * kXS];
  __shared__ float G[kC * kGS];
  const int lane = threadIdx.x;
  for (int i = lane; i < kRows * kC; i += 32) {
    D[(i / kC) * kXS + i % kC] = d[i];
    A[(i / kC) * kXS + i % kC] = a[i];
  }
  for (int i = lane; i < kC * kGS; i += 32) G[i] = 0.f;
  __syncwarp();
  uint32_t ad[2][4];
  at_frag(D, kXS, 0, lane, ad[0]);
  at_frag(D, kXS, 1, lane, ad[1]);
  grad_product<4>(G, ad, A, kXS, 0, false, lane);
  __syncwarp();
  for (int i = lane; i < kC * kC; i += 32) out[i] = G[(i % kC) * kGS + i / kC];
}

template <bool DBG>
int launch(const float* h, const float* x, const int* nbr, const uint32_t* params,
           const uint32_t* params_bwd, const float* dagg_m, const float* dagg_x,
           float* dh_center, float* dx_center, float* dh_nbr, float* dx_nbr, float* grads,
           float* dbg, int B, int N, int K, int wh, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = Smem::total * (int)sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      egcl_bwd_tile_kernel<DBG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int total = B * N;
  const int need = (total + kWarps - 1) / kWarps;
  const int cap = sms * kBlocksPerSM;   // resident blocks; each flushes once
  const int grid = need < cap ? need : cap;
  egcl_bwd_tile_kernel<DBG><<<grid, kWarps * 32, smem, stream>>>(
      h, x, nbr, params, params_bwd, dagg_m, dagg_x, dh_center, dx_center, dh_nbr, dx_nbr,
      grads, dbg, total, N, K, wh);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B,N,32], x [B,N,3] f32 (the layer inputs), nbr [B,N,K] int32 in [0, N),
// params and params_bwd: the buffers of ops/kernels/egcl.py::pack_params_tile
// and pack_params_tile_bwd, dagg_m [B,N,32], dagg_x [B,N,3]. Outputs:
// dh_center [B,N,32] and dx_center [B,N,3] (written), dh_nbr, dx_nbr and
// grads (egcl_backward.cu's layout) accumulated with atomics: the caller
// zero-fills them; and the per-edge stages dbg [B,N,K,96] unless dbg is null.
extern "C" int egcl_backward_tile_launch(const void* h, const void* x, const void* nbr,
                                         const void* params, const void* params_bwd,
                                         const void* dagg_m, const void* dagg_x,
                                         void* dh_center, void* dx_center, void* dh_nbr,
                                         void* dx_nbr, void* grads, void* dbg, int B, int N,
                                         int K, int head_width, void* stream) {
  if (K < 1 || head_width < 1 || kC % head_width) return (int)cudaErrorInvalidValue;
  const float* hf = static_cast<const float*>(h);
  const float* xf = static_cast<const float*>(x);
  const int* nb = static_cast<const int*>(nbr);
  const uint32_t* p = static_cast<const uint32_t*>(params);
  const uint32_t* pb = static_cast<const uint32_t*>(params_bwd);
  const float* dm = static_cast<const float*>(dagg_m);
  const float* dx = static_cast<const float*>(dagg_x);
  float* dhc = static_cast<float*>(dh_center);
  float* dxc = static_cast<float*>(dx_center);
  float* dhn = static_cast<float*>(dh_nbr);
  float* dxn = static_cast<float*>(dx_nbr);
  float* g = static_cast<float*>(grads);
  float* db = static_cast<float*>(dbg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return db != nullptr
             ? launch<true>(hf, xf, nb, p, pb, dm, dx, dhc, dxc, dhn, dxn, g, db, B, N, K, head_width, s)
             : launch<false>(hf, xf, nb, p, pb, dm, dx, dhc, dxc, dhn, dxn, g, db, B, N, K, head_width, s);
}

// d, a [16,32] bf16 row-major, out [32,32] f32 = d.T @ a.
extern "C" int egcl_backward_tile_probe(const void* d, const void* a, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_tile_probe_kernel<<<1, 32, 0, s>>>(static_cast<const __nv_bfloat16*>(d),
                                         static_cast<const __nv_bfloat16*>(a),
                                         static_cast<float*>(out));
  return (int)cudaGetLastError();
}
