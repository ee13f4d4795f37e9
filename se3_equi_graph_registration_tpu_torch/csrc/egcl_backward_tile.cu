// Backward of the fused EGCL layer's edge program ('center' direction, 'frame'
// so3 mode), fast mode, on Hopper's tensor cores (sm_90a), built at two
// channel widths (egcl_tile.cuh): CP = 32 for C = 32 and CP = 48 for
// 32 < C <= 36 (KITTI's C = 33, pads zero).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_backward.py::_egcl_bwd_kernel (wrapper egcl_backward_pallas, custom VJP
// egcl_fused_diff) in fast mode at those widths with whole heads: h [B, N, C],
// x [B, N, 3], nbr [B, N, K] int32 and the cotangents dagg_m [B, N, C],
// dagg_x [B, N, 3] -> dh, dx and the gradients of the 11 edge and coord
// parameters. It computes what egcl_backward.cu computes in FAST mode (bf16
// product operands, rounded where the plain version rounds them, fp32 sums;
// fp32 gathers, geometry and its backward, LayerNorm statistics and vector
// gradients) in another order of the fp32 sums. egcl_backward.cu stays for
// the other widths.
//
// What bounds it: the useful work is ~17.8 kFLOP an edge at C = 32, 4 heads
// (~23.7 at C = 33, one head) against ~4·(C+4) gathered bytes, so
// operations, and at the bf16 tensor rate those take tens of microseconds.
// egcl_backward.cu ran them as scalar FMAs, one lane an output channel, each
// reading a weight or an accumulator word from shared memory. Here one warp
// owns a center and its 16 edges are the 16 rows of bf16 mma.sync.m16n8k16
// tiles, as in the forward (egcl_tile.cuh):
//   - the forward is recomputed from the header, keeping u (the first layer
//     before its SiLU), vhat and each row's rsqrt(var + eps), and cm (the
//     coord layer before its SiLU); s1 and m go to per-warp shared memory as
//     bf16 [edge][channel] operand tiles;
//   - the backward's products run on accumulator fragments (an accumulator
//     rounded to bf16 pairs is the next A fragment): dm = dagg_m + dcm Wc0,
//     ds1 = dv W2 (at CP = 32 the zero head blocks skipped), [dh_col |
//     dh_row] = du [W1hc | W1hr], dgeo = du W1g; the transposed weights are
//     ready B fragments (ops/kernels/egcl.py::pack_params_tile_bwd);
//   - the LayerNorm backward reduces inside a quad, as the forward does, the
//     pad channels masked out (their dv would be -r mean(g));
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
//     flushed once a block by global atomics into the gradients at the true
//     width C (pad entries are never flushed); the vector gradients (fp32)
//     are summed over each tile's rows by recursive halving across lanes,
//     one register a lane a vector (two above CP = 32), so that 16 warps fit
//     at 128 registers at CP = 32.
// K other than 16 runs as row tiles of 16; a row at or beyond K is staged
// from the center with dscale = 0 and dagg_m = 0, so each of its cotangents is
// exactly 0 and it adds nothing; its scatter and geometry backward are skipped.

#include "egcl_tile.cuh"

namespace {

using namespace egcl_tile;
using egcl_edge::geometry_bwd;

constexpr int kSmemWords = 232448 / 4;   // the shared memory a block can use

// Strides, warps (centers in flight) per block and blocks an SM. Latency
// bounds the kernel, so warps in flight set its pace. At CP = 32 the first
// build held the vector gradients and dh_row in registers across the tile
// loop: 237 registers, 8 warps, 1.773 ms a launch at B=64; this one holds 16
// warps at 128 registers with no spill: 1.142 ms (chip_smoke.py, separate
// calls, NVIDIA H100 80GB HBM3 at 700 W). A sweep of warps a block in a
// scratch copy ran 12 warps between the two, and the 237-register source
// forced to 16 warps spilled and ran slower than this one. The shared memory
// (195 KB at 16 warps) allows one block an SM. At CP = 48 the per-warp tiles
// and the block's copies grow, and as many warps as the shared memory holds
// run: 10 (223 KB), which ptxas budgets as 12, 168 registers a thread
// (~300 bytes of spill); 8 warps without spills ran slower
// (egcl_tile_sweep.py, PERF.md §6).
template <int CP>
struct Bwd {
  // row stride (bf16) of the [edge][channel] operand tiles: a fragment's
  // 16-bit loads of edges 2t, 2t + 1 (+8) hit 32 distinct banks when
  // kXS mod 32 is 8 or 24
  static constexpr int kXS = CP == 32 ? 40 : 56;
  // row stride (fp32) of the block's [in][out] gradient copies: an
  // accumulator's shared atomics (inputs 2t, 2t + 1, outputs g) hit 32
  // distinct banks when 2 kGS mod 32 is 8 or 24
  static constexpr int kGS = CP == 32 ? 36 : 52;
  static constexpr int kDgS = 17;  // row stride (fp32) of the per-warp dgeo scratch [edge][16]
  static_assert(kXS % 32 == 8 || kXS % 32 == 24, "operand tile stride");
  static_assert((2 * kGS) % 32 == 8 || (2 * kGS) % 32 == 24, "gradient copy stride");
};

// Word offsets in pack_params_tile_bwd's buffer: cotangent @ W as B fragments.
template <int CP>
struct BwdLayout {
  static constexpr int NT = Dims<CP>::kNT, KS = Dims<CP>::kKS;
  static constexpr int wc0 = 0;                             // KS k-steps x NT n-tiles
  static constexpr int w2 = wc0 + KS * NT * kBlock;         // KS x NT, dense
  static constexpr int w1h = w2 + KS * NT * kBlock;         // KS x 2 NT: [W1hc | W1hr]
  static constexpr int w1g = w1h + KS * 2 * NT * kBlock;    // KS x 2: W1g, 16 outputs
  static constexpr int total = w1g + KS * 2 * kBlock;
};

// Offsets in the output `grads`: egcl_backward.cu's Offsets at the true
// width c, the matrices [in][out] and the vectors in the order of EDGE_PARAMS.
struct GradOut {
  int w1hc, w1g, b1, w2, b2, wc0, bc0, total;
  __device__ explicit GradOut(int c)
      : w1hc(c * c), w1g(2 * c * c), b1(2 * c * c + 12 * c), w2(b1 + c), b2(w2 + c * c),
        wc0(b2 + 3 * c), bc0(wc0 + c * c), total(bc0 + 2 * c) {}
};

// The vector gradients, in registers and in the block's copy.
enum { kVB1, kVB2, kVLns, kVLnb, kVBc0, kVWc1, kVecs };

// Word offsets in dynamic shared memory.
template <int CP>
struct Smem {
  static constexpr int kGS = Bwd<CP>::kGS, kXS = Bwd<CP>::kXS;
  static constexpr int wf = 0;                                // pack_params_tile
  static constexpr int wb = wf + Layout<CP>::total;           // pack_params_tile_bwd
  static constexpr int gmat = wb + BwdLayout<CP>::total;      // W1hr, W1hc, W2, Wc0: [CP][kGS]
  static constexpr int gw1g = gmat + 4 * CP * kGS;            // W1g: [16][kGS]
  static constexpr int gvec = gw1g + 16 * kGS;                // [kVecs][CP]
  static constexpr int warps = gvec + kVecs * CP;
  // per warp: the staged tile [16][kStride] bf16, 5 operand tiles [16][kXS]
  // bf16 (s1, m, dcm, dv, du), the dgeo scratch [16][kDgS] fp32
  static constexpr int ops = kRows * Dims<CP>::kStride / 2;
  static constexpr int dgeo = ops + 5 * kRows * kXS / 2;
  static constexpr int per_warp = dgeo + kRows * Bwd<CP>::kDgS;
  static constexpr int fit = (kSmemWords - warps) / per_warp;
  static constexpr int kWarps = fit < 16 ? fit : 16;
  static constexpr int total = warps + kWarps * per_warp;
  static_assert(warps % 4 == 0 && per_warp % 4 == 0, "16-byte aligned tiles");
  static_assert(kWarps >= 8 && total <= kSmemWords, "the shared memory of a block");
};

// The sum over the 8 row groups g (lanes xor 4, 8, 16) of a lane's 8 values
// v[2n + q] of channels 8n + 2t + q, by recursive halving: lane (g, t)
// returns channel 8 (g >> 1) + 2t + (g & 1): 7 shuffles for 8
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

// The same for 4 values v[2n + q] of channels 32 + 8n + 2t + q (n-tiles 4
// and 5): lane (g, t) returns channel 32 + 8 ((g >> 2) & 1) + 2t + ((g >> 1)
// & 1), the lanes g and g ^ 1 the same one.
__device__ __forceinline__ float group_sum4(const float (&v)[4], int lane) {
  const int g = lane >> 2;
  const bool h2 = g & 4, h1 = g & 2;
  float a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a[i] = (h2 ? v[i + 2] : v[i]) + __shfl_xor_sync(kFull, h2 ? v[i] : v[i + 2], 16);
  const float b = (h1 ? a[1] : a[0]) + __shfl_xor_sync(kFull, h1 ? a[0] : a[1], 8);
  return b + __shfl_xor_sync(kFull, b, 4);
}

// vg += this tile's sum over its rows of channel my_c (group_sum), and above
// CP = 32 vt += that of channel my_t (group_sum4), from a lane's values
// v[2n + q] of channels 8n + 2t + q.
template <int CP>
__device__ __forceinline__ void add_sums(float& vg, float& vt, const float (&v)[2 * Dims<CP>::kNT],
                                         int lane) {
  float lo[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) lo[i] = v[i];
  vg += group_sum(lo, lane);
  if constexpr (CP > 32) {
    float hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) hi[i] = v[8 + i];
    vt += group_sum4(hi, lane);
  }
}

__device__ __forceinline__ float dsilu(float v) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-v));
  return s * (1.0f + v * (1.0f - s));
}

// Accumulators [16 x CP] -> bf16 rows of the [edge][channel] tile X.
template <int CP>
__device__ __forceinline__ void store_rows(const float (&acc)[Dims<CP>::kNT][4],
                                           __nv_bfloat16* X, int lane) {
  constexpr int S = Bwd<CP>::kXS;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* lo = reinterpret_cast<uint32_t*>(X + g * S) + t;
  uint32_t* hi = reinterpret_cast<uint32_t*>(X + (g + 8) * S) + t;
#pragma unroll
  for (int n = 0; n < Dims<CP>::kNT; ++n) {
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

// The CP / 16 m-tiles of D^T.
template <int CP>
__device__ __forceinline__ void at_frags(const __nv_bfloat16* D, int lane,
                                         uint32_t (&ad)[Dims<CP>::kKS][4]) {
#pragma unroll
  for (int mt = 0; mt < Dims<CP>::kKS; ++mt) at_frag(D, Bwd<CP>::kXS, mt, lane, ad[mt]);
}

// The B fragment of X for the 8 channels ch0 .. ch0 + 7 as columns, the 16
// edges as K, X an [edge][channel] tile.
__device__ __forceinline__ uint2 bt_frag(const __nv_bfloat16* X, int stride, int ch0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  return make_uint2(edge_pair(X, stride, 2 * t, ch0 + g), edge_pair(X, stride, 2 * t + 8, ch0 + g));
}

// G[in][out] += one accumulator of out rows 16 mt + g (+8), in columns in0 + 2t (+1).
template <int CP>
__device__ __forceinline__ void add_grad(float* G, const float (&d)[4], int mt, int in0,
                                         int lane) {
  constexpr int kGS = Bwd<CP>::kGS;
  const int o = 16 * mt + (lane >> 2), i = in0 + 2 * (lane & 3);
  atomicAdd(G + i * kGS + o, d[0]);
  atomicAdd(G + (i + 1) * kGS + o, d[1]);
  atomicAdd(G + i * kGS + o + 8, d[2]);
  atomicAdd(G + (i + 1) * kGS + o + 8, d[3]);
}

// G[in][out] += sum over the tile's 16 edges of D[e][out] X[e][ch0 + in] for
// NT n-tiles of X; `ad` holds the CP / 16 m-tiles of D^T. With `diag`, only
// the blocks whose 16 outputs and 8 inputs share a head (CP = 32, head width
// <= 16).
template <int CP, int NT>
__device__ __forceinline__ void grad_product(float* G, const uint32_t (&ad)[Dims<CP>::kKS][4],
                                             const __nv_bfloat16* X, int stride, int ch0,
                                             bool diag, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint2 b = bt_frag(X, stride, ch0 + 8 * nt, lane);
#pragma unroll
    for (int mt = 0; mt < Dims<CP>::kKS; ++mt) {
      if (diag && mt != nt / 2) continue;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma(d, ad[mt], b);
      add_grad<CP>(G, d, mt, 8 * nt, lane);
    }
  }
}

// DBG also writes, per edge, dcm_in, dv and du (fp32) to dbg [B·N, K, 3 CP]:
// the staged checks of the backward's fragment plumbing.
template <int CP, bool DBG>
__global__ void __launch_bounds__(Smem<CP>::kWarps * 32, 1)
egcl_bwd_tile_kernel(const float* __restrict__ h, const float* __restrict__ x,
                     const int* __restrict__ nbr, const uint32_t* __restrict__ params,
                     const uint32_t* __restrict__ params_bwd,
                     const float* __restrict__ dagg_m, const float* __restrict__ dagg_x,
                     float* __restrict__ dh_center, float* __restrict__ dx_center,
                     float* __restrict__ dh_nbr, float* __restrict__ dx_nbr,
                     float* __restrict__ grads, float* __restrict__ dbg, int total, int N,
                     int K, int c_arg, int wh) {
  constexpr int NT = Dims<CP>::kNT, KS = Dims<CP>::kKS, kStride = Dims<CP>::kStride;
  constexpr int kXS = Bwd<CP>::kXS, kGS = Bwd<CP>::kGS, kDgS = Bwd<CP>::kDgS;
  constexpr int kWarps = Smem<CP>::kWarps, kDbg = 3 * CP;
  using L = Layout<CP>;
  using BL = BwdLayout<CP>;
  using S = Smem<CP>;
  const int c = CP == 32 ? 32 : c_arg;   // the true width
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* w = smem + S::wf;
  uint32_t* wb = smem + S::wb;
  float* gacc = reinterpret_cast<float*>(smem + S::gmat);
  for (int i = threadIdx.x; i < L::total; i += blockDim.x) w[i] = params[i];
  for (int i = threadIdx.x; i < BL::total; i += blockDim.x) wb[i] = params_bwd[i];
  for (int i = threadIdx.x; i < S::warps - S::gmat; i += blockDim.x) gacc[i] = 0.f;
  float* gW1hr = gacc;
  float* gW1hc = gacc + CP * kGS;
  float* gW2 = gacc + 2 * CP * kGS;
  float* gWc0 = gacc + 3 * CP * kGS;
  float* gW1g = reinterpret_cast<float*>(smem + S::gw1g);
  float* gvec = reinterpret_cast<float*>(smem + S::gvec);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* mine = smem + S::warps + warp * S::per_warp;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(mine);
  __nv_bfloat16* S1 = reinterpret_cast<__nv_bfloat16*>(mine + S::ops);
  __nv_bfloat16* M = S1 + kRows * kXS;
  __nv_bfloat16* DC = M + kRows * kXS;
  __nv_bfloat16* DV = DC + kRows * kXS;
  __nv_bfloat16* DU = DV + kRows * kXS;
  float* dgs = reinterpret_cast<float*>(mine + S::dgeo);
  if constexpr (CP != 32)               // the pad columns of h_col, never staged
    for (int i = lane; i < S::ops; i += 32) mine[i] = 0u;
  __syncthreads();

  // vector gradients of channel 8 (g >> 1) + 2t + (g & 1), over the warp's
  // centers, and above CP = 32 of channel 32 + 8 ((g >> 2) & 1) + 2t + ((g >> 1) & 1)
  float vg[kVecs], vt[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) vg[v] = vt[v] = 0.f;
  const int my_c = 8 * (g >> 1) + 2 * t + (g & 1);
  const int my_t = 32 + 8 * ((g >> 2) & 1) + 2 * t + ((g >> 1) & 1);

  for (int center = blockIdx.x * kWarps + warp; center < total;
       center += gridDim.x * kWarps) {
    const int base = center - center % N;          // b·N
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];
    const float dax0 = dagg_x[(size_t)center * 3 + 0];
    const float dax1 = dagg_x[(size_t)center * 3 + 1];
    const float dax2 = dagg_x[(size_t)center * 3 + 2];
    float2 hr[NT];
    {
      float2 hi[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) hi[n] = load2<CP>(h, center, c, n, t);
      uint32_t ahi[KS][4];
      row_to_a<CP>(hi, ahi);
      hrow_block<CP>(ahi, w, lane, hr);
    }
    // dh_row = sum over the edges of du W1hr: channels 8g + 2t (+1) in lanes g < CP / 8
    float2 dhs = make_float2(0.f, 0.f);
    float dxi[3] = {0.f, 0.f, 0.f};

    for (int row0 = 0; row0 < K; row0 += kRows) {
      float rel[3];
      const bool valid = stage_edges<CP>(h, x, nbr, center, base, K, row0, xi0, xi1, xi2, tile,
                                         lane, rel, c);
      const bool v_lo = row0 + g < K, v_hi = row0 + g + 8 < K;

      // ---- forward recompute, keeping u, vhat, r and cm ----
      float u[NT][4], vh[NT][4], cm[NT][4];
      first_layer_pre<CP>(tile, hr, w, lane, u);
      {
        float s1[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) s1[n][q] = silu(u[n][q]);
        store_rows<CP>(s1, S1, lane);
        head_layer<CP>(s1, w, wh, lane, vh);
      }
      float r_lo, r_hi;
      normalize<CP>(vh, r_lo, r_hi, c, lane);
      {
        float m[NT][4];
        ln_affine<CP>(vh, w, lane, m);
        store_rows<CP>(m, M, lane);
        coord_pre<CP>(m, w, lane, cm);
      }
      float s_lo, s_hi;
      coord_sum<CP>(cm, w, lane, s_lo, s_hi);
      const float scale_e = row_value(s_lo, s_hi, lane);

      // ---- coord MLP backward: dscale per edge, then dcm_in ----
      const float ds_e = valid ? dax0 * rel[0] + dax1 * rel[1] + dax2 * rel[2] : 0.f;
      const float dsr_lo = round_bf16(__shfl_sync(kFull, ds_e, g));
      const float dsr_hi = round_bf16(__shfl_sync(kFull, ds_e, g + 8));
      float d[NT][4];    // dcm_in, then dm, then dv, then du
      {
        float sb[2 * NT], sw[2 * NT];   // this tile's rows g, g + 8 of the bc0 and wc1 sums
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 wc = vec2(w, L::wc1, n, t);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float ds = q < 2 ? dsr_lo : dsr_hi;
            const float cv = cm[n][q];
            d[n][q] = dsilu(cv) * ((q & 1 ? wc.y : wc.x) * ds);
            const float pw = ds * round_bf16(silu(cv));
            if (q < 2) {
              sb[2 * n + q] = d[n][q];
              sw[2 * n + q] = pw;
            } else {
              sb[2 * n + q - 2] += d[n][q];
              sw[2 * n + q - 2] += pw;
            }
          }
        }
        add_sums<CP>(vg[kVBc0], vt[kVBc0], sb, lane);
        add_sums<CP>(vg[kVWc1], vt[kVWc1], sw, lane);
      }
      store_rows<CP>(d, DC, lane);
      if (DBG) {
        float* lo = dbg + ((size_t)center * K + row0 + g) * kDbg + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (v_lo) *reinterpret_cast<float2*>(lo + 8 * n) = make_float2(d[n][0], d[n][1]);
          if (v_hi)
            *reinterpret_cast<float2*>(lo + 8 * kDbg + 8 * n) = make_float2(d[n][2], d[n][3]);
        }
      }

      // ---- dm = dagg_m + dcm_in Wc0 (0 on rows beyond K) ----
      {
        uint32_t a[KS][4];
        to_a<CP>(d, a);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 dm0 = load2<CP>(dagg_m, center, c, n, t);
          d[n][0] = v_lo ? dm0.x : 0.f;
          d[n][1] = v_lo ? dm0.y : 0.f;
          d[n][2] = v_hi ? dm0.x : 0.f;
          d[n][3] = v_hi ? dm0.y : 0.f;
        }
        product<CP, KS>(d, a, wb, BL::wc0, lane);
      }

      // ---- LayerNorm backward: dv = r (dm·lns - mean(dm·lns) - vhat mean(dm·lns·vhat)),
      // 0 on the pad channels ----
      {
        float sg_lo = 0.f, sg_hi = 0.f, sv_lo = 0.f, sv_hi = 0.f;
        {
          float ss[2 * NT], sb[2 * NT];   // this tile's ln_scale and ln_bias sums
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              ss[2 * n + q] = d[n][q] * vh[n][q] + d[n][q + 2] * vh[n][q + 2];
              sb[2 * n + q] = d[n][q] + d[n][q + 2];
            }
          add_sums<CP>(vg[kVLns], vt[kVLns], ss, lane);
          add_sums<CP>(vg[kVLnb], vt[kVLnb], sb, lane);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 sc = vec2(w, L::lns, n, t);
#pragma unroll
          for (int q = 0; q < 4; ++q) d[n][q] *= (q & 1) ? sc.y : sc.x;
          sg_lo += d[n][0] + d[n][1];
          sg_hi += d[n][2] + d[n][3];
          sv_lo += d[n][0] * vh[n][0] + d[n][1] * vh[n][1];
          sv_hi += d[n][2] * vh[n][2] + d[n][3] * vh[n][3];
        }
        const float inv_c = CP == 32 ? 1.0f / 32 : 1.0f / c;
        const float mg_lo = quad_sum(sg_lo) * inv_c, mg_hi = quad_sum(sg_hi) * inv_c;
        const float mv_lo = quad_sum(sv_lo) * inv_c, mv_hi = quad_sum(sv_hi) * inv_c;
        float sb[2 * NT];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool lo = q < 2;
            d[n][q] = real<CP>(n, t, q & 1, c)
                          ? (lo ? r_lo : r_hi) *
                                (d[n][q] - (lo ? mg_lo : mg_hi) - vh[n][q] * (lo ? mv_lo : mv_hi))
                          : 0.f;
          }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 2; ++q) sb[2 * n + q] = d[n][q] + d[n][q + 2];
        add_sums<CP>(vg[kVB2], vt[kVB2], sb, lane);
      }
      store_rows<CP>(d, DV, lane);
      if (DBG) {
        float* lo = dbg + ((size_t)center * K + row0 + g) * kDbg + CP + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (v_lo) *reinterpret_cast<float2*>(lo + 8 * n) = make_float2(d[n][0], d[n][1]);
          if (v_hi)
            *reinterpret_cast<float2*>(lo + 8 * kDbg + 8 * n) = make_float2(d[n][2], d[n][3]);
        }
      }

      // ---- ds1 = dv W2 (block-diagonal: at CP = 32 with heads <= 16 wide,
      // n-tile n reads k-step n / 2 only), du = dsilu(u) ds1 ----
      {
        uint32_t a[KS][4];
        to_a<CP>(d, a);
#pragma unroll
        for (int n = 0; n < NT; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
        if (CP == 32 && wh <= 16) {
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma(d[n], a[n / 2], b_frag<CP>(wb, BL::w2, n / 2, n, lane));
        } else {
          product<CP, KS>(d, a, wb, BL::w2, lane);
        }
      }
      {
        float sb[2 * NT];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[n][q] *= dsilu(u[n][q]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 2; ++q) sb[2 * n + q] = d[n][q] + d[n][q + 2];
        add_sums<CP>(vg[kVB1], vt[kVB1], sb, lane);
      }
      store_rows<CP>(d, DU, lane);
      if (DBG) {
        float* lo = dbg + ((size_t)center * K + row0 + g) * kDbg + 2 * CP + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (v_lo) *reinterpret_cast<float2*>(lo + 8 * n) = make_float2(d[n][0], d[n][1]);
          if (v_hi)
            *reinterpret_cast<float2*>(lo + 8 * kDbg + 8 * n) = make_float2(d[n][2], d[n][3]);
        }
      }

      // ---- products of du: dgeo, dh_col (onto the neighbor), dh_row ----
      {
        uint32_t a[KS][4];
        to_a<CP>(d, a);
        float dg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dhc[NT][4], dhr[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) dhc[n][q] = dhr[n][q] = 0.f;
#pragma unroll
        for (int j = 0; j < KS; ++j) {
#pragma unroll
          for (int n = 0; n < 2; ++n) mma(dg[n], a[j], b_frag_nt<2>(wb, BL::w1g, j, n, lane));
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mma(dhc[n], a[j], b_frag_nt<2 * NT>(wb, BL::w1h, j, n, lane));
            mma(dhr[n], a[j], b_frag_nt<2 * NT>(wb, BL::w1h, j, n + NT, lane));
          }
        }
        // dh_row: the tile's 16 rows, then the 8 quads; lanes g < NT keep n-tile g
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float2 sm = make_float2(dhr[n][0] + dhr[n][2], dhr[n][1] + dhr[n][3]);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            sm.x += __shfl_xor_sync(kFull, sm.x, o);
            sm.y += __shfl_xor_sync(kFull, sm.y, o);
          }
          if (g == n) {
            dhs.x += sm.x;
            dhs.y += sm.y;
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
          float* dst = dh_nbr + (size_t)(base + nbr[(size_t)center * K + row0 + g]) * c + 2 * t;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (real<CP>(n, t, 0, c)) atomicAdd(dst + 8 * n, dhc[n][0]);
            if (real<CP>(n, t, 1, c)) atomicAdd(dst + 8 * n + 1, dhc[n][1]);
          }
        }
        if (v_hi) {
          float* dst =
              dh_nbr + (size_t)(base + nbr[(size_t)center * K + row0 + g + 8]) * c + 2 * t;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (real<CP>(n, t, 0, c)) atomicAdd(dst + 8 * n, dhc[n][2]);
            if (real<CP>(n, t, 1, c)) atomicAdd(dst + 8 * n + 1, dhc[n][3]);
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
        uint32_t ad[KS][4];
        at_frags<CP>(DC, lane, ad);
        grad_product<CP, NT>(gWc0, ad, M, kXS, 0, false, lane);
        at_frags<CP>(DV, lane, ad);
        grad_product<CP, NT>(gW2, ad, S1, kXS, 0, CP == 32 && wh <= 16, lane);
        at_frags<CP>(DU, lane, ad);
        grad_product<CP, NT>(gW1hc, ad, tile, kStride, 0, false, lane);
        grad_product<CP, 2>(gW1g, ad, tile, kStride, CP, false, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {   // B of h_i repeated along the edges
          const int ch = 8 * nt + g;
          const float hv = CP == 32 || ch < c ? h[(size_t)center * c + ch] : 0.f;
          const uint2 b = make_uint2(pack2(hv, hv), pack2(hv, hv));
#pragma unroll
          for (int mt = 0; mt < KS; ++mt) {
            float dd[4] = {0.f, 0.f, 0.f, 0.f};
            mma(dd, ad[mt], b);
            add_grad<CP>(gW1hr, dd, mt, 8 * nt, lane);
          }
        }
      }
    }

    if (g < NT) store2<CP>(dh_center, center, c, g, t, dhs);
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
  // block's copy into grads at the true width, one global atomic an entry ----
#pragma unroll
  for (int v = 0; v < kVecs; ++v) atomicAdd(gvec + v * CP + my_c, vg[v]);
  if constexpr (CP > 32) {
    if ((g & 1) == 0) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) atomicAdd(gvec + v * CP + my_t, vt[v]);
    }
  }
  __syncthreads();
  const GradOut go(c);
  for (int i = threadIdx.x; i < go.total; i += blockDim.x) {
    const int out = i % c;
    float s;
    if (i < go.w1g) {                     // W1hr, then W1hc, as gacc holds them
      const int mat = i / go.w1hc, in = (i % go.w1hc) / c;
      s = gacc[mat * CP * kGS + in * kGS + out];
    } else if (i < go.b1) {
      s = gW1g[((i - go.w1g) / c) * kGS + out];
    } else if (i < go.w2) {
      s = gvec[kVB1 * CP + out];
    } else if (i < go.b2) {
      const int in = (i - go.w2) / c;
      if (in / wh != out / wh) continue;  // a structural zero of the block-diagonal w2
      s = gW2[in * kGS + out];
    } else if (i < go.wc0) {              // b2, ln_scale, ln_bias
      s = gvec[(kVB2 + (i - go.b2) / c) * CP + out];
    } else if (i < go.bc0) {
      s = gWc0[((i - go.wc0) / c) * kGS + out];
    } else {                              // bc0, wc1
      s = gvec[(kVBc0 + (i - go.bc0) / c) * CP + out];
    }
    atomicAdd(grads + i, s);
  }
}

// out [32, 32] f32 = D^T A over 16 edges, D and A [16, 32] bf16 row-major
// ([edge][channel]): one transposed-operand product as the parameter
// gradients run it at CP = 32, to hold at_frag, bt_frag and add_grad against
// a.T @ b.
__global__ void bwd_tile_probe_kernel(const __nv_bfloat16* __restrict__ d,
                                      const __nv_bfloat16* __restrict__ a,
                                      float* __restrict__ out) {
  constexpr int kXS = Bwd<32>::kXS, kGS = Bwd<32>::kGS;
  __shared__ __align__(16) __nv_bfloat16 D[kRows * kXS];
  __shared__ __align__(16) __nv_bfloat16 A[kRows * kXS];
  __shared__ float G[32 * kGS];
  const int lane = threadIdx.x;
  for (int i = lane; i < kRows * 32; i += 32) {
    D[(i / 32) * kXS + i % 32] = d[i];
    A[(i / 32) * kXS + i % 32] = a[i];
  }
  for (int i = lane; i < 32 * kGS; i += 32) G[i] = 0.f;
  __syncwarp();
  uint32_t ad[2][4];
  at_frags<32>(D, lane, ad);
  grad_product<32, 4>(G, ad, A, kXS, 0, false, lane);
  __syncwarp();
  for (int i = lane; i < 32 * 32; i += 32) out[i] = G[(i % 32) * kGS + i / 32];
}

template <int CP, bool DBG>
int launch(const float* h, const float* x, const int* nbr, const uint32_t* params,
           const uint32_t* params_bwd, const float* dagg_m, const float* dagg_x,
           float* dh_center, float* dx_center, float* dh_nbr, float* dx_nbr, float* grads,
           float* dbg, int B, int N, int K, int C, int wh, cudaStream_t stream) {
  const auto kernel = egcl_bwd_tile_kernel<CP, DBG>;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = Smem<CP>::total * (int)sizeof(uint32_t);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int total = B * N;
  constexpr int kWarps = Smem<CP>::kWarps;
  const int need = (total + kWarps - 1) / kWarps;
  const int grid = need < sms ? need : sms;   // resident blocks (one an SM); each flushes once
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      h, x, nbr, params, params_bwd, dagg_m, dagg_x, dh_center, dx_center, dh_nbr, dx_nbr,
      grads, dbg, total, N, K, C, wh);
  return (int)cudaGetLastError();
}

template <int CP>
int launch_width(const float* h, const float* x, const int* nbr, const uint32_t* p,
                 const uint32_t* pb, const float* dm, const float* dx, float* dhc, float* dxc,
                 float* dhn, float* dxn, float* g, float* db, int B, int N, int K, int C,
                 int wh, cudaStream_t s) {
  return db != nullptr
             ? launch<CP, true>(h, x, nbr, p, pb, dm, dx, dhc, dxc, dhn, dxn, g, db, B, N, K,
                                C, wh, s)
             : launch<CP, false>(h, x, nbr, p, pb, dm, dx, dhc, dxc, dhn, dxn, g, db, B, N, K,
                                 C, wh, s);
}

}  // namespace

// h [B,N,C], x [B,N,3] f32 (the layer inputs), nbr [B,N,K] int32 in [0, N),
// params and params_bwd: the buffers of ops/kernels/egcl.py::pack_params_tile
// and pack_params_tile_bwd at the width that runs C (32 for C = 32, 48 for
// 32 < C <= 36), dagg_m [B,N,C], dagg_x [B,N,3]. Outputs: dh_center [B,N,C]
// and dx_center [B,N,3] (written), dh_nbr, dx_nbr and grads
// (egcl_backward.cu's layout at C) accumulated with atomics: the caller
// zero-fills them; and the per-edge stages dbg [B,N,K,3 CP] unless dbg is null.
extern "C" int egcl_backward_tile_launch(const void* h, const void* x, const void* nbr,
                                         const void* params, const void* params_bwd,
                                         const void* dagg_m, const void* dagg_x,
                                         void* dh_center, void* dx_center, void* dh_nbr,
                                         void* dx_nbr, void* grads, void* dbg, int B, int N,
                                         int K, int C, int head_width, void* stream) {
  if (K < 1 || head_width < 1 || C % head_width) return (int)cudaErrorInvalidValue;
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
  if (C == 32)
    return launch_width<32>(hf, xf, nb, p, pb, dm, dx, dhc, dxc, dhn, dxn, g, db, B, N, K, C,
                            head_width, s);
  if (32 < C && C <= 36)
    return launch_width<kPadded>(hf, xf, nb, p, pb, dm, dx, dhc, dxc, dhn, dxn, g, db, B, N, K,
                                 C, head_width, s);
  return (int)cudaErrorInvalidValue;
}

// d, a [16,32] bf16 row-major, out [32,32] f32 = d.T @ a.
extern "C" int egcl_backward_tile_probe(const void* d, const void* a, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_tile_probe_kernel<<<1, 32, 0, s>>>(static_cast<const __nv_bfloat16*>(d),
                                         static_cast<const __nv_bfloat16*>(a),
                                         static_cast<float*>(out));
  return (int)cudaGetLastError();
}
