// One fused EGCL layer ('center' direction, 'frame' so3 mode), forward, fast
// mode, on Hopper's tensor cores (sm_90a), built at two channel widths
// (egcl_tile.cuh): CP = 32 for C = 32 and CP = 48 for 32 < C <= 36
// (KITTI's C = 33, pads zero).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_kernel.py::_egcl_kernel (wrappers egcl_layer_pallas,
// egnn_forward_pallas) in fast mode at those widths with whole heads:
// h [B, N, C] f32, x [B, N, 3] f32, nbr [B, N, K] int32 with every index in
// [0, N) -> h', x' and, when asked, agg_m (the message sum before the node
// MLP, which the backward needs). It computes what egcl.cu computes in FAST
// mode (bf16 operands, fp32 accumulation; fp32 gathers, geometry, LayerNorm
// and sums), in another order of the fp32 sums. egcl.cu stays for the other
// widths.
//
// What bounds it: the useful work is ~6.3 kFLOP an edge at C = 32, 4 heads
// (~8.3 at C = 33, one head) against 4·(C+4) gathered bytes, so operations,
// and at the bf16 tensor rate those take microseconds. egcl.cu ran them as
// dependent scalar FMAs, one shared-memory weight load and one broadcast load
// each, one edge after another (and at C = 33 its lane l holds channels l and
// l + 32, one live lane of 32 in the second pass). Here the 16 edges of a
// center are the 16 rows of a bf16 mma.sync.m16n8k16 tile:
//   - weights sit in shared memory as ready B fragments (one 64-bit load a
//     lane per mma), rounded and ordered on the host;
//   - a center's edges are staged in parallel: one lane an edge for the
//     neighbor index, x_j and the 12 geometry values, all lanes for the
//     16 gathered h_j rows, into a bf16 tile [16][CP + 16] per warp;
//   - the first layer is [h_col | geo] (CP / 16 + 1 k-steps from the tile) on
//     top of the h_row block, which is one product per center kept as the
//     accumulators' initial value; the head layer, LayerNorm, the coordinate
//     MLP chain in registers (an accumulator fragment is the next A
//     fragment), with no shared-memory round trip and no barrier;
//   - LayerNorm and the coordinate scalar reduce inside a quad, the sum over
//     edges across quads, by shuffles;
//   - the node MLP runs on the same fragments with the center's row repeated
//     in all 16 rows (24 mma a center at CP = 32; the tensor cores have the
//     room).
// What is left is scalar instruction throughput: the gathers, geometry, the
// SiLUs (CP + CP / 4 a lane) and the conversions. The padded width issues
// (48 / 32)² = 2.25x the mma of C = 32 for 33 real channels. K other than 16
// runs as row tiles of 16 with the rows at or beyond K masked out of every sum.

#include "egcl_tile.cuh"

namespace {

using namespace egcl_tile;

// Warps (centers in flight) per block, and blocks per SM the register
// budget is held to. The kernel is bound by instruction throughput and
// latency, not by the tensor pipes, so more warps help: at CP = 32, 3 blocks
// (80 registers, 24 warps an SM, two spilled words) ran a launch at B=64 in
// 0.297-0.304 ms against 0.335-0.338 ms at 2 blocks (124 registers),
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, separate calls. At
// CP = 48, where a lane holds 1.5x the fragments, 3 blocks (80 registers,
// 136 bytes of stack) ran 0.6056 ms at C=33, B=64 against 0.6429 at 2
// blocks (128 registers) and 1.0647 at 1 (egcl_tile_sweep.py, one run).
template <int CP>
struct Fwd {
  static constexpr int kWarps = 8;
  static constexpr int kBlocksPerSM = 3;
};

// Word offsets in dynamic shared memory: the weights, then per warp the
// staging tile [16][kStride] bf16.
template <int CP>
struct Smem {
  static constexpr int stage = Layout<CP>::total;
  static constexpr int per_warp = kRows * Dims<CP>::kStride / 2;
  static constexpr int total = stage + Fwd<CP>::kWarps * per_warp;
  static_assert(stage % 4 == 0 && per_warp % 4 == 0, "16-byte aligned tiles");
};

// DBG also writes, per edge, s1 (after the SiLU) and m (after LayerNorm) to
// dbg [B·N, K, 2 CP]: the staged checks of the fragment layouts.
template <int CP, bool DBG>
__global__ void __launch_bounds__(Fwd<CP>::kWarps * 32, Fwd<CP>::kBlocksPerSM)
egcl_tile_kernel(const float* __restrict__ h, const float* __restrict__ x,
                 const int* __restrict__ nbr, const uint32_t* __restrict__ params,
                 float* __restrict__ h_out, float* __restrict__ x_out,
                 float* __restrict__ aggm_out, float* __restrict__ dbg, int total, int N,
                 int K, int c_arg, int wh) {
  constexpr int NT = Dims<CP>::kNT, KS = Dims<CP>::kKS, kWarps = Fwd<CP>::kWarps;
  using L = Layout<CP>;
  const int c = CP == 32 ? 32 : c_arg;   // the true width
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* w = smem;
  for (int i = threadIdx.x; i < L::total; i += blockDim.x) w[i] = params[i];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem + Smem<CP>::stage +
                                                         warp * Smem<CP>::per_warp);
  if constexpr (CP != 32)               // the pad columns of h_col, never staged
    for (int i = lane; i < Smem<CP>::per_warp; i += 32) smem[Smem<CP>::stage +
                                                            warp * Smem<CP>::per_warp + i] = 0u;
  __syncthreads();

  for (int center = blockIdx.x * kWarps + warp; center < total;
       center += gridDim.x * kWarps) {
    const int base = center - center % N;          // b·N
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];
    float2 hi[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) hi[n] = load2<CP>(h, center, c, n, t);
    uint32_t ahi[KS][4];
    row_to_a<CP>(hi, ahi);
    float2 hr[NT];
    hrow_block<CP>(ahi, w, lane, hr);

    float2 agg[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) agg[n] = make_float2(0.f, 0.f);
    float ax0 = 0.f, ax1 = 0.f, ax2 = 0.f;

    for (int row0 = 0; row0 < K; row0 += kRows) {
      float rel[3];
      const bool valid = stage_edges<CP>(h, x, nbr, center, base, K, row0, xi0, xi1, xi2, tile,
                                         lane, rel, c);
      const bool v_lo = row0 + g < K, v_hi = row0 + g + 8 < K;
      float s1[NT][4], m[NT][4];
      first_layer<CP>(tile, hr, w, lane, s1);
      head_layer<CP>(s1, w, wh, lane, m);
      layer_norm<CP>(m, w, c, lane);
      if (DBG) {
        float* lo = dbg + ((size_t)center * K + row0 + g) * (2 * CP) + 2 * t;
        float* hi_ = lo + 8 * (2 * CP);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (v_lo) {
            *reinterpret_cast<float2*>(lo + 8 * n) = make_float2(s1[n][0], s1[n][1]);
            *reinterpret_cast<float2*>(lo + CP + 8 * n) = make_float2(m[n][0], m[n][1]);
          }
          if (v_hi) {
            *reinterpret_cast<float2*>(hi_ + 8 * n) = make_float2(s1[n][2], s1[n][3]);
            *reinterpret_cast<float2*>(hi_ + CP + 8 * n) = make_float2(m[n][2], m[n][3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        agg[n].x += (v_lo ? m[n][0] : 0.f) + (v_hi ? m[n][2] : 0.f);
        agg[n].y += (v_lo ? m[n][1] : 0.f) + (v_hi ? m[n][3] : 0.f);
      }
      float s_lo, s_hi;
      coord_scalar<CP>(m, w, lane, s_lo, s_hi);
      const float s = row_value(s_lo, s_hi, lane);
      if (valid && lane < kRows) {
        ax0 = fmaf(rel[0], s, ax0);
        ax1 = fmaf(rel[1], s, ax1);
        ax2 = fmaf(rel[2], s, ax2);
      }
    }

    // sums over the edges: across the 8 quads for agg_m, across lanes for x
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        agg[n].x += __shfl_xor_sync(kFull, agg[n].x, o);
        agg[n].y += __shfl_xor_sync(kFull, agg[n].y, o);
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      ax0 += __shfl_xor_sync(kFull, ax0, o);
      ax1 += __shfl_xor_sync(kFull, ax1, o);
      ax2 += __shfl_xor_sync(kFull, ax2, o);
    }
    if (lane == 0) {
      x_out[(size_t)center * 3 + 0] = xi0 + ax0;
      x_out[(size_t)center * 3 + 1] = xi1 + ax1;
      x_out[(size_t)center * 3 + 2] = xi2 + ax2;
    }

    // --- node MLP on [h, Σ m] and residual; every row is the center's ---
    uint32_t an[2 * KS][4];
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) an[j][q] = ahi[j][q];
    {
      uint32_t aagg[KS][4];
      row_to_a<CP>(agg, aagg);
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) an[KS + j][q] = aagg[j][q];
    }
    float o1[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 b = vec2(w, L::bn0, n, t);
      o1[n][0] = o1[n][2] = b.x;
      o1[n][1] = o1[n][3] = b.y;
    }
    product<CP, 2 * KS>(o1, an, w, L::wn0, lane);
    float2 act[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) act[n] = make_float2(silu(o1[n][0]), silu(o1[n][1]));
    uint32_t aact[KS][4];
    row_to_a<CP>(act, aact);
    float o2[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 b = vec2(w, L::bn1, n, t);
      o2[n][0] = o2[n][2] = b.x;
      o2[n][1] = o2[n][3] = b.y;
    }
    product<CP, KS>(o2, aact, w, L::wn1, lane);
    // quad n writes the 8 channels of n-tile n (at CP = 32: 16 lanes, 128
    // contiguous bytes)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (g == n) {
        store2<CP>(h_out, center, c, n, t, make_float2(hi[n].x + o2[n][0], hi[n].y + o2[n][1]));
        if (aggm_out != nullptr) store2<CP>(aggm_out, center, c, n, t, agg[n]);
      }
    }
  }
}

// D [16, 8] f32 = A [16, 16] bf16 (row-major) · B, with B given as the 64
// words of one fragment block in the packed order: one bare tile, to hold the
// fragment layouts and the host's packing against a matrix product.
__global__ void mma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                                 const uint32_t* __restrict__ b, float* __restrict__ d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(a + g * 16) + t;
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(a + (g + 8) * 16) + t;
  const uint32_t af[4] = {lo[0], hi[0], lo[4], hi[4]};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  mma(acc, af, reinterpret_cast<const uint2*>(b)[lane]);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

template <int CP, bool DBG>
int launch(const float* h, const float* x, const int* nbr, const uint32_t* params,
           float* h_out, float* x_out, float* aggm_out, float* dbg, int B, int N, int K, int C,
           int wh, cudaStream_t stream) {
  const auto kernel = egcl_tile_kernel<CP, DBG>;
  const int smem = Smem<CP>::total * (int)sizeof(uint32_t);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int total = B * N;
  constexpr int kWarps = Fwd<CP>::kWarps;
  const int need = (total + kWarps - 1) / kWarps;
  const int grid = need < sms * 8 ? need : sms * 8;  // warps loop over centers
  kernel<<<grid, kWarps * 32, smem, stream>>>(h, x, nbr, params, h_out, x_out, aggm_out, dbg,
                                              total, N, K, C, wh);
  return (int)cudaGetLastError();
}

template <int CP>
int launch_width(const float* h, const float* x, const int* nbr, const uint32_t* params,
                 float* h_out, float* x_out, float* aggm_out, float* dbg, int B, int N, int K,
                 int C, int wh, cudaStream_t s) {
  return dbg != nullptr
             ? launch<CP, true>(h, x, nbr, params, h_out, x_out, aggm_out, dbg, B, N, K, C, wh, s)
             : launch<CP, false>(h, x, nbr, params, h_out, x_out, aggm_out, dbg, B, N, K, C, wh, s);
}

}  // namespace

// h [B,N,C], x [B,N,3] f32, nbr [B,N,K] int32, params: the packed buffer of
// ops/kernels/egcl.py::pack_params_tile at the width that runs C (32 for
// C = 32, 48 for 32 < C <= 36). Outputs h_out [B,N,C], x_out [B,N,3],
// agg_m [B,N,C] unless aggm_out is null, and the per-edge stages
// dbg [B,N,K,2 CP] unless dbg is null.
extern "C" int egcl_tile_launch(const void* h, const void* x, const void* nbr,
                                const void* params, void* h_out, void* x_out,
                                void* aggm_out, void* dbg, int B, int N, int K, int C,
                                int head_width, void* stream) {
  if (K < 1 || head_width < 1 || C % head_width) return (int)cudaErrorInvalidValue;
  const float* hf = static_cast<const float*>(h);
  const float* xf = static_cast<const float*>(x);
  const int* nb = static_cast<const int*>(nbr);
  const uint32_t* p = static_cast<const uint32_t*>(params);
  float* ho = static_cast<float*>(h_out);
  float* xo = static_cast<float*>(x_out);
  float* am = static_cast<float*>(aggm_out);
  float* db = static_cast<float*>(dbg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32) return launch_width<32>(hf, xf, nb, p, ho, xo, am, db, B, N, K, C, head_width, s);
  if (32 < C && C <= 36)
    return launch_width<kPadded>(hf, xf, nb, p, ho, xo, am, db, B, N, K, C, head_width, s);
  return (int)cudaErrorInvalidValue;
}

// a [16,16] bf16 row-major, b: one packed fragment block (64 words), d [16,8] f32.
extern "C" int egcl_tile_mma_probe(const void* a, const void* b, void* d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mma_probe_kernel<<<1, 32, 0, s>>>(static_cast<const __nv_bfloat16*>(a),
                                    static_cast<const uint32_t*>(b), static_cast<float*>(d));
  return (int)cudaGetLastError();
}
