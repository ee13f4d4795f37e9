// One fused EGCL layer ('center' direction, 'frame' so3 mode), forward,
// accurate mode (fp32), for Hopper (sm_90a), on fp32 register-blocked edge
// tiles, built at two channel widths (egcl_tile_f32.cuh): CP = 32 for C = 32
// and CP = 36 for 32 < C <= 36 (KITTI's C = 33, pads zero).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_kernel.py::_egcl_kernel (wrappers egcl_layer_pallas,
// egnn_forward_pallas) in accurate mode at those widths with whole heads:
// h [B, N, C] f32, x [B, N, 3] f32, nbr [B, N, K] int32 with every index in
// [0, N) -> h', x' and, when asked, agg_m (the message sum before the node
// MLP, which the backward needs). It computes what egcl.cu computes in
// ACCURATE mode, in another order of the fp32 sums; egcl.cu stays for fast
// mode at C != 32 and for the other widths.
//
// What bounds it: the useful work is ~6.3 kFLOP an edge at C = 32, 4 heads
// (~8.3 at C = 33, one head) against 4·(C+4) gathered bytes, so fp32 operations:
// 0.198 ms at B=64, C=32 on the fp32 pipes. egcl.cu issued each FMA with two
// shared-memory loads (a weight and a broadcast activation), one edge after
// another: it could reach ~1/8 of the fp32 peak, and at C = 33 its lane l
// holds channels l and l + 32, one live lane of 32 in the second pass. Here
// the 16 edges of a center are the 16 rows of a tile (egcl_tile_f32.cuh):
//   - a center's edges are staged in parallel: one lane an edge for the
//     neighbor index, x_j and the 12 geometry values, all lanes for the
//     16 gathered h_j rows, into an fp32 tile [16][kTS] per warp;
//   - every product is register-blocked, 4 rows x CP / 8 channels a lane;
//     the h_row block is one product per center and the accumulators'
//     initial value; at CP = 32 the head layer reads only its heads' inputs;
//   - LayerNorm and the coordinate scalar reduce across the 8 lanes of a
//     row, the sums over edges across the 4 row groups, by shuffles;
//   - the node MLP runs once per center, each row group taking a quarter of
//     the inputs.
// The padded width issues 20 FFMA a lane an input (40 channel slots, 33
// real) over 36 inputs: 1.32x the products of C = 33. K other than 16 runs as row tiles of 16 with the rows
// at or beyond K masked out of every sum.

#include "egcl_tile_f32.cuh"

namespace {

using namespace egcl_f32;

// Warps (centers in flight) per block and blocks per SM: the register budget,
// 128 a thread, at both widths; at CP = 36 one block of 16 warps (the
// shared memory, 160 KB).
template <int CP>
struct Fwd {
  static constexpr int kWarps = CP == 32 ? 8 : 16;
  static constexpr int kBlocksPerSM = CP == 32 ? 2 : 1;
};

// Word offsets in dynamic shared memory: the weights, then per warp the
// staged tile [16][kTS], the activation tile [16][kXS] (s1, then m) and the
// node MLP's vectors [h_i CP | agg_m CP | hidden CP].
template <int CP>
struct Smem {
  static constexpr int warps = Layout<CP>::total;
  static constexpr int act = kRows * Dims<CP>::kTS;
  static constexpr int vec = act + kRows * Dims<CP>::kXS;
  static constexpr int per_warp = vec + 3 * CP;
  static constexpr int total = warps + Fwd<CP>::kWarps * per_warp;
  static_assert(warps % 4 == 0 && per_warp % 4 == 0, "16-byte aligned tiles");
  static_assert(total * 4 <= 232448, "the shared memory of a block");
};

template <int CP>
__global__ void __launch_bounds__(Fwd<CP>::kWarps * 32, Fwd<CP>::kBlocksPerSM)
egcl_tile_f32_kernel(const float* __restrict__ h, const float* __restrict__ x,
                     const int* __restrict__ nbr, const float* __restrict__ params,
                     float* __restrict__ h_out, float* __restrict__ x_out,
                     float* __restrict__ aggm_out, int total, int N, int K, int c_arg, int wh) {
  using D = Dims<CP>;
  using L = Layout<CP>;
  constexpr int NJ = D::kJ;
  const int c = CP == 32 ? 32 : c_arg;   // the true width
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  for (int i = threadIdx.x; i < L::total / 4; i += blockDim.x)
    reinterpret_cast<float4*>(w)[i] = reinterpret_cast<const float4*>(params)[i];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const bool tail = cg < Dims<CP>::kTail && 32 + cg < c;   // this lane owns channel 32 + cg
                                                           // and it is real (CP > 32)
  float* T = smem + Smem<CP>::warps + warp * Smem<CP>::per_warp;
  float* X = T + Smem<CP>::act;
  float* V = T + Smem<CP>::vec;
  if constexpr (CP != 32)               // the pad columns of h_col, never staged
    for (int i = lane; i < kRows * D::kTS; i += 32) T[i] = 0.f;
  __syncthreads();

  for (int center = blockIdx.x * Fwd<CP>::kWarps + warp; center < total;
       center += gridDim.x * Fwd<CP>::kWarps) {
    const int base = center - center % N;          // b·N
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];
    float hr[NJ];
    hrow_block<CP>(h, center, c, w, rg, cg, hr);

    float agg[NJ];   // Σ m over this lane's rows, this lane's channels
#pragma unroll
    for (int j = 0; j < NJ; ++j) agg[j] = 0.f;
    float ax0 = 0.f, ax1 = 0.f, ax2 = 0.f;

    for (int row0 = 0; row0 < K; row0 += kRows) {
      float rel[3];
      stage_edges<CP>(h, x, nbr, center, base, K, row0, xi0, xi1, xi2, T, lane, rel, c);
      float a[4][NJ];
      first_layer_pre<CP>(T, hr, w, rg, cg, a);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) a[i][j] = silu(a[i][j]);
      store_rows<CP>(a, X, rg, cg);
      __syncwarp();
      head_layer<CP>(X, w, wh, rg, cg, a);
      float r[4];
      normalize<CP>(a, r, c, tail);
      ln_affine<CP>(a, w, cg, a);
      __syncwarp();   // every lane has read s1
      store_rows<CP>(a, X, rg, cg);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (row0 + rg + 4 * i < K) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) agg[j] += a[i][j];
        }
      }
      coord_pre<CP>(X, w, rg, cg, a);
      float s[4];
      coord_sum<CP>(a, w, cg, s);
      // lane (rg, cg < 4) adds row rg + 4cg's rel · s
      const int row = rg + 4 * cg;
      if (cg < 4 && row0 + row < K) {
        const float sv = pick(s, cg);
        const float* rr = T + row * D::kTS + D::kRel;
        ax0 = fmaf(rr[0], sv, ax0);
        ax1 = fmaf(rr[1], sv, ax1);
        ax2 = fmaf(rr[2], sv, ax2);
      }
    }

#pragma unroll
    for (int j = 0; j < NJ; ++j) agg[j] = group_sum(agg[j]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      ax0 += __shfl_xor_sync(kFull, ax0, o);
      ax1 += __shfl_xor_sync(kFull, ax1, o);
      ax2 += __shfl_xor_sync(kFull, ax2, o);
    }
    if (lane == 0) {
      x_out[(size_t)center * 3 + 0] = xi0 + ax0;
      x_out[(size_t)center * 3 + 1] = xi1 + ax1;
      x_out[(size_t)center * 3 + 2] = xi2 + ax2;
    }

    // --- node MLP on [h_i, Σ m] and residual; row group rg sums inputs
    // CP/2 rg .. CP/2 rg + CP/2 - 1 of the first layer and CP/4 rg ..
    // CP/4 rg + CP/4 - 1 of the second ---
    float hi[NJ];
    load_row<CP>(h, center, c, cg, hi);
    if (rg == 0) store_vec<CP>(V, hi, cg);
    if (rg == 1) store_vec<CP>(V + CP, agg, cg);
    __syncwarp();
    float o[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[j] = 0.f;
    vec_product<CP, CP / 2>(o, V + CP / 2 * rg, w + L::wn0 + CP / 2 * rg * CP, cg);
    {
      float b[NJ], act[NJ];
      vec<CP>(w, L::bn0, cg, b);
#pragma unroll
      for (int j = 0; j < NJ; ++j) act[j] = silu(group_sum(o[j]) + b[j]);
      if (rg == 0) store_vec<CP>(V + 2 * CP, act, cg);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[j] = 0.f;
    vec_product<CP, CP / 4>(o, V + 2 * CP + CP / 4 * rg, w + L::wn1 + CP / 4 * rg * CP, cg);
    float b[NJ], out[NJ];
    vec<CP>(w, L::bn1, cg, b);
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[j] = hi[j] + (group_sum(o[j]) + b[j]);
    if (rg == 0) {
      store_row<CP>(h_out, center, c, cg, out);
      if (aggm_out != nullptr) store_row<CP>(aggm_out, center, c, cg, agg);
    }
    __syncwarp();   // V is read before the next center writes it
  }
}

template <int CP>
int launch(const void* h, const void* x, const void* nbr, const void* params, void* h_out,
           void* x_out, void* aggm_out, int B, int N, int K, int C, int head_width,
           cudaStream_t s) {
  const auto kernel = egcl_tile_f32_kernel<CP>;
  const int smem = Smem<CP>::total * (int)sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int total = B * N;
  const int need = (total + Fwd<CP>::kWarps - 1) / Fwd<CP>::kWarps;
  const int cap = sms * Fwd<CP>::kBlocksPerSM * 4;   // warps loop over centers
  const int grid = need < cap ? need : cap;
  const int threads = Fwd<CP>::kWarps * 32;
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(x), static_cast<const int*>(nbr),
      static_cast<const float*>(params), static_cast<float*>(h_out), static_cast<float*>(x_out),
      static_cast<float*>(aggm_out), total, N, K, C, head_width);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B,N,C], x [B,N,3] f32, nbr [B,N,K] int32, params: the buffer of
// ops/kernels/egcl.py::pack_params_f32 at the width that runs C (32 for
// C = 32, 36 for 32 < C <= 36). Outputs h_out [B,N,C], x_out [B,N,3], and
// agg_m [B,N,C] unless aggm_out is null.
extern "C" int egcl_tile_f32_launch(const void* h, const void* x, const void* nbr,
                                    const void* params, void* h_out, void* x_out,
                                    void* aggm_out, int B, int N, int K, int C, int head_width,
                                    void* stream) {
  if (K < 1 || head_width < 1 || C % head_width) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32)
    return launch<32>(h, x, nbr, params, h_out, x_out, aggm_out, B, N, K, C, head_width, s);
  if (32 < C && C <= kPadded)
    return launch<kPadded>(h, x, nbr, params, h_out, x_out, aggm_out, B, N, K, C, head_width, s);
  return (int)cudaErrorInvalidValue;
}
