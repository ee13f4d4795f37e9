// One fused EGCL layer ('center' direction, 'frame' so3 mode), forward,
// accurate mode (fp32) at C = 32, for Hopper (sm_90a), on fp32 register-blocked
// edge tiles.
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_kernel.py::_egcl_kernel (wrappers egcl_layer_pallas,
// egnn_forward_pallas) in accurate mode for the default shape: h [B, N, 32]
// f32, x [B, N, 3] f32, nbr [B, N, K] int32 with every index in [0, N) ->
// h', x' and, when asked, agg_m (the message sum before the node MLP, which
// the backward needs). It computes what egcl.cu computes in ACCURATE mode,
// in another order of the fp32 sums; egcl.cu stays for other widths.
//
// What bounds it: the useful work is ~6.3 kFLOP an edge against 4·(C+4)
// gathered bytes, so fp32 operations: 0.198 ms at B=64 on the fp32 pipes.
// egcl.cu issued each FMA with two shared-memory loads (a weight and a
// broadcast activation), one edge after another: it could reach ~1/8 of the
// fp32 peak. Here the 16 edges of a center are the 16 rows of a tile
// (egcl_tile_f32.cuh):
//   - a center's edges are staged in parallel: one lane an edge for the
//     neighbor index, x_j and the 12 geometry values, all lanes for the
//     16 x 128-byte h_j rows, into an fp32 tile [16][52] per warp;
//   - every product is register-blocked, 4 rows x 4 channels a lane, 8 FFMA
//     a shared load; the h_row block is one product per center and the
//     accumulators' initial value; the head layer reads only its heads'
//     inputs;
//   - LayerNorm and the coordinate scalar reduce across the 8 lanes of a
//     row, the sums over edges across the 4 row groups, by shuffles;
//   - the node MLP runs once per center, each row group taking a quarter of
//     the inputs.
// K other than 16 runs as row tiles of 16 with the rows at or beyond K masked
// out of every sum.

#include "egcl_tile_f32.cuh"

namespace {

using namespace egcl_f32;

constexpr int kWarps = 8;        // warps (centers in flight) per block
constexpr int kBlocksPerSM = 2;  // the register budget: 128 a thread

// Word offsets in dynamic shared memory: the weights, then per warp the
// staged tile [16][kTS], the activation tile [16][kXS] (s1, then m) and the
// node MLP's vectors [h_i 32 | agg_m 32 | hidden 32].
struct Smem {
  static constexpr int warps = Layout::total;
  static constexpr int act = kRows * kTS;
  static constexpr int vec = act + kRows * kXS;
  static constexpr int per_warp = vec + 3 * kC;
  static constexpr int total = warps + kWarps * per_warp;
};
static_assert(Smem::warps % 4 == 0 && Smem::per_warp % 4 == 0, "16-byte aligned tiles");

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
egcl_tile_f32_kernel(const float* __restrict__ h, const float* __restrict__ x,
                     const int* __restrict__ nbr, const float* __restrict__ params,
                     float* __restrict__ h_out, float* __restrict__ x_out,
                     float* __restrict__ aggm_out, int total, int N, int K, int wh) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  for (int i = threadIdx.x; i < Layout::total / 4; i += blockDim.x)
    reinterpret_cast<float4*>(w)[i] = reinterpret_cast<const float4*>(params)[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  float* T = smem + Smem::warps + warp * Smem::per_warp;
  float* X = T + Smem::act;
  float* V = T + Smem::vec;

  for (int center = blockIdx.x * kWarps + warp; center < total;
       center += gridDim.x * kWarps) {
    const int base = center - center % N;          // b·N
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];
    const float4 hr = hrow_block(h, center, w, rg, cg);

    float agg[4] = {0.f, 0.f, 0.f, 0.f};   // Σ m over this lane's rows, channels 4cg + j
    float ax0 = 0.f, ax1 = 0.f, ax2 = 0.f;

    for (int row0 = 0; row0 < K; row0 += kRows) {
      float rel[3];
      stage_edges(h, x, nbr, center, base, K, row0, xi0, xi1, xi2, T, lane, rel);
      float a[4][4];
      first_layer_pre(T, hr, w, rg, cg, a);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = silu(a[i][j]);
      store_rows(a, X, rg, cg);
      __syncwarp();
      head_layer(X, w, wh, rg, cg, a);
      float r[4];
      normalize(a, r);
      ln_affine(a, w, cg, a);
      __syncwarp();   // every lane has read s1
      store_rows(a, X, rg, cg);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (row0 + rg + 4 * i < K) {
#pragma unroll
          for (int j = 0; j < 4; ++j) agg[j] += a[i][j];
        }
      }
      coord_pre(X, w, rg, cg, a);
      float s[4];
      coord_sum(a, w, cg, s);
      // lane (rg, cg < 4) adds row rg + 4cg's rel · s
      const int row = rg + 4 * cg;
      if (cg < 4 && row0 + row < K) {
        const float sv = pick(s, cg);
        const float* rr = T + row * kTS + kRel;
        ax0 = fmaf(rr[0], sv, ax0);
        ax1 = fmaf(rr[1], sv, ax1);
        ax2 = fmaf(rr[2], sv, ax2);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) agg[j] = group_sum(agg[j]);
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
    // 16 rg .. 16 rg + 15 of the first layer and 8 rg .. 8 rg + 7 of the second ---
    const float4 hi = *reinterpret_cast<const float4*>(h + (size_t)center * kC + 4 * cg);
    if (rg == 0) *reinterpret_cast<float4*>(V + 4 * cg) = hi;
    if (rg == 1) *reinterpret_cast<float4*>(V + kC + 4 * cg) = make_float4(agg[0], agg[1], agg[2], agg[3]);
    __syncwarp();
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 16; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(V + 16 * rg + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float vq = comp(v, q);
        const float4 wv = vec4(w, Layout::wn0 + (16 * rg + k + q) * kC, cg);
        o[0] = fmaf(vq, wv.x, o[0]);
        o[1] = fmaf(vq, wv.y, o[1]);
        o[2] = fmaf(vq, wv.z, o[2]);
        o[3] = fmaf(vq, wv.w, o[3]);
      }
    }
    {
      const float4 b = vec4(w, Layout::bn0, cg);
      const float4 act = make_float4(silu(group_sum(o[0]) + b.x), silu(group_sum(o[1]) + b.y),
                                     silu(group_sum(o[2]) + b.z), silu(group_sum(o[3]) + b.w));
      if (rg == 0) *reinterpret_cast<float4*>(V + 2 * kC + 4 * cg) = act;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 8; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(V + 2 * kC + 8 * rg + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float vq = comp(v, q);
        const float4 wv = vec4(w, Layout::wn1 + (8 * rg + k + q) * kC, cg);
        o[0] = fmaf(vq, wv.x, o[0]);
        o[1] = fmaf(vq, wv.y, o[1]);
        o[2] = fmaf(vq, wv.z, o[2]);
        o[3] = fmaf(vq, wv.w, o[3]);
      }
    }
    const float4 b = vec4(w, Layout::bn1, cg);
    const float4 out = make_float4(hi.x + (group_sum(o[0]) + b.x), hi.y + (group_sum(o[1]) + b.y),
                                   hi.z + (group_sum(o[2]) + b.z), hi.w + (group_sum(o[3]) + b.w));
    if (rg == 0) {
      const size_t at = (size_t)center * kC + 4 * cg;
      *reinterpret_cast<float4*>(h_out + at) = out;
      if (aggm_out != nullptr)
        *reinterpret_cast<float4*>(aggm_out + at) = make_float4(agg[0], agg[1], agg[2], agg[3]);
    }
    __syncwarp();   // V is read before the next center writes it
  }
}

}  // namespace

// h [B,N,32], x [B,N,3] f32, nbr [B,N,K] int32, params: the buffer of
// ops/kernels/egcl.py::pack_params_f32. Outputs h_out [B,N,32], x_out
// [B,N,3], and agg_m [B,N,32] unless aggm_out is null.
extern "C" int egcl_tile_f32_launch(const void* h, const void* x, const void* nbr,
                                    const void* params, void* h_out, void* x_out,
                                    void* aggm_out, int B, int N, int K, int head_width,
                                    void* stream) {
  if (K < 1 || head_width < 1 || kC % head_width) return (int)cudaErrorInvalidValue;
  const int smem = Smem::total * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      egcl_tile_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int total = B * N;
  const int need = (total + kWarps - 1) / kWarps;
  const int cap = sms * kBlocksPerSM * 4;   // warps loop over centers
  const int grid = need < cap ? need : cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  egcl_tile_f32_kernel<<<grid, kWarps * 32, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(x), static_cast<const int*>(nbr),
      static_cast<const float*>(params), static_cast<float*>(h_out), static_cast<float*>(x_out),
      static_cast<float*>(aggm_out), total, N, K, head_width);
  return (int)cudaGetLastError();
}
