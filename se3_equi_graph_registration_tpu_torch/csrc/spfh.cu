// Fused SPFH (Darboux-angle histograms) over a Hilbert-window neighbor table,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// spfh_kernel.py::_spfh_kernel (wrapper spfh_pallas). The function is the
// one documented in ops/kernels/spfh.py: per edge the Darboux angles
// (α, φ, θ), 3 × 11 bins, counts of valid edges scaled by 100 / (the valid
// count) per center, plus the edge distances with invalid edges zeroed.
//
// Design: the TPU kernel gathers neighbors with one-hot matmuls against the
// window slice, broadcasts centers through an iota-built map, and sums the
// [33, E] bin one-hots onto centers with one more matmul. Here the gathers
// are indexed loads: a block owns one tile of T centers and stages the
// tile's window [S, S + W) of x and normals in shared memory (an index
// outside it, which the window k-NN never gives, is read from device
// memory). One warp takes one center at a time, one lane per edge (K = 60:
// two passes of 32 lanes). The 33 bin counts are warp ballots: for each bin
// a __ballot_sync of "my edge is valid and falls here", __popc'd, so the
// histogram never leaves registers and needs no atomics.
//
// What bounds it: per edge ~150 fp32 operations, 6 stores of distance
// bytes amortised, the nbr load; at B = 64 clouds, N = 2048, K = 60 that is
// ~1.2 GFLOP and ~100 MB (nbr in, dist and SPFH out): bytes and operations
// are both tens of microseconds at peak. The per-edge chain of dependent
// divides and square roots and the 33 ballots per pass are what cost.
//
// Numerics: every product and sum is rounded on its own (__fmul_rn etc.,
// no FMA contraction), sqrt and division are IEEE, in the order of the
// plain version (ops/kernels/spfh.py::spfh_plain), so the two agree bit for
// bit. θ uses the TPU kernel's sector half-plane tests; the 12 boundary
// (cos, sin) pairs come from the wrapper as float32.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 11;
constexpr int kWarps = 8;

struct Sector {
  float cs[kBins + 1];
  float sn[kBins + 1];
};

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__device__ __forceinline__ int bin_of(float v) {
  float t = __fdiv_rn(__fadd_rn(v, 1.0f), 2.0f);
  t = fminf(fmaxf(t, 0.0f), (float)(1.0 - 1e-7));
  return (int)floorf(__fmul_rn(t, (float)kBins));
}

__global__ void spfh_kernel(const float* __restrict__ x, const float* __restrict__ nrm,
                            const int* __restrict__ nbr, float* __restrict__ spfh,
                            float* __restrict__ dist_out, Sector sec, int N, int K,
                            int T, int W, int pad_tiles, int max_tile) {
  extern __shared__ float smem[];  // window: x then normals, [W][3] each
  float* wx = smem;
  float* wn = smem + 3 * W;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int S = max(0, min(tile - pad_tiles, max_tile)) * T;
  const float* xb = x + (size_t)b * N * 3;
  const float* nb = nrm + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < 3 * W; j += blockDim.x) {
    wx[j] = xb[(size_t)S * 3 + j];
    wn[j] = nb[(size_t)S * 3 + j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < T; r += kWarps) {
    const int i = tile * T + r;
    const float* pi = xb + (size_t)i * 3;
    const float* ni = nb + (size_t)i * 3;
    const float px = pi[0], py = pi[1], pz = pi[2];
    const float ix = ni[0], iy = ni[1], iz = ni[2];
    int ha = 0, hp = 0, ht = 0, total = 0;  // lane b < 11 holds bin b
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool active = k < K;
      bool valid = false;
      int ba = -1, bp = -1, tmask = 0;
      if (active) {
        const int j = nbr[((size_t)b * N + i) * K + k];
        const int l = j - S;
        const float* pj = (l >= 0 && l < W) ? wx + 3 * l : xb + (size_t)j * 3;
        const float* nj = (l >= 0 && l < W) ? wn + 3 * l : nb + (size_t)j * 3;
        const float jx = nj[0], jy = nj[1], jz = nj[2];
        const float dx = __fsub_rn(pj[0], px), dy = __fsub_rn(pj[1], py),
                    dz = __fsub_rn(pj[2], pz);
        const float d2 = dot3(dx, dy, dz, dx, dy, dz);
        valid = d2 > 1e-12f;
        const float dist = sqrtf(d2);
        const float den = __fadd_rn(dist, 1e-12f);
        const float hx = __fdiv_rn(dx, den), hy = __fdiv_rn(dy, den), hz = __fdiv_rn(dz, den);
        const bool take_i = fabsf(dot3(ix, iy, iz, hx, hy, hz)) >= fabsf(dot3(jx, jy, jz, hx, hy, hz));
        const float ux = take_i ? ix : jx, uy = take_i ? iy : jy, uz = take_i ? iz : jz;
        const float tx_ = take_i ? jx : ix, ty_ = take_i ? jy : iy, tz_ = take_i ? jz : iz;
        const float ex = take_i ? hx : -hx, ey = take_i ? hy : -hy, ez = take_i ? hz : -hz;
        float vx = __fsub_rn(__fmul_rn(ey, uz), __fmul_rn(ez, uy));
        float vy = __fsub_rn(__fmul_rn(ez, ux), __fmul_rn(ex, uz));
        float vz = __fsub_rn(__fmul_rn(ex, uy), __fmul_rn(ey, ux));
        const float vden = __fadd_rn(sqrtf(__fadd_rn(dot3(vx, vy, vz, vx, vy, vz), 1e-24f)), 1e-12f);
        vx = __fdiv_rn(vx, vden); vy = __fdiv_rn(vy, vden); vz = __fdiv_rn(vz, vden);
        const float wx_ = __fsub_rn(__fmul_rn(uy, vz), __fmul_rn(uz, vy));
        const float wy_ = __fsub_rn(__fmul_rn(uz, vx), __fmul_rn(ux, vz));
        const float wz_ = __fsub_rn(__fmul_rn(ux, vy), __fmul_rn(uy, vx));
        const float alpha = dot3(vx, vy, vz, tx_, ty_, tz_);
        const float phi = dot3(ux, uy, uz, ex, ey, ez);
        const float ty = dot3(wx_, wy_, wz_, tx_, ty_, tz_);
        const float tx = dot3(ux, uy, uz, tx_, ty_, tz_);
        ba = bin_of(alpha);
        bp = bin_of(phi);
        bool prev = __fsub_rn(__fmul_rn(sec.cs[0], ty), __fmul_rn(sec.sn[0], tx)) >= 0.0f;
#pragma unroll
        for (int q = 0; q < kBins; ++q) {
          const float c = __fsub_rn(__fmul_rn(sec.cs[q + 1], ty), __fmul_rn(sec.sn[q + 1], tx));
          if (prev && c < 0.0f) tmask |= 1 << q;
          prev = c >= 0.0f;
        }
        dist_out[((size_t)b * N + i) * K + k] = valid ? dist : 0.0f;
      }
      const bool on = active && valid;
#pragma unroll
      for (int q = 0; q < kBins; ++q) {
        const int ca = __popc(__ballot_sync(0xffffffffu, on && ba == q));
        const int cp = __popc(__ballot_sync(0xffffffffu, on && bp == q));
        const int ct = __popc(__ballot_sync(0xffffffffu, on && ((tmask >> q) & 1)));
        total += ca;
        if (lane == q) { ha += ca; hp += cp; ht += ct; }
      }
    }
    // 100 / total as the plain version rounds it: the reciprocal, then the product
    const float scale = __fmul_rn(__frcp_rn(fmaxf((float)total, 1e-6f)), 100.0f);
    if (lane < kBins) {
      float* o = spfh + ((size_t)b * N + i) * (3 * kBins);
      o[lane] = __fmul_rn((float)ha, scale);
      o[kBins + lane] = __fmul_rn((float)hp, scale);
      o[2 * kBins + lane] = __fmul_rn((float)ht, scale);
    }
  }
}

}  // namespace

// x, normals [B, N, 3] f32; nbr [B, N, K] int32 (global ids); spfh [B, N, 33]
// and dist [B, N, K] f32 out; sector: host float[24], cos then sin of the 12
// θ bin boundaries.
extern "C" int spfh_launch(const void* x, const void* normals, const void* nbr, void* spfh,
                           void* dist, const void* sector, int B, int N, int K, int T,
                           int W, int pad_tiles, int max_tile, void* stream) {
  Sector sec;
  const float* s = static_cast<const float*>(sector);
  for (int q = 0; q <= kBins; ++q) {
    sec.cs[q] = s[q];
    sec.sn[q] = s[kBins + 1 + q];
  }
  const size_t smem = 6 * (size_t)W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(spfh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / T, B);
  spfh_kernel<<<grid, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(normals),
      static_cast<const int*>(nbr), static_cast<float*>(spfh), static_cast<float*>(dist), sec,
      N, K, T, W, pad_tiles, max_tile);
  return (int)cudaGetLastError();
}

// Resident blocks an SM holds at this geometry (K does not change the
// kernel), and blocks in the grid.
extern "C" int spfh_occupancy(int B, int N, int K, int T, int W, int* blocks_per_sm,
                              int* grid_blocks) {
  (void)K;
  *grid_blocks = N / T * B;
  const size_t smem = 6 * (size_t)W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(spfh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, spfh_kernel,
                                                            32 * kWarps, smem);
}
