// Fused SPFH (Darboux-angle histograms) over a Hilbert-window neighbor table,
// for Hopper (sm_90a): bin counts packed in registers and summed by warp
// reductions.
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// spfh_kernel.py::_spfh_kernel (wrapper spfh_pallas), as csrc/spfh.cu did;
// that kernel (bins counted by 66 warp ballots a center) stays beside it to
// compare. The function is the one documented in ops/kernels/spfh.py: per
// edge the Darboux angles (α, φ, θ), 3 × 11 bins, counts of valid edges
// scaled by 100 / (the valid count) per center, plus the edge distances with
// invalid edges zeroed.
//
// What bounds it on this card: bytes. At B = 64 clouds, N = 2048, K = 60 it
// must move ~83 MB (nbr in, dist and SPFH out: 25 µs at 3.35 TB/s) and do
// ~150 fp32 operations an edge (18 µs at 67 TFLOP/s). Its time goes to
// issuing a chain of ~300 dependent instructions an edge, IEEE divides and
// square roots among them, and the histogram. The design cuts the histogram
// to a few instructions an edge and gives each lane two independent chains.
//
// Design: a block of 16 warps owns one tile of T centers and stages the
// tile's window [S, S + W) of x and normals in shared memory, rounded to
// bf16 there in fast mode (as `.to(torch.bfloat16)` rounds: to nearest
// even), so fast mode costs no launch of its own; the center is read from
// the same window (it always lies in it). One warp takes one center at a
// time, in passes of 32·E edges: lane l takes edges l + 32·e, e < E, with
// E = 2 once K passes 32 (K = 60: one pass a center, two chains a lane for
// the scheduler to interleave), and loads the next pass's neighbor ids
// before its chains. Each lane keeps its edges' 33 bin counts packed in
// registers: fields of FB bits (6 for K ≤ 63, 8 for K ≤ 255, 16 beyond),
// FPW = 32 / FB fields a word, the α, φ and θ bins in one sequence (7 words
// at FB = 6). An edge's hits form one 33-bit vector (its α bin, its φ bin,
// its θ mask, which may hold 0 or 2 bits at fp noise), and each word adds
// its slice of it with the FPW bits spread FB apart by one multiply (the
// partial products land on distinct bits, so nothing carries). The warp
// then sums each word once per center with __reduce_add_sync: 7 reductions
// a center in place of 66 ballots and popcounts. A field's warp sum is at
// most K, so it never carries into the next. The block shape, E and the
// prefetch were chosen by timing the alternatives (spfh_sweep.py).
//
// Numerics: every product and sum is rounded on its own (__fmul_rn etc.,
// no FMA contraction), sqrt and division are IEEE, in the order of the
// plain version (ops/kernels/spfh.py::spfh_plain), so the two agree bit for
// bit. The bin of t = (v + 1) / 2 is taken as (v + 1) · 0.5: both are the
// correctly rounded value of the same real number. θ uses the TPU kernel's
// sector half-plane tests; the 12 boundary (cos, sin) pairs come from the
// wrapper as float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBins = 11;
constexpr int kFields = 3 * kBins;   // α bins 0-10, φ 11-21, θ 22-32
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;

struct Sector {
  float cs[kBins + 1];
  float sn[kBins + 1];
};

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__device__ __forceinline__ int bin_of(float v) {
  float t = __fmul_rn(__fadd_rn(v, 1.0f), 0.5f);
  t = fminf(fmaxf(t, 0.0f), (float)(1.0 - 1e-7));
  return (int)floorf(__fmul_rn(t, (float)kBins));
}

// v, or v rounded to bf16 (round to nearest even) and back
__device__ __forceinline__ float input(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The packed counts: FB-bit fields, FPW a word, NW words for the 33 bins.
template <int FB>
struct Packed {
  static constexpr int FPW = 32 / FB;
  static constexpr int NW = (kFields + FPW - 1) / FPW;
  static constexpr unsigned kFieldMask = (1u << FB) - 1u;
  // x's FPW low bits moved to bits 0, FB, 2·FB, ...: bit i of x times
  // 2^((FB−1)·j) lands on bit i + (FB−1)·j, distinct for every (i, j)
  // because FPW ≤ FB − 1, so the product has no carries; the mask keeps j = i.
  static_assert(FPW <= FB - 1, "the spread multiply needs FPW <= FB - 1");
  static constexpr unsigned ones(int step) {
    unsigned m = 0;
    for (int j = 0; j < FPW; ++j) m |= 1u << (step * j);
    return m;
  }
  static constexpr unsigned kSpreadMul = ones(FB - 1);
  static constexpr unsigned kSpreadMask = ones(FB);

  // add one edge's hit vector (bit f set: the edge falls in bin f)
  static __device__ __forceinline__ void add(unsigned (&cnt)[NW], uint64_t hits) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const unsigned x = (unsigned)(hits >> (j * FPW)) & ((1u << FPW) - 1u);
      cnt[j] += (x * kSpreadMul) & kSpreadMask;
    }
  }
  // field f of the packed words, f known at compile time
  static __device__ __forceinline__ unsigned field(const unsigned (&cnt)[NW], int f) {
    return (cnt[f / FPW] >> (FB * (f % FPW))) & kFieldMask;
  }
};

// One edge of center i (x p, normal n_i) to neighbor j: the edge's hit
// vector (bit f set: it falls in bin f; 0 when the edge is invalid) and its
// distance (0 when invalid). The neighbor comes from the staged window, or
// from device memory when it lies outside it.
__device__ __forceinline__ uint64_t edge_hits(const float* wx, const float* wn, const float* xb,
                                              const float* nb, int j, int S, int W, bool bf16,
                                              float px, float py, float pz, float ix, float iy,
                                              float iz, const Sector& sec, float& dist_out) {
  const int l = j - S;
  float qx, qy, qz, jx, jy, jz;
  if (l >= 0 && l < W) {
    qx = wx[3 * l]; qy = wx[3 * l + 1]; qz = wx[3 * l + 2];
    jx = wn[3 * l]; jy = wn[3 * l + 1]; jz = wn[3 * l + 2];
  } else {                         // outside the window (never from the window k-NN)
    const float* pj = xb + (size_t)j * 3;
    const float* nj = nb + (size_t)j * 3;
    qx = input(pj[0], bf16); qy = input(pj[1], bf16); qz = input(pj[2], bf16);
    jx = input(nj[0], bf16); jy = input(nj[1], bf16); jz = input(nj[2], bf16);
  }
  const float dx = __fsub_rn(qx, px), dy = __fsub_rn(qy, py), dz = __fsub_rn(qz, pz);
  const float d2 = dot3(dx, dy, dz, dx, dy, dz);
  const bool valid = d2 > 1e-12f;
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
  unsigned tmask = 0;
  bool prev = __fsub_rn(__fmul_rn(sec.cs[0], ty), __fmul_rn(sec.sn[0], tx)) >= 0.0f;
#pragma unroll
  for (int q = 0; q < kBins; ++q) {
    const float cq = __fsub_rn(__fmul_rn(sec.cs[q + 1], ty), __fmul_rn(sec.sn[q + 1], tx));
    if (prev && cq < 0.0f) tmask |= 1u << q;
    prev = cq >= 0.0f;
  }
  dist_out = valid ? dist : 0.0f;
  return valid ? (uint64_t(1) << bin_of(alpha)) | (uint64_t(1) << (kBins + bin_of(phi))) |
                     (uint64_t(tmask) << (2 * kBins))
               : 0;
}

template <int FB, int kEdges>
__global__ void __launch_bounds__(kThreads)
spfh_redux_kernel(const float* __restrict__ x, const float* __restrict__ nrm,
                  const int* __restrict__ nbr, float* __restrict__ spfh,
                  float* __restrict__ dist_out, Sector sec, int N, int K, int T, int W,
                  int pad_tiles, int max_tile, bool bf16) {
  using P = Packed<FB>;
  extern __shared__ float smem[];  // window: x then normals, [W][3] each
  float* wx = smem;
  float* wn = smem + 3 * W;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int S = max(0, min(tile - pad_tiles, max_tile)) * T;
  const float* xb = x + (size_t)b * N * 3;
  const float* nb = nrm + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < 3 * W; j += blockDim.x) {
    wx[j] = input(xb[(size_t)S * 3 + j], bf16);
    wn[j] = input(nb[(size_t)S * 3 + j], bf16);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* nbr_b = nbr + (size_t)b * N * K;
  // The warp's passes: centers r = warp, warp + kWarps, ... < T of the tile,
  // each in passes of 32·kEdges edges, edge k0 + lane + 32·e in lane `lane`.
  // Each pass loads the next pass's neighbor ids before its own chains, so
  // the loads' latency hides behind them. A lane past K runs its chain on
  // the center itself (an invalid edge: no hit) and stores nothing.
  int r = warp, k0 = 0;
  int j_next[kEdges];
#pragma unroll
  for (int e = 0; e < kEdges; ++e)
    j_next[e] = (r < T && lane + 32 * e < K) ? nbr_b[(size_t)(tile * T + r) * K + lane + 32 * e]
                                               : 0;
  float px = 0.0f, py = 0.0f, pz = 0.0f, ix = 0.0f, iy = 0.0f, iz = 0.0f;
  unsigned cnt[P::NW];
  while (r < T) {
    const int i = tile * T + r;
    if (k0 == 0) {                 // a new center: it lies in its tile's window
      const int c = 3 * (i - S);
      px = wx[c]; py = wx[c + 1]; pz = wx[c + 2];
      ix = wn[c]; iy = wn[c + 1]; iz = wn[c + 2];
#pragma unroll
      for (int q = 0; q < P::NW; ++q) cnt[q] = 0u;
    }
    int j[kEdges];
#pragma unroll
    for (int e = 0; e < kEdges; ++e) j[e] = k0 + lane + 32 * e < K ? j_next[e] : i;
    int rn = r, kn = k0 + 32 * kEdges;
    if (kn >= K) { rn = r + kWarps; kn = 0; }
#pragma unroll
    for (int e = 0; e < kEdges; ++e)
      if (rn < T && kn + lane + 32 * e < K)
        j_next[e] = nbr_b[(size_t)(tile * T + rn) * K + kn + lane + 32 * e];
#pragma unroll
    for (int e = 0; e < kEdges; ++e) {
      const int k = k0 + lane + 32 * e;
      float dist;
      P::add(cnt, edge_hits(wx, wn, xb, nb, j[e], S, W, bf16, px, py, pz, ix, iy, iz, sec, dist));
      if (k < K) dist_out[((size_t)b * N + i) * K + k] = dist;
    }
    if (kn == 0) {                 // the center's last pass: sum the warp's counts
      // every lane takes part in every reduction (no lane skips one)
#pragma unroll
      for (int q = 0; q < P::NW; ++q) cnt[q] = __reduce_add_sync(0xffffffffu, cnt[q]);
      unsigned total = 0;          // the valid count: the sum of the α fields
#pragma unroll
      for (int f = 0; f < kBins; ++f) total += P::field(cnt, f);
      // 100 / total as the plain version rounds it: the reciprocal, then the product
      const float scale = __fmul_rn(__frcp_rn(fmaxf((float)total, 1e-6f)), 100.0f);
      unsigned word = 0;           // lane l writes bin l, lane 0 also bin 32
#pragma unroll
      for (int q = 0; q < P::NW; ++q) word = (lane / P::FPW == q) ? cnt[q] : word;
      const unsigned mine = (word >> (FB * (lane % P::FPW))) & P::kFieldMask;
      float* o = spfh + ((size_t)b * N + i) * kFields;
      o[lane] = __fmul_rn((float)mine, scale);
      if (lane == 0) o[32] = __fmul_rn((float)P::field(cnt, 32), scale);
    }
    r = rn;
    k0 = kn;
  }
}

using KernelFn = void (*)(const float*, const float*, const int*, float*, float*, Sector, int,
                          int, int, int, int, int, bool);

// The kernel for K: fields wide enough for sums of K, two edges a lane a
// pass once K passes 32; null where no field holds K.
KernelFn kernel_for(int K) {
  return K <= 32 ? spfh_redux_kernel<6, 1>
       : K <= 63 ? spfh_redux_kernel<6, 2>
       : K <= 255 ? spfh_redux_kernel<8, 2>
       : K <= 65535 ? spfh_redux_kernel<16, 2>
       : nullptr;
}

// The kernel for K, allowed `smem` bytes of shared memory.
cudaError_t prepare(int K, size_t smem, KernelFn* kernel) {
  *kernel = kernel_for(K);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// x, normals [B, N, 3] f32; nbr [B, N, K] int32 (global ids); spfh [B, N, 33]
// and dist [B, N, K] f32 out; sector: host float[24], cos then sin of the 12
// θ bin boundaries; accurate = 0 rounds x and the normals to bf16 first.
extern "C" int spfh_redux_launch(const void* x, const void* normals, const void* nbr, void* spfh,
                                 void* dist, const void* sector, int B, int N, int K, int T,
                                 int W, int pad_tiles, int max_tile, int accurate, void* stream) {
  Sector sec;
  const float* s = static_cast<const float*>(sector);
  for (int q = 0; q <= kBins; ++q) {
    sec.cs[q] = s[q];
    sec.sn[q] = s[kBins + 1 + q];
  }
  const size_t smem = 6 * (size_t)W * sizeof(float);
  KernelFn kernel;
  const cudaError_t err = prepare(K, smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / T, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(normals),
      static_cast<const int*>(nbr), static_cast<float*>(spfh), static_cast<float*>(dist), sec, N,
      K, T, W, pad_tiles, max_tile, accurate == 0);
  return (int)cudaGetLastError();
}

// The kernel K selects at this geometry: resident blocks an SM holds, and
// blocks in the grid.
extern "C" int spfh_redux_occupancy(int B, int N, int K, int T, int W, int* blocks_per_sm,
                                    int* grid_blocks) {
  *grid_blocks = N / T * B;
  const size_t smem = 6 * (size_t)W * sizeof(float);
  KernelFn kernel;
  const cudaError_t err = prepare(K, smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}
