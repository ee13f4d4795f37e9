// Exact / packed-key k-NN over Hilbert windows, for Hopper (sm_90a).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// knn_kernel.py::_knn_kernel (wrapper knn_pallas). Same function, not the
// same blocks: the TPU kernel builds a [T, W] distance tile and runs K
// min-reduction sweeps over it because its vector unit likes wide sweeps.
// Here one thread owns one query and keeps its K best keys sorted by
// insertion while it streams the window once.
//
// What bounds it on this card: neither bytes nor FLOPs. Per query it reads
// W candidates (from shared memory) and does 8 flops each, so at the
// served shape (B = 64 clouds per call, N = 2048, W = 384) the work is
// ~0.4 GFLOP of fp32 and ~10 MB of coordinates in and indices out — a few
// microseconds at peak. What costs is instruction throughput: the
// compare/insert per candidate. The design keeps the
// candidate coordinates and ‖c‖² in shared memory (broadcast reads, no
// bank conflicts), the sorted list in shared memory columns (thread t owns
// column t: conflict-free), and the current K-th key in a register so the
// common case — candidate rejected — is one compare.
//
// Numerics: d² = (‖q‖² − 2·q·c) + ‖c‖², each product and sum rounded on its
// own (__fmul_rn/__fadd_rn, no FMA contraction), in the fixed order of the
// port's plain version (ops/kernels/knn.py), so the two agree bit for bit.
// Packed mode: key = (bits(d²) & ~0x3FF) | window_lane compared as signed
// int32 (a slightly negative d² from cancellation sorts first, as on the
// TPU). Keys are unique, so insertion yields what K min-sweeps yield.
// Exact mode: order by (d², global id), the lowest-index tie-break.
// Window start S(i) = clamp(i − pad_tiles, 0, max_tile) · T, the formula of
// ops/morton.py::window_start_at (pad_tiles and max_tile come from there).

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int kChunk = 1024;  // candidates staged in shared memory at once

__device__ __forceinline__ float sqnorm(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

template <bool PACKED>
__global__ void knn_kernel(const float* __restrict__ x, int* __restrict__ out,
                           int N, int K, int W, int pad_tiles, int max_tile,
                           int include_self) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int q = tile * T + tid;
  const int S = max(0, min(tile - pad_tiles, max_tile)) * T;
  const float* xb = x + (size_t)b * N * 3;

  float* cx = smem;
  float* cy = cx + kChunk;
  float* cz = cy + kChunk;
  float* c2 = cz + kChunk;
  // per-thread sorted lists, stored column-wise: entry j of thread t at j*T+t
  int* keys = reinterpret_cast<int*>(c2 + kChunk);     // packed key or id
  float* dl = reinterpret_cast<float*>(keys + K * T);  // exact mode: d²

  const float qx = xb[q * 3 + 0], qy = xb[q * 3 + 1], qz = xb[q * 3 + 2];
  const float q2 = sqnorm(qx, qy, qz);

  for (int j = 0; j < K; ++j) {
    keys[j * T + tid] = INT_MAX;
    if (!PACKED) dl[j * T + tid] = CUDART_INF_F;
  }
  int wk = INT_MAX;            // K-th key (packed) or K-th id (exact)
  float wd = CUDART_INF_F;     // K-th d² (exact)

  for (int c0 = 0; c0 < W; c0 += kChunk) {
    const int n = min(kChunk, W - c0);
    __syncthreads();
    for (int j = tid; j < n; j += T) {
      const float* p = xb + (size_t)(S + c0 + j) * 3;
      const float a = p[0], bb = p[1], c = p[2];
      cx[j] = a; cy[j] = bb; cz[j] = c;
      c2[j] = sqnorm(a, bb, c);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int lane = c0 + j;
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, cx[j]), __fmul_rn(qy, cy[j])),
          __fmul_rn(qz, cz[j]));
      float d2 = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, cross)), c2[j]);
      if (!include_self && S + lane == q) d2 = CUDART_INF_F;
      if (PACKED) {
        const int key = (__float_as_int(d2) & ~0x3FF) | lane;
        if (key >= wk) continue;
        int p = K - 1;
        while (p > 0 && keys[(p - 1) * T + tid] > key) {
          keys[p * T + tid] = keys[(p - 1) * T + tid];
          --p;
        }
        keys[p * T + tid] = key;
        wk = keys[(K - 1) * T + tid];
      } else {
        const int gid = S + lane;
        if (!(d2 < wd || (d2 == wd && gid < wk))) continue;
        int p = K - 1;
        while (p > 0) {
          const float pd = dl[(p - 1) * T + tid];
          const int pi = keys[(p - 1) * T + tid];
          if (!(pd > d2 || (pd == d2 && pi > gid))) break;
          dl[p * T + tid] = pd;
          keys[p * T + tid] = pi;
          --p;
        }
        dl[p * T + tid] = d2;
        keys[p * T + tid] = gid;
        wd = dl[(K - 1) * T + tid];
        wk = keys[(K - 1) * T + tid];
      }
    }
  }

  int* o = out + ((size_t)b * N + q) * K;
  for (int j = 0; j < K; ++j) {
    const int v = keys[j * T + tid];
    o[j] = PACKED ? (v & 0x3FF) + S : v;
  }
}

template <bool PACKED>
int launch(const float* x, int* out, int B, int N, int K, int T, int W,
           int pad_tiles, int max_tile, int include_self, cudaStream_t stream) {
  const size_t smem = 4 * kChunk * sizeof(float) +
                      (size_t)K * T * (PACKED ? sizeof(int) : sizeof(int) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / T, B);
  knn_kernel<PACKED><<<grid, T, smem, stream>>>(x, out, N, K, W, pad_tiles,
                                                max_tile, include_self);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, N, 3] f32, out [B, N, K] int32. W = window (N for the whole cloud).
extern "C" int knn_launch(const void* x, void* out, int B, int N, int K, int T,
                          int W, int pad_tiles, int max_tile, int packed,
                          int include_self, void* stream) {
  const float* xf = static_cast<const float*>(x);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return packed ? launch<true>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, s)
                : launch<false>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, s);
}
