// Two-level (chunked) packed-key k-NN over Hilbert windows, one thread a
// query, for Hopper (sm_90a): kept to compare against the main-path kernel
// csrc/knn_chunked_warp.cu (`variant='thread'` in ops/kernels/knn.py).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// knn_kernel.py:93 `_knn_kernel_chunked` (wrapper knn_pallas(chunked=True)).
// The function, which differs from packed mode's: every window candidate at
// offset r gets the key (bits(d²) & ~0x3FF) | r, compared as signed int32;
// the W candidates fall into C = W/128 residue classes c = r mod C; the
// S_pc smallest keys of each class form a shortlist of S_pc·C keys, and the
// K smallest keys of the shortlist, ascending, give the neighbors
// (key & 0x3FF) + S. A neighbor is lost only when one class holds more
// than S_pc of the true K nearest.
//
// Design: one thread owns one query, as in csrc/knn.cu: it streams the window
// once from shared memory, and keeps C sorted insertion lists of S_pc keys
// (in shared memory, column t for thread t: conflict-free) with each list's
// largest key in a register, so a rejected candidate costs one compare. A
// C-way merge of the sorted lists then writes the K smallest in order.
//
// What bounds it: not bytes (x in, indices out: ~32 MB at B = 64 clouds,
// N = 2048, K = 60) and not the 8 flops per (query, candidate), but the
// issue of the compare/insert instructions, which this design spends
// badly: divergent insertions (far candidates come first in a window centred
// on the query, and are evicted later), 73 KB of lists a block at W = 768
// (3 blocks an SM to hide the dependent shared-memory loads), the C-way
// merge's K·C dependent reads, and 16 blocks for one cloud of N = 2048.
//
// Numerics: d² = (‖c‖² − 2·c·q) + ‖q‖², the TPU kernel's order (the reverse
// of B1's), each product and sum rounded on its own (no FMA contraction), in
// the order of the plain version (ops/kernels/knn.py::knn_chunked_plain), so
// the two agree bit for bit. Window start S(i) = clamp(i − pad_tiles, 0,
// max_tile) · T, as ops/morton.py::window_start_at.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int kMaxWindow = 1024;  // 10-bit offsets in the packed key

__device__ __forceinline__ float sqnorm(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

template <int C>
__global__ void knn_chunked_kernel(const float* __restrict__ x, int* __restrict__ out,
                                   int N, int K, int W, int S_pc, int pad_tiles,
                                   int max_tile, int include_self) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int q = tile * T + tid;
  const int S = max(0, min(tile - pad_tiles, max_tile)) * T;
  const float* xb = x + (size_t)b * N * 3;

  float* cx = smem;
  float* cy = cx + W;
  float* cz = cy + W;
  float* c2 = cz + W;
  // list c of thread t: entry j at (c * S_pc + j) * T + t
  int* lists = reinterpret_cast<int*>(c2 + W);

  for (int j = tid; j < W; j += T) {
    const float* p = xb + (size_t)(S + j) * 3;
    const float a = p[0], bb = p[1], c = p[2];
    cx[j] = a; cy[j] = bb; cz[j] = c;
    c2[j] = sqnorm(a, bb, c);
  }
  for (int j = 0; j < C * S_pc; ++j) lists[j * T + tid] = INT_MAX;
  __syncthreads();

  const float qx = xb[q * 3 + 0], qy = xb[q * 3 + 1], qz = xb[q * 3 + 2];
  const float q2 = sqnorm(qx, qy, qz);
  int thr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) thr[c] = INT_MAX;

  for (int r0 = 0; r0 < W; r0 += C) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int r = r0 + c;
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(cx[r], qx), __fmul_rn(cy[r], qy)), __fmul_rn(cz[r], qz));
      float d2 = __fadd_rn(__fsub_rn(c2[r], __fmul_rn(2.0f, cross)), q2);
      if (!include_self && S + r == q) d2 = CUDART_INF_F;
      const int key = (__float_as_int(d2) & ~0x3FF) | r;
      if (key >= thr[c]) continue;
      int* L = lists + c * S_pc * T + tid;
      int p = S_pc - 1;
      while (p > 0 && L[(p - 1) * T] > key) {
        L[p * T] = L[(p - 1) * T];
        --p;
      }
      L[p * T] = key;
      thr[c] = L[(S_pc - 1) * T];
    }
  }

  // C-way merge of the sorted lists: the K smallest keys, ascending
  int head[C];
#pragma unroll
  for (int c = 0; c < C; ++c) head[c] = 0;
  int* o = out + ((size_t)b * N + q) * K;
  for (int kk = 0; kk < K; ++kk) {
    int best = INT_MAX, bc = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int v = head[c] < S_pc ? lists[(c * S_pc + head[c]) * T + tid] : INT_MAX;
      if (v < best) { best = v; bc = c; }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) head[c] += (c == bc);
    o[kk] = (best & 0x3FF) + S;
  }
}

template <int C>
int launch(const float* x, int* out, int B, int N, int K, int T, int W, int S_pc,
           int pad_tiles, int max_tile, int include_self, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)W * sizeof(float) + (size_t)C * S_pc * T * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      knn_chunked_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / T, B);
  knn_chunked_kernel<C><<<grid, T, smem, stream>>>(x, out, N, K, W, S_pc, pad_tiles,
                                                   max_tile, include_self);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, N, 3] f32, out [B, N, K] int32; W a multiple of 128, at most 1024.
extern "C" int knn_chunked_launch(const void* x, void* out, int B, int N, int K, int T,
                                  int W, int S_pc, int pad_tiles, int max_tile,
                                  int include_self, void* stream) {
  const float* xf = static_cast<const float*>(x);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 128 || W > kMaxWindow) return (int)cudaErrorInvalidValue;
  switch (W / 128) {
    case 1: return launch<1>(xf, o, B, N, K, T, W, S_pc, pad_tiles, max_tile, include_self, s);
    case 2: return launch<2>(xf, o, B, N, K, T, W, S_pc, pad_tiles, max_tile, include_self, s);
    case 3: return launch<3>(xf, o, B, N, K, T, W, S_pc, pad_tiles, max_tile, include_self, s);
    case 4: return launch<4>(xf, o, B, N, K, T, W, S_pc, pad_tiles, max_tile, include_self, s);
    case 5: return launch<5>(xf, o, B, N, K, T, W, S_pc, pad_tiles, max_tile, include_self, s);
    case 6: return launch<6>(xf, o, B, N, K, T, W, S_pc, pad_tiles, max_tile, include_self, s);
    case 7: return launch<7>(xf, o, B, N, K, T, W, S_pc, pad_tiles, max_tile, include_self, s);
    default: return launch<8>(xf, o, B, N, K, T, W, S_pc, pad_tiles, max_tile, include_self, s);
  }
}
