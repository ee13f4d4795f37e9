// Packed-key k-NN over Hilbert windows, one warp a query, for Hopper
// (sm_90a). The main-path kernel of B1 (packed mode, window ≤ 1024).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// knn_kernel.py:26 `_knn_kernel` in packed mode (wrapper knn_pallas(...,
// packed=True)): the K smallest keys (bits(d²) & ~0x3FF) | r over the
// window offsets r, compared as signed int32, ascending, give the neighbors
// (key & 0x3FF) + S. Exact mode and the whole cloud stay on the thread-a-
// query kernel in csrc/knn.cu.
//
// What bounds it on this card: neither bytes (x in, indices out: ~10 MB at
// B = 64 clouds, N = 2048, K = 16) nor the 8 fp32 flops per (query,
// candidate), but instruction issue: key arithmetic and selection. The
// thread kernel spent its issue on divergent insertions into shared-memory
// lists (far candidates come first in a window centred on the query: about
// K·(1 + ln(W/K)) ≈ 67 insertions a query at K = 16, W = 384) and gave one
// cloud 16 blocks for 132 SMs. Here (csrc/knn_select.cuh):
// - a block of 4 warps stages its tile's window once, offset r at [r], so
//   lane l reading r ∈ {l, l+32, …} is stride-1;
// - each lane computes its ⌈W/32⌉ keys into registers (NJ, rounded up to a
//   multiple of 4, pads above every key) and sorts them there; the sorted
//   lists go to a per-warp buffer [j][lane], and K warp-min steps extract the
//   K smallest keys in ascending order, each step advancing one lane's list;
// - a block covers 4·qpw queries of a tile, so one cloud of N = 2048
//   launches 512 blocks (qpw = 1).
//
// Numerics: d² = (‖q‖² − 2·q·c) + ‖c‖², each product and sum rounded on its
// own (no FMA contraction), in the order of the plain version
// (ops/kernels/knn.py::knn_window_plain), so the lists agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"

namespace {

using namespace knn_select;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
knn_warp_kernel(const float* __restrict__ x, int* __restrict__ out, int N, int K, int T, int W,
                int pad_tiles, int max_tile, int include_self, int qpw) {
  extern __shared__ float smem[];
  float* cx = smem;
  float* cy = cx + W;
  float* cz = cy + W;
  float* c2 = cz + W;
  int* lists = reinterpret_cast<int*>(c2 + W) + (threadIdx.x >> 5) * (32 * NJ);
  const int lane = threadIdx.x & 31;

  const BlockQueries bq = block_queries(N, T, qpw);
  const int S = window_start(bq.tile, pad_tiles, max_tile, T);
  const float* xb = x + static_cast<size_t>(bq.b) * N * 3;
  stage_window(xb, S, W, cx, cy, cz, c2, [](int r) { return r; });
  __syncthreads();

  for (int ql = bq.first; ql < bq.end; ql += bq.step) {
    const int q = bq.tile * T + ql;
    const float qx = xb[q * 3 + 0], qy = xb[q * 3 + 1], qz = xb[q * 3 + 2];
    const float q2 = sqnorm(qx, qy, qz);
    int u[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = lane + 32 * j;
      u[j] = kPad;
      if (r < W) {
        const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, cx[r]), __fmul_rn(qy, cy[r])),
                                      __fmul_rn(qz, cz[r]));
        float d2 = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, cross)), c2[r]);
        if (!include_self && S + r == q) d2 = CUDART_INF_F;
        u[j] = order_key(d2, r);
      }
    }
    sort_keys(u);
#pragma unroll
    for (int j = 0; j < NJ; ++j) lists[lane + 32 * j] = u[j];
    __syncwarp();
    extract_to(lists, 32, NJ, u[0], K, out + (static_cast<size_t>(bq.b) * N + q) * K, S);
    __syncwarp();
  }
}

template <int NJ>
int launch(const float* x, int* out, int B, int N, int K, int T, int W, int pad_tiles,
           int max_tile, int include_self, int qpw, cudaStream_t stream) {
  const int smem = (4 * W + kWarps * 32 * NJ) * 4;
  const int per_block = kWarps * qpw;
  const int blocks = B * (N / T) * ((T + per_block - 1) / per_block);
  knn_warp_kernel<NJ><<<blocks, kThreads, smem, stream>>>(x, out, N, K, T, W, pad_tiles,
                                                          max_tile, include_self, qpw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, N, 3] f32, out [B, N, K] int32; packed keys over a window W ≤ 1024,
// 1 ≤ K ≤ W; qpw queries a warp in turn (≥ 1).
extern "C" int knn_warp_launch(const void* x, void* out, int B, int N, int K, int T, int W,
                               int pad_tiles, int max_tile, int include_self, int qpw,
                               void* stream) {
  const float* xf = static_cast<const float*>(x);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W < 1 || W > 1024 || K < 1 || K > W || qpw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((W + 127) / 128) {           // keys a lane, rounded up to a multiple of 4
    case 1: return launch<4>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    case 2: return launch<8>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    case 3: return launch<12>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    case 4: return launch<16>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    case 5: return launch<20>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    case 6: return launch<24>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    case 7: return launch<28>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    default: return launch<32>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
  }
}
