// Two-level (chunked) packed-key k-NN over Hilbert windows, one warp a
// query, for Hopper (sm_90a). The main-path kernel of B4.
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// knn_kernel.py:93 `_knn_kernel_chunked` (wrapper knn_pallas(chunked=True)).
// The function: every window candidate at offset r gets the key
// (bits(d²) & ~0x3FF) | r, compared as signed int32; the W candidates fall
// into C = W/128 residue classes c = r mod C; the S_pc smallest keys of each
// class form a shortlist of S_pc·C keys, and the K smallest keys of the
// shortlist, ascending, give the neighbors (key & 0x3FF) + S.
//
// What bounds it on this card: neither bytes (x in, indices out: ~32 MB at
// B = 64 clouds, N = 2048, K = 60) nor the 8 fp32 flops per (query,
// candidate), but instruction issue: key arithmetic and selection. The
// thread-a-query kernel (csrc/knn_chunked.cu, kept to compare against) spent
// its issue on divergent insertions into shared-memory lists (the window is
// centred on the query, so far candidates come first and are evicted
// later), held 73 KB of lists a block, and gave one cloud 16 blocks for 132
// SMs. Here (csrc/knn_select.cuh):
// - a block of 4 warps stages its tile's window once, offset r = q·C + c at
//   [c][q], so lane l reading class c's q ∈ {l, l+32, l+64, l+96} is
//   stride-1; 14 KB a block at W = 768;
// - per class the lane's 4 keys stay in registers, sorted; S_pc warp-min
//   steps per class (the C classes interleaved) extract each class's
//   shortlist in ascending order into a per-warp buffer [i][c];
// - lane c then walks class c's list, and K warp-min steps over the C
//   heads merge the shortlists into the K smallest, written in order;
// - a block covers 4·qpw queries of a tile, so one cloud of N = 2048
//   launches 512 blocks (qpw = 1).
//
// Numerics: d² = (‖c‖² − 2·c·q) + ‖q‖², the TPU kernel's order (the reverse
// of B1's), each product and sum rounded on its own (no FMA contraction), in
// the order of the plain version (ops/kernels/knn.py::knn_chunked_plain), so
// the lists agree bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"

namespace {

using namespace knn_select;

constexpr int kClassLen = 128;    // candidates a residue class

template <int C>
__global__ void __launch_bounds__(kThreads)
knn_chunked_warp_kernel(const float* __restrict__ x, int* __restrict__ out, int N, int K, int T,
                        int S_pc, int pad_tiles, int max_tile, int include_self, int qpw) {
  constexpr int W = kClassLen * C;
  extern __shared__ float smem[];
  float* cx = smem;
  float* cy = cx + W;
  float* cz = cy + W;
  float* c2 = cz + W;
  int* lists = reinterpret_cast<int*>(c2 + W) + (threadIdx.x >> 5) * kClassLen;
  const int lane = threadIdx.x & 31;

  const BlockQueries bq = block_queries(N, T, qpw);
  const int S = window_start(bq.tile, pad_tiles, max_tile, T);
  const float* xb = x + static_cast<size_t>(bq.b) * N * 3;
  stage_window(xb, S, W, cx, cy, cz, c2, [](int r) { return (r % C) * kClassLen + r / C; });
  __syncthreads();

  for (int ql = bq.first; ql < bq.end; ql += bq.step) {
    const int q = bq.tile * T + ql;
    const float qx = xb[q * 3 + 0], qy = xb[q * 3 + 1], qz = xb[q * 3 + 2];
    const float q2 = sqnorm(qx, qy, qz);
    int u[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = lane + 32 * j, s = c * kClassLen + qc, r = qc * C + c;
        const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx[s], qx), __fmul_rn(cy[s], qy)),
                                      __fmul_rn(cz[s], qz));
        float d2 = __fadd_rn(__fsub_rn(c2[s], __fmul_rn(2.0f, cross)), q2);
        if (!include_self && S + r == q) d2 = CUDART_INF_F;
        u[c][j] = order_key(d2, r);
      }
      sort_keys(u[c]);
    }
    // the S_pc smallest of each class, ascending: entry i of class c at
    // lists[c + i·C], so that lane c walks class c's list below
    for (int i = 0; i < S_pc; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g = next_key(u[c]);
        if (lane == 0) lists[c + i * C] = g;
      }
    }
    __syncwarp();
    extract_to(lists, C, lane < C ? S_pc : 0, lane < C ? lists[lane] : kPad, K,
               out + (static_cast<size_t>(bq.b) * N + q) * K, S);
    __syncwarp();
  }
}

template <int C>
int launch(const float* x, int* out, int B, int N, int K, int T, int S_pc, int pad_tiles,
           int max_tile, int include_self, int qpw, cudaStream_t stream) {
  const int smem = (4 * kClassLen * C + kWarps * kClassLen) * 4;
  const int per_block = kWarps * qpw;
  const int blocks = B * (N / T) * ((T + per_block - 1) / per_block);
  knn_chunked_warp_kernel<C><<<blocks, kThreads, smem, stream>>>(
      x, out, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, N, 3] f32, out [B, N, K] int32; W = 128·C with C from 1 to 8,
// S_pc ≤ 128/C, K ≤ S_pc·C; qpw queries a warp in turn (≥ 1).
extern "C" int knn_chunked_warp_launch(const void* x, void* out, int B, int N, int K, int T,
                                       int W, int S_pc, int pad_tiles, int max_tile,
                                       int include_self, int qpw, void* stream) {
  const float* xf = static_cast<const float*>(x);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % kClassLen || W < kClassLen || W > 8 * kClassLen || qpw < 1 || K < 1 ||
      S_pc < 1 || S_pc * (W / kClassLen) > kClassLen || K > S_pc * (W / kClassLen))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (W / kClassLen) {
    case 1: return launch<1>(xf, o, B, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw, s);
    case 2: return launch<2>(xf, o, B, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw, s);
    case 3: return launch<3>(xf, o, B, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw, s);
    case 4: return launch<4>(xf, o, B, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw, s);
    case 5: return launch<5>(xf, o, B, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw, s);
    case 6: return launch<6>(xf, o, B, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw, s);
    case 7: return launch<7>(xf, o, B, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw, s);
    default: return launch<8>(xf, o, B, N, K, T, S_pc, pad_tiles, max_tile, include_self, qpw, s);
  }
}
