// Exact-key k-NN over Hilbert windows or the whole cloud, one warp a query,
// for Hopper (sm_90a). The main-path kernel of B1 in exact mode.
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// knn_kernel.py:26 `_knn_kernel` without packed keys (wrapper knn_pallas(...,
// packed=False), window or whole cloud): for each query the K candidates of
// [S, S + W) with the smallest d², ascending, ties to the lower global id
// (the lowest-index tie-break of `lax.top_k`). The whole cloud is W = N,
// S = 0: one window that every query shares, so the launcher treats it as
// one tile of N queries whatever tile the caller named.
//
// What bounds it on this card: neither bytes (x in, indices out: ~10 MB at
// B = 64 clouds, N = 2048, K = 16) nor the 8 fp32 flops per (query,
// candidate), but instruction issue and latency: about 20 instructions a
// (query, candidate) for d², its key and the filter, and the selection, a
// chain of K dependent warp-min steps a merge. The
// thread-a-query kernel (csrc/knn.cu, kept to compare against) inserted into
// shared-memory lists, divergently across the warp (~K·(1 + ln(W/K))
// insertions a query in an unsorted cloud), and gave one cloud N/T blocks
// for 132 SMs. Here (csrc/knn_select.cuh):
// - a block of 4 warps stages the candidates once, in chunks of up to 1024
//   (float4 x, y, z, ‖c‖²: one 16-byte load a candidate, lane l at l, l+32,
//   ... stride-1), and each warp runs its queries over each chunk;
// - a query's running list (its K best (d², id) keys so far, 64-bit,
//   ascending) lives in shared memory; a candidate whose key is not below
//   the list's K-th is dropped, and the rest are appended to a per-warp
//   buffer of 256 keys (a ballot and a popcount give each its slot); each
//   lane computes 4 keys before their 4 appends, so the 4 chains overlap;
// - when the buffer could overflow, and at the end of a chunk, the warp
//   merges it with the running list: each lane sorts its 8 buffer entries
//   and its ⌈K/32⌉ list entries in registers, writes them to the buffer as
//   sorted per-lane lists, and K warp-min steps (`holds_warp_min`) extract
//   the new running list in order. The first merge comes after 256
//   candidates; after it the filter keeps ~K·ln(M/m) of the next M − m
//   candidates in an unsorted cloud, so most chunks cost one more merge;
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

constexpr int kChunk = 1024;     // candidates staged a block at once
constexpr int kBufRows = 8;      // survivor buffer: 32·kBufRows keys a warp
constexpr int kGroup = 4;       // 32-candidate steps whose keys a lane computes at once
constexpr int kBufFull = 32 * (kBufRows - kGroup);   // merge before a group that could overflow it

// The K smallest keys of the buffer's `count` entries and the running list
// `run` (sorted, pads beyond K), ascending, into `run`. `lists` is the
// buffer: it holds the lanes' sorted lists while the warp extracts.
template <int KJ>
__device__ __forceinline__ void merge_into(ExactKey* lists, int count, ExactKey* run, int K) {
  constexpr int NL = kBufRows + KJ;
  const int lane = threadIdx.x & 31;
  __syncwarp();
  ExactKey u[NL];
#pragma unroll
  for (int i = 0; i < kBufRows; ++i) {
    const int at = lane + 32 * i;
    u[i] = at < count ? lists[at] : kExactPad;
  }
#pragma unroll
  for (int i = 0; i < KJ; ++i) u[kBufRows + i] = run[lane + 32 * i];
  __syncwarp();
  sort_keys(u);
#pragma unroll
  for (int i = 0; i < NL; ++i) lists[lane + 32 * i] = u[i];
  __syncwarp();
  ExactKey head = u[0];
  int pos = 0;
  for (int i = 0; i < K; ++i) {
    // every lane loads its next entry before the step, outside any branch
    // (PERF.md: a load inside the divergent `if (hit)` lost entries)
    const ExactKey next = pos + 1 < NL ? lists[lane + 32 * (pos + 1)] : kExactPad;
    const bool hit = holds_warp_min(head);
    if (hit) run[i] = head;
    head = hit ? next : head;
    pos += hit;
  }
  __syncwarp();
}

template <int KJ>
__global__ void __launch_bounds__(kThreads)
knn_exact_warp_kernel(const float* __restrict__ x, int* __restrict__ out, int N, int K, int T,
                      int W, int pad_tiles, int max_tile, int include_self, int qpw) {
  constexpr int KP = 32 * KJ;                // running-list slots a query (≥ K)
  extern __shared__ float4 staged[];         // [min(W, kChunk)]: x, y, z, ‖c‖²
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ExactKey* keys = reinterpret_cast<ExactKey*>(staged + min(W, kChunk));
  ExactKey* lists = keys + warp * 32 * (kBufRows + KJ);
  ExactKey* runs = keys + kWarps * 32 * (kBufRows + KJ) + warp * qpw * KP;

  const BlockQueries bq = block_queries(N, T, qpw);
  const int S = window_start(bq.tile, pad_tiles, max_tile, T);
  const float* xb = x + static_cast<size_t>(bq.b) * N * 3;
  for (int i = lane; i < qpw * KP; i += 32) runs[i] = kExactPad;

  for (int c0 = 0; c0 < W; c0 += kChunk) {
    const int n = min(kChunk, W - c0);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const float* p = xb + static_cast<size_t>(S + c0 + r) * 3;
      const float a = p[0], b = p[1], c = p[2];
      staged[r] = make_float4(a, b, c, sqnorm(a, b, c));
    }
    __syncthreads();
    int slot = 0;
    for (int ql = bq.first; ql < bq.end; ql += bq.step, ++slot) {
      const int q = bq.tile * T + ql;
      ExactKey* run = runs + slot * KP;
      const float qx = xb[q * 3 + 0], qy = xb[q * 3 + 1], qz = xb[q * 3 + 2];
      const float q2 = sqnorm(qx, qy, qz);
      ExactKey th = run[K - 1];
      int count = 0;
      for (int j0 = 0; j0 < n; j0 += 32 * kGroup) {
        if (count > kBufFull) {
          merge_into<KJ>(lists, count, run, K);
          th = run[K - 1];
          count = 0;
        }
        ExactKey key[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int r = j0 + 32 * g + lane;
          key[g] = kExactPad;
          if (r < n) {
            const float4 c = staged[r];
            const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, c.x), __fmul_rn(qy, c.y)),
                                          __fmul_rn(qz, c.z));
            float d2 = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, cross)), c.w);
            const int gid = S + c0 + r;
            if (!include_self && gid == q) d2 = CUDART_INF_F;
            key[g] = exact_key(d2, gid);
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const bool keep = key[g] < th;
          const unsigned kept = __ballot_sync(kFull, keep);
          if (kept) {
            if (keep) lists[count + __popc(kept & ((1u << lane) - 1u))] = key[g];
            count += __popc(kept);
          }
        }
      }
      if (count) merge_into<KJ>(lists, count, run, K);
    }
  }

  int slot = 0;
  for (int ql = bq.first; ql < bq.end; ql += bq.step, ++slot) {
    const ExactKey* run = runs + slot * KP;
    int* o = out + (static_cast<size_t>(bq.b) * N + bq.tile * T + ql) * K;
    for (int i = lane; i < K; i += 32) o[i] = static_cast<int>(static_cast<unsigned>(run[i]));
  }
}

template <int KJ>
int launch(const float* x, int* out, int B, int N, int K, int T, int W, int pad_tiles,
           int max_tile, int include_self, int qpw, cudaStream_t stream) {
  const int smem = (W < kChunk ? W : kChunk) * 16 +
                   kWarps * 32 * (kBufRows + KJ + qpw * KJ) * static_cast<int>(sizeof(ExactKey));
  cudaError_t err = cudaFuncSetAttribute(knn_exact_warp_kernel<KJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kWarps * qpw;
  const int blocks = B * (N / T) * ((T + per_block - 1) / per_block);
  knn_exact_warp_kernel<KJ><<<blocks, kThreads, smem, stream>>>(x, out, N, K, T, W, pad_tiles,
                                                                max_tile, include_self, qpw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, N, 3] f32, out [B, N, K] int32; exact keys over the windows
// [S(tile), S(tile) + W) of the tiles of T queries (the whole cloud: T = W =
// N, pad_tiles = max_tile = 0), 1 ≤ K ≤ min(W, 128); qpw queries a warp in
// turn, 1 to 8.
extern "C" int knn_exact_warp_launch(const void* x, void* out, int B, int N, int K, int T,
                                     int W, int pad_tiles, int max_tile, int include_self,
                                     int qpw, void* stream) {
  const float* xf = static_cast<const float*>(x);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || N % T || W < 1 || W > N || K < 1 || K > W || K > 128 || qpw < 1 || qpw > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((K + 31) / 32) {           // running-list entries a lane
    case 1: return launch<1>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    case 2: return launch<2>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    case 3: return launch<3>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
    default: return launch<4>(xf, o, B, N, K, T, W, pad_tiles, max_tile, include_self, qpw, s);
  }
}
