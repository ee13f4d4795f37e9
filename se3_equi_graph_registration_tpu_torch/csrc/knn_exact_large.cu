// Exact-key k-NN at large k (128 < K ≤ 1024) over Hilbert windows or the
// whole cloud, one warp a query, for Hopper (sm_90a). The main-path kernel
// of B1 in exact mode beyond the K ≤ 128 of csrc/knn_exact_warp.cu.
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// knn_kernel.py:26 `_knn_kernel` without packed keys (wrapper knn_pallas(...,
// packed=False), window or whole cloud) at large k: for each query the K
// candidates of [S, S + W) with the smallest d², ascending, ties to the
// lower global id (the lowest-index tie-break of `lax.top_k`). The whole
// cloud is W = N, S = 0: one window that every query shares, one tile of N
// queries.
//
// What bounds it on this card: neither bytes (x in, K indices out: 157 MB
// at B = 64 clouds, N = 2048, K = 300, ~0.05 ms) nor the 8 fp32 flops a
// (query, candidate), but instruction issue. The thread-a-query kernel
// (csrc/knn.cu, kept to compare against) shifts up to K entries of a
// shared-memory list for each accepted candidate, divergently across the
// warp, and at K = 300 a block holds 64 queries, so one cloud of 2048 gives
// 32 blocks for 132 SMs. A running list merged by K serial warp-min steps
// (csrc/knn_exact_warp.cu) costs a chain of K dependent reductions a merge.
// Here the work is O(W · passes + K · passes) a query, with no insertion:
// - select: a radix search finds the K-th smallest (d², id) key. Ids rise
//   with the candidate's offset, so the search runs on the 32-bit
//   order-preserving image of d² alone (`order_bits`): 4 digits of 9, 8, 8
//   and 7 bits (the first is the sign and the exponent, so it already
//   splits the candidates by octave). Each pass recomputes d² from the
//   staged float4 of its candidates (8 flops are cheaper than keeping W
//   keys) and counts the digits of those that match the prefix found so
//   far into a per-warp histogram in shared memory; a warp scan of the
//   bins gives the digit that holds the K-th key. A pass whose bin holds
//   exactly the keys still needed ends the search early (mostly after 2 or
//   3 passes);
// - compact: one more sweep writes the keys below the prefix and, in
//   order of offset, as many of those on it as still needed (a ballot and
//   a popcount give each its slot) into a per-warp list: exactly K keys;
// - sort: a stable LSD radix sort of the K keys by the high word, 4
//   passes of 8 bits between two per-warp buffers in shared memory (a
//   digit histogram, a warp scan, and a scatter 32 keys at a time, each
//   key's rank among the lanes with its digit from a mask the lanes set by
//   a shared atomicOr). Stable, it keeps the compaction's order of id
//   within equal d². A first build sorted ⌈K/32⌉ keys a lane with a
//   bitonic network in registers: 64-bit compare-exchanges at 96 registers
//   with spills, 2.64 ms at B = 64 clouds, N = 2048, K = 300, W = 768,
//   against 1.20-1.25 with this sort (separate runs, PERF.md). The sorted
//   ids go out 32 lanes a store.
// A block of 4 warps stages the candidates once, in chunks of up to 1024
// (float4 x, y, z, ‖c‖²); a window of W ≤ 1024 is staged once for all the
// block's queries, a larger one once a sweep. A block covers 4·qpw
// queries of a tile, so one cloud of N = 2048 launches 512 blocks
// (qpw = 1); a warp keeps 16·K + 2 KB of shared memory.
//
// Numerics: d² = (‖q‖² − 2·q·c) + ‖c‖², each product and sum rounded on its
// own (no FMA contraction), in the order of the plain version
// (ops/kernels/knn.py::knn_window_plain), so the lists agree bit for bit.
// include_self = 0 sets a query's own d² to +inf, as the other kernels do.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"

namespace {

using namespace knn_select;

constexpr int kChunk = 1024;      // candidates staged a block at once
constexpr int kGroup = 4;         // 32-candidate steps whose keys a lane computes at once
constexpr int kBins = 512;        // the widest digit of the search: 9 bits
constexpr int kPasses = 4;        // search digits: bits 31-23, 22-15, 14-7, 6-0
constexpr int kSortPasses = 4;    // sort digits: 8 bits each, low to high

__device__ __forceinline__ int digit_shift(int pass) { return max(23 - 8 * pass, 0); }
__device__ __forceinline__ unsigned digit_mask(int pass) {
  return pass == 0 ? 0x1ffu : pass == kPasses - 1 ? 0x7fu : 0xffu;
}

// A warp's shared memory: the keys (K) and the sort's other buffer (K),
// then the sort's 256 counts and 256 masks; the search's 512 counts overlay
// the second buffer (room for 128 keys at least).
__host__ __device__ constexpr int key_room(int K) { return K < 128 ? 128 : (K + 1) / 2 * 2; }
__host__ __device__ constexpr int scratch_bytes(int K) { return 16 * key_room(K) + 2048; }

// The digit whose bin holds the need-th smallest matching key: need becomes
// that key's rank within the bin, in_bin the bin's count. Lane l sums bins
// 16l ... 16l + 15 (its 16-byte loads rotated by l/2, so a quarter warp's
// fall in different banks), a warp scan finds the lane, and that lane's 16
// bins, one a lane, the bin.
__device__ __forceinline__ unsigned pick_digit(const unsigned* hist, unsigned& need,
                                               unsigned& in_bin) {
  const int lane = threadIdx.x & 31;
  unsigned total = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 b = reinterpret_cast<const uint4*>(hist + 16 * lane)[(v + (lane >> 1)) & 3];
    total += b.x + b.y + b.z + b.w;
  }
  unsigned incl = total;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const unsigned t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned excl = incl - total;
  const int L = __ffs(__ballot_sync(kFull, excl < need && need <= incl)) - 1;
  need -= __shfl_sync(kFull, excl, L);
  const unsigned v = lane < 16 ? hist[16 * L + lane] : 0u;
  unsigned incl2 = v;
#pragma unroll
  for (int o = 1; o < 16; o *= 2) {
    const unsigned t = __shfl_up_sync(kFull, incl2, o);
    if (lane >= o) incl2 += t;
  }
  const unsigned excl2 = incl2 - v;
  const int b = __ffs(__ballot_sync(kFull, lane < 16 && excl2 < need && need <= incl2)) - 1;
  need -= __shfl_sync(kFull, excl2, b);
  in_bin = __shfl_sync(kFull, v, b);
  return static_cast<unsigned>(16 * L + b);
}

// Stable LSD radix sort of the warp's K keys by their high word: 4 passes
// of 8 bits from `a` to `b` and back, so the result ends in `a`. Each pass
// counts the digits, turns the counts into offsets by a warp scan (lane l
// holds bins 8l ... 8l + 7), and scatters the keys 32 at a time in order:
// a key's slot is its digit's offset plus the lanes below it with that
// digit, which each lane sets a bit of in `peers_of[digit]` (a shared
// atomicOr: `__match_any_sync` measured slower, PERF.md); the lowest of
// them moves the offset on and clears the bits. `hist` holds 2 × 256 words.
__device__ __forceinline__ void radix_sort(ExactKey* a, ExactKey* b, unsigned* hist, int K) {
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned* peers_of = hist + 256;
  reinterpret_cast<uint4*>(peers_of)[2 * lane] = make_uint4(0u, 0u, 0u, 0u);
  reinterpret_cast<uint4*>(peers_of)[2 * lane + 1] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
  for (int pass = 0; pass < kSortPasses; ++pass) {
    const int shift = 32 + 8 * pass;
    reinterpret_cast<uint4*>(hist)[2 * lane] = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(hist)[2 * lane + 1] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
    for (int e = lane; e < K; e += 32)
      atomicAdd(hist + (static_cast<unsigned>(a[e] >> shift) & 0xffu), 1u);
    __syncwarp();
    uint4 c0 = reinterpret_cast<uint4*>(hist)[2 * lane];
    uint4 c1 = reinterpret_cast<uint4*>(hist)[2 * lane + 1];
    unsigned run = 0, t;
    t = c0.x; c0.x = run; run += t;
    t = c0.y; c0.y = run; run += t;
    t = c0.z; c0.z = run; run += t;
    t = c0.w; c0.w = run; run += t;
    t = c1.x; c1.x = run; run += t;
    t = c1.y; c1.y = run; run += t;
    t = c1.z; c1.z = run; run += t;
    t = c1.w; c1.w = run; run += t;
    unsigned incl = run;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const unsigned u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    const unsigned excl = incl - run;
    reinterpret_cast<uint4*>(hist)[2 * lane] =
        make_uint4(c0.x + excl, c0.y + excl, c0.z + excl, c0.w + excl);
    reinterpret_cast<uint4*>(hist)[2 * lane + 1] =
        make_uint4(c1.x + excl, c1.y + excl, c1.z + excl, c1.w + excl);
    __syncwarp();
    for (int e0 = 0; e0 < K; e0 += 32) {
      const int e = e0 + lane;
      const bool valid = e < K;
      const ExactKey key = valid ? a[e] : 0ull;
      const unsigned d = static_cast<unsigned>(key >> shift) & 0xffu;
      if (valid) atomicOr(peers_of + d, 1u << lane);
      __syncwarp();
      const unsigned peers = valid ? peers_of[d] : 0u;
      const unsigned base = valid ? hist[d] : 0u;
      __syncwarp();
      if (valid) {
        b[base + __popc(peers & lanes_below)] = key;
        if (!(peers & lanes_below)) {
          hist[d] = base + __popc(peers);
          peers_of[d] = 0u;
        }
      }
      __syncwarp();
    }
    ExactKey* swap = a;
    a = b;
    b = swap;
  }
}

struct Query {
  float x, y, z, n2;
  int id;
};

// Stage candidates [c0, c0 + n) of the window for the block.
__device__ __forceinline__ void stage(const float* __restrict__ xb, int from, int n,
                                      float4* staged) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float* p = xb + static_cast<size_t>(from + r) * 3;
    const float a = p[0], b = p[1], c = p[2];
    staged[r] = make_float4(a, b, c, sqnorm(a, b, c));
  }
}

// One sweep of the query over the window: visit(valid, hi, gid) for the
// candidates at offsets j0 + lane, j0 + 32 + lane, ... in order, called by
// every lane alike (so a visit may vote). `one_chunk`: the block staged the
// whole window before; otherwise each chunk is staged here, by every warp of
// the block, whether or not it has work (`work`).
template <class Visit>
__device__ __forceinline__ void sweep(const float* __restrict__ xb, float4* staged, int S,
                                      int W, bool one_chunk, bool work, const Query& q,
                                      int include_self, Visit visit) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < W; c0 += kChunk) {
    const int n = min(kChunk, W - c0);
    if (!one_chunk) {
      __syncthreads();
      stage(xb, S + c0, n, staged);
      __syncthreads();
    }
    if (!work) continue;
    for (int j0 = 0; j0 < n; j0 += 32 * kGroup) {
      unsigned hi[kGroup];
      bool valid[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int r = j0 + 32 * g + lane;
        valid[g] = r < n;
        hi[g] = 0;
        if (valid[g]) {
          const float4 c = staged[r];
          const float cross = __fadd_rn(__fadd_rn(__fmul_rn(q.x, c.x), __fmul_rn(q.y, c.y)),
                                        __fmul_rn(q.z, c.z));
          float d2 = __fadd_rn(__fsub_rn(q.n2, __fmul_rn(2.0f, cross)), c.w);
          if (!include_self && S + c0 + r == q.id) d2 = CUDART_INF_F;
          hi[g] = order_bits(d2);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) visit(valid[g], hi[g], S + c0 + j0 + 32 * g + lane);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn_exact_large_kernel(const float* __restrict__ x, int* __restrict__ out, int N, int K, int T,
                       int W, int pad_tiles, int max_tile, int include_self, int qpw) {
  extern __shared__ float4 staged[];     // [min(W, kChunk)]: x, y, z, ‖c‖²; then the warps' scratch
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  char* scratch = reinterpret_cast<char*>(staged + min(W, kChunk)) + warp * scratch_bytes(K);
  ExactKey* keys = reinterpret_cast<ExactKey*>(scratch);
  ExactKey* other = keys + key_room(K);
  unsigned* hist = reinterpret_cast<unsigned*>(other);                    // the search's
  unsigned* sort_hist = reinterpret_cast<unsigned*>(other + key_room(K));  // the sort's

  const BlockQueries bq = block_queries(N, T, qpw);
  const int S = window_start(bq.tile, pad_tiles, max_tile, T);
  const float* xb = x + static_cast<size_t>(bq.b) * N * 3;
  const bool one_chunk = W <= kChunk;
  if (one_chunk) {
    stage(xb, S, W, staged);
    __syncthreads();
  }

  // every warp runs qpw slots and 4 + 1 sweeps each, so that the chunks'
  // __syncthreads match when the window is staged a chunk at a time
  for (int s = 0; s < qpw; ++s) {
    const int ql = bq.first + s * bq.step;
    const bool active = ql < bq.end;
    Query q{0.0f, 0.0f, 0.0f, 0.0f, 0};
    if (active) {
      q.id = bq.tile * T + ql;
      q.x = xb[q.id * 3 + 0];
      q.y = xb[q.id * 3 + 1];
      q.z = xb[q.id * 3 + 2];
      q.n2 = sqnorm(q.x, q.y, q.z);
    }

    // select: the prefix (under mask) of the K-th smallest order_bits(d²);
    // `need` of the keys on it are taken, all of those below it
    unsigned prefix = 0, mask = 0, need = static_cast<unsigned>(K);
    bool done = !active;
#pragma unroll 1
    for (int pass = 0; pass < kPasses; ++pass) {
      const int shift = digit_shift(pass);
      const unsigned digit = digit_mask(pass);
      if (!done) {
        for (int i = lane; i < kBins / 4; i += 32)
          reinterpret_cast<uint4*>(hist)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();
      sweep(xb, staged, S, W, one_chunk, !done, q, include_self,
            [&](bool valid, unsigned hi, int) {
              if (valid && (hi & mask) == prefix) atomicAdd(hist + ((hi >> shift) & digit), 1u);
            });
      __syncwarp();
      if (!done) {
        unsigned in_bin;
        prefix |= pick_digit(hist, need, in_bin) << shift;
        mask |= digit << shift;
        done = in_bin == need;
      }
      __syncwarp();
    }

    // compact: exactly K keys, those on the prefix in order of offset (= id)
    int count = 0;
    unsigned ties = 0;
    sweep(xb, staged, S, W, one_chunk, active, q, include_self,
          [&](bool valid, unsigned hi, int gid) {
            const unsigned m = hi & mask;
            const bool on = valid && m == prefix;
            const unsigned on_ballot = __ballot_sync(kFull, on);
            const bool take = (valid && m < prefix) ||
                              (on && ties + __popc(on_ballot & lanes_below) < need);
            ties += __popc(on_ballot);
            const unsigned taken = __ballot_sync(kFull, take);
            if (take)
              keys[count + __popc(taken & lanes_below)] =
                  (static_cast<ExactKey>(hi) << 32) | static_cast<unsigned>(gid);
            count += __popc(taken);
          });
    if (!active) continue;
    __syncwarp();

    radix_sort(keys, other, sort_hist, K);
    int* o = out + (static_cast<size_t>(bq.b) * N + q.id) * K;
    for (int e = lane; e < K; e += 32) o[e] = static_cast<int>(static_cast<unsigned>(keys[e]));
    __syncwarp();
  }
}

}  // namespace

// x [B, N, 3] f32, out [B, N, K] int32; exact keys over the windows
// [S(tile), S(tile) + W) of the tiles of T queries (the whole cloud: T = W =
// N, pad_tiles = max_tile = 0), 1 ≤ K ≤ min(W, 1024); qpw queries a warp in
// turn, 1 to 8.
extern "C" int knn_exact_large_launch(const void* x, void* out, int B, int N, int K, int T,
                                      int W, int pad_tiles, int max_tile, int include_self,
                                      int qpw, void* stream) {
  if (T < 1 || N % T || W < 1 || W > N || K < 1 || K > W || K > 1024 || qpw < 1 || qpw > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (W < kChunk ? W : kChunk) * 16 + kWarps * scratch_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(knn_exact_large_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kWarps * qpw;
  const int blocks = B * (N / T) * ((T + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  knn_exact_large_kernel<<<blocks, kThreads, smem, s>>>(static_cast<const float*>(x),
                                                        static_cast<int*>(out), N, K, T, W,
                                                        pad_tiles, max_tile, include_self, qpw);
  return static_cast<int>(cudaGetLastError());
}
