// Warp-cooperative k-selection over packed k-NN keys, for Hopper (sm_90a):
// the pieces shared by csrc/knn_warp.cu (B1 packed) and
// csrc/knn_chunked_warp.cu (B4).
//
// One warp owns one query. Its block has staged the query tile's window
// once in shared memory (`stage_window`); each lane computes the keys of its
// own candidates into registers, and the warp selects without insertion:
// - each lane sorts its keys in registers (`sort_keys`, Batcher's odd-even
//   merge network: fixed compare-exchanges, no branch);
// - keys are unique within a query (the low 10 bits hold the window offset),
//   so the smallest of the lanes' heads (`__reduce_min_sync`, one
//   instruction) is the next key in ascending order, and exactly one lane
//   advances its list (`next_key`). M steps extract the M smallest in order,
//   with no threshold to search for and nothing to rank afterwards.
// A first build selected by counting (a radix search for a threshold with
// exactly M keys at or below it, ~12-14 rounds of a compare and a
// __reduce_add_sync per key and round, then a compaction and a ranking by
// counting): on an H100 it measured slower at every shape (PERF.md).
//
// Keys are the packed int32 (bits(d²) & ~0x3FF) | r, compared signed as the
// plain versions compare them (a slightly negative d² from cancellation
// sorts first, as on the TPU). Pads sit at INT_MAX, above every key of a
// finite d².
//
// Exact keys (csrc/knn_exact_warp.cu) order by (d², global id): a 64-bit
// key, the order-preserving image of d² in the high word and the id in the
// low one (`exact_key`), sorted by the same networks. Their high words are
// not unique, so a warp-min step over them (`holds_warp_min`) takes the
// smallest high word first, then the smallest id among the lanes that hold
// it: two 32-bit reductions. A form that skipped the second where a ballot
// found one owner measured slower on an H100 (PERF.md).

#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace knn_select {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPad = 0x7fffffff;
constexpr int kWarps = 4;                 // warps a block: one query each at a time
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float sqnorm(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

// Window start S(i) = clamp(i − pad_tiles, 0, max_tile) · T, the formula of
// ops/morton.py::window_start_at.
__device__ __forceinline__ int window_start(int tile, int pad_tiles, int max_tile, int T) {
  return max(0, min(tile - pad_tiles, max_tile)) * T;
}

// The packed key of window offset r.
__device__ __forceinline__ int order_key(float d2, int r) {
  return (__float_as_int(d2) & ~0x3FF) | r;
}

// Exact keys: (d², global id) in one 64-bit word, ordered as unsigned. The
// high word maps d² so that unsigned order is float order, negative d²
// (from cancellation) first: a non-negative float gets its sign bit set, a
// negative one all bits flipped. −0 is made +0 first (x + 0 under
// round-to-nearest), so the two tie as they do in the plain version's sort.
using ExactKey = unsigned long long;
constexpr ExactKey kExactPad = ~0ull;     // above every key of a d² that is not NaN

__device__ __forceinline__ unsigned order_bits(float d2) {
  const unsigned u = __float_as_uint(__fadd_rn(d2, 0.0f));
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ ExactKey exact_key(float d2, int gid) {
  return (static_cast<ExactKey>(order_bits(d2)) << 32) | static_cast<unsigned>(gid);
}

// One warp-min step over exact keys: true on the lane whose head is the
// warp's smallest key. Every lane calls it with its head (pads included).
// The ids of a query's candidates are unique, so only pads can tie in full;
// then every pad lane answers true, which a caller with enough keys never
// reaches.
__device__ __forceinline__ bool holds_warp_min(ExactKey head) {
  const unsigned hi = static_cast<unsigned>(head >> 32);
  const unsigned g = __reduce_min_sync(kFull, hi);
  const unsigned lo = hi == g ? static_cast<unsigned>(head) : 0xffffffffu;
  const unsigned gl = __reduce_min_sync(kFull, lo);   // on every lane, outside any `&&`
  return hi == g && lo == gl;
}

// Where a block's queries are: blocks enumerate (cloud, tile, sub) with sub
// fastest; sub covers kWarps·qpw queries of the tile, a warp takes every
// kWarps-th of them in turn.
struct BlockQueries {
  int b, tile, first, step, end;
};

__device__ __forceinline__ BlockQueries block_queries(int N, int T, int qpw) {
  const int per_block = kWarps * qpw;
  const int subs = (T + per_block - 1) / per_block;
  const int tiles = N / T;
  const int blk = blockIdx.x;
  const int sub = blk % subs;
  BlockQueries q;
  q.tile = (blk / subs) % tiles;
  q.b = blk / (subs * tiles);
  q.first = sub * per_block + (threadIdx.x >> 5);
  q.step = kWarps;
  q.end = min(T, (sub + 1) * per_block);
  return q;
}

// Stage the window [S, S + W) of cloud xb once for the block as SoA x, y, z
// and ‖c‖², offset r at slot(r): the layout that keeps each lane's reads
// stride-1 across the warp.
template <class Slot>
__device__ __forceinline__ void stage_window(const float* __restrict__ xb, int S, int W,
                                             float* cx, float* cy, float* cz, float* c2,
                                             Slot slot) {
  for (int r = threadIdx.x; r < W; r += blockDim.x) {
    const float* p = xb + static_cast<size_t>(S + r) * 3;
    const float a = p[0], b = p[1], c = p[2];
    const int s = slot(r);
    cx[s] = a; cy[s] = b; cz[s] = c;
    c2[s] = sqnorm(a, b, c);
  }
}

// One pass of Batcher's odd-even merge sort over N keys: merge runs of P at
// distance K, then K/2, ... 1. Every bound is a template constant, so the
// loops unroll into fixed compare-exchanges on registers. N need not be a
// power of two: the network of the next power of two, with the comparators
// that reach past N dropped, sorts N keys (those positions would hold +inf).
// Keys are packed int32 or exact 64-bit keys (T).
template <int N, int P, int K, class T>
__device__ __forceinline__ void merge_pass(T (&u)[N]) {
#pragma unroll
  for (int j = K % P; j + K < N; j += 2 * K) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i + j + K < N && (i + j) / (2 * P) == (i + j + K) / (2 * P)) {
        const T a = u[i + j], b = u[i + j + K];
        u[i + j] = min(a, b);
        u[i + j + K] = max(a, b);
      }
    }
  }
  if constexpr (K > 1) merge_pass<N, P, K / 2>(u);
}

// Sort a lane's N keys ascending, in registers.
template <int N, int P = 1, class T>
__device__ __forceinline__ void sort_keys(T (&u)[N]) {
  if constexpr (P < N) {
    merge_pass<N, P, P>(u);
    sort_keys<N, 2 * P>(u);
  }
}

// One extraction step over lists held in registers: the warp's smallest
// head; the lane that holds it shifts its list up by one.
template <int N>
__device__ __forceinline__ int next_key(int (&u)[N]) {
  const int g = __reduce_min_sync(kFull, u[0]);
  const bool hit = u[0] == g;
#pragma unroll
  for (int j = 0; j + 1 < N; ++j) u[j] = hit ? u[j + 1] : u[j];
  u[N - 1] = hit ? kPad : u[N - 1];
  return g;
}

// Extract m keys in ascending order from lists in shared memory, lane l
// walking list l: entry j of it at list[l + j * stride], n entries, head
// already loaded; the i-th key goes to out[i] as the neighbor
// (key & 0x3FF) + S, each run of 32 written by 32 lanes at once.
__device__ __forceinline__ void extract_to(const int* list, int stride, int n, int head,
                                          int m, int* __restrict__ out, int S) {
  const int lane = threadIdx.x & 31;
  int mine = 0;
  int pos = 0;
  for (int i = 0; i < m; ++i) {
    // every lane loads its next entry before the step: a form that loaded it
    // inside the divergent `if (hit)` lost entries on an H100 (PERF.md)
    const int next = pos + 1 < n ? list[lane + (pos + 1) * stride] : kPad;
    const int g = __reduce_min_sync(kFull, head);
    const bool hit = head == g;
    head = hit ? next : head;
    pos += hit;
    if (lane == (i & 31)) mine = g;
    if ((i & 31) == 31 || i + 1 == m) {
      const int at = (i & ~31) + lane;
      if (at <= i) out[at] = (mine & 0x3FF) + S;
    }
  }
}

}  // namespace knn_select
