// Host emulation of the CUDA the port's tensor-core kernels use, for CPU tests
// (tests/test_torch_egcl_tile_emulated.py): a block runs as one std::thread per
// CUDA thread, blocks one after another; __syncthreads, __syncwarp, the warp
// shuffles and mma.sync.m16n8k16 (bf16 operands, fp32 accumulation, the PTX
// fragment layouts) are collectives over std::barrier. Slow and exact enough to
// check a kernel's indexing, masking and fragment plumbing without a card; it
// says nothing about what nvcc accepts or how fast anything is.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <barrier>
#include <functional>
#include <memory>
#include <atomic>
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct float2 { float x, y; }; struct float4 { float x, y, z, w; };
struct uint2 { uint32_t x, y; }; struct uint4 { uint32_t x, y, z, w; };
struct dim3m { int x = 0, y = 0, z = 0; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaDevAttrMultiProcessorCount = 16,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
inline int cudaGetLastError() { return 0; }
extern thread_local dim3m threadIdx, blockIdx, blockDim, gridDim;
struct WarpCtx { std::barrier<> bar{32}; uint32_t buf[32][10]; };
extern thread_local WarpCtx* warp_ctx;
extern thread_local std::barrier<>* block_bar;
inline void __syncthreads() { block_bar->arrive_and_wait(); }
inline void __syncwarp() { warp_ctx->bar.arrive_and_wait(); }
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  int lane = threadIdx.x & 31; std::memcpy(&warp_ctx->buf[lane][0], &v, 4);
  warp_ctx->bar.arrive_and_wait(); T r; std::memcpy(&r, &warp_ctx->buf[src & 31][0], 4);
  warp_ctx->bar.arrive_and_wait(); return r; }
template <class T> inline T __shfl_xor_sync(unsigned m, T v, int x) { return __shfl_sync(m, v, (threadIdx.x & 31) ^ x); }
inline float __fdividef(float a, float b) { return a / b; }
inline float __expf(float a) { return std::exp(a); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
// atomicAdd on float, global or shared memory alike
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
// the block's dynamic shared memory (`extern __shared__`), set by emulated_launch
inline thread_local void* emulated_dynamic_shared = nullptr;
inline float bf2f(uint16_t b) { uint32_t u = (uint32_t)b << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline void emulated_mma(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t* my = warp_ctx->buf[lane];
  for (int i = 0; i < 4; ++i) my[i] = a[i];
  my[4] = b.x; my[5] = b.y;
  warp_ctx->bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    int gg = l >> 2, tt = l & 3; const uint32_t* o = warp_ctx->buf[l];
    auto lo = [](uint32_t w) { return bf2f(w & 0xffff); }; auto hi = [](uint32_t w) { return bf2f(w >> 16); };
    A[gg][2*tt] = lo(o[0]); A[gg][2*tt+1] = hi(o[0]);
    A[gg+8][2*tt] = lo(o[1]); A[gg+8][2*tt+1] = hi(o[1]);
    A[gg][2*tt+8] = lo(o[2]); A[gg][2*tt+9] = hi(o[2]);
    A[gg+8][2*tt+8] = lo(o[3]); A[gg+8][2*tt+9] = hi(o[3]);
    B[2*tt][gg] = lo(o[4]); B[2*tt+1][gg] = hi(o[4]);
    B[2*tt+8][gg] = lo(o[5]); B[2*tt+9][gg] = hi(o[5]);
  }
  auto dot = [&](int r, int c) { float s = 0; for (int k = 0; k < 16; ++k) s += A[r][k] * B[k][c]; return s; };
  d[0] += dot(g, 2*t); d[1] += dot(g, 2*t+1); d[2] += dot(g+8, 2*t); d[3] += dot(g+8, 2*t+1);
  warp_ctx->bar.arrive_and_wait();
}
template <class F> void emulated_launch(int grid, int block, int shared_bytes, F body) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bb(block); int nw = (block + 31) / 32;
    std::vector<std::unique_ptr<WarpCtx>> ws; for (int i = 0; i < nw; ++i) ws.emplace_back(new WarpCtx);
    std::vector<uint32_t> dyn((shared_bytes + 3) / 4 + 4, 0xffffffffu);  // garbage, as on the card
    std::vector<std::thread> th;
    for (int i = 0; i < block; ++i) th.emplace_back([&, i] {
      threadIdx.x = i; blockIdx.x = b; blockDim.x = block; gridDim.x = grid;
      warp_ctx = ws[i / 32].get(); block_bar = &bb;
      emulated_dynamic_shared = reinterpret_cast<void*>(
          (reinterpret_cast<uintptr_t>(dyn.data()) + 15) & ~uintptr_t(15));
      body(); });
    for (auto& t : th) t.join();
  }
}
template <class F> void emulated_launch(int grid, int block, F body) { emulated_launch(grid, block, 0, body); }
