// Host emulation of the CUDA the port's hand-written kernels use, for CPU tests
// (tests/test_torch_*_emulated.py): a block runs its CUDA threads as fibers
// on the calling thread, blocks one after another; __syncthreads,
// __syncwarp, the warp shuffles, the warp min and add reductions, the ballot,
// the match-any and mma.sync.m16n8k16
// (bf16 operands, fp32 accumulation, the PTX fragment layouts) are
// collectives over barriers at which a fiber yields until its peers arrive.
// One OS thread does all the work, so a loaded machine slows it in proportion
// and no more. The _rn arithmetic is plain float arithmetic: compile with
// -ffp-contract=off so nothing fuses. Slow and exact enough to check a
// kernel's indexing, masking and fragment plumbing without a card; it says
// nothing about what nvcc accepts or how fast anything is.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#include <ucontext.h>
#include <vector>
#include <functional>
#include <memory>
#include <algorithm>
using std::min; using std::max;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct float2 { float x, y; }; struct float4 { float x, y, z, w; };
struct uint2 { uint32_t x, y; }; struct uint4 { uint32_t x, y, z, w; };
struct dim3m { int x = 0, y = 0, z = 0; };
struct dim3 { int x, y, z; dim3(int x_ = 1, int y_ = 1, int z_ = 1) : x(x_), y(y_), z(z_) {} };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaDevAttrMultiProcessorCount = 16,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
inline int cudaGetLastError() { return 0; }
template <class F> inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1; return 0; }
inline dim3m threadIdx, blockIdx, blockDim, gridDim;
// Fibers switch on x86-64 by saving the callee-saved registers on their own
// stack and swapping stack pointers (`emulated_switch`): swapcontext also
// saves and restores the signal mask, a system call at every switch, which
// made it the emulation's main cost. Elsewhere, ucontext.
#if defined(__x86_64__)
#define EMULATED_FAST_SWITCH 1
extern "C" void emulated_switch(void** save_sp, void* load_sp);
__asm__(".text\n"
        ".weak emulated_switch\n"
        ".hidden emulated_switch\n"
        ".type emulated_switch, @function\n"
        "emulated_switch:\n"
        "  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n  pushq %r14\n  pushq %r15\n"
        "  movq %rsp, (%rdi)\n"
        "  movq %rsi, %rsp\n"
        "  popq %r15\n  popq %r14\n  popq %r13\n  popq %r12\n  popq %rbx\n  popq %rbp\n"
        "  ret\n"
        ".size emulated_switch, .-emulated_switch\n");
#else
#define EMULATED_FAST_SWITCH 0
#endif
// the fiber running now and the scheduler it yields to
struct EmulatedFiber { ucontext_t ctx; void* sp = nullptr; int tid = 0;
                       struct WarpCtx* warp = nullptr; unsigned reductions = 0; bool done = false; };
inline ucontext_t emulated_scheduler;
inline void* emulated_scheduler_sp = nullptr;
inline EmulatedFiber* emulated_current = nullptr;
inline std::function<void()>* emulated_body = nullptr;
inline unsigned emulated_reductions = 0;   // the running fiber's count of min reductions
inline void emulated_yield() {
  emulated_current->reductions = emulated_reductions;
#if EMULATED_FAST_SWITCH
  emulated_switch(&emulated_current->sp, emulated_scheduler_sp);
#else
  swapcontext(&emulated_current->ctx, &emulated_scheduler);
#endif
}
struct FiberBarrier {
  explicit FiberBarrier(int n) : n(n) {}
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++count == n) { count = 0; ++gen; return; }
    while (gen == g) emulated_yield();
  }
  const int n; int count = 0; unsigned gen = 0;
};
struct WarpCtx { FiberBarrier bar{32}; uint32_t buf[32][10]; };
inline WarpCtx* warp_ctx = nullptr;
inline FiberBarrier* block_bar = nullptr;
inline void __syncthreads() { block_bar->arrive_and_wait(); }
inline void __syncwarp() { warp_ctx->bar.arrive_and_wait(); }
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  int lane = threadIdx.x & 31; std::memcpy(&warp_ctx->buf[lane][0], &v, 4);
  warp_ctx->bar.arrive_and_wait(); T r; std::memcpy(&r, &warp_ctx->buf[src & 31][0], 4);
  warp_ctx->bar.arrive_and_wait(); return r; }
template <class T> inline T __shfl_xor_sync(unsigned m, T v, int x) { return __shfl_sync(m, v, (threadIdx.x & 31) ^ x); }
template <class T> inline T __shfl_up_sync(unsigned m, T v, unsigned d) {
  const int lane = threadIdx.x & 31, src = lane - static_cast<int>(d);
  return __shfl_sync(m, v, src < 0 ? lane : src); }
// the warp min reduction and the ballot: each lane posts its value, all read
// all. One barrier: consecutive collectives alternate between two slots, and
// a lane can write a slot again only after every lane has passed the barrier
// between.
inline uint32_t* emulated_post(uint32_t v) {
  const int lane = threadIdx.x & 31, slot = 8 + (emulated_reductions++ & 1);
  warp_ctx->buf[lane][slot] = v;
  warp_ctx->bar.arrive_and_wait();
  static thread_local uint32_t all[32];
  for (int l = 0; l < 32; ++l) all[l] = warp_ctx->buf[l][slot];
  return all; }
inline int __reduce_min_sync(unsigned, int v) {
  const uint32_t* all = emulated_post(static_cast<uint32_t>(v));
  int r = v;
  for (int l = 0; l < 32; ++l) r = std::min(r, static_cast<int>(all[l]));
  return r; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const uint32_t* all = emulated_post(v);
  unsigned r = v;
  for (int l = 0; l < 32; ++l) r = std::min(r, all[l]);
  return r; }
inline unsigned __ballot_sync(unsigned, int p) {
  const uint32_t* all = emulated_post(p != 0);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= all[l] << l;
  return r; }
inline unsigned __match_any_sync(unsigned, unsigned v) {
  const uint32_t* all = emulated_post(v);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= static_cast<unsigned>(all[l] == v) << l;
  return r; }
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const uint32_t* all = emulated_post(v);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r += all[l];
  return r; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned i; std::memcpy(&i, &f, 4); return i; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __expf(float a) { return std::exp(a); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
// atomicAdd on float, global or shared memory alike
inline float atomicAdd(float* p, float v) { float o = *p; *p = o + v; return o; }
inline unsigned atomicAdd(unsigned* p, unsigned v) { unsigned o = *p; *p = o + v; return o; }
inline unsigned atomicOr(unsigned* p, unsigned v) { unsigned o = *p; *p = o | v; return o; }
// the block's dynamic shared memory (`extern __shared__`), set by emulated_launch
inline void* emulated_dynamic_shared = nullptr;
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
inline void emulated_fiber_main() { (*emulated_body)(); emulated_current->done = true; }
#if EMULATED_FAST_SWITCH
// a fiber's first frame: runs the body, then hands the stack back for good
inline void emulated_fiber_entry() {
  emulated_fiber_main();
  emulated_switch(&emulated_current->sp, emulated_scheduler_sp);
  __builtin_trap();
}
// the stack of a fiber that has not run yet: six zero callee-saved registers
// for emulated_switch to pop and the entry to return into, which then
// starts as if called (its stack pointer 8 off 16-byte alignment)
inline void* emulated_fiber_stack(char* base, size_t size) {
  auto top = reinterpret_cast<uintptr_t*>((reinterpret_cast<uintptr_t>(base) + size) & ~uintptr_t(15));
  top[-1] = 0;
  top[-2] = reinterpret_cast<uintptr_t>(&emulated_fiber_entry);
  for (int i = 3; i <= 8; ++i) top[-i] = 0;
  return top - 8;
}
#endif
template <class F> void emulated_launch(int grid, int block, int shared_bytes, F body) {
  constexpr size_t kStack = 256 << 10;
  std::function<void()> fn = body;
  emulated_body = &fn;
  std::vector<char> stacks(static_cast<size_t>(block) * kStack);
  std::vector<EmulatedFiber> fibers(block);
  for (int b = 0; b < grid; ++b) {
    FiberBarrier bb(block); int nw = (block + 31) / 32;
    std::vector<std::unique_ptr<WarpCtx>> ws; for (int i = 0; i < nw; ++i) ws.emplace_back(new WarpCtx);
    std::vector<uint32_t> dyn((shared_bytes + 3) / 4 + 4, 0xffffffffu);  // garbage, as on the card
    blockIdx.x = b; blockDim.x = block; gridDim.x = grid; block_bar = &bb;
    emulated_dynamic_shared = reinterpret_cast<void*>(
        (reinterpret_cast<uintptr_t>(dyn.data()) + 15) & ~uintptr_t(15));
    for (int i = 0; i < block; ++i) {
      EmulatedFiber& f = fibers[i];
      f = EmulatedFiber{};
      f.tid = i; f.warp = ws[i / 32].get();
#if EMULATED_FAST_SWITCH
      f.sp = emulated_fiber_stack(stacks.data() + static_cast<size_t>(i) * kStack, kStack);
#else
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = stacks.data() + static_cast<size_t>(i) * kStack;
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = &emulated_scheduler;
      makecontext(&f.ctx, emulated_fiber_main, 0);
#endif
    }
    for (int left = block; left > 0;) {          // round robin until every fiber returned
      for (EmulatedFiber& f : fibers) {
        if (f.done) continue;
        threadIdx.x = f.tid; warp_ctx = f.warp; emulated_reductions = f.reductions;
        emulated_current = &f;
#if EMULATED_FAST_SWITCH
        emulated_switch(&emulated_scheduler_sp, f.sp);
#else
        swapcontext(&emulated_scheduler, &f.ctx);
#endif
        left -= f.done;
      }
    }
  }
}
template <class F> void emulated_launch(int grid, int block, F body) { emulated_launch(grid, block, 0, body); }
// a two-dimensional grid: blockIdx.y outer, blockIdx.x inner
template <class F> void emulated_launch(dim3 grid, int block, int shared_bytes, F body) {
  for (int y = 0; y < grid.y; ++y)
    emulated_launch(grid.x, block, shared_bytes, [&] { blockIdx.y = y; gridDim.y = grid.y; body(); });
}
