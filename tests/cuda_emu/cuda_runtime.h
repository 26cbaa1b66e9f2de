// A CPU stand-in for the CUDA subset that the port's kernels use
// (csrc/beam_search.cu, scan_topk.cu, the persistent item body of
// scan_v2.cu, scan_v3.cu and scan_v3b.cu, and the probe in scan_v3b.cu), so
// the kernels' own sources run on the CPU in the tests
// (tests/test_torch_beam_emulated.py, test_torch_scan_emulated.py,
// test_torch_scan_v3b.py, test_torch_scan_v2.py, test_torch_scan_v3.py), and
// the emulator's own tests (tests/test_cuda_emu.py).
// Every CUDA thread of a CTA is a fiber, and a CTA's fibers share one OS
// thread (see EmuBar below); a warp's collectives (ballot, shuffle, reduce,
// mma, __syncwarp) meet at a barrier of its 32 threads, __syncthreads at one
// of the CTA's. emu_launch runs the CTAs one after another on the calling
// thread; emu_launch_concurrent runs each on an OS thread of its own, all at
// once, as a persistent grid whose CTAs share a work counter needs. The
// device has EMU_SMS SMs and one CTA fits each
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). The kernel calls every
// collective with all 32 lanes converged, which is what this emulation
// assumes, and a launch that breaks that aborts with a message rather than
// hang. The test rewrites the source's launch, its extern shared array and
// its inline PTX before compiling: an asynchronous copy becomes a copy made
// at once and a wait finds it done (so a read of a staging buffer before its
// copy is waited for is not caught here, but a copy that overwrites data
// still being read is), and an mma.sync m16n8k16 bf16 becomes
// emu_mma_m16n8k16_bf16 below (cuda_bf16.h stands in for the bf16 type).
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <sys/mman.h>
#include <ucontext.h>
#include <unistd.h>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(x)
#define __restrict__
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct dim3 { unsigned x, y, z; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int cudaDevAttrMultiProcessorCount = 16;
constexpr int EMU_SMS = 2;
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class K> inline int cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
template <class K> inline int cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = {0, 0};
  return cudaSuccess;
}
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline int cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = EMU_SMS; return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }
inline size_t __cvta_generic_to_shared(const void* p) { return reinterpret_cast<size_t>(p); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
template <class V>
inline V __ldg(const V* p) { return *p; }
// A load that other threads' atomics may change meanwhile.
template <class V>
inline V __ldcg(const V* p) {
  V r;
  __atomic_load(p, &r, __ATOMIC_RELAXED);
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return old;
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  unsigned old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v > old && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {}
  return old;
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= unsigned((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}

// One CTA's CUDA threads are fibers (ucontext) on one OS thread, each on a
// stack of its own. A fiber runs until it arrives at a barrier, a warp's (32)
// or the CTA's, then yields to the CTA's scheduler (emu_run_cta), which
// resumes, sweep after sweep, every fiber whose barrier has opened: in thread
// order on even sweeps, in reverse order on odd ones. A barrier opens in the
// sweep in which its last thread arrives, and its threads go on in the next,
// so the threads run from one barrier to the next in one of the two orders,
// and a read of what another thread of the CTA writes between the same two
// barriers reads too early in one order or the other. A sweep that resumes
// no fiber is a deadlock (a collective that part of a warp reaches, a
// __syncthreads in a divergent branch): the launch names each barrier that
// threads wait at and the first thread it still waits for, and aborts.
struct EmuBar {
  int count, arrived = 0;  // the threads it waits for, and those there now
  unsigned gen = 0;        // the times it has opened
  long opened = -1;        // the sweep in which it last opened
};
struct EmuFiber {
  ucontext_t ctx;
  char* stack = nullptr;
  const EmuBar* bar = nullptr;  // the barrier it waits at, or null
  unsigned gen = 0;             // bar->gen when it arrived
  bool done = false;
};
struct EmuWarp { EmuBar bar{32}; unsigned u[32]; unsigned frag[32][10]; };

// A fiber's stack, its lowest page a guard. Stacks go back to a pool for
// later launches.
inline const size_t EMU_PAGE = sysconf(_SC_PAGESIZE);
constexpr size_t EMU_STACK = size_t(1) << 20;
inline std::mutex emu_stacks_mu;
inline std::vector<char*> emu_stacks;
inline char* emu_take_stack() {
  {
    std::lock_guard<std::mutex> hold(emu_stacks_mu);
    if (!emu_stacks.empty()) {
      char* s = emu_stacks.back();
      emu_stacks.pop_back();
      return s;
    }
  }
  void* s = mmap(nullptr, EMU_STACK, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE | MAP_STACK, -1, 0);
  if (s == MAP_FAILED || mprotect(s, EMU_PAGE, PROT_NONE) != 0) {
    std::perror("emulated CUDA: a fiber's stack");
    std::abort();
  }
  return static_cast<char*>(s);
}

// A CTA's dynamic shared memory, zeroed, with EMU_SMEM_SLACK bytes after it
// that a read may reach, then a guard page, so that a read further past its
// end faults whatever the heap holds. The slack is the items body's
// (csrc/scan_items.cuh) over-read: at qblock 8 with a tile that is an odd
// multiple of 256, the round's last busy warp reads its whole 512 rows of 8
// dims from the ring, 256 rows (8 KiB) past the round, which can run past
// the end of the layout (ROADMAP.md, Queue C).
constexpr size_t EMU_SMEM_SLACK = 8192;
struct EmuSmem {
  unsigned char* base;
  size_t span;
  unsigned char* p;  // 16-byte aligned
  explicit EmuSmem(size_t bytes) {
    span = (bytes + EMU_SMEM_SLACK + 16 + EMU_PAGE - 1) / EMU_PAGE * EMU_PAGE + EMU_PAGE;
    void* m = mmap(nullptr, span, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (m == MAP_FAILED ||
        mprotect(static_cast<char*>(m) + span - EMU_PAGE, EMU_PAGE, PROT_NONE) != 0) {
      std::perror("emulated CUDA: shared memory");
      std::abort();
    }
    base = static_cast<unsigned char*>(m);
    p = base + span - EMU_PAGE - EMU_SMEM_SLACK - bytes;
    p -= reinterpret_cast<uintptr_t>(p) % 16;
  }
  ~EmuSmem() { munmap(base, span); }
};

inline void emu_fiber_main();
struct EmuBlock {
  EmuBar bar;
  EmuWarp warps[32];
  unsigned char* smem;
  std::vector<EmuFiber> fibers;  // never resized: a ucontext_t points into itself
  ucontext_t sched;
  long sweep = 0;
  void (*body)(void*);  // the kernel with its arguments, run by every fiber
  void* arg;
  template <class F>
  EmuBlock(int threads, F& run, unsigned char* smem) : bar{threads}, smem(smem), fibers(threads) {
    body = [](void* f) { (*static_cast<F*>(f))(); };
    arg = &run;
    for (EmuFiber& f : fibers) {
      f.stack = emu_take_stack();
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack;
      f.ctx.uc_stack.ss_size = EMU_STACK;
      f.ctx.uc_link = &sched;
      makecontext(&f.ctx, emu_fiber_main, 0);
    }
  }
  ~EmuBlock() {
    std::lock_guard<std::mutex> hold(emu_stacks_mu);
    for (EmuFiber& f : fibers) emu_stacks.push_back(f.stack);
  }
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local EmuBlock* emu_block;
inline EmuWarp& emu_warp() { return emu_block->warps[threadIdx.x / 32]; }
inline unsigned char* emu_smem() { return emu_block->smem; }

// Arrive at b, then yield until it has opened.
inline void emu_wait(EmuBar& b) {
  EmuBlock& blk = *emu_block;
  EmuFiber& f = blk.fibers[threadIdx.x];
  f.bar = &b;
  f.gen = b.gen;
  if (++b.arrived == b.count) {
    b.arrived = 0;
    ++b.gen;
    b.opened = blk.sweep;
  }
  swapcontext(&f.ctx, &blk.sched);
  f.bar = nullptr;
}
inline void __syncwarp() { emu_wait(emu_warp().bar); }
inline void __syncthreads() { emu_wait(emu_block->bar); }

[[noreturn]] inline void emu_deadlock(const EmuBlock& blk) {
  const int n = static_cast<int>(blk.fibers.size());
  std::fprintf(stderr, "emulated CUDA: deadlock in block %u, no thread can go on\n", blockIdx.x);
  auto report = [&](const EmuBar& b, const std::string& what, int lo, int hi) {
    if (b.arrived == 0) return;
    int t = lo;
    while (t < hi && blk.fibers[t].bar == &b) ++t;
    std::fprintf(stderr, "  %s: %d of %d threads wait; first missing thread %d\n",
                 what.c_str(), b.arrived, b.count, t);
  };
  report(blk.bar, "the CTA's barrier (__syncthreads)", 0, n);
  for (int w = 0; 32 * w < n; ++w)
    report(blk.warps[w].bar, "warp " + std::to_string(w) + "'s barrier", 32 * w,
           min(n, 32 * w + 32));
  std::abort();
}

inline void emu_fiber_main() {
  EmuBlock& blk = *emu_block;
  blk.body(blk.arg);
  blk.fibers[threadIdx.x].done = true;
}  // and on to blk.sched, the context's uc_link

// Runs CTA b of the launch on this OS thread, its fibers to their ends.
template <class F>
void emu_run_cta(F& run, int b, int grid, int threads, size_t smem) {
  EmuSmem mem(smem);
  EmuBlock blk(threads, run, mem.p);
  threadIdx = {0, 0, 0};
  blockIdx = {unsigned(b), 0, 0};
  blockDim = {unsigned(threads), 1, 1};
  gridDim = {unsigned(grid), 1, 1};
  emu_block = &blk;
  for (int left = threads; left > 0; ++blk.sweep) {
    bool ran = false;
    for (int j = 0; j < threads; ++j) {
      const int t = blk.sweep % 2 ? threads - 1 - j : j;
      EmuFiber& f = blk.fibers[t];
      if (f.done || (f.bar && (f.bar->gen == f.gen || f.bar->opened == blk.sweep))) continue;
      threadIdx.x = unsigned(t);
      swapcontext(&blk.sched, &f.ctx);
      ran = true;
      left -= f.done;
    }
    if (!ran) emu_deadlock(blk);
  }
}
inline unsigned __ballot_sync(unsigned, int pred) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  w.u[lane] = pred != 0;
  emu_wait(w.bar);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= w.u[i] << i;
  emu_wait(w.bar);
  return r;
}
template <class V>
inline V __shfl_xor_sync(unsigned, V v, int o) {
  static_assert(sizeof(V) == 4, "32-bit values");
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  std::memcpy(&w.u[lane], &v, 4);
  emu_wait(w.bar);
  V r;
  std::memcpy(&r, &w.u[lane ^ o], 4);
  emu_wait(w.bar);
  return r;
}
template <class V>
inline V __shfl_sync(unsigned, V v, int src) {
  static_assert(sizeof(V) == 4, "32-bit values");
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  std::memcpy(&w.u[lane], &v, 4);
  emu_wait(w.bar);
  V r;
  std::memcpy(&r, &w.u[src & 31], 4);
  emu_wait(w.bar);
  return r;
}
template <class V>
inline V __shfl_up_sync(unsigned, V v, unsigned delta) {
  static_assert(sizeof(V) == 4, "32-bit values");
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  std::memcpy(&w.u[lane], &v, 4);
  emu_wait(w.bar);
  V r = v;
  if (lane >= int(delta)) std::memcpy(&r, &w.u[lane - delta], 4);
  emu_wait(w.bar);
  return r;
}
// A warp-wide reduction of one 32-bit value per lane.
template <class F>
inline unsigned emu_reduce(unsigned v, F f) {
  EmuWarp& w = emu_warp();
  w.u[threadIdx.x & 31] = v;
  emu_wait(w.bar);
  unsigned r = w.u[0];
  for (int i = 1; i < 32; ++i) r = f(r, w.u[i]);
  emu_wait(w.bar);
  return r;
}
inline int __any_sync(unsigned, int pred) { return __ballot_sync(0xffffffffu, pred) != 0; }
inline int __reduce_add_sync(unsigned, int v) {
  return int(emu_reduce(unsigned(v), [](unsigned a, unsigned b) { return a + b; }));
}
inline int __reduce_min_sync(unsigned, int v) {
  return int(emu_reduce(unsigned(v), [](unsigned a, unsigned b) { return unsigned(min(int(a), int(b))); }));
}
inline int __reduce_max_sync(unsigned, int v) {
  return int(emu_reduce(unsigned(v), [](unsigned a, unsigned b) { return unsigned(max(int(a), int(b))); }));
}
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, c += A * B, called by
// all 32 lanes with their fragments in the PTX layout (g = lane / 4, t =
// lane % 4; a register holds two k, the lower in its low half): a = {(row g,
// k 2t..), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..)}, b0 =
// (k 2t.., col g), b1 = (k 2t+8.., col g); c = (row g, cols 2t, 2t+1), (row
// g+8, cols 2t, 2t+1). Products of bf16 values are exact in fp32; the sum
// runs over k in order, onto c.
inline float emu_bf16_value(unsigned reg, int high) {
  const unsigned u = (high ? reg >> 16 : reg & 0xffffu) << 16;
  return __uint_as_float(u);
}
inline void emu_mma_m16n8k16_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                  unsigned b1) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < 4; ++r) w.frag[lane][r] = a[r];
  w.frag[lane][4] = b0;
  w.frag[lane][5] = b1;
  for (int r = 0; r < 4; ++r) std::memcpy(&w.frag[lane][6 + r], &c[r], 4);
  emu_wait(w.bar);
  auto A = [&](int row, int k) {  // element (row, k) of A
    return emu_bf16_value(w.frag[(row % 8) * 4 + (k % 8) / 2][(k >= 8 ? 2 : 0) + (row >= 8)],
                          k & 1);
  };
  auto B = [&](int k, int col) {
    return emu_bf16_value(w.frag[col * 4 + (k % 8) / 2][k >= 8 ? 5 : 4], k & 1);
  };
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int r = 0; r < 4; ++r) {
    const int row = g + 8 * (r >> 1), col = 2 * t + (r & 1);
    float acc;
    std::memcpy(&acc, &w.frag[lane][6 + r], 4);
    for (int k = 0; k < 16; ++k) acc += A(row, k) * B(k, col);
    out[r] = acc;
  }
  emu_wait(w.bar);
  for (int r = 0; r < 4; ++r) c[r] = out[r];
}

template <class K, class... A>
void emu_launch(K kernel, int grid, int threads, size_t smem, cudaStream_t, A... args) {
  auto run = [&] { kernel(args...); };
  for (int b = 0; b < grid; ++b) emu_run_cta(run, b, grid, threads, smem);
}
template <class K, class... A>
void emu_launch_concurrent(K kernel, int grid, int threads, size_t smem, cudaStream_t, A... args) {
  auto run = [&] { kernel(args...); };
  std::vector<std::thread> ctas;
  for (int b = 0; b < grid; ++b)
    ctas.emplace_back([&, b] { emu_run_cta(run, b, grid, threads, smem); });
  for (auto& c : ctas) c.join();
}
