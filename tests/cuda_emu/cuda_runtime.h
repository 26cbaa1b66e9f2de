// A CPU stand-in for the CUDA subset that csrc/beam_search.cu uses, so the
// kernel's own source runs on the CPU in the tests (tests/test_torch_beam_emulated.py).
// Every CUDA thread of a CTA is a std::thread; a warp's collectives (ballot,
// shuffle, __syncwarp) meet at a barrier of its 32 threads, __syncthreads at
// one of the CTA's; CTAs run one after another. The kernel calls every
// collective with all 32 lanes converged, which is what this emulation
// assumes. The test rewrites the source's launch, its extern shared array and
// its inline PTX before compiling: an asynchronous copy becomes a copy made
// at once and a wait finds it done (so a read of a staging buffer before its
// copy is waited for is not caught here, but a copy that overwrites data
// still being read is).
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __restrict__
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct dim3 { unsigned x, y, z; };
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class K> inline int cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline int cudaGetLastError() { return cudaSuccess; }
inline size_t __cvta_generic_to_shared(const void* p) { return reinterpret_cast<size_t>(p); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
template <class V>
inline V __ldg(const V* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }

struct EmuWarp { std::barrier<> bar{32}; unsigned u[32]; };
struct EmuBlock {
  std::barrier<> bar;
  EmuWarp warps[32];
  unsigned char* smem;
  explicit EmuBlock(int threads) : bar(threads) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local EmuBlock* emu_block;
inline EmuWarp& emu_warp() { return emu_block->warps[threadIdx.x / 32]; }
inline unsigned char* emu_smem() { return emu_block->smem; }
inline void __syncwarp() { emu_warp().bar.arrive_and_wait(); }
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, int pred) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  w.u[lane] = pred != 0;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= w.u[i] << i;
  w.bar.arrive_and_wait();
  return r;
}
template <class V>
inline V __shfl_xor_sync(unsigned, V v, int o) {
  static_assert(sizeof(V) == 4, "32-bit values");
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  std::memcpy(&w.u[lane], &v, 4);
  w.bar.arrive_and_wait();
  V r;
  std::memcpy(&r, &w.u[lane ^ o], 4);
  w.bar.arrive_and_wait();
  return r;
}
template <class K, class... A>
void emu_launch(K kernel, int grid, int threads, size_t smem, cudaStream_t, A... args) {
  for (int b = 0; b < grid; ++b) {
    EmuBlock blk(threads);
    std::vector<unsigned char> mem(smem + 16);
    blk.smem = mem.data();
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {unsigned(t), 0, 0};
        blockIdx = {unsigned(b), 0, 0};
        emu_block = &blk;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
