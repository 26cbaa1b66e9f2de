// A CPU stand-in for the CUDA subset that the port's kernels use
// (csrc/beam_search.cu, scan_topk.cu, the persistent item body of
// scan_v2.cu, scan_v3.cu and scan_v3b.cu, and the probe in scan_v3b.cu), so
// the kernels' own sources run on the CPU in the tests
// (tests/test_torch_beam_emulated.py, test_torch_scan_emulated.py,
// test_torch_scan_v3b.py, test_torch_scan_v2.py, test_torch_scan_v3.py).
// Every CUDA thread of a CTA is a std::thread; a warp's collectives (ballot,
// shuffle, reduce, __syncwarp) meet at a barrier of its 32 threads,
// __syncthreads at one of the CTA's. emu_launch runs the CTAs one after
// another; emu_launch_concurrent runs them all at once, as a persistent grid
// whose CTAs share a work counter needs. The device has EMU_SMS SMs and one
// CTA fits each (cudaOccupancyMaxActiveBlocksPerMultiprocessor). The kernel calls every
// collective with all 32 lanes converged, which is what this emulation
// assumes. The test rewrites the source's launch, its extern shared array and
// its inline PTX before compiling: an asynchronous copy becomes a copy made
// at once and a wait finds it done (so a read of a staging buffer before its
// copy is waited for is not caught here, but a copy that overwrites data
// still being read is), and an mma.sync m16n8k16 bf16 becomes
// emu_mma_m16n8k16_bf16 below (cuda_bf16.h stands in for the bf16 type).
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
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

struct EmuWarp { std::barrier<> bar{32}; unsigned u[32]; unsigned frag[32][10]; };
struct EmuBlock {
  std::barrier<> bar;
  EmuWarp warps[32];
  unsigned char* smem;
  explicit EmuBlock(int threads) : bar(threads) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
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
template <class V>
inline V __shfl_sync(unsigned, V v, int src) {
  static_assert(sizeof(V) == 4, "32-bit values");
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  std::memcpy(&w.u[lane], &v, 4);
  w.bar.arrive_and_wait();
  V r;
  std::memcpy(&r, &w.u[src & 31], 4);
  w.bar.arrive_and_wait();
  return r;
}
template <class V>
inline V __shfl_up_sync(unsigned, V v, unsigned delta) {
  static_assert(sizeof(V) == 4, "32-bit values");
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31;
  std::memcpy(&w.u[lane], &v, 4);
  w.bar.arrive_and_wait();
  V r = v;
  if (lane >= int(delta)) std::memcpy(&r, &w.u[lane - delta], 4);
  w.bar.arrive_and_wait();
  return r;
}
// A warp-wide reduction of one 32-bit value per lane.
template <class F>
inline unsigned emu_reduce(unsigned v, F f) {
  EmuWarp& w = emu_warp();
  w.u[threadIdx.x & 31] = v;
  w.bar.arrive_and_wait();
  unsigned r = w.u[0];
  for (int i = 1; i < 32; ++i) r = f(r, w.u[i]);
  w.bar.arrive_and_wait();
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
  w.bar.arrive_and_wait();
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
  w.bar.arrive_and_wait();
  for (int r = 0; r < 4; ++r) c[r] = out[r];
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
        blockDim = {unsigned(threads), 1, 1};
        gridDim = {unsigned(grid), 1, 1};
        emu_block = &blk;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
template <class K, class... A>
void emu_launch_concurrent(K kernel, int grid, int threads, size_t smem, cudaStream_t, A... args) {
  std::vector<std::unique_ptr<EmuBlock>> blks;
  std::vector<std::vector<unsigned char>> mems;
  std::vector<std::thread> ts;
  mems.reserve(grid);
  for (int b = 0; b < grid; ++b) {
    blks.push_back(std::make_unique<EmuBlock>(threads));
    mems.emplace_back(smem + 16);
    blks.back()->smem = mems.back().data();
  }
  for (int b = 0; b < grid; ++b)
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        threadIdx = {unsigned(t), 0, 0};
        blockIdx = {unsigned(b), 0, 0};
        blockDim = {unsigned(threads), 1, 1};
        gridDim = {unsigned(grid), 1, 1};
        emu_block = blks[b].get();
        kernel(args...);
      });
  for (auto& t : ts) t.join();
}
