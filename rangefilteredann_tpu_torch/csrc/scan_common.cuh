// Device helpers shared by the scan kernels, hand-written CUDA C++ for
// sm_90a: the production scan (scan_topk.cu) and the persistent body of the
// variants v2, v3 and v3b (scan_items.cuh). One definition each, so that the
// (dist, id) order, the published bound and the merge of item lists cannot
// drift apart.
//
// Every list here is sorted by (dist, id) lexicographically (lowest id first
// among equal distances) and padded with (+inf, EMPTY_ID).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace scan_common {

constexpr int MAX_K = 256;
constexpr int MAX_SEGS = 32;     // segments a block at most: one merge lane each
constexpr int MERGE_WARPS = 4;   // warps a CTA of the merge kernel, one a query
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// *addr = min(*addr, v) for any two non-NaN floats: non-negative floats
// order as ints, negative ones in reverse as unsigned.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (v >= 0.f) atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// (v, i) of the lexicographically smallest pair over the warp, in all lanes.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (lex_less(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Insert (cd, ci) into one query's sorted list of k entries in shared
// memory. Called by every lane of the warp with the same candidate.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int k, float cd, int ci, int lane) {
  if (!lex_less(cd, ci, ld[k - 1], li[k - 1])) return;  // warp-uniform
  int cnt = 0;
  for (int e = lane; e < k; e += 32) cnt += lex_less(ld[e], li[e], cd, ci);
  const int pos = __reduce_add_sync(FULL, cnt);
  // shift [pos, k-1) one place right, 32 entries at a time from the top, so
  // each block's reads come before the writes of the block below it
  for (int base = (k - 1) & ~31; base >= 0; base -= 32) {
    const int e = base + lane;
    const bool move = e < k && e > pos;
    float pd = 0.f;
    int pi = 0;
    if (move) { pd = ld[e - 1]; pi = li[e - 1]; }
    __syncwarp();
    if (move) { ld[e] = pd; li[e] = pi; }
    else if (e == pos) { ld[e] = cd; li[e] = ci; }
    __syncwarp();
  }
}

// Asynchronous 16- and 4-byte copies into shared memory, holding no registers.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// The same for a count known only at run time, 0 to 2 (more waits for 2).
__device__ __forceinline__ void copy_wait(int pending) {
  if (pending >= 2) copy_wait<2>();
  else if (pending == 1) copy_wait<1>();
  else copy_wait<0>();
}

// One warp a query: merge the sorted lists that its block's items wrote
// (at most MAX_SEGS, one a lane) by (dist, id) into the caller's row. A
// holds nq, k, prefix (inclusive sum of items a block), part_d / part_i
// ([items, QB, k], an item's slot being its block's exclusive prefix plus
// its segment), order and out_d / out_i.
template <int QB, class A>
__global__ void __launch_bounds__(MERGE_WARPS * 32) merge_items(const A a) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (q >= a.nq) return;  // the whole warp
  const int k = a.k;
  const int b = q / QB;
  const int first = b > 0 ? a.prefix[b - 1] : 0;
  const int n = a.prefix[b] - first;
  const long long base = (static_cast<long long>(first + lane) * QB + q % QB) * k;
  int h = 0;
  float hd = INFINITY;
  int hi = EMPTY_ID;
  if (lane < n) {
    hd = a.part_d[base];
    hi = a.part_i[base];
  }
  const long long row = a.order[q] * k;
  for (int e = 0; e < k; ++e) {
    float bd = hd;
    int bi = hi, bl = lane;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, bd, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const int ol = __shfl_xor_sync(FULL, bl, off);
      if (lex_less(od, oi, bd, bi) || (od == bd && oi == bi && ol < bl)) {
        bd = od;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == 0) {
      a.out_d[row + e] = bd;
      a.out_i[row + e] = bi;
    }
    if (lane == bl && lane < n) {
      if (++h < k) {
        hd = a.part_d[base + h];
        hi = a.part_i[base + h];
      } else {
        hd = INFINITY;
        hi = EMPTY_ID;
      }
    }
  }
}

}  // namespace scan_common
