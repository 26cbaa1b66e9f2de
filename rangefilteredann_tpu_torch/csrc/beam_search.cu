// Greedy beam search over inline neighbour blocks, hand-written CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel rangefilteredann_tpu/ops/pallas_beam.py::_beam_kernel
// (wrapper _pallas_beam_search_inline). Bound from PyTorch by ctypes through
// rangefilteredann_tpu_torch/ops/beam.py, whose plain version is
// ops/beam_search.batched_beam_search(expand=1, k=0, inline blocks).
//
// What it computes, for each query q (the plain version's function):
//   * init: an active query's frontier is slot 0 = (d0[q], starts[q]) and
//     (+inf, EMPTY_ID) elsewhere, n_vis = 0, cmps = 1; an inactive query
//     returns an empty frontier and zero counters.
//   * while some slot is unexplored and n_vis < limit: expand the first
//     unexplored slot of the (dist, id)-sorted frontier; read the node's R
//     neighbour ids, norms and its [R, w] block of neighbour vectors; the
//     distance of candidate j is nrm_j - 2 ip_j (L2, shifted) or -ip_j
//     (MIPS), ip_j = scale[node] * (q . x_j) for int8-quantized blocks;
//     every candidate with id >= 0 counts in cmps.
//   * a candidate is kept only when strictly below the pre-step tail
//     distance and lexicographically below the current tail; kept
//     candidates are inserted in order j = 0..R-1, skipping an id already in
//     the frontier, behind equal (dist, id <= cid) entries; the slots behind
//     shift one place with their explored flags and the last slot drops.
//     This sequential insertion equals the plain version's batch merge.
// Blocks of fp32, bf16 (upcast), native int8/uint8 and int8 with a per-node
// scale; for byte blocks the wrapper rounds the query to bf16 first (byte x
// bf16 products are exact in fp32), as the reference's operand policy does.
//
// Bound on an H100 SXM. A step reads one block of R * w elements plus R ids
// and norms and does 2 * R * w flops: about 1/2 flop per fp32 byte, far below
// the card's ~20 flop/byte balance point, so the work is bound by bytes
// (3.35 TB/s) -- and, for a simple design, by the latency of the dependent
// chain select -> load -> reduce -> insert of every step.
//
// What this simple design does about it:
//   * One warp per query, four queries per CTA, no block-wide barriers: a
//     query's loop runs on its own and a finished warp leaves.
//   * The frontier (dist, id, explored flag: 9 bytes a slot, 18 KB at beam
//     2048) and the query (w floats) live in shared memory.
//   * Lane l computes candidates l and l + 32: each dot product is one FMA
//     chain over the w columns in order (the order of a GEMM's inner loop),
//     reading the lane's row 4 elements at a time. A node's distance does
//     not depend on which block it was read from.
//   * Selection keeps a lower bound on the first unexplored slot, so a step
//     scans from there by 32-slot ballots; a candidate whose distance is not
//     below the pre-step tail costs one compare; an admitted one costs one
//     warp pass over the frontier (duplicate test and insert position
//     together) and a 32-slot-at-a-time shift.
// Not done yet (later work): several queries' blocks in flight per warp,
// cp.async/TMA prefetch of the next block while inserting, a parallel merge.
//
// Caps: 1 <= R <= 64 (two candidates per lane), w a multiple of 32 up to 256,
// 1 <= beam <= 2048 (4 warps x 19 KB of shared memory); the wrapper raises
// outside them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int EMPTY_ID = 0x7fffffff;
constexpr int WARPS = 4;              // queries per CTA, one warp each
constexpr int THREADS = WARPS * 32;
constexpr int MAX_R = 64;
constexpr int MAX_W = 256;
constexpr int MAX_BEAM = 2048;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ size_t warp_smem_bytes(int beam, int w) {
  // the query (4 bytes a column), then dist (4) + id (4) + explored flag (1)
  // per slot, rounded to 16 bytes
  return (static_cast<size_t>(w) * 4 + static_cast<size_t>(beam) * 9 + 15) / 16 * 16;
}

// Four consecutive elements of a row as floats (rows are 4-element aligned).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(a); x[1] = __high2float(a);
  x[2] = __low2float(b); x[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const uint8_t* p, float (&x)[4]) {
  const uchar4 v = *reinterpret_cast<const uchar4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ bool lex_lt(float d, int i, float td, int ti) {
  return d < td || (d == td && i < ti);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
beam_search_kernel(const T* __restrict__ vecs,        // [m, R, w]
                   const int* __restrict__ nbrs,      // [m, R]
                   const float* __restrict__ nrms,    // [m, R]
                   const float* __restrict__ scale,   // [m] or nullptr
                   const float* __restrict__ queries, // [Q, w]
                   const int* __restrict__ starts,    // [Q]
                   const float* __restrict__ d0,      // [Q]
                   const uint8_t* __restrict__ active,// [Q]
                   int n_q, int m, int R, int w, int beam, int limit, int l2,
                   int* __restrict__ out_ids,         // [Q, beam]
                   float* __restrict__ out_d,         // [Q, beam]
                   int* __restrict__ out_nvis,        // [Q]
                   int* __restrict__ out_cmps) {      // [Q]
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= n_q) return;  // the whole warp leaves together

  float* qs = reinterpret_cast<float*>(smem + warp * warp_smem_bytes(beam, w));
  float* fd = qs + w;
  int* fid = reinterpret_cast<int*>(fd + beam);
  uint8_t* fe = reinterpret_cast<uint8_t*>(fid + beam);
  for (int i = lane; i < beam; i += 32) {
    fd[i] = INFINITY;
    fid[i] = EMPTY_ID;
    fe[i] = 0;
  }
  __syncwarp();

  int n_vis = 0, cmps = 0;
  if (active[q]) {
    if (lane == 0) {
      fd[0] = d0[q];
      fid[0] = starts[q];
    }
    cmps = 1;
    for (int i = lane; i < w; i += 32) qs[i] = queries[static_cast<size_t>(q) * w + i];
    __syncwarp();

    int first = 0;  // every slot before `first` is explored
    while (n_vis < limit) {
      __syncwarp();  // the last step's frontier writes are visible to all lanes
      // --- select: the first unexplored slot (the frontier is sorted, and
      // empty slots, (+inf, EMPTY_ID), sort last) ---
      int s = -1;
      for (int c = first; c < beam; c += 32) {
        const int i = c + lane;
        const int id = i < beam ? fid[i] : EMPTY_ID;
        const unsigned un = __ballot_sync(FULL, id != EMPTY_ID && !fe[min(i, beam - 1)]);
        if (un) {
          s = c + __ffs(un) - 1;
          break;
        }
        if (__ballot_sync(FULL, id == EMPTY_ID)) break;  // only empties follow
      }
      if (s < 0) break;
      const int node = min(max(fid[s], 0), m - 1);
      __syncwarp();
      if (lane == 0) fe[s] = 1;
      first = s + 1;
      ++n_vis;

      // --- candidates: lane l holds candidates l and l + 32 ---
      const size_t base = static_cast<size_t>(node) * R;
      int cid0 = lane < R ? nbrs[base + lane] : -1;
      int cid1 = lane + 32 < R ? nbrs[base + lane + 32] : -1;
      const float nrm0 = lane < R ? nrms[base + lane] : 0.f;
      const float nrm1 = lane + 32 < R ? nrms[base + lane + 32] : 0.f;
      const float sc = scale != nullptr ? scale[node] : 1.f;
      const bool has0 = lane < R, has1 = lane + 32 < R;
      const T* row0 = vecs + (base + min(lane, R - 1)) * w;
      const T* row1 = vecs + (base + min(lane + 32, R - 1)) * w;
      float acc0 = 0.f, acc1 = 0.f;
      for (int k = 0; k < w; k += 4) {
        const float4 qk = *reinterpret_cast<const float4*>(qs + k);  // broadcast
        float x[4];
        if (has0) {
          load4(row0 + k, x);
          acc0 = fmaf(qk.x, x[0], acc0);
          acc0 = fmaf(qk.y, x[1], acc0);
          acc0 = fmaf(qk.z, x[2], acc0);
          acc0 = fmaf(qk.w, x[3], acc0);
        }
        if (has1) {
          load4(row1 + k, x);
          acc1 = fmaf(qk.x, x[0], acc1);
          acc1 = fmaf(qk.y, x[1], acc1);
          acc1 = fmaf(qk.z, x[2], acc1);
          acc1 = fmaf(qk.w, x[3], acc1);
        }
      }
      if (scale != nullptr) {
        acc0 = sc * acc0;
        acc1 = sc * acc1;
      }
      float cd0 = l2 ? nrm0 - 2.f * acc0 : -acc0;
      float cd1 = l2 ? nrm1 - 2.f * acc1 : -acc1;
      const bool v0 = cid0 >= 0, v1 = cid1 >= 0;
      cmps += __popc(__ballot_sync(FULL, v0)) + __popc(__ballot_sync(FULL, v1));
      if (!v0) { cd0 = INFINITY; cid0 = EMPTY_ID; }
      if (!v1) { cd1 = INFINITY; cid1 = EMPTY_ID; }

      // --- admit and insert, in candidate order ---
      const float wd0 = fd[beam - 1];  // the pre-step tail
      for (int half = 0; half < 2; ++half) {
        const float my_d = half ? cd1 : cd0;
        const int my_id = half ? cid1 : cid0;
        unsigned pre = __ballot_sync(FULL, my_id != EMPTY_ID && my_d < wd0);
        while (pre) {
          const int j = __ffs(pre) - 1;
          pre &= pre - 1;
          const float cd = __shfl_sync(FULL, my_d, j);
          const int cid = __shfl_sync(FULL, my_id, j);
          if (!lex_lt(cd, cid, fd[beam - 1], fid[beam - 1])) continue;
          bool dup = false;
          int pos = 0;  // slots that stay ahead of the candidate
          for (int c = 0; c < beam; c += 32) {
            const int i = c + lane;
            bool is_dup = false, stay = false;
            if (i < beam) {
              const float d = fd[i];
              const int id = fid[i];
              is_dup = id == cid;
              stay = d < cd || (d == cd && id <= cid);
            }
            if (__any_sync(FULL, is_dup)) {
              dup = true;
              break;
            }
            pos += __popc(__ballot_sync(FULL, stay));
          }
          if (dup) continue;
          // shift slots [pos, beam - 1) up by one, the top 32 first
          for (int hi = beam - 1; hi > pos; hi -= 32) {
            const int i = hi - lane;
            const bool mv = i > pos;
            float d = 0.f;
            int id = 0;
            uint8_t e = 0;
            if (mv) {
              d = fd[i - 1];
              id = fid[i - 1];
              e = fe[i - 1];
            }
            __syncwarp();
            if (mv) {
              fd[i] = d;
              fid[i] = id;
              fe[i] = e;
            }
            __syncwarp();
          }
          if (lane == 0) {
            fd[pos] = cd;
            fid[pos] = cid;
            fe[pos] = 0;
          }
          __syncwarp();
          first = min(first, pos);
        }
      }
    }
  }

  __syncwarp();
  const size_t out = static_cast<size_t>(q) * beam;
  for (int i = lane; i < beam; i += 32) {
    out_ids[out + i] = fid[i];
    out_d[out + i] = fd[i];
  }
  if (lane == 0) {
    out_nvis[q] = n_vis;
    out_cmps[q] = cmps;
  }
}

template <typename T>
int launch(const void* vecs, const int* nbrs, const float* nrms, const float* scale,
           const float* queries, const int* starts, const float* d0,
           const uint8_t* active, int n_q, int m, int R, int w, int beam, int limit,
           int l2, int* out_ids, float* out_d, int* out_nvis, int* out_cmps,
           cudaStream_t stream) {
  const size_t smem = WARPS * warp_smem_bytes(beam, w);
  cudaError_t err = cudaFuncSetAttribute(beam_search_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_q + WARPS - 1) / WARPS;
  beam_search_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(vecs), nbrs, nrms, scale, queries, starts, d0, active,
      n_q, m, R, w, beam, limit, l2, out_ids, out_d, out_nvis, out_cmps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int8, 3 uint8. Returns 0 or a CUDA error
// code; -1 for arguments outside the caps.
extern "C" int beam_search_launch(const void* vecs, int dtype, const int* nbrs,
                                  const float* nrms, const float* scale,
                                  const float* queries, const int* starts,
                                  const float* d0, const uint8_t* active, int n_q,
                                  int m, int R, int w, int beam, int limit, int l2,
                                  int* out_ids, float* out_d, int* out_nvis,
                                  int* out_cmps, void* stream) {
  if (n_q < 1 || m < 1 || R < 1 || R > MAX_R || w < 32 || w > MAX_W || w % 32 != 0 ||
      beam < 1 || beam > MAX_BEAM)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(vecs, nbrs, nrms, scale, queries, starts, d0, active, n_q, m,
                           R, w, beam, limit, l2, out_ids, out_d, out_nvis, out_cmps, s);
    case 1:
      return launch<__nv_bfloat16>(vecs, nbrs, nrms, scale, queries, starts, d0, active,
                                   n_q, m, R, w, beam, limit, l2, out_ids, out_d,
                                   out_nvis, out_cmps, s);
    case 2:
      return launch<int8_t>(vecs, nbrs, nrms, scale, queries, starts, d0, active, n_q, m,
                            R, w, beam, limit, l2, out_ids, out_d, out_nvis, out_cmps, s);
    case 3:
      return launch<uint8_t>(vecs, nbrs, nrms, scale, queries, starts, d0, active, n_q,
                             m, R, w, beam, limit, l2, out_ids, out_d, out_nvis,
                             out_cmps, s);
    default:
      return -1;
  }
}
