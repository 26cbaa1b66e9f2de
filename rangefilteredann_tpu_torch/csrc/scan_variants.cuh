// The block-per-CTA body of the scan variant v3 (scan_v3.cu), hand-written
// CUDA C++ for sm_90a. (v2 and v3b run on the persistent item body,
// scan_items.cuh; v3 moves there in its own redesign.)
//
// The TPU kernel of tools/exp_scan3.py computes the same range-masked
// (dist, id) top-k as the production scan and differs only in how it
// extracts the k best of a [queries, tile] block of distances. So does this
// body: it computes the block, and the source passes its extraction policy.
//
// On the card:
//   * A CTA takes QB queries, sorted by window midpoint by the wrapper, and
//     walks the union of their windows tile by tile, with a loop inside the
//     block (the TPU's sequential grid axis does not carry over).
//   * Each tile's [QB, tile] fp32 distances are staged in shared memory,
//     each query's window masked there (+inf outside it). The product runs
//     in sub-tiles of SUB points, DK columns at a time, as fp32 FMAs on the
//     CUDA cores.
//   * Then one warp per query (each warp takes QB / WARPS queries in turn)
//     runs the variant's extraction against the tile, with a table of
//     per-128-point group minima held one entry per lane (tile <= 4096), and
//     inserts into the query's running (dist, id) list in shared memory.
//     Each warp stops on its own; on the TPU one block-wide jnp.any set the
//     pace for every query. Same result, different work.
//   * Every insert compares (dist, id) lexicographically, as the production
//     kernel does, so the order in which warps visit candidates cannot change
//     the list: the lowest id first among equal distances.

#pragma once

#include "scan_common.cuh"

namespace scanvar {

using namespace scan_common;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 256;             // points per sub-tile of the product
constexpr int DK = 16;               // columns per staged chunk (one mma k-step)
constexpr int GROUP = 128;           // points per group-minima table entry
constexpr int MAX_TILE = 32 * GROUP; // one table entry per lane
constexpr int MAX_SMEM = 231424;     // dynamic shared memory a CTA may take

// Dynamic shared memory of one CTA: the distance tile, the QB running lists,
// and the staging of one chunk.
inline size_t smem_bytes(int qb, int tile, int k) {
  return (size_t)qb * tile * 4 + (size_t)qb * k * 8 +
         (size_t)(DK * qb + SUB * (DK + 1)) * 4;
}

// (min, first argmin) of group g of one query's distance row.
__device__ __forceinline__ void group_min(const float* row, int g, int lane,
                                          float& m, int& a) {
  const float* p = row + g * GROUP;
  m = p[lane];
  a = lane;
#pragma unroll
  for (int j = 1; j < GROUP / 32; ++j) {
    const float v = p[lane + 32 * j];
    if (v < m) { m = v; a = lane + 32 * j; }
  }
  warp_argmin(m, a);
}

// The group table: lane g holds (min, argmin) of group g; other lanes +inf.
__device__ __forceinline__ void build_tables(const float* row, int groups,
                                             int lane, float& gm, int& am) {
  gm = INFINITY;
  am = 0;
  for (int g = 0; g < groups; ++g) {
    float m;
    int a;
    group_min(row, g, lane, m, a);
    if (lane == g) { gm = m; am = a; }
  }
}

// The table's best head: its distance, group and id. Equal minima go to the
// lowest group, whose ids are lower, so this is the (dist, id) minimum of
// the heads.
__device__ __forceinline__ void pick(float gm, int am, int lane, int base,
                                     float& m, int& gsel, int& cid) {
  m = gm;
  gsel = lane;
  warp_argmin(m, gsel);
  cid = base + gsel * GROUP + __shfl_sync(FULL, am, gsel);
}

__device__ __forceinline__ bool improves(float m, int cid, const float* ld,
                                         const int* li, int k) {
  return m < INFINITY && lex_less(m, cid, ld[k - 1], li[k - 1]);
}

// Write one computed distance into the tile, masked by the query's window.
__device__ __forceinline__ void put(float* dist, int tile, int ql, int p,
                                    int col, float dd, const int* s_start,
                                    const int* s_end) {
  dist[ql * tile + p] =
      (col >= s_start[ql] && col < s_end[ql]) ? dd : INFINITY;
}

// One sub-tile of SUB points, fp32: 4 rows of threads along the queries
// (QB / 4 queries each) x 64 lanes along the points (4 points each).
template <int QB>
__device__ __forceinline__ void subtile_fp32(
    const float* __restrict__ data, long long n_rows, int d_pad, int d_stream,
    const float* __restrict__ norms, const float* __restrict__ queries,
    int nq, int q0, int row0, int p0, const int* s_start, const int* s_end,
    int metric_l2, float* dist, int tile, float* stage) {
  constexpr int QPT = QB / 4;
  constexpr int PL = THREADS / 4;
  constexpr int PPT = SUB / PL;
  float* As = stage;              // [DK][QB]
  float* Bs = stage + DK * QB;    // [SUB][DK + 1]
  const int tid = threadIdx.x;
  const int qg = tid / PL;
  const int pl = tid % PL;
  float acc[QPT][PPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j)
#pragma unroll
    for (int i = 0; i < PPT; ++i) acc[j][i] = 0.f;

  for (int k0 = 0; k0 < d_stream; k0 += DK) {
    __syncthreads();  // the previous chunk is consumed
    for (int v = tid; v < SUB * DK / 4; v += THREADS) {
      const int r = v / (DK / 4);
      const int c = (v % (DK / 4)) * 4;
      const long long row = static_cast<long long>(row0) + r;
      const float4 x = row < n_rows
          ? *reinterpret_cast<const float4*>(data + row * d_pad + k0 + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      float* b = Bs + r * (DK + 1) + c;
      b[0] = x.x; b[1] = x.y; b[2] = x.z; b[3] = x.w;
    }
    for (int v = tid; v < DK * QB; v += THREADS) {
      const int qq = v / DK;
      const int c = v % DK;
      As[c * QB + qq] = q0 + qq < nq
          ? queries[static_cast<long long>(q0 + qq) * d_stream + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      float a[QPT], b[PPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) a[j] = As[kk * QB + qg * QPT + j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) b[i] = Bs[(pl + PL * i) * (DK + 1) + kk];
#pragma unroll
      for (int j = 0; j < QPT; ++j)
#pragma unroll
        for (int i = 0; i < PPT; ++i) acc[j][i] = fmaf(a[j], b[i], acc[j][i]);
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pl + PL * i;
    const int col = row0 + p;
    const float nrm = (metric_l2 && col < n_rows) ? norms[col] : 0.f;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      // 2 * acc is exact, so a contracted multiply-add rounds the same way
      const float dd = metric_l2 ? nrm - 2.0f * acc[j][i] : -acc[j][i];
      put(dist, tile, qg * QPT + j, p0 + p, col, dd, s_start, s_end);
    }
  }
}

// The kernel body. Extract::run(row, groups, base, ld, li, k, unroll, lane)
// is the variant's extraction of one query against one tile.
template <int QB, class Extract>
__global__ void __launch_bounds__(THREADS, 2) scan_variant_kernel(
    const float* __restrict__ data, long long n_rows, int d_pad, int d_stream,
    const float* __restrict__ norms, const float* __restrict__ queries,
    const int* __restrict__ starts, const int* __restrict__ ends, int nq,
    int k, int metric_l2, int n_real, int tile, int unroll,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  static_assert(QB % 4 == 0 && QB <= 32, "4 rows of threads, one warp of windows");
  extern __shared__ float4 smem4[];
  float* dist = reinterpret_cast<float*>(smem4);         // [QB][tile]
  float* Ld = dist + QB * tile;                          // [QB][k]
  int* Li = reinterpret_cast<int*>(Ld + QB * k);         // [QB][k]
  float* stage = reinterpret_cast<float*>(Li + QB * k);  // one chunk
  __shared__ int s_start[QB], s_end[QB], s_range[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QB;

  for (int e = tid; e < QB * k; e += THREADS) {
    Ld[e] = INFINITY;
    Li[e] = EMPTY_ID;
  }
  if (warp == 0) {
    int s = 0, e = 0;
    if (lane < QB && q0 + lane < nq) {
      s = starts[q0 + lane];
      e = min(ends[q0 + lane], n_real);
    }
    if (lane < QB) {
      s_start[lane] = s;
      s_end[lane] = e;
    }
    const bool nonempty = e > s;
    const int lo = __reduce_min_sync(FULL, nonempty ? max(s, 0) : INT_MAX);
    const int hi = __reduce_max_sync(FULL, nonempty ? e : 0);
    if (lane == 0) {
      s_range[0] = lo;
      s_range[1] = hi;
    }
  }
  __syncthreads();
  const int lo = s_range[0];
  const int hi = s_range[1];
  const int t_begin = lo == INT_MAX ? 0 : lo / tile;
  const int t_end = lo == INT_MAX ? 0 : (hi + tile - 1) / tile;
  const int groups = tile / GROUP;

  for (int t = t_begin; t < t_end; ++t) {
    const int base = t * tile;
    for (int p0 = 0; p0 < tile; p0 += SUB)
      subtile_fp32<QB>(data, n_rows, d_pad, d_stream, norms, queries, nq, q0,
                       base + p0, p0, s_start, s_end, metric_l2, dist, tile,
                       stage);
    __syncthreads();  // the tile's distances are complete
    for (int ql = warp; ql < QB && q0 + ql < nq; ql += WARPS) {
      if (max(s_start[ql], base) >= min(s_end[ql], base + tile)) continue;
      Extract::run(dist + ql * tile, groups, base, Ld + ql * k, Li + ql * k, k,
                   unroll, lane);
    }
    __syncthreads();  // extraction is done before the next tile overwrites
  }

  for (int e = tid; e < QB * k; e += THREADS) {
    const int ql = e / k;
    if (q0 + ql < nq) {
      const long long o = static_cast<long long>(q0 + ql) * k + e % k;
      out_d[o] = Ld[e];
      out_i[o] = Li[e];
    }
  }
}

template <int QB, class Extract>
int launch_qb(const void* data, long long n_rows, int d_pad, int d_stream,
              const void* norms, const void* queries, const void* starts,
              const void* ends, int nq, int k, int metric_l2, int n_real,
              int tile, int unroll, void* out_d, void* out_i,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(QB, tile, k);
  auto kern = scan_variant_kernel<QB, Extract>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(nq + QB - 1) / QB, THREADS, smem, stream>>>(
      static_cast<const float*>(data), n_rows, d_pad, d_stream,
      static_cast<const float*>(norms), static_cast<const float*>(queries),
      static_cast<const int*>(starts), static_cast<const int*>(ends), nq, k,
      metric_l2, n_real, tile, unroll, static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// Checks the arguments and dispatches on qblock. Returns cudaGetLastError()
// after the launch (0 on success), or -1 for arguments the kernel refuses.
template <class Extract>
int launch_variant(int qblock, const void* data, long long n_rows, int d_pad,
                   int d_stream, const void* norms, const void* queries,
                   const void* starts, const void* ends, int nq, int k,
                   int metric_l2, int n_real, int tile, int unroll,
                   void* out_d, void* out_i, void* stream) {
  if (nq <= 0) return 0;
  if (k < 1 || k > MAX_K || d_stream <= 0 || d_stream % DK != 0 ||
      d_stream > d_pad || n_real > n_rows || tile < SUB || tile % SUB != 0 ||
      tile > MAX_TILE || unroll < 1 || smem_bytes(qblock, tile, k) > MAX_SMEM)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qblock) {
    case 8:
      return launch_qb<8, Extract>(data, n_rows, d_pad, d_stream, norms, queries, starts,
                                   ends, nq, k, metric_l2, n_real, tile, unroll, out_d,
                                   out_i, s);
    case 16:
      return launch_qb<16, Extract>(data, n_rows, d_pad, d_stream, norms, queries, starts,
                                    ends, nq, k, metric_l2, n_real, tile, unroll, out_d,
                                    out_i, s);
    case 32:
      return launch_qb<32, Extract>(data, n_rows, d_pad, d_stream, norms, queries, starts,
                                    ends, nq, k, metric_l2, n_real, tile, unroll, out_d,
                                    out_i, s);
    default:
      return -1;
  }
}

}  // namespace scanvar
