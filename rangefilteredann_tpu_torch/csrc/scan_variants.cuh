// Shared body of the scan-variant kernels (scan_v2.cu, scan_v3.cu,
// scan_v3b.cu), hand-written CUDA C++ for sm_90a.
//
// The three TPU kernels of tools/exp_scan2.py, exp_scan3.py and
// exp_scan3b.py compute the same range-masked (dist, id) top-k as the
// production scan and differ only in how they extract the k best of a
// [queries, tile] block of distances. So do these: one kernel body, here,
// computes the block, and each source passes its own extraction policy.
//
// Common ground, on the card:
//   * A CTA takes QB queries, sorted by window midpoint by the wrapper, and
//     walks the union of their windows tile by tile, with a loop inside the
//     block (the TPU's sequential grid axis does not carry over).
//   * Each tile's [QB, tile] fp32 distances are staged in shared memory,
//     each query's window masked there (+inf outside it). The product runs
//     in sub-tiles of SUB points, DK columns at a time: fp32 FMAs on the CUDA
//     cores, or, for v2's bf16 mode, mma.sync m16n8k16 bf16 with fp32
//     accumulation on the tensor cores.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace scanvar {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 256;             // points per sub-tile of the product
constexpr int DK = 16;               // columns per staged chunk (one mma k-step)
constexpr int GROUP = 128;           // points per group-minima table entry
constexpr int MAX_TILE = 32 * GROUP; // one table entry per lane
constexpr int MAX_K = 256;
constexpr int MAX_SMEM = 231424;     // dynamic shared memory a CTA may take
constexpr int BF_LD = DK + 8;        // bf16 row stride of staged chunks
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of one CTA: the distance tile, the QB running lists,
// and the staging of one chunk (the fp32 staging is the larger of the two).
inline size_t smem_bytes(int qb, int tile, int k) {
  return (size_t)qb * tile * 4 + (size_t)qb * k * 8 +
         (size_t)(DK * qb + SUB * (DK + 1)) * 4;
}

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
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

// Insert (cd, ci) into one query's sorted list of k entries (csrc/
// scan_topk.cu's warp_insert). Called by every lane with the same candidate.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int k,
                                            float cd, int ci, int lane) {
  if (!lex_less(cd, ci, ld[k - 1], li[k - 1])) return;  // warp-uniform
  int cnt = 0;
  for (int e = lane; e < k; e += 32) cnt += lex_less(ld[e], li[e], cd, ci);
  const int pos = __reduce_add_sync(FULL, cnt);
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16x16, row) * B (16x8, col), bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One sub-tile of SUB points, bf16 on the tensor cores (v2's bf16 mode, L2
// only): query and points rounded to bf16 (round to nearest even, as
// astype(bfloat16) does), products accumulated in fp32. Warp w owns points
// [32w, 32w + 32) of the sub-tile: QB/16 m-tiles x 4 n-tiles of 8.
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A registers hold
// (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8,
// k 2t+8..); B registers (k 2t..2t+1, col g), (k 2t+8.., col g); C holds
// (row g, cols 2t, 2t+1) and (row g+8, cols 2t, 2t+1).
template <int QB>
__device__ __forceinline__ void subtile_bf16(
    const float* __restrict__ data, long long n_rows, int d_pad, int d_stream,
    const float* __restrict__ norms, const float* __restrict__ queries,
    int nq, int q0, int row0, int p0, const int* s_start, const int* s_end,
    float* dist, int tile, float* stage) {
  constexpr int MT = QB / 16;
  constexpr int NT = SUB / WARPS / 8;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(stage);  // [QB][BF_LD]
  __nv_bfloat16* Bs = As + QB * BF_LD;                          // [SUB][BF_LD]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int k0 = 0; k0 < d_stream; k0 += DK) {
    __syncthreads();
    for (int v = tid; v < SUB * DK / 4; v += THREADS) {
      const int r = v / (DK / 4);
      const int c = (v % (DK / 4)) * 4;
      const long long row = static_cast<long long>(row0) + r;
      const float4 x = row < n_rows
          ? *reinterpret_cast<const float4*>(data + row * d_pad + k0 + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(Bs + r * BF_LD + c);
      b[0] = __floats2bfloat162_rn(x.x, x.y);
      b[1] = __floats2bfloat162_rn(x.z, x.w);
    }
    for (int v = tid; v < QB * DK / 2; v += THREADS) {
      const int qq = v / (DK / 2);
      const int c = (v % (DK / 2)) * 2;
      float x0 = 0.f, x1 = 0.f;
      if (q0 + qq < nq) {
        const float* src = queries + static_cast<long long>(q0 + qq) * d_stream + k0 + c;
        x0 = src[0];
        x1 = src[1];
      }
      *reinterpret_cast<__nv_bfloat162*>(As + qq * BF_LD + c) =
          __floats2bfloat162_rn(x0, x1);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const __nv_bfloat16* a = As + (m * 16 + g) * BF_LD + 2 * t;
      const uint32_t a0 = ld32(a), a1 = ld32(a + 8 * BF_LD);
      const uint32_t a2 = ld32(a + 8), a3 = ld32(a + 8 * BF_LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* b = Bs + (warp * 32 + n * 8 + g) * BF_LD + 2 * t;
        mma_bf16(acc[m][n], a0, a1, a2, a3, ld32(b), ld32(b + 8));
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = warp * 32 + n * 8 + 2 * t + e;
      const int col = row0 + p;
      const float nrm = col < n_rows ? norms[col] : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          put(dist, tile, m * 16 + g + 8 * h, p0 + p, col,
              nrm - 2.0f * acc[m][n][2 * h + e], s_start, s_end);
    }
}

// The kernel body. Extract::run(row, groups, base, ld, li, k, unroll, lane)
// is the variant's extraction of one query against one tile.
template <int QB, bool BF16, class Extract>
__global__ void __launch_bounds__(THREADS, 2) scan_variant_kernel(
    const float* __restrict__ data, long long n_rows, int d_pad, int d_stream,
    const float* __restrict__ norms, const float* __restrict__ queries,
    const int* __restrict__ starts, const int* __restrict__ ends, int nq,
    int k, int metric_l2, int n_real, int tile, int unroll,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  static_assert(QB % 4 == 0 && QB <= 32, "4 rows of threads, one warp of windows");
  static_assert(!BF16 || QB % 16 == 0, "mma m-tiles of 16 queries");
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
    for (int p0 = 0; p0 < tile; p0 += SUB) {
      if constexpr (BF16)
        subtile_bf16<QB>(data, n_rows, d_pad, d_stream, norms, queries, nq, q0,
                         base + p0, p0, s_start, s_end, dist, tile, stage);
      else
        subtile_fp32<QB>(data, n_rows, d_pad, d_stream, norms, queries, nq, q0,
                         base + p0, p0, s_start, s_end, metric_l2, dist, tile,
                         stage);
    }
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

template <int QB, bool BF16, class Extract>
int launch_qb(const void* data, long long n_rows, int d_pad, int d_stream,
              const void* norms, const void* queries, const void* starts,
              const void* ends, int nq, int k, int metric_l2, int n_real,
              int tile, int unroll, void* out_d, void* out_i,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(QB, tile, k);
  auto kern = scan_variant_kernel<QB, BF16, Extract>;
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

// Checks the arguments and dispatches on (qblock, bf16); only a variant with
// HAS_BF16 has the bf16 mode. Returns cudaGetLastError() after the launch
// (0 on success), or -1 for arguments the kernel refuses.
template <class Extract, bool HAS_BF16>
int launch_variant(int qblock, int bf16, const void* data, long long n_rows,
                   int d_pad, int d_stream, const void* norms,
                   const void* queries, const void* starts, const void* ends,
                   int nq, int k, int metric_l2, int n_real, int tile,
                   int unroll, void* out_d, void* out_i, void* stream) {
  if (nq <= 0) return 0;
  if (k < 1 || k > MAX_K || d_stream <= 0 || d_stream % DK != 0 ||
      d_stream > d_pad || n_real > n_rows || tile < SUB || tile % SUB != 0 ||
      tile > MAX_TILE || unroll < 1 || smem_bytes(qblock, tile, k) > MAX_SMEM ||
      (bf16 && (!HAS_BF16 || !metric_l2)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCANVAR_LAUNCH(QB_, BF_)                                              \
  return launch_qb<QB_, BF_, Extract>(data, n_rows, d_pad, d_stream, norms,   \
                                      queries, starts, ends, nq, k, metric_l2, \
                                      n_real, tile, unroll, out_d, out_i, s)
  switch (qblock) {
    case 8:
      if (bf16) return -1;
      SCANVAR_LAUNCH(8, false);
    case 16:
      if constexpr (HAS_BF16) {
        if (bf16) SCANVAR_LAUNCH(16, true);
      }
      SCANVAR_LAUNCH(16, false);
    case 32:
      if constexpr (HAS_BF16) {
        if (bf16) SCANVAR_LAUNCH(32, true);
      }
      SCANVAR_LAUNCH(32, false);
    default:
      break;
  }
#undef SCANVAR_LAUNCH
  return -1;
}

}  // namespace scanvar
