// Range-masked brute-force top-k scan, hand-written CUDA C++ for sm_90a.
//
// Replaces the TPU kernel rangefilteredann_tpu/ops/pallas_scan.py::_scan_kernel
// (wrapper pallas_scan_bruteforce). Bound from PyTorch by ctypes through
// rangefilteredann_tpu_torch/ops/scan.py, whose plain version is
// ops/bruteforce.scan_bruteforce.
//
// What it computes, for each query q with window [starts[q], ends[q]) over
// the label-sorted store:
//   dist(q, col) = norms[col] - 2 q.x_col   (L2, shifted)   or   -q.x_col (MIPS)
// for every col with starts[q] <= col < ends[q] and col < n_real, and the k
// smallest (dist, id) pairs in lexicographic order (lowest id first among equal
// distances), padded with (+inf, EMPTY_ID). Float stores multiply in fp32 FMA
// (no TF32); byte stores are widened to fp32 here, and the wrapper rounds the
// query to bf16 first, as the reference's operand policy does (byte x bf16
// products are exact in fp32).
//
// Bound on an H100 SXM. The work is 2 * sum_q(window_q) * d floating-point
// operations and it must stay fp32 to keep the reference's ordering, so it
// runs on the CUDA cores (67 TFLOP/s fp32), not the tensor cores. The bytes it
// must move are the distinct rows the windows cover, read once: at the main
// shape (1M x 128 fp32, windows of 1/4 of the store, 10,240 queries) that is
// ~0.5 GB against ~0.66 TFLOP, so the bound is the operations (~10 ms against
// ~0.15 ms of memory time).
//
// What this simple design does about it:
//   * One CTA takes QB = 32 queries, sorted by window midpoint by the wrapper,
//     and walks the union of their windows in tiles of 256 points with a loop
//     inside the block (the TPU's sequential grid axis does not carry over).
//   * Each tile is staged through shared memory in chunks of 32 columns,
//     converted to fp32; the next chunk is fetched into registers while the
//     block computes on this one. Each lane accumulates an 8-query x 4-point
//     register tile, so one chunk costs 32 FMAs per 6 shared-memory loads.
//   * The running top-k costs O(1) per candidate: a lexicographic compare
//     against the query's current k-th entry. Only candidates that pass (about
//     k * ln(window / k) over a whole scan) are inserted, by the whole warp,
//     into a sorted list in shared memory. Warps along the points keep their
//     own lists; the lists are merged once at the end.
//   * Rows re-read by neighbouring query blocks come mostly from the 50 MB L2.
// Not done yet (later work): TMA staging, splitting one
// block's windows over several CTAs for occupancy, error-compensated 3xTF32
// wgmma to lift the fp32 CUDA-core bound.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int QB = 32;                // queries per CTA
constexpr int QPW = 8;                // queries per warp
constexpr int QGROUPS = QB / QPW;     // warps along the queries
constexpr int NP = 2;                 // warps along the points
constexpr int PPL = 4;                // points per lane
constexpr int HALF = 32 * PPL;        // points per warp in one tile
constexpr int TILE = HALF * NP;       // points per tile
constexpr int DK = 32;                // columns per staged chunk
constexpr int WARPS = QGROUPS * NP;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_K = 256;
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

static_assert(QB == 32, "block setup reduces the block's windows in one warp");
static_assert(DK % 4 == 0 && QB % 4 == 0, "float4 staging");

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// A raw 16-byte vector of a store row chunk, widened to fp32.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
  }
};

template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void widen(const uint4& u, float* out) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff));
  }
};

template <> struct Vec<uint8_t> {
  static constexpr int N = 16;
  __device__ static void widen(const uint4& u, float* out) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = static_cast<float>((w[i / 4] >> (8 * (i % 4))) & 0xff);
  }
};

// Insert (cd, ci) into one query's sorted list of k entries. Called by every
// lane of the warp with the same candidate; the list lives in shared memory.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int k,
                                            float cd, int ci, int lane) {
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

template <typename T, bool L2>
__global__ void __launch_bounds__(THREADS, 2) scan_topk_kernel(
    const T* __restrict__ data, long long n_rows, int d_pad, int d_stream,
    const float* __restrict__ norms, const float* __restrict__ queries,
    int q_ld, const int* __restrict__ starts, const int* __restrict__ ends,
    int nq, int k, int n_real, float* __restrict__ out_d,
    int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);       // [DK][QB]
  float* Bs = As + DK * QB;                          // [TILE][DK + 1]
  float* Ld = Bs + TILE * (DK + 1);                  // [NP][QB][k]
  int* Li = reinterpret_cast<int*>(Ld + NP * QB * k);  // [NP][QB][k]
  __shared__ int s_start[QB], s_end[QB], s_range[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qg = warp % QGROUPS;
  const int half = warp / QGROUPS;
  const int q0 = blockIdx.x * QB;

  for (int e = tid; e < NP * QB * k; e += THREADS) {
    Ld[e] = INFINITY;
    Li[e] = EMPTY_ID;
  }
  if (warp == 0) {
    const int q = q0 + lane;
    int s = 0, e = 0;
    if (q < nq) {
      s = starts[q];
      e = min(ends[q], n_real);
    }
    s_start[lane] = s;
    s_end[lane] = e;
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
  const int t_begin = lo == INT_MAX ? 0 : lo / TILE;
  const int t_end = lo == INT_MAX ? 0 : (hi + TILE - 1) / TILE;

  // Staging: every thread fetches its share of the next chunk (PASSES row
  // vectors of the store, one float4 of the queries) into registers while
  // the block computes on the current chunk, then writes it to shared memory.
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = DK / VEC;               // vectors per row chunk
  constexpr int ROWS_PER_PASS = THREADS / VPR;
  constexpr int PASSES = TILE / ROWS_PER_PASS;
  static_assert(TILE % ROWS_PER_PASS == 0, "whole passes per tile");
  static_assert(THREADS / QB * 4 == DK, "one float4 of queries per thread");
  const int bv = tid % VPR;
  const int br = tid / VPR;
  const int aq = tid % QB;
  const int av = tid / QB;
  uint4 breg[PASSES];
  float4 areg;

  auto fetch = [&](int tile, int k0) {
    const long long row0 = static_cast<long long>(tile) * TILE;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const long long row = row0 + br + p * ROWS_PER_PASS;
      breg[p] = row < n_rows
                    ? *reinterpret_cast<const uint4*>(data + row * d_pad + k0 + bv * VEC)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    const int q = q0 + aq;
    areg = q < nq ? *reinterpret_cast<const float4*>(
                        queries + static_cast<long long>(q) * q_ld + k0 + av * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto stage = [&]() {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      float vals[VEC];
      Vec<T>::widen(breg[p], vals);
      const int r = br + p * ROWS_PER_PASS;
#pragma unroll
      for (int i = 0; i < VEC; ++i) Bs[r * (DK + 1) + bv * VEC + i] = vals[i];
    }
    As[(av * 4 + 0) * QB + aq] = areg.x;
    As[(av * 4 + 1) * QB + aq] = areg.y;
    As[(av * 4 + 2) * QB + aq] = areg.z;
    As[(av * 4 + 3) * QB + aq] = areg.w;
  };

  const int n_chunks = d_stream / DK;
  if (t_begin < t_end) fetch(t_begin, 0);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const long long row0 = static_cast<long long>(tile) * TILE;
    int col[PPL];
    float nrm[PPL];
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      col[i] = static_cast<int>(row0) + half * HALF + lane + 32 * i;
      nrm[i] = (L2 && col[i] < n_rows) ? norms[col[i]] : 0.f;
    }
    float acc[QPW][PPL];
#pragma unroll
    for (int j = 0; j < QPW; ++j)
#pragma unroll
      for (int i = 0; i < PPL; ++i) acc[j][i] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // the previous chunk is fully consumed
      stage();
      __syncthreads();
      if (c + 1 < n_chunks) fetch(tile, (c + 1) * DK);
      else if (tile + 1 < t_end) fetch(tile + 1, 0);
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * QB + qg * QPW]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * QB + qg * QPW + 4]);
        const float a[QPW] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[PPL];
#pragma unroll
        for (int i = 0; i < PPL; ++i)
          b[i] = Bs[(half * HALF + lane + 32 * i) * (DK + 1) + kk];
#pragma unroll
        for (int j = 0; j < QPW; ++j)
#pragma unroll
          for (int i = 0; i < PPL; ++i) acc[j][i] = fmaf(a[j], b[i], acc[j][i]);
      }
    }

#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int ql = qg * QPW + j;
      const int s = s_start[ql];
      const int e = s_end[ql];
      float* ld = Ld + (half * QB + ql) * k;
      int* li = Li + (half * QB + ql) * k;
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
        // 2 * acc is exact, so a contracted multiply-add rounds the same way
        const float dist = L2 ? nrm[i] - 2.0f * acc[j][i] : -acc[j][i];
        const bool ok = col[i] >= s && col[i] < e &&
                        lex_less(dist, col[i], ld[k - 1], li[k - 1]);
        unsigned m = __ballot_sync(FULL, ok);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cd = __shfl_sync(FULL, dist, src);
          const int ci = __shfl_sync(FULL, col[i], src);
          warp_insert(ld, li, k, cd, ci, lane);
        }
      }
    }
  }
  __syncthreads();

  // merge the NP per-warp lists of each query, lexicographically
  if (tid < QB && q0 + tid < nq) {
    int head[NP];
#pragma unroll
    for (int h = 0; h < NP; ++h) head[h] = 0;
    const long long out0 = static_cast<long long>(q0 + tid) * k;
    for (int e = 0; e < k; ++e) {
      int best = 0;
      float bd = Ld[(0 * QB + tid) * k + head[0]];
      int bi = Li[(0 * QB + tid) * k + head[0]];
#pragma unroll
      for (int h = 1; h < NP; ++h) {
        const float hd = Ld[(h * QB + tid) * k + head[h]];
        const int hi_ = Li[(h * QB + tid) * k + head[h]];
        if (lex_less(hd, hi_, bd, bi)) { best = h; bd = hd; bi = hi_; }
      }
      ++head[best];
      out_d[out0 + e] = bd;
      out_i[out0 + e] = bi;
    }
  }
}

template <typename T, bool L2>
int launch_typed(const void* data, long long n_rows, int d_pad, int d_stream,
                 const void* norms, const void* queries, int q_ld,
                 const void* starts, const void* ends, int nq, int k,
                 int n_real, void* out_d, void* out_i, cudaStream_t stream) {
  const size_t smem = (size_t)(DK * QB + TILE * (DK + 1)) * sizeof(float) +
                      (size_t)NP * QB * k * (sizeof(float) + sizeof(int));
  auto kern = scan_topk_kernel<T, L2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (nq + QB - 1) / QB;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(data), n_rows, d_pad, d_stream,
      static_cast<const float*>(norms), static_cast<const float*>(queries),
      q_ld, static_cast<const int*>(starts), static_cast<const int*>(ends),
      nq, k, n_real, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_metric(int metric_l2, const void* data, long long n_rows, int d_pad,
                  int d_stream, const void* norms, const void* queries,
                  int q_ld, const void* starts, const void* ends, int nq,
                  int k, int n_real, void* out_d, void* out_i,
                  cudaStream_t stream) {
  if (metric_l2)
    return launch_typed<T, true>(data, n_rows, d_pad, d_stream, norms, queries,
                                 q_ld, starts, ends, nq, k, n_real, out_d,
                                 out_i, stream);
  return launch_typed<T, false>(data, n_rows, d_pad, d_stream, norms, queries,
                                q_ld, starts, ends, nq, k, n_real, out_d, out_i,
                                stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 int8, 2 uint8. Returns cudaGetLastError()
// after the launch (0 on success), or -1 for arguments the kernel refuses.
int scan_topk_launch(const void* data, int dtype, long long n_rows, int d_pad,
                     int d_stream, const void* norms, const void* queries,
                     int q_ld, const void* starts, const void* ends, int nq,
                     int k, int metric_l2, int n_real, void* out_d,
                     void* out_i, void* stream) {
  if (nq <= 0) return 0;
  if (k < 1 || k > MAX_K || d_stream <= 0 || d_stream % DK != 0 ||
      d_stream > d_pad || q_ld < d_stream || n_real > n_rows)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_metric<float>(metric_l2, data, n_rows, d_pad, d_stream,
                                  norms, queries, q_ld, starts, ends, nq, k,
                                  n_real, out_d, out_i, s);
    case 1:
      return launch_metric<int8_t>(metric_l2, data, n_rows, d_pad, d_stream,
                                   norms, queries, q_ld, starts, ends, nq, k,
                                   n_real, out_d, out_i, s);
    case 2:
      return launch_metric<uint8_t>(metric_l2, data, n_rows, d_pad, d_stream,
                                    norms, queries, q_ld, starts, ends, nq, k,
                                    n_real, out_d, out_i, s);
    default:
      return -1;
  }
}

}  // extern "C"
