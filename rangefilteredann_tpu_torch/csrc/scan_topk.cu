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
// ~0.5 GB against ~0.66 TFLOP, so the bound is the operations (~9.8 ms against
// ~0.16 ms of memory time). Every FMA issue slot counts, and so does every
// byte a warp reads from shared memory: an SM delivers 128 bytes of shared
// memory a clock against 128 FMAs, so a lane must do at least 4 FMAs per
// float it loads just to keep up.
//
// What the design does about it:
//   * Work is spread over a persistent grid. The wrapper sorts the queries by
//     window midpoint into blocks of QB = 32 and cuts each block's union of
//     windows into segments of whole tiles (ops/scan.segment_plan, torch ops
//     on the device, no host synchronisation). SMs x resident CTAs take
//     (block, segment) items from an atomic counter, so a small batch still
//     fills every SM and a large one ends in a short tail. The segments lie
//     on one grid over the store and the items are handed out by grid
//     segment: the blocks covering a segment read its rows at the same time,
//     and the rows come from L2, not from device memory, for all but one.
//   * Each item keeps a sorted (dist, id) list per query and writes it to
//     scratch; the second kernel merges a query's lists, one per segment, in
//     one warp. The top-k of a set under (dist, id) order is unique, so the
//     result does not depend on how the windows were cut or in which order
//     the items ran.
//   * The product is register-tiled: a CTA is two warps side by side along
//     the points, a warp 4 query groups x 8 point groups, and each lane holds
//     8 queries x 16 points of fp32 accumulators and reads 4 dims of a query
//     or a point with one 16-byte shared load: 24 loads feed 512 FMAs, 5.3
//     FMAs per float loaded. Both operands are k-contiguous; padded rows (20
//     words for fp32, 12 for bytes) make the 8 rows a warp reads at once fall
//     in distinct banks. Each distance is one FMA chain over the dims in
//     order, finished as nrm - 2 * acc: bit-identical to the plain per-point
//     reduction order of the first design, so grid-valued cases stay exact.
//     The 128 accumulators take ~245 registers, so four CTAs (8 warps) share
//     an SM and the dim loop is not unrolled.
//   * Rows, queries, and with a tile's last chunk its norms are staged by
//     cp.async (no registers) in a ring of 2 stages of DK = 16 dims, with one
//     __syncthreads a stage. Byte stores are copied raw and widened at the
//     fragment load.
//   * A candidate costs one compare against a bound on its query's k-th
//     distance held in registers: the smallest k-th distance of the query's
//     lists in this CTA and of the k-th distances that items of its block
//     have published ([nq] in global memory, lowered by atomics, staged with
//     each tile). A distance that k points reach bounds the k-th, so the
//     bound drops nothing of the result, and a block's later items start
//     from what its earlier ones found. The warp inserts the few that pass
//     into a sorted list in shared memory. For k <= 32 each warp keeps its
//     own lists (merged at the end of an item; a list is one entry a lane,
//     so an insert is one read, a ballot and a shift); for larger k one list
//     per query is shared and the warps take turns.
// Not done (later work, only if the measurements call for it):
// error-compensated 3xTF32 on the tensor cores.

#include "scan_common.cuh"

namespace {

using namespace scan_common;

constexpr int QB = 32;                // queries per block
constexpr int WARPS = 2;              // warps per CTA, side by side along the points
constexpr int THREADS = WARPS * 32;
constexpr int CTAS_PER_SM = 4;        // the occupancy the registers are sized for
constexpr int QT = 8;                 // queries per lane: qg, qg + 4, ..., qg + 28
constexpr int PT = 16;                // points per lane: pg, pg + 8, ..., pg + 120 of its warp's
constexpr int WPTS = 8 * PT;          // points per warp in a tile
constexpr int TILE = 256;             // points per tile
constexpr int DK = 16;                // dims per stage
constexpr int STAGES = 2;             // cp.async ring
constexpr int A_COPIES = QB * DK / 4 / THREADS;  // 16-byte query pieces a thread a stage
constexpr int A_LD = DK + 4;          // floats per staged query row
constexpr int LIST_SPLIT_K = 32;      // k above this shares one list per query

static_assert(TILE == WARPS * WPTS, "a tile is the warps' points side by side");
static_assert(QB == 4 * QT, "a warp is 4 query groups x 8 point groups");
static_assert(DK % 16 == 0, "16-byte copies of byte rows, 4-dim fragments");
static_assert(A_COPIES * THREADS == QB * DK / 4, "whole query pieces a thread");
static_assert(TILE % THREADS == 0, "norm copies");

// Shared-memory layout of one stage: QB query rows of DK floats, then TILE
// store rows of DK elements, each row padded so that the 8 rows a warp reads
// at once fall into distinct banks, then the tile's TILE norms and the
// block's QB published k-th distances (both filled by the stage of a tile's
// last chunk, whose epilogue reads them).
template <typename T>
struct Layout {
  static constexpr int ROW = DK * static_cast<int>(sizeof(T));  // bytes of a row's chunk
  static constexpr int LD = ROW + (sizeof(T) == 4 ? 16 : 32);   // bytes between staged rows
  static constexpr int PIECES = ROW / 16;                       // 16-byte copies a row
  static constexpr int RSTEP = THREADS / PIECES;                // rows apart of a thread's copies
  static constexpr int A_BYTES = QB * A_LD * 4;
  static constexpr int NRM = A_BYTES + TILE * LD;               // offset of the norms
  static constexpr int KTH = NRM + TILE * 4;                    // offset of the k-th distances
  static constexpr int BYTES = KTH + QB * 4;
};

template <typename T, int L>
__host__ __device__ constexpr size_t smem_bytes(int k) {
  return static_cast<size_t>(STAGES) * Layout<T>::BYTES +
         static_cast<size_t>(L) * QB * k * (sizeof(float) + sizeof(int)) + (2 * QB + 4) * sizeof(int);
}

// 4 dims of one staged row, widened to fp32. Bytes become exact floats by
// placing them in the mantissa of 2^23 (int8 shifted by 128 first).
__device__ __forceinline__ float4 widen_bytes(unsigned w, float offset) {
  return make_float4(__uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540)) - offset,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7541)) - offset,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7542)) - offset,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7543)) - offset);
}
template <typename T> struct Frag;
template <> struct Frag<float> {
  __device__ static float4 load(const unsigned char* row, int kk) {
    return *reinterpret_cast<const float4*>(row + kk * 4);
  }
};
template <> struct Frag<int8_t> {
  __device__ static float4 load(const unsigned char* row, int kk) {
    return widen_bytes(*reinterpret_cast<const unsigned*>(row + kk) ^ 0x80808080u, 8388736.0f);
  }
};
template <> struct Frag<uint8_t> {
  __device__ static float4 load(const unsigned char* row, int kk) {
    return widen_bytes(*reinterpret_cast<const unsigned*>(row + kk), 8388608.0f);
  }
};

struct ScanArgs {
  const void* data;
  long long n_rows;
  int d_pad, d_stream;
  const float* norms;
  const float* queries;  // [nq, q_ld] sorted by window midpoint
  int q_ld;
  const int* starts;     // [nq] sorted
  const int* ends;
  int nq, k, n_real;
  const int* tile_begin;  // [n_blocks] first tile of each block's union
  const int* tile_end;    // [n_blocks] one past its last tile
  const int* prefix;      // [n_blocks] inclusive prefix sum of segments per block
  const int* seg;         // [1] tiles per segment, on one grid over the store
  const int* item_code;   // items in the order handed out: block * MAX_SEGS + segment
  int n_blocks;
  int* counter;           // [1] items taken, zero before the launch
  float* kth;             // [nq] an upper bound on each sorted query's k-th distance, +inf before
  float* part_d;          // [items, QB, k] each item's sorted lists
  int* part_i;
  const long long* order;  // [nq] caller's row of each sorted query
  float* out_d;            // [nq, k] in the caller's order
  int* out_i;
};

// One stage: the block's query rows and the tile's store rows, dims
// [chunk * DK, chunk * DK + DK), by the whole CTA, and with a tile's last
// chunk its norms (L2) and the block's published k-th distances (ksrc, for
// the first QB threads). qsrc are this thread's query pieces at chunk 0 (a
// query past the batch repeats the last one); rows past the store repeat
// the last one. The window test drops both.
template <typename T, bool L2>
__device__ __forceinline__ void issue_stage(unsigned char* st, const ScanArgs& a,
                                            const float* const (&qsrc)[A_COPIES],
                                            const float* ksrc, int tile, int chunk, bool last,
                                            int tid) {
  using Lay = Layout<T>;
#pragma unroll
  for (int c = 0; c < A_COPIES; ++c) {
    const int p = tid + c * THREADS;
    copy16(st + ((p / (DK / 4)) * A_LD + (p % (DK / 4)) * 4) * 4, qsrc[c] + chunk * DK);
  }
  const long long row0 = static_cast<long long>(tile) * TILE;
  const long long pitch = static_cast<long long>(a.d_pad) * sizeof(T);
  const int r = tid / Lay::PIECES;
  unsigned char* dst = st + Lay::A_BYTES + r * Lay::LD + (tid % Lay::PIECES) * 16;
  const unsigned char* src = static_cast<const unsigned char*>(a.data) + chunk * Lay::ROW +
                             (tid % Lay::PIECES) * 16;
  if (row0 + TILE <= a.n_rows) {
    src += (row0 + r) * pitch;
#pragma unroll
    for (int it = 0; it < TILE / Lay::RSTEP; ++it)
      copy16(dst + it * Lay::RSTEP * Lay::LD, src + it * Lay::RSTEP * pitch);
  } else {
#pragma unroll
    for (int it = 0; it < TILE / Lay::RSTEP; ++it)
      copy16(dst + it * Lay::RSTEP * Lay::LD,
             src + min(row0 + r + it * Lay::RSTEP, a.n_rows - 1) * pitch);
  }
  if (!last) return;
  if (tid < QB) copy4(st + Lay::KTH + tid * 4, ksrc);
  if (L2) {
    float* nrm = reinterpret_cast<float*>(st + Lay::NRM);
#pragma unroll
    for (int it = 0; it < TILE / THREADS; ++it) {
      const int p = tid + it * THREADS;
      copy4(nrm + p, a.norms + min(row0 + p, a.n_rows - 1));
    }
  }
}

// One stage's DK dims into the lane's 8 x 16 accumulators, each one FMA
// chain over the dims in order.
template <typename T>
__device__ __forceinline__ void compute_stage(const unsigned char* st, float (&acc)[QT][PT],
                                              int qg, int pg, int warp) {
  using Lay = Layout<T>;
  const float* as = reinterpret_cast<const float*>(st) + qg * A_LD;
  const unsigned char* bs = st + Lay::A_BYTES + (warp * WPTS + pg) * Lay::LD;
#pragma unroll 1  // a small loop body: 8 x 16 accumulators leave no room to unroll
  for (int kk = 0; kk < DK; kk += 4) {
    float4 av[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) av[j] = *reinterpret_cast<const float4*>(as + 4 * j * A_LD + kk);
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const float4 b = Frag<T>::load(bs + 8 * i * Lay::LD, kk);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        acc[j][i] = fmaf(av[j].x, b.x, acc[j][i]);
        acc[j][i] = fmaf(av[j].y, b.y, acc[j][i]);
        acc[j][i] = fmaf(av[j].z, b.z, acc[j][i]);
        acc[j][i] = fmaf(av[j].w, b.w, acc[j][i]);
      }
    }
  }
}

// warp_insert (scan_common.cuh) for a list of k <= 32 entries, one a lane:
// one read of the list, a ballot for the place, a shift by one lane.
__device__ __forceinline__ void warp_insert32(float* ld, int* li, int k, float cd, int ci,
                                              int lane) {
  const float d = lane < k ? ld[lane] : INFINITY;
  const int i = lane < k ? li[lane] : EMPTY_ID;
  // the list is sorted, so the entries that stay ahead of the candidate are a prefix
  const int pos = __popc(__ballot_sync(FULL, lex_less(d, i, cd, ci)));
  if (pos >= k) return;  // warp-uniform
  const float pd = __shfl_up_sync(FULL, d, 1);
  const int pi = __shfl_up_sync(FULL, i, 1);
  if (lane < k && lane >= pos) {
    ld[lane] = lane == pos ? cd : pd;
    li[lane] = lane == pos ? ci : pi;
  }
  __syncwarp();
}

// A finished tile: each accumulator becomes a distance and is held against
// its window, its own list's k-th (dist, id) and a bound on the query's k-th
// distance: the smallest k-th distance of its L lists and of the k-th
// distance other items of its block have published (gk_s). A candidate
// beyond a distance that k points reach cannot be among the k best, so the
// bound drops nothing of the result. A lane whose distances of a query all
// lie beyond the bound skips the rest. Warp 0 publishes its lists' bound
// (kth, the block's row) where it improves on gk_s. The warp inserts the
// few that pass into its lists (ld, li: [QB][k]), query by query: each
// round every lane offers its lowest passing point.
template <bool L2, int L>
__device__ __forceinline__ void epilogue(float (&acc)[QT][PT], const float* nrm_s,
                                         const float* gk_s, float* kth, const float* lists_d,
                                         float* ld, int* li, const int* ctl, int k,
                                         unsigned colw, int qg, int pg, int lane, bool publish) {
  float nrm[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) nrm[i] = L2 ? nrm_s[pg + 8 * i] : 0.f;
  unsigned pass[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int q = qg + 4 * j;
    float lo = INFINITY;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      // 2 * acc is exact, so a contracted multiply-add rounds the same way
      acc[j][i] = L2 ? nrm[i] - 2.0f * acc[j][i] : -acc[j][i];
      lo = fminf(lo, acc[j][i]);
    }
    float bound = ld[q * k + k - 1];
#pragma unroll
    for (int h = 0; h < L; ++h) bound = fminf(bound, lists_d[(h * QB + q) * k + k - 1]);
    const float gk = gk_s[q];
    // (a query past the batch never fills a list: its window is empty)
    if (publish && bound < gk) atomic_min_float(kth + q, bound);
    bound = fminf(bound, gk);
    pass[j] = 0;
    if (lo <= bound) {
      const float td = ld[q * k + k - 1];
      const int ti = li[q * k + k - 1];
      const unsigned s = ctl[q], e = ctl[QB + q];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const unsigned col = colw + pg + 8 * i;
        // bound <= td, so (dist, col) < (td, ti) reduces to dist < td or col < ti
        if (col >= s && col < e && acc[j][i] <= bound &&
            (acc[j][i] < td || static_cast<int>(col) < ti))
          pass[j] |= 1u << i;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    while (__any_sync(FULL, pass[j] != 0)) {
      const int bit = pass[j] != 0 ? __ffs(pass[j]) - 1 : 0;
      float mine = acc[j][0];
#pragma unroll
      for (int i = 1; i < PT; ++i) mine = bit == i ? acc[j][i] : mine;
      unsigned m = __ballot_sync(FULL, pass[j] != 0);
      pass[j] &= pass[j] - 1;
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float cd = __shfl_sync(FULL, mine, src);
        const int ci = static_cast<int>(colw + (src & 7) + 8 * __shfl_sync(FULL, bit, src));
        const int q = (src >> 3) + 4 * j;
        if (L > 1) warp_insert32(ld + q * k, li + q * k, k, cd, ci, lane);
        else warp_insert(ld + q * k, li + q * k, k, cd, ci, lane);
      }
    }
  }
}

// The persistent scan: every CTA takes items until none is left. L lists
// per query: one per warp (WARPS) or one shared in turns (1).
template <typename T, bool L2, int L>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM) scan_items_kernel(const ScanArgs a) {
  using Lay = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = a.k;
  float* lists_d = reinterpret_cast<float*>(smem + STAGES * Lay::BYTES);  // [L][QB][k]
  int* lists_i = reinterpret_cast<int*>(lists_d + L * QB * k);            // [L][QB][k]
  // [0, QB) window starts, [QB, 2 QB) window ends (clipped to n_real), then
  // the item's scratch slot, its block, its first tile and one past its last
  int* ctl = lists_i + L * QB * k;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qg = lane >> 3;
  const int pg = lane & 7;
  float* ld = lists_d + (warp % L) * QB * k;
  int* li = lists_i + (warp % L) * QB * k;
  const int n_items = a.prefix[a.n_blocks - 1];
  const int seg = *a.seg;
  const int n_chunks = a.d_stream / DK;

  for (;;) {
    if (tid == 0) {
      const int item = atomicAdd(a.counter, 1);
      int b = 0, slot = 0;
      if (item < n_items) {
        const int code = a.item_code[item];
        b = code / MAX_SEGS;
        const int first = a.tile_begin[b] / seg + code % MAX_SEGS;  // its grid segment
        ctl[2 * QB + 2] = max(first * seg, a.tile_begin[b]);
        ctl[2 * QB + 3] = min(first * seg + seg, a.tile_end[b]);
        slot = (b > 0 ? a.prefix[b - 1] : 0) + code % MAX_SEGS;
      }
      ctl[2 * QB] = item < n_items ? slot : n_items;
      ctl[2 * QB + 1] = b;
    }
    __syncthreads();  // also: the previous item's lists have been written out
    const int item = ctl[2 * QB];  // its scratch slot
    if (item >= n_items) break;
    const int q0 = ctl[2 * QB + 1] * QB;
    const int t_first = ctl[2 * QB + 2];
    const int steps = (ctl[2 * QB + 3] - t_first) * n_chunks;
    for (int e = tid; e < L * QB * k; e += THREADS) {
      lists_d[e] = INFINITY;
      lists_i[e] = EMPTY_ID;
    }
    if (tid < QB) {
      const int q = q0 + tid;
      ctl[tid] = q < a.nq ? max(a.starts[q], 0) : 0;
      ctl[QB + tid] = q < a.nq ? min(a.ends[q], a.n_real) : 0;
    }
    // this block's row of the published bounds, and whether this thread
    // publishes them: warp 0's first lane of each query group
    float* kth = a.kth + q0;
    const float* ksrc = a.kth + min(q0 + tid, a.nq - 1);
    const bool publish = warp == 0 && pg == 0;
    const float* qsrc[A_COPIES];
#pragma unroll
    for (int c = 0; c < A_COPIES; ++c) {
      const int p = tid + c * THREADS;
      qsrc[c] = a.queries + static_cast<long long>(min(q0 + p / (DK / 4), a.nq - 1)) * a.q_ld +
                (p % (DK / 4)) * 4;
    }
    // the next stage to issue: its tile, chunk and ring slot
    int ld_tile = t_first, ld_chunk = 0, ld_slot = 0;
#pragma unroll
    for (int g = 0; g < STAGES - 1; ++g) {
      if (g < steps)
        issue_stage<T, L2>(smem + ld_slot * Lay::BYTES, a, qsrc, ksrc, ld_tile, ld_chunk,
                           ld_chunk == n_chunks - 1, tid);
      copy_commit();
      ++ld_slot;
      if (++ld_chunk == n_chunks) { ld_chunk = 0; ++ld_tile; }
    }
    float acc[QT][PT];
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[j][i] = 0.f;
    int chunk = 0, slot = 0;
    unsigned colw = static_cast<unsigned>(t_first) * TILE + warp * WPTS;
    for (int g = 0; g < steps; ++g) {
      copy_wait<STAGES - 2>();
      // stage g is in for every thread, and stage g - 1's buffer is free
      __syncthreads();
      if (g + STAGES - 1 < steps)
        issue_stage<T, L2>(smem + ld_slot * Lay::BYTES, a, qsrc, ksrc, ld_tile, ld_chunk,
                           ld_chunk == n_chunks - 1, tid);
      copy_commit();
      ld_slot = ld_slot == STAGES - 1 ? 0 : ld_slot + 1;
      if (++ld_chunk == n_chunks) { ld_chunk = 0; ++ld_tile; }
      const unsigned char* st = smem + slot * Lay::BYTES;
      slot = slot == STAGES - 1 ? 0 : slot + 1;
      compute_stage<T>(st, acc, qg, pg, warp);
      if (++chunk == n_chunks) {
        chunk = 0;
        const float* nrm_s = reinterpret_cast<const float*>(st + Lay::NRM) + warp * WPTS;
        const float* gk_s = reinterpret_cast<const float*>(st + Lay::KTH);
        if (L == WARPS) {
          epilogue<L2, L>(acc, nrm_s, gk_s, kth, lists_d, ld, li, ctl, k, colw, qg, pg,
                          lane, publish);
        } else {
          for (int turn = 0; turn < WARPS / L; ++turn) {
            if (warp / L == turn)
              epilogue<L2, L>(acc, nrm_s, gk_s, kth, lists_d, ld, li, ctl, k, colw, qg, pg,
                          lane, publish);
            __syncthreads();
          }
        }
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
          for (int i = 0; i < PT; ++i) acc[j][i] = 0.f;
        colw += TILE;
      }
    }
    __syncthreads();  // every warp's inserts are in

    // this item's sorted list of each query, lists of the warps merged
    float* pd = a.part_d + static_cast<long long>(item) * QB * k;
    int* pi = a.part_i + static_cast<long long>(item) * QB * k;
    if (L == 1) {
      for (int e = tid; e < QB * k; e += THREADS) {
        pd[e] = lists_d[e];
        pi[e] = lists_i[e];
      }
    } else if (tid < QB) {
      int head[L];
#pragma unroll
      for (int h = 0; h < L; ++h) head[h] = 0;
      for (int e = 0; e < k; ++e) {
        int best = 0;
        float bd = lists_d[tid * k + head[0]];
        int bi = lists_i[tid * k + head[0]];
#pragma unroll
        for (int h = 1; h < L; ++h) {
          const float hd = lists_d[(h * QB + tid) * k + head[h]];
          const int hi = lists_i[(h * QB + tid) * k + head[h]];
          if (lex_less(hd, hi, bd, bi)) { best = h; bd = hd; bi = hi; }
        }
#pragma unroll
        for (int h = 0; h < L; ++h) head[h] += h == best;
        pd[tid * k + e] = bd;
        pi[tid * k + e] = bi;
      }
    }
  }
}

struct Call {
  int dtype, metric_l2, k, grid;
  ScanArgs args;
  cudaStream_t stream;
  int* config;  // non-null: report the configuration, launch nothing
};

template <typename T, bool L2, int L>
int run(const Call& c) {
  auto kern = scan_items_kernel<T, L2, L>;
  const size_t smem = smem_bytes<T, L>(c.k);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.config != nullptr) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaFuncAttributes fa;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem)) !=
            cudaSuccess ||
        (err = cudaFuncGetAttributes(&fa, kern)) != cudaSuccess)
      return static_cast<int>(err);
    c.config[0] = per_sm;
    c.config[1] = sms;
    c.config[2] = fa.numRegs;
    c.config[3] = static_cast<int>(fa.localSizeBytes);
    c.config[4] = static_cast<int>(smem);
    c.config[5] = L;
    return 0;
  }
  kern<<<c.grid, THREADS, smem, c.stream>>>(c.args);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int merge_grid = (c.args.nq + MERGE_WARPS - 1) / MERGE_WARPS;
  merge_items<QB, ScanArgs><<<merge_grid, MERGE_WARPS * 32, 0, c.stream>>>(c.args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool L2>
int by_lists(const Call& c) {
  return c.k <= LIST_SPLIT_K ? run<T, L2, WARPS>(c) : run<T, L2, 1>(c);
}

template <typename T>
int by_metric(const Call& c) {
  return c.metric_l2 ? by_lists<T, true>(c) : by_lists<T, false>(c);
}

int dispatch(const Call& c) {
  if (c.k < 1 || c.k > MAX_K) return -1;
  switch (c.dtype) {
    case 0: return by_metric<float>(c);
    case 1: return by_metric<int8_t>(c);
    case 2: return by_metric<uint8_t>(c);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// The configuration a launch of (dtype, metric, k) takes, into out[6]: CTAs
// resident an SM, SMs, registers a thread, local (spill) bytes a thread,
// dynamic shared memory a CTA, lists a query. Returns 0, a CUDA error, or
// -1 for arguments the kernel refuses.
int scan_topk_config(int dtype, int metric_l2, int k, int* out) {
  Call c{};
  c.dtype = dtype;
  c.metric_l2 = metric_l2;
  c.k = k;
  c.config = out;
  return dispatch(c);
}

// dtype: 0 float32, 1 int8, 2 uint8. The wrapper sorts the queries, builds
// the segment plan (tile_begin, tile_end, prefix, seg, item_code), zeroes the counter,
// fills kth ([nq] float32) with +inf and allocates part_d / part_i for at
// least prefix[n_blocks - 1] items;
// grid is SMs x resident CTAs from scan_topk_config. Returns
// cudaGetLastError() after the launches (0 on success), or -1 for
// arguments the kernel refuses.
int scan_topk_launch(const void* data, int dtype, long long n_rows, int d_pad, int d_stream,
                     const void* norms, const void* queries, int q_ld, const void* starts,
                     const void* ends, int nq, int k, int metric_l2, int n_real,
                     const void* tile_begin, const void* tile_end, const void* prefix,
                     const void* seg, const void* item_code, int n_blocks, void* counter,
                     void* kth, void* part_d, void* part_i, const void* order, void* out_d, void* out_i,
                     int grid, void* stream) {
  if (nq <= 0) return 0;
  if (d_stream <= 0 || d_stream % DK != 0 || d_stream > d_pad || q_ld < d_stream ||
      n_real > n_rows || n_rows >= INT_MAX || grid < 1 || n_blocks != (nq + QB - 1) / QB)
    return -1;
  Call c{};
  c.dtype = dtype;
  c.metric_l2 = metric_l2;
  c.k = k;
  c.grid = grid;
  c.stream = static_cast<cudaStream_t>(stream);
  ScanArgs& a = c.args;
  a.data = data;
  a.n_rows = n_rows;
  a.d_pad = d_pad;
  a.d_stream = d_stream;
  a.norms = static_cast<const float*>(norms);
  a.queries = static_cast<const float*>(queries);
  a.q_ld = q_ld;
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
  a.nq = nq;
  a.k = k;
  a.n_real = n_real;
  a.tile_begin = static_cast<const int*>(tile_begin);
  a.tile_end = static_cast<const int*>(tile_end);
  a.prefix = static_cast<const int*>(prefix);
  a.seg = static_cast<const int*>(seg);
  a.item_code = static_cast<const int*>(item_code);
  a.n_blocks = n_blocks;
  a.counter = static_cast<int*>(counter);
  a.kth = static_cast<float*>(kth);
  a.part_d = static_cast<float*>(part_d);
  a.part_i = static_cast<int*>(part_i);
  a.order = static_cast<const long long*>(order);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  return dispatch(c);
}

}  // extern "C"
