// Scan variant v3b: the range-masked (dist, id) top-k by U insert steps a
// round against a per-128-point group table, then one retire-and-rescan
// pass; and the nested-loop probe. Hand-written CUDA C++ for sm_90a, on a
// body of its own (scan_v2.cu and scan_v3.cu keep scan_variants.cuh).
//
// Replaces the TPU kernels tools/exp_scan3b.py::_scan_kernel_v3b (wrapper
// scan_v3b) and the kernel of tools/exp_scan3b.py::probe_nested_while. Bound
// from PyTorch by ctypes through rangefilteredann_tpu_torch/tools/
// exp_scan3b.py, whose plain versions are scan_v3b_plain
// (ops/bruteforce.scan_bruteforce) and probe_nested_while_plain.
//
// What it computes: for each query q with window [starts[q], ends[q]) over
// the label-sorted store, dist(q, col) = norms[col] - 2 q.x_col (L2, shifted)
// or -q.x_col (MIPS) in fp32, and the k smallest (dist, id) pairs in
// lexicographic order (lowest id first among equal distances), padded with
// (+inf, EMPTY_ID).
//
// Bound on an H100 SXM: 2 * sum(window) * d fp32 operations on the CUDA cores
// (67 TFLOP/s), ~0.39 ms at the harness shape (200k x 128, 2,048 queries,
// windows of 50,000) against ~0.03 ms of bytes; no TF32 and no tensor cores,
// so the result stays fp32-exact. Every FMA issue slot counts, and so does
// every byte read from shared memory: an SM delivers 128 bytes of shared
// memory a clock against 128 FMAs, so a lane must do at least 4 FMAs per
// float it loads.
//
// What the design does about it:
//   * A persistent grid. The wrapper sorts the queries by window midpoint
//     into blocks of QB (qblock) and cuts each block's union of windows into
//     segments of whole tiles of `tile` points (exp_scan3b.segment_plan,
//     torch ops on the device, no host synchronisation). SMs x resident CTAs
//     take (block, segment) items from an atomic counter, handed out by grid
//     segment, so the blocks covering a segment read its rows from L2. Each
//     item writes its per-query sorted lists to scratch and a merge kernel
//     joins them; the top-k under (dist, id) is unique, so neither the cut
//     nor the order of the items can change the result.
//   * A register-tiled product: 8 warps, each lane 8 queries x 16 points of
//     fp32 accumulators. A warp is QB / 8 query groups x 256 / QB point
//     groups, so it covers all QB queries and W = 4096 / QB points, and the
//     CTA a round of 8 W points (1024, 2048, 4096 at QB 32, 16, 8). A lane
//     reads 4 dims of a query or a point with one 16-byte load: 24 loads
//     feed 512 FMAs, 5.3 FMAs per float loaded. Rows are staged 16 dims (64
//     bytes, two whole sectors; 8 dims at QB 8, whose 4,096-row round would
//     not fit) a stage, k-contiguous, the 16-byte pieces of a row permuted
//     by row so that the 8 rows a quarter-warp reads fall in distinct
//     banks; queries beside them. Both by cp.async (no registers) in a ring
//     of up to 4 stages with one __syncthreads a stage (on the card 16
//     dims a stage streamed faster than 8; 32, which leaves one ring slot,
//     lost more to the lost overlap than it gained). Each distance is one
//     FMA chain over the dims in order, finished as nrm - 2 * acc (MIPS:
//     -acc), the order of the plain per-point sum, so grid-valued cases
//     stay exact.
//   * v3b's extraction, one warp a query. The product's epilogue writes a
//     tile's [QB, tile] distances (masked by each window) to shared memory
//     and, since the lanes sharing a query group know which 128-point group
//     their points fall in, the table of group minima (min, first argmin)
//     by a shuffle reduction: nothing re-reads the tile to build it. Then a
//     round runs up to U steps against the table alone, each inserting the
//     table's best head if it beats the query's k-th entry ((dist, id)
//     compare) and retiring that entry; a step that does not improve ends
//     the round's steps, since no later step could. One pass then retires
//     the inserted heads and rescans only their groups. A head above the
//     bound is dead, and so is its group, since the head is the group's
//     minimum: its entry is dropped without a rescan. The bound is the
//     smaller of the query's own k-th distance and the k-th distance that
//     its block's other items have published (an [nq] float array lowered
//     by atomics): a distance that k points reach bounds the k-th, so
//     nothing of the result is dropped. A group whose minimum is above the
//     bound is dead before the first round.
//   * Shared memory. The distance tile is QB x tile fp32, up to 192 KB of
//     the 227 KB a CTA can take, so one CTA runs on an SM. The ring takes
//     the deeper of two places: beside the tile, where the next tile's
//     first stages load while the warps extract; or over the tile's last
//     round's block, which is written only after that round's last stage
//     (a tile wider than a round is stored as one block a round, the
//     partial one first), and then the loads wait for the extraction. Over
//     a block of QB = 16 or 8 the ring is one stage deep, so at T = 2048
//     QB = 16 no load overlaps an FMA; on the card 2 stages of 8 dims there
//     ran slower than 1 of 16 (PERF.md). Every (qblock, tile, k) that
//     fitted the earlier shared body fits here.
// With a tile narrower than a round (tile < 8 W), warps past the tile's
// points sit out the product.
//
// The probe: out = x summed in a 3 x 2 nested loop, i.e. 6 x. It showed
// whether the TPU's compiler took a while loop inside a while loop; here it
// is one elementwise kernel.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;              // warps a CTA
constexpr int THREADS = WARPS * 32;
constexpr int QT = 8;                 // queries a lane
constexpr int PT = 16;                // points a lane
constexpr int MAX_STAGES = 4;         // ring depth at most
constexpr int GROUP = 128;            // points a group-table entry
constexpr int MAX_GROUPS = 32;        // one table entry a lane
constexpr int MAX_TILE = MAX_GROUPS * GROUP;
constexpr int TILE_STEP = 256;        // tiles are multiples of it
constexpr int MAX_K = 256;
constexpr int MAX_SEGS = 32;          // segments a block: one merge lane each
constexpr int MAX_SMEM = 231424;      // dynamic shared memory a CTA may take
constexpr int EMPTY_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// Points of one CTA round at qblock qb: 8 warps x 16 points x 256 / qb lanes
// along the points.
__host__ __device__ constexpr int round_points(int qb) { return WARPS * PT * (256 / qb); }

// Dims a stage at qblock qb: 16 (64 bytes of a row, two sectors), or 8 at
// qblock 8, whose round of 4,096 rows would not fit 16.
__host__ __device__ constexpr int stage_dims(int qb) { return qb >= 16 ? 16 : 8; }

// Where things lie in a CTA's dynamic shared memory, in bytes.
struct Layout {
  int ring;      // point stages [stages][rw][dk]
  int qring;     // query stages [MAX_STAGES][qb][dk]
  int lists;     // [qb][k] floats, then [qb][k] ints
  int table;     // [qb][groups] floats, then [qb][groups] ints
  int ctl;       // ints: [qb] starts, [qb] ends, the item's slot, block, first tile, end
                 // tile; then [qb] floats, the block's published k-th distances
  int total;
  int stages;    // ring depth, 1 to MAX_STAGES
  int separate;  // 1: the ring has its own space, 0: it overlays the last block
};

// The layout of a (qblock, tile, k) launch; total > MAX_SMEM: refused. The
// deeper of the two rings: beside the tile (taken at equal depth, since
// its loads need not wait for the extraction) or under its last block.
__host__ __device__ inline Layout layout(int qb, int tile, int k) {
  Layout l{};
  const int rw = tile < round_points(qb) ? tile : round_points(qb);
  const int dist = qb * tile * 4;
  const int dk = stage_dims(qb);
  const int stage = rw * dk * 4;
  const int rest =
      MAX_STAGES * qb * dk * 4 + qb * k * 8 + qb * (tile / GROUP) * 8 + (3 * qb + 4) * 4;
  const int spare = MAX_SMEM - dist - rest;
  const int beside = spare < MAX_STAGES * stage ? spare / stage : MAX_STAGES;
  const int under = qb * rw * 4 < MAX_STAGES * stage ? qb * rw * 4 / stage : MAX_STAGES;
  l.separate = beside >= 2 && beside >= under;
  l.stages = l.separate ? beside : under;
  l.ring = l.separate ? dist : qb * (tile - rw) * 4;
  l.qring = l.separate ? dist + l.stages * stage : dist;
  l.lists = l.qring + MAX_STAGES * qb * dk * 4;
  l.table = l.lists + qb * k * 8;
  l.ctl = l.table + qb * (tile / GROUP) * 8;
  l.total = l.ctl + (3 * qb + 4) * 4;
  return l;
}

struct Args {
  const float* data;
  long long n_rows;
  int d_pad, d_stream;
  const float* norms;
  const float* queries;  // [nq, q_ld] sorted by window midpoint
  int q_ld;
  const int* starts;     // [nq] sorted
  const int* ends;
  int nq, k, n_real, tile, unroll;
  const int* tile_begin;  // [n_blocks] first tile of each block's union
  const int* tile_end;    // [n_blocks] one past its last tile
  const int* prefix;      // [n_blocks] inclusive prefix sum of segments a block
  const int* seg;         // [1] tiles a segment, on one grid over the store
  const int* item_code;   // items in the order handed out: block * MAX_SEGS + segment
  int n_blocks;
  int* counter;           // [1] items taken, zero before the launch
  float* kth;             // [nq] an upper bound on each sorted query's k-th distance, +inf before
  float* part_d;          // [items, qb, k] each item's sorted lists
  int* part_i;
  const long long* order;  // [nq] caller's row of each sorted query
  float* out_d;            // [nq, k] in the caller's order
  int* out_i;
  Layout lay;
};

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// *addr = min(*addr, v) for any two non-NaN floats: non-negative floats
// order as ints, negative ones in reverse as unsigned.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (v >= 0.f) atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// Asynchronous 16-byte copies into shared memory, holding no registers.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Wait until at most `pending` (0 to MAX_STAGES - 2) of this thread's
// committed groups are in flight.
__device__ __forceinline__ void copy_wait(int pending) {
  if (pending >= 2) {
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
}

// The published bound of a query, read past L1 (other CTAs lower it).
__device__ __forceinline__ float load_bound(const float* p) { return __ldcg(p); }

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

// A tile is stored as one block a round: the partial round first (r0 =
// tile % rw points, if any), then full rounds of rw points, each block
// [qb][width] row-major. The first column of group g of query q:
__device__ __forceinline__ float* group_row(float* dist, int qb, int q, int g, int r0, int rw) {
  const int c = g * GROUP;
  int cb = 0, w = r0;
  if (c >= r0) {
    cb = r0 + (c - r0) / rw * rw;
    w = rw;
  }
  return dist + qb * cb + q * w + (c - cb);
}

// (min, first argmin) of group g of one query's distances, in all lanes.
__device__ __forceinline__ void group_min(const float* p, int lane, float& m, int& a) {
  m = p[lane];
  a = lane;
#pragma unroll
  for (int j = 1; j < GROUP / 32; ++j) {
    const float v = p[lane + 32 * j];
    if (v < m) { m = v; a = lane + 32 * j; }
  }
  warp_argmin(m, a);
}

// Round r of a tile: its first column and its width.
__device__ __forceinline__ void round_span(int r, int r0, int rw, int& cb, int& w) {
  if (r0 > 0) {
    cb = r == 0 ? 0 : r0 + (r - 1) * rw;
    w = r == 0 ? r0 : rw;
  } else {
    cb = r * rw;
    w = rw;
  }
}

template <int QB, bool L2>
__global__ void __launch_bounds__(THREADS, 1) v3b_items_kernel(const Args a) {
  constexpr int QG = QB / QT;        // query groups a warp
  constexpr int PG = 32 / QG;        // point groups a warp
  constexpr int W = PT * PG;         // points a warp covers in a round
  constexpr int RW = WARPS * W;      // points a CTA round
  constexpr int GPB = W / GROUP;     // groups a warp's points touch in a round
  constexpr int IPG = PT / GPB;      // points a lane has in each of them
  constexpr int DK = stage_dims(QB);  // dims a stage
  constexpr int PIECES = DK / 4;      // 16-byte pieces of a staged row
  constexpr int RPP = THREADS / PIECES;  // rows the CTA copies a pass
  // A row's piece p is stored at p ^ swz(row), swz(row) = (row >> SWZ) &
  // (PIECES - 1): the 8 rows a quarter-warp reads fall in distinct banks.
  constexpr int SWZ = 4 / PIECES;
  static_assert(QB % QT == 0 && 32 % QG == 0, "a warp is query groups x point groups");
  static_assert(W % GROUP == 0 && RW == round_points(QB), "whole groups a warp");
  static_assert(PG % 8 == 0, "all rows of a lane share one swizzle");

  extern __shared__ __align__(16) unsigned char smem[];
  float* dist = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + a.lay.ring);
  float* qring = reinterpret_cast<float*>(smem + a.lay.qring);
  const int k = a.k;
  float* lists_d = reinterpret_cast<float*>(smem + a.lay.lists);
  int* lists_i = reinterpret_cast<int*>(lists_d + QB * k);
  const int tile = a.tile;
  const int groups = tile / GROUP;
  float* tab_m = reinterpret_cast<float*>(smem + a.lay.table);
  int* tab_a = reinterpret_cast<int*>(tab_m + QB * groups);
  int* ctl = reinterpret_cast<int*>(smem + a.lay.ctl);
  float* s_gk = reinterpret_cast<float*>(ctl + 2 * QB + 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qg = lane / PG;
  const int pg = lane % PG;
  const int swz = (pg >> SWZ) & (PIECES - 1);  // all of this lane's rows share it
  const int rw = min(tile, RW);
  const int r0 = tile % rw;
  const int n_rounds = (r0 > 0) + (tile - r0) / rw;
  const int n_chunks = a.d_stream / DK;
  const int per_tile = n_rounds * n_chunks;
  const int S = a.lay.stages;
  const bool sep = a.lay.separate != 0;
  const int n_items = a.prefix[a.n_blocks - 1];
  const int seg = *a.seg;

  for (;;) {
    if (tid == 0) {
      const int item = atomicAdd(a.counter, 1);
      int b = 0, slot = n_items;
      if (item < n_items) {
        const int code = a.item_code[item];
        b = code / MAX_SEGS;
        const int first = a.tile_begin[b] / seg + code % MAX_SEGS;  // its grid segment
        ctl[2 * QB + 2] = max(first * seg, a.tile_begin[b]);
        ctl[2 * QB + 3] = min(first * seg + seg, a.tile_end[b]);
        slot = (b > 0 ? a.prefix[b - 1] : 0) + code % MAX_SEGS;
      }
      ctl[2 * QB] = slot;
      ctl[2 * QB + 1] = b;
    }
    __syncthreads();  // also: the previous item's lists have been written out
    const int slot = ctl[2 * QB];
    if (slot >= n_items) break;
    const int q0 = ctl[2 * QB + 1] * QB;
    const int t_first = ctl[2 * QB + 2];
    const int n_tiles = ctl[2 * QB + 3] - t_first;
    const int total = n_tiles * per_tile;
    for (int e = tid; e < QB * k; e += THREADS) {
      lists_d[e] = INFINITY;
      lists_i[e] = EMPTY_ID;
    }
    if (tid < QB) {
      const int q = q0 + tid;
      ctl[tid] = q < a.nq ? max(a.starts[q], 0) : 0;
      ctl[QB + tid] = q < a.nq ? min(a.ends[q], a.n_real) : 0;
    }

    // Stage (tile ti of the item, round r, chunk c) into ring slot `buf`:
    // the round's rows and the block's queries, dims [c * DK, c * DK + DK).
    // Thread t copies piece t % PIECES of rows t / PIECES + RPP i; rows past
    // the store repeat the last one, queries past the batch the last one:
    // the windows drop both.
    const int t_piece = tid % PIECES;
    const int t_row = tid / PIECES;
    const int t_dst = t_row * DK + ((t_piece ^ ((t_row >> SWZ) & (PIECES - 1))) << 2);
    auto issue = [&](int ti, int r, int c, int buf) {
      int cb, w;
      round_span(r, r0, rw, cb, w);
      const long long row0 = static_cast<long long>(t_first + ti) * tile + cb;
      float* dst = ring + buf * rw * DK + t_dst;
      const float* src = a.data + c * DK + t_piece * 4;
      if (row0 + w <= a.n_rows) {
        src += (row0 + t_row) * a.d_pad;
        const long long pitch = static_cast<long long>(RPP) * a.d_pad;
        for (int i = 0; i < w / RPP; ++i) copy16(dst + i * RPP * DK, src + i * pitch);
      } else {
        for (int i = 0; i < w / RPP; ++i)
          copy16(dst + i * RPP * DK, src + min(row0 + t_row + RPP * i, a.n_rows - 1) * a.d_pad);
      }
      if (tid < PIECES * QB)
        copy16(qring + (buf * QB + t_row) * DK + t_piece * 4,
               a.queries + static_cast<long long>(min(q0 + t_row, a.nq - 1)) * a.q_ld +
                   c * DK + t_piece * 4);
    };

    // Steps are staged in order, one commit group each, step x into ring
    // slot x % S, S - 1 ahead of the one computed, but never past a tile
    // whose last block the ring lies under.
    int next = 0, n_ti = 0, n_r = 0, n_c = 0;  // the next step and its place
    auto stage_next = [&]() {
      issue(n_ti, n_r, n_c, next % S);
      copy_commit();
      ++next;
      if (++n_c == n_chunks) {
        n_c = 0;
        if (++n_r == n_rounds) { n_r = 0; ++n_ti; }
      }
    };
    while (next < S - 1 && next < total && (sep || next < per_tile)) stage_next();
    float acc[QT][PT];
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[j][i] = 0.f;
    for (int ti = 0; ti < n_tiles; ++ti) {
      const long long tile_base = static_cast<long long>(t_first + ti) * tile;
      for (int s = 0; s < per_tile; ++s) {
        const int g = ti * per_tile + s;
        if (S == 1) {
          __syncthreads();  // every warp is done with the one slot
          stage_next();
        }
        copy_wait(next - 1 - g);
        __syncthreads();  // step g is in for every thread, and step g - 1's slot is free
        if (S > 1 && next < total && next < g + S && (sep || next < (ti + 1) * per_tile))
          stage_next();
        const int r = s / n_chunks;
        int cb, w;
        round_span(r, r0, rw, cb, w);
        const bool busy = warp * W < w;  // warp-uniform: this warp has points this round
        if (busy) {
          const int buf = g % S;
          const float* qs = qring + (buf * QB + qg) * DK;
          const float* rs = ring + buf * rw * DK + (warp * W + pg) * DK;
#pragma unroll
          for (int h = 0; h < PIECES; ++h) {
            float4 av[QT];
#pragma unroll
            for (int j = 0; j < QT; ++j)
              av[j] = *reinterpret_cast<const float4*>(qs + QG * j * DK + h * 4);
#pragma unroll
            for (int i = 0; i < PT; ++i) {
              const float4 b =
                  *reinterpret_cast<const float4*>(rs + PG * i * DK + ((h ^ swz) << 2));
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
        if (s % n_chunks != n_chunks - 1) continue;
        // the round's last chunk: its epilogue
        const bool last = r == n_rounds - 1;
        if (!sep && last) __syncthreads();  // the ring lies under this block
        // the block's published bounds, for the extraction: loaded ahead of
        // the epilogue, stored after it
        float gk_in = INFINITY;
        if (last && tid < QB) gk_in = load_bound(a.kth + min(q0 + tid, a.nq - 1));
        if (busy) {
          const int local0 = warp * W + pg;  // column of point 0 in the round
          const long long col0 = tile_base + cb + local0;
          float* blk = dist + QB * cb;
          const int g0 = (cb + warp * W) / GROUP;  // the warp's first group in the tile
#pragma unroll
          for (int j = 0; j < QT; ++j) {
            const int q = qg + QG * j;
            const long long s_q = ctl[q], e_q = ctl[QB + q];
#pragma unroll
            for (int gg = 0; gg < GPB; ++gg) {
              float m = INFINITY;
              int am = EMPTY_ID;
#pragma unroll
              for (int ii = 0; ii < IPG; ++ii) {
                const int i = gg * IPG + ii;
                const long long col = col0 + PG * i;
                // 2 * acc is exact, so a contracted multiply-add rounds the same way
                float d = L2 ? __ldg(a.norms + min(col, a.n_rows - 1)) - 2.0f * acc[j][i]
                             : -acc[j][i];
                d = (col >= s_q && col < e_q) ? d : INFINITY;
                if (local0 + PG * i < w) {
                  blk[q * w + local0 + PG * i] = d;
                  if (d < m) { m = d; am = (pg + PG * i) & (GROUP - 1); }
                }
              }
              // the group's (min, first argmin) over the lanes of this query group
#pragma unroll
              for (int off = 1; off < PG; off <<= 1) {
                const float om = __shfl_xor_sync(FULL, m, off);
                const int oa = __shfl_xor_sync(FULL, am, off);
                if (lex_less(om, oa, m, am)) { m = om; am = oa; }
              }
              if (pg == 0 && warp * W + gg * GROUP < w) {
                tab_m[q * groups + g0 + gg] = m;
                tab_a[q * groups + g0 + gg] = am;
              }
            }
          }
        }
        if (last && tid < QB) s_gk[tid] = gk_in;
#pragma unroll
        for (int j = 0; j < QT; ++j)
#pragma unroll
          for (int i = 0; i < PT; ++i) acc[j][i] = 0.f;
      }
      __syncthreads();  // the tile's distances, table and bounds are in

      // v3b's extraction, one warp a query
      for (int ql = warp; ql < QB; ql += WARPS) {
        const int q = q0 + ql;
        if (q >= a.nq) break;
        if (max(static_cast<long long>(ctl[ql]), tile_base) >=
            min(static_cast<long long>(ctl[QB + ql]), tile_base + tile))
          continue;
        float* ld = lists_d + ql * k;
        int* li = lists_i + ql * k;
        const float gk = s_gk[ql];
        float gm = lane < groups ? tab_m[ql * groups + lane] : INFINITY;
        int am = lane < groups ? tab_a[ql * groups + lane] : 0;
        if (gm > fminf(gk, ld[k - 1])) gm = INFINITY;  // dead before the first round
        while (true) {
          const float gm_in = gm;  // round-start heads
          int steps = 0;
          for (; steps < a.unroll; ++steps) {
            float m = gm;
            int gsel = lane;
            warp_argmin(m, gsel);
            const int cid =
                static_cast<int>(tile_base) + gsel * GROUP + __shfl_sync(FULL, am, gsel);
            if (!(m < INFINITY && m <= gk && lex_less(m, cid, ld[k - 1], li[k - 1]))) break;
            warp_insert(ld, li, k, m, cid, lane);
            if (lane == gsel) gm = INFINITY;
          }
          if (steps == 0) break;
          // retire the inserted heads; a head above the bound kills its group
          const bool inserted = lane < groups && gm_in < INFINITY && gm == INFINITY;
          if (inserted) group_row(dist, QB, ql, lane, r0, rw)[am] = INFINITY;
          else if (gm > fminf(gk, ld[k - 1])) gm = INFINITY;
          __syncwarp();
          unsigned mask = __ballot_sync(FULL, inserted);
          while (mask) {
            const int g = __ffs(mask) - 1;
            mask &= mask - 1;
            float m;
            int at;
            group_min(group_row(dist, QB, ql, g, r0, rw), lane, m, at);
            if (lane == g) { gm = m; am = at; }
          }
        }
        if (lane == 0 && ld[k - 1] < gk) atomic_min_float(a.kth + q, ld[k - 1]);
      }
      __syncthreads();  // the tile has been read before the next one's epilogues
      if (!sep)  // the ring was under the tile: its loads go ahead now
        while (next < total && next < (ti + 1) * per_tile + S - 1) stage_next();
    }

    // this item's sorted list of each query
    float* pd = a.part_d + static_cast<long long>(slot) * QB * k;
    int* pi = a.part_i + static_cast<long long>(slot) * QB * k;
    for (int e = tid; e < QB * k; e += THREADS) {
      pd[e] = lists_d[e];
      pi[e] = lists_i[e];
    }
  }
}

// One warp a query: merge the sorted lists of its block's items (at most
// MAX_SEGS, one a lane) by (dist, id) into the caller's row.
constexpr int MERGE_WARPS = 4;
__global__ void __launch_bounds__(MERGE_WARPS * 32) merge_kernel(const Args a, int qb) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (q >= a.nq) return;  // the whole warp
  const int k = a.k;
  const int b = q / qb;
  const int first = b > 0 ? a.prefix[b - 1] : 0;
  const int n = a.prefix[b] - first;
  const long long base = (static_cast<long long>(first + lane) * qb + q % qb) * k;
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

struct Call {
  int qb, metric_l2, grid;
  Args args;
  cudaStream_t stream;
  int* config;  // non-null: report the configuration, launch nothing
};

template <int QB, bool L2>
int run(const Call& c) {
  auto kern = v3b_items_kernel<QB, L2>;
  const size_t smem = static_cast<size_t>(c.args.lay.total);
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
    c.config[5] = 1;  // lists a query
    c.config[6] = c.args.lay.stages;
    c.config[7] = c.args.lay.separate;
    return 0;
  }
  kern<<<c.grid, THREADS, smem, c.stream>>>(c.args);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int merge_grid = (c.args.nq + MERGE_WARPS - 1) / MERGE_WARPS;
  merge_kernel<<<merge_grid, MERGE_WARPS * 32, 0, c.stream>>>(c.args, QB);
  return static_cast<int>(cudaGetLastError());
}

template <bool L2>
int by_qblock(const Call& c) {
  switch (c.qb) {
    case 8: return run<8, L2>(c);
    case 16: return run<16, L2>(c);
    case 32: return run<32, L2>(c);
    default: return -1;
  }
}

// The layout of (qblock, tile, k) into c, or -1 for arguments the kernel
// refuses.
int set_layout(Call& c, int qblock, int tile, int k) {
  if (qblock != 8 && qblock != 16 && qblock != 32) return -1;
  if (k < 1 || k > MAX_K || tile < TILE_STEP || tile % TILE_STEP != 0 || tile > MAX_TILE) return -1;
  c.qb = qblock;
  c.args.tile = tile;
  c.args.k = k;
  c.args.lay = layout(qblock, tile, k);
  return c.args.lay.total <= MAX_SMEM ? 0 : -1;
}

__global__ void probe_nested_while_kernel(const float* __restrict__ x,
                                          float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  int a = 0;
  while (a < 3) {
    int b = 0;
    while (b < 2) {
      acc += x[i];
      ++b;
    }
    ++a;
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// The configuration a launch of (qblock, tile, k, metric) takes, into
// out[8]: CTAs resident an SM, SMs, registers a thread, local (spill) bytes
// a thread, dynamic shared memory a CTA, lists a query, ring stages, and 1
// if the ring has its own space (0: it overlays the tile's last block).
// Returns 0, a CUDA error, or -1 for arguments the kernel refuses.
int scan_v3b_config(int qblock, int tile, int k, int metric_l2, int* out) {
  Call c{};
  if (set_layout(c, qblock, tile, k) != 0) return -1;
  c.metric_l2 = metric_l2;
  c.config = out;
  return metric_l2 ? by_qblock<true>(c) : by_qblock<false>(c);
}

// metric_l2: 1 for L2, 0 for MIPS; qblock 8, 16 or 32; tile a multiple of
// 256 up to 4096; unroll >= 1. The wrapper sorts the queries, builds the
// segment plan (tile_begin, tile_end, prefix, seg, item_code, in tiles of
// `tile` and blocks of qblock), zeroes the counter, fills kth ([nq]
// float32) with +inf and allocates part_d / part_i for at least
// prefix[n_blocks - 1] items; grid is SMs x resident CTAs from
// scan_v3b_config. Returns cudaGetLastError() after the launches (0 on
// success), or -1 for arguments the kernel refuses.
int scan_v3b_launch(const void* data, long long n_rows, int d_pad, int d_stream,
                    const void* norms, const void* queries, int q_ld, const void* starts,
                    const void* ends, int nq, int k, int metric_l2, int n_real, int tile,
                    int qblock, int unroll, const void* tile_begin, const void* tile_end,
                    const void* prefix, const void* seg, const void* item_code, int n_blocks,
                    void* counter, void* kth, void* part_d, void* part_i, const void* order,
                    void* out_d, void* out_i, int grid, void* stream) {
  if (nq <= 0) return 0;
  Call c{};
  if (set_layout(c, qblock, tile, k) != 0) return -1;
  if (d_stream <= 0 || d_stream % stage_dims(qblock) != 0 || d_stream > d_pad || q_ld < d_stream ||
      n_real > n_rows || n_rows >= INT_MAX || unroll < 1 || grid < 1 ||
      n_blocks != (nq + qblock - 1) / qblock)
    return -1;
  c.metric_l2 = metric_l2;
  c.grid = grid;
  c.stream = static_cast<cudaStream_t>(stream);
  Args& a = c.args;
  a.data = static_cast<const float*>(data);
  a.n_rows = n_rows;
  a.d_pad = d_pad;
  a.d_stream = d_stream;
  a.norms = static_cast<const float*>(norms);
  a.queries = static_cast<const float*>(queries);
  a.q_ld = q_ld;
  a.starts = static_cast<const int*>(starts);
  a.ends = static_cast<const int*>(ends);
  a.nq = nq;
  a.n_real = n_real;
  a.unroll = unroll;
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
  return metric_l2 ? by_qblock<true>(c) : by_qblock<false>(c);
}

int probe_nested_while_launch(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  probe_nested_while_kernel<<<(n + 255) / 256, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
