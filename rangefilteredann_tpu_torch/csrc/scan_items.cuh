// The persistent item body of the scan variants v2 (scan_v2.cu), v3
// (scan_v3.cu) and v3b (scan_v3b.cu), hand-written CUDA C++ for sm_90a.
// Each source passes its extraction policy (v3 and v3b the round extraction
// below, uncapped and capped), and v2's bf16 mode its tensor-core product.
//
// What it computes: for each query q with window [starts[q], ends[q]) over
// the label-sorted store, dist(q, col) = norms[col] - 2 q.x_col (L2, shifted)
// or -q.x_col (MIPS), and the k smallest (dist, id) pairs in lexicographic
// order (lowest id first among equal distances), padded with (+inf,
// EMPTY_ID). The fp32 product is fp32-exact; the bf16 product rounds the
// query and the store to bf16 (round to nearest even) and accumulates in
// fp32, with the fp32 norms of the unrounded store.
//
// Bound on an H100 SXM: 2 * sum(window) * d operations, fp32 on the CUDA
// cores (67 TFLOP/s) or bf16 on the tensor cores (989 TFLOP/s), against the
// bytes of the rows the windows cover, read once. At the harness shape
// (200k x 128, 2,048 queries, windows of 50,000) fp32 is bound by the
// operations (~0.39 ms) and bf16 by the bytes (~0.03 ms). For the fp32
// product every FMA issue slot counts, and so does every byte read from
// shared memory: an SM delivers 128 bytes of shared memory a clock against
// 128 FMAs, so a lane must do at least 4 FMAs per float it loads.
//
// What the design does about it:
//   * A persistent grid. The wrapper sorts the queries by window midpoint
//     into blocks of QB (qblock) and cuts each block's union of windows into
//     segments of whole tiles of `tile` points (ops/scan.segment_plan, torch
//     ops on the device, no host synchronisation). SMs x resident CTAs take
//     (block, segment) items from an atomic counter, handed out by grid
//     segment, so the blocks covering a segment read its rows from L2. Each
//     item writes its per-query sorted lists to scratch and a merge kernel
//     (scan_common.cuh) joins them; the top-k under (dist, id) is unique, so
//     neither the cut nor the order of the items can change the result.
//   * Staging. Rows are staged 16 dims (64 bytes, two whole sectors; 8 dims
//     at QB 8, whose 4,096-row round would not fit 16) a stage,
//     k-contiguous, the 16-byte pieces of a row permuted by row so that the
//     8 rows a quarter-warp reads fall in distinct banks; queries beside
//     them. Both by cp.async (no registers) in a ring of up to 4 stages with
//     one __syncthreads a stage (on the card 16 dims a stage streamed faster
//     than 8; 32, which leaves one ring slot, lost more to the lost overlap
//     than it gained). The bf16 mode stages the same fp32 rows and rounds
//     them when it builds its fragments: the store needs no bf16 copy.
//   * The fp32 product (FmaProduct) is register-tiled: 8 warps, each lane 8
//     queries x 16 points of fp32 accumulators. A warp is QB / 8 query
//     groups x 256 / QB point groups, so it covers all QB queries and W =
//     4096 / QB points, and the CTA a round of 8 W points (1024, 2048, 4096
//     at QB 32, 16, 8). A lane reads 4 dims of a query or a point with one
//     16-byte load: 24 loads feed 512 FMAs, 5.3 FMAs per float loaded. Each
//     distance is one FMA chain over the dims in order, finished as nrm - 2
//     * acc (MIPS: -acc), the order of the plain per-point sum, so
//     grid-valued cases stay exact.
//   * The bf16 product (MmaProduct, QB 16 or 32) covers the same W points a
//     warp with mma.sync m16n8k16 (bf16 in, fp32 accumulated): QB / 16
//     m-tiles x W / 8 n-tiles, 128 accumulators a lane as in fp32. A lane
//     reads a point's 4 dims with one 16-byte load and rounds them to two
//     bf16 pairs; the k order inside a 16-dim step is permuted alike in both
//     operands, so the sum is the same.
//   * The extraction, one warp a query. The product's epilogue writes a
//     tile's [QB, tile] distances (masked by each window) to shared memory
//     and, since the lanes sharing a query know which 128-point group their
//     points fall in, the table of group minima (min, first argmin) by a
//     shuffle reduction: nothing re-reads the tile to build it. The
//     source's policy then extracts against the table, inserting into the
//     query's list and rescanning only the groups it took from. Its bound is
//     the smaller of the query's own k-th distance and the k-th distance
//     that its block's other items have published (an [nq] float array
//     lowered by atomics): a distance that k points reach bounds the k-th,
//     so nothing of the result is dropped. A group whose minimum is above
//     the bound is dead before the policy starts.
//   * Shared memory. The distance tile is QB x tile fp32, up to 192 KB of
//     the 227 KB a CTA can take, so one CTA runs on an SM. The ring takes
//     the deeper of two places: beside the tile, where the next tile's
//     first stages load while the warps extract; or over the tile's last
//     round's block, which is written only after that round's last stage
//     (a tile wider than a round is stored as one block a round, the
//     partial one first), and then the loads wait for the extraction. Over
//     a block of QB = 16 or 8 the ring is one stage deep, so at T = 2048
//     QB = 16 no load overlaps a product; on the card 2 stages of 8 dims
//     there ran slower than 1 of 16 (PERF.md).
// With a tile narrower than a round (tile < 8 W), warps past the tile's
// points sit out the product.

#pragma once

#include <cuda_bf16.h>

#include "scan_common.cuh"

namespace scan_items {

using namespace scan_common;

constexpr int WARPS = 8;              // warps a CTA
constexpr int THREADS = WARPS * 32;
constexpr int QT = 8;                 // fp32 product: queries a lane
constexpr int PT = 16;                // fp32 product: points a lane
constexpr int MAX_STAGES = 4;         // ring depth at most
constexpr int GROUP = 128;            // points a group-table entry
constexpr int MAX_GROUPS = 32;        // one table entry a lane
constexpr int MAX_TILE = MAX_GROUPS * GROUP;
constexpr int TILE_STEP = 256;        // tiles are multiples of it
constexpr int MAX_SMEM = 231424;      // dynamic shared memory a CTA may take

// Points of one CTA round at qblock qb: 8 warps x 16 points x 256 / qb lanes.
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

// The published bound of a query, read past L1 (other CTAs lower it).
__device__ __forceinline__ float load_bound(const float* p) { return __ldcg(p); }

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

// The round extraction, the policy of v3b (CAPPED: at most `unroll` steps a
// round) and of v3 (uncapped), for sorted query ql against one tile, one
// warp, lane g holding group g's table entry (gm, am), gk the query's
// published bound. A round takes steps against the table alone: each
// inserts the table's best head if it beats min(own k-th, published bound)
// under the (dist, id) compare and retires that entry; a step that does not
// improve ends the round's steps, since no later head is smaller. Then the
// inserted heads are retired in the tile and only their groups rescanned. A
// head above the bound is dead, and so is its group, since the head is the
// group's minimum: its entry is dropped without a rescan.
//
// v3 (tools/exp_scan3.py:139-184) inserts heads while they improve, then
// retires every head, inserted or not, and rebuilds the whole table. That is
// this round with no cap on the steps. Every head its inner loop did not
// insert failed the compare (the argmin that ended the loop did, and the
// others are no smaller), the k-th entry only decreases, and a head is its
// group's minimum: those groups can give nothing more, and v3's rebuild of
// them finds nothing to insert. Uncapped, a round ends after at most
// `groups` steps (one entry a lane), when every entry is retired. Capped or
// not, the result is the exact (dist, id) top-k; the cap moves only the
// time, by how many inserts one rescan pass serves.
template <bool CAPPED>
struct RoundExtract {
  __device__ static void run(float* dist, int qb, int ql, int r0, int rw, int groups,
                             int tile_base, float gk, float* ld, int* li, int k, int unroll,
                             float gm, int am, int lane) {
    const int cap = CAPPED ? unroll : groups;
    while (true) {
      const float gm_in = gm;  // round-start heads
      int steps = 0;
      for (; steps < cap; ++steps) {
        float m = gm;
        int gsel = lane;
        warp_argmin(m, gsel);
        const int cid = tile_base + gsel * GROUP + __shfl_sync(FULL, am, gsel);
        if (!(m < INFINITY && m <= gk && lex_less(m, cid, ld[k - 1], li[k - 1]))) break;
        warp_insert(ld, li, k, m, cid, lane);
        if (lane == gsel) gm = INFINITY;
      }
      if (steps == 0) break;
      // retire the inserted heads; a head above the bound kills its group
      const bool inserted = lane < groups && gm_in < INFINITY && gm == INFINITY;
      if (inserted) group_row(dist, qb, ql, lane, r0, rw)[am] = INFINITY;
      else if (gm > fminf(gk, ld[k - 1])) gm = INFINITY;
      __syncwarp();
      unsigned mask = __ballot_sync(FULL, inserted);
      while (mask) {
        const int g = __ffs(mask) - 1;
        mask &= mask - 1;
        float m;
        int at;
        group_min(group_row(dist, qb, ql, g, r0, rw), lane, m, at);
        if (lane == g) { gm = m; am = at; }
      }
    }
  }
};

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

// One warp's epilogue target in a round: the round's block of the tile
// ([QB][w] at blk), the warp's first column in the round (local) and in the
// store (col), its first group in the tile (g0), and the group table.
struct Epi {
  float* blk;
  int w, local;
  long long col;
  int g0, groups;
  float* tab_m;
  int* tab_a;
};

// The distance of store column col to a query whose window is [s_q, e_q),
// acc being their product; +inf outside the window.
template <bool L2>
__device__ __forceinline__ float masked_dist(const Args& a, long long s_q, long long e_q,
                                             long long col, float acc) {
  // 2 * acc is exact, so a contracted multiply-add rounds the same way
  const float d = L2 ? __ldg(a.norms + min(col, a.n_rows - 1)) - 2.0f * acc : -acc;
  return (col >= s_q && col < e_q) ? d : INFINITY;
}

// The fp32 product: a lane holds 8 queries (qg + QG j) x 16 points (pg + PG i
// of its warp's W) of fp32 accumulators.
template <int QB_>
struct FmaProduct {
  static constexpr int QB = QB_;
  static constexpr int QG = QB / QT;        // query groups a warp
  static constexpr int PG = 32 / QG;        // point groups a warp
  static constexpr int W = PT * PG;         // points a warp covers in a round
  static constexpr int GPB = W / GROUP;     // groups a warp's points touch in a round
  static constexpr int IPG = PT / GPB;      // points a lane has in each of them
  static constexpr int DK = stage_dims(QB);
  static constexpr int PIECES = DK / 4;     // 16-byte pieces of a staged row
  // A staged row's piece p lies at p ^ swz(row), swz(row) = (row >> SWZ) &
  // (PIECES - 1): the 8 rows a quarter-warp reads fall in distinct banks.
  static constexpr int SWZ = 4 / PIECES;
  static_assert(QB % QT == 0 && 32 % QG == 0, "a warp is query groups x point groups");
  static_assert(W % GROUP == 0 && WARPS * W == round_points(QB), "whole groups a warp");
  static_assert(PG % 8 == 0, "all rows of a lane share one swizzle");

  float acc[QT][PT];
  int qg, pg, swz;

  __device__ __forceinline__ explicit FmaProduct(int lane)
      : qg(lane / PG), pg(lane % PG), swz(((lane % PG) >> SWZ) & (PIECES - 1)) {
    zero();
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[j][i] = 0.f;
  }

  // One stage: qs the ring slot's [QB][DK] queries, rs its rows from the
  // warp's first.
  __device__ __forceinline__ void step(const float* qs, const float* rs) {
    qs += qg * DK;
    rs += pg * DK;
#pragma unroll
    for (int h = 0; h < PIECES; ++h) {
      float4 av[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j)
        av[j] = *reinterpret_cast<const float4*>(qs + QG * j * DK + h * 4);
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const float4 b = *reinterpret_cast<const float4*>(rs + PG * i * DK + ((h ^ swz) << 2));
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

  // The round's distances into the tile, and the group minima of its
  // points (min, first argmin) by a shuffle over the lanes of a query.
  template <bool L2>
  __device__ __forceinline__ void epilogue(const Args& a, const int* ctl, const Epi& e) {
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
          const int p = pg + PG * i;  // the point in the warp's W
          const float d = masked_dist<L2>(a, s_q, e_q, e.col + p, acc[j][i]);
          if (e.local + p < e.w) {
            e.blk[q * e.w + e.local + p] = d;
            if (d < m) { m = d; am = p & (GROUP - 1); }
          }
        }
#pragma unroll
        for (int off = 1; off < PG; off <<= 1) {
          const float om = __shfl_xor_sync(FULL, m, off);
          const int oa = __shfl_xor_sync(FULL, am, off);
          if (lex_less(om, oa, m, am)) { m = om; am = oa; }
        }
        if (pg == 0 && e.local + gg * GROUP < e.w) {
          e.tab_m[q * e.groups + e.g0 + gg] = m;
          e.tab_a[q * e.groups + e.g0 + gg] = am;
        }
      }
    }
  }
};

// D += A (16 x 16, row) * B (16 x 8, col), bf16 operands, fp32 accumulation.
// Fragments (g = lane / 4, t = lane % 4; a register holds two k, the lower in
// its low half): a = {(row g, k 2t..), (row g+8, k 2t..), (row g, k 2t+8..),
// (row g+8, k 2t+8..)}, b0 = (k 2t.., col g), b1 = (k 2t+8.., col g); c =
// (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The bf16 product on the tensor cores, QB 16 or 32: a warp's W points are
// W / 8 n-tiles of 8 consecutive points, its QB queries QB / 16 m-tiles.
// Logical k 2t, 2t+1, 2t+8, 2t+9 of a 16-dim step are dims 4t .. 4t+3 of
// the stage in both operands, so a lane reads a row's piece t (4 dims) with
// one 16-byte load.
template <int QB_>
struct MmaProduct {
  static constexpr int QB = QB_;
  static constexpr int MT = QB / 16;        // m-tiles
  static constexpr int W = round_points(QB) / WARPS;
  static constexpr int NT = W / 8;          // n-tiles
  static constexpr int NPG = GROUP / 8;     // n-tiles a group
  static constexpr int GPB = W / GROUP;     // groups a warp's points touch in a round
  static constexpr int DK = stage_dims(QB);
  static_assert(QB % 16 == 0 && DK == 16, "m-tiles of 16 queries, one k-step a stage");
  static_assert(W % GROUP == 0, "whole groups a warp");

  float acc[MT][NT][4];
  int g, t, boff;

  __device__ __forceinline__ explicit MmaProduct(int lane)
      : g(lane >> 2), t(lane & 3),
        // row g of an n-tile (its first row a multiple of 8): piece t at t ^ swz(row)
        boff((lane >> 2) * DK + (((lane & 3) ^ ((lane >> 3) & 3)) << 2)) {
    zero();
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  }

  __device__ __forceinline__ void step(const float* qs, const float* rs) {
    unsigned fa[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 lo = *reinterpret_cast<const float4*>(qs + (m * 16 + g) * DK + 4 * t);
      const float4 hi = *reinterpret_cast<const float4*>(qs + (m * 16 + g + 8) * DK + 4 * t);
      fa[m][0] = pack_bf16(lo.x, lo.y);
      fa[m][1] = pack_bf16(hi.x, hi.y);
      fa[m][2] = pack_bf16(lo.z, lo.w);
      fa[m][3] = pack_bf16(hi.z, hi.w);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(rs + n * 8 * DK + boff);
      const unsigned b0 = pack_bf16(x.x, x.y), b1 = pack_bf16(x.z, x.w);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_bf16(acc[m][n], fa[m], b0, b1);
    }
  }

  // The lane holds columns 2t, 2t+1 of every n-tile for queries g and g + 8
  // of each m-tile: a group's 128 points of a query lie in the 4 lanes of a
  // row, so two xor-shuffles give its minimum. The n-tiles go outermost, so
  // each pair of norms is loaded once and used at once by every query row.
  template <bool L2>
  __device__ __forceinline__ void epilogue(const Args& a, const int* ctl, const Epi& e) {
    long long s_q[MT][2], e_q[MT][2];
    float mn[MT][2][GPB];
    int am[MT][2][GPB];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s_q[m][h] = ctl[m * 16 + g + 8 * h];
        e_q[m][h] = ctl[QB + m * 16 + g + 8 * h];
#pragma unroll
        for (int gg = 0; gg < GPB; ++gg) {
          mn[m][h][gg] = INFINITY;
          am[m][h][gg] = EMPTY_ID;
        }
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int p = n * 8 + 2 * t;  // the first of the lane's two points
      if (e.local + p >= e.w) continue;
      const int gg = n / NPG;
      const long long col = e.col + p;
      const float nrm0 = L2 ? __ldg(a.norms + min(col, a.n_rows - 1)) : 0.f;
      const float nrm1 = L2 ? __ldg(a.norms + min(col + 1, a.n_rows - 1)) : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = m * 16 + g + 8 * h;
          // 2 * acc is exact, so a contracted multiply-add rounds the same way
          float d0 = L2 ? nrm0 - 2.0f * acc[m][n][2 * h] : -acc[m][n][2 * h];
          float d1 = L2 ? nrm1 - 2.0f * acc[m][n][2 * h + 1] : -acc[m][n][2 * h + 1];
          d0 = (col >= s_q[m][h] && col < e_q[m][h]) ? d0 : INFINITY;
          d1 = (col + 1 >= s_q[m][h] && col + 1 < e_q[m][h]) ? d1 : INFINITY;
          *reinterpret_cast<float2*>(e.blk + q * e.w + e.local + p) = make_float2(d0, d1);
          if (d0 < mn[m][h][gg]) { mn[m][h][gg] = d0; am[m][h][gg] = p & (GROUP - 1); }
          if (d1 < mn[m][h][gg]) { mn[m][h][gg] = d1; am[m][h][gg] = (p + 1) & (GROUP - 1); }
        }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int gg = 0; gg < GPB; ++gg) {
          float v = mn[m][h][gg];
          int i = am[m][h][gg];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float ov = __shfl_xor_sync(FULL, v, off);
            const int oi = __shfl_xor_sync(FULL, i, off);
            if (lex_less(ov, oi, v, i)) { v = ov; i = oi; }
          }
          const int q = m * 16 + g + 8 * h;
          if (t == 0 && e.local + gg * GROUP < e.w) {
            e.tab_m[q * e.groups + e.g0 + gg] = v;
            e.tab_a[q * e.groups + e.g0 + gg] = i;
          }
        }
  }
};

// The persistent items kernel. Product: FmaProduct<QB> or MmaProduct<QB>
// (then L2). Extract::run(dist, qb, ql, r0, rw, groups, tile_base, gk, ld,
// li, k, unroll, gm, am, lane) is the policy's extraction of sorted query ql
// against one tile, with its lane's table entry (gm, am) and its bound gk.
template <class Product, bool L2, class Extract>
__global__ void __launch_bounds__(THREADS, 1) items_kernel(const Args a) {
  constexpr int QB = Product::QB;
  constexpr int W = Product::W;          // points a warp covers in a round
  constexpr int DK = stage_dims(QB);     // dims a stage
  constexpr int PIECES = DK / 4;         // 16-byte pieces of a staged row
  constexpr int RPP = THREADS / PIECES;  // rows the CTA copies a pass
  constexpr int SWZ = 4 / PIECES;        // a row's piece p lies at p ^ ((row >> SWZ) & (PIECES - 1))
  static_assert(WARPS * W == round_points(QB), "the warps cover a round");

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
  const int rw = min(tile, round_points(QB));
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
    Product prod(lane);
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
          prod.step(qring + buf * QB * DK, ring + (buf * rw + warp * W) * DK);
        }
        if (s % n_chunks != n_chunks - 1) continue;
        // the round's last chunk: its epilogue
        const bool last = r == n_rounds - 1;
        if (!sep && last) __syncthreads();  // the ring lies under this block
        // the block's published bounds, for the extraction: loaded ahead of
        // the epilogue, stored after it
        float gk_in = INFINITY;
        if (last && tid < QB) gk_in = load_bound(a.kth + min(q0 + tid, a.nq - 1));
        if (busy)
          prod.template epilogue<L2>(
              a, ctl,
              Epi{dist + QB * cb, w, warp * W, tile_base + cb + warp * W, (cb + warp * W) / GROUP,
                  groups, tab_m, tab_a});
        if (last && tid < QB) s_gk[tid] = gk_in;
        prod.zero();
      }
      __syncthreads();  // the tile's distances, table and bounds are in

      // the policy's extraction, one warp a query
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
        const int am = lane < groups ? tab_a[ql * groups + lane] : 0;
        if (gm > fminf(gk, ld[k - 1])) gm = INFINITY;  // dead before the first insert
        Extract::run(dist, QB, ql, r0, rw, groups, static_cast<int>(tile_base), gk, ld, li, k,
                     a.unroll, gm, am, lane);
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

struct Call {
  int qb, grid;
  Args args;
  cudaStream_t stream;
  int* config;  // non-null: report the configuration, launch nothing
};

// With c.config: its configuration into config[8] (CTAs resident an SM, SMs,
// registers a thread, local (spill) bytes a thread, dynamic shared memory a
// CTA, lists a query, ring stages, 1 if the ring has its own space);
// otherwise the items kernel and the merge on c.stream. Returns 0 or a CUDA
// error.
template <class Product, bool L2, class Extract>
int run(const Call& c) {
  auto kern = items_kernel<Product, L2, Extract>;
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
  merge_items<Product::QB, Args><<<merge_grid, MERGE_WARPS * 32, 0, c.stream>>>(c.args);
  return static_cast<int>(cudaGetLastError());
}

// run() with the fp32 product at c.qb, L2 or MIPS, or -1 for a qblock the
// kernel does not take.
template <class Extract>
int run_fp32(const Call& c, bool l2) {
  switch (c.qb) {
    case 8: return l2 ? run<FmaProduct<8>, true, Extract>(c) : run<FmaProduct<8>, false, Extract>(c);
    case 16:
      return l2 ? run<FmaProduct<16>, true, Extract>(c) : run<FmaProduct<16>, false, Extract>(c);
    case 32:
      return l2 ? run<FmaProduct<32>, true, Extract>(c) : run<FmaProduct<32>, false, Extract>(c);
    default: return -1;
  }
}

// The layout of (qblock, tile, k) into c, or -1 for arguments the kernel
// refuses.
inline int set_layout(Call& c, int qblock, int tile, int k) {
  if (qblock != 8 && qblock != 16 && qblock != 32) return -1;
  if (k < 1 || k > MAX_K || tile < TILE_STEP || tile % TILE_STEP != 0 || tile > MAX_TILE) return -1;
  c.qb = qblock;
  c.args.tile = tile;
  c.args.k = k;
  c.args.lay = layout(qblock, tile, k);
  return c.args.lay.total <= MAX_SMEM ? 0 : -1;
}

// A launch's arguments into c (the sources' launchers take them in this
// order), or -1 for arguments the kernel refuses.
inline int set_args(Call& c, const void* data, long long n_rows, int d_pad, int d_stream,
                    const void* norms, const void* queries, int q_ld, const void* starts,
                    const void* ends, int nq, int k, int n_real, int tile, int qblock, int unroll,
                    const void* tile_begin, const void* tile_end, const void* prefix,
                    const void* seg, const void* item_code, int n_blocks, void* counter,
                    void* kth, void* part_d, void* part_i, const void* order, void* out_d,
                    void* out_i, int grid, void* stream) {
  if (set_layout(c, qblock, tile, k) != 0) return -1;
  if (d_stream <= 0 || d_stream % stage_dims(qblock) != 0 || d_stream > d_pad || q_ld < d_stream ||
      n_real > n_rows || n_rows >= INT_MAX || unroll < 1 || grid < 1 ||
      n_blocks != (nq + qblock - 1) / qblock)
    return -1;
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
  return 0;
}

}  // namespace scan_items
