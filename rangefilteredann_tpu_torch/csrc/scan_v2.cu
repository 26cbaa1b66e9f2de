// Scan variant v2: insertion extraction from group minima, with strict
// early exit; an optional bf16 pass on the tensor cores. Hand-written CUDA
// C++ for sm_90a, on the persistent item body scan_items.cuh (shared with
// scan_v3b.cu).
//
// Replaces the TPU kernel tools/exp_scan2.py::_scan_kernel_v2 (wrapper
// scan_v2). Bound from PyTorch by ctypes through
// rangefilteredann_tpu_torch/tools/exp_scan2.py, whose plain version
// scan_v2_plain is ops/bruteforce.scan_bruteforce (L2), on bf16-rounded
// store and queries with the fp32 norms in the bf16 mode.
//
// What it computes: the range-masked (dist, id) top-k of the production scan,
// L2 only (dist = norms - 2 q.x, exp_scan2.py:102). In the bf16 mode the
// query and the store are rounded to bf16 and the products accumulated in
// fp32, while the norms stay the fp32 norms of the unrounded store: another
// function, which an fp32 rerank of k' candidates (rerank_fp32) corrects.
//
// Extraction, per query and tile (one warp): while the table's best (dist,
// id) beats the query's k-th entry and the block's published bound, insert
// it, mask it in the tile and rescan that one group. Candidates come out of
// a tile in (dist, id) order and an item's tiles in ascending id, so the
// TPU's strict `<` early exit and its insert after equal distances
// (exp_scan2.py:61, :116) are the lexicographic compare used here. The
// first head that fails ends the tile: every other head is no smaller, so
// the groups that were not dead before the first insert die with it.
//
// Bound on an H100 SXM: 2 * sum(window) * d operations. fp32 runs on the
// CUDA cores (67 TFLOP/s), so operations bound it at the harness shape (200k
// x 128, 2,048 queries, windows of 1/4: ~26 GFLOP, ~0.39 ms; ~0.1 GB once,
// ~0.03 ms). The bf16 mode runs on the tensor cores (989 TFLOP/s dense), and
// its bound is the bytes. What the design does about it: the body's
// persistent items over the card, cp.async staging in a ring, the tile's
// distances and group table written once by the product's epilogue and the
// published bound (scan_items.cuh); the bf16 product is mma.sync m16n8k16
// on the fp32 rows the ring stages (wgmma and TMA are later work), so both
// modes pay the same staging and extraction, and bf16 only cuts the
// product's share.

#include "scan_items.cuh"

namespace {

using namespace scan_items;

struct ExtractV2 {
  __device__ static void run(float* dist, int qb, int ql, int r0, int rw, int groups,
                             int tile_base, float gk, float* ld, int* li, int k, int /*unroll*/,
                             float gm, int am, int lane) {
    while (true) {
      float m = gm;
      int gsel = lane;
      warp_argmin(m, gsel);
      const int cid = tile_base + gsel * GROUP + __shfl_sync(FULL, am, gsel);
      if (!(m < INFINITY && m <= gk && lex_less(m, cid, ld[k - 1], li[k - 1]))) break;
      warp_insert(ld, li, k, m, cid, lane);
      float* row = group_row(dist, qb, ql, gsel, r0, rw);
      if (lane == gsel) row[am] = INFINITY;  // take it
      __syncwarp();
      float nm;
      int na;
      group_min(row, lane, nm, na);  // repair that group's minimum
      if (lane == gsel) { gm = nm; am = na; }
    }
  }
};

int dispatch(const Call& c, int bf16) {
  switch (c.qb) {
    case 8: return bf16 ? -1 : run<FmaProduct<8>, true, ExtractV2>(c);
    case 16: return bf16 ? run<MmaProduct<16>, true, ExtractV2>(c)
                         : run<FmaProduct<16>, true, ExtractV2>(c);
    case 32: return bf16 ? run<MmaProduct<32>, true, ExtractV2>(c)
                         : run<FmaProduct<32>, true, ExtractV2>(c);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// The configuration a launch of (qblock, tile, k, bf16) takes (metric_l2
// 1), into out[8]: CTAs resident an SM, SMs, registers a thread, local
// (spill) bytes a thread, dynamic shared memory a CTA, lists a query, ring
// stages, and 1 if the ring has its own space (0: it overlays the tile's
// last block). Returns 0, a CUDA error, or -1 for arguments the kernel
// refuses.
int scan_v2_config(int qblock, int tile, int k, int metric_l2, int bf16, int* out) {
  Call c{};
  if (metric_l2 != 1 || set_layout(c, qblock, tile, k) != 0) return -1;
  c.config = out;
  return dispatch(c, bf16);
}

// scan_v3b_launch's arguments (scan_v3b.cu), metric_l2 1 (v2 is L2 only)
// and bf16 in the place of unroll: qblock 8, 16 or 32 (bf16: 16 or 32), tile
// a multiple of 256 up to 4096. The wrapper sorts the queries, builds the
// segment plan (in tiles of `tile` and blocks of qblock), zeroes the
// counter, fills kth with +inf and allocates part_d / part_i for at least
// prefix[n_blocks - 1] items; grid is SMs x resident CTAs from
// scan_v2_config. Returns cudaGetLastError() after the launches (0 on
// success), or -1 for arguments the kernel refuses.
int scan_v2_launch(const void* data, long long n_rows, int d_pad, int d_stream,
                   const void* norms, const void* queries, int q_ld, const void* starts,
                   const void* ends, int nq, int k, int metric_l2, int n_real, int tile,
                   int qblock, int bf16, const void* tile_begin, const void* tile_end,
                   const void* prefix, const void* seg, const void* item_code, int n_blocks,
                   void* counter, void* kth, void* part_d, void* part_i, const void* order,
                   void* out_d, void* out_i, int grid, void* stream) {
  if (nq <= 0) return 0;
  Call c{};
  if (metric_l2 != 1 ||
      set_args(c, data, n_rows, d_pad, d_stream, norms, queries, q_ld, starts, ends, nq, k,
               n_real, tile, qblock, 1, tile_begin, tile_end, prefix, seg, item_code, n_blocks,
               counter, kth, part_d, part_i, order, out_d, out_i, grid, stream) != 0)
    return -1;
  return dispatch(c, bf16);
}

}  // extern "C"
