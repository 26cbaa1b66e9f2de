// Scan variant v2: insertion extraction from group minima, with strict
// early exit; an optional bf16 single pass. Hand-written CUDA C++ for sm_90a.
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
// Extraction, per query and tile (one warp): build the per-128-point group
// minima; then, while the table's best (dist, id) beats the query's k-th
// entry, insert it, mask it in the tile and recompute that one group's
// minimum. Candidates come out of a tile in (dist, id) order and tiles in
// ascending id, so the TPU's strict `<` early exit and its insert after
// equal distances (exp_scan2.py:61, :116) are the lexicographic compare used
// here.
//
// Bound on an H100 SXM: 2 * sum(window) * d flops. fp32 runs on the CUDA
// cores (67 TFLOP/s), so operations bound it at the harness shape (200k x
// 128, 2,048 queries, windows of 1/4: ~26 GFLOP, ~0.4 ms; ~0.1 GB once,
// ~0.03 ms). The bf16 mode runs on the tensor cores (989 TFLOP/s dense) and
// its operations bound drops 15x, under the bytes of the rows its windows
// cover. What the design does about it: the shared body (scan_variants.cuh)
// keeps each tile's distances in shared memory, so extraction costs no
// device-memory traffic, and runs the bf16 product as warp-level
// mma.sync m16n8k16 (wgmma and TMA are later work).

#include "scan_variants.cuh"

namespace {

using namespace scanvar;

struct ExtractV2 {
  __device__ static void run(float* row, int groups, int base, float* ld,
                             int* li, int k, int /*unroll*/, int lane) {
    float gm;
    int am;
    build_tables(row, groups, lane, gm, am);
    while (true) {
      float m;
      int gsel, cid;
      pick(gm, am, lane, base, m, gsel, cid);
      if (!improves(m, cid, ld, li, k)) break;
      warp_insert(ld, li, k, m, cid, lane);
      if (lane == 0) row[cid - base] = INFINITY;  // take it
      __syncwarp();
      float nm;
      int na;
      group_min(row, gsel, lane, nm, na);  // repair that group's minimum
      if (lane == gsel) { gm = nm; am = na; }
    }
  }
};

}  // namespace

extern "C" {

// qblock 8, 16 or 32 (bf16: 16 or 32); tile a multiple of 256 up to 4096.
int scan_v2_launch(const void* data, long long n_rows, int d_pad,
                   int d_stream, const void* norms, const void* queries,
                   const void* starts, const void* ends, int nq, int k,
                   int n_real, int tile, int qblock, int bf16, void* out_d,
                   void* out_i, void* stream) {
  return launch_variant<ExtractV2, true>(
      qblock, bf16, data, n_rows, d_pad, d_stream, norms, queries, starts,
      ends, nq, k, /*metric_l2=*/1, n_real, tile, /*unroll=*/1, out_d, out_i,
      stream);
}

}  // extern "C"
