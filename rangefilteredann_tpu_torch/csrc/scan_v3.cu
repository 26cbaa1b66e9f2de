// Scan variant v3: batched extraction from a per-128-point group-minima
// table, in a nested loop. Hand-written CUDA C++ for sm_90a.
//
// Replaces the TPU kernel tools/exp_scan3.py::_scan_kernel_v3 (wrapper
// scan_v3). Bound from PyTorch by ctypes through
// rangefilteredann_tpu_torch/tools/exp_scan3.py, whose plain version
// scan_v3_plain is ops/bruteforce.scan_bruteforce.
//
// What it computes: the range-masked (dist, id) top-k of the production
// scan, L2 (norms - 2 q.x) or MIPS (-q.x), in fp32.
//
// Extraction, per query and tile (one warp): an outer loop over rounds. In a
// round, the inner loop inserts the table's best head while it beats the
// query's k-th entry (a lexicographic (dist, id) compare, exp_scan3.py:73,
// :154) and retires that head in the table only. Then one pass over the tile
// retires every group's head, inserted or dead, and rebuilds the table
// (exp_scan3.py:172-182). A head the inner loop did not insert no longer
// beats the k-th entry, and the k-th entry only decreases, so it can never
// enter: retiring it unconditionally is safe. The TPU's compiler refused the
// nested loop (HTTP 500); on the card it is an ordinary loop nest.
//
// Bound on an H100 SXM: 2 * sum(window) * d fp32 flops on the CUDA cores
// (67 TFLOP/s): operations, ~0.4 ms at the harness shape (200k x 128, 2,048
// queries, windows of 1/4), against ~0.03 ms of bytes. What the design does
// about it: the shared body (scan_variants.cuh) keeps each tile's distances
// in shared memory, so the rescans of a round read no device memory, and one
// rescan serves up to one insert per group.

#include "scan_variants.cuh"

namespace {

using namespace scanvar;

struct ExtractV3 {
  __device__ static void run(float* row, int groups, int base, float* ld,
                             int* li, int k, int /*unroll*/, int lane) {
    float gm;
    int am;
    build_tables(row, groups, lane, gm, am);
    while (true) {
      bool inserted = false;
      while (true) {
        float m;
        int gsel, cid;
        pick(gm, am, lane, base, m, gsel, cid);
        if (!improves(m, cid, ld, li, k)) break;
        warp_insert(ld, li, k, m, cid, lane);
        if (lane == gsel) gm = INFINITY;  // retired for the rest of the round
        inserted = true;
      }
      if (!inserted) break;
      // one pass: retire every head (inserted or dead) and rebuild the table
      if (lane < groups) row[lane * GROUP + am] = INFINITY;
      __syncwarp();
      build_tables(row, groups, lane, gm, am);
    }
  }
};

}  // namespace

extern "C" {

// metric_l2: 1 for L2, 0 for MIPS. qblock 8, 16 or 32; tile a multiple of
// 256 up to 4096.
int scan_v3_launch(const void* data, long long n_rows, int d_pad,
                   int d_stream, const void* norms, const void* queries,
                   const void* starts, const void* ends, int nq, int k,
                   int metric_l2, int n_real, int tile, int qblock,
                   void* out_d, void* out_i, void* stream) {
  return launch_variant<ExtractV3>(
      qblock, data, n_rows, d_pad, d_stream, norms, queries, starts, ends,
      nq, k, metric_l2, n_real, tile, /*unroll=*/1, out_d, out_i, stream);
}

}  // extern "C"
