// Scan variant v3: the range-masked (dist, id) top-k by rounds that insert a
// group table's heads while they improve, then retire them and rescan.
// Hand-written CUDA C++ for sm_90a, on the persistent item body
// scan_items.cuh (shared with scan_v2.cu and scan_v3b.cu).
//
// Replaces the TPU kernel tools/exp_scan3.py::_scan_kernel_v3 (wrapper
// scan_v3). Bound from PyTorch by ctypes through
// rangefilteredann_tpu_torch/tools/exp_scan3.py (launched by
// tools/scan_items.py), whose plain version scan_v3_plain is
// ops/bruteforce.scan_bruteforce.
//
// What it computes: the range-masked (dist, id) top-k of the production scan,
// L2 (norms - 2 q.x, shifted) or MIPS (-q.x), in fp32 (the body's
// FmaProduct).
//
// Bound on an H100 SXM: 2 * sum(window) * d fp32 operations on the CUDA cores
// (67 TFLOP/s), ~0.39 ms at the harness shape (200k x 128, 2,048 queries,
// windows of 50,000) against ~0.03 ms of bytes. What the design does about
// it: the body's persistent items, register tiles, cp.async ring,
// epilogue-built group table and published bound (scan_items.cuh), with
// v3's extraction as the body's round extraction with no cap on the steps
// (RoundExtract<false>): v3's pass that retires every head and rebuilds the
// whole table is, on this body, a rescan of the inserted heads' groups only
// (the argument is at RoundExtract). The TPU's compiler refused the nested
// loop; on the card it is an ordinary loop nest.

#include "scan_items.cuh"

using namespace scan_items;

extern "C" {

// The configuration a launch of (qblock, tile, k, metric) takes, into
// out[8]: CTAs resident an SM, SMs, registers a thread, local (spill) bytes
// a thread, dynamic shared memory a CTA, lists a query, ring stages, and 1
// if the ring has its own space (0: it overlays the tile's last block).
// mode is unused (v3 has no step cap). Returns 0, a CUDA error, or -1 for
// arguments the kernel refuses.
int scan_v3_config(int qblock, int tile, int k, int metric_l2, int /*mode*/, int* out) {
  Call c{};
  if (set_layout(c, qblock, tile, k) != 0) return -1;
  c.config = out;
  return run_fp32<RoundExtract<false>>(c, metric_l2 != 0);
}

// scan_v3b_launch's arguments (scan_v3b.cu), mode in the place of unroll
// (>= 1, unused): metric_l2 1 for L2, 0 for MIPS; qblock 8, 16 or 32; tile
// a multiple of 256 up to 4096. The wrapper sorts the queries, builds the
// segment plan (in tiles of `tile` and blocks of qblock), zeroes the
// counter, fills kth with +inf and allocates part_d / part_i for at least
// prefix[n_blocks - 1] items; grid is SMs x resident CTAs from
// scan_v3_config. Returns cudaGetLastError() after the launches (0 on
// success), or -1 for arguments the kernel refuses.
int scan_v3_launch(const void* data, long long n_rows, int d_pad, int d_stream,
                   const void* norms, const void* queries, int q_ld, const void* starts,
                   const void* ends, int nq, int k, int metric_l2, int n_real, int tile,
                   int qblock, int mode, const void* tile_begin, const void* tile_end,
                   const void* prefix, const void* seg, const void* item_code, int n_blocks,
                   void* counter, void* kth, void* part_d, void* part_i, const void* order,
                   void* out_d, void* out_i, int grid, void* stream) {
  if (nq <= 0) return 0;
  Call c{};
  if (set_args(c, data, n_rows, d_pad, d_stream, norms, queries, q_ld, starts, ends, nq, k,
               n_real, tile, qblock, mode, tile_begin, tile_end, prefix, seg, item_code,
               n_blocks, counter, kth, part_d, part_i, order, out_d, out_i, grid, stream) != 0)
    return -1;
  return run_fp32<RoundExtract<false>>(c, metric_l2 != 0);
}

}  // extern "C"
