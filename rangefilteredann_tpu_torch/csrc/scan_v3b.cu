// Scan variant v3b: batched extraction in a single loop, U insert steps per
// rescan; and the nested-loop probe. Hand-written CUDA C++ for sm_90a.
//
// Replaces the TPU kernels tools/exp_scan3b.py::_scan_kernel_v3b (wrapper
// scan_v3b) and the kernel of tools/exp_scan3b.py::probe_nested_while. Bound
// from PyTorch by ctypes through rangefilteredann_tpu_torch/tools/
// exp_scan3b.py, whose plain versions are scan_v3b_plain
// (ops/bruteforce.scan_bruteforce) and probe_nested_while_plain.
//
// What it computes: the range-masked (dist, id) top-k of the production
// scan, L2 (norms - 2 q.x) or MIPS (-q.x), in fp32.
//
// Extraction, per query and tile (one warp): a single loop of rounds. A round
// runs up to U steps against the table alone, each inserting the table's
// best head if it beats the query's k-th entry ((dist, id) compare) and
// retiring it in the table; the TPU unrolled the U steps, here a step that
// does not improve ends them, since no later step could. Then one pass over
// the tile retires the heads that were inserted, or whose round-start value
// is above the new k-th distance (exp_scan3b.py:190-197), and recomputes
// those groups' entries; heads that got no turn stay live. A retired dead
// head is safe only because the k-th entry only decreases: once above it,
// always above it. (The TPU rebuilt every group's entry; the others have not
// changed, so recomputing only the retired ones gives the same table.)
//
// Bound on an H100 SXM: 2 * sum(window) * d fp32 flops on the CUDA cores
// (67 TFLOP/s): operations, ~0.4 ms at the harness shape (200k x 128, 2,048
// queries, windows of 1/4), against ~0.03 ms of bytes. What the design does
// about it: the shared body (scan_variants.cuh) keeps each tile's distances
// in shared memory, and U steps share one rescan. The TPU ran out of VMEM at
// TILE=4096; here a CTA's [QB, tile] block must fit 227 KB of shared memory,
// which the wrapper checks.
//
// The probe: out = x summed in a 3 x 2 nested loop, i.e. 6 x. It showed
// whether the TPU's compiler took a while loop inside a while loop; here it
// is one elementwise kernel.

#include "scan_variants.cuh"

namespace {

using namespace scanvar;

struct ExtractV3b {
  __device__ static void run(float* row, int groups, int base, float* ld,
                             int* li, int k, int unroll, int lane) {
    float gm;
    int am;
    build_tables(row, groups, lane, gm, am);
    while (true) {
      const float gm_in = gm;  // round-start heads, for the dead-head test
      int steps = 0;
      for (; steps < unroll; ++steps) {
        float m;
        int gsel, cid;
        pick(gm, am, lane, base, m, gsel, cid);
        if (!improves(m, cid, ld, li, k)) break;
        warp_insert(ld, li, k, m, cid, lane);
        if (lane == gsel) gm = INFINITY;
      }
      if (steps == 0) break;
      // an empty group's head stays +inf whether retired or not: skip it
      const bool retire = lane < groups && gm_in < INFINITY &&
                          (gm == INFINITY || gm_in > ld[k - 1]);
      if (retire) row[lane * GROUP + am] = INFINITY;
      __syncwarp();
      unsigned mask = __ballot_sync(FULL, retire);
      while (mask) {
        const int g = __ffs(mask) - 1;
        mask &= mask - 1;
        float m;
        int a;
        group_min(row, g, lane, m, a);
        if (lane == g) { gm = m; am = a; }
      }
    }
  }
};

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

// metric_l2: 1 for L2, 0 for MIPS. qblock 8, 16 or 32; tile a multiple of
// 256 up to 4096; unroll >= 1.
int scan_v3b_launch(const void* data, long long n_rows, int d_pad,
                    int d_stream, const void* norms, const void* queries,
                    const void* starts, const void* ends, int nq, int k,
                    int metric_l2, int n_real, int tile, int qblock,
                    int unroll, void* out_d, void* out_i, void* stream) {
  return launch_variant<ExtractV3b, false>(
      qblock, 0, data, n_rows, d_pad, d_stream, norms, queries, starts, ends,
      nq, k, metric_l2, n_real, tile, unroll, out_d, out_i, stream);
}

int probe_nested_while_launch(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  probe_nested_while_kernel<<<(n + 255) / 256, 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
