// Scan variant v3b: the range-masked (dist, id) top-k by U insert steps a
// round against a per-128-point group table, then one retire-and-rescan
// pass; and the nested-loop probe. Hand-written CUDA C++ for sm_90a, on the
// persistent item body scan_items.cuh (shared with scan_v2.cu).
//
// Replaces the TPU kernels tools/exp_scan3b.py::_scan_kernel_v3b (wrapper
// scan_v3b) and the kernel of tools/exp_scan3b.py::probe_nested_while. Bound
// from PyTorch by ctypes through rangefilteredann_tpu_torch/tools/
// exp_scan3b.py, whose plain versions are scan_v3b_plain
// (ops/bruteforce.scan_bruteforce) and probe_nested_while_plain.
//
// What it computes: the range-masked (dist, id) top-k of the production scan,
// L2 (norms - 2 q.x, shifted) or MIPS (-q.x), in fp32 (the body's
// FmaProduct).
//
// Bound on an H100 SXM: 2 * sum(window) * d fp32 operations on the CUDA cores
// (67 TFLOP/s), ~0.39 ms at the harness shape (200k x 128, 2,048 queries,
// windows of 50,000) against ~0.03 ms of bytes; no TF32 and no tensor cores,
// so the result stays fp32-exact. What the design does about it: the body's
// persistent items, register tiles, cp.async ring, epilogue-built group
// table and published bound (scan_items.cuh), and this extraction: a round
// runs up to U steps against the table alone, each inserting the table's
// best head if it beats the query's k-th entry ((dist, id) compare) and
// retiring that entry; a step that does not improve ends the round's steps,
// since no later step could. One pass then retires the inserted heads and
// rescans only their groups. A head above the bound is dead, and so is its
// group, since the head is the group's minimum: its entry is dropped
// without a rescan.
//
// The probe: out = x summed in a 3 x 2 nested loop, i.e. 6 x. It showed
// whether the TPU's compiler took a while loop inside a while loop; here it
// is one elementwise kernel.

#include "scan_items.cuh"

namespace {

using namespace scan_items;

struct ExtractV3b {
  __device__ static void run(float* dist, int qb, int ql, int r0, int rw, int groups,
                             int tile_base, float gk, float* ld, int* li, int k, int unroll,
                             float gm, int am, int lane) {
    while (true) {
      const float gm_in = gm;  // round-start heads
      int steps = 0;
      for (; steps < unroll; ++steps) {
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

template <bool L2>
int by_qblock(const Call& c) {
  switch (c.qb) {
    case 8: return run<FmaProduct<8>, L2, ExtractV3b>(c);
    case 16: return run<FmaProduct<16>, L2, ExtractV3b>(c);
    case 32: return run<FmaProduct<32>, L2, ExtractV3b>(c);
    default: return -1;
  }
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
// unroll is the launch's (the kernel is the same for every value). Returns
// 0, a CUDA error, or -1 for arguments the kernel refuses.
int scan_v3b_config(int qblock, int tile, int k, int metric_l2, int /*unroll*/, int* out) {
  Call c{};
  if (set_layout(c, qblock, tile, k) != 0) return -1;
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
  if (set_args(c, data, n_rows, d_pad, d_stream, norms, queries, q_ld, starts, ends, nq, k,
               n_real, tile, qblock, unroll, tile_begin, tile_end, prefix, seg, item_code,
               n_blocks, counter, kth, part_d, part_i, order, out_d, out_i, grid, stream) != 0)
    return -1;
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
