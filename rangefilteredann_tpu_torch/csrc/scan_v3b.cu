// Scan variant v3b: the range-masked (dist, id) top-k by U insert steps a
// round against a per-128-point group table, then one retire-and-rescan
// pass; and the nested-loop probe. Hand-written CUDA C++ for sm_90a, on the
// persistent item body scan_items.cuh (shared with scan_v2.cu and
// scan_v3.cu).
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
// table and published bound (scan_items.cuh), and its round extraction
// capped at U = unroll steps a round (RoundExtract<true>), so that one
// rescan pass serves up to U inserts.
//
// The probe: out = x summed in a 3 x 2 nested loop (acc = 0, then acc += x
// six times, the plain version's order; 6 * x would round differently). It
// showed whether the TPU's compiler took a while loop inside a while loop;
// here it is one elementwise kernel, bound by its bytes (4 read and 4
// written an element: 8 KB at the JAX tool's [8, 128], ~2.4 ns at 3.35
// TB/s), so at that shape its time is one launch. A lane loads one float4
// and stores one (one CTA of 256 lanes covers [8, 128]), grid-stride beyond
// that; the n % 4 tail, and all of x where x or out is not 16-byte aligned,
// go one float a lane.

#include "scan_items.cuh"

namespace {

using namespace scan_items;

constexpr int PROBE_THREADS = 256;
constexpr long long PROBE_MAX_CTAS = 4096;  // then the lanes stride

__device__ __forceinline__ float nested_sum(float v) {
  float acc = 0.f;
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 2; ++b) acc += v;
  return acc;
}

__global__ void __launch_bounds__(PROBE_THREADS)
    probe_nested_while_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * PROBE_THREADS;
  const long long t = static_cast<long long>(blockIdx.x) * PROBE_THREADS + threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = t; i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<float4*>(out)[i] =
        make_float4(nested_sum(v.x), nested_sum(v.y), nested_sum(v.z), nested_sum(v.w));
  }
  for (long long i = 4 * n4 + t; i < n; i += stride) out[i] = nested_sum(x[i]);
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
  return run_fp32<RoundExtract<true>>(c, metric_l2 != 0);
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
  return run_fp32<RoundExtract<true>>(c, metric_l2 != 0);
}

// out[i] = x[i] summed in a 3 x 2 nested loop, i < n, on `stream`. Returns
// cudaGetLastError() after the launch (0 on success).
int probe_nested_while_launch(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long ctas = ((n + 3) / 4 + PROBE_THREADS - 1) / PROBE_THREADS;
  probe_nested_while_kernel<<<static_cast<int>(ctas < PROBE_MAX_CTAS ? ctas : PROBE_MAX_CTAS),
                              PROBE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
