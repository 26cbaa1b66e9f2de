"""The CUDA emulator's own tests (tests/cuda_emu/): tiny kernels written
here, built by emulate.build the way the port's kernels are, and run on the
CPU.

A warp's collectives equal their CUDA definitions on a known lane pattern; a
collective that part of a warp reaches, and a __syncthreads that half the
CTA reaches, abort the launch with the emulator's message within seconds
instead of hanging; and a read of a neighbour's shared-memory slot with no
__syncthreads after the write reads too early, in the order of the sweep it
falls in, where its synchronised twin reads what was written.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import ctypes
import subprocess
import sys

import numpy as np
import pytest

from .cuda_emu import emulate

SOURCE = r"""
#include <cuda_runtime.h>

// Thread t's results of each collective on v = in[t], 8 a thread.
__global__ void collectives(const int* in, int* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x, lane = threadIdx.x & 31;
  const int v = in[t];
  int* o = out + 8 * t;
  o[0] = __shfl_xor_sync(0xffffffffu, v, 5);
  o[1] = __shfl_sync(0xffffffffu, v, (lane * 7 + 3) & 31);
  o[2] = __shfl_up_sync(0xffffffffu, v, 3);
  o[3] = static_cast<int>(__ballot_sync(0xffffffffu, v & 1));
  o[4] = __reduce_add_sync(0xffffffffu, v);
  o[5] = __reduce_min_sync(0xffffffffu, v);
  o[6] = __reduce_max_sync(0xffffffffu, v);
  o[7] = __any_sync(0xffffffffu, v == 7);
}

// Each thread writes t + 1 into its slot, then reads its left and right
// neighbours' (0 past the ends), after `pre` barriers and with or without
// one between the write and the read.
template <bool SYNC>
__global__ void neighbours(int pre, int* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s = reinterpret_cast<int*>(smem);
  const int t = threadIdx.x, n = blockDim.x;
  for (int i = 0; i < pre; ++i) __syncthreads();
  s[t] = t + 1;
  if (SYNC) __syncthreads();
  out[2 * t] = t > 0 ? s[t - 1] : 0;
  out[2 * t + 1] = t + 1 < n ? s[t + 1] : 0;
}

__global__ void half_syncthreads(int* out) {
  if (threadIdx.x < blockDim.x / 2) __syncthreads();
  out[threadIdx.x] = 1;
}

__global__ void half_warp_shuffle(int* out) {
  int v = threadIdx.x;
  if ((threadIdx.x & 31) < 16) v = __shfl_xor_sync(0xffffffffu, v, 1);
  out[threadIdx.x] = v;
}

extern "C" {
int collectives_launch(const int* in, int* out, int ctas, int threads) {
  collectives<<<ctas, threads, 0, nullptr>>>(in, out);
  return 0;
}
int neighbours_launch(int sync, int pre, int* out, int threads) {
  if (sync) neighbours<true><<<1, threads, 4 * threads, nullptr>>>(pre, out);
  else neighbours<false><<<1, threads, 4 * threads, nullptr>>>(pre, out);
  return 0;
}
int half_syncthreads_launch(int* out, int threads) {
  half_syncthreads<<<1, threads, 0, nullptr>>>(out);
  return 0;
}
int half_warp_shuffle_launch(int* out, int threads) {
  half_warp_shuffle<<<1, threads, 0, nullptr>>>(out);
  return 0;
}
}
"""


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The kernels above built for the CPU: (library, its path)."""
    out = tmp_path_factory.mktemp("cuda_emu")
    (out / "emu_probe.cu").write_text(SOURCE)
    return emulate.build("emu_probe", out, out), out / "libemu_probe_emu.so"


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_warp_collectives_match_their_definitions(built):
    lib, _ = built
    ctas, threads = 2, 64
    rng = np.random.default_rng(0)
    v = rng.integers(-40, 40, size=ctas * threads).astype(np.int32)
    v[37] = 7  # one warp of the four has a lane at 7
    out = np.zeros((ctas * threads, 8), np.int32)
    assert lib.collectives_launch(_ptr(v), _ptr(out), ctas, threads) == 0
    lane = np.arange(32)
    want = []
    for w in v.reshape(-1, 32):
        ballot = int(sum(int(b) << i for i, b in enumerate(w & 1)))
        want.append(np.stack([
            w[lane ^ 5],
            w[(lane * 7 + 3) & 31],
            np.where(lane >= 3, w[np.maximum(lane - 3, 0)], w),
            np.full(32, np.uint32(ballot).view(np.int32)),
            np.full(32, w.sum()),
            np.full(32, w.min()),
            np.full(32, w.max()),
            np.full(32, int((w == 7).any())),
        ], axis=1))
    np.testing.assert_array_equal(out, np.concatenate(want))


@pytest.mark.parametrize("pre,order", [(0, "thread order"), (1, "reverse order")],
                         ids=["even-sweep", "odd-sweep"])
def test_unsynchronised_neighbour_read_differs(built, pre, order):
    """Between two barriers the threads run in thread order on even sweeps
    and in reverse order on odd ones: without the barrier, a thread reads
    its right neighbour's slot before that neighbour writes it in the
    first, and its left neighbour's in the second."""
    lib, _ = built
    threads = 64
    t = np.arange(threads)
    synced = np.zeros((threads, 2), np.int32)
    racy = np.zeros((threads, 2), np.int32)
    assert lib.neighbours_launch(1, pre, _ptr(synced), threads) == 0
    assert lib.neighbours_launch(0, pre, _ptr(racy), threads) == 0
    want = np.stack([np.where(t > 0, t, 0), np.where(t + 1 < threads, t + 2, 0)], axis=1)
    np.testing.assert_array_equal(synced, want)
    assert (racy != synced).any()
    early = 1 if order == "thread order" else 0  # the neighbour read too early
    np.testing.assert_array_equal(racy[:, 1 - early], synced[:, 1 - early])
    assert not racy[:, early].any()


@pytest.mark.parametrize("launch,barrier,missing", [
    ("half_syncthreads_launch", "the CTA's barrier (__syncthreads): 32 of 64", 32),
    ("half_warp_shuffle_launch", "warp 0's barrier: 16 of 32", 16),
], ids=["syncthreads", "shuffle"])
def test_partial_barrier_fails_fast(built, launch, barrier, missing):
    """A barrier that only part of its threads reach aborts the launch with
    the emulator's message, naming the barrier and its first missing thread,
    well within 5 s (the emulator aborts: so the launch runs in a process of
    its own)."""
    _, path = built
    code = ("import ctypes, sys\n"
            "import numpy as np\n"
            "out = np.zeros(64, np.int32)\n"
            f"ctypes.CDLL(sys.argv[1]).{launch}(out.ctypes.data_as(ctypes.c_void_p), 64)\n")
    run = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True,
                         text=True, timeout=5)
    assert run.returncode != 0
    assert "emulated CUDA: deadlock in block 0" in run.stderr, run.stderr
    assert f"{barrier} threads wait; first missing thread {missing}" in run.stderr, run.stderr
