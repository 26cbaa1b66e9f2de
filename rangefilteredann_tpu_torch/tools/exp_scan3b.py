"""Scan variant v3b: batched extraction in a single loop; the nested-loop probe.

Counterpart of the JAX package's tools/exp_scan3b.py. `scan_v3b` is the
wrapper of csrc/scan_v3b.cu (which replaces the Pallas kernel
`_scan_kernel_v3b`) on the persistent item body it shares with v2 and v3
(csrc/scan_items.cuh, launched through tools/scan_items.py): a persistent
grid of (query block, tile segment) items, a register-tiled fp32 product,
and per round `unroll` insert steps against a per-128-point group-minima
table, then one pass that retires the inserted heads and drops the dead
ones; a merge kernel joins the items' lists. L2 and MIPS, fp32. `probe_sum` is the wrapper of the same file's
probe kernel (which replaces the kernel of the JAX `probe_nested_while`):
x summed in a 3 x 2 nested loop; `probe_nested_while` runs it as the JAX
tool does.

A CPU tensor goes to the plain version (`scan_v3b_plain`,
`probe_nested_while_plain`); a CUDA tensor goes to the kernel or raises.
There is no fallback from one to the other.

    python -m rangefilteredann_tpu_torch.tools.exp_scan3b [--reps 10] [--n 200000]
        [--nq 2048] [--dups] [--skip-probe] [--device cuda|cpu]

runs the probe, then times the production scan and v3b at the card's grid
shapes and unroll counts, compares their ids and distances, and logs each
v3b launch's grid (items, segments a block, CTAs an SM, registers, spills,
shared memory, ring).
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from .. import kernels
from ..ops.scan import scan_topk
from ..utils.data import METRIC_L2, resolve_device
from . import D, GRIDS, K, main_args, log, make_harness, window_scan_plain
from . import scan_items as items

# Kernel launches since the count was last set to 0.
SCAN_V3B_LAUNCHES = 0
PROBE_LAUNCHES = 0

# (tile, qblock, unroll) cases main() runs on the card; the first on the CPU
CASES = ((GRIDS[0][0], GRIDS[0][1], 4), (GRIDS[0][0], GRIDS[0][1], 2),
         (GRIDS[0][0], GRIDS[0][1], 8), (GRIDS[1][0], GRIDS[1][1], 4))

_probe_bound: "set[int]" = set()  # libraries whose probe has its ctypes signature


def scan_v3b_plain(data, norms_sq, queries, starts, ends, k, metric="l2",
                   d_eff=None):
    """The plain version: ops/bruteforce.scan_bruteforce over the first
    d_eff columns."""
    return window_scan_plain(data, norms_sq, queries, starts, ends, k, metric,
                             d_eff)


def scan_v3b(data, norms_sq, queries, starts, ends, k, metric="l2", tile=1024,
             d_eff=None, qblock=32, unroll=4):
    """Exact k nearest within per-query windows. Returns (dists [Q, k] f32,
    ids [Q, k] int32) in the caller's query order, (dist, id) ascending,
    empty slots (+inf, EMPTY_ID), L2 shifted (no ||q||^2)."""
    global SCAN_V3B_LAUNCHES
    items.check_caps(data, k, tile, qblock, unroll=unroll, metric=metric)
    if data.device.type == "cpu":
        return scan_v3b_plain(data, norms_sq, queries, starts, ends, k, metric, d_eff)
    dev = data.device
    with torch.cuda.device(dev):
        out_d, out_i, plan = items.launch(
            kernels.load("scan_v3b"), "scan_v3b", data, norms_sq, queries, starts, ends, k,
            d_eff, tile, qblock, int(metric == METRIC_L2), unroll,
            torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    if plan is not None:
        SCAN_V3B_LAUNCHES += 1
    return out_d, out_i


def grid(data, norms_sq, queries, starts, ends, k, metric="l2", tile=1024, d_eff=None,
         qblock=32):
    """The grid a CUDA call of scan_v3b takes on these inputs
    (tools/scan_items.grid). Launches nothing."""
    return items.grid(kernels.load("scan_v3b"), "scan_v3b", data, norms_sq, queries, starts,
                      ends, k, d_eff, tile, qblock, int(metric == METRIC_L2), 1)


def probe_nested_while_plain(x):
    """x summed in a 3 x 2 nested loop, in the kernel's order."""
    acc = torch.zeros_like(x)
    for _ in range(3):
        for _ in range(2):
            acc = acc + x
    return acc


def probe_launch(lib, x, stream):
    """The probe kernel of `lib` (the built library of csrc/scan_v3b.cu) on
    the contiguous float32 x, on `stream`: out = x summed in a 3 x 2 nested
    loop, allocated here. Raises on a failed launch."""
    fn = lib.probe_nested_while_launch
    if id(lib) not in _probe_bound:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        _probe_bound.add(id(lib))
    out = torch.empty_like(x)
    rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"probe_nested_while launch failed (code {rc})")
    return out


def probe_sum(x):
    """The probe kernel's wrapper: x [..] float32 summed in a 3 x 2 nested
    loop. A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    global PROBE_LAUNCHES
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the probe takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return probe_nested_while_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"the probe takes CPU or CUDA tensors, got {x.device}")
    with torch.cuda.device(x.device):
        out = probe_launch(kernels.load("scan_v3b"), x,
                           torch.cuda.current_stream(x.device).cuda_stream)
    PROBE_LAUNCHES += 1
    return out


def probe_nested_while(device=None):
    """The JAX tool's probe: an [8, 128] tensor of ones on `device` (None =
    the card) through `probe_sum`. Returns the output and logs its sum."""
    x = torch.ones((8, 128), dtype=torch.float32, device=resolve_device(device))
    out = probe_sum(x)
    log(f"nested-while probe: OK (sum={float(out.sum())})")
    return out


def main(argv=None):
    """exp_scan3b's harness on the port. Returns the Harness: its inputs and
    every run's (output, ms)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dups", action="store_true")
    ap.add_argument("--skip-probe", action="store_true")
    args = main_args(ap, argv)
    if not args.skip_probe:
        probe_nested_while(args.device)
    h = make_harness(args.n, args.nq, args.device, args.reps, dups=args.dups,
                     degenerate=True)
    prod, _ = h.timeit("prod", lambda: scan_topk(*h.args, K, METRIC_L2, d_eff=D))
    cases = CASES if h.device.type == "cuda" else CASES[:1]
    for tile, qblock, unroll in cases:
        name = f"v3b T={tile} QB={qblock} U={unroll}"
        out, _ = h.timeit(name, lambda tile=tile, qblock=qblock, unroll=unroll: scan_v3b(
            *h.args, K, tile=tile, d_eff=D, qblock=qblock, unroll=unroll))
        h.vs_prod(prod, out, name)
        if h.device.type == "cuda":
            g = grid(*h.args, K, tile=tile, d_eff=D, qblock=qblock)
            log(f"  grid: {items.grid_note(g, tile)}")
    return h


if __name__ == "__main__":
    main()
