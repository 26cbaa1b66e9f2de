"""Scan variant v3: batched per-group extraction in a nested loop.

Counterpart of the JAX package's tools/exp_scan3.py. `scan_v3` is the
wrapper of csrc/scan_v3.cu (which replaces the Pallas kernel
`_scan_kernel_v3`) on the persistent item body it shares with v2 and v3b
(csrc/scan_items.cuh, launched through tools/scan_items.py): per round, the
heads of a per-128-point group-minima table are inserted while they
improve, then the inserted heads are retired and only their groups
rescanned (v3's pass that retires every head and rebuilds the whole table:
the heads not inserted are dead, see RoundExtract in the header); a merge
kernel joins the items' lists. L2 and MIPS, fp32.

A CPU tensor goes to the plain version `scan_v3_plain`; a CUDA tensor goes
to the kernel or raises. There is no fallback from one to the other.

    python -m rangefilteredann_tpu_torch.tools.exp_scan3 [--reps 10] [--n 200000]
        [--nq 2048] [--dups] [--device cuda|cpu]

times the production scan and v3 at the card's grid shapes, compares
their ids and distances, and logs each v3 launch's grid (items, segments a
block, CTAs an SM, registers, spills, shared memory, ring). The first four
windows are degenerate (empty or narrower than k); --dups duplicates every
third point (exact ties).
"""

from __future__ import annotations

import argparse

import torch

from .. import kernels
from ..ops.scan import scan_topk
from ..utils.data import METRIC_L2
from . import D, GRIDS, K, log, main_args, make_harness, window_scan_plain
from . import scan_items as items

# Kernel launches since the count was last set to 0.
SCAN_V3_LAUNCHES = 0


def scan_v3_plain(data, norms_sq, queries, starts, ends, k, metric="l2",
                  d_eff=None):
    """The plain version: ops/bruteforce.scan_bruteforce over the first
    d_eff columns."""
    return window_scan_plain(data, norms_sq, queries, starts, ends, k, metric,
                             d_eff)


def scan_v3(data, norms_sq, queries, starts, ends, k, metric="l2", tile=1024,
            d_eff=None, qblock=32):
    """Exact k nearest within per-query windows. Returns (dists [Q, k] f32,
    ids [Q, k] int32) in the caller's query order, (dist, id) ascending,
    empty slots (+inf, EMPTY_ID), L2 shifted (no ||q||^2)."""
    global SCAN_V3_LAUNCHES
    items.check_caps(data, k, tile, qblock, metric=metric)
    if data.device.type == "cpu":
        return scan_v3_plain(data, norms_sq, queries, starts, ends, k, metric, d_eff)
    dev = data.device
    with torch.cuda.device(dev):
        out_d, out_i, plan = items.launch(
            kernels.load("scan_v3"), "scan_v3", data, norms_sq, queries, starts, ends, k,
            d_eff, tile, qblock, int(metric == METRIC_L2), 1,
            torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    if plan is not None:
        SCAN_V3_LAUNCHES += 1
    return out_d, out_i


def grid(data, norms_sq, queries, starts, ends, k, metric="l2", tile=1024, d_eff=None,
         qblock=32):
    """The grid a CUDA call of scan_v3 takes on these inputs
    (tools/scan_items.grid). Launches nothing."""
    return items.grid(kernels.load("scan_v3"), "scan_v3", data, norms_sq, queries, starts,
                      ends, k, d_eff, tile, qblock, int(metric == METRIC_L2), 1)


def main(argv=None):
    """exp_scan3's harness on the port. Returns the Harness: its inputs and
    every run's (output, ms)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dups", action="store_true",
                    help="inject duplicate points (exact-tie stress)")
    args = main_args(ap, argv)
    h = make_harness(args.n, args.nq, args.device, args.reps, dups=args.dups,
                     degenerate=True)
    prod, _ = h.timeit("prod", lambda: scan_topk(*h.args, K, METRIC_L2, d_eff=D))
    grids = GRIDS if h.device.type == "cuda" else GRIDS[:1]
    for tile, qblock in grids:
        name = f"v3 T={tile} QB={qblock}"
        out, _ = h.timeit(name, lambda tile=tile, qblock=qblock: scan_v3(
            *h.args, K, tile=tile, d_eff=D, qblock=qblock))
        h.vs_prod(prod, out, name)
        if h.device.type == "cuda":
            g = grid(*h.args, K, tile=tile, d_eff=D, qblock=qblock)
            log(f"  grid: {items.grid_note(g, tile)}")
    return h


if __name__ == "__main__":
    main()
