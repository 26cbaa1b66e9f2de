"""Scan variant v3: batched per-group extraction in a nested loop.

Counterpart of the JAX package's tools/exp_scan3.py. `scan_v3` is the
wrapper of csrc/scan_v3.cu (which replaces the Pallas kernel
`_scan_kernel_v3`): per round, the heads of a per-128-point group-minima
table are inserted while they improve, then one pass over the tile retires
every head and rebuilds the table. L2 and MIPS, fp32.

A CPU tensor goes to the plain version `scan_v3_plain`; a CUDA tensor goes
to the kernel or raises. There is no fallback from one to the other.

    python -m rangefilteredann_tpu_torch.tools.exp_scan3 [--reps 10] [--n 200000]
        [--nq 2048] [--dups] [--device cuda|cpu]

times the production scan and v3 at the card's grid shapes and compares
their ids and distances. The first four windows are degenerate (empty or
narrower than k); --dups duplicates every third point (exact ties).
"""

from __future__ import annotations

import argparse

from ..ops.scan import scan_topk
from ..utils.data import METRIC_L2
from . import (D, GRIDS, K, bind, check_caps, main_args, launch,
               make_harness, window_scan_plain)

# Kernel launches since the count was last set to 0.
SCAN_V3_LAUNCHES = 0

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        _launch_fn = bind("scan_v3", "scan_v3_launch", 5)
    return _launch_fn


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
    check_caps(data, k, tile, qblock, metric=metric)
    if data.device.type == "cpu":
        return scan_v3_plain(data, norms_sq, queries, starts, ends, k, metric, d_eff)
    out = launch(_kernel(), "scan_v3", data, norms_sq, queries, starts, ends, k,
                 d_eff, (k, int(metric == METRIC_L2), data.shape[0], tile, qblock))
    if queries.shape[0]:
        SCAN_V3_LAUNCHES += 1
    return out


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
    return h


if __name__ == "__main__":
    main()
