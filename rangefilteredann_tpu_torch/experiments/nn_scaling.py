"""Beam-search-time vs index-size scaling study
(ref: experiments/other/testing_nn_scaling.py): build unfiltered Vamana
indices over nested prefixes of a dataset and time fixed-beam searches,
showing the (sub-linear) growth of per-query cost with n. The port's copy of
rangefilteredann_tpu/experiments/nn_scaling.py: builds and searches run on
`--device` (default "cuda")."""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..models.vamana_index import VamanaIndex
from ..models.vamana import build_vamana_graph
from ..params import BuildParams
from ..utils.data import make_pointset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="10000,20000,40000,80000")
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--beam", type=int, default=64)
    ap.add_argument("--R", type=int, default=32)
    ap.add_argument("--L", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    rng = np.random.default_rng(0)
    data = rng.normal(size=(max(sizes), args.d)).astype(np.float32)
    queries = rng.normal(size=(args.nq, args.d)).astype(np.float32)

    print(f"{'n':>9} {'build_s':>8} {'ms/query':>9} {'QPS':>9}")
    for n in sizes:
        ps = make_pointset(data[:n], "l2", device=args.device)
        t0 = time.time()
        g = build_vamana_graph(
            ps, np.arange(n, dtype=np.int64), np.array([0, n]),
            BuildParams(R=args.R, L=args.L, alpha=1.2),
        )
        build_s = time.time() - t0
        idx = VamanaIndex.from_arrays(data[:n], g.nbrs_host, device=args.device)
        idx.batch_search(queries, args.nq, 10, args.beam)  # warm-up
        t0 = time.time()
        idx.batch_search(queries, args.nq, 10, args.beam)
        dt = time.time() - t0
        print(f"{n:>9} {build_s:>8.1f} {1e3*dt/args.nq:>9.3f} {args.nq/dt:>9.0f}")


if __name__ == "__main__":
    main()
