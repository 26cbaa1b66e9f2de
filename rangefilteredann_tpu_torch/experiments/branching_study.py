"""Branching-factor study — the b_plot.ipynb analysis as a script
(ref: experiments/b_plot.ipynb): sweep the B-WST split_factor, measuring
build time, bucket-count/row profile, and query QPS-at-recall per filter
fraction on a synthetic dataset. Writes the run_our_method CSV schema with
the branching factor recorded per row. The port's copy of
rangefilteredann_tpu/experiments/branching_study.py: the trees build and
search on `--device` (default "cuda").
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import wrapper as wp
from ..models.range_filter_tree import build_offset_rows
from .datasets import generate_random_query_filter_ranges
from .run_our_method import TOP_K, compute_recall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--splits", default="2,3,4,8")
    ap.add_argument("--cutoff", type=int, default=1000)
    ap.add_argument("--fractions", default="-6,-3,-1")
    ap.add_argument("--beam", type=int, default=40)
    ap.add_argument("--out", default="results/branching.csv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.d)).astype(np.float32)
    queries = rng.normal(size=(args.nq, args.d)).astype(np.float32)
    labels = rng.uniform(size=args.n)

    import os

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    new = not os.path.exists(args.out)
    with open(args.out, "a") as f:
        if new:
            f.write("split_factor,rows,filter_width,recall,qps,build_time\n")

    for split in (int(s) for s in args.splits.split(",")):
        rows = build_offset_rows(args.n, args.cutoff, split)
        t0 = time.time()
        tree = wp.vamana_range_filter_tree_constructor("Euclidian", "float")(
            data, labels, cutoff=args.cutoff, split_factor=split,
            build_params=wp.BuildParams(32, 64, 1.2, ""), device=args.device,
        )
        build_time = time.time() - t0
        print(f"split={split}: {len(rows)} rows, build {build_time:.1f}s")
        for p in (int(x) for x in args.fractions.split(",")):
            ranges = generate_random_query_filter_ranges(
                labels, 2.0**p, args.nq, rng
            )
            qp = wp.build_query_params(TOP_K, args.beam, final_beam_multiply=4)
            tree.batch_search(queries, ranges, args.nq, "fenwick", qp)
            t0 = time.time()
            ids, _ = tree.batch_search(queries, ranges, args.nq, "fenwick", qp)
            dt = time.time() - t0
            # exact GT inline (small nq)
            order = np.argsort(labels, kind="stable")
            ls = labels[order]
            gt = []
            for i in range(args.nq):
                a = np.searchsorted(ls, ranges[i, 0])
                b = np.searchsorted(ls, ranges[i, 1], side="right")
                cand = order[a:b]
                dd = ((data[cand] - queries[i]) ** 2).sum(1)
                gt.append(cand[np.argsort(dd)[:TOP_K]])
            recall = compute_recall(ids, np.array(gt), TOP_K)
            with open(args.out, "a") as f:
                f.write(f"{split},{len(rows)},2pow{p},{recall},"
                        f"{args.nq/dt},{build_time}\n")
            print(f"  2pow{p}: recall={recall:.4f} qps={args.nq/dt:.0f}")


if __name__ == "__main__":
    main()
