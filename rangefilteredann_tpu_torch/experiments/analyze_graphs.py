"""Stored-graph forensics (ref: experiments/other/analyzing_stored_graphs.py:
pure-Python reader of the binary graph format + degree statistics over an
index cache directory)."""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..utils.io import read_graph_file
from ..utils.stats import graph_stats


def analyze_file(path: str):
    if path.endswith(".npz"):
        with np.load(path) as z:
            nbrs = z["nbrs"]
    else:
        nbrs, _ = read_graph_file(path)
    avg, mx = graph_stats(nbrs)
    degs = (nbrs >= 0).sum(axis=1)
    return {
        "file": os.path.basename(path),
        "n": nbrs.shape[0],
        "R": nbrs.shape[1],
        "avg_degree": round(avg, 2),
        "max_degree": mx,
        "isolated": int((degs == 0).sum()),
        "p50_degree": int(np.median(degs)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cache_dir", help="index cache dir (*.bin / *.npz graphs)")
    args = ap.parse_args(argv)
    files = sorted(
        glob.glob(os.path.join(args.cache_dir, "**", "*.npz"), recursive=True)
        + glob.glob(os.path.join(args.cache_dir, "**", "*.bin"), recursive=True)
    )
    if not files:
        print(f"no graph files under {args.cache_dir}")
        return
    for f in files:
        try:
            info = analyze_file(f)
        except Exception as e:
            print(f"{os.path.basename(f)}: unreadable ({e})")
            continue
        print(
            f"{info['file']}: n={info['n']} R={info['R']} "
            f"deg avg={info['avg_degree']} p50={info['p50_degree']} "
            f"max={info['max_degree']} isolated={info['isolated']}"
        )


if __name__ == "__main__":
    main()
