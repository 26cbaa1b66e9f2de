"""Recall-vs-QPS plot for the adversarial dataset
(ref: experiments/plot_adversarial.py). Unlike plot.py there is a single
implicit filter width (each query targets exactly one cluster's label
window), so this renders one Pareto panel comparing all methods."""

from __future__ import annotations

import argparse
import os

import numpy as np

from .plot import pareto_front


def load_rows(results_file: str):
    import csv

    rows = []
    with open(results_file) as f:
        for row in csv.DictReader(f):
            rows.append(row)
    return rows


def plot(results_file: str, out: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = load_rows(results_file)
    by_family = {}
    for r in rows:
        fam = r["method"].split("_")[0]
        by_family.setdefault(fam, []).append(
            (float(r["recall"]), float(r["qps"]))
        )
    fig, ax = plt.subplots(figsize=(7, 5))
    for fam, pts in sorted(by_family.items()):
        recalls = np.array([p[0] for p in pts])
        qps = np.array([p[1] for p in pts])
        px, py = pareto_front(recalls, qps)  # recall-ascending points
        ax.plot(px, py, "o-", label=fam)
    ax.set_yscale("log")
    ax.set_xlabel("recall@10")
    ax.set_ylabel("QPS")
    ax.set_title("adversarial dataset")
    ax.legend(fontsize=8)
    out = out or os.path.splitext(results_file)[0] + "_adversarial.png"
    fig.savefig(out, dpi=150, bbox_inches="tight")
    print(f"wrote {out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results_file")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    plot(args.results_file, args.out)


if __name__ == "__main__":
    main()
