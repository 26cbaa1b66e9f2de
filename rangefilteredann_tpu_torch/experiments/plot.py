"""Recall-vs-QPS Pareto plots — parity with the reference's experiments/plot.py.

Per filter fraction: the Pareto front of (recall, QPS) per method, in a grid
of subplots with the reference's 1-(1-x)^(1/10) x-axis warp
(ref: plot.py:130-152), per-dataset fraction exclusions (ref: plot.py:52-57),
and the smart-combined drop (ref: plot.py:79).
"""

from __future__ import annotations

import glob
import re

import numpy as np

MAX_ALLOWED_RECALL = 0.9999
BASELINE_METHODS = ["prefiltering", "postfiltering", "milvus", "vbase"]

filter_out_map = {
    "sift-128-euclidean": [-16, -15, -14, -13, -12],
    "glove-100-angular": [-16, -15, -14, -13, -12],
    "deep-image-96-angular": [-1, -3, -5, -7, -9, -11, -13, -15, -16],
    "redcaps-512-angular": [-1, -3, -5, -7, -9, -11, -13, -15, -16],
}


def pareto_front(recalls: np.ndarray, qps: np.ndarray):
    """Upper-right Pareto front of (recall, qps), recalls descending in."""
    order = np.argsort(-recalls)
    xs, ys = [], []
    best = -np.inf
    for i in order:
        if qps[i] > best:
            xs.append(recalls[i])
            ys.append(qps[i])
            best = qps[i]
    return np.array(xs[::-1]), np.array(ys[::-1])


def load_results(dataset_name: str, results_dir: str = "results"):
    import pandas as pd

    paths = glob.glob(f"{results_dir}/*{dataset_name}*.csv")
    if not paths:
        raise FileNotFoundError(f"no results for {dataset_name} in {results_dir}/")
    df = pd.concat([pd.read_csv(p) for p in paths])
    df["filter_width"] = df["filter_width"].astype(str).str.strip("_")
    drop = [f"2pow{i}" for i in filter_out_map.get(dataset_name, [])]
    df = df[~df["filter_width"].isin(drop)]
    df["method"] = df["method"].str.split("_").str[0]
    df = df[df["method"] != "smart-combined"]
    df["recall"] = df["recall"].clip(upper=MAX_ALLOWED_RECALL)
    return df


def plot(dataset_name: str, results_dir: str = "results", out: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.ticker import FormatStrFormatter

    df = load_results(dataset_name, results_dir)
    widths = df["filter_width"].unique().tolist()
    num_cols = 4
    num_rows = (len(widths) + num_cols - 1) // num_cols
    fig, axes = plt.subplots(
        num_rows, num_cols, figsize=(6 * num_cols, 6 * num_rows), tight_layout=True
    )
    axes = np.atleast_1d(axes).reshape(-1)
    cmap = plt.get_cmap("tab10")
    colors = {}

    for (width, method), group in df.groupby(["filter_width", "method"]):
        if method not in colors:
            colors[method] = cmap(len(colors) % 10)
        color = colors[method]
        label, marker = (
            ("Baseline: " + method.capitalize(), "o")
            if method in BASELINE_METHODS
            else (method, "x")
        )
        ax = axes[widths.index(width)]
        x, y = pareto_front(np.array(group["recall"]), np.array(group["qps"]))
        ax.plot(x, y, label=label, color=color, marker=marker, markersize=10)

    for i, width in enumerate(widths):
        ax = axes[i]
        max_recall = df[df["filter_width"] == width]["recall"].max()
        title = re.sub(r"2\^(-?\d+)", r"$2^{\1}$", f"Filter Fraction: {width.replace('2pow', '2^')}")
        # the reference's recall-warp x axis (ref: plot.py:130-142)
        alpha = 10
        ax.set_xscale(
            "function",
            functions=(lambda x: 1 - (1 - x) ** (1 / alpha),
                       lambda x: 1 - (1 - x) ** alpha),
        )
        ax.xaxis.set_major_formatter(FormatStrFormatter("%g"))
        ticks = [0, 0.5, 1 - 1e-1, 1 - 1e-2, 1 - 1e-3, 1 - 1e-4, MAX_ALLOWED_RECALL]
        ticks = [t for t in ticks if t <= 1 - ((1 - max_recall) / 10)]
        ax.set_xticks(ticks)
        ax.set_xlim(0, max(ticks))
        ax.set_yscale("log")
        ax.set_title(title)
        ax.grid(visible=True, which="major", color="0.85")
        ax.legend(fontsize=8)
    fig.supxlabel("Recall")
    fig.supylabel("Queries Per Second")
    out = out or f"results/{dataset_name}_pareto.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


if __name__ == "__main__":
    import sys

    plot(sys.argv[1] if len(sys.argv) > 1 else "synthetic-64-euclidean")
