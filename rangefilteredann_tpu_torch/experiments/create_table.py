"""LaTeX speedup tables — parity with the reference's create_table.py:
speedup = best our-method QPS / best baseline QPS among rows above a recall
threshold, per filter fraction 2^-11..2^0 (ref: create_table.py:5-37).

Implementation is plain csv + dict grouping (no pandas): the result CSVs
follow the reference schema (filter_width,method,recall,...,qps,...), where
`filter_width` may carry a leading/trailing "_" from filename joins and
`method` is "<family>_<param>_<param>" — the family is the prefix before
the first "_".
"""

from __future__ import annotations

import csv
import glob
import math

OUR_METHODS = [
    "vamana-tree",
    "three-split",
    "super-postfiltering",
    "optimized-postfiltering",
]
THEIR_METHODS = ["milvus", "vbase", "postfiltering", "prefiltering"]
POWS = list(range(-11, 1))
RECALL_THRESHOLDS = [0.8, 0.9, 0.95, 0.99, 0.995]


def _iter_rows(dataset_name, results_dir):
    """Yield (filter_width, method_family, recall, qps) from every result
    CSV whose filename mentions the dataset."""
    for path in glob.glob(f"{results_dir}/*{dataset_name}*.csv"):
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                try:
                    rec, qps = float(row["recall"]), float(row["qps"])
                except (KeyError, TypeError, ValueError):
                    continue
                width = str(row.get("filter_width", "")).strip("_")
                family = str(row.get("method", "")).split("_", 1)[0]
                yield width, family, rec, qps


def speedup_of_our_best_method(dataset_name, filter_width, recall_threshold,
                               results_dir="results"):
    """Best OUR_METHODS qps / best THEIR_METHODS qps above the threshold
    at one filter width; NaN when either side has no qualifying row."""
    best = {"ours": -math.inf, "theirs": -math.inf}
    for width, family, rec, qps in _iter_rows(dataset_name, results_dir):
        if width != filter_width or rec <= recall_threshold:
            continue
        if family in OUR_METHODS:
            best["ours"] = max(best["ours"], qps)
        elif family in THEIR_METHODS:
            best["theirs"] = max(best["theirs"], qps)
    if math.isinf(best["ours"]) or math.isinf(best["theirs"]):
        return float("nan")
    return best["ours"] / best["theirs"]


def _latex_table(header, rows):
    """Booktabs tabular like the reference's pandas to_latex output."""
    cols = "l" + "r" * (len(header) - 1)
    body = [
        " & ".join(
            c if isinstance(c, str) else
            ("NaN" if math.isnan(c) else f"{c:0.2f}")
            for c in r) + r" \\"
        for r in rows
    ]
    return "\n".join(
        [rf"\begin{{tabular}}{{{cols}}}", r"\toprule",
         " & ".join(header) + r" \\", r"\midrule"]
        + body
        + [r"\bottomrule", r"\end{tabular}", ""])


def main(datasets=None, results_dir="results"):
    datasets = datasets or [
        "deep-image-96-angular",
        "sift-128-euclidean",
        "glove-100-angular",
        "redcaps-512-angular",
    ]
    header = ["Dataset"] + [f"$2^{{{p}}}$" for p in POWS]
    for thr in RECALL_THRESHOLDS:
        rows = [
            [d] + [speedup_of_our_best_method(d, f"2pow{p}", thr,
                                              results_dir)
                   for p in POWS]
            for d in datasets
        ]
        print(thr)
        print(_latex_table(header, rows))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:] or None)
