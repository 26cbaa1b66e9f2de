"""Super-postfiltering arrangement cost study
(ref: experiments/other/postfiltering_arrangements.py:9-60).

For a grid of (split_factor, shift_factor) pairs, computes (a) the total
memory blowup of the overlapping-bucket rows relative to one copy of the
dataset, and (b) the worst-case query blowup — the largest ratio
bucket_size / query_width over query widths that route to each row — then
prints the Pareto-optimal settings. Pure integer arithmetic over
super_row_layout, no device work.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.super_postfilter_tree import super_row_layout


def arrangement_cost(n: int, cutoff: int, split: float, shift: float):
    rows = super_row_layout(n, cutoff, split, shift)
    # memory: total points stored across rows / n
    total = 0
    for bsize, bshift, nb in rows:
        if nb == 1:
            total += n
        else:
            starts = np.arange(nb) * bshift
            total += int(np.minimum(starts + bsize, n).sum() - starts.sum())
    memory_blowup = total / n
    # query blowup: a query of width w routes to the smallest row whose
    # buckets are guaranteed to contain some width-w range; guaranteed
    # coverage requires w <= bsize - bshift + 1 (adjacent buckets overlap by
    # bsize - bshift). Worst ratio is bsize / smallest width that still
    # routes to this row (one more than the next row's guarantee).
    guarantees = [
        bsize - bshift + 1 if nb > 1 else n for bsize, bshift, nb in rows
    ]
    worst = 1.0
    for r in range(len(rows)):
        bsize = rows[r][0]
        w_min = guarantees[r + 1] + 1 if r + 1 < len(rows) else 1
        worst = max(worst, bsize / max(w_min, 1))
    return memory_blowup, worst


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--cutoff", type=int, default=1000)
    args = ap.parse_args(argv)
    results = []
    for split in (1.5, 2.0, 3.0, 4.0):
        for shift in (0.25, 0.5, 0.65, 0.75, 0.9):
            mem, blow = arrangement_cost(args.n, args.cutoff, split, shift)
            results.append((split, shift, mem, blow))
            print(f"split={split:4} shift={shift:4}: memory x{mem:6.2f}  "
                  f"worst query blowup x{blow:8.1f}")
    # Pareto front on (memory, blowup)
    pareto = [
        r for r in results
        if not any(o[2] <= r[2] and o[3] < r[3] or o[2] < r[2] and o[3] <= r[3]
                   for o in results)
    ]
    print("\nPareto-optimal (memory, blowup):")
    for split, shift, mem, blow in sorted(pareto, key=lambda r: r[2]):
        print(f"  split={split} shift={shift}: x{mem:.2f} mem, x{blow:.1f} query")


if __name__ == "__main__":
    main()
