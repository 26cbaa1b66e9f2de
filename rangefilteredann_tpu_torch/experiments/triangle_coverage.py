"""Label-space coverage geometry of super-postfiltering — static port of the
reference's interactive tool (ref: triangle_experiments/test.py).

A window query is a point in (width, start) space; the feasible region is the
"main triangle" {(w, s): w >= 0, s >= bottom_offset, s + w <= 1} (the
reference draws it with bottom_offset = 1/8, slop = 2). A bucket of size y
placed at start x serves every query whose window fits inside it with at most
`slop` blowup — a right triangle with legs `y - y/slop` hanging below-right of
(x, y). Covering the main triangle with minimum total cost (sum of bucket
sizes) is exactly the arrangement problem super_row_layout solves with its
(split_factor, shift_factor) grid (ref: experiments/other/
postfiltering_arrangements.py).

The reference's tool is click-driven; with no display assumed,
this version takes placements from a CSV / the super-tree layout and renders
a static PNG with the same fill-%-and-cost readout, computing areas by
rasterization instead of shapely.

Usage:
  python -m rangefilteredann_tpu_torch.experiments.triangle_coverage \
      [--split 2.0 --shift 0.5 | --placements file.csv] [--out tri.png]
"""

from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np

BOTTOM_OFFSET = 1.0 / 8.0  # ref: test.py bottom_offset
SLOP = 2.0  # ref: test.py slop_value


def coverage_triangle(x: float, y: float, slop: float = SLOP):
    """Vertices of the region served by a bucket of size y at start x
    (ref: test.py add_triangle): [[x, y], [x, y - size], [x + size, y - size]]
    with size = y - y/slop."""
    size = y - y / slop
    return [(x, y), (x, y - size), (x + size, y - size)]


def _raster_inside_main(res: int, bottom_offset: float):
    """Boolean mask of raster cells inside the main triangle
    [[0, b], [1 - b, b], [0, 1]]."""
    xs = (np.arange(res) + 0.5) / res * (1 - bottom_offset)
    ys = bottom_offset + (np.arange(res) + 0.5) / res * (1 - bottom_offset)
    X, Y = np.meshgrid(xs, ys)
    # edges: y >= b; x >= 0; below the hypotenuse from (0,1) to (1-b, b):
    # param: y <= 1 - x * (1 - b) / (1 - b) ... the line through (0,1) and
    # (1-b, b) is y = 1 - x
    return (Y >= bottom_offset) & (X >= 0) & (Y <= 1 - X), X, Y


def _point_in_cover(X, Y, x: float, y: float, slop: float):
    """Raster mask of the coverage triangle at (x, y): the right triangle
    with vertices [(x, y), (x, y - size), (x + size, y - size)] contains
    (px, py) iff px >= x, py >= y - size, and (px - x) <= (y - py)."""
    size = y - y / slop
    return (X >= x) & (Y >= y - size) & (Y <= y) & ((X - x) <= (y - Y))


def evaluate(placements: Sequence[Tuple[float, float]],
             slop: float = SLOP, bottom_offset: float = BOTTOM_OFFSET,
             res: int = 1024):
    """(fill_percent, cost): rasterized fill of the main triangle by the
    placements' coverage triangles, and cost = sum of bucket sizes y
    (ref: test.py update_area_text)."""
    inside, X, Y = _raster_inside_main(res, bottom_offset)
    covered = np.zeros_like(inside)
    for x, y in placements:
        covered |= _point_in_cover(X, Y, x, y, slop)
    total = inside.sum()
    fill = 100.0 * (covered & inside).sum() / max(total, 1)
    cost = float(sum(y for _, y in placements))
    return fill, cost


def super_tree_placements(split: float, shift: float, cutoff_frac: float,
                          bottom_offset: float = BOTTOM_OFFSET
                          ) -> List[Tuple[float, float]]:
    """Placements induced by super_row_layout's (split, shift) arrangement on
    a unit label range: row r has buckets of size y_r at starts k*shift*y_r."""
    from ..models.super_postfilter_tree import super_row_layout

    n = 1_000_000  # arrangement geometry is scale-free; use a fine grid
    rows = super_row_layout(n, int(cutoff_frac * n), split, shift)
    out = []
    for (bsize, bshift, nb) in rows:
        y = bsize / n
        if y < bottom_offset:  # its coverage triangle lies below the region
            continue
        if nb == 1:
            out.append((0.0, y))
            continue
        for b in range(nb):
            x = min(b * bshift / n, 1.0)
            out.append((x, y))
    return out


def render(placements, fill, cost, out_path: str,
           bottom_offset: float = BOTTOM_OFFSET, slop: float = SLOP):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    ax.set_xlabel("Width")
    ax.set_ylabel("Starting Position")
    ax.set_xlim(bottom_offset - 0.2, 1.2 - bottom_offset)
    ax.set_ylim(bottom_offset - 0.2, 1.2)
    main = [(0, bottom_offset), (1 - bottom_offset, bottom_offset), (0, 1)]
    ax.add_patch(patches.Polygon(main, closed=True, color="blue", fill=False))
    for x, y in placements:
        ax.add_patch(patches.Polygon(
            coverage_triangle(x, y, slop), closed=True, color="blue",
            alpha=0.35))
    ax.text(0.1, 0.95, f"Filled: {fill:.2f}% Cost {cost:.2f}",
            transform=ax.transAxes)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--split", type=float, default=2.0)
    ap.add_argument("--shift", type=float, default=0.5)
    ap.add_argument("--cutoff-frac", type=float, default=1 / 64)
    ap.add_argument("--placements", type=str, default=None,
                    help="CSV of x,y placements (overrides --split/--shift)")
    ap.add_argument("--out", type=str, default="triangle_coverage.png")
    args = ap.parse_args(argv)
    if args.placements:
        pl = [tuple(map(float, ln.split(",")))
              for ln in open(args.placements) if ln.strip()]
    else:
        pl = super_tree_placements(args.split, args.shift, args.cutoff_frac)
    fill, cost = evaluate(pl)
    render(pl, fill, cost, args.out)
    print(f"{len(pl)} placements: filled {fill:.2f}% at cost {cost:.2f} "
          f"-> {args.out}")
    return fill, cost


if __name__ == "__main__":
    main()
