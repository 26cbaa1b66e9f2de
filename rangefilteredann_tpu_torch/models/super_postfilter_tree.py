"""SuperOptimizedPostfilterTree — overlapping-bucket postfiltering.

Counterpart of rangefilteredann_tpu/models/super_postfilter_tree.py (ref:
src/super_optimized_postfilter_tree.h:29-271). Row 0 is one bucket over the
label-sorted points; row r+1 holds fixed-size *overlapping* buckets of
size prev / split_factor (truncated float division, ref: :148-149) that
start every ceil(size * shift_factor) points (ref: :150), until the size is
at most cutoff. A query range of width <= (1 - shift) * size fits wholly in
some bucket of the row. Each query is routed to the smallest bucket that
holds its range (rows scanned smallest first, row 0 the fallback) and runs
the beam-doubling postfilter in that one bucket (ref: :187-270).

Overlapping buckets cannot share one adjacency over the sorted ids, so each
row is a slab: its buckets laid out one after another in slab space with an
explicit slab -> sorted id map, and all of a row's buckets build in one
batched Vamana build (models/vamana.py). The searches of a batch run one
doubling_postfilter per routed row: on the card the beam kernel for rows
that plan_row_inline gave int8 blocks, batched_beam_search for the rest.

`shard(mesh)` replicates the index over a mesh's devices and splits each
row's searches over them, every search taking the plain
batched_beam_search, as in the JAX package (parallel/sharded.py).

Not ported: the JAX package's device query cache keys (`_qkey`), and the
`pad_rows` / `insert_pad` build options that let its rows share compiled
shapes (models/vamana.py says why none is needed; a row cache either
package saved loads into the other).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..ops.topk import EMPTY_ID
from ..parallel.sharded import replicate_index
from ..params import (
    DEFAULT_CUTOFF,
    DEFAULT_SHIFT_FACTOR,
    DEFAULT_SPLIT_FACTOR,
    BuildParams,
    QueryParams,
)
from ..utils.data import first_geq, make_pointset, pad_queries, sort_by_labels
from .base import (
    RowResidency,
    cache_fingerprint,
    finalize_output,
    plan_row_inline,
    to_device,
    whole_dataset_cache,
)
from .postfilter_vamana import doubling_postfilter
from .vamana import SlabGraph, load_or_build_row


def super_row_layout(n: int, cutoff: int, split_factor: float, shift_factor: float):
    """Per-row (bucket_size, bucket_shift, num_buckets), the reference's
    arithmetic (ref: super_optimized_postfilter_tree.h:145-161). Row 0 is
    the whole dataset."""
    rows = [(n, 0, 1)]
    while rows[-1][0] > cutoff:
        last = rows[-1][0]
        bucket_size = int((last + split_factor - 1) / split_factor)
        bucket_shift = math.ceil(bucket_size * shift_factor)
        num_buckets = (n - bucket_size + bucket_shift - 1) // bucket_shift + 1
        rows.append((bucket_size, bucket_shift, num_buckets))
    return rows


def super_row_cache_filename(cache_path, bp, label_lo, label_hi, n, split,
                             shift, cutoff, row) -> str:
    """A super row's cache file, the JAX package's name, so that a row cache
    written by either package loads into the other."""
    return os.path.join(
        cache_path,
        f"super_{bp.L}_{bp.R}_{bp.alpha:.6f}_{label_lo:.6f}_{label_hi:.6f}_"
        f"{n}_{split:.3f}_{shift:.3f}_{cutoff}_row{row}.npz",
    )


class SuperOptimizedPostfilterTree:
    """Rows of overlapping buckets over label-sorted points.

    `device` places the store and the rows: None means the card ("cuda"),
    and raises where there is none; device="cpu" runs the plain PyTorch
    path. `device_rows_budget` bounds the bytes of row adjacency kept on the
    device (LRU; a row uploads again when a batch routes to it); None keeps
    every row resident. `require_cache` raises instead of building a row
    that has no cache."""

    def __init__(
        self,
        points: np.ndarray,
        filter_values: np.ndarray,
        cutoff: int = DEFAULT_CUTOFF,
        split_factor: float = float(DEFAULT_SPLIT_FACTOR),
        shift_factor: float = DEFAULT_SHIFT_FACTOR,
        build_params: Optional[BuildParams] = None,
        metric: str = "Euclidian",
        seed: int = 0,
        device_rows_budget: Optional[int] = None,
        require_cache: bool = False,
        device=None,
    ):
        if split_factor <= 1:
            raise ValueError("split_factor must be greater than 1")
        if not (0 < shift_factor < 1):
            raise ValueError("shift_factor must be between 0 and 1")
        self._require_cache = require_cache
        self._bp = build_params or BuildParams()
        points = np.asarray(points)
        pts_sorted, self._labels_sorted, self._decoding = sort_by_labels(
            points, np.asarray(filter_values))
        self._ps = make_pointset(pts_sorted, metric, device=device)
        self._cutoff = int(cutoff)
        self._split = float(split_factor)
        self._shift = float(shift_factor)
        n = self._ps.n
        self._rows = super_row_layout(n, self._cutoff, self._split, self._shift)
        self._fp = cache_fingerprint(self._labels_sorted, pts_sorted)
        self._graphs: List[SlabGraph] = [
            self._load_or_build_row(r, *self._row_slab(n, *row), seed)
            for r, row in enumerate(self._rows)]
        self._res = RowResidency(self._graphs, device_rows_budget, self._ps.device)
        self._inline_attached: set = set()  # rows with inline blocks resident
        self._mesh = None

    @property
    def device(self):
        return self._ps.device

    def shard(self, mesh) -> "SuperOptimizedPostfilterTree":
        """Query-shard over the devices of `mesh` (parallel.sharded.make_mesh),
        the index replicated on each; its first device must hold the index.
        The row residency is pinned, as the tree's shard() pins it."""
        replicate_index(self._ps, self._graphs, mesh)
        self._inline_attached.clear()  # replicate_index dropped the blocks
        self._res.budget = None
        self._res.order = []
        self._mesh = mesh
        return self

    # ------------------------------------------------------------------ build
    @staticmethod
    def _row_slab(n, bsize, bshift, nb):
        """Contiguous slab layout: bucket b spans sorted ids
        [b * shift, b * shift + size). Returns (bucket slab offsets [nb + 1],
        slab -> sorted id map)."""
        if nb == 1:
            return np.array([0, n], dtype=np.int64), np.arange(n, dtype=np.int64)
        starts = np.arange(nb, dtype=np.int64) * bshift
        lens = np.minimum(starts + bsize, n) - starts
        offsets = np.concatenate([[0], np.cumsum(lens)])
        s2g = np.concatenate(
            [start + np.arange(ln, dtype=np.int64) for start, ln in zip(starts, lens)])
        return offsets, s2g

    def _row_cache_file(self, r: int) -> Optional[str]:
        bp = self._bp
        if not bp.cache_path:
            return None
        lo, hi = float(self._labels_sorted[0]), float(self._labels_sorted[-1])
        return super_row_cache_filename(
            bp.cache_path, bp, lo, hi, self._ps.n, self._split, self._shift,
            self._cutoff, r)

    def _load_or_build_row(self, r, slab_offsets, s2g, seed) -> SlabGraph:
        lo, hi = float(self._labels_sorted[0]), float(self._labels_sorted[-1])
        canon = whole_dataset_cache(self._bp.cache_path, self._bp, lo, hi,
                                    self._ps.n) if r == 0 else None
        return load_or_build_row(self._ps, self._bp, s2g, slab_offsets, self._fp,
                                 self._row_cache_file(r), canon, seed=seed + r,
                                 require_cache=self._require_cache)

    # ---------------------------------------------------------------- routing
    def _route(self, lo: int, hi: int) -> Tuple[int, int]:
        """Smallest row/bucket containing [lo, hi) (ref: :202-243): rows
        scanned smallest bucket first; row 0 is the fallback. The parity
        oracle of native.route_super_batch, and its fallback."""
        n = self._ps.n
        for r in range(len(self._rows) - 1, 0, -1):
            bsize, bshift, nb = self._rows[r]
            if bsize < hi - lo:
                continue
            first = min(lo // bshift, nb - 1)
            last = min((hi - 1) // bshift, nb - 1)
            for b in range(first, last + 1):
                b_lo = b * bshift
                b_hi = min(b_lo + bsize, n)
                if lo >= b_lo and hi <= b_hi:
                    return r, b
        return 0, 0

    def _route_batch(self, lo_idx, hi_idx) -> Tuple[np.ndarray, np.ndarray]:
        """(row [Q], bucket [Q]) of every query; empty ranges keep row -1.
        The native router, or the Python one where the library is missing."""
        nq = len(lo_idx)
        rows = np.full(nq, -1, dtype=np.int64)
        buckets = np.zeros(nq, dtype=np.int64)
        act = np.nonzero(hi_idx > lo_idx)[0]
        routed = native.route_super_batch(
            self._rows, self._ps.n, lo_idx[act].astype(np.int64),
            hi_idx[act].astype(np.int64)) if len(act) else None
        if routed is not None:
            rows[act], buckets[act] = routed
        else:
            for qi in act:
                rows[qi], buckets[qi] = self._route(int(lo_idx[qi]), int(hi_idx[qi]))
        return rows, buckets

    # ----------------------------------------------------------------- search
    def batch_search(
        self,
        queries: np.ndarray,
        filters: Sequence[Tuple[float, float]],
        num_queries: int,
        query_params: QueryParams,
        stats=None,  # optional utils.stats.QueryStats
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [nq, k] uint32 original ids, dists [nq, k] f32);
        empty slots are (0, FLT_MAX), the reference's tree padding."""
        qp = query_params
        queries = np.asarray(queries, dtype=np.float32)[:num_queries]
        filters = np.asarray(filters, dtype=np.float64)[:num_queries]
        k = qp.k
        qpad = pad_queries(queries, self._ps.d, self._ps.d_pad)
        q_norms = np.einsum("qd,qd->q", queries, queries).astype(np.float32)
        lo_idx = first_geq(self._labels_sorted, filters[:, 0])
        hi_idx = first_geq(self._labels_sorted, filters[:, 1])
        # routing takes [lo, hi) (exclusive top), but the postfilter's label
        # window is inclusive at the top (ref: postfilter_vamana.h:236-237):
        # a label equal to hi passes the filter without widening the route
        hi_incl = np.searchsorted(self._labels_sorted, filters[:, 1], side="right")
        rows, buckets = self._route_batch(lo_idx, hi_idx)

        # int8 inline blocks for the batch's busiest rows (quantized scores
        # are exact-reranked inside doubling_postfilter); none with a mesh
        urows, ucounts = np.unique(rows[rows >= 0], return_counts=True)
        if len(urows) and self._mesh is None:
            plan_row_inline(self._ps, self._graphs, self._inline_attached,
                            urows, ucounts)

        out_i = np.full((num_queries, k), EMPTY_ID, dtype=np.int64)
        out_d = np.full((num_queries, k), np.inf, dtype=np.float32)
        (q_dev,) = to_device(self._ps.device, qpad)  # one upload; rows index it
        for r in urows:
            sel = np.nonzero(rows == r)[0]
            g = self._res.touch(int(r))
            qi_dev, starts, lo, hi = to_device(
                self._ps.device, sel, g.bucket_slab_offsets[buckets[sel]].astype(np.int32),
                lo_idx[sel], hi_incl[sel])
            out_i[sel], out_d[sel] = doubling_postfilter(
                self._ps, g, q_dev[qi_dev], starts, lo, hi, qp, self._ps.metric,
                stats=stats, stat_ids=sel, mesh=self._mesh)
        return finalize_output(out_d, out_i, self._decoding, q_norms,
                               self._ps.metric, pad_id=0)
