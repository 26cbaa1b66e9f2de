"""PrefilterIndex — exact brute-force window search.

Counterpart of rangefilteredann_tpu/models/prefilter.py (ref:
src/prefiltering.h:29-205): argsort points by label, binary-search the query
range endpoints on the host, compute exact distances to every in-range point
on the device, keep the k nearest.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..convert import pointset_from_arrays
from ..params import BuildParams, QueryParams
from ..utils.data import first_geq, make_pointset, pad_queries, sort_by_labels
from ..utils.trace import span
from .base import (
    finalize_output,
    finish_many_range_bruteforce,
    launch_range_bruteforce,
)


class PrefilterIndex:
    """Exact range-filtered k-NN by brute force over the label window.

    `device` places the store: None means the card ("cuda"), and raises
    where there is none; pass device="cpu" to run the plain PyTorch path."""

    def __init__(
        self,
        points: np.ndarray,
        filter_values: np.ndarray,
        build_params: Optional[BuildParams] = None,  # unused; kept for API parity
        metric: str = "Euclidian",
        device=None,
    ):
        del build_params  # unused, like the reference (prefiltering.h:46-47)
        points = np.asarray(points)
        pts_sorted, self._labels_sorted, self._decoding = sort_by_labels(
            points, np.asarray(filter_values)
        )
        self._ps = make_pointset(pts_sorted, metric, device=device)

    @classmethod
    def from_arrays(cls, data, norms_sq, n, d, metric, norm_col,
                    labels_sorted, decoding, device=None) -> "PrefilterIndex":
        """An index over an existing label-sorted store, without re-sorting:
        the arrays of a JAX-built PrefilterIndex (`_ps.data`, `_ps.norms_sq`,
        its fields, `_labels_sorted`, `_decoding`) given as numpy."""
        self = cls.__new__(cls)
        self._ps = pointset_from_arrays(data, norms_sq, n, d, metric, norm_col,
                                        device)
        self._labels_sorted = np.asarray(labels_sorted, dtype=np.float64)
        self._decoding = np.asarray(decoding, dtype=np.int64)
        return self

    @property
    def metric(self) -> str:
        return self._ps.metric

    @property
    def device(self):
        return self._ps.device

    def _launch(self, queries, filters, k):
        with span("prefilter.pad"):
            qp = pad_queries(queries, self._ps.d, self._ps.d_pad)
        with span("prefilter.window_bounds"):
            starts = first_geq(self._labels_sorted, filters[:, 0])
            ends = first_geq(self._labels_sorted, filters[:, 1])
        return launch_range_bruteforce(
            self._ps.data, self._ps.norms_sq, qp, starts, ends, k,
            self._ps.metric, norm_col=self._ps.norm_col)

    def _finalize(self, queries, dists, ids):
        with span("base.finalize"):
            q_norms = np.einsum("qd,qd->q", queries, queries)
            return finalize_output(dists, ids, self._decoding, q_norms,
                                   self._ps.metric, pad_id=-1)

    def batch_search(
        self,
        queries: np.ndarray,
        filters: Sequence[Tuple[float, float]],
        num_queries: int,
        query_params: QueryParams,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [nq, k] uint32 original ids, dists [nq, k] f32).

        Filter bounds follow the reference's arithmetic: points with
        label in [first >= lo, first >= hi) are candidates
        (ref: prefiltering.h:157-184).
        """
        return self.batch_search_many(
            [(np.asarray(queries)[:num_queries],
              np.asarray(filters)[:num_queries])], query_params)[0]

    def batch_search_many(
        self,
        batches: Sequence[Tuple[np.ndarray, Sequence[Tuple[float, float]]]],
        query_params: QueryParams,
    ) -> "list[Tuple[np.ndarray, np.ndarray]]":
        """Search a stream of (queries, filters) batches: every batch's
        kernels are enqueued before any result is fetched. Returns
        [(ids, dists)] in batch order, each as batch_search returns it."""
        k = query_params.k
        with span("prefilter.batch"):
            kept, launches = [], []
            for queries, filters in batches:
                queries = np.asarray(queries, dtype=np.float32)
                kept.append(queries)
                launches.append(self._launch(
                    queries, np.asarray(filters, dtype=np.float64), k))
            return [self._finalize(q, d, i) for q, (d, i) in
                    zip(kept, finish_many_range_bruteforce(launches))]
