"""PrefilterIndex — exact brute-force window search.

Counterpart of rangefilteredann_tpu/models/prefilter.py (ref:
src/prefiltering.h:29-205): argsort points by label, binary-search the query
range endpoints, compute exact distances to every in-range point on the
device, keep the k nearest. The launch plan is built on the store's device:
the queries go up as the caller gives them, the endpoints are searched in a
device copy of the sorted labels, and the host reads back only the window
widths that route each query (one fetch a batch_search_many call).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import pointset_from_arrays
from ..params import BuildParams, QueryParams
# wsbench's traced runs wrap first_geq, pad_queries (not called here),
# launch_range_bruteforce, finish_many_range_bruteforce and finalize_output
# by their names in this module, so each stays importable from it.
from ..utils.data import (  # noqa: F401
    device_labels,
    first_geq,
    make_pointset,
    pad_queries,
    sort_by_labels,
)
from ..utils.trace import span
from .base import (
    finalize_output,
    finish_many_range_bruteforce,
    launch_range_bruteforce,
    to_device,
    to_host,
)

# Batches whose window bounds were searched on the store's device.
DEVICE_PLANS = 0


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
        self._labels_dev = device_labels(self._labels_sorted, self._ps.device)

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
        self._labels_dev = device_labels(self._labels_sorted, self._ps.device)
        return self

    @property
    def metric(self) -> str:
        return self._ps.metric

    @property
    def device(self):
        return self._ps.device

    def _plan(self, queries, filters):
        """Upload one batch as it is given and search its window bounds on
        the store's device. Returns (queries [nq, d] f32 on the host, the
        same on the device, bounds [2, nq] int32: starts, then ends)."""
        global DEVICE_PLANS
        with span("prefilter.pad"):
            queries = np.ascontiguousarray(queries, dtype=np.float32)
            filters = np.ascontiguousarray(filters, dtype=np.float64)
            if queries.ndim != 2 or queries.shape[1] != self._ps.d:
                raise ValueError(
                    f"queries must be [nq, {self._ps.d}], got {queries.shape}")
        q_dev, f_dev = to_device(self.device, queries, filters)
        with span("prefilter.window_bounds"):
            bounds = first_geq(self._labels_dev, f_dev).to(torch.int32)
        DEVICE_PLANS += 1
        return queries, q_dev, bounds.t().contiguous()

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
            plans = [self._plan(q, f) for q, f in batches]
            if not plans:
                return []
            with span("prefilter.window_bounds"):  # every batch's, one fetch
                (bounds,) = to_host(torch.cat([b for _, _, b in plans], dim=1))
            widths = (bounds[1] - bounds[0]).astype(np.int64)
            launches, lo = [], 0
            for _, q_dev, b in plans:
                hi = lo + b.shape[1]
                launches.append(launch_range_bruteforce(
                    self._ps.data, self._ps.norms_sq, q_dev, b[0], b[1], k,
                    self._ps.metric, norm_col=self._ps.norm_col, widths=widths[lo:hi]))
                lo = hi
            return [self._finalize(q, d, i) for (q, _, _), (d, i) in
                    zip(plans, finish_many_range_bruteforce(launches))]
