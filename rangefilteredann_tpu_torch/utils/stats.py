"""Per-query search statistics and graph statistics.

A copy of rangefilteredann_tpu/utils/stats.py (numpy, and torch to fetch a
BeamResult's counters), kept here so that the port never imports the JAX
package (ref: ParlayANN/algorithms/utils/stats.h:43-88, graph_stats_ :90+).
The searches return their counters (BeamResult.num_visited / .dist_cmps);
this module accumulates them per query on the host and reports the average
and 99th percentile.
"""

from __future__ import annotations

import numpy as np
import torch


class QueryStats:
    """Visited-node and distance-comparison counts per query. A query may
    contribute from several searches (the doubling loop); counts accumulate
    by query id."""

    def __init__(self, n: int):
        self.visited = np.zeros(n, dtype=np.int64)
        self.distances = np.zeros(n, dtype=np.int64)

    def increment_visited(self, i, cnt) -> None:
        np.add.at(self.visited, i, cnt)

    def increment_dist(self, i, cnt) -> None:
        np.add.at(self.distances, i, cnt)

    def add_beam_result(self, query_ids, result) -> None:
        """Fold a BeamResult's counters (tensors on any device) into the
        per-query totals."""
        nq = len(query_ids)
        self.increment_visited(query_ids, _host(result.num_visited)[:nq])
        self.increment_dist(query_ids, _host(result.dist_cmps)[:nq])

    @staticmethod
    def _two_stats(arr: np.ndarray):
        if len(arr) == 0:
            return 0.0, 0.0
        s = np.sort(arr)
        tail = s[int(len(s) * 0.99):]
        return float(s.mean()), float(tail.mean()) if len(tail) else 0.0

    def visited_stats(self):
        return self._two_stats(self.visited)

    def dist_stats(self):
        return self._two_stats(self.distances)

    def print(self) -> None:
        va, v99 = self.visited_stats()
        da, d99 = self.dist_stats()
        print(f"Visited: average {va}, 99th percentile {v99}")
        print(f"Distance comparisons: average {da}, 99th percentile {d99}")

    def clear(self) -> None:
        self.visited[:] = 0
        self.distances[:] = 0


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def graph_stats(nbrs_host: np.ndarray):
    """(avg_degree, max_degree) of a padded [m, R] adjacency
    (ref: stats.h graph_stats_)."""
    degs = (np.asarray(nbrs_host) >= 0).sum(axis=1)
    return float(degs.mean()), int(degs.max(initial=0))
