"""Per-query search statistics and graph statistics.

A copy of rangefilteredann_tpu/utils/stats.py (pure numpy), kept here so
that the port never imports the JAX package (ref:
ParlayANN/algorithms/utils/stats.h:43-88, graph_stats_ :90+). The searches
return their counters (BeamResult.num_visited / .dist_cmps); this module
accumulates them per query on the host and reports the average and 99th
percentile.
"""

from __future__ import annotations

import numpy as np


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



def graph_stats(nbrs_host: np.ndarray):
    """(avg_degree, max_degree) of a padded [m, R] adjacency
    (ref: stats.h graph_stats_)."""
    degs = (np.asarray(nbrs_host) >= 0).sum(axis=1)
    return float(degs.mean()), int(degs.max(initial=0))
