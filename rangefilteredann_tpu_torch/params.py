"""Build / query parameter structs.

A copy of rangefilteredann_tpu/params.py, kept here so that the PyTorch port
never imports the JAX package. Equivalents of the reference's config structs
(ref: ParlayANN/algorithms/utils/types.h:77-140) with the Python-side defaults of
experiments/wrapper.py:334-355 and python_bindings/python_bindings.cpp:88.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BuildParams:
    """Vamana graph build parameters (ref: utils/types.h:77-112).

    Attributes:
      R: max out-degree of the graph.
      L: beam width used for the insertion searches.
      alpha: RobustPrune domination slack (alpha >= 1 keeps more diverse edges).
      cache_path: if non-empty, directory prefix where built graphs are cached
        (ref: src/postfilter_vamana.h:54-79). "" disables caching.
    """

    R: int = 64
    L: int = 500
    alpha: float = 1.175
    cache_path: str = ""

    def __post_init__(self):
        if self.R <= 0 or self.L <= 0:
            raise ValueError(f"BuildParams requires R>0 and L>0, got R={self.R} L={self.L}")
        if self.alpha < 1.0:
            raise ValueError(f"BuildParams alpha must be >= 1.0, got {self.alpha}")


@dataclasses.dataclass(frozen=True)
class QueryParams:
    """Search-time parameters (ref: utils/types.h:115-140).

    Attributes:
      k: number of neighbors to return. k == 0 means "build-mode" search
        (no cut pruning; frontier returned whole).
      beamSize: beam width of the graph search.
      cut: frontier-truncation slack — entries with dist >= cut * d_k are
        dropped (metric spaces only; ref: beamSearch.h:162-167).
      limit: max number of nodes visited per search.
      degree_limit: max neighbors expanded per visited node.
      final_beam_multiply: postfiltering-only — after the doubling loop, one
        final search at beam * this (ref: src/postfilter_vamana.h:173-181).
      postfiltering_max_beam: cap on the doubled beam.
      min_query_to_bucket_ratio: optional "smart combined" fallback threshold —
        if the smallest covering bucket is more than this many times larger
        than the query range, fall back to the tree (fenwick) query
        (ref: src/range_filter_tree.h:460-466).
      verbose: print per-query routing decisions.
    """

    k: int
    beamSize: int
    cut: float = 1.35
    limit: int = 10_000_000
    degree_limit: int = 10_000
    final_beam_multiply: int = 1
    postfiltering_max_beam: int = 10_000
    min_query_to_bucket_ratio: Optional[float] = None
    verbose: bool = False

    def replace(self, **kw) -> "QueryParams":
        return dataclasses.replace(self, **kw)


def build_query_params(
    k,
    beam_size,
    cut=1.35,
    limit=10_000_000,
    degree_limit=10_000,
    final_beam_multiply=1,
    postfiltering_max_beam=10_000,
    min_query_to_bucket_ratio=None,
    verbose=False,
) -> QueryParams:
    """Drop-in equivalent of the reference's wrapper.build_query_params
    (ref: experiments/wrapper.py:334-355)."""
    return QueryParams(
        k=k,
        beamSize=beam_size,
        cut=cut,
        limit=limit,
        degree_limit=degree_limit,
        final_beam_multiply=final_beam_multiply,
        postfiltering_max_beam=postfiltering_max_beam,
        min_query_to_bucket_ratio=min_query_to_bucket_ratio,
        verbose=verbose,
    )


# Binding-layer defaults (ref: python_bindings/python_bindings.cpp:88,123-124,151-153).
DEFAULT_BUILD_PARAMS = BuildParams(R=64, L=500, alpha=1.175, cache_path="index_cache")
DEFAULT_CUTOFF = 1000
DEFAULT_SPLIT_FACTOR = 2
DEFAULT_SHIFT_FACTOR = 0.5
