"""Carry state built by the JAX package across to the PyTorch port.

Two kinds of state cross, each as numpy arrays, rebuilt bit for bit on the
device the port is asked for. This module imports neither JAX nor the JAX
package.

  * The label-sorted point store, the prefilter's "weights": a JAX-built
    index hands over `np.asarray(idx._ps.data)`, `np.asarray(idx._ps.norms_sq)`,
    the PointSet's n, d, metric and norm_col, `idx._labels_sorted` and
    `idx._decoding` (`pointset_from_arrays`, `PrefilterIndex.from_arrays`).
  * The graph of a flat Vamana index: its adjacency `nbrs` [m, R] int32
    (-1 padded), from `idx._graph.nbrs_host` or from a `vamana_*.npz` graph
    cache the JAX package wrote, whose `fingerprint` the port checks with
    the same digest (`slab_graph_from_nbrs` = `SlabGraph.from_nbrs`,
    `load_graph_cache` = `SlabGraph.from_cache`,
    `PostfilterVamanaIndex.from_arrays`; an index given the JAX package's
    `cache_path` loads the same file under the same name).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.vamana import SlabGraph
from .utils.data import PointSet, canonical_metric, resolve_device


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX buffer
        a = a.copy()
    return torch.from_numpy(a)


def pointset_from_arrays(data, norms_sq, n: int, d: int, metric: str,
                         norm_col: int, device=None) -> PointSet:
    """The port's PointSet holding `data` [n_rows, d_pad] and `norms_sq`
    [n_rows] as given, on `device` (None = the card)."""
    device = resolve_device(device)
    data = np.asarray(data)
    norms_sq = np.asarray(norms_sq, dtype=np.float32)
    if data.ndim != 2 or norms_sq.shape != (data.shape[0],):
        raise ValueError(f"data {data.shape} and norms_sq {norms_sq.shape} "
                         "do not form a store")
    if not 0 <= n <= data.shape[0] or d > data.shape[1]:
        raise ValueError(f"n={n}, d={d} do not fit a store of {data.shape}")
    return PointSet(data=_to_tensor(data).to(device),
                    norms_sq=_to_tensor(norms_sq).to(device), n=int(n),
                    d=int(d), metric=canonical_metric(metric),
                    norm_col=int(norm_col))


# The graph's loaders live beside SlabGraph; named here as the state this
# module carries across.
slab_graph_from_nbrs = SlabGraph.from_nbrs
load_graph_cache = SlabGraph.from_cache
