"""Carry a store built by the JAX package across to the PyTorch port.

The prefilter's "weights" are its label-sorted point store. A JAX-built
index hands over its arrays as numpy (`np.asarray(idx._ps.data)`,
`np.asarray(idx._ps.norms_sq)`, the PointSet's n, d, metric and norm_col,
`idx._labels_sorted`, `idx._decoding`), and the port rebuilds the same store
from them, bit for bit, on the device it is asked for. This module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

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
