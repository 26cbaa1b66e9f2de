"""Binary file I/O in the reference's on-disk formats.

A copy of rangefilteredann_tpu/utils/io.py (numpy, and the native library
for graphs), kept here so that the port never imports the JAX package; the
files either package writes are byte for byte the same.

  * Vector ".bin" files (DiskANN style; ref: point_range.h:57-93):
      uint32 num_points, uint32 dims, then num_points*dims values row-major.
  * Graph files (ref: graph.h:126-196):
      uint32 n, uint32 max_degree, uint32 degrees[n], then the packed
      (variable-length) edge lists as uint32.
  * Ground-truth files (ref: utils/types.h:33-74):
      uint32 n, uint32 k, then n*k uint32 ids, then n*k float32 dists.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import native

_DTYPES = {"float": np.float32, "uint8": np.uint8, "int8": np.int8}


def write_vector_file(path: str, data: np.ndarray) -> None:
    n, d = data.shape
    with open(path, "wb") as f:
        np.array([n, d], dtype=np.uint32).tofile(f)
        data.tofile(f)


def read_vector_file(path: str, dtype="float") -> np.ndarray:
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    with open(path, "rb") as f:
        n, d = np.fromfile(f, dtype=np.uint32, count=2)
        data = np.fromfile(f, dtype=dt, count=int(n) * int(d))
    return data.reshape(int(n), int(d))


def write_graph_file(path: str, nbrs: np.ndarray) -> None:
    """nbrs: [n, R] int32, -1 padded with valid edges packed first. The
    native writer, or the same bytes from numpy without the library."""
    if native.write_graph_padded(path, nbrs):
        return
    n, max_deg = nbrs.shape
    degrees = (nbrs >= 0).sum(axis=1).astype(np.uint32)
    with open(path, "wb") as f:
        np.array([n, max_deg], dtype=np.uint32).tofile(f)
        degrees.tofile(f)
        nbrs[nbrs >= 0].astype(np.uint32).tofile(f)


def read_graph_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (nbrs [n, max_deg] int32 -1-padded, degrees [n] int32)."""
    nbrs = native.read_graph_padded(path)
    if nbrs is not None:
        return nbrs, (nbrs >= 0).sum(axis=1).astype(np.int32)
    with open(path, "rb") as f:
        n, max_deg = np.fromfile(f, dtype=np.uint32, count=2)
        n, max_deg = int(n), int(max_deg)
        degrees = np.fromfile(f, dtype=np.uint32, count=n).astype(np.int64)
        edges = np.fromfile(f, dtype=np.uint32, count=int(degrees.sum()))
    nbrs = np.full((n, max_deg), -1, dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(degrees)])
    cols = np.arange(len(edges)) - np.repeat(offsets[:-1], degrees)
    rows = np.repeat(np.arange(n), degrees)
    nbrs[rows, cols] = edges.astype(np.int32)
    return nbrs, degrees.astype(np.int32)


def write_groundtruth_file(path: str, ids: np.ndarray, dists: np.ndarray) -> None:
    """uint32 n, uint32 k, then n*k uint32 ids, then n*k float32 dists."""
    n, k = ids.shape
    with open(path, "wb") as f:
        np.array([n, k], dtype=np.uint32).tofile(f)
        ids.astype(np.uint32).tofile(f)
        dists.astype(np.float32).tofile(f)


def read_groundtruth_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        n, k = np.fromfile(f, dtype=np.uint32, count=2)
        n, k = int(n), int(k)
        ids = np.fromfile(f, dtype=np.uint32, count=n * k).reshape(n, k)
        dists = np.fromfile(f, dtype=np.float32, count=n * k).reshape(n, k)
    return ids, dists
