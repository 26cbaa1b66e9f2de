"""Point storage for the PyTorch port of window search.

Counterpart of rangefilteredann_tpu/utils/data.py, with the same layout bit
for bit: points live label-sorted in one padded `[n_rows, d_pad]` tensor,
rows padded to a SCAN_ROW_PAD multiple (all-zero, norm 0), columns padded to
a LANE multiple. Float stores carry ||x||^2 in column `d` (`norm_col`); int8
and uint8 stores stay in their own dtype with `norm_col = -1` and exact
integer square sums in `norms_sq`. Host planning (labels, windows) stays
numpy, as in the JAX package, except the prefilter's window bounds, which
first_geq searches on the store's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

LANE = 128  # last dim padded to a multiple of this (the reference layout)

METRIC_L2 = "l2"
METRIC_MIPS = "mips"

# Stores are row-padded to this multiple, as in the JAX package, so a store
# built here and one built there have identical shapes.
SCAN_ROW_PAD = 4096
_METRIC_ALIASES = {
    "euclidian": METRIC_L2,
    "euclidean": METRIC_L2,
    "l2": METRIC_L2,
    "mips": METRIC_MIPS,
    "ip": METRIC_MIPS,
    "angular": METRIC_MIPS,  # angular data is pre-normalized and searched with MIPS
}

# Float stores above this many bytes are copied to the device in chunks, each
# padded and norm-columned on the host exactly as the single copy would be.
_STREAM_INGEST_BYTES = int(1.5e9)
# Rows per chunk of the int8/uint8 ingest (square sums run on the device).
_INT_INGEST_ROWS = 1 << 19


def canonical_metric(metric: str) -> str:
    m = _METRIC_ALIASES.get(metric.lower())
    if m is None:
        raise ValueError(f"Unknown metric {metric!r}; expected one of {sorted(_METRIC_ALIASES)}")
    return m


def pad_dim(d: int, lane: int = LANE) -> int:
    return ((d + lane - 1) // lane) * lane


def resolve_device(device=None) -> torch.device:
    """The device a store lives on: the card unless the caller names another.

    None means "cuda". Asking for CUDA where there is none raises: the port
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        # The reference pins fp32 distance matmuls to full precision
        # (Precision.HIGHEST in ops/distances.py). TF32 keeps ~10 mantissa
        # bits, enough to reorder true neighbours, so both switches stay off.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclasses.dataclass
class PointSet:
    """A padded point store on one device.

    Attributes:
      data: [n_rows, d_pad] float32, int8 or uint8 tensor.
      norms_sq: [n_rows] float32 squared L2 norms.
      n: number of real points (rows past n are zero padding).
      d: true dimensionality.
      metric: "l2" or "mips".
      norm_col: column of `data` holding ||x||^2 (float stores), else -1.
      replicas: (data, norms_sq) as {device: tensor} over a mesh's devices,
        set by parallel.sharded.replicate_index; None unreplicated.
    """

    data: torch.Tensor
    norms_sq: torch.Tensor
    n: int
    d: int
    metric: str
    norm_col: int = -1
    replicas: Optional[tuple] = None

    @property
    def d_pad(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device


def make_pointset(points: np.ndarray, metric: str, device=None) -> PointSet:
    """Pad a host point matrix and copy it to `device` (None = the card).

    int8/uint8 points keep their dtype (1 byte per dim); their distances stay
    exact because byte values are exact in bfloat16 (ops/distances)."""
    metric = canonical_metric(metric)
    device = resolve_device(device)
    if points.ndim != 2:
        raise ValueError("points array must be 2-dimensional")
    n, d = points.shape
    n_rows = -(-n // SCAN_ROW_PAD) * SCAN_ROW_PAD
    if points.dtype in (np.int8, np.uint8):
        return _make_int_pointset(points, metric, n, d, n_rows, device)
    dp = pad_dim(d + 1)  # + 1 slot for the fused ||x||^2 column
    norm_col = d
    if n_rows * dp * 4 > _STREAM_INGEST_BYTES:
        return _make_float_pointset_streaming(
            points, metric, n, d, n_rows, dp, norm_col, device)
    host = np.zeros((n_rows, dp), dtype=np.float32)
    host[:n, :d] = points.astype(np.float32)
    norms = np.einsum("nd,nd->n", host, host).astype(np.float32)
    host[:, norm_col] = norms
    data = torch.from_numpy(host).to(device)
    return PointSet(data=data, norms_sq=torch.from_numpy(norms).to(device),
                    n=n, d=d, metric=metric, norm_col=norm_col)


def _make_float_pointset_streaming(points, metric, n, d, n_rows, dp,
                                   norm_col, device) -> PointSet:
    """Chunked float ingest, bit-identical to the single-copy path: each
    chunk is padded and norm-columned on the host with the same np.einsum,
    so only the transfer schedule differs."""
    data = torch.zeros((n_rows, dp), dtype=torch.float32, device=device)
    norms = np.zeros(n_rows, dtype=np.float32)
    step = max(1, _STREAM_INGEST_BYTES // 8 // (dp * 4))
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        chunk = np.zeros((hi - lo, dp), dtype=np.float32)
        chunk[:, :d] = points[lo:hi].astype(np.float32)
        nrm = np.einsum("nd,nd->n", chunk, chunk).astype(np.float32)
        chunk[:, norm_col] = nrm
        norms[lo:hi] = nrm
        data[lo:hi] = torch.from_numpy(chunk).to(device)
    return PointSet(data=data, norms_sq=torch.from_numpy(norms).to(device),
                    n=n, d=d, metric=metric, norm_col=norm_col)


def _make_int_pointset(points, metric, n: int, d: int, n_rows: int,
                       device) -> PointSet:
    """Chunked ingest for native int8/uint8 stores: each chunk is copied
    into place on the device and its square sums taken there in int32, which
    is exact (255^2 * 512 < 2^31); the cast to float32 rounds as the JAX
    package's does."""
    dp = pad_dim(max(d, 1))
    dtype = torch.int8 if points.dtype == np.int8 else torch.uint8
    data = torch.zeros((n_rows, dp), dtype=dtype, device=device)
    norms = torch.zeros(n_rows, dtype=torch.float32, device=device)
    for lo in range(0, n, _INT_INGEST_ROWS):
        chunk = torch.from_numpy(
            np.ascontiguousarray(points[lo : lo + _INT_INGEST_ROWS])).to(device)
        hi = lo + chunk.shape[0]
        data[lo:hi, :d] = chunk
        c32 = chunk.to(torch.int32)
        norms[lo:hi] = (c32 * c32).sum(dim=1, dtype=torch.int32).to(torch.float32)
    return PointSet(data=data, norms_sq=norms, n=n, d=d, metric=metric,
                    norm_col=-1)


def pad_queries(queries: np.ndarray, d: int, d_padded: int) -> np.ndarray:
    if queries.ndim != 2 or queries.shape[1] != d:
        raise ValueError(f"queries must be [nq, {d}], got {queries.shape}")
    nq = queries.shape[0]
    out = np.zeros((nq, d_padded), dtype=np.float32)
    out[:, :d] = queries.astype(np.float32)
    return out


def sort_by_labels(
    points: np.ndarray, labels: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Label-argsort ingest (ref: src/tree_utils.h:40-98).

    Returns (points_sorted, labels_sorted, decoding) where
    decoding[sorted_id] = original point id. Labels stay float64 on the host.
    """
    labels = np.asarray(labels)
    if labels.ndim != 1:
        raise ValueError("filter (label) array must be 1-dimensional")
    if labels.shape[0] != points.shape[0]:
        raise ValueError(
            "filter (label) array must have the same number of elements as the points array"
        )
    # fast path: already label-sorted input. A stable argsort of a sorted
    # array is the identity even with ties, so skip the permutation copy.
    if len(labels) and bool((labels[:-1] <= labels[1:]).all()):
        order = np.arange(len(labels), dtype=np.int64)
        return points, labels.astype(np.float64), order
    order = np.argsort(labels, kind="stable")
    return points[order], labels[order].astype(np.float64), order.astype(np.int64)


def first_geq(labels_sorted, values):
    """Index of the first label >= value (ref: src/tree_utils.h:20-37).

    Vectorized over `values`. Equals len(labels_sorted) when value exceeds all.
    Given tensors (labels from device_labels, values of the same dtype), the
    search runs on their device and returns int64 tensors; given arrays, it
    runs in numpy. Both give the same integers: a NaN value gets the number
    of non-NaN labels from either (numpy sorts NaN after every number, and
    torch's binary search never stops before a NaN value), which is why
    device_labels leaves out the NaN labels that a label sort puts last.
    """
    if isinstance(labels_sorted, torch.Tensor):
        return torch.searchsorted(labels_sorted, values, side="left")
    return np.searchsorted(labels_sorted, values, side="left")


def device_labels(labels_sorted: np.ndarray, device) -> torch.Tensor:
    """The float64 labels that first_geq searches on `device`: those before
    the first NaN (a label sort puts NaN labels last), for which torch's
    search gives numpy's answer over all of them."""
    n = len(labels_sorted) - int(np.isnan(labels_sorted).sum())
    return torch.from_numpy(np.ascontiguousarray(
        labels_sorted[:n], dtype=np.float64)).to(device)


def label_range_to_window(
    labels_sorted: np.ndarray, lo, hi
) -> Tuple[np.ndarray, np.ndarray]:
    """Map label ranges [lo, hi] to sorted-index windows [start, end).

    The reference's arithmetic: start = first index with label >= lo, end =
    first index with label >= hi, so a point whose label == hi is excluded
    (ref: src/range_filter_tree.h:306-309). Kept for parity.
    """
    return first_geq(labels_sorted, lo), first_geq(labels_sorted, hi)
