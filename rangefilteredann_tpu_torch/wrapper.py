"""User-facing factory API of the port: the prefilter, postfilter and B-WST
constructors.

Counterpart of rangefilteredann_tpu/wrapper.py (ref: experiments/wrapper.py).
The factory returns a constructor callable with the (metric, dtype) variant
baked in. Metric strings: "Euclidian" (reference spelling) and "mips".
"""

from __future__ import annotations

import numpy as np

from .models.postfilter_vamana import PostfilterVamanaIndex
from .models.prefilter import PrefilterIndex
from .models.range_filter_tree import RangeFilterTreeIndex
from .params import DEFAULT_BUILD_PARAMS, DEFAULT_CUTOFF, DEFAULT_SPLIT_FACTOR

_DTYPES = {"float": np.float32, "uint8": np.uint8, "int8": np.int8}
_METRICS = ("Euclidian", "mips")


def _check(metric: str, dtype: str):
    if metric not in _METRICS:
        raise Exception("Invalid metric " + metric)
    if dtype not in _DTYPES:
        raise Exception("Invalid data type " + dtype)


def _cast(points, dtype):
    return np.asarray(points, dtype=_DTYPES[dtype])


def prefilter_index_constructor(metric: str, dtype: str):
    """(ref: wrapper.py:242-262). The constructor's `device` places the
    store: None means the card."""
    _check(metric, dtype)

    def ctor(points, filter_values, build_params=DEFAULT_BUILD_PARAMS,
             device=None):
        return PrefilterIndex(_cast(points, dtype), filter_values, build_params,
                              metric=metric, device=device)

    return ctor


def postfilter_vamana_constructor(metric: str, dtype: str):
    """(ref: wrapper.py:265-285). The constructor's `device` places the
    store and the graph: None means the card."""
    _check(metric, dtype)

    def ctor(points, filter_values, build_params=DEFAULT_BUILD_PARAMS,
             device=None):
        return PostfilterVamanaIndex(_cast(points, dtype), filter_values,
                                     build_params, metric=metric, device=device)

    return ctor


def vamana_range_filter_tree_constructor(metric: str, dtype: str):
    """Vamana-leaf B-WST (ref: wrapper.py:288-308, binding
    VamanaRangeFilterTreeIndex* at python_bindings.cpp:136-141). The
    constructor's `device` places the store and the rows: None means the
    card."""
    _check(metric, dtype)

    def ctor(points, filter_values, cutoff=DEFAULT_CUTOFF,
             split_factor=DEFAULT_SPLIT_FACTOR, build_params=DEFAULT_BUILD_PARAMS,
             device=None):
        return RangeFilterTreeIndex(
            _cast(points, dtype), filter_values, cutoff, split_factor,
            build_params, metric=metric, leaf="vamana", device=device)

    return ctor


def range_filter_tree_constructor(metric: str, dtype: str):
    """Prefilter-leaf B-WST (binding RangeFilterTreeIndex* at
    python_bindings.cpp:119-124). The constructor's `device` places the
    store: None means the card."""
    _check(metric, dtype)

    def ctor(points, filter_values, cutoff=DEFAULT_CUTOFF,
             split_factor=DEFAULT_SPLIT_FACTOR, build_params=DEFAULT_BUILD_PARAMS,
             device=None):
        return RangeFilterTreeIndex(
            _cast(points, dtype), filter_values, cutoff, split_factor,
            build_params, metric=metric, leaf="prefilter", device=device)

    return ctor


__all__ = [
    "postfilter_vamana_constructor",
    "prefilter_index_constructor",
    "range_filter_tree_constructor",
    "vamana_range_filter_tree_constructor",
]
