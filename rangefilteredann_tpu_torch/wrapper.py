"""User-facing factory API of the port.

Counterpart of rangefilteredann_tpu/wrapper.py (ref: experiments/wrapper.py
and the `window_ann` module of python_bindings/python_bindings.cpp:91-237).
The reference registers one class per (dtype x metric) variant; here a
factory returns a constructor callable with the variant baked in (integer
inputs widen to float32, which keeps their distances exact). Every
constructor takes `device`: None means the card. Metric strings:
"Euclidian" (reference spelling) and "mips".
"""

from __future__ import annotations

import functools

import numpy as np

from .models.postfilter_vamana import PostfilterVamanaIndex
from .models.prefilter import PrefilterIndex
from .models.range_filter_tree import RangeFilterTreeIndex
from .models.super_postfilter_tree import SuperOptimizedPostfilterTree
from .models.vamana_index import VamanaIndex, build_vamana_index
from .params import (
    DEFAULT_BUILD_PARAMS,
    DEFAULT_CUTOFF,
    DEFAULT_SHIFT_FACTOR,
    DEFAULT_SPLIT_FACTOR,
)

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


def super_optimized_postfilter_tree_constructor(metric: str, dtype: str):
    """(ref: wrapper.py:311-331, binding SuperOptimizedPostfilterTreeIndex*
    at python_bindings.cpp:143-158; defaults cutoff=1000, split=2,
    shift=0.5). The constructor's `device` places the store and the rows:
    None means the card."""
    _check(metric, dtype)

    def ctor(points, filter_values, cutoff=DEFAULT_CUTOFF,
             split_factor=float(DEFAULT_SPLIT_FACTOR),
             shift_factor=DEFAULT_SHIFT_FACTOR,
             build_params=DEFAULT_BUILD_PARAMS, device=None):
        return SuperOptimizedPostfilterTree(
            _cast(points, dtype), filter_values, cutoff, split_factor,
            shift_factor, build_params, metric=metric, device=device)

    return ctor


def vamana_index_constructor(metric: str, dtype: str):
    """The unfiltered VamanaIndex loader (ref: wrapper.py:28-49); it takes
    `device` as VamanaIndex does."""
    _check(metric, dtype)
    return functools.partial(VamanaIndex, metric=metric, dtype=dtype)


def build_vamana_index_fn(metric: str, dtype: str):
    """The unfiltered file-based builder (ref: wrapper.py:4-25); it takes
    `device` as build_vamana_index does."""
    _check(metric, dtype)
    return functools.partial(build_vamana_index, dtype=dtype)


__all__ = [
    "build_vamana_index_fn",
    "postfilter_vamana_constructor",
    "prefilter_index_constructor",
    "range_filter_tree_constructor",
    "super_optimized_postfilter_tree_constructor",
    "vamana_index_constructor",
    "vamana_range_filter_tree_constructor",
]
