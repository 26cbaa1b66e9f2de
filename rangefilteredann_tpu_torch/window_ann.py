"""The reference's `window_ann` module names, on the port
(ref: python_bindings/python_bindings.cpp:160-238).

Counterpart of the `window_ann.py` shim at the repository root, which
serves the JAX package: `from rangefilteredann_tpu_torch import window_ann`
exposes the same per-variant class names (e.g.
VamanaRangeFilterTreeIndexFloatMips), the `Vamana*Index` loaders, the
`build_vamana_*_index` builders, `defaults`, QueryParams/BuildParams and the
filter classes, backed by the port. Every constructor takes `device`: None
means the card.
"""

from .filters import FilteredDataset, QueryFilter, csr_filters  # noqa: F401
from .params import BuildParams, QueryParams, build_query_params  # noqa: F401
from . import wrapper as _w

__version__ = "dev"


class _Defaults:
    """The `window_ann.defaults` submodule
    (ref: python_bindings/python_bindings.cpp:169-174)."""

    METRIC = "Euclidian"
    ALPHA = 1.2
    GRAPH_DEGREE = 64
    BEAMWIDTH = 128


defaults = _Defaults()

_VARIANTS = [
    ("Float", "float", "Euclidian", "Euclidian"),
    ("Uint8", "uint8", "Euclidian", "Euclidian"),
    ("Int8", "int8", "Euclidian", "Euclidian"),
    ("Float", "float", "Mips", "mips"),
    ("Uint8", "uint8", "Mips", "mips"),
    ("Int8", "int8", "Mips", "mips"),
]

_FAMILIES = [
    # (reference class prefix, factory)
    ("PrefilterIndex", _w.prefilter_index_constructor),
    ("PostfilterVamanaIndex", _w.postfilter_vamana_constructor),
    ("RangeFilterTreeIndex", _w.range_filter_tree_constructor),
    ("VamanaRangeFilterTreeIndex", _w.vamana_range_filter_tree_constructor),
    ("SuperOptimizedPostfilterTreeIndex", _w.super_optimized_postfilter_tree_constructor),
]

for _dt_name, _dt, _m_name, _metric in _VARIANTS:
    for _prefix, _factory in _FAMILIES:
        globals()[f"{_prefix}{_dt_name}{_m_name}"] = _factory(_metric, _dt)
    globals()[f"Vamana{_dt_name}{_m_name}Index"] = _w.vamana_index_constructor(_metric, _dt)
    globals()[f"build_vamana_{_dt}_{_metric.lower()}_index"] = _w.build_vamana_index_fn(_metric, _dt)

del _dt_name, _dt, _m_name, _metric, _prefix, _factory
