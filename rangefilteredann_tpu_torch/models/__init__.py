from .prefilter import PrefilterIndex  # noqa: F401
from .postfilter_vamana import PostfilterVamanaIndex  # noqa: F401
from .range_filter_tree import RangeFilterTreeIndex, build_offset_rows  # noqa: F401
from .super_postfilter_tree import (  # noqa: F401
    SuperOptimizedPostfilterTree,
    super_row_layout,
)
from .vamana_index import VamanaIndex, build_vamana_index  # noqa: F401
