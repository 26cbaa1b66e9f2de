from .prefilter import PrefilterIndex  # noqa: F401
from .postfilter_vamana import PostfilterVamanaIndex  # noqa: F401
from .range_filter_tree import RangeFilterTreeIndex, build_offset_rows  # noqa: F401
