from .prefilter import PrefilterIndex  # noqa: F401
from .postfilter_vamana import PostfilterVamanaIndex  # noqa: F401
