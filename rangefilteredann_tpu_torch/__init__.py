"""rangefilteredann_tpu_torch — the PyTorch / CUDA port of window search.

A second package beside the JAX reference `rangefilteredann_tpu`, for an
NVIDIA H100. It imports torch and numpy only, never JAX or the JAX package.
Indices place their store on the card unless the caller passes
`device="cpu"`. Ported so far: the exact prefilter (`PrefilterIndex`), whose
range-masked scan runs as a hand-written CUDA kernel (csrc/scan_topk.cu),
the graph postfilter (`PostfilterVamanaIndex`: Vamana build and doubling beam
search), whose query-mode beam searches run as a hand-written CUDA kernel
(csrc/beam_search.cu), and the B-Window-Search-Tree (`RangeFilterTreeIndex`,
Vamana or prefilter leaves, with the native host planners of native.py),
which runs on those two kernels.
"""

from .params import (  # noqa: F401
    DEFAULT_BUILD_PARAMS,
    DEFAULT_CUTOFF,
    DEFAULT_SHIFT_FACTOR,
    DEFAULT_SPLIT_FACTOR,
    BuildParams,
    QueryParams,
    build_query_params,
)
from .models import (  # noqa: F401
    PostfilterVamanaIndex,
    PrefilterIndex,
    RangeFilterTreeIndex,
)
from .wrapper import (  # noqa: F401
    postfilter_vamana_constructor,
    prefilter_index_constructor,
    range_filter_tree_constructor,
    vamana_range_filter_tree_constructor,
)

__version__ = "0.1.0"
