"""rangefilteredann_tpu_torch — the PyTorch / CUDA port of window search.

A second package beside the JAX reference `rangefilteredann_tpu`, for an
NVIDIA H100. It imports torch and numpy only, never JAX or the JAX package.
Indices place their store on the card unless the caller passes
`device="cpu"`. Ported so far: the exact prefilter (`PrefilterIndex`), whose
range-masked scan runs as a hand-written CUDA kernel (csrc/scan_topk.cu),
the graph postfilter (`PostfilterVamanaIndex`: Vamana build and doubling beam
search), whose query-mode beam searches run as a hand-written CUDA kernel
(csrc/beam_search.cu), the B-Window-Search-Tree (`RangeFilterTreeIndex`,
Vamana or prefilter leaves, with the native host planners of native.py) and
the super tree (`SuperOptimizedPostfilterTree`, overlapping buckets, native
routing), which run on those two kernels, and the API surface: the
file-based `VamanaIndex` and `build_vamana_index`, `utils/io.py` (the
reference's vector, graph and ground-truth files), `filters.py`, the
factories of `wrapper.py`, the `window_ann` class names
(`rangefilteredann_tpu_torch.window_ann`) and the command line
(`python -m rangefilteredann_tpu_torch.cli`), and the experiment layer
(`rangefilteredann_tpu_torch.experiments`: protocol datasets, the benchmark
driver, the studies and the baseline runners), and the scale-out
(`rangefilteredann_tpu_torch.parallel`: a mesh of devices driven by one
process, the indices' `shard` methods, the index-sharded scan and
bucket-sharded tree rows).
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
    SuperOptimizedPostfilterTree,
    VamanaIndex,
    build_vamana_index,
)
from .filters import FilteredDataset, QueryFilter, csr_filters  # noqa: F401
from .utils.stats import QueryStats, graph_stats  # noqa: F401
from .utils.trace import SPANS, set_tracing  # noqa: F401
from .wrapper import (  # noqa: F401
    build_vamana_index_fn,
    postfilter_vamana_constructor,
    prefilter_index_constructor,
    range_filter_tree_constructor,
    super_optimized_postfilter_tree_constructor,
    vamana_index_constructor,
    vamana_range_filter_tree_constructor,
)

__version__ = "0.1.0"
