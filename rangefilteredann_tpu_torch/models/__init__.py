from .prefilter import PrefilterIndex  # noqa: F401
