"""The harness's spans, counters and timers around the program's layers.

In a traced run the harness replaces a function that a module of the program
looks up by name with a wrapper from this file: a span (a record_function
range the profiler records) or a timer (the host clock, ended by a
synchronise). The program itself is not changed and not told. A metric's
reader declares what it reads:

  SPANS    [(span name, module, attribute)]
  COUNTERS [(counter name, module, attribute)]  a module's integer counter
  TIMERS   [(timer name, module, attribute)]

BREAKDOWN_SPANS are the spans the trace's breakdown names besides those:
one for each step of a batch's host path.
"""

from __future__ import annotations

import functools
import importlib
import time

import torch
from torch.profiler import record_function

PKG = "rangefilteredann_tpu_torch"
BATCH = "wsbench.batch"  # one timed batch_search call

BREAKDOWN_SPANS = [
    ("utils.data.first_geq", f"{PKG}.models.prefilter", "first_geq"),
    ("utils.data.first_geq", f"{PKG}.models.postfilter_vamana", "first_geq"),
    ("utils.data.pad_queries", f"{PKG}.models.prefilter", "pad_queries"),
    ("utils.data.pad_queries", f"{PKG}.models.postfilter_vamana", "pad_queries"),
    ("models.base.launch_range_bruteforce", f"{PKG}.models.prefilter",
     "launch_range_bruteforce"),
    ("models.base.finish_many_range_bruteforce", f"{PKG}.models.prefilter",
     "finish_many_range_bruteforce"),
    ("models.base.finalize_output", f"{PKG}.models.prefilter", "finalize_output"),
    ("models.base.finalize_output", f"{PKG}.models.postfilter_vamana", "finalize_output"),
    ("ops.scan.scan_topk", f"{PKG}.models.base", "scan_topk"),
    ("ops.bruteforce.windowed_bruteforce", f"{PKG}.models.base", "windowed_bruteforce"),
    ("models.postfilter_vamana.doubling_postfilter", f"{PKG}.models.postfilter_vamana",
     "doubling_postfilter"),
    ("models.postfilter_vamana.run_beam_batch", f"{PKG}.models.postfilter_vamana",
     "run_beam_batch"),
    ("ops.beam.start_distances", f"{PKG}.models.postfilter_vamana", "start_distances"),
    ("ops.beam.beam_search_inline", f"{PKG}.models.postfilter_vamana", "beam_search_inline"),
    ("ops.beam_search.batched_beam_search", f"{PKG}.models.postfilter_vamana",
     "batched_beam_search"),
    ("ops.beam_search.window_filter_topk", f"{PKG}.models.postfilter_vamana",
     "window_filter_topk"),
    ("ops.beam_search.exact_rerank", f"{PKG}.models.postfilter_vamana", "exact_rerank"),
    ("models.base.batched_range_bruteforce", f"{PKG}.models.postfilter_vamana",
     "batched_range_bruteforce"),
]


def _span(name, fn):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return wrapper


def _timer(name, fn, timers):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        timers.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    return wrapper


class Instruments:
    """Wrappers installed for one traced run, and what they recorded."""

    def __init__(self, readers):
        self.spans, self.counters, self.timers_wanted = [], [], []
        for spec in list(BREAKDOWN_SPANS) + [s for r in readers for s in getattr(r, "SPANS", ())]:
            if tuple(spec) not in self.spans:
                self.spans.append(tuple(spec))
        for r in readers:
            self.counters += [c for c in getattr(r, "COUNTERS", ()) if c not in self.counters]
            self.timers_wanted += [t for t in getattr(r, "TIMERS", ())
                                   if t not in self.timers_wanted]
        self.timers: dict = {}
        self._saved = []

    @property
    def span_names(self):
        return {BATCH} | {s[0] for s in self.spans}

    def install(self):
        for name, mod, attr in self.spans:
            self._replace(mod, attr, lambda fn, name=name: _span(name, fn))
        for name, mod, attr in self.timers_wanted:
            self._replace(mod, attr, lambda fn, name=name: _timer(name, fn, self.timers))
        return self

    def _replace(self, mod, attr, make):
        m = importlib.import_module(mod)
        fn = getattr(m, attr)
        self._saved.append((m, attr, fn))
        setattr(m, attr, make(fn))

    def restore(self):
        for m, attr, fn in reversed(self._saved):
            setattr(m, attr, fn)
        self._saved.clear()

    def read_counters(self) -> dict:
        return {name: int(getattr(importlib.import_module(mod), attr))
                for name, mod, attr in self.counters}
