"""The port's own spans, on torch.profiler's timeline.

Each step of the batch paths runs inside `span(name)`. With tracing off
(the default) that is one shared no-op context after a test of one module
flag; with tracing on it is a `record_function` range, which a running
torch.profiler records on the clock of its device trace. Spans nest as the
calls do: a batch's root span (`prefilter.batch`, `postfilter.batch`) holds
every span of that batch. No span calls itself, so spans of one name never
overlap.

The counters beside them are module-level ints that count always:
`models.base.UPLOADS` and `FETCHES` (tensors copied to and from the device),
`models.postfilter_vamana.ROUNDS` (doubling rounds), `ops.scan.SCAN_LAUNCHES`
and `ops.beam.BEAM_LAUNCHES` (kernel launches), `models.prefilter.DEVICE_PLANS`
(batches whose window bounds were searched on the store's device). Counts
that the card computes are `DeviceCount`s, which add up only while tracing
is on and stay on the device until `int()` reads them:
`ops.beam.BEAM_ROWS_SCORED` and `BEAM_CANDIDATES` (the beam kernel's rows
scored, and its candidates less each query's start).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

SPANS = (
    # PrefilterIndex.batch_search
    "prefilter.batch",
    "prefilter.pad",
    "prefilter.window_bounds",
    "scan.plan",
    "scan.kernel",
    "gather.kernel",
    # PostfilterVamanaIndex.batch_search
    "postfilter.batch",
    "postfilter.pad",
    "postfilter.window_bounds",
    "postfilter.round",
    "postfilter.search",
    "beam.start",
    "beam.kernel",
    "beam_search.plain",
    "beam_search.window_filter",
    "beam_search.rerank",
    "postfilter.exact_tail",
    "postfilter.final",
    # both
    "base.upload",
    "base.fetch",
    "base.finalize",
)

_NULL = contextlib.nullcontext()
_on = False


def set_tracing(on: bool) -> None:
    """Open the port's spans (True) or skip them (False)."""
    global _on
    _on = bool(on)


def tracing() -> bool:
    """Whether the port's spans are open."""
    return _on


def span(name: str):
    """A context that records `name` on the profiler's timeline while
    tracing is on, and does nothing otherwise."""
    return record_function(name) if _on else _NULL


class DeviceCount:
    """A count summed on the device, one int64 a device: `add` queues a
    sum and an addition on the tensor's stream (no host sync); `int()`
    fetches the totals, so read it only outside the steps it counts."""

    def __init__(self):
        self._totals: dict = {}

    def add(self, total: torch.Tensor) -> None:
        """Adds a 0-d integer tensor."""
        t = self._totals.get(total.device)
        if t is None:
            self._totals[total.device] = total.to(torch.int64).clone()
        else:
            t += total

    def __int__(self) -> int:
        return sum(int(t) for t in self._totals.values())
