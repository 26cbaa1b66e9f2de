"""The program's own spans and counters, for the readers of the metrics that
read them.

The program opens its spans (record_function ranges, named in its `SPANS`)
only while its tracing is switched on (`set_tracing`), and counts its
copies and doubling rounds in module integers. The harness's own files
neither switch its tracing nor keep its span names in the reduced trace
(`spans.Instruments.span_names` lists the harness's spans alone), so a
reader of such a metric takes both from here:

  module `__getattr__ = traced(counters)`: the harness asks a reader for
      its COUNTERS only while it sets up a traced run's instruments, before
      the index is built; the answer switches the program's tracing on and
      names those of the counters that the program has;
  `trace(run)`: the traced window's profile with the program's spans (the
      run's own reduction where it holds them, else the Chrome trace the
      harness wrote, read again once); the harness reads the metrics once
      the window has closed, and this switches the tracing off again;
  `per_batch(run, counter)`, `durations(t, name, within)`.

A program without these spans or counters (an older commit) gives nothing
to read, and nor does a run in which no operation ran on a device (a CPU
run): the readers return None.

    python3 -m wsbench.program wsbench/out/trace-<cell>.json

prints a traced run's breakdown with the program's spans named, and each
span's count, time and self time in the window.
"""

from __future__ import annotations

import importlib
import json
import sys

import numpy as np

from . import spans as harness_spans
from . import trace as trace_mod
from .harness import OUT, PORT

_read: dict = {}  # (path, mtime) -> Trace, the last trace read again


def port():
    return importlib.import_module(PORT)


def program_spans() -> tuple:
    return tuple(getattr(port(), "SPANS", ()))


def set_tracing(on: bool) -> None:
    switch = getattr(port(), "set_tracing", None)
    if switch is not None:
        switch(on)


def _has(counter) -> bool:
    _, mod, attr = counter
    try:
        return hasattr(importlib.import_module(mod), attr)
    except ImportError:
        return False


def traced(counters=()):
    """A reader's module `__getattr__`: asked for COUNTERS (in a traced run
    only), it switches the program's tracing on and returns the counters
    of `counters` that the program has."""
    def __getattr__(attr):
        if attr == "COUNTERS":
            set_tracing(True)
            return [c for c in counters if _has(c)]
        raise AttributeError(attr)
    return __getattr__


def all_span_names() -> set:
    return ({harness_spans.BATCH} | {s[0] for s in harness_spans.BREAKDOWN_SPANS}
            | set(program_spans()))


def trace(run):
    """The run's profile with the program's spans, or None where it holds
    none of them or no operation ran on a device."""
    set_tracing(False)
    names = set(program_spans())
    if not names or len(run.trace.dev_start) == 0:
        return None
    if any(s[0] in names for s in run.trace.spans):
        return run.trace
    path = OUT / f"trace-{run.cell.name}.json"
    if not path.exists():
        return None
    key = (str(path), path.stat().st_mtime_ns)
    if key not in _read:
        _read.clear()
        _read[key] = trace_mod.Trace.from_chrome(str(path), all_span_names())
    t = _read[key]
    return t if any(s[0] in names for s in t.spans) else None


def per_batch(run, counter: str):
    """A counter's increase over the window, per batch; None where the
    program lacks it or no operation ran on a device."""
    set_tracing(False)
    if counter not in run.counters or len(run.trace.dev_start) == 0:
        return None
    return run.counters[counter] / run.batches


def durations(t, name: str, within=()) -> np.ndarray:
    """Microseconds of each `name` span, of those that lie inside a span
    named in `within` where it names any."""
    st, en = t.intervals(name)
    if within and len(st):
        ivs = [t.intervals(p) for p in within]
        a, b = trace_mod.merge(np.concatenate([i[0] for i in ivs]),
                               np.concatenate([i[1] for i in ivs]))
        i = np.searchsorted(a, st, side="right") - 1
        keep = (i >= 0) & (en <= b[np.maximum(i, 0)]) if len(a) else np.zeros(len(st), bool)
        st, en = st[keep], en[keep]
    return en - st


def host_times(t, lo: float, hi: float) -> dict:
    """{span name: [spans, seconds, self seconds]} in [lo, hi], by self
    time, largest first: a span's self time is the part of it that no
    span inside it covers."""
    out = {}
    for name in {s[0] for s in t.spans}:
        st, en = t.intervals(name)
        inside = (st >= lo) & (en <= hi)
        out[name] = [int(inside.sum()), float((en - st)[inside].sum()) * 1e-6, 0.0]
    for a, b, name in t.segments(lo, hi):
        if name in out:
            out[name][2] += (b - a) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1][2]))


def main(argv=None) -> int:
    path = (argv or sys.argv[1:])[0]
    t = trace_mod.Trace.from_chrome(path, all_span_names())
    lo, hi = t.window(harness_spans.BATCH)
    bd = t.breakdown(lo, hi, top=40)
    bd["window_s"] = (hi - lo) * 1e-6
    bd["idle_s"] = bd["window_s"] - t.busy(lo, hi) * 1e-6
    bd["host_s"] = host_times(t, lo, hi)
    print(json.dumps(bd, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
