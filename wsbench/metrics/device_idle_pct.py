"""Share of the traced window in which no kernel, copy or set ran on the card:
100 - the union of the device's intervals / the window (first batch's call
to last batch's answers)."""

from wsbench.spans import BATCH

UNIT, LAYER, MOVES, SOURCE = "%", "device: one H100", "qps", "device_trace"


def read(run):
    lo, hi = run.trace.window(BATCH)
    if hi <= lo or len(run.trace.dev_start) == 0:
        return None
    return 100.0 * (1.0 - run.trace.busy(lo, hi) / (hi - lo))
