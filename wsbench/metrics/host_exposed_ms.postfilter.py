"""Host milliseconds a batch that the card does not hide: each traced
batch's wall (its span, call to answers on the host) less the union of the
device operations launched inside it; the mean over the batches."""

from wsbench.spans import BATCH

UNIT, LAYER, MOVES, SOURCE = "ms/batch", "models.postfilter_vamana: doubling planner, window filter and finalize", "qps", "device_trace"


def read(run):
    wall, busy = run.trace.per_span_busy(BATCH)
    if len(wall) == 0:
        return None
    return float((wall - busy).mean()) * 1e-3
