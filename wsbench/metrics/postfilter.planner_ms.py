"""Host milliseconds a batch of the doubling planner that are not spent
waiting on the card: the program's postfilter.round, postfilter.exact_tail
and postfilter.final spans, less the base.fetch and base.upload spans
inside them (a blocking upload synchronises the stream, so it too waits for
the kernels launched before it), summed over the traced window, per
batch."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "ms/batch", "models.postfilter_vamana: doubling planner, window filter and finalize", "qps", "program_span"
__getattr__ = program.traced()
PARTS = ("postfilter.round", "postfilter.exact_tail", "postfilter.final")


def read(run):
    t = program.trace(run)
    if t is None:
        return None
    us = sum(program.durations(t, name).sum() for name in PARTS) - sum(
        program.durations(t, name, within=PARTS).sum() for name in ("base.fetch", "base.upload"))
    return float(us) * 1e-3 / run.batches
