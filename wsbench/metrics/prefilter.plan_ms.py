"""Host milliseconds a batch that the prefilter plans before its launch: the
program's spans prefilter.pad (query padding), prefilter.window_bounds (the
two label searches) and base.upload (the copies to the card) inside
prefilter.batch, summed over the traced window, per batch."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "ms/batch", "models.prefilter and models.base: host planner and finalize", "qps", "program_span"
__getattr__ = program.traced()


def read(run):
    t = program.trace(run)
    if t is None:
        return None
    us = sum(program.durations(t, name, within=("prefilter.batch",)).sum()
             for name in ("prefilter.pad", "prefilter.window_bounds", "base.upload"))
    return float(us) * 1e-3 / run.batches
