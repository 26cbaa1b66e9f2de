"""Host milliseconds a batch of finishing the answers: the program's
base.finalize spans (the query norms and finalize_output, which decodes the
ids and restores the distances), summed over the traced window, per
batch."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "ms/batch", "models.prefilter and models.base: host planner and finalize", "qps", "program_span"
__getattr__ = program.traced()


def read(run):
    t = program.trace(run)
    if t is None:
        return None
    return float(program.durations(t, "base.finalize").sum()) * 1e-3 / run.batches
