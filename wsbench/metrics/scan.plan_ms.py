"""Host milliseconds a batch of the scan wrapper's planning before the kernel
B1's launch (the midpoint sort, the segment plan and the scratch): the
program's scan.plan spans, summed over the traced window, per batch."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "ms/batch", "ops.scan: the scan kernel B1", "qps", "program_span"
__getattr__ = program.traced()


def read(run):
    t = program.trace(run)
    if t is None:
        return None
    return float(program.durations(t, "scan.plan").sum()) * 1e-3 / run.batches
