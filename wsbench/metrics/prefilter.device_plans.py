"""Batches whose window bounds the prefilter searched on the card: the
increase of the program's counter models.prefilter.DEVICE_PLANS over the
traced window, per batch."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "1/batch", "models.prefilter and models.base: host planner and finalize", "qps", "program_counter"
NAME = "models.prefilter.DEVICE_PLANS"
__getattr__ = program.traced([(NAME, f"{program.PORT}.models.prefilter", "DEVICE_PLANS")])


def read(run):
    return program.per_batch(run, NAME)
