"""Doubling rounds a batch: the increase of the program's counter
models.postfilter_vamana.ROUNDS over the traced window, per batch."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "1/batch", "models.postfilter_vamana: doubling planner, window filter and finalize", "qps", "program_counter"
NAME = "models.postfilter_vamana.ROUNDS"
__getattr__ = program.traced([(NAME, f"{program.PORT}.models.postfilter_vamana", "ROUNDS")])


def read(run):
    return program.per_batch(run, NAME)
