"""Tensors copied to the card a batch: the increase of the program's counter
models.base.UPLOADS over the traced window, per batch."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "1/batch", "models.base: host-device copies", "qps", "program_counter"
NAME = "models.base.UPLOADS"
__getattr__ = program.traced([(NAME, f"{program.PORT}.models.base", "UPLOADS")])


def read(run):
    return program.per_batch(run, NAME)
