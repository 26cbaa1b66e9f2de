"""Tensors copied from the card a batch: the increase of the program's
counter models.base.FETCHES over the traced window, per batch."""

from wsbench import program

UNIT, LAYER, MOVES, SOURCE = "1/batch", "models.base: host-device copies", "qps", "program_counter"
NAME = "models.base.FETCHES"
__getattr__ = program.traced([(NAME, f"{program.PORT}.models.base", "FETCHES")])


def read(run):
    return program.per_batch(run, NAME)
