"""Launches of the beam kernel B2 a batch: the increase of the program's
counter ops.beam.BEAM_LAUNCHES over the traced window, per batch."""

UNIT, LAYER, MOVES, SOURCE = "1/batch", "ops.beam: the beam kernel B2", "qps", "program_counter"
COUNTERS = [("ops.beam.BEAM_LAUNCHES", "rangefilteredann_tpu_torch.ops.beam", "BEAM_LAUNCHES")]


def read(run):
    return run.counters[COUNTERS[0][0]] / run.batches
