"""Launches of the scan kernel B1 a batch: the increase of the program's
counter ops.scan.SCAN_LAUNCHES over the traced window, per batch."""

UNIT, LAYER, MOVES, SOURCE = "1/batch", "models.base: prefilter routing", "qps", "program_counter"
COUNTERS = [("ops.scan.SCAN_LAUNCHES", "rangefilteredann_tpu_torch.ops.scan", "SCAN_LAUNCHES")]


def read(run):
    return run.counters[COUNTERS[0][0]] / run.batches
