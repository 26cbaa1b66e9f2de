"""The reader of beam_search.rows_skipped_pct, beside the other readers'
tests (test_wsbench_metrics.py), on a synthetic run: its counters, its
answer worked out by hand, and nothing where the program lacks them."""

import numpy as np
import pytest

from wsbench import catalog, program
from wsbench.harness import RunView
from wsbench.tests.test_wsbench_metrics import synthetic

NAME = "beam_search.rows_skipped_pct"
CELL = "postfilter-200k-d128.frac2-2"


def run_with(tmp_path, counters):
    return RunView(cell=catalog.cell(CELL), trace=synthetic(tmp_path), batches=2,
                   which=np.array([0, 1]), counters=counters, timers={}, windows=[])


def test_reader_counters():
    mod = catalog.metric(NAME)
    try:
        names = {c[0] for c in mod.COUNTERS}
    finally:
        program.set_tracing(False)
    assert names == {"ops.beam.BEAM_ROWS_SCORED", "ops.beam.BEAM_CANDIDATES"}
    assert NAME in {m["name"] for m, _ in catalog.cell(CELL).per_layer}


def test_reader_value(tmp_path):
    run = run_with(tmp_path, {"ops.beam.BEAM_ROWS_SCORED": 300,
                              "ops.beam.BEAM_CANDIDATES": 1200})
    assert catalog.metric(NAME).read(run) == pytest.approx(75.0)


@pytest.mark.parametrize("counters", [{}, {"ops.beam.BEAM_ROWS_SCORED": 0},
                                      {"ops.beam.BEAM_ROWS_SCORED": 0,
                                       "ops.beam.BEAM_CANDIDATES": 0}])
def test_reader_finds_nothing(tmp_path, counters):
    assert catalog.metric(NAME).read(run_with(tmp_path, counters)) is None
