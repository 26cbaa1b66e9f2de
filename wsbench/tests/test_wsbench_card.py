"""The harness on the card at small sizes: the kernels B1 and B2 on the
timed path, their spans and counters in the traced run. Marked `card`:
skips without a CUDA device. On the card:

    python -m pytest wsbench/tests -q -p no:cacheprovider -m card
"""

import pytest

from wsbench import harness

from conftest import tiny_cell


@pytest.mark.card
def test_scan_cell_on_the_card(card):
    cell = tiny_cell("prefilter-1m-d128.frac2-2")
    cell.config = dict(cell.config, n=60000)  # windows of 15,000: the scan kernel
    r = harness.run_cell(cell, 21, 1.0, True, device=card)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["scan_topk.launches"] == 1.0
    assert 0 < m["scan_topk.roofline_pct"] <= 100
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]


@pytest.mark.card
def test_beam_cell_on_the_card(card):
    r = harness.run_cell(tiny_cell("postfilter-200k-d128.frac2-2"), 22, 1.0, True, device=card)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["beam_search.launches"] >= 1 and m["postfilter.plain_searches"] == 0
    assert m["beam_search.device_ms"] > 0 and m["vamana.build_s"] > 0
