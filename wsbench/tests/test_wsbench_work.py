"""The scan's work, counted on hand-worked windows."""

import pytest

from wsbench.work import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, bound_s, scan_work


def test_scan_work_by_hand():
    # windows [0, 10), [5, 15), [30, 30) (empty), [40, 42): 10 + 10 + 0 + 2
    # pairs; rows 0..14 and 40..41 covered: 17 rows
    flops, nbytes = scan_work([0, 5, 30, 40], [10, 15, 30, 42], d=4, k=3)
    assert flops == 2 * 4 * 22
    assert nbytes == 17 * (4 * 4 + 4) + 4 * (4 * 4 + 8) + 4 * 3 * 8


def test_scan_work_of_nested_and_touching_windows():
    flops, nbytes = scan_work([0, 2, 8], [8, 4, 12], d=2, k=1)
    assert flops == 2 * 2 * (8 + 2 + 4)
    assert nbytes == 12 * 12 + 3 * 16 + 3 * 8


def test_bound_takes_the_larger():
    assert bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert PEAK_FP32_FLOPS == 67e12 and PEAK_HBM_BYTES == 3.35e12
