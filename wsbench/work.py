"""The card's peaks, and the work a layer must do, counted by the benchmark.

Work is counted from the benchmark's own label sort and windows
(reference.Reference.windows), never from what the program computed, so the
count stays the same whatever implements the layer.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM 80 GB, NVIDIA's data sheet, dense rates at the 700 W limit.
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def scan_work(starts: np.ndarray, ends: np.ndarray, d: int, k: int):
    """(flops, bytes) an exact float32 window scan must do for one batch:
    2*d flops for each in-window (query, point) pair; each point that some
    window covers read once (d floats and its norm), each query read once
    (d floats and its two bounds), each answer written once (a distance and
    an id)."""
    s = np.asarray(starts, dtype=np.int64)
    e = np.asarray(ends, dtype=np.int64)
    w = np.maximum(e - s, 0)
    flops = 2.0 * d * float(w.sum())
    live = w > 0
    marks = np.zeros(int(e.max(initial=0)) + 2, dtype=np.int64)
    np.add.at(marks, s[live], 1)
    np.add.at(marks, e[live], -1)
    covered = int((np.cumsum(marks) > 0).sum())
    nbytes = covered * (d * 4 + 4) + len(s) * (d * 4 + 8) + len(s) * k * 8
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS) -> float:
    """The least time the card could take: the larger of the operations at
    their peak rate and the bytes at the memory's."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)
