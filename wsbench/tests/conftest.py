"""wsbench's tests: CPU tests of the harness at tiny sizes, and tests marked
`card` that need a CUDA device and skip without one.

    python -m pytest wsbench/tests -q -p no:cacheprovider
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from wsbench import catalog  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def card():
    """Skip a test that needs the card where there is none (decided here,
    when the test runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


TINY = {
    # cell: (n, batch, build) at which the plain versions run in seconds
    "prefilter-1m-d128.frac2-2": (4000, 48, None),
    "postfilter-200k-d128.frac2-2": (1200, 24, {"R": 16, "L": 32, "alpha": 1.175}),
    "postfilter-200k-d128.frac2-4": (1200, 24, {"R": 16, "L": 32, "alpha": 1.175}),
}
# A 1,200-point graph of degree 16 holds recall@10 near 0.97 at beam 80, not
# the full graph's 0.99: the tiny cells' recall limit.
TINY_RECALL = 0.9


def tiny_cell(name: str) -> catalog.Cell:
    """The committed cell, cut to a size the CPU runs in seconds: fewer
    points and queries, a pool of 2, one warm-up pass, a smaller graph."""
    c = catalog.cell(name)
    n, batch, build = TINY[name]
    c.config = dict(c.config, n=n, **({"build": build} if build else {}))
    c.traffic = dict(c.traffic, batch=batch, pool=2, warmup_passes=1)
    c.limits = copy.deepcopy(c.limits)
    if "recall" in c.limits["checks"]:
        c.limits["checks"]["recall"]["min"] = TINY_RECALL
    return c
