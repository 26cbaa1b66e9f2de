"""The PyTorch port's native bridge and tree planners against the JAX
package's.

The port keeps its own copy of the ctypes bridge (rangefilteredann_tpu_torch/
native.py) over the unchanged native/winann_native.cpp, built into
build/native/. On the same inputs, drawn from a numpy seed, it must return
exactly what the JAX bridge returns (tests/test_native.py's cases), and the
port's batched native planner must emit the same tasks as its per-query
Python planner and as the JAX package's planner, for every query method and
both leaves.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest

from rangefilteredann_tpu import native as jnative
from rangefilteredann_tpu.models import range_filter_tree as JRFT
from rangefilteredann_tpu.params import QueryParams as JQueryParams
from rangefilteredann_tpu.utils.data import first_geq
from rangefilteredann_tpu_torch import native as pnative
from rangefilteredann_tpu_torch.models import range_filter_tree as PRFT
from rangefilteredann_tpu_torch.params import QueryParams

from .torch_native_bridge import load_reference_bridge


@pytest.fixture(scope="module", autouse=True)
def bridges():
    """Both bridges over one whole library (skips only without g++)."""
    load_reference_bridge()


def _random_ranges(rng, n, nq):
    lo = rng.integers(0, n, size=nq).astype(np.int64)
    width = np.minimum(rng.integers(1, n, size=nq), (n - lo).astype(np.int64))
    hi = lo + np.maximum(width, 1)
    return lo, np.minimum(hi, n)


def _planner(cls, n, cutoff, split, leaf="vamana"):
    """A tree object holding only what the planners read (no rows built)."""
    t = cls.__new__(cls)
    t._offsets = PRFT.build_offset_rows(n, cutoff, split)
    t._cutoff, t._split, t._leaf = cutoff, split, leaf
    return t


@pytest.fixture
def no_native():
    """The port's bridge as it is without g++: every entry point gives None."""
    saved = pnative._lib, pnative._tried
    pnative._lib, pnative._tried = None, True
    yield
    pnative._lib, pnative._tried = saved


def test_library_builds_under_build_dir():
    so = pnative.library_path()
    assert so.parent == pnative.BUILD_DIR
    assert pnative.BUILD_DIR.parts[-2:] == ("build", "native")
    assert pnative.SRC.parts[-2:] == ("native", "winann_native.cpp")
    assert so.exists()


def test_entry_points_give_none_without_the_library(no_native):
    offs = PRFT.build_offset_rows(1000, 97, 2)
    lo, hi = np.array([0, 10]), np.array([500, 900])
    assert not pnative.available()
    assert pnative.plan_fenwick_batch(offs, 2, lo, hi) is None
    assert pnative.plan_center_batch(offs, lo, hi) is None
    assert pnative.plan_optimized_batch(offs, 2, 97, None, lo, hi) is None
    assert pnative.merge_topk_parts(np.zeros((1, 2), np.int64),
                                    np.zeros((1, 2), np.float32),
                                    np.zeros(1, np.int32), 1, 7) is None


@pytest.mark.parametrize("n,cutoff,split", [(10_000, 97, 2), (5_000, 53, 3)])
def test_fenwick_planner_parity(n, cutoff, split):
    rng = np.random.default_rng(0)
    oracle = _planner(PRFT.RangeFilterTreeIndex, n, cutoff, split)
    lo, hi = _random_ranges(rng, n, 300)
    got = pnative.plan_fenwick_batch(oracle._offsets, split, lo, hi)
    want = jnative.plan_fenwick_batch(JRFT.build_offset_rows(n, cutoff, split),
                                      split, lo, hi)
    b_row, b_idx, b_cnt, fringe = got
    np.testing.assert_array_equal(b_cnt, want[2])
    np.testing.assert_array_equal(fringe, want[3])
    for q in range(len(lo)):
        c = b_cnt[q]
        np.testing.assert_array_equal(b_row[q, :c], want[0][q, :c])
        np.testing.assert_array_equal(b_idx[q, :c], want[1][q, :c])
        buckets, fr = oracle._plan_fenwick(int(lo[q]), int(hi[q]))
        assert [(int(b_row[q, j]), int(b_idx[q, j])) for j in range(c)] == buckets
        want_fr = fr if len(fr) == 2 else [fr[0], (0, 0)]  # no-centre case
        assert [(int(fringe[q, 0]), int(fringe[q, 1])),
                (int(fringe[q, 2]), int(fringe[q, 3]))] == want_fr, f"q={q}"


@pytest.mark.parametrize("min_ratio", [None, 8.0])
def test_optimized_planner_parity(min_ratio):
    n, cutoff, split = 10_000, 97, 2
    rng = np.random.default_rng(1)
    oracle = _planner(PRFT.RangeFilterTreeIndex, n, cutoff, split)
    qp = QueryParams(k=5, beamSize=10, min_query_to_bucket_ratio=min_ratio)
    lo, hi = _random_ranges(rng, n, 300)
    kind, row, idx = pnative.plan_optimized_batch(oracle._offsets, split, cutoff,
                                                  min_ratio, lo, hi)
    for a, b in zip((kind, row, idx), jnative.plan_optimized_batch(
            oracle._offsets, split, cutoff, min_ratio, lo, hi)):
        np.testing.assert_array_equal(a[kind == 1], b[kind == 1])
    for q in range(len(lo)):
        want_kind, want_where = oracle._plan_optimized(int(lo[q]), int(hi[q]), qp)
        assert kind[q] == (want_kind == "bucket"), f"q={q}"
        if want_kind == "bucket":
            assert (int(row[q]), int(idx[q])) == want_where, f"q={q}"


def test_center_parity():
    n, cutoff, split = 10_000, 97, 2
    rng = np.random.default_rng(2)
    oracle = _planner(PRFT.RangeFilterTreeIndex, n, cutoff, split)
    lo, hi = _random_ranges(rng, n, 300)
    got = pnative.plan_center_batch(oracle._offsets, lo, hi)
    want = jnative.plan_center_batch(oracle._offsets, lo, hi)
    found = got[0]
    np.testing.assert_array_equal(found, want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a[found], b[found])
    for q in range(len(lo)):
        c = oracle._find_largest_ranges(int(lo[q]), int(hi[q]))
        assert found[q] == (c is not None), f"q={q}"
        if c is not None:
            assert tuple(int(a[q]) for a in got[1:]) == c, f"q={q}"


def test_merge_topk_parity(no_native):
    """The native merge equals the JAX bridge's, the port's numpy merge and
    a per-query (dist, id) lexsort; parts are disjoint, so no dedup."""
    rng = np.random.default_rng(4)
    nq, k, parts = 50, 10, 170
    empty = PRFT.EMPTY_ID
    part_qi = rng.integers(0, nq, size=parts).astype(np.int32)
    part_ids = rng.permutation(10_000)[: parts * k].reshape(parts, k).astype(np.int64)
    part_d = rng.integers(0, 40, size=(parts, k)).astype(np.float32)  # ties
    mask = rng.random((parts, k)) < 0.3
    part_ids[mask] = empty
    part_d[mask] = np.inf
    tree = _planner(PRFT.RangeFilterTreeIndex, 1000, 97, 2)
    numpy_i, numpy_d = tree._merge(part_ids, part_d, part_qi, nq, k)
    pnative._lib, pnative._tried = None, False  # the library again
    got_i, got_d = pnative.merge_topk_parts(part_ids, part_d, part_qi, nq, empty)
    want_i, want_d = jnative.merge_topk_parts(part_ids, part_d, part_qi, nq, empty)
    for a, b in ((got_i, want_i), (got_d, want_d), (got_i, numpy_i), (got_d, numpy_d)):
        np.testing.assert_array_equal(a, b)
    for q in range(nq):
        ids_all = part_ids[part_qi == q].reshape(-1)
        d_all = part_d[part_qi == q].reshape(-1)
        keep = ids_all != empty
        order = np.lexsort((ids_all[keep], d_all[keep]))[:k]
        np.testing.assert_array_equal(got_i[q, : len(order)], ids_all[keep][order])
        assert (got_i[q, len(order):] == empty).all()


def _sorted_tasks(plan):
    """Each task kind's rows as a sorted array (the planners order tasks
    differently; the set of tasks is what must agree)."""
    out = []
    for cols in plan:
        a = np.stack(cols, axis=1) if len(cols[0]) else np.zeros((0, len(cols)), np.int64)
        out.append(a[np.lexsort(a.T[::-1])] if len(a) else a)
    return out


@pytest.mark.parametrize("leaf", ["vamana", "prefilter"])
@pytest.mark.parametrize("method,ratio", [
    ("fenwick", None), ("optimized_postfilter", None), ("three_split", None),
    ("optimized_postfilter", 1.5)])  # the last: smart combined
def test_batch_plans_agree(method, ratio, leaf):
    """The port's native batched plan == its Python per-query plan (as task
    sets) == the JAX package's native plan (array for array), on labels
    with ties so that hi_incl differs from hi."""
    n, cutoff, split = 6_000, 150, 2
    rng = np.random.default_rng(6)
    labels = np.sort(rng.integers(0, 1500, size=n) / 1500.0)
    nq = 200
    a = rng.uniform(-0.05, 1.0, size=nq)
    filters = np.stack([a, a + rng.choice([2.0**-8, 2.0**-4, 0.25, 0.6], size=nq)], 1)
    filters[:5] = [(0.5, 0.4), (2.0, 3.0), (0.0, 1.1), (0.3, 0.3), (-1, 0.0)]
    lo, hi = first_geq(labels, filters[:, 0]), first_geq(labels, filters[:, 1])
    hi_incl = np.searchsorted(labels, filters[:, 1], side="right")
    qp = QueryParams(k=10, beamSize=20, final_beam_multiply=3,
                     min_query_to_bucket_ratio=ratio)
    jqp = JQueryParams(k=10, beamSize=20, final_beam_multiply=3,
                       min_query_to_bucket_ratio=ratio)
    port = _planner(PRFT.RangeFilterTreeIndex, n, cutoff, split, leaf)
    jax_t = _planner(JRFT.RangeFilterTreeIndex, n, cutoff, split, leaf)
    got = port._plan_batch_native(method, lo, hi, hi_incl, qp)
    want = jax_t._plan_batch_native(method, lo, hi, hi_incl, jqp)
    for g_kind, w_kind in zip(got, want):
        for g, w in zip(g_kind, w_kind):
            np.testing.assert_array_equal(g, w)
    py = port._plan_batch_python(method, lo, hi, hi_incl, qp, nq)
    for g, p in zip(_sorted_tasks(got), _sorted_tasks(py)):
        np.testing.assert_array_equal(g, p)
    n_single, n_dbl, n_brute = (len(kind[0]) for kind in got)
    assert n_brute > 0
    if leaf == "prefilter":
        assert n_single == 0  # bucket searches are exact windows there
    elif method != "optimized_postfilter":
        assert n_single > 0
    assert (n_dbl > 0) == (leaf == "vamana" and method != "fenwick")
