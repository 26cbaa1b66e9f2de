"""The PyTorch port's RangeFilterTreeIndex (B-WST) against the JAX package's.

The JAX package builds one Vamana-leaf tree per module (n = 2000, d = 24,
cutoff 300, R = 20, L = 40) with its row caches in a temporary directory;
the port loads the same rows through `row_cache_filename` (same names, same
fingerprint) and both packages search them: ids must match exactly,
distances within rtol 1e-5 / atol 1e-4, search counters exactly, for
fenwick, optimized_postfilter, three_split and smart combined at filter
fractions 2^-8, 2^-4, 2^-2 and 0.5, with the native planner and with the
Python one. The prefilter-leaf tree is exact and is also held against the
float64 oracle. On the CPU no row carries inline blocks (as in the JAX
package); a test attaches them to reach the beam kernel's route.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import rangefilteredann_tpu as J
import rangefilteredann_tpu_torch as P
from rangefilteredann_tpu.models import range_filter_tree as JRFT
from rangefilteredann_tpu_torch import native as pnative
from rangefilteredann_tpu_torch.models import base as PBASE
from rangefilteredann_tpu_torch.models import postfilter_vamana as PPV
from rangefilteredann_tpu_torch.models import range_filter_tree as PRFT
from rangefilteredann_tpu_torch.utils.data import first_geq
from rangefilteredann_tpu_torch.utils.stats import QueryStats

RTOL, ATOL = 1e-5, 1e-4
N, D, K = 2000, 24, 10
CUTOFF, SPLIT, SEED = 300, 2, 5
FRACTIONS = (2.0**-8, 2.0**-4, 2.0**-2, 0.5)
FLT_MAX = np.finfo(np.float32).max
METHODS = [("fenwick", None), ("optimized_postfilter", None),
           ("three_split", None), ("optimized_postfilter", 1.5)]  # smart combined
METHOD_IDS = ["fenwick", "optimized_postfilter", "three_split", "smart_combined"]


def _bp(pkg, cache=""):
    return pkg.BuildParams(R=20, L=40, alpha=1.2, cache_path=cache)


def _queries(rng, nq, fractions=FRACTIONS):
    queries = rng.normal(size=(nq, D)).astype(np.float32)
    frac = np.asarray(fractions)[np.arange(nq) % len(fractions)]
    lo = rng.uniform(0, 1, size=nq) * (1 - frac)
    return queries, np.stack([lo, lo + frac], axis=1)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Data, a JAX-built tree whose rows are cached, and queries."""
    rng = np.random.default_rng(2025)
    points = rng.normal(size=(N, D)).astype(np.float32)
    labels = rng.uniform(size=N)
    cache = str(tmp_path_factory.mktemp("rows")) + "/"
    jtree = J.RangeFilterTreeIndex(points, labels, cutoff=CUTOFF, split_factor=SPLIT,
                                   build_params=_bp(J, cache), seed=SEED)
    queries, filters = _queries(rng, 64)
    return dict(points=points, labels=labels, cache=cache, jtree=jtree,
                queries=queries, filters=filters)


def _port_tree(s, **kw):
    return P.RangeFilterTreeIndex(s["points"], s["labels"], cutoff=CUTOFF,
                                  split_factor=SPLIT, build_params=_bp(P, s["cache"]),
                                  seed=SEED, require_cache=True, device="cpu", **kw)


def _search(tree, pkg, s, method, ratio=None, stats=None, beam=20, fm=2):
    qp = pkg.build_query_params(K, beam, final_beam_multiply=fm,
                                min_query_to_bucket_ratio=ratio)
    return tree.batch_search(s["queries"], s["filters"], len(s["queries"]), method,
                             qp, stats=stats)


def assert_same_results(want, got):
    wi, wd = want
    gi, gd = got
    assert gi.dtype == np.uint32 and gd.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


def recall(ids, dists, gt_ids):
    hits = tot = 0
    for i in range(len(ids)):
        want = set(gt_ids[i][gt_ids[i] >= 0].tolist())
        hits += len(want & set(ids[i][dists[i] < FLT_MAX].astype(int).tolist()))
        tot += len(want)
    return hits / max(tot, 1)


@pytest.mark.parametrize("n,cutoff,split", [(1000, 100, 2), (997, 50, 3),
                                            (5000, 1000, 2), (64, 10, 4)])
def test_layout_helpers_match_jax(n, cutoff, split):
    got, want = PRFT.build_offset_rows(n, cutoff, split), JRFT.build_offset_rows(n, cutoff, split)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for r in range(len(got)):
        assert (PRFT.row_cache_filename("c/", _bp(P), 0.125, 0.75, n, split, cutoff, r)
                == JRFT.row_cache_filename("c/", _bp(J), 0.125, 0.75, n, split, cutoff, r))


@pytest.fixture
def python_planner():
    """The port without its native library: the Python planner and merge."""
    saved = pnative._lib, pnative._tried
    pnative._lib, pnative._tried = None, True
    yield
    pnative._lib, pnative._tried = saved


@pytest.mark.parametrize("method,ratio", METHODS, ids=METHOD_IDS)
def test_vamana_tree_matches_jax(shared, method, ratio, request):
    s = shared
    ptree = _port_tree(s)
    for r, (pg, jg) in enumerate(zip(ptree._graphs, s["jtree"]._graphs)):
        np.testing.assert_array_equal(pg.nbrs_host, jg.nbrs_host)
        np.testing.assert_array_equal(pg.bucket_slab_offsets, s["jtree"]._offsets[r])
    jstats, pstats = J.QueryStats(len(s["queries"])), QueryStats(len(s["queries"]))
    want = _search(s["jtree"], J, s, method, ratio, stats=jstats)
    got = _search(ptree, P, s, method, ratio, stats=pstats)
    assert_same_results(want, got)
    np.testing.assert_array_equal(pstats.visited, jstats.visited)
    np.testing.assert_array_equal(pstats.distances, jstats.distances)
    assert (got[0] == 0).any() and (got[1][:, 0] < FLT_MAX).all()  # 2^-8: padded
    request.getfixturevalue("python_planner")
    assert not pnative.available()
    for a, b in zip(_search(ptree, P, s, method, ratio), got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["fenwick", "optimized_postfilter", "three_split"])
def test_prefilter_leaf_matches_jax_and_oracle(shared, gt_fn, method):
    s = shared
    jtree = J.RangeFilterTreeIndex(s["points"], s["labels"], cutoff=CUTOFF,
                                   leaf="prefilter")
    ptree = P.range_filter_tree_constructor("Euclidian", "float")(
        s["points"], s["labels"], cutoff=CUTOFF, device="cpu")
    assert ptree._leaf == "prefilter" and all(g is None for g in ptree._graphs)
    want, got = _search(jtree, J, s, method), _search(ptree, P, s, method)
    assert_same_results(want, got)
    gt_ids, gt_d = gt_fn(s["points"], s["labels"], s["queries"], s["filters"], K, "l2")
    real = gt_ids >= 0
    np.testing.assert_array_equal(got[0][real], gt_ids[real])
    np.testing.assert_allclose(got[1][real], gt_d[real], rtol=RTOL, atol=ATOL)
    assert (got[0][~real] == 0).all() and (got[1][~real] == FLT_MAX).all()


def test_three_split_right_side_uses_inclusive_top():
    """three_split's right-side doubling window tops at hi_incl (the
    inclusive-top extension of the direct optimized_postfilter path), in
    both planners (tests/test_tree.py::test_three_split_right_side_uses_inclusive_top)."""
    rng = np.random.default_rng(11)
    n = 1200
    labels = np.sort(rng.integers(0, 100, size=n) / 100.0)  # ~12 points a label
    tree = PRFT.RangeFilterTreeIndex.__new__(PRFT.RangeFilterTreeIndex)
    tree._offsets = PRFT.build_offset_rows(n, 150, 2)
    tree._cutoff, tree._split, tree._leaf = 150, 2, "vamana"
    vals = np.unique(labels)
    filters = np.array([sorted(vals[rng.choice(len(vals), 2, replace=False)])
                        for _ in range(24)])
    lo_idx, hi_idx = first_geq(labels, filters[:, 0]), first_geq(labels, filters[:, 1])
    hi_incl = np.searchsorted(labels, filters[:, 1], side="right")
    assert (hi_incl > hi_idx).all()  # every hi sits on a tied label
    qp = P.build_query_params(K, 20)
    plans = [tree._plan_batch_python("three_split", lo_idx, hi_idx, hi_incl, qp, 24)]
    if pnative.available():
        plans.append(tree._plan_batch_native("three_split", lo_idx, hi_idx, hi_incl, qp))
    checked = 0
    for _, (d_qi, _, _, _, d_whi), _ in plans:
        for qi in range(len(filters)):
            tops = d_whi[d_qi == qi]
            right = tops[tops >= hi_idx[qi]]  # left sides end at cover_lo < hi
            checked += len(right)
            assert (right == hi_incl[qi]).all(), (qi, right, hi_incl[qi])
    assert checked > 0


def test_empty_windows_and_pad_zero(shared):
    """Empty windows (above every label, hi < lo) return only padding: id 0
    and FLT_MAX in trees (ref: range_filter_tree.h:84-93)."""
    s = shared
    ptree = _port_tree(s)
    queries = s["queries"][:3]
    filters = np.array([(5.0, 6.0), (0.5, 0.4), (0.4, 0.5)])
    qp_j, qp_p = J.build_query_params(K, 20), P.build_query_params(K, 20)
    want = s["jtree"].batch_search(queries, filters, 3, "fenwick", qp_j)
    for method in ("fenwick", "optimized_postfilter", "three_split"):
        ids, dists = ptree.batch_search(queries, filters, 3, method, qp_p)
        assert (ids[:2] == 0).all() and (dists[:2] == FLT_MAX).all()
        assert (dists[2] < FLT_MAX).all()
        if method == "fenwick":
            assert_same_results(want, (ids, dists))


def test_row0_loads_whole_dataset_cache(shared, tmp_path):
    """Row 0 is the flat postfilter graph's build: without a row-0 file the
    tree loads the whole-dataset cache (vamana_*.npz) and writes nothing."""
    s = shared
    cache = str(tmp_path) + "/"
    for f in os.listdir(s["cache"]):
        if not f.endswith("_row0.npz"):
            shutil.copy(os.path.join(s["cache"], f), cache)
    canon = PBASE.whole_dataset_cache(cache, _bp(P, cache), float(s["labels"].min()),
                                      float(s["labels"].max()), N)
    assert os.path.exists(canon)
    before = sorted(os.listdir(cache))
    ptree = P.RangeFilterTreeIndex(s["points"], s["labels"], cutoff=CUTOFF,
                                   split_factor=SPLIT, build_params=_bp(P, cache),
                                   seed=SEED, require_cache=True, device="cpu")
    np.testing.assert_array_equal(ptree._graphs[0].nbrs_host,
                                  s["jtree"]._graphs[0].nbrs_host)
    assert sorted(os.listdir(cache)) == before
    flat = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, cache),
                                   require_cache=True, device="cpu")
    np.testing.assert_array_equal(flat._graph.nbrs_host, ptree._graphs[0].nbrs_host)
    os.remove(canon)
    with pytest.raises(FileNotFoundError):
        P.RangeFilterTreeIndex(s["points"], s["labels"], cutoff=CUTOFF,
                               build_params=_bp(P, cache), require_cache=True,
                               device="cpu")


def test_device_rows_budget_same_results(shared):
    """Rows kept on the device under an LRU budget that holds about one
    row: they start evicted, upload on route, and the results equal the
    fully resident tree's (tests/test_tree.py::test_device_rows_budget_lru)."""
    s = shared
    full = _port_tree(s)
    one_row = int(N * 20 * 4 * 1.5)
    lazy = _port_tree(s, device_rows_budget=one_row)
    assert all(g.nbrs_dev is None and g.slab_to_global_dev is None
               for g in lazy._graphs)
    for method in ("fenwick", "optimized_postfilter", "three_split"):
        want = _search(full, P, s, method)
        got = _search(lazy, P, s, method)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        resident = [g for g in lazy._graphs if g.nbrs_dev is not None]
        assert 1 <= len(resident) < len(lazy._graphs)
        assert sum(g.device_bytes() for g in resident) <= one_row
    g = lazy._graphs[0]
    g.ensure_device("cpu")
    np.testing.assert_array_equal(g.nbrs_dev.numpy(), g.nbrs_host)
    assert g.device_bytes() == g.m * g.R * 4 + g.m * 4


@pytest.mark.parametrize("method", ["fenwick", "optimized_postfilter"])
def test_inline_blocks_take_the_kernel_route(shared, gt_fn, method, monkeypatch):
    """With int8 blocks and a scale on every row (what plan_row_inline
    attaches on the card), every query-mode search goes through the beam
    kernel's wrapper (on CPU tensors, its plain version), the single-shot
    top k + 8 is reranked exactly, and recall stays within 0.02 of the
    route without blocks."""
    s = shared
    ptree = _port_tree(s)
    gt_ids, _ = gt_fn(s["points"], s["labels"], s["queries"], s["filters"], K, "l2")
    ids0, d0 = _search(ptree, P, s, method, beam=40, fm=4)
    for g in ptree._graphs:
        assert g.nbr_vecs is None  # plan_row_inline does nothing on the CPU
        g.attach_inline(ptree._ps, torch.int8)
    calls = {"kernel": 0, "plain": 0}
    real_inline, real_plain = PPV.beam_search_inline, PPV.batched_beam_search

    def inline(*a, **kw):
        calls["kernel"] += 1
        return real_inline(*a, **kw)

    def plain(*a, **kw):
        calls["plain"] += 1
        return real_plain(*a, **kw)

    monkeypatch.setattr(PPV, "beam_search_inline", inline)
    monkeypatch.setattr(PPV, "batched_beam_search", plain)
    ids1, d1 = _search(ptree, P, s, method, beam=40, fm=4)
    assert calls["kernel"] >= 1 and calls["plain"] == 0
    r0, r1 = recall(ids0, d0, gt_ids), recall(ids1, d1, gt_ids)
    assert r0 > 0.85 and r1 >= r0 - 0.02, (r1, r0)
    # reranked distances are exact: each equals the no-block search's
    # distance of the same id
    same = ids1 == ids0
    np.testing.assert_allclose(d1[same], d0[same], rtol=RTOL, atol=ATOL)


def test_plan_row_inline_picks_within_budget(monkeypatch):
    """The busiest rows get int8 blocks while they fit TREE_INLINE_BUDGET;
    attached rows outside the pick lose them; a store on the CPU is left
    alone."""
    attached_calls = []

    class Row:
        def __init__(self, r):
            self.r, self.nbrs_dev, self.nbr_vecs = r, object(), None
            self.nbr_norms = self.nbr_scale = None

        def inline_bytes(self, ps, dtype):
            assert dtype == torch.int8
            return 100

        def attach_inline(self, ps, dtype):
            attached_calls.append(self.r)
            self.nbr_vecs = self.nbr_norms = self.nbr_scale = object()

    monkeypatch.setattr(PBASE, "TREE_INLINE_BUDGET", 250)
    ps = types.SimpleNamespace(device=torch.device("meta"),
                               data=torch.empty(0, dtype=torch.float32))
    graphs = [Row(r) for r in range(4)]
    attached = set()
    PBASE.plan_row_inline(ps, graphs, attached, np.array([0, 1, 2, 3]),
                          np.array([5, 9, 1, 7]))
    assert attached == {1, 3} and attached_calls == [1, 3]
    PBASE.plan_row_inline(ps, graphs, attached, np.array([0, 1, 2]),
                          np.array([8, 9, 1]))
    assert attached == {0, 1} and attached_calls == [1, 3, 0]
    assert graphs[3].nbr_vecs is None and graphs[1].nbr_vecs is not None
    cpu = types.SimpleNamespace(device=torch.device("cpu"), data=ps.data)
    PBASE.plan_row_inline(cpu, graphs, attached, np.array([2]), np.array([1]))
    assert attached == {0, 1}
    assert PBASE.TREE_INLINE_BUDGET == 250 and int(3.5e9) == 3_500_000_000


def test_port_built_tree_recall(gt_fn):
    """The port's own row builds: each row's edges stay inside their
    buckets, and the three methods reach the recall floor of
    tests/test_tree.py (> 0.85 at beam 40, final_beam_multiply 4)."""
    rng = np.random.default_rng(9)
    n = 1200
    points = rng.normal(size=(n, D)).astype(np.float32)
    labels = rng.uniform(size=n)
    tree = P.vamana_range_filter_tree_constructor("Euclidian", "float")(
        points, labels, cutoff=CUTOFF, split_factor=SPLIT,
        build_params=P.BuildParams(R=16, L=32, alpha=1.2, cache_path=""), device="cpu")
    assert len(tree._graphs) == 3
    for r, g in enumerate(tree._graphs):
        off = tree._offsets[r]
        bucket = np.searchsorted(off, np.arange(n), side="right") - 1
        src = np.repeat(np.arange(n), g.R)
        dst = g.nbrs_host.reshape(-1)
        ok = dst >= 0
        assert (bucket[src[ok]] == bucket[dst[ok]]).all()
        assert ok.reshape(n, g.R).sum(1).mean() > 4
    queries, filters = _queries(rng, 60)
    gt_ids, _ = gt_fn(points, labels, queries, filters, K, "l2")
    qp = P.build_query_params(K, 40, final_beam_multiply=4)
    for method in ("fenwick", "optimized_postfilter", "three_split"):
        ids, dists = tree.batch_search(queries, filters, 60, method, qp)
        assert recall(ids, dists, gt_ids) > 0.85, method


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.RangeFilterTreeIndex(np.eye(8, dtype=np.float32), np.arange(8.0),
                               cutoff=4, leaf="prefilter")


def test_suite_runs_torch_on_one_thread():
    """tests/torch_threads.py, imported first, gives the port's tests one
    torch thread: this file sets none of its own, and a Python process that
    a test starts, as test_tree_path_imports_no_jax starts one, inherits it."""
    assert torch.get_num_threads() == 1
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"


def test_tree_path_imports_no_jax():
    """Building and searching a CPU tree (native planners included) loads
    neither jax nor any module of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "import rangefilteredann_tpu_torch as P\n"
        "from rangefilteredann_tpu_torch import native\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.normal(size=(400, 8)).astype(np.float32)\n"
        "t = P.RangeFilterTreeIndex(x, rng.uniform(size=400), cutoff=200,"
        " build_params=P.BuildParams(R=8, L=16), device='cpu')\n"
        "for m in ('fenwick', 'optimized_postfilter', 'three_split'):\n"
        "    t.batch_search(x[:4], [(0.1, 0.9)] * 4, 4, m, P.build_query_params(3, 8))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rangefilteredann_tpu' or m.startswith('rangefilteredann_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
