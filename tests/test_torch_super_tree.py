"""The PyTorch port's SuperOptimizedPostfilterTree against the JAX package's.

The JAX package builds one super tree per module (n = 2000, d = 24, labels
on a grid of 400 values, cutoff 300, split 2.0, shift 0.5, R = 20, L = 40)
with its row caches in a temporary directory. Its rows after row 0 build
padded (`pad_rows`, `insert_pad`) and are cached unpadded; the port, which
has neither option, loads the same caches (same names, same fingerprint)
and both packages search them: ids must match exactly, distances within
rtol 1e-5 / atol 1e-4, search counters exactly, at filter fractions 2^-8,
2^-4, 2^-2 and 0.5 and at bounds on label values, with the native router
and with the Python one. On the CPU no row carries inline blocks (as in the
JAX package); a test attaches them to reach the beam kernel's route.
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
from rangefilteredann_tpu import native as jnative
from rangefilteredann_tpu.models import super_postfilter_tree as JSPT
from rangefilteredann_tpu_torch import native as pnative
from rangefilteredann_tpu_torch.models import base as PBASE
from rangefilteredann_tpu_torch.models import postfilter_vamana as PPV
from rangefilteredann_tpu_torch.models import super_postfilter_tree as PSPT
from rangefilteredann_tpu_torch.utils.data import first_geq
from rangefilteredann_tpu_torch.utils.stats import QueryStats

from .torch_native_bridge import load_reference_bridge

RTOL, ATOL = 1e-5, 1e-4
N, D, K = 2000, 24, 10
CUTOFF, SPLIT, SHIFT, SEED = 300, 2.0, 0.5, 5
LABEL_VALUES = 400
FRACTIONS = (2.0**-8, 2.0**-4, 2.0**-2, 0.5)
N_FRAC, N_BOUND = 64, 16  # queries at FRACTIONS, then at label-value bounds
FLT_MAX = np.finfo(np.float32).max


def _bp(pkg, cache=""):
    return pkg.BuildParams(R=20, L=40, alpha=1.2, cache_path=cache)


def _qp(pkg, beam=20, fm=2):
    return pkg.build_query_params(K, beam, final_beam_multiply=fm)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Data, a JAX-built super tree whose rows are cached, one batch of
    queries (fractions, label-value bounds, three empty windows) and the
    JAX tree's answers and counters on it."""
    rng = np.random.default_rng(2025)
    points = rng.normal(size=(N, D)).astype(np.float32)
    labels = rng.integers(0, LABEL_VALUES, size=N) / LABEL_VALUES
    cache = str(tmp_path_factory.mktemp("super_rows")) + "/"
    jtree = J.SuperOptimizedPostfilterTree(
        points, labels, cutoff=CUTOFF, split_factor=SPLIT, shift_factor=SHIFT,
        build_params=_bp(J, cache), seed=SEED)
    frac = np.asarray(FRACTIONS)[np.arange(N_FRAC) % len(FRACTIONS)]
    lo = rng.uniform(0, 1, size=N_FRAC) * (1 - frac)
    # bounds on label values: half on neighbouring values (the route holds
    # the points labelled lo alone), half on random pairs
    vals = np.unique(labels)
    first = rng.integers(0, len(vals) - 2, size=N_BOUND)
    second = np.where(np.arange(N_BOUND) < N_BOUND // 2, first + 1,
                      rng.integers(0, len(vals), size=N_BOUND))
    bounds = np.sort(np.stack([vals[first], vals[second]], axis=1), axis=1)
    bounds[bounds[:, 0] == bounds[:, 1], 1] = vals[-1]
    filters = np.concatenate([
        np.stack([lo, lo + frac], axis=1), bounds,
        [(5.0, 6.0), (0.5, 0.4), (vals[7], vals[7])]])  # three empty windows
    queries = rng.normal(size=(len(filters), D)).astype(np.float32)
    jstats = J.QueryStats(len(queries))
    want = jtree.batch_search(queries, filters, len(queries), _qp(J), stats=jstats)
    return dict(points=points, labels=labels, cache=cache, jtree=jtree,
                queries=queries, filters=filters, want=want, jstats=jstats)


def _port_tree(s, **kw):
    return P.SuperOptimizedPostfilterTree(
        s["points"], s["labels"], cutoff=CUTOFF, split_factor=SPLIT,
        shift_factor=SHIFT, build_params=_bp(P, s["cache"]), seed=SEED,
        require_cache=True, device="cpu", **kw)


def _search(tree, s, stats=None, beam=20, fm=2, sel=slice(None)):
    queries, filters = s["queries"][sel], s["filters"][sel]
    return tree.batch_search(queries, filters, len(queries), _qp(P, beam, fm),
                             stats=stats)


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


@pytest.fixture
def python_router():
    """The port without its native library: the Python router."""
    saved = pnative._lib, pnative._tried
    pnative._lib, pnative._tried = None, True
    yield
    pnative._lib, pnative._tried = saved


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("n,cutoff,split,shift", [
    (1000, 100, 2.0, 0.5), (997, 50, 3.0, 0.25), (5000, 1000, 2.0, 0.5),
    (64, 10, 2.5, 0.75), (200_000, 1000, 2.0, 0.5)])
def test_layout_helpers_match_jax(n, cutoff, split, shift):
    rows = PSPT.super_row_layout(n, cutoff, split, shift)
    assert rows == JSPT.super_row_layout(n, cutoff, split, shift)
    bp_p, bp_j = _bp(P), _bp(J)
    for r, row in enumerate(rows):
        got = PSPT.SuperOptimizedPostfilterTree._row_slab(n, *row)
        want = JSPT.SuperOptimizedPostfilterTree._row_slab(n, *row)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert (PSPT.super_row_cache_filename("c/", bp_p, 0.125, 0.75, n, split, shift,
                                              cutoff, r)
                == JSPT.super_row_cache_filename("c/", bp_j, 0.125, 0.75, n, split,
                                                 shift, cutoff, r))
    if n == 200_000:  # the card's configuration: slab sizes of its rows 1-8
        slabs = [int(PSPT.SuperOptimizedPostfilterTree._row_slab(n, *row)[0][-1])
                 for row in rows[1:]]
        assert slabs == [300_000, 350_000, 375_000, 387_500, 393_750, 396_812,
                         398_374, 399_410]


def test_layout_reference_example():
    """(ref: super_optimized_postfilter_tree.h:154-158, the example of
    tests/test_tree.py:34): n=20, size 3, shift 2 -> 10 buckets; every
    row's last bucket reaches the end and any range no wider than
    size - shift fits in one bucket."""
    offsets, s2g = PSPT.SuperOptimizedPostfilterTree._row_slab(20, 3, 2, 10)
    assert len(offsets) == 11 and s2g[-2:].tolist() == [18, 19]
    n = 1000
    rows = PSPT.super_row_layout(n, 100, 2.0, 0.5)
    tree = types.SimpleNamespace(_rows=rows, _ps=types.SimpleNamespace(n=n))
    for r, (bsize, bshift, nb) in enumerate(rows[1:], start=1):
        assert bshift <= bsize and (nb - 1) * bshift + bsize >= n
        w = bsize - bshift
        for lo in range(0, n - w + 1, 37):
            row, b = PSPT.SuperOptimizedPostfilterTree._route(tree, lo, lo + w)
            assert row >= r and b * rows[row][1] <= lo
            assert lo + w <= min(b * rows[row][1] + rows[row][0], n)


# --------------------------------------------------------------- routing
@pytest.mark.parametrize("n", [N, 200_000])
def test_routers_match_jax(n, python_router):
    """The port's Python `_route`, its native route_super_batch (the
    library is restored for that call) and the JAX `_route` and
    route_super_batch give the same rows and buckets; empty ranges stay
    on row -1 in the port's batched router."""
    rng = np.random.default_rng(n)
    rows = PSPT.super_row_layout(n, 1000 if n > N else CUTOFF, SPLIT, SHIFT)
    ptree = PSPT.SuperOptimizedPostfilterTree.__new__(PSPT.SuperOptimizedPostfilterTree)
    jtree = JSPT.SuperOptimizedPostfilterTree.__new__(JSPT.SuperOptimizedPostfilterTree)
    for t in (ptree, jtree):
        t._rows, t._ps = rows, types.SimpleNamespace(n=n)
    nq = 400
    lo = rng.integers(0, n, size=nq)
    width = (n * 2.0 ** -rng.uniform(0, 12, size=nq)).astype(np.int64)
    hi = np.minimum(lo + width, n)
    hi[:20] = lo[:20]  # empty
    hi[20:30] = np.maximum(lo[20:30] - 5, 0)  # inverted
    act = hi > lo
    py_rows, py_b = ptree._route_batch(lo, hi)
    assert (py_rows[~act] == -1).all() and (py_b[~act] == 0).all()
    j_pairs = np.array([jtree._route(int(a), int(b)) for a, b in zip(lo[act], hi[act])])
    np.testing.assert_array_equal(py_rows[act], j_pairs[:, 0])
    np.testing.assert_array_equal(py_b[act], j_pairs[:, 1])
    saved = pnative._lib, pnative._tried
    pnative._lib, pnative._tried = None, False
    try:
        load_reference_bridge()
        nat_rows, nat_b = ptree._route_batch(lo, hi)
        p_nat = pnative.route_super_batch(rows, n, lo[act], hi[act])
    finally:
        pnative._lib, pnative._tried = saved
    np.testing.assert_array_equal(nat_rows, py_rows)
    np.testing.assert_array_equal(nat_b, py_b)
    j_nat = jnative.route_super_batch(rows, n, lo[act], hi[act])
    for a, b in zip(p_nat, j_nat):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(py_rows[act])) >= 3


# ---------------------------------------------------------------- search
@pytest.mark.parametrize("router", ["native", "python"])
def test_super_tree_matches_jax(shared, router, request):
    s = shared
    if router == "python":
        request.getfixturevalue("python_router")
        assert not pnative.available()
    else:
        assert pnative.available()
    ptree = _port_tree(s)
    for pg, jg in zip(ptree._graphs, s["jtree"]._graphs):
        m = pg.m  # the JAX rows after row 0 are padded past the real slab
        np.testing.assert_array_equal(pg.nbrs_host, jg.nbrs_host[:m])
        assert (jg.nbrs_host[m:] == -1).all()
        np.testing.assert_array_equal(pg.slab_to_global_host,
                                      jg.slab_to_global_host[:m])
        np.testing.assert_array_equal(pg.bucket_slab_offsets, jg.bucket_slab_offsets)
        assert pg.identity_s2g == jg.identity_s2g
    assert ptree._graphs[1].m < s["jtree"]._graphs[1].m  # really unpadded
    pstats = QueryStats(len(s["queries"]))
    got = _search(ptree, s, stats=pstats)
    assert_same_results(s["want"], got)
    np.testing.assert_array_equal(pstats.visited, s["jstats"].visited)
    np.testing.assert_array_equal(pstats.distances, s["jstats"].distances)
    assert (got[1][:N_FRAC, 0] < FLT_MAX).all()


def test_label_value_bounds_route_exclusive_filter_inclusive(shared, monkeypatch):
    """Bounds on label values: the route takes [first_geq(lo), first_geq(hi))
    but the postfilter window ends at searchsorted(hi, "right"), so points
    labelled hi may be returned although they did not widen the route."""
    s = shared
    ptree = _port_tree(s)
    calls = []
    real = PSPT.doubling_postfilter

    def recording(ps, g, qpad, starts, win_lo, win_hi, qp, metric, **kw):
        calls.append((kw["q_rows"].copy(), win_lo.copy(), win_hi.copy()))
        return real(ps, g, qpad, starts, win_lo, win_hi, qp, metric, **kw)

    monkeypatch.setattr(PSPT, "doubling_postfilter", recording)
    sel = slice(N_FRAC, None)  # the label-value bounds and the empty windows
    ids, dists = _search(ptree, s, sel=sel)
    assert_same_results((s["want"][0][sel], s["want"][1][sel]), (ids, dists))
    ls = ptree._labels_sorted
    f = s["filters"][sel]
    lo_idx, hi_idx = first_geq(ls, f[:, 0]), first_geq(ls, f[:, 1])
    hi_incl = np.searchsorted(ls, f[:, 1], side="right")
    bound_q = np.arange(N_BOUND)
    assert (hi_incl[bound_q] > hi_idx[bound_q]).all()  # hi is a label value
    rows, buckets = ptree._route_batch(lo_idx, hi_idx)
    seen = np.zeros(len(f), dtype=bool)
    for q_rows, w_lo, w_hi in calls:
        np.testing.assert_array_equal(w_lo, lo_idx[q_rows])
        np.testing.assert_array_equal(w_hi, hi_incl[q_rows])
        seen[q_rows] = True
    np.testing.assert_array_equal(seen, hi_idx > lo_idx)
    assert not seen[-3:].any()
    on_hi = 0
    labels = s["labels"]
    for qi in bound_q:
        real_ = dists[qi] < FLT_MAX
        got = labels[ids[qi][real_].astype(np.int64)]
        assert ((got >= f[qi, 0]) & (got <= f[qi, 1])).all()
        on_hi += int((got == f[qi, 1]).sum())
        r, b = rows[qi], buckets[qi]
        b_lo = b * ptree._rows[r][1]
        assert b_lo <= lo_idx[qi] and hi_idx[qi] <= b_lo + ptree._rows[r][0]
    assert on_hi > 0


def test_empty_windows_pad_zero(shared):
    """Windows that hold no point under [lo, hi) (above every label, hi < lo,
    lo == hi on a label value) route nowhere and return only padding: id 0
    and FLT_MAX, as the JAX tree does (ref: range_filter_tree.h:84-93)."""
    s = shared
    ids, dists = _search(_port_tree(s), s, sel=slice(-3, None))
    for a in (ids, s["want"][0][-3:]):
        assert (a == 0).all()
    for a in (dists, s["want"][1][-3:]):
        assert (a == FLT_MAX).all()


def test_device_rows_budget_same_results(shared):
    """Rows kept on the device under an LRU budget of about one row: they
    start evicted, upload on route, and the results equal the fully
    resident trees' (the JAX tree's, which the resident port tree equals)."""
    s = shared
    one_row = int(3750 * 20 * 4 * 1.2)
    lazy = _port_tree(s, device_rows_budget=one_row)
    assert all(g.nbrs_dev is None for g in lazy._graphs)
    sel = slice(0, None, 2)
    assert_same_results((s["want"][0][sel], s["want"][1][sel]), _search(lazy, s, sel=sel))
    resident = [g for g in lazy._graphs if g.nbrs_dev is not None]
    assert 1 <= len(resident) < len(lazy._graphs)
    assert sum(g.device_bytes() for g in resident) <= one_row


def test_inline_blocks_take_the_kernel_route(shared, gt_fn, monkeypatch):
    """With int8 blocks and a scale on every row (what plan_row_inline
    attaches on the card), every search goes through the beam kernel's
    wrapper (on CPU tensors, its plain version), the top k + 8 is reranked
    exactly, and recall stays within 0.02 of the route without blocks."""
    s = shared
    ptree = _port_tree(s)
    sel = slice(0, N_FRAC, 4)
    gt_ids, _ = gt_fn(s["points"], s["labels"], s["queries"][sel],
                      s["filters"][sel], K, "l2")
    ids0, d0 = _search(ptree, s, beam=40, fm=4, sel=sel)
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
    ids1, d1 = _search(ptree, s, beam=40, fm=4, sel=sel)
    assert calls["kernel"] >= 1 and calls["plain"] == 0
    r0, r1 = recall(ids0, d0, gt_ids), recall(ids1, d1, gt_ids)
    assert r0 > 0.85 and r1 >= r0 - 0.02, (r1, r0)
    same = ids1 == ids0
    np.testing.assert_allclose(d1[same], d0[same], rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- build
def test_port_built_super_tree_recall(gt_fn):
    """The port's own row builds: each row's edges stay inside their
    buckets' slab ranges, and the tree reaches the recall floor of
    tests/test_tree.py:157 (> 0.85 at beam 40, final_beam_multiply 4)."""
    rng = np.random.default_rng(9)
    n = 1200
    points = rng.normal(size=(n, D)).astype(np.float32)
    labels = rng.uniform(size=n)
    tree = P.super_optimized_postfilter_tree_constructor("Euclidian", "float")(
        points, labels, cutoff=CUTOFF, split_factor=SPLIT, shift_factor=SHIFT,
        build_params=P.BuildParams(R=16, L=32, alpha=1.2, cache_path=""), device="cpu")
    assert [g.m for g in tree._graphs] == [1200, 1800, 2100]
    for g in tree._graphs:
        off = g.bucket_slab_offsets
        bucket = np.searchsorted(off, np.arange(g.m), side="right") - 1
        src = np.repeat(np.arange(g.m), g.R)
        dst = g.nbrs_host.reshape(-1)
        ok = dst >= 0
        assert (bucket[src[ok]] == bucket[dst[ok]]).all()
        assert ok.reshape(g.m, g.R).sum(1).mean() > 4
    nq = 40
    queries = rng.normal(size=(nq, D)).astype(np.float32)
    frac = np.array([2.0**-6, 2.0**-3, 0.25, 0.9])[np.arange(nq) % 4]
    lo = rng.uniform(0, 1, size=nq) * (1 - frac)
    filters = np.stack([lo, lo + frac], axis=1)
    gt_ids, _ = gt_fn(points, labels, queries, filters, K, "l2")
    ids, dists = tree.batch_search(queries, filters, nq,
                                   P.build_query_params(K, 40, final_beam_multiply=4))
    assert recall(ids, dists, gt_ids) > 0.85


def test_validation_errors():
    """(tests/test_tree.py:171)"""
    x = np.zeros((100, 4), dtype=np.float32)
    labels = np.linspace(0, 1, 100)
    for kw in ({"split_factor": 1.0}, {"shift_factor": 1.5}, {"shift_factor": 0.0}):
        with pytest.raises(ValueError):
            P.SuperOptimizedPostfilterTree(x, labels, device="cpu", **kw)


def test_row0_loads_whole_dataset_cache(shared, tmp_path):
    """Row 0 is the flat postfilter graph's build: without a row-0 file the
    tree loads the whole-dataset cache (vamana_*.npz) and writes nothing
    (tests/test_tree.py:321); without either it raises under
    require_cache."""
    s = shared
    cache = str(tmp_path) + "/"
    for f in os.listdir(s["cache"]):
        if not f.endswith("_row0.npz"):
            shutil.copy(os.path.join(s["cache"], f), cache)
    canon = PBASE.whole_dataset_cache(cache, _bp(P, cache), float(s["labels"].min()),
                                      float(s["labels"].max()), N)
    assert os.path.exists(canon)
    before = sorted(os.listdir(cache))
    ptree = P.SuperOptimizedPostfilterTree(
        s["points"], s["labels"], cutoff=CUTOFF, split_factor=SPLIT,
        shift_factor=SHIFT, build_params=_bp(P, cache), require_cache=True,
        device="cpu")
    np.testing.assert_array_equal(ptree._graphs[0].nbrs_host,
                                  s["jtree"]._graphs[0].nbrs_host)
    assert ptree._graphs[0].identity_s2g
    assert sorted(os.listdir(cache)) == before
    flat = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, cache),
                                   require_cache=True, device="cpu")
    np.testing.assert_array_equal(flat._graph.nbrs_host, ptree._graphs[0].nbrs_host)
    os.remove(canon)
    with pytest.raises(FileNotFoundError):
        P.SuperOptimizedPostfilterTree(
            s["points"], s["labels"], cutoff=CUTOFF, split_factor=SPLIT,
            shift_factor=SHIFT, build_params=_bp(P, cache), require_cache=True,
            device="cpu")


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.SuperOptimizedPostfilterTree(np.eye(8, dtype=np.float32), np.arange(8.0),
                                       cutoff=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.VamanaIndex.from_arrays(np.eye(8, dtype=np.float32),
                                  np.zeros((8, 2), dtype=np.int32))


def test_new_modules_import_no_jax(tmp_path):
    """The super tree, VamanaIndex, utils/io, filters, the window_ann names
    and the command line, driven on the CPU, load neither jax nor any
    module of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "import rangefilteredann_tpu_torch as P\n"
        "from rangefilteredann_tpu_torch import cli, filters, window_ann\n"
        "from rangefilteredann_tpu_torch.utils import io\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.normal(size=(300, 8)).astype(np.float32)\n"
        "t = window_ann.SuperOptimizedPostfilterTreeIndexFloatEuclidian(x,"
        " rng.uniform(size=300), cutoff=400, build_params=P.BuildParams(R=8, L=16),"
        " device='cpu')\n"
        "t.batch_search(x[:4], [(0.1, 0.9)] * 4, 4, P.build_query_params(3, 8))\n"
        f"d = {str(tmp_path)!r}\n"
        "io.write_vector_file(d + '/x.bin', x)\n"
        "io.write_graph_file(d + '/g.bin', t._graphs[0].nbrs_host)\n"
        "P.VamanaIndex(d + '/g.bin', d + '/x.bin', device='cpu').batch_search(x[:4], 4, 3, 8)\n"
        "filters.csr_filters.from_arrays(np.array([0, 1]), np.array([0]), 1)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rangefilteredann_tpu' or m.startswith('rangefilteredann_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
