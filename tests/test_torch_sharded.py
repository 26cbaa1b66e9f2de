"""The PyTorch port's scale-out (parallel/sharded.py) against the JAX package's.

The port's mesh is make_mesh(devices=["cpu"] * 8), eight logical shards on
the CPU; the JAX package's is make_mesh(8) over the conftest's eight host
devices. The same numpy-seeded inputs go through both: query-sharded beam
search, the index-sharded scan (windows across shard boundaries, windows
empty on most shards, windows shorter than k), PostfilterVamanaIndex.shard,
the bucket layout of shard_graph_row, sharded_bucket_search, the tree with
shard_rows=True (also against the port's unsharded tree), the doubling cap
with its exact tail, the device_rows_budget planner, the super tree's shard
and the dry run. The graphs are built once by the JAX package into a cache
directory and loaded by the port. Ids must match exactly, distances within
rtol 1e-5 / atol 1e-4, counters exactly.
"""

import numpy as np
import pytest
import torch

import rangefilteredann_tpu as J
import rangefilteredann_tpu_torch as P
from rangefilteredann_tpu.models import postfilter_vamana as JPV
from rangefilteredann_tpu.parallel import sharded as JSH
from rangefilteredann_tpu_torch.models import postfilter_vamana as PPV
from rangefilteredann_tpu_torch.models import range_filter_tree as PRFT
from rangefilteredann_tpu_torch.ops.beam_search import batched_beam_search
from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
from rangefilteredann_tpu_torch.ops.topk import EMPTY_ID
from rangefilteredann_tpu_torch.parallel import sharded as PSH
from rangefilteredann_tpu_torch.parallel.dryrun import dryrun_multidevice
from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries
from rangefilteredann_tpu_torch.utils.stats import QueryStats

from .test_beam_search import knn_graph

RTOL, ATOL = 1e-5, 1e-4
N, D, NQ = 2000, 16, 32
CUTOFF, SPLIT, SEED = 300, 3, 2  # rows of 1, 3 and 9 buckets
METHODS = ("fenwick", "optimized_postfilter", "three_split")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths are many small torch ops: one thread each keeps
    them from contending with the other test workers' threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bp(pkg, cache=""):
    return pkg.BuildParams(R=16, L=32, alpha=1.2, cache_path=cache)


def _qp(pkg, k=5, beam=16):
    return pkg.build_query_params(k, beam, final_beam_multiply=2)


def _meshes(n=8):
    return JSH.make_mesh(n), PSH.make_mesh(devices=["cpu"] * n)


def assert_same(want, got):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    wd, gd = np.asarray(want[1]), np.asarray(got[1])
    fin = np.isfinite(wd) & (wd < np.finfo(np.float32).max)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Data, a JAX-built flat graph and tree (rows cached; the tree's row 0
    loads the flat graph's cache) and one batch of mixed-width queries."""
    rng = np.random.default_rng(7)
    points = rng.normal(size=(N, D)).astype(np.float32)
    labels = rng.uniform(size=N)
    cache = str(tmp_path_factory.mktemp("graphs")) + "/"
    jflat = J.PostfilterVamanaIndex(points, labels, _bp(J, cache))
    J.RangeFilterTreeIndex(points, labels, cutoff=CUTOFF, split_factor=SPLIT,
                           build_params=_bp(J, cache), seed=SEED)
    queries = rng.normal(size=(NQ, D)).astype(np.float32)
    # windows that take every route of the three methods: fenwick covers
    # and fringes, doubling on a covering bucket of a sharded row and on
    # row 0, three_split's centres and sides (the cap test below takes the
    # narrow windows that double several times)
    widths = rng.choice([0.15, 0.3], size=NQ)
    lo = rng.uniform(0, 1, size=NQ) * (1 - widths)
    return dict(points=points, labels=labels, cache=cache, jflat=jflat,
                queries=queries, filters=np.stack([lo, lo + widths], 1))


def _jtree(s, **kw):
    return J.RangeFilterTreeIndex(s["points"], s["labels"], cutoff=CUTOFF,
                                  split_factor=SPLIT, build_params=_bp(J, s["cache"]),
                                  seed=SEED, require_cache=True, **kw)


def _ptree(s, **kw):
    return P.RangeFilterTreeIndex(s["points"], s["labels"], cutoff=CUTOFF,
                                  split_factor=SPLIT, build_params=_bp(P, s["cache"]),
                                  seed=SEED, require_cache=True, device="cpu", **kw)


def _search(tree, pkg, s, method, stats=None, **qkw):
    return tree.batch_search(s["queries"], s["filters"], NQ, method, _qp(pkg, **qkw),
                             stats=stats)


@pytest.fixture(scope="module")
def trees(shared):
    """The port's unsharded tree, and both packages' trees sharded with
    shard_rows=True over their 8-shard meshes."""
    jmesh, pmesh = _meshes()
    return dict(plain=_ptree(shared), j=_jtree(shared).shard(jmesh, shard_rows=True),
                p=_ptree(shared).shard(pmesh, shard_rows=True))


def test_make_mesh_needs_a_card_or_devices():
    mesh = PSH.make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.distinct == (torch.device("cpu"),)
    assert PSH.make_mesh(2, devices=["cpu"] * 4).size == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PSH.make_mesh()


def test_query_sharded_beam_search_matches_jax():
    rng = np.random.default_rng(0)
    n, d, nq = 512, 16, 60  # 60 queries: the last shards' chunks are short
    points = rng.normal(size=(n, d)).astype(np.float32)
    nbrs = knn_graph(points, 8)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    import jax.numpy as jnp
    from rangefilteredann_tpu.utils.data import make_pointset as jmake

    jps = jmake(points, "l2")
    pps = make_pointset(points, "l2", device="cpu")
    qpad = pad_queries(queries, d, pps.d_pad)
    qn = np.einsum("qd,qd->q", queries, queries)
    jmesh, pmesh = _meshes()
    want = JSH.sharded_beam_search(
        jmesh, jps.data, jps.norms_sq, jnp.asarray(nbrs), jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(np.pad(qpad, ((0, 4), (0, 0)))), jnp.zeros(nq + 4, jnp.int32),
        beam=16, k=10, cut=jnp.float32(1.35), limit=jnp.int32(n), metric="l2",
        q_norms_sq=jnp.asarray(np.pad(qn, (0, 4))))
    common = dict(beam=16, k=10, cut=1.35, limit=n, metric="l2",
                  q_norms_sq=torch.from_numpy(qn))
    args = (pps.data, pps.norms_sq, torch.from_numpy(nbrs),
            torch.arange(n, dtype=torch.int32), torch.from_numpy(qpad),
            torch.zeros(nq, dtype=torch.int32))
    got = PSH.sharded_beam_search(pmesh, *args, **common)
    one = batched_beam_search(*args, **common)
    for f in ("frontier_ids", "num_visited", "dist_cmps"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f))[:nq], err_msg=f)
        assert torch.equal(getattr(got, f), getattr(one, f)), f
    assert_same((np.asarray(want.frontier_ids)[:nq], np.asarray(want.frontier_dists)[:nq]),
                (got.frontier_ids.numpy(), got.frontier_dists.numpy()))


def _scan_windows(kind, nq, n, rng, k):
    """[nq] windows over n points of a store cut in 8 shards of 512 rows."""
    edges = np.arange(1, 8) * 512
    if kind == "full":
        return np.zeros(nq, np.int64), np.full(nq, n, np.int64)
    if kind == "straddle":  # across one or more shard boundaries
        at = rng.choice(edges[edges < n - 40], size=nq)
        return at - rng.integers(1, 300, nq), np.minimum(at + rng.integers(1, 700, nq), n)
    if kind == "short":  # fewer rows than k, some of them across a boundary
        s = np.concatenate([rng.integers(0, n - k, nq - 8), edges[:4] - 2, edges[:4] - 1])
        return s, s + rng.integers(0, k, nq)
    if kind == "one_shard":  # empty on every shard but one, some empty
        s = rng.integers(0, n - 100, nq)
        s = s - s % 512 + rng.integers(0, 300, nq)
        return s, s + rng.integers(0, 200, nq)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["full", "straddle", "short", "one_shard"])
def test_index_sharded_scan_matches_jax(kind):
    import jax.numpy as jnp
    from rangefilteredann_tpu.utils.data import make_pointset as jmake

    rng = np.random.default_rng(3)
    n, d, nq, k = 3000, 16, 40, 10  # 4096 store rows: 8 shards of 512
    points = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    jps, pps = jmake(points, "l2"), make_pointset(points, "l2", device="cpu")
    qpad = pad_queries(queries, d, pps.d_pad)
    starts, ends = _scan_windows(kind, nq, n, rng, k)
    jmesh, pmesh = _meshes()
    wd, wi = JSH.sharded_scan_bruteforce(jmesh, jps.data, jps.norms_sq, jnp.asarray(qpad),
                                         starts.astype(np.int32), ends.astype(np.int32),
                                         k, "l2")
    gd, gi = PSH.sharded_scan_bruteforce(pmesh, pps.data, pps.norms_sq,
                                         torch.from_numpy(qpad), starts, ends, k, "l2")
    assert gi.dtype == torch.int32
    assert_same((np.asarray(wi), np.asarray(wd)), (gi.numpy(), gd.numpy()))
    od, oi = scan_bruteforce(pps.data, pps.norms_sq, torch.from_numpy(qpad),
                             torch.from_numpy(starts.astype(np.int32)),
                             torch.from_numpy(ends.astype(np.int32)), k, "l2")
    assert torch.equal(gi, oi)
    if kind == "short":
        assert (gi == EMPTY_ID).any(), "no window shorter than k"


def test_postfilter_shard_matches_jax(shared):
    s = shared
    jmesh, pmesh = _meshes()
    qp_j, qp_p = _qp(J, k=10, beam=16), _qp(P, k=10, beam=16)
    pidx = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, s["cache"]),
                                   require_cache=True, device="cpu")
    np.testing.assert_array_equal(pidx._graph.nbrs_host, s["jflat"]._graph.nbrs_host)
    plain = pidx.batch_search(s["queries"], s["filters"], NQ, qp_p)
    jstats, pstats = J.QueryStats(NQ), QueryStats(NQ)
    want = s["jflat"].shard(jmesh).batch_search(s["queries"], s["filters"], NQ, qp_j,
                                                stats=jstats)
    got = pidx.shard(pmesh).batch_search(s["queries"], s["filters"], NQ, qp_p,
                                         stats=pstats)
    assert_same(want, got)
    assert_same(plain, got)
    np.testing.assert_array_equal(pstats.visited, jstats.visited)
    np.testing.assert_array_equal(pstats.distances, jstats.distances)


@pytest.mark.parametrize("n_dev", [3, 8])
def test_shard_graph_row_layout_matches_jax(shared, n_dev):
    jtree, ptree = _jtree(shared), _ptree(shared)
    jmesh, pmesh = _meshes(n_dev)
    for r in range(1, len(ptree._offsets)):
        jrow = JSH.shard_graph_row(jtree._ps, jtree._graphs[r], jmesh)
        prow = PSH.shard_graph_row(ptree._ps, ptree._graphs[r], pmesh)
        assert prow.ms == jrow.ms == PSH.shard_plan_rows_per_device(ptree._graphs[r], n_dev)
        for f in ("bucket_device", "bucket_local_start", "local_to_global"):
            np.testing.assert_array_equal(getattr(prow, f), getattr(jrow, f), err_msg=f)
        for f in ("nbrs_sh", "points_sh", "norms_sh"):
            np.testing.assert_array_equal(torch.cat(getattr(prow, f)).numpy(),
                                          np.asarray(getattr(jrow, f)), err_msg=f)


def test_sharded_bucket_search_matches_jax(shared):
    jtree, ptree = _jtree(shared), _ptree(shared)
    jmesh, pmesh = _meshes()
    r, beam = 2, 12  # 9 buckets of 222-223 points
    rng = np.random.default_rng(4)
    buckets = rng.integers(0, len(ptree._offsets[r]) - 1, size=NQ)
    qpad = pad_queries(shared["queries"], D, ptree._ps.d_pad)
    jrow = JSH.shard_graph_row(jtree._ps, jtree._graphs[r], jmesh)
    prow = PSH.shard_graph_row(ptree._ps, ptree._graphs[r], pmesh)
    kw = dict(beam=beam, k=0, metric="l2", norm_col=ptree._ps.norm_col, return_stats=True)
    want = JSH.sharded_bucket_search(jrow, qpad, buckets, **kw)
    got = PSH.sharded_bucket_search(prow, qpad, buckets, **kw)
    assert_same(want[:2], got[:2])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    # the same searches on the unsharded row
    g = ptree._graphs[r]
    res = batched_beam_search(
        ptree._ps.data, ptree._ps.norms_sq, g.nbrs_dev, g.slab_to_global_dev,
        torch.from_numpy(qpad),
        torch.from_numpy(ptree._offsets[r][buckets].astype(np.int32)), beam=beam, k=0,
        cut=1.35, limit=N, metric="l2", norm_col=ptree._ps.norm_col, identity_map=True)
    np.testing.assert_array_equal(got[0], res.frontier_ids.numpy().astype(np.int64))
    np.testing.assert_array_equal(got[2], res.num_visited.numpy())


@pytest.mark.parametrize("method", METHODS)
def test_tree_shard_rows_matches_jax(shared, trees, method):
    assert sorted(trees["p"]._sharded) == sorted(trees["j"]._sharded) == [1, 2]
    jstats, pstats = J.QueryStats(NQ), QueryStats(NQ)
    want = _search(trees["j"], J, shared, method, stats=jstats)
    got = _search(trees["p"], P, shared, method, stats=pstats)
    assert_same(want, got)
    assert_same(_search(trees["plain"], P, shared, method), got)
    np.testing.assert_array_equal(pstats.visited, jstats.visited)
    np.testing.assert_array_equal(pstats.distances, jstats.distances)


def test_tree_shard_rows_doubling_cap_and_exact_tail(shared, trees, monkeypatch):
    """With MAX_SAFE_BEAM pinned low (in both packages) and narrow windows,
    the doubling on sharded rows exhausts the cap and takes the exact tail,
    as the unsharded path does. A beam below k (which the JAX package's
    sharded doubling does not take) is held against the unsharded port."""
    monkeypatch.setattr(JPV, "MAX_SAFE_BEAM", 32)
    monkeypatch.setattr(PPV, "MAX_SAFE_BEAM", 32)
    tails, sharded_tails = [], []
    real, real_doubling = PPV.batched_range_bruteforce, PRFT.doubling_postfilter

    def counted(*a, **kw):
        tails.append(len(a[3]))
        return real(*a, **kw)

    def doubling(ps, graph, *a, **kw):  # the tails taken on bucket-sharded rows
        n = len(tails)
        out = real_doubling(ps, graph, *a, **kw)
        if isinstance(graph, PSH.ShardedGraphRow):
            sharded_tails.extend(tails[n:])
        return out

    monkeypatch.setattr(PPV, "batched_range_bruteforce", counted)
    monkeypatch.setattr(PRFT, "doubling_postfilter", doubling)
    rng = np.random.default_rng(11)
    lo = rng.uniform(0, 0.9, size=NQ)
    s = dict(shared, filters=np.stack([lo, lo + 0.04], 1))
    assert _qp(P, beam=8).postfiltering_max_beam > 32  # the exact tail is reachable
    want = _search(trees["j"], J, s, "optimized_postfilter", beam=8)
    got = _search(trees["p"], P, s, "optimized_postfilter", beam=8)
    assert sharded_tails, "no query on a sharded row reached the exact tail"
    assert_same(want, got)
    assert_same(_search(trees["plain"], P, s, "optimized_postfilter", beam=8), got)
    assert_same(_search(trees["plain"], P, s, "optimized_postfilter", k=10, beam=4),
                _search(trees["p"], P, s, "optimized_postfilter", k=10, beam=4))


def test_tree_device_rows_budget_matches_jax(shared):
    """device_rows_budget is a per-device budget over all rows: rows each
    below it but jointly above shard, the largest first; the residency is
    pinned afterwards and the counters match the JAX package's."""
    budget = 250_000  # a row's adjacency: 2000 x 17 x 4 = 136 kB
    jmesh, pmesh = _meshes()
    jtree = _jtree(shared, device_rows_budget=budget).shard(jmesh, shard_rows=True)
    ptree = _ptree(shared, device_rows_budget=budget).shard(pmesh, shard_rows=True)
    assert sorted(ptree._sharded) == sorted(jtree._sharded)
    assert ptree._sharded and 0 not in ptree._sharded
    assert ptree._res.budget is None
    jstats, pstats = J.QueryStats(NQ), QueryStats(NQ)
    want = _search(jtree, J, shared, "fenwick", stats=jstats)
    got = _search(ptree, P, shared, "fenwick", stats=pstats)
    assert_same(want, got)
    assert pstats.visited.sum() > 0
    np.testing.assert_array_equal(pstats.visited, jstats.visited)
    np.testing.assert_array_equal(pstats.distances, jstats.distances)


def test_super_tree_shard_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    n, nq = 400, 16
    points = rng.normal(size=(n, D)).astype(np.float32)
    labels = rng.uniform(size=n)
    queries = rng.normal(size=(nq, D)).astype(np.float32)
    lo = rng.uniform(0, 0.7, size=nq)
    filters = np.stack([lo, lo + rng.choice([0.1, 0.3], size=nq)], 1)
    cache = str(tmp_path) + "/"
    kw = dict(cutoff=200, split_factor=2.0, shift_factor=0.5, seed=SEED)  # 2 rows
    jtree = J.SuperOptimizedPostfilterTree(points, labels, build_params=_bp(J, cache), **kw)
    ptree = P.SuperOptimizedPostfilterTree(points, labels, build_params=_bp(P, cache),
                                           require_cache=True, device="cpu", **kw)
    plain = ptree.batch_search(queries, filters, nq, _qp(P))
    jmesh, pmesh = _meshes()
    jstats, pstats = J.QueryStats(nq), QueryStats(nq)
    want = jtree.shard(jmesh).batch_search(queries, filters, nq, _qp(J), stats=jstats)
    got = ptree.shard(pmesh).batch_search(queries, filters, nq, _qp(P), stats=pstats)
    assert_same(want, got)
    assert_same(plain, got)
    np.testing.assert_array_equal(pstats.visited, jstats.visited)
    np.testing.assert_array_equal(pstats.distances, jstats.distances)


def test_dryrun_multidevice():
    dryrun_multidevice(8, devices=["cpu"] * 8)
