"""The PyTorch port's PostfilterVamanaIndex and Vamana build against the JAX
package's.

A graph the JAX package builds (n = 3000, d = 24, R = 32, L = 64, once per
module) is loaded into the port through its `.npz` cache (same name, same
fingerprint) and through convert.py; both packages then search it: ids must
match exactly, distances within rtol 1e-5 / atol 1e-4. The port's own builds
are held to the structural checks and recall thresholds of
tests/test_vamana.py, to the reverse-edge group-by oracle, and to an
identical graph after a checkpoint/resume.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rangefilteredann_tpu as J
import rangefilteredann_tpu_torch as P
from rangefilteredann_tpu.models import postfilter_vamana as JPV
from rangefilteredann_tpu.models import vamana as JV
from rangefilteredann_tpu_torch import convert
from rangefilteredann_tpu_torch.models import base as PBASE
from rangefilteredann_tpu_torch.models import postfilter_vamana as PPV
from rangefilteredann_tpu_torch.models import vamana as PV
from rangefilteredann_tpu_torch.ops import beam as PBEAM
from rangefilteredann_tpu_torch.ops.robust_prune import robust_prune
from rangefilteredann_tpu_torch.utils.data import (
    device_labels, first_geq, make_pointset, pad_queries)
from rangefilteredann_tpu_torch.utils.stats import QueryStats

RTOL, ATOL = 1e-5, 1e-4
N, D, K = 3000, 24, 10


def _bp(pkg, cache_path=""):
    return pkg.BuildParams(R=32, L=64, alpha=1.2, cache_path=cache_path)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Data, and a JAX-built graph written to its cache."""
    rng = np.random.default_rng(2024)
    points = rng.normal(size=(N, D)).astype(np.float32)
    labels = rng.uniform(size=N)
    cache = str(tmp_path_factory.mktemp("graphs")) + "/"
    jidx = JPV.PostfilterVamanaIndex(points, labels, _bp(J, cache))
    nq = 64
    queries = rng.normal(size=(nq, D)).astype(np.float32)
    # windows of 1/2 and 1/4 of the labels (a start beam of 20 leaves about
    # half of the queries short of k, so they double), and one whose hi is
    # a label (inclusive there)
    width = rng.choice([0.5, 0.25], size=nq)
    lo = rng.uniform(0, 1, size=nq) * (1 - width)
    filters = np.stack([lo, lo + width], axis=1)
    ls = np.sort(labels)
    filters[0] = (ls[100], ls[900])
    s = dict(points=points, labels=labels, cache=cache, jidx=jidx,
             queries=queries, filters=filters, jstats=J.QueryStats(nq))
    s["want"] = _search(jidx, J, s, stats=s["jstats"])  # the reference results
    return s


def assert_same_results(want, got):
    wi, wd = want
    gi, gd = got
    assert gi.dtype == np.uint32 and gd.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


def _search(idx, pkg, s, beam=20, final_beam_multiply=2, stats=None, **kw):
    qp = pkg.build_query_params(K, beam, final_beam_multiply=final_beam_multiply,
                                **kw)
    return idx.batch_search(s["queries"], s["filters"], len(s["queries"]), qp,
                            stats=stats)


def test_jax_graph_loads_into_the_port(shared):
    """The JAX-written cache loads under the same name and fingerprint, and
    the adjacency carried across by convert.py is the same graph."""
    s, jidx = shared, shared["jidx"]
    want = np.asarray(jidx._graph.nbrs_host)
    pidx = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, s["cache"]),
                                   require_cache=True, device="cpu")
    np.testing.assert_array_equal(pidx._graph.nbrs_host, want)
    assert pidx._graph.nbrs_dev.dtype == torch.int32
    np.testing.assert_array_equal(pidx._fp, jidx._fp)
    fname = pidx._cache_file(_bp(P, s["cache"]))
    assert fname == jidx._cache_file(_bp(J, s["cache"]), N)
    g = convert.load_graph_cache(fname, jidx._fp, device="cpu")
    np.testing.assert_array_equal(g.nbrs_dev.numpy(), want)
    with pytest.warns(UserWarning, match="fingerprint"):
        assert convert.load_graph_cache(fname, jidx._fp + 1, device="cpu") is None
    ps = jidx._ps
    fidx = P.PostfilterVamanaIndex.from_arrays(
        np.asarray(ps.data), np.asarray(ps.norms_sq), ps.n, ps.d, ps.metric,
        ps.norm_col, jidx._labels_sorted, jidx._decoding, want, device="cpu")
    assert_same_results(s["want"], _search(fidx, P, s))
    assert_same_results(s["want"], _search(pidx, P, s))


@pytest.mark.parametrize("metric", ["Euclidian", "mips"])
@pytest.mark.parametrize("start", ["zero", "medoid"])
def test_batch_search_matches_jax(shared, metric, start):
    s = shared
    jidx = JPV.PostfilterVamanaIndex(s["points"], s["labels"], _bp(J, s["cache"]),
                                     metric=metric, require_cache=True,
                                     start_point=start)
    pidx = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, s["cache"]),
                                   metric=metric, require_cache=True,
                                   start_point=start, device="cpu")
    assert pidx._start == jidx._start
    want = (s["want"] if (metric, start) == ("Euclidian", "zero")
            else _search(jidx, J, s))
    got = _search(pidx, P, s)
    assert_same_results(want, got)
    assert (got[1][:, 0] < np.finfo(np.float32).max).any()


def test_speculative_finals_keep_jax_counters(shared):
    """The speculative final searches change only when the final searches
    run: results equal the JAX package's, counters included."""
    s = shared
    nq = len(s["queries"])
    pidx = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, s["cache"]),
                                   require_cache=True, device="cpu")
    stats = QueryStats(nq)
    got = _search(pidx, P, s, stats=stats)
    assert_same_results(s["want"], got)
    np.testing.assert_array_equal(stats.visited, s["jstats"].visited)
    np.testing.assert_array_equal(stats.distances, s["jstats"].distances)
    assert stats.visited.min() > 0


def test_inline_blocks_take_the_kernel_route(shared, monkeypatch):
    """With inline blocks attached (as on the card), every query-mode search
    goes through the kernel's wrapper, whose CPU path is the plain version,
    and the results equal the JAX package's inline search. int8-quantized
    blocks add the exact rerank of k + RERANK_SLACK candidates: exact
    distances, and ids close to the fp32 search's."""
    s = shared
    jidx = JPV.PostfilterVamanaIndex(s["points"], s["labels"], _bp(J, s["cache"]),
                                     require_cache=True)
    pidx = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, s["cache"]),
                                   require_cache=True, device="cpu")
    assert pidx._graph.nbr_vecs is None  # maybe_attach_inline: CPU no-op
    jidx._graph.attach_inline(jidx._ps)
    pidx._graph.attach_inline(pidx._ps)
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
    launches = PBEAM.BEAM_LAUNCHES
    got = _search(pidx, P, s)
    assert calls["kernel"] >= 2 and calls["plain"] == 0
    assert PBEAM.BEAM_LAUNCHES == launches  # CPU tensors launch nothing
    assert_same_results(_search(jidx, J, s), got)

    pidx._graph.attach_inline(pidx._ps, torch.int8)
    assert pidx._graph.nbr_scale is not None
    qi, qd = _search(pidx, P, s)
    overlap = np.mean([len(set(qi[i]) & set(got[0][i])) / K for i in range(len(qi))])
    assert overlap > 0.9, overlap
    same = qi == got[0]
    np.testing.assert_allclose(qd[same], got[1][same], rtol=RTOL, atol=ATOL)


def test_beam_at_clamp_still_searches(shared, monkeypatch):
    """A beamSize above MAX_SAFE_BEAM still runs one search at the clamp
    (tests/test_vamana.py::test_postfilter_beam_at_clamp_still_searches)."""
    s = shared
    monkeypatch.setattr(JPV, "MAX_SAFE_BEAM", 32)
    monkeypatch.setattr(PPV, "MAX_SAFE_BEAM", 32)
    pidx = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, s["cache"]),
                                   require_cache=True, device="cpu")
    want = _search(s["jidx"], J, s, beam=64, final_beam_multiply=4)
    got = _search(pidx, P, s, beam=64, final_beam_multiply=4)
    assert_same_results(want, got)
    wide = s["filters"][:, 1] - s["filters"][:, 0] >= 0.25
    assert (got[1][wide, 0] < np.finfo(np.float32).max).all()


def test_exact_tail_beyond_safe_beam(shared, monkeypatch, gt_fn):
    """Queries whose doubling exhausts MAX_SAFE_BEAM take the exact scan of
    their window (tests/test_vamana.py::test_postfilter_exact_tail_beyond_safe_beam)."""
    s = shared
    monkeypatch.setattr(JPV, "MAX_SAFE_BEAM", 16)
    monkeypatch.setattr(PPV, "MAX_SAFE_BEAM", 16)
    pidx = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, s["cache"]),
                                   require_cache=True, device="cpu")
    rng = np.random.default_rng(5)
    nq = 24
    queries = rng.normal(size=(nq, D)).astype(np.float32)
    lo = rng.uniform(0.05, 0.9, size=nq)
    filters = np.stack([lo, lo + (K - 2) / N], axis=1)  # ~8 points a window
    qp = dict(final_beam_multiply=2)
    got = pidx.batch_search(queries, filters, nq, P.build_query_params(K, 10, **qp))
    want = s["jidx"].batch_search(queries, filters, nq, J.build_query_params(K, 10, **qp))
    assert_same_results(want, got)
    gt_ids, _ = gt_fn(s["points"], s["labels"], queries, filters, K, "l2")
    ids, dists = got
    for i in range(nq):
        real = dists[i] < np.finfo(np.float32).max
        assert set(ids[i][real].astype(int)) == set(gt_ids[i][gt_ids[i] >= 0])
    # with the caller's cap equal to the clamp, no tail runs
    qp2 = dict(final_beam_multiply=2, postfiltering_max_beam=16)
    assert_same_results(
        s["jidx"].batch_search(queries, filters, nq, J.build_query_params(K, 10, **qp2)),
        pidx.batch_search(queries, filters, nq, P.build_query_params(K, 10, **qp2)))


WINDOW_CASES = ["ties", "nan_labels", "nan_filters", "inf", "outside", "reversed"]


def window_case(case):
    """(sorted labels, [nq, 2] filters) for one case of the window search."""
    rng = np.random.default_rng(31)
    labels = np.sort(np.round(rng.uniform(size=300), 2))  # ties at every 0.01
    lo = rng.uniform(-0.05, 1.05, 40)
    f = {
        "ties": np.stack([labels[0:296:8], labels[4:300:8]], 1),
        "nan_labels": np.stack([lo, lo + 0.3], 1),
        "nan_filters": np.array([[np.nan, 0.5], [0.2, np.nan], [np.nan, np.nan]]),
        "inf": np.array([[-np.inf, np.inf], [-np.inf, 0.4], [0.6, np.inf],
                         [np.inf, np.inf], [-np.inf, -np.inf]]),
        "outside": np.array([[-2.0, -1.0], [1.5, 3.0], [-1.0, 3.0], [0.5, 9.0]]),
        "reversed": np.stack([lo + 0.2, lo], 1),
    }[case]
    if case in ("nan_labels", "nan_filters", "inf"):  # NaN labels sort last
        labels = np.concatenate([labels, [np.nan] * 4])
    return labels, f


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_closed_windows_match_numpy(case):
    """The device window search equals the three numpy searches it
    replaces, np.maximum(first_geq(hi), searchsorted(hi, "right")) for the
    end, on labels with ties and a NaN tail: NaN, infinite, out-of-range
    and reversed filters included."""
    labels, f = window_case(case)
    lo, hi = PPV.closed_windows(device_labels(labels, "cpu"), len(labels),
                                torch.from_numpy(f))
    assert lo.dtype == hi.dtype == torch.int64
    np.testing.assert_array_equal(lo.numpy(), first_geq(labels, f[:, 0]))
    np.testing.assert_array_equal(hi.numpy(), np.maximum(
        first_geq(labels, f[:, 1]), np.searchsorted(labels, f[:, 1], side="right")))


@pytest.mark.parametrize("rows", ["repeated", "identity", "subset"])
@pytest.mark.parametrize("tail", [False, True])
def test_doubling_on_task_rows_matches_jax(shared, monkeypatch, rows, tail):
    """doubling_postfilter over tensors on the store's device, one query row
    a task (q_dev[rows], as the trees pass them), gives the JAX package's
    ids, distances and stats from its host arrays and q_rows: with rows
    repeated and reordered, every row once, or a strict subset, and with
    the exact tail, whose host windows are fetched only there."""
    s = shared
    if tail:
        monkeypatch.setattr(JPV, "MAX_SAFE_BEAM", 16)
        monkeypatch.setattr(PPV, "MAX_SAFE_BEAM", 16)
    jidx = s["jidx"]
    pidx = P.PostfilterVamanaIndex(s["points"], s["labels"], _bp(P, s["cache"]),
                                   require_cache=True, device="cpu")
    rng = np.random.default_rng(9)
    nq = len(s["queries"])
    q_rows = {"repeated": rng.integers(0, nq, 48), "identity": np.arange(nq),
              "subset": np.sort(rng.choice(nq, 40, replace=False))}[rows]
    qpad = pad_queries(s["queries"], D, pidx._ps.d_pad)
    f = s["filters"][q_rows]
    lo = first_geq(pidx._labels_sorted, f[:, 0])
    hi = np.searchsorted(pidx._labels_sorted, f[:, 1], side="right")
    starts = np.full(len(q_rows), pidx._start, dtype=np.int32)
    q_norms = np.einsum("qd,qd->q", s["queries"], s["queries"])[q_rows]

    tails = []
    real_tail = PPV.batched_range_bruteforce
    monkeypatch.setattr(PPV, "batched_range_bruteforce",
                        lambda *a, **kw: tails.append(1) or real_tail(*a, **kw))
    want_stats, got_stats = J.QueryStats(nq), QueryStats(nq)
    want = JPV.doubling_postfilter(
        jidx._ps, jidx._graph, qpad, q_norms, starts, lo, hi,
        J.build_query_params(K, 10, final_beam_multiply=2), "l2",
        stats=want_stats, stat_ids=q_rows, q_rows=q_rows)
    q_dev, st, wl, wh, r = PBASE.to_device(pidx._ps.device, qpad, starts, lo, hi, q_rows)
    got = PPV.doubling_postfilter(
        pidx._ps, pidx._graph, q_dev[r], st, wl, wh,
        P.build_query_params(K, 10, final_beam_multiply=2), "l2",
        stats=got_stats, stat_ids=q_rows)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_stats.visited, want_stats.visited)
    np.testing.assert_array_equal(got_stats.distances, want_stats.distances)
    assert got_stats.visited[q_rows].min() > 0
    assert len(tails) == (1 if tail else 0)  # the exact scan ran


@pytest.fixture(scope="module")
def port_built(shared):
    return P.PostfilterVamanaIndex(shared["points"], shared["labels"], _bp(P),
                                   device="cpu")


def test_port_build_structure_and_recall(shared, port_built, gt_fn):
    """The port's own build: degree bound, no self-edges, distance-sorted
    rows; unfiltered recall > 0.9 and filtered recall > 0.85, the thresholds
    of tests/test_vamana.py."""
    s, g = shared, port_built._graph
    assert ((g.nbrs_host >= 0).sum(axis=1) <= 32).all()
    assert not (g.nbrs_host == np.arange(N)[:, None]).any()
    np.testing.assert_array_equal(g.degrees, (g.nbrs_host >= 0).sum(axis=1))
    np.testing.assert_array_equal(g.nbrs_dev.numpy(), g.nbrs_host)
    assert (g.nbrs_host >= 0).sum(axis=1).mean() > 8
    rng = np.random.default_rng(8)
    nq = 100
    queries = rng.normal(size=(nq, D)).astype(np.float32)
    for width, beam, fm, floor in ((2.0, 60, 1, 0.9), (0.25, 40, 4, 0.85)):
        lo = rng.uniform(0, 1 - min(width, 1.0), size=nq) - (width > 1)
        filters = np.stack([lo, lo + width], axis=1)
        ids, _ = port_built.batch_search(
            queries, filters, nq, P.build_query_params(K, beam, final_beam_multiply=fm))
        gt_ids, _ = gt_fn(s["points"], s["labels"], queries, filters, K, "l2")
        recall = np.mean([
            len(set(ids[i].astype(int)) & set(gt_ids[i][gt_ids[i] >= 0]))
            / max((gt_ids[i] >= 0).sum(), 1) for i in range(nq)])
        assert recall > floor, (width, recall)


def test_multibucket_build_stays_in_buckets():
    rng = np.random.default_rng(12)
    n = 1200
    ps = make_pointset(rng.normal(size=(n, 16)).astype(np.float32), "l2", device="cpu")
    offsets = np.array([0, 300, 600, 900, 1200])
    g = PV.build_vamana_graph(ps, np.arange(n, dtype=np.int64), offsets,
                              P.BuildParams(R=16, L=32, alpha=1.2), seed=2)
    bucket_of = np.searchsorted(offsets, np.arange(n), side="right") - 1
    rows = np.repeat(np.arange(n), g.R)
    flat = g.nbrs_host.reshape(-1)
    ok = flat >= 0
    assert (bucket_of[rows[ok]] == bucket_of[flat[ok]]).all()
    deg = (g.nbrs_host >= 0).sum(1)
    for b in range(4):
        assert deg[offsets[b]:offsets[b + 1]].mean() > 4


def test_schedule_helpers_match_jax():
    for m in (1, 2, 7, 300, 3000, 200_000):
        assert PV._batch_schedule(m) == JV._batch_schedule(m)
    offsets = np.array([0, 300, 700, 1500])
    assert PV.max_step_insert(offsets) == JV.max_step_insert(offsets)
    assert PBASE.INLINE_BUDGET == J.models.base.INLINE_BUDGET


def test_reverse_edges_match_groupby_oracle():
    """The reverse-edge bookkeeping (stable sort by target, segmented ranks,
    bounded appends, overfull re-prune) against a NumPy group-by-key oracle
    (tests/test_vamana.py::test_reverse_edges_match_groupby_oracle)."""
    rng = np.random.default_rng(21)
    n, R, mp, rev_cap = 300, 6, 64, 16
    ps = make_pointset(rng.normal(size=(n, 8)).astype(np.float32), "l2", device="cpu")
    s2g = torch.arange(n, dtype=torch.int32)
    nbrs = np.full((n, R), -1, dtype=np.int32)
    for i in range(n):
        deg = rng.integers(0, R + 1)
        if deg:
            nbrs[i, :deg] = rng.choice(n, size=deg, replace=False)
    degrees = (nbrs >= 0).sum(axis=1).astype(np.int32)
    ins = rng.choice(n, size=mp, replace=False).astype(np.int32)
    new_out = np.full((mp, R), -1, dtype=np.int32)
    for i in range(mp):
        deg = rng.integers(1, R + 1)
        new_out[i, :deg] = rng.choice(n, size=deg, replace=False)

    got_n, got_d = torch.from_numpy(nbrs.copy()), torch.from_numpy(degrees.copy())
    PV._apply_reverse_edges(got_n, got_d, ps.data, ps.norms_sq, s2g,
                            torch.from_numpy(ins), torch.from_numpy(new_out), 1.1,
                            R=R, metric="l2", chunk=16, rev_cap=rev_cap,
                            norm_col=ps.norm_col)

    want_n, want_d = nbrs.copy(), degrees.copy()
    u, v = np.repeat(ins, R), new_out.reshape(-1)
    u, v = u[v >= 0], v[v >= 0]
    order = np.argsort(v, kind="stable")
    u, v = u[order], v[order]
    n_over = 0
    for tgt, s0, c in zip(*np.unique(v, return_index=True, return_counts=True)):
        srcs = u[s0:s0 + c]
        if want_d[tgt] + c <= R:
            want_n[tgt, want_d[tgt]:want_d[tgt] + c] = srcs
            want_d[tgt] += c
        else:
            n_over += 1
            cand = np.full((1, rev_cap), -1, dtype=np.int32)
            cand[0, :want_d[tgt]] = want_n[tgt, :want_d[tgt]]
            keep = srcs[:rev_cap - R]
            cand[0, R:R + len(keep)] = keep
            pruned, _ = robust_prune(ps.data, ps.norms_sq, s2g,
                                     torch.tensor([tgt], dtype=torch.int32),
                                     torch.from_numpy(cand), 1.1, R=R, metric="l2",
                                     norm_col=ps.norm_col)
            want_n[tgt] = pruned[0].numpy()
            want_d[tgt] = (want_n[tgt] >= 0).sum()
    assert n_over > 16  # more than one overfull chunk
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_n.numpy(), want_n)


def test_build_checkpoint_resume(tmp_path, monkeypatch):
    """A build stopped mid-loop and resumed from its step checkpoint gives
    exactly the graph of an uninterrupted build; a checkpoint of other
    inputs is ignored."""
    rng = np.random.default_rng(31)
    n = 900
    ps = make_pointset(rng.normal(size=(n, 16)).astype(np.float32), "l2", device="cpu")
    bp = P.BuildParams(R=16, L=32, alpha=1.2)
    s2g, offsets = np.arange(n, dtype=np.int64), np.array([0, n])
    ref = PV.build_vamana_graph(ps, s2g, offsets, bp, seed=7)

    ckpt = str(tmp_path / "g.ckpt.npz")
    monkeypatch.setattr(PV, "CKPT_SECS", 0.0)  # checkpoint every step
    real_step, calls = PV._insert_step, {"n": 0}

    def bomb(*a, **k):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("simulated fault")
        return real_step(*a, **k)

    monkeypatch.setattr(PV, "_insert_step", bomb)
    with pytest.raises(RuntimeError):
        PV.build_vamana_graph(ps, s2g, offsets, bp, seed=7, checkpoint_path=ckpt)
    monkeypatch.setattr(PV, "_insert_step", real_step)
    saved = dict(np.load(ckpt))
    assert int(saved["t_done"]) == 3
    resumed = PV.build_vamana_graph(ps, s2g, offsets, bp, seed=7,
                                    checkpoint_path=ckpt)
    assert not os.path.exists(ckpt)
    np.testing.assert_array_equal(resumed.nbrs_host, ref.nbrs_host)
    np.savez(ckpt, fingerprint=np.int64(0), t_done=saved["t_done"],
             nbrs=saved["nbrs"], degrees=saved["degrees"])
    fresh = PV.build_vamana_graph(ps, s2g, offsets, bp, seed=7, checkpoint_path=ckpt)
    np.testing.assert_array_equal(fresh.nbrs_host, ref.nbrs_host)


def test_require_cache_guard(tmp_path):
    rng = np.random.default_rng(41)
    points = rng.normal(size=(1000, 16)).astype(np.float32)
    labels = rng.uniform(size=1000)
    bp = P.BuildParams(R=8, L=16, alpha=1.2, cache_path=str(tmp_path) + "/")
    with pytest.raises(FileNotFoundError):
        P.PostfilterVamanaIndex(points, labels, bp, require_cache=True, device="cpu")
    built = P.PostfilterVamanaIndex(points, labels, bp, device="cpu")
    loaded = P.PostfilterVamanaIndex(points, labels, bp, require_cache=True,
                                     device="cpu")
    np.testing.assert_array_equal(loaded._graph.nbrs_host, built._graph.nbrs_host)
    with pytest.raises(FileNotFoundError), pytest.warns(UserWarning):
        P.PostfilterVamanaIndex(points + 1.0, labels, bp, require_cache=True,
                                device="cpu")
    with pytest.raises(ValueError):
        P.PostfilterVamanaIndex(points, labels, bp, start_point="nope", device="cpu")


def test_postfilter_constructor_matches(shared):
    from rangefilteredann_tpu.wrapper import postfilter_vamana_constructor as jctor

    s = shared
    jidx = jctor("Euclidian", "float")(s["points"], s["labels"], _bp(J, s["cache"]))
    np.testing.assert_array_equal(jidx._graph.nbrs_host, s["jidx"]._graph.nbrs_host)
    got = _search(P.postfilter_vamana_constructor("Euclidian", "float")(
        s["points"], s["labels"], _bp(P, s["cache"]), device="cpu"), P, s)
    assert_same_results(s["want"], got)
    with pytest.raises(Exception, match="Invalid metric"):
        P.postfilter_vamana_constructor("cosine", "float")


def test_device_none_means_the_card():
    """device=None places the index on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.PostfilterVamanaIndex(np.eye(8, dtype=np.float32), np.arange(8.0),
                                P.BuildParams(R=4, L=8))


def test_graph_path_imports_no_jax():
    """Building and searching a CPU postfilter index loads neither jax nor
    any module of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "import rangefilteredann_tpu_torch as P\n"
        "from rangefilteredann_tpu_torch.ops import beam\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.normal(size=(300, 8)).astype(np.float32)\n"
        "idx = P.PostfilterVamanaIndex(x, rng.uniform(size=300),"
        " P.BuildParams(R=8, L=16), device='cpu')\n"
        "idx.batch_search(x[:4], [(0, 1)] * 4, 4, P.build_query_params(3, 8))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rangefilteredann_tpu' or m.startswith('rangefilteredann_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
