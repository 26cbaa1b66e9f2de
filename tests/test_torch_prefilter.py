"""The PyTorch port's PrefilterIndex against the JAX package's.

The same numpy inputs (made from a seed) go through both indices: ids must
match exactly, distances within rtol 1e-5 / atol 1e-4. Both routes of the
port (per-query gather and range-masked scan) are driven by lowering its own
window_gather_max; the JAX side keeps its routing, since both are exact.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import subprocess
import sys

import numpy as np
import pytest

import rangefilteredann_tpu as J
import rangefilteredann_tpu_torch as P
from rangefilteredann_tpu_torch.models import base as PBASE
from rangefilteredann_tpu_torch.models import prefilter as PPRE
from rangefilteredann_tpu_torch.utils.data import pad_queries

RTOL, ATOL = 1e-5, 1e-4
FLT_MAX = np.finfo(np.float32).max


def _data(kind, seed=0, n=3000, d=24, nq=96):
    rng = np.random.default_rng(seed)
    if kind == "int8":
        pts = rng.integers(-100, 100, size=(n, d)).astype(np.int8)
        queries = rng.integers(-100, 100, size=(nq, d)).astype(np.float32)
    elif kind == "uint8":
        pts = rng.integers(0, 200, size=(n, d)).astype(np.uint8)
        queries = rng.integers(0, 200, size=(nq, d)).astype(np.float32)
    else:
        pts = rng.normal(size=(n, d)).astype(np.float32)
        queries = rng.normal(size=(nq, d)).astype(np.float32)
    labels = rng.uniform(size=n)
    # empty (outside the labels), tiny, narrow and wide windows
    width = rng.choice([0.0, 1e-4, 0.003, 0.02, 0.6, 1.0], size=nq)
    lo = rng.uniform(0, 1, size=nq) * (1 - width)
    filters = np.stack([lo, lo + width], axis=1)
    filters[:3] = [(2.0, 3.0), (-1.0, -0.5), (0.5, 0.5)]
    return pts, labels, queries, filters


def assert_same_results(want, got, exact_dists=False):
    wi, wd = want
    gi, gd = got
    assert gi.dtype == np.uint32 and gd.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    if exact_dists:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["float", "int8", "uint8"])
@pytest.mark.parametrize("metric", ["Euclidian", "mips"])
@pytest.mark.parametrize("gather_max", [4096, 16])
def test_batch_search_matches_jax(monkeypatch, kind, metric, gather_max):
    """gather_max=4096 sends every window (n=3000) through the gather; 16
    sends all but the tiny ones through the scan."""
    pts, labels, queries, filters = _data(kind, seed=len(kind))
    monkeypatch.setattr(PBASE, "WINDOW_GATHER_MAX", gather_max)
    qp = J.build_query_params(10, 10)
    want = J.PrefilterIndex(pts, labels, metric=metric).batch_search(
        queries, filters, len(queries), qp)
    got = P.PrefilterIndex(pts, labels, metric=metric, device="cpu").batch_search(
        queries, filters, len(queries), P.build_query_params(10, 10))
    assert_same_results(want, got, exact_dists=kind != "float")


def test_batch_search_many_matches_jax():
    pts, labels, _, _ = _data("float", seed=3)
    jidx = J.PrefilterIndex(pts, labels)
    pidx = P.PrefilterIndex(pts, labels, device="cpu")
    batches = []
    for s in range(3):
        _, _, q, f = _data("float", seed=50 + s, nq=40)
        batches.append((q, f))
    want = jidx.batch_search_many(batches, J.build_query_params(10, 10))
    got = pidx.batch_search_many(batches, P.build_query_params(10, 10))
    assert len(got) == len(batches)
    for w, g in zip(want, got):
        assert_same_results(w, g)
    # each batch of the stream equals its own batch_search
    single = pidx.batch_search(*batches[1], 40, P.build_query_params(10, 10))
    for a, b in zip(single, got[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_batch_search_many_plans_on_the_device(monkeypatch, kind):
    """Three batches whose windows take both routes (the gather up to 64
    points, the scan past them): the answers equal, bit for bit, those of
    the host-array entry given numpy's bounds and padded queries, and the
    JAX package's (ids exactly, distances bit for bit on the integer store,
    within the parity bar on the float one, whose products differ); the
    bounds of all three come down in one fetch, after every batch's search,
    and DEVICE_PLANS counts each batch."""
    monkeypatch.setattr(PBASE, "WINDOW_GATHER_MAX", 64)
    pts, labels, _, _ = _data(kind, seed=21)
    batches = [_data(kind, seed=60 + s, nq=40)[2:] for s in range(3)]
    want = J.PrefilterIndex(pts, labels).batch_search_many(
        batches, J.build_query_params(10, 10))
    pidx = P.PrefilterIndex(pts, labels, device="cpu")
    fetched, real = [], PPRE.to_host
    monkeypatch.setattr(PPRE, "to_host", lambda *t: (
        fetched.append((len(t), PPRE.DEVICE_PLANS)), real(*t))[1])
    before = PPRE.DEVICE_PLANS
    got = pidx.batch_search_many(batches, P.build_query_params(10, 10))
    assert fetched == [(1, before + 3)] and PPRE.DEVICE_PLANS == before + 3
    ps, ls = pidx._ps, pidx._labels_sorted
    for (q, f), w, g in zip(batches, want, got):
        assert_same_results(w, g, exact_dists=kind != "float")
        d, i = PBASE.batched_range_bruteforce(
            ps.data, ps.norms_sq, pad_queries(q, ps.d, ps.d_pad),
            np.searchsorted(ls, f[:, 0]), np.searchsorted(ls, f[:, 1]), 10,
            ps.metric, norm_col=ps.norm_col)
        host = PBASE.finalize_output(d, i, pidx._decoding, np.einsum("qd,qd->q", q, q),
                                     ps.metric, pad_id=-1)
        assert_same_results(host, g, exact_dists=True)


@pytest.mark.parametrize("gather_max", [4096, 16])
def test_padding_of_empty_slots(monkeypatch, gather_max):
    """Empty windows and windows with fewer than k points pad with
    uint32(-1) / FLT_MAX, as the JAX package does."""
    monkeypatch.setattr(PBASE, "WINDOW_GATHER_MAX", gather_max)
    pts, labels, queries, _ = _data("float", seed=5, n=500, nq=3)
    ls = np.sort(labels)
    filters = np.array([(2.0, 3.0), (ls[10], ls[15]), (0.0, 1.1)])
    qp = P.build_query_params(10, 10)
    got = P.PrefilterIndex(pts, labels, device="cpu").batch_search(
        queries, filters, 3, qp)
    want = J.PrefilterIndex(pts, labels).batch_search(
        queries, filters, 3, J.build_query_params(10, 10))
    assert_same_results(want, got)
    ids, dists = got
    assert (ids[0] == np.uint32(0xFFFFFFFF)).all() and (dists[0] == FLT_MAX).all()
    assert (ids[1, 5:] == np.uint32(0xFFFFFFFF)).all()
    assert (dists[1, 5:] == FLT_MAX).all() and (dists[1, :5] < FLT_MAX).all()
    assert (dists[2] < FLT_MAX).all()


def test_k_above_window_class(gt_fn):
    """k=100 over windows of a few dozen points. The JAX package raises
    here (its 64-wide window class returns 64 columns for k=100); the port
    pads and agrees with the numpy oracle."""
    pts, labels, queries, _ = _data("float", seed=7, n=2000, nq=8)
    lo = np.linspace(0.1, 0.8, 8)
    filters = np.stack([lo, lo + 0.015], axis=1)
    ids, dists = P.PrefilterIndex(pts, labels, device="cpu").batch_search(
        queries, filters, 8, P.build_query_params(100, 100))
    gt_ids, gt_d = gt_fn(pts, labels, queries, filters, 100, "l2")
    valid = gt_ids >= 0
    np.testing.assert_array_equal(ids.astype(np.int64)[valid], gt_ids[valid])
    np.testing.assert_allclose(dists[valid], gt_d[valid], rtol=1e-4, atol=1e-3)
    assert (dists[~valid] == FLT_MAX).all()


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_jax_built_index_loads_into_the_port(kind):
    """convert.py: the arrays of a JAX-built index, given as numpy, give an
    identical store and identical outputs in the port."""
    pts, labels, queries, filters = _data(kind, seed=9)
    jidx = J.PrefilterIndex(pts, labels)
    ps = jidx._ps
    pidx = P.PrefilterIndex.from_arrays(
        np.asarray(ps.data), np.asarray(ps.norms_sq), ps.n, ps.d, ps.metric,
        ps.norm_col, jidx._labels_sorted, jidx._decoding, device="cpu")
    np.testing.assert_array_equal(pidx._ps.data.numpy(), np.asarray(ps.data))
    assert pidx.metric == jidx.metric and pidx._ps.norm_col == ps.norm_col
    want = jidx.batch_search(queries, filters, len(queries),
                             J.build_query_params(10, 10))
    got = pidx.batch_search(queries, filters, len(queries),
                            P.build_query_params(10, 10))
    assert_same_results(want, got, exact_dists=kind != "float")


def test_prefilter_constructor_matches():
    from rangefilteredann_tpu.wrapper import prefilter_index_constructor as jctor
    from rangefilteredann_tpu_torch.wrapper import prefilter_index_constructor as pctor

    pts, labels, queries, filters = _data("float", seed=11, n=1500, nq=32)
    pts_u8 = np.clip(np.abs(pts) * 60, 0, 255).astype(np.uint8)
    want = jctor("mips", "uint8")(pts_u8, labels).batch_search(
        queries, filters, 32, J.build_query_params(10, 10))
    got = pctor("mips", "uint8")(pts_u8, labels, device="cpu").batch_search(
        queries, filters, 32, P.build_query_params(10, 10))
    assert_same_results(want, got)
    with pytest.raises(Exception, match="Invalid metric"):
        pctor("cosine", "float")
    with pytest.raises(Exception, match="Invalid data type"):
        pctor("mips", "float16")


def test_import_pulls_in_no_jax():
    """Importing the port (and building a CPU index) loads neither jax nor
    any module of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "import rangefilteredann_tpu_torch as P\n"
        "from rangefilteredann_tpu_torch import wrapper, convert, kernels\n"
        "from rangefilteredann_tpu_torch.ops import scan\n"
        "idx = P.PrefilterIndex(np.eye(8, dtype=np.float32), np.arange(8.0),"
        " device='cpu')\n"
        "idx.batch_search(np.eye(8, dtype=np.float32)[:2], [(0, 9), (2, 5)], 2,"
        " P.build_query_params(3, 3))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rangefilteredann_tpu' or m.startswith('rangefilteredann_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_host_planning_helpers_match():
    """The batch and window-class arithmetic of models/base.py."""
    from rangefilteredann_tpu.models import base as JBASE

    widths = np.array([0, 1, 63, 64, 65, 200, 4096, 5000])
    np.testing.assert_array_equal(JBASE.pow2_classes(widths),
                                  PBASE.pow2_classes(widths))
    np.testing.assert_array_equal(JBASE.pow2_classes(widths, hi=256),
                                  PBASE.pow2_classes(widths, hi=256))
    for x in (0, 1, 3, 64, 100, 2048, 2049, 10_240):
        assert PBASE.next_pow2(x) == JBASE.next_pow2(x)
        assert PBASE.pad_batch(x) == JBASE.pad_batch(x)
    assert (PBASE.MIN_CLASS, PBASE.GATHER_BYTES_BUDGET) == (
        JBASE.MIN_CLASS, JBASE.GATHER_BYTES_BUDGET)
    assert PBASE.window_gather_max() == JBASE.WINDOW_GATHER_MAX
