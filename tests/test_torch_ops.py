"""The PyTorch port's top-k, distance and scan ops against the JAX package.

Inputs are made with numpy from a seed and given to both packages. Ids must
match exactly and distances within rtol 1e-5 / atol 1e-4 (the bar of
tests/test_pallas.py): the two sides sum float32 products in different
orders. The Pallas scan runs in interpret mode, as its own tests run it.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rangefilteredann_tpu.ops import bruteforce as JB
from rangefilteredann_tpu.ops import distances as JD
from rangefilteredann_tpu.ops import topk as JT
from rangefilteredann_tpu.ops.pallas_scan import pallas_scan_bruteforce
from rangefilteredann_tpu.utils.data import make_pointset as j_make_pointset
from rangefilteredann_tpu.utils.data import pad_queries
from rangefilteredann_tpu_torch.ops import bruteforce as PB
from rangefilteredann_tpu_torch.ops import distances as PD
from rangefilteredann_tpu_torch.ops import scan as PS
from rangefilteredann_tpu_torch.ops import topk as PT
from rangefilteredann_tpu_torch.utils.data import make_pointset as p_make_pointset

RTOL, ATOL = 1e-5, 1e-4


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def assert_topk_equal(want, got, exact_dists=False):
    wd, wi = (np.asarray(x) for x in want)
    gd, gi = (x.numpy() for x in got)
    np.testing.assert_array_equal(gi, wi)
    if exact_dists:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


def stores(pts, metric):
    """The same store built by both packages."""
    return j_make_pointset(pts, metric), p_make_pointset(pts, metric, device="cpu")


# ------------------------------------------------------------------ top-k --

@pytest.mark.parametrize("c,k", [(40, 10), (300, 64), (16, 16)])
def test_masked_topk_tie_order_matches(c, k):
    """Heavy distance ties, shuffled ids and +inf/EMPTY slots: the port's two
    stable sorts give jax.lax.sort(num_keys=2)'s (dist, id) order."""
    rng = np.random.default_rng(c)
    q = 32
    d = rng.choice([0.0, 1.0, 2.5, np.inf], size=(q, c)).astype(np.float32)
    ids = np.stack([rng.permutation(10 * c)[:c] for _ in range(q)]).astype(np.int32)
    ids[d == np.inf] = JT.EMPTY_ID
    want = JT.masked_topk(jnp.asarray(d), jnp.asarray(ids), k)
    got = PT.masked_topk(t(d), t(ids), k)
    assert_topk_equal(want, got, exact_dists=True)


def test_merge_topk_matches():
    rng = np.random.default_rng(1)
    q, k = 16, 10
    da = np.sort(rng.choice([0.0, 1.0, 2.0], size=(q, k)), axis=1).astype(np.float32)
    db = np.sort(rng.choice([0.0, 1.0, 2.0], size=(q, k)), axis=1).astype(np.float32)
    ia = rng.integers(0, 1000, size=(q, k)).astype(np.int32)
    ib = rng.integers(1000, 2000, size=(q, k)).astype(np.int32)
    want = JT.merge_topk(*(jnp.asarray(x) for x in (da, ia, db, ib)), k)
    got = PT.merge_topk(t(da), t(ia), t(db), t(ib), k)
    assert_topk_equal(want, got, exact_dists=True)


def test_masked_topk_pads_short_rows():
    """Fewer candidates than k: the port pads with (+inf, EMPTY_ID)."""
    d = torch.tensor([[3.0, 1.0, 2.0]])
    i = torch.tensor([[7, 8, 9]], dtype=torch.int32)
    gd, gi = PT.masked_topk(d, i, 5)
    assert gd.tolist() == [[1.0, 2.0, 3.0, float("inf"), float("inf")]]
    assert gi.tolist() == [[8, 9, 7, PT.EMPTY_ID, PT.EMPTY_ID]]
    assert PT.EMPTY_ID == int(JT.EMPTY_ID)


# -------------------------------------------------------------- distances --

def _points(kind, rng, n, d):
    if kind == "int8":
        return rng.integers(-100, 100, size=(n, d)).astype(np.int8)
    if kind == "uint8":
        return rng.integers(0, 200, size=(n, d)).astype(np.uint8)
    return rng.normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["float", "int8", "uint8"])
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_block_and_pairwise_distances_match(kind, metric):
    rng = np.random.default_rng(2)
    d = 24
    jps, pps = stores(_points(kind, rng, 300, d), metric)
    queries = pad_queries(rng.normal(size=(40, d)).astype(np.float32), d, jps.d_pad)
    want = JD.query_block_distances(jnp.asarray(queries), jps.data, jps.norms_sq, metric)
    got = PD.query_block_distances(t(queries), pps.data, pps.norms_sq, metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    a = slice(0, 50)
    want = JD.pairwise_distances(jps.data[a], jps.norms_sq[a], jps.data,
                                 jps.norms_sq, metric)
    got = PD.pairwise_distances(pps.data[a], pps.norms_sq[a], pps.data,
                                pps.norms_sq, metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert PD.is_metric(metric) == JD.is_metric(metric)


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_gathered_and_fused_norm_distances_match(kind, metric):
    rng = np.random.default_rng(4)
    d, q, c = 24, 16, 33
    jps, pps = stores(_points(kind, rng, 500, d), metric)
    queries = pad_queries(rng.normal(size=(q, d)).astype(np.float32), d, jps.d_pad)
    ids = rng.integers(0, 500, size=(q, c))
    want = JD.gathered_distances(jnp.asarray(queries), jps.data[ids],
                                 jps.norms_sq[ids], metric)
    got = PD.gathered_distances(t(queries), pps.data[t(ids)],
                                pps.norms_sq[t(ids)], metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if kind == "float":
        want = JD.fused_norm_distances(jps.data[ids], jnp.asarray(queries),
                                       metric, jps.norm_col)
        got = PD.fused_norm_distances(pps.data[t(ids)], t(queries), metric,
                                      pps.norm_col)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ scans --

def _scan_case(seed, n, d, nq, kind="float", metric="l2"):
    rng = np.random.default_rng(seed)
    jps, pps = stores(_points(kind, rng, n, d), metric)
    if kind == "float":
        queries = rng.normal(size=(nq, d)).astype(np.float32)
    else:  # integer-valued queries: byte-store distances are then exact
        queries = _points(kind, rng, nq, d).astype(np.float32)
    qp = pad_queries(queries, d, jps.d_pad)
    starts = rng.integers(0, n, size=nq).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, n, size=nq), n).astype(np.int32)
    ends[:4] = starts[:4]  # a few empty windows
    ends[4:8] = n  # windows touching the store's end
    return jps, pps, qp, starts, ends


@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("nq", [64, 512])
def test_scan_bruteforce_matches_jax_and_pallas(metric, nq):
    """n=1300 is no tile multiple; windows are random, empty, or run to the
    store's end. The port's plain scan equals the JAX scan and the Pallas
    kernel (interpret mode)."""
    jps, pps, qp, starts, ends = _scan_case(nq, 1300, 24, nq, metric=metric)
    args = (jnp.asarray(qp), jnp.asarray(starts), jnp.asarray(ends))
    want = JB.scan_bruteforce(jps.data, jps.norms_sq, *args, k=10, metric=metric)
    got = PB.scan_bruteforce(pps.data, pps.norms_sq, t(qp), t(starts), t(ends),
                             k=10, metric=metric)
    assert_topk_equal(want, got)
    pallas = pallas_scan_bruteforce(jps.data, jps.norms_sq, *args, k=10,
                                    metric=metric, interpret=True)
    assert_topk_equal(pallas, got)


@pytest.mark.parametrize("kind", ["int8", "uint8"])
def test_scan_bruteforce_byte_store_exact(kind):
    """Byte stores with integer queries: identical ids and distances."""
    jps, pps, qp, starts, ends = _scan_case(9, 1300, 32, 64, kind=kind)
    want = JB.scan_bruteforce(jps.data, jps.norms_sq, jnp.asarray(qp),
                              jnp.asarray(starts), jnp.asarray(ends), k=10,
                              metric="l2")
    got = PB.scan_bruteforce(pps.data, pps.norms_sq, t(qp), t(starts), t(ends),
                             k=10, metric="l2")
    assert_topk_equal(want, got, exact_dists=True)


@pytest.mark.parametrize("k", [1, 10, 100])
def test_scan_duplicate_points_tie_order(k):
    """Every point duplicated 16x across tiles: exact distance ties, broken
    lowest id first, as the JAX scan and the Pallas kernel break them."""
    rng = np.random.default_rng(21)
    d, nq = 8, 64
    points = np.tile(rng.normal(size=(96, d)).astype(np.float32), (16, 1))
    jps, pps = stores(points, "l2")
    qp = pad_queries(rng.normal(size=(nq, d)).astype(np.float32), d, jps.d_pad)
    starts = np.zeros(nq, np.int32)
    ends = np.full(nq, len(points), np.int32)
    args = (jnp.asarray(qp), jnp.asarray(starts), jnp.asarray(ends))
    want = JB.scan_bruteforce(jps.data, jps.norms_sq, *args, k=k, metric="l2")
    got = PB.scan_bruteforce(pps.data, pps.norms_sq, t(qp), t(starts), t(ends),
                             k=k, metric="l2", tile=512)
    assert_topk_equal(want, got)
    if k == 10:
        pallas = pallas_scan_bruteforce(jps.data, jps.norms_sq, *args, k=k,
                                        metric="l2", interpret=True)
        assert_topk_equal(pallas, got)


@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("fused", [True, False])
def test_windowed_bruteforce_matches(metric, fused):
    rng = np.random.default_rng(23)
    n, d, nq, window = 1300, 24, 64, 128
    jps, pps = stores(rng.normal(size=(n, d)).astype(np.float32), metric)
    qp = pad_queries(rng.normal(size=(nq, d)).astype(np.float32), d, jps.d_pad)
    starts = rng.integers(0, n, size=nq).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, window + 1, size=nq), n).astype(np.int32)
    ends[:3] = starts[:3]
    norm_col = jps.norm_col if fused else None
    want = JB.windowed_bruteforce(jps.data, jps.norms_sq, jnp.asarray(qp),
                                  jnp.asarray(starts), jnp.asarray(ends),
                                  window=window, k=10, metric=metric,
                                  norm_col=norm_col)
    got = PB.windowed_bruteforce(pps.data, pps.norms_sq, t(qp), t(starts),
                                 t(ends), window=window, k=10, metric=metric,
                                 norm_col=norm_col)
    assert_topk_equal(want, got)


def test_windowed_bruteforce_byte_store_matches():
    jps, pps, qp, starts, ends = _scan_case(25, 1300, 32, 64, kind="int8")
    ends = np.minimum(ends, starts + 200).astype(np.int32)
    args = (jnp.asarray(qp), jnp.asarray(starts), jnp.asarray(ends))
    want = JB.windowed_bruteforce(jps.data, jps.norms_sq, *args, window=256,
                                  k=10, metric="l2")
    got = PB.windowed_bruteforce(pps.data, pps.norms_sq, t(qp), t(starts),
                                 t(ends), window=256, k=10, metric="l2")
    assert_topk_equal(want, got, exact_dists=True)


def test_scan_topk_on_cpu_takes_the_plain_version():
    """A CPU store goes to scan_bruteforce and launches no kernel. Query
    columns past d_eff (here the fused norm column and beyond) are ignored,
    as the kernel ignores them, and narrower queries give the same result."""
    _, pps, qp, starts, ends = _scan_case(27, 1300, 24, 64)
    before = PS.SCAN_LAUNCHES
    want = PB.scan_bruteforce(pps.data, pps.norms_sq, t(qp), t(starts),
                              t(ends), k=10, metric="l2")
    dirty = qp.copy()
    dirty[:, 24:] = 123.0
    for queries in (dirty, qp[:, :32]):
        got = PS.scan_topk(pps.data, pps.norms_sq, t(queries), t(starts),
                           t(ends), k=10, metric="l2", d_eff=24)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
    assert PS.SCAN_LAUNCHES == before
    with pytest.raises(ValueError):
        PS.scan_topk(pps.data, pps.norms_sq, t(qp), t(starts), t(ends), k=10,
                     metric="cosine")


def test_kernel_sources_and_limits():
    """The kernel's source ships with the package, and the wrapper's limits
    agree with the constants compiled into it (MAX_K from the helpers the
    scan kernels share, csrc/scan_common.cuh)."""
    from rangefilteredann_tpu_torch import kernels

    src = "".join((kernels.CSRC / f).read_text() for f in ("scan_topk.cu", "scan_common.cuh"))
    assert "constexpr int MAX_K = %d;" % PS.MAX_K in src
    assert "constexpr int DK = %d;" % PS.CHUNK in src
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert kernels.library_path("scan_topk").parent == kernels.BUILD_DIR
