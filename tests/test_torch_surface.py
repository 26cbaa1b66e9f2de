"""The PyTorch port's API surface against the JAX package's.

utils/io files written by the port are byte for byte the JAX package's and
each package reads the other's; `filters` and `graph_stats` give the same
answers; the port's VamanaIndex, on a graph the JAX package built and saved,
returns the JAX VamanaIndex's ids (distances within rtol 1e-5 / atol 1e-4)
and recall; the port's own build and command line reach the recall that
tests/test_cli.py asks of the JAX ones; the port's `window_ann` names are
the root shim's, and one class of each family answers like its JAX
counterpart, the graph families on shared caches.
"""

import numpy as np
import pytest
import torch

import window_ann as JWA
from rangefilteredann_tpu import cli as jcli
from rangefilteredann_tpu import filters as JF
from rangefilteredann_tpu import native as jnative
from rangefilteredann_tpu.models.vamana_index import VamanaIndex as JVamanaIndex
from rangefilteredann_tpu.models.vamana_index import build_vamana_index as j_build
from rangefilteredann_tpu.utils import io as jio
from rangefilteredann_tpu.utils.stats import graph_stats as j_graph_stats
from rangefilteredann_tpu_torch import cli as pcli
from rangefilteredann_tpu_torch import filters as PF
from rangefilteredann_tpu_torch import native as pnative
from rangefilteredann_tpu_torch import window_ann as PWA
from rangefilteredann_tpu_torch.models.vamana_index import VamanaIndex, build_vamana_index
from rangefilteredann_tpu_torch.utils import io as pio
from rangefilteredann_tpu_torch.utils.stats import graph_stats

RTOL, ATOL = 1e-5, 1e-4
FLT_MAX = np.finfo(np.float32).max


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths are many small torch ops: one thread each keeps
    them from contending with the other test workers' threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def no_native(monkeypatch):
    """Both packages' bridges as they are without g++."""
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert not pnative.available() and not jnative.available()


def _packed_graph(rng, n=60, r=6):
    nbrs = rng.integers(0, n, size=(n, r)).astype(np.int32)
    degs = rng.integers(0, r + 1, size=n)
    degs[0] = 0
    for i in range(n):
        nbrs[i, degs[i]:] = -1
    return nbrs


# ------------------------------------------------------------------- io
@pytest.mark.parametrize("dtype", ["float", "uint8", "int8"])
def test_vector_file_same_bytes_and_cross_read(tmp_path, dtype):
    rng = np.random.default_rng(1)
    np_dt = {"float": np.float32, "uint8": np.uint8, "int8": np.int8}[dtype]
    data = (rng.normal(size=(50, 7)) if dtype == "float"
            else rng.integers(-100 if dtype == "int8" else 0, 100, size=(50, 7))
            ).astype(np_dt)
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    pio.write_vector_file(p, data)
    jio.write_vector_file(j, data)
    assert _bytes(p) == _bytes(j) and len(_bytes(p)) == 8 + data.nbytes
    for got in (pio.read_vector_file(j, dtype), jio.read_vector_file(p, dtype)):
        assert got.dtype == np_dt
        np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("bridge", ["native", "numpy"])
def test_graph_file_same_bytes_and_cross_read(tmp_path, bridge, request):
    if bridge == "numpy":
        request.getfixturevalue("no_native")
    else:
        assert pnative.available() and jnative.available()
    nbrs = _packed_graph(np.random.default_rng(2))
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    pio.write_graph_file(p, nbrs)
    jio.write_graph_file(j, nbrs)
    assert _bytes(p) == _bytes(j)
    raw = np.frombuffer(_bytes(p), dtype=np.uint32)
    assert tuple(raw[:2]) == nbrs.shape and raw[2:2 + len(nbrs)].sum() == (nbrs >= 0).sum()
    for got, degs in (pio.read_graph_file(j), jio.read_graph_file(p)):
        assert got.dtype == np.int32 and degs.dtype == np.int32
        np.testing.assert_array_equal(got, nbrs)
        np.testing.assert_array_equal(degs, (nbrs >= 0).sum(axis=1))


def test_groundtruth_file_same_bytes_and_cross_read(tmp_path):
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 1000, size=(30, 10)).astype(np.uint32)
    dists = rng.random((30, 10)).astype(np.float32)
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    pio.write_groundtruth_file(p, ids, dists)
    jio.write_groundtruth_file(j, ids, dists)
    assert _bytes(p) == _bytes(j)
    for gi, gd in (pio.read_groundtruth_file(j), jio.read_groundtruth_file(p)):
        np.testing.assert_array_equal(gi, ids)
        np.testing.assert_array_equal(gd, dists)


def test_native_graph_padded_matches_jax(tmp_path):
    assert pnative.available() and jnative.available()
    nbrs = _packed_graph(np.random.default_rng(4), n=300, r=12)
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    assert pnative.write_graph_padded(p, nbrs) and jnative.write_graph_padded(j, nbrs)
    assert _bytes(p) == _bytes(j)
    got, want = pnative.read_graph_padded(j), jnative.read_graph_padded(p)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, nbrs)
    with pytest.raises(FileNotFoundError):
        pnative.read_graph_padded(str(tmp_path / "missing.bin"))


# -------------------------------------------------------------- filters
def _dense_to_csr(mod, dense):
    offsets = np.zeros(dense.shape[0] + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(dense.sum(axis=1))
    cols = np.concatenate([np.nonzero(row)[0] for row in dense]).astype(np.int32)
    return mod.csr_filters.from_arrays(offsets, cols, dense.shape[1])


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(3)
    d = rng.random((40, 13)) < 0.25
    d[:, 0] |= ~d.any(axis=1)  # every point has >= 1 filter
    return d


def test_filters_match_and_counts(dense):
    """tests/test_filters.py::test_match_and_counts and
    test_point_intersection, on both packages' classes."""
    pf, jf = _dense_to_csr(PF, dense), _dense_to_csr(JF, dense)
    for cf in (pf, jf):
        assert (cf.n_points, cf.n_filters, cf.n_nonzero) == (40, 13, int(dense.sum()))
    np.testing.assert_array_equal(pf.row_indices, jf.row_indices)
    for p in range(40):
        for f in range(13):
            assert pf.match(p, f) == jf.match(p, f) == bool(dense[p, f])
        assert pf.point_count(p) == jf.point_count(p) == int(dense[p].sum())
        np.testing.assert_array_equal(pf.point_filters(p), jf.point_filters(p))
    for f in range(13):
        assert pf.filter_count(f) == jf.filter_count(f) == int(dense[:, f].sum())
    np.testing.assert_array_equal(pf.filter_counts(), jf.filter_counts())
    np.testing.assert_array_equal(pf.point_intersection(1, 2), jf.point_intersection(1, 2))
    np.testing.assert_array_equal(pf.point_intersection(1, 2),
                                  np.nonzero(dense[1] & dense[2])[0])


def test_filters_transpose_and_query_matches(dense):
    pt, jt = _dense_to_csr(PF, dense).transpose(), _dense_to_csr(JF, dense).transpose()
    assert pt.transposed and (pt.n_points, pt.n_filters) == (jt.n_points, jt.n_filters)
    np.testing.assert_array_equal(pt.row_offsets, jt.row_offsets)
    np.testing.assert_array_equal(pt.row_indices, jt.row_indices)
    for q in (PF.QueryFilter(4), PF.QueryFilter(4, 7)):
        want = jt.query_matches(JF.QueryFilter(q.a, q.b))
        np.testing.assert_array_equal(pt.query_matches(q), want)
    np.testing.assert_array_equal(pt.query_matches(PF.QueryFilter(4, 7)),
                                  np.nonzero(dense[:, 4] & dense[:, 7])[0])
    with pytest.raises(RuntimeError):
        _dense_to_csr(PF, dense).query_matches(PF.QueryFilter(0))
    back = pt.transpose()
    np.testing.assert_array_equal(back.row_indices, _dense_to_csr(JF, dense).row_indices)
    inplace = _dense_to_csr(PF, dense)
    inplace.transpose_inplace()
    np.testing.assert_array_equal(inplace.row_indices, jt.row_indices)
    assert inplace.reverse_transpose().transposed is False


def test_filters_file_round_trip_across_packages(tmp_path, dense):
    p, j = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    _dense_to_csr(PF, dense).save(p)
    _dense_to_csr(JF, dense).save(j)
    assert _bytes(p) == _bytes(j)
    for loaded in (PF.csr_filters(j), JF.csr_filters(p)):
        np.testing.assert_array_equal(loaded.row_offsets, _dense_to_csr(JF, dense).row_offsets)
        np.testing.assert_array_equal(loaded.row_indices, _dense_to_csr(JF, dense).row_indices)
    unsorted = PF.csr_filters.from_arrays(np.array([0, 3, 5, 5, 8]),
                                          np.array([7, 2, 5, 9, 1, 6, 0, 3]), 10)
    np.testing.assert_array_equal(unsorted.point_filters(0), [2, 5, 7])
    np.testing.assert_array_equal(unsorted.point_filters(3), [0, 3, 6])


def test_filtered_dataset_matches_jax(tmp_path, dense):
    rng = np.random.default_rng(0)
    pts = rng.integers(-20, 20, size=(40, 8)).astype(np.int8)
    ppath, fpath = str(tmp_path / "points.bin"), str(tmp_path / "filters.bin")
    pio.write_vector_file(ppath, pts)
    _dense_to_csr(PF, dense).save(fpath)
    pds, jds = PF.FilteredDataset(ppath, fpath), JF.FilteredDataset(ppath, fpath)
    assert pds.size() == jds.size() == 40
    assert pds.get_n_filters() == jds.get_n_filters() == 13
    assert pds.distance(3, 9) == jds.distance(3, 9)
    for i in range(13):
        assert pds.get_filter_size(i) == jds.get_filter_size(i)
        np.testing.assert_array_equal(pds.get_filter_points(i), jds.get_filter_points(i))
    for i in range(40):
        assert pds.get_point_size(i) == jds.get_point_size(i)
        np.testing.assert_array_equal(pds.get_point_filters(i), jds.get_point_filters(i))
    np.testing.assert_array_equal(pds.get_filter_intersection(0, 1),
                                  jds.get_filter_intersection(0, 1))
    np.testing.assert_array_equal(pds.get_point_intersection(0, 1),
                                  jds.get_point_intersection(0, 1))
    for name in ("out.fvec", "labels.txt"):
        getattr(pds, "write_fvec" if name.endswith("fvec") else "write_labels")(
            str(tmp_path / f"p_{name}"))
        getattr(jds, "write_fvec" if name.endswith("fvec") else "write_labels")(
            str(tmp_path / f"j_{name}"))
        assert _bytes(tmp_path / f"p_{name}") == _bytes(tmp_path / f"j_{name}")
    q = PF.QueryFilter(5, 6)
    assert q.is_and() and q.get_sequence() == [5, 6] and str(q) == str(JF.QueryFilter(5, 6))
    assert repr(PF.QueryFilter(5)) == repr(JF.QueryFilter(5))


def test_graph_stats_matches_jax():
    nbrs = _packed_graph(np.random.default_rng(5), n=200, r=9)
    assert graph_stats(nbrs) == j_graph_stats(nbrs)
    assert graph_stats(np.array([[1, 2, -1], [0, -1, -1]])) == (1.5, 2)


# ---------------------------------------------------------- VamanaIndex
N, DV, NQ, KV = 2000, 16, 50, 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Base and query vector files, an exact ground-truth file, and a graph
    the JAX package built over the base file (tests/test_cli.py's sizes)."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("vamana_files")
    data = rng.normal(size=(N, DV)).astype(np.float32)
    queries = rng.normal(size=(NQ, DV)).astype(np.float32)
    paths = {k: str(d / f"{k}.bin") for k in ("base", "q", "gt", "jgraph")}
    jio.write_vector_file(paths["base"], data)
    jio.write_vector_file(paths["q"], queries)
    d2 = ((data[None] - queries[:, None]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)[:, :KV]
    jio.write_groundtruth_file(paths["gt"], order, np.take_along_axis(d2, order, 1))
    j_build("Euclidian", paths["base"], paths["jgraph"], 16, 32, 1.2)
    return dict(data=data, queries=queries, dir=d, **paths)


@pytest.mark.parametrize("beam", [10, 40])
def test_vamana_index_matches_jax(files, beam):
    f = files
    nbrs, _ = jio.read_graph_file(f["jgraph"])
    jidx = JVamanaIndex(f["jgraph"], f["base"])
    pidx = VamanaIndex(f["jgraph"], f["base"], num_points=N, dimensions=DV, device="cpu")
    want = jidx.batch_search(f["queries"], NQ, KV, beam)
    got = pidx.batch_search(f["queries"], NQ, KV, beam)
    assert got[0].dtype == np.uint32 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    arrays = VamanaIndex.from_arrays(f["data"], nbrs, device="cpu")
    np.testing.assert_array_equal(arrays.batch_search(f["queries"], NQ, KV, beam)[0],
                                  got[0])
    assert (pidx.check_recall(f["gt"], got[0], KV)
            == jidx.check_recall(f["gt"], want[0], KV))
    with pytest.raises(ValueError):
        VamanaIndex(f["jgraph"], f["base"], num_points=N + 1, device="cpu")


@pytest.fixture(scope="module")
def port_graph(files):
    """A graph the port's build_vamana_index built over the base file."""
    out = str(files["dir"] / "pgraph.bin")
    build_vamana_index("Euclidian", files["base"], out, 16, 32, 1.2, device="cpu")
    return out


def test_build_vamana_index_recall(files, port_graph):
    """The port's file-based build reaches the recall tests/test_cli.py asks
    of the JAX build (>= 0.8 at beam 32)."""
    f = files
    nbrs, degs = pio.read_graph_file(port_graph)
    assert nbrs.shape == (N, 16) and degs.mean() > 4
    idx = VamanaIndex(port_graph, f["base"], device="cpu")
    ids, dists = idx.batch_search(f["queries"], NQ, KV, 32)
    assert (dists < FLT_MAX).all()
    assert idx.check_recall(f["gt"], ids, KV) >= 0.8


def _table(out):
    return [ln.split() for ln in out.splitlines() if ln.split() and ln.split()[0].isdigit()]


def test_cli_runs_on_the_cpu(files, port_graph, capsys):
    """The command line with -device cpu: the JAX CLI's table header, one
    row per beam and recall >= 0.8 at beam 32 (tests/test_cli.py) over the
    port's graph, the JAX CLI's recall over the JAX graph, and its build
    path (here over a 400-point prefix), whose saved graph reloads."""
    f = files
    jcli.main(["-base_path", f["base"], "-query_path", f["q"], "-gt_path", f["gt"],
               "-graph_path", f["jgraph"], "-k", str(KV), "-beams", "32"])
    jout = capsys.readouterr().out
    args = ["-query_path", f["q"], "-k", str(KV), "-device", "cpu"]
    full = args + ["-base_path", f["base"], "-gt_path", f["gt"]]
    pcli.main(full + ["-graph_path", port_graph, "-beams", "8,32"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == jout.splitlines()[0]  # the table header
    rows = _table(out)
    assert [r[0] for r in rows] == ["8", "32"] and float(rows[1][1]) >= 0.8, out
    pcli.main(full + ["-graph_path", f["jgraph"], "-beams", "32"])
    assert _table(capsys.readouterr().out)[0][1] == _table(jout)[0][1]
    prefix, graph = str(f["dir"] / "prefix.bin"), str(f["dir"] / "cli_graph.bin")
    pio.write_vector_file(prefix, f["data"][:400])
    pcli.main(args + ["-base_path", prefix, "-R", "16", "-L", "32", "-a", "1.2",
                      "-graph_outfile", graph, "-beams", "8,32"])
    out = capsys.readouterr().out
    assert "built R=16" in out and [r[0] for r in _table(out)] == ["8", "32"]
    assert pio.read_graph_file(graph)[0].shape == (400, 16)
    pcli.main(args + ["-base_path", prefix, "-graph_path", graph, "-beams", "8"])
    assert [r[0] for r in _table(capsys.readouterr().out)] == ["8"]


# ----------------------------------------------------------- window_ann
def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_window_ann_names_equal_root_shim():
    assert _public(PWA) == _public(JWA)
    assert len([n for n in _public(PWA) if n.endswith(("Euclidian", "Mips"))]) == 30
    for name in ("METRIC", "ALPHA", "GRAPH_DEGREE", "BEAMWIDTH"):
        assert getattr(PWA.defaults, name) == getattr(JWA.defaults, name)
    assert PWA.BuildParams is not JWA.BuildParams  # the port's own classes
    assert PWA.csr_filters.__module__ == "rangefilteredann_tpu_torch.filters"


# (family class name, extra constructor kwargs, batch_search query method or
# None, exact): one class of each family, Float Euclidian, plus a byte store
FAMILIES = [
    ("PrefilterIndexFloatEuclidian", {}, None, True),
    ("PrefilterIndexUint8Euclidian", {}, None, True),
    ("RangeFilterTreeIndexFloatEuclidian", {"cutoff": 200}, "fenwick", True),
    ("PostfilterVamanaIndexFloatEuclidian", {}, None, False),
    ("VamanaRangeFilterTreeIndexFloatEuclidian", {"cutoff": 200}, "three_split", False),
    ("SuperOptimizedPostfilterTreeIndexFloatEuclidian", {"cutoff": 200}, None, False),
]


@pytest.mark.parametrize("name,kw,method,exact", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_window_ann_family_answers_like_jax(tmp_path, gt_fn, name, kw, method, exact):
    """The root shim's class (JAX) builds, with its caches under a
    temporary directory; the port's class of the same name loads those
    caches (same names, same fingerprints) and answers a tiny batch with
    the same ids, distances within the bar. The exact families also equal
    the float64 oracle."""
    rng = np.random.default_rng(21)
    n, d, nq, k = 800, 16, 12, 5
    if "Uint8" in name:
        points = rng.integers(0, 256, size=(n, d)).astype(np.uint8)
        queries = rng.integers(0, 256, size=(nq, d)).astype(np.float32)
    else:
        points = rng.normal(size=(n, d)).astype(np.float32)
        queries = rng.normal(size=(nq, d)).astype(np.float32)
    labels = rng.uniform(size=n)
    frac = np.array([2.0**-4, 0.25, 0.5])[np.arange(nq) % 3]
    lo = rng.uniform(size=nq) * (1 - frac)
    filters = np.stack([lo, lo + frac], axis=1)
    cache = str(tmp_path) + "/"
    results = []
    for mod in (JWA, PWA):
        extra = {"device": "cpu"} if mod is PWA else {}
        bp = mod.BuildParams(R=12, L=24, alpha=1.2, cache_path=cache)
        idx = getattr(mod, name)(points, labels, build_params=bp, **kw, **extra)
        qp = mod.build_query_params(k, 20, final_beam_multiply=2)
        args = (queries, filters, nq) + ((method,) if method else ()) + (qp,)
        results.append(idx.batch_search(*args))
    (wi, wd), (gi, gd) = results
    assert gi.dtype == np.uint32 and gd.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    if exact:
        gt_ids, gt_d = gt_fn(points, labels, queries, filters, k, "l2")
        np.testing.assert_array_equal(gi.astype(np.int64), gt_ids)
        np.testing.assert_allclose(gd, gt_d, rtol=RTOL, atol=ATOL)
