"""The PyTorch port's experiment layer against the JAX package's.

The same seeds go through both packages' generators: every protocol file
must be equal bit for bit, except the ground-truth ids, which must be equal
where the exact answer is not decided by a near-tie (tolerance below). The
JAX benchmark driver runs first (in a subprocess, from a temporary working
directory), then the port's, with `--device cpu`, in the same directory, so
that the port loads the JAX-built graphs from `index_cache/`; their CSV rows
must agree in filter width, method and recall. The host-side analyses, the
CSV writer of the baseline runners and their clean skips must give the
JAX package's answers on the same inputs. Port modules run on the CPU with
torch on one thread, as the other port test files do.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import csv
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rangefilteredann_tpu.experiments import analyze_graphs as j_analyze
from rangefilteredann_tpu.experiments import arrangements as j_arr
from rangefilteredann_tpu.experiments import create_table as j_table
from rangefilteredann_tpu.experiments import datasets as jds
from rangefilteredann_tpu.experiments import plot as j_plot
from rangefilteredann_tpu.experiments import run_milvus as j_milvus
from rangefilteredann_tpu.experiments import run_msvbase as j_msvbase
from rangefilteredann_tpu.experiments import triangle_coverage as j_tri
from rangefilteredann_tpu_torch.experiments import all_memories as p_allmem
from rangefilteredann_tpu_torch.experiments import analyze_graphs as p_analyze
from rangefilteredann_tpu_torch.experiments import arrangements as p_arr
from rangefilteredann_tpu_torch.experiments import branching_study as p_branch
from rangefilteredann_tpu_torch.experiments import create_table as p_table
from rangefilteredann_tpu_torch.experiments import datasets as pds
from rangefilteredann_tpu_torch.experiments import memory_footprint as p_mem
from rangefilteredann_tpu_torch.experiments import nn_scaling as p_nn
from rangefilteredann_tpu_torch.experiments import plot as p_plot
from rangefilteredann_tpu_torch.experiments import plot_adversarial as p_plot_adv
from rangefilteredann_tpu_torch.experiments import run_milvus as p_milvus
from rangefilteredann_tpu_torch.experiments import run_msvbase as p_msvbase
from rangefilteredann_tpu_torch.experiments import run_our_method as p_driver
from rangefilteredann_tpu_torch.experiments import triangle_coverage as p_tri

# Ground-truth ids are held equal on a query when its 10th and 11th true
# (float64) distances differ by more than this; below it the two packages'
# float32 products may order the tie either way. Order within the top 10 is
# held too where every gap among the first 11 exceeds it.
GT_TIE_TOL = 1e-4

# The driver's tiny dataset and its one-point sweep: one width, one beam and
# one multiply, so should_break (which reads wall times) cannot cut one
# driver's sweep and not the other's.
DRV_NAME = "synthetic-16-euclidean"
DRV_ARGS = ["--dataset", DRV_NAME, "--data_folder", "data",
            "--experiment_filter_width", "2pow-2", "--beam_search_size", "10",
            "--num_final_multiplies", "2", "--build_R", "16", "--build_L", "32",
            "--cutoff", "250", "--no_warmup", "--prefiltering", "--postfiltering",
            "--vamana_tree", "--optimized_postfiltering", "--smart_combined",
            "--three_split"]
DRV_METHODS = ("prefiltering", "postfiltering", "vamana-tree",
               "optimized-postfiltering", "smart-combined", "three-split")


# ------------------------------------------------------------ generation
def _true_dists(data, queries, labels, ranges, angular):
    """[nq] float64 distances of each query's window points (inclusive at
    both ends), sorted, and the matching original ids."""
    out = []
    for q, (lo, hi) in zip(queries.astype(np.float64), ranges):
        cand = np.nonzero((labels >= lo) & (labels <= hi))[0]
        x = data[cand].astype(np.float64)
        d = -(x @ q) if angular else ((x - q) ** 2).sum(1)
        order = np.lexsort((cand, d))
        out.append((d[order], cand[order]))
    return out


def _assert_gt_equal(folder, name, angular, jgt, pgt, ranges):
    data = np.load(os.path.join(folder, f"{name}.npy"))
    queries = np.load(os.path.join(folder, f"{name}_queries.npy"))
    labels = np.load(os.path.join(folder, f"{name}_filter-values.npy"))
    decided = ordered = 0
    for i, (d, ids) in enumerate(_true_dists(data, queries, labels, ranges, angular)):
        k = jgt.shape[1]
        if len(d) > k and d[k] - d[k - 1] <= GT_TIE_TOL:
            continue
        decided += 1
        assert set(jgt[i].tolist()) == set(pgt[i].tolist()), i
        assert set(pgt[i].tolist()) == set(ids[:k].tolist()), i
        if (np.diff(d[: k + 1]) > GT_TIE_TOL).all():
            ordered += 1
            np.testing.assert_array_equal(jgt[i], pgt[i])
    assert decided >= 0.9 * len(jgt) and ordered > 0


@pytest.mark.parametrize("kind", ["synthetic", "adversarial"])
def test_generated_files_match_jax(tmp_path, kind):
    """Both generators at the same seed write the same file set; points,
    queries, labels and ranges are equal bit for bit, ground-truth ids up to
    GT_TIE_TOL (the port runs its plain versions, device="cpu")."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind == "synthetic":
        name, angular = "synthetic-16-euclidean", False
        kw = dict(n=3000, d=16, nq=20)
        jds.generate_synthetic(jdir, name, **kw)
        pds.generate_synthetic(pdir, name, device="cpu", **kw)
    else:
        name, angular = "adversarial-100-angular", True
        kw = dict(n=5000, n_clusters=10, d=16, nq=50)
        jds.generate_adversarial(jdir, **kw)
        pds.generate_adversarial(pdir, device="cpu", **kw)
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(pdir))
    gts = [f for f in files if f.endswith("_gt.npy")]
    assert len(gts) == (9 if kind == "synthetic" else 1)  # fractions with >= 10 points
    for f in files:
        j, p = np.load(os.path.join(jdir, f)), np.load(os.path.join(pdir, f))
        assert j.dtype == p.dtype and j.shape == p.shape, f
        if f in gts:
            ranges = np.load(os.path.join(pdir, f.replace("_gt.npy", "_ranges.npy")))
            _assert_gt_equal(pdir, name, angular, j, p, ranges)
        else:
            assert j.tobytes() == p.tobytes(), f


@pytest.mark.parametrize("fraction,follow", [(2.0**-4, True), (1, True), (2.0**-3, False)])
def test_query_filter_ranges_match_jax(fraction, follow):
    fv = np.random.default_rng(1).uniform(size=4000)
    want = jds.generate_random_query_filter_ranges(
        fv, fraction, 30, np.random.default_rng(9), follow)
    got = pds.generate_random_query_filter_ranges(
        fv, fraction, 30, np.random.default_rng(9), follow)
    assert want.dtype == got.dtype and want.tobytes() == got.tobytes()


def test_protocol_names_match_jax(tmp_path):
    assert pds.DATASETS == jds.DATASETS and pds.TOP_K == jds.TOP_K
    assert pds.EXPERIMENT_FILTER_POWERS == jds.EXPERIMENT_FILTER_POWERS
    for name in pds.DATASETS + ["synthetic-64-euclidean"]:
        assert pds.metric_of(name) == jds.metric_of(name)
    pds.generate_synthetic(str(tmp_path), "toy-8-angular", n=400, d=8, nq=5,
                           powers=[-1], device="cpu")
    for a, b in zip(pds.initialize_dataset("toy-8-angular", str(tmp_path)),
                    jds.initialize_dataset("toy-8-angular", str(tmp_path))):
        if isinstance(a, str):
            assert a == b == "mips"
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pds.get_queries_and_gt("toy-8-angular", "2pow-1", str(tmp_path)),
                    jds.get_queries_and_gt("toy-8-angular", "2pow-1", str(tmp_path))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        pds.get_queries_and_gt("toy-8-angular", "2pow-2", str(tmp_path))


def test_converters_raise_without_inputs(tmp_path):
    """The converters of downloaded sets keep their gated imports and fail
    clearly without their files, as the JAX package's do."""
    for mod in (jds, pds):
        with pytest.raises((ImportError, OSError, FileNotFoundError)):
            mod.convert_ann_benchmarks_hdf5(str(tmp_path / "none.hdf5"),
                                            str(tmp_path), "x-8-angular")
        with pytest.raises(FileNotFoundError):
            mod.convert_redcaps(str(tmp_path / "e.npy"), str(tmp_path / "t.npy"),
                                str(tmp_path / "q.npy"), str(tmp_path))


def test_redcaps_converter_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    emb, ts, qs = (str(tmp_path / f) for f in ("e.npy", "t.npy", "q.npy"))
    np.save(emb, rng.normal(size=(600, 8)).astype(np.float32))
    np.save(ts, rng.integers(1_500_000_000, 1_600_000_000, size=600))
    np.save(qs, rng.normal(size=(6, 8)).astype(np.float32))
    jds.convert_redcaps(emb, ts, qs, str(tmp_path / "j"), "toy-8-angular")
    pds.convert_redcaps(emb, ts, qs, str(tmp_path / "p"), "toy-8-angular", device="cpu")
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p")) and len(files) > 3
    for f in files:
        j, p = np.load(tmp_path / "j" / f), np.load(tmp_path / "p" / f)
        if f.endswith("_gt.npy"):
            ranges = np.load(tmp_path / "p" / f.replace("_gt.npy", "_ranges.npy"))
            _assert_gt_equal(str(tmp_path / "p"), "toy-8-angular", True, j, p, ranges)
        else:
            assert j.tobytes() == p.tobytes(), f


# ---------------------------------------------------------------- driver
def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """One tiny synthetic folder; the JAX driver, then the port's on the
    same index_cache/. Returns both CSVs' rows and the cache files' mtimes
    before and after the port's run."""
    work = tmp_path_factory.mktemp("driver")
    pds.generate_synthetic(str(work / "data"), DRV_NAME, n=2000, d=16, nq=40,
                           powers=[-2], device="cpu")
    code = ("import sys\n"
            "from rangefilteredann_tpu.experiments import run_our_method as r\n"
            "r.main(sys.argv[1:] + ['--results_file_prefix', 'jax-'])\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code, *DRV_ARGS], cwd=work, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]

    def mtimes():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for d, _, fs in os.walk(work / "index_cache") for f in fs}

    before = mtimes()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        p_driver.main(DRV_ARGS + ["--results_file_prefix", "port-", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return dict(work=work, before=before, after=mtimes(),
                jax=_rows(work / "results" / f"jax-{DRV_NAME}_results.csv"),
                port=_rows(work / "results" / f"port-{DRV_NAME}_results.csv"))


def test_driver_loads_the_jax_graphs(drivers):
    """The port built no graph: every cache file the JAX driver wrote is
    there untouched, and the port wrote none of its own."""
    assert drivers["after"] == drivers["before"]
    assert any(f.endswith(".npz") for f in drivers["before"])


@pytest.mark.parametrize("family", DRV_METHODS)
def test_driver_rows_match_jax(drivers, family):
    """Row for row, the CSVs agree in filter width, method and recall
    (exactly); `threads` records each package's own devices."""
    j = [r for r in drivers["jax"] if r["method"].split("_")[0] == family]
    p = [r for r in drivers["port"] if r["method"].split("_")[0] == family]
    assert len(j) == len(p) == 1
    assert list(j[0]) == list(p[0])  # the reference CSV schema
    for key in ("filter_width", "method", "recall", "branching_factor"):
        assert j[0][key] == p[0][key], key
    assert p[0]["threads"] == "1" and float(p[0]["qps"]) > 0
    if family == "prefiltering":
        assert float(p[0]["recall"]) == 1.0


def test_driver_helpers_match_jax():
    from rangefilteredann_tpu.experiments import run_our_method as j_driver

    for name in ("TOP_K", "BEAM_SIZES", "FINAL_MULTIPLIES", "ALPHAS",
                 "VAMANA_TREE_SPLIT_FACTORS", "SUPER_POSTFILTERING_SPLIT_FACTORS",
                 "SUPER_POSTFILTERING_SHIFT_FACTORS", "EXPERIMENT_FILTER_WIDTHS"):
        assert getattr(p_driver, name) == getattr(j_driver, name), name
    rng = np.random.default_rng(4)
    gt = rng.integers(0, 50, size=(12, 10))
    res = np.where(rng.random((12, 10)) < 0.7, gt, rng.integers(50, 99, size=(12, 10)))
    assert p_driver.compute_recall(res, gt, 10) == j_driver.compute_recall(res, gt, 10)
    runs = [("w", "prefiltering", 1.0, 2.0), ("w", "a_10_1", 0.5, 1.0),
            ("w", "a_10_2", 0.6, 1.5), ("w", "a_20_2", 0.6, 1.0),
            ("w", "a_40_2", 0.7, 3.0), ("w", "a_80_2", 0.9995, 1.0)]
    for i in range(len(runs) + 1):
        assert p_driver.should_break(runs[:i]) == j_driver.should_break(runs[:i]), i


def test_no_device_means_the_card(tmp_path, monkeypatch):
    """The driver's default --device is the card: without one it raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks a machine without one")
    pds.generate_synthetic(str(tmp_path / "data"), "toy-8-euclidean", n=300, d=8,
                           nq=4, powers=[-1], device="cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        p_driver.main(["--dataset", "toy-8-euclidean", "--data_folder", "data",
                       "--prefiltering", "--experiment_filter_width", "2pow-1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pds.generate_synthetic(str(tmp_path / "d2"), "toy-8-euclidean", n=300, d=8,
                               nq=4, powers=[-1])


# ---------------------------------------------------------- host modules
TABLE_ROWS = [
    "filter_width,method,recall,average_time,qps,threads",
    "_2pow-2_,vamana-tree_40_2,0.95,0.001,1000.0,1",
    "_2pow-2_,optimized-postfiltering_80_2,0.99,0.001,3000.0,1",
    "_2pow-2_,postfiltering_40_2,0.92,0.001,500.0,1",
    "_2pow-2_,milvus_16,0.91,0.001,250.0,1",
    "_2pow-2_,vamana-tree_10_2,0.50,0.001,9999.0,1",
    "_2pow-3_,vamana-tree_40_2,0.95,0.001,800.0,1",
    "2pow-1,three-split_40_2,0.999,0.001,700.0,1",
    "2pow-1,prefiltering,1.0,0.001,350.0,1",
]


def test_create_table_matches_jax(tmp_path, capsys):
    (tmp_path / "sift-128-euclidean_run.csv").write_text("\n".join(TABLE_ROWS))
    for width in ("2pow-1", "2pow-2", "2pow-3"):
        for thr in p_table.RECALL_THRESHOLDS:
            a = p_table.speedup_of_our_best_method("sift-128-euclidean", width, thr,
                                                   results_dir=str(tmp_path))
            b = j_table.speedup_of_our_best_method("sift-128-euclidean", width, thr,
                                                   results_dir=str(tmp_path))
            assert (math.isnan(a) and math.isnan(b)) or a == b
    p_table.main(datasets=["sift-128-euclidean", "glove-100-angular"],
                 results_dir=str(tmp_path))
    got = capsys.readouterr().out
    j_table.main(datasets=["sift-128-euclidean", "glove-100-angular"],
                 results_dir=str(tmp_path))
    want = capsys.readouterr().out
    assert got == want and "6.00" in got and r"\toprule" in got


def test_pareto_and_arrangements_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(5):
        rec, qps = rng.random(40), rng.random(40) * 1e4
        for a, b in zip(p_plot.pareto_front(rec, qps), j_plot.pareto_front(rec, qps)):
            np.testing.assert_array_equal(a, b)
    for split in (1.5, 2.0, 3.0):
        for shift in (0.25, 0.5, 0.9):
            assert p_arr.arrangement_cost(200_000, 1000, split, shift) == \
                j_arr.arrangement_cost(200_000, 1000, split, shift)


def test_arrangements_main_matches_jax(capsys):
    p_arr.main(["--n", "100000"])
    got = capsys.readouterr().out
    j_arr.main(["--n", "100000"])
    assert got == capsys.readouterr().out and "Pareto-optimal" in got


def test_analyze_graphs_matches_jax(tmp_path, capsys):
    """One .npz row cache and one reference-format graph file: the same
    statistics line from both packages."""
    from rangefilteredann_tpu_torch.utils.io import write_graph_file

    rng = np.random.default_rng(6)
    nbrs = rng.integers(0, 300, size=(300, 12)).astype(np.int32)
    nbrs[rng.random((300, 12)) < 0.3] = -1
    nbrs = -np.sort(-nbrs, axis=1)  # real ids first, padding last
    nbrs[:4] = -1  # isolated nodes
    np.savez(tmp_path / "row.npz", nbrs=nbrs, fp=np.zeros(2))
    write_graph_file(str(tmp_path / "g.bin"), nbrs)
    for f in ("row.npz", "g.bin"):
        assert p_analyze.analyze_file(str(tmp_path / f)) == \
            j_analyze.analyze_file(str(tmp_path / f))
    p_analyze.main([str(tmp_path)])
    got = capsys.readouterr().out
    j_analyze.main([str(tmp_path)])
    assert got == capsys.readouterr().out and "isolated=4" in got


def test_triangle_coverage_matches_jax(tmp_path):
    assert p_tri.coverage_triangle(0.25, 0.5) == j_tri.coverage_triangle(0.25, 0.5)
    for split, shift in ((2.0, 0.5), (3.0, 0.75)):
        pl = p_tri.super_tree_placements(split, shift, 1 / 64)
        assert pl == j_tri.super_tree_placements(split, shift, 1 / 64)
        assert p_tri.evaluate(pl, res=256) == j_tri.evaluate(pl, res=256)
    out = tmp_path / "t.png"
    fill, cost = p_tri.main(["--out", str(out)])
    assert (fill, cost) == j_tri.evaluate(j_tri.super_tree_placements(2.0, 0.5, 1 / 64))
    assert out.stat().st_size > 1000


def test_plots_render(tmp_path):
    """The plots read the reference CSV schema and render (matplotlib Agg,
    imported at call time); load_results gives the JAX package's frame."""
    (tmp_path / "sift-128-euclidean_run.csv").write_text("\n".join(TABLE_ROWS))
    a = p_plot.load_results("sift-128-euclidean", str(tmp_path))
    b = j_plot.load_results("sift-128-euclidean", str(tmp_path))
    assert a.equals(b)
    out = p_plot.plot("sift-128-euclidean", str(tmp_path), out=str(tmp_path / "p.png"))
    assert os.path.getsize(out) > 1000
    adv = tmp_path / "adversarial_1m.csv"
    adv.write_text("filter_width,method,recall,average_time,qps,threads\n"
                   "cluster-1,prefiltering,1.0,0.001,1000.0,1\n"
                   "cluster-1,postfiltering_40_2,0.55,0.0005,2000.0,1\n"
                   "cluster-1,vamana-tree_40_2,0.99,0.001,900.0,1\n")
    p_plot_adv.plot(str(adv), out=str(tmp_path / "adv.png"))
    assert (tmp_path / "adv.png").stat().st_size > 1000


def test_save_row_matches_jax(tmp_path):
    for mod, sub in ((p_milvus, "p"), (j_milvus, "j")):
        d = str(tmp_path / sub)
        mod.save_row(d, "sift-128-euclidean", "2pow-2", "milvus-HNSW_40", 0.987,
                     0.000123, 8130.1, 16, build_time=42.5)
        mod.save_row(d, "sift-128-euclidean", "2pow-3", "msvbase", 0.9, 0.001,
                     1000.0, 16)
    name = "sift-128-euclidean_results.csv"
    assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert p_milvus.INDEX_TYPES == j_milvus.INDEX_TYPES
    assert p_milvus.SEARCH_GRIDS == j_milvus.SEARCH_GRIDS


def test_baseline_runners_skip_like_jax(capsys):
    """Without pymilvus / psycopg2 or a server, both runners print the JAX
    runners' lines and return (a local port no server listens on)."""
    outs = []
    for milvus, msvbase in ((p_milvus, p_msvbase), (j_milvus, j_msvbase)):
        milvus.run("nonexistent-dataset", "HNSW", host="127.0.0.1", port=1)
        msvbase.run("nonexistent-dataset", host="127.0.0.1", port=1)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "skipping" in outs[0]


# ----------------------------------------------- drivers of the studies
def test_memory_footprint_counts_each_storage_once():
    """device_bytes over a CPU index: the sum of its distinct storages; a
    view of a counted tensor adds nothing, a new tensor adds its bytes."""
    from rangefilteredann_tpu.experiments.memory_footprint import device_bytes as j_bytes
    import rangefilteredann_tpu as J
    import rangefilteredann_tpu_torch as P

    rng = np.random.default_rng(7)
    x = rng.normal(size=(500, 12)).astype(np.float32)
    labels = rng.uniform(size=500)
    nbrs = rng.integers(0, 500, size=(500, 8)).astype(np.int32)
    idx = P.PostfilterVamanaIndex.from_arrays(
        *_store_of(P.PrefilterIndex(x, labels, device="cpu")), nbrs, device="cpu")
    storages = {}
    for obj in (idx._ps, idx._graph):
        for v in vars(obj).values():
            if isinstance(v, torch.Tensor):
                st = v.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
    want = sum(storages.values())
    assert want >= idx._ps.data.numel() * 4 + nbrs.nbytes
    # the index also keeps its sorted labels (float64) on the device, where
    # it searches its window bounds
    want += labels.nbytes
    assert p_mem.device_bytes(idx) == want
    idx.views = [idx._ps.data[3:7], idx._ps.data.view(-1), idx._graph.nbrs_dev.t()]
    assert p_mem.device_bytes(idx) == want
    idx.extra = torch.zeros(1000)
    assert p_mem.device_bytes(idx) == want + 4000
    pre = P.PrefilterIndex(x, labels, device="cpu")
    # the port's prefilter also keeps its sorted labels (float64) on the device,
    # where it searches its window bounds
    assert p_mem.device_bytes(pre) == j_bytes(J.PrefilterIndex(x, labels)) + labels.nbytes


def _store_of(pre):
    ps = pre._ps
    return (ps.data.numpy(), ps.norms_sq.numpy(), ps.n, ps.d, "Euclidian", ps.norm_col,
            pre._labels_sorted, pre._decoding)


def test_memory_study_drivers(tmp_path, monkeypatch, capsys):
    """memory_footprint.main writes its CSV row; all_memories starts the
    port's own module (not the JAX package's) with the device passed on."""
    pds.generate_synthetic(str(tmp_path / "data"), "toy-8-euclidean", n=500, d=8,
                           nq=4, powers=[-1], device="cpu")
    monkeypatch.chdir(tmp_path)
    p_mem.main(["--method", "prefiltering", "--dataset", "toy-8-euclidean",
                "--data_folder", "data", "--device", "cpu"])
    lines = (tmp_path / "results" / "memory.csv").read_text().splitlines()
    assert lines[0] == "method,dataset,memory,hbm_bytes"
    assert lines[1].startswith("prefiltering,toy-8-euclidean,")
    assert int(lines[1].split(",")[3]) == 4096 * 128 * 4 + 4096 * 4 + 500 * 8  # + labels
    started = []
    monkeypatch.setattr(p_allmem.subprocess, "run",
                        lambda cmd: started.append(cmd) or subprocess.CompletedProcess(cmd, 0))
    p_allmem.main(["toy-8-euclidean", "--methods", "prefiltering", "postfiltering",
                   "--device", "cpu"])
    assert len(started) == 2
    for cmd, method in zip(started, ("prefiltering", "postfiltering")):
        assert cmd[1:3] == ["-m", "rangefilteredann_tpu_torch.experiments.memory_footprint"]
        assert cmd[cmd.index("--method") + 1] == method
        assert cmd[cmd.index("--device") + 1] == "cpu"


def test_branching_and_scaling_studies(tmp_path, capsys):
    """The two studies build and search through the port on the CPU: the
    branching study's CSV row reaches graph recall, the scaling table has
    a row a size."""
    out = tmp_path / "branching.csv"
    p_branch.main(["--n", "800", "--d", "8", "--nq", "16", "--splits", "2",
                   "--cutoff", "200", "--fractions", "-1", "--beam", "20",
                   "--out", str(out), "--device", "cpu"])
    rows = _rows(out)
    assert [r["split_factor"] for r in rows] == ["2"] and rows[0]["filter_width"] == "2pow-1"
    assert float(rows[0]["recall"]) >= 0.9
    p_nn.main(["--sizes", "300,600", "--d", "8", "--nq", "16", "--beam", "16",
               "--R", "8", "--L", "16", "--device", "cpu"])
    table = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in table if ln.strip()[:1].isdigit()][-2:] == ["300", "600"]


# --------------------------------------------------------- QueryStats
def test_add_beam_result_matches_jax(capsys):
    """The same BeamResult counters folded into both packages' QueryStats
    (repeated query ids accumulate; rows past the ids are padding)."""
    import jax.numpy as jnp

    from rangefilteredann_tpu.ops.beam_search import BeamResult as JBeamResult
    from rangefilteredann_tpu.utils.stats import QueryStats as JQueryStats
    from rangefilteredann_tpu_torch.ops.beam_search import BeamResult
    from rangefilteredann_tpu_torch.utils.stats import QueryStats

    rng = np.random.default_rng(8)
    p, j = QueryStats(50), JQueryStats(50)
    for _ in range(3):
        q = 40
        vis = rng.integers(0, 300, size=q).astype(np.int32)
        cmps = rng.integers(0, 5000, size=q).astype(np.int32)
        ids = rng.integers(0, 50, size=q - 8)
        empty = np.zeros((q, 0), np.int32)
        p.add_beam_result(ids, BeamResult(*(torch.from_numpy(a) for a in (
            empty, empty.astype(np.float32), vis, cmps, empty, empty.astype(np.float32)))))
        j.add_beam_result(ids, JBeamResult(*(jnp.asarray(a) for a in (
            empty, empty.astype(np.float32), vis, cmps, empty, empty.astype(np.float32)))))
    np.testing.assert_array_equal(p.visited, j.visited)
    np.testing.assert_array_equal(p.distances, j.distances)
    assert p.visited.sum() > 0
    assert p.visited_stats() == j.visited_stats() and p.dist_stats() == j.dist_stats()
    p.print()
    got = capsys.readouterr().out
    j.print()
    assert got == capsys.readouterr().out


# ---------------------------------------------------------------- imports
def test_experiments_import_no_jax(tmp_path):
    """Every module of the port's experiment layer imports, and
    generate_synthetic runs on the CPU, without loading jax or any module
    of the JAX package."""
    mods = ["all_memories", "analyze_graphs", "arrangements", "branching_study",
            "create_table", "datasets", "memory_footprint", "nn_scaling", "plot",
            "plot_adversarial", "run_milvus", "run_msvbase", "run_our_method",
            "triangle_coverage"]
    code = (
        "import importlib, sys\n"
        "import rangefilteredann_tpu_torch.experiments\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('rangefilteredann_tpu_torch.experiments.' + m)\n"
        "from rangefilteredann_tpu_torch.experiments import datasets\n"
        f"datasets.generate_synthetic({str(tmp_path)!r}, n=600, d=8, nq=5,"
        " powers=[-2, 0], device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rangefilteredann_tpu' or m.startswith('rangefilteredann_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(os.listdir(tmp_path)) == 7
