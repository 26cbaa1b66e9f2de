"""The harness end to end at tiny sizes on the CPU, through the port's plain
versions: sound runs are correct, the control and each fault the cells can
have are not, and run.py itself refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import rangefilteredann_tpu_torch.models.postfilter_vamana as pv
import rangefilteredann_tpu_torch.models.prefilter as pf
from wsbench import catalog, harness
from wsbench.reference import FLT_MAX, PAD_ID

from conftest import TINY, tiny_cell

SEED = 2**31 + 12345  # seeds may be larger than 32 signed bits hold
PRE, POST = "prefilter-1m-d128.frac2-2", "postfilter-200k-d128.frac2-2"


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_cell_is_correct(name):
    r = harness.run_cell(tiny_cell(name), SEED, 0.2, False, device="cpu", control=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] % tiny_cell(name).traffic["batch"] == 0
    assert set(r["metrics"]) == {m["name"] for m in tiny_cell(name).end_to_end}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    # the control (float32 with TF32 products) fails the committed limits
    assert not r["control_correct"], r["control"]
    assert list(r)[-1] == "checks"


def test_traced_run_reports_its_per_layer_metrics():
    cell = tiny_cell(POST)
    r = harness.run_cell(cell, 3, 0.2, True, device="cpu")
    assert r["correct"]
    # no device ran: only the readers of counters, spans and timers report
    assert set(r["metrics"]) == {"beam_search.launches", "postfilter.plain_searches",
                                 "vamana.build_s"}
    assert r["metrics"]["postfilter.plain_searches"]["value"] > 0  # the CPU's plain route
    assert r["device"]["window_s"] > 0 and r["breakdown"]["idle_gaps"]


def test_same_seed_same_inputs():
    from wsbench.data import generate

    cell = tiny_cell(PRE)
    a, b = (generate(cell.config, cell.traffic, SEED, cell.generator, "cpu") for _ in range(2))
    c = generate(cell.config, cell.traffic, SEED + 1, cell.generator, "cpu")
    assert np.array_equal(a.points, b.points) and np.array_equal(a.filters, b.filters)
    assert not np.array_equal(a.points, c.points)
    w = a.filters[..., 1] - a.filters[..., 0]
    assert np.allclose(w, 0.25) and (a.filters[..., 0] >= 0).all() and (a.filters[..., 1] <= 1).all()


def stale(cls):
    """Each call returns the previous call's answers: state left unchanged."""
    real, last = cls.batch_search, []

    def search(self, *a, **kw):
        out = real(self, *a, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return search


def half_left_out(real):
    """The second half of the batch answered with padding."""
    def finalize(*a, **kw):
        ids, d = real(*a, **kw)
        h = len(ids) // 2
        ids[h:], d[h:] = PAD_ID, FLT_MAX
        return ids, d
    return finalize


def altered(real):
    """One answer changed where it is produced: another point's id."""
    def finalize(*a, **kw):
        ids, d = real(*a, **kw)
        ids[0, 0] = (int(ids[0, 0]) + 1) % 1000
        return ids, d
    return finalize


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", [PRE, POST])
def test_each_fault_is_caught(name, fault, monkeypatch):
    mod, cls = (pf, pf.PrefilterIndex) if name == PRE else (pv, pv.PostfilterVamanaIndex)
    if fault == "stale":
        monkeypatch.setattr(cls, "batch_search", stale(cls))
    else:
        wrap = half_left_out if fault == "half" else altered
        monkeypatch.setattr(mod, "finalize_output", wrap(mod.finalize_output))
    r = harness.run_cell(tiny_cell(name), 5, 0.2, False, device="cpu")
    assert not r["correct"], r["checks"]


def run_py(cwd, *args, env=None):
    return subprocess.run([sys.executable, "wsbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120, env=env)


def test_run_py_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = run_py(catalog.REPO, "--workload", PRE, "--seed", "1", "--seconds", "1",
               "--trace", "0", env=env)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_benchmark_alone_finds_no_program(tmp_path):
    """In a directory of BENCHMARK.json and wsbench/ alone, the program is
    not there to be run (nor taken from elsewhere)."""
    shutil.copy(catalog.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(catalog.HERE, tmp_path / "wsbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    p = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
         "from wsbench import harness; harness.port()", str(tmp_path), str(catalog.REPO)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "outside this checkout" in p.stderr
    assert json.loads(json.dumps(p.stdout)) == ""


def test_window_keeps_each_distinct_answer_once():
    """Equal answers of a pool batch are kept once and counted, so the
    window's memory stays flat; a different answer is kept beside them."""
    calls = []

    def search(q, f):
        calls.append(q)
        ids = np.full((2, 3), len(calls) >= 7, dtype=np.uint32)  # changes at call 7
        return ids, np.zeros((2, 3), np.float32)

    pool = [(i, None) for i in range(3)]
    w = harness.timed_window(search, pool, 0.05, False)
    assert len(w.latency) == len(w.which) == len(calls) >= 8
    assert sum(g[2] for gs in w.groups.values() for g in gs) == len(calls)
    assert all(1 <= len(gs) <= 2 for gs in w.groups.values())
    assert len(w.groups[(7 - 1) % 3]) == 2  # call 7 went to pool batch 0


def test_generator_is_found_by_name():
    cell = tiny_cell(PRE)
    assert cell.generator.__file__ == str(catalog.HERE / "generators" / "clustered.py")
    with pytest.raises(FileNotFoundError):
        catalog.generator("no_such").make
