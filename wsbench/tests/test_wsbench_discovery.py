"""BENCHMARK.json against the benchmark format, and every part of a cell
found by name: adding a configuration, a mix, a metric or a cell adds
files and edits none."""

import json
import re
import shutil

import pytest
import torch

from wsbench import catalog, harness

from conftest import tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = catalog.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "wsbench/run.py"]
    assert BENCH["paths"] == ["wsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # the full check with 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(w):
    cell = catalog.cell(w)
    assert cell.entry["chips"] == 1
    assert {m["name"] for m in cell.end_to_end} >= {"qps", "batch_p95_ms", "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for c in BENCH["configs"]:
        if c["name"] == cell.entry["config"]:
            assert c["file"] == f"wsbench/configs/{c['name']}.json"
            assert set(c["reduced"]) == set(cell.config["reduced"])
    checks = cell.limits["checks"]
    assert set(checks) <= {"invalid", "misses", "recall", "dist_err"}
    guarantee = cell.config["guarantee"]
    if guarantee["exact"]:
        assert checks["misses"] == {"max": 0} and checks["invalid"] == {"max": 0}
    else:  # the recall limit is the configuration's own
        assert checks["recall"] == {"min": guarantee["recall_at_10"]}


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_file_matches_its_entry(entry):
    mod = catalog.metric(entry["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
        entry["unit"], entry["layer"], entry["moves"], entry["source"])
    assert callable(mod.read)
    for w in entry.get("workloads", ()):
        assert entry["moves"] in {m["name"] for m in catalog.cell(w).end_to_end}


GAUSSIAN = '''
import torch


def make(config, pool, batch, gen, device):
    n, d = int(config["n"]), int(config["d"])
    return (torch.randn(n, d, generator=gen, device=device),
            torch.rand(n, generator=gen, dtype=torch.float64, device=device),
            torch.randn(pool, batch, d, generator=gen, device=device))
'''


def test_adding_files_needs_no_edit(tmp_path):
    """A new configuration (with a new generator and another metric), mix,
    limits file and metric, each a new file beside copies of the committed
    ones, and a new cell in BENCHMARK.json: the harness finds and runs
    them."""
    for sub in ("configs", "traffic", "limits", "metrics", "generators"):
        shutil.copytree(catalog.HERE / sub, tmp_path / sub)
    (tmp_path / "generators" / "gaussian.py").write_text(GAUSSIAN)
    cfg = catalog.config("prefilter-1m-d128")
    cfg.update(n=3000, d=64, metric="mips", data={"generator": "gaussian"})
    (tmp_path / "configs" / "prefilter-3k-d64.json").write_text(json.dumps(cfg))
    mix = catalog.traffic("frac2-2")
    mix.update(batch=32, pool=2, warmup_passes=1, fraction=0.125)
    (tmp_path / "traffic" / "narrow.json").write_text(json.dumps(mix))
    name = "prefilter-3k-d64.narrow"
    (tmp_path / "limits" / f"{name}.json").write_text(
        json.dumps(catalog.limits("prefilter-1m-d128.frac2-2")))
    (tmp_path / "metrics" / "batch_count.py").write_text(
        'UNIT, LAYER, MOVES, SOURCE = "1", "device: one H100", "qps", "program_span"\n'
        "def read(run):\n    return float(run.batches)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": name, "config": "prefilter-3k-d64", "traffic": "narrow",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "batch_count", "unit": "1", "better": "higher",
                               "source": "program_span", "layer": "device: one H100",
                               "moves": "qps", "workloads": [name]})
    cell = catalog.cell(name, bench=bench, root=tmp_path)
    assert cell.config["d"] == 64 and cell.traffic["fraction"] == 0.125
    assert cell.generator.__file__ == str(tmp_path / "generators" / "gaussian.py")
    assert {m["name"] for m in cell.end_to_end} == {"qps", "batch_p95_ms", "setup_s"}
    r = harness.run_cell(cell, 7, 0.3, True, device="cpu")
    assert r["correct"], r["checks"]
    assert r["metrics"]["batch_count"]["value"] >= 1


def test_tiny_cells_resolve():
    for w in BENCH["workloads"]:
        assert tiny_cell(w["name"]).traffic["pool"] == 2
    assert torch.get_num_threads() == 1
