"""Find a cell's parts by name.

A cell of BENCHMARK.json names a configuration and a traffic mix; each is a
JSON file of its own (configs/<config>.json, traffic/<mix>.json), the
configuration's data generator is generators/<name>.py, the limits of the
cell's correctness check are limits/<cell>.json, and each per-layer metric is
a reader of its own, metrics/<metric>.py. Adding any of them adds a file (and
an entry in BENCHMARK.json), and edits nothing here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BENCHMARK = REPO / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> dict:
    return _json(path)


def config(name: str, root: Path = HERE) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = HERE) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def limits(workload: str, root: Path = HERE) -> dict:
    return _json(root / "limits" / f"{workload}.json")


def _module(kind: str, name: str, root: Path) -> ModuleType:
    """The module <kind>/<name>.py (names may hold dots, so it is loaded
    from its path and not imported by name)."""
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"wsbench_{kind}_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: Path = HERE) -> ModuleType:
    """The reader of a per-layer metric, metrics/<name>.py."""
    return _module("metrics", name, root)


def generator(name: str, root: Path = HERE) -> ModuleType:
    """A data generator, generators/<name>.py."""
    return _module("generators", name, root)


def applies(entry: dict, workload: str, e2e_names) -> bool:
    """Whether a metric of BENCHMARK.json is reported in a cell: the cells
    its `workloads` key lists, or, without the key, every cell that reports
    the end-to-end metric it moves (an end-to-end metric itself: every
    cell)."""
    if "workloads" in entry:
        return workload in entry["workloads"]
    return "moves" not in entry or entry["moves"] in e2e_names


@dataclasses.dataclass
class Cell:
    """Everything one cell is made of, read from its files."""

    name: str
    entry: dict  # the `workloads` entry
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries reported in this cell
    per_layer: list  # (BENCHMARK.json entry, reader module)
    generator: ModuleType  # the configuration's data generator


def cell(workload: str, bench: dict | None = None, root: Path = HERE) -> Cell:
    bench = benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    e2e = [m for m in bench["end_to_end"] if applies(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [(m, metric(m["name"], root)) for m in bench["per_layer"]
                 if applies(m, workload, names)]
    cfg = config(entry["config"], root)
    return Cell(name=workload, entry=entry, config=cfg,
                traffic=traffic(entry["traffic"], root),
                limits=limits(workload, root), end_to_end=e2e,
                per_layer=per_layer, generator=generator(cfg["data"]["generator"], root))
