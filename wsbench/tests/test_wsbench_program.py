"""The readers of the program's own spans and counters (wsbench/program.py
and the metrics that use it): each on a synthetic profile worked out by
hand, the older readers unchanged beside the program's spans, nothing read
from a program that lacks them, and a traced run that switches the
program's tracing on and off."""

import json

import numpy as np
import pytest

import rangefilteredann_tpu_torch as P
from rangefilteredann_tpu_torch.models import base
from rangefilteredann_tpu_torch.utils import trace as port_trace
from wsbench import catalog, harness, program, spans
from wsbench.harness import RunView
from wsbench.trace import Trace

from conftest import tiny_cell
from test_wsbench_metrics import EXPECTED, ev, synthetic

PRE, POST = "prefilter-1m-d128.frac2-2", "postfilter-200k-d128.frac2-2"
NEW = {  # metric -> value on the synthetic profile (two batches)
    "prefilter.plan_ms": (2 + 4 + 2) / 2 * 1e-3,  # not the upload of batch 2
    "scan.plan_ms": 1 / 2 * 1e-3,
    "base.finalize_ms": (10 + 1 + 3) / 2 * 1e-3,
    "postfilter.planner_ms": (43 + 20 - 18 - 4 - 1) / 2 * 1e-3,  # not batch 1's copies
    "postfilter.rounds": 3 / 2,
    "base.uploads": 8 / 2,
    "base.fetches": 6 / 2,
}
COUNTERS = {"ops.scan.SCAN_LAUNCHES": 2, "ops.beam.BEAM_LAUNCHES": 6,
            "models.base.UPLOADS": 8, "models.base.FETCHES": 6,
            "models.postfilter_vamana.ROUNDS": 3}


@pytest.fixture(autouse=True)
def tracing_off():
    port_trace.set_tracing(False)
    yield
    port_trace.set_tracing(False)


def program_events():
    """The program's spans inside the synthetic profile's two batches: a
    prefilter batch (0-100) and a postfilter batch (200-300)."""
    u = lambda name, ts, dur: ev("user_annotation", name, ts, dur)  # noqa: E731
    return [
        u("prefilter.batch", 1, 98), u("prefilter.pad", 2, 2),
        u("prefilter.window_bounds", 4, 4), u("base.upload", 8, 2),
        u("scan.plan", 10.5, 1), u("scan.kernel", 11.5, 4.5),
        u("base.fetch", 40, 16), u("base.finalize", 60, 10),
        u("postfilter.batch", 201, 98), u("postfilter.pad", 202, 1),
        u("base.finalize", 203, 1), u("postfilter.window_bounds", 204, 2),
        u("postfilter.round", 207, 43), u("postfilter.search", 208, 15),
        u("base.upload", 208, 1), u("beam.start", 209, 1), u("beam.kernel", 211, 2),
        u("beam_search.window_filter", 220, 1), u("base.fetch", 223, 18),
        u("postfilter.final", 252, 20), u("base.fetch", 267, 4),
        u("base.finalize", 280, 3),
    ]


def with_program(tmp_path, names=None):
    """The synthetic profile with the program's spans, reduced to `names`
    (all of them by default); returns the trace and its file."""
    synthetic(tmp_path)
    path = tmp_path / "trace.json"
    doc = json.loads(path.read_text())
    doc["traceEvents"] += program_events()
    path.write_text(json.dumps(doc))
    return Trace.from_chrome(str(path), program.all_span_names() if names is None
                             else names), path


def view(t, name=PRE, counters=COUNTERS):
    return RunView(cell=catalog.cell(name), trace=t, batches=2, which=np.array([0, 1]),
                   counters=dict(counters),
                   timers={"models.vamana.build_vamana_graph": [30.5]},
                   windows=[(np.array([0, 100]), np.array([50, 200])),
                            (np.array([0]), np.array([10]))])


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_reader(tmp_path, name):
    t, _ = with_program(tmp_path)
    assert catalog.metric(name).read(view(t)) == pytest.approx(NEW[name])


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_reader_reads_the_written_trace(tmp_path, name, monkeypatch):
    """Where the harness's reduction holds only its own spans, the reader
    reads the trace file the harness wrote for the cell."""
    t, path = with_program(tmp_path, names={spans.BATCH} | {
        s[0] for s in spans.BREAKDOWN_SPANS})
    monkeypatch.setattr(program, "OUT", tmp_path)
    path.rename(tmp_path / f"trace-{PRE}.json")
    assert catalog.metric(name).read(view(t)) == pytest.approx(NEW[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_older_reader_unchanged_by_program_spans(tmp_path, name):
    t, _ = with_program(tmp_path)
    before = catalog.metric(name).read(view(synthetic(tmp_path)))
    assert catalog.metric(name).read(view(t)) == pytest.approx(before)
    assert before == pytest.approx(EXPECTED[name])


def test_nothing_read_from_a_program_without_them(tmp_path, monkeypatch):
    """An older program: no SPANS, no set_tracing, no counters. The readers
    declare no counter, switch nothing, raise nothing and return None."""
    for mod, attr in ((P, "SPANS"), (P, "set_tracing"), (base, "UPLOADS"),
                      (base, "FETCHES")):
        monkeypatch.delattr(mod, attr)
    from rangefilteredann_tpu_torch.models import postfilter_vamana as pv

    monkeypatch.delattr(pv, "ROUNDS")
    t, _ = with_program(tmp_path, names={spans.BATCH})
    old = {k: v for k, v in COUNTERS.items() if k.startswith("ops.")}
    for name in NEW:
        mod = catalog.metric(name)
        assert mod.COUNTERS == []
        assert mod.read(view(t, counters=old)) is None, name
    assert not port_trace._on


def test_nothing_read_in_a_cpu_run(tmp_path):
    path = tmp_path / "cpu.json"
    path.write_text(json.dumps({"traceEvents": [ev("user_annotation", spans.BATCH, 0, 10)]
                                + program_events()[:4]}))
    t = Trace.from_chrome(str(path), program.all_span_names())
    for name in NEW:
        assert catalog.metric(name).read(view(t)) is None, name


def test_instruments_switch_tracing_on_and_reading_off(tmp_path):
    readers = [m for _, m in catalog.cell(POST).per_layer]
    inst = spans.Instruments(readers)
    assert port_trace._on
    assert {c[0] for c in inst.counters} >= {"models.base.UPLOADS", "models.base.FETCHES",
                                             "models.postfilter_vamana.ROUNDS"}
    assert set(inst.read_counters()) == {c[0] for c in inst.counters}
    t, _ = with_program(tmp_path)
    catalog.metric("base.uploads").read(view(t, POST))
    assert not port_trace._on
    spans.Instruments([])  # no reader: nothing switched
    assert not port_trace._on


def test_traced_cpu_run_records_the_program_spans():
    cell = tiny_cell(PRE)
    r = harness.run_cell(cell, 2**31 + 7, 0.2, True, device="cpu")
    assert r["correct"] and not port_trace._on
    assert not set(r["metrics"]) & set(NEW)  # no device: nothing to read
    t = Trace.from_chrome(str(harness.OUT / f"trace-{cell.name}.json"),
                          program.all_span_names())
    names = {s[0] for s in t.spans}
    assert {"prefilter.batch", "prefilter.pad", "prefilter.window_bounds", "base.upload",
            "base.fetch", "base.finalize"} <= names
    assert len(t.intervals("prefilter.batch")[0]) == len(t.intervals(spans.BATCH)[0])


def test_breakdown_names_the_program_spans(tmp_path, capsys):
    _, path = with_program(tmp_path)
    assert program.main([str(path)]) == 0
    out = json.loads(capsys.readouterr().out)
    idle = dict(out["idle_gaps"])
    assert idle["scan.plan"] == pytest.approx(1e-6)  # 10.5..11.5, before the kernel ran
    assert idle["scan.kernel"] == pytest.approx(4.5e-6)
    assert idle["ops.scan.scan_topk"] == pytest.approx(4.5e-6)  # 10..10.5 and 16..20
    assert out["idle_s"] == pytest.approx((300 - 75) * 1e-6)
    host = out["host_s"]
    assert host["postfilter.round"] == pytest.approx([1, 43e-6, (43 - 15 - 18) * 1e-6])
    assert host["base.fetch"] == pytest.approx([3, 38e-6, 38e-6])
    # upload, start, the harness's beam_search_inline span (210..220) and the filter
    assert host["postfilter.search"] == pytest.approx([1, 15e-6, (15 - 1 - 1 - 10 - 1) * 1e-6])
