"""The trace's reduction and each per-layer reader, on a synthetic
profiler trace whose answers are worked out by hand."""

import json

import numpy as np
import pytest

from wsbench import catalog, spans
from wsbench.harness import RunView
from wsbench.trace import Trace, merge, short_name, union_length

B = spans.BATCH


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def synthetic(tmp_path):
    """Two batches of 100 us. Batch 1: a scan span launching two kernels
    (20 + 10 us) and a copy (5 us); batch 2: a beam span launching one
    kernel (30 us), a plain-search span, a gather span launching a kernel
    (4 us), and one kernel whose launch the trace does not hold."""
    evs = [
        ev("user_annotation", B, 0, 100),
        ev("user_annotation", "ops.scan.scan_topk", 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
        ev("cuda_driver", "cuLaunchKernel", 15, 2, correlation=2),
        ev("cuda_runtime", "cudaMemcpyAsync", 40, 2, correlation=3),
        ev("kernel", "void scan_items_kernel<float, true, 2>(ScanArgs)", 20, 20, correlation=1),
        ev("kernel", "merge_items<32>", 40, 10, correlation=2),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 50, 5, correlation=3),
        ev("user_annotation", B, 200, 100),
        ev("user_annotation", "ops.beam.beam_search_inline", 210, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 212, 2, correlation=4),
        ev("kernel", "beam_search_kernel<float, 32, 1>", 220, 30, correlation=4),
        ev("user_annotation", "ops.beam_search.batched_beam_search", 255, 5),
        ev("user_annotation", "ops.bruteforce.windowed_bruteforce", 262, 4),
        ev("cuda_runtime", "cudaLaunchKernel", 263, 1, correlation=5),
        ev("kernel", "topk_kernel", 270, 4, correlation=5),
        ev("kernel", "stray", 280, 6, correlation=99),
        ev("user_annotation", "some.other.range", 0, 1),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 12, "id": 1},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    names = {B} | {s[0] for s in spans.BREAKDOWN_SPANS}
    return Trace.from_chrome(str(path), names)


def test_trace_reduction(tmp_path):
    t = synthetic(tmp_path)
    assert len(t.spans) == 6 and len(t.dev_start) == 6
    assert t.linked_share() == pytest.approx(5 / 6)
    assert t.device_s("ops.scan.scan_topk") == pytest.approx(30e-6)  # the copy was launched after
    assert t.device_s("ops.beam.beam_search_inline") == pytest.approx(30e-6)
    assert t.device_s("ops.bruteforce.windowed_bruteforce") == pytest.approx(4e-6)
    assert t.window(B) == (0.0, 300.0)
    assert t.busy(0, 300) == pytest.approx(20 + 10 + 5 + 30 + 4 + 6)
    wall, busy = t.per_span_busy(B)
    assert wall.tolist() == [100, 100] and busy.tolist() == [35, 34]  # the stray is unlinked
    bd = t.breakdown(0, 300)
    ops = dict(bd["device_ops"])
    assert ops["ops.scan.scan_topk: scan_items_kernel"] == pytest.approx(20e-6)
    assert ops["wsbench.batch: Memcpy DtoH"] == pytest.approx(5e-6)
    assert ops["(no span): stray"] == pytest.approx(6e-6)
    idle = dict(bd["idle_gaps"])
    assert idle["(no span)"] == pytest.approx(100e-6)  # between the batches
    assert idle["ops.scan.scan_topk"] == pytest.approx(10e-6)  # 10..20
    assert sum(idle.values()) == pytest.approx((300 - 75) * 1e-6)


def test_interval_helpers():
    a, b = merge(np.array([5.0, 0.0, 2.0, 10.0]), np.array([7.0, 3.0, 4.0, 11.0]))
    assert a.tolist() == [0, 5, 10] and b.tolist() == [4, 7, 11]
    assert union_length(np.array([0.0, 1.0]), np.array([2.0, 3.0])) == 3
    assert short_name("void (anonymous namespace)::k<float, 2>(Args)") == "::k"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"


def view(tmp_path, cell_name):
    cell = catalog.cell(cell_name)
    d = cell.config["d"]
    return RunView(cell=cell, trace=synthetic(tmp_path), batches=2, which=np.array([0, 1]),
                   counters={"ops.scan.SCAN_LAUNCHES": 2, "ops.beam.BEAM_LAUNCHES": 6},
                   timers={"models.vamana.build_vamana_graph": [30.5]},
                   windows=[(np.array([0, 100]), np.array([50, 200])),
                            (np.array([0]), np.array([10]))]), d


EXPECTED = {  # metric -> value on the synthetic trace
    "device_idle_pct": 100 * (1 - 75 / 300),
    "scan_topk.launches": 1.0,
    "beam_search.launches": 3.0,
    "beam_search.device_ms": 30e-3 / 2,
    "host_exposed_ms.prefilter": (65 + 66) / 2 * 1e-3,
    "host_exposed_ms.postfilter": (65 + 66) / 2 * 1e-3,
    "postfilter.plain_searches": 0.5,
    "vamana.build_s": 30.5,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(tmp_path, name):
    run, _ = view(tmp_path, "prefilter-1m-d128.frac2-2")
    assert catalog.metric(name).read(run) == pytest.approx(EXPECTED[name])


def test_scan_roofline_reader(tmp_path):
    run, d = view(tmp_path, "prefilter-1m-d128.frac2-2")
    k = run.cell.traffic["k"]
    flops0, flops1 = 2 * d * 150, 2 * d * 10
    bytes0 = 150 * (4 * d + 4) + 2 * (4 * d + 8) + 2 * k * 8
    bytes1 = 10 * (4 * d + 4) + (4 * d + 8) + k * 8
    bound = sum(max(f / 67e12, b / 3.35e12) for f, b in ((flops0, bytes0), (flops1, bytes1)))
    got = catalog.metric("scan_topk.roofline_pct").read(run)
    assert got == pytest.approx(100 * bound / 30e-6)


def test_readers_find_nothing(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": [ev("user_annotation", B, 0, 10)]}))
    t = Trace.from_chrome(str(path), {B})
    run = RunView(cell=catalog.cell("prefilter-1m-d128.frac2-2"), trace=t, batches=1,
                  which=np.array([0]), counters={}, timers={}, windows=[])
    for name in ("device_idle_pct", "scan_topk.roofline_pct", "beam_search.device_ms",
                 "vamana.build_s"):
        assert catalog.metric(name).read(run) is None, name
