"""One run of one cell: data, index, warm-up, the timed window, the check.

The window is a closed loop of one caller: each call is one batch_search of
a whole batch of the pool, in turn, and the next call is sent once the
previous call's answers are on the host. Of each pool batch the window keeps
each distinct answer once, with the number of calls that returned it, so the
host's memory stays flat through the window; once the window has closed and
the program's state is freed, each is held against the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import catalog, reference, spans, trace as trace_mod
from .data import Data, generate

PORT = "rangefilteredann_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "rangefilteredann_tpu")
OUT = catalog.HERE / "out"
# A traced run's window, at most: long enough for tens of the slowest cell's
# batches, short enough that its profile (~10 MB a second of host-paced
# batches) is written and read in seconds.
TRACE_SECONDS = 12.0


def log(msg: str) -> None:
    print(f"wsbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def port():
    import importlib

    mod = importlib.import_module(PORT)
    if catalog.REPO not in Path(mod.__file__).resolve().parents:
        raise ImportError(f"{PORT} was loaded from {mod.__file__}, outside this checkout")
    return mod


def build_index(cell: catalog.Cell, data: Data, device):
    """The configuration's index class over the cell's points, with its
    build parameters and constructor arguments as the file gives them."""
    p = port()
    cfg = cell.config
    bp = p.BuildParams(**cfg["build"]) if cfg.get("build") else None
    return getattr(p, cfg["index"])(data.points, data.labels, bp, metric=cfg["metric"],
                                    device=device, **cfg.get("constructor", {}))


def searcher(cell: catalog.Cell, index):
    t = cell.traffic
    qp = port().build_query_params(
        t["k"], t.get("beam", t["k"]), final_beam_multiply=t.get("final_beam_multiply", 1))
    return lambda q, f: index.batch_search(q, f, len(q), qp)


@dataclasses.dataclass
class Window:
    latency: np.ndarray  # [batches] seconds from the call to answers on the host
    which: np.ndarray  # [batches] pool batch of each call
    groups: dict  # {pool batch: [[ids, dists, calls]]}: each distinct answer once
    seconds: float  # first call to last answer


def keep(group: list, ids: np.ndarray, dists: np.ndarray) -> None:
    """Count an answer in its pool batch's group: one more call of an equal
    answer already kept, or a new distinct answer."""
    for g in group:
        if np.array_equal(g[0], ids) and np.array_equal(g[1], dists):
            g[2] += 1
            return
    group.append([ids, dists, 1])


def timed_window(search, pool, seconds: float, traced: bool) -> Window:
    lat, which = [], []
    groups = {b: [] for b in range(len(pool))}
    t_first = time.perf_counter()
    deadline = t_first + seconds
    t1, i = t_first, 0
    while t1 < deadline:
        b = i % len(pool)
        t0 = time.perf_counter()
        if traced:
            with record_function(spans.BATCH):
                out = search(*pool[b])
        else:
            out = search(*pool[b])
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        which.append(b)
        keep(groups[b], *out)
        del out
        i += 1
    return Window(np.array(lat), np.array(which), groups, t1 - t_first)


def check(cell: catalog.Cell, data: Data, ref: reference.Reference, groups) -> dict:
    """The window's answers held against the reference: invalid slots and
    missed answers (totals over the window's queries), mean recall, the
    largest distance error, and the queries that failed (invalid, or
    short of exact where the configuration promises exact answers)."""
    k = cell.traffic["k"]
    exact = bool(cell.config["guarantee"].get("exact", False))
    tot = dict(invalid=0, misses=0, recall=0.0, queries=0, failed=0)
    dist_err = 0.0
    for b, outs in groups.items():
        if not outs:
            continue
        truth = ref.topk(data.queries[b], data.filters[b], k)
        for ids, dists, calls in outs:
            v = reference.judge(ref, data.queries[b], data.filters[b], ids, dists, k, truth)
            tot["invalid"] += calls * int(v.invalid.sum())
            tot["misses"] += calls * int(v.misses.sum())
            tot["recall"] += calls * float(v.recall.sum())
            tot["queries"] += calls * len(ids)
            bad = (v.invalid > 0) | ((v.misses > 0) if exact else False)
            tot["failed"] += calls * int(bad.sum())
            dist_err = max(dist_err, v.dist_err)
    return {"invalid": tot["invalid"], "misses": tot["misses"],
            "recall": tot["recall"] / max(tot["queries"], 1), "dist_err": dist_err,
            "failed": tot["failed"], "queries": tot["queries"]}


def compare(values: dict, limits: dict) -> dict:
    """{name: {"value", "max" or "min"}} for each number the cell's limits
    file names, in its order."""
    out = {}
    for name, lim in limits["checks"].items():
        side = "max" if "max" in lim else "min"
        out[name] = {"value": values[name], side: lim[side]}
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
               for c in checks.values())


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader may read of a traced run."""

    cell: catalog.Cell
    trace: trace_mod.Trace
    batches: int  # timed batches, all traced
    which: np.ndarray  # pool batch of each
    counters: dict  # counter -> increase over the window
    timers: dict  # timer -> [seconds] of each call, set-up included
    windows: list  # per pool batch (starts, ends) from the reference's sort


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(cell: catalog.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float | None = None, control: bool = False,
             chips: int = 1):
    """One run. Returns the result line as a dict, or None where a
    forbidden module was loaded (named on standard error)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    tr = cell.traffic
    if tr["loop"] != "closed":
        raise ValueError(f"traffic loop {tr['loop']!r}: the harness runs closed loops only")
    t0 = time.perf_counter()
    data = generate(cell.config, tr, seed, cell.generator, device)
    log(f"data {data.points.shape} and {data.queries.shape[0]} batches of "
        f"{data.queries.shape[1]} made in {time.perf_counter() - t0:.3f} s")
    readers = [mod for _, mod in cell.per_layer] if traced else []
    inst = spans.Instruments(readers).install() if traced else None
    try:
        t0 = time.perf_counter()
        index = build_index(cell, data, device)
        if cuda:
            torch.cuda.synchronize()
        log(f"index {cell.config['index']} built in {time.perf_counter() - t0:.3f} s")
        search = searcher(cell, index)
        pool = [(data.queries[b], data.filters[b]) for b in range(len(data.queries))]
        t0 = time.perf_counter()
        for _ in range(int(tr.get("warmup_passes", 1))):
            for q, f in pool:
                search(q, f)
        log(f"warm-up of {tr.get('warmup_passes', 1)} passes over the pool in "
            f"{time.perf_counter() - t0:.3f} s")
        prof = None
        if traced:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            before = inst.read_counters()
        setup_s = time.perf_counter() - t_start
        window = timed_window(search, pool, min(seconds, TRACE_SECONDS) if traced else seconds,
                              traced)
        if traced:
            prof.__exit__(None, None, None)
            counters = {n: v - before[n] for n, v in inst.read_counters().items()}
    finally:
        if inst is not None:
            inst.restore()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    calls = len(window.latency)
    log(f"window: {calls} calls in {window.seconds:.3f} s; card: "
        f"{card_line() if cuda else 'none (CPU run)'}")
    groups = window.groups
    del index, search
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = reference.Reference(data.points, data.labels, cell.config["window"],
                              cell.config["metric"], device)
    values = check(cell, data, ref, groups)
    log(f"reference check of {sum(len(g) for g in groups.values())} distinct answers in "
        f"{time.perf_counter() - t0:.3f} s")
    checks = compare(values, cell.limits)
    e2e = {"qps": calls * tr["batch"] / window.seconds,
           "batch_p95_ms": float(np.percentile(window.latency, 95)) * 1e3,
           "recall_at_10": values["recall"], "setup_s": setup_s}
    result = {
        "correct": passed(checks) and values["queries"] == calls * tr["batch"],
        "attempted": calls * tr["batch"],
        "failed": values["failed"],
        "metrics": {},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)},
    }
    if traced:
        tr_path = OUT / f"trace-{cell.name}.json"
        tr_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(tr_path))
        tr_obj = trace_mod.Trace.from_chrome(str(tr_path), inst.span_names)
        lo, hi = tr_obj.window(spans.BATCH)
        log(f"trace: {len(tr_obj.dev_start)} device operations, "
            f"{tr_obj.linked_share():.4f} of them linked to their launch")
        view = RunView(cell=cell, trace=tr_obj, batches=calls, which=window.which,
                       counters=counters, timers=inst.timers,
                       windows=[ref.windows(data.filters[b]) for b in range(len(pool))])
        for entry, mod in cell.per_layer:
            if mod.SOURCE == "device_trace" and len(tr_obj.dev_start) == 0:
                continue  # nothing ran on a device: a CPU run
            v = mod.read(view)
            if v is not None:
                result["metrics"][entry["name"]] = {"value": float(v), "unit": entry["unit"]}
        result["device"]["busy_s"] = tr_obj.busy(lo, hi) * 1e-6
        result["device"]["window_s"] = (hi - lo) * 1e-6
        result["breakdown"] = tr_obj.breakdown(lo, hi)
    else:
        for entry in cell.end_to_end:
            result["metrics"][entry["name"]] = {"value": e2e[entry["name"]],
                                                "unit": entry["unit"]}
    if control:
        cv = check(cell, data, ref, {b: [[*ref.control(data.queries[b], data.filters[b],
                                                        tr["k"]), 1]]
                                     for b in range(len(pool))})
        result["control"] = compare(cv, cell.limits)
        result["control_correct"] = passed(result["control"])
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return None
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        side = "max" if "max" in c else "min"
        ok = c["value"] <= c[side] if side == "max" else c["value"] >= c[side]
        print(f"check {name} = {c['value']!r}, {side} {c[side]!r}: "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
