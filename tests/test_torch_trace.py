"""The port's own spans and counters (utils/trace.py), on the CPU at tiny
sizes, under torch.profiler: with tracing off no span is recorded, outputs
are bit-identical with it on and off, each path opens the spans it should,
nested in their parents, and the counters rise by what the code predicts."""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rangefilteredann_tpu_torch as P
from rangefilteredann_tpu_torch.models import base
from rangefilteredann_tpu_torch.models import postfilter_vamana as pv
from rangefilteredann_tpu_torch.utils import trace
from wsbench.spans import BREAKDOWN_SPANS

PKG = Path(P.__file__).resolve().parent
N, D, NQ, K = 400, 16, 8, 5


@pytest.fixture(autouse=True)
def tracing_off():
    trace.set_tracing(False)
    yield
    trace.set_tracing(False)


def data(seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, D)).astype(np.float32)
    pts = (centers[rng.integers(0, 20, N)] + 0.3 * rng.normal(size=(N, D))).astype(np.float32)
    labels = rng.uniform(size=N)
    q = (centers[rng.integers(0, 20, NQ)] + 0.3 * rng.normal(size=(NQ, D))).astype(np.float32)
    lo = rng.uniform(0, 0.75, NQ)
    width = np.where(np.arange(NQ) % 4 == 0, 2.0**-4, 0.25)
    return pts, labels, q, np.stack([lo, lo + width], 1)


@pytest.fixture(scope="module")
def pre():
    pts, labels, q, f = data()
    return P.PrefilterIndex(pts, labels, device="cpu"), q, f


@pytest.fixture(scope="module")
def post():
    pts, labels, q, f = data()
    idx = P.PostfilterVamanaIndex(pts, labels, P.BuildParams(R=8, L=16, alpha=1.2),
                                  device="cpu")
    return idx, q, f


def searched(idx, q, f, on=True):
    """(ids, dists, {span name: [events]}, counter increases) of one
    batch_search under the profiler."""
    trace.set_tracing(on)
    before = (base.UPLOADS, base.FETCHES, pv.ROUNDS)
    qp = P.build_query_params(K, 10, limit=3, final_beam_multiply=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids, dists = idx.batch_search(q, f, len(q), qp)
    trace.set_tracing(False)
    events = {}
    for e in prof.events():
        if e.name in trace.SPANS:
            events.setdefault(e.name, []).append(e)
    counts = [a - b for a, b in zip((base.UPLOADS, base.FETCHES, pv.ROUNDS), before)]
    return ids, dists, events, dict(zip(("uploads", "fetches", "rounds"), counts))


def parent(e):
    """The nearest enclosing port span of an event."""
    p = e.cpu_parent
    while p is not None and p.name not in trace.SPANS:
        p = p.cpu_parent
    return None if p is None else p.name


def test_span_names_are_the_ones_the_code_opens():
    """SPANS lists each name that a span(...) of the package opens, once,
    and shares none with the benchmark harness's by-name spans."""
    opened = set()
    for path in PKG.rglob("*.py"):
        opened |= set(re.findall(r'span\("([^"]+)"\)', path.read_text()))
    assert opened == set(trace.SPANS) and len(trace.SPANS) == len(opened)
    from wsbench import spans as harness_spans

    theirs = {harness_spans.BATCH} | {s[0] for s in harness_spans.BREAKDOWN_SPANS}
    assert not theirs & set(trace.SPANS)
    assert P.SPANS is trace.SPANS and P.set_tracing is trace.set_tracing


@pytest.mark.parametrize("route", ["gather", "scan"])
def test_prefilter(pre, route, monkeypatch):
    idx, q, f = pre
    if route == "scan":  # every window to the scan, as in the 1M benchmark cell
        monkeypatch.setattr(base, "window_gather_max", lambda: 0)
    ids0, d0, ev0, c0 = searched(idx, q, f, on=False)
    ids1, d1, ev1, c1 = searched(idx, q, f)
    assert ev0 == {}
    assert np.array_equal(ids0, ids1) and np.array_equal(d0, d1)
    assert c0 == c1
    B, W = "prefilter.batch", "prefilter.window_bounds"
    want = {B: {None}, "prefilter.pad": {B}, W: {B}, "base.upload": {B},
            "base.fetch": {B, W}, "base.finalize": {B}}
    if route == "gather":
        want["gather.kernel"] = {B}
    assert set(ev1) == set(want)
    for name, ups in want.items():
        assert {parent(e) for e in ev1[name]} <= ups, name
    gathers = len(ev1.get("gather.kernel", ()))
    assert gathers == (2 if route == "gather" else 0)  # two window classes
    # queries and filters up, then one index a gather chunk that takes part
    # of the batch; the bounds down once, then two tensors a launch
    assert len(ev1["base.upload"]) == 1 + gathers
    assert sum(parent(e) == W for e in ev1["base.fetch"]) == 1
    assert c1["uploads"] == 2 + gathers
    assert c1["fetches"] == 1 + 2 * max(gathers, 1)
    assert c1["rounds"] == 0


@pytest.mark.parametrize("inline", [None, "float32", "int8"])
def test_postfilter(post, inline):
    """A step limit of 3 keeps the searches short, so most windows end
    their doubling at the cap and take the exact tail as well."""
    idx, q, f = post
    g = idx._graph
    if inline:  # the beam kernel's route; its plain version on the CPU
        g.attach_inline(idx._ps, getattr(torch, inline))
    try:
        ids0, d0, ev0, c0 = searched(idx, q, f, on=False)
        ids1, d1, ev1, c1 = searched(idx, q, f)
    finally:
        g.nbr_vecs = g.nbr_norms = g.nbr_scale = None
    assert ev0 == {}
    assert np.array_equal(ids0, ids1) and np.array_equal(d0, d1)
    assert c0 == c1
    B, S, T = "postfilter.batch", "postfilter.search", "postfilter.exact_tail"
    want = {B: {None}, "postfilter.pad": {B}, "postfilter.window_bounds": {B},
            "base.finalize": {B}, "postfilter.round": {B}, T: {B}, "postfilter.final": {B},
            S: {"postfilter.round", "postfilter.final"}, "base.upload": {S, T},
            "base.fetch": {"postfilter.round", "postfilter.final", T},
            "beam_search.window_filter": {S}, "gather.kernel": {T}}
    want["beam.start" if inline else "beam_search.plain"] = {S}
    if inline == "int8":
        want["beam_search.rerank"] = {S}
    assert set(ev1) == set(want)
    for name, ups in want.items():
        assert {parent(e) for e in ev1[name]} <= ups, name
    assert len(ev1["base.finalize"]) == 2  # the query norms, then finalize_output
    searches, rounds = len(ev1[S]), len(ev1["postfilter.round"])
    assert searches > rounds >= 2
    tail = sum(parent(e) == T for e in ev1["base.upload"])  # the tail's launches
    assert tail >= 1
    assert c1 == {"uploads": 4 * searches + 3 * tail, "fetches": 3 * searches + 2 * tail,
                  "rounds": rounds}


@pytest.mark.parametrize("spec", BREAKDOWN_SPANS, ids=lambda s: f"{s[1]}.{s[2]}")
def test_breakdown_names_resolve(spec):
    """Each function that wsbench/spans.py wraps by name in a traced run
    imports and resolves where it looks for it, so a planner edit that
    drops a name fails here rather than in a traced run on the card."""
    import importlib

    _, mod, attr = spec
    assert callable(getattr(importlib.import_module(mod), attr))
