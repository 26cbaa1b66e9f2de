#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rangefilteredann_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--nq 10240]

Run from the repository root. It imports nothing of JAX or the JAX package.
Phases, each of which raises on failure (exit code != 0, no result line):
  1. the card's name and power limit;
  2. nvcc builds every kernel of the port from csrc/ into build/kernels/;
  3. each kernel against its plain PyTorch version on the card, case by case;
  4. the main path at SIFT-1M scale (1M x 128 fp32, 1000 clusters, noise
     0.35, uniform labels, as bench.py makes its data): PrefilterIndex on the
     card, batch_search of 10,240 queries at k=10 at filter fraction 2^-2
     (the scan kernel), 2^-12 (the per-query gather) and a mix, with every
     kernel's launch count reset just before and read just after, recall@10
     against a float64 numpy oracle, best-of-3 timings, the kernel's own time
     by CUDA events, and the kernel held against its plain version on the
     main path's own inputs;
  5. one `kernels` JSON line: each kernel, the TPU kernel it replaces, its
     launches on the main path, its worst deviation, its times and bound;
  6. the card line again, then {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

D, K = 128, 10  # SIFT's width; the protocol's k
SAMPLE = 256  # queries per batch held against the float64 oracle
FRACTIONS = {"frac2^-2": 2.0 ** -2, "frac2^-12": 2.0 ** -12}
RTOL, ATOL = 1e-5, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ comparisons --

def compare_topk(kernel_out, plain_k1, k, exact):
    """Hold the kernel's (dists, ids) against the plain version's top-(k+1).

    exact: ids and distances identical (byte stores with integer queries).
    Otherwise distances within rtol/atol, +inf in the same places, and ids
    equal wherever the plain distance is separated by more than the
    tolerance from every other entry of the plain top-(k+1) (a near-tie may
    be ordered either way by two summation orders). Returns (max |dd|,
    positions excused as near-ties)."""
    kd, ki = (x.cpu().numpy() for x in kernel_out)
    pd, pi = (x.cpu().numpy() for x in plain_k1)
    pdk, pik = pd[:, :k], pi[:, :k]
    if kd.shape != pdk.shape or ki.shape != pik.shape:
        raise AssertionError(f"shape {kd.shape} != {pdk.shape}")
    if exact:
        np.testing.assert_array_equal(ki, pik)
        np.testing.assert_array_equal(kd, pdk)
        return 0.0, 0
    fin = np.isfinite(pdk)
    np.testing.assert_array_equal(np.isfinite(kd), fin)
    np.testing.assert_allclose(kd[fin], pdk[fin], rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(pd)
    with np.errstate(invalid="ignore"):  # inf - inf in empty slots
        gap = np.abs(pd[:, :k, None] - pd[:, None, :])  # [Q, k, k+1]
    gap[:, np.arange(k), np.arange(k)] = np.inf
    near_tie = (gap <= tol[:, :k, None]).any(axis=2) & fin
    ok = (ki == pik) | near_tie
    if not ok.all():
        q, j = np.argwhere(~ok)[0]
        raise AssertionError(
            f"id mismatch at query {q} slot {j}: kernel {ki[q]} plain {pik[q]}")
    err = float(np.max(np.abs(kd[fin] - pdk[fin]))) if fin.any() else 0.0
    return err, int((near_tie & (ki != pik)).sum())


def kernel_cases():
    """(name, points, queries, starts, ends, k, metric, options) cases."""
    rng = np.random.default_rng(1234)

    def windows(n, nq):
        s = rng.integers(0, n, size=nq).astype(np.int32)
        e = np.minimum(s + rng.integers(0, n, size=nq), n).astype(np.int32)
        e[:4] = s[:4]  # empty windows
        e[4:8] = n  # windows touching the store's end
        s[8:12] = 0
        e[8:12] = n  # the whole store
        return s, e

    cases = []
    for metric in ("l2", "mips"):
        pts = rng.normal(size=(1300, 24)).astype(np.float32)
        q = rng.normal(size=(512, 24)).astype(np.float32)
        cases.append((f"fp32-{metric}-n1300-d24", pts, q, *windows(1300, 512), 10, metric, {}))
    pts = rng.normal(size=(50_000, 128)).astype(np.float32)
    q = rng.normal(size=(1000, 128)).astype(np.float32)
    for k in (1, 10, 100, 256):
        cases.append((f"fp32-l2-n50000-d128-k{k}", pts, q, *windows(50_000, 1000), k, "l2", {}))
    pts = rng.normal(size=(7001, 100)).astype(np.float32)
    q = rng.normal(size=(300, 100)).astype(np.float32)
    cases.append(("fp32-l2-n7001-d100-normcol-in-stream", pts, q, *windows(7001, 300),
                  10, "l2", {"dirty_norm_col": True}))
    for kind, lo, hi in (("int8", -128, 128), ("uint8", 0, 256)):
        dt = np.int8 if kind == "int8" else np.uint8
        pts = rng.integers(lo, hi, size=(5003, 100)).astype(dt)
        q = rng.integers(lo, hi, size=(400, 100)).astype(np.float32)
        cases.append((f"{kind}-l2-n5003-d100-intq", pts, q, *windows(5003, 400), 10, "l2",
                      {"exact": True}))
    base = rng.normal(size=(96, 8)).astype(np.float32)
    dup = np.tile(base, (16, 1))
    q = rng.normal(size=(64, 8)).astype(np.float32)
    full = (np.zeros(64, np.int32), np.full(64, len(dup), np.int32))
    for k in (1, 10, 100):
        cases.append((f"fp32-l2-dup16-k{k}", dup, q, *full, k, "l2", {}))
    dup8 = np.tile(rng.integers(-20, 20, size=(96, 8)).astype(np.int8), (16, 1))
    q8 = rng.integers(-20, 20, size=(64, 8)).astype(np.float32)
    for k in (1, 10, 100):
        cases.append((f"int8-l2-dup16-k{k}-ties", dup8, q8, *full, k, "l2", {"exact": True}))
    return cases


def run_kernel_cases(torch):
    from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
    from rangefilteredann_tpu_torch.ops.scan import scan_topk
    from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

    worst = 0.0
    for name, pts, q, s, e, k, metric, opt in kernel_cases():
        ps = make_pointset(pts, metric, device="cuda")
        d = pts.shape[1]
        qp = torch.from_numpy(pad_queries(q, d, ps.d_pad)).cuda()
        st, en = torch.from_numpy(s).cuda(), torch.from_numpy(e).cuda()
        d_eff = ps.norm_col if ps.norm_col >= 0 else ps.d_pad
        qk = qp.clone()
        if opt.get("dirty_norm_col"):  # the kernel must zero the query there
            qk[:, d:] = 123.0
        got = scan_topk(ps.data, ps.norms_sq, qk, st, en, k, metric, d_eff=d_eff)
        plain = scan_bruteforce(ps.data, ps.norms_sq, qp, st, en, k + 1, metric)
        torch.cuda.synchronize()
        err, excused = compare_topk(got, plain, k, opt.get("exact", False))
        worst = max(worst, err)
        log(f"case {name} k={k}: ok, max|dd|={err:.3g}, near-ties excused={excused}")
    return worst


# --------------------------------------------------------------- main path --

def make_data(seed, n, d, nq, clusters=1000, noise=0.35):
    """bench.py's data: clustered points, uniform labels, clustered queries."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32)
    assign = rng.integers(0, clusters, size=n)
    points = (centers[assign] + noise * rng.normal(size=(n, d))).astype(np.float32)
    labels = rng.uniform(size=n)
    q_assign = rng.integers(0, clusters, size=nq)
    queries = (centers[q_assign] + noise * rng.normal(size=(nq, d))).astype(np.float32)

    def filters_for(frac):
        starts = rng.uniform(0, 1 - frac, size=nq)
        return np.stack([starts, starts + frac], axis=1)

    batches = {name: filters_for(f) for name, f in FRACTIONS.items()}
    mix = rng.uniform(size=nq) < 0.5
    batches["mix"] = np.where(mix[:, None], batches["frac2^-2"], batches["frac2^-12"])
    return points, labels, queries, batches


class Oracle:
    """The float64 numpy oracle of tests/conftest.py (stable label argsort,
    searchsorted-left on both ends, (dist, id) lexsort), over a label-sorted
    float64 copy so that each window is one slice and its distances
    ||x||^2 - 2 x.q + ||q||^2 one BLAS product."""

    def __init__(self, points, labels):
        self.order = np.argsort(labels, kind="stable")
        self.pos = np.empty_like(self.order)
        self.pos[self.order] = np.arange(len(self.order))
        self.ls = labels[self.order]
        self.x = points[self.order].astype(np.float64)
        self.norms = np.einsum("nd,nd->n", self.x, self.x)

    def window(self, lo, hi):
        return (np.searchsorted(self.ls, lo, side="left"),
                np.searchsorted(self.ls, hi, side="left"))

    def dist(self, q, ids):
        """float64 squared L2 distances from q to the points of original ids."""
        q64 = q.astype(np.float64)
        p = self.pos[ids]
        return self.norms[p] - 2.0 * (self.x[p] @ q64) + q64 @ q64

    def topk(self, q, lo, hi, k):
        s, e = self.window(lo, hi)
        if e <= s:
            return np.zeros(0, np.int64), np.zeros(0)
        q64 = q.astype(np.float64)
        d = self.norms[s:e] - 2.0 * (self.x[s:e] @ q64) + q64 @ q64
        cand = self.order[s:e]
        sel = np.arange(len(d))
        if len(d) > k:
            thr = np.partition(d, k - 1)[k - 1]
            sel = np.nonzero(d <= thr)[0]
        sel = sel[np.lexsort((cand[sel], d[sel]))][:k]
        return cand[sel], d[sel]


# A returned point whose true distance is within this of the true k-th
# distance is a correct answer (the ann-benchmarks convention): float32
# distances of ~1e2 carry ~1e-4 of rounding, so two points that close may
# rank either way in any float32 implementation, the reference's included.
TIE_EPS = 1e-3


def check_results(oracle, queries, filters, ids, dists, k, sample):
    """(recall, set-overlap recall, notes) of a batch's results on `sample`
    queries. Every returned id must lie in its query's window, and every
    distance must match the oracle's distance of that id."""
    if ids.shape != (len(queries), k) or dists.shape != (len(queries), k):
        raise AssertionError(f"result shapes {ids.shape} {dists.shape}")
    if not np.isfinite(dists).all():
        raise AssertionError("non-finite distances in the results")
    hits = overlap = 0.0
    notes = []
    for qi in sample:
        want_i, want_d = oracle.topk(queries[qi], *filters[qi], k)
        kk = len(want_i)
        if not ((ids[qi, kk:] == np.uint32(0xFFFFFFFF)).all()
                and (dists[qi, kk:] == np.finfo(np.float32).max).all()):
            raise AssertionError(f"query {qi}: slots past its {kk} points are not padding")
        if kk == 0:  # an empty window, rightly answered with padding only
            hits += 1.0
            overlap += 1.0
            continue
        got = ids[qi, :kk].astype(np.int64)
        s, e = oracle.window(*filters[qi])
        if not ((oracle.pos[got] >= s) & (oracle.pos[got] < e)).all():
            raise AssertionError(f"query {qi}: a returned id lies outside its window")
        got_d = oracle.dist(queries[qi], got)
        np.testing.assert_allclose(dists[qi, :kk], got_d, rtol=1e-4, atol=1e-2)
        overlap += len(set(want_i.tolist()) & set(got.tolist())) / kk
        hits += (got_d <= want_d[-1] + TIE_EPS).sum() / kk
        if set(want_i.tolist()) != set(got.tolist()):
            notes.append(f"query {qi}: k-th true distance {want_d[-1]!r}, returned "
                         f"{sorted(got_d.tolist())[-1]!r}")
    return hits / len(sample), overlap / len(sample), notes


def cuda_time_ms(torch, fn, reps):
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def short_name(key: str) -> str:
    """A kernel's name without its argument list."""
    if key.endswith(")"):
        depth = 0
        for i in range(len(key) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(key[i], 0)
            if depth == 0:
                return key[:i].removeprefix("void ").rstrip()
    return key


def device_breakdown(torch, fn, top=6):
    """(wall ms, device ms, [(op, device ms)]) of one call of fn under
    torch.profiler: the device time of every operation it ran, largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(short_name(e.key), e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(ms for _, ms in rows), rows[:top]


def scan_work(args, kw):
    """Operations and bytes the scan must do for one call's inputs: each
    in-window (query, point) pair costs 2*d flops; each row that some window
    covers is read once, each query once, each output written once. Also
    the rows the kernel actually streams (32-query blocks over the union of
    their midpoint-sorted windows), for the record."""
    data, norms, queries, starts, ends = args
    k, d = kw["k"], kw["d_eff"]
    s = starts.cpu().numpy().astype(np.int64)
    e = np.minimum(ends.cpu().numpy().astype(np.int64), data.shape[0])
    w = np.maximum(e - s, 0)
    flops = 2.0 * float(w.sum()) * d
    cover = np.zeros(data.shape[0] + 1, np.int64)
    np.add.at(cover, s[w > 0], 1)
    np.add.at(cover, e[w > 0], -1)
    rows = int((np.cumsum(cover)[:-1] > 0).sum())
    elem = data.element_size()
    nbytes = rows * (d * elem + 4) + len(s) * (d * 4 + 8 + k * 8)
    order = np.argsort(s + e, kind="stable")
    streamed = 0
    for b in range(0, len(s), 32):
        blk = order[b : b + 32]
        ne = blk[w[blk] > 0]
        if len(ne):
            streamed += int(e[ne].max() - s[ne].min())
    return flops, nbytes, streamed * d * elem


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=10_240)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch import kernels
    from rangefilteredann_tpu_torch.models import base
    from rangefilteredann_tpu_torch.ops import scan
    from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # 2. build every kernel
    t0 = time.time()
    out = kernels.build(kernels.SOURCES, verbose=True)
    log(f"build: {', '.join(kernels.SOURCES)} in {time.time() - t0:.2f} s")
    for name, text in out.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # 3. each kernel against its plain version
    t0 = time.time()
    worst = run_kernel_cases(torch)
    log(f"kernel cases: all passed in {time.time() - t0:.1f} s, max|dd|={worst:.3g}")

    # 4. the main path at SIFT-1M scale
    t0 = time.time()
    points, labels, queries, batches = make_data(args.seed, args.n, D, args.nq)
    log(f"data: {args.n} x {D} fp32, {args.nq} queries, made in {time.time() - t0:.1f} s")
    t0 = time.time()
    idx = P.PrefilterIndex(points, labels, metric="Euclidian")
    torch.cuda.synchronize()
    log(f"index: PrefilterIndex on {idx.device} built in {time.time() - t0:.1f} s")
    qparams = P.build_query_params(K, K)

    captured = {}
    real_scan = base.scan_topk

    def recording_scan(*a, **kw):  # keeps the scan inputs the main path makes
        captured["last"] = (a, kw)
        return real_scan(*a, **kw)

    base.scan_topk = recording_scan
    scan_inputs, results = {}, {}
    scan.SCAN_LAUNCHES = 0  # every kernel's count, just before the main path
    for name, filters in batches.items():
        captured.pop("last", None)
        results[name] = idx.batch_search(queries, filters, args.nq, qparams)
        if "last" in captured:
            scan_inputs[name] = captured["last"]
    launches = scan.SCAN_LAUNCHES  # just after
    base.scan_topk = real_scan
    log(f"main path: scan_topk launches = {launches} over {len(batches)} batch_search calls")
    if launches < 1:
        raise AssertionError("the main path never launched the scan kernel")

    t0 = time.time()
    oracle = Oracle(points, labels)
    rng = np.random.default_rng(args.seed + 1)
    sample = rng.choice(args.nq, size=min(SAMPLE, args.nq), replace=False)
    for name, filters in batches.items():
        ids, dists = results[name]
        rec, overlap, notes = check_results(oracle, queries, filters, ids, dists,
                                            K, sample)
        log(f"recall@{K} {name}: {rec} on {len(sample)} queries "
            f"(id-set overlap {overlap})")
        for note in notes:
            log(f"  near-tie at the k-th place, {note}")
        if rec != 1.0:
            raise AssertionError(f"recall@{K} {name} = {rec} < 1.0")
    log(f"oracle checks in {time.time() - t0:.1f} s")

    for name, filters in batches.items():
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            idx.batch_search(queries, filters, args.nq, qparams)
            walls.append(time.perf_counter() - t0)
        best = min(walls)
        log(f"timing {name}: best-of-3 wall {best * 1e3:.3f} ms, QPS {args.nq / best:.1f}, "
            f"runs {[round(w * 1e3, 3) for w in walls]}")

    # where the time of the scan batch goes, by the profiler's device clock
    wall, dev, rows = device_breakdown(
        torch, lambda: idx.batch_search(queries, batches["frac2^-2"], args.nq, qparams))
    log(f"profile frac2^-2: wall {wall:.3f} ms, device busy {dev:.3f} ms "
        f"({100 * dev / wall:.1f}%), " + "; ".join(f"{k} {ms:.3f} ms" for k, ms in rows))

    # the kernel on the main path's own inputs of each batch that took it:
    # against its plain version, then timed alone (CUDA events), beside the
    # plain version's time. The kernels line reports the 2^-2 batch.
    timed = {}
    for name, (a, kw) in scan_inputs.items():
        data, norms, q_dev, st, en = a
        k, metric = kw["k"], kw["metric"]
        got = scan.scan_topk(*a, **kw)
        plain = scan_bruteforce(data, norms, q_dev, st, en, k + 1, metric)
        torch.cuda.synchronize()
        err, excused = compare_topk(got, plain, k, exact=False)
        worst = max(worst, err)
        log(f"main-path inputs {name} [{q_dev.shape[0]} queries x {data.shape[0]} rows]: "
            f"kernel == plain, max|dd|={err:.3g}, near-ties excused={excused}")
        kernel_ms = cuda_time_ms(torch, lambda: scan.scan_topk(*a, **kw), 5)
        plain_ms = cuda_time_ms(
            torch, lambda: scan_bruteforce(data, norms, q_dev, st, en, k, metric), 1)
        flops, nbytes, streamed = scan_work(a, kw)
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        timed[name] = (kernel_ms, plain_ms, bound_ms, bound_by)
        log(f"scan kernel {name}: {kernel_ms:.3f} ms (plain {plain_ms:.3f} ms); "
            f"work {flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB once "
            f"({streamed / 1e9:.3f} GB streamed by 32-query blocks); bound {bound_ms:.3f} ms "
            f"by {bound_by} ({t_ops:.3f} ms ops, {t_bytes:.4f} ms bytes); "
            f"{flops / kernel_ms / 1e9:.2f} TFLOP/s achieved")
    kernel_ms, plain_ms, bound_ms, bound_by = timed["frac2^-2"]

    # 5. inventory
    print(json.dumps({"kernels": [{
        "name": "scan_topk",
        "route": "cuda",
        "source": "rangefilteredann_tpu_torch/csrc/scan_topk.cu",
        "replaces": "rangefilteredann_tpu/ops/pallas_scan.py:114",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    # 6. the card, then the result
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
