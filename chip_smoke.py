#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rangefilteredann_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n 1000000] [--nq 10240]
                          [--graph-n 200000] [--graph-nq 10240]
                          [--variant-n 200000] [--variant-nq 2048]

Run from the repository root. It imports nothing of JAX or the JAX package.
Phases, each of which raises on failure (exit code != 0, no result line):
  1. the card's name and power limit;
  2. nvcc builds every kernel of the port from csrc/ into build/kernels/;
  3. each kernel against its plain PyTorch version on the card, case by case
     (the scan against ops/bruteforce.scan_bruteforce, with cases that cut
     every block's windows into several segments and log the grid, the beam search
     against ops/beam.beam_search_plain in both of its launch
     configurations, logged case by case, the scan variants v2, v3 and v3b of
     tools/ against their plain versions at two (tile, qblock) shapes, v3,
     v3b and v2 (fp32 and bf16, k = 1, 10 and 256) also on windows that cut
     their blocks into several segments, bit for bit on grid-valued data,
     v2's bf16 pass and its fp32 rerank bit for bit on grid-valued data, the
     nested-loop probe against its plain version, aligned, misaligned, with
     a tail and past its grid's cap);
  4. the prefilter main path at SIFT-1M scale (1M x 128 fp32, 1000 clusters,
     noise 0.35, uniform labels, as bench.py makes its data): PrefilterIndex
     on the card, batch_search of 10,240 queries at k=10 at filter fraction
     2^-2 (the scan kernel), 2^-12 (the per-query gather) and a mix;
  5. the graph main path at bench.py's postfilter scale (200,000 x 128 fp32,
     the same generator): PostfilterVamanaIndex built on the card with
     R=48, L=100, alpha=1.2, then batch_search of 10,240 queries at k=10,
     fraction 2^-2, beam 80, final_beam_multiply 2 (the beam kernel);
     each main path runs with every kernel's launch count reset just before
     and read just after, and is followed by recall@10 against a float64
     numpy oracle, best-of-3 timings, a profiler breakdown, the kernel's own
     time by CUDA events (for the beam kernel beside the bytes its
     expansions read and its longest query's steps), and the kernel held
     against its plain version on the main path's own inputs; for the scan
     also its grid, its time at k = 1, 32 and 256, and a 2,048-query
     sub-batch that must equal its rows of the whole launch bit for bit
     (the host's stages of batch_search are the port's own spans, read by
     the benchmark's traced runs); the scan variants also run
     on the prefilter's 2^-2 batch, timed beside the scan kernel;
  6. the trees, after the graph path (which saves its graph in a cache
     directory of the run): the Vamana-leaf RangeFilterTreeIndex at
     bench.py's tree configuration (the graph path's 200,000 x 128 data,
     cutoff 1000, split 2, R=48, L=100, alpha=1.2), row 0 loaded from the
     graph's cache and rows 1-8 built on the card; 10,240 queries at k=10,
     fraction 2^-2, beam 40, final_beam_multiply 2 for fenwick,
     optimized_postfilter, three_split and smart combined, each with the
     launch counts reset just before one call and read just after,
     recall@10 >= 0.99 against the float64 oracle, best-of-2 wall, the
     query-mode searches that missed the beam kernel, the rows given
     inline blocks and a host breakdown (planning beside the phases), a
     profile of fenwick, and one of its beam-kernel launches against the
     plain version; then the super tree (SuperOptimizedPostfilterTree) at
     bench.py's super configuration over the same data (split 2.0, shift
     0.5, the same build; cutoff 6250 where bench.py has 1000, for the
     run's time: the batch routes no window below row 2; row 0 loaded from
     the graph's cache, rows 1-5 built on the card) on the 2^-2 batch at
     beam 40 and beam 80,
     final_beam_multiply 2, each with the launch counts reset just before
     one call and read just after, recall@10 >= 0.99, best-of-2 wall, the
     routed rows, a host breakdown, and its largest beam-kernel launch
     against the plain version; then the prefilter-leaf tree over the
     prefilter path's 1M store, fenwick on its 2^-2 batch (recall@10 1.0,
     the scan kernel);
  7. the file-based surface over the graph path's data (run after the
     super tree, before the prefilter-leaf tree, in the run's temporary
     directory): vectors and graph
     written as reference-format files (utils/io), VamanaIndex loaded from
     them on the card and searched unfiltered at beam 10, 20, 40 and 80
     (recall@10 against a float64 ground-truth file, >= 0.99 at beam 80),
     the command line (cli.main) over the same files, and
     build_vamana_index on a 20,000-point prefix (recall@10 >= 0.95 at
     beam 80); these searches prune by the cut and run batched_beam_search,
     not the beam kernel;
  8. the scan-variant harness (tools/exp_scan2, exp_scan3, exp_scan3b) at
     its own size: 200,000 x 128 fp32, 2,048 queries, windows of 1/4, k=10,
     the tools' generator with seed 42, through each tool's main() with
     the launch counts reset just before and read just after, then the
     --dups inputs; each variant against a float64 oracle, its plain
     version and the scan kernel, and v2's bf16 pass + fp32 rerank recall;
     the grid of v3, v3b and v2 (fp32 and bf16) at the harness, and their
     device time a call by kernel (torch.profiler) beside the CUDA events';
     the probe kernel's device time a launch beside torch.mul's;
  9. the experiment layer (experiments/), in a temporary directory that is
     also the benchmark driver's working directory (it writes results/ and
     index_cache/ there): the adversarial set at the reference's scale
     (1,000,000 x 100 angular, 100 clusters, 10,000 queries, seed 0) made
     by datasets.generate_adversarial, its ground truth on the scan kernel
     held against a float64 oracle on 256 queries (recall@10 1.0) and its
     scan launch against the plain version on every window; the driver
     (run_our_method.main) with --prefiltering on it (recall 1.0); then
     the synthetic set at its defaults (100,000 x 64, 1,000 queries, 17
     fractions) and the driver at 2^-2, beam 40 x2, R=48, L=100 for the
     prefilter (recall 1.0) and the graph methods but the super tree
     (phase 6 runs it at full width), each CSV row printed
     with its scan and beam launches and plain-route searches, every count
     reset just before each generator and driver run and read just after;
  10. the scale-out (parallel/sharded.py) over a mesh of 4 shards,
     cuda:0..3 when there are four cards, else four logical shards on one
     (cross-device copies are then no-ops): the index-sharded scan on phase
     4's store and 2^-2 batch (ids identical to the unsharded scan kernel
     launch, its launches counted and each held against the plain version,
     walls in turns beside the unsharded launch; window cases across shard
     boundaries, clipped to zero rows and to fewer than k rows, each
     per-shard launch held against the plain version), phase 5's PostfilterVamanaIndex loaded from the cache and
     sharded (recall@10 >= 0.99, ids equal to its unsharded plain route on
     the whole batch, no beam-kernel launch, both walls), phase 6's
     Vamana-leaf tree loaded from its row caches and sharded with
     shard_rows=True for fenwick, optimized_postfilter and three_split
     (recall@10 >= 0.99, ids equal to the unsharded plain route, run with
     TREE_INLINE_BUDGET 0, on the whole batch, no beam-kernel launch, both
     walls and a host breakdown), and dryrun_multidevice;
  11. one `kernels` JSON line: each kernel, the TPU kernel it replaces, its
     launches on its main path (the scan kernel's: the prefilter path's,
     the experiments' and the scale-out's; the beam kernel's: the graph
     path's, the super tree's and the experiments'), its worst deviation,
     its times and bound;
  12. the card line again, then {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

D, K = 128, 10  # SIFT's width; the protocol's k
SAMPLE = 256  # queries per batch held against the float64 oracle
FRACTIONS = {"frac2^-2": 2.0 ** -2, "frac2^-12": 2.0 ** -12}
RTOL, ATOL = 1e-5, 1e-4
PLAIN_BLOCK = 16384  # windows per plain-scan call on the prefilter-leaf tree's launch


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


def split_cases():
    """Cases that cut every block's windows into several segments: 64 and
    2,048 queries over windows of 100k to 1M rows of a 1M-row store, k = 1,
    10 and 256, L2 and MIPS, on grid-valued fp32 data (every distance exact,
    many exact ties across segments), and one int8 store with integer
    queries. All exact. Yields (name, points, queries, starts, ends, k,
    metric, options), one store at a time."""
    rng = np.random.default_rng(4242)
    n = 1_000_000

    def windows(nq):
        s = rng.integers(0, n - 100_000, size=nq).astype(np.int32)
        e = np.minimum(s + rng.integers(100_000, n + 1, size=nq), n).astype(np.int32)
        s[:2], e[:2] = 0, n  # the whole store
        return s, e

    pts = grid_values(rng, (n, D))
    for nq in (64, 2048):
        q = grid_values(rng, (nq, D))
        s, e = windows(nq)
        for metric in ("l2", "mips"):
            for k in (1, 10, 256):
                yield (f"split-fp32grid-{metric}-n{n}-q{nq}-k{k}", pts, q, s, e, k, metric,
                       {"exact": True, "split": True})
    pts = rng.integers(-128, 128, size=(n, D)).astype(np.int8)
    q = rng.integers(-128, 128, size=(2048, D)).astype(np.float32)
    yield (f"split-int8-l2-n{n}-q2048-k10", pts, q, *windows(2048), 10, "l2",
           {"exact": True, "split": True})


def scan_grid(torch, a, kw):
    """The scan kernel's grid for one call's inputs, as its wrapper plans it:
    the launch configuration (CTAs resident an SM, registers, spills) and
    the segment plan (items, tiles a segment, segments a block)."""
    from rangefilteredann_tpu_torch import kernels
    from rangefilteredann_tpu_torch.ops import scan

    data, norms, queries, starts, ends = a
    k, metric = kw["k"], kw["metric"]
    _, _, s_s, e_s, _ = scan.sorted_launch_args(
        data, norms, queries, starts, ends, k, kw.get("d_eff") or data.shape[1],
        chunk=scan.CHUNK, dtypes=scan._DTYPE_CODES, name="scan")
    cfg = scan.launch_config(kernels.load("scan_topk"), scan._DTYPE_CODES[data.dtype], metric,
                             k, data.device.index or 0)
    _, _, prefix, seg, _, _ = scan.segment_plan(s_s, e_s, data.shape[0], cfg["slots"])
    segs = torch.diff(prefix, prepend=prefix.new_zeros(1)).float()
    return dict(cfg, items=int(prefix[-1]), seg_tiles=int(seg[0]),
                segs_max=int(segs.max()), segs_mean=float(segs.mean()))


def grid_note(g):
    return (f"{g['ctas_per_sm']} CTAs an SM x {g['sms']} SMs = {g['slots']} resident, "
            f"{g['lists']} list(s) a query, {g['items']} items of {g['seg_tiles']} tiles "
            f"({g['seg_tiles'] * 256} points), segments a block max {g['segs_max']} mean "
            f"{g['segs_mean']:.2f}; {g['registers']} registers, {g['spill_bytes']} spill bytes "
            f"a thread, {g['smem_bytes']} B shared memory a CTA")


def run_kernel_cases(torch):
    from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
    from rangefilteredann_tpu_torch.ops.scan import scan_topk
    from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

    worst = 0.0
    stores = {}
    for name, pts, q, s, e, k, metric, opt in itertools.chain(kernel_cases(), split_cases()):
        if id(pts) not in stores:  # one store per array (the split cases share theirs)
            stores = {id(pts): make_pointset(pts, metric, device="cuda")}
        ps = stores[id(pts)]
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
        note = ""
        if opt.get("split"):
            g = scan_grid(torch, (ps.data, ps.norms_sq, qk, st, en),
                          {"k": k, "metric": metric, "d_eff": d_eff})
            if g["segs_max"] < 2 or (len(q) >= 2048 and g["items"] <= g["slots"]):
                raise AssertionError(f"case {name} did not split its blocks: {g}")
            note = f"; grid: {grid_note(g)}"
        log(f"case {name} k={k}: ok, {'identical' if opt.get('exact') else 'near-tie'} "
            f"compare, max|dd|={err:.3g}, near-ties excused={excused}{note}")
    return worst


def beam_slab(rng, m, r, w, grid=True, hub=False):
    """tests/test_pallas_beam.py's random slab (sorted random adjacency of
    1..R neighbours, inline blocks copied from the rows) as
    (data, norms, nbrs, vecs, nbr_norms). With grid=True the values lie on
    the grid k/8, so every product and partial sum of a distance is exact in
    float32 and no summation order can change a distance: ids, n_vis and
    cmps must then be identical. Real-valued data is held on the main path.
    hub=True puts node 0 into every other row, so a search that starts there
    meets its start again as a neighbour."""
    data = rng.normal(size=(m, w))
    data = (np.round(data * 8) / 8 if grid else data).astype(np.float32)
    norms = np.einsum("ij,ij->i", data, data).astype(np.float32)
    nbrs = np.full((m, r), -1, dtype=np.int32)
    for i in range(m):
        cand = rng.choice(m, size=rng.integers(1, r + 1), replace=False)
        cand = cand[cand != i]
        if hub and i > 0 and 0 not in cand:
            cand = np.append(cand[: r - 1], 0)
        nbrs[i, :len(cand)] = np.sort(cand)
    safe = np.clip(nbrs, 0, m - 1)
    return data, norms, nbrs, data[safe], norms[safe]


def beam_cases():
    """(name, metric, R, beam, limit, blocks, inactive, w, queries) cases:
    fp32 over the grid of R x beam for both metrics, a small limit, an
    all-inactive batch, bf16 blocks, native int8/uint8 blocks with integer
    queries (exact), int8 blocks with a per-node scale (held at recall
    level), and the widths w = 32, 96 and 256 beside the main path's 128
    (the lanes a row and the shared-memory layout depend on w), all at 64
    queries, which take four warps a query (ops/beam.launch_config). Then
    batches of 600 and 2,048 queries, which take one warp a query, over
    the same kinds of blocks; 16 queries at beams 320 and 2048; and the
    start met again as a neighbour (hub) with int8 blocks and a scale,
    whose two distances of one id the by-id duplicate test must keep apart."""
    cases = [(f"fp32-{metric}-R{r}-beam{beam}", metric, r, beam, 10_000, "fp32", 3, 128)
             for metric in ("l2", "mips") for r in (5, 48, 64)
             for beam in (8, 40, 80, 512, 2048)]
    cases += [("fp32-l2-R48-beam40-limit7", "l2", 48, 40, 7, "fp32", 3, 128),
              ("fp32-l2-R5-beam8-all-inactive", "l2", 5, 8, 10_000, "fp32", 64, 128),
              ("bf16-l2-R48-beam80", "l2", 48, 80, 10_000, "bf16", 3, 128),
              ("bf16-mips-R64-beam512", "mips", 64, 512, 10_000, "bf16", 3, 128),
              ("int8-l2-R48-beam40", "l2", 48, 40, 10_000, "int8", 3, 128),
              ("uint8-mips-R48-beam40", "mips", 48, 40, 10_000, "uint8", 3, 128),
              ("int8scale-l2-R64-beam80", "l2", 64, 80, 10_000, "int8scale", 3, 128),
              ("int8scale-mips-R64-beam80", "mips", 64, 80, 10_000, "int8scale", 3, 128)]
    cases += [("fp32-l2-R48-beam80-w32", "l2", 48, 80, 10_000, "fp32", 3, 32),
              ("fp32-mips-R5-beam40-w96", "mips", 5, 40, 10_000, "fp32", 3, 96),
              ("fp32-l2-R64-beam2048-w256", "l2", 64, 2048, 10_000, "fp32", 3, 256),
              ("fp32-mips-R48-beam512-w256", "mips", 48, 512, 10_000, "fp32", 3, 256),
              ("bf16-l2-R48-beam80-w256", "l2", 48, 80, 10_000, "bf16", 3, 256),
              ("int8-l2-R48-beam40-w256", "l2", 48, 40, 10_000, "int8", 3, 256),
              ("uint8-mips-R48-beam40-w32", "mips", 48, 40, 10_000, "uint8", 3, 32),
              ("int8scale-l2-R64-beam80-w256", "l2", 64, 80, 10_000, "int8scale", 3, 256)]
    cases = [c + (64,) for c in cases]
    cases += [("fp32-l2-R48-beam320-q16", "l2", 48, 320, 10_000, "fp32", 1, 128, 16),
              ("fp32-l2-R48-beam2048-q16", "l2", 48, 2048, 10_000, "fp32", 1, 128, 16),
              ("fp32-l2-R64-beam2048-w256-q16", "l2", 64, 2048, 10_000, "fp32", 1, 256, 16),
              ("fp32-l2-R48-beam80-q2048", "l2", 48, 80, 10_000, "fp32", 3, 128, 2048),
              ("fp32-l2-R64-beam2048-w256-q600", "l2", 64, 2048, 10_000, "fp32", 3, 256, 600),
              ("fp32-mips-R5-beam40-w96-q600", "mips", 5, 40, 10_000, "fp32", 3, 96, 600),
              ("fp32-l2-R48-beam40-limit7-q600", "l2", 48, 40, 7, "fp32", 3, 128, 600),
              ("bf16-mips-R64-beam512-q600", "mips", 64, 512, 10_000, "bf16", 3, 128, 600),
              ("int8-l2-R48-beam40-w256-q600", "l2", 48, 40, 10_000, "int8", 3, 256, 600),
              ("uint8-mips-R48-beam40-w32-q600", "mips", 48, 40, 10_000, "uint8", 3, 32, 600),
              ("int8scale-l2-R64-beam80-q600", "l2", 64, 80, 10_000, "int8scale", 3, 128, 600),
              ("int8scale-l2-R48-beam80-hub", "l2", 48, 80, 10_000, "int8scale", 3, 128, 64),
              ("int8scale-l2-R48-beam80-hub-q600", "l2", 48, 80, 10_000, "int8scale", 3, 128,
               600)]
    return cases


def beam_case_inputs(torch, rng, metric, r, blocks, inactive, w, m=3000, q=64, hub=False):
    """Tensors on the card for one case: the kernel wrapper's arguments and
    the float data the int8-scale recall check needs. With hub=True every
    query starts at node 0, which every other row holds."""
    from rangefilteredann_tpu_torch.ops.distances import gathered_distances

    data, norms, nbrs, vecs, nrm = beam_slab(rng, m, r, w, grid=blocks != "int8scale", hub=hub)
    queries = (np.round(rng.normal(size=(q, w)) * 8) / 8).astype(np.float32)
    scale = None
    if blocks in ("int8", "uint8"):  # a byte store, integer queries
        lo = -100 if blocks == "int8" else 0
        data = rng.integers(lo, lo + 200, size=(m, w)).astype(np.float32)
        norms = np.einsum("ij,ij->i", data, data).astype(np.float32)
        safe = np.clip(nbrs, 0, m - 1)
        vecs, nrm = data[safe].astype(np.int8 if blocks == "int8" else np.uint8), norms[safe]
        queries = rng.integers(-20, 20, size=(q, w)).astype(np.float32)
    elif blocks == "int8scale":  # tests/test_pallas_beam.py's quantization
        queries = rng.normal(size=(q, w)).astype(np.float32)
        scale = (np.abs(vecs).max(axis=(1, 2)) / 127.0).astype(np.float32)
        vecs = np.clip(np.rint(vecs / scale[:, None, None]), -127, 127).astype(np.int8)
    starts = (np.zeros(q) if hub else rng.integers(0, m, size=q)).astype(np.int32)
    active = np.ones(q, dtype=bool)
    active[q - inactive:] = False
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    v = dev(vecs)
    if blocks == "bf16":
        v = v.to(torch.bfloat16)
    st = dev(starts)
    d0 = gathered_distances(dev(queries), dev(data)[st.long()][:, None, :],
                            dev(norms)[st.long()][:, None], metric)[:, 0]
    args = (v, dev(nbrs), dev(nrm), None if scale is None else dev(scale),
            dev(queries), st, d0, dev(active))
    return args, (data, queries)


def frontier_agreement(got, plain):
    """How far the kernel's frontiers agree with the plain version's:
    (share identical id by id, share identical up to near-tie order, max
    |dist - plain dist| over the ids both frontiers hold, and the gaps in
    float32 ulps between the plain distances of the entries that two
    same-set frontiers order differently).

    Two summation orders of one fp32 dot product differ in the last bits,
    which can swap two frontier entries whose distances are that close. A
    frontier counts as identical up to near-tie order when it holds the same
    ids, and wherever the ids differ, the plain version's distance of the
    kernel's id lies within RTOL/ATOL of the plain distance at that slot.
    Raises where the distances of a common id differ by more than RTOL/ATOL."""
    gi, gd = (x.cpu().numpy() for x in got[:2])
    pi, pd = (x.cpu().numpy() for x in plain[:2])
    same = (gi == pi).all(axis=1)
    same_set = (np.sort(gi, axis=1) == np.sort(pi, axis=1)).all(axis=1)
    tie_order = same.copy()
    fin = np.isfinite(pd[same])
    np.testing.assert_array_equal(np.isfinite(gd[same]), fin)
    kd, wd, ulps = [gd[same][fin]], [pd[same][fin]], [np.zeros(0)]
    for qi in np.nonzero(~same)[0]:
        _, a, b = np.intersect1d(gi[qi], pi[qi], return_indices=True)
        keep = np.isfinite(pd[qi, b])
        kd.append(gd[qi, a][keep])
        wd.append(pd[qi, b][keep])
        if same_set[qi]:
            order = np.argsort(pi[qi], kind="stable")
            pd_of_g = pd[qi, order[np.searchsorted(pi[qi, order], gi[qi])]]
            moved = gi[qi] != pi[qi]
            gap = np.abs(pd_of_g - pd[qi])[moved]
            tie_order[qi] = (gap <= ATOL + RTOL * np.abs(pd[qi, moved])).all()
            ulps.append(gap / np.spacing(np.abs(pd[qi, moved]).astype(np.float32)))
    kd, wd = np.concatenate(kd), np.concatenate(wd)
    np.testing.assert_allclose(kd, wd, rtol=RTOL, atol=ATOL,
                               err_msg="distances of common frontier ids")
    return (float(same.mean()), float(tie_order.mean()),
            float(np.abs(kd - wd).max(initial=0.0)), np.concatenate(ulps))


CONFIG_NAMES = {1: "one warp a query", 4: "four warps a query"}


def launch_config_name(q, beam, vecs):
    """The configuration the beam kernel's launch rule picks for a batch
    over these blocks."""
    from rangefilteredann_tpu_torch.ops.beam import launch_config

    _, r, w = vecs.shape
    return CONFIG_NAMES[launch_config(q, beam, r, w, vecs.element_size())[0]]


def assert_distinct_ids(name, ids):
    """No frontier holds an id twice (the duplicate test is by id)."""
    s = np.sort(ids, axis=1)
    if ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] != EMPTY_ID_NP)).any():
        raise AssertionError(f"case {name}: a frontier holds an id twice")


def run_beam_cases(torch):
    """Each beam case: the kernel against its plain version on the card.
    Fails unless the cases reach both launch configurations."""
    from rangefilteredann_tpu_torch.ops.beam import beam_search_inline, beam_search_plain

    rng = np.random.default_rng(4321)
    worst = 0.0
    configs = set()
    for name, metric, r, beam, limit, blocks, inactive, w, q in beam_cases():
        args, (data, queries) = beam_case_inputs(torch, rng, metric, r, blocks, inactive, w,
                                                 q=q, hub="hub" in name)
        kw = dict(beam=beam, limit=limit, metric=metric)
        config = launch_config_name(q, beam, args[0])
        configs.add(config)
        got = beam_search_inline(*args, **kw)
        plain = beam_search_plain(*args, **kw)
        torch.cuda.synchronize()
        gi, gd, gv, gc = (x.cpu().numpy() for x in got)
        pi, pd, pv, pc = (x.cpu().numpy() for x in plain)
        if (gv[~args[-1].cpu().numpy()] != 0).any():
            raise AssertionError(f"case {name}: an inactive query visited nodes")
        assert_distinct_ids(name, gi)
        if blocks != "int8scale":
            np.testing.assert_array_equal(gi, pi, err_msg=f"case {name}: ids")
            np.testing.assert_array_equal(gv, pv, err_msg=f"case {name}: n_vis")
            np.testing.assert_array_equal(gc, pc, err_msg=f"case {name}: cmps")
            fin = np.isfinite(pd)
            np.testing.assert_array_equal(np.isfinite(gd), fin)
            np.testing.assert_allclose(gd[fin], pd[fin], rtol=RTOL, atol=ATOL,
                                       err_msg=f"case {name}: dists")
            err = float(np.abs(gd[fin] - pd[fin]).max(initial=0.0))
            worst = max(worst, err)
            log(f"beam case {name} [{q} queries, {config}]: ok, identical ids/n_vis/cmps, "
                f"max|dd|={err:.3g}, mean n_vis {gv.mean():.1f}")
            continue
        # int8 with a scale: approximate by design (tests/test_pallas_beam.py)
        mism = float((gi != pi).mean())
        if mism >= 0.02 or not np.array_equal(np.isfinite(gd), gi != EMPTY_ID_NP):
            raise AssertionError(f"case {name}: {mism:.4%} ids differ")
        d_exact = -(queries @ data.T) if metric == "mips" else (
            np.einsum("ij,ij->i", data, data)[None, :] - 2.0 * (queries @ data.T))
        oracle = np.argsort(d_exact, axis=1, kind="stable")[:, :10]

        def recall(ids):
            hits = 0.0
            for qi in range(len(queries) - inactive):
                cand = ids[qi][ids[qi] != EMPTY_ID_NP]
                top = cand[np.argsort(d_exact[qi, cand], kind="stable")[:10]]
                hits += len(set(top.tolist()) & set(oracle[qi].tolist())) / 10
            return hits / (len(queries) - inactive)

        rec_got, rec_plain = recall(gi), recall(pi)
        if rec_got < rec_plain - 0.01 or np.abs(gv - pv).mean() >= 2 or \
                np.abs(gc - pc).mean() >= 128:
            raise AssertionError(f"case {name}: recall {rec_got} vs plain {rec_plain}")
        log(f"beam case {name} [{q} queries, {config}]: ok at recall level, {mism:.4%} ids "
            f"differ, n_vis equal on {float((gv == pv).mean()):.4f} of queries, recall@10 "
            f"{rec_got} (plain {rec_plain})")
    if configs != set(CONFIG_NAMES.values()):
        raise AssertionError(f"the beam cases reached only {configs}")
    return worst


EMPTY_ID_NP = np.int32(2**31 - 1)


# ------------------------------------------------------------ scan variants --

VARIANT_REPS = 5  # timed calls per harness run, after one warm-up
VARIANT_KERNELS = (("v3b", "scan_v3b"), ("v3", "scan_v3"), ("v2", "scan_v2"))
# Shapes that fault on the card, though scan_items.check_caps accepts them:
# qblock 8 with a tile that is an odd multiple of 256 (256, 768, 1280, 1792,
# 2304, 2816, 3328, 3840). There the round's last busy warp of the item body
# (csrc/scan_items.cuh) reads 256 rows past its ring slot, and scan_v2,
# scan_v3 and scan_v3b each stop with "an illegal memory access was
# encountered" (H100 80GB HBM3, 700 W). Every other accepted (tile, qblock)
# matched its plain version there. The shapes held here avoid them
# (ROADMAP.md, Queue C).


def variant_shapes():
    """The (tile, qblock) shapes held per variant: the first two that each
    tool's main() sweeps."""
    from rangefilteredann_tpu_torch.tools import GRIDS

    return GRIDS[:2]


def note_err(errs, run, err):
    """Keep the largest deviation of the kernel that ran `run` (a run name
    such as "v3b T=1024 QB=32 U=4") in errs, keyed by kernel name."""
    name = next(kernel for prefix, kernel in VARIANT_KERNELS if run.startswith(prefix))
    errs[name] = max(errs.get(name, 0.0), err)


def variant_cases():
    """The fp32 cases of kernel_cases() (the variants take fp32 stores
    only), plus windows that are empty, narrower than k, at the store's end
    or the whole store, for both metrics."""
    cases = [c for c in kernel_cases() if c[1].dtype == np.float32]
    rng = np.random.default_rng(99)
    pts = rng.normal(size=(3000, 128)).astype(np.float32)
    q = rng.normal(size=(64, 128)).astype(np.float32)
    s = rng.integers(0, 3000, size=64).astype(np.int32)
    e = np.minimum(s + rng.integers(0, 600, size=64), 3000).astype(np.int32)
    s[:6] = [100, 200, 300, 400, 2995, 0]
    e[:6] = [100, 203, 301, 404, 3000, 3000]
    for metric in ("l2", "mips"):
        cases.append((f"fp32-{metric}-n3000-d128-degenerate", pts, q, s, e, 10, metric, {}))
    return cases


def variant_runs(metric):
    """(name, fn) of each variant setting a case runs: v2 (L2 only) and v3
    at both shapes, v3b at the first shape with unroll 4 and at the second
    with unroll 1 and 8. fn takes the scan's arguments, k and d_eff."""
    from rangefilteredann_tpu_torch.tools.exp_scan2 import scan_v2
    from rangefilteredann_tpu_torch.tools.exp_scan3 import scan_v3
    from rangefilteredann_tpu_torch.tools.exp_scan3b import scan_v3b

    shapes = variant_shapes()
    (t0, b0), (t1, b1) = shapes
    runs = []
    if metric == "l2":
        runs += [(f"v2 T={t} QB={b}", functools.partial(scan_v2, tile=t, qblock=b))
                 for t, b in shapes]
    runs += [(f"v3 T={t} QB={b}", functools.partial(scan_v3, metric=metric, tile=t, qblock=b))
             for t, b in shapes]
    runs += [(f"v3b T={t} QB={b} U={u}",
              functools.partial(scan_v3b, metric=metric, tile=t, qblock=b, unroll=u))
             for t, b, u in ((t0, b0, 4), (t1, b1, 1), (t1, b1, 8))]
    return runs


def run_variant_cases(torch):
    """Each scan variant against its plain version (scan_bruteforce) on the
    card, at every setting of variant_runs(). Returns each kernel's max
    |dd| by name."""
    from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
    from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

    errs = {}
    for name, pts, q, s, e, k, metric, opt in variant_cases():
        ps = make_pointset(pts, metric, device="cuda")
        d = pts.shape[1]
        qp = torch.from_numpy(pad_queries(q, d, ps.d_pad)).cuda()
        st, en = torch.from_numpy(s).cuda(), torch.from_numpy(e).cuda()
        d_eff = ps.norm_col
        qk = qp.clone()
        if opt.get("dirty_norm_col"):  # the kernels must zero the query there
            qk[:, d:] = 123.0
        plain = scan_bruteforce(ps.data, ps.norms_sq, qp, st, en, k + 1, metric)
        runs = variant_runs(metric)
        for run, fn in runs:
            got = fn(ps.data, ps.norms_sq, qk, st, en, k, d_eff=d_eff)
            torch.cuda.synchronize()
            err, excused = compare_topk(got, plain, k, exact=False)
            note_err(errs, run, err)
        log(f"variant case {name} k={k}: {', '.join(n for n, _ in runs)} ok, "
            f"max|dd| so far {errs}")
    run_split_cases(torch)
    return errs


def run_split_cases(torch):
    """v3, v3b and v2 on windows that cut every block into several segments
    (the merge kernel joins their lists) with more items than resident CTAs,
    on grid-valued data, where every distance is exact (and exact in bf16):
    v3 and v3b at each of their settings of variant_runs, v2 in fp32 and in
    bf16 at both shapes with k = 1, K and 256, each identical to its plain
    version, the grid logged."""
    from rangefilteredann_tpu_torch.tools import exp_scan2 as v2
    from rangefilteredann_tpu_torch.tools import exp_scan3 as v3
    from rangefilteredann_tpu_torch.tools import exp_scan3b as v3b
    from rangefilteredann_tpu_torch.tools import scan_items
    from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

    rng = np.random.default_rng(31)
    n, nq = 300_000, 1024
    pts, q = grid_values(rng, (n, D)), grid_values(rng, (nq, D))
    s = rng.integers(0, n // 2, size=nq).astype(np.int32)
    e = (s + rng.integers(n // 4, n // 2, size=nq)).astype(np.int32)
    ps = make_pointset(pts, "l2", device="cuda")
    a = (ps.data, ps.norms_sq, torch.from_numpy(pad_queries(q, D, ps.d_pad)).cuda(),
         torch.from_numpy(s).cuda(), torch.from_numpy(e).cuda())
    # (name, kernel call, k, bf16, its grid); v3's and v3b's plain version is
    # v2's fp32 one
    grids = {"v3 ": v3.grid, "v3b ": v3b.grid}
    runs = [(name, fn, K, False, functools.partial(grid, tile=fn.keywords["tile"],
                                                   qblock=fn.keywords["qblock"]))
            for name, fn in variant_runs("l2")
            for prefix, grid in grids.items() if name.startswith(prefix)]
    for (t, b), bf16, k in itertools.product(variant_shapes(), (False, True), (1, K, 256)):
        kw = dict(tile=t, qblock=b, bf16=bf16)
        runs.append((f"v2 {'bf16' if bf16 else 'fp32'} T={t} QB={b}",
                     functools.partial(v2.scan_v2, **kw), k, bf16, functools.partial(v2.grid, **kw)))
    plains = {}
    for name, fn, k, bf16, grid_fn in runs:
        if (bf16, k) not in plains:
            plains[bf16, k] = v2.scan_v2_plain(*a, k + 1, bf16=bf16, d_eff=D)
        got = fn(*a, k, d_eff=D)
        torch.cuda.synchronize()
        compare_topk(got, plains[bf16, k], k, exact=True)
        g = grid_fn(*a, k, d_eff=D)
        if g["segs_max"] < 2 or g["items"] <= g["slots"]:
            raise AssertionError(f"{name} k={k} did not split its blocks: {g}")
        log(f"variant case split-grid-n{n}-q{nq} {name} k={k}: identical to the plain "
            f"version; grid: {scan_items.grid_note(g, grid_fn.keywords['tile'])}")


def grid_values(rng, shape):
    """Values on the grid j/8: exact in bf16, and every product and partial
    sum of a 128-term distance exact in fp32, in any order."""
    return (np.round(rng.normal(size=shape) * 8) / 8).astype(np.float32)


def run_bf16_cases(torch):
    """v2's bf16 pass and rerank_fp32 after it on grid-valued data, where
    the tensor-core products must equal the plain version bit for bit."""
    from rangefilteredann_tpu_torch.tools import exp_scan2 as v2
    from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

    rng = np.random.default_rng(777)
    n, nq = 20_000, 512
    pts, q = grid_values(rng, (n, D)), grid_values(rng, (nq, D))
    s = rng.integers(0, n, size=nq).astype(np.int32)
    e = np.minimum(s + rng.integers(0, n, size=nq), n).astype(np.int32)
    e[:4] = s[:4]
    e[4:8] = n
    s[8:12] = 0
    ps = make_pointset(pts, "l2", device="cuda")
    qp = torch.from_numpy(pad_queries(q, D, ps.d_pad)).cuda()
    a = (ps.data, ps.norms_sq, qp, torch.from_numpy(s).cuda(), torch.from_numpy(e).cuda())
    for k in (10, 100, v2.RERANK_K):
        plain = v2.scan_v2_plain(*a, k, bf16=True, d_eff=D)
        for t, b in variant_shapes():
            got = v2.scan_v2(*a, k, tile=t, bf16=True, d_eff=D, qblock=b)
            torch.cuda.synchronize()
            compare_topk(got, plain, k, exact=True)
            if k == v2.RERANK_K:
                got_r = v2.rerank_fp32(ps.data, ps.norms_sq, qp, got[1], K)
                plain_r = v2.rerank_fp32(ps.data, ps.norms_sq, qp, plain[1], K)
                compare_topk(got_r, plain_r, K, exact=True)
        log(f"bf16 case grid-n{n}-d{D} k={k}: v2 bf16 identical to its plain version"
            + (f", rerank_fp32 to k={K} identical" if k == v2.RERANK_K else "")
            + f" at {variant_shapes()}")


def run_probe_case(torch):
    """The probe on ones (6 everywhere) and on random x against its plain
    version: the JAX tool's [8, 128] (float4 lanes), an n that is no
    multiple of 4 (the scalar tail), a view one float past a 16-byte
    boundary (the scalar path), and 2^24 floats aligned and 2^24 + 3 past
    the boundary (more CTAs than the grid's cap: the lanes stride). Returns
    max |kernel - plain| over all."""
    from rangefilteredann_tpu_torch.tools import exp_scan3b as v3b

    out = v3b.probe_nested_while("cuda")
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.normal(size=2 ** 24 + 4).astype(np.float32) * 1e3).cuda()
    xs = {"[8, 128]": base[:1024].view(8, 128), "n=1027": base[:1027],
          "misaligned n=1024": base[1:1025], "n=2^24": base[:2 ** 24],
          "misaligned n=2^24+3": base[1:]}
    err = float((out - 6.0).abs().max())
    ok = bool((out == 6.0).all())
    for name, x in xs.items():
        got, plain = v3b.probe_sum(x), v3b.probe_nested_while_plain(x)
        torch.cuda.synchronize()
        err = max(err, float((got - plain).abs().max()))
        ok = ok and torch.equal(got, plain)
    if not ok:
        raise AssertionError(f"the probe kernel differs from its plain version (max|dd|={err:.3g})")
    log(f"probe case: ones -> 6 everywhere; random x ({', '.join(xs)}) identical to the plain "
        f"version, max|dd|={err:.3g}")
    return err


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

    def window(self, lo, hi, hi_side="left"):
        """[start, end) of the labels in [lo, hi) (hi_side "left", the
        prefilter's window) or [lo, hi] ("right", the postfilter's)."""
        return (np.searchsorted(self.ls, lo, side="left"),
                np.searchsorted(self.ls, hi, side=hi_side))

    def dist(self, q, ids):
        """float64 squared L2 distances from q to the points of original ids."""
        q64 = q.astype(np.float64)
        p = self.pos[ids]
        return self.norms[p] - 2.0 * (self.x[p] @ q64) + q64 @ q64

    def topk(self, q, lo, hi, k, hi_side="left"):
        s, e = self.window(lo, hi, hi_side)
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


FLT_MAX = np.finfo(np.float32).max


def check_results(oracle, queries, filters, ids, dists, k, sample, hi_side="left",
                  pad_id=0xFFFFFFFF):
    """(recall, set-overlap recall, notes) of a batch's results on `sample`
    queries. Results must be the returned points first, padding (pad_id:
    uint32 -1, or 0 for the trees; FLT_MAX) after them, no more points than
    the window holds; every returned id must lie in its query's window, and
    every distance must match the oracle's distance of that id."""
    if ids.shape != (len(queries), k) or dists.shape != (len(queries), k):
        raise AssertionError(f"result shapes {ids.shape} {dists.shape}")
    if not np.isfinite(dists).all():
        raise AssertionError("non-finite distances in the results")
    hits = overlap = 0.0
    notes = []
    for qi in sample:
        want_i, want_d = oracle.topk(queries[qi], *filters[qi], k, hi_side)
        kk = len(want_i)
        real = dists[qi] < FLT_MAX
        nr = int(real.sum())
        if (nr > kk or not real[:nr].all()
                or not (ids[qi, nr:] == np.uint32(pad_id)).all()):
            raise AssertionError(f"query {qi}: {nr} results for a window of {kk} "
                                 "points, or padding out of place")
        if kk == 0:  # an empty window, rightly answered with padding only
            hits += 1.0
            overlap += 1.0
            continue
        got = ids[qi, :nr].astype(np.int64)
        s, e = oracle.window(*filters[qi], hi_side)
        if not ((oracle.pos[got] >= s) & (oracle.pos[got] < e)).all():
            raise AssertionError(f"query {qi}: a returned id lies outside its window")
        got_d = oracle.dist(queries[qi], got)
        np.testing.assert_allclose(dists[qi, :nr], got_d, rtol=1e-4, atol=1e-2)
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


def expanded_nodes(torch, args, kw, out):
    """Distinct nodes that one call's queries expand, all queries together,
    from the plain version's visit lists on the same inputs (its n_vis
    equals the kernel's on all but a few queries, which the caller checks).
    Queries that start at one vertex share their first expansions, so this
    is far below the sum of n_vis."""
    from rangefilteredann_tpu_torch.ops.beam_search import batched_beam_search
    from rangefilteredann_tpu_torch.ops.topk import EMPTY_ID

    vecs, nbrs, nrm, scale, queries, starts, d0, active = args
    res = batched_beam_search(
        None, None, nbrs, None, queries, starts, beam=kw["beam"], k=0, cut=1.35,
        limit=kw["limit"], metric=kw["metric"], active_in=active, expand=1,
        identity_map=True, nbr_vecs=vecs, nbr_norms=nrm, nbr_scale=scale, d0=d0,
        return_visited=True, visited_cap=int(out[2].max()) + 64)
    v = res.visited_ids
    return int(torch.unique(v[v != EMPTY_ID]).numel())


def block_bytes(args):
    """Bytes of one node's expansion: R rows of w elements, R ids, R norms,
    its scale."""
    vecs, scale = args[0], args[3]
    _, r, w = vecs.shape
    return r * (w * vecs.element_size() + 8) + (4 if scale is not None else 0)


def beam_work(args, out, nodes):
    """Operations and bytes the beam search must do for one call: the block
    of each of the `nodes` distinct expanded nodes read once however many
    queries expand it, each query with its start, d0 and flag read once,
    the frontier and the counters written once; 2*w flops per distance
    computed (the cmps of every query: each query's distances are its own
    work)."""
    w = args[0].shape[2]
    q, beam = out[0].shape
    cmps = float(out[3].double().sum())
    nbytes = nodes * block_bytes(args) + q * (w * 4 + 9) + q * (beam * 8 + 8)
    return cmps * 2.0 * w, nbytes


def bound(flops, nbytes, peak_flops):
    """(bound ms, "operations" or "bytes") on the H100's published peaks, the
    operations at `peak_flops` (the rate of the units that run them)."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


SUB_BATCH = 2048  # queries of the segmentation-invariance launch


def check_segmentation_invariance(torch, a, kw):
    """The first SUB_BATCH midpoint-sorted queries of a batch, launched
    alone, must give bit for bit their rows of the whole batch's launch:
    the same blocks, cut into other segments (the segment length follows
    the batch's total work)."""
    from rangefilteredann_tpu_torch.ops import scan

    data, norms, queries, starts, ends = a
    full = scan.scan_topk(*a, **kw)
    sub = torch.argsort(starts.long() + ends.long(), stable=True)[:SUB_BATCH]
    a_sub = (data, norms, queries[sub], starts[sub], ends[sub])
    part = scan.scan_topk(*a_sub, **kw)
    torch.cuda.synchronize()
    g_full, g_sub = scan_grid(torch, a, kw), scan_grid(torch, a_sub, kw)
    if g_full["seg_tiles"] == g_sub["seg_tiles"]:
        raise AssertionError("the two launches cut their windows alike")
    if not (torch.equal(part[0], full[0][sub]) and torch.equal(part[1], full[1][sub])):
        raise AssertionError("a sub-batch's results differ from the whole batch's")
    log(f"segmentation invariance: the first {SUB_BATCH} sorted queries alone "
        f"({g_sub['items']} items of {g_sub['seg_tiles']} tiles) == their rows of the "
        f"{queries.shape[0]}-query launch ({g_full['items']} items of {g_full['seg_tiles']} "
        f"tiles), bit for bit")


def run_prefilter_path(torch, args, worst):
    """The prefilter main path at SIFT-1M scale. Returns its data, the scan
    inputs of its 2^-2 batch and the scan kernel's entry of the kernels
    line."""
    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch.models import base
    from rangefilteredann_tpu_torch.ops import beam, scan
    from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce

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
    scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
    for name, filters in batches.items():
        captured.pop("last", None)
        results[name] = idx.batch_search(queries, filters, args.nq, qparams)
        if "last" in captured:
            scan_inputs[name] = captured["last"]
    launches, beam_launches = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
    base.scan_topk = real_scan
    log(f"prefilter main path: scan_topk launches = {launches}, beam_search launches = "
        f"{beam_launches} over {len(batches)} batch_search calls")
    if launches < 1:
        raise AssertionError("the prefilter main path never launched the scan kernel")

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
        bound_ms, bound_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
        timed[name] = (kernel_ms, plain_ms, bound_ms, bound_by)
        log(f"scan kernel {name}: {kernel_ms:.3f} ms (plain {plain_ms:.3f} ms); "
            f"work {flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB once "
            f"({streamed / 1e9:.3f} GB streamed by 32-query blocks); bound {bound_ms:.3f} ms "
            f"by {bound_by} ({flops / PEAK_FP32_FLOPS * 1e3:.3f} ms ops, "
            f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms bytes); "
            f"{flops / kernel_ms / 1e9:.2f} TFLOP/s achieved, {bound_ms / kernel_ms:.3f} "
            f"of the bound")
        log(f"scan grid {name}: {grid_note(scan_grid(torch, a, kw))}")
        if name == "frac2^-2":  # what the list inserts cost: the same scan at other k
            at_k = {kk: cuda_time_ms(torch, lambda: scan.scan_topk(*a, **dict(kw, k=kk)), 3)
                    for kk in (1, 32, 256)}
            log(f"scan kernel {name} at other k: " + ", ".join(
                f"k={kk} {ms:.3f} ms" for kk, ms in at_k.items()))
    check_segmentation_invariance(torch, *scan_inputs["frac2^-2"])
    kernel_ms, plain_ms, bound_ms, bound_by = timed["frac2^-2"]
    return (points, labels, queries, batches), scan_inputs["frac2^-2"], {
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
    }


def run_graph_path(torch, args, worst, cache):
    """The graph main path at bench.py's postfilter scale, its graph saved
    under `cache` once the build is timed. Returns its data, the graph's adjacency and the beam
    kernel's entry of the kernels line."""
    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch.models import base
    from rangefilteredann_tpu_torch.models import postfilter_vamana as pv
    from rangefilteredann_tpu_torch.ops import beam, scan

    t0 = time.time()
    points, labels, queries, batches = make_data(args.seed, args.graph_n, D, args.graph_nq)
    filters = batches["frac2^-2"]
    log(f"graph data: {args.graph_n} x {D} fp32, {args.graph_nq} queries, made in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    idx = P.PostfilterVamanaIndex(points, labels, tree_build_params(P, None))
    torch.cuda.synchronize()
    built = time.time() - t0
    g = idx._graph
    # the tree's row 0 loads this file: written here, after the build's
    # clock stopped, under the name the index itself would have used
    t0 = time.time()
    fname = base.whole_dataset_cache(cache, tree_build_params(P, cache),
                                     float(labels.min()), float(labels.max()), len(points))
    base.save_cached_nbrs(fname, g.nbrs_host, idx._fp)
    deg = (g.nbrs_host >= 0).sum(axis=1)
    log(f"graph index: PostfilterVamanaIndex on {idx.device} (R=48, L=100, alpha=1.2) "
        f"built in {built:.1f} s; degree mean {deg.mean():.2f} max {deg.max()}; "
        f"inline blocks {list(g.nbr_vecs.shape) if g.nbr_vecs is not None else None} "
        f"{g.inline_dtype}; cache file {os.path.basename(fname)} written in "
        f"{time.time() - t0:.1f} s after the build")
    if g.inline_dtype != torch.float32:
        raise AssertionError(f"inline blocks are {g.inline_dtype}, not float32")
    qparams = P.build_query_params(K, 80, final_beam_multiply=2)

    captured, plain_calls = [], [0]
    real_inline, real_plain = pv.beam_search_inline, pv.batched_beam_search

    def recording_inline(*a, **kw):  # keeps the kernel's inputs and outputs
        out = real_inline(*a, **kw)
        captured.append((a, kw, out))
        return out

    def counting_plain(*a, **kw):  # query-mode searches that missed the kernel
        plain_calls[0] += 1
        return real_plain(*a, **kw)

    pv.beam_search_inline, pv.batched_beam_search = recording_inline, counting_plain
    scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
    ids, dists = idx.batch_search(queries, filters, args.graph_nq, qparams)
    launches, scan_launches = beam.BEAM_LAUNCHES, scan.SCAN_LAUNCHES  # just after
    pv.beam_search_inline, pv.batched_beam_search = real_inline, real_plain
    log(f"graph main path: beam_search launches = {launches} "
        f"(beams {[kw['beam'] for _, kw, _ in captured]}), scan_topk launches = "
        f"{scan_launches}, query-mode batched_beam_search calls = {plain_calls[0]}")
    if launches < 2 or plain_calls[0] != 0:
        raise AssertionError("the graph main path did not run its searches in the kernel")

    t0 = time.time()
    oracle = Oracle(points, labels)
    rng = np.random.default_rng(args.seed + 1)
    sample = rng.choice(args.graph_nq, size=min(SAMPLE, args.graph_nq), replace=False)
    rec, overlap, notes = check_results(oracle, queries, filters, ids, dists, K, sample,
                                        hi_side="right")
    log(f"graph recall@{K} frac2^-2 beam 80 x2: {rec} on {len(sample)} queries "
        f"(id-set overlap {overlap}); oracle checks in {time.time() - t0:.1f} s")
    if rec < 0.99:
        raise AssertionError(f"graph recall@{K} = {rec} < 0.99")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        idx.batch_search(queries, filters, args.graph_nq, qparams)
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    log(f"graph timing frac2^-2: best-of-3 wall {best * 1e3:.3f} ms, QPS "
        f"{args.graph_nq / best:.1f}, runs {[round(w * 1e3, 3) for w in walls]}")
    wall, dev, rows = device_breakdown(
        torch, lambda: idx.batch_search(queries, filters, args.graph_nq, qparams))
    log(f"graph profile frac2^-2: wall {wall:.3f} ms, device busy {dev:.3f} ms "
        f"({100 * dev / wall:.1f}%), " + "; ".join(f"{k} {ms:.3f} ms" for k, ms in rows))

    # the kernel on each of the main path's own launches: against its plain
    # version (identical frontiers, distances of common ids), then timed
    # alone by CUDA events beside the plain version. The kernels line sums
    # the launches of the one batch_search.
    # Frontiers identical id by id are not required: the kernel's FMA chain
    # and the plain version's bmm sum in other orders, and entries whose
    # distances are that close may sort either way. The search itself
    # (which nodes it expands, how many distances) must agree.
    tot = np.zeros(4)  # kernel ms, plain ms, flops, bytes
    for a, kw, out in captured:
        plain = beam.beam_search_plain(*a, **kw)
        torch.cuda.synchronize()
        share, share_ties, err, ulps = frontier_agreement(out, plain)
        same_counts = float(((out[2] == plain[2]) & (out[3] == plain[3])).double().mean())
        worst = max(worst, err)
        kernel_ms = cuda_time_ms(torch, lambda: beam.beam_search_inline(*a, **kw), 3)
        plain_ms = cuda_time_ms(torch, lambda: beam.beam_search_plain(*a, **kw), 1)
        nodes = expanded_nodes(torch, a, kw, out)
        flops, nbytes = beam_work(a, out, nodes)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
        tot += (kernel_ms, plain_ms, flops, nbytes)
        q = a[4].shape[0]
        sum_vis = int(out[2].double().sum())
        # the design's own ceiling: every expansion reads its block once
        exp_bytes = sum_vis * block_bytes(a)
        max_vis = int(out[2].max())
        log(f"beam kernel beam {kw['beam']} [{q} queries, "
            f"{launch_config_name(q, kw['beam'], a[0])}]: per-expansion bytes "
            f"{exp_bytes / 1e9:.3f} GB (sum of n_vis x {block_bytes(a)} B), "
            f"{exp_bytes / kernel_ms / 1e6:.1f} GB/s achieved against it "
            f"({exp_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at {PEAK_BYTES_PER_S / 1e12} TB/s); "
            f"longest query {max_vis} steps, {kernel_ms * 1e3 / max(max_vis, 1):.2f} us a step "
            f"at most")
        log(f"beam kernel beam {kw['beam']} [{q} queries]: {kernel_ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms); identical frontiers {share:.6f} id by id, "
            f"{share_ties:.6f} up to near-tie order; identical n_vis and "
            f"cmps {same_counts:.6f}, max|dd| over common ids {err:.3g}; entries "
            f"ordered otherwise: {len(ulps)}, their plain distances "
            f"{np.max(ulps, initial=0):.0f} ulps apart at most, median "
            f"{np.median(ulps) if len(ulps) else 0:.0f}; mean n_vis "
            f"{sum_vis / q:.1f}; distinct nodes expanded {nodes} of {a[1].shape[0]} "
            f"(sum of n_vis {sum_vis}); work {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e9:.3f} GB once; bound {bound_ms:.3f} ms by {bound_by}; "
            f"{nbytes / kernel_ms / 1e6:.1f} GB/s of distinct bytes achieved")
        if share_ties < 0.99 or same_counts < 0.999:
            raise AssertionError(
                f"frontiers equal to the plain version's up to near-tie order on "
                f"{share_ties:.4%} of queries, n_vis and cmps on {same_counts:.4%}")
    bound_ms, bound_by = bound(tot[2], tot[3], PEAK_FP32_FLOPS)
    log(f"beam kernel per batch_search: {tot[0]:.3f} ms over {len(captured)} launches "
        f"(plain {tot[1]:.3f} ms), bound {bound_ms:.3f} ms by {bound_by}")
    return (points, labels, queries, batches), g.nbrs_host, {
        "name": "beam_search",
        "route": "cuda",
        "source": "rangefilteredann_tpu_torch/csrc/beam_search.cu",
        "replaces": "rangefilteredann_tpu/ops/pallas_beam.py:133",
        "launches": launches,
        "max_abs_err": worst,
        "ms": float(tot[0]),
        "plain_ms": float(tot[1]),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def tree_build_params(P, cache):
    """The graph's and the tree's build (bench.py:48-49, :328), with one
    cache directory for the run (None: no cache): the tree's row 0 is the
    graph's build."""
    return P.BuildParams(R=48, L=100, alpha=1.2, cache_path=cache)


TREE_CUTOFF, TREE_SPLIT = 1000, 2  # bench.py:353
TREE_BEAM, TREE_FM = 40, 2  # bench.py:375-377
# (name, query_method, min_query_to_bucket_ratio): smart combined is
# optimized_postfilter with the ratio of tests/test_tree.py:141
TREE_METHODS = (("fenwick", "fenwick", None),
                ("optimized_postfilter", "optimized_postfilter", None),
                ("three_split", "three_split", None),
                ("smart_combined", "optimized_postfilter", 1.5))


@contextlib.contextmanager
def recorded_rows(torch, row_of):
    """While open, every row build of a tree (models/vamana.load_or_build_row)
    is timed into builds[row_of(bucket offsets)] and every graph cache it
    loads is recorded in loads; yields (builds, loads)."""
    from rangefilteredann_tpu_torch.models import vamana

    builds, loads = {}, []
    real_build, real_load = vamana.build_vamana_graph, vamana.load_cached_nbrs

    def timed_build(ps, s2g, off, bp, seed):
        t0 = time.time()
        g = real_build(ps, s2g, off, bp, seed=seed)
        torch.cuda.synchronize()
        builds[row_of(off)] = time.time() - t0
        return g

    def recorded_load(fname, fp):
        loads.append(fname)
        return real_load(fname, fp)

    vamana.build_vamana_graph, vamana.load_cached_nbrs = timed_build, recorded_load
    try:
        yield builds, loads
    finally:
        vamana.build_vamana_graph, vamana.load_cached_nbrs = real_build, real_load


def span_timer(torch, spans, fn, name):
    """fn wrapped to add its host ms, between two synchronises, to
    spans[name]."""
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spans[name] = spans.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def tree_breakdown(torch, tree, queries, filters, qparams, method, nq):
    """Host clock around the stages of one real RangeFilterTreeIndex.
    batch_search call: marks, each after a synchronise, at the entry and
    exit of the functions it calls (the planner, plan_row_inline, the
    single-shot, doubling and brute-force phases, the merge and
    finalize_output). Returns (total ms, {stage: ms} with "other" holding
    the rest, {phase: tasks})."""
    from rangefilteredann_tpu_torch.models import range_filter_tree as rft

    spans = {}
    marked = functools.partial(span_timer, torch, spans)
    stages = {"_plan_batch_native": "plan", "_plan_batch_python": "plan",
              "_run_single_shot": "single-shot", "_run_doubling": "doubling",
              "_merge": "merge"}
    for attr, name in stages.items():
        setattr(tree, attr, marked(getattr(tree, attr), name))
    tasks = {}
    real_run = tree._run_single_shot, tree._run_doubling

    def counted(fn, name, arg=0):  # the tasks a phase gets: len(positional arg)
        def wrapper(*a, **kw):
            tasks[name] = len(a[arg])
            return fn(*a, **kw)
        return wrapper

    tree._run_single_shot = counted(real_run[0], "single-shot")
    tree._run_doubling = counted(real_run[1], "doubling")
    real = rft.plan_row_inline, rft.batched_range_bruteforce, rft.finalize_output
    rft.plan_row_inline = marked(real[0], "inline blocks")
    rft.batched_range_bruteforce = counted(marked(real[1], "brute force"), "brute force", 3)
    rft.finalize_output = marked(real[2], "finalize_output")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree.batch_search(queries, filters, nq, method, qparams)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        rft.plan_row_inline, rft.batched_range_bruteforce, rft.finalize_output = real
        for attr in stages:
            delattr(tree, attr)
    spans["other"] = total - sum(spans.values())
    return total, spans, tasks


def run_tree_path(torch, args, cache, data, flat_nbrs):
    """The Vamana-leaf B-WST at bench.py's tree configuration over the graph
    path's data, row 0 loaded from the graph's cache, the other rows built on
    the card; then each query method on the 2^-2 batch, with every kernel's
    launch count reset just before one call and read just after."""
    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch.models import base
    from rangefilteredann_tpu_torch.models import postfilter_vamana as pv
    from rangefilteredann_tpu_torch import native
    from rangefilteredann_tpu_torch.models import range_filter_tree as rft
    from rangefilteredann_tpu_torch.ops import beam, scan

    if not native.available():  # the phase measures the native planners
        raise AssertionError("the native planners did not build (g++ missing?)")
    log(f"native planners: {native.library_path()}")
    points, labels, queries, batches = data
    filters = batches["frac2^-2"]
    nq = len(queries)
    bp = tree_build_params(P, cache)
    offsets = rft.build_offset_rows(len(points), TREE_CUTOFF, TREE_SPLIT)
    row_of = {len(o) - 1: r for r, o in enumerate(offsets)}  # buckets -> row
    t0 = time.time()
    with recorded_rows(torch, lambda off: row_of[len(off) - 1]) as (builds, loads):
        tree = P.RangeFilterTreeIndex(points, labels, cutoff=TREE_CUTOFF,
                                      split_factor=TREE_SPLIT, build_params=bp)
    torch.cuda.synchronize()
    total = time.time() - t0
    canon = base.whole_dataset_cache(cache, bp, float(labels.min()), float(labels.max()),
                                     len(points))
    if loads != [canon] or sorted(builds) != list(range(1, len(offsets))) or \
            not np.array_equal(tree._graphs[0].nbrs_host, flat_nbrs):
        raise AssertionError(f"row 0 did not load the graph's cache: loads {loads}, "
                             f"rows built {sorted(builds)}")
    log(f"tree index: RangeFilterTreeIndex on {tree.device} ({len(offsets)} rows, cutoff "
        f"{TREE_CUTOFF}, split {TREE_SPLIT}, R=48, L=100, alpha=1.2, native planners "
        f"{native.available()}) in {total:.1f} s; row 0 "
        f"loaded from the graph's cache {os.path.basename(canon)}; rows built: " + ", ".join(
            f"row {r} ({len(offsets[r]) - 1} buckets) {builds[r]:.1f} s" for r in sorted(builds)))
    log(f"tree rows: device bytes {sum(g.device_bytes() for g in tree._graphs)} "
        f"(adjacency + slab maps, no inline blocks); int8 inline blocks of a row "
        f"{tree._graphs[0].inline_bytes(tree._ps, torch.int8)} B, budget "
        f"{base.TREE_INLINE_BUDGET} B")

    oracle = Oracle(points, labels)
    rng = np.random.default_rng(args.seed + 1)
    sample = rng.choice(nq, size=min(SAMPLE, nq), replace=False)
    plain_calls = [0, 0]
    captured = {}  # method -> its largest beam kernel launch (a, kw, out)
    real_inline, real_plain = pv.beam_search_inline, pv.batched_beam_search

    def recording_inline(*a, **kw):  # keeps each method's largest launch
        out = real_inline(*a, **kw)
        if name not in captured or a[4].shape[0] > captured[name][0][4].shape[0]:
            captured[name] = (a, kw, out)
        return out

    def counting_plain(*a, **kw):  # query-mode searches that missed the kernel
        plain_calls[0] += 1
        plain_calls[1] += a[4].shape[0]
        return real_plain(*a, **kw)

    for name, method, ratio in TREE_METHODS:
        qparams = P.build_query_params(K, TREE_BEAM, final_beam_multiply=TREE_FM,
                                       min_query_to_bucket_ratio=ratio)
        plain_calls[:] = [0, 0]
        pv.beam_search_inline, pv.batched_beam_search = recording_inline, counting_plain
        scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
        t0 = time.perf_counter()
        try:
            ids, dists = tree.batch_search(queries, filters, nq, method, qparams)
        finally:
            launches, scan_launches = beam.BEAM_LAUNCHES, scan.SCAN_LAUNCHES  # just after
            pv.beam_search_inline, pv.batched_beam_search = real_inline, real_plain
        first = time.perf_counter() - t0
        rec, overlap, notes = check_results(oracle, queries, filters, ids, dists, K, sample,
                                            pad_id=0)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            tree.batch_search(queries, filters, nq, method, qparams)
            walls.append(time.perf_counter() - t0)
        best = min(walls)
        total, spans, tasks = tree_breakdown(torch, tree, queries, filters, qparams,
                                             method, nq)
        log(f"tree {name} frac2^-2 beam {TREE_BEAM} x{TREE_FM}: recall@{K} {rec} on "
            f"{len(sample)} queries (id-set overlap {overlap}); wall best of 2 "
            f"{best * 1e3:.3f} ms, QPS {nq / best:.1f}, runs "
            f"{[round(w * 1e3, 3) for w in walls]} (first call {first * 1e3:.3f} ms); "
            f"beam_search launches {launches}, scan_topk launches {scan_launches}; "
            f"query-mode batched_beam_search calls {plain_calls[0]} over {plain_calls[1]} "
            f"searches; inline rows {sorted(tree._inline_attached)}; device bytes "
            f"{sum(g.device_bytes() for g in tree._graphs)}")
        log(f"tree {name} host breakdown: total {total:.3f} ms; " + "; ".join(
            f"{k} {ms:.3f} ms" for k, ms in spans.items()) + f"; tasks {tasks}")
        for note in notes[:3]:
            log(f"  near-tie at the k-th place, {note}")
        if rec < 0.99 or launches < 1:
            raise AssertionError(f"tree {name}: recall@{K} {rec} < 0.99 or no beam_search "
                                 f"launch ({launches})")
        if name == "fenwick":
            wall, dev, rows = device_breakdown(
                torch, lambda: tree.batch_search(queries, filters, nq, method, qparams))
            log(f"tree fenwick profile: wall {wall:.3f} ms, device busy {dev:.3f} ms "
                f"({100 * dev / wall:.1f}%), " + "; ".join(f"{k} {ms:.3f} ms" for k, ms in rows))

    # each method's largest beam kernel launch (single-shot for fenwick,
    # doubling for the others) against its plain version on the same inputs
    # (int8 blocks with a scale: held at recall level, as in the beam cases)
    for name, (a, kw, out) in captured.items():
        plain = beam.beam_search_plain(*a, **kw)
        torch.cuda.synchronize()
        gi, pi = out[0].cpu().numpy(), plain[0].cpu().numpy()
        mism = float((gi != pi).mean())
        same_vis = float((out[2] == plain[2]).double().mean())
        log(f"tree {name} beam kernel launch [{gi.shape[0]} queries, beam {kw['beam']}, "
            f"{a[0].dtype} blocks{' with a scale' if a[3] is not None else ''}]: {mism:.4%} "
            f"of frontier ids differ from the plain version, n_vis equal on {same_vis:.4f} "
            f"of queries")
        if mism >= 0.02:
            raise AssertionError(f"tree {name} beam kernel launch: {mism:.4%} ids differ")


@contextlib.contextmanager
def recorded_scans():
    """While open, every scan kernel call of the prefilter routing
    (models/base.scan_topk) keeps its inputs and output in the yielded list
    as (args, kwargs, out)."""
    from rangefilteredann_tpu_torch.models import base

    captured = []
    real_scan = base.scan_topk

    def recording_scan(*a, **kw):
        out = real_scan(*a, **kw)
        captured.append((a, kw, out))
        return out

    base.scan_topk = recording_scan
    try:
        yield captured
    finally:
        base.scan_topk = real_scan


def hold_scan_launch(torch, a, kw, out, what):
    """One scan kernel launch against the plain version on every one of its
    windows, under the scan cases' rule (ids equal except at near-ties,
    distances within RTOL/ATOL), the plain version run in blocks of
    PLAIN_BLOCK windows to bound its [Q, tile] buffers. Logs the launch,
    its kernel time beside its bound, and its grid; returns the largest
    |dd|."""
    from rangefilteredann_tpu_torch.ops import scan
    from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce

    data, norms, q_dev, st, en = a
    k, metric = kw["k"], kw["metric"]
    t0 = time.time()
    parts = [scan_bruteforce(data, norms, q_dev[j:j + PLAIN_BLOCK], st[j:j + PLAIN_BLOCK],
                             en[j:j + PLAIN_BLOCK], k + 1, metric)
             for j in range(0, q_dev.shape[0], PLAIN_BLOCK)]
    plain = tuple(torch.cat(x) for x in zip(*parts))
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    err, excused = compare_topk(out, plain, k, exact=False)
    width = (en.long() - st.long()).clamp(min=0)
    with torch.cuda.device(data.device):  # the events on the launch's own card
        kernel_ms = cuda_time_ms(torch, lambda: scan.scan_topk(*a, **kw), 3)
    flops, nbytes, _ = scan_work(a, kw)
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
    log(f"{what} scan launch [{q_dev.shape[0]} windows of {int(width.min())}-"
        f"{int(width.max())} rows, {int(width.sum())} in all, x {data.shape[0]} rows, "
        f"{metric}, k {k}]: kernel == plain on every window, max|dd|={err:.3g}, near-ties "
        f"excused={excused}; kernel {kernel_ms:.3f} ms, plain {plain_s:.1f} s; work "
        f"{flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB once, bound {b_ms:.4f} ms by {b_by}")
    log(f"scan grid {what}: {grid_note(scan_grid(torch, a, kw))}")
    return err


def run_prefilter_tree_path(torch, args, data):
    """The prefilter-leaf B-WST (no build) over the prefilter path's store,
    fenwick on its 2^-2 batch: every covered bucket is an exact window. The
    scan kernel's launch of that call is then held against its plain
    version on the launch's own inputs. Returns the largest |dd|."""
    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch.ops import beam, scan

    points, labels, queries, batches = data
    filters = batches["frac2^-2"]
    nq = len(queries)
    t0 = time.time()
    tree = P.RangeFilterTreeIndex(points, labels, cutoff=TREE_CUTOFF,
                                  split_factor=TREE_SPLIT, leaf="prefilter")
    torch.cuda.synchronize()
    log(f"prefilter-leaf tree: {len(points)} x {D} on {tree.device}, "
        f"{len(tree._offsets)} rows, made in {time.time() - t0:.1f} s")
    qparams = P.build_query_params(K, K)
    with recorded_scans() as captured:
        scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
        try:
            ids, dists = tree.batch_search(queries, filters, nq, "fenwick", qparams)
        finally:
            launches, beam_launches = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
    rng = np.random.default_rng(args.seed + 1)
    sample = rng.choice(nq, size=min(SAMPLE, nq), replace=False)
    rec, overlap, _ = check_results(Oracle(points, labels), queries, filters, ids, dists,
                                    K, sample, pad_id=0)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        tree.batch_search(queries, filters, nq, "fenwick", qparams)
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    total, spans, tasks = tree_breakdown(torch, tree, queries, filters, qparams,
                                         "fenwick", nq)
    log(f"prefilter-leaf tree fenwick frac2^-2: recall@{K} {rec} on {len(sample)} queries "
        f"(id-set overlap {overlap}); wall best of 2 {best * 1e3:.3f} ms, QPS "
        f"{nq / best:.1f}, runs {[round(w * 1e3, 3) for w in walls]}; scan_topk launches "
        f"{launches}, beam_search launches {beam_launches}")
    log(f"prefilter-leaf tree fenwick host breakdown: total {total:.3f} ms; " + "; ".join(
        f"{k} {ms:.3f} ms" for k, ms in spans.items()) + f"; tasks {tasks}")
    if rec != 1.0 or launches < 1:
        raise AssertionError(f"prefilter-leaf tree: recall@{K} {rec} or no scan_topk launch")

    # every window of each launch against the plain version
    return max(hold_scan_launch(torch, a, kw, out, "prefilter-leaf tree")
               for a, kw, out in captured)


SUPER_SPLIT, SUPER_SHIFT = 2.0, 0.5  # bench.py:341-345
# bench.py's cutoff is 1000 (rows 1-8 at 200k points); rows 6-8 (buckets of
# 3,125 points and fewer, ~150 s of builds) are cut for the run's time:
# the 2^-2 batch's windows of 50,000 points route to rows 1 and 2.
SUPER_CUTOFF = 6250
SUPER_BEAMS = (40, 80)  # bench.py:396-412, each at final_beam_multiply 2


def super_breakdown(torch, tree, queries, filters, qparams, nq):
    """Host clock around the stages of one SuperOptimizedPostfilterTree.
    batch_search call: routing, plan_row_inline, each routed row's
    doubling_postfilter call (named by its row, its queries and whether the
    row's searches take B2 or the plain search) and finalize_output, each
    between two synchronises; "other" holds the rest. Returns (total ms,
    {stage: ms})."""
    from rangefilteredann_tpu_torch.models import super_postfilter_tree as spt

    spans = {}
    marked = functools.partial(span_timer, torch, spans)
    tree._route_batch = marked(tree._route_batch, "routing")
    real = spt.plan_row_inline, spt.doubling_postfilter, spt.finalize_output

    def per_row(ps, g, *a, **kw):
        r = next(i for i, x in enumerate(tree._graphs) if x is g)
        route = "B2" if g.nbr_vecs is not None else "plain"
        name = f"doubling row {r} ({len(kw['q_rows'])} queries, {route})"
        return marked(real[1], name)(ps, g, *a, **kw)

    spt.plan_row_inline = marked(real[0], "inline blocks")
    spt.doubling_postfilter = per_row
    spt.finalize_output = marked(real[2], "finalize_output")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree.batch_search(queries, filters, nq, qparams)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        spt.plan_row_inline, spt.doubling_postfilter, spt.finalize_output = real
        del tree._route_batch
    spans["other"] = total - sum(spans.values())
    return total, spans


def run_super_tree_path(torch, args, cache, data, flat_nbrs):
    """The super tree at bench.py's super configuration over the graph
    path's data (cutoff SUPER_CUTOFF, split 2.0, shift 0.5, R=48, L=100,
    alpha=1.2), row 0 loaded from the graph's cache, rows 1-5 built on the
    card; then
    the 2^-2 batch at beam 40 and 80, x2, each with every kernel's launch
    count reset just before one call and read just after. Returns the beam
    kernel's launches over those calls."""
    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch import native
    from rangefilteredann_tpu_torch.models import base
    from rangefilteredann_tpu_torch.models import postfilter_vamana as pv
    from rangefilteredann_tpu_torch.models import super_postfilter_tree as spt
    from rangefilteredann_tpu_torch.ops import beam, scan

    if not native.available():  # the phase measures the native router
        raise AssertionError("the native router did not build (g++ missing?)")
    points, labels, queries, batches = data
    filters = batches["frac2^-2"]
    nq, n = len(queries), len(points)
    bp = tree_build_params(P, cache)
    layout = spt.super_row_layout(n, SUPER_CUTOFF, SUPER_SPLIT, SUPER_SHIFT)
    slabs = [int(spt.SuperOptimizedPostfilterTree._row_slab(n, *row)[0][-1])
             for row in layout]
    row_of = {m: r for r, m in enumerate(slabs)}  # slab points -> row
    t0 = time.time()
    with recorded_rows(torch, lambda off: row_of[int(off[-1])]) as (builds, loads):
        tree = P.SuperOptimizedPostfilterTree(
            points, labels, cutoff=SUPER_CUTOFF, split_factor=SUPER_SPLIT,
            shift_factor=SUPER_SHIFT, build_params=bp)
    torch.cuda.synchronize()
    total = time.time() - t0
    canon = base.whole_dataset_cache(cache, bp, float(labels.min()), float(labels.max()), n)
    if loads != [canon] or sorted(builds) != list(range(1, len(layout))) or \
            not np.array_equal(tree._graphs[0].nbrs_host, flat_nbrs):
        raise AssertionError(f"super row 0 did not load the graph's cache: loads {loads}, "
                             f"rows built {sorted(builds)}")
    log(f"super tree: SuperOptimizedPostfilterTree on {tree.device} ({len(layout)} rows, "
        f"cutoff {SUPER_CUTOFF}, split {SUPER_SPLIT}, shift {SUPER_SHIFT}, R=48, L=100, "
        f"alpha=1.2, native router {native.available()}) in {total:.1f} s with the cache "
        f"writes; row 0 loaded from the graph's cache {os.path.basename(canon)}; rows built: "
        + ", ".join(f"row {r} ({layout[r][2]} buckets of {layout[r][0]}, slab {slabs[r]}) "
                    f"{builds[r]:.1f} s" for r in sorted(builds))
        + f"; {sum(builds.values()):.1f} s of builds for {sum(slabs[1:])} slab points")
    log(f"super rows: adjacency and slab maps on the card "
        f"{sum(g.device_bytes() for g in tree._graphs)} B; int8 inline blocks of a row "
        + ", ".join(f"{r}: {g.inline_bytes(tree._ps, torch.int8)}"
                    for r, g in enumerate(tree._graphs))
        + f" B; budget {base.TREE_INLINE_BUDGET} B")

    oracle = Oracle(points, labels)
    rng = np.random.default_rng(args.seed + 1)
    sample = rng.choice(nq, size=min(SAMPLE, nq), replace=False)
    captured = {}  # the largest beam kernel launch (a, kw, out)
    plain_calls, routed = [0, 0], {}
    real_inline, real_plain = pv.beam_search_inline, pv.batched_beam_search
    real_route = tree._route_batch

    def recording_inline(*a, **kw):
        out = real_inline(*a, **kw)
        if "launch" not in captured or a[4].shape[0] > captured["launch"][0][4].shape[0]:
            captured["launch"] = (a, kw, out)
        return out

    def counting_plain(*a, **kw):  # query-mode searches that missed the kernel
        plain_calls[0] += 1
        plain_calls[1] += a[4].shape[0]
        return real_plain(*a, **kw)

    def recording_route(*a, **kw):
        rows, buckets = real_route(*a, **kw)
        routed["rows"] = rows
        return rows, buckets

    total_launches = 0
    for beam_w in SUPER_BEAMS:
        qparams = P.build_query_params(K, beam_w, final_beam_multiply=TREE_FM)
        plain_calls[:] = [0, 0]
        pv.beam_search_inline, pv.batched_beam_search = recording_inline, counting_plain
        tree._route_batch = recording_route
        scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
        t0 = time.perf_counter()
        try:
            ids, dists = tree.batch_search(queries, filters, nq, qparams)
        finally:
            launches, scan_launches = beam.BEAM_LAUNCHES, scan.SCAN_LAUNCHES  # just after
            pv.beam_search_inline, pv.batched_beam_search = real_inline, real_plain
            del tree._route_batch
        first = time.perf_counter() - t0
        total_launches += launches
        rec, overlap, notes = check_results(oracle, queries, filters, ids, dists, K, sample,
                                            hi_side="right", pad_id=0)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            tree.batch_search(queries, filters, nq, qparams)
            walls.append(time.perf_counter() - t0)
        best = min(walls)
        spent, spans = super_breakdown(torch, tree, queries, filters, qparams, nq)
        urows, ucounts = np.unique(routed["rows"], return_counts=True)
        log(f"super tree frac2^-2 beam {beam_w} x{TREE_FM}: recall@{K} {rec} on "
            f"{len(sample)} queries (id-set overlap {overlap}); wall best of 2 "
            f"{best * 1e3:.3f} ms, QPS {nq / best:.1f}, runs "
            f"{[round(w * 1e3, 3) for w in walls]} (first call {first * 1e3:.3f} ms); "
            f"beam_search launches {launches}, scan_topk launches {scan_launches}; "
            f"query-mode batched_beam_search calls {plain_calls[0]} over {plain_calls[1]} "
            f"searches; routed rows (row: queries) "
            f"{dict(zip(urows.tolist(), ucounts.tolist()))}; int8 inline rows "
            f"{sorted(tree._inline_attached)}")
        log(f"super tree beam {beam_w} host breakdown: total {spent:.3f} ms; " + "; ".join(
            f"{k} {ms:.3f} ms" for k, ms in spans.items()))
        for note in notes[:3]:
            log(f"  near-tie at the k-th place, {note}")
        if rec < 0.99 or launches < 1:
            raise AssertionError(f"super tree beam {beam_w}: recall@{K} {rec} < 0.99 or no "
                                 f"beam_search launch ({launches})")

    # the largest beam kernel launch against its plain version (int8 blocks
    # with a scale: held at recall level, as in the beam cases)
    a, kw, out = captured["launch"]
    plain = beam.beam_search_plain(*a, **kw)
    torch.cuda.synchronize()
    gi, pi = out[0].cpu().numpy(), plain[0].cpu().numpy()
    mism = float((gi != pi).mean())
    same_vis = float((out[2] == plain[2]).double().mean())
    kernel_ms = cuda_time_ms(torch, lambda: beam.beam_search_inline(*a, **kw), 3)
    plain_ms = cuda_time_ms(torch, lambda: beam.beam_search_plain(*a, **kw), 1)
    log(f"super tree beam kernel launch [{gi.shape[0]} queries, beam {kw['beam']}, "
        f"{a[0].dtype} blocks{' with a scale' if a[3] is not None else ''}]: {mism:.4%} "
        f"of frontier ids differ from the plain version, n_vis equal on {same_vis:.4f} "
        f"of queries; kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events)")
    if mism >= 0.02:
        raise AssertionError(f"super tree beam kernel launch: {mism:.4%} ids differ")
    return total_launches


def exact_knn(torch, points, queries, k, block=1024):
    """(ids [Q, k] int64, dists [Q, k] float64): the k nearest points of each
    query over the whole store, float64 products on the card."""
    x = torch.from_numpy(points).cuda().double()
    xn = (x * x).sum(dim=1)
    ids, dists = [], []
    for j in range(0, len(queries), block):
        q = torch.from_numpy(queries[j:j + block]).cuda().double()
        d = xn[None, :] - 2.0 * (q @ x.T) + (q * q).sum(dim=1)[:, None]
        dv, di = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ids.append(di.cpu().numpy())
        dists.append(dv.cpu().numpy())
    return np.concatenate(ids), np.concatenate(dists)


VAMANA_BEAMS = (10, 20, 40, 80)
PREFIX_N = 20_000  # points of the build_vamana_index run


def run_vamana_index_path(torch, args, tmp, data, flat_nbrs):
    """The file-based surface over the graph path's data: its vectors, in
    the label-sorted order its graph indexes, and the graph written as
    reference-format files, VamanaIndex loaded from
    them on the card and searched unfiltered at each beam of VAMANA_BEAMS
    (recall against a float64 ground-truth file and the sampled oracle),
    the command line over the same files, and build_vamana_index on a
    PREFIX_N-point prefix."""
    import io

    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch import cli
    from rangefilteredann_tpu_torch.models import vamana_index as vi
    from rangefilteredann_tpu_torch.ops import beam, scan
    from rangefilteredann_tpu_torch.utils import io as bin_io

    points, labels, queries, _ = data
    points = points[np.argsort(labels, kind="stable")]  # the order the graph indexes
    labels = np.sort(labels)
    nq = len(queries)
    path = {k: os.path.join(tmp, f"{k}.bin")
            for k in ("base", "graph", "queries", "gt", "prefix", "prefix_graph")}
    t0 = time.time()
    bin_io.write_vector_file(path["base"], points)
    bin_io.write_graph_file(path["graph"], flat_nbrs)
    bin_io.write_vector_file(path["queries"], queries)
    gt_ids, gt_d = exact_knn(torch, points, queries, K)
    bin_io.write_groundtruth_file(path["gt"], gt_ids, gt_d)
    log(f"vamana files: base {os.path.getsize(path['base'])} B, graph "
        f"{os.path.getsize(path['graph'])} B, queries, float64 ground truth at k={K}; "
        f"in {time.time() - t0:.1f} s")
    t0 = time.time()
    idx = P.VamanaIndex(path["graph"], path["base"], num_points=len(points), dimensions=D)
    torch.cuda.synchronize()
    if not np.array_equal(idx._graph.nbrs_host, flat_nbrs):
        raise AssertionError("the graph file did not round-trip")
    log(f"VamanaIndex on {idx.device} loaded in {time.time() - t0:.1f} s; inline blocks "
        f"{idx._graph.inline_dtype}")

    rng = np.random.default_rng(args.seed + 1)
    sample = rng.choice(nq, size=min(SAMPLE, nq), replace=False)
    plain_calls = [0]
    real_plain = vi.batched_beam_search

    def counting_plain(*a, **kw):
        plain_calls[0] += 1
        return real_plain(*a, **kw)

    recall_at = {}
    for beam_w in VAMANA_BEAMS:
        plain_calls[0] = 0
        vi.batched_beam_search = counting_plain
        scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
        try:
            ids, dists = idx.batch_search(queries, nq, K, beam_w)
        finally:
            launches, scan_launches = beam.BEAM_LAUNCHES, scan.SCAN_LAUNCHES  # just after
            vi.batched_beam_search = real_plain
        recall_at[beam_w] = idx.check_recall(path["gt"], ids, K)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            idx.batch_search(queries, nq, K, beam_w)
            walls.append(time.perf_counter() - t0)
        best = min(walls)
        log(f"VamanaIndex unfiltered beam {beam_w}: recall@{K} {recall_at[beam_w]} "
            f"(check_recall against the ground-truth file); wall best of 2 "
            f"{best * 1e3:.3f} ms, QPS {nq / best:.1f}, runs "
            f"{[round(w * 1e3, 3) for w in walls]}; batched_beam_search calls "
            f"{plain_calls[0]}, beam_search launches {launches}, scan_topk launches "
            f"{scan_launches}")
    # the last beam's results: shapes, padding and every distance against the
    # float64 oracle over the whole store (a window holding every label)
    everything = np.tile([[-1.0, 2.0]], (nq, 1))
    rec, overlap, _ = check_results(Oracle(points, labels), queries, everything, ids,
                                    dists, K, sample, pad_id=0)
    log(f"VamanaIndex beam {beam_w} on the sampled oracle: recall@{K} {rec} (id-set "
        f"overlap {overlap})")
    if recall_at[beam_w] < 0.99:
        raise AssertionError(f"VamanaIndex recall@{K} {recall_at[beam_w]} < 0.99 at beam "
                             f"{beam_w}")
    del idx
    torch.cuda.empty_cache()

    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        cli.main(["-base_path", path["base"], "-query_path", path["queries"],
                  "-gt_path", path["gt"], "-graph_path", path["graph"], "-k", str(K),
                  "-beams", ",".join(map(str, VAMANA_BEAMS))])
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"  cli: {line}")
    rows = [ln.split() for ln in lines if ln.split() and ln.split()[0].isdigit()]
    if [int(r[0]) for r in rows] != list(VAMANA_BEAMS) or float(rows[-1][1]) < 0.99:
        raise AssertionError(f"the command line printed {lines}")
    log(f"cli over the files in {time.time() - t0:.1f} s")

    m = min(PREFIX_N, len(points))
    bin_io.write_vector_file(path["prefix"], points[:m])
    t0 = time.time()
    P.build_vamana_index("Euclidian", path["prefix"], path["prefix_graph"], 48, 100, 1.2)
    torch.cuda.synchronize()
    built = time.time() - t0
    pidx = P.VamanaIndex(path["prefix_graph"], path["prefix"])
    p_ids, p_d = exact_knn(torch, points[:m], queries, K)
    bin_io.write_groundtruth_file(path["gt"], p_ids, p_d)
    ids, _ = pidx.batch_search(queries, nq, K, VAMANA_BEAMS[-1])
    rec = pidx.check_recall(path["gt"], ids, K)
    log(f"build_vamana_index over a {m}-point prefix (R=48, L=100, alpha=1.2) on the card "
        f"in {built:.1f} s; VamanaIndex recall@{K} at beam {VAMANA_BEAMS[-1]}: {rec}")
    if rec < 0.95:
        raise AssertionError(f"prefix build recall@{K} {rec} < 0.95")


def run_variants_on_batch(torch, inputs, b1_ms, errs):
    """The scan variants on the prefilter main path's 2^-2 batch (the scan
    kernel's own inputs): each against the plain version, its max |dd| kept
    in errs, then timed by CUDA events beside the scan kernel."""
    from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
    from rangefilteredann_tpu_torch.tools.exp_scan2 import scan_v2

    a, kw = inputs
    k, d_eff = kw["k"], kw["d_eff"]
    plain = scan_bruteforce(*a, k + 1, "l2")
    for name, fn in variant_runs("l2"):
        got = fn(*a, k, d_eff=d_eff)
        torch.cuda.synchronize()
        err, excused = compare_topk(got, plain, k, exact=False)
        note_err(errs, name, err)
        ms = cuda_time_ms(torch, lambda: fn(*a, k, d_eff=d_eff), 3)
        log(f"prefilter 2^-2 batch [{a[2].shape[0]} queries x {a[0].shape[0]} rows] {name}: "
            f"{ms:.3f} ms (scan kernel {b1_ms:.3f} ms, {ms / b1_ms:.2f}x), == plain, "
            f"max|dd|={err:.3g}, near-ties excused={excused}")
    for t, b in variant_shapes():
        ms = cuda_time_ms(torch, lambda: scan_v2(*a, k, tile=t, bf16=True, d_eff=d_eff,
                                                 qblock=b), 3)
        log(f"prefilter 2^-2 batch v2 bf16 T={t} QB={b}: {ms:.3f} ms (scan kernel "
            f"{b1_ms:.3f} ms, {ms / b1_ms:.2f}x)")


def harness_checks(torch, h, prod_name, names, gt=None):
    """Each named run of a harness against the plain version (near-tie
    tolerant) and, with an oracle, against the float64 oracle: its set-match
    must equal the scan kernel's. Returns (max |dd|, best ms, plain ms)."""
    from rangefilteredann_tpu_torch.tools import D as HD, K as HK, window_scan_plain

    plain = window_scan_plain(*h.args, HK + 1, d_eff=HD)
    plain_ms = cuda_time_ms(torch, lambda: window_scan_plain(*h.args, HK, d_eff=HD), 1)
    prod = h.runs[prod_name][0]
    compare_topk(prod, plain, HK, exact=False)
    prod_set = h.check(gt, prod[1], prod_name)[0] if gt is not None else None
    worst, best = 0.0, float("inf")
    for name in names:
        out, ms = h.runs[name]
        err, excused = compare_topk(out, plain, HK, exact=False)
        same = float((out[1] == prod[1]).double().mean())
        worst, best = max(worst, err), min(best, ms)
        note = ""
        if gt is not None:
            set_m, pos_m = h.check(gt, out[1], name)
            if set_m != prod_set:
                raise AssertionError(f"{name}: oracle set-match {set_m}, scan kernel {prod_set}")
            note = f", oracle set-match {set_m} pos-match {pos_m}"
        log(f"harness {name}: {ms:.3f} ms, == plain (max|dd|={err:.3g}, near-ties "
            f"excused={excused}), ids equal to the scan kernel's {same:.6f}{note}")
    return worst, best, plain_ms


def run_variant_path(torch, args, errs):
    """The scan-variant harness at its own size, through the tools'
    main(). errs holds each kernel's max |dd| from the earlier phases, by
    name. Returns the kernels line's entries of v2, v3, v3b and the probe."""
    from rangefilteredann_tpu_torch.ops import beam, scan
    from rangefilteredann_tpu_torch.tools import D as HD, GRIDS, K as HK, make_harness
    from rangefilteredann_tpu_torch.tools import exp_scan2 as v2
    from rangefilteredann_tpu_torch.tools import exp_scan3 as v3
    from rangefilteredann_tpu_torch.tools import exp_scan3b as v3b
    from rangefilteredann_tpu_torch.tools import scan_items

    argv = ["--n", str(args.variant_n), "--nq", str(args.variant_nq),
            "--reps", str(VARIANT_REPS)]
    dups = ["--dups", "--reps", "1"]
    t0 = time.time()
    # every kernel's count, just before
    scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0
    v2.SCAN_V2_LAUNCHES = v3.SCAN_V3_LAUNCHES = v3b.SCAN_V3B_LAUNCHES = v3b.PROBE_LAUNCHES = 0
    h2 = v2.main(argv)
    h3 = v3.main(argv)
    h3b = v3b.main(argv)
    h3d = v3.main(argv + dups)
    h3bd = v3b.main(argv + dups + ["--skip-probe"])
    h2d = make_harness(args.variant_n, args.variant_nq, "cuda", 1, dups=True, degenerate=True)
    tile, qblock = variant_shapes()[0]
    h2d.timeit("prod", lambda: scan.scan_topk(*h2d.args, HK, "l2", d_eff=HD))
    h2d.timeit("v2 dups", lambda: v2.scan_v2(*h2d.args, HK, tile=tile, d_eff=HD,
                                             qblock=qblock))
    launches = {"scan_v2": v2.SCAN_V2_LAUNCHES, "scan_v3": v3.SCAN_V3_LAUNCHES,
                "scan_v3b": v3b.SCAN_V3B_LAUNCHES, "probe": v3b.PROBE_LAUNCHES}
    b1_launches, beam_launches = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
    log(f"variant harness path: launches {launches}, scan_topk {b1_launches}, beam_search "
        f"{beam_launches}, in {time.time() - t0:.1f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"the harness path never launched a kernel: {launches}")

    def runs(h, prefix):
        return [n for n in h.runs if n.startswith(prefix)]

    # (kernel name, its harness, the harness's scan-kernel run, the kernel's runs)
    harnesses = (("scan_v2", h2, "prod scan_topk fp32", runs(h2, "v2 insert fp32")),
                 ("scan_v3", h3, "prod", runs(h3, "v3 ")),
                 ("scan_v3b", h3b, "prod", runs(h3b, "v3b ")))
    timed = {}
    for name, h, prod_name, names in harnesses:
        err, ms, plain_ms = harness_checks(torch, h, prod_name, names, h.oracle(HK))
        errs[name] = max(errs.get(name, 0.0), err)
        flops, nbytes, _ = scan_work(h.args, {"k": HK, "d_eff": HD})
        timed[name] = (ms, plain_ms, *bound(flops, nbytes, PEAK_FP32_FLOPS))
        log(f"harness {name}: work {flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB once; "
            f"bound {timed[name][2]:.4f} ms by {timed[name][3]} at the fp32 rate; best "
            f"{ms:.3f} ms; scan kernel {h.runs[prod_name][1]:.3f} ms")
    log(f"scan grid harness: {grid_note(scan_grid(torch, h2.args, {'k': HK, 'metric': 'l2', 'd_eff': HD}))}")
    for tile, qblock in sorted({(t, b) for t, b, _ in v3b.CASES}):
        g = v3b.grid(*h3b.args, HK, tile=tile, d_eff=HD, qblock=qblock)
        log(f"scan_v3b grid harness T={tile} QB={qblock}: {scan_items.grid_note(g, tile)}")
    for tile, qblock in GRIDS:
        g = v3.grid(*h3.args, HK, tile=tile, d_eff=HD, qblock=qblock)
        log(f"scan_v3 grid harness T={tile} QB={qblock}: {scan_items.grid_note(g, tile)}")
    for (tile, qblock), bf16 in itertools.product(variant_shapes(), (False, True)):
        g = v2.grid(*h2.args, HK, tile=tile, bf16=bf16, d_eff=HD, qblock=qblock)
        log(f"scan_v2 grid harness T={tile} QB={qblock} {'bf16' if bf16 else 'fp32'}: "
            f"{scan_items.grid_note(g, tile)}")
    # device time a call, by kernel: the item kernel, the merge of item lists
    # and the wrapper's own ops (midpoint sort, plan, scratch)
    tile0, qb0 = variant_shapes()[0]
    ids_k = v2.scan_v2(*h2.args, v2.RERANK_K, tile=tile0, bf16=True, d_eff=HD, qblock=qb0)[1]
    profiled = [(f"v2 {'bf16' if bf16 else 'fp32'} T={t} QB={b}",
                 functools.partial(v2.scan_v2, *h2.args, HK, tile=t, bf16=bf16, d_eff=HD, qblock=b))
                for (t, b), bf16 in itertools.product(variant_shapes(), (False, True))]
    profiled += [
        ("v2 fp32 T=4096 QB=8", functools.partial(v2.scan_v2, *h2.args, HK, tile=4096, d_eff=HD,
                                                  qblock=8)),
        (f"v2 bf16 k'={v2.RERANK_K} T={tile0} QB={qb0}",
         functools.partial(v2.scan_v2, *h2.args, v2.RERANK_K, tile=tile0, bf16=True, d_eff=HD,
                           qblock=qb0)),
        (f"rerank_fp32 k'={v2.RERANK_K}",
         functools.partial(v2.rerank_fp32, h2.ps.data, h2.ps.norms_sq, h2.qp, ids_k, HK)),
        (f"v3b T={tile0} QB={qb0} U=4", functools.partial(v3b.scan_v3b, *h2.args, HK, tile=tile0,
                                                        d_eff=HD, qblock=qb0, unroll=4))]
    profiled += [(f"v3 T={t} QB={b}", functools.partial(v3.scan_v3, *h3.args, HK, tile=t,
                                                        d_eff=HD, qblock=b)) for t, b in GRIDS]
    for name, fn in profiled:
        fn()
        ms = cuda_time_ms(torch, fn, 10)
        _, dev, rows = device_breakdown(torch, lambda: [fn() for _ in range(10)], top=1000)
        part = {key: sum(t for op, t in rows if key in op) / 10 for key in ("items_kernel",
                                                                             "merge_items")}
        log(f"harness device {name}: {dev / 10:.4f} ms a call (item kernel "
            f"{part['items_kernel']:.4f}, merge {part['merge_items']:.4f}, other ops "
            f"{dev / 10 - sum(part.values()):.4f}); CUDA events {ms:.4f} ms a call")
    for name, h, prefix in (("scan_v3", h3d, "v3 "), ("scan_v3b", h3bd, "v3b "),
                            ("scan_v2", h2d, "v2 ")):
        err, _, _ = harness_checks(torch, h, "prod", runs(h, prefix))
        errs[name] = max(errs.get(name, 0.0), err)

    # v2's bf16 pass against its plain version, and the recall of bf16 + rerank
    bf16_name = next(n for n in h2.runs if n.startswith("v2 insert bf16") and "rerank" not in n)
    plain_bf16 = v2.scan_v2_plain(*h2.args, HK + 1, bf16=True, d_eff=HD)
    err, excused = compare_topk(h2.runs[bf16_name][0], plain_bf16, HK, exact=False)
    errs["scan_v2"] = max(errs["scan_v2"], err)
    rerank_name = next(n for n in h2.runs if "rerank" in n)
    recall = h2.checks[bf16_name + "+rerank"][0]
    flops, nbytes, _ = scan_work(h2.args, {"k": HK, "d_eff": HD})
    bf16_bound, bf16_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"harness {bf16_name}: {h2.runs[bf16_name][1]:.3f} ms, == its plain version "
        f"(max|dd|={err:.3g}, near-ties excused={excused}), oracle set-match "
        f"{h2.checks[bf16_name][0]}; bound {bf16_bound:.4f} ms by {bf16_by} at the bf16 rate; "
        f"{rerank_name}: {h2.runs[rerank_name][1]:.3f} ms, recall (oracle set-match) {recall}")

    x = torch.ones((8, 128), dtype=torch.float32).cuda()
    probe_ms = cuda_time_ms(torch, lambda: v3b.probe_sum(x), 20)
    probe_plain = cuda_time_ms(torch, lambda: v3b.probe_nested_while_plain(x), 20)
    timed["probe"] = (probe_ms, probe_plain,
                      *bound(6.0 * x.numel(), 2 * 4 * x.numel(), PEAK_FP32_FLOPS))
    # the probe kernel's own device time, beside one elementwise launch of
    # torch on the same tensor (context only: torch.mul rounds once)
    dev_ms = {}
    for name, fn, key in (("probe kernel", lambda: v3b.probe_sum(x), "probe_nested_while"),
                          ("torch.mul(x, 6.0)", lambda: torch.mul(x, 6.0), "")):
        _, _, rows = device_breakdown(torch, lambda fn=fn: [fn() for _ in range(100)], top=1000)
        dev_ms[name] = sum(t for op, t in rows if key in op) / 100
    log(f"harness device probe [8, 128]: kernel {dev_ms['probe kernel']:.6f} ms a launch "
        f"(profiler), torch.mul(x, 6.0) {dev_ms['torch.mul(x, 6.0)']:.6f} ms a launch (one "
        f"elementwise launch, context only); CUDA events of the wrapper {probe_ms:.6f} ms a "
        f"call, plain version {probe_plain:.6f}; bound {timed['probe'][2]:.7f} ms by "
        f"{timed['probe'][3]}: at this shape the time is one launch")

    def entry(name, source, replaces):
        ms, plain_ms, b_ms, b_by = timed[name]
        return {"name": name, "route": "cuda",
                "source": f"rangefilteredann_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    return [entry("scan_v2", "scan_v2.cu", "tools/exp_scan2.py:73"),
            entry("scan_v3", "scan_v3.cu", "tools/exp_scan3.py:85"),
            entry("scan_v3b", "scan_v3b.cu", "tools/exp_scan3b.py:114"),
            entry("probe", "scan_v3b.cu", "tools/exp_scan3b.py:60")]


ADV_NAME, SYN_NAME = "adversarial-100-angular", "synthetic-64-euclidean"
# the synthetic set's driver run: one width, beam and multiply, bench.py's
# build (bench.py:48-49), the graph methods beside the exact prefilter; the
# super tree is left out for the run's time limit (its build took 59.7 s
# here, and phase 6 runs it at full width)
SYN_ARGS = ["--experiment_filter_width", "2pow-2", "--beam_search_size", "40",
            "--num_final_multiplies", "2", "--build_R", "48", "--build_L", "100",
            "--prefiltering", "--postfiltering", "--optimized_postfiltering",
            "--vamana_tree", "--three_split", "--smart_combined"]


def gt_recall(folder, name, width, rng, angular):
    """Recall@K of a protocol set's ground-truth file against a float64
    numpy oracle on SAMPLE queries drawn by rng: a listed id counts when it
    lies in its query's window (inclusive at both ends) and its true
    distance is within TIE_EPS of the true k-th. Returns (recall, the
    file's shape)."""
    from rangefilteredann_tpu_torch.experiments import datasets as ds

    data, queries, labels, _ = ds.initialize_dataset(name, folder)
    ranges, gt = ds.get_queries_and_gt(name, width, folder)
    sample = rng.choice(len(queries), size=min(SAMPLE, len(queries)), replace=False)
    order = np.argsort(labels, kind="stable")
    ls = labels[order]

    def dist(ids, q):
        x = data[ids].astype(np.float64)
        return -(x @ q) if angular else ((x - q) ** 2).sum(axis=1)

    hits = 0.0
    for qi in sample:
        lo, hi = ranges[qi]
        q = queries[qi].astype(np.float64)
        cand = order[np.searchsorted(ls, lo, "left"):np.searchsorted(ls, hi, "right")]
        kth = np.partition(dist(cand, q), K - 1)[K - 1]
        inside = (labels[gt[qi]] >= lo) & (labels[gt[qi]] <= hi)
        hits += float((inside & (dist(gt[qi], q) <= kth + TIE_EPS)).sum()) / K
    return hits / len(sample), gt.shape


def run_driver(torch, argv):
    """The port's run_our_method.main(argv) from the working directory, with
    every kernel's launch count reset just before and read just after. Each
    search's launches are also taken apart at its compute_recall call (the
    driver scores each timed search right after it: its warm-up, its timed
    run and, for the first search of an index, the build). Returns (CSV
    rows, per-row (B1, B2 launches, plain-route calls, searches), B1
    launches, B2 launches, seconds)."""
    import csv

    from rangefilteredann_tpu_torch.experiments import run_our_method as rom
    from rangefilteredann_tpu_torch.models import postfilter_vamana as pv
    from rangefilteredann_tpu_torch.ops import beam, scan

    plain = [0, 0]
    marks, per_row = [(0, 0, 0, 0)], []
    real_recall, real_plain = rom.compute_recall, pv.batched_beam_search

    def counting_plain(*a, **kw):  # query-mode searches that missed the kernel
        plain[0] += 1
        plain[1] += a[4].shape[0]
        return real_plain(*a, **kw)

    def marked_recall(*a, **kw):
        now = (scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES, *plain)
        per_row.append(tuple(x - y for x, y in zip(now, marks[-1])))
        marks.append(now)
        return real_recall(*a, **kw)

    rom.compute_recall, pv.batched_beam_search = marked_recall, counting_plain
    t0 = time.time()
    scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
    try:
        rom.main(argv)
    finally:
        b1, b2 = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
        rom.compute_recall, pv.batched_beam_search = real_recall, real_plain
    seconds = time.time() - t0
    name = argv[argv.index("--dataset") + 1]
    with open(os.path.join("results", f"{name}_results.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != len(per_row):
        raise AssertionError(f"{len(rows)} CSV rows for {len(per_row)} scored searches")
    return rows, per_row, b1, b2, seconds


def run_experiments_path(torch, args):
    """The experiment layer (rangefilteredann_tpu_torch/experiments) in a
    temporary directory that is also the benchmark driver's working
    directory: the adversarial set at the reference's scale with its ground
    truth on the scan kernel, the driver's prefiltering on it, then the
    synthetic set and the driver's graph methods. Returns (B1 launches, B2
    launches, the largest |dd| of the held B1 launch)."""
    from rangefilteredann_tpu_torch.experiments import datasets as ds
    from rangefilteredann_tpu_torch.ops import beam, scan

    rng = np.random.default_rng(args.seed + 3)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_experiments_") as work:
        os.chdir(work)
        try:
            folder = os.path.join(work, "data")
            # 1. the adversarial set, 1M x 100 angular, 100 clusters, 10,000
            # queries, seed 0 (the reference's generate_advserial_dataset.py)
            spans = {}
            real_gt = ds.compute_ground_truths
            ds.compute_ground_truths = span_timer(torch, spans, real_gt, "gt")
            t0 = time.time()
            with recorded_scans() as captured:
                scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # just before
                try:
                    ds.generate_adversarial(folder, seed=0)
                finally:
                    gen_b1, gen_b2 = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
                    ds.compute_ground_truths = real_gt
            total = time.time() - t0
            gt_s = spans["gt"] / 1e3
            rec, shape = gt_recall(folder, ADV_NAME, "", rng, angular=True)
            log(f"experiments {ADV_NAME}: generated in {total - gt_s:.1f} s, ground truth "
                f"{shape} in {gt_s:.1f} s on the card (scan_topk launches {gen_b1}, "
                f"beam_search {gen_b2}); ground-truth recall@{K} {rec} against the float64 "
                f"oracle on {SAMPLE} queries")
            if rec != 1.0 or gen_b1 < 1:
                raise AssertionError(f"{ADV_NAME} ground truth: recall@{K} {rec}, "
                                     f"scan_topk launches {gen_b1}")
            a, kw, out = max(captured, key=lambda c: c[0][2].shape[0])
            err = hold_scan_launch(torch, a, kw, out, f"{ADV_NAME} ground truth")
            del captured, a, kw, out
            torch.cuda.empty_cache()

            # 2. the driver's prefiltering on it
            rows, per_row, b1, b2, secs = run_driver(
                torch, ["--dataset", ADV_NAME, "--data_folder", folder, "--prefiltering"])
            for row, (r1, r2, _, _) in zip(rows, per_row):
                log(f"experiments {ADV_NAME} driver row: {dict(row)}; scan_topk launches "
                    f"{r1}, beam_search {r2}")
            log(f"experiments {ADV_NAME} driver: {secs:.1f} s, scan_topk launches {b1}, "
                f"beam_search {b2}")
            if [r["method"] for r in rows] != ["prefiltering"] or \
                    float(rows[0]["recall"]) != 1.0 or b1 < 1:
                raise AssertionError(f"{ADV_NAME} driver: rows {rows}, scan_topk {b1}")
            b1_all, b2_all = gen_b1 + b1, gen_b2 + b2
            for f in os.listdir(folder):
                os.remove(os.path.join(folder, f))  # 0.9 GB of protocol files
            torch.cuda.empty_cache()

            # 3. the synthetic set at its defaults (100,000 x 64, 1,000
            # queries, 17 fractions), then the graph methods
            scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # just before
            t0 = time.time()
            ds.generate_synthetic(folder)
            gen_b1, gen_b2 = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
            recs = {w: gt_recall(folder, SYN_NAME, w, rng, angular=False)[0]
                    for w in ("2pow-13", "2pow-6", "2pow-2", "2pow0")}
            log(f"experiments {SYN_NAME}: generated with ground truth in "
                f"{time.time() - t0:.1f} s (scan_topk launches {gen_b1}, beam_search "
                f"{gen_b2}); ground-truth recall@{K} {recs}")
            if min(recs.values()) != 1.0 or gen_b1 < 1:
                raise AssertionError(f"{SYN_NAME} ground truth: recall {recs}, scan_topk "
                                     f"launches {gen_b1}")
            rows, per_row, b1, b2, secs = run_driver(
                torch, ["--dataset", SYN_NAME, "--data_folder", folder] + SYN_ARGS)
            for row, (r1, r2, pc, ps) in zip(rows, per_row):
                log(f"experiments {SYN_NAME} driver row: {dict(row)}; scan_topk launches "
                    f"{r1}, beam_search {r2}, query-mode batched_beam_search calls {pc} "
                    f"over {ps} searches")
            log(f"experiments {SYN_NAME} driver: {secs:.1f} s, scan_topk launches {b1}, "
                f"beam_search {b2}")
            pre = [r for r in rows if r["method"] == "prefiltering"]
            if len(pre) != 1 or float(pre[0]["recall"]) != 1.0 or len(rows) != 6 or b2 < 1:
                raise AssertionError(f"{SYN_NAME} driver: rows {rows}, beam_search {b2}")
            return b1_all + gen_b1 + b1, b2_all + gen_b2 + b2, err
        finally:
            os.chdir(cwd)


# ------------------------------------------------------------ scale-out --

SHARDS = 4  # the mesh: cuda:0..3 when the card count allows, else logical shards
SHARD_TREE_METHODS = ("fenwick", "optimized_postfilter", "three_split")


def best_wall(torch, fn, reps):
    """(best ms, [ms]) of `reps` calls of fn, each ended by a synchronise."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return min(walls), [round(w, 3) for w in walls]


@contextlib.contextmanager
def recorded_shard_scans():
    """While open, every per-shard scan of parallel/sharded.py keeps its
    inputs and output in the yielded list as (args, kwargs, out)."""
    from rangefilteredann_tpu_torch.parallel import sharded

    captured = []
    real = sharded.scan_topk

    def recording(*a, **kw):
        out = real(*a, **kw)
        captured.append((a, kw, out))
        return out

    sharded.scan_topk = recording
    try:
        yield captured
    finally:
        sharded.scan_topk = real


def shard_scan_cases(torch, n_local, n_real, nq, dev):
    """(name, starts, ends) window cases over a store cut in SHARDS shards of
    n_local rows: windows across one and two shard boundaries, windows
    inside one shard (clipped to zero rows on the others), windows with
    fewer than k rows on each side of a boundary, and empty windows."""
    rng = np.random.default_rng(77)
    w = n_local // 12  # ~20,000 rows at the prefilter path's store
    edges = np.arange(1, SHARDS) * n_local
    at = rng.choice(edges, size=nq)
    one = (at - rng.integers(1, w, nq), at + rng.integers(1, w, nq))
    two = (rng.integers(0, n_local - w, nq), edges[1] + rng.integers(1, w, nq))
    s = rng.integers(0, SHARDS, nq) * n_local + rng.integers(0, n_local - 3 * w, nq)
    inside = (s, s + rng.integers(1, 3 * w, nq))
    short = (at - rng.integers(0, K, nq), at + rng.integers(0, K, nq))
    s = rng.integers(0, n_real, nq)
    empty = (s, s)
    out = []
    for name, (s, e) in (("one boundary", one), ("two boundaries", two),
                         ("inside one shard", inside), ("< k rows a side", short),
                         ("empty", empty)):
        s = np.clip(s, 0, n_real)
        e = np.clip(e, 0, n_real)
        out.append((name, torch.from_numpy(s.astype(np.int32)).to(dev),
                    torch.from_numpy(e.astype(np.int32)).to(dev)))
    return out


def run_sharded_scan(torch, mesh, batch_inputs):
    """The index-sharded scan on the prefilter path's store and its 2^-2
    batch: ids identical to the unsharded scan kernel launch, each of its
    per-shard launches held against the plain version, walls beside the
    unsharded launch, then window cases whose every per-shard launch is
    held too. Returns (scan launches of the main call, largest |dd|)."""
    from rangefilteredann_tpu_torch.ops import beam, scan
    from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
    from rangefilteredann_tpu_torch.parallel import sharded

    a, kw = batch_inputs
    data, norms, q_dev, st, en = a
    k, metric, d_eff = kw["k"], kw["metric"], kw.get("d_eff")
    data_sh, norms_sh = sharded.shard_rows(mesh, data, norms)
    n_local = data_sh[0].shape[0]

    def call(q=q_dev, s=st, e=en):
        return sharded.sharded_scan_bruteforce(mesh, data_sh, norms_sh, q, s, e, k, metric,
                                               d_eff=d_eff)

    ref_d, ref_i = scan.scan_topk(*a, **kw)
    with recorded_shard_scans() as main_launches:
        scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
        got_d, got_i = call()
        torch.cuda.synchronize()
        launches, b2 = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
    same = bool(torch.equal(got_i, ref_i))
    fin = torch.isfinite(ref_d)
    dd = float((got_d[fin] - ref_d[fin]).abs().max()) if bool(fin.any()) else 0.0
    if not same or not torch.equal(torch.isfinite(got_d), fin):
        raise AssertionError(f"sharded scan: {int((got_i != ref_i).sum())} ids differ from "
                             "the unsharded launch")
    if launches != mesh.size or b2:
        raise AssertionError(f"sharded scan: {launches} scan_topk launches, {b2} beam_search")
    walls = {}
    for name in ("unsharded", "sharded", "sharded", "unsharded"):  # in turns
        fn = (lambda: scan.scan_topk(*a, **kw)) if name == "unsharded" else call
        best, runs = best_wall(torch, fn, 3)
        walls.setdefault(name, []).append((best, runs))
    log(f"sharded scan [{q_dev.shape[0]} queries x {data.shape[0]} rows in {mesh.size} "
        f"shards of {n_local} on {[str(d) for d in mesh.devices]}, k {k}]: ids identical "
        f"to the unsharded launch, max|dd|={dd:.3g}; scan_topk launches {launches}; wall "
        f"best of 3 (host clock, synchronised, in turns): sharded "
        f"{[w for w, _ in walls['sharded']]} ms, unsharded "
        f"{[w for w, _ in walls['unsharded']]} ms; runs {walls}")

    worst = dd
    for i, (ca, ckw, cout) in enumerate(main_launches):  # each shard's launch, whole
        worst = max(worst, hold_scan_launch(
            torch, ca, ckw, cout, f"sharded scan shard {i} ({ca[0].device})"))
    qc = q_dev[:2048]
    for name, s, e in shard_scan_cases(torch, n_local, int(en.max()), qc.shape[0],
                                       q_dev.device):
        with recorded_shard_scans() as captured:
            out = call(qc, s, e)
        plain = scan_bruteforce(data, norms, qc, s, e, k + 1, metric)
        err, excused = compare_topk(out, plain, k, exact=False)
        worst = max(worst, err)
        width = (e.long() - s.long()).clamp(min=0)
        log(f"sharded scan case '{name}' [{qc.shape[0]} windows of {int(width.min())}-"
            f"{int(width.max())} rows]: merged == plain on the whole store, "
            f"max|dd|={err:.3g}, near-ties excused={excused}; "
            f"{int((out[1] == 2**31 - 1).sum())} empty slots")
        for i, (ca, ckw, cout) in enumerate(captured):
            worst = max(worst, hold_scan_launch(
                torch, ca, ckw, cout, f"sharded scan case '{name}' shard {i} "
                f"({ca[0].device})"))
    return launches, worst


def run_query_sharded_graph(torch, args, mesh, cache, data):
    """The graph path's PostfilterVamanaIndex (loaded from the run's cache)
    sharded over the mesh: recall, no beam-kernel launch, ids equal to the
    unsharded plain route on the whole batch, walls of both. Returns its
    scan kernel launches."""
    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch.ops import beam, scan
    from rangefilteredann_tpu_torch.parallel import sharded

    points, labels, queries, batches = data
    filters = batches["frac2^-2"]
    nq = len(queries)
    t0 = time.time()
    idx = P.PostfilterVamanaIndex(points, labels, tree_build_params(P, cache),
                                  require_cache=True)
    g = idx._graph
    g.nbr_vecs = g.nbr_norms = g.nbr_scale = None  # the plain route, for the reference
    torch.cuda.empty_cache()
    qparams = P.build_query_params(K, 80, final_beam_multiply=2)
    t1 = time.perf_counter()
    ref_i, _ = idx.batch_search(queries, filters, nq, qparams)
    ref_ms = (time.perf_counter() - t1) * 1e3
    idx.shard(mesh)
    log(f"query-sharded graph: PostfilterVamanaIndex loaded from the cache and sharded over "
        f"{[str(d) for d in mesh.devices]} in {time.time() - t0:.1f} s (with its unsharded "
        f"plain-route reference, {ref_ms:.3f} ms for the {nq} queries)")
    searches = []
    real = sharded.batched_beam_search

    def counting(*a, **kw):  # each shard's search: (its device, its queries)
        searches.append((str(a[4].device), a[4].shape[0]))
        return real(*a, **kw)

    sharded.batched_beam_search = counting
    scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
    t0 = time.perf_counter()
    try:
        ids, dists = idx.batch_search(queries, filters, nq, qparams)
    finally:
        b1, b2 = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
        sharded.batched_beam_search = real
    first = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 1)
    sample = rng.choice(nq, size=min(SAMPLE, nq), replace=False)
    rec, overlap, _ = check_results(Oracle(points, labels), queries, filters, ids, dists, K,
                                    sample, hi_side="right")
    same = bool(np.array_equal(ids, ref_i))
    best, runs = best_wall(torch, lambda: idx.batch_search(queries, filters, nq, qparams), 2)
    per_dev = {}
    for dev, n in searches:
        per_dev[dev] = per_dev.get(dev, 0) + n
    log(f"query-sharded graph frac2^-2 beam 80 x2 [{nq} queries]: recall@{K} {rec} on "
        f"{len(sample)} queries (id-set overlap {overlap}); ids equal to the unsharded "
        f"plain route ({ref_ms:.3f} ms, one call) on all {nq} queries: {same}; beam_search launches {b2}, scan_topk "
        f"launches {b1}; {len(searches)} per-shard searches, queries searched per device "
        f"{per_dev}; wall best of 2 {best:.3f} ms, QPS {nq / best * 1e3:.1f}, runs {runs} "
        f"(first call {first * 1e3:.3f} ms)")
    if rec < 0.99 or not same or b2 != 0:
        raise AssertionError(f"query-sharded graph: recall@{K} {rec}, ids equal {same}, "
                             f"beam_search launches {b2}")
    return b1


def sharded_tree_breakdown(torch, tree, queries, filters, qparams, method, nq):
    """Host clock around the scale-out stages of one sharded tree
    batch_search: the queries' placement on the shards, the per-shard
    searches (bucket-sharded rows, and the query-sharded row 0), the window
    filter of the doubling and its exact tail, each between two
    synchronises; "other" holds the rest. Returns (total ms, {stage: ms})."""
    from rangefilteredann_tpu_torch.models import postfilter_vamana as pv
    from rangefilteredann_tpu_torch.parallel import sharded

    spans = {}
    marked = functools.partial(span_timer, torch, spans)
    names = {(sharded, "_placement"): "placement",
             (sharded, "batched_beam_search"): "per-shard searches",
             (pv, "window_filter_topk"): "window filter",
             (pv, "batched_range_bruteforce"): "exact tail"}
    real = {key: getattr(*key) for key in names}
    for (mod, attr), name in names.items():
        setattr(mod, attr, marked(real[(mod, attr)], name))
    try:
        total, _ = best_wall(torch, lambda: tree.batch_search(queries, filters, nq, method,
                                                              qparams), 1)
    finally:
        for (mod, attr), fn in real.items():
            setattr(mod, attr, fn)
    spans["other"] = total - sum(spans.values())
    return total, spans


def run_bucket_sharded_tree(torch, args, mesh, cache, data):
    """The tree path's Vamana-leaf B-WST loaded from the run's row caches,
    each method's plain route on the whole batch unsharded (no inline
    blocks, timed), then sharded with shard_rows=True: recall, ids equal to that
    reference, wall and a host breakdown. Returns its scan kernel launches."""
    import rangefilteredann_tpu_torch as P
    from rangefilteredann_tpu_torch.models import base
    from rangefilteredann_tpu_torch.ops import beam, scan

    points, labels, queries, batches = data
    filters = batches["frac2^-2"]
    nq = len(queries)
    t0 = time.time()
    tree = P.RangeFilterTreeIndex(points, labels, cutoff=TREE_CUTOFF, split_factor=TREE_SPLIT,
                                  build_params=tree_build_params(P, cache), require_cache=True)
    loaded = time.time() - t0
    qps = {m: P.build_query_params(K, TREE_BEAM, final_beam_multiply=TREE_FM)
           for m in SHARD_TREE_METHODS}
    saved, base.TREE_INLINE_BUDGET = base.TREE_INLINE_BUDGET, 0  # the plain route
    try:
        refs = {}
        for m in SHARD_TREE_METHODS:
            t0 = time.perf_counter()
            ref_i = tree.batch_search(queries, filters, nq, m, qps[m])[0]
            refs[m] = ref_i, (time.perf_counter() - t0) * 1e3
    finally:
        base.TREE_INLINE_BUDGET = saved
    t0 = time.time()
    tree.shard(mesh, shard_rows=True)
    torch.cuda.synchronize()
    log(f"bucket-sharded tree: loaded from the row caches in {loaded:.1f} s; sharded over "
        f"{[str(d) for d in mesh.devices]} in {time.time() - t0:.1f} s; rows sharded "
        f"{sorted(tree._sharded)}, replicated {[r for r in range(len(tree._graphs)) if r not in tree._sharded]}; " + "; ".join(
            f"row {r}: {len(row.bucket_device)} buckets, ms {row.ms}, real rows a shard "
            f"{(row.local_to_global >= 0).sum(axis=1).tolist()}"
            for r, row in sorted(tree._sharded.items())))
    if sorted(tree._sharded) != list(range(1, len(tree._graphs))):
        raise AssertionError(f"rows sharded {sorted(tree._sharded)}")
    rng = np.random.default_rng(args.seed + 1)
    sample = rng.choice(nq, size=min(SAMPLE, nq), replace=False)
    oracle = Oracle(points, labels)
    b1_all = 0
    for m in SHARD_TREE_METHODS:
        torch.cuda.synchronize()
        scan.SCAN_LAUNCHES = beam.BEAM_LAUNCHES = 0  # every kernel's count, just before
        t0 = time.perf_counter()
        try:
            ids, dists = tree.batch_search(queries, filters, nq, m, qps[m])
        finally:
            b1, b2 = scan.SCAN_LAUNCHES, beam.BEAM_LAUNCHES  # just after
        wall = (time.perf_counter() - t0) * 1e3  # the results are on the host
        b1_all += b1
        rec, overlap, _ = check_results(oracle, queries, filters, ids, dists, K, sample,
                                        pad_id=0)
        same = bool(np.array_equal(ids, refs[m][0]))
        total, spans = sharded_tree_breakdown(torch, tree, queries, filters, qps[m], m, nq)
        log(f"bucket-sharded tree {m} frac2^-2 beam {TREE_BEAM} x{TREE_FM} [{nq} queries]: "
            f"recall@{K} {rec} on {len(sample)} queries (id-set overlap {overlap}); ids equal "
            f"to the unsharded plain route ({refs[m][1]:.3f} ms, one call) on all {nq} "
            f"queries: {same}; wall "
            f"{wall:.3f} ms (one call), QPS {nq / wall * 1e3:.1f}; beam_search launches "
            f"{b2}, scan_topk launches {b1}")
        log(f"bucket-sharded tree {m} host breakdown: total {total:.3f} ms; " + "; ".join(
            f"{k} {ms:.3f} ms" for k, ms in spans.items()))
        if rec < 0.99 or not same or b2 != 0:
            raise AssertionError(f"bucket-sharded tree {m}: recall@{K} {rec}, ids equal "
                                 f"{same}, beam_search launches {b2}")
    return b1_all


def run_sharded_path(torch, args, batch_inputs, cache, data):
    """Phase 10: the scale-out over a mesh of SHARDS shards (cuda:0..3 when
    there are four cards, else logical shards on one). Returns (scan kernel
    launches of the phase's calls, the largest |dd| of its held launches)."""
    from rangefilteredann_tpu_torch.parallel import sharded
    from rangefilteredann_tpu_torch.parallel.dryrun import dryrun_multidevice

    devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(SHARDS)]
    mesh = sharded.make_mesh(devices=devices)
    log(f"scale-out: mesh of {mesh.size} shards on {[str(d) for d in mesh.devices]} "
        f"({len(mesh.distinct)} distinct device(s): "
        f"{[torch.cuda.get_device_name(d) for d in mesh.distinct]})")
    t0 = time.time()
    b1, err = run_sharded_scan(torch, mesh, batch_inputs)
    log(f"sharded scan phase in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    b1 += run_query_sharded_graph(torch, args, mesh, cache, data)
    log(f"query-sharded graph phase in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    b1 += run_bucket_sharded_tree(torch, args, mesh, cache, data)
    log(f"bucket-sharded tree phase in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    dryrun_multidevice(SHARDS, devices=devices)
    log(f"dryrun_multidevice({SHARDS}, devices={devices}): passed in "
        f"{time.time() - t0:.1f} s")
    return b1, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=10_240)
    ap.add_argument("--graph-n", type=int, default=200_000)
    ap.add_argument("--graph-nq", type=int, default=10_240)
    ap.add_argument("--variant-n", type=int, default=200_000)
    ap.add_argument("--variant-nq", type=int, default=2048)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    from rangefilteredann_tpu_torch import kernels

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # 2. build every kernel, one nvcc each, all at once
    t0 = time.time()
    out = kernels.build(kernels.SOURCES, verbose=True)
    log(f"build: {', '.join(kernels.SOURCES)} in {time.time() - t0:.2f} s")
    for name, text in out.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                log(f"  {name}: {line.strip()}")

    # 3. each kernel against its plain version
    t0 = time.time()
    scan_worst = run_kernel_cases(torch)
    log(f"scan kernel cases: all passed in {time.time() - t0:.1f} s, "
        f"max|dd|={scan_worst:.3g}")
    t0 = time.time()
    beam_worst = run_beam_cases(torch)
    log(f"beam kernel cases: all passed in {time.time() - t0:.1f} s, "
        f"max|dd|={beam_worst:.3g}")
    t0 = time.time()
    variant_errs = run_variant_cases(torch)
    run_bf16_cases(torch)
    variant_errs["probe"] = run_probe_case(torch)
    log(f"scan variant cases: all passed in {time.time() - t0:.1f} s, "
        f"max|dd| {variant_errs}")

    # 4-5. the main paths
    prefilter_data, batch_inputs, scan_entry = run_prefilter_path(torch, args, scan_worst)
    run_variants_on_batch(torch, batch_inputs, scan_entry["ms"], variant_errs)
    entries = [scan_entry]
    torch.cuda.empty_cache()
    # the graph path's cache directory lasts to the scale-out phase, which
    # loads its graph and the tree's rows from it
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graphs_") as cache:
        graph_data, flat_nbrs, beam_entry = run_graph_path(torch, args, beam_worst, cache)
        entries.append(beam_entry)
        torch.cuda.empty_cache()
        # 6. the trees
        run_tree_path(torch, args, cache, graph_data, flat_nbrs)
        torch.cuda.empty_cache()
        beam_entry["launches"] += run_super_tree_path(torch, args, cache, graph_data,
                                                      flat_nbrs)
        torch.cuda.empty_cache()
        # 7. the file-based surface
        run_vamana_index_path(torch, args, cache, graph_data, flat_nbrs)
        torch.cuda.empty_cache()
        tree_err = run_prefilter_tree_path(torch, args, prefilter_data)
        scan_entry["max_abs_err"] = max(scan_entry["max_abs_err"], tree_err)
        torch.cuda.empty_cache()
        # 8. the scan-variant harness
        entries += run_variant_path(torch, args, variant_errs)
        torch.cuda.empty_cache()
        # 9. the experiment layer
        exp_b1, exp_b2, exp_err = run_experiments_path(torch, args)
        scan_entry["launches"] += exp_b1
        beam_entry["launches"] += exp_b2
        scan_entry["max_abs_err"] = max(scan_entry["max_abs_err"], exp_err)
        del flat_nbrs, prefilter_data
        torch.cuda.empty_cache()
        # 10. the scale-out
        shard_b1, shard_err = run_sharded_path(torch, args, batch_inputs, cache, graph_data)
        scan_entry["launches"] += shard_b1
        scan_entry["max_abs_err"] = max(scan_entry["max_abs_err"], shard_err)
    del batch_inputs, graph_data

    # 11. inventory
    print(json.dumps({"kernels": entries}), flush=True)
    # 12. the card, then the result
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
