"""Scan-variant experiment harness of the PyTorch port.

Counterpart of the JAX package's `tools/exp_scan2.py`, `exp_scan3.py` and
`exp_scan3b.py`: three designs of the range-masked top-k scan, each a
hand-written CUDA kernel (`csrc/scan_v2.cu`, `scan_v3.cu`, `scan_v3b.cu`)
with its wrapper, its plain version and a `main()` in the module of
the same name (all three on one persistent item body, whose caps and
launch path are `scan_items.py`):

    python -m rangefilteredann_tpu_torch.tools.exp_scan2 [--reps 10] [--device cpu]

This module holds what the three share beside that: the plain version,
the harness data (made exactly as the JAX tools make it), timing and the
float64 oracle check.
Each main() logs to stderr, as the JAX tools do; its "prod" baseline is the
port's production scan (`ops/scan.scan_topk`).

On the card, `tile` and `qblock` are the points a CTA stages per step and
its queries: the [qblock, tile] fp32 block of distances must fit the 227 KB
of shared memory a CTA can take, beside the running lists, so the TPU's
sweep shapes (QB 128-512, TILE 2048-8192) do not carry over.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from ..ops.bruteforce import scan_bruteforce
from ..ops.topk import EMPTY_ID
from ..utils.data import METRIC_L2, PointSet, make_pointset, pad_queries, resolve_device

D, K = 128, 10  # the harness's width and k
N_ORACLE = 256  # queries held against the float64 oracle
# (tile, qblock) shapes each main() sweeps on the card; the first on the CPU
GRIDS = ((1024, 32), (2048, 16), (1024, 8))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def window_scan_plain(data, norms_sq, queries, starts, ends, k,
                      metric=METRIC_L2, d_eff=None, bf16=False):
    """The variants' plain version: ops/bruteforce.scan_bruteforce over the
    first d_eff columns. bf16=True rounds those columns of the store and the
    queries to bf16 (products then exact in fp32) and keeps the fp32 norms
    of the unrounded store, as v2's bf16 pass does."""
    w = data.shape[1] if d_eff is None else min(int(d_eff), data.shape[1])
    q = queries[:, :w]
    if bf16:
        q = q.to(torch.bfloat16).to(torch.float32)
        data = data[:, :w].to(torch.bfloat16).to(torch.float32)
    return scan_bruteforce(data, norms_sq, q, starts, ends, k=k, metric=metric)


# ---------------------------------------------------------------- harness --

def harness_data(n, nq, *, dups=False, degenerate=False, seed=42):
    """The JAX tools' data, draw for draw: clustered points (1000 centres,
    noise 0.35) in a shuffled order, clustered queries, windows of int(n/4)
    at k=10. dups (exp_scan3 --dups): every 3rd point duplicates another and
    a quarter of the queries are store points. degenerate (exp_scan3/3b):
    the first four windows are empty or narrower than k."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(1000, D)).astype(np.float32)
    assign = rng.integers(0, 1000, size=n)
    points = (centers[assign] + 0.35 * rng.normal(size=(n, D))).astype(np.float32)
    if dups:
        src = rng.integers(0, n, size=n // 3)
        points[np.arange(0, n, 3)[: len(src)]] = points[src]
    order = np.argsort(rng.uniform(size=n), kind="stable")
    points = points[order]
    q_assign = rng.integers(0, 1000, size=nq)
    queries = (centers[q_assign] + 0.35 * rng.normal(size=(nq, D))).astype(np.float32)
    if dups:
        queries[: nq // 4] = points[rng.integers(0, n, size=nq // 4)]
    width = int(n * 0.25)
    starts = rng.integers(0, n - width, size=nq).astype(np.int32)
    ends = (starts + width).astype(np.int32)
    if degenerate:
        starts[:4] = [100, 200, 300, 400]
        ends[:4] = [100, 203, 301, 404]
    return points, queries, starts, ends


@dataclasses.dataclass
class Harness:
    """One harness run's inputs on its device, and what its runs measured."""

    points: np.ndarray
    queries: np.ndarray
    starts_np: np.ndarray
    ends_np: np.ndarray
    ps: PointSet
    qp: torch.Tensor  # [nq, d_pad] zero-padded queries
    starts: torch.Tensor
    ends: torch.Tensor
    reps: int
    runs: dict = dataclasses.field(default_factory=dict)  # name -> (out, ms)
    checks: dict = dataclasses.field(default_factory=dict)  # name -> (set, pos)

    @property
    def device(self) -> torch.device:
        return self.ps.device

    @property
    def args(self):
        """(data, norms_sq, queries, starts, ends) of every scan call."""
        return self.ps.data, self.ps.norms_sq, self.qp, self.starts, self.ends

    def timeit(self, name, fn):
        """fn's output and its mean time over `reps` calls after one warm-up:
        CUDA events on the card, the host clock on the CPU."""
        out = fn()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.reps):
                fn()
            stop.record()
            torch.cuda.synchronize(self.device)
            ms = start.elapsed_time(stop) / self.reps
        else:
            t0 = time.perf_counter()
            for _ in range(self.reps):
                fn()
            ms = (time.perf_counter() - t0) / self.reps * 1e3
        log(f"{name}: {ms:.2f} ms -> {len(self.queries) / ms * 1e3:.0f} qps")
        self.runs[name] = (out, ms)
        return out, ms

    def oracle(self, k=K, n_or=N_ORACLE):
        """Exact (dist, id) top-k ids of the first n_or queries in float64
        (matmul form), EMPTY_ID where a window holds fewer than k points."""
        n_or = min(n_or, len(self.queries))
        x64 = self.points.astype(np.float64)
        q64 = self.queries[:n_or].astype(np.float64)
        d2 = (x64 ** 2).sum(1)[None, :] - 2.0 * (q64 @ x64.T)
        for i in range(n_or):
            d2[i, : self.starts_np[i]] = np.inf
            d2[i, self.ends_np[i]:] = np.inf
        gt = np.argsort(d2, axis=1, kind="stable")[:, :k]
        gt[np.isinf(np.take_along_axis(d2, gt, axis=1))] = EMPTY_ID
        return gt

    def check(self, gt, ids, name):
        """(set-match, pos-match) of ids against the oracle's, logged."""
        got = ids[: len(gt)].cpu().numpy()
        ok = float(np.mean([set(got[i]) == set(gt[i]) for i in range(len(gt))]))
        exact = float(np.mean(got == gt))
        log(f"  {name}: set-match {ok:.4f} pos-match {exact:.4f}")
        self.checks[name] = (ok, exact)
        return ok, exact

    def vs_prod(self, prod, out, name):
        """Share of ids and distances equal to the production scan's, logged
        with the first mismatching row (exp_scan3's comparison)."""
        pd, pi = (x.cpu().numpy() for x in prod)
        vd, vi = (x.cpu().numpy() for x in out)
        same_i = float(np.mean(pi == vi))
        same_d = float(np.mean((pd == vd) | (np.isinf(pd) & np.isinf(vd))))
        log(f"  {name}: id pos-match vs prod {same_i:.6f} dist {same_d:.6f}")
        if same_i < 1.0:
            r, c = np.argwhere(pi != vi)[0]
            log(f"  first mismatch row {r} col {c}: prod {pi[r].tolist()} "
                f"variant {vi[r].tolist()}")
            log(f"    dists prod    {pd[r].tolist()}")
            log(f"    dists variant {vd[r].tolist()}")
        return same_i, same_d


def make_harness(n, nq, device, reps, **data_kw) -> Harness:
    """The harness data on `device` ("cuda" or "cpu"; the card raises
    without one), as a label-sorted store with its fused norm column."""
    dev = resolve_device(device)
    points, queries, starts, ends = harness_data(n, nq, **data_kw)
    ps = make_pointset(points, METRIC_L2, device=dev)
    qp = torch.from_numpy(pad_queries(queries, D, ps.d_pad)).to(dev)
    h = Harness(points, queries, starts, ends, ps, qp,
                torch.from_numpy(starts).to(dev), torch.from_numpy(ends).to(dev),
                reps)
    log(f"n={n} nq={nq} width={int(n * 0.25)} d_pad={ps.d_pad} "
        f"norm_col={ps.norm_col} device={dev}")
    return h


def main_args(ap, argv):
    """The flags every main() shares, added to `ap`, parsed from argv."""
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)
