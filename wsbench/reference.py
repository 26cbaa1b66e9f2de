"""The plain reference, and the comparison that decides `correct`.

`Reference` answers k-nearest-neighbour queries inside label windows exactly:
its own stable label sort, its own window bounds (half-open [lo, hi) or
closed [lo, hi], as the configuration states), and the configuration's
distance (squared L2, or the negated inner product of MIPS) of every
in-window point in float64, blocked so that it fits beside nothing else on
the card. It imports nothing of the program and takes nothing the
program made. `control` is the same computation in the precision below the
configuration's (float32 with its products in TF32), put in the program's
place to show that the comparison fails it.

`judge` holds one batch's answers against the reference. A returned slot is
a valid answer when its id is a real point inside the query's window and not
repeated; it is a hit when its true distance is within TIE_EPS of the true
k-th (the ann-benchmarks convention: float32 distances of ~1e2 carry ~1e-4 of
rounding, so two points that close may rank either way in any float32
implementation).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TIE_EPS = 1e-3
FLT_MAX = float(np.finfo(np.float32).max)
PAD_ID = 0xFFFFFFFF  # uint32 -1, the pre- and postfilter's empty slot
BLOCK_BYTES = 1 << 30  # distance rows of one query block, at most
MAX_BLOCK = 1024  # queries a block
# The configuration's metric, by any name the port takes, to the distance
# the program returns: squared L2, or "ip", the negated inner product
# (angular data is normalized by its generator and searched as MIPS).
METRICS = {"euclidian": "l2", "euclidean": "l2", "l2": "l2",
           "mips": "ip", "ip": "ip", "angular": "ip"}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit mantissa bits (to
    nearest), as the tensor cores round their fp32 operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    """Exact window top-k over one point set, on `device`."""

    def __init__(self, points: np.ndarray, labels: np.ndarray, window: str,
                 metric: str, device="cuda"):
        if metric.lower() not in METRICS:
            raise ValueError(f"unknown metric {metric!r}; expected one of {sorted(METRICS)}")
        self.l2 = METRICS[metric.lower()] == "l2"
        self.closed = {"half_open": False, "closed": True}[window]
        self.order = np.argsort(labels, kind="stable")
        self.labels = np.asarray(labels)[self.order]
        self.pos = np.empty_like(self.order)
        self.pos[self.order] = np.arange(len(self.order))
        self.n = len(self.order)
        self.device = torch.device(device)
        self.x = torch.from_numpy(points[self.order]).to(self.device, torch.float64)
        self.xn = self._norms(self.x)

    def _norms(self, x: torch.Tensor) -> torch.Tensor:
        """Squared norms under L2; zeros under MIPS, whose distance has no
        norm terms."""
        return (x * x).sum(1) if self.l2 else torch.zeros(len(x), dtype=x.dtype,
                                                            device=x.device)

    def windows(self, filters: np.ndarray):
        """[start, end) of each filter's points in label order."""
        s = np.searchsorted(self.labels, filters[:, 0], side="left")
        e = np.searchsorted(self.labels, filters[:, 1],
                            side="right" if self.closed else "left")
        return s, np.maximum(e, s)

    def topk(self, queries: np.ndarray, filters: np.ndarray, k: int):
        """(label-order positions [Q, k], -1 empty; float64 distances
        [Q, k], +inf empty)."""
        q = torch.from_numpy(queries).to(self.device, torch.float64)
        return self._blocked(q, self._norms(q), self.x, self.xn, *self.windows(filters), k)

    def control(self, queries: np.ndarray, filters: np.ndarray, k: int):
        """The control in the program's output form (uint32 original ids,
        PAD_ID empty; float32 distances, FLT_MAX empty): this reference in
        float32 with the distance products' operands rounded to TF32."""
        q32 = torch.from_numpy(queries).to(self.device, torch.float32)
        x32 = self.x.to(torch.float32)
        xn32 = self._norms(x32)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False  # the rounding is ours
        try:
            p, d = self._blocked(tf32_round(q32), self._norms(q32),
                                 tf32_round(x32), xn32, *self.windows(filters), k)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        p, d = p.cpu().numpy(), d.cpu().numpy()
        ids = np.where(p >= 0, self.order[np.maximum(p, 0)], PAD_ID).astype(np.uint32)
        return ids, np.where(p >= 0, d, FLT_MAX).astype(np.float32)

    def _blocked(self, q, qn, x, xn, s, e, k):
        """Blocks of queries with nearby window starts, each against the
        union of its windows: ||q||^2 + ||x||^2 - 2 q.x under L2, -q.x
        under MIPS, masked to each query's window, then the k smallest."""
        nq = q.shape[0]
        out_d = torch.full((nq, k), float("inf"), dtype=x.dtype, device=x.device)
        out_p = torch.full((nq, k), -1, dtype=torch.int64, device=x.device)
        order = np.argsort(s, kind="stable")
        i = 0
        while i < nq:
            b = min(MAX_BLOCK, nq - i)
            while True:
                blk = order[i:i + b]
                lo, hi = int(s[blk].min()), int(e[blk].max())
                if b == 1 or b * max(hi - lo, 1) * x.element_size() * 3 <= BLOCK_BYTES:
                    break
                b //= 2
            i += b
            if hi <= lo:
                continue
            rows = torch.from_numpy(blk).to(x.device)
            dist = torch.addmm(xn[lo:hi][None, :] + qn[rows][:, None],
                               q[rows], x[lo:hi].T, alpha=-2.0 if self.l2 else -1.0)
            cols = torch.arange(lo, hi, device=x.device)
            sb = torch.from_numpy(s[blk]).to(x.device)
            eb = torch.from_numpy(e[blk]).to(x.device)
            dist.masked_fill_((cols[None, :] < sb[:, None]) | (cols[None, :] >= eb[:, None]),
                              float("inf"))
            vals, idx = torch.topk(dist, min(k, hi - lo), dim=1, largest=False)
            kk = vals.shape[1]
            out_d[rows, :kk] = vals
            out_p[rows, :kk] = torch.where(torch.isinf(vals), -1, idx + lo)
        return out_p, out_d

    def true_distances(self, queries: np.ndarray, ids: np.ndarray,
                       valid: np.ndarray) -> np.ndarray:
        """float64 distance of each valid original id to its query, NaN
        elsewhere."""
        p = torch.from_numpy(self.pos[np.where(valid, ids, 0)]).to(self.device)
        q = torch.from_numpy(queries).to(self.device, torch.float64)[:, None, :]
        d = ((self.x[p] - q) ** 2).sum(-1) if self.l2 else -(self.x[p] * q).sum(-1)
        d = d.cpu().numpy()
        return np.where(valid, d, np.nan)


@dataclasses.dataclass
class Verdict:
    """One batch's answers held against the reference."""

    invalid: np.ndarray  # [Q] slots that break the answer's form
    misses: np.ndarray  # [Q] expected answers not among the hits
    recall: np.ndarray  # [Q] hits / expected answers (1 for an empty window)
    dist_err: float  # largest |returned - true| distance of a valid slot


def judge(ref: Reference, queries: np.ndarray, filters: np.ndarray,
          ids: np.ndarray, dists: np.ndarray, k: int, truth=None) -> Verdict:
    """Hold one batch's (ids, dists), as the program returns them, against
    the reference. `truth` is ref.topk(queries, filters, k), if at hand.

    A query's expected answers are m = min(k, window size). Its slots must
    hold its answers first, sorted by distance, and (PAD_ID, FLT_MAX) after
    them; an answer is valid inside the window, as a real point, once."""
    nq = len(queries)
    if ids.shape != (nq, k) or dists.shape != (nq, k):
        raise ValueError(f"answers of shape {ids.shape}, {dists.shape}, not {(nq, k)}")
    _, tdist = ref.topk(queries, filters, k) if truth is None else truth
    tdist = tdist.cpu().numpy()
    s, e = ref.windows(filters)
    m = np.minimum(k, e - s)
    kth = np.where(m > 0, tdist[np.arange(nq), np.maximum(m - 1, 0)], np.inf)

    ids = ids.astype(np.int64)
    real = ids != PAD_ID
    nreal = real.sum(1)
    form_bad = ((real != (np.arange(k)[None, :] < nreal[:, None])).any(1)
                | ((~real) & (dists != np.float32(FLT_MAX))).any(1))
    inside = real & (ids >= 0) & (ids < ref.n)
    p = ref.pos[np.where(inside, ids, 0)]
    inside &= (p >= s[:, None]) & (p < e[:, None])
    earlier = np.tril(np.ones((k, k), dtype=bool), -1)
    repeat = real & ((ids[:, :, None] == ids[:, None, :]) & earlier[None]).any(2)
    valid = inside & ~repeat
    with np.errstate(invalid="ignore"):
        unsorted = (real[:, 1:] & (np.diff(dists, axis=1) < 0)).any(1)
    invalid = ((real & ~valid).sum(1) + np.maximum(nreal - m, 0)
               + form_bad + unsorted).astype(np.int64)
    true = ref.true_distances(queries, ids, valid)
    hits = (valid & (true <= kth[:, None] + TIE_EPS)).sum(1)
    misses = np.maximum(m - hits, 0)
    recall = np.where(m > 0, np.minimum(hits, m) / np.maximum(m, 1), 1.0)
    err = np.abs(dists.astype(np.float64) - true)[valid]
    return Verdict(invalid=invalid, misses=misses, recall=recall,
                   dist_err=float(err.max()) if err.size else 0.0)
