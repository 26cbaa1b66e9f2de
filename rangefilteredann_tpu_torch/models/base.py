"""Host-side machinery for the index classes.

Counterpart of rangefilteredann_tpu/models/base.py:169-392, :395-481,
:484-537 and :540: the prefilter routing below, the inline-block budgets of
the graph indices (maybe_attach_inline) and the trees' rows
(plan_row_inline), the trees' row residency (RowResidency) and the
graph-cache helpers. The host
groups a batch's queries by window width: windows up to window_gather_max()
gather their own rows (windowed_bruteforce, grouped in power-of-two classes
and chunked by GATHER_BYTES_BUDGET); wider windows are midpoint-sorted and go
to the range-masked scan, which is the hand-written kernel when the store
lies on the card and its plain version when it lies on the CPU. The routing
(launch_range_bruteforce) reads the widths on the host and takes the query
rows and window bounds either as host arrays, which it slices and uploads a
route at a time, or as tensors already on the device, which it indexes
there.

The JAX package's query cache (_QCACHE, qcache_fill), its packed result fetch
(_pack_di) and its SCAN_CHUNK split exist to work around a remote TPU link
and change no result; they are not ported.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import Tuple

import numpy as np
import torch

from ..ops.bruteforce import windowed_bruteforce
from ..ops.scan import CHUNK, scan_topk
from ..ops.topk import EMPTY_ID
from ..utils.data import METRIC_L2
from ..utils.trace import span

# Windows up to this width use the per-query gather; wider ones the scan.
# The JAX package's non-TPU value, kept until a measurement on the card sets
# its own. Both routes are exact, so results do not depend on it.
WINDOW_GATHER_MAX = 4096


def window_gather_max() -> int:
    return WINDOW_GATHER_MAX


MIN_CLASS = 64  # smallest padded window class
# Cap on gathered bytes per windowed_bruteforce launch (fp32), to bound memory.
GATHER_BYTES_BUDGET = 1 << 30


def next_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


# Tensors copied to and from the device by to_device / to_host since the
# counts were last set to 0.
UPLOADS = 0
FETCHES = 0


def to_device(dev, *arrays: np.ndarray) -> "list[torch.Tensor]":
    """Copy host arrays to `dev`, in order: every upload of the batch
    paths."""
    global UPLOADS
    with span("base.upload"):
        UPLOADS += len(arrays)
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def to_host(*tensors: torch.Tensor) -> "list[np.ndarray]":
    """Copy tensors to host arrays, in order: every fetch of the batch
    paths (each waits for the work that makes its tensor)."""
    global FETCHES
    with span("base.fetch"):
        FETCHES += len(tensors)
        return [t.cpu().numpy() for t in tensors]


def pad_batch(q: int) -> int:
    """Padded batch size for a q-query launch: pow2 up to 2048, then
    2048-multiples (the JAX package's shape classes)."""
    return next_pow2(max(q, 64)) if q <= 2048 else -(-q // 2048) * 2048


def pow2_classes(widths: np.ndarray, lo: int = MIN_CLASS, hi: int | None = None):
    """Assign each width to the smallest power-of-two class >= width (>= lo)."""
    cls = np.maximum(lo, 1 << np.ceil(np.log2(np.maximum(widths, 1))).astype(np.int64))
    if hi is not None:
        cls = np.minimum(cls, hi)
    return cls


def _row_taker(dev, queries, starts, ends, q_rows):
    """take(sel, width) -> the query rows (cut or zero-padded to `width`
    columns), starts and ends of tasks `sel`, on `dev`. Host arrays (row
    `q_rows[t]` for task t, where given) are sliced on the host and
    uploaded; device tensors are indexed and padded on the device, by an
    uploaded index where `sel` is not every task."""
    if not isinstance(queries, torch.Tensor):
        def take(sel, width):
            rows = sel if q_rows is None else q_rows[sel]
            return to_device(dev, queries[rows, :width], starts[sel].astype(np.int32),
                             ends[sel].astype(np.int32))
        return take

    def take(sel, width):
        if len(sel) == len(starts):
            q, s, e = queries, starts, ends
        else:
            (i,) = to_device(dev, sel)
            q, s, e = queries[i], starts[i], ends[i]
        if q.shape[1] < width:
            q = torch.nn.functional.pad(q, (0, width - q.shape[1]))
        return q[:, :width], s, e
    return take


def launch_range_bruteforce(
    data: torch.Tensor,  # [n, d_pad] store
    norms_sq: torch.Tensor,  # [n]
    queries,  # [Q, d_pad] f32 host, or [Q, w] f32 on data's device (zero past d)
    starts,  # [Q] int64 host, or int32 on data's device
    ends,  # [Q] like starts
    k: int,
    metric: str,
    norm_col=None,  # fused norm column (PointSet.norm_col), if `data` has one
    q_rows: np.ndarray | None = None,  # [Q] task -> row of host queries
    widths: np.ndarray | None = None,  # [Q] host ends - starts, given device bounds
):
    """Launch phase of batched_range_bruteforce: enqueues every kernel on the
    device's stream (returning before they finish) and returns a launch
    record for finish_range_bruteforce. The host widths route each window;
    each route takes its rows and bounds as _row_taker gives them, from
    host arrays or from tensors already on the device."""
    if norm_col is not None and norm_col < 0:
        norm_col = None  # integer stores carry no fused-norm column
    dev = data.device
    take = _row_taker(dev, queries, starts, ends, q_rows)
    widths = np.maximum(ends - starts if widths is None else widths, 0)
    nq = len(widths)
    d_pad = data.shape[1]
    out_d = np.full((nq, k), np.inf, dtype=np.float32)
    out_i = np.full((nq, k), EMPTY_ID, dtype=np.int64)
    results = []  # (query indices, dists, ids) still on the device
    small = widths <= window_gather_max()
    # --- small windows: per-query gather, grouped by pow2 window class ---
    if small.any():
        idx_small = np.nonzero(small)[0]
        classes = pow2_classes(widths[idx_small])
        for w in np.unique(classes):
            sel = idx_small[classes == w]
            # Respect the gather budget by chunking the query batch.
            max_q = max(64, int(GATHER_BYTES_BUDGET // (int(w) * d_pad * 4)))
            max_q = next_pow2(max_q) // 2 if next_pow2(max_q) > max_q else max_q
            for lo in range(0, len(sel), max_q):
                chunk = sel[lo : lo + max_q]
                q_dev, s_dev, e_dev = take(chunk, d_pad)
                with span("gather.kernel"):
                    d, i = windowed_bruteforce(
                        data, norms_sq, q_dev, s_dev, e_dev,
                        window=int(w), k=k, metric=metric, norm_col=norm_col,
                    )
                results.append((chunk, d, i))
    # --- large windows: the range-masked scan ---
    if (~small).any():
        # (the kernel's wrapper midpoint-sorts these queries into blocks)
        sel = np.nonzero(~small)[0]
        # stream only the columns holding real dims: the fused ||x||^2 column
        # and the padding past it are dead weight (half of d_pad at d=128)
        d_eff = d_pad if norm_col is None else norm_col
        qw = min(d_pad, -(-d_eff // CHUNK) * CHUNK)
        q_dev, s_dev, e_dev = take(sel, qw)
        d, i = scan_topk(data, norms_sq, q_dev, s_dev, e_dev,
                         k=k, metric=metric, d_eff=d_eff)
        results.append((sel, d, i))
    return results, out_d, out_i


def finish_range_bruteforce(launch) -> Tuple[np.ndarray, np.ndarray]:
    """Fetch phase: copy every launched result to the host and scatter it."""
    return finish_many_range_bruteforce([launch])[0]


def finish_many_range_bruteforce(launches) -> "list[Tuple[np.ndarray, np.ndarray]]":
    """Fetch many launch records (results come back in launch order) and
    scatter each into its output arrays."""
    out = []
    for results, out_d, out_i in launches:
        for chunk, d, i in results:
            out_d[chunk], out_i[chunk] = to_host(d, i)
        out.append((out_d, out_i))
    return out


def batched_range_bruteforce(
    data, norms_sq, queries_padded, starts, ends, k, metric,
    norm_col=None, q_rows=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN within per-query sorted-index windows (launch + fetch).

    Returns (dists [Q, k] f32 shifted-L2, ids [Q, k] int64 sorted-order ids).
    Empty slots: id EMPTY_ID, dist +inf.
    """
    return finish_range_bruteforce(launch_range_bruteforce(
        data, norms_sq, queries_padded, starts, ends, k, metric,
        norm_col=norm_col, q_rows=q_rows))


# Device bytes allowed for a graph's inline neighbour blocks. The JAX
# package's value, kept so that a given store picks the same inline dtype in
# both packages (the 200k x 128 fp32 blocks take 4.9 GB). An H100 has 80 GB;
# raising the budget there is a decision for later (ROADMAP).
INLINE_BUDGET = int(7e9)


def maybe_attach_inline(graph, ps) -> bool:
    """Attach inline neighbour blocks to a graph on the card when they fit
    INLINE_BUDGET: exact fp32 first, then bf16 (storage rounding, ~1e-3
    relative on distances), then int8-quantized over a float store (final
    candidates exact-reranked). Byte stores attach blocks of their own dtype
    (exact). Does nothing for a store on the CPU, as the JAX package does
    nothing there: the CPU tests attach inline blocks themselves."""
    if ps.device.type == "cpu":
        return False
    if ps.data.dtype in (torch.int8, torch.uint8):
        if graph.inline_bytes(ps, ps.data.dtype) <= INLINE_BUDGET:
            graph.attach_inline(ps, ps.data.dtype)
            return True
        return False
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        if graph.inline_bytes(ps, dtype) <= INLINE_BUDGET:
            if dtype != torch.float32:
                warnings.warn(
                    f"inline neighbour blocks attached as {dtype} (the wider "
                    f"form exceeds INLINE_BUDGET={INLINE_BUDGET}); frontier "
                    "distances are approximate — check graph.inline_dtype",
                    stacklevel=2)
            graph.attach_inline(ps, dtype)
            return True
    return False


# Device bytes a tree gives the int8 inline blocks of the rows a batch
# touches most (the JAX package's RFANN_TREE_INLINE_BUDGET default). A
# 200k x 48 row's int8 blocks take 1.27 GB, so two rows fit; raising it for
# the card's 80 GB is a decision for later (ROADMAP).
TREE_INLINE_BUDGET = int(3.5e9)


def plan_row_inline(ps, graphs, attached: set, rows: np.ndarray,
                    counts: np.ndarray) -> None:
    """Attach int8 inline neighbour blocks (int8-quantized with a scale over
    a float store, exact over a byte store) to the tree rows that `counts`
    says a batch touches most, within TREE_INLINE_BUDGET bytes, and drop
    those of attached rows outside that pick. Rows that do not fit run the
    search without blocks. A repeated workload picks the same rows and
    attaches once. Does nothing for a store on the CPU, as the JAX package
    does nothing there: the CPU tests attach blocks themselves."""
    if ps.device.type == "cpu":
        return
    dtype = ps.data.dtype if ps.data.dtype in (torch.int8, torch.uint8) else torch.int8
    order = np.asarray(rows)[np.argsort(-np.asarray(counts))]
    picked, used = [], 0
    for r in order:
        r = int(r)
        b = graphs[r].inline_bytes(ps, dtype)
        if used + b <= TREE_INLINE_BUDGET:
            picked.append(r)
            used += b
    for r in list(attached):
        if r not in picked:
            g = graphs[r]
            g.nbr_vecs = g.nbr_norms = g.nbr_scale = None
            attached.discard(r)
    for r in picked:
        g = graphs[r]
        if g.nbr_vecs is None and g.nbrs_dev is not None:
            g.attach_inline(ps, dtype)
            attached.add(r)
        elif g.nbr_vecs is not None:
            attached.add(r)


class RowResidency:
    """LRU device residency of a tree's SlabGraph rows under a byte budget.

    A tree whose rows together exceed the card's memory keeps them on the
    host and uploads a row when a batch routes to it; queries at one filter
    fraction touch few rows. budget=None (the default) keeps every row
    resident."""

    def __init__(self, graphs, budget, device):
        self.graphs = graphs
        self.budget = budget
        self.device = device
        self.order = []
        if budget is not None:
            for g in graphs:
                if g is not None:
                    g.evict_device()

    def touch(self, r: int):
        g = self.graphs[r]
        if self.budget is None:
            return g
        g.ensure_device(self.device)
        if r in self.order:
            self.order.remove(r)
        self.order.insert(0, r)
        total = sum(self.graphs[i].device_bytes() for i in self.order)
        while total > self.budget and len(self.order) > 1:
            ev = self.order.pop()
            total -= self.graphs[ev].device_bytes()
            self.graphs[ev].evict_device()
        return g


def cache_fingerprint(labels_sorted: np.ndarray,
                      pts_sorted: np.ndarray) -> np.ndarray:
    """Content digest stored in graph cache files beside the adjacency: a
    sha1 of sampled label-sorted labels and points, so that a cache built
    for other data is rebuilt, not loaded. Identical to the JAX package's,
    so each package loads the other's caches."""
    h = hashlib.sha1()
    step = max(1, len(labels_sorted) // 1024)
    h.update(np.ascontiguousarray(
        labels_sorted[::step].astype(np.float64)).tobytes())
    pstep = max(1, len(pts_sorted) // 256)
    h.update(np.ascontiguousarray(
        np.asarray(pts_sorted[::pstep, : min(8, pts_sorted.shape[1])],
                   dtype=np.float32)).tobytes())
    return np.frombuffer(h.digest()[:8], dtype=np.int64).copy()


def load_cached_nbrs(fname: str, fingerprint: np.ndarray):
    """The cached adjacency of `fname`, or None (with a warning) when its
    digest says it was built for other data. Caches without a digest load."""
    with np.load(fname) as z:
        nbrs = z["nbrs"]
        if "fingerprint" in z and not np.array_equal(z["fingerprint"], fingerprint):
            warnings.warn(
                f"graph cache {fname} was built for different data "
                "(fingerprint mismatch) — rebuilding", stacklevel=2)
            return None
    return nbrs


def save_cached_nbrs(fname: str, nbrs: np.ndarray, fingerprint: np.ndarray) -> None:
    """Write a graph cache: the adjacency and the digest of its data. The
    archive is stored, not deflated: a 400,000 x 48 row takes ~11 s to
    deflate (to 57 MB) and ~0.15 s to store (77 MB). np.load reads either
    form, so both packages load the caches of both."""
    np.savez(fname, nbrs=nbrs, fingerprint=fingerprint)


def whole_dataset_cache(cache_path, bp, label_lo, label_hi, n):
    """The cache file of the single Vamana graph over the whole label-sorted
    dataset, the JAX package's (and the reference's, ref:
    src/postfilter_vamana.h:126-132) name: vamana_{L}_{R}_{alpha}_{lo}_{hi}_{n}.npz."""
    if not cache_path:
        return None
    return os.path.join(
        cache_path,
        f"vamana_{bp.L}_{bp.R}_{bp.alpha:.6f}_{label_lo:.6f}_{label_hi:.6f}_"
        f"{n}.npz",
    )


def finalize_output(
    dists: np.ndarray,  # [Q, k] shifted-L2 / mips dists, +inf = empty
    ids_sorted: np.ndarray,  # [Q, k] sorted-order ids, EMPTY_ID = empty
    decoding: np.ndarray | None,  # sorted id -> original id (None = identity)
    q_norms: np.ndarray,  # [Q] squared query norms (for L2 un-shifting)
    metric: str,
    pad_id: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode sorted ids to original ids and restore true distances.

    Empty slots become (pad_id, FLT_MAX) matching the reference's padding
    (ref: src/range_filter_tree.h:84-93 pads id=0; postfilter_vamana.h:207-215
    pads id=-1 as unsigned).
    """
    empty = ~np.isfinite(dists)
    safe = np.where(ids_sorted == EMPTY_ID, 0, ids_sorted)
    orig = decoding[safe] if decoding is not None else safe
    out_ids = np.where(empty, np.int64(pad_id) & 0xFFFFFFFF, orig).astype(np.uint32)
    out_d = dists.astype(np.float32)
    if metric == METRIC_L2:
        out_d = out_d + q_norms[:, None].astype(np.float32)
    out_d = np.where(empty, np.finfo(np.float32).max, out_d).astype(np.float32)
    return out_ids, out_d
