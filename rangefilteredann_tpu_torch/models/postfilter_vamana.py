"""PostfilterVamanaIndex — Vamana graph search with label postfiltering.

Counterpart of rangefilteredann_tpu/models/postfilter_vamana.py (ref:
src/postfilter_vamana.h:31-255): one Vamana graph over the label-sorted
points; each query runs beam searches with beam doubling — filter the
frontier to the label window, double the beam until >= k survive or the cap
is hit — then one final search at beam * final_beam_multiply. The host
regroups unfinished queries by their next beam, so every launch is one
batch at one beam. The launch plan is built on the store's device:
doubling_postfilter takes its queries, starts and windows as tensors
there (PostfilterVamanaIndex searches the window bounds in a device copy
of the sorted labels), and each beam class gathers its rows, starts and
windows there.

On the card, every query-mode search the beam kernel covers (ops/beam.py,
kernel_covers) goes to the kernel; the rest, and the build's searches, take
ops/beam_search.batched_beam_search. After `shard(mesh)` the batches split
over the mesh's devices and every search takes the plain
batched_beam_search (parallel/sharded.py), as the JAX package's mesh path
does. Its device query cache (a remote-TPU-link workaround) is not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import pointset_from_arrays
from ..ops.beam import beam_search_inline, kernel_covers, start_distances
from ..ops.beam_search import (
    BeamResult,
    batched_beam_search,
    default_expand,
    exact_rerank,
    window_filter_topk,
)
from ..ops.topk import EMPTY_ID
from ..parallel.sharded import (
    ShardedGraphRow,
    replicate_index,
    sharded_beam_search,
    sharded_row_search,
)
from ..params import BuildParams, QueryParams
# wsbench's traced runs wrap first_geq, pad_queries (not called here),
# batched_range_bruteforce, finalize_output and the ops imported above by
# their names in this module, so each stays importable from it.
from ..utils.data import (  # noqa: F401
    device_labels,
    first_geq,
    make_pointset,
    pad_queries,
    sort_by_labels,
)
from ..utils.trace import span
from .base import (
    batched_range_bruteforce,
    cache_fingerprint,
    finalize_output,
    maybe_attach_inline,
    save_cached_nbrs,
    to_device,
    to_host,
    whole_dataset_cache,
)
from .vamana import SlabGraph, build_vamana_graph

# Largest beam a doubling search runs; the JAX package's clamp around a TPU
# fault, which defines its results and is kept here. Queries whose doubling
# exhausts it while qp.postfiltering_max_beam allows more take the exact
# scan over their label window instead (doubling_postfilter).
MAX_SAFE_BEAM = 2048

# Candidates past k that a quantized-inline search reranks exactly.
RERANK_SLACK = 8

# Doubling rounds (passes of doubling_postfilter's loop) since the count was
# last set to 0.
ROUNDS = 0


def run_beam_batch(ps, graph, qs: torch.Tensor, st: torch.Tensor,
                   beam: int, limit: int, metric: str,
                   degree_limit: int = 0, mesh=None) -> BeamResult:
    """One batched query-mode search at a fixed beam, of the queries `qs`
    [Q, d_pad] from the slab ids `st` [Q], both on the store's device: the
    beam kernel where it covers the search, batched_beam_search otherwise.
    With a mesh, the batch splits over its devices and every chunk takes
    batched_beam_search over the replicas of replicate_index. A
    bucket-sharded row (a parallel.sharded.ShardedGraphRow in place of the
    SlabGraph) searches each query on the shard owning its bucket."""
    act = torch.ones(st.shape[0], dtype=torch.bool, device=qs.device)
    beam = int(beam)
    if isinstance(graph, ShardedGraphRow):
        return sharded_row_search(
            graph, qs, st, beam=beam, limit=int(limit), metric=metric,
            degree_limit=int(degree_limit),
            norm_col=ps.norm_col if ps.norm_col >= 0 else None)
    if mesh is not None:
        return sharded_beam_search(
            mesh, *ps.replicas, *graph.replicas, qs, st, beam=beam, k=0, cut=1.35,
            limit=int(limit), metric=metric, active_in=act,
            expand=default_expand(beam), degree_limit=int(degree_limit),
            norm_col=ps.norm_col if ps.norm_col >= 0 else None,
            identity_map=graph.identity_s2g)
    if kernel_covers(graph, beam, degree_limit):
        with span("beam.start"):
            d0 = start_distances(ps, graph, qs, st, metric)
        w = graph.nbr_vecs.shape[2]
        f_ids, f_d, n_vis, cmps = beam_search_inline(
            graph.nbr_vecs, graph.nbrs_dev, graph.nbr_norms, graph.nbr_scale,
            qs[:, :w], st, d0, act, beam=beam, limit=int(limit), metric=metric)
        return BeamResult(f_ids, f_d, n_vis, cmps, f_ids[:, :0], f_d[:, :0])
    with span("beam_search.plain"):
        return batched_beam_search(
            ps.data, ps.norms_sq, graph.nbrs_dev, graph.slab_to_global_dev, qs, st,
            beam=beam, k=0, cut=1.35, limit=int(limit), metric=metric,
            active_in=act, expand=default_expand(beam),
            degree_limit=int(degree_limit),
            norm_col=ps.norm_col if ps.norm_col >= 0 else None,
            identity_map=graph.identity_s2g, nbr_vecs=graph.nbr_vecs,
            nbr_norms=graph.nbr_norms, nbr_scale=graph.nbr_scale,
        )


def closed_windows(labels_dev: torch.Tensor, n_labels: int, filters: torch.Tensor):
    """Sorted-id windows [win_lo, win_hi) of the closed label ranges
    lo <= label <= hi of `filters` [nq, 2] f64, searched on the labels'
    device (labels_dev from device_labels over `n_labels` sorted labels).
    Returns int64 tensors: win_lo the first label >= lo (first_geq),
    win_hi the first label > hi, as numpy's right-side search gives it
    over all the labels: a NaN hi ends past the NaN labels that
    device_labels leaves out."""
    lo, hi = filters.t().contiguous()
    win_hi = torch.searchsorted(labels_dev, hi, side="right")
    return first_geq(labels_dev, lo), win_hi.masked_fill_(torch.isnan(hi), n_labels)


def _dl(qp, graph) -> int:
    """Effective degree limit (0 = expand full adjacency rows)."""
    return qp.degree_limit if qp.degree_limit < graph.R else 0


class _Doubling:
    """The state of one doubling_postfilter call, and its steps.

    Holds the staged inputs on the store's device (queries [Q, d_pad] f32,
    starts, win_lo, win_hi [Q] int32), the per-task results and schedule
    on the host (res_i, res_d, done, cur_beam, capped), the stats buffer
    and the round-1 speculative finals kept for reuse. The searches,
    filters, reranks and the exact tail resolve through this module's
    globals at call time."""

    def __init__(self, ps, graph, queries, starts, win_lo, win_hi, qp, metric,
                 stats, stat_ids, mesh):
        self.ps, self.graph, self.qp, self.metric, self.mesh = ps, graph, qp, metric, mesh
        self.inputs = (queries, starts.to(torch.int32), win_lo.to(torch.int32),
                       win_hi.to(torch.int32))
        nq = self.nq = starts.shape[0]
        self.stats = stats
        self.stat_ids = stat_ids if stat_ids is not None else np.arange(nq)
        k = qp.k
        self.max_beam = min(qp.postfiltering_max_beam, MAX_SAFE_BEAM)
        self.exact_tail = qp.postfiltering_max_beam > self.max_beam
        self.capped = np.zeros(nq, dtype=bool)  # done by the cap, not by k survivors
        # do-while: at least one search always runs, at the cap if the
        # requested beam meets it (ref: postfilter_vamana.h:161-172)
        self.cur_beam = np.minimum(np.full(nq, qp.beamSize, dtype=np.int64),
                                   self.max_beam)
        self.res_i = np.full((nq, k), int(EMPTY_ID), dtype=np.int64)
        self.res_d = np.full((nq, k), np.inf, dtype=np.float32)
        self.done = np.zeros(nq, dtype=bool)
        self.norm_col = ps.norm_col if ps.norm_col >= 0 else None
        # quantized-inline frontiers carry int8-rounded distances: filter a
        # k + slack superset and rerank it exactly
        self.quant = graph.nbr_scale is not None
        self.stat_buf = []  # (ids_for, row_idx, num_visited, dist_cmps), fetched once
        self.first_round = True
        # round-1 speculative finals at twice the beam (fm == 2) are the
        # doubled search the queries that fail need next: reuse them (the
        # search is per-query deterministic, so a relaunch would be
        # bit-identical)
        self.reuse = {}  # next beam -> (sel, counts, ids, dists, res)

    def collect(self, sel, idx, res):
        """Keep the counters of rows `idx` of a search over tasks `sel`."""
        if self.stats is not None and len(idx):
            self.stat_buf.append((self.stat_ids[sel], idx, res.num_visited,
                                  res.dist_cmps))

    def gather(self, sels):
        """Each class's (queries, starts, win_lo, win_hi) on the card, for
        the classes `sels` of one pass: one uploaded index of all of them,
        sliced a class; a class of every task takes the inputs whole."""
        if not sels:
            return []
        (idx,) = to_device(self.ps.device, np.concatenate(sels))
        out, lo = [], 0
        for sel in sels:
            i = idx[lo:lo + len(sel)]
            lo += len(sel)
            out.append(self.inputs if len(sel) == self.nq
                       else tuple(x[i] for x in self.inputs))
        return out

    def search(self, sel, inputs, b, collect_stats=True):
        """Enqueue one search + window filter over a class's gathered
        inputs; returns device tensors (counts, gids, dists) and the
        BeamResult, fetching nothing."""
        qs, st, lo, hi = inputs
        qp, k = self.qp, self.qp.k
        with span("postfilter.search"):
            res = run_beam_batch(self.ps, self.graph, qs, st, b, qp.limit,
                                 self.metric, degree_limit=_dl(qp, self.graph),
                                 mesh=self.mesh)
            if collect_stats:
                self.collect(sel, np.arange(len(sel)), res)
            with span("beam_search.window_filter"):
                counts, g, d = window_filter_topk(
                    res.frontier_ids, res.frontier_dists,
                    self.graph.slab_to_global_dev, lo, hi,
                    k + RERANK_SLACK if self.quant else k)
            if self.quant:
                with span("beam_search.rerank"):
                    g, d = exact_rerank(self.ps.data, self.ps.norms_sq, qs, g, k,
                                        self.metric, norm_col=self.norm_col)
            return (counts, g, d), res

    def advance(self, sel, counts, ti, td):
        """Take a search's results; the queries with < k survivors double."""
        self.res_i[sel] = ti.astype(np.int64)
        self.res_d[sel] = td
        enough = counts >= self.qp.k
        self.done[sel[enough]] = True
        grow = sel[~enough]
        self.cur_beam[grow] *= 2
        hit_cap = self.cur_beam[grow] >= self.max_beam
        self.done[grow] |= hit_cap
        self.capped[grow[hit_cap]] = True
        return enough

    def round(self):
        """One doubling pass: the reused speculative finals first, then
        every beam class and its speculative final enqueued before the
        pass's first fetch (ref semantics: the final search always runs
        after the loop, postfilter_vamana.h:173-181)."""
        done, cur_beam = self.done, self.cur_beam
        for b, (sel_r, counts_r, ti_r, td_r, s_res) in list(self.reuse.items()):
            self.reuse.pop(b)
            live = ~done[sel_r] & (cur_beam[sel_r] == b)
            if not live.any():
                continue
            sub = np.nonzero(live)[0]
            self.advance(sel_r[sub], counts_r[sub], ti_r[sub], td_r[sub])
            self.collect(sel_r, sub, s_res)
        beams = np.unique(cur_beam[~done])
        sels = [np.nonzero(~done & (cur_beam == b))[0] for b in beams]
        launches, spec = [], {}
        for b, sel, inputs in zip(beams, sels, self.gather(sels)):
            fut, _ = self.search(sel, inputs, b)
            launches.append((sel, b, fut))
            fb = min(b * self.qp.final_beam_multiply, self.max_beam)
            if fb > b and (self.first_round or fb == 2 * b):
                spec[b] = (fb,) + self.search(sel, inputs, fb, collect_stats=False)
        for sel, b, fut in launches:
            enough = self.advance(sel, *to_host(*fut))
            if b in spec:  # speculative final for this beam class (same sel)
                fb, s_fut, s_res = spec[b]
                counts_s, ti_s, td_s = to_host(*s_fut)
                sat = np.nonzero(enough)[0]
                self.res_i[sel[sat]] = ti_s[sat].astype(np.int64)
                self.res_d[sel[sat]] = td_s[sat]
                cur_beam[sel[sat]] = -fb  # final already applied
                self.collect(sel, sat, s_res)
                if fb == 2 * b and not enough.all():
                    self.reuse[fb] = (sel, counts_s, ti_s, td_s, s_res)
        self.first_round = False

    def exact_scan_tail(self):
        """Queries that exhausted the cap while the caller's
        postfiltering_max_beam allows more get the exact window top-k."""
        sel = np.nonzero(self.capped)[0]
        # the only reader of host windows: the route and the stats
        lo_h, hi_h = to_host(*self.inputs[2:])
        widths = np.maximum(hi_h[sel] - lo_h[sel], 0).astype(np.int64)
        qs, _, lo, hi = self.gather([sel])[0]
        bf_d, bf_i = batched_range_bruteforce(
            self.ps.data, self.ps.norms_sq, qs, lo, hi, self.qp.k, self.metric,
            norm_col=self.norm_col, widths=widths)
        self.res_i[sel] = bf_i
        self.res_d[sel] = bf_d
        self.cur_beam[sel] = -1  # exact: no final pass
        if self.stats is not None:
            self.stats.increment_dist(self.stat_ids[sel], widths)

    def final_pass(self):
        """The search at beam * final_beam_multiply (ref:
        postfilter_vamana.h:173-181) of the queries whose speculative
        final did not apply."""
        cur_beam = self.cur_beam
        final_beam = np.minimum(cur_beam * self.qp.final_beam_multiply, self.max_beam)
        needs_final = (final_beam > cur_beam) & (cur_beam >= 0)
        beams = np.unique(final_beam[needs_final])
        sels = [np.nonzero(needs_final & (final_beam == b))[0] for b in beams]
        launches = [(sel, self.search(sel, inputs, b)[0])
                    for b, sel, inputs in zip(beams, sels, self.gather(sels))]
        for sel, fut in launches:
            _, ti, td = to_host(*fut)
            self.res_i[sel] = ti.astype(np.int64)
            self.res_d[sel] = td

    def fold_stats(self):
        """Fetch the kept counters and add them to the stats."""
        for ids_for, idx, nv, dc in self.stat_buf:
            nv, dc = to_host(nv, dc)
            self.stats.increment_visited(ids_for[idx], nv[idx])
            self.stats.increment_dist(ids_for[idx], dc[idx])


def doubling_postfilter(
    ps,
    graph,  # SlabGraph, or a bucket-sharded row (parallel.sharded.ShardedGraphRow)
    queries: torch.Tensor,  # [Q, d_pad] f32 on the store's device, one row a task
    starts: torch.Tensor,  # [Q] slab start ids, on the store's device
    win_lo: torch.Tensor,  # [Q] global sorted-id window (inclusive start), as starts
    win_hi: torch.Tensor,  # [Q] (exclusive end), as starts
    qp: QueryParams,
    metric: str,
    stats=None,  # optional QueryStats; counters accumulate per source query
    stat_ids: Optional[np.ndarray] = None,  # [Q] host source-query ids for stats
    mesh=None,  # parallel.sharded.Mesh: split each batch over its devices
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched beam-doubling postfilter query (ref: postfilter_vamana.h:141-188),
    the JAX package's schedule step for step.

    Each pass (a round, the final pass) uploads one index of every beam
    class it launches, while the stream is empty, and each class gathers
    its rows from the inputs on the card: no copy between a pass's first
    launch and its first fetch waits for a kernel. Every round-1 beam
    class also launches its final pass (beam * final_beam_multiply) before
    knowing whether it satisfies, and reuses it as the doubled search when
    the multiply is 2, as the JAX package does by default.

    Returns (ids [Q, k] global sorted ids, dists [Q, k]) — inf/EMPTY padded."""
    global ROUNDS
    state = _Doubling(ps, graph, queries, starts, win_lo, win_hi, qp, metric,
                      stats, stat_ids, mesh)
    while not state.done.all():
        ROUNDS += 1
        with span("postfilter.round"):
            state.round()
    if state.exact_tail and state.capped.any():
        with span("postfilter.exact_tail"):
            state.exact_scan_tail()
    with span("postfilter.final"):
        state.final_pass()
    if stats is not None:
        state.fold_stats()
    return state.res_i, state.res_d


def _start_vertex(pts_sorted: np.ndarray, start_point: str) -> int:
    """Vertex 0 (reference parity, ref: postfilter_vamana.h:226-227) or the
    medoid: the point closest to the centroid, in label-sorted order."""
    if start_point == "zero":
        return 0
    if start_point == "medoid":
        mean = pts_sorted.astype(np.float64).mean(axis=0)
        d = (np.einsum("ij,ij->i", pts_sorted, pts_sorted)
             - 2.0 * (pts_sorted @ mean))
        return int(np.argmin(d))
    raise ValueError(f"start_point must be zero|medoid: {start_point}")


class PostfilterVamanaIndex:
    """Whole-dataset Vamana + doubling postfilter (the 'postfiltering' method).

    `device` places the store and the graph: None means the card ("cuda"),
    and raises where there is none; device="cpu" runs the plain PyTorch
    path. `start_point` ("zero" or "medoid") acts at query time only."""

    def __init__(
        self,
        points: np.ndarray,
        filter_values: np.ndarray,
        build_params: Optional[BuildParams] = None,
        metric: str = "Euclidian",
        *,
        seed: int = 0,
        require_cache: bool = False,
        start_point: str = "zero",
        device=None,
    ):
        bp = build_params or BuildParams()
        points = np.asarray(points)
        pts_sorted, self._labels_sorted, self._decoding = sort_by_labels(
            points, np.asarray(filter_values))
        self._start = _start_vertex(pts_sorted, start_point)
        self._ps = make_pointset(pts_sorted, metric, device=device)
        self._labels_dev = device_labels(self._labels_sorted, self._ps.device)
        self._fp = cache_fingerprint(self._labels_sorted, pts_sorted)
        self._graph = self._load_or_build(bp, seed, require_cache)
        self._mesh = None
        maybe_attach_inline(self._graph, self._ps)

    @classmethod
    def from_arrays(cls, data, norms_sq, n, d, metric, norm_col, labels_sorted,
                    decoding, nbrs, start: int = 0,
                    device=None) -> "PostfilterVamanaIndex":
        """An index over an existing label-sorted store and graph, without
        a build: the arrays of a JAX-built PostfilterVamanaIndex (its
        store's arrays as for PrefilterIndex.from_arrays, `_graph.nbrs_host`,
        `_start`) given as numpy."""
        self = cls.__new__(cls)
        self._ps = pointset_from_arrays(data, norms_sq, n, d, metric, norm_col,
                                        device)
        self._labels_sorted = np.asarray(labels_sorted, dtype=np.float64)
        self._decoding = np.asarray(decoding, dtype=np.int64)
        self._labels_dev = device_labels(self._labels_sorted, self._ps.device)
        self._graph = SlabGraph.from_nbrs(nbrs, device)
        self._start = int(start)
        self._mesh = None
        maybe_attach_inline(self._graph, self._ps)
        return self

    @property
    def metric(self) -> str:
        return self._ps.metric

    @property
    def device(self):
        return self._ps.device

    # --- graph cache (ref: postfilter_vamana.h:54-79,126-138) ---
    def _cache_file(self, bp: BuildParams) -> Optional[str]:
        return whole_dataset_cache(
            bp.cache_path, bp, float(self._labels_sorted[0]),
            float(self._labels_sorted[-1]), self._ps.n)

    def _load_or_build(self, bp: BuildParams, seed: int,
                       require_cache: bool) -> SlabGraph:
        n = self._ps.n
        fname = self._cache_file(bp)
        if fname and os.path.exists(fname):
            g = SlabGraph.from_cache(fname, self._fp, self._ps.device)
            if g is not None:
                return g
        if require_cache:
            raise FileNotFoundError(
                f"require_cache: graph cache absent or fingerprint-mismatched"
                f" ({fname})")
        if fname:
            os.makedirs(os.path.dirname(fname), exist_ok=True)
        # the build checkpoints beside the cache file and resumes from it
        g = build_vamana_graph(
            self._ps, np.arange(n, dtype=np.int64),
            np.array([0, n], dtype=np.int64), bp, seed=seed,
            checkpoint_path=fname + ".ckpt.npz" if fname else None)
        if fname:
            save_cached_nbrs(fname, g.nbrs_host, self._fp)
        return g

    def shard(self, mesh) -> "PostfilterVamanaIndex":
        """Split query batches over the devices of `mesh`
        (parallel.sharded.make_mesh), the store and graph replicated on
        each; its first device must hold the index. Searches then take the
        plain batched_beam_search on every device (the inline blocks are
        dropped), with the results of the unsharded plain search."""
        replicate_index(self._ps, [self._graph], mesh)
        self._mesh = mesh
        return self

    def batch_search(
        self,
        queries: np.ndarray,
        filters: Sequence[Tuple[float, float]],
        num_queries: int,
        query_params: QueryParams,
        stats=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [nq, k] uint32 original ids, dists [nq, k] f32).
        Points with lo <= label <= hi are candidates: the window's upper end
        is inclusive here (ref: postfilter_vamana.h:236-237), unlike the
        prefilter's."""
        with span("postfilter.batch"):
            queries = np.ascontiguousarray(
                np.asarray(queries, dtype=np.float32)[:num_queries])
            filters = np.ascontiguousarray(
                np.asarray(filters, dtype=np.float64)[:num_queries])
            d, d_pad = self._ps.d, self._ps.d_pad
            if queries.ndim != 2 or queries.shape[1] != d:
                raise ValueError(f"queries must be [nq, {d}], got {queries.shape}")
            q_dev, f_dev = to_device(self.device, queries, filters)
            with span("postfilter.pad"):  # the zeros pad_queries writes
                qp_pad = torch.nn.functional.pad(q_dev, (0, d_pad - d))
            with span("base.finalize"):
                q_norms = np.einsum("qd,qd->q", queries, queries)
            with span("postfilter.window_bounds"):
                win_lo, win_hi = closed_windows(
                    self._labels_dev, len(self._labels_sorted), f_dev)
            starts = torch.full((num_queries,), self._start, dtype=torch.int32,
                                device=self.device)
            ids, dists = doubling_postfilter(
                self._ps, self._graph, qp_pad, starts, win_lo, win_hi,
                query_params, self._ps.metric, stats=stats, mesh=self._mesh)
            with span("base.finalize"):
                return finalize_output(dists, ids, self._decoding, q_norms,
                                       self._ps.metric, pad_id=-1)
