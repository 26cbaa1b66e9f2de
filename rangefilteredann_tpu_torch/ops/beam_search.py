"""Batched greedy best-first graph search (beam search) in plain PyTorch.

Counterpart of rangefilteredann_tpu/ops/beam_search.py, with the same state
and the same step (ref: ParlayANN/algorithms/utils/beamSearch.h:53-184):

  * frontier: per query, a (dist, id)-sorted array of `beam` slots with an
    explored flag each; no visited set (a node dropped from a full frontier
    never re-enters, so exact dedup against the frontier suffices).
  * each step expands the first `expand` unexplored slots, gathers their
    neighbours from the padded [m, R] adjacency (or their inline [R, w]
    vector blocks), drops candidates not strictly below the pre-step tail,
    and merges with exact dedup, truncating to `beam`; optional cut pruning.

Graphs are slabs: adjacency rows hold slab-local int32 ids (-1 = padding) and
`slab_to_global` maps slab positions to rows of the point store.

This is the plain version of the hand-written beam kernel (ops/beam.py): the
CPU path of every search, the build's searches on the card (expand > 1,
visited lists, exclude), and what the kernel is held against. The loop
condition is read on the host; on the card it is read every COND_EVERY steps
(a step taken after a query has finished leaves its state as it is, so the
result does not depend on the cadence). The JAX package's merge-path variant
(`RFANN_MERGE=path`) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.data import METRIC_L2
from .distances import fused_norm_distances, gathered_distances
from .topk import EMPTY_ID, lexsort2

# Steps between two host reads of the loop condition on the card.
COND_EVERY = 8


def default_expand(beam: int) -> int:
    """Nodes expanded per query step: 1, the reference's order
    (beamSearch.h:108)."""
    del beam
    return 1


def build_expand(L: int) -> int:
    """Nodes expanded per step of a build's insertion searches, as the JAX
    package's builds do (its cached graphs were built with it)."""
    return max(1, min(8, L // 16))


def window_filter_topk(
    f_ids: torch.Tensor,  # [Q, B] slab ids, (dist, id)-sorted, EMPTY_ID padded
    f_d: torch.Tensor,  # [Q, B]
    s2g: torch.Tensor,  # [m] slab -> global sorted id (int32)
    win_lo: torch.Tensor,  # [Q] inclusive global window start
    win_hi: torch.Tensor,  # [Q] exclusive global window end
    k: int,
):
    """Label-window filter + top-k of a beam frontier (ref:
    postfilter_vamana.h:223-254). Returns (counts [Q] int32, gids [Q, k]
    int32 EMPTY_ID-padded, dists [Q, k]).

    The frontier arrives sorted and filtering keeps relative order, so the
    top k in-window entries are the first k by in-window rank; each lands in
    column rank - 1 (column k collects the rest and is cut off)."""
    q, m = f_ids.shape[0], s2g.shape[0]
    valid = f_ids != EMPTY_ID
    gids = s2g[f_ids.clamp(0, m - 1).long()]
    inwin = valid & (gids >= win_lo[:, None]) & (gids < win_hi[:, None])
    counts = inwin.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(inwin.to(torch.int64), dim=1)  # 1-based in-window
    col = torch.where(inwin & (rank <= k), rank - 1, k)
    out_d = f_d.new_full((q, k + 1), float("inf"))
    out_g = gids.new_full((q, k + 1), EMPTY_ID)
    out_d.scatter_(1, col, f_d)
    out_g.scatter_(1, col, gids)
    return counts, out_g[:, :k], out_d[:, :k]


def exact_rerank(
    data: torch.Tensor,  # [n, d_pad] global point store (float)
    norms_sq: torch.Tensor,  # [n]
    queries: torch.Tensor,  # [Q, d_pad] f32
    gids: torch.Tensor,  # [Q, C] global sorted ids, EMPTY_ID padded
    k: int,
    metric: str,
    norm_col: Optional[int] = None,
):
    """Exact fp32 distances for candidate global ids, (dist, id)-sorted, top
    k: the rerank of a quantized-inline search's final candidates.
    Returns (gids [Q, k], dists [Q, k])."""
    n = data.shape[0]
    valid = gids != EMPTY_ID
    safe = gids.clamp(0, n - 1).long()
    vecs = data[safe]
    if norm_col is not None:
        d = fused_norm_distances(vecs, queries, metric, norm_col)
    else:
        d = gathered_distances(queries, vecs, norms_sq[safe], metric)
    d = torch.where(valid, d, float("inf"))
    g = torch.where(valid, gids, EMPTY_ID)
    perm = lexsort2(d, g)
    return torch.gather(g, 1, perm)[:, :k], torch.gather(d, 1, perm)[:, :k]


class BeamResult(NamedTuple):
    frontier_ids: torch.Tensor  # [Q, B] slab ids, EMPTY_ID = empty slot
    frontier_dists: torch.Tensor  # [Q, B] f32, +inf = empty
    num_visited: torch.Tensor  # [Q] int32 nodes expanded
    dist_cmps: torch.Tensor  # [Q] int32 distance computations
    visited_ids: torch.Tensor  # [Q, V] slab ids in visit order (or [Q, 0])
    visited_dists: torch.Tensor  # [Q, V]


def _pack(ids, expl):
    """One int32 key per slot: id * 2 + flag, EMPTY_ID for empty slots."""
    return torch.where(ids == EMPTY_ID, EMPTY_ID, ids * 2 + expl)


def _unpack(key):
    empty = key == EMPTY_ID
    return (torch.where(empty, EMPTY_ID, key >> 1),
            torch.where(empty, 0, key & 1))


def _merge_dedup_sort(ids, dists, expl, beam):
    """Exact dedup by id, then (dist, id) sort; the best `beam` slots. For
    wide candidate sets (builds). Explored copies win a dedup."""
    key1 = _pack(ids, 1 - expl)
    s_key1, order = torch.sort(key1, dim=1, stable=True)
    s_d = torch.gather(dists, 1, order)
    is_empty = s_key1 == EMPTY_ID
    s_ids = torch.where(is_empty, EMPTY_ID, s_key1 >> 1)
    s_e = torch.where(is_empty, 0, 1 - (s_key1 & 1))
    dup = torch.cat([torch.zeros_like(is_empty[:, :1]),
                     s_ids[:, 1:] == s_ids[:, :-1]], dim=1) & ~is_empty
    key2 = torch.where(dup | is_empty, EMPTY_ID, s_ids * 2 + s_e)
    s_d = torch.where(dup, float("inf"), s_d)
    perm = lexsort2(s_d, key2)
    f_ids, f_e = _unpack(torch.gather(key2, 1, perm))
    f_d = torch.gather(s_d, 1, perm)
    return f_ids[:, :beam], f_d[:, :beam], f_e[:, :beam]


def _dedup_cands(f_ids, c_ids, c_d):
    """Mask candidates that repeat a frontier id (the frontier copy wins)
    or an earlier candidate (the first wins)."""
    dup_f = (c_ids[:, :, None] == f_ids[:, None, :]).any(dim=2)
    same = c_ids[:, :, None] == c_ids[:, None, :]
    c = c_ids.shape[1]
    iota = torch.arange(c, device=c_ids.device)
    earlier = iota[None, None, :] < iota[None, :, None]
    dup = (dup_f | (same & earlier).any(dim=2)) & (c_ids != EMPTY_ID)
    return (torch.where(dup, EMPTY_ID, c_ids),
            torch.where(dup, float("inf"), c_d))


def _merge_frontier_cands(f_ids, f_d, f_e, c_ids, c_d, beam):
    """Merge a duplicate-free sorted frontier with fresh candidates: one
    (dist, key) sort. For narrow candidate sets (queries)."""
    c_ids, c_d = _dedup_cands(f_ids, c_ids, c_d)
    key = _pack(torch.cat([f_ids, c_ids], dim=1),
                torch.cat([f_e, torch.zeros_like(c_ids)], dim=1))
    m_d = torch.cat([f_d, c_d], dim=1)
    perm = lexsort2(m_d, key)
    o_ids, o_e = _unpack(torch.gather(key, 1, perm))
    return o_ids[:, :beam], torch.gather(m_d, 1, perm)[:, :beam], o_e[:, :beam]


def batched_beam_search(
    data: Optional[torch.Tensor],  # [n, d_pad] global point store
    norms_sq: Optional[torch.Tensor],  # [n]
    nbrs: torch.Tensor,  # [m, R] int32 slab-local adjacency, -1 padded
    slab_to_global: Optional[torch.Tensor],  # [m] int32 slab -> store row
    queries: torch.Tensor,  # [Q, d_pad] f32
    starts: torch.Tensor,  # [Q] int32 slab start ids
    *,
    beam: int,
    k: int,  # 0 = build mode (no cut pruning)
    cut: float,
    limit: int,  # max nodes visited
    metric: str,
    active_in: Optional[torch.Tensor] = None,  # [Q] bool, False = padded query
    exclude: Optional[torch.Tensor] = None,  # [Q] slab id never proposed (-1 none)
    q_norms_sq: Optional[torch.Tensor] = None,  # [Q] ||q||^2 for L2 cut pruning
    return_visited: bool = False,
    visited_cap: int = 0,
    expand: int = 1,  # nodes expanded per step (1 = the reference's order)
    degree_limit: int = 0,  # expand only the first degree_limit neighbours
    norm_col: Optional[int] = None,  # column of `data` holding ||x||^2
    identity_map: bool = False,  # slab_to_global is the identity
    nbr_vecs: Optional[torch.Tensor] = None,  # [m, R, w] inline neighbour
    # vectors (fp32 exact, bf16, native int8/uint8, or int8-quantized)
    nbr_norms: Optional[torch.Tensor] = None,  # [m, R] their ||x||^2
    nbr_scale: Optional[torch.Tensor] = None,  # [m] dequant scales: nbr_vecs
    # holds int8 quantizations x ~= scale[node] * x_hat of a float store
    d0: Optional[torch.Tensor] = None,  # [Q] start distances, computed by the
    # caller exactly as the init below does; then `data` is read only by a
    # search without inline blocks
) -> BeamResult:
    """The JAX package's batched_beam_search (ops/beam_search.py:376), step
    for step. Returns a BeamResult; visited arrays are [Q, 0] unless
    return_visited."""
    q = queries.shape[0]
    m, r = nbrs.shape
    dev = queries.device
    if m >= 2**30:
        raise ValueError("slab ids must fit packed int32 sort keys (m < 2^30)")
    if degree_limit and degree_limit < r:
        r = degree_limit
    v_cap = visited_cap if return_visited else 0
    vw = max(v_cap, 1)
    i32 = torch.int32
    inf = float("inf")
    active_in = (torch.ones(q, dtype=torch.bool, device=dev) if active_in is None
                 else active_in.to(dev, torch.bool))
    exclude = (torch.full((q,), -1, dtype=i32, device=dev) if exclude is None
               else exclude.to(dev, i32))
    q_norms_sq = (torch.zeros(q, dtype=torch.float32, device=dev)
                  if q_norms_sq is None else q_norms_sq.to(dev))
    cut_t = torch.tensor(cut, dtype=torch.float32, device=dev)
    starts = starts.to(dev, i32)

    def _dists(vecs, gids):
        if norm_col is not None:
            return fused_norm_distances(vecs, queries, metric, norm_col)
        return gathered_distances(queries, vecs, norms_sq[gids], metric)

    # --- init: frontier = {start} ---
    if d0 is None:
        start_safe = starts.clamp(0, m - 1).long()
        start_gid = (start_safe if identity_map
                     else slab_to_global[start_safe].long())
        d0 = _dists(data[start_gid][:, None, :], start_gid[:, None])[:, 0]
    f_ids = torch.full((q, beam), EMPTY_ID, dtype=i32, device=dev)
    f_ids[:, 0] = torch.where(active_in, starts, EMPTY_ID)
    f_d = torch.full((q, beam), inf, dtype=torch.float32, device=dev)
    f_d[:, 0] = torch.where(active_in, d0, inf)
    f_e = torch.zeros((q, beam), dtype=i32, device=dev)
    n_vis = torch.zeros(q, dtype=i32, device=dev)
    cmps = active_in.to(i32)
    vis_ids = torch.full((q, vw), EMPTY_ID, dtype=i32, device=dev)
    vis_d = torch.full((q, vw), inf, dtype=torch.float32, device=dev)
    iota_b = torch.arange(beam, device=dev)
    iota_v = torch.arange(vw, device=dev)
    e_rank = torch.arange(1, expand + 1, device=dev)[None, :, None]

    def running():
        unexplored = (f_e == 0) & (f_ids != EMPTY_ID)
        return bool((unexplored.any(dim=1) & (n_vis < limit)).any())

    def step():
        nonlocal f_ids, f_d, f_e, n_vis, cmps, vis_ids, vis_d
        unexplored = (f_e == 0) & (f_ids != EMPTY_ID)
        active = unexplored.any(dim=1) & (n_vis < limit)
        # the first `expand` unexplored slots (the frontier is sorted)
        if expand == 1:
            sel = torch.argmax(unexplored.to(torch.uint8), dim=1)[:, None]
        else:
            rank = torch.cumsum(unexplored.to(i32), dim=1)
            hit = unexplored[:, None, :] & (rank[:, None, :] == e_rank)
            sel = torch.argmax(hit.to(torch.uint8), dim=2)  # [Q, E]
        n_unex = unexplored.sum(dim=1, dtype=i32)
        e_iota = torch.arange(sel.shape[1], device=dev)[None, :]
        sel_act = active[:, None] & (e_iota < n_unex[:, None])  # [Q, E]
        sel_onehot = (iota_b[None, None, :] == sel[:, :, None]) & sel_act[:, :, None]
        cur = torch.gather(f_ids, 1, sel)
        cur_d = torch.gather(f_d, 1, sel)
        cur_safe = cur.clamp(0, m - 1).long()

        # mark explored; record in visit order
        f_e = torch.where(sel_onehot.any(dim=1), 1, f_e)
        if v_cap:
            slot = n_vis[:, None] + torch.cumsum(sel_act.to(i32), dim=1) - 1
            at = (iota_v[None, None, :] == slot[:, :, None]) & sel_act[:, :, None]
            hit_v = at.any(dim=1)
            vis_ids = torch.where(hit_v, torch.where(at, cur[:, :, None], 0).sum(
                dim=1, dtype=i32), vis_ids)
            vis_d = torch.where(hit_v, torch.where(at, cur_d[:, :, None], 0.0).sum(
                dim=1), vis_d)
        n_vis = n_vis + sel_act.sum(dim=1, dtype=i32)

        # neighbour ids and distances
        cand = nbrs[cur_safe][..., :r].reshape(q, -1)  # [Q, E*r]
        valid = ((cand >= 0) & sel_act.repeat_interleave(r, dim=1)
                 & (cand != exclude[:, None]))
        cand_safe = cand.clamp(0, m - 1).long()
        if nbr_vecs is not None:
            blk = nbr_vecs[cur_safe][..., :r, :]  # [Q, E, r, w]
            w = blk.shape[-1]
            vecs = blk.reshape(q, -1, w)
            nrm = nbr_norms[cur_safe][..., :r].reshape(q, -1)
            if nbr_scale is not None:
                s = nbr_scale[cur_safe].repeat_interleave(r, dim=1)
                ip = -gathered_distances(queries[:, :w], vecs,
                                         torch.zeros_like(nrm), "mips")
                cand_dist = (nrm - 2.0 * s * ip if metric == METRIC_L2
                             else -s * ip)
            else:
                if vecs.dtype == torch.bfloat16:  # upcast after the gather
                    vecs = vecs.to(torch.float32)
                cand_dist = gathered_distances(queries[:, :w], vecs, nrm, metric)
        else:
            if identity_map:
                gid_safe = cand_safe
            else:
                gid_safe = slab_to_global[cand_safe].long().clamp(0, data.shape[0] - 1)
            cand_dist = _dists(data[gid_safe], gid_safe)
        cmps = cmps + valid.sum(dim=1, dtype=i32)

        # drop candidates not beating the worst of a full frontier
        # (ref: beamSearch.h:133-144)
        full = f_ids[:, beam - 1] != EMPTY_ID
        cutoff = torch.where(full, f_d[:, beam - 1], inf)
        keep = valid & (cand_dist < cutoff[:, None])
        cand_ids = torch.where(keep, cand, EMPTY_ID)
        cand_dist = torch.where(keep, cand_dist, inf)

        if cand_ids.shape[1] <= 128:
            nf_ids, nf_d, nf_e = _merge_frontier_cands(
                f_ids, f_d, f_e, cand_ids, cand_dist, beam)
        else:
            nf_ids, nf_d, nf_e = _merge_dedup_sort(
                torch.cat([f_ids, cand_ids], dim=1),
                torch.cat([f_d, cand_dist], dim=1),
                torch.cat([f_e, torch.zeros_like(cand_ids)], dim=1), beam)

        # cut pruning (query mode, L2 only; ref: beamSearch.h:162-167), in
        # the shifted form d < cut * dk + (cut - 1) * ||q||^2
        if 0 < k < beam and metric == METRIC_L2:
            kth = nf_d[:, k]
            keep_cut = nf_d < (cut_t * kth + (cut_t - 1.0) * q_norms_sq)[:, None]
            drop = torch.isfinite(kth)[:, None] & ~keep_cut
            nf_ids = torch.where(drop, EMPTY_ID, nf_ids)
            nf_d = torch.where(drop, inf, nf_d)
            nf_e = torch.where(drop, 0, nf_e)

        # finished queries keep their frontier
        a = active[:, None]
        f_ids = torch.where(a, nf_ids, f_ids)
        f_d = torch.where(a, nf_d, f_d)
        f_e = torch.where(a, nf_e, f_e)

    every = 1 if dev.type == "cpu" else COND_EVERY
    while running():
        for _ in range(every):
            step()
    if not return_visited:
        vis_ids, vis_d = vis_ids[:, :0], vis_d[:, :0]
    return BeamResult(f_ids, f_d, n_vis, cmps, vis_ids, vis_d)
