"""RobustPrune (DiskANN edge selection) over batches of nodes.

Counterpart of rangefilteredann_tpu/ops/robust_prune.py (ref:
ParlayANN/algorithms/vamana/index.h:61-108). Candidates are sorted by
(distance to p, id); all pairwise candidate distances come from one batched
Gram product; then R greedy steps each keep the nearest surviving candidate
and kill every candidate it alpha-dominates.

All distances are TRUE distances (L2: ||p - c||^2 with both norms; MIPS:
-p.c): the domination test alpha * d(p*, c) <= d(p, c) compares distances
from different reference points, so the shifted form of the search path does
not serve here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.data import METRIC_L2
from .distances import mxu_operands
from .topk import EMPTY_ID, lexsort2


def _true_dists(vecs_a, norms_a, vecs_b, norms_b, metric):
    """d(a_i, b_ic) for a [m, d] against b [m, C, d]: [m, C]."""
    b_c, a_c = mxu_operands(vecs_b, vecs_a)
    ip = torch.bmm(b_c, a_c[..., None])[..., 0]
    if metric == METRIC_L2:
        return norms_a[:, None] + norms_b - 2.0 * ip
    return -ip


def robust_prune(
    data: torch.Tensor,  # [n, d_pad] global point store
    norms_sq: torch.Tensor,  # [n]
    slab_to_global: torch.Tensor,  # [m_slab] int32
    p_slab: torch.Tensor,  # [m] int32 slab ids of the nodes being pruned
    cand_slab: torch.Tensor,  # [m, C] int32 candidate slab ids, -1 = pad
    alpha: float,
    R: int,
    metric: str,
    norm_col: "int | None" = None,  # the store's fused ||x||^2 column, which
    # the point side of every product zeroes (PointSet.norm_col)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out_ids [m, R] slab ids, -1 padded; out_dists [m, R] true
    d(p, out)). Candidates equal to p or -1 are ignored; a repeated
    candidate is dominated by its first copy at distance 0."""
    m, c = cand_slab.shape
    m_slab = slab_to_global.shape[0]
    dev = data.device
    p_gid = slab_to_global[p_slab.clamp(0, m_slab - 1).long()].long()
    p_vec = data[p_gid]  # [m, d]
    valid = (cand_slab >= 0) & (cand_slab != p_slab[:, None])
    c_gid = slab_to_global[cand_slab.clamp(0, m_slab - 1).long()].long()
    c_vecs = data[c_gid]  # [m, C, d]
    if norm_col is not None:
        p_norm = p_vec[:, norm_col]
        c_norms = c_vecs[..., norm_col]
        p_vec = p_vec.clone()
        p_vec[:, norm_col] = 0.0
    else:
        p_norm = norms_sq[p_gid]
        c_norms = norms_sq[c_gid]

    d_pc = _true_dists(p_vec, p_norm, c_vecs, c_norms, metric)
    d_pc = torch.where(valid, d_pc, float("inf"))
    ids = torch.where(valid, cand_slab.to(torch.int32), EMPTY_ID)

    # (dist, id) order, the candidate position breaking exact repeats
    s_pos = lexsort2(d_pc, ids)
    s_d = torch.gather(d_pc, 1, s_pos)
    s_ids = torch.gather(ids, 1, s_pos)
    rows = torch.arange(m, device=dev)[:, None]
    s_vecs = c_vecs[rows, s_pos]
    s_norms = torch.gather(c_norms, 1, s_pos)

    # all pairwise candidate distances, so the greedy loop reads rows only
    lhs = s_vecs
    if norm_col is not None:  # the point side stays norm-free
        lhs = lhs.clone()
        lhs[..., norm_col] = 0.0
    rhs_c, lhs_c = mxu_operands(s_vecs, lhs)
    gram = torch.bmm(lhs_c, rhs_c.transpose(1, 2))  # [m, C, C]
    if metric == METRIC_L2:
        pair_d = s_norms[:, :, None] + s_norms[:, None, :] - 2.0 * gram
    else:
        pair_d = -gram

    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
    iota_c = torch.arange(c, device=dev)[None, :]
    alive = torch.isfinite(s_d)
    out_ids = torch.full((m, R), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((m, R), float("inf"), dtype=torch.float32, device=dev)
    for i in range(R):
        any_alive = alive.any(dim=1)
        idx = torch.argmax(alive.to(torch.uint8), dim=1)  # nearest survivor
        out_ids[:, i] = torch.where(any_alive, s_ids[rows[:, 0], idx], -1)
        out_d[:, i] = torch.where(any_alive, s_d[rows[:, 0], idx], float("inf"))
        d_star = pair_d[rows[:, 0], idx]  # [m, C]
        dominated = alpha_t * d_star <= s_d
        consumed = iota_c == idx[:, None]  # taken even if not self-dominated
        alive = alive & ~dominated & ~consumed & any_alive[:, None]
    return out_ids, out_d
