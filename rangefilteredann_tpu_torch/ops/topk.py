"""Masked top-k helpers in (dist, id) order.

Counterpart of rangefilteredann_tpu/ops/topk.py, which sorts with
jax.lax.sort(num_keys=2). torch.topk and torch.sort break ties in no fixed
order, so the same lexicographic order comes from two stable sorts: by id,
then by distance. +inf distances stand for empty slots.
"""

from __future__ import annotations

import torch

EMPTY_ID = 2**31 - 1  # sorts after every real id


def lexsort2(d: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Per-row permutation that sorts by (d, key): two stable sorts, as
    jax.lax.sort(num_keys=2) orders; equal pairs keep their positions."""
    _, by_key = torch.sort(key, dim=-1, stable=True)
    _, by_d = torch.sort(torch.gather(d, -1, by_key), dim=-1, stable=True)
    return torch.gather(by_key, -1, by_d)


def masked_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Per-row smallest-k by distance, ties broken by smaller id.

    dists: [..., C] float32 (+inf = invalid); ids: [..., C] int32.
    Returns (top_dists [..., k], top_ids [..., k]). Rows with fewer than k
    candidates are padded with (+inf, EMPTY_ID).
    """
    c = dists.shape[-1]
    if c < k:
        pad = (*dists.shape[:-1], k - c)
        dists = torch.cat([dists, dists.new_full(pad, float("inf"))], dim=-1)
        ids = torch.cat([ids, ids.new_full(pad, EMPTY_ID)], dim=-1)
    sel = lexsort2(dists, ids)[..., :k]
    return torch.gather(dists, -1, sel), torch.gather(ids, -1, sel)


def merge_topk(dists_a, ids_a, dists_b, ids_b, k: int):
    """Merge two per-row candidate sets and keep the smallest k of the union."""
    d = torch.cat([dists_a, dists_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    return masked_topk(d, i, k)
