"""Range-masked brute-force k-NN scans in plain PyTorch.

Counterpart of rangefilteredann_tpu/ops/bruteforce.py. Both scans are exact:

  * `windowed_bruteforce` — each query gathers its own [start, end) window of
    the label-sorted store as a padded block. Right for small windows.
  * `scan_bruteforce` — all queries scan the whole store in tiles, masking
    columns outside each query's window and keeping a running top-k. This is
    the plain version of the hand-written scan kernel (ops/scan.py): the CPU
    path, and what the kernel is held against on the card.

Both return L2 distances in the shifted form (no per-query ||q||^2; see
ops/distances.py); callers add it back at the API boundary.
"""

from __future__ import annotations

import torch

from .distances import (
    fused_norm_distances,
    gathered_distances,
    query_block_distances,
)
from .topk import EMPTY_ID, masked_topk, merge_topk


def windowed_bruteforce(
    data: torch.Tensor,  # [n, d_pad]
    norms_sq: torch.Tensor,  # [n]
    queries: torch.Tensor,  # [Q, d_pad]
    starts: torch.Tensor,  # [Q] int32 inclusive window starts (sorted ids)
    ends: torch.Tensor,  # [Q] int32 exclusive window ends
    window: int,  # padded window size (>= max(ends-starts))
    k: int,
    metric: str,
    norm_col=None,  # fused ||x||^2 column (PointSet.norm_col), if any
):
    """Per-query window scan. Returns (dists [Q, k], ids [Q, k] int32).

    Empty slots have id EMPTY_ID and dist +inf.
    """
    n = data.shape[0]
    offs = torch.arange(window, dtype=torch.int32, device=data.device)
    ids = starts[:, None].to(torch.int32) + offs[None, :]  # [Q, W]
    valid = ids < ends[:, None]
    safe = ids.clamp(0, n - 1).long()
    vecs = data[safe]  # [Q, W, d_pad]
    if norm_col is not None:
        dists = fused_norm_distances(vecs, queries, metric, norm_col)
    else:
        dists = gathered_distances(queries, vecs, norms_sq[safe], metric)
    dists = torch.where(valid, dists, float("inf"))
    ids = torch.where(valid, ids, EMPTY_ID)
    return masked_topk(dists, ids, k)


def scan_bruteforce(
    data: torch.Tensor,  # [n, d_pad]
    norms_sq: torch.Tensor,  # [n]
    queries: torch.Tensor,  # [Q, d_pad]
    starts: torch.Tensor,  # [Q] int32
    ends: torch.Tensor,  # [Q] int32
    k: int,
    metric: str,
    tile: int = 8192,
):
    """Full-store tiled scan with per-query range masks.

    Returns (dists [Q, k], ids [Q, k] int32). Each tile is one [Q, d] x
    [d, T] product, a window mask, and a merge into the running top-k.
    Queries narrower than the store multiply its first columns only.
    """
    n, width = data.shape[0], queries.shape[1]
    q = queries.shape[0]
    dev = data.device
    starts = starts.to(device=dev, dtype=torch.int32)[:, None]
    ends = ends.to(device=dev, dtype=torch.int32)[:, None]
    best_d = torch.full((q, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((q, k), EMPTY_ID, dtype=torch.int32, device=dev)
    for base in range(0, n, tile):
        hi = min(base + tile, n)
        dists = query_block_distances(queries, data[base:hi, :width],
                                      norms_sq[base:hi], metric)  # [Q, T]
        col = torch.arange(base, hi, dtype=torch.int32, device=dev)[None, :]
        valid = (col >= starts) & (col < ends)
        dists = torch.where(valid, dists, float("inf"))
        ids = torch.where(valid, col, EMPTY_ID)
        td, ti = masked_topk(dists, ids, k)
        best_d, best_i = merge_topk(best_d, best_i, td, ti, k)
    return best_d, best_i
