"""Distance blocks as matrix products.

Counterpart of rangefilteredann_tpu/ops/distances.py:

  L2^2(q, x) = ||x||^2 - 2 q.x  (+ ||q||^2, a per-query constant dropped
               everywhere, exactly as ordering-only distances allow)
  MIPS(q, x) = -q.x             (negated inner product)

Operand policy (`mxu_operands`): float32 stores multiply in full float32
(TF32 stays off, see utils/data.resolve_device); int8/uint8 stores round BOTH
the store and the query to bfloat16 and accumulate in float32, which is exact
for byte values and matches the JAX package's single bf16 pass. The rounded
operands are multiplied as float32 tensors: a product of two bf16 values is
exact in float32, so this equals a bf16 product with float32 accumulation.
"""

from __future__ import annotations

import torch

from ..utils.data import METRIC_L2, METRIC_MIPS

_BYTE_DTYPES = (torch.int8, torch.uint8)


def is_metric(metric: str) -> bool:
    return metric == METRIC_L2


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def mxu_operands(block: torch.Tensor, other: torch.Tensor):
    """(block', other') as float32 tensors holding the values the reference
    multiplies: bf16-rounded for byte stores, float32 otherwise."""
    if block.dtype in _BYTE_DTYPES:
        return _bf16_round(block), _bf16_round(other)
    return block.to(torch.float32), other.to(torch.float32)


def _shift(ip: torch.Tensor, norms, metric: str) -> torch.Tensor:
    if metric == METRIC_L2:
        return norms - 2.0 * ip
    if metric == METRIC_MIPS:
        return -ip
    raise ValueError(metric)


def query_block_distances(
    queries: torch.Tensor,  # [Q, d_pad] f32
    block: torch.Tensor,  # [T, d_pad] points tile
    block_norms: torch.Tensor,  # [T] f32
    metric: str,
) -> torch.Tensor:
    """All-pairs distances between a query block and a point tile: [Q, T]."""
    blk, q = mxu_operands(block, queries)
    return _shift(q @ blk.T, block_norms[None, :], metric)


def gathered_distances(
    queries: torch.Tensor,  # [Q, d_pad]
    gathered: torch.Tensor,  # [Q, C, d_pad] per-query candidate vectors
    gathered_norms: torch.Tensor,  # [Q, C]
    metric: str,
) -> torch.Tensor:
    """Per-query distances to per-query gathered candidates: [Q, C]."""
    g, q = mxu_operands(gathered, queries)
    ip = torch.bmm(g, q[:, :, None])[..., 0]
    return _shift(ip, gathered_norms, metric)


def fused_norm_distances(
    vecs: torch.Tensor,  # [Q, C, d_pad] gathered rows carrying ||x||^2 at norm_col
    queries: torch.Tensor,  # [Q, d_pad] zero-padded queries
    metric: str,
    norm_col: int,
) -> torch.Tensor:
    """Distances with the norm taken inside the product: the query's entry
    at norm_col is set to -0.5 (L2) / 0 (MIPS), so shifted-L2 = -2*ip and
    MIPS = -ip with no separate norm read. Returns [Q, C]."""
    queries = queries.clone()
    queries[:, norm_col] = -0.5 if metric == METRIC_L2 else 0.0
    ip = torch.bmm(vecs, queries[:, :, None])[..., 0]
    return -2.0 * ip if metric == METRIC_L2 else -ip


def pairwise_distances(
    a: torch.Tensor, a_norms: torch.Tensor, b: torch.Tensor,
    b_norms: torch.Tensor, metric: str,
) -> torch.Tensor:
    """[A, B] all-pairs distances between two padded point blocks."""
    b_c, a_c = mxu_operands(b, a)
    ip = a_c @ b_c.T
    if metric == METRIC_L2:
        return a_norms[:, None] + b_norms[None, :] - 2.0 * ip
    if metric == METRIC_MIPS:
        return -ip
    raise ValueError(metric)
