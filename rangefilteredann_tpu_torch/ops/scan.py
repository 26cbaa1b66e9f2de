"""Range-masked top-k scan on the card: the wrapper of csrc/scan_topk.cu.

Counterpart of rangefilteredann_tpu/ops/pallas_scan.py, whose Pallas kernel
`_scan_kernel` this hand-written CUDA kernel replaces; the kernel's source
carries the note on its bound and design. Same contract as the plain version
ops/bruteforce.scan_bruteforce: (dists [Q, k] f32, ids [Q, k] int32) in the
caller's query order, sorted by (dist, id), empty slots (+inf, EMPTY_ID), L2
distances shifted (no ||q||^2).

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils.data import METRIC_L2, METRIC_MIPS
from .bruteforce import scan_bruteforce

# Kernel launches since the count was last set to 0 (launches only, never
# calls that took the plain version).
SCAN_LAUNCHES = 0

MAX_K = 256  # csrc/scan_topk.cu MAX_K
CHUNK = 32  # columns per staged chunk (csrc/scan_topk.cu DK)
_DTYPE_CODES = {torch.float32: 0, torch.int8: 1, torch.uint8: 2}

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = kernels.load("scan_topk").scan_topk_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, ctypes.c_longlong, i, i, p, p, i, p, p, i, i, i,
                       i, p, p, p]
        fn.restype = i
        _launch_fn = fn
    return _launch_fn


def scan_topk(
    data: torch.Tensor,  # [n_rows, d_pad] f32 / int8 / uint8
    norms_sq: torch.Tensor,  # [n_rows] f32
    queries: torch.Tensor,  # [Q, >= d_eff] f32, zero past the real dims
    starts: torch.Tensor,  # [Q] int inclusive window starts
    ends: torch.Tensor,  # [Q] int exclusive window ends
    k: int,
    metric: str,
    d_eff: "int | None" = None,  # columns holding real dims (default d_pad)
):
    """Exact k nearest within per-query windows of the label-sorted store.

    The kernel streams only the first `d_eff` columns (rounded up to CHUNK,
    with the query zeroed past d_eff), so a fused norm column past the real
    dims never enters the product."""
    if metric not in (METRIC_L2, METRIC_MIPS):
        raise ValueError(metric)
    if data.device.type == "cpu":
        if d_eff is not None and d_eff < queries.shape[1]:
            queries = queries.clone()
            queries[:, d_eff:] = 0.0
        return scan_bruteforce(data, norms_sq, queries, starts, ends, k=k,
                               metric=metric)
    if data.device.type != "cuda":
        raise ValueError(f"scan_topk takes CPU or CUDA tensors, got {data.device}")
    return _scan_cuda(data, norms_sq, queries, starts, ends, k, metric,
                      data.shape[1] if d_eff is None else int(d_eff))


def sorted_launch_args(data, norms_sq, queries, starts, ends, k, d_eff, *,
                       chunk, dtypes, name):
    """Check the arguments of a scan kernel on the card and sort the queries
    by window midpoint, so each block of queries walks a tight union of
    windows. Returns (order, sorted queries [Q, d_stream] f32 contiguous and
    zero past d_eff, sorted starts, sorted ends, d_stream), where d_stream
    is d_eff rounded up to `chunk`. Byte stores get the reference's operand
    policy: the query is rounded to bf16."""
    dev = data.device
    n_rows, d_pad = data.shape
    q = queries.shape[0]
    if data.dtype not in dtypes:
        raise ValueError(f"the CUDA {name} does not take {data.dtype} stores")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CUDA {name} takes 1 <= k <= {MAX_K}, got k={k}")
    for arg, t in (("norms_sq", norms_sq), ("queries", queries),
                   ("starts", starts), ("ends", ends)):
        if t.device != dev:
            raise ValueError(f"{arg} is on {t.device}, the store on {dev}")
    if not data.is_contiguous() or data.data_ptr() % 16 or (
            d_pad * data.element_size()) % 16:
        raise ValueError("the store must be contiguous with 16-byte aligned rows")
    if (norms_sq.dtype != torch.float32 or tuple(norms_sq.shape) != (n_rows,)
            or not norms_sq.is_contiguous()):
        raise ValueError(f"norms_sq must be a contiguous float32 [{n_rows}]")
    if queries.dim() != 2 or queries.dtype != torch.float32:
        raise ValueError("queries must be a float32 [Q, d] tensor")
    if tuple(starts.shape) != (q,) or tuple(ends.shape) != (q,):
        raise ValueError(f"starts and ends must be [{q}]")
    if n_rows >= 2**31 - 1:
        raise ValueError(f"{n_rows} rows do not fit int32 ids")
    d_stream = -(-d_eff // chunk) * chunk
    if not 0 < d_eff <= d_stream <= min(d_pad, queries.shape[1]):
        raise ValueError(f"d_eff={d_eff} does not fit the store ({d_pad}) "
                         f"and queries ({queries.shape[1]})")
    starts = starts.to(torch.int32)
    ends = ends.to(torch.int32)
    order = torch.argsort(starts.long() + ends.long(), stable=True)
    qs = queries[order, :d_stream]
    if data.dtype != torch.float32:  # byte stores: the reference's operand policy
        qs = qs.to(torch.bfloat16).to(torch.float32)
    if d_eff < d_stream:
        qs[:, d_eff:] = 0.0
    return (order, qs.contiguous(), starts[order].contiguous(),
            ends[order].contiguous(), d_stream)


def _scan_cuda(data, norms_sq, queries, starts, ends, k, metric, d_eff):
    global SCAN_LAUNCHES
    dev = data.device
    n_rows, d_pad = data.shape
    order, qs, s_s, e_s, d_stream = sorted_launch_args(
        data, norms_sq, queries, starts, ends, k, d_eff, chunk=CHUNK,
        dtypes=_DTYPE_CODES, name="scan")
    q = qs.shape[0]
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_i
    d_sorted = torch.empty_like(out_d)
    i_sorted = torch.empty_like(out_i)
    with torch.cuda.device(dev):
        rc = _kernel()(
            data.data_ptr(), _DTYPE_CODES[data.dtype], n_rows, d_pad, d_stream,
            norms_sq.data_ptr(), qs.data_ptr(), d_stream, s_s.data_ptr(),
            e_s.data_ptr(), q, k, int(metric == METRIC_L2), n_rows,
            d_sorted.data_ptr(), i_sorted.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scan_topk launch failed (code {rc})")
    SCAN_LAUNCHES += 1
    out_d[order] = d_sorted
    out_i[order] = i_sorted
    return out_d, out_i
