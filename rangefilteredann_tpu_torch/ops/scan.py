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
from ..utils.trace import span
from .bruteforce import scan_bruteforce

# Kernel launches since the count was last set to 0 (launches only, never
# calls that took the plain version).
SCAN_LAUNCHES = 0

MAX_K = 256  # csrc/scan_common.cuh MAX_K
CHUNK = 16  # dims per staged chunk (csrc/scan_topk.cu DK)
QB = 32  # queries per block (csrc/scan_topk.cu QB)
TILE = 256  # points per tile (csrc/scan_topk.cu TILE)
MAX_SEGS = 32  # segments per block at most (csrc/scan_common.cuh MAX_SEGS)
# The segment rule of this kernel: about ITEMS_PER_SLOT items for each
# resident CTA, so that the last items end close together, and never under
# MIN_SEG_POINTS points (an item's list set-up, pipeline fill and write-out
# stay a few percent of its product).
ITEMS_PER_SLOT = 8
MIN_SEG_POINTS = 4096
_DTYPE_CODES = {torch.float32: 0, torch.int8: 1, torch.uint8: 2}

_bound: "dict[int, tuple]" = {}
_configs: "dict[tuple, tuple]" = {}


def bind(lib):
    """(scan_topk_launch, scan_topk_config) of a loaded library, with their
    ctypes signatures."""
    key = id(lib)
    if key not in _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        launch, config = lib.scan_topk_launch, lib.scan_topk_config
        launch.argtypes = [p, i, ctypes.c_longlong, i, i, p, p, i, p, p, i, i, i, i,
                           p, p, p, p, p, i, p, p, p, p, p, p, p, i, p]
        launch.restype = i
        config.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        config.restype = i
        _bound[key] = (lib, launch, config)
    return _bound[key][1:]


def launch_config(lib, dtype_code: int, metric: str, k: int, device_index: int = 0) -> dict:
    """The kernel's configuration for (dtype, metric, k) on the current
    device, asked of the library once: CTAs resident an SM, SMs, registers
    and local (spill) bytes a thread, shared memory a CTA, lists a query."""
    key = (id(lib), device_index, dtype_code, metric, k)
    if key not in _configs:
        out = (ctypes.c_int * 6)()
        rc = bind(lib)[1](dtype_code, int(metric == METRIC_L2), k, out)
        if rc != 0:
            raise RuntimeError(f"scan_topk configuration failed (code {rc})")
        _configs[key] = tuple(out)
    per_sm, sms, regs, local, smem, lists = _configs[key]
    return {"ctas_per_sm": per_sm, "sms": sms, "registers": regs, "spill_bytes": local,
            "smem_bytes": smem, "lists": lists, "slots": per_sm * sms}


def segment_plan(starts, ends, n_real: int, slots: int, *, qblock: int = QB,
                 tile: int = TILE, items_per_slot: int = ITEMS_PER_SLOT,
                 min_seg_points: int = MIN_SEG_POINTS):
    """Cut each block's union of windows into segments of whole tiles, and
    order the items so that those reading the same rows run together. The
    plan of every persistent scan kernel: this module's (the defaults) and
    the variants' item body (tools/scan_items.py).

    starts/ends: [Q] int32 midpoint-sorted windows, on the device; blocks
    are `qblock` consecutive queries, tiles `tile` points. Torch ops only,
    so nothing waits for the device. Segments lie on one grid of `seg` tiles
    over the whole store, a block's first and last clipped to its union, so
    every block covering a grid segment reads the same rows; the items are
    handed out by grid segment, then block. The segment length is the
    largest of ceil(min_seg_points / tile), the share that gives about
    items_per_slot items to each of `slots` resident CTAs, and the length
    that keeps every block within MAX_SEGS segments.

    Returns (tile_begin, tile_end, prefix, seg, item_code, max_items):
    tile_begin/tile_end [n_blocks] int32 the tiles of each block's union (0,
    0 for a block of empty windows); prefix [n_blocks] int32 the inclusive
    sum of segments per block (an item's scratch slot is its block's
    exclusive prefix plus its segment); seg [1] int32 tiles per segment;
    item_code [n_blocks * MAX_SEGS] int32, the items in the order they are
    handed out, each block * MAX_SEGS + its segment (entries past
    prefix[-1] are unused); max_items a host bound on prefix[-1]."""
    q = starts.shape[0]
    n_blocks = -(-q // qblock)
    pad = n_blocks * qblock - q
    s = starts.to(torch.int64).clamp(min=0)
    e = ends.to(torch.int64).clamp(max=n_real)
    if pad:
        zeros = torch.zeros(pad, dtype=torch.int64, device=s.device)
        s, e = torch.cat([s, zeros]), torch.cat([e, zeros])
    nonempty = (e > s).view(n_blocks, qblock)
    lo = torch.where(nonempty, s.view(n_blocks, qblock), n_real).amin(1)
    hi = torch.where(nonempty, e.view(n_blocks, qblock), 0).amax(1)
    has = nonempty.any(1)
    tile_begin = torch.where(has, lo // tile, 0)
    tile_end = torch.where(has, (hi + tile - 1) // tile, 0)
    tiles = tile_end - tile_begin
    cap = items_per_slot * slots
    seg = torch.maximum((tiles.sum() + cap - 1) // cap,
                        (tiles.max() + MAX_SEGS - 2) // (MAX_SEGS - 1)).clamp(
                            min=-(-min_seg_points // tile))
    # a block's grid segments: at most ceil(tiles / seg) + 1 <= MAX_SEGS, so
    # items <= sum(tiles) / seg + 2 n_blocks <= cap + 2 n_blocks
    first = tile_begin // seg
    segs = torch.where(has, (tile_end + seg - 1) // seg - first, 0)
    prefix = torch.cumsum(segs, 0)
    slot = torch.arange(MAX_SEGS, device=s.device)
    block = torch.arange(n_blocks, device=s.device)[:, None]
    key = torch.where(slot < segs[:, None], (first[:, None] + slot) * n_blocks + block,
                      torch.iinfo(torch.int64).max)
    item_code = torch.argsort(key.flatten(), stable=True)
    return (tile_begin.to(torch.int32), tile_end.to(torch.int32), prefix.to(torch.int32),
            seg.view(1).to(torch.int32), item_code.to(torch.int32), cap + 2 * n_blocks)


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


def launch(lib, data, norms_sq, queries, starts, ends, k, metric, d_eff, stream,
           device_index=0):
    """The kernel's launch on `lib` (the built library): sort, plan, scratch,
    then the scan and merge kernels on `stream`. Returns (dists, ids, plan),
    plan being segment_plan's."""
    dev = data.device
    n_rows, d_pad = data.shape
    with span("scan.plan"):
        order, qs, s_s, e_s, d_stream = sorted_launch_args(
            data, norms_sq, queries, starts, ends, k, d_eff, chunk=CHUNK,
            dtypes=_DTYPE_CODES, name="scan")
        q = qs.shape[0]
        out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
        if q == 0:
            return out_d, out_i, None
        code = _DTYPE_CODES[data.dtype]
        slots = launch_config(lib, code, metric, k, device_index)["slots"]
        if slots < 1:
            raise RuntimeError(f"the scan kernel fits no SM at k={k}")
        plan = segment_plan(s_s, e_s, n_rows, slots)
        tile_begin, tile_end, prefix, seg, item_code, max_items = plan
        part_d = torch.empty(max_items * QB * k, dtype=torch.float32, device=dev)
        part_i = torch.empty(max_items * QB * k, dtype=torch.int32, device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        kth = torch.full((q,), float("inf"), dtype=torch.float32, device=dev)
    with span("scan.kernel"):
        rc = bind(lib)[0](
            data.data_ptr(), code, n_rows, d_pad, d_stream, norms_sq.data_ptr(),
            qs.data_ptr(), d_stream, s_s.data_ptr(), e_s.data_ptr(), q, k,
            int(metric == METRIC_L2), n_rows, tile_begin.data_ptr(), tile_end.data_ptr(),
            prefix.data_ptr(), seg.data_ptr(), item_code.data_ptr(), tile_begin.shape[0],
            counter.data_ptr(), kth.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), order.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), slots, stream)
    if rc != 0:
        raise RuntimeError(f"scan_topk launch failed (code {rc})")
    return out_d, out_i, plan


def _scan_cuda(data, norms_sq, queries, starts, ends, k, metric, d_eff):
    global SCAN_LAUNCHES
    dev = data.device
    with torch.cuda.device(dev):
        out_d, out_i, plan = launch(
            kernels.load("scan_topk"), data, norms_sq, queries, starts, ends, k, metric,
            d_eff, torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    if plan is not None:
        SCAN_LAUNCHES += 1
    return out_d, out_i
