"""The launch path of the variants' persistent item body (csrc/scan_items.cuh).

`scan_v2` (csrc/scan_v2.cu), `scan_v3` (csrc/scan_v3.cu) and `scan_v3b`
(csrc/scan_v3b.cu) run one kernel body over (query block, tile segment)
items and differ in their extraction policy and, for v2's bf16 mode, the
product. The three sources export `<name>_config(qblock, tile, k,
metric_l2, mode, out)` and `<name>_launch(...)` with the same arguments,
`mode` being v3b's unroll (the same kernel for every value), v2's bf16
switch, or unused (v3). This module holds what their wrappers share: the
kernels' caps, shape and shared-memory layout, the ctypes binding, the
launch (midpoint sort, the segment plan of ops/scan.segment_plan, scratch,
the call) and the grid a launch takes.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import scan
from ..ops.scan import MAX_K, sorted_launch_args
from ..utils.data import METRIC_L2, METRIC_MIPS

# The kernels' caps, which check_caps holds CPU and CUDA calls to alike; the
# sources compile the same values in, and their launchers return -1 outside
# them (the launches raise on that).
SUB = 256  # tiles are multiples of it (TILE_STEP)
GROUP = 128  # points per group-minima table entry
MAX_TILE = 32 * GROUP  # one table entry per lane
MAX_SMEM = 231424  # dynamic shared memory a CTA may take
QBLOCKS = (8, 16, 32)  # queries per CTA (bf16: 16 or 32)
# csrc/scan_items.cuh's shape: 8 warps of lanes holding 8 queries x 16
# points (fp32; the bf16 product covers the same points), a ring of up to
# 4 stages.
WARPS, QT, PT = 8, 8, 16
MAX_STAGES = 4
# The items' segment rule (ops/scan.segment_plan's, in tiles of `tile` and
# blocks of `qblock`): about ITEMS_PER_SLOT items for each resident CTA (one
# an SM), never under MIN_SEG_POINTS points.
ITEMS_PER_SLOT = 16
MIN_SEG_POINTS = 4096

_configs: "dict[tuple, dict]" = {}
_bound: "dict[tuple, tuple]" = {}


def round_points(qblock: int) -> int:
    """Points one CTA round covers: 8 warps x 16 points x 256 / qblock lanes."""
    return WARPS * PT * (256 // qblock)


def stage_dims(qblock: int) -> int:
    """Dims a stage (the kernel's stage_dims): 16, or 8 at qblock 8. d_eff is
    streamed rounded up to it."""
    return 16 if qblock >= 16 else 8


def layout(tile: int, qblock: int, k: int) -> dict:
    """csrc/scan_items.cuh's shared-memory layout of a CTA, in bytes: the
    [qblock, tile] distances; the ring of point stages, up to MAX_STAGES
    deep, beside them where that is at least as deep as under the tile's
    last round's block (separate), else under it; the query stages, the
    lists, the group table and the item's control words."""
    rw = min(tile, round_points(qblock))
    dk = stage_dims(qblock)
    dist = qblock * tile * 4
    stage = rw * dk * 4
    rest = (MAX_STAGES * qblock * dk * 4 + qblock * k * 8 + qblock * (tile // GROUP) * 8
            + (3 * qblock + 4) * 4)
    beside = min(MAX_STAGES, (MAX_SMEM - dist - rest) // stage)
    under = min(MAX_STAGES, qblock * rw * 4 // stage)
    separate = beside >= 2 and beside >= under
    stages = beside if separate else under
    return {"total": dist + rest + (stages * stage if separate else 0), "stages": stages,
            "separate": int(separate)}


def smem_bytes(tile: int, qblock: int, k: int) -> int:
    """Dynamic shared memory of one item CTA (layout's total)."""
    return layout(tile, qblock, k)["total"]


def check_caps(data: torch.Tensor, k: int, tile: int, qblock: int, *,
               bf16: bool = False, unroll: int = 1, metric: str = METRIC_L2):
    """Raise ValueError outside the variant kernels' caps, on any device:
    nothing falls back."""
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the scan variants take CPU or CUDA tensors, got {data.device}")
    if metric not in (METRIC_L2, METRIC_MIPS):
        raise ValueError(metric)
    if data.dtype != torch.float32:
        raise ValueError(f"the scan variants take float32 stores, not {data.dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the scan variants take 1 <= k <= {MAX_K}, got k={k}")
    if not (SUB <= tile <= MAX_TILE and tile % SUB == 0):
        raise ValueError(f"tile must be a multiple of {SUB} up to {MAX_TILE}, got {tile}")
    if qblock not in QBLOCKS or (bf16 and qblock < 16):
        raise ValueError(f"qblock must be one of {QBLOCKS} (bf16: 16 or 32), got {qblock}")
    need = smem_bytes(tile, qblock, k)
    if need > MAX_SMEM:
        raise ValueError(f"a [{qblock}, {tile}] block with k={k} takes "
                         f"{need} bytes of shared memory, over {MAX_SMEM}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")


def bind(lib, name: str):
    """(<name>_launch, <name>_config) of a loaded library, with their ctypes
    signatures."""
    key = (id(lib), name)
    if key not in _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn, config = getattr(lib, f"{name}_launch"), getattr(lib, f"{name}_config")
        fn.argtypes = [p, ctypes.c_longlong, i, i, p, p, i, p, p, i, i, i, i, i, i, i,
                       p, p, p, p, p, i, p, p, p, p, p, p, p, i, p]
        fn.restype = i
        config.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        config.restype = i
        _bound[key] = (lib, fn, config)
    return _bound[key][1:]


def launch_config(lib, name: str, qblock: int, tile: int, k: int, metric_l2: int, mode: int,
                  device_index: int = 0) -> dict:
    """The kernel's configuration for these arguments on the current device,
    asked of the library once: CTAs resident an SM, SMs, registers and local
    (spill) bytes a thread, shared memory a CTA, lists a query, ring stages
    and whether the ring has its own space."""
    key = (id(lib), name, device_index, qblock, tile, k, metric_l2, mode)
    if key not in _configs:
        out = (ctypes.c_int * 8)()
        rc = bind(lib, name)[1](qblock, tile, k, metric_l2, mode, out)
        if rc != 0:
            raise RuntimeError(f"{name} configuration failed (code {rc})")
        per_sm, sms, regs, local, smem, lists, stages, separate = out
        _configs[key] = {"ctas_per_sm": per_sm, "sms": sms, "registers": regs,
                         "spill_bytes": local, "smem_bytes": smem, "lists": lists,
                         "stages": stages, "separate": separate, "slots": per_sm * sms}
    return _configs[key]


def plan(starts, ends, n_rows: int, slots: int, qblock: int, tile: int):
    """ops/scan.segment_plan with the items' rule (module constants)."""
    return scan.segment_plan(starts, ends, n_rows, slots, qblock=qblock, tile=tile,
                             items_per_slot=ITEMS_PER_SLOT, min_seg_points=MIN_SEG_POINTS)


def launch(lib, name, data, norms_sq, queries, starts, ends, k, d_eff, tile, qblock,
           metric_l2, mode, stream, device_index=0):
    """The kernel's launch on `lib` (the built library of csrc/<name>.cu):
    sort, plan, scratch, then the item and merge kernels on `stream`.
    Returns (dists, ids, plan) in the caller's query order, plan being
    segment_plan's (None for an empty batch, which launches nothing)."""
    dev = data.device
    n_rows, d_pad = data.shape
    order, qs, s_s, e_s, d_stream = sorted_launch_args(
        data, norms_sq, queries, starts, ends, k,
        d_pad if d_eff is None else int(d_eff), chunk=stage_dims(qblock),
        dtypes=(torch.float32,), name=name)
    q = qs.shape[0]
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_i, None
    slots = launch_config(lib, name, qblock, tile, k, metric_l2, mode, device_index)["slots"]
    if slots < 1:
        raise RuntimeError(f"{name} fits no SM at tile={tile} qblock={qblock} k={k}")
    items = plan(s_s, e_s, n_rows, slots, qblock, tile)
    tile_begin, tile_end, prefix, seg, item_code, max_items = items
    part_d = torch.empty(max_items * qblock * k, dtype=torch.float32, device=dev)
    part_i = torch.empty(max_items * qblock * k, dtype=torch.int32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    kth = torch.full((q,), float("inf"), dtype=torch.float32, device=dev)
    rc = bind(lib, name)[0](
        data.data_ptr(), n_rows, d_pad, d_stream, norms_sq.data_ptr(), qs.data_ptr(),
        d_stream, s_s.data_ptr(), e_s.data_ptr(), q, k, metric_l2, n_rows, tile, qblock, mode,
        tile_begin.data_ptr(), tile_end.data_ptr(), prefix.data_ptr(), seg.data_ptr(),
        item_code.data_ptr(), tile_begin.shape[0], counter.data_ptr(), kth.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(), order.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), slots, stream)
    if rc == -1:  # the launcher's own check of the caps, behind check_caps
        raise RuntimeError(f"{name}: the kernel refused its arguments (code -1), which "
                           f"check_caps let through: the caps here and in csrc/{name}.cu "
                           f"disagree")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (CUDA error {rc})")
    return out_d, out_i, items


def grid(lib, name, data, norms_sq, queries, starts, ends, k, d_eff, tile, qblock,
         metric_l2, mode) -> dict:
    """The grid a CUDA launch on these inputs takes, as `launch` plans it:
    launch_config's fields, items, tiles a segment and segments a block
    (max, mean). Launches nothing."""
    d = data.shape[1] if d_eff is None else int(d_eff)
    _, _, s_s, e_s, _ = sorted_launch_args(data, norms_sq, queries, starts, ends, k, d,
                                           chunk=stage_dims(qblock), dtypes=(torch.float32,),
                                           name=name)
    cfg = launch_config(lib, name, qblock, tile, k, metric_l2, mode, data.device.index or 0)
    _, _, prefix, seg, _, _ = plan(s_s, e_s, data.shape[0], cfg["slots"], qblock, tile)
    segs = torch.diff(prefix, prepend=prefix.new_zeros(1)).float()
    return dict(cfg, items=int(prefix[-1]), seg_tiles=int(seg[0]),
                segs_max=int(segs.max()), segs_mean=float(segs.mean()))


def grid_note(g: dict, tile: int) -> str:
    return (f"{g['ctas_per_sm']} CTA(s) an SM x {g['sms']} SMs = {g['slots']} resident, "
            f"{g['items']} items of {g['seg_tiles']} tiles ({g['seg_tiles'] * tile} points), "
            f"segments a block max {g['segs_max']} mean {g['segs_mean']:.2f}; "
            f"{g['registers']} registers, {g['spill_bytes']} spill bytes a thread, "
            f"{g['smem_bytes']} B shared memory a CTA, a {g['stages']}-stage ring "
            f"{'beside the tile' if g['separate'] else 'under the tile'}")
