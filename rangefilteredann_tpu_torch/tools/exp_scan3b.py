"""Scan variant v3b: batched extraction in a single loop; the nested-loop probe.

Counterpart of the JAX package's tools/exp_scan3b.py. `scan_v3b` is the
wrapper of csrc/scan_v3b.cu (which replaces the Pallas kernel
`_scan_kernel_v3b`): a persistent grid of (query block, tile segment)
items, a register-tiled fp32 product, and per round `unroll` insert steps
against a per-128-point group-minima table, then one pass that retires the
inserted heads and drops the dead ones; a merge kernel joins the items'
lists. L2 and MIPS, fp32. `probe_sum` is the wrapper of the same file's
probe kernel (which replaces the kernel of the JAX `probe_nested_while`):
x summed in a 3 x 2 nested loop; `probe_nested_while` runs it as the JAX
tool does.

A CPU tensor goes to the plain version (`scan_v3b_plain`,
`probe_nested_while_plain`); a CUDA tensor goes to the kernel or raises.
There is no fallback from one to the other.

    python -m rangefilteredann_tpu_torch.tools.exp_scan3b [--reps 10] [--n 200000]
        [--nq 2048] [--dups] [--skip-probe] [--device cuda|cpu]

runs the probe, then times the production scan and v3b at the card's grid
shapes and unroll counts, compares their ids and distances, and logs each
v3b launch's grid (items, segments a block, CTAs an SM, registers, spills,
shared memory, ring).
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from .. import kernels
from ..ops.scan import scan_topk, sorted_launch_args
from ..utils.data import METRIC_L2, resolve_device
from . import (D, GRIDS, GROUP, K, MAX_SMEM, check_caps, main_args, log, make_harness,
               window_scan_plain)

# Kernel launches since the count was last set to 0.
SCAN_V3B_LAUNCHES = 0
PROBE_LAUNCHES = 0

# (tile, qblock, unroll) cases main() runs on the card; the first on the CPU
CASES = ((GRIDS[0][0], GRIDS[0][1], 4), (GRIDS[0][0], GRIDS[0][1], 2),
         (GRIDS[0][0], GRIDS[0][1], 8), (GRIDS[1][0], GRIDS[1][1], 4))

# csrc/scan_v3b.cu's shape: 8 warps of lanes holding 8 queries x 16 points,
# a ring of up to 4 stages, at most 32 segments a block.
WARPS, QT, PT = 8, 8, 16
MAX_STAGES = 4
MAX_SEGS = 32
# The segment rule (ops/scan.segment_plan's, in tiles of `tile`): about
# ITEMS_PER_SLOT items for each resident CTA, never under MIN_SEG_POINTS
# points (an item's list set-up, pipeline fill and write-out stay a few
# percent of its product), and at most MAX_SEGS segments a block.
ITEMS_PER_SLOT = 16
MIN_SEG_POINTS = 4096

_configs: "dict[tuple, dict]" = {}
_bound: "dict[int, tuple]" = {}
_probe_fn = None


def round_points(qblock: int) -> int:
    """Points one CTA round covers: 8 warps x 16 points x 256 / qblock lanes."""
    return WARPS * PT * (256 // qblock)


def stage_dims(qblock: int) -> int:
    """Dims a stage (the kernel's stage_dims): 16, or 8 at qblock 8. d_eff is
    streamed rounded up to it."""
    return 16 if qblock >= 16 else 8


def layout(tile: int, qblock: int, k: int) -> dict:
    """csrc/scan_v3b.cu's shared-memory layout of a CTA, in bytes: the
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
    """Dynamic shared memory of one v3b CTA (layout's total)."""
    return layout(tile, qblock, k)["total"]


def segment_plan(starts, ends, n_real: int, slots: int, qblock: int, tile: int):
    """Cut each block's union of windows into segments of whole tiles, and
    order the items so that those reading the same rows run together: the
    counterpart of ops/scan.segment_plan in blocks of `qblock` queries and
    tiles of `tile` points.

    starts/ends: [Q] int32 midpoint-sorted windows, on the device. Torch ops
    only, so nothing waits for the device. Segments lie on one grid of `seg`
    tiles over the store, a block's first and last clipped to its union;
    the items are handed out by grid segment, then block. The segment length
    is the largest of ceil(MIN_SEG_POINTS / tile), the share that gives about
    ITEMS_PER_SLOT items to each of `slots` resident CTAs, and the length
    that keeps every block within MAX_SEGS segments.

    Returns (tile_begin, tile_end, prefix, seg, item_code, max_items):
    tile_begin/tile_end [n_blocks] int32 the tiles of each block's union (0,
    0 for a block of empty windows); prefix [n_blocks] int32 the inclusive
    sum of segments a block; seg [1] int32 tiles a segment; item_code
    [n_blocks * MAX_SEGS] int32, the items in the order they are handed out,
    each block * MAX_SEGS + its segment (entries past prefix[-1] unused);
    max_items a host bound on prefix[-1]."""
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
    cap = ITEMS_PER_SLOT * slots
    seg = torch.maximum((tiles.sum() + cap - 1) // cap,
                        (tiles.max() + MAX_SEGS - 2) // (MAX_SEGS - 1)).clamp(
                            min=-(-MIN_SEG_POINTS // tile))
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


def bind(lib):
    """(scan_v3b_launch, scan_v3b_config) of a loaded library, with their
    ctypes signatures."""
    key = id(lib)
    if key not in _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn, config = lib.scan_v3b_launch, lib.scan_v3b_config
        fn.argtypes = [p, ctypes.c_longlong, i, i, p, p, i, p, p, i, i, i, i, i, i, i,
                       p, p, p, p, p, i, p, p, p, p, p, p, p, i, p]
        fn.restype = i
        config.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        config.restype = i
        _bound[key] = (lib, fn, config)
    return _bound[key][1:]


def launch_config(lib, qblock: int, tile: int, k: int, metric: str,
                  device_index: int = 0) -> dict:
    """The kernel's configuration for (qblock, tile, k, metric) on the
    current device, asked of the library once: CTAs resident an SM, SMs,
    registers and local (spill) bytes a thread, shared memory a CTA, lists
    a query, ring stages and whether the ring has its own space."""
    key = (id(lib), device_index, qblock, tile, k, metric)
    if key not in _configs:
        out = (ctypes.c_int * 8)()
        rc = bind(lib)[1](qblock, tile, k, int(metric == METRIC_L2), out)
        if rc != 0:
            raise RuntimeError(f"scan_v3b configuration failed (code {rc})")
        per_sm, sms, regs, local, smem, lists, stages, separate = out
        _configs[key] = {"ctas_per_sm": per_sm, "sms": sms, "registers": regs,
                         "spill_bytes": local, "smem_bytes": smem, "lists": lists,
                         "stages": stages, "separate": separate, "slots": per_sm * sms}
    return _configs[key]


def launch(lib, data, norms_sq, queries, starts, ends, k, metric, d_eff, tile, qblock,
           unroll, stream, device_index=0):
    """The kernel's launch on `lib` (the built library): sort, plan,
    scratch, then the item and merge kernels on `stream`. Returns (dists,
    ids, plan) in the caller's query order, plan being segment_plan's (None
    for an empty batch, which launches nothing)."""
    dev = data.device
    n_rows, d_pad = data.shape
    order, qs, s_s, e_s, d_stream = sorted_launch_args(
        data, norms_sq, queries, starts, ends, k,
        d_pad if d_eff is None else int(d_eff), chunk=stage_dims(qblock),
        dtypes=(torch.float32,), name="scan_v3b")
    q = qs.shape[0]
    out_d = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_d, out_i, None
    slots = launch_config(lib, qblock, tile, k, metric, device_index)["slots"]
    if slots < 1:
        raise RuntimeError(f"scan_v3b fits no SM at tile={tile} qblock={qblock} k={k}")
    plan = segment_plan(s_s, e_s, n_rows, slots, qblock, tile)
    tile_begin, tile_end, prefix, seg, item_code, max_items = plan
    part_d = torch.empty(max_items * qblock * k, dtype=torch.float32, device=dev)
    part_i = torch.empty(max_items * qblock * k, dtype=torch.int32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    kth = torch.full((q,), float("inf"), dtype=torch.float32, device=dev)
    rc = bind(lib)[0](
        data.data_ptr(), n_rows, d_pad, d_stream, norms_sq.data_ptr(), qs.data_ptr(),
        d_stream, s_s.data_ptr(), e_s.data_ptr(), q, k, int(metric == METRIC_L2), n_rows,
        tile, qblock, unroll, tile_begin.data_ptr(), tile_end.data_ptr(), prefix.data_ptr(),
        seg.data_ptr(), item_code.data_ptr(), tile_begin.shape[0], counter.data_ptr(),
        kth.data_ptr(), part_d.data_ptr(), part_i.data_ptr(), order.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), slots, stream)
    if rc == -1:  # the launcher's own check of the caps, behind check_caps
        raise RuntimeError("scan_v3b: the kernel refused its arguments (code -1), which "
                           "check_caps let through: the caps here and in "
                           "csrc/scan_v3b.cu disagree")
    if rc != 0:
        raise RuntimeError(f"scan_v3b launch failed (CUDA error {rc})")
    return out_d, out_i, plan


def scan_v3b_plain(data, norms_sq, queries, starts, ends, k, metric="l2",
                   d_eff=None):
    """The plain version: ops/bruteforce.scan_bruteforce over the first
    d_eff columns."""
    return window_scan_plain(data, norms_sq, queries, starts, ends, k, metric,
                             d_eff)


def scan_v3b(data, norms_sq, queries, starts, ends, k, metric="l2", tile=1024,
             d_eff=None, qblock=32, unroll=4):
    """Exact k nearest within per-query windows. Returns (dists [Q, k] f32,
    ids [Q, k] int32) in the caller's query order, (dist, id) ascending,
    empty slots (+inf, EMPTY_ID), L2 shifted (no ||q||^2)."""
    global SCAN_V3B_LAUNCHES
    check_caps(data, k, tile, qblock, unroll=unroll, metric=metric, smem=smem_bytes)
    if data.device.type == "cpu":
        return scan_v3b_plain(data, norms_sq, queries, starts, ends, k, metric, d_eff)
    dev = data.device
    with torch.cuda.device(dev):
        out_d, out_i, plan = launch(
            kernels.load("scan_v3b"), data, norms_sq, queries, starts, ends, k, metric,
            d_eff, tile, qblock, unroll, torch.cuda.current_stream(dev).cuda_stream,
            dev.index or 0)
    if plan is not None:
        SCAN_V3B_LAUNCHES += 1
    return out_d, out_i


def grid(data, norms_sq, queries, starts, ends, k, metric="l2", tile=1024, d_eff=None,
         qblock=32):
    """The grid a CUDA call of scan_v3b takes on these inputs, as its wrapper
    plans it: launch_config's fields, items, tiles a segment and segments a
    block (max, mean). Launches nothing."""
    d = data.shape[1] if d_eff is None else int(d_eff)
    _, _, s_s, e_s, _ = sorted_launch_args(data, norms_sq, queries, starts, ends, k, d,
                                           chunk=stage_dims(qblock), dtypes=(torch.float32,),
                                           name="scan_v3b")
    cfg = launch_config(kernels.load("scan_v3b"), qblock, tile, k, metric,
                        data.device.index or 0)
    _, _, prefix, seg, _, _ = segment_plan(s_s, e_s, data.shape[0], cfg["slots"], qblock, tile)
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


def probe_nested_while_plain(x):
    """x summed in a 3 x 2 nested loop, in the kernel's order."""
    acc = torch.zeros_like(x)
    for _ in range(3):
        for _ in range(2):
            acc = acc + x
    return acc


def _probe_kernel():
    global _probe_fn
    if _probe_fn is None:
        fn = kernels.load("scan_v3b").probe_nested_while_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _probe_fn = fn
    return _probe_fn


def probe_sum(x):
    """The probe kernel's wrapper: x [..] float32 summed in a 3 x 2 nested
    loop. A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    global PROBE_LAUNCHES
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the probe takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return probe_nested_while_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"the probe takes CPU or CUDA tensors, got {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _probe_kernel()(x.data_ptr(), out.data_ptr(), x.numel(),
                             torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_nested_while launch failed (code {rc})")
    PROBE_LAUNCHES += 1
    return out


def probe_nested_while(device=None):
    """The JAX tool's probe: an [8, 128] tensor of ones on `device` (None =
    the card) through `probe_sum`. Returns the output and logs its sum."""
    x = torch.ones((8, 128), dtype=torch.float32, device=resolve_device(device))
    out = probe_sum(x)
    log(f"nested-while probe: OK (sum={float(out.sum())})")
    return out


def main(argv=None):
    """exp_scan3b's harness on the port. Returns the Harness: its inputs and
    every run's (output, ms)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dups", action="store_true")
    ap.add_argument("--skip-probe", action="store_true")
    args = main_args(ap, argv)
    if not args.skip_probe:
        probe_nested_while(args.device)
    h = make_harness(args.n, args.nq, args.device, args.reps, dups=args.dups,
                     degenerate=True)
    prod, _ = h.timeit("prod", lambda: scan_topk(*h.args, K, METRIC_L2, d_eff=D))
    cases = CASES if h.device.type == "cuda" else CASES[:1]
    for tile, qblock, unroll in cases:
        name = f"v3b T={tile} QB={qblock} U={unroll}"
        out, _ = h.timeit(name, lambda tile=tile, qblock=qblock, unroll=unroll: scan_v3b(
            *h.args, K, tile=tile, d_eff=D, qblock=qblock, unroll=unroll))
        h.vs_prod(prod, out, name)
        if h.device.type == "cuda":
            log(f"  grid: {grid_note(grid(*h.args, K, tile=tile, d_eff=D, qblock=qblock), tile)}")
    return h


if __name__ == "__main__":
    main()
