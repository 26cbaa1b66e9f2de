"""Scan variant v2: insertion extraction, and a bf16 pass with an fp32 rerank.

Counterpart of the JAX package's tools/exp_scan2.py. `scan_v2` is the
wrapper of csrc/scan_v2.cu (which replaces the Pallas kernel
`_scan_kernel_v2`), on the persistent item body it shares with v3 and v3b
(csrc/scan_items.cuh, launched through tools/scan_items.py): one candidate
at a time is taken from per-128-point group minima, and a tile is left as
soon as its best no longer beats a query's k-th entry. L2 only. With
bf16=True the query and the store are rounded to bf16 and the products
accumulated in fp32 on the tensor cores, with the fp32 norms of the
unrounded store: an approximate pass whose k' candidates `rerank_fp32`
ranks again exactly.

A CPU tensor goes to the plain version `scan_v2_plain`; a CUDA tensor goes
to the kernel or raises. There is no fallback from one to the other.

    python -m rangefilteredann_tpu_torch.tools.exp_scan2 [--reps 10] [--n 200000]
        [--nq 2048] [--device cuda|cpu]

times the production scan and v2 at the card's grid shapes, fp32, then bf16
alone and bf16 with k'=32 + rerank, each held against a float64 oracle, and
logs each fp32 launch's grid (items, segments a block, CTAs an SM,
registers, spills, shared memory, ring).
"""

from __future__ import annotations

import argparse

import torch

from .. import kernels
from ..ops.scan import scan_topk
from ..ops.topk import EMPTY_ID
from ..utils.data import METRIC_L2
from . import D, GRIDS, K, log, main_args, make_harness, window_scan_plain
from . import scan_items as items

# Kernel launches since the count was last set to 0.
SCAN_V2_LAUNCHES = 0
RERANK_K = 32  # k' of the bf16 pass before the fp32 rerank


def scan_v2_plain(data, norms_sq, queries, starts, ends, k, bf16=False,
                  d_eff=None):
    """The plain version: ops/bruteforce.scan_bruteforce (L2) over the first
    d_eff columns; with bf16, on bf16-rounded store and queries with the
    fp32 norms."""
    return window_scan_plain(data, norms_sq, queries, starts, ends, k,
                             METRIC_L2, d_eff, bf16)


def scan_v2(data, norms_sq, queries, starts, ends, k, tile=512, bf16=False,
            d_eff=None, qblock=32):
    """Exact (or, with bf16, bf16-rounded) L2 k nearest within per-query
    windows. Returns (dists [Q, k] f32, ids [Q, k] int32) in the caller's
    query order, (dist, id) ascending, empty slots (+inf, EMPTY_ID)."""
    global SCAN_V2_LAUNCHES
    items.check_caps(data, k, tile, qblock, bf16=bf16)
    if data.device.type == "cpu":
        return scan_v2_plain(data, norms_sq, queries, starts, ends, k, bf16, d_eff)
    dev = data.device
    with torch.cuda.device(dev):
        out_d, out_i, plan = items.launch(
            kernels.load("scan_v2"), "scan_v2", data, norms_sq, queries, starts, ends, k,
            d_eff, tile, qblock, 1, int(bf16), torch.cuda.current_stream(dev).cuda_stream,
            dev.index or 0)
    if plan is not None:
        SCAN_V2_LAUNCHES += 1
    return out_d, out_i


def grid(data, norms_sq, queries, starts, ends, k, tile=512, bf16=False, d_eff=None,
         qblock=32):
    """The grid a CUDA call of scan_v2 takes on these inputs
    (tools/scan_items.grid). Launches nothing."""
    return items.grid(kernels.load("scan_v2"), "scan_v2", data, norms_sq, queries, starts,
                      ends, k, d_eff, tile, qblock, 1, int(bf16))


def rerank_fp32(data, norms_sq, queries, cand_ids, k):
    """Exact fp32 re-rank of per-query candidates (restores exactness after a
    bf16 scan). cand_ids [Q, K'] int32, EMPTY_ID padded. Plain torch, as the
    JAX package left it to XLA: a gather, a batched product and k rounds of
    argmin. Each round takes the first minimum by candidate position, so
    equal fp32 distances keep the bf16 pass's order, not the lowest id."""
    safe = cand_ids.long().clamp(0, data.shape[0] - 1)
    vecs = data[safe]  # [Q, K', d_pad]
    ip = torch.bmm(vecs, queries[:, :, None])[..., 0]
    dist = norms_sq[safe] - 2.0 * ip
    d = torch.where(cand_ids == EMPTY_ID, float("inf"), dist)
    ids = cand_ids
    pos = torch.arange(d.shape[1], device=d.device)[None, :]
    out_d, out_i = [], []
    for _ in range(k):
        arg = torch.argmin(d, dim=1)
        sel = pos == arg[:, None]
        out_d.append(d.min(dim=1).values)
        out_i.append(torch.where(sel, ids, EMPTY_ID).min(dim=1).values)
        d = torch.where(sel, float("inf"), d)
        ids = torch.where(sel, EMPTY_ID, ids)
    return torch.stack(out_d, 1), torch.stack(out_i, 1)


def main(argv=None):
    """The round-2/3 harness of the JAX tool on the port. Returns the
    Harness: its inputs and every run's (output, ms)."""
    args = main_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]),
                       argv)
    h = make_harness(args.n, args.nq, args.device, args.reps)
    gt = h.oracle(K)
    out, _ = h.timeit("prod scan_topk fp32", lambda: scan_topk(
        *h.args, K, METRIC_L2, d_eff=D))
    h.check(gt, out[1], "prod")

    grids = GRIDS if h.device.type == "cuda" else GRIDS[:1]
    for tile, qblock in grids:
        name = f"v2 insert fp32 QB={qblock} T={tile}"
        out, _ = h.timeit(name, lambda tile=tile, qblock=qblock: scan_v2(
            *h.args, K, tile=tile, d_eff=D, qblock=qblock))
        h.check(gt, out[1], name)
        if h.device.type == "cuda":
            g = grid(*h.args, K, tile=tile, d_eff=D, qblock=qblock)
            log(f"  grid: {items.grid_note(g, tile)}")
    # bf16 + rerank at the first grid shape
    tile, qblock = grids[0]
    name = f"v2 insert bf16 QB={qblock} T={tile}"
    out, _ = h.timeit(name, lambda: scan_v2(
        *h.args, K, tile=tile, bf16=True, d_eff=D, qblock=qblock))
    h.check(gt, out[1], name)

    def e2e():
        _, i32 = scan_v2(*h.args, RERANK_K, tile=tile, bf16=True, d_eff=D,
                         qblock=qblock)
        return rerank_fp32(h.ps.data, h.ps.norms_sq, h.qp, i32, K)

    out, _ = h.timeit(name + f" k'={RERANK_K}+rerank", e2e)
    h.check(gt, out[1], name + "+rerank")
    return h


if __name__ == "__main__":
    main()
