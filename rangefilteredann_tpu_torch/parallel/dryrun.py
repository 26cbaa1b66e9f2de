"""One step of each sharded path at tiny shapes, over a mesh.

Counterpart of `__graft_entry__.dryrun_multichip` of the JAX package:

    python -c "from rangefilteredann_tpu_torch.parallel.dryrun import \\
        dryrun_multidevice; dryrun_multidevice(4)"

runs on every visible card (devices=None) or on the devices given, e.g.
devices=["cpu"] * 8. Three paths, each checked for shape: an insert-sharded
build step (beam search with visited lists, then RobustPrune, each chunk of
inserts on its device), the query-sharded graph search (also held against
the same search on one device) and the index-sharded scan (also held
against a float64 oracle).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.beam_search import batched_beam_search
from ..ops.robust_prune import robust_prune
from ..ops.topk import EMPTY_ID
from ..utils.data import make_pointset
from .sharded import (
    make_mesh,
    replicate,
    sharded_beam_search,
    sharded_scan_bruteforce,
)


def dryrun_multidevice(n_devices: int, devices=None) -> None:
    mesh = make_mesh(n_devices, devices=devices)
    dev0 = mesh.devices[0]
    rng = np.random.default_rng(0)
    n, d, r, q = 64 * n_devices, 16, 8, 8 * n_devices
    points = rng.normal(size=(n, d)).astype(np.float32)
    ps = make_pointset(points, "l2", device=dev0)
    nbrs = torch.from_numpy(rng.integers(0, n, size=(n, r)).astype(np.int32)).to(dev0)
    s2g = torch.arange(n, dtype=torch.int32, device=dev0)
    data_r, norms_r = replicate(ps.data, mesh), replicate(ps.norms_sq, mesh)
    nbrs_r, s2g_r = replicate(nbrs, mesh), replicate(s2g, mesh)

    # 1. one build step (search + prune), the inserts cut over the mesh
    inserts = torch.arange(q, dtype=torch.int32, device=dev0)
    c = q // mesh.size

    def build_step(i, dev):
        ins = inserts[i * c:(i + 1) * c].to(dev)
        data = data_r[dev]
        res = batched_beam_search(
            data, norms_r[dev], nbrs_r[dev], s2g_r[dev], data[ins.long()],
            torch.zeros_like(ins), beam=8, k=0, cut=1.0, limit=n, metric="l2",
            exclude=ins, return_visited=True, visited_cap=16)
        cand = torch.where(res.visited_ids == EMPTY_ID, -1, res.visited_ids)
        return robust_prune(data, norms_r[dev], s2g_r[dev], ins, cand, 1.2, R=r,
                            metric="l2")

    out_ids = torch.cat([build_step(i, dev)[0].to(dev0)
                         for i, dev in enumerate(mesh.devices)])
    assert out_ids.shape == (q, r), out_ids.shape

    # 2. query-sharded graph search, the index replicated
    queries = np.zeros((q, ps.d_pad), dtype=np.float32)
    queries[:, :d] = rng.normal(size=(q, d))
    q_dev = torch.from_numpy(queries).to(dev0)
    q_norms = torch.from_numpy(np.einsum("qd,qd->q", queries, queries)).to(dev0)
    common = dict(beam=8, k=5, cut=1.35, limit=n, metric="l2", q_norms_sq=q_norms)
    res = sharded_beam_search(mesh, data_r, norms_r, nbrs_r, s2g_r, q_dev,
                              torch.zeros(q, dtype=torch.int32, device=dev0), **common)
    assert res.frontier_ids.shape == (q, 8), res.frontier_ids.shape
    one = batched_beam_search(ps.data, ps.norms_sq, nbrs, s2g, q_dev,
                              torch.zeros(q, dtype=torch.int32, device=dev0), **common)
    assert torch.equal(res.frontier_ids, one.frontier_ids), "query-sharded search differs"

    # 3. index-sharded scan, partial lists merged on the first device
    starts = np.zeros(q, dtype=np.int32)
    ends = np.full(q, n, dtype=np.int32)
    d_out, i_out = sharded_scan_bruteforce(mesh, ps.data, ps.norms_sq, q_dev,
                                           starts, ends, 5, "l2", d_eff=ps.norm_col)
    assert d_out.shape == (q, 5) and i_out.shape == (q, 5)
    gt = np.argsort(((points[None].astype(np.float64)
                      - queries[:, None, :d].astype(np.float64)) ** 2).sum(-1), axis=1)[:, :5]
    got = i_out.cpu().numpy()
    assert all(set(got[i]) == set(gt[i]) for i in range(q)), "sharded scan mismatch"
