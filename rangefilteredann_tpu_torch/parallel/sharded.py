"""Scale-out over several devices, driven by one Python process.

Counterpart of rangefilteredann_tpu/parallel/sharded.py, which runs SPMD
over a jax.sharding.Mesh. Here a `Mesh` is an ordered list of torch devices
and the controller runs each shard's work on its device, as FAISS's
IndexShards and IndexReplicas do; no process group is involved, so
`index.shard(mesh)` followed by `batch_search` from one caller works as in
the JAX package. A mesh may name one device several times: those shards
are logical (the CPU tests use ["cpu"] * 8, one card can hold four), and
`tensor.to(device)` of a tensor already there is the tensor itself, so their
replicas share storage.

  * **Query sharding**: the index is replicated (one copy per distinct
    device) and the batch is cut into mesh.size contiguous chunks
    (`sharded_beam_search`).
  * **Index-row sharding of the exact scan**: each shard scans its rows of
    the label-sorted store with ops/scan.scan_topk (the scan kernel on the
    card), and the partial top-k lists are merged on the first device in
    (dist, id) order (`sharded_scan_bruteforce`).
  * **Bucket-sharded tree rows**: whole buckets are bin-packed onto the
    shards and each query searches on the shard owning its bucket
    (`shard_graph_row`, `sharded_bucket_search`). `sharded_row_search`
    gives such a row the result of one unsharded search, so the models'
    doubling_postfilter and single-shot searches run over it as they run
    over a SlabGraph (the JAX package keeps a second, sequential copy of
    the doubling schedule for these rows instead).

The graph searches take the plain batched_beam_search on every shard, as
the JAX package's mesh paths take its plain search, one shard after
another. That search is paced by the host (it waits for its device every
few steps to test for its end), so its shards do not overlap across
cards; a thread a card made it slower still on four H100s, the threads
contending for the interpreter (PERF.md §5, scale-out). The scan waits for
nothing, so its launches on distinct cards overlap. Results come back to
the first device by `Tensor.to`, which orders the copy after the work of
the source device's current stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.beam_search import BeamResult, batched_beam_search
from ..ops.scan import scan_topk
from ..ops.topk import EMPTY_ID, masked_topk


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices, one a shard. Devices may repeat
    (logical shards on one device)."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (a list that may repeat a device), or over
    every visible CUDA card when none is given; raises where there is no
    card. `n_devices` keeps the first n."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=[...] (e.g. ['cpu'] * 8)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"make_mesh: {n_devices} devices asked, {len(devs)} given")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(devs)


def replicate(x: torch.Tensor, mesh: Mesh) -> dict:
    """{device: x on that device} over the mesh's distinct devices."""
    return {dev: x.to(dev) for dev in mesh.distinct}


def _on(x, dev):
    """x's copy on `dev`: from a replica dict, or copied (a no-op when x
    already lies there)."""
    if isinstance(x, dict):
        return x[dev]
    return None if x is None else x.to(dev)


def replicate_index(ps, graphs, mesh: Mesh) -> None:
    """Replicate an index's point store and slab graphs over the mesh's
    distinct devices (in place: `ps.replicas`, `g.replicas`). Shared by
    every index class's shard(). Inline neighbour blocks are dropped, not
    replicated: the mesh routes take the plain search, as in the JAX
    package."""
    if mesh.devices[0] != ps.device:
        raise ValueError(f"the mesh's first device ({mesh.devices[0]}) must hold "
                         f"the index ({ps.device})")
    ps.replicas = (replicate(ps.data, mesh), replicate(ps.norms_sq, mesh))
    for g in graphs:
        if g is not None:
            g.ensure_device(ps.device)  # an evicted row uploads first
            g.nbr_vecs = g.nbr_norms = g.nbr_scale = None
            g.replicas = (replicate(g.nbrs_dev, mesh),
                          replicate(g.slab_to_global_dev, mesh))


def sharded_beam_search(
    mesh: Mesh,
    data, norms_sq, nbrs, slab_to_global,  # tensors, or replicate() dicts
    queries: torch.Tensor, starts: torch.Tensor,
    *, beam: int, k: int, cut, limit, metric: str,
    q_norms_sq=None, active_in=None, exclude=None, **kw,
) -> BeamResult:
    """Query-sharded batched beam search: the batch cut into mesh.size
    contiguous chunks of ceil(Q / size) queries, each searched by the plain
    batched_beam_search on its shard's device over that device's replica;
    the results are concatenated on mesh.devices[0]. The per-query
    arguments are cut with the batch; `kw` goes to batched_beam_search.
    The search is per query, so the result is the unsharded search's."""
    q = queries.shape[0]
    c = max(1, -(-q // mesh.size))
    parts = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * c, min(q, (i + 1) * c)
        if hi <= lo and i:  # an empty batch still searches once
            continue
        part = (lambda t: None if t is None else t[lo:hi].to(dev))
        parts.append(batched_beam_search(
            _on(data, dev), _on(norms_sq, dev), _on(nbrs, dev),
            _on(slab_to_global, dev), part(queries), part(starts),
            beam=beam, k=k, cut=cut, limit=limit, metric=metric,
            q_norms_sq=part(q_norms_sq), active_in=part(active_in),
            exclude=part(exclude), **kw))
    dev0 = mesh.devices[0]
    return BeamResult(*(torch.cat([t.to(dev0) for t in ts])
                        for ts in zip(*parts)))


def shard_rows(mesh: Mesh, data: torch.Tensor, norms_sq: torch.Tensor):
    """Contiguous equal row shards of a store: (data shards, norm shards),
    shard i on mesh.devices[i]. The rows must be a multiple of the mesh
    size (pad with rows whose ids fall outside every window)."""
    n = data.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split into {mesh.size} equal shards")
    nl = n // mesh.size
    return (tuple(data[i * nl:(i + 1) * nl].to(dev) for i, dev in enumerate(mesh.devices)),
            tuple(norms_sq[i * nl:(i + 1) * nl].to(dev)
                  for i, dev in enumerate(mesh.devices)))


def sharded_scan_bruteforce(
    mesh: Mesh, data, norms_sq, queries, starts, ends, k: int, metric: str,
    d_eff: Optional[int] = None,
):
    """Index-sharded exact range scan: each shard clips the windows to its
    rows, runs ops/scan.scan_topk there (the scan kernel on the card, its
    plain version on the CPU) and adds its row base to the ids; the
    partial lists meet on mesh.devices[0] and merge by (dist, id).

    `data`/`norms_sq`: the store (rows a multiple of the mesh size), or the
    shards of shard_rows(). `d_eff` as for scan_topk. Returns (dists [Q, k],
    ids [Q, k] int32), empty slots (+inf, EMPTY_ID)."""
    if isinstance(data, torch.Tensor):
        data, norms_sq = shard_rows(mesh, data, norms_sq)
    nl = data[0].shape[0]
    dev0 = mesh.devices[0]
    queries = torch.as_tensor(queries)
    starts = torch.as_tensor(starts).to(torch.int64)
    ends = torch.as_tensor(ends).to(torch.int64)
    part_d, part_i = [], []
    for i, dev in enumerate(mesh.devices):
        base = i * nl
        # the scan waits for nothing on the host: the shards' launches
        # are all enqueued before the first copy back
        s = (starts.to(dev) - base).clamp(0, nl).to(torch.int32)
        e = (ends.to(dev) - base).clamp(0, nl).to(torch.int32)
        d, ids = scan_topk(data[i], norms_sq[i], queries.to(dev), s, e, k=k,
                           metric=metric, d_eff=d_eff)
        part_d.append(d)
        part_i.append(torch.where(ids == EMPTY_ID, EMPTY_ID, ids + base))
    return masked_topk(torch.cat([t.to(dev0) for t in part_d], dim=1),
                       torch.cat([t.to(dev0) for t in part_i], dim=1), k)


class ShardedGraphRow:
    """One slab row bucket-sharded over a mesh. A bucket's adjacency stays
    inside the bucket, so a shard is a set of whole buckets with its own
    point rows, norms and shard-local adjacency, and a search needs nothing
    of another shard. Built by `shard_graph_row`; searched by
    `sharded_row_search`, which the models' searches take for it in place
    of a SlabGraph."""

    nbr_scale = None  # no inline blocks: the shards take the plain search

    def __init__(self, mesh, points_sh, norms_sh, nbrs_sh, local_to_slab,
                 local_to_global, bucket_device, bucket_local_start, ms,
                 slab_offsets, slab_to_global_dev):
        self.mesh = mesh
        self.points_sh = points_sh  # per shard [ms, d_pad], on its device
        self.norms_sh = norms_sh  # per shard [ms]
        self.nbrs_sh = nbrs_sh  # per shard [ms, R] shard-local ids
        self.local_to_slab = local_to_slab  # [D, ms] host: -> the row's slab ids
        self.local_to_global = local_to_global  # [D, ms] host: -> global ids
        self.bucket_device = bucket_device  # [nb] host
        self.bucket_local_start = bucket_local_start  # [nb] host
        self.ms = ms  # slab rows a shard (padded equal)
        self.slab_offsets = slab_offsets  # [nb + 1] host: the row's bucket starts
        self.slab_to_global_dev = slab_to_global_dev  # [m] on the store's device

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def R(self) -> int:
        return self.nbrs_sh[0].shape[1]


def _bin_pack(graph, n_devices: int):
    """The greedy bin-pack of the JAX package, step for step: biggest
    bucket first (stable), onto the first least-loaded device. Returns
    (bucket_device [nb], ms): ms the rows a device, padded to 8."""
    off = np.asarray(graph.bucket_slab_offsets, dtype=np.int64)
    sizes = np.diff(off)
    load = np.zeros(n_devices, dtype=np.int64)
    bucket_device = np.zeros(len(sizes), dtype=np.int64)
    for b in np.argsort(-sizes, kind="stable"):
        d = int(np.argmin(load))
        bucket_device[b] = d
        load[d] += sizes[b]
    return bucket_device, int(-(-load.max() // 8) * 8)


def shard_plan_rows_per_device(graph, n_devices: int) -> int:
    """The rows a device (ms) that shard_graph_row would give this row,
    without building the shards. Budget planners size per-device bytes
    from it: every device pads to ms >= m / D, and bucket skew can push ms
    well above m / D."""
    return _bin_pack(graph, n_devices)[1]


def shard_graph_row(ps, graph, mesh: Mesh) -> ShardedGraphRow:
    """Bucket-shard a SlabGraph row: whole buckets bin-packed onto the
    shards; each shard lays its buckets out contiguously with a monotone
    id shift, which keeps the (dist, id) order of ties inside a bucket, so
    sharded results equal the unsharded ones. The point rows are gathered
    on the store's device and copied to their shards."""
    D = mesh.size
    off = np.asarray(graph.bucket_slab_offsets, dtype=np.int64)
    nb = len(off) - 1
    bucket_device, ms = _bin_pack(graph, D)
    nbrs = np.full((D, ms, graph.R), -1, dtype=np.int32)
    l2s = np.full((D, ms), -1, dtype=np.int64)
    bucket_local_start = np.zeros(nb, dtype=np.int64)
    s2g = graph.slab_to_global_host
    fill = np.zeros(D, dtype=np.int64)
    for b in range(nb):
        d = int(bucket_device[b])
        lo, hi = int(off[b]), int(off[b + 1])
        start = int(fill[d])
        bucket_local_start[b] = start
        l2s[d, start:start + hi - lo] = np.arange(lo, hi)
        rows = graph.nbrs_host[lo:hi]
        # slab ids -> shard-local: a monotone shift inside the bucket
        nbrs[d, start:start + hi - lo] = np.where(rows >= 0, rows - lo + start, -1)
        fill[d] += hi - lo
    l2g = np.where(l2s >= 0, s2g[l2s.clip(min=0)], -1).astype(np.int64)
    pts, nrm, adj = [], [], []
    for d, dev in enumerate(mesh.devices):
        gid = torch.from_numpy(l2g[d]).to(ps.device)
        real = gid >= 0
        safe = gid.clamp(min=0)
        pts.append(torch.where(real[:, None], ps.data[safe], 0).to(dev))
        nrm.append(torch.where(real, ps.norms_sq[safe], 0.0).to(dev))
        adj.append(torch.from_numpy(nbrs[d]).to(dev))
    return ShardedGraphRow(
        mesh, pts, nrm, adj, l2s, l2g, bucket_device, bucket_local_start, ms, off,
        torch.from_numpy(s2g.astype(np.int32)).to(ps.device))


def _placement(row: ShardedGraphRow, buckets: np.ndarray):
    """The queries of each shard, in batch order: a stable sort of the
    queries by their bucket's shard, cut at the shard boundaries."""
    dev = row.bucket_device[buckets]
    order = np.argsort(dev, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(dev, minlength=row.n_devices))])
    return [order[bounds[d]:bounds[d + 1]] for d in range(row.n_devices)]


def _bucket_search(row: ShardedGraphRow, id_map: np.ndarray, queries,
                   buckets: np.ndarray, *, beam: int, k: int, cut, metric: str,
                   norm_col, limit: int, degree_limit: int):
    """Each query searched on the shard owning its bucket, from the
    bucket's start, by the plain batched_beam_search. Returns host arrays:
    (ids [Q, beam] int64 through `id_map` [D, ms] from shard-local ids,
    EMPTY_ID-padded; dists [Q, beam] f32 +inf-padded; num_visited [Q];
    dist_cmps [Q])."""
    queries = torch.as_tensor(queries)
    q = len(buckets)
    out_s = np.full((q, beam), EMPTY_ID, dtype=np.int64)
    out_d = np.full((q, beam), np.inf, dtype=np.float32)
    nv = np.zeros(q, dtype=np.int32)
    dc = np.zeros(q, dtype=np.int32)
    for d, sel in enumerate(_placement(row, buckets)):
        if not len(sel):
            continue
        dev = row.mesh.devices[d]
        qs = queries[torch.from_numpy(sel).to(queries.device)].to(dev)
        st = torch.from_numpy(row.bucket_local_start[buckets[sel]].astype(np.int32)).to(dev)
        res = batched_beam_search(
            row.points_sh[d], row.norms_sh[d], row.nbrs_sh[d], None, qs, st,
            beam=beam, k=k, cut=cut, limit=limit if limit else row.ms,
            metric=metric, degree_limit=degree_limit, norm_col=norm_col,
            identity_map=True)
        ids = res.frontier_ids.cpu().numpy()
        valid = ids != EMPTY_ID
        out_s[sel] = np.where(valid, id_map[d][np.clip(ids, 0, row.ms - 1)], EMPTY_ID)
        out_d[sel] = np.where(valid, res.frontier_dists.cpu().numpy(), np.inf)
        nv[sel] = res.num_visited.cpu().numpy()
        dc[sel] = res.dist_cmps.cpu().numpy()
    return out_s, out_d, nv, dc


def sharded_bucket_search(
    row: ShardedGraphRow,
    queries,  # [Q, d_pad] f32, host array or tensor
    buckets: np.ndarray,  # [Q] bucket id a query
    *, beam: int, k: int, cut=1.35, metric: str, norm_col=None,
    limit: int = 0,  # max visited (0 = the shard's rows)
    degree_limit: int = 0,
    return_stats: bool = False,
):
    """Search each query on the shard owning its bucket, from the bucket's
    start, with the plain batched_beam_search.

    Returns (global ids [Q, beam] int64 EMPTY_ID-padded, dists [Q, beam]
    f32, +inf-padded) as host arrays; with `return_stats` also
    (num_visited [Q], dist_cmps [Q]). Equal to searching the unsharded
    row."""
    gi, sd, nv, dc = _bucket_search(row, row.local_to_global, queries, buckets, beam=beam,
                                    k=k, cut=cut, metric=metric, norm_col=norm_col,
                                    limit=limit, degree_limit=degree_limit)
    if return_stats:
        return gi, sd, nv, dc
    return gi, sd


def sharded_row_search(row: ShardedGraphRow, qs: torch.Tensor, st: torch.Tensor, *,
                       beam: int, limit: int, metric: str, degree_limit: int = 0,
                       norm_col=None) -> BeamResult:
    """The query-mode search of a bucket-sharded row from the slab ids `st`
    [Q] (each its bucket's first row), as models.postfilter_vamana.
    run_beam_batch runs one over a SlabGraph: the same BeamResult, slab ids
    and all, on the queries' device. Each bucket's queries search on the
    shard owning it."""
    buckets = np.searchsorted(row.slab_offsets, st.cpu().numpy(), side="right") - 1
    si, sd, nv, dc = _bucket_search(row, row.local_to_slab, qs, buckets, beam=beam, k=0,
                                    cut=1.35, metric=metric, norm_col=norm_col,
                                    limit=limit, degree_limit=degree_limit)
    up = lambda x: torch.from_numpy(x).to(qs.device)  # noqa: E731
    ids, dists = up(si.astype(np.int32)), up(sd)
    return BeamResult(ids, dists, up(nv), up(dc), ids[:, :0], dists[:, :0])
