"""Vamana graph construction over slabs, batched across buckets.

Counterpart of rangefilteredann_tpu/models/vamana.py (ref:
ParlayANN/algorithms/vamana/index.h:123-135,211-313). Every bucket of a slab
runs the same exponential insert schedule, so one global step is one batched
beam search (ops/beam_search, expand = build_expand(L), visited lists) plus
one batched RobustPrune across every bucket's inserts, followed by the
reverse-edge bookkeeping: a stable sort of the new edges by target,
segmented ranks, bounded appends, and a re-prune of overfull targets.

The adjacency and degrees live on the store's device and are updated in
place; the host enqueues the steps. The JAX package's padding of every step
to one compiled shape is not needed in PyTorch: only its cap on the batch
size (`mp`, which splits an oversized step into sub-batches) is kept, so the
same inputs take the same steps. Its `pad_rows` and `insert_pad` options,
which let the super tree's rows share compiled shapes, are not ported:
PyTorch has no compiled shapes to share. Pad rows are isolated and
unreachable, and the JAX package caches the real rows only, so a super row
it saved loads here unpadded and searches alike
(tests/test_torch_super_tree.py holds ids and counters equal).
"""

from __future__ import annotations

import dataclasses
import os
import time
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

from ..ops.beam_search import batched_beam_search, build_expand
from ..ops.distances import gathered_distances
from ..ops.robust_prune import robust_prune
from ..ops.topk import EMPTY_ID
from ..params import BuildParams
from ..utils.data import PointSet, resolve_device
from .base import load_cached_nbrs, next_pow2, save_cached_nbrs

PRUNE_CHUNK = 2048  # rows per robust_prune call (bounds the [rows, C, d] gather)
_I32_MAX = int(np.iinfo(np.int32).max)
# Seconds between two checkpoints of a build given a checkpoint_path.
CKPT_SECS = 600.0


@dataclasses.dataclass
class SlabGraph:
    """Adjacency of one graph slab on a device, with its host mirror."""

    nbrs_dev: torch.Tensor  # [m, R] int32 slab ids, -1 pad
    slab_to_global_dev: torch.Tensor  # [m] int32
    nbrs_host: np.ndarray  # mirror of nbrs_dev
    degrees: np.ndarray  # [m] int32
    bucket_slab_offsets: np.ndarray  # [nb+1] slab-space bucket boundaries
    slab_to_global_host: np.ndarray = None  # [m] host copy of the slab map
    identity_s2g: bool = False  # slab ids == global ids

    nbr_vecs: Optional[torch.Tensor] = None  # [m, R, w] inline neighbour vectors
    nbr_norms: Optional[torch.Tensor] = None  # [m, R] their ||x||^2
    nbr_scale: Optional[torch.Tensor] = None  # [m] dequant scales when nbr_vecs
    # is an int8 quantization of a float store (None = vectors are exact)
    replicas: Optional[tuple] = None  # (nbrs_dev, slab_to_global_dev) as
    # {device: tensor} over a mesh's devices (parallel.sharded.replicate_index)

    @classmethod
    def from_nbrs(cls, nbrs, device=None, slab_to_global=None,
                  bucket_slab_offsets=None) -> "SlabGraph":
        """The graph over the adjacency `nbrs` [m, R] (-1 padded), as a
        loaded graph is held: flat (one bucket, identity slab map) unless a
        slab's map [m] and bucket offsets are given; `device` None means
        the card."""
        device = resolve_device(device)
        nbrs = np.array(nbrs, dtype=np.int32, order="C")  # a writable copy
        if nbrs.ndim != 2:
            raise ValueError(f"nbrs must be [m, R], got {nbrs.shape}")
        m = nbrs.shape[0]
        ident = np.arange(m, dtype=np.int64)
        s2g = ident if slab_to_global is None else np.asarray(
            slab_to_global, dtype=np.int64)
        if s2g.shape != (m,):
            raise ValueError(f"slab_to_global must be [{m}], got {s2g.shape}")
        offsets = (np.array([0, m], dtype=np.int64) if bucket_slab_offsets is None
                   else np.asarray(bucket_slab_offsets, dtype=np.int64))
        return cls(
            nbrs_dev=torch.from_numpy(nbrs).to(device),
            slab_to_global_dev=torch.from_numpy(s2g.astype(np.int32)).to(device),
            nbrs_host=nbrs,
            degrees=(nbrs >= 0).sum(axis=1).astype(np.int32),
            bucket_slab_offsets=offsets,
            slab_to_global_host=s2g,
            identity_s2g=bool(np.array_equal(s2g, ident)),
        )

    @classmethod
    def from_cache(cls, fname: str, fingerprint: np.ndarray,
                   device=None) -> Optional["SlabGraph"]:
        """The flat graph of a `vamana_*.npz` graph cache (either package's),
        or None when its fingerprint says it was built for other data."""
        nbrs = load_cached_nbrs(fname, fingerprint)
        return None if nbrs is None else cls.from_nbrs(nbrs, device)

    @property
    def inline_dtype(self):
        """Storage dtype of the inline blocks (None = not attached)."""
        return None if self.nbr_vecs is None else self.nbr_vecs.dtype

    @property
    def m(self) -> int:
        return self.nbrs_host.shape[0]

    @property
    def R(self) -> int:
        return self.nbrs_host.shape[1]

    def sync_to_device(self):
        self.nbrs_dev = torch.from_numpy(np.ascontiguousarray(
            self.nbrs_host, dtype=np.int32)).to(self.slab_to_global_dev.device)

    # Device residency for trees whose rows together exceed the card's
    # memory: a row drops its device copies and uploads them again from the
    # host mirrors when a batch routes to it (models/base.RowResidency).
    def ensure_device(self, device) -> "SlabGraph":
        if self.nbrs_dev is None:
            self.nbrs_dev = torch.from_numpy(np.ascontiguousarray(
                self.nbrs_host, dtype=np.int32)).to(device)
        if self.slab_to_global_dev is None:
            self.slab_to_global_dev = torch.from_numpy(
                self.slab_to_global_host.astype(np.int32)).to(device)
        return self

    def evict_device(self) -> None:
        """Drop the device copies (the host mirrors stay), inline blocks too."""
        self.nbrs_dev = None
        self.slab_to_global_dev = None
        self.nbr_vecs = None
        self.nbr_norms = None
        self.nbr_scale = None
        self.replicas = None

    def device_bytes(self) -> int:
        """Device bytes of the adjacency, the slab map and inline blocks."""
        b = self.m * self.R * 4 + self.m * 4
        if self.nbr_vecs is not None:
            b += self.nbr_vecs.numel() * self.nbr_vecs.element_size()
            b += self.nbr_norms.numel() * 4
        return b

    @staticmethod
    def inline_width(ps: PointSet) -> int:
        """Columns of an inline block: the real dims rounded up to 128."""
        w = ps.norm_col if ps.norm_col >= 0 else ps.d_pad
        return -(-w // 128) * 128

    def inline_bytes(self, ps: PointSet, dtype=torch.float32) -> int:
        """Device bytes of attach_inline for this slab."""
        elem = torch.empty((), dtype=dtype).element_size()
        return self.m * self.R * (self.inline_width(ps) * elem + 4)

    def attach_inline(self, ps: PointSet, dtype=torch.float32) -> "SlabGraph":
        """Copy each node's neighbour vectors into one contiguous [R, w]
        block ([m, R, w] + [m, R] fp32 norms), with the fused norm column
        zeroed, so that expanding a node reads one block. float32 is exact;
        bfloat16 rounds the stored vectors; int8 over a float store
        quantizes each node's block with one scale (nbr_scale), and callers
        exact-rerank the final candidates. Byte stores keep their own dtype."""
        w = self.inline_width(ps)
        safe = self.nbrs_dev.clamp(0, self.m - 1).long()
        gid = safe if self.identity_s2g else self.slab_to_global_dev[safe].long()
        src = ps.data[:, :w]
        if 0 <= ps.norm_col < w:
            src = src.clone()
            src[:, ps.norm_col] = 0.0
        if dtype == torch.int8 and src.dtype not in (torch.int8, torch.uint8):
            chunk = min(self.m, max(
                4096, next_pow2(int(1e9 // (self.R * w * 4))) // 2))
            self.nbr_vecs, self.nbr_scale = _quant_inline_all(src, gid, chunk=chunk)
        else:
            self.nbr_vecs = src.to(dtype)[gid]
            self.nbr_scale = None
        self.nbr_norms = ps.norms_sq[gid]
        return self


def max_step_insert(bucket_slab_offsets) -> int:
    """Largest per-step insert batch of this slab's aligned schedules."""
    sizes = np.diff(np.asarray(bucket_slab_offsets))
    schedules = [_batch_schedule(int(s)) for s in sizes]
    n_steps = max(len(s) for s in schedules)
    return max(
        sum(s[t][1] - s[t][0] for s in schedules if t < len(s))
        for t in range(n_steps)
    )


def _quant_inline_all(src, gid, *, chunk):
    """Per-node symmetric int8 quantization of every inline block, one
    [chunk, R, w] fp32 gather at a time, written in place. The last chunk
    starts at m - chunk (overlapping the previous one; rows are independent,
    so the rewrite is idempotent)."""
    m, r = gid.shape
    w = src.shape[1]
    buf = torch.zeros((m, r, w), dtype=torch.int8, device=src.device)
    sc = torch.zeros(m, dtype=torch.float32, device=src.device)
    # max / 127 as XLA compiles the JAX package's division by a constant:
    # a product with the float32 reciprocal (bit-identical scales)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=src.device)
    for c in range(-(-m // chunk)):
        lo = min(c * chunk, m - chunk)
        v = src[gid[lo:lo + chunk]].to(torch.float32)  # [chunk, R, w]
        s = v.abs().amax(dim=(1, 2)).clamp_min(1e-12) * inv127
        buf[lo:lo + chunk] = torch.round(v / s[:, None, None]).clamp(
            -127, 127).to(torch.int8)
        sc[lo:lo + chunk] = s
    return buf, sc


def _batch_schedule(m: int, base: float = 2.0, max_fraction: float = 0.02):
    """Exponential insert batches (ref: index.h:228-255). Returns [(lo, hi))."""
    max_batch = min(int(max_fraction * m), 1_000_000)
    if max_batch == 0:
        max_batch = m
    out = []
    count, inc = 0, 0
    while count < m:
        if base**inc <= max_batch:
            lo = int(base**inc) - 1
            hi = min(int(base ** (inc + 1)), m) - 1
            count = hi
        else:
            lo = count
            hi = min(count + max_batch, m)
            count = hi
        if hi > lo:
            out.append((lo, hi))
        inc += 1
    return out


def _prune_rows(data, norms_sq, s2g, p_slab, cand, alpha, *, R, metric,
                norm_col, chunk):
    """robust_prune over [mp, C] rows, `chunk` rows at a time (bounds the
    [chunk, C, d] gather and the [chunk, C, C] Gram product)."""
    outs = [robust_prune(data, norms_sq, s2g, p_slab[lo:lo + chunk],
                         cand[lo:lo + chunk], alpha, R=R, metric=metric,
                         norm_col=norm_col)[0]
            for lo in range(0, p_slab.shape[0], chunk)]
    return torch.cat(outs, dim=0)


def _insert_step(nbrs, degrees, data, norms_sq, s2g, ins, st, alpha, *, R, L,
                 metric, v_cap, chunk, rev_cap, norm_col, identity, expand):
    """One insert batch (ref: index.h:264-307), updating `nbrs` [m, R] and
    `degrees` [m] in place: insertion searches against the current graph,
    RobustPrune of their visited lists, then the reverse edges."""
    m_slab = nbrs.shape[0]
    q_gid = ins.long() if identity else s2g[ins.long()].long()
    queries = data[q_gid].to(torch.float32)
    res = batched_beam_search(
        data, norms_sq, nbrs, s2g, queries, st,
        beam=L, k=0, cut=1.0, limit=m_slab, metric=metric, exclude=ins,
        return_visited=True, visited_cap=v_cap, expand=expand,
        norm_col=norm_col, identity_map=identity,
    )
    visited = torch.where(res.visited_ids == EMPTY_ID, -1, res.visited_ids)
    new_out = _prune_rows(data, norms_sq, s2g, ins, visited, alpha, R=R,
                          metric=metric, norm_col=norm_col, chunk=chunk)
    nbrs[ins.long()] = new_out
    degrees[ins.long()] = (new_out >= 0).sum(dim=1, dtype=torch.int32)
    _apply_reverse_edges(nbrs, degrees, data, norms_sq, s2g, ins, new_out,
                         alpha, R=R, metric=metric, chunk=chunk,
                         rev_cap=rev_cap, norm_col=norm_col)


def _apply_reverse_edges(
    nbrs, degrees, data, norms_sq, s2g,
    ins,  # [mp] int32 inserted slab ids
    new_out,  # [mp, R] their freshly pruned out-edges (-1 pad)
    alpha,
    *, R, metric, chunk, rev_cap, norm_col,
):
    """Reverse edges (ref: index.h:279-306), in place: group the u -> v edges
    by target v (stable sort), append where v has room for its whole group,
    and RobustPrune (old neighbours + the first rev_cap - R sources) where
    it has not."""
    m_slab = nbrs.shape[0]
    dev = nbrs.device
    e = ins.shape[0] * R
    u = ins.repeat_interleave(R)
    v = new_out.reshape(-1)
    s_v, order = torch.sort(torch.where(v >= 0, v, _I32_MAX), stable=True)
    s_v = s_v.long()
    s_u = u[order]
    valid = s_v != _I32_MAX
    iota = torch.arange(e, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    head = valid & torch.cat([one, s_v[1:] != s_v[:-1]])
    last = valid & torch.cat([s_v[:-1] != s_v[1:], one])
    seg_start = torch.cummax(torch.where(head, iota, 0), dim=0).values
    seg_end = torch.cummin(torch.where(last, iota, _I32_MAX).flip(0),
                           dim=0).values.flip(0)
    count = seg_end - seg_start + 1
    rank = iota - seg_start
    deg_v = degrees[s_v.clamp(0, m_slab - 1)].long()
    fits = valid & (deg_v + count <= R)
    # appends: a whole group lands behind the target's current degree
    nbrs[s_v[fits], (deg_v + rank)[fits]] = s_u[fits]
    grown = head & fits
    degrees[s_v[grown]] += count[grown].to(torch.int32)

    # overfull targets: RobustPrune(current neighbours + reverse sources)
    # with the user's alpha (ref: index.h:297-306)
    over = torch.nonzero(head & ~fits)[:, 0]
    t = torch.arange(rev_cap - R, device=dev)
    for lo in range(0, over.shape[0], chunk):
        p = over[lo:lo + chunk]
        v_o = s_v[p]
        take = t[None, :] < torch.clamp(count[p], max=rev_cap - R)[:, None]
        rev = torch.where(take, s_u[(p[:, None] + t[None, :]).clamp(0, e - 1)], -1)
        cand = torch.cat([nbrs[v_o], rev], dim=1)
        pruned, _ = robust_prune(data, norms_sq, s2g, v_o.to(torch.int32), cand,
                                 alpha, R=R, metric=metric, norm_col=norm_col)
        nbrs[v_o] = pruned
        degrees[v_o] = (pruned >= 0).sum(dim=1, dtype=torch.int32)


def _build_fingerprint(seed, m_slab, nb, R, L, n_steps, mp, ps, alpha,
                       bucket_slab_offsets, slab_to_global) -> int:
    """crc32 over every input that shapes the insert stream (the JAX
    package's checkpoint fingerprint)."""
    fp = 0
    for part in (
        np.int64([seed, m_slab, nb, R, L, n_steps, mp, ps.n, ps.d]),
        np.float64([alpha]),
        np.asarray(bucket_slab_offsets, dtype=np.int64),
        slab_to_global.astype(np.int64),
    ):
        fp = zlib.crc32(part.tobytes(), fp)
    return fp


def _load_checkpoint(path, fp, verbose):
    """(t_done, nbrs, degrees) from a checkpoint written for these inputs,
    else None (a missing, foreign or unreadable file means a cold start)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as ck:
            if int(ck["fingerprint"]) != fp:
                if verbose:
                    print("  vamana resume: fingerprint mismatch, rebuilding")
                return None
            return int(ck["t_done"]), ck["nbrs"], ck["degrees"]
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        if verbose:
            print(f"  vamana resume: unreadable checkpoint ({e}), rebuilding")
        return None


def build_vamana_graph(
    ps: PointSet,
    slab_to_global: np.ndarray,  # [m_slab] int64/int32
    bucket_slab_offsets: np.ndarray,  # [nb+1]
    bp: BuildParams,
    *,
    seed: int = 0,
    visited_cap: Optional[int] = None,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,  # (nbrs, degrees, step) written
    # atomically every CKPT_SECS and deleted on completion; a build given
    # the same path and inputs resumes from it
) -> SlabGraph:
    """Build Vamana graphs over every bucket of a slab at once, on the
    store's device."""
    dev = ps.device
    rng = np.random.default_rng(seed)
    m_slab = int(bucket_slab_offsets[-1])
    nb = len(bucket_slab_offsets) - 1
    R, L, alpha = bp.R, bp.L, bp.alpha
    v_cap = visited_cap or (int(1.25 * L) + 64)
    s2g_dev = torch.from_numpy(slab_to_global.astype(np.int32)).to(dev)
    identity = bool(m_slab == ps.n
                    and np.array_equal(slab_to_global, np.arange(m_slab)))

    # per-bucket random insertion orders and aligned schedules
    # (start point = the bucket's first slab id; ref: index.h:128)
    perms, schedules = [], []
    for b in range(nb):
        lo, hi = int(bucket_slab_offsets[b]), int(bucket_slab_offsets[b + 1])
        perms.append(lo + rng.permutation(hi - lo))
        schedules.append(_batch_schedule(hi - lo))
    n_steps = max(len(s) for s in schedules)
    bucket_starts = bucket_slab_offsets[:-1].astype(np.int32)

    # cap on one search batch, as the JAX package sets it: the insertion
    # search gathers [mp, expand * R, d_pad] fp32 per step
    mb_max = max(sum(s[t][1] - s[t][0] for s in schedules if t < len(s))
                 for t in range(n_steps))
    exp = build_expand(L)
    row_bytes = exp * R * int(ps.d_pad) * 4
    data_bytes = ps.data.numel() * ps.data.element_size()
    gather_budget = 6e9 if data_bytes < 2e9 else 3e9
    auto_cap = max(1024, int(gather_budget // max(row_bytes, 1)))
    p = next_pow2(max(min(mb_max, auto_cap), 64))
    mp = p // 2 if p > auto_cap else p
    chunk = min(PRUNE_CHUNK, mp)
    rev_cap = next_pow2(2 * R)  # reverse-edge prune candidate width
    norm_col = ps.norm_col if ps.norm_col >= 0 else None

    nbrs = torch.full((m_slab, R), -1, dtype=torch.int32, device=dev)
    degrees = torch.zeros(m_slab, dtype=torch.int32, device=dev)
    t_start = 0
    fp = 0
    if checkpoint_path:
        fp = _build_fingerprint(seed, m_slab, nb, R, L, n_steps, mp, ps, alpha,
                                bucket_slab_offsets, slab_to_global)
        ck = _load_checkpoint(checkpoint_path, fp, verbose)
        if ck is not None:
            t_start = ck[0]
            nbrs = torch.from_numpy(ck[1]).to(dev)
            degrees = torch.from_numpy(ck[2]).to(dev)
            if verbose:
                print(f"  vamana resume: step {t_start}/{n_steps}")
    last_ckpt = time.time()

    for t in range(t_start, n_steps):
        ins_list, start_list = [], []
        for b in range(nb):
            if t < len(schedules[b]):
                lo, hi = schedules[b][t]
                ins_list.append(perms[b][lo:hi])
                start_list.append(np.full(hi - lo, bucket_starts[b], dtype=np.int32))
        inserts_all = np.concatenate(ins_list).astype(np.int32)
        starts_all = np.concatenate(start_list)
        for sub in range(0, len(inserts_all), mp):
            _insert_step(
                nbrs, degrees, ps.data, ps.norms_sq, s2g_dev,
                torch.from_numpy(inserts_all[sub:sub + mp]).to(dev),
                torch.from_numpy(starts_all[sub:sub + mp]).to(dev), alpha,
                R=R, L=L, metric=ps.metric, v_cap=v_cap, chunk=chunk,
                rev_cap=rev_cap, norm_col=norm_col, identity=identity,
                expand=exp,
            )
        if verbose:
            print(f"  vamana step {t + 1}/{n_steps}: inserted {len(inserts_all)}")
        if (checkpoint_path and t + 1 < n_steps
                and time.time() - last_ckpt >= CKPT_SECS):
            tmp = checkpoint_path + ".tmp.npz"  # savez must not append .npz
            np.savez(tmp, fingerprint=np.int64(fp), t_done=np.int64(t + 1),
                     nbrs=nbrs.cpu().numpy(), degrees=degrees.cpu().numpy())
            os.replace(tmp, checkpoint_path)
            last_ckpt = time.time()
            if verbose:
                print(f"  vamana checkpoint: step {t + 1}/{n_steps}")
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)

    g = SlabGraph(
        nbrs_dev=nbrs,
        slab_to_global_dev=s2g_dev,
        nbrs_host=nbrs.cpu().numpy(),
        degrees=degrees.cpu().numpy(),
        bucket_slab_offsets=np.asarray(bucket_slab_offsets),
        slab_to_global_host=slab_to_global.astype(np.int64),
        identity_s2g=identity,
    )
    # final pass: sort each adjacency row by distance (ref: index.h:131-134)
    g.nbrs_host = sort_adjacency_rows(ps, g)
    g.sync_to_device()
    return g


def load_or_build_row(ps: PointSet, bp: BuildParams, slab_to_global: np.ndarray,
                      bucket_slab_offsets: np.ndarray, fingerprint: np.ndarray,
                      fname: Optional[str], canon: Optional[str] = None, *,
                      seed: int, require_cache: bool) -> SlabGraph:
    """A tree row's graph over the slab `slab_to_global` cut at
    `bucket_slab_offsets`: loaded from its cache file `fname` or, when that
    file is absent, from `canon` (a tree's row 0 is the flat graph's build
    and shares its cache); else built and saved under both names, or, under
    `require_cache`, FileNotFoundError. A cache written for other data (its
    fingerprint differs) is rebuilt."""
    load_from = fname
    if canon and fname and not os.path.exists(fname) and os.path.exists(canon):
        load_from = canon
    if load_from and os.path.exists(load_from):
        nbrs = load_cached_nbrs(load_from, fingerprint)
        if nbrs is not None:
            return SlabGraph.from_nbrs(nbrs, ps.device, slab_to_global,
                                       bucket_slab_offsets)
    if require_cache:
        raise FileNotFoundError(
            f"require_cache: row cache absent or fingerprint-mismatched ({fname})")
    g = build_vamana_graph(ps, slab_to_global, bucket_slab_offsets, bp, seed=seed)
    if fname:
        os.makedirs(os.path.dirname(fname), exist_ok=True)
        save_cached_nbrs(fname, g.nbrs_host, fingerprint)
        if canon and not os.path.exists(canon):
            save_cached_nbrs(canon, g.nbrs_host, fingerprint)
    return g


def sort_adjacency_rows(ps: PointSet, g: SlabGraph) -> np.ndarray:
    """Each node's neighbours sorted by distance to it (a stable sort, -1
    padding last), 65,536 rows at a time on the store's device."""
    m = g.m
    out = np.empty_like(g.nbrs_host)
    s2g = g.slab_to_global_dev
    norm_col = ps.norm_col if ps.norm_col >= 0 else None
    for lo in range(0, m, 1 << 16):
        hi = min(lo + (1 << 16), m)
        rows = torch.from_numpy(np.ascontiguousarray(g.nbrs_host[lo:hi])).to(ps.device)
        valid = rows >= 0
        gid = s2g[rows.clamp(0, m - 1).long()].long()
        self_gid = s2g[torch.arange(lo, hi, device=ps.device)].long()
        self_vecs = ps.data[self_gid].to(torch.float32)
        if norm_col is not None:  # the node's side keeps the norm out
            self_vecs[:, norm_col] = 0.0
        d = gathered_distances(self_vecs, ps.data[gid], ps.norms_sq[gid], ps.metric)
        d = torch.where(valid, d, float("inf"))
        keys = torch.where(valid, rows, EMPTY_ID)
        _, order = torch.sort(d, dim=1, stable=True)
        srt = torch.gather(keys, 1, order)
        out[lo:hi] = torch.where(srt == EMPTY_ID, -1, srt).cpu().numpy()
    return out
