"""The v3b scan kernel's plan, merge and CUDA source, on the CPU.

csrc/scan_v3b.cu runs only on the card, where no test runs. Here:

* its segment plan (ops/scan.segment_plan at the item body's parameters,
  tools/scan_items.plan, which v2 shares) is held to what the kernel
  relies on, at the three GRIDS (tile, qblock) shapes over random and
  degenerate windows: every block's window union covered by whole tiles
  exactly once, no item for a block of empty windows, at most MAX_SEGS
  segments a block, and an item count within the scratch bound;
* the merge: the plain scan of each item's tiles, merged per query by
  (dist, id) (ops/topk.merge_topk, the merge kernel's twin in these tests
  only), equals the plain scan of the whole window, on the harness's
  --dups data, where ties decide the order;
* the kernel's own source with the headers it includes (the item body
  csrc/scan_items.cuh, csrc/scan_common.cuh), compiled by g++ against
  tests/cuda_emu/cuda_runtime.h (a fiber per CUDA thread, barriers
  for a warp's collectives, cp.async copies made at once), through the
  wrapper's own launch (tools/scan_items.launch: the midpoint sort, the
  plan, the scratch, the ctypes call) on CPU tensors. On grid-valued data (values
  j/8) every distance is exact in float32 in any summation order, so ids
  and distances must equal, bit for bit, the port's and the JAX package's
  scan_bruteforce: each qblock, both metrics, k from 1 to 256, ties, rings
  of 2 to 4 stages beside the tile and of 1 and 2 under it, tiles wider
  than a round,
  and blocks cut into several segments, those also with the items handed
  out last first, so that a block's later segments publish their k-th
  distances before its earlier ones run;
* the shared-memory layout the wrapper's caps use equals the kernel's, and
  admits every (tile, qblock, k) that the variants' old block-per-CTA body
  admitted;
* the probe kernel of the same source (float4 lanes, a scalar tail, a
  scalar path for a misaligned tensor), through the wrapper's own launch
  (exp_scan3b.probe_launch), equal to probe_nested_while_plain.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangefilteredann_tpu.ops import bruteforce as JB
from rangefilteredann_tpu.utils.data import make_pointset as j_make_pointset
from rangefilteredann_tpu_torch import kernels
from rangefilteredann_tpu_torch import tools as PT
from rangefilteredann_tpu_torch.ops import scan as PS
from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
from rangefilteredann_tpu_torch.ops.topk import EMPTY_ID, merge_topk
from rangefilteredann_tpu_torch.tools import exp_scan3b as P3B
from rangefilteredann_tpu_torch.tools import scan_items as I
from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

from .cuda_emu import emulate

EMU_SMS = 2  # tests/cuda_emu/cuda_runtime.h EMU_SMS, one CTA each


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's source (with the csrc/ headers it includes) built for
    the CPU, as a ctypes library."""
    return emulate.build("scan_v3b", kernels.CSRC, tmp_path_factory.mktemp("scan_v3b_emu"))


def _grid(rng, shape):
    return (np.round(rng.normal(size=shape) * 8) / 8).astype(np.float32)


def _windows(rng, n, nq, k, min_width=0):
    """Random windows with the degenerate ones: empty, at the store's end,
    the whole store, narrower than k."""
    s = rng.integers(0, n, size=nq).astype(np.int32)
    e = np.minimum(s + rng.integers(min_width, n + 1, size=nq), n).astype(np.int32)
    e[:2] = s[:2]
    e[2:4] = n
    s[4:6], e[4:6] = 0, n
    s[6], e[6] = 10, 10 + max(k - 3, 1)
    return s, e


# name: (store, metric, n, d, queries, k, tile, qblock, unroll); d = 24 and
# 40 are no multiple of the 16-dim stage (qblock 16 and 32), 24 none of the
# 8-dim one (qblock 8)
CASES = {
    "qb8-l2-k10-d24": ("fp32", "l2", 1300, 24, 40, 10, 256, 8, 4),
    "qb16-mips-k10-d24": ("fp32", "mips", 1300, 24, 40, 10, 512, 16, 1),
    "qb32-l2-k1-d40": ("fp32", "l2", 2000, 40, 70, 1, 256, 32, 4),
    "qb8-mips-k256-d16": ("fp32", "mips", 520, 16, 9, 256, 256, 8, 2),
    "qb32-l2-k33-t768": ("fp32", "l2", 1300, 24, 24, 33, 768, 32, 8),
    "dup16-qb16-l2-k10": ("dup16", "l2", 1536, 8, 40, 10, 256, 16, 4),
    # the ring beside the tile, 3 and 2 stages deep; under it, 1 and 2
    # stages deep; tiles wider than a round
    "beside3-qb8-t1536": ("fp32", "l2", 5000, 16, 30, 10, 1536, 8, 4),
    "beside2-qb8-t1792": ("fp32", "mips", 5000, 16, 30, 10, 1792, 8, 4),
    "under-qb16-t2048": ("fp32", "l2", 6000, 16, 40, 10, 2048, 16, 4),
    "under-qb8-t4096": ("fp32", "l2", 9000, 16, 40, 10, 4096, 8, 4),
    "under-qb32-t1536": ("fp32", "l2", 5000, 16, 70, 10, 1536, 32, 4),
    "under-qb16-t3072-mips": ("fp32", "mips", 7000, 16, 40, 20, 3072, 16, 2),
    # blocks cut into several segments, more items than CTAs; copies 1,280
    # rows apart, in other segments: ties across items
    "dup16-qb16-l2-k2-split": ("dup16", "l2", 20_480, 8, 40, 2, 256, 16, 1),
    "qb8-mips-k40-split": ("fp32", "mips", 9000, 24, 33, 40, 512, 8, 4),
}
# (ring stages, beside the tile) of the cases that exercise a ring mode
MODES = {"qb8-l2-k10-d24": (4, 1), "beside3-qb8-t1536": (3, 1), "beside2-qb8-t1792": (2, 1),
         "qb32-l2-k33-t768": (2, 1), "under-qb16-t2048": (1, 0), "under-qb8-t4096": (1, 0),
         "under-qb32-t1536": (2, 0), "under-qb16-t3072-mips": (1, 0)}
ORDERS = [(name, "planned") for name in sorted(CASES)] + [
    (name, "reversed") for name in sorted(CASES) if "split" in name]


def _case(name):
    kind, metric, n, d, nq, k, tile, qblock, unroll = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    pts, q = _grid(rng, (n, d)), _grid(rng, (nq, d))
    if kind == "dup16":  # every point 16 times: exact ties
        pts = np.tile(_grid(rng, (n // 16, d)), (16, 1))
    s, e = _windows(rng, n, nq, k, min_width=n // 3 if "split" in name else 0)
    return pts, q, s, e, k, metric, tile, qblock, unroll


@pytest.mark.parametrize("name,order", ORDERS)
def test_emulated_kernel_matches_plain(emulated, name, order, monkeypatch):
    if order == "reversed":
        plan = PS.segment_plan

        def reversed_plan(*args, **kw):
            tb, te, prefix, seg, code, cap = plan(*args, **kw)
            n = int(prefix[-1])
            return tb, te, prefix, seg, torch.cat([code[:n].flip(0), code[n:]]), cap

        monkeypatch.setattr(PS, "segment_plan", reversed_plan)
    pts, q, s, e, k, metric, tile, qblock, unroll = _case(name)
    ps = make_pointset(pts, metric, device="cpu")
    qp = torch.from_numpy(pad_queries(q, pts.shape[1], ps.d_pad))
    st, en = torch.from_numpy(s), torch.from_numpy(e)
    got_d, got_i, plan = I.launch(emulated, "scan_v3b", ps.data, ps.norms_sq, qp, st, en, k,
                                  ps.norm_col, tile, qblock, int(metric == "l2"), unroll, None)
    want_d, want_i = scan_bruteforce(ps.data, ps.norms_sq, qp, st, en, k, metric)
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())
    jps = j_make_pointset(pts, metric)
    jq = pad_queries(q, pts.shape[1], jps.d_pad)
    jd, ji = JB.scan_bruteforce(jps.data, jps.norms_sq, jnp.asarray(jq), jnp.asarray(s),
                                jnp.asarray(e), k=k, metric=metric)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(jd))
    assert got_i[0].tolist() == [EMPTY_ID] * k  # the empty window
    tile_begin, tile_end, prefix, seg, _, max_items = plan
    assert int(prefix[-1]) <= max_items
    if "split" in name:  # blocks cut into several segments, more items than CTAs
        assert int(seg[0]) < int((tile_end - tile_begin).max()) and int(prefix[-1]) > EMU_SMS
    cfg = I.launch_config(emulated, "scan_v3b", qblock, tile, k, int(metric == "l2"), unroll)
    assert (cfg["stages"], cfg["separate"]) == MODES.get(name, (cfg["stages"], cfg["separate"]))


def test_emulated_config_matches_the_layout(emulated):
    """scan_v3b_config reports the layout the wrapper's caps compute, and
    refuses exactly what they refuse."""
    out = (ctypes.c_int * 8)()
    fn = I.bind(emulated, "scan_v3b")[1]
    for qblock in (8, 16, 32):
        for tile in range(256, 4097, 256):
            for k in (1, 10, 100, 256):
                rc = fn(qblock, tile, k, 1, 1, out)
                lay = I.layout(tile, qblock, k)
                if lay["total"] > I.MAX_SMEM:
                    assert rc == -1, (qblock, tile, k)
                    continue
                assert rc == 0, (qblock, tile, k)
                assert (out[4], out[6], out[7]) == (lay["total"], lay["stages"],
                                                    lay["separate"]), (qblock, tile, k)
    assert fn(12, 1024, 10, 1, 1, out) == -1 and fn(16, 640, 10, 1, 1, out) == -1


def test_caps_no_narrower_than_the_shared_body():
    """Every (tile, qblock, k) that the variants' old block-per-CTA body
    admitted (its shared memory: the distance block, the running lists, one
    staged chunk of 256 rows x 16 dims), the item body's layout admits, and
    so do the caps that v3 and v3b check."""
    store = torch.zeros((1, 16), dtype=torch.float32)
    for qblock in I.QBLOCKS:
        for tile in range(I.SUB, I.MAX_TILE + 1, I.SUB):
            for k in range(1, 257):
                if qblock * tile * 4 + qblock * k * 8 + (16 * qblock + 256 * 17) * 4 <= 231424:
                    assert I.smem_bytes(tile, qblock, k) <= I.MAX_SMEM, (tile, qblock, k)
                    for metric, unroll in (("l2", 1), ("mips", 4)):  # v3's call, then v3b's
                        I.check_caps(store, k, tile, qblock, unroll=unroll, metric=metric)


@pytest.mark.parametrize("n,offset", [(1024, 0), (1027, 0), (1024, 1), (1030, 3)])
def test_emulated_probe_matches_plain(emulated, n, offset):
    """The probe at the JAX tool's [8, 128] (one CTA of float4 lanes), at an
    n that is no multiple of 4 (the scalar tail), and on views 1 and 3
    floats past a 16-byte boundary (the scalar path)."""
    rng = np.random.default_rng(n + offset)
    base = torch.from_numpy(rng.normal(size=n + offset).astype(np.float32) * 1e3)
    x = base[offset:]
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset > 0)
    got = P3B.probe_launch(emulated, x, None)
    assert torch.equal(got, P3B.probe_nested_while_plain(x))
    assert not torch.equal(got, 6.0 * x)  # the order of the sum shows


def test_kernel_constants_match_the_wrapper():
    """The item body's constants (csrc/scan_items.cuh and the helpers it
    includes) are the wrappers', and v3b runs on that body, not on the old
    block-per-CTA one."""
    src = "".join((kernels.CSRC / f).read_text() for f in ("scan_items.cuh", "scan_common.cuh"))
    for name, value in (("WARPS", I.WARPS), ("QT", I.QT), ("PT", I.PT),
                        ("MAX_STAGES", I.MAX_STAGES), ("GROUP", I.GROUP),
                        ("MAX_SEGS", PS.MAX_SEGS), ("MAX_K", 256), ("MAX_SMEM", I.MAX_SMEM),
                        ("TILE_STEP", I.SUB)):
        assert f"constexpr int {name} = {value};" in src
    assert "int stage_dims(int qb) { return qb >= 16 ? 16 : 8; }" in src
    assert [I.stage_dims(qb) for qb in I.QBLOCKS] == [8, 16, 16]
    v3b = (kernels.CSRC / "scan_v3b.cu").read_text()
    assert '#include "scan_items.cuh"' in v3b and '#include "scan_variants.cuh"' not in v3b


def _plan_windows(rng, n, nq, kind):
    """Midpoint-sorted windows: the harness's (a quarter of the store each)
    or degenerate ones (empty, narrower than k, at the store's end, the
    whole store, and a block of empty windows first)."""
    if kind == "harness":
        width = n // 4
        s = rng.integers(0, n - width, size=nq)
        e = s + width
    else:
        s = rng.integers(0, n, size=nq)
        e = s + rng.integers(0, n + 1, size=nq)  # some run past n
        e[:5] = s[:5]
        e[5:9] = s[5:9] + 3
        s[9:11], e[9:11] = n - 100, n
        s[11:13], e[11:13] = 0, n
        s[-40:], e[-40:] = 0, 0
    order = np.argsort(s + e, kind="stable")
    return (torch.from_numpy(s[order].astype(np.int32)),
            torch.from_numpy(e[order].astype(np.int32)))


def _items(plan, qblock):
    """Each block's items as (first tile, one past the last) ranges, and the
    order they are handed out in as (block, segment) pairs: the kernel's
    mapping from an item to its tiles."""
    tile_begin, tile_end, prefix, seg, item_code, _ = plan
    seg = int(seg[0])
    per_block, first = [], 0
    for b in range(len(prefix)):
        tb, te = int(tile_begin[b]), int(tile_end[b])
        g = tb // seg
        per_block.append([(max((g + j) * seg, tb), min((g + j + 1) * seg, te))
                          for j in range(int(prefix[b]) - first)])
        first = int(prefix[b])
    order = [divmod(int(c), PS.MAX_SEGS) for c in item_code[:first]]
    return per_block, order


@pytest.mark.parametrize("kind", ["harness", "degenerate"])
@pytest.mark.parametrize("tile,qblock", PT.GRIDS)
def test_segment_plan_covers_each_union_once(tile, qblock, kind):
    n, nq, slots = 200_000, 2048, 132
    rng = np.random.default_rng(tile + qblock)
    starts, ends = _plan_windows(rng, n, nq, kind)
    plan = I.plan(starts, ends, n, slots, qblock, tile)
    tile_begin, tile_end, prefix, seg, item_code, max_items = plan
    assert all(t.dtype == torch.int32 for t in (tile_begin, tile_end, prefix, seg, item_code))
    assert int(seg[0]) * tile >= I.MIN_SEG_POINTS
    assert int(prefix[-1]) <= max_items
    per_block, order = _items(plan, qblock)
    assert len(per_block) == -(-nq // qblock)
    # every (block, segment) handed out once, by grid segment, then block
    assert sorted(order) == [(b, j) for b, items in enumerate(per_block)
                             for j in range(len(items))]
    grid = [(int(tile_begin[b]) // int(seg[0]) + j, b) for b, j in order]
    assert grid == sorted(grid)
    s = starts.numpy().astype(np.int64)
    e = np.minimum(ends.numpy().astype(np.int64), n)
    empty_blocks = 0
    for b, items in enumerate(per_block):
        bs, be = s[b * qblock:(b + 1) * qblock], e[b * qblock:(b + 1) * qblock]
        live = be > bs
        assert len(items) <= PS.MAX_SEGS
        if not live.any():
            assert items == []
            empty_blocks += 1
            continue
        lo, hi = bs[live].min() // tile, -(-be[live].max() // tile)
        # consecutive, non-empty segments of whole tiles from the union's
        # first tile to its last, cut on the grid of seg tiles
        assert items[0][0] == lo and items[-1][1] == hi
        assert all(x < y for x, y in items)
        assert all(t % int(seg[0]) == 0 for t, _ in items[1:])
        assert all(items[j][1] == items[j + 1][0] for j in range(len(items) - 1))
    assert empty_blocks == (0 if kind == "harness" else 40 // qblock)
    if kind == "harness":  # several items a resident CTA
        assert int(prefix[-1]) >= 3 * slots


@pytest.mark.parametrize("tile,qblock", PT.GRIDS)
def test_merged_segment_lists_equal_the_whole_scan(tile, qblock):
    """scan_v3b_plain over each item's tiles, merged per query by (dist, id),
    equals scan_v3b_plain over the whole windows bit for bit, on the
    harness's --dups data (every 3rd point a copy, queries that are store
    points) with its degenerate windows."""
    n, nq, k = 24_000, 96, PT.K
    points, queries, s, e = PT.harness_data(n, nq, dups=True, degenerate=True)
    ps = make_pointset(points, "l2", device="cpu")
    qp = torch.from_numpy(pad_queries(queries, PT.D, ps.d_pad))
    order = np.argsort(s.astype(np.int64) + e, kind="stable")
    st, en = torch.from_numpy(s[order]), torch.from_numpy(e[order])
    qs = qp[torch.from_numpy(order)]
    plan = I.plan(st, en, n, 2, qblock, tile)
    items = _items(plan, qblock)[0]
    assert max(map(len, items)) > 1
    got_d = torch.full((nq, k), float("inf"))
    got_i = torch.full((nq, k), EMPTY_ID, dtype=torch.int32)
    for b, segs in enumerate(items):
        rows = slice(b * qblock, min((b + 1) * qblock, nq))
        for t0, t1 in segs:
            d_, i_ = P3B.scan_v3b_plain(ps.data, ps.norms_sq, qs[rows],
                                      st[rows].clamp(min=t0 * tile),
                                      en[rows].clamp(max=t1 * tile), k, d_eff=PT.D)
            got_d[rows], got_i[rows] = merge_topk(got_d[rows], got_i[rows], d_, i_, k)
    want_d, want_i = P3B.scan_v3b_plain(ps.data, ps.norms_sq, qs, st, en, k, d_eff=PT.D)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    assert (want_i[:, 0] != EMPTY_ID).sum() >= nq - 4  # only the degenerate few lack a point
