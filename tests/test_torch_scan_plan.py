"""The scan kernel's segment plan (ops/scan.segment_plan), on the CPU.

The kernel's wrapper cuts each block of 32 midpoint-sorted queries' union of
windows into segments of whole tiles, one work item each, by torch ops on
the device. These tests hold the plan, at its defaults (the production
scan's), to what the kernel relies on: every block's union tile range
covered exactly once, no item for a block of empty windows, at most
MAX_SEGS segments a block, and an item count within the scratch bound the
wrapper allocates (tests/test_torch_scan_v3b.py holds the same function at
the item body's parameters, v2's and v3b's). Then the merge: the per-segment top-k
lists, merged by (dist, id), equal the whole scan bit for bit, so the
result cannot depend on the segmentation. The whole scan is the JAX
package's scan_bruteforce on the same inputs; values on the grid j/8 make
every distance exact, and repeated points make ties across segments.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rangefilteredann_tpu.ops import bruteforce as JB
from rangefilteredann_tpu.utils.data import make_pointset as j_make_pointset
from rangefilteredann_tpu.utils.data import pad_queries
from rangefilteredann_tpu_torch import kernels
from rangefilteredann_tpu_torch.ops import scan as PS
from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
from rangefilteredann_tpu_torch.ops.topk import merge_topk
from rangefilteredann_tpu_torch.utils.data import make_pointset as p_make_pointset


def _sorted_windows(rng, n, nq, min_width, empty_block=False):
    """Random windows sorted by midpoint as the wrapper sorts them, with
    empty windows, windows past the store's end and the whole store."""
    s = rng.integers(0, n, size=nq)
    e = s + rng.integers(max(min_width, 1), n + 1, size=nq)  # some run past n
    if nq > 8:
        e[:5] = s[:5]
        s[5:7], e[5:7] = 0, n
    if empty_block:  # 40 empty windows sort first: the first block is empty
        s[-40:], e[-40:] = 0, 0
    order = np.argsort(s + e, kind="stable")
    return (torch.from_numpy(s[order].astype(np.int32)),
            torch.from_numpy(e[order].astype(np.int32)))


def _items(plan):
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


PLANS = {
    # name: (n, queries, minimum window width, resident CTAs, an empty block)
    "harness-2048q-w50k": (200_000, 2048, 50_000, 264, False),
    "1M-10240q-w250k": (1_000_000, 10_240, 250_000, 264, False),
    "narrow-1000q": (1_000_000, 1000, 0, 132, False),
    "ragged-70q-empty-block": (30_000, 70, 0, 3, True),
    "one-query": (5000, 1, 0, 264, False),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_segment_plan_covers_each_union_once(name):
    n, nq, min_width, slots, empty_block = PLANS[name]
    rng = np.random.default_rng(len(name))
    starts, ends = _sorted_windows(rng, n, nq, min_width, empty_block)
    plan = PS.segment_plan(starts, ends, n, slots)
    tile_begin, tile_end, prefix, seg, item_code, max_items = plan
    assert all(t.dtype == torch.int32 for t in (tile_begin, tile_end, prefix, seg, item_code))
    assert int(seg[0]) * PS.TILE >= PS.MIN_SEG_POINTS
    assert int(prefix[-1]) <= max_items
    per_block, order = _items(plan)
    # every (block, segment) handed out once, by grid segment, then block
    assert sorted(order) == [(b, j) for b, items in enumerate(per_block)
                             for j in range(len(items))]
    grid = [(int(tile_begin[b]) // int(seg[0]) + j, b) for b, j in order]
    assert grid == sorted(grid)
    s = starts.numpy().astype(np.int64)
    e = np.minimum(ends.numpy().astype(np.int64), n)
    empty_blocks = 0
    for b, items in enumerate(per_block):
        bs, be = s[b * PS.QB:(b + 1) * PS.QB], e[b * PS.QB:(b + 1) * PS.QB]
        live = be > bs
        assert len(items) <= PS.MAX_SEGS
        if not live.any():
            assert items == []
            empty_blocks += 1
            continue
        lo, hi = bs[live].min() // PS.TILE, -(-be[live].max() // PS.TILE)
        # consecutive, non-empty segments from the union's first tile to its
        # last, cut on the grid of seg tiles
        assert items[0][0] == lo and items[-1][1] == hi
        assert all(a < b for a, b in items)
        assert all(t % int(seg[0]) == 0 for t, _ in items[1:])
        assert all(items[j][1] == items[j + 1][0] for j in range(len(items) - 1))
    assert empty_blocks == (1 if empty_block else 0)


def test_segment_plan_spreads_small_batches():
    """The harness's 2,048 queries over windows of 50,000 give several items
    a resident CTA; 10,240 queries over windows of 1/4 of 1M give longer
    segments and about ITEMS_PER_SLOT items a CTA."""
    for n, nq, w, want in ((200_000, 2048, 50_000, 3), (1_000_000, 10_240, 250_000, 7)):
        starts, ends = _sorted_windows(np.random.default_rng(nq), n, nq, w)
        plan = PS.segment_plan(starts, ends, n, 264)
        assert int(plan[2][-1]) >= want * 264


def test_merged_segment_scans_equal_the_whole_scan():
    """Each item's plain scan over its own tiles, merged per query by
    (dist, id), equals the whole scan bit for bit (JAX and port)."""
    rng = np.random.default_rng(5)
    n, d, nq, k = 12_000, 16, 70, 10
    pts = np.round(rng.normal(size=(n // 4, d)) * 8) / 8
    pts = np.tile(pts, (4, 1)).astype(np.float32)  # ties 3,000 rows apart
    queries = (np.round(rng.normal(size=(nq, d)) * 8) / 8).astype(np.float32)
    starts, ends = _sorted_windows(rng, n, nq, 2000)
    ps = p_make_pointset(pts, "l2", device="cpu")
    qp = pad_queries(queries, d, ps.d_pad)
    qp_t = torch.from_numpy(qp)
    plan = PS.segment_plan(starts, ends, n, 3)
    items = _items(plan)[0]
    assert max(map(len, items)) > 1
    got_d = torch.full((nq, k), float("inf"))
    got_i = torch.full((nq, k), 2**31 - 1, dtype=torch.int32)
    for b, segs in enumerate(items):
        rows = slice(b * PS.QB, min((b + 1) * PS.QB, nq))
        for t0, t1 in segs:
            s = starts[rows].clamp(min=t0 * PS.TILE)
            e = ends[rows].clamp(max=t1 * PS.TILE)
            d_, i_ = scan_bruteforce(ps.data, ps.norms_sq, qp_t[rows], s, e, k, "l2")
            got_d[rows], got_i[rows] = merge_topk(got_d[rows], got_i[rows], d_, i_, k)
    want = scan_bruteforce(ps.data, ps.norms_sq, qp_t, starts, ends, k, "l2")
    assert torch.equal(got_d, want[0]) and torch.equal(got_i, want[1])
    jps = j_make_pointset(pts, "l2")
    jd, ji = JB.scan_bruteforce(jps.data, jps.norms_sq, jnp.asarray(qp),
                                jnp.asarray(starts.numpy()), jnp.asarray(ends.numpy()),
                                k=k, metric="l2")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(jd))


def test_plan_constants_match_the_kernel():
    """The wrapper's plan uses the kernel's block, tile, chunk and segment
    caps (the last two from the helpers it includes)."""
    src = "".join((kernels.CSRC / f).read_text() for f in ("scan_topk.cu", "scan_common.cuh"))
    for name, value in (("QB", PS.QB), ("TILE", PS.TILE), ("DK", PS.CHUNK),
                        ("MAX_SEGS", PS.MAX_SEGS), ("MAX_K", PS.MAX_K)):
        assert f"constexpr int {name} = {value};" in src
