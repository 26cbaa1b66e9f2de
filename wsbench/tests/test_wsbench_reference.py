"""The reference against a brute-force NumPy top-k, both window semantics,
and the comparison that decides `correct`."""

import numpy as np
import pytest
import torch

from wsbench import reference
from wsbench.reference import FLT_MAX, PAD_ID, Reference, judge, tf32_round


def numpy_topk(points, labels, queries, filters, k, closed, l2=True):
    """Per query: the (id, float64 squared L2, or negated inner product) of
    its k nearest in-window points, by (distance, id)."""
    out = []
    for q, (lo, hi) in zip(queries, filters):
        inside = (labels >= lo) & ((labels <= hi) if closed else (labels < hi))
        ids = np.nonzero(inside)[0]
        x, q = points[ids].astype(np.float64), q.astype(np.float64)
        d = ((x - q) ** 2).sum(1) if l2 else -(x @ q)
        o = np.lexsort((ids, d))[:k]
        out.append((ids[o], d[o]))
    return out


def data(seed, n=600, d=16, nq=40):
    rng = np.random.default_rng(seed)
    points = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, 50, size=n) / 50.0  # ties on labels, windows ending on one
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    lo = rng.uniform(-0.1, 1.0, size=nq)
    width = rng.choice([0.0, 0.01, 0.02, 0.1, 0.5, 2.0], size=nq)
    lo[:3] = [0.2, 0.2, 1.5]  # an exact label, and a window past every label
    width[:3] = [0.0, 0.02, 0.1]
    return points, labels, queries, np.stack([lo, lo + width], 1)


@pytest.mark.parametrize("metric", ["Euclidian", "mips"])
@pytest.mark.parametrize("window", ["half_open", "closed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_is_the_numpy_topk(window, seed, metric, monkeypatch):
    points, labels, queries, filters = data(seed)
    monkeypatch.setattr(reference, "MAX_BLOCK", 8)  # many blocks of nearby windows
    ref = Reference(points, labels, window, metric, "cpu")
    k = 7
    pos, dist = ref.topk(queries, filters, k)
    want = numpy_topk(points, labels, queries, filters, k, window == "closed",
                      l2=metric != "mips")
    for qi, (ids, d) in enumerate(want):
        got = pos[qi].numpy()
        m = len(ids)
        assert (got[m:] == -1).all() and torch.isinf(dist[qi, m:]).all()
        assert sorted(ref.order[got[:m]].tolist()) == sorted(ids.tolist())
        np.testing.assert_allclose(dist[qi, :m].numpy(), d, rtol=1e-9, atol=1e-9)
    s, e = ref.windows(filters)
    assert (e - s).tolist() == [
        int(((labels >= lo) & ((labels <= hi) if window == "closed" else (labels < hi))).sum())
        for lo, hi in filters]
    assert e[0] > s[0] if window == "closed" else e[0] == s[0]  # [0.2, 0.2]


def answers(ref, queries, filters, k):
    """The exact answers in the program's output form."""
    pos, dist = ref.topk(queries, filters, k)
    pos, dist = pos.numpy(), dist.numpy()
    ids = np.where(pos >= 0, ref.order[np.maximum(pos, 0)], PAD_ID).astype(np.uint32)
    return ids, np.where(pos >= 0, dist, FLT_MAX).astype(np.float32)


def test_judge_counts_each_fault():
    points, labels, queries, filters = data(3)
    ref = Reference(points, labels, "half_open", "l2", "cpu")
    k = 5
    ids, dists = answers(ref, queries, filters, k)
    v = judge(ref, queries, filters, ids, dists, k)
    assert v.invalid.sum() == 0 and v.misses.sum() == 0 and (v.recall == 1).all()
    assert v.dist_err < 1e-5
    s, e = ref.windows(filters)
    full = np.nonzero(e - s > k + 2)[0]
    q = full[0]

    bad = ids.copy()  # an id outside the window
    outside = ref.order[e[q] if e[q] < ref.n else s[q] - 1]
    bad[q, 0] = outside
    assert judge(ref, queries, filters, bad, dists, k).invalid[q] == 1

    bad = ids.copy()  # a repeated id: the second is invalid, one answer missed
    bad[q, 1] = bad[q, 0]
    v = judge(ref, queries, filters, bad, dists, k)
    assert v.invalid[q] == 1 and v.misses[q] == 1

    short = ids.copy()  # an answer left out, padded
    sd = dists.copy()
    short[q, -1], sd[q, -1] = PAD_ID, FLT_MAX
    v = judge(ref, queries, filters, short, sd, k)
    assert v.invalid[q] == 0 and v.misses[q] == 1 and v.recall[q] == (k - 1) / k

    far = ids.copy()  # a valid but farther point: a miss, and its distance is off
    far[q, -1] = ref.order[s[q]:e[q]][np.argmax(
        ((ref.x[s[q]:e[q]].numpy() - queries[q].astype(np.float64)) ** 2).sum(1))]
    v = judge(ref, queries, filters, far, dists, k)
    assert v.misses[q] == 1 and v.dist_err > 0.1

    swapped = dists.copy()  # answers out of order
    swapped[q, :2] = swapped[q, 1::-1]
    assert judge(ref, queries, filters, ids, swapped, k).invalid[q] >= 1

    gap = ids.copy()  # padding before an answer
    gap[q, 0] = PAD_ID
    assert judge(ref, queries, filters, gap, dists, k).invalid[q] >= 1


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11 + 2**-20, -3.0 - 2**-12, 1e-30])
    r = tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0 + 2**-10  # rounded to nearest, up
    assert r[3] == -3.0  # rounded to nearest, down
    bits = r.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()


def test_control_is_close_but_not_exact():
    points, labels, queries, filters = data(4, n=2000, d=128, nq=64)
    points *= 4.0  # distances of ~4e3, as far from 0 as the cells' in ulps
    queries *= 4.0
    ref = Reference(points, labels, "closed", "l2", "cpu")
    k = 10
    ids, dists = ref.control(queries, filters, k)
    v = judge(ref, queries, filters, ids, dists, k)
    assert v.invalid.sum() == 0
    assert v.recall.mean() > 0.9  # close ...
    assert v.dist_err > 1e-2  # ... but not float32


@pytest.mark.parametrize("metric", ["mips", "angular", "l2"])
def test_judge_takes_the_configured_distance(metric):
    """The exact answers under the configuration's metric are judged
    correct, distances and all; under the other metric they are not."""
    points, labels, queries, filters = data(5)
    ref = Reference(points, labels, "closed", metric, "cpu")
    ids, dists = answers(ref, queries, filters, 5)
    v = judge(ref, queries, filters, ids, dists, 5)
    assert v.invalid.sum() == 0 and v.misses.sum() == 0 and v.dist_err < 1e-5
    other = Reference(points, labels, "closed", "l2" if metric != "l2" else "mips", "cpu")
    assert judge(other, queries, filters, ids, dists, 5).dist_err > 0.1


def test_unknown_metric_is_refused():
    points, labels, _, _ = data(6)
    with pytest.raises(ValueError, match="unknown metric"):
        Reference(points, labels, "closed", "hamming", "cpu")
