"""The PyTorch port's point store and host planning against the JAX package.

Inputs are made with numpy from a seed and given to both packages; the
port's store must be bit-identical to the JAX PointSet (same padding, same
fused norm column, same norms), and the host helpers must agree exactly.
"""

import numpy as np
import pytest
import torch

import rangefilteredann_tpu.utils.data as J
import rangefilteredann_tpu_torch.utils.data as P


def assert_same_store(want, got):
    np.testing.assert_array_equal(np.asarray(want.data), got.data.numpy())
    np.testing.assert_array_equal(np.asarray(want.norms_sq), got.norms_sq.numpy())
    assert (want.n, want.d, want.metric, want.norm_col) == (
        got.n, got.d, got.metric, got.norm_col)
    assert want.d_pad == got.d_pad


@pytest.mark.parametrize("metric", ["Euclidian", "mips"])
@pytest.mark.parametrize("d", [24, 127, 128])
def test_float_store_bit_identical(metric, d):
    pts = np.random.default_rng(d).normal(size=(1300, d)).astype(np.float32)
    assert_same_store(J.make_pointset(pts, metric),
                      P.make_pointset(pts, metric, device="cpu"))


def test_float_streaming_ingest_bit_identical(monkeypatch):
    """The chunked float ingest (forced by the port's own threshold) gives
    the JAX package's single-copy store bit for bit."""
    pts = np.random.default_rng(5).normal(size=(9000, 37)).astype(np.float32)
    want = J.make_pointset(pts, "l2")
    monkeypatch.setattr(P, "_STREAM_INGEST_BYTES", 100_000)
    assert_same_store(want, P.make_pointset(pts, "l2", device="cpu"))


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
@pytest.mark.parametrize("chunked", [False, True])
def test_int_store_bit_identical(monkeypatch, dtype, chunked):
    """Byte stores keep their dtype with exact int32 square sums, also at
    d=512, where norms pass 2^24 (the fp32 rounding edge)."""
    rng = np.random.default_rng(7)
    lo, hi = (-128, 128) if dtype == np.int8 else (0, 256)
    pts = rng.integers(lo, hi, size=(700, 512)).astype(dtype)
    want = J.make_pointset(pts, "Euclidian")
    if chunked:
        monkeypatch.setattr(P, "_INT_INGEST_ROWS", 128)
    got = P.make_pointset(pts, "Euclidian", device="cpu")
    assert got.data.dtype == (torch.int8 if dtype == np.int8 else torch.uint8)
    assert_same_store(want, got)


@pytest.mark.parametrize("case", ["shuffled", "sorted_with_ties"])
def test_sort_by_labels_matches(case):
    rng = np.random.default_rng(11)
    n = 1200
    pts = rng.normal(size=(n, 8)).astype(np.float32)
    labels = np.round(rng.uniform(size=n), 2)  # ties
    if case == "sorted_with_ties":
        labels = np.sort(labels)
    want = J.sort_by_labels(pts, labels)
    got = P.sort_by_labels(pts, labels)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if case == "sorted_with_ties":  # the fast path hands back the caller's array
        assert got[0] is pts


def test_sort_by_labels_rejects_bad_labels():
    pts = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError):
        P.sort_by_labels(pts, np.zeros((4, 1)))
    with pytest.raises(ValueError):
        P.sort_by_labels(pts, np.zeros(3))


def test_first_geq_and_label_windows_match():
    rng = np.random.default_rng(13)
    labels = np.sort(np.round(rng.uniform(size=500), 3))
    values = np.concatenate([rng.uniform(-0.1, 1.1, size=200), labels[:20],
                             [-np.inf, np.inf]])
    np.testing.assert_array_equal(J.first_geq(labels, values),
                                  P.first_geq(labels, values))
    lo, hi = values[:100], values[100:200]
    for a, b in zip(J.label_range_to_window(labels, lo, hi),
                    P.label_range_to_window(labels, lo, hi)):
        np.testing.assert_array_equal(a, b)


def test_pad_queries_and_metric_names():
    q = np.random.default_rng(17).normal(size=(5, 24))
    np.testing.assert_array_equal(J.pad_queries(q, 24, 128),
                                  P.pad_queries(q, 24, 128))
    with pytest.raises(ValueError):
        P.pad_queries(q, 23, 128)
    for name in ["Euclidian", "euclidean", "L2", "mips", "ip", "angular"]:
        assert P.canonical_metric(name) == J.canonical_metric(name)
    with pytest.raises(ValueError):
        P.canonical_metric("cosine")
    assert [P.pad_dim(x) for x in (1, 128, 129)] == [128, 128, 256]
    assert (P.SCAN_ROW_PAD, P.LANE) == (J.SCAN_ROW_PAD, J.LANE)


def test_default_device_is_the_card():
    """device=None means CUDA, and asking for it without a card raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        assert P.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        P.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.make_pointset(np.zeros((4, 3), np.float32), "l2")
    assert P.resolve_device("cpu").type == "cpu"
