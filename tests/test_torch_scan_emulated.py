"""The scan kernel's own CUDA source, run on the CPU, against its plain version.

csrc/scan_topk.cu runs only on the card, where no test runs. Here g++
compiles it, with the csrc/ headers it includes (tests/cuda_emu/emulate.py),
against tests/cuda_emu/cuda_runtime.h, which stands a thread in
for each CUDA thread and meets a warp's collectives at a barrier. The
persistent scan kernel's CTAs run all at once and share the work counter;
the merge kernel's run one after another; cp.async copies are made at once.
The launch is the wrapper's own (ops/scan.launch): the midpoint sort, the
segment plan, the scratch and the ctypes call, on CPU tensors. On
grid-valued data (values j/8) and on byte stores with integer queries every
distance is exact in float32 whatever the summation order, so ids and
distances must equal, bit for bit, both the port's
ops/bruteforce.scan_bruteforce and the JAX package's scan_bruteforce on the
same inputs: the
windows (empty, at the store's end, the whole store), the (dist, id) order
of ties across warps and segments, both list configurations (k <= 32 and
above), and blocks cut into several segments with more items than CTAs.
Those split cases run twice: in the plan's item order and last item first,
so that the k-th distances a block's later segments publish prune its
earlier ones (a bound that dropped a tie at the k-th distance fails the
dup16 split case there).
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangefilteredann_tpu.ops import bruteforce as JB
from rangefilteredann_tpu.utils.data import make_pointset as j_make_pointset
from rangefilteredann_tpu_torch import kernels
from rangefilteredann_tpu_torch.ops import scan as PS
from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

from .cuda_emu import emulate

EMU_SMS = 2  # tests/cuda_emu/cuda_runtime.h EMU_SMS, one CTA each


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's source (with the csrc/ headers it includes) built for
    the CPU, as a ctypes library."""
    return emulate.build("scan_topk", kernels.CSRC, tmp_path_factory.mktemp("scan_emu"))


def _grid(rng, shape):
    return (np.round(rng.normal(size=shape) * 8) / 8).astype(np.float32)


def _windows(rng, n, nq, min_width=0):
    s = rng.integers(0, n, size=nq).astype(np.int32)
    e = np.minimum(s + rng.integers(min_width, n + 1, size=nq), n).astype(np.int32)
    e[:2] = s[:2]  # empty windows
    e[2:4] = n  # windows touching the store's end
    s[4:6], e[4:6] = 0, n  # the whole store
    return s, e


def _case(name):
    """(points, queries, starts, ends, k, metric) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    kind, metric, n, d, nq, k = CASES[name]
    if kind == "fp32":
        pts, q = _grid(rng, (n, d)), _grid(rng, (nq, d))
    else:  # a byte store, integer queries
        lo = -128 if kind == "int8" else 0
        pts = rng.integers(lo, lo + 256, size=(n, d)).astype(np.int8 if kind == "int8" else np.uint8)
        q = rng.integers(-20, 20, size=(nq, d)).astype(np.float32)
    if kind == "dup16":  # every point 16 times, in tiles of 96 rows: exact ties
        pts = np.tile(_grid(rng, (n // 16, d)), (16, 1))
        s, e = np.zeros(nq, np.int32), np.full(nq, n, np.int32)
    else:
        s, e = _windows(rng, n, nq, min_width=n // 3 if "split" in name else 0)
    return pts, q, s, e, k, metric


CASES = {
    # name: (store, metric, n, d, queries, k); d = 24 and 100 are no
    # multiple of the 16-dim chunk
    "fp32-l2-k10-d24": ("fp32", "l2", 1300, 24, 40, 10),
    "fp32-mips-k10-d24": ("fp32", "mips", 1300, 24, 40, 10),
    "fp32-l2-k1-d40": ("fp32", "l2", 2000, 40, 70, 1),
    "fp32-mips-k256-d16": ("fp32", "mips", 520, 16, 9, 256),
    "fp32-l2-k33-d24": ("fp32", "l2", 1300, 24, 24, 33),
    "int8-l2-k10-d100": ("int8", "l2", 1500, 100, 40, 10),
    "uint8-mips-k10-d32": ("uint8", "mips", 1500, 32, 40, 10),
    "dup16-l2-k10-d8": ("dup16", "l2", 1536, 8, 40, 10),
    "dup16-l2-k100-d8": ("dup16", "l2", 1536, 8, 8, 100),
    # copies 1,280 rows apart, in other segments: ties across items
    "dup16-l2-k2-d8-split": ("dup16", "l2", 20_480, 8, 40, 2),
    "fp32-l2-k10-d24-split": ("fp32", "l2", 20_000, 24, 70, 10),
    "fp32-mips-k40-d24-split": ("fp32", "mips", 9000, 24, 33, 40),
}


# every case in the plan's item order; the split cases also with the items
# handed out last first, so that a block's later segments run, and publish
# their bounds, before its earlier ones
ORDERS = [(name, "planned") for name in sorted(CASES)] + [
    (name, "reversed") for name in sorted(CASES) if "split" in name]


@pytest.mark.parametrize("name,order", ORDERS)
def test_emulated_kernel_matches_plain(emulated, name, order, monkeypatch):
    if order == "reversed":
        plan = PS.segment_plan

        def reversed_plan(*args, **kw):
            tb, te, prefix, seg, code, cap = plan(*args, **kw)
            n = int(prefix[-1])
            code = torch.cat([code[:n].flip(0), code[n:]])
            return tb, te, prefix, seg, code, cap

        monkeypatch.setattr(PS, "segment_plan", reversed_plan)
    pts, q, s, e, k, metric = _case(name)
    ps = make_pointset(pts, metric, device="cpu")
    d_eff = ps.norm_col if ps.norm_col >= 0 else ps.d_pad
    qp = torch.from_numpy(pad_queries(q, pts.shape[1], ps.d_pad))
    st, en = torch.from_numpy(s), torch.from_numpy(e)
    got_d, got_i, plan = PS.launch(emulated, ps.data, ps.norms_sq, qp, st, en, k, metric,
                                   d_eff, None)
    want_d, want_i = scan_bruteforce(ps.data, ps.norms_sq, qp, st, en, k, metric)
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())
    jps = j_make_pointset(pts, metric)
    jq = pad_queries(q, pts.shape[1], jps.d_pad)
    jd, ji = JB.scan_bruteforce(jps.data, jps.norms_sq, jnp.asarray(jq), jnp.asarray(s),
                                jnp.asarray(e), k=k, metric=metric)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(jd))
    tile_begin, tile_end, prefix, seg, _, max_items = plan
    items = int(prefix[-1])
    assert items <= max_items
    if "split" in name:  # blocks cut into several segments, more items than CTAs
        assert int(seg[0]) < int((tile_end - tile_begin).max()) and items > EMU_SMS
