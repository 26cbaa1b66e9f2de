"""The v2 scan kernel's own CUDA source, on the CPU, in both of its modes.

csrc/scan_v2.cu runs only on the card, where no test runs. Here g++
compiles it with the headers it includes (the persistent item body
csrc/scan_items.cuh, which v3b shares, and csrc/scan_common.cuh) against
tests/cuda_emu/cuda_runtime.h: a fiber per CUDA thread, barriers for
a warp's collectives, cp.async copies made at once, and an mma.sync
m16n8k16 bf16 stand-in that takes and gives its fragments in the PTX
layout. The launch is the wrapper's own (tools/scan_items.launch: the
midpoint sort, the segment plan, the scratch, the ctypes call) on CPU
tensors. On grid-valued data (values j/8: exact in bf16, and every product
and partial sum exact in fp32, in any order) ids and distances must equal,
bit for bit:

* in fp32, the JAX package's tools/exp_scan2.scan_v2 in interpret mode;
* in bf16, scan_v2_plain(bf16=True), on the tensor-core product;

at each qblock (bf16: 16 and 32), k from 1 to 256, ties (every point 16
times), degenerate windows, tiles wider than a round (a partial round first,
the ring under the tile), and blocks cut into several segments with more
items than CTAs, those also with the items handed out last first, so that a
block's later segments publish their k-th distances before its earlier ones
run. Then scan_v2_config: the layout the caps compute, and what it refuses.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangefilteredann_tpu.utils.data import make_pointset as j_make_pointset
from rangefilteredann_tpu_torch import kernels
from rangefilteredann_tpu_torch import tools as PT
from rangefilteredann_tpu_torch.ops import scan as PS
from rangefilteredann_tpu_torch.ops.topk import EMPTY_ID
from rangefilteredann_tpu_torch.tools import exp_scan2 as P2
from rangefilteredann_tpu_torch.tools import scan_items as I
from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

from .cuda_emu import emulate
from .test_torch_scan_variants import load_jax_tool

EMU_SMS = 2  # tests/cuda_emu/cuda_runtime.h EMU_SMS, one CTA each


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's source (with the csrc/ headers it includes) built for
    the CPU, as a ctypes library."""
    return emulate.build("scan_v2", kernels.CSRC, tmp_path_factory.mktemp("scan_v2_emu"))


@pytest.fixture(scope="module")
def jax_scan_v2():
    return load_jax_tool("exp_scan2").scan_v2


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


# name: (store, n, d, queries, k, tile, qblock, bf16). The JAX kernel takes
# a batch of whole blocks (or one block of fewer queries), so the fp32 cases'
# query counts are multiples of qblock or below it; d = 24 and 40 are no
# multiple of the 16-dim stage, 24 none of the 8-dim one (qblock 8).
CASES = {
    "qb8-k10-d24": ("grid", 1300, 24, 40, 10, 256, 8, False),
    "qb16-k1-d40": ("grid", 2000, 40, 48, 1, 512, 16, False),
    "qb32-k256-d16": ("grid", 520, 16, 12, 256, 256, 32, False),
    # a tile of a partial round (512) and a full one (1024), the ring under it
    "qb32-k33-t1536": ("grid", 5000, 24, 32, 33, 1536, 32, False),
    "dup16-qb16-k10": ("dup16", 1536, 8, 32, 10, 256, 16, False),
    # blocks cut into several segments, more items than CTAs; copies 640
    # rows apart, in other segments: ties across items
    "split-dup16-qb16-k2": ("dup16", 10_240, 8, 32, 2, 256, 16, False),
    "split-qb8-k40": ("grid", 6000, 24, 24, 40, 512, 8, False),
    "bf16-qb16-k10-d24": ("grid", 1300, 24, 40, 10, 512, 16, True),
    "bf16-qb32-k1-d40": ("grid", 2000, 40, 70, 1, 256, 32, True),
    "bf16-qb32-k256-d16": ("grid", 520, 16, 9, 256, 256, 32, True),
    # a partial round (1024) and a full one (2048) under a one-stage ring
    "bf16-qb16-k20-t3072": ("grid", 7000, 16, 40, 20, 3072, 16, True),
    "bf16-dup16-qb32-k10": ("dup16", 1536, 8, 40, 10, 256, 32, True),
    "bf16-split-qb32-k20": ("grid", 12_000, 24, 40, 20, 256, 32, True),
    "bf16-split-dup16-qb16-k2": ("dup16", 10_240, 8, 40, 2, 256, 16, True),
}
ORDERS = [(name, "planned") for name in sorted(CASES)] + [
    (name, "reversed") for name in sorted(CASES) if "split" in name]


def _case(name):
    kind, n, d, nq, k, tile, qblock, bf16 = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    pts, q = _grid(rng, (n, d)), _grid(rng, (nq, d))
    if kind == "dup16":  # every point 16 times: exact ties
        pts = np.tile(_grid(rng, (n // 16, d)), (16, 1))
    s, e = _windows(rng, n, nq, k, min_width=n // 3 if "split" in name else 0)
    return pts, q, s, e, k, tile, qblock, bf16


@pytest.mark.parametrize("name,order", ORDERS)
def test_emulated_kernel_matches(emulated, jax_scan_v2, name, order, monkeypatch):
    if order == "reversed":
        plan = PS.segment_plan

        def reversed_plan(*args, **kw):
            tb, te, prefix, seg, code, cap = plan(*args, **kw)
            n = int(prefix[-1])
            return tb, te, prefix, seg, torch.cat([code[:n].flip(0), code[n:]]), cap

        monkeypatch.setattr(PS, "segment_plan", reversed_plan)
    pts, q, s, e, k, tile, qblock, bf16 = _case(name)
    ps = make_pointset(pts, "l2", device="cpu")
    qp = torch.from_numpy(pad_queries(q, pts.shape[1], ps.d_pad))
    st, en = torch.from_numpy(s), torch.from_numpy(e)
    got_d, got_i, plan = I.launch(emulated, "scan_v2", ps.data, ps.norms_sq, qp, st, en, k,
                                  ps.norm_col, tile, qblock, 1, int(bf16), None)
    if bf16:
        want_d, want_i = P2.scan_v2_plain(ps.data, ps.norms_sq, qp, st, en, k, bf16=True,
                                          d_eff=ps.norm_col)
        want_d, want_i = want_d.numpy(), want_i.numpy()
    else:
        jps = j_make_pointset(pts, "l2")
        jq = pad_queries(q, pts.shape[1], jps.d_pad)
        want_d, want_i = (np.asarray(x) for x in jax_scan_v2(
            jps.data, jps.norms_sq, jnp.asarray(jq), jnp.asarray(s), jnp.asarray(e), k,
            tile=tile, d_eff=pts.shape[1], interpret=True, qblock=qblock))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert got_i[0].tolist() == [EMPTY_ID] * k  # the empty window
    tile_begin, tile_end, prefix, seg, _, max_items = plan
    assert int(prefix[-1]) <= max_items
    if "split" in name:  # blocks cut into several segments, more items than CTAs
        assert int(seg[0]) < int((tile_end - tile_begin).max()) and int(prefix[-1]) > EMU_SMS


def test_emulated_config_matches_the_layout(emulated):
    """scan_v2_config reports the layout the wrapper's caps compute, in both
    modes, and refuses what the caps refuse: bf16 at qblock 8, MIPS, tiles
    off the 256-point step, qblocks other than 8, 16 and 32."""
    out = (ctypes.c_int * 8)()
    fn = I.bind(emulated, "scan_v2")[1]
    for bf16 in (0, 1):
        for qblock in (8, 16, 32):
            for tile in (256, 1024, 2048, 3072, 4096):
                for k in (1, 32, 256):
                    rc = fn(qblock, tile, k, 1, bf16, out)
                    lay = I.layout(tile, qblock, k)
                    if lay["total"] > I.MAX_SMEM or (bf16 and qblock == 8):
                        assert rc == -1, (bf16, qblock, tile, k)
                        continue
                    assert rc == 0, (bf16, qblock, tile, k)
                    assert (out[4], out[6], out[7]) == (lay["total"], lay["stages"],
                                                        lay["separate"]), (qblock, tile, k)
    assert fn(16, 1024, 10, 0, 0, out) == -1  # L2 only
    assert fn(12, 1024, 10, 1, 0, out) == -1 and fn(16, 640, 10, 1, 0, out) == -1
