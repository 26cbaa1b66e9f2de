"""The v3 scan kernel's own CUDA source, on the CPU.

csrc/scan_v3.cu runs only on the card, where no test runs. Here g++ compiles
it with the headers it includes (the persistent item body
csrc/scan_items.cuh, which v2 and v3b share, and csrc/scan_common.cuh)
against tests/cuda_emu/cuda_runtime.h (a fiber per CUDA thread,
barriers for a warp's collectives, cp.async copies made at once), and runs
it through the wrapper's own launch (tools/scan_items.launch: the midpoint
sort, the plan, the scratch, the ctypes call) on CPU tensors, on the cases
of tests/test_torch_scan_v3b.py: grid-valued data (values j/8, every
distance exact in float32 in any summation order), each qblock, both
metrics, k from 1 to 256, ties (every point 16 times), every ring mode, and
blocks cut into several segments, those also with the items handed out last
first, so that a block's later segments publish their k-th distances before
its earlier ones run. Ids and distances must equal, bit for bit, the port's
and the JAX package's scan_bruteforce, and on two cases the JAX package's
tools/exp_scan3.scan_v3 in interpret mode. Then scan_v3_config: the layout
the caps compute, and what it refuses.
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
from rangefilteredann_tpu_torch.ops import scan as PS
from rangefilteredann_tpu_torch.ops.bruteforce import scan_bruteforce
from rangefilteredann_tpu_torch.ops.topk import EMPTY_ID
from rangefilteredann_tpu_torch.tools import scan_items as I
from rangefilteredann_tpu_torch.utils.data import make_pointset, pad_queries

from .cuda_emu import emulate
from .test_torch_scan_v3b import MODES, ORDERS, _case
from .test_torch_scan_variants import load_jax_tool

EMU_SMS = 2  # tests/cuda_emu/cuda_runtime.h EMU_SMS, one CTA each
# cases also held against the JAX v3 kernel (which takes whole blocks of
# queries: the first n queries of each case)
JAX_CASES = {"qb8-l2-k10-d24": 40, "qb16-mips-k10-d24": 32}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's source (with the csrc/ headers it includes) built for
    the CPU, as a ctypes library."""
    return emulate.build("scan_v3", kernels.CSRC, tmp_path_factory.mktemp("scan_v3_emu"))


def _launch(lib, name, monkeypatch, order):
    """The case's inputs, and the emulated kernel's (dists, ids, plan) on
    them, with the items handed out as planned or last first."""
    if order == "reversed":
        plan = PS.segment_plan

        def reversed_plan(*args, **kw):
            tb, te, prefix, seg, code, cap = plan(*args, **kw)
            n = int(prefix[-1])
            return tb, te, prefix, seg, torch.cat([code[:n].flip(0), code[n:]]), cap

        monkeypatch.setattr(PS, "segment_plan", reversed_plan)
    pts, q, s, e, k, metric, tile, qblock, _ = _case(name)  # v3 takes no unroll
    ps = make_pointset(pts, metric, device="cpu")
    qp = torch.from_numpy(pad_queries(q, pts.shape[1], ps.d_pad))
    st, en = torch.from_numpy(s), torch.from_numpy(e)
    out = I.launch(lib, "scan_v3", ps.data, ps.norms_sq, qp, st, en, k, ps.norm_col, tile,
                   qblock, int(metric == "l2"), 1, None)
    return (pts, q, s, e, k, metric, tile, qblock, ps, qp, st, en), out


@pytest.mark.parametrize("name,order", ORDERS)
def test_emulated_kernel_matches_plain(emulated, name, order, monkeypatch):
    case, (got_d, got_i, plan) = _launch(emulated, name, monkeypatch, order)
    pts, q, s, e, k, metric, tile, qblock, ps, qp, st, en = case
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
    cfg = I.launch_config(emulated, "scan_v3", qblock, tile, k, int(metric == "l2"), 1)
    assert (cfg["stages"], cfg["separate"]) == MODES.get(name, (cfg["stages"], cfg["separate"]))


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_emulated_kernel_matches_jax_v3(emulated, name, monkeypatch):
    """The JAX package's v3 kernel (interpret mode) on the case's first
    JAX_CASES[name] queries, a whole number of its blocks: the same ids and
    distances, bit for bit."""
    case, (got_d, got_i, _) = _launch(emulated, name, monkeypatch, "planned")
    pts, q, s, e, k, metric, tile, qblock, *_ = case
    m = JAX_CASES[name]
    assert m % qblock == 0
    jps = j_make_pointset(pts, metric)
    jq = pad_queries(q[:m], pts.shape[1], jps.d_pad)
    jd, ji = load_jax_tool("exp_scan3").scan_v3(
        jps.data, jps.norms_sq, jnp.asarray(jq), jnp.asarray(s[:m]), jnp.asarray(e[:m]), k,
        metric=metric, tile=tile, d_eff=pts.shape[1], interpret=True, qblock=qblock)
    np.testing.assert_array_equal(got_i[:m].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got_d[:m].numpy(), np.asarray(jd))


def test_emulated_config_matches_the_layout(emulated):
    """scan_v3_config reports the layout the wrapper's caps compute, for
    both metrics, and refuses exactly what they refuse."""
    out = (ctypes.c_int * 8)()
    fn = I.bind(emulated, "scan_v3")[1]
    for qblock in (8, 16, 32):
        for tile in range(256, 4097, 256):
            for k in (1, 10, 100, 256):
                lay = I.layout(tile, qblock, k)
                for metric_l2 in (0, 1):
                    rc = fn(qblock, tile, k, metric_l2, 1, out)
                    if lay["total"] > I.MAX_SMEM:
                        assert rc == -1, (qblock, tile, k)
                        continue
                    assert rc == 0, (qblock, tile, k)
                    assert (out[4], out[6], out[7]) == (lay["total"], lay["stages"],
                                                        lay["separate"]), (qblock, tile, k)
    assert fn(12, 1024, 10, 1, 1, out) == -1 and fn(16, 640, 10, 1, 1, out) == -1
    assert fn(16, 1024, 0, 1, 1, out) == -1 and fn(16, 1024, 257, 0, 1, out) == -1
