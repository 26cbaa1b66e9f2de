"""The PyTorch port's graph-search ops against the JAX package's.

The same numpy inputs (made from a seed) go through both packages on the
CPU: batched_beam_search in query mode (inline fp32 / bf16 / int8 with a
scale / native int8 blocks, plain gathers, degree_limit, cut pruning,
exclude, inactive queries) and build mode (expand > 1, visited lists),
window_filter_topk, exact_rerank, the frontier merges, robust_prune, and the
beam kernel's CPU path against the Pallas kernel in TPU interpret mode. Ids
and counters must match exactly, distances within rtol 1e-5 / atol 1e-4.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rangefilteredann_tpu.models import vamana as JV
from rangefilteredann_tpu.ops import beam_search as JB
from rangefilteredann_tpu.ops import pallas_beam as JPB
from rangefilteredann_tpu.ops.distances import gathered_distances as j_gathered
from rangefilteredann_tpu.ops.robust_prune import robust_prune as j_robust_prune
from rangefilteredann_tpu.utils.data import make_pointset as j_pointset
from rangefilteredann_tpu_torch.models import vamana as PV
from rangefilteredann_tpu_torch.ops import beam as PBEAM
from rangefilteredann_tpu_torch.ops import beam_search as PB
from rangefilteredann_tpu_torch.ops.robust_prune import robust_prune as p_robust_prune
from rangefilteredann_tpu_torch.ops.topk import EMPTY_ID
from rangefilteredann_tpu_torch.utils.data import make_pointset as p_pointset
from rangefilteredann_tpu_torch.utils.data import pad_queries

from .oracle import random_graph, robust_prune_oracle

RTOL, ATOL = 1e-5, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def assert_same_arrays(want, got, names):
    for w, g, name in zip(want, got, names):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert w.shape == g.shape, (name, w.shape, g.shape)
        if w.dtype.kind == "f":
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
            np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def assert_same_beam(want, got):
    assert_same_arrays(want, got, JB.BeamResult._fields)


def _graph_case(seed, n=300, d=16, r=8, q=20, metric="l2", clustered=False,
                kind="float"):
    rng = np.random.default_rng(seed)
    if kind == "int8":
        pts = rng.integers(-60, 60, size=(n, d)).astype(np.int8)
        queries = rng.integers(-60, 60, size=(q, d)).astype(np.float32)
    elif clustered:
        centers = rng.normal(size=(20, d)).astype(np.float32)
        pts = (centers[rng.integers(0, 20, n)]
               + 0.2 * rng.normal(size=(n, d))).astype(np.float32)
        queries = rng.normal(size=(q, d)).astype(np.float32)
    else:
        pts = rng.normal(size=(n, d)).astype(np.float32)
        queries = rng.normal(size=(q, d)).astype(np.float32)
    nbrs = random_graph(rng, n, r)
    jps, pps = j_pointset(pts, metric), p_pointset(pts, metric, device="cpu")
    qp = pad_queries(queries, d, pps.d_pad)
    return rng, queries, nbrs, jps, pps, qp


def _run_both(jps, pps, nbrs, qp, starts, *, inline=None, **kw):
    """The same search through both packages; `inline` = (jax blocks, port
    blocks) as (nbr_vecs, nbr_norms, nbr_scale) triples."""
    n = nbrs.shape[0]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    pkw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    if "cut" in kw:
        jkw["cut"] = jnp.float32(kw["cut"])
    if inline is not None:
        (jv, jn, js), (pv, pn, ps_) = inline
        jkw.update(nbr_vecs=jv, nbr_norms=jn, nbr_scale=js)
        pkw.update(nbr_vecs=pv, nbr_norms=pn, nbr_scale=ps_)
    norm_col = jps.norm_col if jps.norm_col >= 0 else None
    want = JB.batched_beam_search(
        jps.data, jps.norms_sq, jnp.asarray(nbrs), jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(qp), jnp.asarray(starts), norm_col=norm_col,
        identity_map=True, limit=jnp.int32(kw.pop("limit", 10_000)),
        **{k: v for k, v in jkw.items() if k != "limit"})
    got = PB.batched_beam_search(
        pps.data, pps.norms_sq, t(nbrs), torch.arange(n, dtype=torch.int32),
        t(qp), t(starts), norm_col=norm_col, identity_map=True,
        limit=pkw.pop("limit", 10_000), **pkw)
    return want, got


QUERY_CASES = {
    # name: (graph-case kwargs, search kwargs)
    "l2-beam4": ({}, dict(beam=4)),
    "l2-beam16": ({}, dict(beam=16)),
    "mips-beam16": ({"metric": "mips"}, dict(beam=16)),
    "l2-limit5": ({}, dict(beam=8, limit=5)),
    "l2-degree-limit3": ({"r": 12}, dict(beam=16, degree_limit=3)),
    "l2-cut-k5": ({"clustered": True}, dict(beam=16, k=5, cut=1.35)),
    "mips-cut-k5-ignored": ({"metric": "mips"}, dict(beam=16, k=5, cut=1.35)),
    "l2-exclude": ({}, dict(beam=16, exclude=np.full(20, 7, np.int32))),
    "int8-store-l2": ({"kind": "int8"}, dict(beam=16)),
}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_query_mode_matches_jax(case):
    gkw, skw = QUERY_CASES[case]
    rng, queries, nbrs, jps, pps, qp = _graph_case(len(case), **gkw)
    q = len(queries)
    starts = rng.integers(0, nbrs.shape[0], size=q).astype(np.int32)
    active = np.ones(q, dtype=bool)
    active[[2, 11]] = False  # padded queries stay empty
    kw = dict(k=0, cut=1.35, metric=jps.metric, active_in=active,
              q_norms_sq=np.einsum("qd,qd->q", queries, queries))
    kw.update(skw)
    want, got = _run_both(jps, pps, nbrs, qp, starts, **kw)
    assert_same_beam(want, got)
    assert (got.frontier_ids[2] == EMPTY_ID).all() and got.num_visited[2] == 0
    if "exclude" in skw:
        assert not (got.frontier_ids == 7).any()


def _inline_blocks(jps, pps, nbrs, kind):
    """Inline blocks attached by each package's SlabGraph.attach_inline."""
    n = nbrs.shape[0]
    jg = JV.SlabGraph(jnp.asarray(nbrs), jnp.arange(n, dtype=jnp.int32), nbrs,
                      (nbrs >= 0).sum(1).astype(np.int32), np.array([0, n]),
                      np.arange(n), True)
    pg = PV.SlabGraph(t(nbrs), torch.arange(n, dtype=torch.int32), nbrs,
                      (nbrs >= 0).sum(1).astype(np.int32), np.array([0, n]),
                      np.arange(n), True)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8q": jnp.int8,
           "byte": jps.data.dtype}[kind]
    pdt = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8q": torch.int8,
           "byte": pps.data.dtype}[kind]
    jg.attach_inline(jps, jdt)
    pg.attach_inline(pps, pdt)
    assert pg.inline_bytes(pps, pdt) == jg.inline_bytes(jps, jdt)
    assert_same_arrays([jg.nbr_vecs.astype(jnp.float32), jg.nbr_norms],
                       [pg.nbr_vecs.float(), pg.nbr_norms], ["vecs", "norms"])
    if kind == "int8q":
        np.testing.assert_array_equal(pg.nbr_scale.numpy(), np.asarray(jg.nbr_scale))
    return jg, pg


@pytest.mark.parametrize("kind,metric", [("fp32", "l2"), ("fp32", "mips"),
                                         ("bf16", "l2"), ("int8q", "l2"),
                                         ("int8q", "mips"), ("byte", "l2")])
def test_inline_blocks_match_jax(kind, metric):
    """Inline-block searches, the query path of the postfilter; int8q is the
    quantized form with a per-node scale, `byte` a native int8 store."""
    rng, queries, nbrs, jps, pps, qp = _graph_case(
        40 + len(kind), n=400, d=24, r=10, metric=metric, clustered=True,
        kind="int8" if kind == "byte" else "float")
    jg, pg = _inline_blocks(jps, pps, nbrs, kind)
    starts = np.zeros(len(queries), dtype=np.int32)
    want, got = _run_both(
        jps, pps, nbrs, qp, starts,
        inline=((jg.nbr_vecs, jg.nbr_norms, jg.nbr_scale),
                (pg.nbr_vecs, pg.nbr_norms, pg.nbr_scale)),
        beam=24, k=0, cut=1.35, metric=metric)
    assert_same_beam(want, got)


@pytest.mark.parametrize("expand,beam", [(4, 16), (6, 24)])
def test_build_mode_matches_jax(expand, beam):
    """Insertion searches of a build: multi-expansion, visited lists in
    visit order, the inserted node excluded."""
    rng, queries, nbrs, jps, pps, qp = _graph_case(60 + expand, n=400, r=10)
    q = len(queries)
    starts = np.zeros(q, dtype=np.int32)
    ins = rng.choice(400, size=q, replace=False).astype(np.int32)
    want, got = _run_both(
        jps, pps, nbrs, qp, starts, beam=beam, k=0, cut=1.0, metric="l2",
        exclude=ins, return_visited=True, visited_cap=int(1.25 * beam) + 64,
        expand=expand, limit=400)
    assert_same_beam(want, got)
    assert got.visited_ids.shape == (q, int(1.25 * beam) + 64)


def test_beam_search_oracle_exact_visits():
    """Without cut pruning the search equals the exact-seen-set oracle,
    frontier, visit order and visit count (tests/test_beam_search.py)."""
    from .oracle import beam_search_oracle

    rng, queries, nbrs, _, pps, qp = _graph_case(5)
    res = PB.batched_beam_search(
        pps.data, pps.norms_sq, t(nbrs), torch.arange(300, dtype=torch.int32),
        t(qp), torch.zeros(20, dtype=torch.int32), beam=16, k=0, cut=10.0,
        limit=10_000, metric="l2", return_visited=True, visited_cap=400,
        norm_col=pps.norm_col)
    for qi in range(20):
        frontier, visited, _ = beam_search_oracle(
            queries[qi], nbrs, pps.data[:300, :16].numpy(), 0, 16, k=0,
            cut=10.0, limit=10_000, metric="l2")
        ids = [e[0] for e in frontier]
        assert res.frontier_ids[qi, :len(ids)].tolist() == ids
        assert res.visited_ids[qi, :len(visited)].tolist() == [e[0] for e in visited]
        assert int(res.num_visited[qi]) == len(visited)


_J_MERGE = jax.jit(JB._merge_frontier_cands, static_argnums=5)
_J_MERGE_SORT = jax.jit(JB._merge_dedup_sort, static_argnums=3)


@pytest.mark.parametrize("beam,c", [(4, 3), (16, 8), (40, 48)])
def test_merges_match_jax(beam, c):
    """Both frontier merges on inputs with duplicate candidates (of the
    frontier and among themselves), EMPTY padding and distance ties."""
    rng = np.random.default_rng(beam + c)
    q = 6
    for trial in range(4):
        f_ids = np.full((q, beam), EMPTY_ID, dtype=np.int32)
        f_d = np.full((q, beam), np.inf, dtype=np.float32)
        f_e = np.zeros((q, beam), dtype=np.int32)
        for i in range(q):
            r = int(rng.integers(0, beam + 1))
            ids = rng.choice(1000, size=r, replace=False).astype(np.int32)
            d = (rng.integers(0, 6, size=r) * 0.25).astype(np.float32)
            order = np.lexsort((ids, d))
            f_ids[i, :r], f_d[i, :r] = ids[order], d[order]
            f_e[i, :r] = rng.integers(0, 2, size=r)
        c_ids = rng.integers(0, 1000, size=(q, c)).astype(np.int32)
        c_d = (rng.integers(0, 6, size=(q, c)) * 0.25).astype(np.float32)
        kill = rng.random((q, c)) < 0.3
        c_ids = np.where(kill, EMPTY_ID, c_ids).astype(np.int32)
        c_d = np.where(kill, np.inf, c_d).astype(np.float32)
        c_ids[:, 0] = np.where(f_ids[:, 0] != EMPTY_ID, f_ids[:, 0], c_ids[:, 0])
        if c > 2:
            c_ids[:, 2], c_d[:, 2] = c_ids[:, 1], c_d[:, 1]
        args = (f_ids, f_d, f_e, c_ids, c_d)
        want = _J_MERGE(*map(jnp.asarray, args), beam)
        got = PB._merge_frontier_cands(*map(t, args), beam)
        assert_same_arrays(want, got, ["ids", "dists", "expl"])
        cat = [np.concatenate([f_ids, c_ids], 1), np.concatenate([f_d, c_d], 1),
               np.concatenate([f_e, np.zeros_like(c_ids)], 1)]
        want = _J_MERGE_SORT(*map(jnp.asarray, cat), beam)
        got = PB._merge_dedup_sort(*map(t, cat), beam)
        assert_same_arrays(want, got, ["ids", "dists", "expl"])


def test_window_filter_topk_and_exact_rerank_match_jax():
    rng = np.random.default_rng(3)
    m, q, b, k = 500, 6, 32, 10
    s2g = np.sort(rng.choice(5000, size=m, replace=False)).astype(np.int32)
    for trial in range(10):
        f_ids = np.full((q, b), EMPTY_ID, dtype=np.int32)
        f_d = np.full((q, b), np.inf, dtype=np.float32)
        for i in range(q):
            r = int(rng.integers(0, b + 1))
            ids = rng.choice(m, size=r, replace=False).astype(np.int32)
            d = (rng.integers(0, 5, size=r) * 0.5).astype(np.float32)
            order = np.lexsort((ids, d))
            f_ids[i, :r], f_d[i, :r] = ids[order], d[order]
        lo = rng.integers(0, 4000, size=q).astype(np.int32)
        hi = (lo + rng.integers(0, 3000, size=q)).astype(np.int32)
        args = (f_ids, f_d, s2g, lo, hi)
        want = JB.window_filter_topk(*map(jnp.asarray, args), k)
        got = PB.window_filter_topk(*map(t, args), k)
        assert_same_arrays(want, got, ["counts", "gids", "dists"])

    pts = rng.normal(size=(900, 24)).astype(np.float32)
    queries = pad_queries(rng.normal(size=(q, 24)).astype(np.float32), 24, 128)
    gids = rng.integers(0, 900, size=(q, 18)).astype(np.int32)
    gids[:, -3:] = EMPTY_ID
    for metric in ("l2", "mips"):
        jps, pps = j_pointset(pts, metric), p_pointset(pts, metric, device="cpu")
        for norm_col in (jps.norm_col, None):
            want = JB.exact_rerank(jps.data, jps.norms_sq, jnp.asarray(queries),
                                   jnp.asarray(gids), k, metric, norm_col=norm_col)
            got = PB.exact_rerank(pps.data, pps.norms_sq, t(queries), t(gids), k,
                                  metric, norm_col=norm_col)
            assert_same_arrays(want, got, ["gids", "dists"])


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_robust_prune_matches_oracle_and_jax(metric):
    rng = np.random.default_rng(11 + len(metric))
    n, d, c, r, m = 200, 8, 32, 8, 16
    points = rng.normal(size=(n, d)).astype(np.float32)
    jps, pps = j_pointset(points, metric), p_pointset(points, metric, device="cpu")
    p_slab = rng.choice(n, size=m, replace=False).astype(np.int32)
    cand = np.stack([rng.choice(n, size=c, replace=False) for _ in range(m)]
                    ).astype(np.int32)
    cand[:, -4:] = -1  # padding
    cand[0, 3] = p_slab[0]  # the node itself is ignored
    want = j_robust_prune(jps.data, jps.norms_sq, jnp.arange(n, dtype=jnp.int32),
                          jnp.asarray(p_slab), jnp.asarray(cand), jnp.float32(1.2),
                          R=r, metric=metric, norm_col=jps.norm_col)
    got = p_robust_prune(pps.data, pps.norms_sq, torch.arange(n, dtype=torch.int32),
                         t(p_slab), t(cand), 1.2, R=r, metric=metric,
                         norm_col=pps.norm_col)
    assert_same_arrays(want, got, ["ids", "dists"])
    if metric == "l2":
        for i in range(m):
            cd = [(int(x), float(np.dot(points[p_slab[i]] - points[x],
                                        points[p_slab[i]] - points[x])))
                  for x in cand[i] if x >= 0]
            want_i = robust_prune_oracle(int(p_slab[i]), cd, points, 1.2, r, "l2")
            assert [int(x) for x in got[0][i] if x >= 0] == want_i


def _pallas_slab(rng, m, r, w):
    """tests/test_pallas_beam.py's random slab: data, norms, sorted
    adjacency, fp32 inline blocks."""
    data = rng.normal(size=(m, w)).astype(np.float32)
    norms = np.einsum("ij,ij->i", data, data).astype(np.float32)
    nbrs = np.full((m, r), -1, dtype=np.int32)
    for i in range(m):
        cand = rng.choice(m, size=rng.integers(1, r + 1), replace=False)
        cand = cand[cand != i]
        nbrs[i, :len(cand)] = np.sort(cand)
    safe = np.clip(nbrs, 0, m - 1)
    return data, norms, nbrs, data[safe], norms[safe]


@pytest.mark.parametrize("metric,r,beam,limit,blocks", [
    ("l2", 5, 8, 10_000, "fp32"),
    ("mips", 48, 40, 7, "fp32"),
    ("l2", 24, 16, 10_000, "bf16"),
    ("l2", 5, 8, 100, "inactive"),
])
def test_beam_kernel_cpu_path_matches_pallas_interpret(metric, r, beam, limit,
                                                       blocks):
    """The wrapper's CPU path (the kernel's plain version) against the Pallas
    kernel run as tests/test_pallas_beam.py runs it, on cases of its grid."""
    rng = np.random.default_rng(42 + r + beam)
    m, w, q, qb = 300, 128, 16, 8
    data, norms, nbrs, vecs, nrm = _pallas_slab(rng, m, r, w)
    queries = rng.normal(size=(q, w)).astype(np.float32)
    starts = rng.integers(0, m, size=q).astype(np.int32)
    active = np.ones(q, dtype=bool)
    active[q - 3:] = False
    if blocks == "inactive":
        active[:] = False
    jvecs = jnp.asarray(vecs).astype(jnp.bfloat16 if blocks == "bf16" else jnp.float32)
    d0 = j_gathered(jnp.asarray(queries), jnp.asarray(data)[starts][:, None, :],
                    jnp.asarray(norms)[starts][:, None], metric)[:, 0]
    want = JPB.pallas_beam_search_inline(
        jvecs, JPB.build_meta(jnp.asarray(nbrs), jnp.asarray(nrm)),
        jnp.asarray(queries), jnp.asarray(starts), d0, jnp.asarray(active),
        beam=beam, limit=limit, metric=metric, interpret=True, qb=qb)
    pvecs = t(vecs).to(torch.bfloat16 if blocks == "bf16" else torch.float32)
    before = PBEAM.BEAM_LAUNCHES
    got = PBEAM.beam_search_inline(
        pvecs, t(nbrs), t(nrm), None, t(queries), t(starts), t(np.asarray(d0)),
        t(active), beam=beam, limit=limit, metric=metric)
    assert PBEAM.BEAM_LAUNCHES == before  # the CPU path launches nothing
    assert_same_arrays(want, got, ["f_ids", "f_d", "n_vis", "cmps"])
    if blocks == "inactive":
        assert (got[0] == EMPTY_ID).all() and not got[3].any()


def test_kernel_coverage_rule_and_caps():
    """kernel_covers is a rule on the search and the blocks; the wrapper's
    caps agree with the constants compiled into the kernel."""
    from rangefilteredann_tpu_torch import kernels

    class G:
        nbr_vecs = torch.zeros((4, 48, 128))
        nbr_scale = None

    g = G()
    assert PBEAM.kernel_covers(g, 80, 0)
    assert PBEAM.kernel_covers(g, PBEAM.MAX_BEAM, 0)
    assert not PBEAM.kernel_covers(g, PBEAM.MAX_BEAM + 1, 0)
    assert not PBEAM.kernel_covers(g, 80, 5)  # degree limit
    g.nbr_vecs = torch.zeros((4, 65, 128))
    assert not PBEAM.kernel_covers(g, 80, 0)
    g.nbr_vecs = torch.zeros((4, 48, 384))
    assert not PBEAM.kernel_covers(g, 80, 0)
    g.nbr_vecs, g.nbr_scale = torch.zeros((4, 48, 128), dtype=torch.int8), torch.ones(4)
    assert PBEAM.kernel_covers(g, 80, 0)
    g.nbr_vecs = None
    assert not PBEAM.kernel_covers(g, 80, 0)
    src = (kernels.CSRC / "beam_search.cu").read_text()
    for name in ("MAX_R", "MAX_W", "MAX_BEAM", "BLOCKS_PER_SM", "CTL_BYTES",
                 "CAND_ARRAYS", "TABLE_PER_BEAM", "STAGE_BYTES"):
        assert f"constexpr int {name} = {getattr(PBEAM, name)};" in src
    assert "__launch_bounds__(32 * WPQ, WPQ == 1 ? 1 : BLOCKS_PER_SM)" in src
    assert "beam_search" in kernels.SOURCES
    with pytest.raises(ValueError):
        PBEAM.beam_search_inline(*[torch.zeros(1)] * 8, beam=8, limit=10,
                                 metric="cosine")


SMEM_PER_CTA = 232_448  # the most dynamic shared memory an H100 CTA may take


@pytest.mark.parametrize("q", [1, 16, 10240])
def test_launch_config_rule_fits_the_card(q):
    """Across the grid of the caps, the postfilter's beams and node counts
    that take 16-bit tags or whole ids in the table of scored ids, the
    launch rule returns one of the two configurations, and its shared
    memory (the kernel's layout, mirrored from the .cu constants: the table
    of TABLE_PER_BEAM x beam slots, a power of two, unless the blocks carry
    a scale, and a staging buffer of one block, in the one-warp
    configuration at most STAGE_BYTES) fits a CTA; small batches take four
    warps a query, the main path's 10,240-query launches one warp a
    query."""
    for r in (1, 48, 64):
        for w in (32, 128, 256):
            for beam in (1, 80, 160, 640, 2048):
                for dtype in PBEAM._DTYPE_CODES:
                    for scaled in ((False, True) if dtype == torch.int8 else (False,)):
                        class G:
                            nbr_vecs = torch.zeros((2, r, w), dtype=dtype)
                            nbr_scale = torch.ones(2) if scaled else None
                        assert PBEAM.kernel_covers(G(), beam, 0)
                        elem = G.nbr_vecs.element_size()
                        assert PBEAM.stage_rows(r, w, elem, 4) == r
                        rows1 = PBEAM.stage_rows(r, w, elem, 1)
                        assert rows1 == r if scaled else 1 <= rows1 <= r
                        assert rows1 * w * elem <= max(PBEAM.STAGE_BYTES, w * elem)
                        for m in (200_000, 2**31 - 2):
                            table = PBEAM.table_bytes(beam, m, scaled)
                            slots = 0 if scaled else 1 << (PBEAM.TABLE_PER_BEAM * beam - 1).bit_length()
                            assert slots == 0 or slots // 2 < PBEAM.TABLE_PER_BEAM * beam <= slots
                            wide = slots and (m - 1) // slots >= 0xFFFF
                            assert table == slots * (4 if wide else 2)
                            wpq, smem = PBEAM.launch_config(q, beam, r, w, elem, table)
                            assert wpq in (1, 4)
                            rows = r if wpq == 4 else rows1
                            assert smem == -(-(PBEAM.CTL_BYTES + 4 * w + 9 * beam + rows * w * elem
                                               + PBEAM.CAND_ARRAYS * PBEAM.MAX_R * 4
                                               + table) // 16) * 16
                            assert smem <= SMEM_PER_CTA
                            assert wpq == (4 if q <= 16 else 1)
    assert PBEAM.table_bytes(80, 200_000, False) == 2048  # 1024 16-bit tags
    assert PBEAM.table_bytes(80, 2**31 - 2, False) == 4096  # 1024 ids
    assert PBEAM.stage_rows(64, 128, 4, 1) == 32 and PBEAM.stage_rows(64, 128, 2, 1) == 64
    t = PBEAM.table_bytes  # the main path: R 64, w 128 fp32 over 200k nodes
    assert PBEAM.launch_config(16, 320, 48, 128, 4, t(320, 200_000, False))[0] == 4  # straggler
    assert PBEAM.launch_config(10240, 80, 48, 128, 4, t(80, 200_000, False))[0] == 1  # full
    # the rule's edge: every query its own 4-warp CTA, all resident at once
    edge = PBEAM.SMS * PBEAM.BLOCKS_PER_SM
    assert PBEAM.launch_config(edge, 320, 48, 128, 4, t(320, 200_000, False))[0] == 4
    assert PBEAM.launch_config(edge + 1, 320, 48, 128, 4, t(320, 200_000, False))[0] == 1
    # a four-warp query state of ~90 KB (a whole 64 KB block staged, beam
    # 640's table of 16-bit tags 16 KB) leaves two CTAs an SM, and the edge
    # moves with it; at beam 2048 (~118 KB), one
    assert PBEAM.launch_config(2 * PBEAM.SMS, 640, 64, 256, 4, t(640, 200_000, False))[0] == 4
    assert PBEAM.launch_config(2 * PBEAM.SMS + 1, 640, 64, 256, 4,
                               t(640, 200_000, False))[0] == 1
    assert PBEAM.launch_config(PBEAM.SMS, 2048, 64, 256, 4, t(2048, 2**31 - 2, False))[0] == 4
    assert PBEAM.launch_config(PBEAM.SMS + 1, 2048, 64, 256, 4, t(2048, 2**31 - 2, False))[0] == 1
