"""The port's scan-variant harness against the JAX tools it mirrors.

tools/exp_scan2.py, exp_scan3.py and exp_scan3b.py (the JAX tools, loaded by
path) and rangefilteredann_tpu_torch/tools/ get the same numpy inputs, on a
store the JAX package built and convert.py carried across. The JAX kernels
run in interpret mode; the port's wrappers, given CPU tensors, run their
plain versions. Ids must match exactly and distances within rtol 1e-5 /
atol 1e-4 (XLA and torch sum float32 products in other orders); on
grid-valued data (values j/8, every product and sum exact) the bf16 pass
must match bit for bit.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import importlib.util
import re
import pathlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangefilteredann_tpu.utils.data import make_pointset as j_make_pointset
from rangefilteredann_tpu.utils.data import pad_queries
from rangefilteredann_tpu_torch import convert, kernels
from rangefilteredann_tpu_torch import tools as PT
from rangefilteredann_tpu_torch.ops.topk import EMPTY_ID
from rangefilteredann_tpu_torch.tools import exp_scan2 as P2
from rangefilteredann_tpu_torch.tools import exp_scan3 as P3
from rangefilteredann_tpu_torch.tools import exp_scan3b as P3B
from rangefilteredann_tpu_torch.tools import scan_items as I

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-4
N, DIM, NQ, K, TILE = 1200, 32, 16, 10, 512
_JAX_SETTINGS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_compile_time_secs")


def load_jax_tool(name):
    """tools/<name>.py as a module. Importing a tool creates a fixed cache
    directory, points JAX's compilation cache at it and extends sys.path:
    the directory is not created, and the cache settings and sys.path are
    restored before the import returns, so nothing compiled afterwards (in
    this file or a later one on the same worker) goes anywhere but the
    cache that tests/conftest.py chose."""
    saved = {key: getattr(jax.config, key) for key in _JAX_SETTINGS}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        with mock.patch("os.makedirs"):
            spec.loader.exec_module(mod)
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def jtools():
    """The three JAX tools by name."""
    return {name: load_jax_tool(name) for name in ("exp_scan2", "exp_scan3", "exp_scan3b")}


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def make_case(seed, metric="l2", grid=False, dups=False):
    """(JAX store, port store, padded queries, starts, ends): the port's
    store is the JAX one carried across. Windows are random, empty, narrower
    than k, at the store's end and the whole store."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(N, DIM))
    q = rng.normal(size=(NQ, DIM))
    if grid:
        pts, q = np.round(pts * 8) / 8, np.round(q * 8) / 8
    pts, q = pts.astype(np.float32), q.astype(np.float32)
    if dups:  # the tools' --dups: every 3rd point copies another (exact ties)
        src = rng.integers(0, N, size=N // 3)
        pts[np.arange(0, N, 3)[: len(src)]] = pts[src]
        q[: NQ // 4] = pts[rng.integers(0, N, size=NQ // 4)]
    n = len(pts)
    starts = rng.integers(0, n, size=NQ).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, n, size=NQ), n).astype(np.int32)
    starts[:4] = [100, 200, 300, 400]
    ends[:4] = [100, 203, 301, 404]
    ends[4:6] = n
    starts[6], ends[6] = 0, n
    jps = j_make_pointset(pts, metric)
    pps = convert.pointset_from_arrays(
        np.asarray(jps.data), np.asarray(jps.norms_sq), jps.n, jps.d, jps.metric,
        jps.norm_col, device="cpu")
    return jps, pps, pad_queries(q, DIM, jps.d_pad), starts, ends


def jax_args(jps, qp, starts, ends):
    return jps.data, jps.norms_sq, jnp.asarray(qp), jnp.asarray(starts), jnp.asarray(ends)


def port_args(pps, qp, starts, ends):
    return pps.data, pps.norms_sq, t(qp), t(starts), t(ends)


def assert_same(want, got, exact_dists=False):
    wd, wi = (np.asarray(x) for x in want)
    gd, gi = (x.numpy() for x in got)
    np.testing.assert_array_equal(gi, wi)
    if exact_dists:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------- v2 --

@pytest.mark.parametrize("tile", [512, 1024])
def test_v2_fp32_matches_jax(jtools, tile):
    jps, pps, qp, s, e = make_case(1)
    want = jtools["exp_scan2"].scan_v2(*jax_args(jps, qp, s, e), K, tile=tile,
                                       d_eff=DIM, interpret=True, qblock=8)
    got = P2.scan_v2(*port_args(pps, qp, s, e), K, tile=tile, d_eff=DIM, qblock=8)
    assert_same(want, got)


def test_v2_bf16_grid_values_exact(jtools):
    """On grid values bf16 rounding is exact and so is every sum: the bf16
    pass (with the fp32 norms) equals the JAX kernel's bit for bit."""
    jps, pps, qp, s, e = make_case(2, grid=True)
    want = jtools["exp_scan2"].scan_v2(*jax_args(jps, qp, s, e), K, tile=TILE,
                                       bf16=True, d_eff=DIM, interpret=True, qblock=16)
    got = P2.scan_v2(*port_args(pps, qp, s, e), K, tile=TILE, bf16=True, d_eff=DIM,
                     qblock=16)
    assert_same(want, got, exact_dists=True)


def test_rerank_fp32_keeps_candidate_order_on_ties(jtools):
    """rerank_fp32's rounds take the first minimum by candidate position, so
    duplicates (equal fp32 distances) come out in the candidates' order, not
    lowest id first: the JAX quirk, ported."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(40, DIM)).astype(np.float32)
    pts = np.tile(base, (4, 1))  # ids i, i+40, i+80, i+120 are one point
    jps = j_make_pointset(pts, "l2")
    pps = convert.pointset_from_arrays(np.asarray(jps.data), np.asarray(jps.norms_sq),
                                       jps.n, jps.d, "l2", jps.norm_col, device="cpu")
    cand = np.stack([rng.permutation(len(pts))[:24] for _ in range(NQ)]).astype(np.int32)
    cand[:, -3:] = EMPTY_ID
    cand[0, :4] = [120, 80, 40, 0]  # one point four times, highest id first
    qp = pad_queries(rng.normal(size=(NQ, DIM)).astype(np.float32), DIM, jps.d_pad)
    qp[0, :DIM] = base[0]
    want = jtools["exp_scan2"].rerank_fp32(jps.data, jps.norms_sq, jnp.asarray(qp),
                                           jnp.asarray(cand), K)
    got = P2.rerank_fp32(pps.data, pps.norms_sq, t(qp), t(cand), K)
    assert_same(want, got)
    assert got[1][0, :4].tolist() == [120, 80, 40, 0]


def test_v2_bf16_then_rerank_matches_jax(jtools):
    """The approximate bf16 pass with k' = 32 candidates, then the exact
    fp32 rerank to k: the pipeline the JAX tool times."""
    jps, pps, qp, s, e = make_case(4)
    j2 = jtools["exp_scan2"]
    _, ci = j2.scan_v2(*jax_args(jps, qp, s, e), P2.RERANK_K, tile=TILE, bf16=True,
                       d_eff=DIM, interpret=True, qblock=16)
    want = j2.rerank_fp32(jps.data, jps.norms_sq, jnp.asarray(qp), ci, K)
    _, pi = P2.scan_v2(*port_args(pps, qp, s, e), P2.RERANK_K, tile=TILE, bf16=True,
                       d_eff=DIM, qblock=16)
    got = P2.rerank_fp32(pps.data, pps.norms_sq, t(qp), pi, K)
    assert_same(want, got)


# -------------------------------------------------------------- v3, v3b --

@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_v3_matches_jax(jtools, metric):
    jps, pps, qp, s, e = make_case(5, metric=metric)
    want = jtools["exp_scan3"].scan_v3(*jax_args(jps, qp, s, e), K, metric=metric,
                                       tile=TILE, d_eff=DIM, interpret=True, qblock=16)
    got = P3.scan_v3(*port_args(pps, qp, s, e), K, metric=metric, tile=TILE,
                     d_eff=DIM, qblock=16)
    assert_same(want, got)


@pytest.mark.parametrize("unroll", [1, 4])
def test_v3b_matches_jax(jtools, unroll):
    jps, pps, qp, s, e = make_case(6)
    want = jtools["exp_scan3b"].scan_v3b(*jax_args(jps, qp, s, e), K, tile=TILE,
                                         d_eff=DIM, interpret=True, qblock=8,
                                         unroll=unroll)
    got = P3B.scan_v3b(*port_args(pps, qp, s, e), K, tile=TILE, d_eff=DIM,
                       qblock=8, unroll=unroll)
    assert_same(want, got)


@pytest.mark.parametrize("variant", ["v2", "v3", "v3b"])
def test_duplicates_and_degenerate_windows(jtools, variant):
    """Duplicated points (exact ties, lowest id first) and windows that are
    empty, narrower than k or the whole store."""
    jps, pps, qp, s, e = make_case(7, dups=True)
    ja, pa = jax_args(jps, qp, s, e), port_args(pps, qp, s, e)
    kw = dict(tile=TILE, d_eff=DIM)
    if variant == "v2":
        want = jtools["exp_scan2"].scan_v2(*ja, K, interpret=True, qblock=16, **kw)
        got = P2.scan_v2(*pa, K, qblock=16, **kw)
    elif variant == "v3":
        want = jtools["exp_scan3"].scan_v3(*ja, K, interpret=True, qblock=16, **kw)
        got = P3.scan_v3(*pa, K, qblock=16, **kw)
    else:
        want = jtools["exp_scan3b"].scan_v3b(*ja, K, interpret=True, qblock=16, **kw)
        got = P3B.scan_v3b(*pa, K, qblock=16, **kw)
    assert_same(want, got)
    assert got[1][0].tolist() == [EMPTY_ID] * K  # the empty window
    assert (got[1][1, 3:] == EMPTY_ID).all()  # three points for k = 10


def test_probe_matches_jax(jtools, capsys):
    """The port's probe logs the JAX probe's line, sum included."""
    jtools["exp_scan3b"].probe_nested_while(True)
    want = capsys.readouterr().err.strip().splitlines()[-1]
    before = P3B.PROBE_LAUNCHES
    out = P3B.probe_nested_while("cpu")
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want == "nested-while probe: OK (sum=6144.0)"
    assert torch.equal(out, torch.full((8, 128), 6.0))
    assert P3B.PROBE_LAUNCHES == before


# ------------------------------------------------- wrappers on the CPU --

def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors each wrapper is its plain version and counts no
    launch; query columns past d_eff are ignored, as the kernels ignore
    them."""
    _, pps, qp, s, e = make_case(8)
    a = port_args(pps, qp, s, e)
    dirty = port_args(pps, np.where(np.arange(qp.shape[1]) >= DIM, 7.0, qp)
                      .astype(np.float32), s, e)
    counts = (P2.SCAN_V2_LAUNCHES, P3.SCAN_V3_LAUNCHES, P3B.SCAN_V3B_LAUNCHES)
    pairs = [
        (P2.scan_v2(*dirty, K, d_eff=DIM), P2.scan_v2_plain(*a, K, d_eff=DIM)),
        (P2.scan_v2(*dirty, K, bf16=True, d_eff=DIM),
         P2.scan_v2_plain(*a, K, bf16=True, d_eff=DIM)),
        (P3.scan_v3(*dirty, K, metric="mips", d_eff=DIM),
         P3.scan_v3_plain(*a, K, metric="mips", d_eff=DIM)),
        (P3B.scan_v3b(*dirty, K, d_eff=DIM), P3B.scan_v3b_plain(*a, K, d_eff=DIM)),
    ]
    for got, want in pairs:
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert counts == (P2.SCAN_V2_LAUNCHES, P3.SCAN_V3_LAUNCHES, P3B.SCAN_V3B_LAUNCHES)


@pytest.mark.parametrize("bad", ["v2-mips", "byte-store", "k-above-256", "meta-device",
                                 "tile", "qblock", "shared-memory", "unroll"])
def test_caps_raise(bad):
    """Outside its caps a wrapper raises, on the CPU as on the card."""
    _, pps, qp, s, e = make_case(9)
    data, norms, q, st, en = port_args(pps, qp, s, e)
    if bad == "v2-mips":  # v2 is L2 only: it has no metric argument
        with pytest.raises(TypeError):
            P2.scan_v2(data, norms, q, st, en, K, metric="mips")
        return
    kw = {}
    if bad == "byte-store":
        data = data.to(torch.int8)
    elif bad == "meta-device":
        data = torch.empty(data.shape, device="meta")
    k = 257 if bad == "k-above-256" else K
    kw = {"tile": {"tile": 640}, "qblock": {"qblock": 64},
          "shared-memory": {"tile": 4096, "qblock": 32},
          "unroll": {"unroll": 0}}.get(bad, {})
    fn = P3B.scan_v3b if bad == "unroll" else P3.scan_v3
    with pytest.raises(ValueError):
        fn(data, norms, q, st, en, k, **kw)


@pytest.mark.parametrize("module", [P2, P3, P3B])
def test_main_runs_to_its_end(module, capsys):
    h = module.main(["--device", "cpu", "--n", "3000", "--nq", "32", "--reps", "1"])
    assert h.device.type == "cpu" and h.runs
    for name, ((dists, ids), ms) in h.runs.items():
        assert ids.shape == (32, K) and ms > 0, name
    err = capsys.readouterr().err
    assert "prod" in err and "qps" in err
    if module is P2:  # the exact runs agree with the float64 oracle
        assert all(ok == 1.0 for name, (ok, _) in h.checks.items() if "bf16" not in name)


class _Drawn(Exception):
    """Raised in place of a JAX tool's make_pointset, carrying the local
    variables of the main() that called it."""


@pytest.mark.parametrize("tool,flags", [
    ("exp_scan2", []), ("exp_scan3", []), ("exp_scan3", ["--dups"]),
    ("exp_scan3b", []), ("exp_scan3b", ["--dups"])])
def test_harness_data_matches_the_jax_tools(jtools, monkeypatch, tool, flags):
    """The harness draws its data as each JAX tool's main() does, draw for
    draw: the tool's main() runs until it builds its store, and its points,
    queries and windows are taken from there."""
    def drawn(points, metric):
        raise _Drawn(sys._getframe(1).f_locals)

    n, nq = 2000, 16
    mod = jtools[tool]
    monkeypatch.setattr(mod, "make_pointset", drawn)
    monkeypatch.setattr(sys, "argv", [tool, "--n", str(n), "--nq", str(nq),
                                      *flags, *(["--skip-probe"] if tool == "exp_scan3b" else [])])
    with pytest.raises(_Drawn) as info:
        mod.main()
    want = info.value.args[0]
    got = PT.harness_data(n, nq, dups="--dups" in flags, degenerate=tool != "exp_scan2")
    for name, have in zip(("points", "queries", "starts", "ends"), got):
        assert have.dtype == want[name].dtype, name
        np.testing.assert_array_equal(have, want[name], err_msg=name)


def test_kernel_sources_and_constants():
    """The variants' sources ship with the package, and the wrappers' caps
    agree with the constants compiled into them: v2, v3 and v3b all run on
    the persistent item body scan_items.cuh (no source includes the old
    block-per-CTA body scan_variants.cuh, which is gone), whose constants
    and shared-memory layout the wrappers' caps mirror; the round extraction
    of v3 and v3b is defined once, in scan_items.cuh; and each helper the
    scan kernels share is defined once among their sources, in
    scan_common.cuh (the beam search, csrc/beam_search.cu, keeps its own
    copy helpers)."""
    hdr = (kernels.CSRC / "scan_items.cuh").read_text()
    common = (kernels.CSRC / "scan_common.cuh").read_text()
    assert not (kernels.CSRC / "scan_variants.cuh").exists()
    for name in ("scan_v2", "scan_v3", "scan_v3b"):
        assert name in kernels.SOURCES
        src = (kernels.CSRC / f"{name}.cu").read_text()
        assert '#include "scan_items.cuh"' in src, name
        assert f"int {name}_config(" in src and f"int {name}_launch(" in src, name
    assert "probe_nested_while_launch" in (kernels.CSRC / "scan_v3b.cu").read_text()
    for const, value in (("TILE_STEP", I.SUB), ("GROUP", I.GROUP), ("MAX_SMEM", I.MAX_SMEM)):
        assert f"constexpr int {const} = {value};" in hdr
    assert "constexpr int MAX_K = 256;" in common
    assert "constexpr int MAX_TILE = MAX_GROUPS * GROUP;" in hdr
    assert I.MAX_TILE == 32 * I.GROUP and I.smem_bytes(1024, 32, 256) <= I.MAX_SMEM
    assert ("MAX_STAGES * qb * dk * 4 + qb * k * 8 + qb * (tile / GROUP) * 8 + (3 * qb + 4) * 4"
            in hdr)
    sources = {f.name: f.read_text() for f in sorted(kernels.CSRC.glob("scan_*.cu*"))}
    assert len(sources) == 6
    assert not any('#include "scan_variants.cuh"' in text for text in sources.values())
    assert {f for f, text in sources.items() if "run_fp32<RoundExtract<" in text} == {
        "scan_v3.cu", "scan_v3b.cu"}
    for helper in (r"bool lex_less\(", r"void atomic_min_float\(", r"void warp_argmin\(",
                   r"void warp_insert\(", r"unsigned smem_u32\(", r"void copy16\(",
                   r"void copy4\(", r"void copy_commit\(", r"void copy_wait\(",
                   r"__global__ void __launch_bounds__\(MERGE_WARPS \* 32\) merge_",
                   r"struct RoundExtract \{"):
        where = {f: len(re.findall(helper, text)) for f, text in sources.items()}
        where = {f: n for f, n in where.items() if n}
        home = "scan_items.cuh" if "RoundExtract" in helper else "scan_common.cuh"
        assert list(where) == [home], (helper, where)
    assert len(re.findall(r"struct RoundExtract \{", hdr)) == 1


def _copy_sources(tmp_path, monkeypatch):
    for f in kernels.CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)


def test_build_hash_covers_the_included_headers(tmp_path, monkeypatch):
    """A library's name changes with the headers its source includes and
    with no other: an edit to the item body (scan_items.cuh) renames the
    builds of v2, v3 and v3b only; an edit to the shared helpers
    (scan_common.cuh) renames the builds of the production scan, v2, v3 and
    v3b, not the beam search's."""
    _copy_sources(tmp_path, monkeypatch)
    names = kernels.SOURCES
    before = {n: kernels.library_path(n) for n in names}
    assert len(set(before.values())) == len(names)
    with open(tmp_path / "scan_items.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: kernels.library_path(n) for n in names}
    assert [n for n in names if after[n] != before[n]] == ["scan_v2", "scan_v3", "scan_v3b"]
    with open(tmp_path / "scan_common.cuh", "a") as f:
        f.write("// edited\n")
    again = {n: kernels.library_path(n) for n in names}
    assert [n for n in names if again[n] != after[n]] == [
        "scan_topk", "scan_v2", "scan_v3", "scan_v3b"]
    with open(tmp_path / "scan_v3b.cu", "a") as f:
        f.write("// edited\n")
    assert kernels.library_path("scan_v3b") != again["scan_v3b"]


def test_build_hash_follows_includes_through_headers(tmp_path, monkeypatch):
    """A header included only through another header is in the hash:
    scan_v2.cu reaches scan_common.cuh only through scan_items.cuh, and an
    edit to it renames v2's build; includes that form a cycle are read
    once each."""
    _copy_sources(tmp_path, monkeypatch)
    assert '#include "scan_common.cuh"' not in (tmp_path / "scan_v2.cu").read_text()
    assert '#include "scan_common.cuh"' in (tmp_path / "scan_items.cuh").read_text()
    before = kernels.library_path("scan_v2")
    with open(tmp_path / "scan_common.cuh", "a") as f:
        f.write("// edited\n")
    assert kernels.library_path("scan_v2") != before
    (tmp_path / "loop.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n// b\n')
    first = kernels.library_path("loop")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n// b, edited\n')
    assert kernels.library_path("loop") != first


def test_ab_tool_reads_ptxas_and_names_kernels_alike(tmp_path):
    """tools/ab.py, which compares two trees' builds on the card, names a
    kernel the same in both trees (the anonymous namespace's per-file hash
    left out) and reads registers and spill bytes from ptxas -v; it refuses
    a parent directory without the package."""
    from rangefilteredann_tpu_torch.tools import ab

    out = ("ptxas info    : Compiling entry function "
           "'_ZN45_GLOBAL__N__2120ea9f_12_scan_topk_cu_419e08dd17scan_items_kernelIfLb1ELi2EEEvNS_8ScanArgsE'"
           " for 'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 245 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function "
           "'_ZN45_GLOBAL__N__c542dd46_12_scan_topk_cu_419e08dd12merge_kernelENS_8ScanArgsE'"
           " for 'sm_90a'\nptxas info    : Function properties for y\n"
           "    48 bytes stack frame, 48 bytes spill stores, 132 bytes spill loads\n"
           "ptxas info    : Used 24 registers, used 0 barriers\n")
    assert ab.ptxas(out) == {
        "_ZNANON17scan_items_kernelIfLb1ELi2EEEvNS_8ScanArgsE": (245, 0),
        "_ZNANON12merge_kernelENS_8ScanArgsE": (24, 48)}
    with pytest.raises(SystemExit):
        ab.main(["--parent", str(tmp_path)])
