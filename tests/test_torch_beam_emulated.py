"""The beam kernel's own CUDA source, run on the CPU, against its plain version.

csrc/beam_search.cu runs only on the card, where no test runs. Here g++
compiles it against tests/cuda_emu/cuda_runtime.h, which stands a thread in
for each CUDA thread and meets a warp's collectives at a barrier, so the
kernel's arithmetic and its merge (admission below the pre-step tail, the
by-id duplicate test, each survivor's place, the in-place moves, the next
slot) run as written, in both launch configurations: one warp per query and
a CTA of four warps per query. On grid-valued data (values k/8) every
distance is exact in float32 whatever the summation order, so ids, n_vis
and cmps must equal ops/beam.beam_search_plain's, the port's plain version,
which tests/test_torch_beam.py holds against the JAX package's Pallas kernel
in interpret mode. Int8 blocks with a per-node scale are held as the card's
cases hold them: at most 2% of ids differ, and no frontier holds an id twice
(the hub case meets its start again with a second distance).

Each query also returns the rows it scored. Every id a search meets is
scored at least once, and the table of scored ids lets no more through than
the candidates: distinct ids met <= scored <= cmps - 1. Where searches meet
ids again (a hub start, a beam near the node count, a table smaller than
the ids met) the table skips rows, and with a per-node scale it is off.
"""

from . import torch_threads  # noqa: F401  (first: one torch thread)

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from rangefilteredann_tpu_torch import kernels
from rangefilteredann_tpu_torch.ops.beam import _DTYPE_CODES, beam_search_plain, table_bits
from rangefilteredann_tpu_torch.ops.beam_search import batched_beam_search
from rangefilteredann_tpu_torch.ops.distances import gathered_distances
from rangefilteredann_tpu_torch.ops.topk import EMPTY_ID

RTOL, ATOL = 1e-5, 1e-4
EMU = Path(__file__).resolve().parent / "cuda_emu"


def build_emulated(out: Path):
    """beam_search_launch of the kernel's source, built for the CPU in the
    directory `out`; skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernel")
    src = (kernels.CSRC / "beam_search.cu").read_text()
    # the asynchronous copies copy at once, the waits find them done
    src = re.sub(r'asm volatile\(\s*"cp\.async\.ca\.shared\.global \[%0\], \[%1\], 4;".*?\);',
                 "std::memcpy(dst, src, 4);", src, flags=re.S)
    src = re.sub(r'asm volatile\(\s*"cp\.async\.bulk\.shared.*?\);',
                 "std::memcpy(dst, src, bytes);", src, flags=re.S)
    src = re.sub(r"asm volatile\(.*?\);", "", src, flags=re.S)
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_smem();")
    src = src.replace("kernel<<<a.n_q, 32 * WPQ, smem, a.stream>>>(",
                      "emu_launch(kernel, a.n_q, 32 * WPQ, smem, a.stream, ")
    assert "memcpy(dst, src, bytes)" in src and "emu_launch" in src and "asm" not in src
    (out / "beam_emu.cpp").write_text(src)
    lib = out / "libbeam_emu.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                            f"-I{EMU}", "-o", str(lib), str(out / "beam_emu.cpp")],
                           capture_output=True, text=True)
    assert built.returncode == 0, built.stderr
    fn = ctypes.CDLL(str(lib)).beam_search_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p, p]
    fn.restype = i
    return fn


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulated(tmp_path_factory.mktemp("beam_emu"))


def _slab(rng, m, r, w, blocks, hub):
    """A random slab as chip_smoke.beam_slab makes it (grid values, sorted
    random rows of 1..R neighbours), except that every third row keeps its
    padding in front; hub puts node 0 into every other row."""
    data = rng.normal(size=(m, w))
    data = (data if blocks == "int8scale" else np.round(data * 8) / 8).astype(np.float32)
    if blocks in ("int8", "uint8"):
        lo = -100 if blocks == "int8" else 0
        data = rng.integers(lo, lo + 200, size=(m, w)).astype(np.float32)
    norms = np.einsum("ij,ij->i", data, data).astype(np.float32)
    nbrs = np.full((m, r), -1, dtype=np.int32)
    for i in range(m):
        cand = rng.choice(m, size=rng.integers(1, r + 1), replace=False)
        cand = cand[cand != i]
        if hub and i > 0 and 0 not in cand:
            cand = np.append(cand[: r - 1], 0)
        nbrs[i, :len(cand)] = np.sort(cand)
        if i % 3 == 0:
            nbrs[i] = np.roll(nbrs[i], r - len(cand))
    safe = np.clip(nbrs, 0, m - 1)
    return data, norms, nbrs, data[safe], norms[safe]


def _inputs(seed, metric, r, blocks, w, m=300, q=5, hub=False):
    rng = np.random.default_rng(seed)
    data, norms, nbrs, vecs, nrm = _slab(rng, m, r, w, blocks, hub)
    queries = (np.round(rng.normal(size=(q, w)) * 8) / 8).astype(np.float32)
    if hub and blocks == "fp32":
        queries = (np.round((data[0] + 2 * rng.normal(size=(q, w))) * 8) / 8).astype(np.float32)
    scale = None
    if blocks in ("int8", "uint8"):
        vecs = vecs.astype(np.int8 if blocks == "int8" else np.uint8)
        queries = rng.integers(-20, 20, size=(q, w)).astype(np.float32)
    elif blocks == "int8scale":
        queries = rng.normal(size=(q, w)).astype(np.float32)
        scale = (np.abs(vecs).max(axis=(1, 2)) / 127.0).astype(np.float32)
        vecs = np.clip(np.rint(vecs / scale[:, None, None]), -127, 127).astype(np.int8)
    starts = (np.zeros(q) if hub else rng.integers(0, m, size=q)).astype(np.int32)
    active = np.ones(q, dtype=bool)
    active[q - 2:] = False
    t = torch.from_numpy
    v = t(vecs).to(torch.bfloat16) if blocks == "bf16" else t(vecs)
    st = t(starts)
    d0 = gathered_distances(t(queries), t(data)[st.long()][:, None, :],
                            t(norms)[st.long()][:, None], metric)[:, 0]
    if hub and blocks == "fp32":
        # queries near the start, whose own distance lies far above its block
        # rows' (as a store row may beside a rounded block): a search evicts
        # the start and admits it again from a block, so the table must
        # never hold the start
        d0 = d0 + 256.0
    return (v, t(nbrs), t(nrm), None if scale is None else t(scale), t(queries), st,
            d0, t(active))


def _run(fn, args, beam, limit, metric, wpq):
    """The wrapper's launch (ops/beam._beam_cuda) on CPU tensors."""
    v, nbrs, nrm, scale, queries, st, d0, act = args
    m, r, w = v.shape
    q = queries.shape[0]
    if v.dtype in (torch.int8, torch.uint8):
        queries = queries.to(torch.bfloat16).to(torch.float32)
    act = act.to(torch.uint8)
    f_ids = torch.empty((q, beam), dtype=torch.int32)
    f_d = torch.empty((q, beam), dtype=torch.float32)
    n_vis = torch.empty(q, dtype=torch.int32)
    cmps = torch.empty(q, dtype=torch.int32)
    scored = torch.empty(q, dtype=torch.int32)
    rc = fn(v.data_ptr(), _DTYPE_CODES[v.dtype], nbrs.data_ptr(), nrm.data_ptr(),
            None if scale is None else scale.data_ptr(), queries.data_ptr(),
            st.data_ptr(), d0.data_ptr(), act.data_ptr(), q, m, r, w, beam, limit,
            int(metric == "l2"), wpq, f_ids.data_ptr(), f_d.data_ptr(),
            n_vis.data_ptr(), cmps.data_ptr(), scored.data_ptr(), None)
    assert rc == 0
    return f_ids, f_d, n_vis, cmps, scored


def _ids_met(args, beam, limit, metric, cap):
    """[Q] distinct valid ids among the neighbours of each query's expanded
    nodes, from the plain version's visit list (at most `cap` a query)."""
    v, nbrs, nrm, scale, queries, st, d0, act = args
    res = batched_beam_search(
        None, None, nbrs, None, queries, st, beam=beam, k=0, cut=1.35, limit=limit,
        metric=metric, active_in=act, expand=1, identity_map=True, nbr_vecs=v,
        nbr_norms=nrm, nbr_scale=scale, d0=d0, return_visited=True, visited_cap=cap)
    out = np.zeros(queries.shape[0], dtype=np.int64)
    for qi, row in enumerate(res.visited_ids.numpy()):
        ids = nbrs.numpy()[row[row != EMPTY_ID]]
        out[qi] = len(np.unique(ids[ids >= 0]))
    return out


CASES = {
    # name: (metric, R, beam, limit, blocks, w, hub); the lanes a row G
    # follow w and the element size: 32 (fp32 w128), 4, 2, 4, 32 (two pieces)
    "fp32-l2-R5-beam8": ("l2", 5, 8, 10_000, "fp32", 128, False),
    "fp32-mips-R48-beam40-limit7": ("mips", 48, 40, 7, "fp32", 128, False),
    "bf16-l2-R24-beam16-w32": ("l2", 24, 16, 10_000, "bf16", 32, False),
    "uint8-mips-R48-beam24-w32": ("mips", 48, 24, 10_000, "uint8", 32, False),
    "int8-l2-R20-beam16-w96": ("l2", 20, 16, 10_000, "int8", 96, False),
    "fp32-l2-R33-beam8-w160": ("l2", 33, 8, 10_000, "fp32", 160, False),
    "int8scale-l2-R40-beam24-hub": ("l2", 40, 24, 10_000, "int8scale", 128, True),
    # the table of scored ids: the start met again in other rows, a beam near
    # the 300 nodes, a table (64 slots) smaller than the ids a search meets,
    # bf16 rows of 16 pieces, and rows of 1 KB, 16 a staging buffer, so a
    # step stages its rows in up to four chunks
    "fp32-l2-R40-beam24-hub": ("l2", 40, 24, 10_000, "fp32", 128, True),
    "fp32-mips-R16-beam256-revisit": ("mips", 16, 256, 10_000, "fp32", 64, False),
    "fp32-l2-R64-beam8-overflow": ("l2", 64, 8, 10_000, "fp32", 32, False),
    "bf16-l2-R48-beam64": ("l2", 48, 64, 10_000, "bf16", 128, False),
    "fp32-mips-R64-beam16-w256-chunks": ("mips", 64, 16, 10_000, "fp32", 256, False),
}
REVISITS = ("fp32-l2-R40-beam24-hub", "fp32-mips-R16-beam256-revisit",
            "fp32-l2-R64-beam8-overflow")


@pytest.mark.parametrize("wpq", [1, 4], ids=["warp-per-query", "cta-per-query"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_plain(emulated, case, wpq):
    metric, r, beam, limit, blocks, w, hub = CASES[case]
    args = _inputs(len(case) + r, metric, r, blocks, w, hub=hub)
    *got, scored = [x.numpy() for x in _run(emulated, args, beam, limit, metric, wpq)]
    want = [x.numpy() for x in beam_search_plain(*args, beam=beam, limit=limit,
                                                 metric=metric)]
    s = np.sort(got[0], axis=1)
    assert not ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] != EMPTY_ID)).any()
    assert (got[2][-2:] == 0).all() and (got[0][-2:] == EMPTY_ID).all()
    on = args[-1].numpy()
    candidates = got[3][on] - 1
    assert (scored[~on] == 0).all() and (scored[on] <= candidates).all()
    if blocks == "int8scale":  # no table: every candidate's row is scored
        np.testing.assert_array_equal(scored[on], candidates)
        assert (got[0] != want[0]).mean() < 0.02
        return
    met = _ids_met(args, beam, limit, metric, int(want[2].max()))[on]
    assert (scored[on] >= met).all()
    if case in REVISITS:
        assert (scored[on] < candidates).all()
    if case.endswith("overflow"):  # ids met outnumber the slots, and some are rescored
        assert (met > 1 << table_bits(beam, False)).all() and (scored[on] > met).all()
    for g, p, name in zip(got, want, ("ids", "dists", "n_vis", "cmps")):
        if name == "dists":
            fin = np.isfinite(p)
            np.testing.assert_array_equal(np.isfinite(g), fin)
            np.testing.assert_allclose(g[fin], p[fin], rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, p, err_msg=name)


def test_emulated_wide_table(emulated):
    """Over 2**19 + 64 nodes a beam-1 table (8 slots) cannot hold 16-bit
    tags, so it holds whole ids: a clique of five nodes with the highest
    ids, uint8 rows, each query starting inside it, against the plain
    version, with rows skipped where the search meets the clique again."""
    m, r, w, q, clique = 2**19 + 64, 4, 32, 6, 5
    assert table_bits(1, False) == 3 and (m - 1) >> 3 >= 0xFFFF
    rng = np.random.default_rng(11)
    ids = np.arange(m - clique, m)
    nbrs = np.full((m, r), -1, dtype=np.int32)
    nbrs[ids] = [np.delete(ids, i) for i in range(clique)]
    data = rng.integers(0, 200, size=(clique, w)).astype(np.float32)
    vecs = np.zeros((m, r, w), dtype=np.uint8)
    nrm = np.zeros((m, r), dtype=np.float32)
    pos = {int(g): i for i, g in enumerate(ids)}
    for g in ids:
        rows = data[[pos[int(x)] for x in nbrs[g]]]
        vecs[g], nrm[g] = rows, np.einsum("ij,ij->i", rows, rows)
    queries = rng.integers(-20, 20, size=(q, w)).astype(np.float32)
    t = torch.from_numpy
    st = t(ids[rng.integers(0, clique, size=q)].astype(np.int32))
    d0 = gathered_distances(t(queries), t(data)[[pos[int(x)] for x in st]][:, None, :],
                            t(np.einsum("ij,ij->i", data, data))[[pos[int(x)] for x in st]][:, None],
                            "l2")[:, 0]
    active = torch.ones(q, dtype=torch.bool)
    args = (t(vecs), t(nbrs), t(nrm), None, t(queries), st, d0, active)
    want = [x.numpy() for x in beam_search_plain(*args, beam=1, limit=10_000, metric="l2")]
    for wpq in (1, 4):
        *got, scored = [x.numpy() for x in _run(emulated, args, 1, 10_000, "l2", wpq)]
        for g, p, name in zip(got, want, ("ids", "dists", "n_vis", "cmps")):
            np.testing.assert_array_equal(g, p, err_msg=name)
        assert (scored <= got[3] - 1).all() and scored.sum() < (got[3] - 1).sum()
