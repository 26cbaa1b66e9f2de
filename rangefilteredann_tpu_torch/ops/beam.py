"""Beam search over inline neighbour blocks on the card: the wrapper of
csrc/beam_search.cu.

Counterpart of rangefilteredann_tpu/ops/pallas_beam.py (the Pallas kernel
`_beam_kernel` this hand-written CUDA kernel replaces; the kernel's source
carries the note on its bound and design) and of `pallas_beam_search`
(ops/beam_search.py:321 there), whose start distance `start_distances` here
computes. The contract is the plain version's, `beam_search_plain`:
batched_beam_search at expand=1, k=0 over inline blocks, returning
(f_ids [Q, beam] int32, f_d [Q, beam] f32, n_vis [Q] int32, cmps [Q] int32)
with the frontier (dist, id)-sorted.

Coverage (`kernel_covers`), a rule on the search and not a switch:
query-mode searches (expand 1, no cut pruning, no exclude, full adjacency
rows) over inline blocks of float32, bfloat16, native int8/uint8, or int8
quantized with a per-node scale, with R <= MAX_R, w a multiple of 32 up to
MAX_W and beam <= MAX_BEAM (the postfilter's MAX_SAFE_BEAM, so the whole
doubling schedule stays in the kernel). Other searches take
batched_beam_search. A CPU tensor goes to the plain version; a CUDA tensor
goes to the kernel or raises. There is no fallback from one to the other.

Launch configuration (`launch_config`), a rule on the batch and not a
switch: the kernel runs one CTA per query, of one warp or of four warps,
both instances of one template. A batch whose queries all fit the card at
once as four-warp CTAs (at most SMS x the CTAs an SM holds, by registers
and by the shared memory that beam, R, w and the element size ask for)
takes four warps a query, so a small batch spreads its steps over more
threads; a larger batch takes one warp a query, which spends no threads on
barriers and packs the most queries into an SM.

Each query's CTA stages only the rows of ids it has not scored yet in the
launch, by a table of scored ids whose size follows beam (`table_bits`;
its entries' width follows the node count, `table_bytes`), into a buffer
of at most STAGE_BYTES in the one-warp configuration (`stage_rows`);
blocks with a per-node scale take no table and stage whole blocks. While
the port's tracing is on, the rows scored and the candidates of each
launch add up on the card in `BEAM_ROWS_SCORED` and `BEAM_CANDIDATES`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils.data import METRIC_L2, METRIC_MIPS
from ..utils.trace import DeviceCount, span, tracing
from .beam_search import batched_beam_search
from .distances import fused_norm_distances, gathered_distances

# Kernel launches since the count was last set to 0 (launches only, never
# calls that took the plain version).
BEAM_LAUNCHES = 0
# While tracing is on: rows the kernel scored, and candidates (valid ids met,
# cmps less each active query's start), summed on the card.
BEAM_ROWS_SCORED = DeviceCount()
BEAM_CANDIDATES = DeviceCount()

MAX_R = 64  # csrc/beam_search.cu MAX_R
MAX_W = 256  # csrc/beam_search.cu MAX_W
MAX_BEAM = 2048  # csrc/beam_search.cu MAX_BEAM
BLOCKS_PER_SM = 4  # csrc/beam_search.cu BLOCKS_PER_SM: 4-warp CTAs an SM holds
CTL_BYTES = 48  # csrc/beam_search.cu CTL_BYTES
CAND_ARRAYS = 12  # csrc/beam_search.cu CAND_ARRAYS
TABLE_PER_BEAM = 8  # csrc/beam_search.cu TABLE_PER_BEAM
STAGE_BYTES = 16384  # csrc/beam_search.cu STAGE_BYTES
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 233_472  # shared memory of an SM (228 KB)
SMEM_RESERVED = 1024  # shared memory the system keeps per CTA
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.uint8: 3}
_BYTE_DTYPES = (torch.int8, torch.uint8)

_launch_fn = None


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        fn = kernels.load("beam_search").beam_search_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p,
                       p, p, p, p]
        fn.restype = i
        _launch_fn = fn
    return _launch_fn


def kernel_covers(graph, beam: int, degree_limit: int) -> bool:
    """True when the kernel computes this query-mode search (expand 1,
    k = 0, no exclude) over the graph's inline blocks."""
    v = graph.nbr_vecs
    if v is None or v.dtype not in _DTYPE_CODES:
        return False
    if graph.nbr_scale is not None and v.dtype != torch.int8:
        return False
    _, r, w = v.shape
    return (degree_limit == 0 and r <= MAX_R
            and w <= MAX_W and w % 32 == 0 and 1 <= beam <= MAX_BEAM)


def table_bits(beam: int, scaled: bool) -> int:
    """log2 of the slots of a query's table of scored ids
    (csrc/beam_search.cu table_bits): the least power of two >=
    TABLE_PER_BEAM x beam, or 0 (no table) for blocks with a scale."""
    return 0 if scaled else (TABLE_PER_BEAM * beam - 1).bit_length()


def table_bytes(beam: int, m: int, scaled: bool) -> int:
    """Shared memory of a query's table of scored ids over m nodes: 2
    bytes a slot (a tag), or 4 (an id) where some id's tag reaches 0xffff
    (csrc/beam_search.cu table_wide)."""
    bits = table_bits(beam, scaled)
    if not bits:
        return 0
    return (4 if (m - 1) >> bits >= 0xFFFF else 2) << bits


def stage_rows(r: int, w: int, elem: int, wpq: int) -> int:
    """Rows of the staging buffer (csrc/beam_search.cu stage_rows): the
    whole block, up to STAGE_BYTES in the one-warp configuration."""
    return r if wpq != 1 else min(r, STAGE_BYTES // (w * elem))


def query_smem_bytes(beam: int, r: int, w: int, elem: int, table: int, wpq: int) -> int:
    """Shared memory of one query's CTA in a configuration of wpq warps
    (csrc/beam_search.cu query_smem_bytes): control words, the query, the
    candidates' scratch, the table of scored ids (`table` bytes,
    table_bytes), the staging buffer of rows of w `elem`-byte elements, the
    frontier."""
    return (CTL_BYTES + 4 * w + CAND_ARRAYS * MAX_R * 4 + table
            + stage_rows(r, w, elem, wpq) * w * elem + 9 * beam + 15) // 16 * 16


def launch_config(q: int, beam: int, r: int, w: int, elem: int, table: int):
    """(warps per query, dynamic shared memory bytes a CTA) of a launch of
    q queries at this beam over [r, w] blocks of `elem`-byte elements, with
    a table of `table` bytes (table_bytes): four warps a query when every
    query's four-warp CTA is resident at once, else one."""
    smem = query_smem_bytes(beam, r, w, elem, table, 4)
    ctas_per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    if q <= SMS * ctas_per_sm:
        return 4, smem
    return 1, query_smem_bytes(beam, r, w, elem, table, 1)


def start_distances(ps, graph, queries, starts, metric):
    """[Q] distances from each query (padded to the store's width) to its
    start node, from the full store row with its fused norm column: the
    plain search's own init (ops/beam_search.py)."""
    start_safe = starts.clamp(0, graph.m - 1).long()
    gid = (start_safe if graph.identity_s2g
           else graph.slab_to_global_dev[start_safe].long())
    rows = ps.data[gid][:, None, :]
    if ps.norm_col >= 0:
        return fused_norm_distances(rows, queries, metric, ps.norm_col)[:, 0]
    return gathered_distances(queries, rows, ps.norms_sq[gid][:, None], metric)[:, 0]


def beam_search_plain(nbr_vecs, nbrs, nbr_norms, nbr_scale, queries, starts,
                      d0, active, *, beam, limit, metric):
    """The plain version: batched_beam_search at expand=1, k=0 over the
    inline blocks, starting from the given d0."""
    res = batched_beam_search(
        None, None, nbrs, None, queries, starts, beam=beam, k=0, cut=1.35,
        limit=limit, metric=metric, active_in=active, expand=1,
        identity_map=True, nbr_vecs=nbr_vecs, nbr_norms=nbr_norms,
        nbr_scale=nbr_scale, d0=d0)
    return res.frontier_ids, res.frontier_dists, res.num_visited, res.dist_cmps


def beam_search_inline(
    nbr_vecs: torch.Tensor,  # [m, R, w] f32 / bf16 / int8 / uint8
    nbrs: torch.Tensor,  # [m, R] int32 slab ids, -1 pad
    nbr_norms: torch.Tensor,  # [m, R] f32
    nbr_scale,  # [m] f32 dequant scales of int8-quantized blocks, or None
    queries: torch.Tensor,  # [Q, w] f32
    starts: torch.Tensor,  # [Q] int slab start ids
    d0: torch.Tensor,  # [Q] f32 start distances (start_distances)
    active: torch.Tensor,  # [Q] bool, False = padded query
    *,
    beam: int,
    limit: int,
    metric: str,
):
    """Greedy beam search of each query over the inline blocks. Returns
    (f_ids, f_d, n_vis, cmps) as the plain version does."""
    if metric not in (METRIC_L2, METRIC_MIPS):
        raise ValueError(metric)
    args = (nbr_vecs, nbrs, nbr_norms, nbr_scale, queries, starts, d0, active)
    if nbr_vecs.device.type == "cpu":
        return beam_search_plain(*args, beam=beam, limit=limit, metric=metric)
    if nbr_vecs.device.type != "cuda":
        raise ValueError(f"beam_search_inline takes CPU or CUDA tensors, "
                         f"got {nbr_vecs.device}")
    return _beam_cuda(*args, beam=beam, limit=limit, metric=metric)[:4]


def _beam_cuda(nbr_vecs, nbrs, nbr_norms, nbr_scale, queries, starts, d0,
               active, *, beam, limit, metric):
    global BEAM_LAUNCHES
    dev = nbr_vecs.device
    if nbr_vecs.dim() != 3 or nbr_vecs.dtype not in _DTYPE_CODES:
        raise ValueError("nbr_vecs must be a [m, R, w] float32, bfloat16, "
                         f"int8 or uint8 tensor, got {nbr_vecs.dtype}")
    m, r, w = nbr_vecs.shape
    q = queries.shape[0]
    if not (1 <= r <= MAX_R and w % 32 == 0 and 32 <= w <= MAX_W
            and 1 <= beam <= MAX_BEAM):
        raise ValueError(f"the CUDA beam search takes R <= {MAX_R}, w a "
                         f"multiple of 32 up to {MAX_W} and beam <= "
                         f"{MAX_BEAM}; got R={r}, w={w}, beam={beam}")
    if m >= 2**31 - 1:
        raise ValueError(f"{m} nodes do not fit int32 ids")
    if nbr_scale is not None and nbr_vecs.dtype != torch.int8:
        raise ValueError("a dequant scale goes with int8 blocks only")
    tensors = [("nbrs", nbrs, torch.int32, (m, r)),
               ("nbr_norms", nbr_norms, torch.float32, (m, r)),
               ("queries", queries, torch.float32, (q, w)),
               ("d0", d0, torch.float32, (q,))]
    if nbr_scale is not None:
        tensors.append(("nbr_scale", nbr_scale, torch.float32, (m,)))
    for name, t, dtype, shape in tensors:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {dtype} {list(shape)} tensor on "
                             f"{dev}, got {t.dtype} {list(t.shape)} on {t.device}")
    if tuple(starts.shape) != (q,) or tuple(active.shape) != (q,):
        raise ValueError(f"starts and active must be [{q}]")
    if not nbr_vecs.is_contiguous() or nbr_vecs.data_ptr() % 16:
        raise ValueError("nbr_vecs must be contiguous and 16-byte aligned")
    f_ids = torch.empty((q, beam), dtype=torch.int32, device=dev)
    f_d = torch.empty((q, beam), dtype=torch.float32, device=dev)
    n_vis = torch.empty(q, dtype=torch.int32, device=dev)
    cmps = torch.empty(q, dtype=torch.int32, device=dev)
    scored = torch.empty(q, dtype=torch.int32, device=dev)  # rows each query scored
    if q == 0:
        return f_ids, f_d, n_vis, cmps, scored
    if nbr_vecs.dtype in _BYTE_DTYPES:  # the reference's operand policy
        queries = queries.to(torch.bfloat16).to(torch.float32)
    queries = queries.contiguous()
    nbrs = nbrs.contiguous()
    nbr_norms = nbr_norms.contiguous()
    nbr_scale = None if nbr_scale is None else nbr_scale.contiguous()
    starts = starts.to(dev, torch.int32).contiguous()
    act = active.to(dev, torch.uint8).contiguous()
    d0 = d0.contiguous()
    with torch.cuda.device(dev), span("beam.kernel"):
        rc = _kernel()(
            nbr_vecs.data_ptr(), _DTYPE_CODES[nbr_vecs.dtype], nbrs.data_ptr(),
            nbr_norms.data_ptr(),
            None if nbr_scale is None else nbr_scale.data_ptr(),
            queries.data_ptr(), starts.data_ptr(), d0.data_ptr(), act.data_ptr(),
            q, m, r, w, int(beam), int(min(limit, 2**31 - 1)),
            int(metric == METRIC_L2),
            launch_config(q, beam, r, w, nbr_vecs.element_size(),
                          table_bytes(beam, m, nbr_scale is not None))[0],
            f_ids.data_ptr(), f_d.data_ptr(),
            n_vis.data_ptr(), cmps.data_ptr(), scored.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"beam_search launch failed (code {rc})")
    BEAM_LAUNCHES += 1
    if tracing():  # on the card, no host sync
        BEAM_ROWS_SCORED.add(scored.sum())
        BEAM_CANDIDATES.add(cmps.sum() - act.sum())
    return f_ids, f_d, n_vis, cmps, scored
