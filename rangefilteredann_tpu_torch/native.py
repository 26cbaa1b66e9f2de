"""ctypes bridge to the native host runtime (native/winann_native.cpp).

A copy of rangefilteredann_tpu/native.py (numpy and ctypes only), kept here
so that the port never imports the JAX package. The native library owns the
host side of a tree batch: covering-bucket planning, the super tree's
routing and the top-k merge of result parts (C++ under parlay in the
reference, src/range_filter_tree.h), and the graph file I/O of utils/io.py
(ref: utils/graph.h). g++ compiles the unchanged
source at first use into `build/native/` at the repository root, under a
name that hashes the source and the flags, so a stale build is never
loaded. Where g++ or the source is missing, every entry point returns None
and its caller takes the pure-Python path (the trees' `_plan_batch_python`
and `_route`, the numpy merge, the numpy graph I/O), which gives the same
results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
SRC = _ROOT / "native" / "winann_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()
_tried = False

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libwinann_native-{digest.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    if not SRC.exists():
        return None
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)  # atomic: processes building at once each land a whole file
    return so


def _signatures(lib):
    lib.plan_fenwick_batch.restype = ctypes.c_int64
    lib.plan_fenwick_batch.argtypes = [
        _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        _i64p, _i64p, ctypes.c_int64,
        _i32p, _i64p, _i32p, _i64p, ctypes.c_int64,
    ]
    lib.plan_center_batch.restype = None
    lib.plan_center_batch.argtypes = [
        _i64p, _i64p, ctypes.c_int64,
        _i64p, _i64p, ctypes.c_int64,
        _i32p, _i32p, _i64p, _i64p, _i64p, _i64p,
    ]
    lib.plan_optimized_batch.restype = None
    lib.plan_optimized_batch.argtypes = [
        _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double,
        _i64p, _i64p, ctypes.c_int64,
        _i32p, _i32p, _i64p,
    ]
    lib.route_super_batch.restype = None
    lib.route_super_batch.argtypes = [
        _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        _i64p, _i64p, ctypes.c_int64,
        _i32p, _i64p,
    ]
    lib.merge_topk_parts.restype = None
    lib.merge_topk_parts.argtypes = [
        _i64p, _f32p, _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, _i32p, _i64p, _f32p, ctypes.c_int64,
    ]
    lib.read_graph_padded.restype = ctypes.c_int64
    lib.read_graph_padded.argtypes = [
        ctypes.c_char_p, _i32p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.write_graph_padded.restype = ctypes.c_int64
    lib.write_graph_padded.argtypes = [
        ctypes.c_char_p, _i32p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.graph_file_sizes.restype = ctypes.c_int64
    lib.graph_file_sizes.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]


def get_lib():
    """The native library, built first if needed, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
            _signatures(lib)
            _lib = lib
        except OSError:
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


# ----------------------------------------------------------------- wrappers

def _flatten_rows(offset_rows: List[np.ndarray]):
    row_ptr = np.zeros(len(offset_rows) + 1, dtype=np.int64)
    for i, row in enumerate(offset_rows):
        row_ptr[i + 1] = row_ptr[i] + len(row)
    flat = np.concatenate([np.asarray(r, dtype=np.int64) for r in offset_rows])
    return np.ascontiguousarray(flat), row_ptr


def plan_fenwick_batch(
    offset_rows: List[np.ndarray], split: int,
    lo: np.ndarray, hi: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Batched fenwick plans. Returns (bucket_row [Q,cap], bucket_idx [Q,cap],
    bucket_count [Q], fringe [Q,4]) or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    flat, row_ptr = _flatten_rows(offset_rows)
    n_rows = len(offset_rows)
    nq = len(lo)
    cap = (split + 2) * n_rows + split + 4
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    b_row = np.empty((nq, cap), dtype=np.int32)
    b_idx = np.empty((nq, cap), dtype=np.int64)
    b_cnt = np.empty((nq,), dtype=np.int32)
    fringe = np.empty((nq, 4), dtype=np.int64)
    rc = lib.plan_fenwick_batch(
        flat, row_ptr, n_rows, split, lo, hi, nq,
        b_row.reshape(-1), b_idx.reshape(-1), b_cnt, fringe.reshape(-1), cap,
    )
    if rc != 0:  # cap overflow — caller falls back to the Python planner
        return None
    return b_row, b_idx, b_cnt, fringe


def plan_center_batch(
    offset_rows: List[np.ndarray], lo: np.ndarray, hi: np.ndarray,
):
    """Batched find_largest_ranges. Returns (found [Q] bool, row [Q],
    first [Q], last [Q], cover_lo [Q], cover_hi [Q]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    flat, row_ptr = _flatten_rows(offset_rows)
    nq = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    found = np.empty((nq,), dtype=np.int32)
    row = np.empty((nq,), dtype=np.int32)
    first = np.empty((nq,), dtype=np.int64)
    last = np.empty((nq,), dtype=np.int64)
    c_lo = np.empty((nq,), dtype=np.int64)
    c_hi = np.empty((nq,), dtype=np.int64)
    lib.plan_center_batch(
        flat, row_ptr, len(offset_rows), lo, hi, nq,
        found, row, first, last, c_lo, c_hi,
    )
    return found.astype(bool), row, first, last, c_lo, c_hi


def plan_optimized_batch(
    offset_rows: List[np.ndarray], split: int, cutoff: int,
    min_ratio: Optional[float], lo: np.ndarray, hi: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Batched optimized-postfilter routing. Returns (kind [Q], row [Q],
    idx [Q]) with kind 0 = fenwick fallback, 1 = bucket."""
    lib = get_lib()
    if lib is None:
        return None
    flat, row_ptr = _flatten_rows(offset_rows)
    nq = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    kind = np.empty((nq,), dtype=np.int32)
    row = np.empty((nq,), dtype=np.int32)
    idx = np.empty((nq,), dtype=np.int64)
    lib.plan_optimized_batch(
        flat, row_ptr, len(offset_rows), split, cutoff,
        -1.0 if min_ratio is None else float(min_ratio),
        lo, hi, nq, kind, row, idx,
    )
    return kind, row, idx


def route_super_batch(
    rows: List[Tuple[int, int, int]], n_points: int,
    lo: np.ndarray, hi: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Batched super-tree routing over (bucket_size, bucket_shift, n_buckets)
    rows: the smallest bucket holding each [lo, hi), row 0 where none does.
    Returns (row [Q] int32, bucket [Q] int64)."""
    lib = get_lib()
    if lib is None:
        return None
    sizes = np.ascontiguousarray([r[0] for r in rows], dtype=np.int64)
    shifts = np.ascontiguousarray([r[1] for r in rows], dtype=np.int64)
    nbs = np.ascontiguousarray([r[2] for r in rows], dtype=np.int64)
    nq = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    out_row = np.empty((nq,), dtype=np.int32)
    out_idx = np.empty((nq,), dtype=np.int64)
    lib.route_super_batch(
        sizes, shifts, nbs, len(rows), n_points, lo, hi, nq, out_row, out_idx)
    return out_row, out_idx


def merge_topk_parts(
    part_ids: np.ndarray,  # [P, k] int64
    part_dists: np.ndarray,  # [P, k] f32
    part_qi: np.ndarray,  # [P] int32
    n_queries: int,
    empty_id: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-query top-k merge over result parts, in (dist, id) order. Returns
    (ids [Q,k], dists [Q,k])."""
    lib = get_lib()
    if lib is None:
        return None
    n_parts, k = part_ids.shape
    part_qi = np.ascontiguousarray(part_qi, dtype=np.int32)
    order = np.argsort(part_qi, kind="stable").astype(np.int32)
    counts = np.bincount(part_qi, minlength=n_queries)
    offsets = np.zeros(n_queries + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    out_ids = np.empty((n_queries, k), dtype=np.int64)
    out_d = np.empty((n_queries, k), dtype=np.float32)
    lib.merge_topk_parts(
        np.ascontiguousarray(part_ids, dtype=np.int64).reshape(-1),
        np.ascontiguousarray(part_dists, dtype=np.float32).reshape(-1),
        part_qi, n_parts, k, n_queries, offsets, order,
        out_ids.reshape(-1), out_d.reshape(-1), empty_id,
    )
    return out_ids, out_d


def read_graph_padded(path: str) -> Optional[np.ndarray]:
    """A reference-format graph file as a padded [n, max_deg] int32
    adjacency (-1 padding), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    n = ctypes.c_uint32()
    deg = ctypes.c_uint32()
    if lib.graph_file_sizes(path.encode(), ctypes.byref(n), ctypes.byref(deg)) != 0:
        raise FileNotFoundError(path)
    nbrs = np.empty((n.value, deg.value), dtype=np.int32)
    if lib.read_graph_padded(path.encode(), nbrs.reshape(-1), n.value, deg.value) != 0:
        raise IOError(f"bad graph file {path}")
    return nbrs


def write_graph_padded(path: str, nbrs: np.ndarray) -> bool:
    """Write a padded adjacency (valid edges first in each row) as a
    reference-format graph file; False without the library."""
    lib = get_lib()
    if lib is None:
        return False
    nbrs = np.ascontiguousarray(nbrs, dtype=np.int32)
    rc = lib.write_graph_padded(
        path.encode(), nbrs.reshape(-1), nbrs.shape[0], nbrs.shape[1])
    if rc != 0:
        raise IOError(f"cannot write graph file {path}")
    return True
