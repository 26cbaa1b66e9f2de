"""Categorical point<->filter membership (CSR) and the filtered-dataset
inspector.

A copy of rangefilteredann_tpu/filters.py (numpy only), kept here so that
the port never imports the JAX package (ref:
ParlayANN/algorithms/utils/filters.h:47-305, src/filtered_dataset.h:24-122,
python_bindings/python_bindings.cpp:176-230). These are side utilities of
the window search (dataset inspection, CAPS export), not used by the range
indices, and host-side: sparse integer bookkeeping with no arithmetic for
a card. Set operations are vectorized (np.intersect1d, bincount scatters).

File format (ref: filters.h:84-110): little-endian
  int64 n_points | int64 n_filters | int64 n_nonzero |
  int64 row_offsets[n_points + 1] | int32 row_indices[n_nonzero]
"""

from __future__ import annotations

import numpy as np


class QueryFilter:
    """One or two categorical filter labels (ref: filters.h:47-66).

    ``b == -1`` means a single-label filter; otherwise the query is the AND of
    both labels.
    """

    __slots__ = ("a", "b")

    def __init__(self, a: int, b: int = -1):
        self.a = int(a)
        self.b = int(b)

    def is_and(self) -> bool:
        return self.b != -1

    def get_sequence(self):
        return [self.a, self.b] if self.is_and() else [self.a]

    def __repr__(self) -> str:
        return f"<QueryFilter: {self.a}, {self.b}>"

    def __str__(self) -> str:
        return f"({self.a}, {self.b})"


class csr_filters:
    """CSR point->filter membership matrix (ref: filters.h:69-305).

    Rows are points, columns are filters (until transposed). Row indices are
    kept sorted, matching the reference's post-load sort (filters.h:105-107).
    """

    def __init__(self, filename: str | None = None):
        if filename is not None:
            with open(filename, "rb") as f:
                head = np.fromfile(f, dtype=np.int64, count=3)
                self.n_points, self.n_filters, self.n_nonzero = map(int, head)
                self.row_offsets = np.fromfile(
                    f, dtype=np.int64, count=self.n_points + 1
                )
                self.row_indices = np.fromfile(
                    f, dtype=np.int32, count=self.n_nonzero
                )
            self._sort_rows()
        else:
            self.n_points = self.n_filters = self.n_nonzero = 0
            self.row_offsets = np.zeros(1, dtype=np.int64)
            self.row_indices = np.zeros(0, dtype=np.int32)
        self.transposed = False

    @classmethod
    def from_arrays(
        cls, row_offsets: np.ndarray, row_indices: np.ndarray, n_filters: int
    ) -> "csr_filters":
        out = cls()
        out.row_offsets = np.asarray(row_offsets, dtype=np.int64)
        out.row_indices = np.asarray(row_indices, dtype=np.int32)
        out.n_points = len(out.row_offsets) - 1
        out.n_filters = int(n_filters)
        out.n_nonzero = len(out.row_indices)
        out._sort_rows()
        return out

    def _sort_rows(self):
        # one vectorized lexsort by (row, col) instead of a per-point loop
        # (the reference sorts rows in parallel C++, filters.h:105-107)
        rows = np.repeat(
            np.arange(self.n_points, dtype=np.int64),
            np.diff(self.row_offsets),
        )
        order = np.lexsort((self.row_indices, rows))
        self.row_indices = self.row_indices[order]

    def save(self, filename: str) -> None:
        with open(filename, "wb") as f:
            np.array(
                [self.n_points, self.n_filters, self.n_nonzero], dtype=np.int64
            ).tofile(f)
            self.row_offsets.astype(np.int64).tofile(f)
            self.row_indices.astype(np.int32).tofile(f)

    def print_stats(self) -> None:
        print(f"n_points: {self.n_points}")
        print(f"n_filters: {self.n_filters}")
        print(f"n_nonzeros: {self.n_nonzero}")

    def _row(self, p: int) -> np.ndarray:
        return self.row_indices[self.row_offsets[p] : self.row_offsets[p + 1]]

    def match(self, p: int, f: int) -> bool:
        """True iff row p contains column f (ref: filters.h:163-180)."""
        row = self._row(p)
        i = np.searchsorted(row, f)
        return bool(i < len(row) and row[i] == f)

    # the reference exposes a binary-search variant too (filters.h:186-202);
    # match() above already binary-searches, so they coincide here.
    bin_match = match

    def query_matches(self, q: QueryFilter) -> np.ndarray:
        """Point ids matching a (transposed) QueryFilter (ref: filters.h:204-214)."""
        if not self.transposed:
            raise RuntimeError(
                "query_matches requires a transposed csr_filters "
                "(rows must be filters; call .transpose())"
            )
        if q.is_and():
            return np.intersect1d(
                self._row(q.a), self._row(q.b), assume_unique=True
            ).astype(np.int32)
        return self._row(q.a).copy()

    def first_label(self, p: int) -> int:
        # NB: the reference's first_label ignores p and returns the first
        # stored label (filters.h:217-219); we honor the evident intent.
        return int(self._row(p)[0])

    def filter_count(self, f: int) -> int:
        """Number of points matching filter f (ref: filters.h:222-226)."""
        return int(np.count_nonzero(self.row_indices == f))

    def point_count(self, p: int) -> int:
        return int(self.row_offsets[p + 1] - self.row_offsets[p])

    def filter_counts(self) -> np.ndarray:
        return np.bincount(
            self.row_indices, minlength=self.n_filters
        ).astype(np.int64)

    def point_filters(self, p: int) -> np.ndarray:
        return self._row(p).copy()

    def point_intersection(self, a: int, b: int) -> np.ndarray:
        return np.intersect1d(
            self._row(a), self._row(b), assume_unique=True
        ).astype(np.int32)

    def transpose(self) -> "csr_filters":
        out = csr_filters()
        out.n_points, out.n_filters = self.n_filters, self.n_points
        out.n_nonzero = self.n_nonzero
        counts = np.bincount(self.row_indices, minlength=self.n_filters)
        out.row_offsets = np.zeros(self.n_filters + 1, dtype=np.int64)
        np.cumsum(counts, out=out.row_offsets[1:])
        # stable counting-sort scatter: row ids in increasing order per filter
        order = np.argsort(self.row_indices, kind="stable")
        rows = np.repeat(
            np.arange(self.n_points, dtype=np.int32),
            np.diff(self.row_offsets).astype(np.int64),
        )
        out.row_indices = rows[order]
        out.transposed = not self.transposed
        return out

    def transpose_inplace(self) -> None:
        t = self.transpose()
        self.__dict__.update(t.__dict__)

    def reverse_transpose(self) -> "csr_filters":
        if not self.transposed:
            return self
        out = self.transpose()
        out.transposed = False
        return out


class FilteredDataset:
    """Inspector over an int8 point file + CSR filter file and CAPS exporter
    (ref: src/filtered_dataset.h:24-122). Point file format is the ParlayANN
    ``.bin``: uint32 n | uint32 d | int8 data[n*d]."""

    def __init__(self, points_filename: str, filters_filename: str):
        with open(points_filename, "rb") as f:
            n, d = np.fromfile(f, dtype=np.uint32, count=2)
            self.points = np.fromfile(f, dtype=np.int8, count=int(n) * int(d))
        self.points = self.points.reshape(int(n), int(d))
        self.filters = csr_filters(filters_filename)
        self.transpose_filters = self.filters.transpose()

    def distance(self, a: int, b: int) -> float:
        """Squared euclidean distance (ref: filtered_dataset.h:35-40)."""
        diff = self.points[a].astype(np.int32) - self.points[b].astype(np.int32)
        return float((diff * diff).sum())

    def size(self) -> int:
        return self.points.shape[0]

    def get_n_filters(self) -> int:
        return self.filters.n_filters

    def get_filter_size(self, filter_id: int) -> int:
        return self.transpose_filters.point_count(filter_id)

    def get_point_size(self, point_id: int) -> int:
        return self.filters.point_count(point_id)

    def get_filter_points(self, filter_id: int) -> np.ndarray:
        return self.transpose_filters.point_filters(filter_id)

    def get_point_filters(self, point_id: int) -> np.ndarray:
        return self.filters.point_filters(point_id)

    def get_filter_intersection(self, f1: int, f2: int) -> np.ndarray:
        return self.transpose_filters.point_intersection(f1, f2)

    def get_point_intersection(self, p1: int, p2: int) -> np.ndarray:
        return self.filters.point_intersection(p1, p2)

    def write_fvec(self, filename: str) -> None:
        """CAPS fvec export: <dim><vector as int32>... (ref: filtered_dataset.h:98-115)."""
        n, d = self.points.shape
        buf = np.empty((n, d + 1), dtype=np.int32)
        buf[:, 0] = d
        buf[:, 1:] = self.points.astype(np.int32)
        buf.tofile(filename)

    def write_labels(self, filename: str) -> None:
        """CAPS label export (ref: filtered_dataset.h:117-122)."""
        with open(filename, "w") as f:
            f.write(" ".join(str(i) for i in range(self.points.shape[0])) + " ")
