"""Unfiltered Vamana index over files (the reference's file-based API).

Counterpart of rangefilteredann_tpu/models/vamana_index.py (ref:
ParlayANN/python/vamana_index.cpp:43-125, builder.cpp:33-59,
python_bindings.cpp:93-109): build a graph from a binary vector file and
save it; load a graph and its vectors and batch-search them at a beam
width; check recall against a binary ground-truth file.

The search prunes its frontier by the cut (k > 0, cut 1.35, ref:
vamana_index.cpp:57), which the beam kernel does not cover
(ops/beam.kernel_covers), so it runs ops/beam_search.batched_beam_search on
the store's device, over inline blocks where maybe_attach_inline gave the
graph some, as the JAX package runs it as XLA code and not in its Pallas
kernel. The JAX package pads the query batch to a power of two, a TPU shape
class whose added rows are inactive; the port searches the batch as given.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.beam_search import batched_beam_search, default_expand, exact_rerank
from ..params import BuildParams
from ..utils import io as bin_io
from ..utils.data import make_pointset, pad_queries
from .base import finalize_output, maybe_attach_inline
from .postfilter_vamana import RERANK_SLACK
from .vamana import SlabGraph, build_vamana_graph


def build_vamana_index(
    distance_metric: str,
    data_file_path: str,
    index_output_path: str,
    graph_degree: int,
    beam_width: int,
    alpha: float,
    dtype: str = "float",
    seed: int = 0,
    device=None,
) -> None:
    """Build a graph over a .bin vector file and save it in the reference's
    graph format (ref: builder.cpp:33-59). `device` runs the build: None
    means the card."""
    data = bin_io.read_vector_file(data_file_path, dtype)
    ps = make_pointset(data, distance_metric, device=device)
    n = ps.n
    bp = BuildParams(R=graph_degree, L=beam_width, alpha=alpha)
    g = build_vamana_graph(ps, np.arange(n, dtype=np.int64),
                           np.array([0, n], dtype=np.int64), bp, seed=seed)
    bin_io.write_graph_file(index_output_path, g.nbrs_host)


class VamanaIndex:
    """A built graph and its vectors, loaded from files and batch-searched
    (ref: vamana_index.cpp:43). `device` places the store and the graph:
    None means the card."""

    def __init__(
        self,
        index_path: str,
        data_path: str,
        num_points: int = 0,
        dimensions: int = 0,
        metric: str = "Euclidian",
        dtype: str = "float",
        device=None,
    ):
        data = bin_io.read_vector_file(data_path, dtype)
        if num_points and num_points != data.shape[0]:
            raise ValueError(f"{data_path} holds {data.shape[0]} points, "
                             f"not {num_points}")
        if dimensions and dimensions != data.shape[1]:
            raise ValueError(f"{data_path} holds {data.shape[1]} dimensions, "
                             f"not {dimensions}")
        nbrs, _ = bin_io.read_graph_file(index_path)
        self._init_from_arrays(data, nbrs, metric, device)

    @classmethod
    def from_arrays(cls, data: np.ndarray, nbrs: np.ndarray, metric="Euclidian",
                    device=None) -> "VamanaIndex":
        self = cls.__new__(cls)
        self._init_from_arrays(data, nbrs, metric, device)
        return self

    def _init_from_arrays(self, data, nbrs, metric, device):
        self._ps = make_pointset(data, metric, device=device)
        self._graph = SlabGraph.from_nbrs(nbrs, self._ps.device)
        maybe_attach_inline(self._graph, self._ps)

    @property
    def device(self):
        return self._ps.device

    def batch_search(
        self,
        queries: np.ndarray,
        num_queries: int,
        knn: int,
        beam_width: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """QueryParams(knn, beam, cut=1.35, limit=n, full degree)
        (ref: vamana_index.cpp:57); every search starts at vertex 0.
        Returns (ids [nq, knn] uint32, dists [nq, knn] f32)."""
        queries = np.asarray(queries, dtype=np.float32)[:num_queries]
        ps, g = self._ps, self._graph
        knn, beam = int(knn), int(beam_width)
        norm_col = ps.norm_col if ps.norm_col >= 0 else None
        q_norms = np.einsum("qd,qd->q", queries, queries)
        qs = torch.from_numpy(pad_queries(queries, ps.d, ps.d_pad)).to(ps.device)
        res = batched_beam_search(
            ps.data, ps.norms_sq, g.nbrs_dev, g.slab_to_global_dev, qs,
            torch.zeros(len(queries), dtype=torch.int32, device=ps.device),
            beam=beam, k=knn, cut=1.35, limit=ps.n, metric=ps.metric,
            q_norms_sq=torch.from_numpy(q_norms).to(ps.device),
            expand=default_expand(beam), norm_col=norm_col, identity_map=True,
            nbr_vecs=g.nbr_vecs, nbr_norms=g.nbr_norms, nbr_scale=g.nbr_scale)
        f_ids, f_d = res.frontier_ids, res.frontier_dists
        if g.nbr_scale is not None:
            # int8-rounded frontier scores: rerank the top k + slack exactly
            # (identity slab map: frontier ids are store rows)
            f_ids, f_d = exact_rerank(ps.data, ps.norms_sq, qs,
                                      f_ids[:, : knn + RERANK_SLACK], knn,
                                      ps.metric, norm_col=norm_col)
        ids = f_ids[:, :knn].cpu().numpy().astype(np.int64)
        dists = f_d[:, :knn].cpu().numpy()
        return finalize_output(dists, ids, None, q_norms, ps.metric, pad_id=0)

    def check_recall(self, gFile: str, neighbors: np.ndarray, k: int) -> float:
        """Recall against a binary ground-truth file, every entry tied with
        the k-th distance counted (ref: vamana_index.cpp:99-125,
        check_nn_recall.h:85-108)."""
        gt_ids, gt_dists = bin_io.read_groundtruth_file(gFile)
        n = neighbors.shape[0]
        hits = 0
        for i in range(n):
            kth = gt_dists[i, k - 1]
            valid = set(gt_ids[i, np.nonzero(gt_dists[i] <= kth)[0]].tolist())
            hits += len(valid & set(neighbors[i, :k].astype(np.uint32).tolist()))
        return hits / (n * k)
