"""Dataset generation + loading for the window-search benchmark protocol.

A copy of rangefilteredann_tpu/experiments/datasets.py (same file names,
seeds and numpy draws, so the same files), kept here so that the port never
imports the JAX package. Equivalent of the reference's generate_datasets/* (ref:
generate_ann_benchmarks_datasets.py, filter_generation_utils.py,
generate_advserial_dataset.py) and the .npy protocol consumed by the driver
(ref: experiments/run_our_method.py:218-236):

  {name}.npy                      — points [n, d] float32 (angular: L2-normalized)
  {name}_queries.npy              — query vectors
  {name}_filter-values.npy        — one numeric label per point
  {name}_queries_2pow{i}_ranges.npy — per-query [lo, hi] label ranges
  {name}_queries_2pow{i}_gt.npy   — exact top-10 ids under the filter

Differences from the reference:
  * ann-benchmarks HDF5 downloads and RedCaps/CLIP embedding builds need
    network access; these functions convert from local files when present
    and raise a clear error otherwise. Synthetic + adversarial datasets generate
    locally.
  * Exact ground truth runs through the port's prefilter routing
    (models/base.batched_range_bruteforce): windows wider than
    window_gather_max() take the range-masked scan kernel on the card
    (csrc/scan_topk.cu), narrower ones the per-query gather, instead of a
    per-query NumPy loop — same label-inclusive semantics
    (ref: filter_generation_utils.py:142-168). Every generator takes
    `device`: None means the card, "cpu" the plain PyTorch versions.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

EXPERIMENT_FILTER_POWERS = list(range(-16, 1))
TOP_K = 10
DATASET_FOLDER = os.environ.get("WINDOW_ANN_DATA", "data")

DATASETS = [
    "sift-128-euclidean",
    "glove-100-angular",
    "deep-image-96-angular",
    "redcaps-512-angular",
    "adversarial-100-angular",
]


def is_angular(name: str) -> bool:
    return "angular" in name


def metric_of(name: str) -> str:
    return "mips" if is_angular(name) else "Euclidian"


# --------------------------------------------------------------- generation
def generate_random_query_filter_ranges(
    filter_values: np.ndarray,
    target_percentage: float,
    num_queries: int,
    rng: Optional[np.random.Generator] = None,
    follow_data_distribution: bool = True,
) -> np.ndarray:
    """Query label ranges at a filter fraction, following the data
    distribution (ref: filter_generation_utils.py:8-75): pick a uniform start
    index, span fraction*n points, jitter both endpoints into the gaps to the
    neighboring labels. Fraction 1 spans the whole support with slack."""
    rng = rng or np.random.default_rng()
    fv = np.sort(filter_values)
    lo, hi = float(fv[0]), float(fv[-1])
    if target_percentage == 1:
        return np.array(
            [(lo - rng.integers(1, 100), hi + rng.integers(1, 100))] * num_queries
        )
    out = []
    num_in = int(len(fv) * target_percentage)
    if follow_data_distribution:
        for _ in range(num_queries):
            si = rng.integers(0, len(fv) - num_in)
            ei = si + num_in
            s_val, e_val = fv[si], fv[ei]
            s_jit = rng.uniform() * ((s_val - fv[si - 1]) if si > 0 else 1)
            e_jit = rng.uniform() * ((fv[ei + 1] - e_val) if ei < len(fv) - 1 else 1)
            out.append((s_val - s_jit, e_val + e_jit))
    else:
        width = target_percentage * (hi - lo)
        for _ in range(num_queries):
            s = rng.uniform(lo, hi - width)
            out.append((s, s + width))
    return np.array(out)


def compute_ground_truths(
    data: np.ndarray,
    queries: np.ndarray,
    filter_ranges: np.ndarray,  # [nq, 2] label ranges (inclusive both ends)
    filter_values: np.ndarray,
    top_k: int,
    angular: bool,
    device=None,
) -> np.ndarray:
    """Exact filtered top-k through the port's prefilter routing on `device`
    (None: the card); the JAX package's compute_ground_truths_tpu. Label test
    is inclusive on both ends (ref: filter_generation_utils.py:155-160)."""
    from ..models.base import batched_range_bruteforce, to_device
    from ..utils.data import make_pointset, pad_queries, sort_by_labels

    pts_sorted, labels_sorted, decoding = sort_by_labels(data, filter_values)
    ps = make_pointset(pts_sorted, "mips" if angular else "l2", device=device)
    qpad = pad_queries(queries.astype(np.float32), ps.d, ps.d_pad)
    starts = np.searchsorted(labels_sorted, filter_ranges[:, 0], side="left")
    ends = np.searchsorted(labels_sorted, filter_ranges[:, 1], side="right")
    dists, ids = batched_range_bruteforce(
        ps.data, ps.norms_sq,
        *to_device(ps.device, qpad, starts.astype(np.int32), ends.astype(np.int32)),
        top_k, ps.metric, norm_col=ps.norm_col, widths=ends - starts,
    )
    assert np.isfinite(dists).all(), (
        "a query range holds fewer than top_k points; regenerate ranges"
    )
    return decoding[ids]


def generate_filters(
    output_dir: str,
    angular: bool,
    name: str,
    data: np.ndarray,
    queries: np.ndarray,
    filter_values: np.ndarray,
    seed: int = 0,
    powers=None,
    device=None,
) -> None:
    """All 17 fraction query-range + GT files (ref: filter_generation_utils.py
    generate_filters). `powers` restricts the fractions (fractions whose
    windows would hold fewer than TOP_K points are skipped with a warning)."""
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for p in powers if powers is not None else EXPERIMENT_FILTER_POWERS:
        if int(len(filter_values) * 2.0**p) < TOP_K:
            print(f"skipping 2pow{p}: window would hold < {TOP_K} points")
            continue
        ranges = generate_random_query_filter_ranges(
            filter_values, 2.0**p, len(queries), rng
        )
        gt = compute_ground_truths(
            data, queries, ranges, filter_values, TOP_K, angular, device
        )
        np.save(os.path.join(output_dir, f"{name}_queries_2pow{p}_ranges.npy"), ranges)
        np.save(os.path.join(output_dir, f"{name}_queries_2pow{p}_gt.npy"), gt)


def generate_synthetic(
    output_dir: str, name: str = "synthetic-64-euclidean",
    n: int = 100_000, d: int = 64, nq: int = 1000, seed: int = 0,
    powers=None, device=None,
) -> None:
    """Local stand-in for the downloaded ann-benchmarks sets: gaussian points,
    uniform random labels (ref label assignment:
    generate_ann_benchmarks_datasets.py:49-54)."""
    rng = np.random.default_rng(seed)
    angular = is_angular(name)
    data = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    if angular:
        data /= np.linalg.norm(data, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    labels = rng.uniform(size=n)
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, f"{name}.npy"), data)
    np.save(os.path.join(output_dir, f"{name}_queries.npy"), queries)
    np.save(os.path.join(output_dir, f"{name}_filter-values.npy"), labels)
    generate_filters(output_dir, angular, name, data, queries, labels, seed,
                     powers=powers, device=device)


def generate_adversarial(
    output_dir: str, name: str = "adversarial-100-angular",
    n: int = 1_000_000, n_clusters: int = 100, d: int = 100,
    nq: int = 10_000, seed: int = 0, device=None,
) -> None:
    """Adversarial set (ref: generate_advserial_dataset.py:8-60): gaussian
    clusters, labels ~= cluster id + U[0,1); each query targets one cluster's
    vectors but a *different* cluster's label window — worst case for naive
    postfiltering."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    per = n // n_clusters
    data = np.repeat(centers, per, axis=0) + 0.05 * rng.normal(size=(n, d))
    data = (data / np.linalg.norm(data, axis=1, keepdims=True)).astype(np.float32)
    labels = (np.repeat(np.arange(n_clusters), per) + rng.uniform(size=n)).astype(
        np.float64
    )
    # queries: near cluster c, filter window = label range of cluster (c+1)%k
    qc = rng.integers(0, n_clusters, size=nq)
    queries = centers[qc] + 0.05 * rng.normal(size=(nq, d))
    queries = (queries / np.linalg.norm(queries, axis=1, keepdims=True)).astype(
        np.float32
    )
    target = (qc + 1) % n_clusters
    ranges = np.stack([target.astype(np.float64), target + 1.0], axis=1)
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, f"{name}.npy"), data)
    np.save(os.path.join(output_dir, f"{name}_queries.npy"), queries)
    np.save(os.path.join(output_dir, f"{name}_filter-values.npy"), labels)
    gt = compute_ground_truths(data, queries, ranges, labels, TOP_K, True, device)
    np.save(os.path.join(output_dir, f"{name}_queries_ranges.npy"), ranges)
    np.save(os.path.join(output_dir, f"{name}_queries_gt.npy"), gt)


def convert_ann_benchmarks_hdf5(
    hdf5_path: str, output_dir: str, name: str, seed: int = 0, device=None
) -> None:
    """Convert a locally present ann-benchmarks HDF5 (nothing is
    downloaded) — L2-normalize angular data, assign uniform
    random labels (ref: generate_ann_benchmarks_datasets.py:19-54)."""
    import h5py  # gated: raise if unavailable

    rng = np.random.default_rng(seed)
    with h5py.File(hdf5_path, "r") as f:
        data = np.array(f["train"], dtype=np.float32)
        queries = np.array(f["test"], dtype=np.float32)
    if is_angular(name):
        data /= np.linalg.norm(data, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    labels = rng.uniform(size=len(data))
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, f"{name}.npy"), data)
    np.save(os.path.join(output_dir, f"{name}_queries.npy"), queries)
    np.save(os.path.join(output_dir, f"{name}_filter-values.npy"), labels)
    generate_filters(output_dir, is_angular(name), name, data, queries, labels, seed,
                     device=device)


def convert_redcaps(
    embeddings_path: str,
    timestamps_path: str,
    queries_path: str,
    output_dir: str,
    name: str = "redcaps-512-angular",
    seed: int = 0,
    device=None,
) -> None:
    """RedCaps protocol files from locally present CLIP embeddings
    (ref: generate_redcaps_data.py:15-16,65-80 — ~12M CLIP ViT-B/16 image
    embeddings, 512d, L2-normalized, labels = Unix created_utc timestamps;
    queries are 800 CLIP text-tower embeddings,
    ref: generate_redcaps_queries.py:14-29). Downloading/embedding RedCaps
    needs network access; this converts the three .npy artifacts."""
    data = np.load(embeddings_path).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    labels = np.load(timestamps_path).astype(np.float64)
    queries = np.load(queries_path).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, f"{name}.npy"), data)
    np.save(os.path.join(output_dir, f"{name}_queries.npy"), queries)
    np.save(os.path.join(output_dir, f"{name}_filter-values.npy"), labels)
    generate_filters(output_dir, True, name, data, queries, labels, seed,
                     device=device)


def embed_clip_queries(texts, model_name="openai/clip-vit-base-patch16"):
    """CLIP text-tower embeddings for RedCaps-style text queries
    (ref: generate_redcaps_queries.py:14-29). Requires the `transformers`
    package and locally cached weights; raises otherwise."""
    import torch
    from transformers import CLIPModel, CLIPProcessor

    model = CLIPModel.from_pretrained(model_name, local_files_only=True)
    proc = CLIPProcessor.from_pretrained(model_name, local_files_only=True)
    with torch.no_grad():
        inputs = proc(text=list(texts), return_tensors="pt", padding=True)
        emb = model.get_text_features(**inputs).numpy().astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


# ------------------------------------------------------------------ loading
def initialize_dataset(name: str, folder: Optional[str] = None):
    """(ref: run_our_method.py:218-228)"""
    folder = folder or DATASET_FOLDER
    data = np.load(os.path.join(folder, f"{name}.npy"))
    queries = np.load(os.path.join(folder, f"{name}_queries.npy"))
    filter_values = np.load(os.path.join(folder, f"{name}_filter-values.npy"))
    return data, queries, filter_values, metric_of(name)


def get_queries_and_gt(name: str, filter_width: str, folder: Optional[str] = None):
    """(ref: run_our_method.py:231-240). filter_width '' = adversarial style."""
    folder = folder or DATASET_FOLDER
    mid = "_" if filter_width == "" else f"_{filter_width}_"
    ranges = np.load(os.path.join(folder, f"{name}_queries{mid}ranges.npy"))
    gt = np.load(os.path.join(folder, f"{name}_queries{mid}gt.npy"))
    return ranges, gt
