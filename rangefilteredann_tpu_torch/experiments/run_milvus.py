"""Milvus baseline runner (ref: experiments/run_milvus.py:1-302).

Benchmarks a Milvus server on the same window-search protocol: vectors with a
`priority` scalar field, range filters pushed down as boolean expressions
(`(priority > a) && (priority < b)`, ref: run_milvus.py:225-240), sweeping the
reference's index types (HNSW M=64 efConstruction=500, IVF_FLAT / IVF_SQ8 /
IVF_PQ with nlist=sqrt(n), SCANN; ref: run_milvus.py:43-77). Emits the same
CSV schema as run_our_method so plots/tables compare directly.

Requires a reachable Milvus (the reference launches one via Docker compose,
docker-compose.yml and milvus.yaml beside the JAX package's copy of this
file); the script exits cleanly when `pymilvus` or the server is
unavailable — it exists for protocol parity and for users running against a
real cluster. The port's copy of rangefilteredann_tpu/experiments/
run_milvus.py, over the port's protocol loaders.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .datasets import get_queries_and_gt, initialize_dataset, metric_of
from .run_our_method import (
    EXPERIMENT_FILTER_WIDTHS,
    TOP_K,
    compute_recall,
)


def save_row(results_dir, dataset_name, width, method, recall, avg_time, qps,
             threads, build_time=""):
    """Append one CSV row, reference schema (ref: run_milvus.py results
    writing / run_our_method.py:538-567)."""
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, f"{dataset_name}_results.csv")
    if not os.path.exists(path):
        with open(path, "a") as f:
            f.write("filter_width,method,recall,average_time,qps,threads,"
                    "build_time,branching_factor,memory\n")
    with open(path, "a") as f:
        f.write(f"{width},{method},{recall},{avg_time},{qps},{threads},"
                f"{build_time},,\n")

THREADS = 16  # ref: run_milvus.py:19
INDEX_TYPES = {
    "HNSW": {"M": 64, "efConstruction": 500},
    "IVF_FLAT": {},
    "IVF_SQ8": {},
    "IVF_PQ": {"m": 8},
    "SCANN": {},
}
SEARCH_GRIDS = {
    "HNSW": [{"ef": ef} for ef in (10, 20, 40, 80, 160, 320, 640)],
    "IVF_FLAT": [{"nprobe": p} for p in (1, 2, 4, 8, 16, 32, 64)],
    "IVF_SQ8": [{"nprobe": p} for p in (1, 2, 4, 8, 16, 32, 64)],
    "IVF_PQ": [{"nprobe": p} for p in (1, 2, 4, 8, 16, 32, 64)],
    "SCANN": [{"nprobe": p} for p in (1, 2, 4, 8, 16, 32, 64)],
}


def _connect(host: str, port: int):
    try:
        from pymilvus import connections
    except ImportError:
        print("pymilvus not installed — skipping Milvus baseline")
        return False
    try:
        connections.connect(host=host, port=str(port))
        return True
    except Exception as e:  # server unreachable
        print(f"cannot reach Milvus at {host}:{port}: {e} — skipping")
        return False


def run(dataset_name: str, index_type: str, host="localhost", port=19530,
        results_dir="results", data_dir=None):
    if not _connect(host, port):
        return
    from pymilvus import (
        Collection, CollectionSchema, DataType, FieldSchema, utility,
    )

    points, all_queries, labels, _metric = initialize_dataset(dataset_name, data_dir)
    n, dim = points.shape
    metric = "IP" if metric_of(dataset_name) == "mips" else "L2"
    name = f"window_{dataset_name.replace('-', '_')}"

    if utility.has_collection(name):
        coll = Collection(name)
    else:
        schema = CollectionSchema([
            FieldSchema("id", DataType.INT64, is_primary=True),
            FieldSchema("priority", DataType.DOUBLE),
            FieldSchema("embedding", DataType.FLOAT_VECTOR, dim=dim),
        ])
        coll = Collection(name, schema)
        batch = 10_000
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            coll.insert([
                list(range(lo, hi)),
                labels[lo:hi].tolist(),
                points[lo:hi].tolist(),
            ])
        coll.flush()

    params = dict(INDEX_TYPES[index_type])
    if index_type.startswith("IVF") or index_type == "SCANN":
        params["nlist"] = int(np.sqrt(n))  # ref: run_milvus.py:59-77
    t0 = time.time()
    coll.create_index(
        "embedding",
        {"index_type": index_type, "metric_type": metric, "params": params},
    )
    coll.load()
    build_time = time.time() - t0

    for width in EXPERIMENT_FILTER_WIDTHS:
        try:
            ranges, gt = get_queries_and_gt(dataset_name, width, data_dir)
        except FileNotFoundError:
            print(f"skipping {width}: no query/GT protocol files")
            continue
        queries = all_queries[: len(ranges)]
        nq = len(queries)
        for sp in SEARCH_GRIDS[index_type]:
            t0 = time.time()
            results = []
            for qi in range(nq):
                a, b = ranges[qi]
                hits = coll.search(
                    [queries[qi].tolist()], "embedding",
                    {"metric_type": metric, "params": sp},
                    limit=TOP_K,
                    expr=f"(priority > {a}) && (priority < {b})",
                )
                results.append([h.id for h in hits[0]])
            dt = time.time() - t0
            recall = compute_recall(np.array(
                [r + [-1] * (TOP_K - len(r)) for r in results]
            ), gt, TOP_K)
            save_row(
                results_dir, dataset_name, width,
                f"milvus-{index_type}_{'_'.join(map(str, sp.values()))}",
                recall, dt / nq, nq / dt, THREADS, build_time=build_time,
            )
            print(f"{index_type} {sp} width={width}: "
                  f"recall={recall:.4f} qps={nq/dt:.0f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--index-types", nargs="+", default=list(INDEX_TYPES))
    ap.add_argument("--host", default=os.environ.get("MILVUS_HOST", "localhost"))
    ap.add_argument("--port", type=int, default=19530)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--data-dir", default=None)
    args = ap.parse_args(argv)
    for it in args.index_types:
        run(args.dataset, it, args.host, args.port, args.results_dir,
            args.data_dir)


if __name__ == "__main__":
    main()
