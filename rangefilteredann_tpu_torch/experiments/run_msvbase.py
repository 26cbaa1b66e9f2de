"""MSVBASE (VBASE) baseline runner (ref: experiments/run_msvbase.py:1-203).

Benchmarks a VBASE-enabled PostgreSQL on the window-search protocol: a table
(id, priority, embedding vector) with an HNSW vector index, range filters as
SQL predicates, ordered by embedding distance with LIMIT k. Emits the
run_our_method CSV schema.

The reference runs the server via Docker; the script exits cleanly when
`psycopg2` or the server is unavailable. The port's copy of
rangefilteredann_tpu/experiments/run_msvbase.py.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .datasets import get_queries_and_gt, initialize_dataset, metric_of
from .run_milvus import save_row
from .run_our_method import EXPERIMENT_FILTER_WIDTHS, TOP_K, compute_recall

THREADS = 16


def _connect(host, port, user, password, dbname):
    try:
        import psycopg2
    except ImportError:
        print("psycopg2 not installed — skipping MSVBASE baseline")
        return None
    try:
        return psycopg2.connect(
            host=host, port=port, user=user, password=password, dbname=dbname
        )
    except Exception as e:
        print(f"cannot reach MSVBASE at {host}:{port}: {e} — skipping")
        return None


def run(dataset_name, host="localhost", port=5432, user="vectordb",
        password="vectordb", dbname="vectordb", results_dir="results",
        data_dir=None):
    conn = _connect(host, port, user, password, dbname)
    if conn is None:
        return
    cur = conn.cursor()
    points, all_queries, labels, _metric = initialize_dataset(dataset_name, data_dir)
    n, dim = points.shape
    op = "<#>" if metric_of(dataset_name) == "mips" else "<->"
    table = f"window_{dataset_name.replace('-', '_')}"

    cur.execute(f"SELECT to_regclass('{table}')")
    if cur.fetchone()[0] is None:
        cur.execute(
            f"CREATE TABLE {table} "
            f"(id int PRIMARY KEY, priority float8, embedding float8[{dim}])"
        )
        # chunked inserts: one statement for the full set exceeds
        # PostgreSQL's query-size limit at reference scales
        # (ref: run_msvbase.py:134-140 loads in batches too)
        batch = 10_000
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            chunk = b",".join(
                cur.mogrify("(%s,%s,%s)", (i, float(labels[i]), points[i].tolist()))
                for i in range(lo, hi)
            )
            cur.execute(f"INSERT INTO {table} VALUES " + chunk.decode())
        t0 = time.time()
        cur.execute(
            f"CREATE INDEX {table}_hnsw ON {table} "
            f"USING hnsw(embedding) WITH (dimension={dim})"
        )
        # scalar index on the filter column — the reference creates one and
        # the range predicate is a sequential scan without it
        # (ref: run_msvbase.py:145)
        cur.execute(f"CREATE INDEX {table}_filter_idx ON {table} (priority)")
        conn.commit()
        build_time = time.time() - t0
    else:
        build_time = ""

    for width in EXPERIMENT_FILTER_WIDTHS:
        try:
            ranges, gt = get_queries_and_gt(dataset_name, width, data_dir)
        except FileNotFoundError:
            print(f"skipping {width}: no query/GT protocol files")
            continue
        queries = all_queries[: len(ranges)]
        nq = len(queries)
        t0 = time.time()
        results = []
        for qi in range(nq):
            a, b = ranges[qi]
            cur.execute(
                f"SELECT id FROM {table} "
                f"WHERE priority > %s AND priority < %s "
                f"ORDER BY embedding {op} %s::float8[] LIMIT {TOP_K}",
                (float(a), float(b), queries[qi].tolist()),
            )
            results.append([r[0] for r in cur.fetchall()])
        dt = time.time() - t0
        recall = compute_recall(
            np.array([r + [-1] * (TOP_K - len(r)) for r in results]), gt, TOP_K
        )
        save_row(results_dir, dataset_name, width, "msvbase", recall,
                 dt / nq, nq / dt, THREADS, build_time=build_time)
        print(f"msvbase width={width}: recall={recall:.4f} qps={nq/dt:.0f}")
    conn.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--host", default=os.environ.get("MSVBASE_HOST", "localhost"))
    ap.add_argument("--port", type=int, default=5432)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--data-dir", default=None)
    args = ap.parse_args(argv)
    run(args.dataset, host=args.host, port=args.port,
        results_dir=args.results_dir, data_dir=args.data_dir)


if __name__ == "__main__":
    main()
