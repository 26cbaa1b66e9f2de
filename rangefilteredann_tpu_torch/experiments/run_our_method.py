"""Benchmark driver — parity with the reference's experiments/run_our_method.py.

The port's copy of rangefilteredann_tpu/experiments/run_our_method.py: same
method set, hyperparameter grids, early-stop heuristic, CSV schema and
index-cache paths (ref: run_our_method.py:29-39 grids, :174-207 recall +
should_break, :538-567 CSV `filter_width,method,recall,average_time,qps,
threads[,build_time,branching_factor,memory]`), so both drivers share
`index_cache/` and `results/`. Every index lives on `--device` (default
"cuda"; "cpu" runs the plain PyTorch versions). "threads" records the CUDA
device count, 1 on the CPU (the reference records PARLAY_NUM_THREADS).

Usage:
  python -m rangefilteredann_tpu_torch.experiments.run_our_method \
      --dataset adversarial-100-angular --prefiltering --data_folder data
"""

from __future__ import annotations

import argparse
import gc
import os
import resource
import sys
import time

import numpy as np
import torch

from .. import wrapper as wp
from . import datasets as ds

TOP_K = 10
BEAM_SIZES = [10, 20, 40, 80, 160, 320, 640, 1280]
FINAL_MULTIPLIES = [1, 2, 3, 4, 8, 16, 32]
ALPHAS = [1]
VAMANA_TREE_SPLIT_FACTORS = [2]
SUPER_POSTFILTERING_SPLIT_FACTORS = [2]
SUPER_POSTFILTERING_SHIFT_FACTORS = [0.5]
EXPERIMENT_FILTER_WIDTHS = [f"2pow{i}" for i in range(-16, 1)]


def compute_recall(results, gt_neighbors, top_k):
    """(ref: run_our_method.py:174-180)"""
    recall = 0.0
    for i in range(len(gt_neighbors)):
        gt = set(np.asarray(gt_neighbors[i]).tolist())
        res = set(np.asarray(results[i][:top_k], dtype=np.int64).tolist())
        recall += len(gt & res) / len(gt)
    return recall / len(gt_neighbors)


def should_break(run_results):
    """Early-stop heuristic (ref: run_our_method.py:187-207): stop a sweep
    when recall ~ 1, recall stopped improving (except first multiply), or the
    run got slower than the last prefiltering run."""
    if not run_results:
        return False
    if run_results[-1][2] > 0.999:
        return True
    if len(run_results) == 1:
        return False
    recall_not_better = run_results[-1][2] <= run_results[-2][2]
    one_multiply = str(run_results[-1][1]).split("_")[-1] == "1"
    if recall_not_better and not one_multiply:
        return True
    pre = [x for x in run_results if x[1] == "prefiltering"]
    if not pre:
        return False
    return run_results[-1][3] > pre[-1][3]


def rss_kb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--threads", type=int, default=None,
                   help="Recorded in the CSV; no-op (device count used)")
    p.add_argument("--postfiltering", action="store_true")
    p.add_argument("--optimized_postfiltering", action="store_true")
    p.add_argument("--vamana_tree", action="store_true")
    p.add_argument("--prefiltering", action="store_true")
    p.add_argument("--smart_combined", action="store_true")
    p.add_argument("--three_split", action="store_true")
    p.add_argument("--super_opt_postfiltering", action="store_true")
    p.add_argument("--all_methods", action="store_true")
    p.add_argument("--results_file_prefix", default="")
    p.add_argument("--beam_search_size", type=int, default=None)
    p.add_argument("--experiment_filter_width", type=str, default=None)
    p.add_argument("--num_final_multiplies", type=int, default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--dont_write_to_results_file", action="store_true")
    p.add_argument("--no_warmup", action="store_true",
                   help="Skip the untimed warm-up search before each timed "
                        "one (warm-up excludes kernel builds and first "
                        "uploads from QPS, the analogue of the reference C++ "
                        "harness's warm-up run, check_nn_recall.h:60-66)")
    p.add_argument("--vamana_tree_split_factor", type=int, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--super_opt_postfiltering_split_factor", type=float, default=None)
    p.add_argument("--super_opt_postfiltering_shift_factor", type=float, default=None)
    p.add_argument("--data_folder", type=str, default=None)
    p.add_argument("--build_R", type=int, default=64)
    p.add_argument("--build_L", type=int, default=500)
    p.add_argument("--cutoff", type=int, default=1000)
    p.add_argument("--device", type=str, default="cuda",
                   help="Where every index lives: cuda (the kernels) or cpu")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    threads = args.threads or (torch.cuda.device_count() if dev.type == "cuda" else 1)

    beam_sizes = [args.beam_search_size] if args.beam_search_size else BEAM_SIZES
    widths = ([args.experiment_filter_width] if args.experiment_filter_width
              else EXPERIMENT_FILTER_WIDTHS)
    multiplies = ([args.num_final_multiplies] if args.num_final_multiplies
                  else FINAL_MULTIPLIES)
    dataset_names = [args.dataset] if args.dataset else ds.DATASETS
    alphas = [args.alpha] if args.alpha is not None else ALPHAS
    tree_splits = ([args.vamana_tree_split_factor]
                   if args.vamana_tree_split_factor else VAMANA_TREE_SPLIT_FACTORS)
    super_splits = ([args.super_opt_postfiltering_split_factor]
                    if args.super_opt_postfiltering_split_factor
                    else SUPER_POSTFILTERING_SPLIT_FACTORS)
    super_shifts = ([args.super_opt_postfiltering_shift_factor]
                    if args.super_opt_postfiltering_shift_factor
                    else SUPER_POSTFILTERING_SHIFT_FACTORS)

    run = dict(
        postfiltering=args.postfiltering or args.all_methods,
        optimized_postfiltering=args.optimized_postfiltering or args.all_methods,
        vamana_tree=args.vamana_tree or args.all_methods,
        prefiltering=args.prefiltering or args.all_methods,
        smart_combined=args.smart_combined or args.all_methods,
        three_split=args.three_split or args.all_methods,
        super_opt_postfiltering=args.super_opt_postfiltering or args.all_methods,
    )
    if not any(run.values()):
        print("NOTE: No experiments specified, so aborting")
        p.print_help()
        sys.exit(0)

    os.makedirs("results", exist_ok=True)
    for name in dataset_names:
        os.makedirs(f"index_cache/{name}/", exist_ok=True)
        os.makedirs(f"index_cache/{name}-super_opt_postfiltering/", exist_ok=True)

    for name in dataset_names:
        data, queries, filter_values, metric = ds.initialize_dataset(
            name, args.data_folder
        )
        nq = len(queries)
        ds_widths = [""] if "adversarial" in name else widths

        for width in ds_widths:
            all_results = []
            try:
                ranges, gt = ds.get_queries_and_gt(name, width, args.data_folder)
            except FileNotFoundError:
                print(f"skipping {width}: no query/GT protocol files", flush=True)
                continue

            def record(method, recall, total, *extra):
                all_results.append((width, method, recall, total) + extra)
                print(all_results[-1], flush=True)

            def timed(search):
                """Run a search twice: untimed warm-up, then timed
                (ref: check_nn_recall.h:60-66 does the same). The results
                come back as numpy; the clock stops after the device is
                idle as well."""
                if not args.no_warmup:
                    search()
                t0 = time.time()
                res = search()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                return res, time.time() - t0

            if run["prefiltering"]:
                t0 = time.time()
                pre = wp.prefilter_index_constructor(metric, "float")(
                    data, filter_values, device=dev)
                print(f"Prefiltering index build time: {time.time()-t0:.3f}s", flush=True)
                qp = wp.build_query_params(k=TOP_K, beam_size=0, verbose=args.verbose)
                res, dt = timed(lambda: pre.batch_search(queries, ranges, nq, qp))
                record("prefiltering", compute_recall(res[0], gt, TOP_K), dt)

            for alpha in alphas:
                if run["postfiltering"]:
                    bp = wp.BuildParams(args.build_R, args.build_L, alpha,
                                        f"index_cache/{name}/unsorted-")
                    t0 = time.time()
                    pf = wp.postfilter_vamana_constructor(metric, "float")(
                        data, filter_values, bp, device=dev)
                    print(f"Naive postfilter build time: {time.time()-t0:.3f}s", flush=True)
                    for beam in beam_sizes:
                        for fm in multiplies:
                            qp = wp.build_query_params(
                                k=TOP_K, beam_size=beam, final_beam_multiply=fm,
                                verbose=args.verbose)
                            res, dt = timed(
                                lambda: pf.batch_search(queries, ranges, nq, qp))
                            record(f"postfiltering_{alpha}_{beam}_{fm}",
                                   compute_recall(res[0], gt, TOP_K), dt)
                            if should_break(all_results):
                                break

                tree_methods = ("vamana_tree", "optimized_postfiltering",
                                "smart_combined", "three_split")
                if any(run[m] for m in tree_methods):
                    for split in tree_splits:
                        gc.disable()
                        mem0 = rss_kb()
                        bp = wp.BuildParams(args.build_R, args.build_L, alpha,
                                            f"index_cache/{name}/")
                        t0 = time.time()
                        tree = wp.vamana_range_filter_tree_constructor(metric, "float")(
                            data, filter_values, cutoff=args.cutoff,
                            split_factor=split, build_params=bp, device=dev)
                        build_time = time.time() - t0
                        memory = rss_kb() - mem0
                        gc.enable()
                        print(f"Vamana tree build time: {build_time:.3f}s", flush=True)

                        if run["vamana_tree"]:
                            for beam in beam_sizes:
                                qp = wp.build_query_params(
                                    k=TOP_K, beam_size=beam, verbose=args.verbose)
                                res, dt = timed(lambda: tree.batch_search(
                                    queries, ranges, nq, "fenwick", qp))
                                record(f"vamana-tree_{alpha:.3f}_{split}_{beam}",
                                       compute_recall(res[0], gt, TOP_K),
                                       dt, build_time, split, memory)
                        if run["optimized_postfiltering"]:
                            for beam in beam_sizes:
                                for fm in multiplies:
                                    qp = wp.build_query_params(
                                        k=TOP_K, beam_size=beam,
                                        final_beam_multiply=fm, verbose=args.verbose)
                                    res, dt = timed(lambda: tree.batch_search(
                                        queries, ranges, nq, "optimized_postfilter", qp))
                                    record(
                                        f"optimized-postfiltering_{alpha:.3f}_{split}_{beam}_{fm}",
                                        compute_recall(res[0], gt, TOP_K),
                                        dt, build_time, split, memory)
                                    if should_break(all_results):
                                        break
                        if run["smart_combined"]:
                            for beam in beam_sizes:
                                for fm in multiplies:
                                    qp = wp.build_query_params(
                                        k=TOP_K, beam_size=beam, final_beam_multiply=fm,
                                        min_query_to_bucket_ratio=0.05,
                                        verbose=args.verbose)
                                    res, dt = timed(lambda: tree.batch_search(
                                        queries, ranges, nq, "optimized_postfilter", qp))
                                    record(
                                        f"smart-combined_{alpha:.3f}_{split}_{beam}_{fm}",
                                        compute_recall(res[0], gt, TOP_K),
                                        dt, build_time, split, memory)
                                    if should_break(all_results):
                                        break
                        if run["three_split"]:
                            for beam in beam_sizes:
                                for fm in multiplies:
                                    qp = wp.build_query_params(
                                        k=TOP_K, beam_size=beam, final_beam_multiply=fm,
                                        min_query_to_bucket_ratio=0.05,
                                        verbose=args.verbose)
                                    res, dt = timed(lambda: tree.batch_search(
                                        queries, ranges, nq, "three_split", qp))
                                    record(
                                        f"three-split_{alpha:.3f}_{split}_{beam}_{fm}",
                                        compute_recall(res[0], gt, TOP_K), dt)
                                    if should_break(all_results):
                                        break

                if run["super_opt_postfiltering"]:
                    for split in super_splits:
                        for shift in super_shifts:
                            gc.disable()
                            mem0 = rss_kb()
                            bp = wp.BuildParams(
                                args.build_R, args.build_L, alpha,
                                f"index_cache/{name}-super_opt_postfiltering/")
                            t0 = time.time()
                            sup = wp.super_optimized_postfilter_tree_constructor(
                                metric, "float")(
                                data, filter_values, cutoff=args.cutoff,
                                split_factor=split, shift_factor=shift,
                                build_params=bp, device=dev)
                            build_time = time.time() - t0
                            memory = rss_kb() - mem0
                            gc.enable()
                            print(f"Super optimized postfilter tree build time: "
                                  f"{build_time:.3f}s", flush=True)
                            for beam in beam_sizes:
                                for fm in multiplies:
                                    qp = wp.build_query_params(
                                        k=TOP_K, beam_size=beam,
                                        final_beam_multiply=fm, verbose=args.verbose)
                                    res, dt = timed(lambda: sup.batch_search(
                                        queries, ranges, nq, qp))
                                    record(
                                        f"super-postfiltering_{split}_{shift}_{alpha}_{beam}_{fm}",
                                        compute_recall(res[0], gt, TOP_K),
                                        dt, build_time, split, memory)
                                    if should_break(all_results):
                                        break

            save_results(all_results, name, args, nq, threads)


def save_results(all_results, dataset_name, args, num_queries, threads):
    """CSV writer, schema-identical to the reference (ref: :538-567)."""
    if args.dont_write_to_results_file:
        return
    output_file = f"results/{args.results_file_prefix}{dataset_name}_results.csv"
    if not os.path.exists(output_file):
        with open(output_file, "a") as f:
            f.write("filter_width,method,recall,average_time,qps,threads,"
                    "build_time,branching_factor,memory\n")
    with open(output_file, "a") as f:
        for tup in all_results:
            width, name, recall, total = tup[:4]
            extra = list(tup[4:]) + [""] * (3 - len(tup[4:]))
            build_time, branching, memory = extra[:3]
            f.write(
                f"{width},{name},{recall},{total/num_queries},"
                f"{num_queries/total},{threads},{build_time},{branching},{memory}\n"
            )


if __name__ == "__main__":
    main()
