"""Command-line build and beam sweep over binary files: the ParlayANN
`neighbors` executable's role (ref: ParlayANN/algorithms/bench/neighborsTime.C,
parse_command_line.h, vamana/neighbors.h:40-68), on the port.

Counterpart of rangefilteredann_tpu/cli.py, with the same flags and table,
and one more: -device (default cuda; cpu runs the plain PyTorch path). It
builds an unfiltered Vamana graph over a binary vector file with -R/-L/-a
(or loads one with -graph_path), then sweeps beam widths, printing recall
(distance ties counted) against a binary ground-truth file, and QPS.

Usage:
  python -m rangefilteredann_tpu_torch.cli \\
      -base_path data.bin -query_path queries.bin -gt_path gt.bin \\
      -R 64 -L 128 -a 1.2 -k 10 -graph_outfile graph.bin
  python -m rangefilteredann_tpu_torch.cli \\
      -base_path data.bin -query_path queries.bin -gt_path gt.bin \\
      -graph_path graph.bin -k 10 -beams 10,20,40,80
"""

from __future__ import annotations

import argparse
import time

from .models.vamana_index import VamanaIndex, build_vamana_index
from .utils import io as bin_io

DEFAULT_BEAMS = [10, 20, 40, 80, 160, 320]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-base_path", required=True, help="binary vector file")
    ap.add_argument("-query_path", required=True)
    ap.add_argument("-gt_path", default=None, help="binary ground-truth file")
    ap.add_argument("-graph_path", default=None, help="load a built graph")
    ap.add_argument("-graph_outfile", default=None, help="save the built graph")
    ap.add_argument("-R", type=int, default=64, help="max degree")
    ap.add_argument("-L", type=int, default=128, help="build beam width")
    ap.add_argument("-a", "-alpha", dest="alpha", type=float, default=1.2)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("-dist_func", default="Euclidian",
                    choices=["Euclidian", "mips"])
    ap.add_argument("-data_type", default="float",
                    choices=["float", "uint8", "int8"])
    ap.add_argument("-beams", default=",".join(map(str, DEFAULT_BEAMS)))
    ap.add_argument("-device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    graph_path = args.graph_path
    if graph_path is None:
        graph_path = args.graph_outfile or (args.base_path + ".graph")
        t0 = time.time()
        build_vamana_index(
            args.dist_func, args.base_path, graph_path,
            args.R, args.L, args.alpha, dtype=args.data_type, device=args.device,
        )
        print(f"built R={args.R} L={args.L} alpha={args.alpha} "
              f"in {time.time() - t0:.1f}s -> {graph_path}")

    idx = VamanaIndex(graph_path, args.base_path, metric=args.dist_func,
                      dtype=args.data_type, device=args.device)
    queries = bin_io.read_vector_file(args.query_path, args.data_type)
    nq = queries.shape[0]
    print(f"{'beam':>6} {'recall':>8} {'QPS':>12} {'avg_ms':>8}")
    for beam in (int(b) for b in args.beams.split(",")):
        idx.batch_search(queries, nq, args.k, beam)  # warm-up
        t0 = time.time()
        ids, _ = idx.batch_search(queries, nq, args.k, beam)
        dt = time.time() - t0
        recall = (
            idx.check_recall(args.gt_path, ids, args.k)
            if args.gt_path else float("nan")
        )
        print(f"{beam:>6} {recall:>8.4f} {nq/dt:>12.0f} {1e3*dt/nq:>8.3f}")


if __name__ == "__main__":
    main()
