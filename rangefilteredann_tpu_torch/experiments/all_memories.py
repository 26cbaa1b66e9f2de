"""Run the memory study for every (method, dataset) pair, one build per
subprocess so RSS deltas don't contaminate each other
(ref: experiments/all_memories.py:28-41, run_all_memories.sh)."""

from __future__ import annotations

import argparse
import subprocess
import sys

METHODS = ["prefiltering", "postfiltering", "vamana-tree", "super-postfiltering"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("datasets", nargs="+")
    ap.add_argument("--methods", nargs="+", default=METHODS)
    ap.add_argument("--out", default="results/memory.csv")
    ap.add_argument("--data_folder", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for dataset in args.datasets:
        for method in args.methods:
            cmd = [
                sys.executable, "-m",
                "rangefilteredann_tpu_torch.experiments.memory_footprint",
                "--method", method, "--dataset", dataset, "--out", args.out,
                "--device", args.device,
            ]
            if args.data_folder:
                cmd += ["--data_folder", args.data_folder]
            print("$", " ".join(cmd), flush=True)
            rc = subprocess.run(cmd).returncode
            if rc != 0:
                print(f"  FAILED (rc={rc})", file=sys.stderr)


if __name__ == "__main__":
    main()
