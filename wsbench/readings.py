"""The readings a cell's correctness limits are set from.

    python3 wsbench/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3]

Runs the cell in this one process once for each seed, with a short window
(each pool batch answered at least once, so as many answers are compared as
in a full run), and prints each run's compared numbers; for the control
seeds, also the control's (the reference in float32 with TF32 products, put
in the program's place, judged alike). Ends with the lower reading (the
program's worst over the seeds) and the upper reading (the control's best)
of each number, and writes every line to wsbench/out/readings-<cell>.jsonl.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wsbench import catalog, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = catalog.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    out = catalog.HERE / "out" / f"readings-{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    prog, control = {}, {}
    with open(out, "w") as f:
        for seed in seeds:
            r = harness.run_cell(cell, seed, args.seconds, False, control=seed in ctl)
            if r is None:
                return 3
            line = {"seed": seed, "correct": r["correct"],
                    "checks": {n: c["value"] for n, c in r["checks"].items()},
                    "metrics": {n: m["value"] for n, m in r["metrics"].items()}}
            for n, c in r["checks"].items():
                prog.setdefault(n, []).append(c["value"])
            if "control" in r:
                line["control"] = {n: c["value"] for n, c in r["control"].items()}
                line["control_correct"] = r["control_correct"]
                for n, c in r["control"].items():
                    control.setdefault(n, []).append(c["value"])
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
        for name, lim in cell.limits["checks"].items():
            worst, best = (max, min) if "max" in lim else (min, max)
            summary = {"number": name, "limit": lim,
                       "lower_reading": worst(prog[name]) if name in prog else None,
                       "control_best": best(control[name]) if name in control else None,
                       "program": prog.get(name), "control": control.get(name)}
            print(json.dumps(summary), flush=True)
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
