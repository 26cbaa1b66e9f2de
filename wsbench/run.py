"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 wsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Refuses (exit code 2, no result) without as many CUDA devices as the cell
asks for: there is no CPU fallback. Exit code 3, no result: a forbidden
module (JAX, or the JAX package) was loaded in this process.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / "out" / "cache"
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from wsbench import catalog, harness

    cell = catalog.cell(args.workload)
    chips = int(cell.entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"wsbench: {args.workload} needs {chips} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START, chips=chips)
    if result is None:
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
