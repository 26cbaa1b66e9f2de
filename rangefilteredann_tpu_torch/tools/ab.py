"""Compare the scan kernels of this tree and of a parent tree on the card.

    python -m rangefilteredann_tpu_torch.tools.ab --parent build/parent
        [--sources scan_topk scan_v3b scan_v2] [--drivers exp_scan2 exp_scan3b]
        [--reps 10]

`--parent` is a checkout of the other commit in a directory that
.gitignore lists (`git archive <commit> | tar -x -C build/parent`). Each
tree builds the named sources with its own `kernels.build` (one process a
tree). Then, for every kernel function of every source, its registers and
spill bytes in each build (ptxas) and whether its machine code (`cuobjdump
-sass`, with the anonymous namespace's per-file hash left out of the names)
is identical; a function renamed between the trees is matched by its code.
Last, each named driver's main() runs from each tree in turns, parent,
change, change, parent, and its timed lines are printed. Run it on trees
with nothing built yet (a library already built prints no ptxas report).
Needs the card and the CUDA toolkit; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from .. import kernels

ROOT = Path(__file__).resolve().parents[2]
_BUILD = ("import json; from rangefilteredann_tpu_torch import kernels as k; "
          "n = {names!r}; o = k.build(n, verbose=True); "
          "print(json.dumps({{'libs': {{x: str(k.library_path(x)) for x in n}}, 'ptxas': o}}))")
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\w*?_cu_[0-9a-f]{8}")


def build(tree: Path, names) -> dict:
    """{'libs': name -> library path, 'ptxas': name -> compiler output} of
    `tree`'s own build of the named sources."""
    r = subprocess.run([sys.executable, "-c", _BUILD.format(names=tuple(names))], cwd=tree,
                       capture_output=True, text=True, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def ptxas(text: str) -> dict:
    """Kernel function -> (registers, spill store bytes) from ptxas -v."""
    ents = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                      r"Used (\d+) registers", text, re.S)
    return {_ANON.sub("ANON", f): (int(r), int(sp)) for f, sp, r in ents}


def sass(lib: str) -> dict:
    """Kernel function -> its instructions, from cuobjdump -sass."""
    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = _ANON.sub("ANON", m.group(1))
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur is not None and m:
            funcs[cur].append(m.group(1))
    return funcs


def compare(name: str, parent: dict, change: dict) -> None:
    a, b = sass(parent["libs"][name]), sass(change["libs"][name])
    pa, pb = ptxas(parent["ptxas"].get(name, "")), ptxas(change["ptxas"].get(name, ""))
    print(f"{name}: {len(a)} kernel functions in the parent, {len(b)} in the change", flush=True)
    for f in sorted(set(a) | set(b)):
        if f in a and f in b:
            what = "identical" if a[f] == b[f] else f"different ({len(a[f])} vs {len(b[f])} instr)"
        elif f in b:
            twin = next((g for g in a if g not in b and a[g] == b[f]), None)
            what = (f"new name, identical to the parent's {twin}" if twin
                    else f"only in the change ({len(b[f])} instr)")
        else:
            if any(f2 not in a and b[f2] == a[f] for f2 in b):
                continue  # reported under its new name
            what = f"only in the parent ({len(a[f])} instr)"
        regs = f"parent {pa.get(f)}, change {pb.get(f)} (registers, spill bytes)"
        print(f"  {f}: {what}; {regs}", flush=True)


def run_driver(tree: Path, module: str, reps: int, tag: str) -> None:
    r = subprocess.run([sys.executable, "-m", f"rangefilteredann_tpu_torch.tools.{module}",
                        "--reps", str(reps)], cwd=tree, capture_output=True, text=True)
    print(f"== {tag} {module} (rc {r.returncode})", flush=True)
    for line in r.stderr.splitlines():
        if " ms -> " in line or "match" in line:
            print(f"   {line}", flush=True)
    if r.returncode:
        print(r.stderr[-3000:], flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--sources", nargs="+", default=["scan_topk", "scan_v3b", "scan_v2"])
    ap.add_argument("--drivers", nargs="+", default=["exp_scan2", "exp_scan3b"])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    parent = args.parent.resolve()
    if not (parent / "rangefilteredann_tpu_torch").is_dir():
        raise SystemExit(f"{parent} holds no rangefilteredann_tpu_torch package")
    builds = {tag: build(tree, args.sources) for tag, tree in (("parent", parent), ("change", ROOT))}
    for name in args.sources:
        compare(name, builds["parent"], builds["change"])
    for module in args.drivers:
        for tag, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                          ("parent", parent)):
            run_driver(tree, module, args.reps, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
