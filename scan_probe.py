"""Design probe for the scan kernel (csrc/scan_topk.cu) on the card.

Builds variants of the kernel's source, each a list of text substitutions,
and times them in turns (two rounds, the second in reverse order) by CUDA
events on the prefilter main path's own scan inputs (the 1M x 128, 10,240-
query 2^-2 and mix batches of chip_smoke.py) and on the scan-variant
harness (200k x 128, 2,048 queries, windows of 50,000). Each variant that
computes the same function is held to the production build's output bit
for bit; the diagnostic ones (names starting "no_") drop part of the work
and are timing probes only.

    python3 scan_probe.py

Needs the card, nvcc and the repository's package; imports no JAX.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import torch

import chip_smoke as C
import rangefilteredann_tpu_torch as P
from rangefilteredann_tpu_torch import kernels
from rangefilteredann_tpu_torch.models import base
from rangefilteredann_tpu_torch.ops import scan as PS
from rangefilteredann_tpu_torch.tools import D as HD, K as HK, make_harness

FMA = """#pragma unroll
      for (int j = 0; j < QT; ++j) {
        acc[j][i] = fmaf(av[j].x, b.x, acc[j][i]);
        acc[j][i] = fmaf(av[j].y, b.y, acc[j][i]);
        acc[j][i] = fmaf(av[j].z, b.z, acc[j][i]);
        acc[j][i] = fmaf(av[j].w, b.w, acc[j][i]);
      }"""
EPILOGUE = """          epilogue<L2, L>(acc, nrm_s, gk_s, kth, lists_d, ld, li, ctl, k, colw, qg, pg,
                          lane, publish);
        } else {"""
COPY = "      if (g + STAGES - 1 < steps)\n        issue_stage"
TILE_8X8 = [["constexpr int WARPS = 2;", "constexpr int WARPS = 4;"],
            ["constexpr int PT = 16;", "constexpr int PT = 8;"],
            ["constexpr int CTAS_PER_SM = 4;", "constexpr int CTAS_PER_SM = 3;"]]
# the built-in set: the committed design, its 8 x 8 tile configuration, and
# the final design with the product, the tile epilogue or the staging taken out
BUILT_IN = {
    "final": [],
    "tile8x8": TILE_8X8,
    "no_product": [[FMA, """      acc[0][i] += b.x + b.y + b.z + b.w;
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[j][0] += av[j].x + av[j].y + av[j].z + av[j].w;"""]],
    "no_epilogue": [[EPILOGUE, """          float t = 0.f;
#pragma unroll
          for (int j = 0; j < QT; ++j)
#pragma unroll
            for (int i = 0; i < PT; ++i) t += acc[j][i];
          if (t == 1.2345e-30f) ld[lane] = t;
        } else {"""]],
    "no_staging": [[COPY, COPY.replace("< steps", "< 0")]],
}


def build(variants):
    """Compile every variant in parallel; returns {name: (library, ptxas note)}."""
    src0 = (kernels.CSRC / "scan_topk.cu").read_text()
    out = kernels.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        src = src0
        for old, new in subs:
            if old not in src:
                raise ValueError(f"{name}: substitution target not in the source: {old[:60]!r}")
            src = src.replace(old, new)
        (out / f"{name}.cu").write_text(src)
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", f"-I{kernels.CSRC}",
               "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text[-3000:]}")
        ents = re.findall(r"Compiling entry function '_ZN\w*?scan_items_kernel(\w*?)EEvNS_8ScanArgsE'"
                          r".*?(\d+) bytes spill stores.*?Used (\d+) registers", text, re.S)
        note = "; ".join(f"<{t}> {r} registers, {sp} B spilled" for t, sp, r in ents)
        libs[name] = (ctypes.CDLL(str(out / f"lib{name}.so")), note)
    return libs


def main() -> int:
    libs = build(BUILT_IN)
    for name, (_, note) in libs.items():
        print(f"probe {name}: {note}", flush=True)

    # the main path's own scan inputs, captured at the call into the kernel
    points, labels, queries, batches = C.make_data(0, 1_000_000, 128, 10240)
    idx = P.PrefilterIndex(points, labels, metric="Euclidian")
    inputs, real = {}, base.scan_topk
    for nm in ("frac2^-2", "mix"):
        def capture(*a, _nm=nm, **kw):
            inputs[_nm] = (a, kw)
            return real(*a, **kw)
        base.scan_topk = capture
        try:
            idx.batch_search(queries, batches[nm], 10240, P.build_query_params(10, 10))
        finally:
            base.scan_topk = real
    h = make_harness(200_000, 2048, "cuda", 42)
    inputs["harness"] = (h.args, {"k": HK, "metric": "l2", "d_eff": HD})
    ref = {nm: PS.scan_topk(*a, **kw) for nm, (a, kw) in inputs.items()}
    print(f"probe card: {C.card_line()}", flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    rows, names = {}, list(libs)
    for rnd in range(2):
        for name in names if rnd == 0 else names[::-1]:
            lib = libs[name][0]
            for nm, (a, kw) in inputs.items():
                run = lambda: PS.launch(lib, *a, kw["k"], kw["metric"], kw["d_eff"], stream)
                got = run()
                torch.cuda.synchronize()
                if rnd == 0 and not name.startswith("no_") and not (
                        torch.equal(got[0], ref[nm][0]) and torch.equal(got[1], ref[nm][1])):
                    raise AssertionError(f"{name} on {nm}: the output differs")
                rows.setdefault((name, nm), []).append(C.cuda_time_ms(torch, run, 5))
    for (name, nm), ms in rows.items():
        print(f"probe {name} {nm} k={inputs[nm][1]['k']}: "
              + " ".join(f"{x:.3f}" for x in ms) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
