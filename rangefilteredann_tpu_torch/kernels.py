"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` has a plain C interface. nvcc compiles it for
sm_90a into a shared library under `build/kernels/` at the repository root,
named by a hash of the source, the `csrc/` headers it includes (directly
or through another header) and the flags so that a stale build is never
loaded, and ctypes loads it at first use. Nothing is built when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("scan_topk", "beam_search", "scan_v2", "scan_v3", "scan_v3b")

_LOADED: "dict[str, ctypes.CDLL]" = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _with_includes(file: str, seen: set) -> bytes:
    """csrc/<file> followed by every csrc/ header it includes with quotes,
    directly or through another header, each once."""
    seen.add(file)
    src = (CSRC / file).read_bytes()
    out = [src]
    for h in re.findall(rb'^#include "([^"]+)"', src, re.M):
        if h.decode() not in seen:
            out.append(_with_includes(h.decode(), seen))
    return b"".join(out)


def library_path(name: str) -> Path:
    src = _with_includes(f"{name}.cu", set())
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES, verbose: bool = False) -> "dict[str, str]":
    """Compile every named source that has no current build, one nvcc
    process per source, all started together. Returns the compiler's output
    by name (with verbose=True, ptxas's register and shared-memory report)."""
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib, tmp)
    out, failed = {}, []
    for name, (proc, lib, tmp) in jobs.items():
        out[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(out[n] for n in failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
