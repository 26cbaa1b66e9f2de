"""A kernel's own CUDA source, built by g++ for the CPU against cuda_runtime.h.

The source's quoted includes (the csrc/ headers) are inlined, each once, and
what only the card has is rewritten for the stand-in: cp.async copies
become copies made at once (their waits and commits go), an mma.sync bf16
becomes emu_mma_m16n8k16_bf16, the extern shared array a CTA's emulated
shared memory, and a launch `kern<<<...>>>(` (the persistent kernels') runs
its CTAs all at once, each on an OS thread of its own, any other launch one
CTA after another on the calling thread. A CTA's CUDA threads are fibers on
its OS thread; a barrier that only part of its threads reach aborts the
process with a message (cuda_runtime.h), so a test that may reach one runs
the launch in a process of its own.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

EMU = Path(__file__).resolve().parent


def inline_includes(path: Path, seen=None) -> str:
    """path's text with each quoted #include replaced by the header's own
    (inlined) text the first time, by nothing after."""
    seen = set() if seen is None else seen
    seen.add(path.name)

    def header(m):
        name = m.group(1)
        if name in seen:
            return ""
        return inline_includes(path.parent / name, seen)

    text = path.read_text().replace("#pragma once\n", "")
    return re.sub(r'^#include "([^"]+)"\n', header, text, flags=re.M)


def emulated_source(path: Path) -> str:
    src = inline_includes(path)
    for size in (16, 4):
        src = re.sub(r'asm volatile\(\s*"cp\.async\.c[ag]\.shared\.global \[%0\], \[%1\], '
                     + str(size) + r';".*?\);', f"std::memcpy(dst, src, {size});", src,
                     flags=re.S)
    src = re.sub(r'asm volatile\(\s*"mma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16\.bf16\.f32'
                 r'.*?\);', "emu_mma_m16n8k16_bf16(c, a, b0, b1);", src, flags=re.S)
    # every copy and product was rewritten before the rest of the PTX goes
    assert not re.search(r'"(cp\.async\.c[ag]\.|mma\.sync)', src)
    src = re.sub(r"asm volatile\(.*?\);", "", src, flags=re.S)
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = emu_smem();")
    src = re.sub(r"\bkern<<<(.*?)>>>\(", r"emu_launch_concurrent(kern, \1, ", src, flags=re.S)
    src = re.sub(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src,
                 flags=re.S)
    assert "<<<" not in src and "asm" not in src
    return src


def build(name: str, csrc: Path, out: Path) -> ctypes.CDLL:
    """csrc/<name>.cu built for the CPU into `out`, loaded by ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernel")
    src = out / f"{name}_emu.cpp"
    src.write_text(emulated_source(csrc / f"{name}.cu"))
    lib = out / f"lib{name}_emu.so"
    built = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                            f"-I{EMU}", "-o", str(lib), str(src)],
                           capture_output=True, text=True)
    assert built.returncode == 0, built.stderr
    return ctypes.CDLL(str(lib))
