"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc and ctypes.

Each source compiles on first use into a shared library with a plain C interface,
under ``_build/`` next to the package sources (listed in .gitignore). The library
name carries a hash of the source, the shared headers (csrc/*.cuh) and the flags,
so an edited source or header rebuilds and an unchanged one loads at once.
Nothing here runs at import time: the CPU test suite imports every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# library name -> source file in csrc/
SOURCES = {
    "fused_sae": "fused_sae.cu",
    "fused_gated_sae": "fused_gated_sae.cu",
    "fused_jumprelu_sae": "fused_jumprelu_sae.cu",
    "fused_transcoder": "fused_transcoder.cu",  # the transcoder and crosscoder kernels
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all), one nvcc process per source, all
    started together. Returns ``{name: {"path", "seconds", "log"}}``; ``log`` holds
    nvcc's ptxas report (registers, shared memory, spills). Raises on a failed
    build with the compiler's output."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            procs[name] = (out, None, None)
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (out, tmp, proc)
    result = {}
    for name, (out, tmp, proc) in procs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        result[name] = {"path": str(out), "seconds": time.perf_counter() - start, "log": log}
    return result


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))
