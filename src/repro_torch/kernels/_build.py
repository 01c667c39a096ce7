"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled
on first use, for Hopper only (``sm_90a``), into
``build/repro_torch_kernels/`` at the repository root. The library's
file name carries a hash of the source and flags, so an edited source is
rebuilt and never confused with a stale build. Nothing here runs at
import time: the CPU-only tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load_library", "nvcc_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("paged_decode", "wire_compress")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                           "the port's CUDA kernels are built from source")
    return found


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str) -> subprocess.Popen:
    """Start one nvcc; it writes lib<name>-<hash>.so and a .log of the
    compiler's output (``-Xptxas -v``: registers, spills, shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc_path(), *_FLAGS, "-o", str(out) + ".tmp",
           str(_CSRC / f"{name}.cu")]
    try:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _finish(name: str, proc: subprocess.Popen) -> None:
    out = _target(name)
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                           + out.with_suffix(".log").read_text())
    os.replace(str(out) + ".tmp", out)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Build every missing library, one nvcc per source, all at once.
    Returns {name: path of the .so}."""
    procs = {n: _start(n) for n in names if not _target(n).exists()}
    try:
        for n, p in procs.items():
            _finish(n, p)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {n: _target(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib
