"""Build-at-first-use for the hand-written CUDA kernels.

Each kernel's sources are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/kernels/`` at the
repository root (``.gitignore`` lists ``build/``), and loaded with
``ctypes``. The library name carries a hash of the sources, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing is built
when a module is imported: :func:`load` runs inside the wrapper that
launches the kernel (or in an explicit warm-up such as ``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent
REPO_ROOT = _PKG.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the toolkit's standard install prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def source_paths(rel_sources: Sequence[str]) -> list:
    return [_PKG / s for s in rel_sources]


def library_path(name: str, rel_sources: Sequence[str]) -> Path:
    h = hashlib.sha256()
    for p in source_paths(rel_sources):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, rel_sources: Sequence[str]) -> Path:
    """Compile ``rel_sources`` (paths relative to ``repro_torch/kernels``)
    unless the hashed library exists; returns its path. ptxas's register
    and spill report is written beside it as ``.log``."""
    lib = library_path(name, rel_sources)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in source_paths(rel_sources)]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or none
    return lib


def load(name: str, rel_sources: Sequence[str]) -> ctypes.CDLL:
    """Build if needed and ``ctypes``-load the kernel library (cached)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name, rel_sources)))
    return _LOADED[name]
