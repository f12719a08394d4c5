"""Build-at-first-use for the hand-written CUDA kernels.

Each kernel's sources are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/kernels/`` at the
repository root (``.gitignore`` lists ``build/``), and loaded with
``ctypes``. The library name carries a hash of the sources, the headers
(``*.cuh``) beside them, and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is. A
library may add flags of its own after its sources: ``-lcuda`` for one that
encodes TMA tensor maps with the driver API, ``-I<dir>`` for headers such as
CUTLASS's (``/usr/local/cutlass/include`` where the toolkit has them); an
include directory that does not exist raises, naming it, before anything is
built. Nothing is built when a module is imported: :func:`load` runs inside
the wrapper that launches the kernel (or in an explicit warm-up such as
``chip_smoke.py``).
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


def header_paths(rel_sources: Sequence[str]) -> list:
    """The ``*.cuh`` headers in the sources' directories, sorted."""
    dirs = sorted({p.parent for p in source_paths(rel_sources)})
    return [h for d in dirs for h in sorted(d.glob("*.cuh"))]


def library_path(name: str, rel_sources: Sequence[str],
                 extra_flags: Sequence[str] = ()) -> Path:
    h = hashlib.sha256()
    for p in (*source_paths(rel_sources), *header_paths(rel_sources)):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *extra_flags)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def include_dirs(extra_flags: Sequence[str]) -> list:
    """The directories that ``-I<dir>`` or ``-I <dir>`` name."""
    dirs = []
    for i, f in enumerate(extra_flags):
        if f == "-I" and i + 1 < len(extra_flags):
            dirs.append(extra_flags[i + 1])
        elif f.startswith("-I") and len(f) > 2:
            dirs.append(f[2:])
    return dirs


def command(nvcc: str, rel_sources: Sequence[str],
            extra_flags: Sequence[str], out: Path) -> list:
    """The ``nvcc`` command line of one library. The library's own flags
    come after its sources, so that a ``-l`` library resolves their
    symbols."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out),
            *[str(p) for p in source_paths(rel_sources)], *extra_flags]


def build(name: str, rel_sources: Sequence[str],
          extra_flags: Sequence[str] = ()) -> Path:
    """Compile ``rel_sources`` (paths relative to ``repro_torch/kernels``)
    with ``extra_flags`` unless the hashed library exists; returns its
    path. ptxas's register and spill report is written beside it as
    ``.log``."""
    for d in include_dirs(extra_flags):
        if not os.path.isdir(d):
            raise RuntimeError(f"{name}: include directory {d} not found")
    lib = library_path(name, rel_sources, extra_flags)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = command(nvcc_path(), rel_sources, extra_flags, tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)   # atomic: a concurrent build sees all or none
    return lib


def load(name: str, rel_sources: Sequence[str],
         extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build if needed and ``ctypes``-load the kernel library (cached)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name, rel_sources,
                                              extra_flags)))
    return _LOADED[name]
