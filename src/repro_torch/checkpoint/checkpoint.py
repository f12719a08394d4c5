"""Atomic checkpoints, the port of the JAX package's
``checkpoint/checkpoint.py`` with its on-disk layout.

One directory per step: ``<dir>/step_<step:08d>`` holds one ``.npy`` per
leaf of the tree, named by its path with the parts joined by ``__``
(``planes__d``, ``key``, ``store__h_src``), and ``manifest.json`` with
``step``, ``extra``, ``leaves`` (file, shape and dtype of each) and
``written_at``. A save writes into ``<dir>/tmp.<step>.<pid>``, fsyncs
every file, and renames the directory to its final name, so a writer
killed midway never leaves a partial step that ``latest_step`` would
take; then all but the newest ``keep`` steps are removed.

A tree is nested dicts (flattened in sorted key order, as
``jax.tree_util`` does), tuples, lists, NamedTuples and dataclasses whose
leaves are torch tensors, numpy arrays or scalars; ``None`` holds no
leaf. Tensor leaves reach the host through ``guard.fetch``, so any
active ``guard.metered()`` region counts them. ``restore`` places each
leaf like the matching leaf of ``like``: a tensor on its device with its
dtype, anything else as a numpy array of its dtype.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import get_logger
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault import retriable

log = get_logger("repro_torch.ckpt")

_SEP = "__"
_STEP_RE = re.compile(r"step_\d+")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[Tuple[List[Tuple[str, Any]],
                                      Callable[[List[Any]], Any]]]:
    """``([(path part, child)], rebuild)`` of an inner node, or None for a
    leaf. ``rebuild(children)`` makes a node of the same type."""
    if isinstance(node, dict):
        keys = sorted(node)
        return ([(str(k), node[k]) for k in keys],
                lambda ch: type(node)(zip(keys, ch)))
    if _is_namedtuple(node):
        return (list(zip(node._fields, node)),
                lambda ch: type(node)(*ch))
    if isinstance(node, (tuple, list)):
        return ([(str(i), c) for i, c in enumerate(node)],
                lambda ch: type(node)(ch))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return ([(n, getattr(node, n)) for n in names],
                lambda ch: dataclasses.replace(node, **dict(zip(names, ch))))
    return None


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Leaves by their ``__``-joined path, in flattening order."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): tree}
    out: Dict[str, Any] = {}
    for part, child in kids[0]:
        out.update(_flatten(child, prefix + (part,)))
    return out


def _unflatten(like, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``like``'s structure with each leaf replaced from ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return leaves[_SEP.join(prefix)]
    return kids[1]([_unflatten(c, leaves, prefix + (p,))
                    for p, c in kids[0]])


def _write_npy(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    """Atomic checkpoint write; returns the step's final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    manifest = {"step": step, "extra": extra or {}, "leaves": {},
                "written_at": telemetry.wall_time()}
    write = retriable(_write_npy)
    for key, leaf in flat.items():
        if isinstance(leaf, torch.Tensor):
            # the one device->host seam: an active meter counts the save's
            # reads (EngineMetrics.checkpoint_syncs)
            leaf = guard.fetch(
                leaf, reason=f"checkpoint save: materialize leaf {key}")
        arr = np.asarray(leaf)
        fname = f"{key}.npy"
        write(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic on POSIX
    _gc(ckpt_dir, keep)
    log.info("checkpoint step %d -> %s (%d leaves)", step, final, len(flat))
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    """Remove all but the newest ``keep`` steps (``keep=0`` keeps all)."""
    steps = sorted(d for d in os.listdir(ckpt_dir) if _STEP_RE.fullmatch(d))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if _STEP_RE.fullmatch(d)]
    return max(steps) if steps else None


def _place(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=like.device, dtype=like.dtype)
    return np.asarray(arr, dtype=np.asarray(like).dtype)


@retriable
def restore(ckpt_dir: str, like: Any,
            step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
    """Restore step ``step`` (default: the latest) into the structure of
    ``like``; returns ``(tree, extra)``. A saved leaf that ``like`` lacks is
    skipped with a warning; a leaf of ``like`` that the step lacks
    raises."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(like)
    loaded = {}
    for key, meta in manifest["leaves"].items():
        if key not in flat_like:
            log.warning("checkpoint leaf %s not in target tree; skipped", key)
            continue
        loaded[key] = _place(np.load(os.path.join(d, meta["file"])),
                             flat_like[key])
    missing = set(flat_like) - set(loaded)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}...")
    return _unflatten(like, loaded), manifest["extra"]
