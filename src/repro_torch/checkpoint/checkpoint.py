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

A bfloat16 tensor is written as the reference writes one (numpy has no
bfloat16; the reference's arrays carry ml_dtypes' type): its 2-byte words
under the ``.npy`` descr ``<V2``, and ``bfloat16`` in the manifest, byte
for byte the reference's file. ``restore`` reads such a leaf by the
manifest's dtype and views its words as ``torch.bfloat16``, where the
reference's ``restore`` hands back a numpy void array.
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
from repro_torch.common import get_logger, to_device
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


_BF16 = "bfloat16"
_BF16_DESCR = "<V2"     # ml_dtypes' bfloat16 in a .npy header


def _write_npy(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def _write_bf16_npy(path: str, words: np.ndarray) -> None:
    """bfloat16 values, given as their int16 words, as the reference's
    ``.npy``: the words under the header descr ``<V2``."""
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": words.shape})
        f.write(np.ascontiguousarray(words).tobytes())
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
    with telemetry.span("checkpoint.save", step=step, leaves=len(flat)):
        manifest = {"step": step, "extra": extra or {}, "leaves": {},
                    "written_at": telemetry.wall_time()}
        write, write_bf16 = retriable(_write_npy), retriable(_write_bf16_npy)
        for key, leaf in flat.items():
            bf16 = (isinstance(leaf, torch.Tensor)
                    and leaf.dtype == torch.bfloat16)
            if isinstance(leaf, torch.Tensor):
                # the one device->host seam: an active meter counts the save's
                # reads (EngineMetrics.checkpoint_syncs); numpy has no
                # bfloat16, so such a leaf is fetched as its 2-byte words
                leaf = guard.fetch(
                    leaf.view(torch.int16) if bf16 else leaf,
                    reason=f"checkpoint save: materialize leaf {key}")
            arr = np.asarray(leaf)
            fname = f"{key}.npy"
            (write_bf16 if bf16 else write)(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": _BF16 if bf16 else str(arr.dtype)}
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


def _place(arr: np.ndarray, like, dtype: str):
    """A loaded leaf placed like ``like``. A ``bfloat16`` leaf (2-byte void
    words) placed like a tensor is those words viewed as bfloat16, on
    ``like``'s device, then cast to its dtype; placed like anything else,
    it stays the void array the file holds."""
    if isinstance(like, torch.Tensor):
        # ascontiguousarray makes a 0-d array 1-d: the leaf keeps its shape
        t = torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16 if dtype == _BF16 else arr.dtype)).reshape(arr.shape)
        t = to_device(t, like.device)
        if dtype == _BF16:
            return t.view(torch.bfloat16).to(like.dtype)
        return t.to(like.dtype)
    if dtype == _BF16:
        return arr
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
    with telemetry.span("checkpoint.restore", step=step) as sp:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = _flatten(like)
        loaded = {}
        for key, meta in manifest["leaves"].items():
            if key not in flat_like:
                log.warning("checkpoint leaf %s not in target tree; skipped",
                            key)
                continue
            loaded[key] = _place(np.load(os.path.join(d, meta["file"])),
                                 flat_like[key], meta["dtype"])
        missing = set(flat_like) - set(loaded)
        if missing:
            raise ValueError(
                f"checkpoint missing leaves: {sorted(missing)[:5]}...")
        sp.set(leaves=len(loaded))
    return _unflatten(like, loaded), manifest["extra"]
