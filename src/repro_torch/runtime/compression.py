"""Compression codecs, the port of the JAX package's
``runtime/compression.py``: lossless int32 column packing for
``graph.storage.GraphStore`` and lossy int8 codecs for gradients.

Error-feedback int8 gradient compression (``ef_compress_grads``, used by
``launch/train.py --grad-compression int8_ef``): each leaf, plus the
residual that the last step's quantization left, is quantized to int8
with one symmetric per-tensor scale, and the new residual is what that
quantization lost, so the errors telescope. The arithmetic is the
reference's float32, element for element. Its all-reduce
(``compressed_psum``, ``int8_allreduce_shardmap``) belongs to the
multi-device slice and is not ported.

A slab column (sorted destination ids, near-sorted sources) is
delta-encoded, zig-zag mapped to unsigned and stored at the narrowest
width that holds it: a sorted dst column packs to 1–2 bytes an edge
instead of 4. The round trip is exact, so compressed residency never
changes a decomposition. The streams are the reference's, byte for byte.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common import tree_map


class PackedI32(NamedTuple):
    """A losslessly packed int32 column: ``data`` holds the zig-zag deltas
    in the narrowest unsigned dtype that fits their maximum, ``first``
    anchors the delta chain, ``n`` is the column's length."""

    data: np.ndarray
    n: int
    first: int

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes)


def pack_i32(x: np.ndarray) -> PackedI32:
    """Delta + zig-zag + minimal-width packing of a 1-d int32 array.

    A delta of two int32 values needs 33 bits, so the arithmetic runs in
    int64; zig-zag (``z = (d << 1) ^ (d >> 63)``) keeps small negative
    deltas small; the column is stored as uint8, 16, 32 or 64, whichever
    is the narrowest to hold the largest ``z``.
    """
    x = np.ascontiguousarray(np.asarray(x, dtype=np.int32))
    if x.ndim != 1:
        raise ValueError(f"pack_i32 expects a 1-d column, got shape {x.shape}")
    if x.size == 0:
        return PackedI32(np.zeros(0, np.uint8), 0, 0)
    wide = x.astype(np.int64)
    d = np.diff(wide, prepend=wide[:1])
    z = ((d << 1) ^ (d >> 63)).astype(np.uint64)
    z[0] = 0  # the anchor rides in `first`, not in the delta stream
    hi = int(z.max())
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if hi <= np.iinfo(dt).max:
            return PackedI32(z.astype(dt), int(x.size), int(x[0]))
    raise AssertionError("unreachable: uint64 holds every zig-zag delta")


def unpack_i32(p: PackedI32) -> np.ndarray:
    """The exact inverse of :func:`pack_i32`: the int32 column, byte for
    byte."""
    if p.n == 0:
        return np.zeros(0, np.int32)
    z = p.data.astype(np.uint64)
    d = ((z >> np.uint64(1)).astype(np.int64)
         ^ -(z & np.uint64(1)).astype(np.int64))
    d[0] = p.first
    return np.cumsum(d).astype(np.int32)


def quantize_int8(x: torch.Tensor):
    """``(q, scale)``: int8 ``round(x / scale)`` clipped to +-127, with the
    float32 ``scale = max|x| / 127 + 1e-12``."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_grads(grads, residual):
    """Add the error feedback and quantize: ``(q tree, scale tree, new
    residual tree)``."""
    corrected = tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                         residual)
    done = {}

    def quantize(c):
        done[id(c)] = quantize_int8(c)
        return done[id(c)][0]

    q = tree_map(quantize, corrected)
    s = tree_map(lambda c: done[id(c)][1], corrected)
    new_resid = tree_map(lambda c, qq, ss: c - dequantize_int8(qq, ss),
                         corrected, q, s)
    return q, s, new_resid


def init_residual(grads):
    """Zero float32 residuals in the gradients' shapes."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
