"""Lossless int32 column packing for ``graph.storage.GraphStore``, the
numpy half of the JAX package's ``runtime/compression.py`` (its int8
gradient codecs belong to training and multi-device, which the port does
not have yet).

A slab column (sorted destination ids, near-sorted sources) is
delta-encoded, zig-zag mapped to unsigned and stored at the narrowest
width that holds it: a sorted dst column packs to 1–2 bytes an edge
instead of 4. The round trip is exact, so compressed residency never
changes a decomposition. The streams are the reference's, byte for byte.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
