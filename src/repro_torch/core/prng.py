"""The reference's ``jax.random`` stream, reproduced bit for bit in PyTorch.

JAX's default generator is Threefry-2x32 (20 rounds) in its
"partitionable" form (``jax_threefry_partitionable``, the default since
JAX 0.5):

  * ``prng_key(seed)`` is the key ``(seed >> 32, seed & 0xFFFFFFFF)``;
  * ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``, both output
    words forming the new key;
  * ``split(key)`` hashes the 64-bit counters 0 and 1, ``(hi, lo) = (0, i)``,
    and subkey ``i`` is the pair of output words of counter ``i``;
  * ``uniform(key, n)`` hashes the counters ``0 .. n-1`` the same way, XORs
    the two output words into 32 random bits, and takes
    ``float32((bits >> 9) | 0x3f800000) - 1``, a uniform in ``[0, 1)``.

Keys are pairs of Python ints (uint32 words): deriving one is host
arithmetic on a few words, with no device work and no read. The uniform
draw runs on the draw's device as whole-tensor ops (uint32 words carried in
int64 tensors and masked after every add and shift), so it needs no host
loop over ``n`` and no read.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

Key = Tuple[int, int]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _rotl(v: Word, r: int) -> Word:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(key: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 with 20 rounds on uint32 words: Python ints or int64
    tensors holding values in ``[0, 2^32)``. Returns the two output words."""
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2^63)``."""
    seed = int(seed)
    if not 0 <= seed < 2**63:
        raise ValueError(f"prng_key: seed must be in [0, 2^63), got {seed}")
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for ``data`` taken as a uint32."""
    return threefry2x32(key, 0, int(data) & MASK32)


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)`` (two subkeys)."""
    return threefry2x32(key, 0, 0), threefry2x32(key, 0, 1)


def uniform(key: Key, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: float32 in ``[0, 1)`` on
    ``device``, from the 32 random bits of counters ``0 .. n-1``."""
    idx = torch.arange(int(n), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
