"""Real-spherical-harmonic Wigner rotation matrices (Ivanic-Ruedenberg):
the port of the JAX package's ``models/wigner.py``.

EquiformerV2's eSCN trick rotates each edge's irrep features so that the
edge direction aligns with +z; the SO(3) convolution then reduces to
independent SO(2) mixes per |m|. The rotation is the block-diagonal
Wigner-D in the REAL spherical harmonic basis, built per l by the sparse
bilinear recursion D^l = M_l(r (x) D^{l-1}) from host-side tables
(``_l_recursion_table``, the reference's float32 table term for term).

The reference sums each table's terms into D^l with ``segment_sum`` over
``out_idx``. The port sums them without scatters: the table's terms are
already sorted by ``out_idx``, so each output element's terms form one run,
and ``_gather_table`` lays the runs out as the columns of a padded
``[n_out, width]`` index (the pad points at a zero term); the sum is then
``width`` gathered adds in the table's own order, the same on every device
and in every run (no float atomics).

The tables are copied to a device once (``_device_table``) and the
constants of ``edge_rotation`` are made there, so that a forward that
runs again copies nothing from the host (a training step runs under
``torch.cuda.set_sync_debug_mode("error")``, where a blocking copy
raises).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch


def _d1_index(m: int) -> int:
    """Real-SH l=1 ordering m=-1,0,1 -> cartesian (y, z, x) row of R."""
    return {-1: 1, 0: 2, 1: 0}[m]


def _delta(a, b) -> float:
    return 1.0 if a == b else 0.0


@lru_cache(maxsize=None)
def _l_recursion_table(l: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray]:
    """Sparse map for D^l from (r, D^{l-1}).

    Returns (r_idx, d_idx, coeff, out_idx): each term contributes
      coeff * r_flat[r_idx] * Dprev_flat[d_idx]  to  D_flat[out_idx].
    Index layout: r_flat = r[(i+1)*3 + (j+1)] for i,j in -1..1;
    Dprev_flat over (2l-1)^2 with m in -l+1..l-1; D_flat over (2l+1)^2.
    """
    terms: List[Tuple[int, int, float, int]] = []
    n_prev = 2 * l - 1

    def ridx(i: int, j: int) -> int:
        return (i + 1) * 3 + (j + 1)

    def didx(mu: int, m: int) -> int:
        return (mu + l - 1) * n_prev + (m + l - 1)

    def P(i: int, mu: int, m2: int) -> List[Tuple[int, int, float]]:
        """Expansion of the paper's P function into (r_idx, d_idx, coeff)."""
        if m2 == l:
            return [
                (ridx(i, 1), didx(mu, l - 1), 1.0),
                (ridx(i, -1), didx(mu, -l + 1), -1.0),
            ]
        if m2 == -l:
            return [
                (ridx(i, 1), didx(mu, -l + 1), 1.0),
                (ridx(i, -1), didx(mu, l - 1), 1.0),
            ]
        return [(ridx(i, 0), didx(mu, m2), 1.0)]

    for m1 in range(-l, l + 1):
        for m2 in range(-l, l + 1):
            out = (m1 + l) * (2 * l + 1) + (m2 + l)
            denom = float((l + m2) * (l - m2)) if abs(m2) < l else float(2 * l * (2 * l - 1))
            u = np.sqrt((l + m1) * (l - m1) / denom)
            v = 0.5 * np.sqrt(
                (1 + _delta(m1, 0)) * (l + abs(m1) - 1) * (l + abs(m1)) / denom
            ) * (1 - 2 * _delta(m1, 0))
            w = -0.5 * np.sqrt(
                (l - abs(m1) - 1) * (l - abs(m1)) / denom
            ) * (1 - _delta(m1, 0))

            parts: List[Tuple[int, int, float]] = []
            if u:
                parts += [(r, d, u * c) for r, d, c in P(0, m1, m2)]
            if v:
                if m1 == 0:
                    sub = P(1, 1, m2) + P(-1, -1, m2)
                elif m1 > 0:
                    sub = [(r, d, c * np.sqrt(1 + _delta(m1, 1)))
                           for r, d, c in P(1, m1 - 1, m2)]
                    sub += [(r, d, -c * (1 - _delta(m1, 1)))
                            for r, d, c in P(-1, -m1 + 1, m2)]
                else:
                    sub = [(r, d, c * (1 - _delta(m1, -1)))
                           for r, d, c in P(1, m1 + 1, m2)]
                    sub += [(r, d, c * np.sqrt(1 + _delta(m1, -1)))
                            for r, d, c in P(-1, -m1 - 1, m2)]
                parts += [(r, d, v * c) for r, d, c in sub]
            if w and m1 != 0:
                if m1 > 0:
                    sub = P(1, m1 + 1, m2) + P(-1, -m1 - 1, m2)
                else:
                    sub = [(r, d, c) for r, d, c in P(1, m1 - 1, m2)]
                    sub += [(r, d, -c) for r, d, c in P(-1, -m1 + 1, m2)]
                parts += [(r, d, w * c) for r, d, c in sub]

            terms += [(r, d, c, out) for r, d, c in parts if c != 0.0]

    r_idx = np.array([t[0] for t in terms], np.int32)
    d_idx = np.array([t[1] for t in terms], np.int32)
    coeff = np.array([t[2] for t in terms], np.float32)
    out_idx = np.array([t[3] for t in terms], np.int32)
    return r_idx, d_idx, coeff, out_idx


@lru_cache(maxsize=None)
def _gather_table(l: int) -> np.ndarray:
    """``_l_recursion_table(l)``'s terms by output element: int64
    ``[(2l+1)^2, width]``, row o holding the indices of o's terms in the
    table's order, padded with the index one past the last term (a zero
    term that the caller appends); width is the most terms of one
    output."""
    out_idx = _l_recursion_table(l)[3]
    n_out, n_terms = (2 * l + 1) ** 2, len(out_idx)
    if np.any(np.diff(out_idx) < 0):
        raise AssertionError(f"_l_recursion_table({l}): out_idx not sorted")
    start = np.searchsorted(out_idx, np.arange(n_out))
    count = np.bincount(out_idx, minlength=n_out)
    t = np.arange(count.max())
    idx = start[:, None] + t[None, :]
    return np.where(t[None, :] < count[:, None], idx, n_terms)


@lru_cache(maxsize=None)
def _device_table(l: int, device: torch.device, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """``(r_idx, d_idx, coeff, gather table)`` of degree ``l`` on
    ``device``, the indices int64 and the coefficients in ``dtype``."""
    ri, di, cf, _ = _l_recursion_table(l)
    return (torch.from_numpy(ri.astype(np.int64)).to(device),
            torch.from_numpy(di.astype(np.int64)).to(device),
            torch.from_numpy(cf).to(device=device, dtype=dtype),
            torch.from_numpy(_gather_table(l)).to(device))


def rotation_to_d1(rot: torch.Tensor) -> torch.Tensor:
    """3x3 cartesian rotation(s) [..., 3, 3] -> l=1 real-SH rotation r."""
    # rows and columns in the order [_d1_index(m) for m = -1, 0, 1] =
    # [1, 2, 0], by a roll: no index list copied to the device
    if [_d1_index(m) for m in (-1, 0, 1)] != [1, 2, 0]:
        raise AssertionError("rotation_to_d1: the l=1 order is not a roll")
    return rot.roll(-1, dims=-2).roll(-1, dims=-1)


def wigner_d_stack(rot: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """Per-l Wigner-D blocks for a batch of rotations.

    rot [E, 3, 3] -> list of [E, 2l+1, 2l+1] for l = 0..l_max, in rot's
    dtype (the table's float32 coefficients cast to it, as the reference
    multiplies by them)."""
    E = rot.shape[0]
    dev, dt = rot.device, rot.dtype
    r = rotation_to_d1(rot)                    # [E, 3, 3]
    r_flat = r.reshape(E, 9)
    blocks = [torch.ones((E, 1, 1), dtype=dt, device=dev), r]
    d_prev = r
    for l in range(2, l_max + 1):
        ri, di, cf, table = _device_table(l, dev, dt)
        vals = r_flat[:, ri] * d_prev.reshape(E, -1)[:, di] * cf[None, :]
        vals = torch.cat([vals, vals.new_zeros(E, 1)], dim=1)
        d_l = vals[:, table[:, 0]]
        for t in range(1, table.shape[1]):
            d_l = d_l + vals[:, table[:, t]]
        d_l = d_l.reshape(E, 2 * l + 1, 2 * l + 1)
        blocks.append(d_l)
        d_prev = d_l
    return blocks


def edge_rotation(vec: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Rotation matrices aligning each edge vector with +z.

    vec [E, 3] -> R [E, 3, 3] with R @ (vec/|vec|) = z. Uses the Rodrigues
    construction; degenerate (anti)parallel cases fall back to diag(1,-1,-1).
    A zero vector (a self-loop) gives the identity.
    """
    dt, dev = vec.dtype, vec.device
    n = vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + eps)
    eye = torch.eye(3, dtype=dt, device=dev)
    z = eye[2]
    v = torch.linalg.cross(n, z.expand_as(n))           # rotation axis * sin
    c = n[..., 2]                                       # cos(theta)
    zero = torch.zeros_like(c)
    vx = torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)
    k = 1.0 / torch.clamp_min(1.0 + c, eps)
    r = eye + vx + (vx @ vx) * k[..., None, None]
    flip = torch.diag(eye[0] - eye[1] - eye[2])         # diag(1, -1, -1)
    anti = (c < -1.0 + 1e-6)[..., None, None]
    return torch.where(anti, flip, r)


def rotate_irreps(feat: torch.Tensor, blocks: List[torch.Tensor],
                  transpose: bool = False) -> torch.Tensor:
    """Apply block-diagonal Wigner-D to irrep features.

    feat [E, K, C] with K = (l_max+1)^2 (real-SH coefficient order
    l ascending, m = -l..l within l); blocks from wigner_d_stack.
    """
    outs = []
    off = 0
    for l, d in enumerate(blocks):
        k = 2 * l + 1
        f = feat[:, off:off + k]
        dm = d.transpose(-1, -2) if transpose else d
        outs.append(torch.bmm(dm, f))
        off += k
    return torch.cat(outs, dim=1)
