"""The port's ``models/wigner.py`` against the JAX package's: the
Ivanic-Ruedenberg recursion tables, the l = 1 permutation, the edge
frames (``edge_rotation``, with planted zero vectors of self-loops, exact
and near anti-parallel edges), the Wigner-D blocks (``wigner_d_stack``) and
``rotate_irreps`` at l_max 6, on inputs made from a numpy seed.

Tolerances:
  * the tables (``_l_recursion_table``, float32 coefficients): byte
    equality, l = 1 to 6.
  * float64 on both sides (the reference under ``jax.enable_x64``):
    ``max|port - ref| <= 1e-9 max|ref|``.
  * float32: the spread rule of ``models/gnn_check.py``: the port's
    float32 output within ``SPREAD_C`` (8) times the reference's own
    float32 spread from its float64 output (``rel_max``, floored at
    2^-22); the reference rounds the same frames in float32 (near
    anti-parallel edges lose digits to ``1 / (1 + c)`` on both sides).
"""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.models import wigner as ref_wigner  # noqa: E402
from repro_torch.models import wigner  # noqa: E402
from repro_torch.models.gnn_check import rel_max, spread_excess  # noqa: E402

L_MAX = 6
REL64 = 1e-9


def _vectors(seed=0, n=256):
    """Random edge vectors with planted degenerate ones: zero vectors
    (self-loops), exact -z and +z, and a vector 1e-4 off -z."""
    v = np.random.default_rng(seed).standard_normal((n, 3))
    v[0] = v[1] = 0.0
    v[2] = (0.0, 0.0, -1.5)
    v[3] = (0.0, 0.0, 2.0)
    v[4] = (1e-4, -1e-4, -1.0)
    return v


def _rotations(seed, n=64):
    """Random proper rotations (QR of a normal matrix, det fixed to +1)."""
    a = np.random.default_rng(seed).standard_normal((n, 3, 3))
    q, _ = np.linalg.qr(a)
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    return q


def _ref(fn, *arrays, x64):
    with jax.enable_x64(x64):
        dt = np.float64 if x64 else np.float32
        out = fn(*(jnp.asarray(a.astype(dt)) for a in arrays))
        return jax.tree_util.tree_map(np.array, out)


def _close64(got, want):
    assert got.dtype == torch.float64
    assert rel_max(got, torch.from_numpy(want)) <= REL64


def _f32_excess(got, want32, want64):
    assert got.dtype == torch.float32
    return spread_excess(got, torch.from_numpy(want64),
                         torch.from_numpy(want32))


@pytest.mark.parametrize("l", range(1, L_MAX + 1))
def test_recursion_table_byte_equal(l):
    got, want = wigner._l_recursion_table(l), ref_wigner._l_recursion_table(l)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("l", range(2, L_MAX + 1))
def test_gather_table_covers_each_term_once(l):
    """The padded per-output index holds every term once, in the table's
    order within each output, and pads with the zero term past the end."""
    out_idx = wigner._l_recursion_table(l)[3]
    table = wigner._gather_table(l)
    n_terms = len(out_idx)
    assert table.shape[0] == (2 * l + 1) ** 2
    real = table[table < n_terms]
    assert np.array_equal(np.sort(real), np.arange(n_terms))
    for o, row in enumerate(table):
        terms = row[row < n_terms]
        assert np.all(out_idx[terms] == o) and np.all(np.diff(terms) > 0)
        assert np.all(row[len(terms):] == n_terms)


def test_rotation_to_d1_and_index():
    rot = _rotations(1)
    got = wigner.rotation_to_d1(torch.from_numpy(rot)).numpy()
    want = np.array(ref_wigner.rotation_to_d1(rot))
    assert got.tobytes() == want.tobytes()
    assert [wigner._d1_index(m) for m in (-1, 0, 1)] == \
        [ref_wigner._d1_index(m) for m in (-1, 0, 1)]


def test_edge_rotation_matches_reference():
    v = _vectors()
    want64 = _ref(ref_wigner.edge_rotation, v, x64=True)
    want32 = _ref(ref_wigner.edge_rotation, v, x64=False)
    got64 = wigner.edge_rotation(torch.from_numpy(v))
    _close64(got64, want64)
    got32 = wigner.edge_rotation(torch.from_numpy(v.astype(np.float32)))
    assert _f32_excess(got32, want32, want64) <= 1.0
    # the planted cases: identity at zero vectors, the flip at -z
    eye, flip = np.eye(3), np.diag([1.0, -1.0, -1.0])
    for r in (got64, got32):
        r = r.double().numpy()
        assert np.array_equal(r[0], eye) and np.array_equal(r[1], eye)
        assert np.array_equal(r[2], flip)
        assert np.allclose(r[3], eye)
    # elsewhere R maps the unit edge vector to +z (the reference's own
    # test's 1e-5: the eps in the normalisation and near anti-parallel
    # vectors' 1 / (1 + c) cost digits even in float64)
    n = v[5:] / np.linalg.norm(v[5:], axis=-1, keepdims=True)
    z = np.einsum("eij,ej->ei", got64.numpy()[5:], n)
    assert np.abs(z - [0.0, 0.0, 1.0]).max() < 1e-5


def test_wigner_d_stack_matches_reference():
    rot = np.concatenate([_rotations(2),
                          _ref(ref_wigner.edge_rotation, _vectors(3),
                               x64=True)])
    want64 = _ref(lambda r: ref_wigner.wigner_d_stack(r, L_MAX), rot,
                  x64=True)
    want32 = _ref(lambda r: ref_wigner.wigner_d_stack(r, L_MAX), rot,
                  x64=False)
    got64 = wigner.wigner_d_stack(torch.from_numpy(rot), L_MAX)
    got32 = wigner.wigner_d_stack(torch.from_numpy(rot.astype(np.float32)),
                                  L_MAX)
    assert len(got64) == len(got32) == L_MAX + 1
    for l in range(L_MAX + 1):
        assert tuple(got64[l].shape) == (rot.shape[0], 2 * l + 1, 2 * l + 1)
        _close64(got64[l], want64[l])
        assert _f32_excess(got32[l], want32[l], want64[l]) <= 1.0
    # the blocks are (to the float32 table's rounding) orthogonal
    for d in got64:
        eye = torch.eye(d.shape[-1], dtype=d.dtype)
        assert float((d @ d.transpose(-1, -2) - eye).abs().max()) < 1e-5


@pytest.mark.parametrize("transpose", [False, True])
def test_rotate_irreps_matches_reference(transpose):
    rot = _rotations(4)
    k = (L_MAX + 1) ** 2
    feat = np.random.default_rng(5).standard_normal((rot.shape[0], k, 6))

    def ref(r, f):
        return ref_wigner.rotate_irreps(
            f, ref_wigner.wigner_d_stack(r, L_MAX), transpose=transpose)

    want64 = _ref(ref, rot, feat, x64=True)
    want32 = _ref(ref, rot, feat, x64=False)
    t64 = torch.from_numpy(rot), torch.from_numpy(feat)
    t32 = tuple(t.float() for t in t64)
    got64 = wigner.rotate_irreps(
        t64[1], wigner.wigner_d_stack(t64[0], L_MAX), transpose=transpose)
    got32 = wigner.rotate_irreps(
        t32[1], wigner.wigner_d_stack(t32[0], L_MAX), transpose=transpose)
    _close64(got64, want64)
    assert _f32_excess(got32, want32, want64) <= 1.0
    # there and back again
    blocks = wigner.wigner_d_stack(t64[0], L_MAX)
    back = wigner.rotate_irreps(wigner.rotate_irreps(t64[1], blocks), blocks,
                                transpose=True)
    assert float((back - t64[1]).abs().max()) < 1e-4
