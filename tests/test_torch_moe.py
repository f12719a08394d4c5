"""The port's MoE FFN (``_moe_mlp`` of ``repro_torch/models/transformer.py``)
against the JAX package's, on the moonshot-v1-16b-a3b smoke config (8
experts, top 3, one shared expert of width 48) and the mixtral-8x7b one (4
experts, top 2, no shared expert), with the reference's own layer weights
carried over by ``transformer_params_from_reference``: output and aux loss
at ``moe_groups`` 1 and 2, at ``capacity_factor`` 16 (nothing dropped) and
1.0 (pairs dropped), with and without shared experts; ties planted at the
top-k boundary route as ``lax.top_k`` does (the lower expert index wins);
the dispatch's keep mask equals a cumulative count over the one-hot
choices; the dense check of ``models/moe_check.py`` equals the dispatch
and reads a planted fault above 1; ``init_params`` makes the reference's
tensors.

Tolerances:
  * float32: 1e-5 absolute and relative on the FFN's output and the aux
    loss (|x| < 10 here). Both sides compute in float32 with the same
    routing, so they differ only by the order of sums in the matmuls, the
    softmax and the per-token combine, and in the last ulp of XLA's and
    torch's float32 ``exp``/``sigmoid``.
  * bfloat16, the layer: each token whose top-k experts are the same on
    both sides is within 2e-2 (relative L2 over its row) of the
    reference's layer output (measured on the CPU: at most 0.9%; the
    products, their gates' combine and the residual add round to bf16 at
    other places). A token may be routed otherwise only at a bf16 near-tie:
    its reference router logits at ranks k and k + 1 within 2^-6 (1 +
    |logit|) of each other (the two frameworks' bf16 router products may
    round a logit a step of 2^-8 of it apart).
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import transformer_params_from_reference  # noqa: E402
from repro_torch.models import moe_check  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ROW_REL = 2e-2
NEAR_TIE = 2.0 ** -6
ARCHS = {"shared": "moonshot-v1-16b-a3b", "no_shared": "mixtral-8x7b"}


def _layer(arch, seed=1, **overrides):
    """(reference cfg, port cfg, reference layer 0, port layer 0)."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch, smoke=True), **overrides)
    cfg = dataclasses.replace(get_arch(arch, smoke=True), **overrides)
    ref_params = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = transformer_params_from_reference(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    ref_lp = jax.tree.map(lambda a: a[0], ref_params["layers"])
    return ref_cfg, cfg, ref_lp, tf.layer_params(params, 0)


def _x(cfg, B=2, S=24, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _normalised(x, lp, cfg, groups):
    h = tf.rmsnorm(torch.from_numpy(x), lp["mlp_norm"], cfg.norm_eps)
    return h.reshape(groups, -1, cfg.d_model)


@pytest.mark.parametrize("shared", sorted(ARCHS))
@pytest.mark.parametrize("capacity_factor", [16.0, 1.0])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_mlp_matches_reference(shared, capacity_factor, groups):
    ref_cfg, cfg, ref_lp, lp = _layer(ARCHS[shared], moe_groups=groups,
                                      capacity_factor=capacity_factor)
    x = _x(cfg)
    want, want_aux = ref_tf._moe_mlp(jnp.asarray(x), ref_lp, ref_cfg)
    got, aux = tf._moe_mlp(torch.from_numpy(x), lp, cfg)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    # capacity factor 1.0 drops pairs (the test reaches the drop path);
    # 16 drops none
    h = _normalised(x, lp, cfg, groups)
    _, gates, experts, _ = tf.moe_route(h, lp["router"], cfg)
    cap = tf.moe_capacity(h.shape[1], cfg)
    keep = tf.moe_dispatch(experts, gates, cap, cfg.n_experts)[3]
    assert (int((~keep).sum()) > 0) == (capacity_factor == 1.0)


def _tied_router(cfg, row):
    """A router whose logits for ``h = e_0`` are exactly ``row``."""
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[0] = row
    return router


def test_ties_at_the_top_k_boundary_route_as_lax_top_k():
    """Logits with equal values across the k boundary: the lower expert
    index wins, as in ``lax.top_k`` (``torch.topk`` picks another)."""
    ref_cfg, cfg, ref_lp, lp = _layer(ARCHS["shared"], capacity_factor=1.0)
    k, E = cfg.top_k, cfg.n_experts                # 3 of 8
    rows = np.array([[0.1, 0.3, 0.3, 0.3, 0.3, 0.2, 0.0, 0.0],
                     [0.5, 0.2, 0.2, 0.2, 0.2, 0.2, 0.1, 0.9],
                     [0.0] * 8,
                     [0.4, 0.4, 0.1, 0.1, 0.4, 0.4, 0.1, 0.4]], np.float32)
    h = np.zeros((4, cfg.d_model), np.float32)
    h[:, 0] = 1.0
    for row in rows:
        router = _tied_router(cfg, row)
        want = jax.lax.top_k(jax.nn.softmax(
            jnp.asarray(h) @ jnp.asarray(router), axis=-1), k)[1]
        probs, _, got, _ = tf.moe_route(torch.from_numpy(h)[None],
                                        torch.from_numpy(router), cfg)
        p = probs[0, 0]
        assert float(p.sort(descending=True)[0][k - 1]) == \
            float(p.sort(descending=True)[0][k])    # a tie at the boundary
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert torch.topk(torch.tensor([0.1, 0.3, 0.3, 0.3, 0.2]), 2)[1].tolist() \
        == [1, 3]          # what a topk-based router would have chosen
    # whole FFN with a tied router: every token's logits are tied the same
    # way, so at capacity factor 1.0 the tie decides which pairs drop
    r = np.random.default_rng(2)
    x = np.zeros((2, 24, cfg.d_model), np.float32)
    x[..., 0] = 1.0 + r.random((2, 24)).astype(np.float32)
    router = _tied_router(cfg, rows[0])
    ref_lp = dict(ref_lp, router=jnp.asarray(router))
    lp = dict(lp, router=torch.from_numpy(router))
    want, want_aux = ref_tf._moe_mlp(jnp.asarray(x), ref_lp, ref_cfg)
    got, aux = tf._moe_mlp(torch.from_numpy(x), lp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_dispatch_keep_equals_the_cumulative_count(groups):
    _, cfg, _, lp = _layer(ARCHS["shared"], capacity_factor=1.0,
                           moe_groups=groups)
    h = _normalised(_x(cfg, S=40, seed=4), lp, cfg, groups)
    _, gates, experts, _ = tf.moe_route(h, lp["router"], cfg)
    cap = tf.moe_capacity(h.shape[1], cfg)
    flat_e, slot, gate, keep = tf.moe_dispatch(experts, gates, cap,
                                               cfg.n_experts)
    by_count = moe_check.moe_keep_by_count(experts, cap, cfg.n_experts)
    assert torch.equal(keep, by_count.reshape(keep.shape))
    assert int((~keep).sum()) > 0
    # every kept pair owns its (expert, slot); dropped pairs sit at the last
    # slot with gate 0
    pairs = (flat_e * cap + slot)[keep]
    for g in range(groups):
        owned = (flat_e[g] * cap + slot[g])[keep[g]]
        assert owned.unique().numel() == owned.numel()
    assert pairs.numel() == int(keep.sum())
    assert bool((slot[~keep] == cap - 1).all())
    assert bool((gate[~keep] == 0).all())


@pytest.mark.parametrize("shared", sorted(ARCHS))
def test_dense_check_equals_dispatch_and_reads_a_planted_fault(shared):
    _, cfg, _, lp = _layer(ARCHS[shared], capacity_factor=1.0)
    h = _normalised(_x(cfg, S=40, seed=5), lp, cfg, 1)
    got, _ = tf._moe_ffn(h, lp, cfg)
    dense = moe_check.moe_ffn_dense(h, lp, cfg)
    torch.testing.assert_close(got, dense, **TOL)
    assert moe_check.moe_excess(got, dense) <= 1.0
    cap = tf.moe_capacity(h.shape[1], cfg)
    experts = tf.moe_route(h, lp["router"], cfg)[2]
    assert moe_check.fault_capacity(experts, cap, cfg.n_experts) == cap - 1
    fault = moe_check.moe_ffn_dense(h, lp, cfg, capacity=cap - 1)
    assert moe_check.moe_excess(fault, dense) > 1.0
    # with room for every pair, the fault drops the fullest expert's last
    roomy = dataclasses.replace(cfg, capacity_factor=16.0)
    big = tf.moe_capacity(h.shape[1], roomy)
    fault_cap = moe_check.fault_capacity(experts, big, cfg.n_experts)
    assert fault_cap < big - 1
    full = moe_check.moe_ffn_dense(h, lp, roomy)
    assert moe_check.moe_excess(tf._moe_ffn(h, lp, roomy)[0], full) <= 1.0
    assert moe_check.moe_excess(moe_check.moe_ffn_dense(
        h, lp, roomy, capacity=fault_cap), full) > 1.0


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_moe_init_params_shapes_and_the_shared_quirk(arch):
    ref_cfg, cfg = ref_get_arch(arch, smoke=True), get_arch(arch, smoke=True)
    p = tf.init_params(cfg, seed=0, device="cpu")
    ref_shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda: ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in p["layers"].items()} == \
        ref_shapes["layers"]
    assert tuple(p["unembed"].shape) == ref_shapes["unembed"]
    n = sum(v.numel() for v in p["layers"].values()) + sum(
        p[k].numel() for k in ("embed", "final_norm", "unembed"))
    assert n == cfg.param_count() == ref_cfg.param_count()
    assert abs(float(p["layers"]["w_down"].std()) - cfg.d_ff ** -0.5) < 5e-3
    if cfg.n_shared_experts:
        # the reference draws both from keys[10]
        ref_p = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(3))
        np.testing.assert_array_equal(np.asarray(ref_p["layers"]["ws_gate"]),
                                      np.asarray(ref_p["layers"]["ws_up"]))
        assert torch.equal(p["layers"]["ws_gate"], p["layers"]["ws_up"])
        assert p["layers"]["ws_gate"].data_ptr() != \
            p["layers"]["ws_up"].data_ptr()


@pytest.mark.parametrize("shared", sorted(ARCHS))
@pytest.mark.parametrize("capacity_factor", [16.0, 1.0])
def test_moe_mlp_bf16_matches_reference(shared, capacity_factor):
    ref_cfg, cfg, ref_lp, lp = _layer(ARCHS[shared], seed=2,
                                      dtype="bfloat16",
                                      capacity_factor=capacity_factor)
    x = torch.from_numpy(_x(cfg, S=40, seed=6)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want, _ = ref_tf._moe_mlp(xj, ref_lp, ref_cfg)
    got, _ = tf._moe_mlp(x, lp, cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32)).astype(np.float64)
    got = got.float().numpy().astype(np.float64)
    # the two routings
    k = cfg.top_k
    hj = ref_tf.rmsnorm(xj, ref_lp["mlp_norm"], ref_cfg.norm_eps)
    logits = np.asarray((hj @ ref_lp["router"]).astype(jnp.float32))
    ref_experts = np.sort(np.asarray(jax.lax.top_k(
        jax.nn.softmax(jnp.asarray(logits), axis=-1), k)[1]), axis=-1)
    h = tf.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps).reshape(1, -1,
                                                            cfg.d_model)
    experts = tf.moe_route(h, lp["router"], cfg)[2][0].numpy()
    same = (np.sort(experts, axis=-1).reshape(ref_experts.shape)
            == ref_experts).all(axis=-1)
    rel = (np.linalg.norm(got - want, axis=-1)
           / np.linalg.norm(want, axis=-1))
    assert same.any() and rel[same].max() < BF16_ROW_REL
    ranked = -np.sort(-logits, axis=-1)
    gap = np.abs(ranked[..., k - 1] - ranked[..., k])
    assert (gap[~same] <= NEAR_TIE * (1 + np.abs(ranked[..., k - 1][~same]))
            ).all()
