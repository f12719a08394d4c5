"""The port's AdamW (``optim/adamw.py``) against the JAX package's
``optim/adamw.py``: ``apply_updates`` over several steps on a tree of
dicts and lists, with and without ``total_steps`` (the WSD decay), with
clipping active and not, on float32 parameters and on float64 ones (the
reference under ``jax.enable_x64``: its moments, gradients, schedule and
step stay float32 there, and so do the port's), and the reference's own
checks (a quadratic converges; the clipping's reported norm).

Tolerances: ``step`` and ``lr`` exactly; every parameter, moment and the
global norm within 2^-20 of the leaf's largest magnitude (float32
arithmetic on both sides; the global norm's sums may be ordered
differently, which moves the clipping scale by an ulp). Measured: at most
2.3e-7 of a leaf's largest magnitude (about 2^-22) on these cases.
"""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REL = 2.0 ** -20


def _tree(r, dt):
    """A small tree of dicts and lists, keys out of sorted order."""
    return {"w": r.standard_normal((5, 3)).astype(dt),
            "b": r.standard_normal(3).astype(dt),
            "layers": [{"z": r.standard_normal((2, 2)).astype(dt),
                        "a": r.standard_normal(4).astype(dt)}
                       for _ in range(2)]}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * max(np.abs(want).max(), 1e-30)


def _torch_tree(tree):
    return adamw.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("total_steps", [0, 6])
@pytest.mark.parametrize("grad_scale", [1e-3, 50.0])
def test_apply_updates_matches_reference(bits, total_steps, grad_scale):
    """Six steps from the same parameters and gradients (a new draw each
    step): gradients of norm about 0.01 leave the clipping off, of norm
    about 500 turn it on (clip_norm 1); warmup 3 of 6 steps, so the
    schedule warms, holds and (with total_steps) decays."""
    dt = np.float64 if bits == 64 else np.float32
    r = np.random.default_rng(bits + total_steps)
    p0 = _tree(r, dt)
    grads = [jax.tree_util.tree_map(lambda a: a * grad_scale, _tree(r, dt))
             for _ in range(6)]
    kw = dict(lr=0.05, warmup=3, weight_decay=0.1, clip_norm=1.0)
    with jax.enable_x64(bits == 64):
        p = jax.tree_util.tree_map(jnp.asarray, p0)
        opt = ref_adamw.init_state(p)
        want = []
        for g in grads:
            p, opt, stats = ref_adamw.apply_updates(
                p, opt, jax.tree_util.tree_map(jnp.asarray, g),
                RefTrainConfig(**kw), total_steps)
            want.append(jax.tree_util.tree_map(np.asarray, (p, opt, stats)))
    tp = _torch_tree(p0)
    topt = adamw.init_state(tp)
    assert topt.step.dtype == torch.int32 and int(topt.step) == 0
    for step, (g, (wp, wopt, wstats)) in enumerate(zip(grads, want), 1):
        tp, topt, tstats = adamw.apply_updates(
            tp, topt, _torch_tree(g), TrainConfig(**kw), total_steps)
        assert int(topt.step) == step == int(wopt.step)
        assert tstats["lr"].dtype == torch.float32
        assert float(tstats["lr"]) == float(wstats["lr"])
        _close(tstats["grad_norm"], wstats["grad_norm"])
        for got, ref in ((tp, wp), (topt.m, wopt.m), (topt.v, wopt.v)):
            g_leaves = adamw.tree_leaves(got)
            r_leaves = jax.tree_util.tree_leaves(ref)
            assert len(g_leaves) == len(r_leaves) == 6
            for a, b in zip(g_leaves, r_leaves):
                assert a.dtype == torch.from_numpy(np.array(b)).dtype
                _close(a.numpy(), b)
    clipped = float(tstats["grad_norm"]) > kw["clip_norm"]
    assert clipped == (grad_scale > 1)


def test_tree_order_and_state_on_device_tensors():
    """Leaves go in sorted key order, as the reference flattens them; the
    state mirrors the tree in float32 and its step is a 0-d int32
    tensor."""
    tree = {"b": torch.ones(2), "a": [torch.zeros(1), {"d": torch.ones(3),
                                                       "c": torch.ones(4)}]}
    assert [t.numel() for t in adamw.tree_leaves(tree)] == [1, 4, 3, 2]
    st = adamw.init_state(adamw.tree_map(lambda t: t.double(), tree))
    assert all(t.dtype == torch.float32 for t in adamw.tree_leaves(st.m))
    assert st.step.shape == () and st.step.dtype == torch.int32
    assert float(adamw.global_norm(tree)) == pytest.approx(3.0)


def test_adamw_converges_quadratic():
    """The reference's check: 200 steps on sum(w^2) from (5, -3)."""
    tc = TrainConfig(lr=0.1, warmup=1, weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.init_state(params)
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        (w ** 2).sum().backward()
        params, opt, _ = adamw.apply_updates(params, opt, {"w": w.grad}, tc)
    assert float((params["w"] ** 2).sum()) < 1e-3


def test_adamw_clipping():
    """The reference's check: the reported norm is the unclipped one."""
    tc = TrainConfig(lr=1e-3, warmup=1, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    _, _, stats = adamw.apply_updates(params, adamw.init_state(params),
                                      {"w": torch.full((4,), 100.0)}, tc)
    assert float(stats["grad_norm"]) == pytest.approx(200.0)


def test_apply_updates_refuses_a_leaf_that_is_not_contiguous():
    """The step updates each leaf in slices of its flat view, so a leaf
    that is not contiguous is refused, not updated another way."""
    tc = TrainConfig(lr=1e-3, warmup=1)
    params = {"w": torch.zeros((4, 3)).t()}
    with pytest.raises(ValueError, match="contiguous"):
        adamw.apply_updates(params, adamw.init_state(params),
                            {"w": torch.ones((3, 4))}, tc)

