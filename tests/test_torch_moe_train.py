"""The port's MoE training path against the JAX package's: ``lm_loss`` and
every gradient leaf by autograd (router, experts, shared experts, the
attention and norms below them) against ``jax.value_and_grad`` of the
reference's ``lm_loss``, at mixtral-8x7b's smoke config and at
moonshot-v1-16b-a3b's with ``capacity_factor`` lowered to 1.0 (pairs
dropped) and two router columns set to zero (their logits equal, so every
token ties them, some at the top-k boundary, where the lower expert index
wins in both), in float64 with the reference's weights carried over; the
dispatch's gradients against the dense check of ``models/moe_check.py``
(and its planted fault); remat on and off; the MoE ``train_4k`` cell's
step; and ``launch/train.py`` training an MoE smoke arch in bf16, its MoE
leaves checkpointed as bf16 and restored.

The reference runs with ``jnp.float32`` read as float64 and ``jnp.int32``
as int64 (``reference_in_float64`` of ``tests/test_torch_lm_train.py``,
whose helpers this file shares).

Tolerances:
  * float64 loss and every gradient leaf: 1e-9 of the leaf's largest
    magnitude (sums in other orders differ by about 1e-15 relative);
  * the dispatch's gradients against the dense check's, float64: 1e-12
    of each leaf's largest magnitude (the same products, summed over the
    capacity slots or over every token with zero weights);
  * remat on and off: bit for bit.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# installs the x64 shim before the reference's modules are imported
from test_torch_lm_train import (B, CHUNKS, S, TOL, _batch, _loss_and_grads,
                                 _setup, reference_in_float64)

from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.convert import transformer_params_from_reference  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import moe_check  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

DROPS = "moonshot-v1-16b-a3b"       # the arch run with drops and ties
DROP_CF = 1.0                       # its capacity factor
TIED = (1, 2)                       # its router columns set to zero
DENSE_TOL = 1e-12


@functools.lru_cache(maxsize=None)
def _moe_setup(arch):
    """(reference cfg, port cfg, reference params, port params), with the
    drops and ties planted for ``DROPS``."""
    ref_cfg, cfg, ref_params, params = _setup(arch)
    if arch != DROPS:
        return ref_cfg, cfg, ref_params, params
    ref_cfg = dataclasses.replace(ref_cfg, capacity_factor=DROP_CF)
    cfg = dataclasses.replace(cfg, capacity_factor=DROP_CF)
    layers = dict(ref_params["layers"])
    router = np.array(layers["router"])
    router[:, :, list(TIED)] = 0.0
    layers["router"] = router
    ref_params = dict(ref_params, layers=layers)
    return ref_cfg, cfg, ref_params, transformer_params_from_reference(
        ref_params, cfg, device="cpu")


@pytest.fixture(scope="module", params=["mixtral-8x7b", DROPS])
def moe(request):
    """(cfg, port params, batch, the reference's loss and gradients)."""
    ref_cfg, cfg, ref_params, params = _moe_setup(request.param)
    batch = _batch(cfg, seed=4)
    with reference_in_float64(ref_tf, ref_ops):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_tf.lm_loss(p, b, ref_cfg,
                                        loss_chunks=CHUNKS)))(
            jax.tree.map(jnp.asarray, ref_params),
            jax.tree.map(jnp.asarray, batch))
        want = (float(loss), jax.tree.map(np.asarray, grads))
    return cfg, params, batch, want


def _routing_stats(monkeypatch, cfg):
    """Wrap ``moe_route`` to count, over its calls, the pairs the dispatch
    drops and the tokens whose k-th and (k+1)-th probabilities are equal."""
    real, seen = tf.moe_route, {"dropped": 0, "boundary_ties": 0}

    def route(h, router, c):
        probs, gates, idx, aux = real(h, router, c)
        ranked = probs.sort(dim=-1, descending=True)[0]
        seen["boundary_ties"] += int((ranked[..., c.top_k - 1]
                                      == ranked[..., c.top_k]).sum())
        keep = tf.moe_dispatch(idx, gates, tf.moe_capacity(h.shape[1], c),
                               c.n_experts)[3]
        seen["dropped"] += int((~keep).sum())
        return probs, gates, idx, aux

    monkeypatch.setattr(tf, "moe_route", route)
    return seen


def test_moe_loss_and_gradients_match_reference(moe, monkeypatch):
    cfg, params, batch, (want_loss, want_grads) = moe
    seen = _routing_stats(monkeypatch, cfg)
    loss, grads = _loss_and_grads(params, batch, cfg)
    assert abs(float(loss) - want_loss) <= TOL * abs(want_loss)
    got = adamw.tree_leaves(grads)
    ref = adamw.tree_leaves(want_grads)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert np.abs(g.numpy() - r).max() <= TOL * np.abs(r).max()
    assert float(grads["layers"]["router"].abs().max()) > 0
    if cfg.name.startswith("moonshot"):
        # the case holds dropped pairs and ties at the top-k boundary
        assert seen["dropped"] > 0 and seen["boundary_ties"] > 0
        assert float(grads["layers"]["ws_gate"].abs().max()) > 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", DROPS])
def test_moe_ffn_gradients_match_the_dense_check(arch):
    """``_moe_ffn``'s gradients in h, the router and every expert weight
    against ``moe_check.moe_ffn_dense``'s at capacity factor 1.0, in two
    groups (pairs dropped); the dense check with one slot fewer moves
    them past the tolerance."""
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype="float64",
                              capacity_factor=1.0, moe_groups=2)
    lp = tf.layer_params(tf.init_params(cfg, seed=7, device="cpu"), 0)
    g = torch.Generator().manual_seed(3)
    h = torch.randn(2, 48, cfg.d_model, generator=g, dtype=torch.float64)
    cot = torch.randn(2, 48, cfg.d_model, generator=g, dtype=torch.float64)
    names = sorted(k for k in lp if k in ("router", "w_gate", "w_up",
                                          "w_down", "ws_gate", "ws_up",
                                          "ws_down"))

    def grads(fn, **kw):
        hh = h.clone().requires_grad_()
        w = {k: v.clone().requires_grad_() for k, v in lp.items()}
        out = fn(hh, w, cfg, **kw)
        out = out[0] if isinstance(out, tuple) else out
        return torch.autograd.grad(out, [hh] + [w[k] for k in names], cot)

    got = grads(tf._moe_ffn)
    want = grads(moe_check.moe_ffn_dense)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= DENSE_TOL * float(b.abs().max())
    experts = tf.moe_route(h, lp["router"], cfg)[2]
    cap = tf.moe_capacity(48, cfg)
    assert not bool(moe_check.moe_keep_by_count(experts, cap,
                                                cfg.n_experts).all())
    fault = grads(moe_check.moe_ffn_dense, capacity=moe_check.fault_capacity(
        experts, cap, cfg.n_experts))
    assert max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(fault, want)) > 1e-3


def test_moe_remat_on_and_off_are_equal():
    _, cfg, _, params = _moe_setup(DROPS)
    batch = _batch(cfg, seed=4)
    runs = [_loss_and_grads(params, batch, dataclasses.replace(cfg, remat=r))
            for r in ("none", "full")]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(*(adamw.tree_leaves(g) for _, g in runs)):
        assert torch.equal(a, b)


def test_moe_train_cell_step_is_lm_loss_then_adamw():
    """mixtral's smoke ``train_4k`` cell at cut batch and length: one
    dispatch group, its loss ``lm_loss`` of the batch and its update
    ``apply_updates`` of that gradient."""
    cell = build_cell("mixtral-8x7b", "train_4k", smoke=True, device="cpu",
                      batch=B, seq_len=S)
    assert cell.note == "batch 2 of 256; seq_len 32 of 4096"
    assert cell.cfg.moe_groups == 1
    assert cell.model_flops == 6.0 * cell.cfg.active_param_count() * B * S
    params, opt = cell.init(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cell.cfg).items()}
    twin = adamw.tree_map(lambda t: t.clone(), params)
    p = adamw.tree_map(lambda t: t.clone().requires_grad_(), twin)
    loss = tf.lm_loss(p, batch, cell.cfg)
    loss.backward()
    want, _, _ = adamw.apply_updates(
        twin, adamw.init_state(twin), adamw.tree_map(lambda t: t.grad, p),
        cell.train_cfg)
    params, opt, got_loss, stats = cell.step_fn(params, opt,
                                                cell.inputs(_batch(cell.cfg)))
    assert torch.equal(got_loss, loss.detach()) and int(opt.step) == 1
    assert all(torch.equal(a, b) and not a.requires_grad for a, b in
               zip(adamw.tree_leaves(params), adamw.tree_leaves(want)))


def test_train_launcher_trains_and_checkpoints_an_moe_arch(tmp_path, capsys,
                                                           monkeypatch):
    """``launch/train.py --arch moonshot-v1-16b-a3b --smoke`` in bf16: two
    steps, a save at step 2 whose MoE leaves are bf16 files of their
    stacked shapes, and a ``--resume`` that restores them and has no step
    left to run."""
    cfg = dataclasses.replace(get_arch(DROPS, smoke=True), dtype="bfloat16")

    def arch(name, smoke=False):
        return cfg if name == DROPS and smoke else get_arch(name, smoke)

    monkeypatch.setattr(train_launcher, "get_arch", arch)
    argv = ["--arch", DROPS, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq-len", str(S), "--batch", str(B), "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]

    def run(extra):
        code = train_launcher.main(argv + extra)
        return code, json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])

    code, res = run([])
    assert code == 0 and res["steps_run"] == 2 and res["saved"] == [2]
    assert all(np.isfinite(res["losses"]))
    assert res["params"] == cfg.param_count()
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    L, E, d, f = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    shapes = {"router": [L, d, E], "w_gate": [L, E, d, f],
              "w_up": [L, E, d, f], "w_down": [L, E, f, d]}
    for name, shape in shapes.items():
        for tree in ("params", "m", "v"):
            leaf = leaves[f"{tree}__layers__{name}"]
            assert leaf["shape"] == shape
            assert leaf["dtype"] == ("bfloat16" if tree == "params"
                                     else "float32")
    assert leaves["params__layers__ws_down"]["dtype"] == "bfloat16"
    like = tf.init_params(cfg, seed=1, device="cpu")
    restored, extra = ckpt.restore(str(tmp_path), {"params": like})
    assert extra["cursor"]["step"] == 2
    assert restored["params"]["layers"]["w_gate"].dtype == torch.bfloat16
    code, again = run(["--resume"])
    assert code == 0 and again["resumed_from"] == 2
    assert again["steps_run"] == 0
