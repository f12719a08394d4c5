"""The port's xDeepFM training step (``launch/steps.py``'s
``recsys_train`` cell: ``models/recsys.bce_loss``, autograd through
``kernels/cin/ops.CinLayer``, ``optim/adamw.apply_updates``) against the
JAX package's (``jax.value_and_grad`` of its ``bce_loss``, then its
``adamw.apply_updates``), on the smoke config and on xdeepfm's full
widths (39 fields, embed dim 10, CIN 200-200-200, DNN 400-400) with only
``vocab_per_field`` cut to 1,000, at B 64, in float64 on both sides (the
reference under ``jax.enable_x64``), with numpy-drawn weights in the
reference's tree carried over by ``recsys_params_from_reference``. Also: ``CinLayer``'s
gradients in all three inputs against ``jax.vjp`` of the reference's
``cin_layer_ref`` over ``kernels/cin/cases.py``'s gradient cases (and a
layer-1 call whose x0 and xk are one tensor), and the reassociated
``cin_dx_ref`` against the same; the kernels' arithmetic emulated
(``emulated_dx`` under the layer rule, ``emulated_dw`` in 3xTF32 under
dW's rule at B 65,536) with the planted faults above; the step's refusal
of a parameter that gets no gradient; the cell's shapes and refusals.

Tolerances (float64):
  * the loss and every gradient leaf: within 1e-9 of the leaf's largest
    magnitude (measured: at most 1.3e-15); the CIN filters' gradients
    nonzero;
  * three steps: the update is float32 on both sides, as the reference
    casts it, so every parameter after each step within ``PARAM_REL``
    (2^-22, two float32 ulps) of the leaf's largest magnitude (measured:
    at most 6.6e-8), and the later steps' losses within ``PARAM_REL``;
  * ``CinLayer``'s gradients and ``cin_dx_ref``'s: within 1e-12 of each
    gradient's largest magnitude (the same float64 sums in another order;
    measured: at most 1.6e-15);
  * the dW rule (``cases.dw_excess``): the emulated kernel far below 1,
    the planted fault far above.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import functools

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import RECSYS_SHAPES as REF_RECSYS_SHAPES  # noqa: E402
from repro.config.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.data.pipeline import DataCursor as RefDataCursor  # noqa: E402
from repro.data.pipeline import RecsysPipeline as RefRecsysPipeline  # noqa: E402
from repro.kernels.cin.ref import cin_layer_ref as ref_cin_layer  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import recsys as ref_rs  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.config import RECSYS_SHAPES, get_arch  # noqa: E402
from repro_torch.convert import recsys_params_from_reference  # noqa: E402
from repro_torch.kernels.cin import cases  # noqa: E402
from repro_torch.kernels.cin import kernel as cmod  # noqa: E402
from repro_torch.kernels.cin.ops import cin_layer  # noqa: E402
from repro_torch.kernels.cin.ref import cin_dx_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

B = 64
VOCAB_CUT = 1000
REL64 = 1e-9
PARAM_REL = 2.0 ** -22
CIN_REL = 1e-12
STEPS = 3
SHAPE = dataclasses.replace(RECSYS_SHAPES[0], batch=B)


def _configs(full: bool):
    ref_cfg = ref_get_arch("xdeepfm", smoke=not full)
    cfg = get_arch("xdeepfm", smoke=not full)
    if full:
        ref_cfg = dataclasses.replace(ref_cfg, vocab_per_field=VOCAB_CUT)
        cfg = dataclasses.replace(cfg, vocab_per_field=VOCAB_CUT)
    return ref_cfg, cfg


@functools.lru_cache(maxsize=None)
def _batches(full: bool):
    """One pipeline batch of B rows per step (labels included), with some
    ids masked out (row 0's first field; with bag 2, row 1's second id of
    every field)."""
    ref_cfg = _configs(full)[0]
    shape = dataclasses.replace(REF_RECSYS_SHAPES[0], batch=B)
    out = []
    for step in range(STEPS):
        b = RefRecsysPipeline(ref_cfg, shape, seed=3).batch(
            RefDataCursor(step=step))
        b["id_mask"][0, 0, :] = 0
        if b["ids"].shape[2] > 1:
            b["id_mask"][1, :, 1] = 0
        out.append(b)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ref_params(full: bool):
    """Weights for both sides, drawn with numpy (seed 1) at the reference
    init's scales into its tree's shapes, float32."""
    ref_cfg = _configs(full)[0]
    shapes = jax.eval_shape(functools.partial(ref_rs.init_params, ref_cfg),
                            jax.random.PRNGKey(0))
    r = np.random.default_rng(1)

    def draw(sds):
        scale = 0.01 if len(sds.shape) != 2 else sds.shape[0] ** -0.5
        if len(sds.shape) == 3 and sds.shape[0] != ref_cfg.n_sparse:
            scale = (sds.shape[1] * sds.shape[2]) ** -0.5   # CIN filters
        return (r.standard_normal(sds.shape) * scale).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _as64(b):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _reference(full: bool):
    """Per step: the reference's loss, gradients and updated parameters
    (numpy trees) and stats, float64."""
    ref_cfg = _configs(full)[0]
    out = []
    with jax.enable_x64(True):
        vg = jax.jit(jax.value_and_grad(ref_rs.bce_loss), static_argnums=2)
        update = jax.jit(ref_adamw.apply_updates, static_argnums=3)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         _ref_params(full))
        opt = ref_adamw.init_state(p)
        for b in _batches(full):
            loss, grads = vg(p, {k: jnp.asarray(v)
                                 for k, v in _as64(b).items()}, ref_cfg)
            p, opt, stats = update(p, opt, grads, RefTrainConfig())
            out.append((float(loss), jax.tree.map(np.asarray, grads),
                        jax.tree.map(np.asarray, p),
                        {k: float(v) for k, v in stats.items()}))
    return out


def _port_tree(tree_np, cfg):
    """A reference tree (numpy) as the port's float64 parameter dict."""
    t32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree_np)
    return adamw.tree_map(lambda t: t.double(), recsys_params_from_reference(
        t32, cfg, device="cpu"))


def _exact_tree(tree_np):
    """A reference tree (numpy, any float type) as the port's dict of
    float64 tensors, without a float32 round trip."""
    return {"tables": torch.from_numpy(np.array(tree_np["tables"],
                                                  np.float64)),
            "linear": torch.from_numpy(np.array(tree_np["linear"],
                                                  np.float64)),
            "cin": [torch.from_numpy(np.array(w, np.float64))
                    for w in tree_np["cin"]],
            "cin_out": torch.from_numpy(np.array(tree_np["cin_out"],
                                                   np.float64)),
            "mlp": [{"w": torch.from_numpy(np.array(lp["w"], np.float64)),
                     "b": torch.from_numpy(np.array(lp["b"], np.float64))}
                    for lp in tree_np["mlp"]],
            "bias": torch.from_numpy(np.array(tree_np["bias"],
                                                np.float64))}


def _leaves_close(got, want, rel, what):
    worst = 0.0
    for a, b in zip(adamw.tree_leaves(got),
                    adamw.tree_leaves(_exact_tree(want))):
        assert a.shape == b.shape and a.dtype == torch.float64, what
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        assert err <= rel * scale or err == 0.0, (what, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def _inputs(b):
    return {k: torch.from_numpy(v) for k, v in _as64(b).items()}


@pytest.mark.parametrize("full", [False, True])
def test_loss_and_gradients_match_reference(full):
    cfg = _configs(full)[1]
    params = adamw.tree_map(lambda p: p.requires_grad_(),
                            _port_tree(_ref_params(full), cfg))
    before = (cmod.cin_layer_cuda.launches, cmod.cin_dw_cuda.launches)
    loss = recsys.bce_loss(params, _inputs(_batches(full)[0]), cfg)
    loss.backward()
    assert (cmod.cin_layer_cuda.launches, cmod.cin_dw_cuda.launches) \
        == before
    want_loss, want_grads, _, _ = _reference(full)[0]
    assert loss.dtype == torch.float64
    assert abs(loss.item() - want_loss) <= REL64 * abs(want_loss)
    grads = adamw.tree_map(lambda p: p.grad, params)
    _leaves_close(grads, want_grads, REL64, "grad")
    assert all(bool(g.abs().max() > 0) for g in grads["cin"])


@pytest.mark.parametrize("full", [False, True])
def test_three_train_steps_match_reference(full):
    cfg = _configs(full)[1]
    cell = steps._recsys_train_cell(cfg, SHAPE, torch.device("cpu"))
    params = _port_tree(_ref_params(full), cfg)
    opt = adamw.init_state(params)
    for i, (b, (want_loss, _, want_p, want_stats)) in enumerate(zip(
            _batches(full), _reference(full))):
        params, opt, loss, stats = cell.step_fn(params, opt, _inputs(b))
        rel = REL64 if i == 0 else PARAM_REL
        assert abs(float(loss) - want_loss) <= rel * abs(want_loss), i
        _leaves_close(params, want_p, PARAM_REL, f"params after step {i}")
        assert int(opt.step) == i + 1
        assert float(stats["lr"]) == want_stats["lr"]
        assert abs(float(stats["grad_norm"]) - want_stats["grad_norm"]) \
            <= 2.0 ** -20 * want_stats["grad_norm"]
        assert not any(p.requires_grad for p in adamw.tree_leaves(params))


def _vjp_case(case, shared: bool = False):
    """``CinLayer``'s gradients and the reference's ``jax.vjp`` of its
    ``cin_layer_ref`` on one case's inputs (float64); with ``shared``, x0
    passed as both x0 and xk (layer 1's call)."""
    x0, xk, w, dy = (a.astype(np.float64)
                     for a in cases.grad_case_inputs(case))
    if shared:
        xk = x0
    with jax.enable_x64(True):
        if shared:
            _, vjp = jax.vjp(lambda a, c: ref_cin_layer(a, a, c), x0, w)
            want = vjp(dy)
        else:
            _, vjp = jax.vjp(ref_cin_layer, x0, xk, w)
            want = vjp(dy)
    want = [np.asarray(g) for g in want]
    tx0 = torch.from_numpy(x0).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    if shared:
        out = cin_layer(tx0, tx0, tw)
        got = torch.autograd.grad(out, (tx0, tw), torch.from_numpy(dy))
    else:
        txk = torch.from_numpy(xk).requires_grad_()
        out = cin_layer(tx0, txk, tw)
        got = torch.autograd.grad(out, (tx0, txk, tw), torch.from_numpy(dy))
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("name", sorted(cases.GRAD_CASES))
def test_cin_layer_gradients_match_reference_vjp(name):
    case = cases.GRAD_CASES[name]
    before = (cmod.cin_layer_cuda.launches, cmod.cin_dx_cuda.launches,
              cmod.cin_dw_cuda.launches)
    got, want = _vjp_case(case)
    assert (cmod.cin_layer_cuda.launches, cmod.cin_dx_cuda.launches,
            cmod.cin_dw_cuda.launches) == before
    for g, r, what in zip(got, want, ("dx0", "dxk", "dw")):
        assert g.shape == r.shape, what
        assert np.abs(g - r).max() <= CIN_REL * np.abs(r).max(), what
    if case[2] == case[1]:      # a layer-1 shape: x0 and xk one tensor
        got, want = _vjp_case(case, shared=True)
        for g, r, what in zip(got, want, ("dx0 + dxk", "dw")):
            assert np.abs(g - r).max() <= CIN_REL * np.abs(r).max(), what


@pytest.mark.parametrize("name", sorted(cases.GRAD_CASES))
def test_reassociated_dx_matches_reference_vjp(name):
    """``cin_dx_ref`` (the kernel's form: U = dy . W, then the sums over h
    and m) gives the reference's dx0 and dxk (``jax.vjp``, float64)."""
    x0, xk, w, dy = (a.astype(np.float64)
                     for a in cases.grad_case_inputs(cases.GRAD_CASES[name]))
    with jax.enable_x64(True):
        _, vjp = jax.vjp(ref_cin_layer, x0, xk, w)
        want = [np.asarray(g) for g in vjp(dy)[:2]]
    got = cin_dx_ref(*(torch.from_numpy(a) for a in (x0, xk, dy, w)))
    for g, r, what in zip(got, want, ("dx0", "dxk")):
        assert g.shape == r.shape, what
        assert np.abs(g.numpy() - r).max() <= CIN_REL * np.abs(r).max(), what


def test_dw_rule_passes_the_emulated_kernel_and_rejects_a_dropped_tile():
    """At ``DW_RULE_CASE`` (B 65,536, K 524,288): the dW kernel's 3xTF32
    arithmetic and sum order (16-k stages, then the stages of each K part
    by float32 adds, then the parts) emulated in the plan's 132 parts, in
    the 2 parts of the training batch's H-200 layers and in one reads far
    below 1 (measured 0.0013, 0.011, 0.013); one dropped tile of 128
    values of k reads far above (measured 67 to 74)."""
    Bc, m, H, H2, D = cases.DW_RULE_CASE
    x0, xk, _, dy = (torch.from_numpy(a)
                     for a in cases.grad_case_inputs(cases.DW_RULE_CASE))
    r, S = cases.dw_exact(x0, xk, dy)
    K = Bc * D
    assert cmod.dw_plan(Bc, m, H, H2, D, 132)["parts"] == 132
    assert cmod.dw_plan(Bc, 39, 200, 200, D, 132)["parts"] == 2
    for parts in (132, 2, 1):
        emu = cases.emulated_dw(x0, xk, dy, parts)
        assert cases.dw_excess(emu, r, S, K) < 0.1, parts
    for k0 in (0, K // 2 + 3, K - cases.DW_FAULT_K):
        bad = cases.dw_planted_fault(x0, xk, dy, k0)
        assert cases.dw_excess(bad, r, S, K) > 10.0, k0
    assert cases.dw_excess(r.float(), r, S, K) < 0.01


@pytest.mark.parametrize("name", ["xdeepfm-layer2-B37", "H2-39-B61",
                                  "smoke-layer1-B7"])
def test_input_gradients_under_the_layer_rule(name):
    """The dx kernel's arithmetic (``emulated_dx``: U in 3xTF32 over K =
    H2, the sums over h and m by float32 fused multiply-adds in the
    kernel's order, dx0's N parts of its plan on 132 SMs) reads within a
    tenth of the layer rule on each input gradient's operands, and a
    dropped slice of their W reads far above it."""
    case = cases.GRAD_CASES[name]
    x0, xk, w, dy = (torch.from_numpy(a) for a in cases.grad_case_inputs(
        case))
    emu = dict(zip(("dx0", "dxk"), cases.emulated_dx(
        x0, xk, dy, w, cmod.dx_plan(*case, sms=132))))
    for what, (a, b, wp) in cases.input_grad_operands(x0, xk, w,
                                                      dy).items():
        ref = cases.cin_layer_ref(a, b, wp)
        assert cases.layer_excess(emu[what], ref, a, b, wp) < 0.1, what
        assert cases.layer_excess(cases.planted_fault(a, b, wp, h=1), ref, a,
                                  b, wp) > 1.0, what


def test_step_raises_where_a_parameter_gets_no_gradient(monkeypatch):
    """A CIN the autograd tape cannot see (its output detached from the
    filters, as a kernel without a backward is) leaves the filters without
    a gradient: the step raises and names them, where a zero gradient
    would train them silently."""
    cfg = _configs(False)[1]
    cell = steps._recsys_train_cell(cfg, SHAPE, torch.device("cpu"))
    params = _port_tree(_ref_params(False), cfg)
    real = recsys.cin

    def unseen(x0, weights, impl="auto"):
        return real(x0, [w.detach() for w in weights], impl=impl)

    monkeypatch.setattr(recsys, "cin", unseen)
    with pytest.raises(RuntimeError, match=r"no gradient reached \['cin/0', "
                                           r"'cin/1'\]"):
        cell.step_fn(params, adamw.init_state(params),
                     _inputs(_batches(False)[0]))


def test_cell_shapes_equal_reference_and_refusals():
    """``build_cell``'s ``train_batch`` declares the reference cell's batch
    (a one-device mesh) and parameter shapes; ``train_cfg`` reaches the
    update; other arguments are refused."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    for smoke in (True, False):
        ref = ref_steps._recsys_cell(ref_get_arch("xdeepfm", smoke=smoke),
                                     REF_RECSYS_SHAPES[0], mesh,
                                     RefTrainConfig())
        cell = steps.build_cell("xdeepfm", "train_batch", smoke=smoke,
                                device="cpu")
        got = {k: (s, str(d).replace("torch.", ""))
               for k, (s, d) in cell.arg_shapes.items()}
        assert got == {k: (tuple(v.shape), np.dtype(v.dtype).name)
                       for k, v in ref.arg_specs[2].items()}
        assert cell.arg_shapes["ids"][0][0] == 65536
    cfg = get_arch("xdeepfm", smoke=True)
    cell = steps.build_cell("xdeepfm", "train_batch", smoke=True,
                            device="cpu")
    params, opt = cell.init(0)
    assert int(opt.step) == 0
    assert [tuple(p.shape) for p in adamw.tree_leaves(params)] == [
        tuple(a.shape) for a in jax.tree.leaves(ref_steps._recsys_cell(
            ref_get_arch("xdeepfm", smoke=True), REF_RECSYS_SHAPES[0], mesh,
            RefTrainConfig()).arg_specs[0])]
    assert cell.train_cfg == steps.TrainConfig()
    slow = steps.build_cell("xdeepfm", "train_batch", smoke=True,
                            device="cpu",
                            train_cfg=steps.TrainConfig(lr=0.0))
    p0 = _port_tree(_ref_params(False), cfg)
    # the step updates in place: compare with a copy of the parameters
    before = [t.clone() for t in adamw.tree_leaves(p0)]
    p1, _, _, stats = slow.step_fn(p0, adamw.init_state(p0),
                                   _inputs(_batches(False)[0]))
    assert float(stats["lr"]) == 0.0
    for a, b in zip(adamw.tree_leaves(p1), before):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="no cell arguments"):
        steps.build_cell("xdeepfm", "train_batch", smoke=True, device="cpu",
                         n_nodes=8)
    with pytest.raises(TypeError, match="training cell"):
        steps.build_cell("xdeepfm", "serve_p99", smoke=True, device="cpu",
                         train_cfg=steps.TrainConfig())
