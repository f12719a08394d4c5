"""The port's GNN training step (``launch/steps.py``'s GNN cell:
the regime's loss, autograd through ``segment_mm_csr``'s backward over
the transposed layouts, ``optim/adamw.apply_updates``) against the JAX
package's (``jax.value_and_grad`` of its loss, then its
``adamw.apply_updates``), for each kind's smoke config at a small
``full_graph`` (90 nodes, 400 edges), ``molecule`` (4 graphs of 10 nodes,
24 edges each; ``targets [4, d_out]``) and sampled ``minibatch`` (6
seeds, fanout (3, 2), over a 150-node graph; a new batch each step, from
``gnn_minibatch_batch``) graph, in float64 on both sides (the reference
under ``jax.enable_x64``), with numpy-drawn weights carried into both
trees and the reference's gradients into the port's tree through
``convert.gnn_params_from_reference``.

equiformer-v2's smoke config has ``d_out`` 1, so its node-classification
loss is 0 and its gradient exactly zero whatever the weights (one class:
``logsumexp`` of one logit is the logit); its ``full_graph`` and
``minibatch`` cases here run at ``d_out`` 3 on both sides instead.

GCN's coefficients ``rsqrt(deg[src]) rsqrt(deg[dst])`` are float32 on
both sides, and XLA's float32 ``rsqrt`` differs from torch's by up to 2
ulp (held in ``tests/test_torch_gnn.py``); so here the port's
``gcn_norm`` gives the reference's float32 coefficients (``_xla_norm``),
and the gradients are compared on the same inputs.

Tolerances (float64):
  * the loss and every gradient leaf at the first step: within 1e-9 of
    the leaf's largest magnitude, or of ``ZERO_FLOOR`` times the tree's
    largest gradient if that is more: a leaf whose gradient is zero in
    exact arithmetic (the attention's last bias in equiformer-v2: its
    softmax does not move when every score of a segment does) is rounding
    noise on both sides (measured: at most 8.7e-15 for gcn, gatedgcn and
    meshgraphnet, 2.7e-11 for equiformer-v2);
  * three steps: the update is float32 on both sides, as the reference
    casts it, so a gradient element whose float32 rounding flips, or a
    global norm summed in another order, moves a parameter by a float32
    ulp of its own magnitude: every parameter after each step within
    ``PARAM_REL`` (2^-22, two float32 ulps) of the leaf's largest magnitude
    (measured: at most 4.0e-8), the first step's loss within 1e-9 and the
    later ones' within ``PARAM_REL`` (measured: at most 7.0e-10);
  * the no-grad forward: bit for bit the forward autograd records
    (chunked in place at ``EDGE_CHUNK`` 64 without autograd, whole with
    it), in float32, with one intra-op thread;
  * every step on the CPU launches no kernel; its ``segment_mm`` calls
    are twice a forward's (one backward each).
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import functools

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.launch.steps import _GNN_EDGE_DIM  # noqa: E402
from repro.models import gnn as ref_gnn  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.config import ShapeSpec, get_arch  # noqa: E402
from repro_torch.convert import gnn_params_from_reference  # noqa: E402
from repro_torch.data.pipeline import (DataCursor,  # noqa: E402
                                       gnn_full_graph_batch,
                                       gnn_minibatch_batch,
                                       gnn_molecule_batch)
from repro_torch.graph.sampler import NeighborSampler  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.kernels.segment_mm import kernel as smod  # noqa: E402
from repro_torch.kernels.segment_mm import ops as sops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import gnn_check as gc  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ("gcn-cora", "gatedgcn", "meshgraphnet", "equiformer-v2")
REGIMES = ("full_graph", "molecule", "minibatch")
D_FEAT = 12
REL64 = 1e-9
ZERO_FLOOR = 1e-6
PARAM_REL = 2.0 ** -22
STEPS = 3
SHAPES = {
    "full_graph": ShapeSpec(name="tiny_full", kind="full_graph", n_nodes=90,
                            n_edges=400, d_feat=D_FEAT),
    "molecule": ShapeSpec(name="tiny_mol", kind="batched_graphs",
                          n_nodes=10, n_edges=24, n_graphs=4, d_feat=D_FEAT),
    "minibatch": ShapeSpec(name="tiny_mb", kind="minibatch", n_nodes=150,
                           n_edges=900, batch_nodes=6, fanout=(3, 2),
                           d_feat=D_FEAT)}


def _cfgs(arch, regime):
    """The port's and the reference's smoke configs of the case."""
    out = get_arch(arch, smoke=True), ref_get_arch(arch, smoke=True)
    if arch == "equiformer-v2" and regime != "molecule":
        out = tuple(dataclasses.replace(c, d_out=3) for c in out)
    return out


@functools.lru_cache(maxsize=None)
def _batches(arch, regime):
    """The cell's numpy batches, one per step (the same graph for
    full_graph and molecule), with exactly its declared inputs."""
    cfg = _cfgs(arch, regime)[0]
    shape = SHAPES[regime]
    cell = steps._gnn_cell(cfg, shape, torch.device("cpu"))
    if regime == "minibatch":
        full = gnn_full_graph_batch(cfg, shape, seed=0, n_classes=cfg.d_out)
        sampler = NeighborSampler(EdgeList(
            shape.n_nodes, full["src"], full["dst"],
            np.ones(shape.n_edges, np.int32)), shape.fanout, seed=0)
        return tuple(gnn_minibatch_batch(cfg, shape, sampler, full,
                                         DataCursor(step=i))
                     for i in range(STEPS))
    if regime == "molecule":
        b = gnn_molecule_batch(cfg, shape, seed=0, d_feat=D_FEAT)
        b["targets"] = np.random.default_rng(1).standard_normal(
            (shape.n_graphs, cfg.d_out)).astype(np.float32)
    else:
        b = gnn_full_graph_batch(cfg, shape, seed=0, n_classes=cfg.d_out)
    if cfg.kind in _GNN_EDGE_DIM:
        b["e"] = np.random.default_rng(2).standard_normal(
            (len(b["src"]), _GNN_EDGE_DIM[cfg.kind])).astype(np.float32)
    b = {k: v for k, v in b.items() if k in cell.arg_shapes}
    return (b,) * STEPS


@functools.lru_cache(maxsize=None)
def _ref_params(arch, regime):
    cfg_ref = _cfgs(arch, regime)[1]
    shapes = jax.eval_shape(functools.partial(
        ref_gnn.init_gnn, cfg_ref, D_FEAT,
        d_edge_in=_GNN_EDGE_DIM.get(cfg_ref.kind, 1)), jax.random.PRNGKey(0))
    r = np.random.default_rng(3)

    def draw(sds):
        scale = sds.shape[0] ** -0.5 if len(sds.shape) == 2 else 0.1
        return r.standard_normal(sds.shape) * scale

    return jax.tree_util.tree_map(draw, shapes)


@pytest.fixture(autouse=True)
def _xla_norm(monkeypatch):
    """``gcn_norm`` with the per-edge coefficients computed by XLA's
    float32 ``rsqrt``, as the reference forms them."""
    real = gnn.gcn_norm

    def norm(layout, how):
        deg, coeff, self_coeff = real(layout, how)
        if how == "sym":
            d = deg.numpy()
            coeff = torch.from_numpy(np.array(
                jax.lax.rsqrt(jnp.asarray(d[layout.col.numpy()]))
                * jax.lax.rsqrt(jnp.asarray(d[layout.row.numpy()]))))
        return deg, coeff, self_coeff

    monkeypatch.setattr(gnn, "gcn_norm", norm)


def _ref_loss_fn(regime):
    return (ref_gnn.graph_regression_loss if regime == "molecule"
            else ref_gnn.node_classification_loss)


@functools.lru_cache(maxsize=None)
def _reference(arch, regime):
    """Per step: the reference's loss, gradients and updated parameters
    (numpy trees), float64."""
    cfg_ref = _cfgs(arch, regime)[1]
    out = []
    with jax.enable_x64(True):
        vg = jax.jit(jax.value_and_grad(_ref_loss_fn(regime)),
                     static_argnums=2)
        p = jax.tree_util.tree_map(jnp.asarray, _ref_params(arch, regime))
        opt = ref_adamw.init_state(p)
        for b in _batches(arch, regime):
            g = {k: jnp.asarray(v.astype(np.float64)
                                if v.dtype == np.float32 else v)
                 for k, v in b.items()}
            loss, grads = vg(p, g, cfg_ref)
            p, opt, stats = ref_adamw.apply_updates(p, opt, grads,
                                                    RefTrainConfig())
            out.append((float(loss),
                        jax.tree_util.tree_map(np.asarray, grads),
                        jax.tree_util.tree_map(np.asarray, p),
                        {k: float(v) for k, v in stats.items()}))
    return out


def _port_tree(tree, cfg):
    return gnn_params_from_reference(tree, cfg, device="cpu",
                                     dtype=torch.float64)


def _leaves_close(got, want, cfg, what, rel=REL64):
    """Each leaf within ``rel`` of its largest magnitude (floored at
    ``ZERO_FLOOR`` of the tree's largest); the largest relative error."""
    want = adamw.tree_leaves(_port_tree(want, cfg))
    top = max(float(b.abs().max()) for b in want)
    worst = 0.0
    for a, b in zip(adamw.tree_leaves(got), want):
        assert a.shape == b.shape and a.dtype == torch.float64, what
        err = float((a - b).abs().max())
        scale = max(float(b.abs().max()), ZERO_FLOOR * top)
        assert err <= rel * scale, (what, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, regime):
    cfg = _cfgs(arch, regime)[0]
    cell = steps._gnn_cell(cfg, SHAPES[regime], torch.device("cpu"))
    graph = gc.as64(cell.graph(_batches(arch, regime)[0]))
    params = adamw.tree_map(lambda p: p.requires_grad_(),
                            _port_tree(_ref_params(arch, regime), cfg))
    loss_fn = (gnn.graph_regression_loss if regime == "molecule"
               else gnn.node_classification_loss)
    loss = loss_fn(params, graph, cfg)
    loss.backward()
    want_loss, want_grads, _, _ = _reference(arch, regime)[0]
    assert loss.dtype == torch.float64
    assert abs(loss.item() - want_loss) <= REL64 * abs(want_loss)
    grads = adamw.tree_map(lambda p: p.grad, params)
    assert all(g is not None for g in adamw.tree_leaves(grads))
    _leaves_close(grads, want_grads, cfg, "grad")


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch, regime, monkeypatch):
    cfg = _cfgs(arch, regime)[0]
    cell = steps._gnn_cell(cfg, SHAPES[regime], torch.device("cpu"))
    calls = []
    real = sops.segment_mm_csr

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gnn, "segment_mm_csr", counting)
    backwards = []
    real_fn = sops._segment_mm

    def counting_fn(*a, **k):
        backwards.append(1)
        return real_fn(*a, **k)

    monkeypatch.setattr(sops, "_segment_mm", counting_fn)
    params = _port_tree(_ref_params(arch, regime), cfg)
    opt = adamw.init_state(params)
    before = smod.segment_mm_cuda.launches
    for i, (b, (want_loss, _, want_p, want_stats)) in enumerate(zip(
            _batches(arch, regime), _reference(arch, regime))):
        graph = gc.as64(cell.graph(b))
        del calls[:], backwards[:]
        params, opt, loss, stats = cell.step_fn(params, opt, graph)
        assert len(calls) == gnn.segment_mm_launches(cfg)
        assert len(backwards) == 2 * gnn.segment_mm_launches(cfg)
        rel = REL64 if i == 0 else PARAM_REL
        assert abs(float(loss) - want_loss) <= rel * abs(want_loss), i
        _leaves_close(params, want_p, cfg, f"params after step {i + 1}",
                      PARAM_REL)
        assert int(opt.step) == i + 1
        assert float(stats["lr"]) == want_stats["lr"]
        assert abs(float(stats["grad_norm"]) - want_stats["grad_norm"]) \
            <= 2.0 ** -20 * want_stats["grad_norm"]
        assert not any(p.requires_grad for p in adamw.tree_leaves(params))
    assert smod.segment_mm_cuda.launches == before


@pytest.mark.parametrize("arch", ARCHS)
def test_no_grad_forward_bit_equal_to_recorded(arch, monkeypatch):
    """Chunked and in place without autograd, whole with it: the same
    bits (float32, edge chunks of 64 on the 400-edge graph)."""
    monkeypatch.setattr(gnn, "EDGE_CHUNK", 64)
    cfg = _cfgs(arch, "full_graph")[0]
    cell = steps._gnn_cell(cfg, SHAPES["full_graph"], torch.device("cpu"))
    graph = cell.graph(_batches(arch, "full_graph")[0])
    params = _port_tree(_ref_params(arch, "full_graph"), cfg)
    params = adamw.tree_map(lambda p: p.float(), params)
    with torch.no_grad():
        quiet = gnn.gnn_forward(params, graph, cfg)
    plain = gnn.gnn_forward(params, graph, cfg)
    taped = gnn.gnn_forward(adamw.tree_map(
        lambda p: p.detach().requires_grad_(), params), graph, cfg)
    assert taped.requires_grad and not quiet.requires_grad
    assert torch.equal(quiet, taped.detach())
    assert torch.equal(quiet, plain)


def test_cell_refuses_wrong_inputs_and_cuts():
    cfg = get_arch("gatedgcn", smoke=True)
    cell = steps._gnn_cell(cfg, SHAPES["full_graph"], torch.device("cpu"))
    b = dict(_batches("gatedgcn", "full_graph")[0])
    with pytest.raises(ValueError, match="input e"):
        cell.graph({k: v for k, v in b.items() if k != "e"})
    with pytest.raises(ValueError, match="no inputs"):
        cell.graph(dict(b, pos=np.zeros((90, 3), np.float32)))
    with pytest.raises(ValueError, match="input x"):
        cell.graph(dict(b, x=b["x"].astype(np.float64)))
    cut = steps.build_cell("gatedgcn", "ogb_products", device="cpu",
                           n_nodes=300, n_edges=1000)
    assert cut.arg_shapes["src"][0] == (1000,)
    assert cut.arg_shapes["x"][0] == (300, 100)
    assert cut.note == "n_nodes 300 of 2449029; n_edges 1000 of 61859140"
    mb = steps.build_cell("equiformer-v2", "minibatch_lg", device="cpu",
                          batch_nodes=64)
    assert mb.arg_shapes["seed_slots"][0] == (64,)
    assert mb.arg_shapes["x"][0] == (64 * 16 * 11, 602)
    with pytest.raises(TypeError, match="n_edges cuts a full_graph"):
        steps.build_cell("gcn-cora", "molecule", device="cpu", n_edges=10)
    with pytest.raises(TypeError, match="no cell arguments"):
        steps.build_cell("gcn-cora", "molecule", device="cpu", seq_len=10)
    params, opt = mb.init(seed=0)
    assert int(opt.step) == 0 and len(params["layers"]) == 12
