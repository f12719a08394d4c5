"""The port's gatedgcn, meshgraphnet and equiformer-v2 inference against
the JAX package's: the configs, the parameter trees (``init_gnn``'s shapes,
``gnn_params_from_reference``), the shared pieces (``_layernorm``,
``_mlp_apply``, ``segment_softmax`` with empty segments), the layouts the
port sums over (``edge_layout``, ``irrep_layout``), and each kind's
``gnn_forward``, ``node_classification_loss`` and
``graph_regression_loss`` with the reference's own weights, at the smoke
widths on ``molecule`` (128 graphs of 30 nodes) and on a small full graph
(200 nodes, 1,200 edges, an anti-parallel edge planted for
equiformer-v2), and at the full widths on three molecules. Edge features
are drawn with numpy at the reference's cell widths (``GNN_EDGE_DIM``).

The weights are drawn with numpy into the reference's parameter tree
(``_ref_params``). The reference runs jitted, once per case and dtype (a
module cache): in float32, and in float64 under ``jax.enable_x64`` with its
parameters and inputs cast to float64; its losses are its own loss
functions over those logits.

Tolerances:
  * configs, parameter shapes and the converted leaves: equality, bit for
    bit.
  * float64 on both sides: ``max|port - ref| <= 1e-9 max|ref|``
    (measured: at most 2.2e-15).
  * float32: the spread rule of ``models/gnn_check.py``: the port's
    float32 logits within ``SPREAD_C`` (8) times the reference's own
    float32 spread from its float64 logits (floored at 2^-22). Measured on
    these cases: spreads 1.5e-7 to 2.1e-6 and the port within 0.7 to 2.3
    of them. Losses: the same rule on the scalar.
  * on the CPU every aggregation is the plain ``segment_mm_ref`` (no kernel
    launch), called ``segment_mm_launches(cfg)`` times a forward; a
    prebuilt layout, a missing one and ``impl="ref"`` give equal bits.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses
import functools

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import GNN_SHAPES as REF_GNN_SHAPES  # noqa: E402
from repro.config.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.launch.steps import _GNN_EDGE_DIM  # noqa: E402
from repro.models import gnn as ref_gnn  # noqa: E402
from repro_torch.config import GNNConfig, get_arch, list_archs  # noqa: E402
from repro_torch.convert import gnn_params_from_reference  # noqa: E402
from repro_torch.kernels.segment_mm import kernel as smod  # noqa: E402
from repro_torch.kernels.segment_mm import ops as sops  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import gnn_check as gc  # noqa: E402

ARCHS = ("gatedgcn", "meshgraphnet", "equiformer-v2")
CASES = ("molecule-smoke", "graph-smoke", "tiny-full")
REL64 = 1e-9
D_FEAT = 32          # the molecule batches' feature width, on every case
REF_SHAPES = {s.name: s for s in REF_GNN_SHAPES}


def _batch(arch, case):
    """The case's numpy batch (the reference's batch functions, seed 0),
    with ``e`` at the reference's cell width for the kinds that take it."""
    kind = ref_get_arch(arch).kind
    if case == "graph-smoke":
        shape = RefShapeSpec(name="g", kind="full_graph", n_nodes=200,
                             n_edges=1200, d_feat=D_FEAT)
        b = ref_pipeline.gnn_full_graph_batch(
            None, shape, seed=0, n_classes=ref_get_arch(arch,
                                                        smoke=True).d_out)
        # an edge whose vector is exactly -z (the frame's flip branch)
        s, d = b["src"][7], b["dst"][7]
        if s != d:
            b["pos"][d] = b["pos"][s] - np.float32([0.0, 0.0, 1.0])
    else:
        shape = REF_SHAPES["molecule"]
        if case == "tiny-full":
            shape = dataclasses.replace(shape, n_graphs=3)
        b = ref_pipeline.gnn_molecule_batch(None, shape, seed=0,
                                            d_feat=D_FEAT)
    if kind in _GNN_EDGE_DIM:
        b["e"] = np.random.default_rng(1).standard_normal(
            (b["src"].shape[0], _GNN_EDGE_DIM[kind])).astype(np.float32)
    return b


def _cfgs(arch, case):
    smoke = case != "tiny-full"
    return get_arch(arch, smoke=smoke), ref_get_arch(arch, smoke=smoke)


def _f64(a):
    return a.astype(np.float64) if a.dtype == np.float32 else a


@functools.lru_cache(maxsize=None)
def _ref_params(arch, smoke):
    """Weights in the reference's tree (its ``init_gnn``'s structure and
    shapes, from ``jax.eval_shape``) at the arch's smoke or full widths,
    drawn with numpy: normal times fan_in^-0.5 for the weights, as the
    reference scales them, and normal times 0.1 for the biases (zero in
    the reference's init; nonzero here so that they are exercised).
    Shared by the cases of that width."""
    cfg_ref = ref_get_arch(arch, smoke=smoke)
    shapes = jax.eval_shape(functools.partial(
        ref_gnn.init_gnn, cfg_ref, D_FEAT,
        d_edge_in=_GNN_EDGE_DIM.get(cfg_ref.kind, 1)), jax.random.PRNGKey(0))
    r = np.random.default_rng(2)

    def draw(sds):
        a = r.standard_normal(sds.shape)
        scale = sds.shape[0] ** -0.5 if len(sds.shape) == 2 else 0.1
        return (a * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _ref_losses(params, graph, logits, cfg_ref):
    """The reference's two loss functions over ``logits`` (its
    ``gnn_forward`` stood in for while they are traced)."""
    real = ref_gnn.gnn_forward
    ref_gnn.gnn_forward = lambda *_: logits
    try:
        out = {"node": ref_gnn.node_classification_loss(params, graph,
                                                        cfg_ref)}
        if "graph_id" in graph:
            out["graph"] = ref_gnn.graph_regression_loss(params, graph,
                                                         cfg_ref)
    finally:
        ref_gnn.gnn_forward = real
    return out


_REF_FORWARD = jax.jit(ref_gnn.gnn_forward, static_argnums=2)
_REF_LOSSES = jax.jit(_ref_losses, static_argnums=3)


@functools.lru_cache(maxsize=None)
def _reference(arch, case):
    """The reference's weights and its logits and losses in float32 and
    float64, computed once per case."""
    cfg_ref = _cfgs(arch, case)[1]
    b = _batch(arch, case)
    p_np = _ref_params(arch, case != "tiny-full")
    out = {"params": p_np}
    for bits in (32, 64):
        with jax.enable_x64(bits == 64):
            conv = _f64 if bits == 64 else (lambda a: a)
            p = jax.tree_util.tree_map(lambda a: jnp.asarray(conv(a)), p_np)
            g = {k: jnp.asarray(conv(v)) for k, v in b.items()}
            logits = _REF_FORWARD(p, g, cfg_ref)
            losses = _REF_LOSSES(p, g, logits, cfg_ref)
            out[bits] = (np.array(logits),
                         {k: float(v) for k, v in losses.items()})
    return out


def _port(arch, case, bits):
    """The port's params and resident graph (CPU) for the case."""
    cfg = _cfgs(arch, case)[0]
    params = gnn_params_from_reference(_reference(arch, case)["params"], cfg,
                                       device="cpu")
    graph = gnn.resident_graph(_batch(arch, case), device="cpu", cfg=cfg)
    if bits == 64:
        params, graph = gc.as64(params), gc.as64(graph)
    return cfg, params, graph


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert arch in list_archs()
    for smoke in (False, True):
        got, ref = get_arch(arch, smoke=smoke), ref_get_arch(arch,
                                                             smoke=smoke)
        assert isinstance(got, GNNConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.param_count() == ref.param_count()
    assert gnn.GNN_EDGE_DIM == _GNN_EDGE_DIM


def _shapes_of(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_match_reference(arch):
    """``init_gnn`` builds the reference's tree, leaf for leaf, at smoke and
    full widths; weights scaled by fan_in^-0.5, biases zero."""
    for smoke in (True, False):
        cfg, cfg_ref = get_arch(arch, smoke=smoke), ref_get_arch(
            arch, smoke=smoke)
        de = _GNN_EDGE_DIM.get(cfg.kind, 1)
        want = jax.eval_shape(functools.partial(
            ref_gnn.init_gnn, cfg_ref, 24, d_edge_in=de),
            jax.random.PRNGKey(0))
        got = gnn.init_gnn(cfg, 24, torch.Generator().manual_seed(0),
                           d_edge_in=de)
        assert (jax.tree_util.tree_structure(_shapes_of(got))
                == jax.tree_util.tree_structure(_shapes_of(want)))
        assert _shapes_of(got) == _shapes_of(want)
        assert _shapes_of(got) == gnn.param_shapes(cfg, 24, de)
        leaves = jax.tree_util.tree_leaves(got)
        assert all(t.dtype == torch.float32 for t in leaves)
        assert all(not t.any() for t in leaves if t.dim() == 1)
        again = gnn.init_gnn(cfg, 24, torch.Generator().manual_seed(0),
                             d_edge_in=de)
        assert all(torch.equal(a, b) for a, b in zip(
            leaves, jax.tree_util.tree_leaves(again)))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_across_and_checked(arch):
    cfg = _cfgs(arch, "tiny-full")[0]
    p_np = _reference(arch, "tiny-full")["params"]
    p = gnn_params_from_reference(p_np, cfg, device="cpu")
    flat_np = jax.tree_util.tree_leaves_with_path(p_np)
    flat = jax.tree_util.tree_leaves_with_path(p)
    assert [k for k, _ in flat] == [k for k, _ in flat_np]
    for (_, t), (_, a) in zip(flat, flat_np):
        assert t.dtype == torch.float32 and t.numpy().tobytes() == a.tobytes()
    # a leaf of the wrong shape, a missing leaf and a wrong layer count
    # raise, naming where
    bad = jax.tree_util.tree_map(lambda a: a, p_np)
    lp = bad["layers" if "layers" in bad else "blocks"][1]
    name, leaf = next((k, v) for k, v in lp.items()
                      if not isinstance(v, dict))  if arch == "equiformer-v2" \
        else next((k, v) for k, v in lp.items())
    if isinstance(leaf, dict):
        leaf["w0" if "w0" in leaf else "w"] = leaf[
            "w0" if "w0" in leaf else "w"][:, :-1]
        where = rf"\[1\]\.{name}\.w"
    else:
        lp[name] = leaf[:, :-1]
        where = rf"\[1\]\.{name}"
    with pytest.raises(ValueError, match=where):
        gnn_params_from_reference(bad, cfg, device="cpu")
    missing = {k: v for k, v in p_np.items() if k != "head" and k != "dec"}
    with pytest.raises(ValueError, match="keys"):
        gnn_params_from_reference(missing, cfg, device="cpu")
    short = dict(p_np)
    key = "blocks" if "blocks" in p_np else "layers"
    short[key] = p_np[key][:-1]
    with pytest.raises(ValueError, match=key):
        gnn_params_from_reference(short, cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown GNN kind"):
        gnn_params_from_reference(p_np, dataclasses.replace(cfg, kind="x"),
                                  device="cpu")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float64_matches_reference(arch, case):
    cfg, params, graph = _port(arch, case, 64)
    want = _reference(arch, case)[64][0]
    got = gnn.gnn_forward(params, graph, cfg)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert gc.rel_max(got, torch.from_numpy(want)) <= REL64


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32_within_the_spread_rule(arch, case):
    cfg, params, graph = _port(arch, case, 32)
    ref = _reference(arch, case)
    before = smod.segment_mm_cuda.launches
    got = gnn.gnn_forward(params, graph, cfg)
    assert smod.segment_mm_cuda.launches == before
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert gc.spread_excess(got, torch.from_numpy(ref[64][0]),
                            torch.from_numpy(ref[32][0])) <= 1.0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_reference(arch, case):
    """Node classification on every case (the molecule batches' labels are
    zeros) and graph regression on the molecule batches: float64 within
    1e-9, float32 under the spread rule on the scalar."""
    ref = _reference(arch, case)
    for bits in (64, 32):
        cfg, params, graph = _port(arch, case, bits)
        want = ref[bits][1]
        got = {"node": float(gnn.node_classification_loss(params, graph,
                                                          cfg))}
        if "graph_id" in graph:
            got["graph"] = float(gnn.graph_regression_loss(params, graph,
                                                           cfg))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            if bits == 64:
                assert abs(v - want[k]) <= REL64 * abs(want[k])
            else:
                exact, spread = ref[64][1][k], abs(want[k] - ref[64][1][k])
                allow = gc.SPREAD_C * max(spread,
                                          gc.SPREAD_FLOOR * abs(exact))
                assert abs(v - exact) <= allow, (k, v, exact, allow)


@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_and_impl_change_nothing(arch, monkeypatch):
    """A prebuilt layout, none (built for the call) and ``impl="ref"`` give
    the same bits; every aggregation is one ``segment_mm_csr`` call,
    ``segment_mm_launches(cfg)`` of them a forward."""
    cfg, params, graph = _port(arch, "molecule-smoke", 32)
    calls = []
    real = sops.segment_mm_csr

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(gnn, "segment_mm_csr", counting)
    out = gnn.gnn_forward(params, graph, cfg)
    assert len(calls) == gnn.segment_mm_launches(cfg)
    widths = {s[1] for s in calls}
    assert widths == {"gatedgcn": {2 * cfg.d_hidden},
                      "meshgraphnet": {cfg.d_hidden},
                      "equiformer-v2": {cfg.n_heads, cfg.d_hidden}}[arch]
    bare = {k: v for k, v in graph.items() if not k.endswith("layout")}
    assert torch.equal(gnn.gnn_forward(params, bare, cfg), out)
    assert torch.equal(gnn.gnn_forward(params, graph, cfg, impl="ref"), out)
    with pytest.raises(ValueError, match="impl"):
        gnn.gnn_forward(params, graph, cfg, impl="pallas")


def test_shared_pieces_match_reference():
    """``_layernorm``, ``_mlp_apply`` (with and without the final
    activation) and ``segment_softmax`` over segments of which a third are
    empty, in float64 (1e-9) and float32 (the spread rule)."""
    r = np.random.default_rng(3)
    x = r.standard_normal((50, 12)) * 3 + 1
    mlp = {"w0": r.standard_normal((12, 9)), "b0": r.standard_normal(9),
           "w1": r.standard_normal((9, 5)), "b1": r.standard_normal(5)}
    n_seg, n = 30, 400
    seg = r.integers(0, 20, n).astype(np.int32)     # segments 20-29 empty
    scores = r.standard_normal((n, 4)) * 5

    @jax.jit
    def ref_all(x, mlp, scores, seg):
        return (ref_gnn._layernorm(x),
                ref_gnn._mlp_apply(mlp, x, 2),
                ref_gnn._mlp_apply(mlp, x, 2, final_act=True),
                ref_gnn.segment_softmax(scores, seg, n_seg),
                ref_gnn.segment_softmax(scores[:, 0], seg, n_seg))

    def port_all(x, mlp, scores, seg):
        return (gnn._layernorm(x), gnn._mlp_apply(mlp, x, 2),
                gnn._mlp_apply(mlp, x, 2, final_act=True),
                gnn.segment_softmax(scores, seg, n_seg),
                gnn.segment_softmax(scores[:, 0], seg, n_seg))

    want = {}
    for bits in (32, 64):
        dt = np.float64 if bits == 64 else np.float32
        with jax.enable_x64(bits == 64):
            want[bits] = [np.array(a) for a in ref_all(
                jnp.asarray(x.astype(dt)),
                {k: jnp.asarray(v.astype(dt)) for k, v in mlp.items()},
                jnp.asarray(scores.astype(dt)), jnp.asarray(seg))]
    for bits in (64, 32):
        dt = torch.float64 if bits == 64 else torch.float32
        got = port_all(torch.from_numpy(x).to(dt),
                       {k: torch.from_numpy(v).to(dt)
                        for k, v in mlp.items()},
                       torch.from_numpy(scores).to(dt), torch.from_numpy(seg))
        for g, w64, w32 in zip(got, want[64], want[32]):
            assert g.dtype == dt and tuple(g.shape) == w64.shape
            if bits == 64:
                assert gc.rel_max(g, torch.from_numpy(w64)) <= REL64
            else:
                assert gc.spread_excess(g, torch.from_numpy(w64),
                                        torch.from_numpy(w32)) <= 1.0
    # the softmax sums to 1 over each non-empty segment
    sm = got[3].double()
    tot = torch.zeros(n_seg, 4, dtype=torch.float64).index_add_(
        0, torch.from_numpy(seg).long(), sm)
    assert torch.allclose(tot[:20], torch.ones(20, 4, dtype=torch.float64))


@pytest.mark.parametrize("k", [1, 16, 49])
def test_edge_and_irrep_layouts_sum_as_segment_sum(k):
    """``segment_sum`` over ``edge_layout`` and ``irrep_layout`` equals the
    reference's ``jax.ops.segment_sum`` of the per-edge rows (float64, on a
    graph with empty rows, self-loops and duplicate edges); the irrep
    layout is a CSR of E K items over N K rows."""
    r = np.random.default_rng(k)
    n, e, c = 60, 500, 8
    src = r.integers(0, n, e).astype(np.int32)
    dst = r.integers(0, n // 2, e).astype(np.int32)   # rows n/2.. empty
    dst[:40] = src[:40]
    msg = r.standard_normal((e, k, c))
    with jax.enable_x64(True):
        want = np.array(jax.ops.segment_sum(jnp.asarray(msg),
                                            jnp.asarray(dst),
                                            num_segments=n))
    layout = sops.csr_layout(torch.from_numpy(src), torch.from_numpy(dst), n)
    lay_k = gnn.irrep_layout(layout, k)
    assert lay_k.n_nodes == n * k and lay_k.col.numel() == e * k
    assert lay_k.col.dtype == lay_k.row.dtype == torch.int32
    assert torch.equal(lay_k.row_ptr[1:] - lay_k.row_ptr[:-1],
                       layout.in_degree().repeat_interleave(k))
    assert torch.equal(lay_k.row.long(), torch.repeat_interleave(
        torch.arange(n * k), lay_k.row_ptr[1:] - lay_k.row_ptr[:-1]))
    got = gnn.segment_sum(torch.from_numpy(msg).reshape(e * k, c), lay_k)
    assert gc.rel_max(got.reshape(n, k, c), torch.from_numpy(want)) <= 1e-12
    got_e = gnn.segment_sum(torch.from_numpy(msg).reshape(e, k * c),
                            gnn.edge_layout(layout))
    assert gc.rel_max(got_e.reshape(n, k, c),
                      torch.from_numpy(want)) <= 1e-12


def test_default_edge_features_and_edge_width_check():
    """Without ``e`` gatedgcn takes ones [E, 1], as the reference does;
    ``resident_graph`` refuses an ``e`` of another width than the cells'."""
    arch, case = "gatedgcn", "graph-smoke"
    cfg, params, graph = _port(arch, case, 64)
    cfg_ref = _cfgs(arch, case)[1]
    b = {k: v for k, v in _batch(arch, case).items() if k != "e"}
    with jax.enable_x64(True):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(_f64(a)),
                                   _reference(arch, case)["params"])
        want = np.array(ref_gnn.gnn_forward(
            p, {k: jnp.asarray(_f64(v)) for k, v in b.items()}, cfg_ref))
    del graph["e"]
    assert gc.rel_max(gnn.gnn_forward(params, graph, cfg),
                      torch.from_numpy(want)) <= REL64
    bad = dict(b, e=np.ones((b["src"].shape[0], 4), np.float32))
    with pytest.raises(ValueError, match="e \\[E, 1\\]"):
        gnn.resident_graph(bad, device="cpu", cfg=cfg)


def test_equiformer_rotation_invariance_and_its_fault():
    """The reference's own check (``pos`` rotated about z by 1.1: within
    1e-3) with the reference's weights; and under a rotation about no axis
    on the graph without self-loops, the spread-based rule of
    ``models/gnn_check.py`` holds, and rotating messages back without the
    transpose breaks it (the check about z cannot see that fault)."""
    arch, case = "equiformer-v2", "graph-smoke"
    cfg, params, graph = _port(arch, case, 32)
    out = gnn.gnn_forward(params, graph, cfg)
    about_z = gnn.gnn_forward(params, gc.rotated_graph(
        graph, gc.rotation_z()), cfg)
    assert gc.invariance_rel(out, about_z) < gc.INVARIANCE_RULE
    with gc.untransposed_rotation():
        f, fz = (gnn.gnn_forward(params, g, cfg) for g in (
            graph, gc.rotated_graph(graph, gc.rotation_z())))
    assert gc.invariance_rel(f, fz) < gc.INVARIANCE_RULE   # blind to it

    b = gc.drop_self_loops(_batch(arch, case))
    graph = gnn.resident_graph(b, device="cpu", cfg=cfg)
    runs = {}
    for name, g in (("out", graph),
                    ("rot", gc.rotated_graph(graph, gc.ROTATION))):
        runs[name] = gnn.gnn_forward(params, g, cfg)
        runs[name + "64"] = gnn.gnn_forward(gc.as64(params), gc.as64(g), cfg)
        with gc.untransposed_rotation():
            runs[name + "_fault"] = gnn.gnn_forward(params, g, cfg)
    spread = max(gc.rel_max(runs["out"], runs["out64"]),
                 gc.rel_max(runs["rot"], runs["rot64"]))
    assert gc.invariance_excess(runs["out"], runs["rot"], spread) <= 1.0
    assert gc.invariance_excess(runs["out_fault"], runs["rot_fault"],
                                spread) > 1.0


def test_unknown_kind_raises():
    cfg = dataclasses.replace(get_arch("gatedgcn", smoke=True), kind="gin")
    graph = gnn.resident_graph(_batch("gatedgcn", "graph-smoke"),
                               device="cpu")
    for call in (lambda: gnn.init_gnn(cfg, 8, torch.Generator()),
                 lambda: gnn.gnn_forward({}, graph, cfg),
                 lambda: gnn.param_shapes(cfg, 8),
                 lambda: gnn.segment_mm_launches(cfg)):
        with pytest.raises(ValueError, match="unknown GNN kind 'gin'"):
            call()
