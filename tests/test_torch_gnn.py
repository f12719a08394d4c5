"""The port's GCN inference slice against the JAX package's: the configs
(``GNNConfig``, ``GNN_SHAPES``, gcn-cora), the batch functions
(``gnn_full_graph_batch``, ``gnn_molecule_batch``), the parameter
converter, ``init_gnn``, GCN's degrees and coefficients, and
``gnn_forward``, ``node_classification_loss`` and
``graph_regression_loss`` with the reference's own weights (carried over
with ``gnn_params_from_reference``) against the reference's, at the smoke
widths and at gcn-cora's full widths (d_hidden 16, d_out 7) on
``full_graph_sm`` (2,708 nodes x 1,433 features, 10,556 edges) and
``molecule`` (128 graphs of 30 nodes). The port aggregates with
``segment_mm_csr`` over its CSR layout (on the CPU: the plain version); the
reference with ``jax.ops.segment_sum``.

Tolerances:
  * batches, converted parameters and ``deg``: bit equality.
  * ``rsqrt(deg)``: 2 ulp. XLA's float32 ``rsqrt`` on the CPU is not
    torch's: they differ on about a third of the integer degrees up to
    50,000, by up to 2 ulp. So the per-edge coefficients
    ``rsqrt(deg[src]) rsqrt(deg[dst])``, a product of two such factors,
    are held to a relative 2^-21 + 2^-23 (2 ulp of each factor and one
    rounding on each side; measured: at most 3 ulp of the product).
  * one aggregation with the reference's own coefficients: the float32 rule
    of ``kernels/segment_mm/cases.py``.
  * logits: the chained rule of that module (``chain_excess``), ``16 u
    sqrt(K)`` of the forward run on absolute values, K the longest sum on
    the chain. The matmuls (XLA's against torch's) and the aggregations
    both sum in another order; the coefficients differ by up to 2 ulp.
  * losses: what the logits' allowance can move them by (``_loss_tol``).
"""
import contextlib
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    @contextlib.contextmanager
    def _enable_x64(new_val: bool = True):
        with jax.enable_x64(new_val):
            yield

    jax.experimental.enable_x64 = _enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import GNN_SHAPES as REF_GNN_SHAPES  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import gnn as ref_gnn  # noqa: E402
from repro_torch.config import (GNN_SHAPES, GNNConfig, get_arch,  # noqa: E402
                                list_archs)
from repro_torch.convert import gnn_params_from_reference  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.segment_mm import kernel as smod  # noqa: E402
from repro_torch.kernels.segment_mm.cases import (U, chain_excess,  # noqa: E402
                                                  chain_magnitude,
                                                  rule_excess)
from repro_torch.kernels.segment_mm.ops import segment_mm_csr  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

SHAPES = {s.name: s for s in GNN_SHAPES}
REF_SHAPES = {s.name: s for s in REF_GNN_SHAPES}


def _batch(shape_name, seed=0, n_classes=7):
    """The reference's batch for the shape (numpy)."""
    if shape_name == "molecule":
        return ref_pipeline.gnn_molecule_batch(None, REF_SHAPES[shape_name],
                                               seed=seed)
    return ref_pipeline.gnn_full_graph_batch(None, REF_SHAPES[shape_name],
                                             seed=seed, n_classes=n_classes)


def _ref_params(cfg_ref, d_in, seed=0):
    p = ref_gnn.init_gnn(cfg_ref, d_in, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.array, p)


def test_configs_match_reference():
    assert "gcn-cora" in list_archs()
    for smoke in (False, True):
        ref, got = (ref_get_arch("gcn-cora", smoke=smoke),
                    get_arch("gcn-cora", smoke=smoke))
        assert isinstance(got, GNNConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.param_count() == ref.param_count()
    assert dataclasses.asdict(GNNConfig()) == dataclasses.asdict(
        type(ref_get_arch("gcn-cora"))())
    # the port's ShapeSpec keeps the GNN and recsys fields; the reference's
    # LM fields stay at their defaults on the GNN shapes
    kept = [f.name for f in dataclasses.fields(GNN_SHAPES[0])]
    ref_shapes = [dataclasses.asdict(s) for s in REF_GNN_SHAPES]
    assert ([dataclasses.asdict(s) for s in GNN_SHAPES]
            == [{k: s[k] for k in kept} for s in ref_shapes])
    unset = dataclasses.asdict(REF_GNN_SHAPES[0].__class__("", ""))
    assert all(s[k] == unset[k] for s in ref_shapes for k in s
               if k not in kept)


@pytest.mark.parametrize("shape_name", ["full_graph_sm", "ogb_products-cut",
                                        "molecule"])
def test_batches_equal_reference(shape_name):
    """Byte-identical arrays for seeds 0 and 3; ``ogb_products`` with its
    node and edge counts cut to 5,000 and 60,000 (its d_feat, 100, kept)."""
    for seed in (0, 3):
        if shape_name == "molecule":
            got = pipeline.gnn_molecule_batch(None, SHAPES["molecule"],
                                              seed=seed)
            want = _batch("molecule", seed)
        else:
            name = shape_name.split("-")[0]
            shape, ref_shape = SHAPES[name], REF_SHAPES[name]
            if shape_name.endswith("-cut"):
                shape = dataclasses.replace(shape, n_nodes=5000,
                                            n_edges=60_000)
                ref_shape = dataclasses.replace(ref_shape, n_nodes=5000,
                                                n_edges=60_000)
            got = pipeline.gnn_full_graph_batch(None, shape, seed=seed)
            want = ref_pipeline.gnn_full_graph_batch(None, ref_shape,
                                                     seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_params_carried_across_and_checked():
    cfg, cfg_ref = get_arch("gcn-cora"), ref_get_arch("gcn-cora")
    p_np = _ref_params(cfg_ref, 1433)
    p = gnn_params_from_reference(p_np, cfg, device="cpu")
    assert len(p["layers"]) == 2
    for lp, lp_np in zip(p["layers"], p_np["layers"]):
        for k in ("w", "b"):
            assert lp[k].dtype == torch.float32
            np.testing.assert_array_equal(lp[k].numpy(), lp_np[k])
    assert tuple(p["layers"][0]["w"].shape) == (1433, 16)
    assert tuple(p["layers"][1]["w"].shape) == (16, 7)
    bad = jax.tree_util.tree_map(lambda a: a, p_np)
    bad["layers"][1]["w"] = bad["layers"][1]["w"][:, :6]
    with pytest.raises(ValueError, match=r"layers\[1\]\.w"):
        gnn_params_from_reference(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        gnn_params_from_reference({"layers": p_np["layers"][:1]}, cfg,
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="gcn"):
        gnn_params_from_reference(p_np, dataclasses.replace(
            cfg, kind="gatedgcn"), device="cpu")


def test_init_gnn_on_the_generator_device():
    cfg = get_arch("gcn-cora")
    gen = torch.Generator().manual_seed(0)
    p = gnn.init_gnn(cfg, 1433, gen)
    again = gnn.init_gnn(cfg, 1433, torch.Generator().manual_seed(0))
    assert [tuple(lp["w"].shape) for lp in p["layers"]] == [(1433, 16),
                                                           (16, 7)]
    for lp, lq in zip(p["layers"], again["layers"]):
        assert lp["w"].dtype == torch.float32
        assert torch.equal(lp["w"], lq["w"])
        assert torch.equal(lp["b"], torch.zeros_like(lp["b"]))
    # the reference's scale: normal * fan_in^-0.5
    w = p["layers"][0]["w"]
    assert abs(float(w.std()) * 1433 ** 0.5 - 1.0) < 0.02
    for kind in gnn.UNPORTED_KINDS:
        with pytest.raises(NotImplementedError, match="runs gcn"):
            gnn.init_gnn(dataclasses.replace(cfg, kind=kind), 8, gen)
    with pytest.raises(ValueError):
        gnn.init_gnn(dataclasses.replace(cfg, kind="nope"), 8, gen)


def _ref_norm(b, norm):
    """The reference's own lines of ``gcn_forward`` (``deg``, ``coeff``)."""
    src, dst = jnp.asarray(b["src"]), jnp.asarray(b["dst"])
    n = b["x"].shape[0]
    ones = jnp.ones_like(src, jnp.float32)
    deg = jax.ops.segment_sum(ones, dst, num_segments=n) + 1.0
    if norm == "sym":
        coeff = jax.lax.rsqrt(deg[src]) * jax.lax.rsqrt(deg[dst])
    else:
        coeff = 1.0 / deg[dst]
    return np.array(deg), np.array(coeff), np.array(1.0 / deg)


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("norm", ["sym", "none"])
@pytest.mark.parametrize("shape_name", ["full_graph_sm", "molecule"])
def test_degrees_and_coefficients(shape_name, norm):
    b = _batch(shape_name)
    graph = gnn.resident_graph(b, device="cpu")
    layout = graph["layout"]
    deg, coeff, self_coeff = gnn.gcn_norm(layout, norm)
    deg_r, coeff_r, self_r = _ref_norm(b, norm)
    assert deg.dtype == coeff.dtype == torch.float32
    assert deg.numpy().tobytes() == deg_r.tobytes()
    assert self_coeff.numpy().tobytes() == self_r.tobytes()
    want = coeff_r[layout.perm.numpy()]
    if norm == "sym":
        # each factor rsqrt(deg) within 2 ulp of XLA's (relative 2^-22), so
        # their product within 2 * 2^-22 plus the two products' roundings
        f = torch.rsqrt(deg).numpy()
        assert _ulps(f, np.array(jax.lax.rsqrt(jnp.asarray(deg_r)))
                     ).max() <= 2
        rel = np.abs(coeff.numpy().astype(np.float64) - want) / want
        assert rel.max() <= 2.0 ** -21 + 2.0 ** -23
    else:
        assert coeff.numpy().tobytes() == want.tobytes()


def test_rsqrt_differs_by_at_most_two_ulp():
    """Why the coefficients are held to 2 ulp and not bit for bit: the
    integer degrees 1-49,999, through XLA's and torch's float32 rsqrt."""
    d = np.arange(1, 50_000, dtype=np.float32)
    got = torch.rsqrt(torch.from_numpy(d)).numpy()
    want = np.array(jax.lax.rsqrt(jnp.asarray(d)))
    ulps = _ulps(got, want)
    assert ulps.max() <= 2
    assert (ulps > 0).sum() > 1000   # they do differ, often


def test_aggregation_with_the_reference_coefficients():
    """The sum alone: the reference's own coefficients injected, one
    aggregation at d_hidden = 16 on ``full_graph_sm``."""
    b = _batch("full_graph_sm")
    n = b["x"].shape[0]
    graph = gnn.resident_graph(b, device="cpu")
    layout = graph["layout"]
    _, coeff_r, _ = _ref_norm(b, "sym")
    h = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    want = np.array(jax.ops.segment_sum(
        jnp.asarray(h)[b["src"]] * jnp.asarray(coeff_r)[:, None],
        jnp.asarray(b["dst"]), num_segments=n))
    th, tc = torch.from_numpy(h), torch.from_numpy(coeff_r)
    got = segment_mm_csr(th, layout, tc[layout.perm])
    assert rule_excess(got, torch.from_numpy(want), th, graph["src"],
                       graph["dst"], tc, n) <= 1.0


def _loss_tol(allow, logits_ref, graph, kind):
    """How far the loss can move when each logit moves by at most its
    allowance ``allow`` [N, C], plus 2^-16 of the loss for its own float32
    reduction. Cross entropy: ``lse - gold`` moves by at most twice the
    row's largest allowance. MSE of the per-graph means p: by at most
    ``mean(2 |p - t| a + a^2)``, a the mean allowance pooled alike."""
    if kind == "node":
        return 2 * float(allow.max(dim=1).values.mean())
    gid = graph["graph_id"].long()
    ng = graph["targets"].shape[0]
    cnt = torch.bincount(gid, minlength=ng).clamp_min(1)[:, None]
    a = torch.zeros(ng, allow.shape[1], dtype=allow.dtype).index_add_(
        0, gid, allow) / cnt
    p = torch.zeros(ng, allow.shape[1], dtype=allow.dtype).index_add_(
        0, gid, logits_ref.double()) / cnt
    gap = (p - graph["targets"].double()).abs()
    return float((2 * gap * a + a * a).mean())


@pytest.mark.parametrize("norm", ["sym", "none"])
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("shape_name", ["full_graph_sm", "molecule"])
def test_forward_and_losses_match_reference(shape_name, smoke, norm):
    cfg = dataclasses.replace(get_arch("gcn-cora", smoke=smoke), norm=norm)
    cfg_ref = dataclasses.replace(ref_get_arch("gcn-cora", smoke=smoke),
                                  norm=norm)
    b = _batch(shape_name, n_classes=cfg.d_out)
    d_in = b["x"].shape[1]
    p_np = _ref_params(cfg_ref, d_in, seed=1)
    params = gnn_params_from_reference(p_np, cfg, device="cpu")
    graph = gnn.resident_graph(b, device="cpu")
    ref_graph = {k: jnp.asarray(v) for k, v in b.items()}

    before = smod.segment_mm_cuda.launches
    logits = gnn.gnn_forward(params, graph, cfg)
    assert smod.segment_mm_cuda.launches == before
    want = torch.from_numpy(np.array(ref_gnn.gnn_forward(p_np, ref_graph,
                                                         cfg_ref)))
    assert logits.shape == want.shape == (b["x"].shape[0], cfg.d_out)
    assert bool(torch.isfinite(logits).all())

    layout = graph["layout"]
    _, coeff, self_coeff = gnn.gcn_norm(layout, norm)
    mag = chain_magnitude(params, graph["x"], layout.col, layout.row, coeff,
                          self_coeff)
    widths = [d_in, cfg.d_hidden]
    max_deg = int(layout.in_degree().max())
    assert chain_excess(logits, want, mag, widths, max_deg) <= 1.0
    # a prebuilt layout changes nothing; neither does impl="ref" on the CPU
    no_layout = {k: v for k, v in graph.items() if k != "layout"}
    assert torch.equal(gnn.gnn_forward(params, no_layout, cfg), logits)
    assert torch.equal(gnn.gnn_forward(params, graph, cfg, impl="ref"),
                       logits)

    allow = 16 * U * max(max(widths), max_deg + 1) ** 0.5 * mag.double()
    if shape_name == "molecule":
        got = gnn.graph_regression_loss(params, graph, cfg)
        ref = float(ref_gnn.graph_regression_loss(p_np, ref_graph, cfg_ref))
        tol = _loss_tol(allow, want, graph, "graph")
    else:
        got = gnn.node_classification_loss(params, graph, cfg)
        ref = float(ref_gnn.node_classification_loss(p_np, ref_graph,
                                                     cfg_ref))
        tol = _loss_tol(allow, want, graph, "node")
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - ref) <= tol + 2.0 ** -16 * abs(ref)


def test_node_loss_masks_labels_and_seed_slots():
    """Labels < 0 are masked, and a minibatch's ``seed_slots`` pick the
    rows the loss is taken on, as in the reference."""
    cfg, cfg_ref = get_arch("gcn-cora", smoke=True), ref_get_arch(
        "gcn-cora", smoke=True)
    b = _batch("full_graph_sm", n_classes=cfg.d_out)
    b["labels"][::3] = -1
    b["seed_slots"] = np.arange(0, 2708, 7, dtype=np.int32)
    p_np = _ref_params(cfg_ref, b["x"].shape[1])
    params = gnn_params_from_reference(p_np, cfg, device="cpu")
    graph = gnn.resident_graph(b, device="cpu")
    got = float(gnn.node_classification_loss(params, graph, cfg))
    ref = float(ref_gnn.node_classification_loss(
        p_np, {k: jnp.asarray(v) for k, v in b.items()}, cfg_ref))
    assert abs(got - ref) <= 1e-5 * abs(ref)
    del graph["seed_slots"]
    assert abs(float(gnn.node_classification_loss(params, graph, cfg))
               - got) > 1e-4


@pytest.mark.parametrize("kind", gnn.UNPORTED_KINDS)
def test_unported_kinds_raise(kind):
    cfg = dataclasses.replace(get_arch("gcn-cora", smoke=True), kind=kind)
    graph = gnn.resident_graph(_batch("molecule"), device="cpu")
    with pytest.raises(NotImplementedError, match="runs gcn"):
        gnn.gnn_forward({}, graph, cfg)
    with pytest.raises(NotImplementedError, match="runs gcn"):
        gnn.graph_regression_loss({}, graph, cfg)
