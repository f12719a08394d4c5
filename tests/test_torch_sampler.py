"""The port's neighbor sampler (``graph/sampler.py``) against the JAX
package's, and ``data/pipeline.gnn_minibatch_batch``, which fills the
reference's ``minibatch`` cell from it.

  * ``NeighborSampler``: byte for byte the reference's arrays (node ids,
    mask, each block's indices and mask, ``n_dst``, seed slots) for the
    same graph and seed over a sequence of ``sample`` calls (the
    generator's state carries over), on graphs with nodes of in-degree 0,
    fanouts above the degree, repeated seeds and a seed of degree 0; the
    CSR against the reference's (``sorted_by_dst``); ``from_csr`` gives
    the same sampler.
  * ``gnn_minibatch_batch``: its arrays have the reference cell's padded
    shapes and dtypes (``_gnn_cell`` on a one-device mesh, every GNN kind;
    ``minibatch_padding`` equal to them at ``minibatch_lg``), its node
    table and edges follow the documented mapping, a device table gives
    the same arrays as a host one, and its padding is inert: the loss and
    its gradient (float64) do not change when the batch is padded further.
"""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses

import jax

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.config.base import GNN_SHAPES as REF_GNN_SHAPES  # noqa: E402
from repro.config.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.graph.sampler import NeighborSampler as RefSampler  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro_torch.config import GNN_SHAPES, ShapeSpec, get_arch  # noqa: E402
from repro_torch.data.pipeline import (DataCursor,  # noqa: E402
                                       gnn_full_graph_batch,
                                       gnn_minibatch_batch,
                                       minibatch_padding)
from repro_torch.graph.sampler import NeighborSampler  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import gnn_check as gc  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

GNN_ARCHS = ("gcn-cora", "gatedgcn", "meshgraphnet", "equiformer-v2")
TINY = ShapeSpec(name="tiny_mb", kind="minibatch", n_nodes=150, n_edges=900,
                 batch_nodes=6, fanout=(3, 2), d_feat=12)


def _graph(seed, n, e):
    """A random directed graph with nodes 0..n/10 of in-degree 0, one hub
    (node n - 1, a fifth of the edges) and duplicate edges."""
    r = np.random.default_rng(seed)
    src = r.integers(0, n, e).astype(np.int32)
    dst = r.integers(n // 10, n, e).astype(np.int32)
    dst[: e // 5] = n - 1
    src[-20:] = src[:20]
    dst[-20:] = dst[:20]
    return src, dst


def _same_batch(got, want):
    assert got.node_ids.tobytes() == want.node_ids.tobytes()
    assert got.node_ids.dtype == want.node_ids.dtype
    assert got.node_mask.tobytes() == want.node_mask.tobytes()
    assert got.seed_slots.tobytes() == want.seed_slots.tobytes()
    assert got.seed_slots.dtype == want.seed_slots.dtype
    assert len(got.blocks) == len(want.blocks)
    for a, b in zip(got.blocks, want.blocks):
        for name in ("src_index", "dst_index", "edge_mask"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        assert a.n_dst == b.n_dst


@pytest.mark.parametrize("seed,fanout", [(0, (3, 2)), (1, (15, 10)),
                                         (2, (1,)), (3, (4, 3, 2))])
def test_sampler_byte_identical_to_reference(seed, fanout):
    n, e = 400, 3000
    src, dst = _graph(seed, n, e)
    w = np.ones(e, np.int32)
    ref = RefSampler(RefEdgeList(n, src, dst, w), fanout, seed=seed)
    got = NeighborSampler(EdgeList(n, src, dst, w), fanout, seed=seed)
    assert got.indptr.dtype == ref.indptr.dtype == np.int64
    assert got.indptr.tobytes() == ref.indptr.tobytes()
    assert got.srcs.tobytes() == ref.srcs.tobytes()
    r = np.random.default_rng(100 + seed)
    calls = [r.choice(n, 8, replace=False),          # distinct seeds
             r.integers(0, n, 12),                   # repeats
             np.array([0, 1, n - 1], np.int32),      # degree 0 and the hub
             np.array([5], np.int32)]                # degree 0 alone
    again = NeighborSampler.from_csr(got.indptr, got.srcs, fanout, seed=seed)
    for seeds in calls:
        want = ref.sample(seeds)
        _same_batch(got.sample(seeds), want)
        _same_batch(again.sample(seeds), want)


def _ref_cell_shapes(arch, shape):
    """The reference cell's graph input shapes and dtypes on a one-device
    mesh."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    cell = ref_steps._gnn_cell(ref_get_arch(arch), shape, mesh,
                               RefTrainConfig())
    return {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in cell.arg_specs[2].items()}


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_cell_shapes_equal_reference_and_batch_fills_them(arch):
    """``build_cell``'s ``arg_shapes`` equal the reference cell's at every
    GNN shape (minibatch_lg: 180,224 nodes and 179,200 edges), and a tiny
    ``gnn_minibatch_batch`` fills its cell exactly."""
    cfg = get_arch(arch)
    for shape, ref_shape in zip(GNN_SHAPES, REF_GNN_SHAPES):
        cell = steps.build_cell(arch, shape.name, device="cpu")
        got = {k: (s, str(d).replace("torch.", ""))
               for k, (s, d) in cell.arg_shapes.items()}
        assert got == _ref_cell_shapes(arch, ref_shape), shape.name
    lg = {s.name: s for s in GNN_SHAPES}["minibatch_lg"]
    assert minibatch_padding(lg) == (180_224, 179_200)
    small = get_arch(arch, smoke=True)
    full = gnn_full_graph_batch(small, TINY, seed=0, n_classes=small.d_out)
    sampler = NeighborSampler(EdgeList(TINY.n_nodes, full["src"],
                                       full["dst"],
                                       np.ones(TINY.n_edges, np.int32)),
                              TINY.fanout, seed=0)
    b = gnn_minibatch_batch(small, TINY, sampler, full, DataCursor(step=3))
    cell = steps._gnn_cell(small, TINY, torch.device("cpu"))
    assert sorted(b) == sorted(cell.arg_shapes)
    for k, (s, d) in cell.arg_shapes.items():
        assert (b[k].shape, b[k].dtype.name) == (s, str(d)[6:]), k
    assert cfg.kind == small.kind


def test_minibatch_mapping():
    """Seeds from the step's generator, the sampled nodes first in id
    order, padding rows zero with label -1, both blocks' edges deepest
    first, self-loops on the last padding node, ``e`` drawn after the
    seeds; a device table gives the same arrays."""
    cfg = get_arch("gatedgcn", smoke=True)
    full = gnn_full_graph_batch(cfg, TINY, seed=0, n_classes=cfg.d_out)
    edges = EdgeList(TINY.n_nodes, full["src"], full["dst"],
                     np.ones(TINY.n_edges, np.int32))
    cur = DataCursor(step=2, shard=1)
    b = gnn_minibatch_batch(cfg, TINY, NeighborSampler(edges, TINY.fanout),
                            full, cur, seed=5)
    r = np.random.default_rng(np.random.SeedSequence([5, 1, 2])
                              .generate_state(4))
    seeds = r.choice(TINY.n_nodes, TINY.batch_nodes, replace=False)
    sb = NeighborSampler(edges, TINY.fanout).sample(seeds)
    n_real = int(sb.node_mask.sum())
    ids = sb.node_ids[:n_real]
    assert np.array_equal(b["x"][:n_real], full["x"][ids])
    assert not b["x"][n_real:].any() and (b["labels"][n_real:] == -1).all()
    assert np.array_equal(b["labels"][:n_real], full["labels"][ids])
    real = [(blk.src_index[blk.edge_mask], blk.dst_index[blk.edge_mask])
            for blk in sb.blocks]
    n_e = sum(len(s) for s, _ in real)
    assert np.array_equal(b["src"][:n_e], np.concatenate([s for s, _ in
                                                          real]))
    assert np.array_equal(b["dst"][:n_e], np.concatenate([d for _, d in
                                                          real]))
    pad_n, pad_e = minibatch_padding(TINY)
    assert (b["src"][n_e:] == pad_n - 1).all()
    assert (b["dst"][n_e:] == pad_n - 1).all() and n_e < pad_e
    assert np.array_equal(b["seed_slots"], sb.seed_slots)
    assert np.array_equal(b["e"], r.standard_normal((pad_e, 1)).astype(
        np.float32))
    eq = get_arch("equiformer-v2", smoke=True)
    table = {k: torch.from_numpy(full[k]) for k in ("x", "labels", "pos")}
    on_dev = gnn_minibatch_batch(eq, TINY, NeighborSampler(edges,
                                                           TINY.fanout),
                                 table, cur, seed=5)
    host = gnn_minibatch_batch(eq, TINY, NeighborSampler(edges, TINY.fanout),
                               full, cur, seed=5)
    for k in host:
        assert np.array_equal(np.asarray(on_dev[k]), host[k]), k
    assert not host["pos"][n_real:].any()
    with pytest.raises(ValueError, match="do not fit"):
        gnn_minibatch_batch(cfg, TINY, NeighborSampler(edges, TINY.fanout),
                            full, cur, seed=5, pad=(n_real, pad_e))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_minibatch_padding_is_inert(arch):
    """The float64 loss and every gradient leaf are the same (within
    1e-12 of the leaf's largest magnitude) when the batch is padded to 40
    more nodes and 50 more edges."""
    cfg = get_arch(arch, smoke=True)
    full = gnn_full_graph_batch(cfg, TINY, seed=0, n_classes=cfg.d_out)
    edges = EdgeList(TINY.n_nodes, full["src"], full["dst"],
                     np.ones(TINY.n_edges, np.int32))
    pad_n, pad_e = minibatch_padding(TINY)
    params = gc.as64(gnn.init_gnn(cfg, TINY.d_feat,
                                  torch.Generator().manual_seed(0),
                                  d_edge_in=gnn.GNN_EDGE_DIM.get(cfg.kind,
                                                                 1)))
    out = []
    for pad in ((pad_n, pad_e), (pad_n + 40, pad_e + 50)):
        b = gnn_minibatch_batch(cfg, TINY, NeighborSampler(edges,
                                                           TINY.fanout),
                                full, DataCursor(step=1), pad=pad)
        if "e" in b:       # the same real edge features in both batches
            n_e = int((b["dst"] != pad[0] - 1).sum())
            b["e"][:n_e] = np.random.default_rng(9).standard_normal(
                (n_e, b["e"].shape[1]))
        graph = gc.as64(gnn.resident_graph(b, "cpu", cfg, train=True))
        leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                params)
        loss = gnn.node_classification_loss(leaves, graph, cfg)
        loss.backward()
        out.append((float(loss.detach()), [p.grad for p in
                                  adamw.tree_leaves(leaves)]))
    (l0, g0), (l1, g1) = out
    assert abs(l0 - l1) <= 1e-12 * abs(l0)
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max())
