"""Tests of the port that need the card: the hand-written CUDA edge-relax
kernel and megakernel against their plain PyTorch versions (hubs of
100,000 in- and out-edges, rows at and past the long-row threshold, RMAT
graphs, edge cases; two launches bit for bit equal), the pipeline
on the kernel backend against the plain backend, the fused grow path
against the unfused one in both decomposition modes, the flash
attention kernel against its plain version, alone and inside the
transformer's prefill and decode, the CIN kernel against its plain
version, alone (two launches bit for bit equal), in a stack and inside
xDeepFM's forward and retrieval,
and the segment_mm kernel against its plain version in float64, alone (at
the default piece size and at 32 items, with rows padded to 32 bytes, on
a 39,485-edge hub) and inside the GCN forward (two launches per forward);
CLUSTER2 and the quotient cascade on the kernel backend against the plain
backend; pooled sessions (a padded row 0 past the long-row threshold)
against unpooled ones, fused and not; an autotuned session (fuse 8 from
its record) against the same session unfused; dynamic updates on the
kernel backend (``KernelBackend.rebind`` after a scatter and after a
capacity growth, fused and not, and a confined regrow whose frozen set is
every alive node) against the plain backend.
This file imports no JAX, so it runs where only the port is installed:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips where there is no GPU (the kernel has no CPU mode)."""
import numpy as np
import pytest
import torch

import dataclasses
import types

from repro_torch.common import GraphEngineConfig
from repro_torch.config import GNN_SHAPES, get_arch
from repro_torch.core import (CascadeEstimator, ClusterQuotientEstimator,
                              DeltaSteppingEstimator, KernelBackend,
                              SessionPool, SingleDeviceBackend, UpdateBatch,
                              open_session)
from repro_torch.core import dynamic
from repro_torch.graph import road_like, social_like, temporal_trace
from repro_torch.graph.structures import EdgeList
from repro_torch.kernels.cin import kernel as cmod
from repro_torch.kernels.cin.cases import CASES as CIN_CASES
from repro_torch.kernels.cin.cases import (case_inputs, excess,
                                           layer_excess, planted_fault,
                                           pooled_magnitude)
from repro_torch.kernels.cin.ops import cin, cin_layer
from repro_torch.kernels.cin.ref import cin_layer_ref
from repro_torch.kernels.edge_relax import kernel as kmod
from repro_torch.kernels.edge_relax import megakernel as mk
from repro_torch.kernels.edge_relax.ops import (build_relax_graph, edge_relax,
                                                edge_relax_plain)
from repro_torch.kernels.flash_attention import kernel as fmod
from repro_torch.kernels.flash_attention.cases import CASES as FLASH_CASES
from repro_torch.kernels.flash_attention.cases import (bf16_excess,
                                                       case_kwargs)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.segment_mm import kernel as smod
from repro_torch.kernels.segment_mm.cases import CASES as SEGMM_CASES
from repro_torch.kernels.segment_mm.cases import FAULT_CASE as SEGMM_FAULT
from repro_torch.kernels.segment_mm.cases import (chain_excess,
                                                  chain_magnitude,
                                                  drop_one_chunk,
                                                  drop_one_edge, rule_excess)
from repro_torch.kernels.segment_mm.cases import \
    case_inputs as segmm_case_inputs
from repro_torch.kernels.segment_mm.ops import (TILE, CsrLayout, csr_layout,
                                                segment_mm, segment_mm_csr)
from repro_torch.kernels.segment_mm.ref import segment_mm_ref
from repro_torch.data.pipeline import gnn_full_graph_batch
from repro_torch.launch.steps import build_cell
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tf

INF, BIG = 2**31 - 1, 2**30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _planes(n, wmax, seed):
    r = np.random.default_rng(seed)
    d = np.full(n, INF, np.int32)
    live = r.random(n) < 0.3
    d[live] = r.integers(0, min(2 * wmax, BIG), live.sum())
    c = np.full(n, INF, np.int32)
    c[live] = r.integers(0, n, live.sum())
    p = np.full(n, INF, np.int32)
    p[live] = d[live]
    rw0 = np.full(n, BIG, np.int32)
    cov = (r.random(n) < 0.3) & ~live
    rw0[cov] = r.integers(-wmax, 1, cov.sum())
    rc = np.full(n, INF, np.int32)
    rc[cov] = r.integers(0, n, cov.sum())
    rp = np.full(n, INF, np.int32)
    rp[cov] = r.integers(0, min(4 * wmax, BIG), cov.sum())
    return d, c, p, rw0, rc, rp


@pytest.mark.parametrize("n,wmax", [(1, 7), (257, 7), (257, 2**30 - 1),
                                    (5000, 100), (20000, 2**30 - 1)])
def test_kernel_matches_plain_random(cuda_device, n, wmax):
    r = np.random.default_rng(n)
    e = 6 * n
    src = r.integers(0, n, e).astype(np.int32)
    dst = r.integers(0, max(n - n // 20, 1), e).astype(np.int32)
    w = r.integers(1, wmax + 1, e).astype(np.int32)
    g = build_relax_graph(src, dst, w, n, cuda_device)
    tp = [torch.from_numpy(x).to(cuda_device) for x in _planes(n, wmax, n)]
    for delta in (1, int(r.integers(1, min(2 * wmax, BIG))), BIG):
        before = kmod.edge_relax_cuda.launches
        out = edge_relax(tp, g, delta)
        torch.cuda.synchronize()
        assert kmod.edge_relax_cuda.launches == before + 1
        for a, b in zip(out, edge_relax_plain(tp, g, delta)):
            assert torch.equal(a, b)


def test_kernel_matches_plain_rmat_hubs(cuda_device):
    e = social_like(12, seed=3)
    g = build_relax_graph(e.src, e.dst, e.weight, e.n_nodes, cuda_device)
    wmax = int(e.weight.max())
    tp = [torch.from_numpy(x).to(cuda_device)
          for x in _planes(e.n_nodes, wmax, 4)]
    out = edge_relax(tp, g, wmax)
    for a, b in zip(out, edge_relax_plain(tp, g, wmax)):
        assert torch.equal(a, b)


def test_kernel_rejects_bad_inputs(cuda_device):
    g = build_relax_graph(np.array([0], np.int32), np.array([1], np.int32),
                          np.array([3], np.int32), 2, cuda_device)
    planes = [torch.zeros(2, dtype=torch.int32, device=cuda_device)] * 6
    with pytest.raises(ValueError, match="int32"):
        edge_relax(planes[:5] + [planes[5].to(torch.int64)], g, 4)
    with pytest.raises(ValueError, match="delta"):
        edge_relax(planes, g, 0)
    bad = dataclasses.replace(g)
    bad.long_rows = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        kmod.edge_relax_cuda(planes, bad, 4)
    bad.long_rows = g.long_rows.to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        kmod.edge_relax_cuda(planes, bad, 4)


@pytest.mark.parametrize("make", [lambda: road_like(3000, seed=1),
                                  lambda: social_like(11, seed=2)])
def test_pipeline_kernel_equals_single_on_card(cuda_device, make):
    e = make()
    kmod.edge_relax_cuda.launches = 0
    rk = ClusterQuotientEstimator().estimate(
        open_session(e, backend="kernel", tau=4, device=cuda_device))
    assert kmod.edge_relax_cuda.launches == rk.pipeline.kernel_launches > 0
    rs = ClusterQuotientEstimator().estimate(
        open_session(e, backend="single", tau=4, device=cuda_device))
    np.testing.assert_array_equal(rk.decomposition.final_c,
                                  rs.decomposition.final_c)
    np.testing.assert_array_equal(rk.decomposition.final_pathw,
                                  rs.decomposition.final_pathw)
    assert rk.phi_approx == rs.phi_approx and rk.connected


@pytest.mark.parametrize("fuse", [0, 8])
def test_cluster2_kernel_equals_single_on_card(cuda_device, fuse):
    """CLUSTER2 on RMAT social_like(14): every grow of the base CLUSTER and
    of the complete-variant stages (num_it = 4n) through edge_relax or the
    megakernel, byte-identical to the plain backend on the card."""
    e = social_like(14, seed=0)
    kmod.edge_relax_cuda.launches = 0
    kmod.megakernel_cuda.launches = 0
    est = ClusterQuotientEstimator(use_cluster2=True)
    rk = est.estimate(open_session(e, GraphEngineConfig(fuse_supersteps=fuse),
                                   tau=4, device=cuda_device))
    counted = (kmod.megakernel_cuda.launches if fuse
               else kmod.edge_relax_cuda.launches)
    assert counted == rk.pipeline.kernel_launches > 0
    rs = est.estimate(open_session(e, backend="single", tau=4,
                                   device=cuda_device))
    for f in ("final_c", "final_pathw"):
        np.testing.assert_array_equal(getattr(rk.decomposition, f),
                                      getattr(rs.decomposition, f))
    assert (rk.phi_approx, rk.growing_steps) == (rs.phi_approx,
                                                 rs.growing_steps)


@pytest.mark.parametrize("level_mode", ["stages", "oneshot"])
def test_cascade_kernel_equals_single_on_card(cuda_device, level_mode):
    """The cascade on RMAT social_like(14): level 0 through edge_relax,
    the levels on the plain backend over the card's level arrays; the same
    Phi, level lists and solve as the plain backend."""
    e = social_like(14, seed=0)
    est = CascadeEstimator(levels=2, tau_solve=32, level_mode=level_mode)
    cfg = GraphEngineConfig(deterministic=True)
    kmod.edge_relax_cuda.launches = 0
    rk = est.estimate(open_session(e, cfg, device=cuda_device))
    assert kmod.edge_relax_cuda.launches == rk.pipeline.kernel_launches > 0
    rs = est.estimate(open_session(e, cfg, backend="single",
                                   device=cuda_device))
    pk, ps = rk.pipeline, rs.pipeline
    assert pk.cascade_levels >= 1
    assert (rk.phi_approx, pk.level_clusters, pk.level_supersteps,
            pk.solve_supersteps) == (rs.phi_approx, ps.level_clusters,
                                     ps.level_supersteps, ps.solve_supersteps)
    np.testing.assert_array_equal(rk.quotient_ecc, rs.quotient_ecc)


@pytest.mark.parametrize("fuse", [0, 8])
def test_pooled_equals_unpooled_on_card(cuda_device, fuse):
    """Pooled sessions on road_like(65_536): the graph with 5,000 edges
    fewer is padded by 5,000 self-loops at node 0, so row 0 is a long row
    (a block's in edge_relax, a hub marked by a block in the megakernel);
    every field equals the unpooled estimate, and the SSSP estimators read
    the padded CSR to the same distances."""
    a = road_like(65_536, seed=0)
    keep = np.sort(np.random.default_rng(1).permutation(a.n_edges)
                   [:a.n_edges - 5000])
    b = EdgeList(a.n_nodes, a.src[keep], a.dst[keep], a.weight[keep])
    cfg = GraphEngineConfig(fuse_supersteps=fuse)
    kmod.edge_relax_cuda.launches = 0
    kmod.megakernel_cuda.launches = 0
    with SessionPool(cfg, device=cuda_device) as pool:
        pooled = pool.estimate_many([a, b], tau=16)
        padded = pool.open(b, tau=16, e_pad=a.n_edges)
        assert 0 in padded.backend.graph.long_rows.tolist()
        sssp_padded = padded.estimate(DeltaSteppingEstimator(seed=3))
    counted = (kmod.megakernel_cuda.launches if fuse
               else kmod.edge_relax_cuda.launches)
    assert counted >= sum(p.pipeline.kernel_launches for p in pooled) > 0
    for g, p in zip((a, b), pooled):
        solo = open_session(g, cfg, tau=16, device=cuda_device)
        s = solo.estimate()
        for f in ("phi_approx", "phi_quotient", "radius", "n_clusters",
                  "growing_steps", "n_stages", "delta_end", "connected"):
            assert getattr(p, f) == getattr(s, f), f
        assert p.pipeline.kernel_launches == s.pipeline.kernel_launches
        np.testing.assert_array_equal(p.decomposition.final_c,
                                      s.decomposition.final_c)
        np.testing.assert_array_equal(p.decomposition.final_pathw,
                                      s.decomposition.final_pathw)
        if g is b:
            d = solo.estimate(DeltaSteppingEstimator(seed=3))
            np.testing.assert_array_equal(d.dist, sssp_padded.dist)


def test_autotuned_fused_session_equals_unfused_on_card(cuda_device):
    """An autotuned session on the card takes fuse 8 from its record; the
    same session with a prebuilt unfused backend (which pins fuse 0) gives
    the same estimate through edge_relax."""
    e = road_like(65_536, seed=2)
    fused = open_session(e, device=cuda_device, autotune="auto")
    assert fused.tuning.fuse == 8 and fused.backend.fuse == 8
    unfused = open_session(e, backend=KernelBackend(e, cuda_device, fuse=0),
                           autotune="auto")
    assert unfused.tuning == fused.tuning and unfused.backend.fuse == 0
    kmod.megakernel_cuda.launches = 0
    rf = fused.estimate()
    assert kmod.megakernel_cuda.launches == rf.pipeline.kernel_launches > 0
    kmod.edge_relax_cuda.launches = 0
    ru = unfused.estimate()
    assert kmod.edge_relax_cuda.launches == ru.pipeline.kernel_launches > 0
    assert rf.method == ru.method
    for f in ("phi_approx", "radius", "n_clusters", "growing_steps",
              "n_stages", "connected"):
        assert getattr(rf, f) == getattr(ru, f), f
    assert rf.pipeline.level_clusters == ru.pipeline.level_clusters
    np.testing.assert_array_equal(rf.decomposition.final_c,
                                  ru.decomposition.final_c)


def _fused_inputs(e, dev, seed):
    """Random engine-like planes on ``e``'s CSR, a frozen mask (relays and
    some centers) and a random frontier."""
    r = np.random.default_rng(seed)
    g = build_relax_graph(e.src, e.dst, e.weight, e.n_nodes, dev)
    wmax = int(e.weight.max())
    d, c, p, rw0, rc, rp = (torch.from_numpy(x).to(dev)
                            for x in _planes(e.n_nodes, wmax, seed))
    frozen = (rw0 < BIG) | torch.from_numpy(r.random(e.n_nodes) < 0.02).to(dev)
    front = torch.from_numpy(
        (r.random(e.n_nodes) < 0.5).astype(np.uint8)).to(dev)
    return g, (d, c, p), (rw0, rc, rp), frozen, front, wmax


def _random_graph(n, wmax, seed):
    r = np.random.default_rng(seed)
    src = r.integers(0, n, 6 * n).astype(np.int32)
    dst = r.integers(0, max(n - n // 20, 1), 6 * n).astype(np.int32)
    w = r.integers(1, wmax + 1, 6 * n).astype(np.int32)
    return EdgeList(n, src, dst, w)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("variant", ["stop", "complete"])
@pytest.mark.parametrize("graph", ["random", "rmat"])
def test_megakernel_matches_plain(cuda_device, graph, variant, k):
    e = (_random_graph(5000, 2**30 - 1, 5) if graph == "random"
         else social_like(12, seed=3))
    g, planes, relay, frozen, front, wmax = _fused_inputs(e, cuda_device, 6)
    delta = min(2 * wmax, BIG)
    reached0 = int(((~frozen) & (planes[0] < delta)).sum())
    params = mk.MegaParams(delta, reached0 + 40, 4 * e.n_nodes, 0,
                           int(variant == "stop"))
    before = kmod.megakernel_cuda.launches
    out = mk.fused_grow_supersteps(planes, relay, frozen, front, g, params, k)
    torch.cuda.synchronize()
    assert kmod.megakernel_cuda.launches == before + 1
    want = mk.fused_grow_supersteps_plain(planes, relay, frozen, front, g,
                                          params, k)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert int(out[4][k, mk.COL_EXECUTED]) >= 1


@pytest.mark.parametrize("mode", ["stages", "oneshot"])
def test_fused_decomposition_equals_unfused_on_card(cuda_device, mode):
    e = road_like(65_536, seed=0)
    res = {}
    for fuse in (0, 8):
        cfg = GraphEngineConfig(mode=mode, deterministic=True,
                                fuse_supersteps=fuse)
        kmod.megakernel_cuda.launches = 0
        res[fuse] = ClusterQuotientEstimator().estimate(
            open_session(e, cfg, device=cuda_device))
        assert kmod.megakernel_cuda.launches == (
            res[fuse].pipeline.kernel_launches if fuse else 0)
    assert res[8].pipeline.kernel_launches > 0
    assert res[8].pipeline.kernel_supersteps == res[8].growing_steps
    for f in ("final_c", "final_pathw"):
        np.testing.assert_array_equal(getattr(res[0].decomposition, f),
                                      getattr(res[8].decomposition, f))
    assert res[0].phi_approx == res[8].phi_approx


def _hold_relax(g, tp, delta):
    """edge_relax on the card, launched twice: exactly one launch each,
    both bit-identical, and equal to the plain version."""
    outs = []
    for _ in range(2):
        before = kmod.edge_relax_cuda.launches
        outs.append(edge_relax(tp, g, delta))
        torch.cuda.synchronize()
        assert kmod.edge_relax_cuda.launches == before + 1
    for a, b, c in zip(*outs, edge_relax_plain(tp, g, delta)):
        assert torch.equal(a, b) and torch.equal(a, c)
    return outs[0]


def _hold_mega(g, planes, relay, frozen, front, params, k):
    """The megakernel launched twice: bit-identical, and every output (the
    planes, the frontier and the whole stats array) equal to the plain
    version's."""
    outs = []
    for _ in range(2):
        before = kmod.megakernel_cuda.launches
        outs.append(mk.fused_grow_supersteps(planes, relay, frozen, front, g,
                                             params, k))
        torch.cuda.synchronize()
        assert kmod.megakernel_cuda.launches == before + 1
    want = mk.fused_grow_supersteps_plain(planes, relay, frozen, front, g,
                                          params, k)
    for a, b, c in zip(*outs, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    return outs[0]


def _star(hub_in: bool, hub_out: bool, leaves: int = 100_000):
    """Node 0 a hub of ``leaves`` in-edges (from nodes 2..) and/or
    out-edges (to nodes 2..); node 1 feeds it, so node 0 changes in the
    first superstep (a live source at d 0) and then relaxes its out-list."""
    leaf = np.arange(2, leaves + 2, dtype=np.int32)
    src, dst = [np.array([1], np.int32)], [np.array([0], np.int32)]
    if hub_in:
        src.append(leaf)
        dst.append(np.zeros(leaves, np.int32))
    if hub_out:
        src.append(np.zeros(leaves, np.int32))
        dst.append(leaf)
    src, dst = np.concatenate(src), np.concatenate(dst)
    w = np.random.default_rng(leaves).integers(1, 9, src.shape[0]).astype(
        np.int32)
    return EdgeList(leaves + 2, src, dst, w)


def _star_state(e, dev, front_all: bool):
    n = e.n_nodes
    r = np.random.default_rng(1)
    d = np.full(n, INF, np.int32)
    d[1] = 0
    d[2::7] = r.integers(0, 40, d[2::7].shape[0])   # some live leaves
    c = np.where(d < INF, np.arange(n, dtype=np.int32), INF).astype(np.int32)
    p = d.copy()
    rw0 = np.full(n, BIG, np.int32)
    rw0[3::11] = -r.integers(0, 5, rw0[3::11].shape[0])   # some relays
    rc = np.where(rw0 < BIG, 7, INF).astype(np.int32)
    rp = np.where(rw0 < BIG, 3, INF).astype(np.int32)
    to = lambda x: torch.from_numpy(x).to(dev)   # noqa: E731
    frozen = to(rw0 < BIG) | to(r.random(n) < 0.01)
    frozen[0] = False
    front = (torch.ones(n, dtype=torch.uint8, device=dev) if front_all
             else to((np.arange(n) == 1).astype(np.uint8)))
    return (to(d), to(c), to(p)), (to(rw0), to(rc), to(rp)), frozen, front


@pytest.mark.parametrize("front_all", [False, True])
@pytest.mark.parametrize("hub", ["in", "out", "both"])
def test_kernels_on_a_100k_edge_hub(cuda_device, hub, front_all):
    """A star: node 0 with 100,000 in-edges (scanned by a whole block),
    100,000 out-edges (marked by a whole block when it changes), or both;
    both kernels at K = 1, 8 and 64 against their plain versions."""
    e = _star(hub in ("in", "both"), hub in ("out", "both"))
    g = build_relax_graph(e.src, e.dst, e.weight, e.n_nodes, cuda_device)
    assert g.long_rows.tolist() == ([0] if hub != "out" else [])
    out_ptr = g.out_csr()[0]
    assert int(out_ptr[1] - out_ptr[0]) == (100_000 if hub != "in" else 0)
    planes, relay, frozen, front = _star_state(e, cuda_device, front_all)
    _hold_relax(g, [*planes, *relay], 64)
    reached0 = int(((~frozen) & (planes[0] < 64)).sum())
    for k in (1, 8, 64):
        for stop in (0, 1):
            out = _hold_mega(g, planes, relay, frozen, front,
                             mk.MegaParams(64, reached0 + 500 if stop else 0,
                                           4 * e.n_nodes, 0, stop), k)
            assert int(out[0][0]) < INF            # the hub changed
    if hub != "in":   # its out-list relaxed in the second superstep
        out = _hold_mega(g, planes, relay, frozen, front,
                         mk.MegaParams(64, 0, 100, 0, 0), 2)
        assert int(out[4][1, mk.COL_CHANGED]) > 10_000


def _rows_of_degree(degrees, seed):
    """Row i has exactly degrees[i] in-edges and node i as many
    out-edges, from and to random nodes of a 50-node tail."""
    r = np.random.default_rng(seed)
    n = len(degrees) + 50
    dst = np.repeat(np.arange(len(degrees)), degrees).astype(np.int32)
    src = r.integers(len(degrees), n, dst.shape[0]).astype(np.int32)
    src2 = np.repeat(np.arange(len(degrees)), degrees).astype(np.int32)
    dst2 = r.integers(len(degrees), n, src2.shape[0]).astype(np.int32)
    src, dst = np.concatenate([src, src2]), np.concatenate([dst, dst2])
    w = r.integers(1, 20, src.shape[0]).astype(np.int32)
    return EdgeList(n, src, dst, w)


def test_rows_at_the_threshold_and_one_past(cuda_device):
    """Rows of exactly ``LONG_ROW`` in- (and out-) edges take the short
    path, rows of ``LONG_ROW + 1`` the block path; both kernels equal their
    plain versions."""
    t = kmod.LONG_ROW
    e = _rows_of_degree([t, t + 1, t - 1, t + 1, t, 2 * t + 3, 1, 0], seed=t)
    g = build_relax_graph(e.src, e.dst, e.weight, e.n_nodes, cuda_device)
    in_deg = (g.row_ptr[1:] - g.row_ptr[:-1]).cpu()
    assert sorted(g.long_rows.tolist()) == torch.nonzero(
        in_deg > t).flatten().tolist()
    assert 1 in g.long_rows.tolist() and 0 not in g.long_rows.tolist()
    planes, relay, frozen, front = _fused_inputs(e, cuda_device, 9)[1:5]
    for delta in (1, 40, BIG):
        _hold_relax(g, [*planes, *relay], delta)
    for k in (1, 8):
        _hold_mega(g, planes, relay, frozen, front,
                   mk.MegaParams(40, 0, 1000, 0, 0), k)


@pytest.mark.parametrize("front_frac", [0.5, 0.05])
def test_kernels_when_most_rows_are_hubs(cuda_device, front_frac):
    """1,500 rows of 1,030 out-edges each to random rows (so in-degrees
    straddle the threshold): every row that changes is an out-hub, so the
    megakernel's list of changed hubs fills to most of n in one superstep,
    and about half the rows are scanned by a block. A frontier of half the
    rows runs superstep 0 over every row; one of 5% lists its rows, each an
    out-hub marked by a block."""
    n, deg = 1500, 1030
    r = np.random.default_rng(8)
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = r.integers(0, n, n * deg).astype(np.int32)
    e = EdgeList(n, src, dst, r.integers(1, 50, n * deg).astype(np.int32))
    g, planes, relay, frozen, front, _ = _fused_inputs(e, cuda_device, 8)
    in_deg = (g.row_ptr[1:] - g.row_ptr[:-1]).cpu()
    assert 0.2 * n < g.long_rows.numel() < 0.8 * n
    assert (in_deg <= kmod.LONG_ROW).any()
    front = torch.from_numpy((np.random.default_rng(9).random(n)
                              < front_frac).astype(np.uint8)).to(cuda_device)
    _hold_relax(g, [*planes, *relay], 200)
    for k in (1, 8, 64):
        out = _hold_mega(g, planes, relay, frozen, front,
                         mk.MegaParams(200, 0, 1000, 0, 0), k)
    assert int(out[4][0, mk.COL_CHANGED]) > n // 2


@pytest.mark.parametrize("front_frac", [0.5, 0.05])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("variant", ["stop", "complete"])
@pytest.mark.parametrize("scale", [14, 16])
def test_kernels_on_rmat(cuda_device, scale, variant, k, front_frac):
    """RMAT ``social_like(14)`` and ``(16)`` (skewed in- and out-degrees:
    15 and 117 rows past the threshold each way), with a frontier of half
    the rows (the megakernel's superstep 0 runs over every row) and of 5%
    (from a marked list), both kernels twice each against their plain
    versions, stats included."""
    e = social_like(scale, seed=scale)
    g, planes, relay, frozen, front, wmax = _fused_inputs(e, cuda_device,
                                                          scale)
    front = torch.from_numpy((np.random.default_rng(scale).random(
        e.n_nodes) < front_frac).astype(np.uint8)).to(cuda_device)
    delta = min(2 * wmax, BIG)
    if k == 1 and front_frac == 0.5:
        _hold_relax(g, [*planes, *relay], delta)
    reached0 = int(((~frozen) & (planes[0] < delta)).sum())
    stop = int(variant == "stop")
    _hold_mega(g, planes, relay, frozen, front,
               mk.MegaParams(delta, reached0 + e.n_nodes // 20 if stop else 0,
                             4 * e.n_nodes, 0, stop), k)


@pytest.mark.parametrize("case", ["n1", "edgeless", "empty_front",
                                  "frozen_all", "cap"])
def test_megakernel_edge_cases(cuda_device, case):
    """n = 1; an edgeless graph (the frontier empties at superstep 0); an
    all-zero carried frontier; every row frozen; a num_it cap that leaves
    no superstep to run (the carried frontier comes back as it was)."""
    n = 1 if case == "n1" else 1000
    if case in ("n1", "edgeless"):
        e = EdgeList(n, np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.int32))
    else:
        e = _random_graph(n, 50, 3)
    g = build_relax_graph(e.src, e.dst, e.weight, n, cuda_device)
    d, c, p, rw0, rc, rp = (torch.from_numpy(x).to(cuda_device)
                            for x in _planes(n, 50, 4))
    planes, relay = (d, c, p), (rw0, rc, rp)
    frozen = rw0 < BIG
    front = torch.ones(n, dtype=torch.uint8, device=cuda_device)
    if case == "empty_front":
        front = torch.zeros_like(front)
    if case == "frozen_all":
        frozen = torch.ones_like(frozen)
    steps_base = 100 if case == "cap" else 0
    for k in (1, 8):
        out = _hold_mega(g, planes, relay, frozen, front,
                         mk.MegaParams(60, 0, 100, steps_base, 0), k)
        if case == "cap":
            assert int(out[4][k, mk.COL_EXECUTED]) == 0
            assert torch.equal(out[3], front)


def test_megakernel_rejects_bad_inputs(cuda_device):
    e = _random_graph(300, 50, 2)
    g, planes, relay, frozen, front, _ = _fused_inputs(e, cuda_device, 2)
    args = lambda **kw: dict(dict(   # noqa: E731
        planes=planes, relay=relay, frozen=frozen, front=front, g=g,
        params=(60, 0, 10, 0, 0), k_fused=8), **kw)
    bad = dataclasses.replace(g)
    before = kmod.megakernel_cuda.launches
    with pytest.raises(ValueError, match="k_fused"):
        kmod.megakernel_cuda(**args(k_fused=0))
    with pytest.raises(ValueError, match="bool"):
        kmod.megakernel_cuda(**args(frozen=frozen.to(torch.uint8)))
    bad.long_rows = g.long_rows.to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        kmod.megakernel_cuda(**args(g=bad))
    bad.long_rows = torch.zeros(301, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        kmod.megakernel_cuda(**args(g=bad))
    with pytest.raises(ValueError, match="delta"):
        kmod.megakernel_cuda(**args(params=(0, 0, 10, 0, 0)))
    with pytest.raises(ValueError, match="int32 counts"):
        kmod.megakernel_cuda(**args(k_fused=2**31 // 300))
    assert kmod.megakernel_cuda.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_matches_plain(cuda_device, name, dtype):
    """float32 (the row kernel, with tanhf and expf): 2e-5 absolute and
    relative, from the summation order. bf16: the element-wise bf16 rule of
    ``cases.py`` (one bf16 ulp of the element plus 2^-8 of its row's largest
    value)."""
    case = FLASH_CASES[name]
    B, Hq, Hkv, Sq, Skv, D, *_, qs = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(Sq * 1000 + Skv)
    q = (torch.randn(B, Hq, Sq, D, generator=g, device=cuda_device)
         * qs).to(dt)
    k, v = (torch.randn(B, Hkv, Skv, D, generator=g,
                        device=cuda_device).to(dt) for _ in range(2))
    kw = case_kwargs(case, cuda_device)
    before = fmod.flash_attention_cuda.launches
    out = attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fmod.flash_attention_cuda.launches == before + 1
    want = attention_ref(q, k, v, **kw)
    assert out.dtype == dt and out.shape == want.shape
    if dtype == "float32":
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    else:
        assert bf16_excess(out, want) <= 1.0


def test_flash_attention_strided_views_and_bad_inputs(cuda_device):
    """[B, S, H, D] projections seen as [B, H, S, D] views (the model's
    layout) need no copy; what the kernel does not take raises."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x = torch.randn(2, 70, 4, 64, generator=g, device=cuda_device).to(
        torch.bfloat16)
    kv = torch.randn(2, 70, 2, 64, generator=g, device=cuda_device).to(
        torch.bfloat16)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    out = fmod.flash_attention_cuda(q, k, k, window=16, softcap=50.0)
    want = attention_ref(q.contiguous(), k.contiguous(), k.contiguous(),
                         window=16, softcap=50.0)
    assert bf16_excess(out, want) <= 1.0
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fmod.flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head dim"):
        fmod.flash_attention_cuda(q[..., :60], k[..., :60], k[..., :60])
    # bf16 takes the tensor-core kernel's head dims only
    with pytest.raises(ValueError, match="head dim"):
        fmod.flash_attention_cuda(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(ValueError, match="multiple"):
        fmod.flash_attention_cuda(q[:, :3], k, k)
    with pytest.raises(ValueError, match="kv_len"):
        fmod.flash_attention_cuda(q, k, k, kv_len=[3, 4, 5])


def test_prefill_and_decode_through_the_kernel_on_card(cuda_device):
    """The gemma2 smoke model in bf16 at head dim 64: prefill with the
    kernel equals prefill with the plain attention within bf16 noise (2e-2
    relative L2: the attention outputs differ by bf16 ulps, carried through
    four layers), one launch per layer; decode steps launch nothing."""
    cfg = dataclasses.replace(get_arch("gemma2-9b", smoke=True),
                              dtype="bfloat16", d_head=64)
    params = tf.init_params(cfg, seed=3, device=cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=g,
                         device=cuda_device)
    fmod.flash_attention_cuda.launches = 0
    got = tf.prefill_step(params, toks, cfg)
    torch.cuda.synchronize()
    assert fmod.flash_attention_cuda.launches == cfg.n_layers
    want = tf.prefill_step(params, toks, cfg, attn_impl="ref")
    assert fmod.flash_attention_cuda.launches == cfg.n_layers
    rel = float((got - want).norm() / want.norm())
    assert torch.isfinite(got).all() and rel < 2e-2
    cache = tf.init_cache(cfg, 2, 8, device=cuda_device)
    for i in range(8):
        logits, cache = tf.decode_step(params, cache, toks[:, i:i + 1], cfg)
    assert cache["len"] == 8 and torch.isfinite(logits).all()
    assert fmod.flash_attention_cuda.launches == cfg.n_layers


@pytest.mark.parametrize("name", sorted(CIN_CASES))
def test_cin_layer_matches_plain(cuda_device, name):
    """The float32 rule of ``kernels/cin/cases.py``: ``|o - r| <= 2^-16 A``,
    ``A`` the layer on absolute values (both sides sum the same float32
    products in another order); one launch per call."""
    x0, xk, w = (torch.from_numpy(a).to(cuda_device)
                 for a in case_inputs(CIN_CASES[name]))
    before = cmod.cin_layer_cuda.launches
    out = cin_layer(x0, xk, w)
    torch.cuda.synchronize()
    assert cmod.cin_layer_cuda.launches == before + 1
    want = cin_layer_ref(x0, xk, w)
    assert out.shape == want.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert layer_excess(out, want, x0, xk, w) <= 1.0


def test_cin_rule_rejects_a_planted_fault_on_card(cuda_device):
    B, m, H, H2, D = CIN_CASES["xdeepfm-layer2-B512"]
    x0, xk, w = (torch.from_numpy(a).to(cuda_device)
                 for a in case_inputs((B, m, H, H2, D)))
    ref = cin_layer_ref(x0, xk, w)
    assert layer_excess(cmod.cin_layer_cuda(x0, xk, w), ref, x0, xk,
                        w) <= 1.0
    assert layer_excess(planted_fault(x0, xk, w, h=H // 2), ref, x0, xk,
                        w) > 100.0


@pytest.mark.parametrize("B", [512, 4096])
def test_cin_two_launches_bit_identical(cuda_device, B):
    """xdeepfm's layer 2/3 (m 39, H 200, H2 200, D 10): at B = 512 the
    kernel splits K into parts summed in a fixed order (40 row tiles for
    the card's SMs), at B = 4,096 it does not; either way two launches give
    the same bits, within the rule."""
    x0, xk, w = (torch.from_numpy(a).to(cuda_device)
                 for a in case_inputs((B, 39, 200, 200, 10), seed=1))
    a = cmod.cin_layer_cuda(x0, xk, w)
    b = cmod.cin_layer_cuda(x0, xk, w)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert layer_excess(a, cin_layer_ref(x0, xk, w), x0, xk, w) <= 1.0


def test_cin_stack_and_bad_inputs(cuda_device):
    """xdeepfm's CIN stack (m = 39, D = 10, 200-200-200) at B = 100: the
    pooled features within the rule run through the stack (three
    launches); what the kernel does not take raises."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    x0 = torch.randn(100, 39, 10, generator=g, device=cuda_device) * 0.01
    ws, prev = [], 39
    for hk in (200, 200, 200):
        ws.append(torch.randn(hk, prev, 39, generator=g, device=cuda_device)
                  * (prev * 39) ** -0.5)
        prev = hk
    before = cmod.cin_layer_cuda.launches
    got = cin(x0, ws)
    assert cmod.cin_layer_cuda.launches == before + 3
    want = cin(x0, ws, impl="ref")
    assert cmod.cin_layer_cuda.launches == before + 3
    assert excess(got, want, pooled_magnitude(x0, ws)) <= 1.0
    empty = cmod.cin_layer_cuda(x0[:0], x0[:0], ws[0][:, :, :])
    assert empty.shape == (0, 200, 10)
    with pytest.raises(ValueError, match="float32"):
        cmod.cin_layer_cuda(x0.bfloat16(), x0.bfloat16(), ws[0].bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        cmod.cin_layer_cuda(x0, x0.transpose(1, 2).contiguous().transpose(
            1, 2), ws[0])
    with pytest.raises(ValueError, match="do not agree"):
        cmod.cin_layer_cuda(x0, x0[:, :20], ws[0])
    with pytest.raises(ValueError, match="CUDA"):
        cmod.cin_layer_cuda(x0, x0.cpu(), ws[0])


def test_recsys_cells_through_the_kernel_on_card(cuda_device):
    """xdeepfm's smoke config through ``build_cell``: serve_p99 (B = 512)
    and retrieval (64 candidates) launch the CIN kernel once per layer and
    give the plain path's logits within 1e-6 (the CIN branch adds about
    1e-4 to a logit; its pooled features are held to the rule)."""
    cfg = get_arch("xdeepfm", smoke=True)
    params = recsys.init_params(cfg, seed=2, device=cuda_device)
    cell = build_cell("xdeepfm", "serve_p99", smoke=True,
                      device=cuda_device)
    r = np.random.default_rng(0)
    batch = cell.inputs({
        "ids": r.integers(0, 1000, (512, 6, 2)).astype(np.int32),
        "id_mask": (r.random((512, 6, 2)) < 0.9).astype(np.float32),
        "dense": r.standard_normal((512, 4)).astype(np.float32)})
    cmod.cin_layer_cuda.launches = 0
    got = cell.step_fn(params, batch)
    torch.cuda.synchronize()
    assert cmod.cin_layer_cuda.launches == len(cfg.cin_layers)
    want = cell.step_fn(params, batch, cin_impl="ref")
    assert cmod.cin_layer_cuda.launches == len(cfg.cin_layers)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    emb = recsys.embedding_bag(params["tables"], batch["ids"],
                               batch["id_mask"])
    assert excess(cin(emb, params["cin"]), cin(emb, params["cin"],
                                                impl="ref"),
                  pooled_magnitude(emb, params["cin"])) <= 1.0
    cell = build_cell("xdeepfm", "retrieval_cand", smoke=True,
                      device=cuda_device)
    q = cell.inputs({
        "user_ids": r.integers(0, 1000, (1, 2, 2)).astype(np.int32),
        "user_mask": np.ones((1, 2, 2), np.float32),
        "user_dense": r.standard_normal((1, 4)).astype(np.float32),
        "cand_ids": r.integers(0, 1000, (64, 4, 2)).astype(np.int32),
        "cand_mask": np.ones((64, 4, 2), np.float32)})
    cmod.cin_layer_cuda.launches = 0
    scores = cell.step_fn(params, q)
    assert cmod.cin_layer_cuda.launches == len(cfg.cin_layers)
    torch.testing.assert_close(scores, cell.step_fn(params, q, cin_impl="ref"),
                               rtol=0, atol=1e-6)


def _segmm_case(name, dev):
    x, src, dst, coeff, n = segmm_case_inputs(name)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(src).to(dev),
            torch.from_numpy(dst).to(dev), torch.from_numpy(coeff).to(dev), n)


@pytest.mark.parametrize("tile", [TILE, 32])
@pytest.mark.parametrize("name", sorted(SEGMM_CASES))
def test_segment_mm_matches_plain(cuda_device, name, tile):
    """The float32 rule of ``kernels/segment_mm/cases.py`` against the plain
    version in float64; one launch per call (the fix-up included); two
    launches bit-identical; at tile 32 nearly every row crosses a piece
    boundary and is summed from the carries."""
    x, src, dst, coeff, n = _segmm_case(name, cuda_device)
    layout = csr_layout(src, dst, n, tile=tile)
    cs = coeff[layout.perm]
    before = smod.segment_mm_cuda.launches
    out = segment_mm_csr(x, layout, cs)
    again = segment_mm_csr(x, layout, cs)
    torch.cuda.synchronize()
    assert smod.segment_mm_cuda.launches == before + 2
    assert out.shape == (n, x.shape[1]) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    exact = segment_mm_ref(x.double(), src, dst, coeff.double(), n)
    assert rule_excess(out, exact, x, src, dst, coeff, n) <= 1.0
    if tile == TILE:
        flat = segment_mm(x, src, dst, coeff, n)
        assert smod.segment_mm_cuda.launches == before + 3
        assert torch.equal(flat, out)


def test_segment_mm_rule_rejects_the_planted_faults_on_card(cuda_device):
    x, src, dst, coeff, n = _segmm_case(SEGMM_FAULT, cuda_device)
    exact = segment_mm_ref(x.double(), src, dst, coeff.double(), n)
    assert rule_excess(segment_mm(x, src, dst, coeff, n), exact, x, src,
                       dst, coeff, n) <= 1.0
    for fault in (drop_one_edge, drop_one_chunk):
        assert rule_excess(fault(x, src, dst, coeff, n), exact, x, src, dst,
                           coeff, n) > 1.0


def test_segment_mm_layout_and_bad_inputs_on_card(cuda_device):
    """The layout built on the card is the CPU's, edge for edge, and so are
    its crossing rows at both tiles; what the kernel does not take
    raises."""
    x, src, dst, coeff, n = _segmm_case("hub-40000", cuda_device)
    for tile in (TILE, 32):
        dev_l = csr_layout(src, dst, n, tile=tile)
        cpu_l = csr_layout(src.cpu(), dst.cpu(), n, tile=tile)
        for f in ("row_ptr", "col", "row", "perm", "crossing_rows"):
            assert torch.equal(getattr(dev_l, f).cpu(), getattr(cpu_l, f)), f
    layout = csr_layout(src, dst, n)
    cs = coeff[layout.perm]
    with pytest.raises(ValueError, match="float32"):
        smod.segment_mm_cuda(x.double(), layout, cs)
    with pytest.raises(ValueError, match="D <="):
        smod.segment_mm_cuda(torch.zeros(n, 300, device=cuda_device), layout,
                             cs)
    with pytest.raises(ValueError, match="unit column stride"):
        smod.segment_mm_cuda(x.t().contiguous().t(), layout, cs)
    with pytest.raises(ValueError, match="CUDA"):
        smod.segment_mm_cuda(x, dataclasses.replace(
            layout, row_ptr=layout.row_ptr.cpu()), cs)
    with pytest.raises(ValueError, match="tile"):
        dataclasses.replace(layout, tile=TILE + 1)
    fields = {f.name: getattr(layout, f.name)
              for f in dataclasses.fields(layout)}
    with pytest.raises(ValueError, match="tile"):
        smod.segment_mm_cuda(x, types.SimpleNamespace(
            **{**fields, "tile": TILE + 1}), cs)
    empty = csr_layout(src[:0], dst[:0], 0)
    assert smod.segment_mm_cuda(x, empty, cs[:0]).shape == (0, x.shape[1])


def test_segment_mm_strided_rows_and_a_misaligned_base(cuda_device):
    """x as a ``[:, :7]`` view of an ``[N, 8]`` tensor (rows padded to 32
    bytes, read in 16-byte chunks, the padding NaN), and a contiguous x
    whose base is not 16-byte aligned (read a float at a time), within the
    rule of float64, two launches bit-equal; the C entry refuses 16-byte
    reads from a misaligned base before any launch."""
    x, src, dst, coeff, n = _segmm_case("uniform-d7", cuda_device)
    padded = torch.zeros(n, 8, device=cuda_device)
    padded[:, :7] = x
    padded[:, 7] = float("nan")       # never read into a written output
    for tile in (TILE, 32):
        layout = csr_layout(src, dst, n, tile=tile)
        cs = coeff[layout.perm]
        got = segment_mm_csr(padded[:, :7], layout, cs)
        again = segment_mm_csr(padded[:, :7], layout, cs)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.isfinite(got).all()
        exact = segment_mm_ref(x.double(), src, dst, coeff.double(), n)
        assert rule_excess(got, exact, x, src, dst, coeff, n) <= 1.0
        assert torch.equal(got, again)
        buf = torch.full((n * 8 + 1,), float("nan"), device=cuda_device)
        buf[1:n * 7 + 1] = x.flatten()
        skew = buf[1:n * 7 + 1].view(n, 7)
        assert skew.data_ptr() % 16 and not smod._reads_whole_chunks(skew)
        got = segment_mm_csr(skew, layout, cs)
        torch.cuda.synchronize()
        assert rule_excess(got, exact, x, src, dst, coeff, n) <= 1.0
        assert torch.equal(got, segment_mm_csr(skew, layout, cs))
    # 16-byte reads (vec = 1) from a misaligned base: cudaErrorInvalidValue
    xs = buf[1:n * 8 + 1].view(n, 8)
    y = torch.empty(n, 8, device=cuda_device)
    carry = torch.empty(2 * (n + cs.numel()) * 8, device=cuda_device)
    err = smod.load_library().segment_mm_launch(
        layout.row_ptr.data_ptr(), layout.col.data_ptr(), cs.data_ptr(),
        xs.data_ptr(), layout.crossing_rows.data_ptr(), y.data_ptr(),
        carry.data_ptr(), n, cs.numel(), 8, layout.crossing_rows.numel(),
        layout.tile, 8, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1


@pytest.mark.parametrize("d", [7, 16])
def test_segment_mm_on_a_39485_edge_hub(cuda_device, d):
    """One row of 39,485 in-edges (ogb_products' largest) beside rows of a
    few edges, and the hub alone as a one-row graph: the rule against
    float64, two launches bit-equal."""
    r = np.random.default_rng(d)
    n, k = 5000, 39_485
    dst = np.concatenate([np.zeros(k, np.int64), r.integers(1, n, 4 * n)])
    src = r.integers(0, n, len(dst))
    x = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32)).to(
        cuda_device)
    coeff = torch.from_numpy(r.standard_normal(len(dst)).astype(
        np.float32)).to(cuda_device)
    src, dst = (torch.from_numpy(a.astype(np.int32)).to(cuda_device)
                for a in (src, dst))
    layout = csr_layout(src, dst, n)
    assert 0 in layout.crossing_rows.tolist()
    cs = coeff[layout.perm]
    out = segment_mm_csr(x, layout, cs)
    assert torch.equal(out, segment_mm_csr(x, layout, cs))
    exact = segment_mm_ref(x.double(), src, dst, coeff.double(), n)
    assert rule_excess(out, exact, x, src, dst, coeff, n) <= 1.0
    ptr = torch.tensor([0, k], dtype=torch.int64, device=cuda_device)
    hub = CsrLayout(1, ptr, layout.col[:k].contiguous(),
                    torch.zeros(k, dtype=torch.int32, device=cuda_device),
                    torch.arange(k, device=cuda_device))
    alone = segment_mm_csr(x, hub, cs[:k].contiguous())
    assert torch.equal(alone, segment_mm_csr(x, hub, cs[:k].contiguous()))
    assert rule_excess(alone, exact[:1], x, hub.col, hub.row,
                       cs[:k].contiguous(), 1) <= 1.0


def test_gcn_forward_through_the_kernel_on_card(cuda_device):
    """gcn-cora at full widths on ``full_graph_sm``: two launches per
    forward, bit-identical forwards, the logits within the chained rule of
    the plain path's."""
    cfg = get_arch("gcn-cora")
    shape = {s.name: s for s in GNN_SHAPES}["full_graph_sm"]
    graph = gnn.resident_graph(gnn_full_graph_batch(cfg, shape, seed=0),
                               device=cuda_device)
    params = gnn.init_gnn(cfg, shape.d_feat, torch.Generator(
        device=cuda_device).manual_seed(0))
    smod.segment_mm_cuda.launches = 0
    got = gnn.gnn_forward(params, graph, cfg)
    again = gnn.gnn_forward(params, graph, cfg)
    torch.cuda.synchronize()
    assert smod.segment_mm_cuda.launches == 4
    assert torch.equal(got, again)
    want = gnn.gnn_forward(params, graph, cfg, impl="ref")
    assert smod.segment_mm_cuda.launches == 4
    layout = graph["layout"]
    _, coeff, self_coeff = gnn.gcn_norm(layout, cfg.norm)
    mag = chain_magnitude(params, graph["x"], layout.col, layout.row, coeff,
                          self_coeff)
    assert chain_excess(got, want, mag, [shape.d_feat, cfg.d_hidden],
                        int(layout.in_degree().max())) <= 1.0
    loss = gnn.node_classification_loss(params, graph, cfg)
    assert smod.segment_mm_cuda.launches == 6 and torch.isfinite(loss)


def _growth_batch(g, pairs: int, seed: int) -> UpdateBatch:
    """Inserts of ``pairs`` new undirected keys: more directed slots than
    the store's headroom holds, so the flush grows its capacity."""
    rng = np.random.default_rng(seed)
    have = set(zip(g.src.tolist(), g.dst.tolist()))
    new = set()
    while len(new) < pairs:
        u, v = map(int, rng.integers(0, g.n_nodes, 2))
        if u < v and (u, v) not in have:
            new.add((u, v))
    u, v = np.array(sorted(new), np.int32).T
    return UpdateBatch.inserts(u, v, rng.integers(1, 50, len(u)))


@pytest.mark.parametrize("fuse", [0, 8])
def test_dynamic_rebind_after_scatter_and_growth_on_card(cuda_device, fuse):
    """Two trace batches (in-place scatters), then inserts past the
    headroom (a capacity growth and a whole upload): after each, the kernel
    session's reports, planes and estimates equal the plain session's, and
    the rebuilt CSR holds exactly the store's real edges."""
    g = road_like(3000, seed=2)
    batches = temporal_trace(g, 2, events_per_batch=60, seed=3)
    batches.append(_growth_batch(g, g.n_edges // 3, seed=4))
    sk = open_session(g, GraphEngineConfig(fuse_supersteps=fuse),
                      backend="kernel", tau=8, device=cuda_device)
    ss = open_session(g, backend="single", tau=8, device=cuda_device)
    launches0 = sk.backend.launches
    for b in batches:
        rk, rs = sk.apply_updates(b), ss.apply_updates(b)
        assert (dataclasses.replace(rk, seconds=0.0)
                == dataclasses.replace(rs, seconds=0.0))
        dk, ds = sk.dynamic.dec, ss.dynamic.dec
        np.testing.assert_array_equal(dk.final_c, ds.final_c)
        np.testing.assert_array_equal(dk.final_pathw, ds.final_pathw)
        ek, es = sk.estimate(), ss.estimate()
        assert (ek.phi_approx, ek.n_clusters) == (es.phi_approx, es.n_clusters)
        store = sk.dynamic.store
        graph = sk.backend.graph
        assert int(graph.row_ptr[-1]) == store.n_edges
        assert graph.n_edges == store.capacity
    assert sk.dynamic.store.uploads == 2 and sk.dynamic.store.scatters == 2
    assert sk.backend.launches > launches0
    km, sm = (dataclasses.asdict(x.dynamic.metrics) for x in (sk, ss))
    km.pop("engine_syncs"), sm.pop("engine_syncs")
    assert km == sm


@pytest.mark.parametrize("fuse", [0, 8])
def test_confined_regrow_kernel_equals_plain_on_card(cuda_device, fuse):
    """The repair's confined regrow: every alive node frozen, a tenth of
    the nodes dead; the kernel over the store's CSR (inert tail) and the
    plain superstep over the flat store give the same planes."""
    g = road_like(3000, seed=5)
    sess = open_session(g, backend="single", tau=8, device=cuda_device)
    st = dynamic.ensure_dynamic(sess)
    n, store, dec = g.n_nodes, st.store, st.dec
    rng = np.random.default_rng(6)
    alive = torch.ones(n, dtype=torch.bool, device=cuda_device)
    alive[torch.from_numpy(rng.choice(n, n // 10, replace=False)).to(
        cuda_device)] = False
    alive |= dec.final_c_dev == torch.arange(n, device=cuda_device)
    state = dynamic._repair_state(dec.final_c_dev, dec.final_pathw_dev,
                                  alive, n, confine=True)
    kb = KernelBackend(g, device=cuda_device, fuse=fuse)
    kb.rebind(store.src, store.dst, store.weight)
    plain = SingleDeviceBackend.from_device(n, store.src, store.dst,
                                            store.weight)
    got, gs = kb.grow(state, 2**30, 0, 2**30, "complete")
    want, ws = plain.grow(state, 2**30, 0, 2**30, "complete")
    assert kb.launches > 0 and gs.steps == ws.steps > 0
    for a, b in ((got.d, want.d), (got.c, want.c), (got.pathw, want.pathw)):
        assert torch.equal(a, b)
    assert torch.equal(got.pathw[alive], state.pathw[alive])
