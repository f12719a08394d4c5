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
a 39,485-edge hub), inside the GCN forward (two launches per forward),
over the edge and irrep layouts, and inside the gatedgcn, meshgraphnet and
equiformer-v2 forwards (smoke and full widths on ``molecule``: the launch
count, bit-equal repeats, the spread rule and its planted fault;
equiformer-v2's rotation invariance and its planted fault);
CLUSTER2 and the quotient cascade on the kernel backend against the plain
backend; pooled sessions (a padded row 0 past the long-row threshold)
against unpooled ones, fused and not; an autotuned session (fuse 8 from
its record) against the same session unfused; dynamic updates on the
kernel backend (``KernelBackend.rebind`` after a scatter and after a
capacity growth, fused and not, and a confined regrow whose frozen set is
every alive node) against the plain backend; a kill by SIGTERM and a
resume onto the card (fused and not), an unspill onto the kernel backend,
and the ``paper-graph`` cell's kernel superstep against the plain one;
the flash attention kernel at head dim 128 with the heads of
mistral-nemo-12b, qwen1.5-32b, moonshot-v1-16b-a3b and mixtral-8x7b
(its window of 4,096 crossed); the MoE FFN at smoke width in bf16
against its dense check (``models/moe_check.py``), and an MoE prefill
and decode step under ``torch.cuda.set_sync_debug_mode("error")``; the
segment_mm kernel over the transposed layouts a backward sums over
(``transpose_layout`` of the CSR, edge and irrep layouts) against its
plain version in float64, with a dropped item reading above the rule,
and one GNN training step per kind (smoke width, ``molecule``) through
``build_cell``: twice a forward's launches, its gradients within
``gnn_check.grad_excess``'s rule of the plain path's, and no read of the
device under sync debug mode "error"; the CIN layer's gradient kernels
(dxk and dx0 in one launch of ``cin_dx_wgmma``, dW by ``cin_dw_wgmma``)
against their plain versions under ``kernels/cin/cases.py``'s rules (the
layer rule, and dW's against float64) over its gradient cases and at the
training batch's layers (B 65,536, in chunks), each with its planted
fault above the rule, their plans against the Python mirrors, two
launches bit for bit equal, the wrappers' refusals, and xDeepFM's smoke
training step through ``build_cell`` (3 forward and 6 backward launches,
gradients against the plain path's, no read of the device); the flash
attention forward's log-sum-exp against the plain ``mef_forward``'s, the
backward kernel against the float64 plain backward under
``kernels/flash_attention/cases.py``'s rule over its ``GRAD_CASES`` (both
planted faults above it, two launches bit for bit equal, autograd through
``ops.attention``), and an LM training step through ``build_cell``
(``train_4k`` cut, head dim 128: 2L forward and L backward launches,
gradients against the plain attention's, no read of the device); an MoE
training step at capacity factor 1.0 (no read of the device, two steps
from one state bit for bit equal), the MoE FFN's gradients against its
dense check's under ``moe_check.moe_grad_excess`` (and its planted
fault), and a training step with QKV biases (qwen1.5-32b's smoke model:
launch counts, gradients against the plain attention's).
This file imports no JAX, so it runs where only the port is installed:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips where there is no GPU (the kernel has no CPU mode)."""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import numpy as np
import pytest
import torch

import dataclasses
import types

from repro_torch.common import GraphEngineConfig
from repro_torch.config import GNN_SHAPES, LM_SHAPES, get_arch
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
from repro_torch.kernels.cin import cases as cin_cases
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
from repro_torch.kernels.flash_attention import blocked as fblocked
from repro_torch.kernels.flash_attention import cases as fcases
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
                                                segment_mm, segment_mm_csr,
                                                transpose_layout)
from repro_torch.kernels.segment_mm.ref import segment_mm_ref
from repro_torch.data.pipeline import gnn_full_graph_batch, gnn_molecule_batch
from repro_torch.launch import steps
from repro_torch.launch.steps import build_cell
from repro_torch.config import RECSYS_SHAPES
from repro_torch.data.pipeline import DataCursor, RecsysPipeline
from repro_torch.models import gnn, gnn_check, moe_check, recsys
from repro_torch.optim import adamw
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


# (Hq, Hkv, S, window) of the archs with head dim 128, at a moderate S
D128_LAYOUTS = {"mistral-nemo-12b": (32, 8, 2048, 0),
                "qwen1.5-32b": (40, 40, 2048, 0),
                "moonshot-v1-16b-a3b": (16, 16, 2048, 0),
                "mixtral-8x7b": (32, 8, 4608, 4096)}


@pytest.mark.parametrize("arch", sorted(D128_LAYOUTS))
def test_flash_attention_d128_at_each_arch_layout(cuda_device, arch):
    """bf16, causal, the element-wise bf16 rule of ``cases.py``; mixtral's
    rows past 4,096 see a window that cuts a kv tile."""
    Hq, Hkv, S, window = D128_LAYOUTS[arch]
    assert get_arch(arch).n_heads == Hq and get_arch(arch).head_dim == 128
    g = torch.Generator(device=cuda_device)
    g.manual_seed(Hq * 100 + Hkv)
    q = torch.randn(1, Hq, S, 128, generator=g, device=cuda_device).to(
        torch.bfloat16)
    k, v = (torch.randn(1, Hkv, S, 128, generator=g,
                        device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    before = fmod.flash_attention_cuda.launches
    out = attention(q, k, v, causal=True, window=window)
    assert fmod.flash_attention_cuda.launches == before + 1
    want = attention_ref(q, k, v, causal=True, window=window)
    assert bf16_excess(out, want) <= 1.0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_moe_ffn_bf16_matches_its_dense_check_on_card(cuda_device, arch):
    """The dispatch at capacity factor 1.0 (pairs dropped) in two groups
    against every expert on every token, under the rule of
    ``moe_check.py``; its planted fault must read above 1."""
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype="bfloat16",
                              capacity_factor=1.0, moe_groups=2)
    lp = tf.layer_params(tf.init_params(cfg, seed=5, device=cuda_device), 0)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(2)
    x = torch.randn(2, 64, cfg.d_model, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    h = tf.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps).reshape(2, 64,
                                                            cfg.d_model)
    got, _ = tf._moe_ffn(h, lp, cfg)
    want = moe_check.moe_ffn_dense(h, lp, cfg)
    assert got.dtype == torch.float32
    assert moe_check.moe_excess(got, want) <= 1.0
    experts = tf.moe_route(h, lp["router"], cfg)[2]
    cap = moe_check.fault_capacity(experts, tf.moe_capacity(64, cfg),
                                   cfg.n_experts)
    fault = moe_check.moe_ffn_dense(h, lp, cfg, capacity=cap)
    assert moe_check.moe_excess(fault, want) > 1.0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_moe_prefill_and_decode_read_nothing_from_the_card(cuda_device,
                                                           arch):
    """An MoE prefill (through the kernel) and decode steps raise nothing
    under sync debug mode "error": no step reads the device."""
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype="bfloat16")
    params = tf.init_params(cfg, seed=1, device=cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=g,
                         device=cuda_device)
    cache = tf.init_cache(cfg, 2, 4, device=cuda_device)
    fmod.load_library()                 # the build, outside the mode
    torch.cuda.synchronize()
    fmod.flash_attention_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = tf.prefill_step(params, toks, cfg)
        for i in range(4):
            step, cache = tf.decode_step(params, cache, toks[:, i:i + 1],
                                         cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fmod.flash_attention_cuda.launches == cfg.n_layers
    assert cache["len"] == 4
    assert bool(torch.isfinite(logits).all() & torch.isfinite(step).all())


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


def _cin_grad_check(dev, case, seed=0):
    """Each gradient kernel on one case's inputs against its plain version:
    dxk and dx0 (one ``cin_dx_cuda``) under the layer rule (float32 plain,
    chunked), dW under the dW rule (float64); the planted faults read
    beside them; the C plans equal ``kernel.dw_plan`` / ``dx_plan``.
    Returns the readings."""
    x0, xk, w, dy = (torch.from_numpy(a).to(dev)
                     for a in cin_cases.grad_case_inputs(case, seed))
    B, m, H, H2, D = case
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cmod._c_plan("test", "cin_dw_plan", case, 9) == list(
        cmod.dw_plan(B, m, H, H2, D, sms).values())
    assert cmod._c_plan("test", "cin_dx_plan", case, 8) == list(
        cmod.dx_plan(B, m, H, H2, D, sms).values())
    before = (cmod.cin_dx_cuda.launches, cmod.cin_dw_cuda.launches)
    dx0, dxk = cmod.cin_dx_cuda(x0, xk, dy, w)
    got = {"dxk": dxk, "dx0": dx0}
    dw = cmod.cin_dw_cuda(x0, xk, dy)
    torch.cuda.synchronize()
    assert (cmod.cin_dx_cuda.launches, cmod.cin_dw_cuda.launches) == tuple(
        b + 1 for b in before)
    out = {}
    for what, (a, b, wp) in cin_cases.input_grad_operands(x0, xk, w,
                                                          dy).items():
        ref = torch.cat([cin_layer_ref(a[i:i + cin_cases.PLAIN_CHUNK],
                                       b[i:i + cin_cases.PLAIN_CHUNK], wp)
                         for i in range(0, B, cin_cases.PLAIN_CHUNK)])
        assert got[what].shape == ref.shape
        assert torch.isfinite(got[what]).all()
        out[what] = layer_excess(got[what], ref, a, b, wp)
        out[what + "_fault"] = layer_excess(planted_fault(
            a[:cin_cases.PLAIN_CHUNK], b[:cin_cases.PLAIN_CHUNK], wp, h=1),
            ref[:cin_cases.PLAIN_CHUNK], a[:cin_cases.PLAIN_CHUNK],
            b[:cin_cases.PLAIN_CHUNK], wp)
        del ref
    r, S = cin_cases.dw_exact(x0, xk, dy, chunk=4096)
    assert dw.shape == (H2, H, m) and torch.isfinite(dw).all()
    out["dw"] = cin_cases.dw_excess(dw, r, S, B * D)
    out["dw_fault"] = cin_cases.dw_excess(cin_cases.dw_planted_fault(
        x0, xk, dy, (B * D) // 2, chunk=4096), r, S, B * D)
    return out


@pytest.mark.parametrize("name", sorted(cin_cases.GRAD_CASES))
def test_cin_gradient_kernels_match_plain(cuda_device, name):
    """dxk and dx0 (one ``cin_dx_cuda``: N tiles of 200, 64 and 16, N
    parts at small batches) under the layer rule, dW under the dW rule;
    one launch each; autograd through ``cin_layer`` launches each once
    and gives the same gradients; a gradient not asked for is None and
    leaves the other's bits as they were."""
    case = cin_cases.GRAD_CASES[name]
    got = _cin_grad_check(cuda_device, case)
    assert got["dxk"] <= 1.0 and got["dx0"] <= 1.0 and got["dw"] <= 1.0, got
    x0, xk, w, dy = (torch.from_numpy(a).to(cuda_device)
                     for a in cin_cases.grad_case_inputs(case))
    x0.requires_grad_()
    xk.requires_grad_()
    w.requires_grad_()
    before = (cmod.cin_layer_cuda.launches, cmod.cin_dx_cuda.launches,
              cmod.cin_dw_cuda.launches)
    out = cin_layer(x0, xk, w)
    g = torch.autograd.grad(out, (x0, xk, w), dy)
    torch.cuda.synchronize()
    assert (cmod.cin_layer_cuda.launches, cmod.cin_dx_cuda.launches,
            cmod.cin_dw_cuda.launches) == tuple(b + 1 for b in before)
    with torch.no_grad():
        dx0, dxk = cmod.cin_dx_cuda(x0, xk, dy, w)
        assert torch.equal(g[0], dx0) and torch.equal(g[1], dxk)
        assert torch.equal(g[2], cmod.cin_dw_cuda(x0, xk, dy))
        only0 = cmod.cin_dx_cuda(x0, xk, dy, w, need_xk=False)
        onlyk = cmod.cin_dx_cuda(x0, xk, dy, w, need_x0=False)
        assert only0[1] is None and onlyk[0] is None
        assert torch.equal(only0[0], dx0) and torch.equal(onlyk[1], dxk)


@pytest.mark.parametrize("name", sorted(cin_cases.TRAIN_CASES))
def test_cin_gradients_at_the_training_batch(cuda_device, name):
    """xdeepfm's layer 1 and H-200 layer at B 65,536: each gradient kernel
    under its rule (the plain side in chunks), each planted fault (a
    dropped slice of the input gradients' W; one tile of 128 values of k
    left out of dW) above it."""
    got = _cin_grad_check(cuda_device, cin_cases.TRAIN_CASES[name])
    assert got["dxk"] <= 1.0 and got["dx0"] <= 1.0 and got["dw"] <= 1.0, got
    assert got["dxk_fault"] > 1.0 and got["dx0_fault"] > 1.0, got
    assert got["dw_fault"] > 1.0, got


@pytest.mark.parametrize("B", [1, 512, 65536])
def test_cin_gradient_two_launches_bit_identical(cuda_device, B):
    """dW sums its K parts (``dw_plan`` at xdeepfm's H-200 layer on an
    H100: one at B 1, a single stage, and 2 beyond) and dx0 its N parts
    (40 at B 1, 3 at 512, one at 65,536) in a fixed order: two launches
    give the same bits."""
    x0, xk, w, dy = (torch.from_numpy(a).to(cuda_device)
                     for a in cin_cases.grad_case_inputs(
                         (B, 39, 200, 200, 10), seed=1))
    assert torch.equal(cmod.cin_dw_cuda(x0, xk, dy),
                       cmod.cin_dw_cuda(x0, xk, dy))
    a, b = cmod.cin_dx_cuda(x0, xk, dy, w), cmod.cin_dx_cuda(x0, xk, dy, w)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cin_gradient_wrappers_refuse(cuda_device):
    x0, xk, w, dy = (torch.from_numpy(a).to(cuda_device)
                     for a in cin_cases.grad_case_inputs((9, 39, 200, 200,
                                                          10)))
    before = (cmod.cin_dx_cuda.launches, cmod.cin_dw_cuda.launches)
    with pytest.raises(ValueError, match="do not agree"):
        cmod.cin_dx_cuda(x0, xk, dy[:, :5], w)
    with pytest.raises(ValueError, match="do not agree"):
        cmod.cin_dx_cuda(x0, xk[:, :5], dy, w)
    with pytest.raises(ValueError, match="do not agree"):
        cmod.cin_dw_cuda(x0, xk[:3], dy)
    with pytest.raises(ValueError, match="float32"):
        cmod.cin_dw_cuda(x0.double(), xk.double(), dy.double())
    with pytest.raises(ValueError, match="contiguous"):
        cmod.cin_dw_cuda(x0, xk, dy.transpose(1, 2).contiguous().transpose(
            1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        cmod.cin_dx_cuda(x0, xk, dy.cpu(), w)
    wide = torch.zeros(9, 20, 10, device=cuda_device)
    with pytest.raises(ValueError, match="m padded to 8 or 40"):
        cmod.cin_dx_cuda(wide, xk, dy, torch.zeros(200, 200, 20,
                                                   device=cuda_device))
    long = torch.zeros(9, 240, 10, device=cuda_device)
    with pytest.raises(ValueError, match="H2 <= 224"):
        cmod.cin_dx_cuda(x0, xk, long, torch.zeros(240, 200, 39,
                                                   device=cuda_device))
    assert (cmod.cin_dx_cuda.launches, cmod.cin_dw_cuda.launches) == before
    empty = cmod.cin_dw_cuda(x0[:0], xk[:0], dy[:0])
    assert empty.shape == (200, 200, 39) and not empty.any()
    e0, ek = cmod.cin_dx_cuda(x0[:0], xk[:0], dy[:0], w)
    assert e0.shape == (0, 39, 10) and ek.shape == (0, 200, 10)
    assert (cmod.cin_dx_cuda.launches, cmod.cin_dw_cuda.launches) == before


def test_cin_field_limit_follows_shared_memory(cuda_device):
    """The C entry's field limit is the layer launch's shared memory within
    the card's opt-in limit: a multiple of 8, wider beside a narrower
    output (the N tile: 16, 64 or 200), enough for xdeepfm's forward (39
    rows beside 200) and for 200 rows beside 39, and on an H100 136, 312
    and 376. A layer over it is refused before a launch."""
    mf = cmod.max_fields
    assert all(mf(h) % 8 == 0 for h in (6, 16, 39, 64, 200))
    assert mf(200) <= mf(64) == mf(39) <= mf(16) == mf(6)
    assert mf(200) >= 39 and mf(39) >= 200
    if "H100" in torch.cuda.get_device_name(cuda_device):
        assert (mf(200), mf(39), mf(6)) == (136, 312, 376)
    m = mf(200) + 1
    before = cmod.cin_layer_cuda.launches
    with pytest.raises(ValueError, match=f"m <= {m - 1}"):
        cmod.cin_layer_cuda(torch.zeros(9, m, 10, device=cuda_device),
                            torch.zeros(9, 39, 10, device=cuda_device),
                            torch.zeros(200, 39, m, device=cuda_device))
    assert cmod.cin_layer_cuda.launches == before


def test_recsys_train_step_through_the_kernels_on_card(cuda_device):
    """xdeepfm's smoke training cell at B 4,096: a step launches the CIN
    kernel once a layer and each gradient kernel (dx, dW) once a layer
    (layer 1's x0 and xk are one tensor; every layer's input needs both),
    reads nothing from the device, and its gradients agree with the plain
    path's within ``gnn_check.grad_rel`` 1e-4; the loss falls over 5
    steps."""
    cfg = get_arch("xdeepfm", smoke=True)
    shape = dataclasses.replace(
        {s.name: s for s in RECSYS_SHAPES}["train_batch"], batch=4096)
    cell = steps._recsys_train_cell(cfg, shape, cuda_device)
    batch = cell.inputs(RecsysPipeline(cfg, shape, seed=0).batch(
        DataCursor()))
    params, opt = cell.init(0)

    def grads(impl):
        p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        recsys.bce_loss(p, batch, cfg, cin_impl=impl).backward()
        return adamw.tree_map(lambda t: t.grad, p)

    assert gnn_check.grad_rel(grads("auto"), grads("ref")) < 1e-4
    counts = (cmod.cin_layer_cuda, cmod.cin_dx_cuda, cmod.cin_dw_cuda)
    for c in counts:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, opt, loss0, _ = cell.step_fn(params, opt, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [c.launches for c in counts] == [len(cfg.cin_layers)] * 3
    losses = [float(loss0)]
    for _ in range(4):
        params, opt, loss, _ = cell.step_fn(params, opt, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


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


def _gnn_molecule(cfg, dev):
    """The seed-0 ``molecule`` batch on the card, with ``e`` drawn with
    numpy (seed 0) at the kind's cell width, and its layouts."""
    shape = {s.name: s for s in GNN_SHAPES}["molecule"]
    b = gnn_molecule_batch(cfg, shape, seed=0, d_feat=shape.d_feat)
    de = gnn.GNN_EDGE_DIM.get(cfg.kind)
    if de:
        b["e"] = np.random.default_rng(0).standard_normal(
            (b["src"].shape[0], de)).astype(np.float32)
    return gnn.resident_graph(b, device=dev, cfg=cfg), de or 1


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ["gatedgcn", "meshgraphnet",
                                  "equiformer-v2"])
def test_gnn_kind_forward_through_the_kernel_on_card(cuda_device, arch,
                                                     smoke):
    """On ``molecule``: ``segment_mm_launches(cfg)`` launches a forward,
    two forwards bit-equal, the logits within the element-wise spread rule
    of ``models/gnn_check.py`` (the plain path in float64 the exact side,
    in float32 the spread), and one edge dropped from the summed layout
    read above it."""
    cfg = get_arch(arch, smoke=smoke)
    graph, de = _gnn_molecule(cfg, cuda_device)
    params = gnn.init_gnn(cfg, graph["x"].shape[1], torch.Generator(
        device=cuda_device).manual_seed(0), d_edge_in=de)
    smod.segment_mm_cuda.launches = 0
    got = gnn.gnn_forward(params, graph, cfg)
    again = gnn.gnn_forward(params, graph, cfg)
    torch.cuda.synchronize()
    assert smod.segment_mm_cuda.launches == 2 * gnn.segment_mm_launches(cfg)
    assert torch.equal(got, again)
    plain = gnn.gnn_forward(params, graph, cfg, impl="ref")
    exact = gnn.gnn_forward(gnn_check.as64(params), gnn_check.as64(graph),
                            cfg, impl="ref")
    assert smod.segment_mm_cuda.launches == 2 * gnn.segment_mm_launches(cfg)
    assert gnn_check.elementwise_excess(got, exact, plain) <= 1.0
    fault = gnn.gnn_forward(params, gnn_check.drop_one_edge(graph, cfg), cfg)
    assert gnn_check.elementwise_excess(fault, exact, plain) > 1.0


@pytest.mark.parametrize("what", ["edge-d70-in-72", "edge-d140",
                                  "edge-d128", "irrep-k49-d128"])
def test_edge_and_irrep_layout_sums_on_card(cuda_device, what):
    """``segment_sum`` over the layouts the GNN kinds sum through, against
    the plain version in float64 under the float32 rule of
    ``kernels/segment_mm/cases.py``: gatedgcn's rows of 70 floats in rows
    of 72 (a view), its ``[msg | gate]`` rows of 140, meshgraphnet's 128,
    and equiformer-v2's irrep layout (K 49, C 128); two launches
    bit-equal. The graph has empty rows, self-loops and a 3,000-edge
    hub."""
    r = np.random.default_rng(7)
    n, e = 2000, 20_000
    src = r.integers(0, n, e)
    dst = r.integers(0, n // 2, e)
    dst[:3000] = 5
    dst[3000:3100] = src[3000:3100]
    src, dst = (torch.from_numpy(a.astype(np.int32)).to(cuda_device)
                for a in (src, dst))
    layout = csr_layout(src, dst, n)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    if what.startswith("irrep"):
        k, d = 49, 128
        lay = gnn.irrep_layout(layout, k)
        x = torch.randn(e * k, d, generator=gen, device=cuda_device)
    else:
        lay = gnn.edge_layout(layout)
        d = int(what.split("-d")[1].split("-")[0])
        wide = torch.randn(e, -(-d // 8) * 8, generator=gen,
                           device=cuda_device)
        x = wide[:, :d]
        assert what != "edge-d70-in-72" or (x.stride(0) == 72 and
                                            smod._reads_whole_chunks(x))
    before = smod.segment_mm_cuda.launches
    out = gnn.segment_sum(x, lay)
    assert torch.equal(out, gnn.segment_sum(x, lay))
    assert smod.segment_mm_cuda.launches == before + 2
    ones = torch.ones(lay.col.numel(), device=cuda_device)
    exact = segment_mm_ref(x.double(), lay.col, lay.row, ones.double(),
                           lay.n_nodes)
    assert rule_excess(out, exact, x, lay.col, lay.row, ones,
                       lay.n_nodes) <= 1.0


def test_equiformer_rotation_invariance_on_card(cuda_device):
    """equiformer-v2 at full width on ``molecule`` through the kernel: the
    reference's check (about z, 1e-3) on the batch as it is; under
    ``gnn_check.ROTATION`` without self-loops the spread-based rule holds,
    and rotating back without the transpose breaks it."""
    cfg = get_arch("equiformer-v2")
    graph, _ = _gnn_molecule(cfg, cuda_device)
    params = gnn.init_gnn(cfg, graph["x"].shape[1], torch.Generator(
        device=cuda_device).manual_seed(0))
    out = gnn.gnn_forward(params, graph, cfg)
    about_z = gnn.gnn_forward(params, gnn_check.rotated_graph(
        graph, gnn_check.rotation_z()), cfg)
    assert gnn_check.invariance_rel(out, about_z) < gnn_check.INVARIANCE_RULE
    shape = {s.name: s for s in GNN_SHAPES}["molecule"]
    b = gnn_check.drop_self_loops(gnn_molecule_batch(
        cfg, shape, seed=0, d_feat=shape.d_feat))
    graph = gnn.resident_graph(b, device=cuda_device, cfg=cfg)
    runs, spread = {}, 0.0
    for name, g in (("out", graph), ("rot", gnn_check.rotated_graph(
            graph, gnn_check.ROTATION))):
        runs[name] = gnn.gnn_forward(params, g, cfg)
        exact = gnn.gnn_forward(gnn_check.as64(params), gnn_check.as64(g),
                                cfg, impl="ref")
        spread = max(spread, gnn_check.rel_max(
            gnn.gnn_forward(params, g, cfg, impl="ref"), exact))
        with gnn_check.untransposed_rotation():
            runs[name + "_fault"] = gnn.gnn_forward(params, g, cfg)
    assert gnn_check.invariance_excess(runs["out"], runs["rot"],
                                       spread) <= 1.0
    assert gnn_check.invariance_excess(runs["out_fault"], runs["rot_fault"],
                                       spread) > 1.0


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


@pytest.mark.parametrize("fuse", [0, 8])
def test_kill_and_resume_on_card(cuda_device, fuse, tmp_path):
    """A real SIGTERM at stage boundary 2 on the kernel backend (fused or
    not), then a resume from the saved step onto the card: the estimate
    and the final planes equal the uninterrupted run's and the plain
    backend's."""
    from repro_torch.graph import GraphStore
    from repro_torch.runtime.fault import Preempted, PreemptionGuard

    g = road_like(20_000, seed=6)
    cfg = GraphEngineConfig(fuse_supersteps=fuse)
    whole = open_session(g, cfg, tau=8, device=cuda_device).estimate(
        CascadeEstimator(levels=2, tau_solve=64))
    plain = open_session(g, tau=8, backend="single",
                         device=cuda_device).estimate(
        CascadeEstimator(levels=2, tau_solve=64))
    pg = PreemptionGuard()
    d = str(tmp_path)
    sess = open_session(None, cfg, store=GraphStore(g, device=cuda_device),
                        tau=8, checkpoint_dir=d, guard=pg)
    sess.checkpointer.preempt_after_stage = 2
    launches0 = sess.backend.launches
    with pytest.raises(Preempted), pg:
        sess.estimate(CascadeEstimator(levels=2, tau_solve=64))
    assert sess.backend.launches > launches0
    sess.close()
    sess = open_session(None, cfg, store=GraphStore(g, device=cuda_device),
                        tau=8, checkpoint_dir=d, resume=True)
    got = sess.estimate(CascadeEstimator(levels=2, tau_solve=64))
    assert sess.checkpointer.restores == 1
    assert got.pipeline.kernel_launches > 0
    for ref in (whole, plain):
        assert (got.phi_approx, got.n_clusters, got.growing_steps,
                got.n_stages) == (ref.phi_approx, ref.n_clusters,
                                  ref.growing_steps, ref.n_stages)
        np.testing.assert_array_equal(got.decomposition.final_c,
                                      ref.decomposition.final_c)
        np.testing.assert_array_equal(got.decomposition.final_pathw,
                                      ref.decomposition.final_pathw)


def test_unspill_onto_the_kernel_backend(cuda_device):
    """Spill drops the store's device tensors and the CSR; the next query
    builds the CSR again through ``rebind`` (the store's inert slots past
    the last row) and gives the same estimate."""
    from repro_torch.graph import GraphStore

    g = road_like(20_000, seed=7)
    store = GraphStore(g, n_shards=4, compress=True, device=cuda_device)
    sess = open_session(None, store=store, tau=8)
    first = sess.estimate(ClusterQuotientEstimator())
    assert first.pipeline.kernel_launches > 0
    sess.spill()
    assert store.src is None and sess.backend is None
    again = sess.estimate(ClusterQuotientEstimator())
    graph = sess.backend.graph
    assert graph.inert_tail and int(graph.row_ptr[-1]) == store.n_edges
    assert graph.n_edges == store.capacity
    assert (again.phi_approx, again.n_clusters) == (first.phi_approx,
                                                   first.n_clusters)
    np.testing.assert_array_equal(again.decomposition.final_c,
                                  first.decomposition.final_c)
    assert sess.metrics.backend_builds == 2 and sess.metrics.edge_uploads == 2


def test_paper_graph_cell_superstep_on_card(cuda_device):
    """The ``paper-graph`` cell at 2^20 nodes: one launch of the kernel
    superstep, planes equal to the plain backend's superstep."""
    from repro_torch.launch.steps import build_cell

    cell = build_cell("paper-graph", "n1M", device=cuda_device,
                      n_nodes=1 << 20, avg_degree=6)
    g = road_like(1 << 20, seed=0)
    inputs = cell.inputs(g)
    assert cell.n_edges - int(inputs["edge_mask"].sum()) == 12
    bk = cell.backend(inputs, "kernel")
    launches0 = kmod.edge_relax_cuda.launches
    sk, gk = cell.step_fn(cell.state(bk), bk)
    assert kmod.edge_relax_cuda.launches == launches0 + 1
    bs = cell.backend(inputs, "single")
    ss, gs = cell.step_fn(cell.state(bs), bs)
    for f in dataclasses.fields(sk):
        assert torch.equal(getattr(sk, f.name), getattr(ss, f.name)), f.name
    assert (gk.steps, gk.reached) == (gs.steps, gs.reached) and gk.steps == 1


@pytest.mark.parametrize("which", ["csr", "edge", "irrep"])
def test_segment_mm_backward_layouts_on_card(cuda_device, which):
    """The gradient's launch: the kernel over ``transpose_layout`` of the
    CSR (non-symmetric coefficients carried by ``perm``), edge and irrep
    (K 49) layouts of a graph with empty rows, self-loops and a 3,000-edge
    hub, against the plain version in float64 under the float32 rule;
    one item dropped from a row of mean length reads above it; two
    launches bit-equal."""
    from repro_torch.kernels.segment_mm.cases import mean_length_row
    r = np.random.default_rng(11)
    n, e = 2000, 20_000
    src = r.integers(0, n, e)
    dst = r.integers(0, n // 2, e)
    src[:3000] = 7                     # a 3,000-edge hub in the transpose
    dst[3000:3100] = src[3000:3100]
    src, dst = (torch.from_numpy(a.astype(np.int32)).to(cuda_device)
                for a in (src, dst))
    layout = csr_layout(src, dst, n)
    coeff = torch.from_numpy(r.uniform(0.5, 2.0, e).astype(np.float32)).to(
        cuda_device)
    n_src, d = n, 16
    if which == "edge":
        layout, n_src, d = gnn.edge_layout(layout), e, 140
    elif which == "irrep":
        layout, n_src, d = gnn.irrep_layout(layout, 49), 49 * e, 128
        coeff = torch.ones(n_src, device=cuda_device)
    lt = transpose_layout(layout, n_src, gathers_once=which != "csr")
    ct = coeff[lt.perm].contiguous()
    dy = torch.randn(layout.n_nodes, d, device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(0))
    before = smod.segment_mm_cuda.launches
    out = segment_mm_csr(dy, lt, ct)
    assert torch.equal(out, segment_mm_csr(dy, lt, ct))
    assert smod.segment_mm_cuda.launches == before + 2
    exact = segment_mm_ref(dy.double(), lt.col, lt.row, ct.double(),
                           lt.n_nodes)
    assert rule_excess(out, exact, dy, lt.col, lt.row, ct, lt.n_nodes) <= 1
    row = mean_length_row(lt)
    keep = torch.ones_like(lt.col, dtype=torch.bool)
    keep[lt.row_ptr[row]] = False
    faulty = gnn_check.drop_first_items(lt, torch.tensor([row],
                                                         device=cuda_device))
    assert rule_excess(segment_mm_csr(dy, faulty, ct[keep]), exact, dy,
                       lt.col, lt.row, ct, lt.n_nodes) > 1


@pytest.mark.parametrize("arch", ["gcn-cora", "gatedgcn", "meshgraphnet",
                                  "equiformer-v2"])
def test_gnn_train_step_on_card(cuda_device, arch):
    """One ``train_step`` of the full config on ``molecule`` through
    ``build_cell``: 2 ``segment_mm_launches(cfg)`` launches, no read of
    the device (sync debug mode "error"), a finite loss and updated
    parameters; the first step's gradients within ``grad_excess``'s rule
    of the plain path's (float64 exact, the spread of three float32 plain
    runs in different sum orders), and one edge dropped from the
    transposed layout above it (at the smoke widths one edge moves
    meshgraphnet's gradients by less than the rule's floor: 0.71)."""
    cfg = get_arch(arch)
    shape = {s.name: s for s in GNN_SHAPES}["molecule"]
    cell = build_cell(arch, "molecule", device=cuda_device)
    b = gnn_molecule_batch(cfg, shape, seed=0, d_feat=shape.d_feat)
    b["targets"] = np.random.default_rng(0).standard_normal(
        (shape.n_graphs, cfg.d_out)).astype(np.float32)
    de = gnn.GNN_EDGE_DIM.get(cfg.kind)
    if de:
        b["e"] = np.random.default_rng(0).standard_normal(
            (b["src"].shape[0], de)).astype(np.float32)
    graph = cell.graph({k: v for k, v in b.items() if k in cell.arg_shapes})
    params, opt = cell.init(0)

    def grads(p, g, impl="auto"):
        p = adamw.tree_map(lambda t: t.detach().requires_grad_(), p)
        gnn.graph_regression_loss(p, g, cfg, impl=impl).backward()
        return adamw.tree_map(lambda t: t.grad, p)

    with gnn_check.fixed_order():
        got = grads(params, graph)
        plains = [grads(params, graph, "ref")] + [
            grads(params, gnn_check.shuffled_sums(graph, cfg, s), "ref")
            for s in range(1, gnn_check.GRAD_PLAIN_RUNS)]
        exact = grads(gnn_check.as64(params), gnn_check.as64(graph), "ref")
        fault = grads(params, gnn_check.drop_one_transposed(graph, cfg))
    assert gnn_check.grad_excess(got, exact, plains) <= 1.0
    assert gnn_check.grad_excess(fault, exact, plains) > 1.0
    # the step updates the parameters in place: keep a copy to compare
    before = [t.clone() for t in adamw.tree_leaves(params)]
    torch.cuda.synchronize()
    smod.segment_mm_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, opt, loss, stats = cell.step_fn(params, opt, graph)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert smod.segment_mm_cuda.launches == 2 * gnn.segment_mm_launches(cfg)
    assert np.isfinite(float(loss)) and int(opt.step) == 1
    assert any(not torch.equal(a, b) for a, b in zip(
        adamw.tree_leaves(new), before))


def _flash_grad_inputs(case, dev, seed=0):
    B, Hq, Hkv, Sq, Skv, D, *_, qs = case
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    return (randn(B, Hq, Sq, D, scale=qs), randn(B, Hkv, Skv, D),
            randn(B, Hkv, Skv, D), randn(B, Hq, Sq, D))


# card-only backward cases (same fields as GRAD_CASES), long enough to wrap
# the kernels' TMA rings many times and give each head several blocks;
# the CPU tests do not run them
CARD_GRAD_CASES = {
    "gemma2-heads-S2048-softcap50": (1, 16, 8, 2048, 2048, 256, True, 0,
                                     50.0, None, None, 30.0),
    "gqa4-d128-kv_len-per-row-q_offset": (2, 16, 4, 1536, 2048, 128, True,
                                          0, 0.0, [2048, 1500], 512, 1.0),
}


@pytest.mark.parametrize("name", sorted(fcases.GRAD_CASES)
                         + sorted(CARD_GRAD_CASES))
def test_flash_backward_matches_plain(cuda_device, name):
    """The forward's lse against the plain forward's (float32 sums and the
    fast exponential: 1e-4 absolute); dq, dk and dv under the backward rule
    of ``cases.py`` against float64 on the same inputs, both planted
    faults above it, two launches bit for bit equal, one count a call."""
    case = fcases.GRAD_CASES.get(name) or CARD_GRAD_CASES[name]
    q, k, v, do = _flash_grad_inputs(case, cuda_device)
    kw = fcases.case_kwargs(case, cuda_device)
    o, lse = fmod.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, lse_ref = fblocked.mef_forward(q, k, v, **kw)
    live = lse_ref > -1e29
    torch.testing.assert_close(lse[live], lse_ref[live].float(), rtol=0,
                               atol=1e-4)
    assert bool((lse[~live] == -1e30).all())
    before = fmod.flash_attention_bwd_cuda.launches
    got = fmod.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    again = fmod.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fmod.flash_attention_bwd_cuda.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = fcases.grad_reference(q, k, v, o, lse, do, **kw)
    for n, g in zip(("dq", "dk", "dv"), got):
        assert g.dtype == torch.bfloat16 and g.shape == ref[n].shape
        assert fcases.grad_excess(g, ref[n], ref["a_" + n]) <= 1.0, n
    for fault in fcases.GRAD_FAULTS:
        bad = fcases.grad_reference(q, k, v, o, lse, do, drop=fault, **kw)
        assert max(fcases.grad_excess(bad[n], ref[n], ref["a_" + n])
                   for n in ("dq", "dk", "dv")) > 1.0, fault


def test_flash_attention_autograd_goes_through_the_kernels(cuda_device):
    """``ops.attention`` on CUDA tensors that require grad: one forward and
    one backward launch, the gradients the backward kernel's, the
    strided [B, S, H, D] views the model passes taken as they are; the
    backward wrapper refuses float32 and other head dims."""
    case = fcases.GRAD_CASES["window40-softcap50-d128"]
    q, k, v, do = _flash_grad_inputs(case, cuda_device, seed=2)
    kw = fcases.case_kwargs(case, cuda_device)
    qq, kk, vv = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  .requires_grad_() for x in (q, k, v))
    f0 = fmod.flash_attention_cuda.launches
    b0 = fmod.flash_attention_bwd_cuda.launches
    attention(qq, kk, vv, **kw).backward(do)
    torch.cuda.synchronize()
    assert fmod.flash_attention_cuda.launches == f0 + 1
    assert fmod.flash_attention_bwd_cuda.launches == b0 + 1
    o, lse = fmod.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want = fmod.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b.grad) for a, b in zip(want, (qq, kk, vv)))
    with pytest.raises(ValueError, match="bfloat16"):
        f = q.float()
        fmod.flash_attention_bwd_cuda(f, k.float(), v.float(), f, lse, f)
    with pytest.raises(ValueError, match="head dim"):
        fmod.flash_attention_bwd_cuda(q[..., :64], k[..., :64],
                                      v[..., :64], o[..., :64], lse,
                                      do[..., :64])


def test_lm_train_step_through_the_kernels_on_card(cuda_device):
    """gemma2's smoke model in bf16 at head dim 128 and remat: a train_4k
    step cut to batch 2 and length 256 launches the flash forward 2L
    times (the remat recomputes) and its backward L times; its gradients
    are within bf16 noise of the plain attention's (5e-2 relative L2 per
    leaf, ``chip_smoke.py``'s rule: the kernel rounds P and dS to bf16
    where the plain version does not, and that rounding is carried
    through the layers' backward; measured 2.2% at this size); step 1
    reads nothing from the device; the loss falls over 5 steps."""
    cfg = dataclasses.replace(get_arch("gemma2-9b", smoke=True),
                              dtype="bfloat16", d_head=128, remat="full")
    shape = {s.name: s for s in LM_SHAPES}["train_4k"]
    cell = steps._lm_cell(cfg, shape, cuda_device, batch=2, seq_len=256)
    params, opt = cell.init(0)
    r = np.random.default_rng(0)
    toks = r.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = cell.inputs({"tokens": toks, "labels": labels})

    def grads(attn_impl):
        p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        tf.lm_loss(p, batch, cfg, attn_impl=attn_impl).backward()
        return adamw.tree_leaves(adamw.tree_map(lambda t: t.grad, p))

    for a, b in zip(grads("auto"), grads("blocked")):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel < 5e-2
    fmod.flash_attention_cuda.launches = 0
    fmod.flash_attention_bwd_cuda.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, opt, loss, _ = cell.step_fn(params, opt, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert fmod.flash_attention_cuda.launches == 2 * cfg.n_layers
    assert fmod.flash_attention_bwd_cuda.launches == cfg.n_layers
    losses = [loss]
    for _ in range(4):
        params, opt, loss, _ = cell.step_fn(params, opt, batch)
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _lm_train_cell(arch, device, **replace):
    """A smoke arch's train_4k cell in bf16 at head dim 128 (the backward
    kernel's) with remat, cut to batch 2 and length 256, its state and a
    seeded batch."""
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype="bfloat16",
                              d_head=128, remat="full", **replace)
    shape = {s.name: s for s in LM_SHAPES}["train_4k"]
    cell = steps._lm_cell(cfg, shape, device, batch=2, seq_len=256)
    r = np.random.default_rng(0)
    toks = r.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return cell, cell.init(0), cell.inputs({"tokens": toks,
                                            "labels": labels})


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_moe_train_step_reads_nothing_and_repeats_bit_equal_on_card(
        cuda_device, arch):
    """An MoE smoke arch's training step at capacity factor 1.0 (pairs
    dropped) under sync debug mode "error": 2L forward and L backward
    flash launches, nothing read from the device; the same step from the
    same state again gives the same loss, parameters and moments bit for
    bit (the combine's index_add_ sums one pair's gradient per slot and
    exact zeros)."""
    cell, (params, opt), batch = _lm_train_cell(arch, cuda_device,
                                                capacity_factor=1.0)
    start = [t.clone() for t in adamw.tree_leaves((params, opt.m, opt.v))]
    fmod.load_library()                 # the build, outside the mode
    torch.cuda.synchronize()
    fmod.flash_attention_cuda.launches = 0
    fmod.flash_attention_bwd_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, loss, _ = cell.step_fn(params, opt, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    L = cell.cfg.n_layers
    assert fmod.flash_attention_cuda.launches == 2 * L
    assert fmod.flash_attention_bwd_cuda.launches == L
    assert bool(torch.isfinite(loss))

    def step_from_start():
        p, o = cell.init(0)
        for a, b in zip(adamw.tree_leaves((p, o.m, o.v)), start):
            a.copy_(b)
        p, o, loss, _ = cell.step_fn(p, o, batch)
        return [loss] + adamw.tree_leaves((p, o.m, o.v))

    for a, b in zip(step_from_start(), step_from_start()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_moe_ffn_gradients_match_their_dense_check_on_card(cuda_device,
                                                           arch):
    """``_moe_ffn``'s gradients in h and every layer weight at capacity
    factor 1.0 in two groups against ``moe_ffn_dense``'s (h in float32
    there), under ``moe_check.moe_grad_excess``'s rule; the dense check at
    one slot fewer reads above it."""
    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype="bfloat16",
                              capacity_factor=1.0, moe_groups=2)
    lp = tf.layer_params(tf.init_params(cfg, seed=5, device=cuda_device), 0)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(2)
    x = torch.randn(2, 64, cfg.d_model, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    h = tf.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps).reshape(2, 64,
                                                            cfg.d_model)
    cot = torch.randn(h.shape, generator=g, device=cuda_device).to(
        torch.bfloat16).float()
    names = [n for n in ("router", "w_gate", "w_up", "w_down", "ws_gate",
                         "ws_up", "ws_down") if n in lp]

    def grads(fn, hh, **kw):
        hh = hh.detach().requires_grad_()
        w = {n: t.detach().requires_grad_() for n, t in lp.items()}
        out = fn(hh, w, cfg, **kw)
        out = out[0] if isinstance(out, tuple) else out
        return dict(zip(["h"] + names, torch.autograd.grad(
            out, [hh] + [w[n] for n in names], cot)))

    got = grads(tf._moe_ffn, h)
    want = grads(moe_check.moe_ffn_dense, h.float())
    assert max(moe_check.moe_grad_excess(got, want).values()) <= 1.0
    experts = tf.moe_route(h, lp["router"], cfg)[2]
    cap = moe_check.fault_capacity(experts, tf.moe_capacity(64, cfg),
                                   cfg.n_experts)
    fault = grads(moe_check.moe_ffn_dense, h.float(), capacity=cap)
    assert max(moe_check.moe_grad_excess(fault, want).values()) > 1.0


def test_qkv_bias_train_step_launches_the_backward_once_a_layer(cuda_device):
    """qwen1.5-32b's smoke model (QKV biases, MHA) in bf16 at head dim 128:
    a training step launches the flash forward 2L times and its backward
    L times, and its gradients, biases included, are within
    ``chip_smoke.py``'s 5e-2 relative L2 per leaf of the plain
    attention's."""
    cell, (params, opt), batch = _lm_train_cell("qwen1.5-32b", cuda_device)
    cfg = cell.cfg
    params["layers"]["bq"].normal_(0, 0.1)

    def grads(attn_impl):
        p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        tf.lm_loss(p, batch, cfg, attn_impl=attn_impl).backward()
        return p["layers"], adamw.tree_leaves(adamw.tree_map(
            lambda t: t.grad, p))

    layers, got = grads("auto")
    assert all(float(layers[b].grad.abs().max()) > 0
               for b in ("bq", "bk", "bv"))
    for a, b in zip(got, grads("blocked")[1]):
        assert float((a.float() - b.float()).norm()
                     / b.float().norm()) < 5e-2
    fmod.flash_attention_cuda.launches = 0
    fmod.flash_attention_bwd_cuda.launches = 0
    params, opt, loss, _ = cell.step_fn(params, opt, batch)
    torch.cuda.synchronize()
    assert fmod.flash_attention_cuda.launches == 2 * cfg.n_layers
    assert fmod.flash_attention_bwd_cuda.launches == cfg.n_layers
    assert bool(torch.isfinite(loss))
