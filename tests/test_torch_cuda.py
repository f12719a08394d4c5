"""Tests of the port that need the card: the hand-written CUDA edge-relax
kernel and megakernel against their plain PyTorch versions, the pipeline
on the kernel backend against the plain backend, the fused grow path
against the unfused one in both decomposition modes, the flash
attention kernel against its plain version, alone and inside the
transformer's prefill and decode, the CIN kernel against its plain
version, alone, in a stack and inside xDeepFM's forward and retrieval,
and the segment_mm kernel against its plain version in float64, alone and
inside the GCN forward (two launches per forward).
This file imports no JAX, so it runs where only the port is installed:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every test skips where there is no GPU (the kernel has no CPU mode)."""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.common import GraphEngineConfig
from repro_torch.config import GNN_SHAPES, get_arch
from repro_torch.core import ClusterQuotientEstimator, open_session
from repro_torch.graph import road_like, social_like
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
from repro_torch.kernels.segment_mm.ops import (csr_layout, segment_mm,
                                                segment_mm_csr)
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


@pytest.mark.parametrize("chunk", [1024, 7])
@pytest.mark.parametrize("name", sorted(SEGMM_CASES))
def test_segment_mm_matches_plain(cuda_device, name, chunk):
    """The float32 rule of ``kernels/segment_mm/cases.py`` against the plain
    version in float64; one launch per call; two launches bit-identical; at
    chunk 7 nearly every row is split across a block's warps."""
    x, src, dst, coeff, n = _segmm_case(name, cuda_device)
    layout = csr_layout(src, dst, n, chunk=chunk)
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
    if chunk == 1024:
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
    """The layout built on the card is the CPU's, edge for edge; what the
    kernel does not take raises."""
    x, src, dst, coeff, n = _segmm_case("hub-40000", cuda_device)
    dev_l = csr_layout(src, dst, n)
    cpu_l = csr_layout(src.cpu(), dst.cpu(), n)
    for f in ("row_ptr", "col", "row", "perm", "long_rows"):
        assert torch.equal(getattr(dev_l, f).cpu(), getattr(cpu_l, f)), f
    rp, col, lr, cs = dev_l.row_ptr, dev_l.col, dev_l.long_rows, \
        coeff[dev_l.perm]
    with pytest.raises(ValueError, match="float32"):
        smod.segment_mm_cuda(x.double(), rp, col, cs, lr, 1024)
    with pytest.raises(ValueError, match="D <="):
        smod.segment_mm_cuda(torch.zeros(n, 300, device=cuda_device), rp,
                             col, cs, lr, 1024)
    with pytest.raises(ValueError, match="contiguous"):
        smod.segment_mm_cuda(x.t().contiguous().t(), rp, col, cs, lr, 1024)
    with pytest.raises(ValueError, match="CUDA"):
        smod.segment_mm_cuda(x, rp.cpu(), col, cs, lr, 1024)
    empty = smod.segment_mm_cuda(x, rp[:1], col, cs, lr[:0], 1024)
    assert empty.shape == (0, x.shape[1])


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
