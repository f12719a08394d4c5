#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Builds the five hand-written CUDA kernels from the checkout's sources (one
``nvcc`` per kernel, started together), then:

  1. kernel vs plain: ``edge_relax`` on random graphs (n = 1, 257, 10,000,
     1,000,000), an RMAT graph (hub skew), weights up to 7 and 2^30 - 1,
     random Δ, covered nodes with negative offsets and INF/BIG sentinels,
     and at the main path's shapes (the n = 1,890,815 road graph). Every
     comparison is exact equality (all planes are int32).
  1b. megakernel vs plain: the same graphs with a frozen mask and a random
     frontier, K = 1, 8, 64, both variants, a ``half_target`` met inside a
     launch and a ``num_it`` cap; exact equality of the four planes AND the
     whole stats array. Timed at the main path's shapes (the road graph
     with the one-shot start planes) and on RMAT.
  2. the main path at the size of the DIMACS CAL road graph:
     ``road_like(1_890_815)`` through ``open_session(backend="kernel",
     tau=16)`` + ``ClusterQuotientEstimator``; the kernel's launch count
     must be > 0; the same query on ``backend="single"`` (plain PyTorch on
     the card) must give byte-identical final planes and an equal Phi.
  2b. the same query fused, ``GraphEngineConfig(fuse_supersteps=8)``: every
     grow call is one megakernel launch per 8 supersteps; byte-identical to
     the unfused kernel run of phase 2, equal Phi.
  2b'. draw spread: the stages decomposition alone for seeds 0-4, with k
     split into the drawn centers and the nodes left at the stop rule, from
     the reference's stream and from the port's pre-repair generator.
  2c. one-shot at full size: ``road_like(1_890_815)``, the session default
     tau (130), ``mode="oneshot"``, ``deterministic=True``, fused (8) and
     unfused; byte-identical planes and equal Phi.
  3. certified bracket: ``IntervalEstimator`` on ``road_like(65_536)``
     (lower <= upper) and on ``road_like(4_096)`` (lower <= scipy exact <=
     upper), stages and one-shot.
  4. flash attention vs plain: ``flash_attention_cuda`` against
     ``attention_ref`` in bf16 on the card, over the cases of
     ``kernels/flash_attention/cases.py`` (GQA groups 1 and 2, causal on
     and off, window 0 and 16, softcap 0 and 50, ``kv_len < Skv`` scalar
     and per row, ``q_offset > 0``, ragged lengths, fully masked rows,
     D = 16, 64, 128 and 256, B > 1), each element within that module's
     bf16 rule; at gemma2-9b's full-width prefill shapes (global and local
     layers) the same rule, which must also reject a planted fault there
     (a kv tile dropped); timed there beside the plain version and, as the
     yardstick, ``scaled_dot_product_attention`` on its flash backend at
     the causal variant without softcap or window.
  5. LM prefill at full width: gemma2-9b (9,241,404,928 parameters, random
     weights from seed 0), B = 1, S = 8192, through ``prefill_step``:
     exactly 42 flash attention launches (one per layer), finite logits,
     and their relative L2 error against the same prefill with the plain
     attention on the card.
  6. LM serving at full width: the port's serve launcher
     (``repro_torch.launch.serve``), gemma2-9b, batch 4, prompt 32, 16
     generated tokens.
  7. CIN vs plain: ``cin_layer_cuda`` against ``cin_layer_ref`` in float32
     on the card, over the cases of ``kernels/cin/cases.py`` (B = 1, 7,
     25, 37 and 512; m = 6 and 39; H = 6 to 200; H2 = 16 and 200; D = 8
     and 10; ragged last blocks), each within that module's rule
     (``|o - r| <= 2^-16 A``, A the layer on absolute values), which must
     reject a planted fault (one h slice of W dropped) at full width.
  8. CIN timed: xdeepfm's layer-1 (H = 39) and layer-2/3 (H = 200) shapes
     at B = 512, 16,384 and 262,144, beside the operations bound, the plain
     version and one ``torch.einsum`` call (the plain and library calls
     only where Z fits, B <= 16,384; float32, TF32 off).
  9. xDeepFM serving at full width: ``xdeepfm`` (39 fields, vocab
     1,000,000 per field, embed dim 10, CIN 200-200-200, DNN 400-400;
     432,747,202 parameter elements, random weights from seed 0), batches
     from ``RecsysPipeline(seed=0)``, through ``launch/steps.py``'s
     ``build_cell``: ``serve_p99`` (B = 512, 200 timed calls: median and
     p99) and ``serve_bulk`` (B = 262,144, 5 timed calls), each after one
     warm-up call and exactly 3 CIN launches per call. Then each CIN
     layer's kernel output over the whole batch (the shape the path
     launches it at) is held element by element against the plain layer
     under the rule, and so are the pooled features it gives against the
     plain stack's; the logits against the plain path's. The plain side
     runs in chunks of 16,384 rows so that its Z fits.
  10. Retrieval at full width: ``retrieval_cand``, one query against
     1,000,000 candidates (13 user and 26 item fields, from one
     ``RecsysPipeline`` batch), 3 timed calls after a warm-up, 3 CIN
     launches per call, checked as in phase 9 with the kernel at
     B = 1,000,000.
  11. segment_mm vs plain: ``segment_mm_cuda`` against ``segment_mm_ref``
     run in float64 on the card, over the cases of
     ``kernels/segment_mm/cases.py`` (the reference's sweep (N, E, D) =
     (100, 500, 32), (600, 2500, 64), (50, 2000, 128), (257, 513, 16);
     D = 1, 4, 7, 8 and 256; E = 0; N = 1; duplicates and self-loops;
     empty rows; a row at and one just past the chunk length; 40,000- and
     5,000-edge hubs), each at the default chunk (1,024) and at chunk 7
     (nearly every row split), each element within that module's rule
     (``|o - r| <= 16 u sqrt(K) A``, A the sum on absolute values, K the
     row's length), two launches bit-identical; both planted faults (an
     edge dropped from a row of average length, a chunk of the hub
     dropped) must read > 1; bad inputs raise before any launch.
  12. segment_mm timed: on the reference's ``ogb_products`` graph
     (2,449,029 nodes, 61,859,140 edges, from ``gnn_full_graph_batch``,
     seed 0) with gcn-cora's coefficients, at D = 16 and 7 (its two
     layers' widths): the kernel's ms per launch (CUDA events) beside the
     plain version's, ``torch.sparse.mm`` of the same CSR (the yardstick),
     the compulsory and the gathered byte bounds, and the hub row alone
     (39,485 edges), split and on one warp.
  13. GCN inference at full width: gcn-cora (d_hidden 16, d_out 7; random
     weights from seed 0) on ``ogb_products``, ``full_graph_sm`` and
     ``molecule`` (batches from the copied batch functions, seed 0), the
     graph and its layout resident on the card (the layout's build timed),
     one warm-up, then 10, 50 and 50 timed forwards (median and max seconds,
     nodes/s, peak bytes) with exactly 2 ``segment_mm`` launches per
     forward. Then each layer's launch at the path's own inputs is held
     under the rule against the float64 plain version, the rerun layers
     must give the timed logits bit for bit, the logits must lie within the
     chained rule (the forward on absolute values) of the plain path's,
     and the loss is printed beside the plain path's.

Prints one JSON line per phase, the kernel table, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores (same)
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
INF, BIG = 2**31 - 1, 2**30
CAL_NODES = 1_890_815           # DIMACS 9th Challenge USA-road-d.CAL


def _fail(msg: str, code: int) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return code


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_planes(n: int, wmax: int, seed: int, covered_frac=0.3,
                  live_frac=0.3):
    """Engine-like node planes: live nodes (d < 2 wmax), covered relays with
    negative offsets, INF/BIG sentinels elsewhere."""
    r = np.random.default_rng(seed)
    d = np.full(n, INF, np.int32)
    live = r.random(n) < live_frac
    d[live] = r.integers(0, min(2 * wmax, BIG), live.sum())
    c = np.full(n, INF, np.int32)
    c[live] = r.integers(0, max(n, 1), live.sum())
    p = np.full(n, INF, np.int32)
    p[live] = d[live]
    rw0 = np.full(n, BIG, np.int32)
    cov = (r.random(n) < covered_frac) & ~live
    rw0[cov] = r.integers(-wmax, 1, cov.sum())
    rc = np.full(n, INF, np.int32)
    rc[cov] = r.integers(0, max(n, 1), cov.sum())
    rp = np.full(n, INF, np.int32)
    rp[cov] = r.integers(0, min(4 * wmax, BIG), cov.sum())
    return d, c, p, rw0, rc, rp


def relax_bytes(torch, g, planes, delta) -> int:
    """Least bytes this superstep must move on these inputs: the CSR
    (row_ptr, src, w) and d, rw0 read once; c, pathw read once for the
    sources of admissible live edges and rc, rp for those of admissible
    relay edges; three output planes written once."""
    d, rw0 = planes[0], planes[3]
    src = g.src.to(torch.int64)
    ds, r0 = d[src], rw0[src]
    live = (ds < delta) & (g.w < delta)
    w_red = torch.clamp_min(g.w + torch.clamp_max(r0, BIG), 0)
    relay = (r0 < BIG) & (w_red < delta)
    n = g.n_nodes
    n_live = int(torch.unique(g.src[live & ~relay]).numel())
    n_relay = int(torch.unique(g.src[relay]).numel())
    return (4 * (n + 1) + 8 * g.n_edges + 8 * n + 8 * n_live + 8 * n_relay
            + 12 * n)


def mega_bytes(torch, g, planes, relay, frozen, front, delta,
               n_changed: int, n_marks: int) -> int:
    """Least bytes one fused superstep must move on these inputs, counted as
    ``relax_bytes`` counts: every row reads its frozen and dirty bytes and
    writes its front byte; a row that runs (not frozen, some source on the
    frontier) reads its two row_ptr entries, src and w of each in-edge, d
    and rw0 of its sources (once per source), c/pathw or rc/rp of the
    admissible ones, and its own d; a changed row writes d, c, pathw, reads
    its two out_ptr entries and its out-edges' destinations, and writes
    their dirty bytes. Skipped rows move only their flag bytes."""
    n = g.n_nodes
    src, dst = g.src.to(torch.int64), g.dst.to(torch.int64)
    live = ~frozen
    hits = torch.zeros(n, dtype=torch.int32, device=src.device).index_add_(
        0, dst, front.to(torch.int32)[src])
    runs = live & (hits > 0)
    e_run = runs[dst]
    s_run = src[e_run]
    ds, r0, w = planes[0][s_run], relay[0][s_run], g.w[e_run]
    live_ok = (ds < delta) & (w < delta)
    w_red = torch.clamp_min(w + torch.clamp_max(r0, BIG), 0)
    relay_ok = (r0 < BIG) & (w_red < delta)
    n_src = int(torch.unique(s_run).numel())
    n_live = int(torch.unique(s_run[live_ok & ~relay_ok]).numel())
    n_relay = int(torch.unique(s_run[relay_ok]).numel())
    return (3 * n + 12 * int(runs.sum()) + 8 * int(e_run.sum())
            + 8 * n_src + 8 * n_live + 8 * n_relay
            + 20 * n_changed + 5 * n_marks)


def mega_launch_bytes(torch, mk, g, planes, relay, frozen, front, params,
                      k: int) -> int:
    """``mega_bytes`` summed over the supersteps one launch of ``k``
    executes on these inputs (stepped one superstep at a time with the
    plain version, under the same stop rule)."""
    total = 0
    for j in range(k):
        p = params._replace(steps_base=params.steps_base + j)
        d, c, pw, f, st = mk.fused_grow_supersteps_plain(
            planes, relay, frozen, front, g, p, 1)
        if int(st[1, mk.COL_EXECUTED]) == 0:
            break
        n_changed = int(st[0, mk.COL_CHANGED])
        out_ptr, _ = g.out_csr()
        out_deg = (out_ptr[1:] - out_ptr[:-1]).to(torch.int64)
        marks = int(out_deg[f.bool()].sum())
        total += mega_bytes(torch, g, planes, relay, frozen, front,
                            params.delta, n_changed, marks)
        planes, front = (d, c, pw), f
        if n_changed == 0:
            break
    return total


def profile_paths() -> int:
    """``--profile``: the decompositions of the main paths (stages fused;
    one-shot fused and unfused), then gemma2-9b's full-width prefill
    (B = 1, S = 8192) and 8 decode steps (batch 4), then one xdeepfm
    ``serve_bulk`` forward (B = 262,144, full width), then 5 gcn-cora
    forwards on ``ogb_products`` (2,449,029 nodes), under
    ``torch.profiler``, each after a warm-up run, printing the device-busy
    share of the host-clock time, the device ops launched and the kernels
    that take the device time. Not part of the default run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False", 2)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.common import Timer
    from repro_torch.config import GNN_SHAPES, RECSYS_SHAPES, get_arch
    from repro_torch.core import cluster, make_backend, tau_for
    from repro_torch.data.pipeline import (DataCursor, RecsysPipeline,
                                           gnn_full_graph_batch)
    from repro_torch.graph import road_like
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import gnn, recsys
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda:0")

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    def profiled(run) -> tuple:
        run()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with Timer() as t:
                out = run()
                torch.cuda.synchronize()
        with Timer() as t_plain:
            run()
            torch.cuda.synchronize()
        # device-side events only (kernels, copies, fills): an operator's
        # row repeats the device time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in events) / 1e6
        top = sorted(events, key=dev_us, reverse=True)[:12]
        return out, {"seconds_profiled": t.seconds,
                     "seconds_unprofiled": t_plain.seconds,
                     "device_busy_seconds": busy,
                     "idle_share": 1.0 - busy / t.seconds,
                     "device_ops": sum(e.count for e in events),
                     "top": [[e.key[:80], dev_us(e) / 1e3, e.count]
                             for e in top]}

    edges = road_like(CAL_NODES, seed=0)
    for name, mode, tau, fuse in (
            ("stages_fused", "stages", 16, 8),
            ("oneshot_fused", "oneshot", tau_for(CAL_NODES), 8),
            ("oneshot_unfused", "oneshot", tau_for(CAL_NODES), 0)):
        backend = make_backend(edges, "kernel", device=dev, fuse=fuse)
        dec, stats = profiled(lambda: cluster(
            edges, tau, backend=backend, mode=mode, deterministic=True))
        emit({"phase": "profile", "path": name,
              "supersteps": dec.growing_steps, **stats})
    del edges, backend, dec
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_arch("gemma2-9b")
    params = tf.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen,
                           device=dev)
    _, stats = profiled(lambda: tf.prefill_step(params, tokens, cfg))
    emit({"phase": "profile", "path": "lm_prefill", "seq": SEQ, **stats})
    steps = 8
    cache = tf.init_cache(cfg, 4, steps, device=dev)
    tok = tokens[0, :4, None]

    def decode():
        c = {**cache, "len": 0}
        for _ in range(steps):
            _, c = tf.decode_step(params, c, tok, cfg)

    _, stats = profiled(decode)
    emit({"phase": "profile", "path": "lm_decode", "batch": 4,
          "steps": steps, **stats})
    del params, cache, tokens, tok
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_arch("xdeepfm")
    params = recsys.init_params(cfg, seed=0, device=dev)
    cell = build_cell("xdeepfm", "serve_bulk", device=dev)
    shape = {s.name: s for s in RECSYS_SHAPES}["serve_bulk"]
    batch = cell.inputs(RecsysPipeline(cfg, shape, seed=0).batch(
        DataCursor()))
    _, stats = profiled(lambda: cell.step_fn(params, batch))
    emit({"phase": "profile", "path": "recsys_serve_bulk",
          "batch": shape.batch, **stats})
    del params, cell, batch
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_arch("gcn-cora")
    shape = {s.name: s for s in GNN_SHAPES}["ogb_products"]
    graph = gnn.resident_graph(gnn_full_graph_batch(cfg, shape, seed=0),
                               device=dev)
    params = gnn.init_gnn(cfg, shape.d_feat,
                          torch.Generator(device=dev).manual_seed(0))
    forwards = 5   # one forward is a 8 ms window; five make it 40 ms

    def gnn_forwards():
        for _ in range(forwards):
            gnn.gnn_forward(params, graph, cfg)

    _, stats = profiled(gnn_forwards)
    emit({"phase": "profile", "path": "gnn_forward_ogb_products",
          "nodes": shape.n_nodes, "edges": shape.n_edges,
          "forwards": forwards, **stats})
    return 0


SEQ = 8192                      # the full-width prefill's length
GEMMA2_PARAMS = 9_241_404_928   # TransformerConfig.param_count() at full width


def unmasked_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask leaves, per (batch row, query head), with the
    queries at positions 0 .. sq-1 and every key valid."""
    total = 0
    for qpos in range(sq):
        hi = min(skv, qpos + 1) if causal else skv
        lo = max(0, qpos - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def attention_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, window) -> tuple:
    """Least time for one attention forward on these shapes: 4 D flops per
    unmasked pair and query head over the bf16 tensor-core peak, or the
    bytes of q, k, v read once and o written once over HBM; the larger,
    and which of the two bounds it."""
    flops = 4 * D * Hq * B * unmasked_pairs(Sq, Skv, causal, window)
    nbytes = 2 * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def rel_l2(torch, a, b, chunk: int = 512) -> float:
    """||a - b|| / ||b|| over the last-but-one axis in chunks (no full-size
    difference tensor), in float64."""
    num = den = 0.0
    for i in range(0, a.shape[-2], chunk):
        x = a[..., i:i + chunk, :].double()
        y = b[..., i:i + chunk, :].double()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    if den == 0:       # b is all zero (rows with no valid key)
        return 0.0 if num == 0 else float("inf")
    return (num / den) ** 0.5


def lm_phases(torch, dev) -> dict:
    """Phases 4-6; returns the flash attention row of the kernel table."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.common import Timer
    from repro_torch.config import get_arch
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.flash_attention.cases import (CASES,
                                                           bf16_excess,
                                                           case_kwargs,
                                                           planted_fault)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    # -- phase 4: flash attention vs plain, bf16 ------------------------------
    # the rule (cases.py): |o - r| <= 2^-7 |r| + 2^-8 max|r| of r's row, read
    # as "excess", the largest error over its allowance (pass at <= 1)
    flash_err = flash_excess = 0.0
    for name, case in CASES.items():
        B, Hq, Hkv, Sq, Skv, D, *_, qs = case
        q, k, v = (randn(B, Hq, Sq, D, scale=qs), randn(B, Hkv, Skv, D),
                   randn(B, Hkv, Skv, D))
        kw = case_kwargs(case, dev)
        out = fmod.flash_attention_cuda(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        excess = bf16_excess(out, ref)
        flash_err, flash_excess = max(flash_err, err), max(flash_excess,
                                                           excess)
        if not (excess <= 1.0 and torch.isfinite(out).all()):
            raise AssertionError(f"flash attention {name}: kernel vs plain "
                                 f"error {excess} times the bf16 rule's")
        emit({"phase": "flash_vs_plain", "case": name,
              "shape": [B, Hq, Hkv, Sq, Skv, D], "causal": kw["causal"],
              "window": kw["window"], "softcap": kw["softcap"],
              "max_abs_err": err, "excess": excess,
              "rel_l2": rel_l2(torch, out, ref), "equal_within": True})

    # timed at the full-width prefill's shapes: gemma2-9b, B = 1, S = 8192.
    # The rule must also reject a planted fault there: query tiles from row
    # 4,096 on skip the first kv tile they would visit (a global row loses
    # keys 0-63 of its 4,097 to 8,192; a local row, up to 63 of its 4,096,
    # in the tile the window's edge cuts)
    cfg = get_arch("gemma2-9b")
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = D ** -0.5
    q, k, v = randn(1, Hq, SEQ, D), randn(1, Hkv, SEQ, D), randn(1, Hkv,
                                                                 SEQ, D)
    timed = {}
    for layer, window in (("global", 0), ("local", cfg.sliding_window)):
        kw = dict(causal=True, window=window, softcap=cfg.attn_logit_softcap,
                  scale=scale)
        out = fmod.flash_attention_cuda(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
        err = float((out.float() - ref.float()).abs().max())
        excess = bf16_excess(out, ref)
        bad = planted_fault(q, k, v, from_row=SEQ // 2, window=window,
                            softcap=cfg.attn_logit_softcap, scale=scale)
        fault_excess = bf16_excess(bad, ref)
        fault_err = float((bad.float() - ref.float()).abs().max())
        fault_rel_l2 = rel_l2(torch, bad, ref)
        # the rule this one replaced: 2^-6 of the tensor's largest |r|
        global_tol = 2.0 ** -6 * max(1.0, float(ref.float().abs().max()))
        if excess > 1.0:
            raise AssertionError(f"flash attention full width {layer}: "
                                 f"error {excess} times the bf16 rule's")
        if fault_excess <= 1.0:
            raise AssertionError(f"flash attention full width {layer}: the "
                                 f"bf16 rule passed a dropped kv tile")
        flash_err, flash_excess = max(flash_err, err), max(flash_excess,
                                                           excess)
        sound_rel_l2 = rel_l2(torch, out, ref)
        del out, ref, bad
        bound, by, flops = attention_bound_ms(1, Hq, Hkv, SEQ, SEQ, D, True,
                                              window)
        row = {"phase": "flash_timed", "layer": layer,
               "shape": [1, Hq, Hkv, SEQ, SEQ, D], "window": window,
               "softcap": cfg.attn_logit_softcap, "max_abs_err": err,
               "excess": excess, "rel_l2": sound_rel_l2,
               "planted_fault": {"excess": fault_excess,
                                 "max_abs_err": fault_err,
                                 "rel_l2": fault_rel_l2,
                                 "global_rule_tolerance": global_tol},
               "ms": time_ms(torch, lambda: fmod.flash_attention_cuda(
                   q, k, v, **kw), 20),
               "plain_ms": time_ms(torch, lambda: attention_ref(q, k, v,
                                                                **kw), 3),
               "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9}
        row["tflop_s"] = flops / row["ms"] / 1e9
        row["bound_share"] = bound / row["ms"]
        timed[layer] = row
        emit(row)
    # the yardstick: SDPA's flash backend computes causal attention without
    # softcap or window; k and v are expanded to 16 heads outside the timing
    kk, vv = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        sdpa_ms = time_ms(torch, lambda: torch.nn.functional.
                          scaled_dot_product_attention(q, kk, vv,
                                                       is_causal=True,
                                                       scale=scale), 20)
    same_variant_ms = time_ms(torch, lambda: fmod.flash_attention_cuda(
        q, k, v, causal=True, scale=scale), 20)
    emit({"phase": "flash_yardstick", "variant": "causal, no softcap, "
          "no window", "library": "scaled_dot_product_attention",
          "backend": "SDPBackend.FLASH_ATTENTION (forced)",
          "library_ms": sdpa_ms, "kernel_ms": same_variant_ms,
          "bound_ms": timed["global"]["bound_ms"]})
    del q, k, v, kk, vv

    # -- phase 5: LM prefill at full width ------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    with Timer() as t_init:
        params = tf.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
    n_params = sum(x.numel() for x in params["layers"].values()) \
        + params["embed"].numel() + params["final_norm"].numel()
    if n_params != cfg.param_count() or n_params != GEMMA2_PARAMS:
        raise AssertionError(f"gemma2-9b has {n_params} parameters")
    weight_bytes = torch.cuda.memory_allocated(dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen,
                           device=dev)
    tf.prefill_step(params, tokens[:, :256], cfg)        # warm-up (cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fmod.flash_attention_cuda.launches = 0
    with Timer() as t_pre:
        logits = tf.prefill_step(params, tokens, cfg)
        torch.cuda.synchronize()
    prefill_launches = fmod.flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if prefill_launches != cfg.n_layers:
        raise AssertionError(f"prefill launched flash attention "
                             f"{prefill_launches} times, not {cfg.n_layers}")
    if tuple(logits.shape) != (1, SEQ, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are malformed or not finite")
    with Timer() as t_plain:
        logits_plain = tf.prefill_step(params, tokens, cfg, attn_impl="ref")
        torch.cuda.synchronize()
    if fmod.flash_attention_cuda.launches != prefill_launches:
        raise AssertionError("the plain prefill launched the kernel")
    # bound: the kernel path and the plain attention differ only in the
    # attention outputs' bf16 rounding (one ulp), carried through 42 layers
    err = rel_l2(torch, logits, logits_plain)
    if not err < 5e-2:
        raise AssertionError(f"prefill logits: relative L2 error {err} "
                             f"against the plain attention")
    emit({"phase": "lm_prefill", "arch": cfg.name, "params": n_params,
          "batch": 1, "seq": SEQ, "layers": cfg.n_layers,
          "flash_launches": prefill_launches, "init_seconds": t_init.seconds,
          "weight_bytes": weight_bytes, "seconds": t_pre.seconds,
          "tok_s": SEQ / t_pre.seconds, "peak_bytes": peak,
          "logits_finite": True, "plain_attention_seconds": t_plain.seconds,
          "rel_l2_vs_plain_attention": err, "rel_l2_bound": 5e-2,
          "attention_ms_in_prefill": 21 * (timed["global"]["ms"]
                                           + timed["local"]["ms"])})
    del params, logits, logits_plain, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 6: LM serving at full width through the launcher --------------
    fmod.flash_attention_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    args = serve.parse_args(["--arch", "gemma2-9b", "--batch", "4",
                             "--prompt-len", "32", "--gen", "16",
                             "--device", str(dev)])
    res = serve.serve_lm(args)
    serve_launches = fmod.flash_attention_cuda.launches
    ids = res.pop("ids")
    if tuple(ids.shape) != (4, 16) or not res["logits_finite"] \
            or not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise AssertionError("serve: malformed ids or non-finite logits")
    step_bound_ms = 1e3 * 2 * cfg.param_count() / HBM_BYTES_PER_S
    emit({"phase": "lm_serve", **res, "ids0": ids[0, :8].tolist(),
          "flash_launches": serve_launches,
          "peak_bytes": torch.cuda.max_memory_allocated(dev),
          "decode_step_bound_ms": step_bound_ms})

    g, loc = timed["global"], timed["local"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:36",
            "launches": prefill_launches, "max_abs_err": flash_err,
            "bf16_rule_excess": flash_excess,
            "ms": g["ms"], "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "library_ms": sdpa_ms,
            "library_variant": "scaled_dot_product_attention (flash "
                               "backend), causal, no softcap, no window",
            "ms_at_library_variant": same_variant_ms,
            "local_ms": loc["ms"], "local_plain_ms": loc["plain_ms"],
            "local_bound_ms": loc["bound_ms"],
            "launches_by_path": {"lm_prefill": prefill_launches,
                                 "lm_serve": serve_launches}}


XDEEPFM_PARAMS = 432_747_202     # parameter elements at full width
XDEEPFM_PARAM_COUNT = 393_747_201  # RecsysConfig.param_count(): the
#                                    reference's count, without the linear
#                                    table and the last layer's bias


def cin_bound_ms(B, m, H, H2, D) -> tuple:
    """Least time for one CIN layer on these shapes: 2 H2 H m D flops per
    batch row over the float32 FMA peak, or x0, xk and W read once and out
    written once over HBM; the larger, and which of the two bounds it."""
    flops = 2 * B * H2 * H * m * D
    nbytes = 4 * (B * m * D + B * H * D + H2 * H * m + B * H2 * D)
    t_ops, t_bytes = flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def recsys_phases(torch, dev) -> dict:
    """Phases 7-10; returns the CIN row of the kernel table."""
    from repro_torch.common import Timer
    from repro_torch.config import RECSYS_SHAPES, get_arch
    from repro_torch.data.pipeline import DataCursor, RecsysPipeline
    from repro_torch.kernels.cin import kernel as cmod
    from repro_torch.kernels.cin.cases import (CASES, FAULT_CASE,
                                               PLAIN_CHUNK, case_inputs,
                                               excess, layer_excess,
                                               planted_fault,
                                               pooled_magnitude)
    from repro_torch.kernels.cin.ops import cin
    from repro_torch.kernels.cin.ref import cin_layer_ref
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys

    # float32 products in full float32 (the default, set here explicitly:
    # the library yardstick and the DNN's matmuls read it)
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 7: CIN vs plain, float32 ----------------------------------------
    cin_err = cin_excess = 0.0
    for name, case in CASES.items():
        x0, xk, w = (torch.from_numpy(a).to(dev) for a in case_inputs(case))
        out = cmod.cin_layer_cuda(x0, xk, w)
        ref = cin_layer_ref(x0, xk, w)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ex = layer_excess(out, ref, x0, xk, w)
        cin_err, cin_excess = max(cin_err, err), max(cin_excess, ex)
        if not (ex <= 1.0 and bool(torch.isfinite(out).all())):
            raise AssertionError(f"cin {name}: kernel vs plain error {ex} "
                                 f"times the float32 rule's")
        emit({"phase": "cin_vs_plain", "case": name, "shape": list(case),
              "max_abs_err": err, "excess": ex, "equal_within": True})
    # the rule must reject a dropped h slice at full width (B = 512, H = 200)
    x0, xk, w = (torch.from_numpy(a).to(dev)
                 for a in case_inputs(FAULT_CASE))
    ref = cin_layer_ref(x0, xk, w)
    fault = {}
    for h in (0, FAULT_CASE[2] // 2, FAULT_CASE[2] - 1):
        bad = planted_fault(x0, xk, w, h=h)
        fault[h] = layer_excess(bad, ref, x0, xk, w)
        if fault[h] <= 1.0:
            raise AssertionError(f"cin: the float32 rule passed a dropped h "
                                 f"slice ({h})")
    emit({"phase": "cin_planted_fault", "shape": list(FAULT_CASE),
          "dropped_h": list(fault), "excess": list(fault.values()),
          "sound_excess": layer_excess(cmod.cin_layer_cuda(x0, xk, w), ref,
                                       x0, xk, w)})
    del x0, xk, w, ref, bad, out

    # -- phase 8: CIN timed at xdeepfm's layer shapes --------------------------
    cfg = get_arch("xdeepfm")
    m, D, H2 = cfg.n_sparse, cfg.embed_dim, cfg.cin_layers[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timed = {}
    for layer, H in (("layer1", m), ("layer2", cfg.cin_layers[0])):
        for B in (512, PLAIN_CHUNK, 262_144):
            x0 = torch.randn(B, m, D, generator=gen, device=dev) * 0.01
            xk = torch.randn(B, H, D, generator=gen, device=dev) * 0.01
            w = torch.randn(H2, H, m, generator=gen, device=dev) \
                * (H * m) ** -0.5
            out = cmod.cin_layer_cuda(x0, xk, w)
            ref = torch.cat([cin_layer_ref(x0[i:i + PLAIN_CHUNK],
                                           xk[i:i + PLAIN_CHUNK], w)
                             for i in range(0, B, PLAIN_CHUNK)])
            ex = layer_excess(out, ref, x0, xk, w)
            if ex > 1.0:
                raise AssertionError(f"cin timed {layer} B={B}: error {ex} "
                                     f"times the float32 rule's")
            cin_excess = max(cin_excess, ex)
            del out, ref
            bound, by, flops = cin_bound_ms(B, m, H, H2, D)
            row = {"phase": "cin_timed", "layer": layer,
                   "shape": [B, m, H, H2, D], "excess": ex,
                   "ms": time_ms(torch, lambda: cmod.cin_layer_cuda(
                       x0, xk, w), 20 if B <= PLAIN_CHUNK else 3, warmup=1),
                   "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9,
                   "plain_ms": None, "library_ms": None}
            if B <= PLAIN_CHUNK:   # where Z fits
                row["plain_ms"] = time_ms(
                    torch, lambda: cin_layer_ref(x0, xk, w), 5, warmup=1)
                row["library_ms"] = time_ms(
                    torch, lambda: torch.einsum("bhd,bmd,nhm->bnd", xk, x0,
                                                w), 5, warmup=1)
            row["tflop_s"] = flops / row["ms"] / 1e9
            row["bound_share"] = bound / row["ms"]
            timed[(layer, B)] = row
            emit(row)
            del x0, xk, w
            torch.cuda.empty_cache()

    # -- phase 9: xDeepFM serving at full width ---------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    with Timer() as t_init:
        params = recsys.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
    n_params = (params["tables"].numel() + params["linear"].numel()
                + sum(x.numel() for x in params["cin"])
                + params["cin_out"].numel() + params["bias"].numel()
                + sum(lp["w"].numel() + lp["b"].numel()
                      for lp in params["mlp"]))
    if n_params != XDEEPFM_PARAMS or cfg.param_count() != XDEEPFM_PARAM_COUNT:
        raise AssertionError(f"xdeepfm has {n_params} parameter elements, "
                             f"param_count() {cfg.param_count()}")
    weight_bytes = torch.cuda.memory_allocated(dev)
    n_cin = len(cfg.cin_layers)

    def check_against_plain(cell, fb, logits):
        """The kernel at the shape the path launched it, against the plain
        version: each CIN layer's kernel output over all of ``fb``'s rows
        (one launch per layer, on the kernel's own previous output) against
        the plain layer on the same inputs, element by element under the
        rule; the pooled features those outputs give against the plain
        stack's; the logits against the plain path's. The plain side runs
        in slices of PLAIN_CHUNK rows so that its Z fits."""
        B = logits.shape[0]
        chunks = [slice(i, i + PLAIN_CHUNK) for i in range(0, B, PLAIN_CHUNK)]
        emb = recsys.embedding_bag(params["tables"], fb["ids"], fb["id_mask"])
        if emb.shape[0] != B:
            raise AssertionError("the plain check's batch is not the path's")
        layer_ex, xk, pooled = 0.0, emb, []
        for w in params["cin"]:
            out = cmod.cin_layer_cuda(emb, xk, w)
            for s in chunks:
                layer_ex = max(layer_ex, layer_excess(
                    out[s], cin_layer_ref(emb[s], xk[s], w), emb[s], xk[s],
                    w))
            pooled.append(out.sum(dim=-1))
            xk = out
        del xk, out
        pooled = torch.cat(pooled, dim=-1)
        pooled_ex = logit_diff = 0.0
        for s in chunks:
            pooled_ex = max(pooled_ex, excess(
                pooled[s], cin(emb[s], params["cin"], impl="ref"),
                pooled_magnitude(emb[s], params["cin"])))
            plain = recsys.forward(params, {k: v[s] for k, v in fb.items()},
                                   cell.cfg, cin_impl="ref")
            logit_diff = max(logit_diff,
                             float((logits[s] - plain).abs().max()))
        # the two paths differ only in the CIN branch, which adds about
        # 1e-5 to a logit of order 1: its own error is far below an ulp
        if layer_ex > 1.0 or pooled_ex > 1.0 or not logit_diff < 1e-5:
            raise AssertionError(f"{cell.shape}: CIN layers at {layer_ex} "
                                 f"and pooled features at {pooled_ex} times "
                                 f"the rule, logits {logit_diff} from the "
                                 f"plain path")
        return layer_ex, pooled_ex, logit_diff

    def timed_calls(cell, inputs, n):
        """One warm-up call, then ``n`` calls of the cell's step, each on the
        host clock and ending in a synchronize, with the CIN launch count
        set to 0 just before them and the peak memory reset. Returns the
        last output and the timing fields of the phase's row."""
        cell.step_fn(params, inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cmod.cin_layer_cuda.launches = 0
        secs = []
        for _ in range(n):
            with Timer() as t:
                out = cell.step_fn(params, inputs)
                torch.cuda.synchronize()
            secs.append(t.seconds)
        launches = cmod.cin_layer_cuda.launches
        if launches != n_cin * n:
            raise AssertionError(f"{cell.shape}: {launches} CIN launches in "
                                 f"{n} calls, not {n_cin} per call")
        return out, {"calls": n, "seconds_median": float(np.median(secs)),
                     "seconds_p99": float(np.percentile(secs, 99)),
                     "seconds_min": min(secs), "seconds_max": max(secs),
                     "cin_launches": launches,
                     "cin_launches_per_call": launches // n,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev)}

    launches_by_path = {}
    for shape_name, n_calls in (("serve_p99", 200), ("serve_bulk", 5)):
        cell = build_cell("xdeepfm", shape_name, device=dev)
        shape = {s.name: s for s in RECSYS_SHAPES}[shape_name]
        batch = cell.inputs(RecsysPipeline(cfg, shape, seed=0).batch(
            DataCursor()))
        logits, timing = timed_calls(cell, batch, n_calls)
        B = shape.batch
        if tuple(logits.shape) != (B,) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{shape_name}: logits malformed or not "
                                 f"finite")
        with Timer() as t_check:
            layer_ex, pooled_ex, logit_diff = check_against_plain(
                cell, batch, logits)
        cin_excess = max(cin_excess, layer_ex, pooled_ex)
        launches_by_path[shape_name] = timing["cin_launches"]
        emit({"phase": "recsys_serve", "arch": cfg.name, "shape": shape_name,
              "batch": B, "params": n_params,
              "param_count": cfg.param_count(),
              "init_seconds": t_init.seconds, "weight_bytes": weight_bytes,
              **timing, "rows_s": B / timing["seconds_median"],
              "cin_layer_excess": layer_ex, "cin_pooled_excess": pooled_ex,
              "logits_max_abs_diff_vs_plain": logit_diff,
              "logits_finite": True, "logits0": logits[:4].tolist(),
              "check_seconds": t_check.seconds})
        del batch, logits
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase 10: retrieval, 1 query x 1,000,000 candidates ------------------
    # the query: row 0's user fields (the first n_sparse // 3) and dense
    # features; the candidates: every row's item fields, all from one
    # RecsysPipeline batch of n_candidates rows (its Zipf ids, seed 0)
    cell = build_cell("xdeepfm", "retrieval_cand", device=dev)
    n_cand = cell.arg_shapes["cand_ids"][0][0]
    fu = cell.arg_shapes["user_ids"][0][1]
    shape = {s.name: s for s in RECSYS_SHAPES}["retrieval_cand"]
    rows = RecsysPipeline(cfg, dataclasses.replace(shape, batch=n_cand),
                          seed=0).batch(DataCursor())
    q = cell.inputs({"user_ids": rows["ids"][:1, :fu],
                     "user_mask": rows["id_mask"][:1, :fu],
                     "user_dense": rows["dense"][:1],
                     "cand_ids": rows["ids"][:, fu:],
                     "cand_mask": rows["id_mask"][:, fu:]})
    del rows
    scores, timing = timed_calls(cell, q, 3)
    if tuple(scores.shape) != (n_cand,) or not bool(
            torch.isfinite(scores).all()):
        raise AssertionError("retrieval: scores malformed or not finite")
    with Timer() as t_check:
        layer_ex, pooled_ex, score_diff = check_against_plain(
            cell, recsys.retrieval_batch(
                q["user_ids"], q["user_mask"], q["user_dense"],
                q["cand_ids"], q["cand_mask"]), scores)
    cin_excess = max(cin_excess, layer_ex, pooled_ex)
    launches_by_path["retrieval_cand"] = timing["cin_launches"]
    emit({"phase": "recsys_retrieval", "arch": cfg.name,
          "shape": "retrieval_cand", "candidates": n_cand,
          "user_fields": cell.arg_shapes["user_ids"][0][1],
          "item_fields": cell.arg_shapes["cand_ids"][0][1],
          **timing, "candidates_s": n_cand / timing["seconds_median"],
          "cin_layer_excess": layer_ex, "cin_pooled_excess": pooled_ex,
          "scores_max_abs_diff_vs_plain": score_diff,
          "top5": torch.topk(scores, 5).indices.tolist(),
          "check_seconds": t_check.seconds})
    del params, q, scores
    gc.collect()
    torch.cuda.empty_cache()

    p99_l1, p99_l2 = timed[("layer1", 512)], timed[("layer2", 512)]
    bulk_l1 = timed[("layer1", 262_144)]
    bulk_l2 = timed[("layer2", 262_144)]
    mid_l2 = timed[("layer2", PLAIN_CHUNK)]
    return {"name": "cin", "route": "cuda",
            "source": "src/repro_torch/kernels/cin/csrc/cin.cu",
            "replaces": "src/repro/kernels/cin/kernel.py:26",
            "launches": sum(launches_by_path.values()),
            "max_abs_err": cin_err, "float32_rule_excess": cin_excess,
            "shape": "layer 2/3 at serve_p99 (B 512, m 39, H 200, H2 200, "
                     "D 10)",
            "ms": p99_l2["ms"], "plain_ms": p99_l2["plain_ms"],
            "bound_ms": p99_l2["bound_ms"], "bound_by": p99_l2["bound_by"],
            "library_ms": p99_l2["library_ms"],
            "library_call": "torch.einsum('bhd,bmd,nhm->bnd', xk, x0, w), "
                            "float32, TF32 off",
            "layer1_ms": p99_l1["ms"], "layer1_bound_ms": p99_l1["bound_ms"],
            "layer1_plain_ms": p99_l1["plain_ms"],
            "layer1_library_ms": p99_l1["library_ms"],
            "b16384_ms": mid_l2["ms"], "b16384_plain_ms": mid_l2["plain_ms"],
            "b16384_library_ms": mid_l2["library_ms"],
            "b16384_bound_ms": mid_l2["bound_ms"],
            "serve_bulk_ms": bulk_l2["ms"],
            "serve_bulk_bound_ms": bulk_l2["bound_ms"],
            "serve_bulk_layer1_ms": bulk_l1["ms"],
            "serve_bulk_layer1_bound_ms": bulk_l1["bound_ms"],
            "launches_by_path": launches_by_path}


def segmm_bytes(n_rows: int, n_src: int, n_edges: int, d: int) -> tuple:
    """Least bytes one ``segment_mm`` launch must move on a CSR of
    ``n_rows`` rows and ``n_edges`` edges over ``x`` [n_src, d], float32:
    compulsory (row_ptr, col, coeff and x read once, y written once) and
    gathered (x read once per edge instead)."""
    fixed = 8 * (n_rows + 1) + 8 * n_edges + 4 * d * n_rows
    return fixed + 4 * d * n_src, fixed + 4 * d * n_edges


def segmm_bound_ms(n_rows: int, n_src: int, n_edges: int, d: int) -> tuple:
    """The compulsory and gathered bounds in ms: the larger of the bytes
    over HBM and the 2 E D flops over the float32 peak (the bytes, by far)."""
    compulsory, gathered = segmm_bytes(n_rows, n_src, n_edges, d)
    t_ops = 2 * n_edges * d / F32_FLOPS_PER_S
    return (1e3 * max(compulsory / HBM_BYTES_PER_S, t_ops),
            1e3 * max(gathered / HBM_BYTES_PER_S, t_ops))


def gnn_phases(torch, dev) -> dict:
    """Phases 11-13; returns the segment_mm row of the kernel table."""
    from repro_torch.common import Timer
    from repro_torch.config import GNN_SHAPES, get_arch
    from repro_torch.data.pipeline import (gnn_full_graph_batch,
                                           gnn_molecule_batch)
    from repro_torch.kernels.segment_mm import kernel as smod
    from repro_torch.kernels.segment_mm.cases import (CASES, FAULT_CASE,
                                                      case_inputs,
                                                      chain_excess,
                                                      chain_magnitude,
                                                      drop_one_chunk,
                                                      drop_one_edge,
                                                      rule_excess)
    from repro_torch.kernels.segment_mm.ops import (CHUNK, csr_layout,
                                                    segment_mm_csr)
    from repro_torch.kernels.segment_mm.ref import segment_mm_ref
    from repro_torch.models import gnn

    # float32 products in full float32 (the default, set here explicitly:
    # the GCN's x @ W reads it)
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = excess_worst = 0.0

    def held(out, x, col, row, coeff, n, what, exact=None):
        """``out`` against the plain version in float64 (``exact``, computed
        here if not given) on the same CSR edges, under the rule; the
        largest |error| and the excess."""
        if exact is None:
            exact = segment_mm_ref(x.double(), col, row, coeff.double(), n)
        err = float((out.double() - exact).abs().max()) if out.numel() else 0.0
        ex = rule_excess(out, exact, x, col, row, coeff, n)
        if not (ex <= 1.0 and bool(torch.isfinite(out).all())):
            raise AssertionError(f"segment_mm {what}: kernel vs float64 plain "
                                 f"error {ex} times the float32 rule's")
        return err, ex

    # -- phase 11: segment_mm vs plain (float64), the shared cases ----------
    for name in CASES:
        x, src, dst, coeff, n = case_inputs(name)
        x, src, dst, coeff = (torch.from_numpy(a).to(dev)
                              for a in (x, src, dst, coeff))
        for chunk in (CHUNK, 7):
            layout = csr_layout(src, dst, n, chunk=chunk)
            cs = coeff[layout.perm]
            out = segment_mm_csr(x, layout, cs)
            again = segment_mm_csr(x, layout, cs)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"segment_mm {name}: two launches "
                                     f"differ")
            err, ex = held(out, x, layout.col, layout.row, cs, n,
                           f"{name} chunk {chunk}")
            max_err, excess_worst = max(max_err, err), max(excess_worst, ex)
            deg = layout.in_degree()
            emit({"phase": "segmm_vs_plain", "case": name, "chunk": chunk,
                  "shape": [n, int(src.numel()), int(x.shape[1])],
                  "longest_row": int(deg.max()) if n else 0,
                  "long_rows": int(layout.long_rows.numel()),
                  "max_abs_err": err, "excess": ex, "bit_identical": True})
    # the rule must reject a dropped edge and a dropped chunk of the hub
    x, src, dst, coeff, n = case_inputs(FAULT_CASE)
    x, src, dst, coeff = (torch.from_numpy(a).to(dev)
                          for a in (x, src, dst, coeff))
    exact = segment_mm_ref(x.double(), src, dst, coeff.double(), n)
    fault = {f.__name__: rule_excess(f(x, src, dst, coeff, n), exact, x, src,
                                     dst, coeff, n)
             for f in (drop_one_edge, drop_one_chunk)}
    if min(fault.values()) <= 1.0:
        raise AssertionError(f"segment_mm: the float32 rule passed a planted "
                             f"fault: {fault}")
    layout = csr_layout(src, dst, n)
    cs = coeff[layout.perm]
    emit({"phase": "segmm_planted_fault", "case": FAULT_CASE, **fault,
          "sound_excess": rule_excess(segment_mm_csr(x, layout, cs), exact,
                                      x, src, dst, coeff, n)})
    # what the kernel does not take raises, before any launch
    bad = {"float64": (x.double(), layout.row_ptr, layout.col, cs),
           "int32 row_ptr": (x, layout.row_ptr.int(), layout.col, cs),
           "D 257": (torch.zeros(n, 257, device=dev), layout.row_ptr,
                     layout.col, cs),
           "strided x": (x.t().contiguous().t(), layout.row_ptr, layout.col,
                         cs),
           "coeff on the CPU": (x, layout.row_ptr, layout.col, cs.cpu()),
           "short coeff": (x, layout.row_ptr, layout.col, cs[:-1])}
    before = smod.segment_mm_cuda.launches
    for what, args in bad.items():
        try:
            smod.segment_mm_cuda(*args, layout.long_rows, CHUNK)
        except ValueError:
            continue
        raise AssertionError(f"segment_mm_cuda took bad inputs: {what}")
    if smod.segment_mm_cuda.launches != before:
        raise AssertionError("segment_mm_cuda launched on bad inputs")
    emit({"phase": "segmm_bad_inputs", "raised": list(bad)})
    del x, src, dst, coeff, exact, layout, cs, out, again

    # -- the ogb_products graph, resident on the card -------------------------
    cfg = get_arch("gcn-cora")
    shapes = {s.name: s for s in GNN_SHAPES}

    def resident(shape_name):
        """The shape's batch from the copied batch functions (seed 0), on
        the card, with its layout built there once; host and layout
        seconds."""
        shape = shapes[shape_name]
        with Timer() as t_host:
            if shape.kind == "batched_graphs":
                batch = gnn_molecule_batch(cfg, shape, seed=0,
                                           d_feat=shape.d_feat)
            else:
                batch = gnn_full_graph_batch(cfg, shape, seed=0,
                                             n_classes=cfg.d_out)
        graph = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        del batch
        torch.cuda.synchronize()
        with Timer() as t_layout:
            graph["layout"] = csr_layout(graph["src"], graph["dst"],
                                         graph["x"].shape[0])
            torch.cuda.synchronize()
        return graph, {"host_batch_seconds": t_host.seconds,
                       "layout_seconds": t_layout.seconds}

    ogb, ogb_setup = resident("ogb_products")
    layout = ogb["layout"]
    n, e = ogb["x"].shape[0], layout.col.numel()
    deg = layout.in_degree()
    emit({"phase": "gnn_graph", "shape": "ogb_products", "nodes": n,
          "edges": e, "max_in_degree": int(deg.max()),
          "long_rows": int(layout.long_rows.numel()),
          "edges_in_long_rows": int(deg[layout.long_rows.long()].sum()),
          "empty_rows": int((deg == 0).sum()), **ogb_setup})

    # -- phase 12: segment_mm timed at ogb_products, D = 16 and 7 ------------
    _, coeff, _ = gnn.gcn_norm(layout, cfg.norm)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hub = int(torch.argmax(deg))
    lo, hi = int(layout.row_ptr[hub]), int(layout.row_ptr[hub + 1])
    hub_ptr = torch.tensor([0, hi - lo], dtype=torch.int64, device=dev)
    hub_col = layout.col[lo:hi].contiguous()
    hub_coeff = coeff[lo:hi].contiguous()
    col64 = layout.col.to(torch.int64)
    timed = {}
    for d in (cfg.d_hidden, cfg.d_out):
        x = torch.randn(n, d, generator=gen, device=dev)
        out = segment_mm_csr(x, layout, coeff)
        exact = segment_mm_ref(x.double(), layout.col, layout.row,
                               coeff.double(), n)
        err, ex = held(out, x, layout.col, layout.row, coeff, n,
                       f"ogb_products D={d}", exact)
        max_err, excess_worst = max(max_err, err), max(excess_worst, ex)
        csr = torch.sparse_csr_tensor(layout.row_ptr, col64, coeff,
                                      size=(n, n))
        lib_ex = rule_excess(torch.sparse.mm(csr, x), exact, x, layout.col,
                             layout.row, coeff, n)
        del exact
        compulsory, gathered = segmm_bound_ms(n, n, e, d)
        bytes_c, bytes_g = segmm_bytes(n, n, e, d)
        row = {"phase": "segmm_timed", "shape": "ogb_products", "d": d,
               "nodes": n, "edges": e, "max_abs_err": err, "excess": ex,
               "ms": time_ms(torch, lambda: segment_mm_csr(x, layout, coeff),
                             20),
               "plain_ms": time_ms(torch, lambda: segment_mm_csr(
                   x, layout, coeff, impl="ref"), 5),
               "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr, x),
                                     5),
               "library_excess": lib_ex,
               "bound_ms": compulsory, "bound_by": "bytes",
               "gathered_bound_ms": gathered,
               "bytes_compulsory": bytes_c, "bytes_gathered": bytes_g}
        # the hub row alone (a one-row graph over the same x): split across
        # a block's warps as the kernel splits it, and one warp over it all
        split = smod.segment_mm_cuda(x, hub_ptr, hub_col, hub_coeff,
                                     torch.zeros(1, dtype=torch.int32,
                                                 device=dev), CHUNK)
        one_warp = smod.segment_mm_cuda(x, hub_ptr, hub_col, hub_coeff,
                                        torch.zeros(0, dtype=torch.int32,
                                                    device=dev), hi - lo)
        if not torch.equal(split[0], out[hub]):
            raise AssertionError("segment_mm: the hub alone differs from the "
                                 "hub in the graph")
        zeros = torch.zeros(hi - lo, dtype=torch.int32, device=dev)
        _, one_ex = held(one_warp, x, hub_col, zeros, hub_coeff, 1,
                         "hub, one warp")
        row.update({
            "hub_edges": hi - lo,
            "hub_ms": time_ms(torch, lambda: smod.segment_mm_cuda(
                x, hub_ptr, hub_col, hub_coeff, torch.zeros(
                    1, dtype=torch.int32, device=dev), CHUNK), 20),
            "hub_one_warp_ms": time_ms(torch, lambda: smod.segment_mm_cuda(
                x, hub_ptr, hub_col, hub_coeff, torch.zeros(
                    0, dtype=torch.int32, device=dev), hi - lo), 20),
            "hub_one_warp_excess": one_ex})
        row["gbytes_s_compulsory"] = bytes_c / row["ms"] / 1e6
        row["bound_share"] = compulsory / row["ms"]
        timed[d] = row
        emit(row)
        del x, out, csr, split, one_warp
        torch.cuda.empty_cache()
    del col64, hub_col, hub_coeff, coeff
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 13: gcn-cora inference at full width ---------------------------
    # ogb_products first, on the graph already resident, which is then
    # freed: the smaller shapes' peaks are their own
    n_timed = {"ogb_products": 10, "full_graph_sm": 50, "molecule": 50}
    launches_by_path = {}
    for shape_name, n_calls in n_timed.items():
        if shape_name == "ogb_products":
            graph, setup, ogb = ogb, ogb_setup, None
        else:
            graph, setup = resident(shape_name)
        layout = graph["layout"]
        n_nodes, d_in = graph["x"].shape
        params = gnn.init_gnn(cfg, d_in, torch.Generator(
            device=dev).manual_seed(0))
        gnn.gnn_forward(params, graph, cfg)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        smod.segment_mm_cuda.launches = 0
        secs = []
        for _ in range(n_calls):
            with Timer() as t:
                logits = gnn.gnn_forward(params, graph, cfg)
                torch.cuda.synchronize()
            secs.append(t.seconds)
        launches = smod.segment_mm_cuda.launches
        peak = torch.cuda.max_memory_allocated(dev)
        # the same forward back to back on CUDA events: the device's time
        # per forward with the host's launch gaps, beside the host clock's
        event_ms = time_ms(torch, lambda: gnn.gnn_forward(params, graph, cfg),
                           n_calls, warmup=1)
        if launches != cfg.n_layers * n_calls:
            raise AssertionError(f"gnn {shape_name}: {launches} segment_mm "
                                 f"launches in {n_calls} forwards, not "
                                 f"{cfg.n_layers} per forward")
        launches_by_path[shape_name] = launches
        if tuple(logits.shape) != (n_nodes, cfg.d_out) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"gnn {shape_name}: logits malformed or not "
                                 f"finite")
        # each launch at the path's own inputs, against float64 plain
        with Timer() as t_check:
            _, coeff, self_coeff = gnn.gcn_norm(layout, cfg.norm)
            x, layer_ex = graph["x"], []
            for i, lp in enumerate(params["layers"]):
                h = x @ lp["w"]
                err, ex = held(segment_mm_csr(h, layout, coeff), h,
                               layout.col, layout.row, coeff, n_nodes,
                               f"{shape_name} layer {i}")
                max_err, excess_worst = max(max_err, err), max(excess_worst,
                                                               ex)
                layer_ex.append(ex)
                x = gnn.gcn_layer(x, lp, layout, coeff, self_coeff,
                                  relu=i < cfg.n_layers - 1)
                del h
            if not torch.equal(x, logits):
                raise AssertionError(f"gnn {shape_name}: the layers rerun "
                                     f"differ from the timed forward")
            plain = gnn.gnn_forward(params, graph, cfg, impl="ref")
            mag = chain_magnitude(params, graph["x"], layout.col, layout.row,
                                  coeff, self_coeff)
            chain = chain_excess(logits, plain, mag, [d_in, cfg.d_hidden],
                                 int(layout.in_degree().max()))
            if chain > 1.0:
                raise AssertionError(f"gnn {shape_name}: logits {chain} times "
                                     f"the chained rule from the plain path")
            loss_fn = (gnn.graph_regression_loss
                       if shape_name == "molecule"
                       else gnn.node_classification_loss)
            loss = float(loss_fn(params, graph, cfg))
            plain_loss = float(loss_fn(params, graph, cfg, impl="ref"))
            del x, plain, mag, coeff, self_coeff
        if not math.isfinite(loss):
            raise AssertionError(f"gnn {shape_name}: loss {loss}")
        emit({"phase": "gnn_forward", "arch": cfg.name, "shape": shape_name,
              "nodes": n_nodes, "edges": int(layout.col.numel()),
              "d_feat": d_in, **setup, "forwards": n_calls,
              "seconds_median": float(np.median(secs)),
              "seconds_max": max(secs), "seconds_min": min(secs),
              "nodes_s": n_nodes / float(np.median(secs)),
              "event_ms_per_forward": event_ms,
              "segmm_launches": launches,
              "segmm_launches_per_forward": launches // n_calls,
              "peak_bytes": peak, "layer_excess": layer_ex,
              "logits_chain_excess": chain, "loss": loss,
              "plain_loss": plain_loss, "loss_diff": abs(loss - plain_loss),
              "logits0": logits[0].tolist(),
              "check_seconds": t_check.seconds})
        del graph, logits, params, layout
        gc.collect()
        torch.cuda.empty_cache()

    t16, t7 = timed[cfg.d_hidden], timed[cfg.d_out]
    return {"name": "segment_mm", "route": "cuda",
            "source": "src/repro_torch/kernels/segment_mm/csrc/segment_mm.cu",
            "replaces": "src/repro/kernels/segment_mm/kernel.py:30",
            "launches": sum(launches_by_path.values()),
            "max_abs_err": max_err, "float32_rule_excess": excess_worst,
            "shape": f"ogb_products ({t16['nodes']} nodes, {t16['edges']} "
                     f"edges), D {t16['d']} (gcn-cora layer 1)",
            "ms": t16["ms"], "plain_ms": t16["plain_ms"],
            "bound_ms": t16["bound_ms"], "bound_by": "bytes",
            "gathered_bound_ms": t16["gathered_bound_ms"],
            "library_ms": t16["library_ms"],
            "library_call": "torch.sparse.mm of a CSR tensor (crow = row_ptr, "
                            "col, values = sorted coeff), float32",
            "hub_ms": t16["hub_ms"], "hub_one_warp_ms": t16["hub_one_warp_ms"],
            "hub_edges": t16["hub_edges"],
            "d7_ms": t7["ms"], "d7_plain_ms": t7["plain_ms"],
            "d7_bound_ms": t7["bound_ms"],
            "d7_gathered_bound_ms": t7["gathered_bound_ms"],
            "d7_library_ms": t7["library_ms"], "d7_hub_ms": t7["hub_ms"],
            "d7_hub_one_warp_ms": t7["hub_one_warp_ms"],
            "launches_by_path": launches_by_path}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False; this script "
                     "measures the CUDA port and has no CPU mode", 2)
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels").is_dir():
        return _fail(f"no src/repro_torch beside {__file__}; run it from a "
                     "checkout of the repository", 3)
    sys.path.insert(0, str(root / "src"))

    from scipy.sparse.csgraph import shortest_path

    from repro_torch.common import GraphEngineConfig, Timer
    from repro_torch.core import (ClusterQuotientEstimator, IntervalEstimator,
                                  open_session, tau_for)
    from repro_torch.core import state as st
    from repro_torch.core.cluster import cluster
    from repro_torch.core.engine import (hashed_uniforms, oneshot_budget,
                                         oneshot_centers)
    from repro_torch.graph import road_like, social_like, to_scipy_csr
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import kernel as kmod
    from repro_torch.kernels.edge_relax import megakernel as mk
    from repro_torch.kernels.edge_relax.ops import (build_relax_graph,
                                                    edge_relax,
                                                    edge_relax_plain)
    from repro_torch.kernels.cin import kernel as cmod
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.segment_mm import kernel as smod

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # -- build: one nvcc per kernel, all started together ---------------------
    builds = ((kmod.NAME, kmod.SOURCES, kmod.load_library),
              (kmod.MEGA_NAME, kmod.MEGA_SOURCES, kmod.load_mega_library),
              (fmod.NAME, fmod.SOURCES, fmod.load_library),
              (cmod.NAME, cmod.SOURCES, cmod.load_library),
              (smod.NAME, smod.SOURCES, smod.load_library))

    def timed_load(load):
        with Timer() as tb:
            load()
        return tb.seconds

    with ThreadPoolExecutor(len(builds)) as pool:
        seconds = list(pool.map(timed_load, [b[2] for b in builds]))
    for (name, sources, _), secs in zip(builds, seconds):
        log = _build.library_path(name, sources).with_suffix(".log")
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln] if log.exists() else []
        emit({"phase": "build", "kernel": name, "seconds": secs,
              "ptxas": ptxas})

    # -- phase 1: kernel vs plain --------------------------------------------
    max_err = 0

    def compare(name, g, planes_np, delta, iters=0):
        nonlocal max_err
        tp = [torch.from_numpy(x).to(dev) for x in planes_np]
        out = edge_relax(tp, g, delta)
        ref = edge_relax_plain(tp, g, delta)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  if a.numel() else 0 for a, b in zip(out, ref))
        max_err = max(max_err, err)
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"edge_relax {name}: kernel != plain "
                                 f"(max abs err {err})")
        row = {"phase": "kernel_vs_plain", "case": name, "n": g.n_nodes,
               "edges": g.n_edges, "delta": int(delta), "equal": True}
        if iters:
            row["ms"] = time_ms(torch, lambda: edge_relax(tp, g, delta), iters)
            row["plain_ms"] = time_ms(
                torch, lambda: edge_relax_plain(tp, g, delta), max(iters // 4, 2))
            row["bound_ms"] = (relax_bytes(torch, g, tp, delta)
                               / HBM_BYTES_PER_S * 1e3)
        emit(row)
        return row

    rng = np.random.default_rng(0)
    for n in (1, 257, 10_000, 1_000_000):
        for wmax in (7, 2**30 - 1):
            e = max(6 * n, 3)
            src = rng.integers(0, n, e).astype(np.int32)
            dst = rng.integers(0, max(n - n // 50, 1), e).astype(np.int32)
            w = rng.integers(1, wmax + 1, e).astype(np.int32)
            g = build_relax_graph(src, dst, w, n, dev)
            delta = int(rng.integers(1, min(2 * wmax, BIG) + 1))
            compare(f"random n={n} wmax={wmax}", g,
                    random_planes(n, wmax, seed=n + wmax), delta,
                    iters=20 if n == 1_000_000 and wmax == 7 else 0)
    social = social_like(20, seed=0)
    g = build_relax_graph(social.src, social.dst, social.weight,
                          social.n_nodes, dev)
    wmax = int(social.weight.max())
    compare("rmat social_like(20)", g,
            random_planes(social.n_nodes, wmax, seed=1),
            int(rng.integers(1, 2 * wmax)), iters=10)
    del g, social

    # -- phase 1b: megakernel vs plain ----------------------------------------
    mega_err = 0
    stopped_inside = capped = 0

    def compare_mega(name, g, planes, relay, frozen, front, params, k,
                     iters=0):
        nonlocal mega_err, stopped_inside, capped
        out = mk.fused_grow_supersteps(planes, relay, frozen, front, g,
                                       params, k)
        ref = mk.fused_grow_supersteps_plain(planes, relay, frozen, front, g,
                                             params, k)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  if a.numel() else 0 for a, b in zip(out, ref))
        mega_err = max(mega_err, err)
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"megakernel {name}: kernel != plain "
                                 f"(max abs err {err})")
        summ = [int(x) for x in out[4][k]]
        executed = summ[mk.COL_EXECUTED]
        if (params.stop_variant and 0 < executed < k
                and summ[mk.COL_REACHED] >= params.half_target):
            stopped_inside += 1
        if params.steps_base + executed == params.num_it and executed < k:
            capped += 1
        row = {"phase": "megakernel_vs_plain", "case": name, "n": g.n_nodes,
               "edges": g.n_edges, "k": k, "delta": params.delta,
               "variant": "stop" if params.stop_variant else "complete",
               "executed": executed, "skipped_rows": summ[mk.COL_DEAD],
               "reached": summ[mk.COL_REACHED], "equal": True}
        if iters:
            row["ms"] = time_ms(torch, lambda: mk.fused_grow_supersteps(
                planes, relay, frozen, front, g, params, k), iters)
            row["ms_per_superstep"] = row["ms"] / max(executed, 1)
            row["plain_ms"] = time_ms(
                torch, lambda: mk.fused_grow_supersteps_plain(
                    planes, relay, frozen, front, g, params, k),
                max(iters // 4, 2))
            row["bound_ms"] = (mega_launch_bytes(
                torch, mk, g, planes, relay, frozen, front, params, k)
                / HBM_BYTES_PER_S * 1e3)
        emit(row)
        return row

    def mega_cases(name, g, planes_np, delta, seed, ks=(1, 8, 64)):
        r = np.random.default_rng(seed)
        d, c, p, rw0, rc, rp = (torch.from_numpy(x).to(dev)
                                for x in planes_np)
        n = g.n_nodes
        frozen = (rw0 < BIG) | torch.from_numpy(r.random(n) < 0.02).to(dev)
        front = torch.from_numpy((r.random(n) < 0.5).astype(np.uint8)).to(dev)
        reached0 = int(((~frozen) & (d < delta)).sum())
        for k in ks:
            for stop in (0, 1):
                half = reached0 + max(1, n // 50) if stop else 0
                compare_mega(f"{name} K={k}", g, (d, c, p), (rw0, rc, rp),
                             frozen, front,
                             mk.MegaParams(delta, half, 4 * n, 0, stop), k)
        compare_mega(f"{name} num_it cap", g, (d, c, p), (rw0, rc, rp),
                     frozen, front, mk.MegaParams(delta, 0, 4 * n, 4 * n - 3,
                                                  0), 8)

    for n in (1, 257, 10_000, 1_000_000):
        for wmax in (7, 2**30 - 1):
            e = max(6 * n, 3)
            src = rng.integers(0, n, e).astype(np.int32)
            dst = rng.integers(0, max(n - n // 50, 1), e).astype(np.int32)
            w = rng.integers(1, wmax + 1, e).astype(np.int32)
            g = build_relax_graph(src, dst, w, n, dev)
            delta = int(rng.integers(1, min(2 * wmax, BIG) + 1))
            mega_cases(f"random n={n} wmax={wmax}", g,
                       random_planes(n, wmax, seed=n + wmax), delta,
                       seed=n + wmax)
    social = social_like(20, seed=0)
    g = build_relax_graph(social.src, social.dst, social.weight,
                          social.n_nodes, dev)
    wmax = int(social.weight.max())
    social_planes = random_planes(social.n_nodes, wmax, seed=1)
    mega_cases("rmat social_like(20)", g, social_planes, 2 * wmax - 1,
               seed=1)
    tp = [torch.from_numpy(x).to(dev) for x in social_planes]
    rmat_row = compare_mega(
        "rmat social_like(20) timed", g, tp[:3], tp[3:],
        tp[3] < BIG, torch.ones(social.n_nodes, dtype=torch.uint8,
                                device=dev),
        mk.MegaParams(2 * wmax - 1, 0, 4 * social.n_nodes, 0, 0), 8,
        iters=5)
    del g, social, tp

    with Timer() as t:
        edges = road_like(CAL_NODES, seed=0)
    emit({"phase": "graph", "family": "road_like", "n": edges.n_nodes,
          "edges": edges.n_edges, "seconds": t.seconds})

    def run_main(backend: str, cfg=None, tau=16, phase="main_path"):
        cfg = cfg or GraphEngineConfig()
        fused = backend == "kernel" and cfg.fuse_supersteps > 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kmod.edge_relax_cuda.launches = 0
        kmod.megakernel_cuda.launches = 0
        with Timer() as tt:
            session = open_session(edges, cfg, backend=backend, tau=tau,
                                   device=dev)
            res = session.estimate(ClusterQuotientEstimator())
            torch.cuda.synchronize()
        relax_launches = kmod.edge_relax_cuda.launches
        mega_launches = kmod.megakernel_cuda.launches
        launches = mega_launches if fused else relax_launches
        other = relax_launches if fused else mega_launches
        pm = res.pipeline
        if launches != pm.kernel_launches or other != 0:
            raise AssertionError(
                f"{phase} {backend}: wrappers counted edge_relax "
                f"{relax_launches}, megakernel {mega_launches}; the backend "
                f"{pm.kernel_launches}")
        row = {"phase": phase, "backend": backend,
               "mode": session.cfg.mode, "fuse": cfg.fuse_supersteps,
               "n": edges.n_nodes,
               "edges": edges.n_edges, "tau": session.tau,
               "phi_approx": res.phi_approx,
               "radius": res.radius, "clusters": res.n_clusters,
               "quotient_edges": pm.n_quotient_edges,
               "stages": res.n_stages, "supersteps": res.growing_steps,
               "solve_supersteps": pm.solve_supersteps,
               "solve_dtype": "int64" if pm.solve_int64 else "int32",
               "kernel_launches": launches,
               "kernel": ("megakernel" if fused else
                          "edge_relax" if backend == "kernel" else None),
               "kernel_supersteps": pm.kernel_supersteps,
               "skipped_rows": pm.dma_stall_blocks,
               "host_syncs": pm.total_host_syncs,
               "decompose_syncs": pm.decompose_syncs,
               "solve_syncs": pm.solve_syncs,
               "seconds": tt.seconds,
               "decompose_seconds": pm.decompose_seconds,
               "quotient_seconds": pm.quotient_seconds,
               "solve_seconds": pm.solve_seconds,
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "connected": res.connected}
        if session.cfg.mode == "stages":
            # k = the stages' drawn centers + the nodes left uncovered when
            # the stop rule fired (singletons)
            m = res.decomposition.metrics
            row["centers_drawn"] = m.centers_drawn
            row["uncovered_at_stop"] = m.uncovered_at_stop
        emit(row)
        graph = session.backend.graph if backend == "kernel" else None
        session.close()
        return res, row, launches, graph

    res_k, row_k, launches, road_graph = run_main("kernel")
    if launches <= 0:
        raise AssertionError("main path ran without launching edge_relax")
    if launches < row_k["supersteps"]:
        raise AssertionError("fewer kernel launches than supersteps")
    res_s, row_s, launches_s, _ = run_main("single")
    if launches_s != 0:
        raise AssertionError("the plain backend launched the kernel")
    dk, ds = res_k.decomposition, res_s.decomposition
    if not (np.array_equal(dk.final_c, ds.final_c)
            and np.array_equal(dk.final_pathw, ds.final_pathw)):
        raise AssertionError("kernel and plain backends decomposed differently")
    if res_k.phi_approx != res_s.phi_approx or not res_k.connected:
        raise AssertionError(f"Phi differs: kernel {res_k.phi_approx} vs "
                             f"plain {res_s.phi_approx}")
    fc = dk.final_c
    if fc.shape != (edges.n_nodes,) or not (fc[fc] == fc).all() \
            or int(dk.final_pathw.max()) != res_k.radius:
        raise AssertionError("decomposition planes are malformed")
    emit({"phase": "main_path_parity", "byte_identical": True,
          "phi_approx": res_k.phi_approx})

    def same_decomposition(a, b) -> bool:
        da, db = a.decomposition, b.decomposition
        return (np.array_equal(da.final_c, db.final_c)
                and np.array_equal(da.final_pathw, db.final_pathw)
                and a.phi_approx == b.phi_approx
                and a.growing_steps == b.growing_steps
                and a.n_clusters == b.n_clusters)

    # -- phase 2b: the same query through the fused megakernel ---------------
    res_f, row_f, launches_stages_fused, _ = run_main(
        "kernel", GraphEngineConfig(fuse_supersteps=8),
        phase="main_path_fused")
    if launches_stages_fused <= 0:
        raise AssertionError("fused main path ran without the megakernel")
    if row_f["kernel_supersteps"] != row_f["supersteps"]:
        raise AssertionError("fused main path: kernel supersteps != steps")
    if not same_decomposition(res_f, res_k):
        raise AssertionError("fused and unfused main paths differ")
    emit({"phase": "main_path_fused_parity", "byte_identical": True,
          "phi_approx": res_f.phi_approx,
          "launches_fused": launches_stages_fused,
          "launches_unfused": launches})

    # -- phase 2b': how far k moves with the seed alone -----------------------
    # the stages decomposition (kernel backend) for seeds 0-4: k is the drawn
    # centers (about gamma tau ln n per stage) plus the stop rule's remainder
    # (0 to 8 tau ln n), so another stream moves k by up to a stage's worth.
    # Beside the reference's stream, the one the port drew from before it
    # reproduced jax.random (a torch.Generator per (seed, stage, t)), kept
    # here only as the comparison that accounts for k's move between them
    def generator_draw(seed):
        def draw(stage, t, n):
            words = np.random.SeedSequence([seed, stage, t]).generate_state(2)
            g = torch.Generator(device=dev)
            g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
            return torch.rand(n, generator=g, dtype=torch.float32, device=dev)
        return draw

    spread = {"jax_random": [], "torch_generator": []}
    for stream, rows in spread.items():
        for seed in range(5):
            with Timer() as tt:
                dec = cluster(edges, 16, seed=seed, backend="kernel",
                              device=dev,
                              uniform_fn=(generator_draw(seed)
                                          if stream == "torch_generator"
                                          else None))
            m = dec.metrics
            rows.append({"seed": seed, "clusters": dec.n_clusters,
                         "stages": dec.n_stages,
                         "centers_drawn": m.centers_drawn,
                         "uncovered_at_stop": m.uncovered_at_stop,
                         "redraws": m.resamples,
                         "supersteps": dec.growing_steps,
                         "seconds": tt.seconds})
            if m.centers_drawn + m.uncovered_at_stop != dec.n_clusters:
                raise AssertionError(f"{stream} seed {seed}: k != drawn "
                                     f"centers + uncovered at stop")
    if spread["jax_random"][0]["clusters"] != res_k.n_clusters:
        raise AssertionError("cluster(seed=0) differs from the main path")
    emit({"phase": "draw_spread", "n": edges.n_nodes, "tau": 16,
          "stop_threshold": int(8 * 16 * math.log(edges.n_nodes)),
          **spread})
    del dec

    # -- phase 2c: one-shot at full size, fused and unfused -------------------
    tau_oneshot = tau_for(edges.n_nodes)
    oneshot = {}
    for fuse in (8, 0):
        cfg = GraphEngineConfig(mode="oneshot", deterministic=True,
                                fuse_supersteps=fuse)
        oneshot[fuse] = run_main("kernel", cfg, tau=tau_oneshot,
                                 phase="oneshot_full")
    launches_oneshot_fused = oneshot[8][2]
    launches_oneshot_unfused = oneshot[0][2]
    if launches_oneshot_fused <= 0 or launches_oneshot_unfused <= 0:
        raise AssertionError("one-shot path ran without its kernel")
    if not same_decomposition(oneshot[8][0], oneshot[0][0]):
        raise AssertionError("fused and unfused one-shot runs differ")
    emit({"phase": "oneshot_full_parity", "byte_identical": True,
          "tau": tau_oneshot, "phi_approx": oneshot[8][0].phi_approx,
          "clusters": oneshot[8][0].n_clusters,
          "supersteps": oneshot[8][0].growing_steps})

    # the kernel at the main path's shapes: the road graph's CSR with
    # engine-like planes and the run's final Δ
    main_row = compare("main path road_like(1890815)", road_graph,
                       random_planes(edges.n_nodes, int(edges.weight.max()),
                                     seed=2), res_k.delta_end, iters=50)
    # the megakernel at the main path's shapes: the road CSR with the planes
    # the full-size one-shot grow starts from (deterministic draw, tau 130)
    b = oneshot_budget(edges, tau_oneshot)
    mask, start = oneshot_centers(*hashed_uniforms(edges.n_nodes, dev), b.p,
                                  b.shift_max, b.shift_scale)
    s0 = st.promote_centers_shifted(st.init_state(edges.n_nodes, dev), mask,
                                    start)
    rw0, rc, rp, frozen = st.relay_planes(s0)
    front = torch.ones(edges.n_nodes, dtype=torch.uint8, device=dev)
    for k in (1, 8, 64):
        for stop in (0, 1):
            compare_mega(f"main path road_like(1890815) K={k}", road_graph,
                         (s0.d, s0.c, s0.pathw), (rw0, rc, rp), frozen, front,
                         mk.MegaParams(b.max_delta, 1 + k * 200 if stop else 0,
                                       b.num_it, 0, stop), k)
    compare_mega(
        "main path road_like(1890815) timed, grow start", road_graph,
        (s0.d, s0.c, s0.pathw), (rw0, rc, rp), frozen, front,
        mk.MegaParams(b.max_delta, 0, b.num_it, 0, 0), 8, iters=20)
    # the launches of a running grow call start from a small carried
    # frontier, not the all-ones one of the call's first launch: time one
    # from the state 64 supersteps in
    *p64, f64, _ = mk.fused_grow_supersteps(
        (s0.d, s0.c, s0.pathw), (rw0, rc, rp), frozen, front, road_graph,
        mk.MegaParams(b.max_delta, 0, b.num_it, 0, 0), 64)
    mega_row = compare_mega(
        "main path road_like(1890815) timed, 64 supersteps in", road_graph,
        tuple(p64), (rw0, rc, rp), frozen, f64,
        mk.MegaParams(b.max_delta, 0, b.num_it, 64, 0), 8, iters=20)
    if not stopped_inside or not capped:
        raise AssertionError(f"megakernel cases missed a stop inside a "
                             f"launch ({stopped_inside}) or a num_it cap "
                             f"({capped})")
    del road_graph, edges, s0, rw0, rc, rp, frozen, front, p64, f64

    # -- phase 3: certified bracket ------------------------------------------
    for n, check_exact, mode in ((65_536, False, "stages"),
                                 (4_096, True, "stages"),
                                 (4_096, True, "oneshot")):
        e = road_like(n, seed=0)
        cfg = GraphEngineConfig(mode=mode, deterministic=mode == "oneshot",
                                fuse_supersteps=8 if mode == "oneshot" else 0)
        with Timer() as tt:
            iv = IntervalEstimator().estimate(open_session(e, cfg, device=dev))
        row = {"phase": "interval", "n": n, "mode": mode, "lower": iv.lower,
               "upper": iv.upper, "connected": iv.connected,
               "host_syncs": iv.pipeline.total_host_syncs,
               "seconds": tt.seconds}
        if not iv.lower <= iv.upper:
            raise AssertionError(f"bracket violated at n={n}")
        if check_exact:
            exact = int(shortest_path(to_scipy_csr(e), method="D",
                                      directed=False).max())
            row["scipy_exact"] = exact
            if not iv.lower <= exact <= iv.upper:
                raise AssertionError(f"scipy exact {exact} outside "
                                     f"[{iv.lower}, {iv.upper}]")
        emit(row)

    # -- phases 4-6: flash attention and the LM at full width -----------------
    del res_k, res_s, res_f, oneshot, dk, ds, fc, mask, start, b
    gc.collect()
    torch.cuda.empty_cache()
    flash_row = lm_phases(torch, dev)

    # -- phases 7-10: CIN and xDeepFM serving at full width -------------------
    gc.collect()
    torch.cuda.empty_cache()
    cin_row = recsys_phases(torch, dev)

    # -- phases 11-13: segment_mm and gcn-cora inference ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    segmm_row = gnn_phases(torch, dev)

    emit({"kernels": [{
        "name": "edge_relax", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu",
        "replaces": "src/repro/kernels/edge_relax/kernel.py:78",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_by_path": {"stages_unfused": launches,
                             "oneshot_unfused": launches_oneshot_unfused},
    }, {
        "name": "megakernel", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/megakernel.cu",
        "replaces": "src/repro/kernels/edge_relax/megakernel.py:93",
        "launches": launches_stages_fused + launches_oneshot_fused,
        "max_abs_err": mega_err,
        "ms": mega_row["ms"], "plain_ms": mega_row["plain_ms"],
        "bound_ms": mega_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "supersteps_per_launch": mega_row["executed"],
        "ms_per_superstep": mega_row["ms_per_superstep"],
        "rmat_ms": rmat_row["ms"], "rmat_plain_ms": rmat_row["plain_ms"],
        "launches_by_path": {"stages_fused": launches_stages_fused,
                             "oneshot_fused": launches_oneshot_fused},
    }, flash_row, cin_row, segmm_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(profile_paths() if sys.argv[1:] == ["--profile"] else main())
