#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Builds the five hand-written CUDA kernel libraries from the checkout's
sources (one ``nvcc`` per library, started together; flash attention's is
linked with the driver library, ``-lcuda``, for its TMA tensor maps), then:

  1. kernel vs plain: ``edge_relax`` on random graphs (n = 1, 257, 10,000,
     1,000,000), stars with a 100,000-edge in-row, out-row or both, rows of
     exactly the long-row threshold (1,024 in-edges) and one past it, an
     RMAT graph (hub skew; timed, and its 39,514-edge hub row timed alone),
     weights up to 7 and 2^30 - 1, random Δ, covered nodes with negative
     offsets and INF/BIG sentinels, and at the main path's shapes (the n =
     1,890,815 road graph). Every comparison is exact equality (all planes
     are int32).
  1b. megakernel vs plain: the same graphs with a frozen mask and a random
     frontier (half the rows: superstep 0 runs over every row; 5%: from a
     marked list), K = 1, 8, 64, both variants, a ``half_target`` met inside
     a launch and a ``num_it`` cap, and on the stars with only the hub's
     feeder on the frontier (the hub changes, then its out-list); exact
     equality of the four planes AND the whole stats array. Timed at the
     main path's shapes (the road graph with the one-shot start planes) and
     on RMAT.
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
  2d. the quotient cascade at full size: on phase 2's kernel session,
     ``CascadeEstimator(levels=0)`` must equal phase 2's flat estimate
     field for field (host-clock seconds aside); ``levels=2``
     (``tau_solve`` 1,024) prints each level's clusters, supersteps,
     reads and seconds, must take no more solve supersteps than the flat
     estimate, and must give the same Phi and level lists on phase 2's
     plain session. Then a new fused session at the default tau (130)
     cascades up to 6 levels (the count printed) with its Phi, level
     table, solve seconds and peak bytes; its flat solve is not run.
  2e. CLUSTER2 at full size: ``ClusterQuotientEstimator(use_cluster2=
     True)`` on phase 2's kernel session and phase 2b's fused one; final
     planes byte-identical and Phi equal; k, radius, stages, supersteps,
     launches and seconds printed. At ``road_like(65_536)`` the kernel
     backend must equal the plain one.
  telemetry. the graph path under the sync guard, traced: on phase 2's
     kernel session (tau 16) ``CascadeEstimator(levels=2)`` once under
     sync debug mode "warn" (every synchronisation that bypasses
     ``guard.fetch`` printed by source line), then untraced and traced
     (``runtime/telemetry.py``), both inside
     ``guard.measured_transfers("disallow")`` (sync debug mode "error":
     a read that bypasses ``guard.fetch`` raises); both must be equal
     byte for byte (planes, levels, every pipeline field), measured reads
     must equal ``total_host_syncs`` and the tracer's attributed reads,
     and the spans the CPU parity test expects must be there. Then two
     batches of phase 2i's seed-0 trace, the first (which enters dynamic
     mode) under "warn" as the sweep, the second traced under
     "disallow": its measured reads must equal the ``DynamicMetrics``
     delta.
     ``write_telemetry`` must write ``trace.json`` (one event per span),
     ``spans.jsonl`` and ``metrics.prom``. Prints the span counts, both
     query seconds and their ratio (no limit), and the reads by span.
  2f. host read: the median host time of one ``guard.fetch`` of a 4-byte
     tensor right after a launch (200 reads after 20 warm-ups), the
     autotuner's ``_HOST_SYNC_S``.
  2g. graph serving at full size: the port's ``serve_graph_diameter``
     (``launch/serve.py --mode graph-diameter``) on ``road_like(1_890_815,
     seed=0)`` (phase 2's graph) and ``seed=1``, one ``SessionPool`` with
     one shared ``e_pad``, 3 rounds of ``CascadeEstimator(levels=2)`` at
     tau 16, ``tau_solve`` 1,024, unfused kernel backend: per query the
     seconds, Phi, k and host reads; cold and warm means, queries per
     second, the amortization ratio, ``SessionMetrics``, the measured
     transfers. Rounds 1-2 must build no backend and upload no edges,
     every round of a session must give the same estimate, and the seed-0
     graph's pooled estimate must equal phase 2d's tau-16 ``levels=2``
     estimate on the unpadded graph field for field.
  2h. autotuned serving: the same two graphs through ``--autotune auto
     --engine-mode auto``, 2 queries each (the record's cascade, fused by
     its ``fuse``): the records' fields, the stats pass's seconds and
     reads, the query seconds, ``predicted_superstep_s`` beside the
     measured seconds per level-0 superstep; tau, tau_solve, levels,
     delta_init, signature and mode must equal ``derive_tuning`` of
     ``compute_graph_stats`` on the host mirror (the padded edges on the
     CPU), and fuse must be 8.
  2i. dynamic updates at full size: ``serve --mode graph-diameter
     --estimator dynamic --update-trace 4 --update-mix mixed --queries 5``
     on the same two graphs in one pool, tau 16, unfused kernel backend,
     0.5% of the edges a batch (``temporal_trace``, made by two worker
     processes while the phases before run, and its host seconds printed):
     per batch and graph the ``UpdateReport`` and the
     seconds of ``KernelBackend.rebind`` alone; the query seconds before
     and after each batch; the amortized update supersteps against the
     full decomposition's; the final bracket (the maintained upper bound:
     one Bellman-Ford here would take about 470,000 supersteps);
     ``DynamicMetrics``, peak bytes, ``edge_relax`` launches (equal to the
     backends' counts). Warm rounds build and upload nothing; measured
     reads equal the queries' and updates' counts.
  2j. the dynamic path against its plain version: the seed-0 replay again
     on a ``single`` session on the card, every ``UpdateReport`` field
     but seconds, ``DynamicMetrics``, every estimate and the final bracket
     equal; a ``delete``-mix trace of 4 batches on ``road_like(65_536)``,
     fused (8), unfused and plain equal, two batches repaired and two
     rebuilt (``rebuild_fraction`` 1, then 0); the same trace's brackets
     on ``road_like(4_096)`` around scipy's exact diameter.
  2k. kill and resume at full size: the tau-16 ``CascadeEstimator(levels=2,
     tau_solve=1024)`` query of phase 2d on a new kernel session, unfused
     and fused (8), with a checkpoint directory armed: a real SIGTERM at
     stage boundary 2 under a ``PreemptionGuard`` (entered only around
     that query) must raise ``Preempted`` after a save; a new session with
     ``resume=True`` must restore once and finish equal to phase 2d's
     estimate (fields, final planes, eccentricities, level lists), leave
     no step behind and count every read (``checkpoint_syncs`` apart).
     Each stage's and each save's host seconds and each step's bytes are
     printed. Then ``serve --mode graph-diameter`` on the same graph in a
     subprocess with ``--preempt-after 2`` must exit 75, and its
     ``--resume`` rerun must exit 0 with phase 2d's estimate.
  2l. ``GraphStore``: ``launch/diameter.py --shards 4 --compress`` on the
     same graph must give phase 2d's estimate (its geometry printed); a
     session over a 4-shard ``GraphStore`` must too, ``spill()`` must
     lower ``torch.cuda.memory_allocated``, and the next query must
     unspill (one more build and upload) and give it again; then
     ``examples/quickstart_torch.py`` on the card must print a
     conservative Phi_approx.
  3. certified bracket: ``IntervalEstimator`` on ``road_like(65_536)``
     (lower <= upper) and on ``road_like(4_096)`` (lower <= scipy exact <=
     upper), stages and one-shot.
  3b. the paper's competitor (Table 3's estimators on one kernel session
     per graph, tau 16): ``ClusterQuotientEstimator``,
     ``CascadeEstimator(levels=2, tau_solve=32)``,
     ``DeltaSteppingEstimator(seed=7)`` (Bellman-Ford) and the same with
     Δ = the mean weight, on ``road_like(32_768)`` (cut from 1,890,815:
     Bellman-Ford's supersteps grow linearly with n on this family; at
     262,144 until the GNN training phases needed its time, at 131,072
     until the LM training phases did, and at 65,536 until the rest of
     the LM family's training did) and
     RMAT ``social_like(20)``. Bellman-Ford's and Δ-stepping's distance
     planes from the same source must be equal element for element, and
     the SSSP lower bound at most either cluster estimate's Phi; each
     prints supersteps, host reads, ms per superstep, seconds and the
     round ratio (Bellman-Ford's supersteps over CLUSTER's growing steps).
  3c. the ``paper-graph`` arch at roads-USA scale: ``road_like(2^24,
     seed=0)`` (100,663,284 directed edges, made by a worker process
     started at the top of the script; its seconds printed) in
     ``build_cell("paper-graph", "n16M", avg_degree=6)`` (12 masked edge
     slots): its superstep on the kernel backend (one ``edge_relax``
     launch) against the plain backend's, every plane equal, and the
     kernel timed there beside the plain version and its byte bound; the
     megakernel (fuse 8) from the same stage-0 planes against its plain
     version, every output equal, at the query's first grow (Δ = the mean
     weight, the stop variant) and at the cell's Δ in the complete variant
     (timed beside its plain version and byte bound); then
     the full config's query (tau ``tau_for(2^24)`` = 1,008, fused 8,
     ``CascadeEstimator(levels=2, tau_solve=1024)``, a checkpoint at every
     stage boundary): seconds, k, level clusters, supersteps, launches,
     Phi, reads (measured = counted + ``checkpoint_syncs``), saves with
     their seconds and bytes, each stage's seconds, peak bytes.
  4. flash attention vs plain: ``flash_attention_cuda`` (the
     warp-specialised ``wgmma`` kernel, K and V staged by TMA) against
     ``attention_ref`` in bf16 on the card, over the cases of
     ``kernels/flash_attention/cases.py`` (GQA groups 1, 2 and 4, causal
     on and off, windows of 16 and 100, softcap 0 and 50, ``kv_len < Skv``
     scalar, per row and inside the ring's last stage, ``q_offset > 0``,
     ragged lengths at the 128-row and 64-key tile edges, fully masked
     rows, D = 16, 32, 64, 128 and 256, B > 1), each element within that
     module's bf16 rule; at gemma2-9b's full-width prefill shapes (global
     and local layers) the same rule, which must also reject a planted
     fault there (a kv tile the kernel visits dropped); timed there beside
     the plain version, with ptxas's registers and spills and TFLOP/s,
     and, as the yardstick, ``scaled_dot_product_attention`` on its flash
     backend at the causal variant without softcap or window.
  4b. flash attention at head dim 128, before any weights load: the
     layers of mistral-nemo-12b (32 / 8 heads), qwen1.5-32b (40 / 40),
     moonshot-v1-16b-a3b (16 / 16) and mixtral-8x7b (32 / 8, a window of
     4,096) at S = 8192, causal: each within the bf16 rule, a planted
     fault rejected, timed beside the plain version and the bound, with
     ptxas's registers and spills of ``flash_fwd_wgmma<128>``; on
     mistral-nemo's function (no window, no softcap) SDPA's flash backend
     beside the kernel, in turns.
  5. LM prefill at full width: gemma2-9b (9,241,404,928 parameters, random
     weights from seed 0), B = 1, S = 8192, through ``prefill_step``:
     exactly 42 flash attention launches (one per layer), finite logits,
     and their relative L2 error against the same prefill with the plain
     attention on the card.
  6. LM serving at full width: the port's serve launcher
     (``repro_torch.launch.serve``), gemma2-9b, batch 4, prompt 32, 16
     generated tokens.
  6b-6d. the rest of the LM family at full width (random weights from
     seed 0; mixtral-8x7b at the deepest of 26 and 24 of its 32 layers
     whose prefill fits, its 93.4 GB not fitting one card), arch by arch,
     each model freed before the next: 6b. ``build_cell``'s
     ``prefill_32k`` at batch 1 (S = 32,768 for mistral-nemo, 8,192 for
     the others; tokens from ``LMTokenPipeline(seed=0)``): the elements
     ``init_params`` makes against ``param_count()`` (qwen's QKV biases
     are the difference), layer 0's kernel attention on its last 1,024
     query rows against the plain attention at ``q_offset = S - 1,024``,
     the timed prefill with exactly one flash launch per layer, finite
     logits, and the prefill against the plain attention (logits for
     mistral-nemo, ``forward_hidden``'s output where two sets of logits
     do not fit beside the weights) at the longest length that fits,
     under 5% relative L2 (for the MoE archs layer by layer, each layer
     on the kernel path's input: a token routed the same within 2% of its
     plain-attention output, a token routed otherwise at a router
     near-tie, tokens with another pair dropped at most twice the
     rerouted pairs; the whole-model difference printed); 6c. for the MoE
     archs, the last layer's MoE FFN on the kernel path's input against
     ``models/moe_check.py``'s dense version (every expert on every token)
     under its rule, its planted fault (one slot fewer than the fullest
     expert's pairs) rejected, both timed, the top-k ties, the capacity
     and the dropped pairs; one prefill under
     ``torch.cuda.set_sync_debug_mode("error")``; once the model is freed
     (after 6d), the layer's backward at the training shape (B 4 x S
     4,096 tokens, the last layer's input over two sequences, its weights
     kept on the host meanwhile): the gradients in h, the router, every
     expert and the shared experts against the dense version's under
     ``moe_check.moe_grad_excess`` (2^-6 relative L2: h by token row, an
     expert leaf by expert), the dense version at one slot fewer above
     it, two backwards bit-equal, both backwards timed; 6d. ``decode_32k``
     against a cache of seeded bf16 values (mistral-nemo batch 8 at
     32,768; moonshot batch 1 at 32,768; qwen and mixtral batch 1 at the
     longest cache that fits), its first step under sync debug mode
     "error" for the MoE archs, then 5 timed steps beside the read bound
     (the weights but the embedding table, every expert, the whole
     cache). (A phase 6e ran the serve launcher per arch until the LM
     training phases needed its time: it repeated what 6b and 6d time;
     phase 6 drives the launcher.)
  7. CIN vs plain: ``cin_layer_cuda`` (3xTF32 ``wgmma``) against
     ``cin_layer_ref`` in float32 on the card, over the cases of
     ``kernels/cin/cases.py`` (B = 1, 7, 25, 37 and 512; m = 6 and 39;
     H = 6 to 200; H2 = 16 and 200; D = 8 and 10; ragged last tiles), each
     within that module's rule (``|o - r| <= 2^-16 A``, A the layer on
     absolute values), which must reject a planted fault (one h slice of W
     dropped) at full width; the same cases through the plain emulation of
     3xTF32 and of one TF32 pass (``emulated_layer``), read under the rule.
  8. CIN timed: xdeepfm's layer-1 (H = 39) and layer-2/3 (H = 200) shapes
     at B = 512, 16,384 and 262,144, beside two operations bounds (3xTF32
     on the tensor cores, the kernel's arithmetic; float32 FMA, the
     replaced kernel's), ptxas's registers and spills, the plain version
     and one ``torch.einsum`` call (the plain and library calls only where
     Z fits, B <= 16,384; float32, TF32 off).
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
  10b. The CIN's gradient kernels at the training batch's layers (B =
     65,536; layer 1, H = 39, and an H-200 layer): ``cin_dx_cuda`` (dxk
     and dx0 in one 3xTF32 launch, ``cin_dx_wgmma``), each output under
     the layer rule against the plain layer on its permuted operands,
     and ``cin_dw_cuda`` (3xTF32, ``cin_dw_wgmma``) under dW's rule
     against float64 (``|o - r| <= 16 u sqrt(K) (S + |r|)``,
     ``kernels/cin/cases.py``), each planted fault above its rule (a
     dropped slice of the permuted W; one tile of 128 values of k left
     out of dW), each timed beside its 3xTF32 and float32-FMA bounds, the
     route they replace in the same run (``cin_layer_cuda`` on the
     permuted operands for dxk and dx0), and, at B = 16,384, beside the
     plain versions and ``torch.einsum`` (float32, TF32 off).
  10c. xDeepFM training at full width and uncut: ``train_batch`` (B =
     65,536) through ``build_cell``, seed 0, one resident
     ``RecsysPipeline`` batch: the first step's gradients of every leaf
     against the float64 plain path in batch chunks under
     ``gnn_check.grad_excess`` (per leaf), a dW with one tile of k left
     out above it; step 1 under ``torch.cuda.set_sync_debug_mode(
     "error")``; steps 2-10 timed (median seconds, rows/s, peak bytes);
     exactly 3 forward, 3 dx (dxk and dx0 in one launch) and 3 dW
     launches a step; the loss falling.
  11. segment_mm vs plain: ``segment_mm_cuda`` against ``segment_mm_ref``
     run in float64 on the card, over the cases of
     ``kernels/segment_mm/cases.py`` (the reference's sweep (N, E, D) =
     (100, 500, 32), (600, 2500, 64), (50, 2000, 128), (257, 513, 16);
     D = 1, 4, 7, 8 and 256; E = 0; N = 1; duplicates and self-loops;
     empty rows; rows of 1,024, 1,025, TILE and TILE + 1 edges; 40,000-
     and 5,000-edge hubs), each at the default piece size (``TILE`` merged
     items) and at 32 (nearly every row crosses a piece boundary), each
     element within that module's rule (``|o - r| <= 16 u sqrt(K) A``, A
     the sum on absolute values, K the row's length), two launches
     bit-identical; both planted faults (an edge dropped from a row of
     average length, 1,024 of the hub's edges dropped) must read > 1; bad
     inputs (a misaligned or column-strided x among them) raise before any
     launch.
  12. segment_mm timed: on the reference's ``ogb_products`` graph
     (2,449,029 nodes, 61,859,140 edges, from ``gnn_full_graph_batch``,
     seed 0) with gcn-cora's coefficients, at D = 16 and 7 (its two
     layers' widths): the kernel's ms per launch (CUDA events; the fix-up
     launch included) at the default piece size and at 1,024, beside the
     plain version's, ``torch.sparse.mm`` of the same CSR (the yardstick),
     the compulsory byte bound, the gathered bound at 4 D bytes an edge
     and counted in 32-byte sectors from x's stride and alignment, and a
     static L2 estimate (the rows read most that fit 40 and 50 MiB read
     once, every other gather its sectors; not a bound); at D = 7 also x
     as the ``[:, :7]`` view of an ``[N, 8]`` tensor (rows padded to 32
     bytes) and gcn-cora's layer 2 (``x @ W`` and the aggregation) both
     ways; the hub row alone (39,485 edges) under the rule, two launches
     bit-equal.
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
  14. gatedgcn, meshgraphnet and equiformer-v2 at full width (random
     weights from seed 0; batches from the copied batch functions, seed 0,
     and ``e`` drawn with numpy from seed 0 at ``GNN_EDGE_DIM``'s widths)
     on ``molecule`` and ``full_graph_sm``: the layouts built once
     (``resident_graph``), a warm-up, then 10 timed forwards (median
     seconds, graphs/s or nodes/s, peak bytes) with exactly
     ``segment_mm_launches(cfg)`` launches each (16, 15 and 24), the first
     and last logits bit-equal, the logits under the element-wise spread
     rule of ``models/gnn_check.py`` (the plain path in float64 the exact
     side, in float32 the spread; excess <= 1; the global rule's reading
     printed beside it), one edge dropped from the summed layout reading
     above it, and the loss beside the plain path's.
  15. gatedgcn and meshgraphnet on ``ogb_products`` (2,449,029 nodes, the
     gcn phase's seed-0 arrays) with the edges cut to the first n, n the
     most (a multiple of 2^20) at which the float64 plain forward (the
     rule's exact side, the cell's largest run) fits the free memory
     (``mem_get_info``) less 10 GiB, from a linear fit of its peak at 2^22
     and 2^23 edges (printed with the cut); 3 timed forwards, checked as in
     phase 14. equiformer-v2 does not run there: its node irreps alone
     would be 61.4 GB.
  16. equiformer-v2's rotation invariance at full width on ``molecule``:
     the reference's check (``pos`` rotated about z by 1.1: within 1e-3;
     its planted fault, rotating back without the transpose, is invariant
     about z too and is printed); under ``gnn_check.ROTATION`` on the batch
     without its self-loops, within 8 float32 spreads, and the planted
     fault above that.
  17. segment_mm's gradient (``segmm_backward``): the kernel over
     ``transpose_layout`` of ``ogb_products``' CSR (rows the sources, items
     the same edges, gcn-cora's coefficients carried by its ``perm``) at
     D = 16 and 7, against the float64 plain version under the float32
     rule, one item dropped reading above it, two launches bit-equal,
     timed beside the plain version, ``torch.sparse.mm`` of the
     transposed CSR (the yardstick; the port never calls it) and the
     byte bound. Each cell of phase 18 holds the same check at its own
     transposed layouts and widths (``backward_launches``; equiformer-v2
     also at ``minibatch_lg``'s uncut 8.8 M one-item rows), with a
     minibatch's padding rows of ``dy`` zero, as a step's are.
  18. GNN training at full width (``gnn_train``): each arch's cells
     through ``build_cell`` (``train_step``: the regime's loss, its
     gradient by autograd, AdamW), weights from seed 0: gcn-cora at
     ``molecule``, ``full_graph_sm``, ``ogb_products`` whole and
     ``minibatch_lg``; gatedgcn and meshgraphnet at ``molecule``,
     ``full_graph_sm``, ``minibatch_lg`` and ``ogb_products`` cut to its
     first nodes and the edges among them (the node states a backward
     keeps, 16 or 15 layers of 2,449,029 rows, do not fit whatever the
     edges); equiformer-v2 at ``molecule``, ``full_graph_sm`` and
     ``minibatch_lg`` with ``batch_nodes`` cut. A cut is the most nodes
     (a multiple of 2^13) or seeds (of 16) at which the plain path's
     float32 step fits the free memory less 12 GiB, from a linear fit of
     its peak reserved bytes at two sizes (printed against the
     ``ShapeSpec``).
     ``minibatch_lg`` samples from ``gnn_full_graph_batch`` at its sizes
     (232,965 nodes, 114,615,892 edges; made with the sampler's CSR by a
     worker process while the phases before run), its node table resident
     on the card: a step's batch uploads only ids and edges
     (``gnn_minibatch_batch``); the sampler's and the layouts' host
     seconds of 3 batches print apart from the step. Per cell: the first
     step's loss and every gradient leaf on the kernel path against the
     plain path's (``gnn_check.grad_excess`` against float64; at a cut
     cell on a quarter of the cut, where the float64 step fits), and one
     edge
     dropped from the transposed layout beside it (above 1 at
     ``molecule`` and ``full_graph_sm``); step 1 under
     ``torch.cuda.set_sync_debug_mode("error")``; steps 2-10 on the same
     batch (median seconds, nodes, graphs or seeds per second, peak
     bytes) with exactly ``2 segment_mm_launches(cfg)`` launches a step;
     the loss of every step, falling (equiformer-v2's one-class cells,
     whose loss and gradient are 0 whatever the weights, stay at 0).
  19. the flash attention backward (``flash_backward``):
     ``flash_attention_bwd_cuda`` (three launches: delta, dK/dV, dQ)
     against the float64 plain backward on the kernel forward's own o and
     lse, over ``kernels/flash_attention/cases.py``'s ``GRAD_CASES`` (GQA
     1, 2 and 4; causal and bidirectional; windows; softcap 50, with and
     without a window; ``q_offset``; ``kv_len`` per row; ragged lengths;
     fully masked rows; D 128 and 256), each output under that module's
     backward rule, both planted faults (a dropped query tile in dK/dV,
     a dropped kv tile in dQ) above it, two launches bit-equal; timed at
     S 4,096 on gemma2-9b's global and local layers (B 1, 16 / 8 heads of
     256, softcap 50), mistral-nemo-12b's (32 / 8 of 128) and the MHA
     layers of qwen1.5-32b (40 / 40) and moonshot-v1-16b-a3b (16 / 16),
     each under the rule, beside the plain ``mef_backward``, the bound
     (2.5 times the forward's flops), ptxas's registers and spills, and
     (all but gemma2's local layer) SDPA's backward on its flash backend
     in turns with the kernel at the causal function without softcap.
  20. LM training at full width (``lm_train``): gemma2-9b's ``train_4k``
     through ``build_cell`` at batch 4 and S 4,096, cut in depth to the
     deepest even count whose fitted peak (one step at 2 and 4 layers,
     ``max_memory_reserved``, linear in the layers) leaves 4 GiB free,
     two layers less while a step runs out of memory;
     the first step's gradients (from the same seed, without optimizer
     state) against the plain attention's (``attention_mef``) per leaf;
     step 1 under sync debug mode "error"; steps 2-10 timed (median, min,
     max; tokens/s, model TFLOP/s from ``_lm_model_flops``, peak bytes);
     exactly 2L forward and L backward flash launches a step; the loss
     falling.
  20b. the rest of the LM family's training (``lm_family_train``):
     mistral-nemo-12b, qwen1.5-32b, moonshot-v1-16b-a3b and mixtral-8x7b
     as phase 20 runs gemma2-9b (any depth; the fit at 2 and 4 layers,
     mixtral's at 1 and 2; batch 4, halved while fewer than 2 layers
     fit), 4 steps (3 timed), the gradient check at 2 layers (the
     script's time limit). For the MoE archs the gradient check pins
     the routing (``RoutePin``, in this script only): the plain pass
     routes each token to the kernel pass's forward choices, with gates
     from its own probabilities, and counts the tokens it would have
     routed otherwise; remat's recompute in the kernel pass must route as
     its forward, layer by layer; the first step's dropped share is
     printed; on moonshot a planted fault (layer 0's dispatched
     activations detached) must read above the rule.
  21. the train launcher (``lm_train_launcher``): ``launch/train.py`` at
     phase 20's depth and batch for 3 steps, no save (at that size one
     would write about 47 GB), and at its default arch (mistral-nemo-12b,
     no ``--arch``) at phase 20b's depth and batch; then at the smoke
     config in bf16 at head
     dim 128, 4 steps with a save every 2, a real SIGTERM after step 2
     (exit 75), ``--resume``, and the result against an uninterrupted run.

Prints one JSON line per phase, the wall seconds of each phase group as
it ends (``group_seconds``; the graph group's also phase by phase, with
``graph_phase``) and all of them together (``group_seconds_total``), the
kernel table, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pathlib
import re
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import types
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:   # the card's rates, defined once in the port
    from repro_torch.runtime.roofline import (BF16_FLOPS_PER_S,
                                              F32_FLOPS_PER_S,
                                              HBM_BYTES_PER_S,
                                              TF32_FLOPS_PER_S)
except ImportError:   # not a checkout of the repository: main() refuses
    pass
INF, BIG = 2**31 - 1, 2**30
CAL_NODES = 1_890_815           # DIMACS 9th Challenge USA-road-d.CAL
CASCADE_MAX_LEVELS = 6          # the tau-130 cascade's level cap
SSSP_ROAD_NODES = 32_768        # the competitor's road graph (see phase 3b)
PAPER_GRAPH_NODES = 1 << 24     # the paper-graph cell's roads-USA scale
ESTIMATE_FIELDS = ("phi_approx", "phi_quotient", "radius", "n_clusters",
                   "growing_steps", "n_stages", "delta_end", "connected")


def trace_job(n: int, seed: int, argv: list) -> tuple:
    """In a worker process: ``road_like(n, seed)``'s update trace by
    ``serve.update_traces``' rule (seed = the graph's index), and the host
    seconds ``temporal_trace`` took."""
    from repro_torch.common import Timer
    from repro_torch.graph import road_like
    from repro_torch.launch import serve

    graph = road_like(n, seed=seed)
    args = serve.parse_args(argv)
    with Timer() as t:
        trace = serve.update_traces([graph], args, seeds=[seed])[0]
    return trace, t.seconds


def graph_job(n: int, seed: int) -> tuple:
    """In a worker process: ``road_like(n, seed)`` and its host seconds."""
    from repro_torch.common import Timer
    from repro_torch.graph import road_like

    with Timer() as t:
        graph = road_like(n, seed=seed)
    return graph, t.seconds


def sync_sites(fn) -> tuple:
    """``fn()`` under ``guard.measured_transfers("log")`` (sync debug mode
    "warn"), catching each warning: returns ``(fn's result, {the port's
    source line that synchronised: count})``. ``guard.fetch`` lifts the
    mode around its own copy, so only the reads and blocking copies that
    bypass it appear."""
    import traceback
    import warnings

    from repro_torch import guard

    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        # PyTorch's own notice, printed once when a process first sets the
        # mode ("... a prototype feature ..."), is not a synchronisation
        text = str(message)
        if "synchroniz" not in text or "prototype" in text:
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "repro_torch" in f.filename]
        key = (f"{ours[-1].filename.split('src/')[-1]}:{ours[-1].lineno}"
               if ours else f"{filename}:{lineno}")
        sites[key] = sites.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        with guard.measured_transfers("log"):
            out = fn()
    return out, sites


def _fail(msg: str, code: int) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return code


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_entries(log: str) -> list:
    """Each entry function of an ``nvcc -Xptxas -v`` log (its mangled
    name) with its registers and spill bytes."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"entry": m.group(1)}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = \
                nums[:3]
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def ptxas_entry(name: str, sources, flags, entry: str) -> dict:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported for the
    first kernel of library ``name`` whose mangled name holds ``entry``."""
    from repro_torch.kernels import _build

    log = _build.library_path(name, sources, flags).with_suffix(".log")
    found, out = False, {}
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            found = entry in ln
        elif found and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out["stack_bytes"], out["spill_stores"], out["spill_loads"] = nums[:3]
        elif found and "Used" in ln and "registers" in ln:
            out["registers"] = int(ln.split("Used")[1].split()[0])
            break
    return out


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


def star_edges(hub_in: bool, hub_out: bool, leaves: int = 100_000):
    """Node 0 a hub of ``leaves`` in-edges (from nodes 2..) and/or out-edges
    (to nodes 2..), fed by node 1: (src, dst, w, n) as int32 arrays."""
    leaf = np.arange(2, leaves + 2, dtype=np.int32)
    src, dst = [np.array([1], np.int32)], [np.array([0], np.int32)]
    if hub_in:
        src.append(leaf)
        dst.append(np.zeros(leaves, np.int32))
    if hub_out:
        src.append(np.zeros(leaves, np.int32))
        dst.append(leaf)
    src, dst = np.concatenate(src), np.concatenate(dst)
    w = np.random.default_rng(leaves).integers(1, 9, src.shape[0])
    return src, dst, w.astype(np.int32), leaves + 2


def star_planes(n: int):
    """Node 1 live at d 0 (so node 0 changes in the first superstep), every
    seventh leaf live, every eleventh a relay, the rest at INF."""
    r = np.random.default_rng(1)
    d = np.full(n, INF, np.int32)
    d[1] = 0
    d[2::7] = r.integers(0, 40, d[2::7].shape[0])
    c = np.where(d < INF, np.arange(n), INF).astype(np.int32)
    rw0 = np.full(n, BIG, np.int32)
    rw0[3::11] = -r.integers(0, 5, rw0[3::11].shape[0])
    rc = np.where(rw0 < BIG, 7, INF).astype(np.int32)
    rp = np.where(rw0 < BIG, 3, INF).astype(np.int32)
    return d, c, d.copy(), rw0, rc, rp


def degree_rows(degrees, seed: int):
    """Row i with exactly degrees[i] in-edges, and node i with as many
    out-edges, from and to a 50-node tail: (src, dst, w, n)."""
    r = np.random.default_rng(seed)
    k = len(degrees)
    n = k + 50
    rows = np.repeat(np.arange(k), degrees).astype(np.int32)
    src = np.concatenate([r.integers(k, n, rows.shape[0]), rows])
    dst = np.concatenate([rows, r.integers(k, n, rows.shape[0])])
    w = r.integers(1, 20, src.shape[0])
    return (src.astype(np.int32), dst.astype(np.int32), w.astype(np.int32),
            n)


def relax_bytes(torch, g, planes, delta) -> int:
    """Least bytes this superstep must move on these inputs: the CSR
    (row_ptr, src, w) and d, rw0 read once; c, pathw read once for the
    sources of admissible live edges and rc, rp for those of admissible
    relay edges; three output planes written once. With every source
    admissible this is ``roofline.relax_pass_bytes(n, e)``, the upper form
    the autotuner prices a superstep by."""
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
    ``relax_bytes`` counts: a row with a source on the frontier has its
    frozen byte read (whether it runs); a row that runs (not frozen)
    reads its two row_ptr entries, src and w of each in-edge, d and rw0 of
    its sources (once per source), c/pathw or rc/rp of the admissible ones,
    and its own d; a changed row writes d, c, pathw, reads its two out_ptr
    entries and its out-edges' destinations (the ``n_marks`` out-edges of
    the changed rows). Rows that do not run move nothing."""
    n = g.n_nodes
    src, dst = g.src.to(torch.int64), g.dst.to(torch.int64)
    hits = torch.zeros(n, dtype=torch.int32, device=src.device).index_add_(
        0, dst, front.to(torch.int32)[src]) > 0
    runs = ~frozen & hits
    e_run = runs[dst]
    s_run = src[e_run]
    ds, r0, w = planes[0][s_run], relay[0][s_run], g.w[e_run]
    live_ok = (ds < delta) & (w < delta)
    w_red = torch.clamp_min(w + torch.clamp_max(r0, BIG), 0)
    relay_ok = (r0 < BIG) & (w_red < delta)
    n_src = int(torch.unique(s_run).numel())
    n_live = int(torch.unique(s_run[live_ok & ~relay_ok]).numel())
    n_relay = int(torch.unique(s_run[relay_ok]).numel())
    return (int(hits.sum()) + 12 * int(runs.sum()) + 8 * int(e_run.sum())
            + 8 * n_src + 8 * n_live + 8 * n_relay
            + 20 * n_changed + 4 * n_marks)


def mega_launch_bytes(torch, mk, g, planes, relay, frozen, front, params,
                      k: int) -> int:
    """Least bytes one launch of ``k`` fused supersteps must move on these
    inputs: d, c, pathw and the frontier of every row read once and
    written once (26n: the outputs are new tensors), and ``mega_bytes``
    for each superstep the launch executes (stepped one superstep at a time
    with the plain version, under the same stop rule)."""
    total = 26 * g.n_nodes
    out_ptr, _ = g.out_csr()
    out_deg = (out_ptr[1:] - out_ptr[:-1]).to(torch.int64)
    for j in range(k):
        p = params._replace(steps_base=params.steps_base + j)
        d, c, pw, f, st = mk.fused_grow_supersteps_plain(
            planes, relay, frozen, front, g, p, 1)
        if int(st[1, mk.COL_EXECUTED]) == 0:
            break
        n_changed = int(st[0, mk.COL_CHANGED])
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
    ``serve_bulk`` forward (B = 262,144, full width) and one xdeepfm
    ``train_batch`` step (B = 65,536, full width), then one gemma2-9b
    ``train_4k`` step at full width cut to ``PROFILE_TRAIN_LAYERS`` layers
    and batch 4 (S 4,096), then 5 gcn-cora
    forwards on ``ogb_products`` (2,449,029 nodes), under
    ``torch.profiler``, each after a warm-up run, printing the device-busy
    share of the host-clock time, the device ops launched and the kernels
    that take the device time. Not part of the default run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False", 2)
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

    cell = build_cell("xdeepfm", "train_batch", device=dev)
    shape = {s.name: s for s in RECSYS_SHAPES}["train_batch"]
    batch = cell.inputs(RecsysPipeline(cfg, shape, seed=0).batch(
        DataCursor()))
    state = list(cell.init(0))

    def train_step():
        state[0], state[1], loss, _ = cell.step_fn(state[0], state[1], batch)
        return loss

    _, stats = profiled(train_step)
    emit({"phase": "profile", "path": "recsys_train_step",
          "batch": shape.batch, **stats})
    del cell, batch, state
    gc.collect()
    torch.cuda.empty_cache()

    from functools import partial

    from repro_torch.config import LM_SHAPES
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch import steps as steps_mod

    steps_mod.get_arch = partial(arch_at_depth,
                                 layers=PROFILE_TRAIN_LAYERS)
    try:
        cell = build_cell("gemma2-9b", "train_4k", device=dev,
                          batch=LM_TRAIN_BATCH)
    finally:
        steps_mod.get_arch = get_arch
    shape = dataclasses.replace({s.name: s for s in LM_SHAPES}["train_4k"],
                                global_batch=LM_TRAIN_BATCH)
    batch = cell.inputs(LMTokenPipeline(cell.cfg, shape, seed=0).batch(
        DataCursor()))
    state = list(cell.init(0))

    def lm_train_step():
        state[0], state[1], loss, _ = cell.step_fn(state[0], state[1], batch)
        return loss

    _, stats = profiled(lm_train_step)
    emit({"phase": "profile", "path": "lm_train_step",
          "layers": PROFILE_TRAIN_LAYERS, "batch": LM_TRAIN_BATCH,
          "seq": shape.seq_len, **stats})
    del cell, batch, state
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
# The rest of the LM family on one card, each at full width (mixtral-8x7b
# at the deepest of `layers` whose prefill fits: its 32 layers are 93.4 GB
# in bf16). prefill_seq: the prefill_32k cell's length at batch 1 (cut to
# what fits, and printed, if it does not); decode_batch / decode_len: the
# decode_32k cell's batch and cache length (None: the longest multiple of
# 1,024 that fits beside the weights); check: how the prefill is held
# against the plain attention: on its logits; on forward_hidden's output
# where two sets of logits do not fit beside the weights; or, for the MoE
# archs, layer by layer (moe_layers_vs_plain).
LM_FAMILY = {
    "mistral-nemo-12b": dict(prefill_seq=32768, decode_batch=8,
                             decode_len=32768, check="logits"),
    "qwen1.5-32b": dict(prefill_seq=8192, decode_batch=1, decode_len=None,
                        check="hidden"),
    "moonshot-v1-16b-a3b": dict(prefill_seq=8192, decode_batch=1,
                                decode_len=32768, check="layers"),
    "mixtral-8x7b": dict(prefill_seq=8192, decode_batch=1, decode_len=None,
                         check="layers", layers=(26, 24)),
}
MEM_MARGIN = 3 << 30            # bytes kept free beside each run's estimate
PREFILL_MARGIN = 1 << 30        # the same beside a prefill's estimate (it
#                                 overshot qwen's measured peak by 2.5 GB)
MOE_ROW_REL = 2e-2              # per-token rule of the MoE layers' check
NEAR_TIE = 2.0 ** -6            # router logits this close (x (1 + |l|)) tie
LAYER_CHECK_ROWS = 1024         # query rows of layer 0 held against plain
DECODE_STEPS = 5                # timed decode steps of a decode cell
LEAK_BYTES = 1 << 30            # allowed allocated once an arch's model is
#                                 freed (the launcher inits the model anew)


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
    # The rule must also reject a planted fault there: the kernel's 128-row
    # query tiles from row 4,096 on skip the first 64-key tile they would
    # visit (a global row loses keys 0-63 of its 4,097 to 8,192; a local
    # row, up to 63 of its 4,096, in the tile the window's edge cuts)
    flash_ptxas = ptxas_entry(fmod.NAME, fmod.SOURCES, fmod.EXTRA_FLAGS,
                              "flash_fwd_wgmmaILi256E")
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
               "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9,
               "ptxas": flash_ptxas}
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
    gflop = timed["global"]["gflop"]
    emit({"phase": "flash_yardstick", "variant": "causal, no softcap, "
          "no window", "library": "scaled_dot_product_attention",
          "backend": "SDPBackend.FLASH_ATTENTION (forced)",
          "library_ms": sdpa_ms, "kernel_ms": same_variant_ms,
          "library_tflop_s": gflop / sdpa_ms, "kernel_tflop_s": gflop /
          same_variant_ms, "kernel_vs_library": sdpa_ms / same_variant_ms,
          "bound_ms": timed["global"]["bound_ms"], "ptxas": flash_ptxas})
    del q, k, v, kk, vv

    # -- phase 4b: the kernel at head dim 128, the other LM archs' layers ----
    # at S = 8192, before any weights load: each arch's heads and window,
    # causal, no softcap; the rule, a planted fault, the bound, and on
    # mistral-nemo-12b's function (no window, no softcap, GQA 4) SDPA's
    # flash backend beside the kernel
    d128_ptxas = ptxas_entry(fmod.NAME, fmod.SOURCES, fmod.EXTRA_FLAGS,
                             "flash_fwd_wgmmaILi128E")
    d128 = {}
    for arch in LM_FAMILY:
        c = get_arch(arch)
        Hq, Hkv, D, window = (c.n_heads, c.n_kv_heads, c.head_dim,
                              c.sliding_window)
        scale = D ** -0.5
        q, k, v = (randn(1, Hq, SEQ, D), randn(1, Hkv, SEQ, D),
                   randn(1, Hkv, SEQ, D))
        kw = dict(causal=True, window=window, scale=scale)
        out = fmod.flash_attention_cuda(q, k, v, **kw)
        ref = attention_ref(q, k, v, **kw)
        err = float((out.float() - ref.float()).abs().max())
        excess = bf16_excess(out, ref)
        bad = planted_fault(q, k, v, from_row=SEQ // 2, window=window,
                            scale=scale)
        fault_excess = bf16_excess(bad, ref)
        if excess > 1.0 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash attention D 128 at {arch}'s layer: "
                                 f"error {excess} times the bf16 rule's")
        if fault_excess <= 1.0:
            raise AssertionError(f"flash attention D 128 at {arch}'s layer: "
                                 f"the bf16 rule passed a dropped kv tile")
        flash_err, flash_excess = max(flash_err, err), max(flash_excess,
                                                           excess)
        del out, ref, bad
        bound, by, flops = attention_bound_ms(1, Hq, Hkv, SEQ, SEQ, D, True,
                                              window)
        row = {"phase": "flash_d128", "arch": arch,
               "shape": [1, Hq, Hkv, SEQ, SEQ, D], "window": window,
               "softcap": 0.0, "max_abs_err": err, "excess": excess,
               "planted_fault": {"excess": fault_excess},
               "ms": time_ms(torch, lambda: fmod.flash_attention_cuda(
                   q, k, v, **kw), 20),
               "plain_ms": time_ms(torch, lambda: attention_ref(q, k, v,
                                                                **kw), 3),
               "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9,
               "ptxas": d128_ptxas}
        row["tflop_s"] = flops / row["ms"] / 1e9
        row["bound_share"] = bound / row["ms"]
        if arch == "mistral-nemo-12b":
            # exactly mistral-nemo's attention function: k and v expanded
            # to 32 heads outside the timing; kernel and library in turns
            kk, vv = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, kk, vv, is_causal=True, scale=scale)

            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                times = [time_ms(torch, lambda: fmod.flash_attention_cuda(
                             q, k, v, **kw), 20), time_ms(torch, sdpa, 20),
                         time_ms(torch, sdpa, 20),
                         time_ms(torch, lambda: fmod.flash_attention_cuda(
                             q, k, v, **kw), 20)]
            row["library_ms"] = (times[1] + times[2]) / 2
            row["kernel_ms_beside_library"] = (times[0] + times[3]) / 2
            row["library"] = ("scaled_dot_product_attention, "
                              "SDPBackend.FLASH_ATTENTION (forced), causal")
            row["kernel_vs_library"] = (row["library_ms"]
                                        / row["kernel_ms_beside_library"])
            del kk, vv
        d128[arch] = row
        emit(row)
        del q, k, v

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
            "tflop_s": g["tflop_s"], "ptxas": flash_ptxas,
            "local_ms": loc["ms"], "local_plain_ms": loc["plain_ms"],
            "local_bound_ms": loc["bound_ms"],
            "launches_by_path": {"lm_prefill": prefill_launches,
                                 "lm_serve": serve_launches},
            "d128": {a: {key: r[key] for key in
                         ("ms", "plain_ms", "bound_ms", "bound_by",
                          "tflop_s", "excess", "planted_fault")}
                     for a, r in d128.items()},
            "d128_library_ms": d128["mistral-nemo-12b"]["library_ms"],
            "d128_kernel_ms_beside_library":
                d128["mistral-nemo-12b"]["kernel_ms_beside_library"],
            "d128_ptxas": d128_ptxas}


def all_finite(torch, t, chunk: int = 1024) -> bool:
    """Whether every element of ``t`` is finite, over its second axis in
    chunks (no full-size boolean tensor)."""
    return all(bool(torch.isfinite(t[:, i:i + chunk]).all())
               for i in range(0, t.shape[1], chunk))


def free_bytes(torch, dev) -> int:
    """Device bytes free once the allocator's cache is released."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(dev)[0]


def longest_fit(need, free: int, cap: int, step: int = 1024,
                margin: int = MEM_MARGIN) -> int:
    """The largest multiple of ``step`` up to ``cap`` (or ``cap`` itself)
    whose ``need(n)`` bytes fit in ``free`` less ``margin``; 0 if none."""
    n = cap
    while n > 0 and need(n) > free - margin:
        n = (n - 1) // step * step
    return n


def moe_layers_vs_plain(torch, tf, params, cfg, tokens) -> dict:
    """An MoE model's prefill held against the plain attention layer by
    layer: each layer runs on the kernel path's input twice, its attention
    through the kernel and through the plain version, each followed by the
    MoE FFN, and each token's kept experts (its top k, less the pairs
    dropped past the capacity) are compared. The rules: a token whose kept
    experts are the same both ways is within ``MOE_ROW_REL`` (relative L2)
    of its plain-attention layer output, as the CPU tests' bf16 MoE layer;
    a token routed to other experts is at a bf16 near-tie, its router
    logits at ranks k and k + 1 within ``NEAR_TIE (1 + |logit|)``; and a
    token with the same top k but another pair dropped owes it to the
    rerouted pairs, each of which moves the queue of two experts by one,
    so there are at most twice as many such tokens as rerouted pairs."""
    S, d, k = tokens.shape[1], cfg.d_model, cfg.top_k
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    cap = tf.moe_capacity(S, cfg)
    worst_same = worst_tie = 0.0
    rerouted, shifted, pairs = [], [], []
    with torch.inference_mode():
        x = tf._embed(params, tokens, cfg)
        for i in range(cfg.n_layers):
            lp = tf.layer_params(params, i)
            outs = []
            for impl in ("auto", "ref"):
                a, _ = tf._attention_block(x, lp, cfg, pos, S,
                                           tf._layer_window(cfg, i),
                                           attn_impl=impl)
                h = tf.rmsnorm(a, lp["mlp_norm"], cfg.norm_eps).reshape(
                    1, S, d)
                logits = (h @ lp["router"]).float()[0]
                _, gates, experts, _ = tf.moe_route(h, lp["router"], cfg)
                keep = tf.moe_dispatch(experts, gates, cap,
                                       cfg.n_experts)[3].view(S, k)
                experts = experts[0]
                outs.append((tf._mlp(a, lp, cfg)[0][0].float(), logits,
                             experts.sort(dim=-1)[0],
                             torch.where(keep, experts, -1).sort(dim=-1)[0]))
                del a, h
            (yk, lk, tk, kk), (yp, _, tp, kp) = outs
            same = (kk == kp).all(dim=-1)
            moved = ~(tk == tp).all(dim=-1)
            rel = (yk - yp).norm(dim=-1) / yp.norm(dim=-1)
            worst_same = max(worst_same, float(rel[same].max()))
            ranked = lk.sort(dim=-1, descending=True)[0]
            ratio = ((ranked[:, k - 1] - ranked[:, k]).abs()
                     / (NEAR_TIE * (1 + ranked[:, k - 1].abs())))
            if bool(moved.any()):
                worst_tie = max(worst_tie, float(ratio[moved].max()))
            common = (tk[:, :, None] == tp[:, None, :]).any(dim=-1).sum(-1)
            rerouted.append(int(moved.sum()))
            pairs.append(int((k - common)[moved].sum()))
            shifted.append(int((~same & ~moved).sum()))
            x = yk.to(x.dtype)[None]
            del outs, yk, yp, lk, tk, tp, kk, kp
    return {"tokens": S, "capacity": cap,
            "worst_same_routing": worst_same,
            "rule_same_routing": MOE_ROW_REL,
            "rerouted_tokens_by_layer": rerouted,
            "rerouted_pairs_by_layer": pairs,
            "drop_shifted_tokens_by_layer": shifted,
            "drops_within_twice_rerouted_pairs": all(
                s_ <= 2 * p_ for s_, p_ in zip(shifted, pairs)),
            "worst_near_tie": worst_tie}


def lm_act_bytes(cfg, S: int) -> int:
    """A generous estimate of one forward's activation bytes at S tokens
    (batch 1, bf16): the residual stream and its norms, q/k/v, and the
    FFN's widest tensors (an MoE layer's dispatch buffer, gate, up and
    product over ``S k cf`` slots, its float32 gathered products, the
    shared expert)."""
    d, D = cfg.d_model, cfg.head_dim
    qkv = 4 * (cfg.n_heads + 2 * cfg.n_kv_heads) * D
    if hasattr(cfg, "n_experts"):
        slots = cfg.top_k * cfg.capacity_factor
        fs = (cfg.d_ff_shared or cfg.d_ff) * cfg.n_shared_experts
        ffn = int(slots * (4 * d + 8 * cfg.d_ff)) + 8 * cfg.top_k * d + 8 * fs
    else:
        ffn = 8 * cfg.d_ff
    return S * (16 * d + qkv + ffn)


def lm_prefill_bytes(cfg, S: int) -> int:
    """Bytes a batch-1 prefill needs beside the weights: float32 logits
    and their bf16 product, the activations, and layer 0's check (the
    plain attention of ``LAYER_CHECK_ROWS`` rows, two float32 score
    copies)."""
    logits = 6 * S * cfg.vocab_size
    check = 8 * cfg.n_heads * min(S, LAYER_CHECK_ROWS) * S
    return max(logits, check) + lm_act_bytes(cfg, S)


def lm_plain_check_bytes(cfg, S: int, mode: str) -> int:
    """Bytes the prefill's check against the plain attention needs beside
    the weights at S tokens: the plain attention's three float32 score
    copies (its scores, softmax and masked softmax live at once) and
    boolean masks, the activations, and in "logits" mode two float32
    logits and a bf16 product."""
    scores = 12 * cfg.n_heads * S * S + 3 * S * S
    logits = 10 * S * cfg.vocab_size if mode == "logits" else 0
    return scores + logits + lm_act_bytes(cfg, S)


def lm_decode_bytes(cfg, B: int, L: int) -> int:
    """Bytes a decode cell needs beside the weights: the bf16 cache of L
    positions and one layer's float32 copies of k and v."""
    one_layer = B * cfg.n_kv_heads * L * cfg.head_dim
    return 4 * cfg.n_layers * one_layer + 8 * one_layer


def lm_family_phases(torch, dev) -> dict:
    """Phases 6b-6e, arch by arch over ``LM_FAMILY``; returns the flash
    attention launches of each arch's prefill and launcher run."""
    from repro_torch.config import get_arch
    from repro_torch.launch import serve, steps

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    launches = {}
    for arch, spec in LM_FAMILY.items():
        cfg = get_arch(arch)
        free = free_bytes(torch, dev)
        S = spec["prefill_seq"]
        if "layers" in spec:
            # the deepest cut whose weights and prefill fit on the card
            fits = [n for n in spec["layers"] if 2 * dataclasses.replace(
                cfg, n_layers=n).param_count() + lm_prefill_bytes(cfg, S)
                <= free - PREFILL_MARGIN]
            if not fits:
                raise AssertionError(f"{arch}: no depth of {spec['layers']} "
                                     f"fits {free} free bytes")
            cfg = dataclasses.replace(cfg, n_layers=fits[0])
        S = longest_fit(lambda n: 2 * cfg.param_count()
                        + lm_prefill_bytes(cfg, n), free, S,
                        margin=PREFILL_MARGIN)
        if S < LAYER_CHECK_ROWS:
            raise AssertionError(f"{arch}: the weights leave no room for a "
                                 f"prefill in {free} free bytes")
        cut = {"layers": [cfg.n_layers, get_arch(arch).n_layers],
               "prefill_batch": [1, 32], "prefill_seq_len": [S, 32768],
               "free_bytes": free}

        def cut_arch(name, smoke=False, _get=get_arch, _arch=arch,
                     _cfg=cfg):
            return _cfg if name == _arch and not smoke else _get(name, smoke)

        # build_cell and the launcher look the arch up by name: give them
        # the depth this card holds
        steps.get_arch = serve.get_arch = cut_arch
        try:
            launches[arch] = lm_family_arch(torch, dev, arch, cfg, spec, S,
                                            cut, gen)
        finally:
            steps.get_arch = serve.get_arch = get_arch
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def lm_family_arch(torch, dev, arch, cfg, spec, S, cut, gen) -> dict:
    """One arch of phases 6b-6e (see the module docstring)."""
    from repro_torch.common import Timer
    from repro_torch.config import LM_SHAPES, MoEConfig
    from repro_torch.data.pipeline import DataCursor, LMTokenPipeline
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.flash_attention.cases import bf16_excess
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import serve, steps
    from repro_torch.models import moe_check
    from repro_torch.models import transformer as tf

    is_moe = isinstance(cfg, MoEConfig)
    shape = dataclasses.replace({s.name: s for s in LM_SHAPES}[
        "prefill_32k"], global_batch=1, seq_len=S)

    # -- phase 6b: the prefill_32k cell at batch 1 ---------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    with Timer() as t_init:
        params = tf.init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated(dev)
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "unembed")
        if k in params)
    biases = sum(params["layers"][b].numel() for b in ("bq", "bk", "bv")
                 if b in params["layers"])
    if n_params != cfg.param_count() + biases:
        raise AssertionError(f"{arch}: init_params made {n_params} elements, "
                             f"param_count() {cfg.param_count()}")
    cell = steps.build_cell(arch, "prefill_32k", device=dev, batch=1,
                            seq_len=S)
    tokens = cell.inputs(LMTokenPipeline(cell.cfg, shape, seed=0).batch(
        DataCursor()))["tokens"]
    D, R = cfg.head_dim, LAYER_CHECK_ROWS
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    lp = tf.layer_params(params, 0)
    with torch.inference_mode():
        # layer 0's attention through the kernel, its last R query rows
        # against the plain attention at q_offset = S - R
        h = tf.rmsnorm(tf._embed(params, tokens, cfg), lp["attn_norm"],
                       cfg.norm_eps)

        def proj(w, b, heads):
            t = h @ lp[w]
            if cfg.qkv_bias:
                t = t + lp[b]
            return t.view(1, S, heads, D)

        q = tf.rope(proj("wq", "bq", cfg.n_heads), pos, cfg.rope_theta)
        k = tf.rope(proj("wk", "bk", cfg.n_kv_heads), pos, cfg.rope_theta)
        v = proj("wv", "bv", cfg.n_kv_heads)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        kw = dict(causal=True, window=tf._layer_window(cfg, 0),
                  softcap=cfg.attn_logit_softcap, scale=D ** -0.5)
        out = fmod.flash_attention_cuda(q, k, v, **kw)[:, :, S - R:]
        ref = attention_ref(q[:, :, S - R:], k, v, q_offset=S - R, **kw)
        layer0_excess = bf16_excess(out, ref)
        del h, q, k, v, out, ref
    if layer0_excess > 1.0:
        raise AssertionError(f"{arch}: layer 0's kernel attention is "
                             f"{layer0_excess} times the bf16 rule's")
    cell.step_fn(params, {"tokens": tokens[:, :256]})   # warm-up (cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fmod.flash_attention_cuda.launches = 0
    with Timer() as t_pre:
        logits = cell.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    prefill_launches = fmod.flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if prefill_launches != cfg.n_layers:
        raise AssertionError(f"{arch}: the prefill launched flash attention "
                             f"{prefill_launches} times, not {cfg.n_layers}")
    if tuple(logits.shape) != (1, S, cfg.vocab_size) \
            or not all_finite(torch, logits):
        raise AssertionError(f"{arch}: prefill logits are malformed or not "
                             f"finite")
    del logits

    # the prefill against the same prefill with the plain attention, at the
    # longest length where that fits beside the weights
    mode = spec["check"]
    S_chk = longest_fit(lambda n: lm_plain_check_bytes(cfg, n, mode),
                        free_bytes(torch, dev), min(S, SEQ))
    if not S_chk:
        raise AssertionError(f"{arch}: no room for the plain attention")
    with torch.inference_mode():
        part = tokens[:, :S_chk]
        if mode == "logits":
            a = tf.prefill_step(params, part, cfg)
            b = tf.prefill_step(params, part, cfg, attn_impl="ref")
        else:
            a = tf.forward_hidden(params, part, cfg)[0]
            b = tf.forward_hidden(params, part, cfg, attn_impl="ref")[0]
        torch.cuda.synchronize()
    err = rel_l2(torch, a, b)
    del a, b
    layers = moe_layers_vs_plain(torch, tf, params, cfg, part) \
        if mode == "layers" else None
    # an MoE model is held layer by layer: a router near-tie that the two
    # attentions' bf16 roundings break differently sends a token to other
    # experts and, through attention, moves every later token, so its
    # whole-model difference is printed, not bounded
    if (mode != "layers" and not err < 5e-2) or (
            layers and not (layers["worst_same_routing"] < MOE_ROW_REL
                            and layers["worst_near_tie"] <= 1.0
                            and layers["drops_within_twice_rerouted_pairs"])):
        raise AssertionError(f"{arch}: prefill {mode}: relative L2 error "
                             f"{err} against the plain attention; {layers}")
    emit({"phase": "lm_family_prefill", "arch": arch, "cuts": cut,
          "params": n_params, "param_count": cfg.param_count(),
          "params_minus_param_count": n_params - cfg.param_count(),
          "qkv_bias_elements": biases,
          "active_param_count": (cfg.active_param_count() if is_moe
                                 else None),
          "init_seconds": t_init.seconds, "weight_bytes": weight_bytes,
          "batch": 1, "seq": S, "layers": cfg.n_layers,
          "flash_launches": prefill_launches, "seconds": t_pre.seconds,
          "tok_s": S / t_pre.seconds, "peak_bytes": peak,
          "model_flops": cell.model_flops,
          "model_tflop_s": cell.model_flops / t_pre.seconds / 1e12,
          "layer0_rows": [S - R, S], "layer0_excess": layer0_excess,
          "plain_check": mode, "plain_check_seq": S_chk,
          "rel_l2_vs_plain_attention": err,
          "rel_l2_bound": None if layers else 5e-2, "layers_check": layers,
          "logits_finite": True, "note": cell.note})

    # -- phase 6c: an MoE layer at full width against its dense check --------
    # the last layer, on the kernel path's input (deep layers route less
    # evenly than layer 0, whose input is the embedding)
    if is_moe:
        E, kk, last = cfg.n_experts, cfg.top_k, cfg.n_layers - 1
        lpl = tf.layer_params(params, last)

        def moe_input(toks):
            """The last layer's MoE input for one sequence of S tokens."""
            x = tf._embed(params, toks, cfg)
            for i in range(last):
                x, _ = tf._attention_block(x, tf.layer_params(params, i), cfg,
                                           pos, S, tf._layer_window(cfg, i))
                x = tf._mlp(x, tf.layer_params(params, i), cfg)[0]
            x, _ = tf._attention_block(x, lpl, cfg, pos, S,
                                       tf._layer_window(cfg, last))
            return tf.rmsnorm(x, lpl["mlp_norm"], cfg.norm_eps).reshape(
                1, S, cfg.d_model)

        # the backward's input at the training shape (B 4 x S 4,096
        # tokens): the last layer's input over as many sequences as that
        # takes, and the layer's weights, kept on the host until the model
        # is freed after phase 6d
        T_train = LM_TRAIN_BATCH * FLASH_BWD_SEQ
        more = [cell.inputs(LMTokenPipeline(cell.cfg, shape, seed=0).batch(
            DataCursor(step=j)))["tokens"] for j in range(1, -(-T_train // S))]
        with torch.inference_mode():
            h = moe_input(tokens)
            h_train = torch.cat([h] + [moe_input(t) for t in more],
                                dim=1)[:, :T_train]
        h_train = h_train.clone()       # a tensor autograd may record
        w_host = {name: t.to("cpu") for name, t in lpl.items()}
        with torch.inference_mode():
            probs, gates, experts, aux = tf.moe_route(h, lpl["router"], cfg)
            ranked = probs.sort(dim=-1, descending=True)[0]
            ties = int((ranked[..., kk - 1] == ranked[..., kk]).sum())
            cap = tf.moe_capacity(S, cfg)
            keep = tf.moe_dispatch(experts, gates, cap, E)[3]
            dropped = int((~keep).sum())
            fault_cap = moe_check.fault_capacity(experts, cap, E)
            got, _ = tf._moe_ffn(h, lpl, cfg)
            want = moe_check.moe_ffn_dense(h, lpl, cfg)
            excess = moe_check.moe_excess(got, want)
            fault = moe_check.moe_excess(moe_check.moe_ffn_dense(
                h, lpl, cfg, capacity=fault_cap), want)
            del got, want, probs, ranked, gates, experts, keep
            ms = time_ms(torch, lambda: tf._moe_ffn(h, lpl, cfg), 5)
            dense_ms = time_ms(torch, lambda: moe_check.moe_ffn_dense(
                h, lpl, cfg), 3)
            del h, lpl   # views of the stacked weights keep them alive
        if excess > 1.0 or fault <= 1.0:
            raise AssertionError(f"{arch}: MoE layer {last} against its "
                                 f"dense check: excess {excess}, planted "
                                 f"{fault}")
        emit({"phase": "lm_family_moe_layer", "direction": "forward",
              "arch": arch, "layer": last,
              "tokens": S, "experts": E, "top_k": kk,
              "capacity_factor": cfg.capacity_factor, "capacity": cap,
              "top_k_ties": ties, "pairs": S * kk, "dropped_pairs": dropped,
              "dropped_share": dropped / (S * kk),
              "aux_loss": float(aux), "excess": excess,
              "rule": "per token ||o - r|| <= 2^-6 ||r||",
              "planted_fault_capacity": fault_cap,
              "planted_fault": fault,
              "dispatch_ms": ms, "dense_ms": dense_ms})
        # one prefill under sync debug mode "error": nothing reads the card
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits = cell.step_fn(params, {"tokens": tokens})
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        del logits
    del tokens, cell

    # -- phase 6d: the decode_32k cell ----------------------------------------
    B = spec["decode_batch"]
    free = free_bytes(torch, dev)
    L = spec["decode_len"] or longest_fit(
        lambda n: lm_decode_bytes(cfg, B, n), free, 32768)
    if not L or lm_decode_bytes(cfg, B, L) > free - MEM_MARGIN:
        raise AssertionError(f"{arch}: a {B} x {L} cache does not fit "
                             f"{free} free bytes")
    cell = steps.build_cell(arch, "decode_32k", device=dev, batch=B,
                            seq_len=L)
    kv_shape, kv_dtype = cell.arg_shapes["k"]
    cache = {name: torch.empty(kv_shape, dtype=kv_dtype, device=dev)
             for name in ("k", "v")}
    for name in ("k", "v"):
        for i in range(cfg.n_layers):
            cache[name][i].normal_(generator=gen)
    cache["len"] = 0
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fmod.flash_attention_cuda.launches = 0
    if is_moe:    # the first step under sync debug mode "error"
        torch.cuda.set_sync_debug_mode("error")
    try:
        logits, new_cache = cell.step_fn(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if new_cache["len"] != L or tuple(logits.shape) != (B, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: decode step malformed")
    with Timer() as t_dec:
        for _ in range(DECODE_STEPS):
            logits = cell.step_fn(params, cache, tok)[0]
        torch.cuda.synchronize()
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    # a step reads every weight but the embedding table (B rows of it;
    # the untied unembed whole), every expert's (the dispatch runs each
    # expert on its capacity slots), and the whole cache
    read_bytes = weight_bytes - embed_bytes + kv_bytes
    step_ms = 1e3 * t_dec.seconds / DECODE_STEPS
    emit({"phase": "lm_family_decode", "arch": arch, "batch": B,
          "cache_len": L, "layers": cfg.n_layers, "note": cell.note,
          "kv_bytes": kv_bytes, "ms_per_step": step_ms,
          "tok_s": B / (step_ms / 1e3), "read_bytes": read_bytes,
          "bound_ms": 1e3 * read_bytes / HBM_BYTES_PER_S,
          "bound_share": 1e3 * read_bytes / HBM_BYTES_PER_S / step_ms,
          "flash_launches": fmod.flash_attention_cuda.launches,
          "peak_bytes": torch.cuda.max_memory_allocated(dev),
          "model_flops": cell.model_flops,
          "sync_debug_error_first_step": is_moe, "logits_finite": True})
    del params, cache, new_cache, logits, lp, cell
    gc.collect()
    torch.cuda.empty_cache()
    if is_moe:
        moe_layer_backward(torch, dev, tf, cfg, arch, last, h_train, w_host)
        del h_train, w_host
        gc.collect()
        torch.cuda.empty_cache()
    if torch.cuda.memory_allocated(dev) > LEAK_BYTES:
        raise AssertionError(f"{arch}: {torch.cuda.memory_allocated(dev)} "
                             f"bytes still allocated after the arch")

    return {"prefill": prefill_launches}


def moe_layer_backward(torch, dev, tf, cfg, arch, layer, h, w_host) -> None:
    """Phase 6c's backward: the MoE layer's gradients in ``h`` and its
    weights, ``_moe_ffn``'s against ``moe_check.moe_ffn_dense``'s under
    ``moe_check.moe_grad_excess``'s rule, at the training shape (``h``
    ``[1, B S, d]`` bf16, one dispatch group), with the dense check at one
    slot fewer read above it; two backwards of the dispatch bit-equal, and
    both backwards timed."""
    from repro_torch.models import moe_check

    lp = {name: t.to(dev) for name, t in w_host.items()}
    names = [n for n in ("router", "w_gate", "w_up", "w_down", "ws_gate",
                         "ws_up", "ws_down") if n in lp]
    T, E = h.shape[1], cfg.n_experts
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cot = torch.randn(h.shape, generator=gen, device=dev).to(
        torch.bfloat16).float()

    def graph(fn, **kw):
        # the dense check takes h in float32 (moe_check.moe_grad_excess)
        hh = (h if fn is tf._moe_ffn else h.float()).detach().requires_grad_()
        w = {n: t.detach().requires_grad_() if n in names else t
             for n, t in lp.items()}
        out = fn(hh, w, cfg, **kw)
        return [hh] + [w[n] for n in names], (
            out[0] if isinstance(out, tuple) else out)

    def grads(fn, **kw):
        leaves, out = graph(fn, **kw)
        return dict(zip(["h"] + names, torch.autograd.grad(out, leaves,
                                                           cot)))

    grads(tf._moe_ffn)                  # a warm-up
    got = grads(tf._moe_ffn)
    again = grads(tf._moe_ffn)
    bit_equal = all(torch.equal(got[n], again[n]) for n in got)
    del again
    want = grads(moe_check.moe_ffn_dense)
    excess = moe_check.moe_grad_excess(got, want)
    del got
    with torch.no_grad():
        experts = tf.moe_route(h, lp["router"], cfg)[2]
        cap = tf.moe_capacity(T, cfg)
        keep = tf.moe_dispatch(experts, torch.ones(experts.shape,
                                                   device=dev), cap, E)[3]
        dropped = int((~keep).sum())
        fault_cap = moe_check.fault_capacity(experts, cap, E)
    fault = moe_check.moe_grad_excess(
        grads(moe_check.moe_ffn_dense, capacity=fault_cap), want)
    del want
    ms = {}
    for label, fn, iters in (("dispatch", tf._moe_ffn, 5),
                             ("dense", moe_check.moe_ffn_dense, 3)):
        leaves, out = graph(fn)
        ms[label] = time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, cot, retain_graph=True), iters)
        del leaves, out
    row = {"phase": "lm_family_moe_layer", "direction": "backward",
           "arch": arch, "layer": layer, "tokens": T,
           "shape": f"training: B {LM_TRAIN_BATCH} x S {FLASH_BWD_SEQ} "
                    f"tokens in one dispatch group, bf16",
           "capacity": cap, "dropped_pairs": dropped,
           "dropped_share": dropped / (T * cfg.top_k),
           "rule": "per leaf <= 2^-6 relative L2: h by token row, each "
                   "expert's slice of w_gate/w_up/w_down, the router and "
                   "shared experts whole (models/moe_check.py)",
           "excess": excess, "worst": max(excess.values()),
           "planted_fault": "dense check at one slot fewer",
           "planted_fault_capacity": fault_cap,
           "planted_fault_excess": fault,
           "planted_fault_worst": max(fault.values()),
           "two_backwards_bit_equal": bit_equal,
           "backward_ms": ms["dispatch"], "dense_backward_ms": ms["dense"]}
    emit(row)
    if not (row["worst"] <= 1.0 and row["planted_fault_worst"] > 1.0
            and bit_equal):
        raise AssertionError(f"{arch}: MoE layer {layer}'s backward against "
                             f"its dense check: {row}")


XDEEPFM_PARAMS = 432_747_202     # parameter elements at full width
XDEEPFM_PARAM_COUNT = 393_747_201  # RecsysConfig.param_count(): the
#                                    reference's count, without the linear
#                                    table and the last layer's bias


def cin_bound_ms(B, m, H, H2, D) -> tuple:
    """Least time for one CIN layer on these shapes, two ways: the kernel's
    arithmetic, 3xTF32, three tensor-core passes of 2 H2 H m D flops per
    batch row over the TF32 peak; and float32 FMA outside the tensor cores
    (the arithmetic of the kernel it replaced), the flops once over the
    float32 peak. Each the larger of its operations and the bytes (x0, xk
    and W read once, out written once) over HBM. Returns (3xTF32 bound ms,
    what bounds it, the layer's flops, FMA bound ms)."""
    flops = 2 * B * H2 * H * m * D
    nbytes = 4 * (B * m * D + B * H * D + H2 * H * m + B * H2 * D)
    t_ops, t_bytes = 3 * flops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    t_fma = flops / F32_FLOPS_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops,
            1e3 * max(t_fma, t_bytes))


def recsys_phases(torch, dev) -> dict:
    """Phases 7-10; returns the CIN row of the kernel table."""
    from repro_torch.common import Timer
    from repro_torch.config import RECSYS_SHAPES, get_arch
    from repro_torch.data.pipeline import DataCursor, RecsysPipeline
    from repro_torch.kernels.cin import kernel as cmod
    from repro_torch.kernels.cin.cases import (CASES, FAULT_CASE,
                                               PLAIN_CHUNK, case_inputs,
                                               emulated_layer, excess,
                                               layer_excess, planted_fault,
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
    # the kernel's arithmetic, emulated in plain PyTorch on the same cases:
    # 3xTF32 (what the kernel does) and one TF32 pass (what it does not)
    emul = {}
    for name, case in CASES.items():
        x0, xk, w = (torch.from_numpy(a).to(dev) for a in case_inputs(case))
        ref = cin_layer_ref(x0, xk, w)
        emul[name] = [layer_excess(emulated_layer(x0, xk, w, passes=n), ref,
                                   x0, xk, w) for n in (3, 1)]
    emit({"phase": "cin_tf32_emulation", "rule": "|o - r| <= 2^-16 A",
          "excess_3xtf32": {n: e[0] for n, e in emul.items()},
          "excess_1xtf32": {n: e[1] for n, e in emul.items()},
          "worst_3xtf32": max(e[0] for e in emul.values()),
          "worst_1xtf32": max(e[1] for e in emul.values())})
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
    # registers and spills of the main kernel at H2 = 200 (NI = 200)
    cin_ptxas = ptxas_entry(cmod.NAME, cmod.SOURCES, (),
                            "cin_layer_wgmmaILi200E")
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
            bound, by, flops, fma_bound = cin_bound_ms(B, m, H, H2, D)
            row = {"phase": "cin_timed", "layer": layer,
                   "shape": [B, m, H, H2, D], "excess": ex,
                   "ms": time_ms(torch, lambda: cmod.cin_layer_cuda(
                       x0, xk, w), 20 if B <= PLAIN_CHUNK else 3, warmup=1),
                   "bound_ms": bound, "bound_by": by,
                   "fma_bound_ms": fma_bound, "gflop": flops / 1e9,
                   "plain_ms": None, "library_ms": None,
                   "ptxas": cin_ptxas}
            if B <= PLAIN_CHUNK:   # where Z fits
                row["plain_ms"] = time_ms(
                    torch, lambda: cin_layer_ref(x0, xk, w), 5, warmup=1)
                row["library_ms"] = time_ms(
                    torch, lambda: torch.einsum("bhd,bmd,nhm->bnd", xk, x0,
                                                w), 5, warmup=1)
            row["tflop_s"] = flops / row["ms"] / 1e9
            row["tensor_tflop_s"] = 3 * row["tflop_s"]   # three TF32 passes
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
            "bound_arithmetic": "3xTF32 on the tensor cores (495 TFLOP/s)",
            "fma_bound_ms": p99_l2["fma_bound_ms"],
            "library_ms": p99_l2["library_ms"],
            "tflop_s": p99_l2["tflop_s"], "ptxas": cin_ptxas,
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
            "serve_bulk_fma_bound_ms": bulk_l2["fma_bound_ms"],
            "serve_bulk_tflop_s": bulk_l2["tflop_s"],
            "serve_bulk_layer1_ms": bulk_l1["ms"],
            "serve_bulk_layer1_bound_ms": bulk_l1["bound_ms"],
            "launches_by_path": launches_by_path}



RECSYS_TRAIN_CHUNK = 4096        # batch rows per plain gradient chunk


def cin_grad_bound_ms(B, m, H, H2, D, which: str) -> tuple:
    """Least time for one gradient launch of a CIN layer (x0 [B, m, D], xk
    [B, H, D], W [H2, H, m], dy [B, H2, D]): ``"dw"`` or ``"dx"`` (dxk and
    dx0 in one launch, reassociated: one layer's flops for the pair) does
    the layer's 2 B H2 H m D flops, three TF32 passes on the tensor cores
    at 495 TFLOP/s (the least time for float32-accurate work; the
    float32-FMA bound beside it), and reads its operands and writes its
    outputs once. Returns (bound ms, what bounds it, flops, FMA bound
    ms)."""
    flops = 2 * B * H2 * H * m * D
    moved = B * m * D + B * H * D + B * H2 * D + {
        "dx": H2 * H * m + B * m * D + B * H * D,   # W in; dx0, dxk out
        "dw": H2 * H * m}[which]                    # dW out
    t_bytes = 4 * moved / HBM_BYTES_PER_S
    t_fma = flops / F32_FLOPS_PER_S
    t_ops = 3 * flops / TF32_FLOPS_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops,
            1e3 * max(t_fma, t_bytes))


def cin_backward_phase(torch, dev) -> dict:
    """Phase 10b: each gradient kernel at the training batch's layers (B
    65,536; layer 1, H 39, and an H-200 layer) against its plain version
    under its rule (``kernels/cin/cases.py``: the layer rule for dxk and
    dx0, both from one ``cin_dx_cuda``; dW's rule against float64), each
    planted fault above it, then timed (CUDA events) beside its bounds and
    the route it replaces (dx: ``cin_layer_cuda`` on the permuted operands
    of dxk and of dx0, a launch each), and at B 16,384 beside that route,
    the plain version and ``torch.einsum`` (float32, TF32 off; dx: the two
    einsums of dxk and dx0). Returns the rows by (layer, "dx" or "dw")."""
    from repro_torch.kernels.cin import cases as cc
    from repro_torch.kernels.cin import kernel as cmod
    from repro_torch.kernels.cin.ref import (cin_dw_ref, cin_dx0_ref,
                                             cin_dxk_ref, cin_layer_ref)

    fn = {"dx": lambda x0, xk, w, dy: cmod.cin_dx_cuda(x0, xk, dy, w),
          "dw": lambda x0, xk, w, dy: cmod.cin_dw_cuda(x0, xk, dy)}
    plain = {"dx": lambda x0, xk, w, dy: (cin_dx0_ref(xk, dy, w),
                                          cin_dxk_ref(x0, dy, w)),
             "dw": lambda x0, xk, w, dy: cin_dw_ref(x0, xk, dy)}
    # one call per gradient, ordered so that no pairwise product is wider
    # than Z
    library = {
        "dx": lambda x0, xk, w, dy: (
            torch.einsum("bnd,bhd,nhm->bmd", dy, xk, w),
            torch.einsum("bnd,bmd,nhm->bhd", dy, x0, w)),
        "dw": lambda x0, xk, w, dy: torch.einsum("bhd,bmd,bnd->nhm", xk,
                                                 x0, dy)}

    def old_route(x0, xk, w, dy, wk, w0):
        """dxk and dx0 by the route the dx kernel replaced: the layer
        kernel on the permuted operands (W permuted once, outside the
        timing)."""
        return (cmod.cin_layer_cuda(xk, dy, w0),
                cmod.cin_layer_cuda(x0, dy, wk))

    # registers and spills of the xdeepfm instances (N tile 200, 40 fields)
    ptxas = {"dx": ptxas_entry(cmod.NAME, cmod.SOURCES, (),
                               "cin_dx_wgmmaILi200ELi40E"),
             "dw": ptxas_entry(cmod.NAME, cmod.SOURCES, (),
                               "cin_dw_wgmmaILi200E")}
    rows = {}
    for name, case in cc.TRAIN_CASES.items():
        layer = "layer1" if case[2] == case[1] else "layer2"
        B, m, H, H2, D = case
        x0, xk, w, dy = (torch.from_numpy(a).to(dev)
                         for a in cc.grad_case_inputs(case))
        ops = cc.input_grad_operands(x0, xk, w, dy)
        wk, w0 = ops["dxk"][2], ops["dx0"][2]
        r, S = cc.dw_exact(x0, xk, dy, chunk=RECSYS_TRAIN_CHUNK)
        for what in ("dx", "dw"):
            out = fn[what](x0, xk, w, dy)
            torch.cuda.synchronize()
            row = {"phase": "cin_backward", "gradient": what,
                   "layer": layer, "shape": list(case),
                   "ptxas": ptxas[what]}
            if what == "dw":
                ex = cc.dw_excess(out, r, S, B * D)
                k0 = (B * D) // 2 + 5
                fault = cc.dw_excess(cc.dw_planted_fault(
                    x0, xk, dy, k0, chunk=RECSYS_TRAIN_CHUNK), r, S, B * D)
                err = float((out.double() - r).abs().max())
                row["rule"] = "|o - r| <= 16 u sqrt(K) (S + |r|), r float64"
                row["planted_fault"] = (f"the {cc.DW_FAULT_K} values of k "
                                        f"from {k0}")
                finite = bool(torch.isfinite(out).all())
            else:
                got = dict(zip(("dx0", "dxk"), out))
                ex, fault, err = {}, {}, 0.0
                s = slice(0, cc.PLAIN_CHUNK)
                for g, (a, b, wp) in ops.items():
                    ref = torch.cat([cin_layer_ref(a[i:i + cc.PLAIN_CHUNK],
                                                   b[i:i + cc.PLAIN_CHUNK],
                                                   wp)
                                     for i in range(0, B, cc.PLAIN_CHUNK)])
                    ex[g] = cc.layer_excess(got[g], ref, a, b, wp)
                    fault[g] = cc.layer_excess(cc.planted_fault(
                        a[s], b[s], wp, h=1), ref[s], a[s], b[s], wp)
                    err = max(err, float((got[g] - ref).abs().max()))
                    del ref
                row.update({f"{g}_excess": ex[g] for g in ex})
                row.update({f"{g}_planted_fault_excess": fault[g]
                            for g in fault})
                ex, fault = max(ex.values()), min(fault.values())
                row["rule"] = "|o - r| <= 2^-16 A (the layer rule), each"
                row["planted_fault"] = "slice 1 of each permuted W"
                finite = all(bool(torch.isfinite(t).all()) for t in out)
            if not (ex <= 1.0 and fault > 1.0 and finite):
                raise AssertionError(f"cin {what} {name}: {ex} times its "
                                     f"rule, planted fault {fault}")
            bound, by, flops, fma_bound = cin_grad_bound_ms(B, m, H, H2, D,
                                                            what)
            ms = time_ms(torch, lambda: fn[what](x0, xk, w, dy), 3,
                         warmup=1)
            row.update({"excess": ex, "max_abs_err": err,
                        "planted_fault_excess": fault, "ms": ms,
                        "bound_ms": bound, "bound_by": by,
                        "fma_bound_ms": fma_bound, "gflop": flops / 1e9,
                        "tflop_s": flops / ms / 1e9,
                        "bound_share": bound / ms})
            del out
            torch.cuda.empty_cache()
            if what == "dx":
                row["old_route_ms"] = time_ms(
                    torch, lambda: old_route(x0, xk, w, dy, wk, w0), 3,
                    warmup=1)
            # plain and library at B 16,384, where their intermediates fit
            c = (x0[:cc.PLAIN_CHUNK], xk[:cc.PLAIN_CHUNK], w,
                 dy[:cc.PLAIN_CHUNK])
            row["b16384_ms"] = time_ms(torch, lambda: fn[what](*c), 5,
                                       warmup=1)
            row["b16384_bound_ms"] = cin_grad_bound_ms(
                cc.PLAIN_CHUNK, m, H, H2, D, what)[0]
            if what == "dx":
                row["b16384_old_route_ms"] = time_ms(
                    torch, lambda: old_route(*c, wk, w0), 5, warmup=1)
            row["b16384_plain_ms"] = time_ms(torch, lambda: plain[what](*c),
                                             3, warmup=1)
            torch.cuda.empty_cache()
            row["b16384_library_ms"] = time_ms(
                torch, lambda: library[what](*c), 3, warmup=1)
            torch.cuda.empty_cache()
            rows[(layer, what)] = row
            emit(row)
        del x0, xk, w, dy, ops, wk, w0, r, S
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def recsys_plain_grads(torch, params, batch, cfg, order, dtype):
    """The gradient of ``bce_loss`` on the plain path (``cin_impl="ref"``)
    in ``dtype``, summed over the batch in chunks of
    ``RECSYS_TRAIN_CHUNK`` rows taken in ``order`` (a permutation of the
    rows: another float32 sum order): each chunk's mean loss weighted by
    its share of the batch, its gradients added up. Returns (loss,
    gradient tree)."""
    from repro_torch.models import recsys
    from repro_torch.optim import adamw

    B = batch["labels"].shape[0]
    p = adamw.tree_map(lambda t: t.detach().to(dtype).requires_grad_(),
                       params)
    total = 0.0
    for i in range(0, B, RECSYS_TRAIN_CHUNK):
        rows = order[i:i + RECSYS_TRAIN_CHUNK]
        chunk = {k: (v[rows].to(dtype) if v.is_floating_point()
                     else v[rows]) for k, v in batch.items()}
        loss = recsys.bce_loss(p, chunk, cfg, cin_impl="ref") \
            * (rows.numel() / B)
        loss.backward()
        total += float(loss)
    return total, adamw.tree_map(lambda t: t.grad, p)


def recsys_train_phase(torch, dev) -> dict:
    """Phase 10c: xdeepfm's ``train_batch`` at full width and uncut (B
    65,536, 39 fields, vocab 1,000,000, CIN 200-200-200, DNN 400-400,
    seed 0), one resident batch, through ``build_cell``:
      * the first step's gradients of every leaf on the kernel path
        against the float64 plain path (in batch chunks) under
        ``gnn_check.grad_excess`` (the spread from three plain float32
        runs over the rows in shuffled orders; each leaf floored at its
        own largest: the CIN filters' gradients are some 1e-9 of the
        DNN's, and the tree's floor would hide them), and a dW kernel that
        leaves out one tile of 128 values of k at layer 2 read beside it
        (above 1);
      * step 1 under ``torch.cuda.set_sync_debug_mode("error")``;
      * steps 2 to ``TRAIN_STEPS`` on the host clock, each ending in a
        synchronize: the median seconds, rows/s, peak bytes; the
        forward's and the two gradient kernels' launches (dx: dxk and dx0
        in one; dW) over the steps, each exactly 3 a step; the losses,
        read once at the
        end, falling."""
    from repro_torch.common import Timer
    from repro_torch.config import RECSYS_SHAPES
    from repro_torch.data.pipeline import DataCursor, RecsysPipeline
    from repro_torch.kernels.cin import cases as cc
    from repro_torch.kernels.cin import kernel as cmod
    from repro_torch.kernels.cin import ops as cops
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import gnn_check, recsys
    from repro_torch.optim import adamw

    torch.cuda.reset_peak_memory_stats(dev)
    cell = build_cell("xdeepfm", "train_batch", device=dev)
    cfg = cell.cfg
    shape = {s.name: s for s in RECSYS_SHAPES}["train_batch"]
    B = shape.batch
    with Timer() as t_init:
        params, opt = cell.init(0)
        batch = cell.inputs(RecsysPipeline(cfg, shape, seed=0).batch(
            DataCursor()))
        torch.cuda.synchronize()
    n_params = sum(t.numel() for t in adamw.tree_leaves(params))
    if n_params != XDEEPFM_PARAMS or tuple(batch["ids"].shape) != (
            B, cfg.n_sparse, max(cfg.multi_hot, 1)):
        raise AssertionError(f"recsys_train: {n_params} parameters, ids "
                             f"{tuple(batch['ids'].shape)}")
    counts = {"forward": cmod.cin_layer_cuda, "dx": cmod.cin_dx_cuda,
              "dw": cmod.cin_dw_cuda}
    n_cin = len(cfg.cin_layers)
    row = {"phase": "recsys_train", "arch": cfg.name, "shape": shape.name,
           "batch": B, "params": n_params, "init_seconds": t_init.seconds}

    def kernel_grads():
        p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = recsys.bce_loss(p, batch, cfg)
        loss.backward()
        return float(loss), adamw.tree_map(lambda t: t.grad, p)

    with Timer() as t_check:
        with gnn_check.fixed_order():
            loss_k, g_k = kernel_grads()
            real_dw = cmod.cin_dw_cuda

            def dropped_tile(x0, xk, dy):
                """dW as a kernel that skips one tile of 128 values of k
                at an H-200 layer would give it."""
                if xk.shape[1] == cfg.cin_layers[0] and dy.shape[0] == B:
                    k = torch.arange(B * dy.shape[2], device=dy.device)
                    k0 = (B * dy.shape[2]) // 3
                    keep = ((k < k0) | (k >= k0 + cc.DW_FAULT_K)).to(
                        dy.dtype).view(B, 1, -1)
                    dy = dy * keep
                return real_dw(x0, xk, dy)

            cops.cin_dw_cuda = dropped_tile   # the name the backward calls
            try:
                _, g_f = kernel_grads()
            finally:
                cops.cin_dw_cuda = real_dw
            torch.cuda.empty_cache()
            loss_x, g_x = recsys_plain_grads(
                torch, params, batch, cfg,
                torch.arange(B, device=dev), torch.float64)
            gen = torch.Generator(device=dev).manual_seed(0)
            plains = [recsys_plain_grads(
                torch, params, batch, cfg,
                torch.arange(B, device=dev) if i == 0 else torch.randperm(
                    B, generator=gen, device=dev), torch.float32)[1]
                for i in range(gnn_check.GRAD_PLAIN_RUNS)]
        row["loss_kernel"], row["loss_plain64"] = loss_k, loss_x
        row["rule"] = ("float64 element-wise against the largest error of 3 "
                       "plain float32 runs over the rows in shuffled orders, "
                       "floored at 2^-12 of each leaf's own largest "
                       "(gnn_check.grad_excess, per_leaf)")
        row["excess"] = gnn_check.grad_excess(g_k, g_x, plains,
                                              per_leaf=True)
        row["planted_fault"] = ("one tile of 128 values of k left out of "
                                "the dW of each H-200 layer")
        row["planted_fault_excess"] = gnn_check.grad_excess(
            g_f, g_x, plains, per_leaf=True)
        row["cin_grads_nonzero"] = all(bool(g.abs().max() > 0)
                                       for g in g_k["cin"])
        del g_k, g_f, g_x, plains
    row["check_seconds"] = t_check.seconds
    gc.collect()
    torch.cuda.empty_cache()
    if not (row["excess"] <= 1.0 and row["planted_fault_excess"] > 1.0
            and row["cin_grads_nonzero"]
            and abs(loss_k - loss_x) <= 1e-4 * abs(loss_x)):
        raise AssertionError(f"recsys_train gradients: {row}")

    # -- the main path: TRAIN_STEPS steps, every count set to 0 before ----
    losses = []
    torch.cuda.synchronize()
    for c in counts.values():
        c.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, opt, loss, stats = cell.step_fn(params, opt, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for _ in range(TRAIN_STEPS - 1):
        with Timer() as t:
            params, opt, loss, stats = cell.step_fn(params, opt, batch)
            torch.cuda.synchronize()
        secs.append(t.seconds)
        losses.append(loss)
    launches = {k: c.launches for k, c in counts.items()}
    losses = torch.stack(losses).tolist()
    row.update({"steps": TRAIN_STEPS, "steps_timed": len(secs),
                "seconds_median": float(np.median(secs)),
                "seconds_min": min(secs), "seconds_max": max(secs),
                "rows_s": B / float(np.median(secs)),
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
                "launches": launches,
                "launches_per_step": {k: v / TRAIN_STEPS
                                      for k, v in launches.items()},
                "sync_debug_step": "error", "losses": losses,
                "grad_norm_last": float(stats["grad_norm"]),
                "lr_last": float(stats["lr"])})
    emit(row)
    if any(v != n_cin * TRAIN_STEPS for v in launches.values()):
        raise AssertionError(f"recsys_train: launches {launches} in "
                             f"{TRAIN_STEPS} steps, not {n_cin} each a step")
    if not (all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"recsys_train: losses {losses}")
    del params, opt, batch, cell
    gc.collect()
    torch.cuda.empty_cache()
    return launches

L2_SHARES = (40 * 2**20, 50 * 2**20)   # L2 bytes an estimate lets x keep


def segmm_sectors(torch, x, col) -> tuple:
    """32-byte sectors each row of ``x`` spans, from its address (x's base
    alignment, row stride and width), and how often the gathers read it
    (``bincount(col)``): the sector count of every gather is
    ``(sectors * counts).sum()``."""
    start = (x.data_ptr() % 32 + 4 * x.stride(0) * torch.arange(
        x.shape[0], dtype=torch.int64, device=x.device))
    sectors = (start + 4 * x.shape[1] - 1) // 32 - start // 32 + 1
    return sectors, torch.bincount(col.long(), minlength=x.shape[0])


def segmm_sector_bound_ms(torch, x, col, n_rows: int) -> tuple:
    """The gathered bound counted in 32-byte sectors: the fixed bytes of
    ``segmm_bytes`` (row_ptr, col, coeff, y) plus every gather's sectors,
    over HBM; and a static estimate, not a bound, for each L2 share of
    ``L2_SHARES``: the rows read most (by ``bincount(col)``) that fit the
    share are read from HBM once, every other gather pays its sectors."""
    n_edges, d = col.numel(), x.shape[1]
    fixed = 8 * (n_rows + 1) + 8 * n_edges + 4 * d * n_rows
    sectors, counts = segmm_sectors(torch, x, col)
    row_bytes = 32 * sectors
    gathered = fixed + int((row_bytes * counts).sum())
    order = torch.argsort(counts, descending=True)
    rb, cnt = row_bytes[order], counts[order]
    fits = torch.cumsum(rb, 0)
    est = {}
    for share in L2_SHARES:
        keep = fits <= share
        b = (fixed + int(rb[keep & (cnt > 0)].sum())
             + int((rb * cnt)[~keep].sum()))
        est[f"{share // 2**20}MiB"] = 1e3 * b / HBM_BYTES_PER_S
    return 1e3 * gathered / HBM_BYTES_PER_S, gathered, est


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


def segmm_launch(torch, smod, x, layout, coeff, vec: int,
                 fixup: bool = True) -> int:
    """One call of the C entry ``segment_mm_launch`` past the wrapper (no
    checks, no launch count): the CUDA error it returns. ``vec`` as given;
    ``fixup=False`` passes no crossing rows, so only the piece kernel runs
    (the crossing rows of y are left unwritten)."""
    n, d = layout.n_nodes, x.shape[1]
    y = torch.empty(n, d, device=x.device)
    n_pieces = -(-(n + layout.col.numel()) // layout.tile)
    carry = torch.empty(2 * n_pieces * (-(-d // 4) * 4), device=x.device)
    cross = layout.crossing_rows
    return smod.load_library().segment_mm_launch(
        layout.row_ptr.data_ptr(), layout.col.data_ptr(), coeff.data_ptr(),
        x.data_ptr(), cross.data_ptr(), y.data_ptr(), carry.data_ptr(), n,
        layout.col.numel(), x.stride(0), cross.numel() if fixup else 0,
        layout.tile, d, vec, torch.cuda.current_stream().cuda_stream)


def segmm_split(torch, smod, x, layout, coeff, iters: int) -> dict:
    """Where one launch's time goes at a layer's inputs: CUDA events over
    ``iters`` back-to-back calls of the wrapper (checks, piece kernel and
    fix-up), of the C entry with the fix-up and of the C entry with the
    piece kernel alone, and the host's time to issue each call (no sync
    inside the loop): where a call's events equal its issue time, the
    host, not the card, sets the pace."""
    from repro_torch.common import Timer
    from repro_torch.kernels.segment_mm.ops import segment_mm_csr
    vec = int(smod._reads_whole_chunks(x))

    def entry(fixup):
        if segmm_launch(torch, smod, x, layout, coeff, vec, fixup=fixup):
            raise RuntimeError("segment_mm_launch failed")

    out = {"d": x.shape[1], "crossing_rows": int(layout.crossing_rows.numel())}
    for name, fn in (("wrapper", lambda: segment_mm_csr(x, layout, coeff)),
                     ("entry", lambda: entry(True)),
                     ("pieces", lambda: entry(False))):
        out[f"{name}_ms"] = time_ms(torch, fn, iters)
        torch.cuda.synchronize()
        with Timer() as t:
            for _ in range(iters):
                fn()
        out[f"{name}_issue_ms"] = 1e3 * t.seconds / iters
        torch.cuda.synchronize()
    out["fixup_ms"] = out["entry_ms"] - out["pieces_ms"]
    out["checks_ms"] = out["wrapper_ms"] - out["entry_ms"]
    return out


def gnn_phases(torch, dev) -> tuple:
    """Phases 11-13; returns the segment_mm row of the kernel table and
    the ``ogb_products`` host batch (seed 0)."""
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
    from repro_torch.kernels.segment_mm.ops import (TILE, CsrLayout,
                                                    csr_layout,
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
        for tile in (TILE, 32):
            layout = csr_layout(src, dst, n, tile=tile)
            cs = coeff[layout.perm]
            out = segment_mm_csr(x, layout, cs)
            again = segment_mm_csr(x, layout, cs)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"segment_mm {name}: two launches "
                                     f"differ")
            err, ex = held(out, x, layout.col, layout.row, cs, n,
                           f"{name} tile {tile}")
            max_err, excess_worst = max(max_err, err), max(excess_worst, ex)
            deg = layout.in_degree()
            emit({"phase": "segmm_vs_plain", "case": name, "tile": tile,
                  "shape": [n, int(src.numel()), int(x.shape[1])],
                  "longest_row": int(deg.max()) if n else 0,
                  "crossing_rows": int(layout.crossing_rows.numel()),
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
    fields = {f.name: getattr(layout, f.name)
              for f in dataclasses.fields(layout)}
    bad = {"float64": lambda: smod.segment_mm_cuda(x.double(), layout, cs),
           "int32 row_ptr": lambda: smod.segment_mm_cuda(
               x, dataclasses.replace(layout, row_ptr=layout.row_ptr.int()),
               cs),
           "D 257": lambda: smod.segment_mm_cuda(
               torch.zeros(n, 257, device=dev), layout, cs),
           "column-strided x": lambda: smod.segment_mm_cuda(
               x.t().contiguous().t(), layout, cs),
           "layout tile past TILE": lambda: dataclasses.replace(
               layout, tile=TILE + 1),
           "tile past TILE": lambda: smod.segment_mm_cuda(
               x, types.SimpleNamespace(**{**fields, "tile": TILE + 1}), cs),
           "coeff on the CPU": lambda: smod.segment_mm_cuda(x, layout,
                                                            cs.cpu()),
           "short coeff": lambda: smod.segment_mm_cuda(x, layout, cs[:-1])}
    before = smod.segment_mm_cuda.launches
    for what, call in bad.items():
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"segment_mm_cuda took bad inputs: {what}")
    if smod.segment_mm_cuda.launches != before:
        raise AssertionError("segment_mm_cuda launched on bad inputs")
    # a base that is not 16-byte aligned is read a float at a time; the C
    # entry refuses 16-byte reads from it
    buf = torch.full((x.numel() + 1,), float("nan"), device=dev)
    skew = buf[1:].view(x.shape)
    skew.copy_(x)
    skew_out = segment_mm_csr(skew, layout, cs)
    if not torch.equal(skew_out, segment_mm_csr(skew, layout, cs)):
        raise AssertionError("segment_mm: two launches on a misaligned x "
                             "differ")
    _, skew_ex = held(skew_out, x, layout.col, layout.row, cs, n,
                      "misaligned x")
    if segmm_launch(torch, smod, skew, layout, cs, vec=1) == 0:
        raise AssertionError("segment_mm_launch took 16-byte reads from a "
                             "misaligned x")
    emit({"phase": "segmm_bad_inputs", "raised": list(bad),
          "misaligned_x_excess": skew_ex, "misaligned_vec_refused": True})
    del x, src, dst, coeff, exact, layout, cs, out, again, buf, skew
    del skew_out

    # -- the ogb_products graph, resident on the card -------------------------
    cfg = get_arch("gcn-cora")
    shapes = {s.name: s for s in GNN_SHAPES}

    host_batches = {}

    def resident(shape_name):
        """The shape's batch from the copied batch functions (seed 0), on
        the card, with its layout built there once; host and layout
        seconds. The host batch of ``ogb_products`` is kept for phase 15."""
        shape = shapes[shape_name]
        with Timer() as t_host:
            if shape.kind == "batched_graphs":
                batch = gnn_molecule_batch(cfg, shape, seed=0,
                                           d_feat=shape.d_feat)
            else:
                batch = gnn_full_graph_batch(cfg, shape, seed=0,
                                             n_classes=cfg.d_out)
        graph = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if shape_name == "ogb_products":
            host_batches[shape_name] = batch
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
          "tile": layout.tile, "pieces": -(-(n + e) // layout.tile),
          "crossing_rows": int(layout.crossing_rows.numel()),
          "edges_in_crossing_rows": int(
              deg[layout.crossing_rows.long()].sum()),
          "empty_rows": int((deg == 0).sum()), **ogb_setup})

    # -- phase 12: segment_mm timed at ogb_products, D = 16 and 7 ------------
    _, coeff, _ = gnn.gcn_norm(layout, cfg.norm)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hub = int(torch.argmax(deg))
    lo, hi = int(layout.row_ptr[hub]), int(layout.row_ptr[hub + 1])
    hub_ptr = torch.tensor([0, hi - lo], dtype=torch.int64, device=dev)
    hub_l = CsrLayout(1, hub_ptr, layout.col[lo:hi].contiguous(),
                      torch.zeros(hi - lo, dtype=torch.int32, device=dev),
                      torch.arange(hi - lo, device=dev))
    hub_coeff = coeff[lo:hi].contiguous()
    layout_1024 = dataclasses.replace(layout, tile=1024)
    col64 = layout.col.to(torch.int64)
    timed = {}

    def sector_fields(x, prefix=""):
        ms, nbytes, est = segmm_sector_bound_ms(torch, x, layout.col, n)
        return {f"{prefix}sector_bound_ms": ms,
                f"{prefix}bytes_sectors": nbytes,
                f"{prefix}l2_estimate_ms": est}

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
        compulsory, gathered = segmm_bound_ms(n, n, e, d)
        bytes_c, bytes_g = segmm_bytes(n, n, e, d)
        row = {"phase": "segmm_timed", "shape": "ogb_products", "d": d,
               "nodes": n, "edges": e, "tile": layout.tile,
               "max_abs_err": err, "excess": ex,
               "ms": time_ms(torch, lambda: segment_mm_csr(x, layout, coeff),
                             20),
               "tile_1024_ms": time_ms(torch, lambda: segment_mm_csr(
                   x, layout_1024, coeff), 20),
               "plain_ms": time_ms(torch, lambda: segment_mm_csr(
                   x, layout, coeff, impl="ref"), 5),
               "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr, x),
                                     5),
               "library_excess": lib_ex,
               "bound_ms": compulsory, "bound_by": "bytes",
               "gathered_bound_ms": gathered,
               "bytes_compulsory": bytes_c, "bytes_gathered": bytes_g,
               **sector_fields(x),
               "l2_estimate_note": "static estimate, not a bound: the "
                                   "rows read most that fit the L2 share "
                                   "read once, every other gather its "
                                   "sectors"}
        if d % 8:
            # the same rows padded to a multiple of 32 bytes, as a view
            wide = torch.zeros(n, -(-d // 8) * 8, device=dev)
            wide[:, :d] = x
            xs = wide[:, :d]
            strided = segment_mm_csr(xs, layout, coeff)
            s_err, s_ex = held(strided, x, layout.col, layout.row, coeff, n,
                               f"ogb_products D={d} in {wide.shape[1]}",
                               exact)
            if not torch.equal(strided, segment_mm_csr(xs, layout, coeff)):
                raise AssertionError("segment_mm: two strided launches "
                                     "differ")
            row.update({"strided_row_floats": wide.shape[1],
                        "strided_ms": time_ms(torch, lambda: segment_mm_csr(
                            xs, layout, coeff), 20),
                        "strided_excess": s_ex,
                        **sector_fields(xs, "strided_")})
            del wide, xs, strided
        del exact
        # the hub row alone (a one-row graph over the same x): the rule
        # against float64, two launches bit-equal
        alone = segment_mm_csr(x, hub_l, hub_coeff)
        if not torch.equal(alone, segment_mm_csr(x, hub_l, hub_coeff)):
            raise AssertionError("segment_mm: two launches on the hub alone "
                                 "differ")
        _, hub_ex = held(alone, x, hub_l.col, hub_l.row, hub_coeff, 1,
                         "hub alone")
        row.update({
            "hub_edges": hi - lo, "hub_excess": hub_ex,
            "hub_ms": time_ms(torch, lambda: segment_mm_csr(
                x, hub_l, hub_coeff), 20)})
        row["gbytes_s_compulsory"] = bytes_c / row["ms"] / 1e6
        row["bound_share"] = compulsory / row["ms"]
        timed[d] = row
        emit(row)
        del x, out, csr, alone
        torch.cuda.empty_cache()
    # gcn-cora's layer 2 as a whole (x @ W, then the aggregation), with h
    # [N, 7] contiguous and as the [:, :7] view of an [N, 8] h from W with a
    # zero eighth column
    h1 = torch.relu(torch.randn(n, cfg.d_hidden, generator=gen, device=dev))
    w = torch.randn(cfg.d_hidden, cfg.d_out, generator=gen, device=dev)
    w8 = torch.nn.functional.pad(w, (0, -cfg.d_out % 8))
    layer2 = {"phase": "segmm_layer2", "shape": "ogb_products",
              "contiguous_ms": time_ms(torch, lambda: segment_mm_csr(
                  h1 @ w, layout, coeff), 20),
              "padded_ms": time_ms(torch, lambda: segment_mm_csr(
                  (h1 @ w8)[:, :cfg.d_out], layout, coeff), 20)}
    emit(layer2)
    del col64, hub_l, hub_coeff, coeff, h1, w, w8, layout_1024
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
            x, layer_ex, split = graph["x"], [], []
            for i, lp in enumerate(params["layers"]):
                h = x @ lp["w"]
                err, ex = held(segment_mm_csr(h, layout, coeff), h,
                               layout.col, layout.row, coeff, n_nodes,
                               f"{shape_name} layer {i}")
                max_err, excess_worst = max(max_err, err), max(excess_worst,
                                                               ex)
                layer_ex.append(ex)
                split.append(segmm_split(torch, smod, h, layout, coeff,
                                         n_calls))
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
              "segmm_split": split,
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
            "tile": t16["tile"], "tile_1024_ms": t16["tile_1024_ms"],
            "hub_ms": t16["hub_ms"], "hub_edges": t16["hub_edges"],
            "d7_ms": t7["ms"], "d7_plain_ms": t7["plain_ms"],
            "d7_bound_ms": t7["bound_ms"],
            "d7_gathered_bound_ms": t7["gathered_bound_ms"],
            "d7_library_ms": t7["library_ms"], "d7_hub_ms": t7["hub_ms"],
            "d7_tile_1024_ms": t7["tile_1024_ms"],
            "d7_in_8_ms": t7["strided_ms"],
            "layer2_contiguous_ms": layer2["contiguous_ms"],
            "layer2_padded_ms": layer2["padded_ms"],
            "launches_by_path": launches_by_path}, host_batches["ogb_products"]


GNN_KIND_ARCHS = ("gatedgcn", "meshgraphnet", "equiformer-v2")
GNN_KIND_TIMED = 10             # timed forwards at molecule and full_graph_sm
OGB_TIMED = 3                   # timed forwards at the ogb_products cut
OGB_FIT_EDGES = (1 << 22, 1 << 23)  # the two cuts the memory fit runs at
OGB_MARGIN = 10 << 30           # bytes kept free beside the fitted peak
OGB_CUT_STEP = 1 << 20          # the cut is a multiple of this many edges


def gnn_kind_batch(cfg, shape, n_edges=None, ogb=None) -> dict:
    """The seed-0 batch of ``shape`` (or the first ``n_edges`` edges of the
    ``ogb`` host batch), with ``e`` drawn with numpy (seed 0) at the
    kind's cell width (``GNN_EDGE_DIM``) for the kinds that take it."""
    from repro_torch.data.pipeline import (gnn_full_graph_batch,
                                           gnn_molecule_batch)
    from repro_torch.models import gnn

    if ogb is not None:
        b = {"x": ogb["x"], "labels": ogb["labels"],
             "src": ogb["src"][:n_edges], "dst": ogb["dst"][:n_edges]}
    elif shape.kind == "batched_graphs":
        b = gnn_molecule_batch(cfg, shape, seed=0, d_feat=shape.d_feat)
    else:
        b = gnn_full_graph_batch(cfg, shape, seed=0, n_classes=cfg.d_out)
    de = gnn.GNN_EDGE_DIM.get(cfg.kind)
    if de:
        b["e"] = np.random.default_rng(0).standard_normal(
            (b["src"].shape[0], de)).astype(np.float32)
    return b


def segmm_at_layouts(torch, dev, cfg, graph, iters: int) -> dict:
    """``segment_mm`` at the shapes a forward of ``cfg`` sums, one entry
    per layout and width (gatedgcn: the edge layout at 2 d_hidden;
    meshgraphnet: at d_hidden; equiformer-v2: at n_heads, and the irrep
    layout at d_hidden), over a standard normal x (seed 0) with
    coefficients 1: CUDA-event ms a launch, the plain version's, one
    ``torch.sparse.mm`` of the same CSR (the yardstick; the port never
    calls it) and the byte bound (every row of x is gathered once, so the
    compulsory and gathered bounds are one)."""
    from repro_torch.kernels.segment_mm.ops import segment_mm_csr

    d = cfg.d_hidden
    shapes = {"gatedgcn": [("edge_layout", 2 * d)],
              "meshgraphnet": [("edge_layout", d)],
              "equiformer_v2": [("edge_layout", cfg.n_heads),
                                ("irrep_layout", d)]}[cfg.kind]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, width in shapes:
        lay = graph[name]
        items = lay.col.numel()
        x = torch.randn(items, width, generator=gen, device=dev)
        ones = torch.ones(items, device=dev)
        csr = torch.sparse_csr_tensor(lay.row_ptr, lay.col.to(torch.int64),
                                      ones, size=(lay.n_nodes, items))
        bound, _ = segmm_bound_ms(lay.n_nodes, items, items, width)
        row = {"rows": lay.n_nodes, "items": items, "d": width,
               "ms": time_ms(torch, lambda: segment_mm_csr(x, lay, ones),
                             iters),
               "plain_ms": time_ms(torch, lambda: segment_mm_csr(
                   x, lay, ones, impl="ref"), max(iters // 4, 1)),
               "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr, x),
                                     max(iters // 4, 1)),
               "bound_ms": bound, "bound_by": "bytes"}
        row["bound_share"] = bound / row["ms"]
        out[f"{name} d{width}"] = row
        del x, ones, csr
    return out


def gnn_kind_cell(torch, dev, cfg, graph, n_timed: int,
                  loss_fn=None) -> tuple:
    """One cell of a GNN kind on the card: a warm-up forward, ``n_timed``
    timed ones (host clock ending in a synchronize) with exactly
    ``segment_mm_launches(cfg)`` launches each, the first and last logits
    bit-equal, the logits under the element-wise spread rule of
    ``models/gnn_check.py`` against the plain path in float64 (and its
    float32 spread), the planted fault (one edge dropped from the summed
    layout) above it, and
    the loss beside the plain path's if ``loss_fn``. Returns the row and
    the parameters (seed 0)."""
    from repro_torch.common import Timer
    from repro_torch.kernels.segment_mm import kernel as smod
    from repro_torch.models import gnn, gnn_check

    n_nodes, d_in = graph["x"].shape
    params = gnn.init_gnn(cfg, d_in, torch.Generator(device=dev).manual_seed(
        0), d_edge_in=gnn.GNN_EDGE_DIM.get(cfg.kind, 1))
    gnn.gnn_forward(params, graph, cfg)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    smod.segment_mm_cuda.launches = 0
    secs, first = [], None
    for _ in range(n_timed):
        with Timer() as t:
            logits = gnn.gnn_forward(params, graph, cfg)
            torch.cuda.synchronize()
        secs.append(t.seconds)
        first = logits if first is None else first
    launches = smod.segment_mm_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    per_forward = gnn.segment_mm_launches(cfg)
    what = f"{cfg.name} on {n_nodes} nodes"
    if launches != n_timed * per_forward:
        raise AssertionError(f"{what}: {launches} segment_mm launches in "
                             f"{n_timed} forwards, not {per_forward} each")
    if tuple(logits.shape) != (n_nodes, cfg.d_out) or not all_finite(
            torch, logits):
        raise AssertionError(f"{what}: logits malformed or not finite")
    if not torch.equal(first, logits):
        raise AssertionError(f"{what}: two kernel forwards differ")
    with Timer() as t_check:
        # each run starts from an empty allocator cache, as the memory fit
        # of phase 15 measured it (blocks cached by the run before would
        # fragment the float64 run's)
        torch.cuda.empty_cache()
        plain = gnn.gnn_forward(params, graph, cfg, impl="ref")
        torch.cuda.empty_cache()
        exact = gnn.gnn_forward(gnn_check.as64(params),
                                gnn_check.as64(graph), cfg, impl="ref")
        torch.cuda.empty_cache()
        excess = gnn_check.elementwise_excess(logits, exact, plain)
        faulty = gnn.gnn_forward(params, gnn_check.drop_one_edge(graph, cfg),
                                 cfg)
        fault = gnn_check.elementwise_excess(faulty, exact, plain)
        row = {"seconds_median": float(np.median(secs)),
               "seconds_max": max(secs), "seconds_min": min(secs),
               "forwards": n_timed, "segmm_launches": launches,
               "segmm_launches_per_forward": per_forward,
               "peak_bytes": peak, "bit_equal": True,
               "spread_plain32_vs_plain64": gnn_check.rel_max(plain, exact),
               "kernel_vs_plain64": gnn_check.rel_max(logits, exact),
               "kernel_vs_plain32": gnn_check.rel_max(logits, plain),
               "excess": excess, "planted_fault_excess": fault,
               "global_excess": gnn_check.spread_excess(logits, exact, plain),
               "global_fault_excess": gnn_check.spread_excess(faulty, exact,
                                                              plain),
               "logits0": logits[0].tolist()}
        del plain, exact, faulty
        if loss_fn is not None:
            row["loss"] = float(loss_fn(params, graph, cfg))
            row["plain_loss"] = float(loss_fn(params, graph, cfg,
                                              impl="ref"))
    row["check_seconds"] = t_check.seconds
    row["segmm_at_layouts"] = segmm_at_layouts(
        torch, dev, cfg, graph, 20 if graph["src"].numel() < 1 << 20 else 5)
    if not (excess <= 1.0 < fault):
        raise AssertionError(f"{what}: kernel {excess} and planted fault "
                             f"{fault} times the spread rule")
    return row, params


def gnn_kinds_phases(torch, dev, ogb_batch) -> tuple:
    """Phases 14-16; returns the segment_mm launches of each timed path and
    the launches timed at the largest cell of each kind (``ogb_products``;
    equiformer-v2: ``full_graph_sm``)."""
    from repro_torch.common import Timer
    from repro_torch.config import GNN_SHAPES, get_arch
    from repro_torch.models import gnn, gnn_check

    shapes = {s.name: s for s in GNN_SHAPES}
    launches, at_largest = {}, {}

    # -- phase 14: the three kinds at full width on molecule, full_graph_sm --
    eq_params = None
    for arch in GNN_KIND_ARCHS:
        cfg = get_arch(arch)
        for shape_name in ("molecule", "full_graph_sm"):
            shape = shapes[shape_name]
            batch = gnn_kind_batch(cfg, shape)
            with Timer() as t_layout:
                graph = gnn.resident_graph(batch, device=dev, cfg=cfg)
                torch.cuda.synchronize()
            molecule = shape_name == "molecule"
            row, params = gnn_kind_cell(
                torch, dev, cfg, graph, GNN_KIND_TIMED,
                gnn.graph_regression_loss if molecule
                else gnn.node_classification_loss)
            n_nodes = graph["x"].shape[0]
            units = shape.n_graphs if molecule else n_nodes
            launches[f"{arch} {shape_name}"] = row["segmm_launches"]
            emit({"phase": "gnn_kind_forward", "arch": arch,
                  "shape": shape_name, "nodes": n_nodes,
                  "edges": int(graph["src"].numel()),
                  "d_feat": int(graph["x"].shape[1]),
                  "resident_and_layouts_seconds": t_layout.seconds,
                  ("graphs_s" if molecule else "nodes_s"):
                      units / row["seconds_median"], **row})
            if arch == "equiformer-v2" and molecule:
                eq_params = params
            if arch == "equiformer-v2" and not molecule:
                at_largest[f"{arch} {shape_name}"] = row["segmm_at_layouts"]
            del graph, params, batch
            gc.collect()
            torch.cuda.empty_cache()

    # -- phase 15: gatedgcn and meshgraphnet on ogb_products, edges cut -------
    n_all = int(ogb_batch["src"].shape[0])
    for arch in ("gatedgcn", "meshgraphnet"):
        cfg = get_arch(arch)

        def plain64_peak(n_edges):
            """Bytes the float64 plain forward (the rule's exact side, the
            cell's largest run) holds at ``n_edges``, graph included."""
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            graph = gnn.resident_graph(gnn_kind_batch(
                cfg, None, n_edges, ogb_batch), device=dev, cfg=cfg)
            params = gnn.init_gnn(cfg, graph["x"].shape[1], torch.Generator(
                device=dev).manual_seed(0), d_edge_in=gnn.GNN_EDGE_DIM[
                    cfg.kind])
            gnn.gnn_forward(gnn_check.as64(params), gnn_check.as64(graph),
                            cfg, impl="ref")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            del graph, params
            return peak

        with Timer() as t_fit:
            (e1, e2), (p1, p2) = OGB_FIT_EDGES, [plain64_peak(e)
                                                 for e in OGB_FIT_EDGES]
            gc.collect()
            torch.cuda.empty_cache()
            free = free_bytes(torch, dev)
        per_edge = (p2 - p1) / (e2 - e1)
        fixed = p1 - per_edge * e1
        fit = int((free - OGB_MARGIN - fixed) / per_edge)
        n_edges = min(n_all, fit // OGB_CUT_STEP * OGB_CUT_STEP)
        if n_edges < e2:
            raise AssertionError(f"{arch} on ogb_products: the fit leaves "
                                 f"{n_edges} edges, fewer than it was "
                                 f"measured at")
        batch = gnn_kind_batch(cfg, None, n_edges, ogb_batch)
        with Timer() as t_layout:
            graph = gnn.resident_graph(batch, device=dev, cfg=cfg)
            torch.cuda.synchronize()
        del batch
        row, _ = gnn_kind_cell(torch, dev, cfg, graph, OGB_TIMED)
        n_nodes = graph["x"].shape[0]
        launches[f"{arch} ogb_products"] = row["segmm_launches"]
        at_largest[f"{arch} ogb_products {n_edges} edges"] = row[
            "segmm_at_layouts"]
        emit({"phase": "gnn_kind_ogb", "arch": arch, "shape": "ogb_products",
              "nodes": n_nodes, "edges": n_edges, "edges_uncut": n_all,
              "cut": {"n_edges": n_edges, "of": n_all,
                      "why": "the most edges (a multiple of "
                             f"{OGB_CUT_STEP}) at which "
                             "the float64 plain forward, the rule's exact "
                             "side and the cell's largest run, fits in the "
                             "free memory less the margin, from a linear fit "
                             "of its peak at two cuts"},
              "fit_edges": list(OGB_FIT_EDGES), "fit_peaks": [p1, p2],
              "fit_bytes_per_edge": per_edge, "fit_fixed_bytes": fixed,
              "free_bytes": free, "margin_bytes": OGB_MARGIN,
              "fit_seconds": t_fit.seconds,
              "resident_and_layouts_seconds": t_layout.seconds,
              "nodes_s": n_nodes / row["seconds_median"],
              "edges_s": n_edges / row["seconds_median"], **row})
        del graph
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase 16: equiformer-v2's rotation invariance at full width ---------
    cfg = get_arch("equiformer-v2")
    mol = shapes["molecule"]
    graph = gnn.resident_graph(gnn_kind_batch(cfg, mol), device=dev,
                               cfg=cfg)
    out = gnn.gnn_forward(eq_params, graph, cfg)
    about_z = gnn.gnn_forward(eq_params, gnn_check.rotated_graph(
        graph, gnn_check.rotation_z()), cfg)
    with gnn_check.untransposed_rotation():
        fz = [gnn.gnn_forward(eq_params, g, cfg) for g in (
            graph, gnn_check.rotated_graph(graph, gnn_check.rotation_z()))]
    inv_z = gnn_check.invariance_rel(out, about_z)
    inv_z_fault = gnn_check.invariance_rel(*fz)
    batch = gnn_check.drop_self_loops(gnn_kind_batch(cfg, mol))
    graph = gnn.resident_graph(batch, device=dev, cfg=cfg)
    runs, spreads = {}, []
    for name, g in (("out", graph), ("rot", gnn_check.rotated_graph(
            graph, gnn_check.ROTATION))):
        runs[name] = gnn.gnn_forward(eq_params, g, cfg)
        exact = gnn.gnn_forward(gnn_check.as64(eq_params), gnn_check.as64(g),
                                cfg, impl="ref")
        spreads.append(gnn_check.rel_max(gnn.gnn_forward(
            eq_params, g, cfg, impl="ref"), exact))
        with gnn_check.untransposed_rotation():
            runs[name + "_fault"] = gnn.gnn_forward(eq_params, g, cfg)
    spread = max(spreads)
    excess = gnn_check.invariance_excess(runs["out"], runs["rot"], spread)
    fault = gnn_check.invariance_excess(runs["out_fault"], runs["rot_fault"],
                                        spread)
    emit({"phase": "equiformer_invariance", "shape": "molecule",
          "about_z": {"theta": gnn_check.THETA, "rel": inv_z,
                      "rule": gnn_check.INVARIANCE_RULE,
                      "untransposed_fault_rel": inv_z_fault},
          "rotation": {"matrix": gnn_check.ROTATION.tolist(),
                       "self_loops_dropped": int(
                           gnn_kind_batch(cfg, mol)["src"].shape[0]
                           - batch["src"].shape[0]),
                       "rel": gnn_check.invariance_rel(runs["out"],
                                                       runs["rot"]),
                       "spreads": spreads, "excess": excess,
                       "untransposed_fault_excess": fault}})
    if not (inv_z < gnn_check.INVARIANCE_RULE and excess <= 1.0 < fault):
        raise AssertionError(f"equiformer invariance: about z {inv_z}, "
                             f"rotated {excess}, fault {fault}")
    del graph, runs, eq_params, out, about_z, fz
    gc.collect()
    torch.cuda.empty_cache()
    return launches, at_largest


TRAIN_STEPS = 10                # steps of a cell on its fixed batch
# bytes kept free beside a cut's fitted peak (12 GiB once left gatedgcn's
# check at ogb_products 13.4 GiB of freed blocks short of 1.1 GiB)
TRAIN_MARGIN = 16 << 30
TRAIN_FIT = {"ogb_products": (1 << 14, 1 << 15),    # nodes
             "minibatch_lg": (16, 32)}              # seeds
TRAIN_CUT_STEP = {"ogb_products": 1 << 13, "minibatch_lg": 16}
MB_BATCHES = 3                  # minibatch_lg batches whose host seconds print
# the cells of phase 18, by arch; the cut ones fit to the card's memory
TRAIN_CELLS = {"gcn-cora": ("molecule", "full_graph_sm", "ogb_products",
                            "minibatch_lg"),
               "gatedgcn": ("molecule", "full_graph_sm", "minibatch_lg",
                            "ogb_products"),
               "meshgraphnet": ("molecule", "full_graph_sm", "minibatch_lg",
                                "ogb_products"),
               "equiformer-v2": ("molecule", "full_graph_sm",
                                 "minibatch_lg")}
TRAIN_CUT = {("gatedgcn", "ogb_products"), ("meshgraphnet", "ogb_products"),
             ("equiformer-v2", "minibatch_lg")}


def minibatch_job(out_dir: str) -> dict:
    """The arrays phase 18 trains on beyond phase 11's ``ogb_products``
    batch, made in a worker process while the phases before run and
    written to ``out_dir`` as ``.npy`` files: ``gnn_full_graph_batch`` at
    ``minibatch_lg``'s sizes (seed 0; its labels for 7, 3 and 1 classes,
    the archs' ``d_out``, and equiformer-v2's ``pos``, drawn after the
    1-class labels), the sampler's in-edge CSR of that graph, and the
    3-class labels of ``ogb_products`` (meshgraphnet's). Returns the files'
    names and the host seconds of the batches and of the CSR."""
    from repro_torch.common import Timer
    from repro_torch.config import GNN_SHAPES
    from repro_torch.data.pipeline import gnn_full_graph_batch
    from repro_torch.graph.sampler import in_edge_csr

    shapes = {s.name: s for s in GNN_SHAPES}
    mb = shapes["minibatch_lg"]
    out, names = {}, {}

    def save(name, a):
        names[name] = os.path.join(out_dir, name + ".npy")
        np.save(names[name], a)

    with Timer() as t_batch:
        for n_classes in (7, 3, 1):
            b = gnn_full_graph_batch(None, mb, seed=0, n_classes=n_classes)
            save(f"mb_labels_{n_classes}", b["labels"])
            if n_classes == 7:
                for k in ("x", "src", "dst"):
                    save(f"mb_{k}", b[k])
            if n_classes == 1:
                save("mb_pos", b["pos"])
            del b
        save("ogb_labels_3", gnn_full_graph_batch(
            None, shapes["ogb_products"], seed=0, n_classes=3)["labels"])
    src, dst = np.load(names["mb_src"]), np.load(names["mb_dst"])
    with Timer() as t_csr:
        indptr, srcs = in_edge_csr(mb.n_nodes, src, dst)
    save("mb_indptr", indptr)
    save("mb_srcs", srcs)
    out["files"] = names
    out["batch_seconds"] = t_batch.seconds
    out["csr_seconds"] = t_csr.seconds
    return out


def backward_launch(torch, dev, lay_t, n_src_rows: int, coeff_t, width: int,
                    iters: int, pad_rows=None) -> dict:
    """The gradient's launch over a transposed layout ``lay_t`` (rows the
    forward's sources, items gathering ``dy`` [n_src_rows, width] rows
    with ``coeff_t``) on a standard normal ``dy`` (seed 0), zero at the
    rows ``pad_rows`` marks (a minibatch's padding nodes, whose gradient
    is zero in a step: the thousands of self-loops on the last one would
    otherwise sum one term over and over, which the rule, made for terms
    that differ, does not cover): the kernel
    against the float64 plain version under the float32 rule of
    ``kernels/segment_mm/cases.py``, the first item of
    ``mean_length_row`` dropped reading above it, two launches bit-equal;
    CUDA-event ms a launch beside the plain version's, one
    ``torch.sparse.mm`` of the same CSR (the yardstick; the port never
    calls it) and the compulsory byte bound, counting the rows of ``dy``
    the items gather (a sampled minibatch's last hop receives no edge, so
    most of its rows are never read)."""
    from repro_torch.kernels.segment_mm.cases import (mean_length_row,
                                                      rule_excess)
    from repro_torch.kernels.segment_mm.ops import segment_mm_csr
    from repro_torch.kernels.segment_mm.ref import segment_mm_ref
    from repro_torch.models.gnn_check import drop_first_items

    gen = torch.Generator(device=dev).manual_seed(0)
    dy = torch.randn(n_src_rows, width, generator=gen, device=dev)
    if pad_rows is not None:
        dy[pad_rows] = 0.0
    n, items = lay_t.n_nodes, lay_t.col.numel()
    with torch.no_grad():
        out = segment_mm_csr(dy, lay_t, coeff_t)
        again = segment_mm_csr(dy, lay_t, coeff_t)
        torch.cuda.synchronize()
        exact = segment_mm_ref(dy.double(), lay_t.col, lay_t.row,
                               coeff_t.double(), n)
        ex = rule_excess(out, exact, dy, lay_t.col, lay_t.row, coeff_t, n)
        r = mean_length_row(lay_t)
        keep = torch.ones_like(lay_t.col, dtype=torch.bool)
        keep[lay_t.row_ptr[r]] = False
        faulty = drop_first_items(lay_t, torch.tensor([r], device=dev))
        fault = rule_excess(segment_mm_csr(dy, faulty, coeff_t[keep]),
                            exact, dy, lay_t.col, lay_t.row, coeff_t, n)
        del exact, faulty, keep
        csr = torch.sparse_csr_tensor(lay_t.row_ptr, lay_t.col.long(),
                                      coeff_t, size=(n, n_src_rows))
        n_read = int((torch.bincount(lay_t.col, minlength=n_src_rows)
                      > 0).sum())
        bound, _ = segmm_bound_ms(n, n_read, items, width)
        row = {"rows": n, "items": items, "d": width,
               "dy_rows_read": n_read,
               "bit_equal": bool(torch.equal(out, again)),
               "max_abs_err": 0.0, "excess": ex,
               "planted_fault_excess": fault,
               "ms": time_ms(torch, lambda: segment_mm_csr(dy, lay_t,
                                                           coeff_t), iters),
               "plain_ms": time_ms(torch, lambda: segment_mm_csr(
                   dy, lay_t, coeff_t, impl="ref"), max(iters // 4, 1), 1),
               "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr, dy),
                                     max(iters // 4, 1), 1),
               "bound_ms": bound, "bound_by": "bytes"}
    row["max_abs_err"] = float((out.double() - segment_mm_ref(
        dy.double(), lay_t.col, lay_t.row, coeff_t.double(), n)).abs().max())
    row["bound_share"] = bound / row["ms"]
    if not (row["bit_equal"] and ex <= 1.0 < fault):
        raise AssertionError(f"segment_mm backward over {n} rows, D "
                             f"{width}: bit-equal {row['bit_equal']}, rule "
                             f"{ex}, planted fault {fault}")
    del dy, out, again, csr
    return row


def backward_launches(torch, dev, cfg, graph, iters: int) -> dict:
    """``backward_launch`` at each transposed layout and width a training
    step of ``cfg`` sums its gradient over: gcn's ``layout_t`` with
    gcn-cora's coefficients at d_hidden and d_out; gatedgcn's and
    meshgraphnet's ``edge_layout_t`` at 2 d_hidden and d_hidden;
    equiformer-v2's ``edge_layout_t`` at n_heads and ``irrep_layout_t``
    at d_hidden (coefficients 1)."""
    from repro_torch.models import gnn

    d = cfg.d_hidden
    out = {}
    pad = graph["labels"] < 0               # a minibatch's padding nodes
    if cfg.kind == "gcn":
        layout = graph["layout"]
        _, coeff, _ = gnn.gcn_norm(layout, cfg.norm)
        lt = graph["layout_t"]
        for width in (d, cfg.d_out):
            out[f"layout_t d{width}"] = backward_launch(
                torch, dev, lt, layout.n_nodes, coeff[lt.perm].contiguous(),
                width, iters, pad)
        return out
    shapes = {"gatedgcn": [("edge_layout_t", 2 * d)],
              "meshgraphnet": [("edge_layout_t", d)],
              "equiformer_v2": [("edge_layout_t", cfg.n_heads),
                                ("irrep_layout_t", d)]}[cfg.kind]
    for name, width in shapes:
        lt = graph[name]
        fwd = graph[name[:-2]]
        ones = torch.ones(lt.col.numel(), device=dev)
        k = fwd.n_nodes // pad.numel()       # irrep rows n K + k
        out[f"{name} d{width}"] = backward_launch(
            torch, dev, lt, fwd.n_nodes, ones, width, iters,
            pad.repeat_interleave(k))
    return out


def ogb_subgraph(ogb: dict, n: int):
    """The edges of ``ogb_products`` among its first ``n`` nodes (all of
    them at ``n`` = every node): a bool mask. The batch function draws
    each endpoint as ``floor(N u^2)``, so the first nodes are the hubs and
    a cut to ``n`` nodes keeps about ``n / N`` of the edges, the same mean
    degree."""
    if n >= ogb["x"].shape[0]:
        return np.ones(ogb["src"].shape[0], dtype=bool)
    return (ogb["src"] < n) & (ogb["dst"] < n)


def train_batch(cell, shape, host: dict) -> dict:
    """The cell's declared inputs for ``shape`` (seed 0): ``molecule`` and
    ``full_graph_sm`` from the copied batch functions (the molecule
    targets drawn with numpy, seed 0, at ``[n_graphs, d_out]`` where
    ``d_out`` > 1), ``ogb_products`` from phase 11's arrays (the cell's
    first nodes and the edges among them, ``ogb_subgraph``; labels of the
    arch's ``d_out`` classes); ``e`` from
    numpy seed 0 at ``GNN_EDGE_DIM``'s width."""
    from repro_torch.data.pipeline import (gnn_full_graph_batch,
                                           gnn_molecule_batch)
    from repro_torch.models import gnn

    cfg = cell.cfg
    if shape.name == "ogb_products":
        n = cell.arg_shapes["x"][0][0]
        src, dst = host["ogb"]["src"], host["ogb"]["dst"]
        keep = ogb_subgraph(host["ogb"], n)
        b = {"x": host["ogb"]["x"][:n], "src": src[keep], "dst": dst[keep],
             "labels": host[f"ogb_labels_{cfg.d_out}"][:n]}
    elif shape.kind == "batched_graphs":
        b = gnn_molecule_batch(cfg, shape, seed=0, d_feat=shape.d_feat)
        if cfg.d_out > 1:
            b["targets"] = np.random.default_rng(0).standard_normal(
                (shape.n_graphs, cfg.d_out)).astype(np.float32)
    else:
        b = gnn_full_graph_batch(cfg, shape, seed=0, n_classes=cfg.d_out)
    de = gnn.GNN_EDGE_DIM.get(cfg.kind)
    if de:
        b["e"] = np.random.default_rng(0).standard_normal(
            (b["src"].shape[0], de)).astype(np.float32)
    return {k: v for k, v in b.items() if k in cell.arg_shapes}


def train_cell(torch, dev, cell, graph, fault_must_show: bool,
               check=None) -> dict:
    """One training cell on the card, from the cell's seed-0 parameters:
      * the first step's loss and every gradient leaf on the kernel path
        against the plain path's in float32 and float64,
        ``gnn_check.grad_excess`` (under ``gnn_check.fixed_order()``; the
        spread from three plain runs in different sum orders),
        with one edge dropped from the
        transposed layout the backward sums over read beside it (above 1
        where ``fault_must_show``), on ``graph`` or, at a cut cell, on
        ``check = (cell, graph)`` at a quarter of the cut, where the
        float64 step fits; there the float32 gradients of the whole cut,
        kernel against plain, are read too (``grad_rel``);
      * step 1 under ``torch.cuda.set_sync_debug_mode("error")``;
      * steps 2 to ``TRAIN_STEPS`` on the same batch, each on the host
        clock ending in a synchronize: the median seconds, peak bytes and
        exactly ``2 segment_mm_launches(cfg)`` launches a step; the loss
        of every step read once at the end, and falling (a cell whose
        loss is 0 whatever the weights stays at 0)."""
    from repro_torch.common import Timer
    from repro_torch.kernels.segment_mm import kernel as smod
    from repro_torch.models import gnn, gnn_check
    from repro_torch.optim import adamw

    cfg = cell.cfg
    loss_fn = (gnn.graph_regression_loss if "graph_id" in cell.arg_shapes
               else gnn.node_classification_loss)
    per_step = 2 * gnn.segment_mm_launches(cfg)
    what = f"{cell.arch} x {cell.shape}"

    def grads(params, g, impl="auto"):
        p = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p, g, cfg, impl=impl)
        loss.backward()
        return loss.detach(), adamw.tree_map(
            lambda t: t.grad if t.grad is not None else torch.zeros_like(t),
            p)

    row = {}
    params, opt = cell.init(0)
    with Timer() as t_check:
        with gnn_check.fixed_order():
            smod.segment_mm_cuda.launches = 0
            loss_k, g_k = grads(params, graph)
            torch.cuda.synchronize()
            row["check_launches"] = smod.segment_mm_cuda.launches
            torch.cuda.empty_cache()
            loss_p, g_p = grads(params, graph, "ref")
            torch.cuda.empty_cache()
        torch.cuda.empty_cache()
        row["grad_rel_vs_plain32"] = gnn_check.grad_rel(g_k, g_p)
        row["loss_kernel"], row["loss_plain32"] = float(loss_k), float(
            loss_p)
        degenerate = not any(bool(t.any()) for t in adamw.tree_leaves(g_p))
        if check is not None:
            del g_k, g_p
            gc.collect()
            torch.cuda.empty_cache()
            c_cell, c_graph = check
            row["check_on"] = {"nodes": int(c_graph["x"].shape[0]),
                               "edges": int(c_graph["src"].numel()),
                               "note": c_cell.note}
            c_params, _ = c_cell.init(0)
            with gnn_check.fixed_order():
                _, g_k = grads(c_params, c_graph)
                _, g_p = grads(c_params, c_graph, "ref")
        else:
            c_params, c_graph = params, graph
        with gnn_check.fixed_order():
            _, g_f = grads(c_params, gnn_check.drop_one_transposed(
                c_graph, cfg))
            torch.cuda.empty_cache()
            loss_x, g_x = grads(gnn_check.as64(c_params),
                                gnn_check.as64(c_graph), "ref")
            # the other plain runs sum in shuffled orders
            plains = [g_p] + [
                grads(c_params, gnn_check.shuffled_sums(c_graph, cfg, s),
                      "ref")[1]
                for s in range(1, gnn_check.GRAD_PLAIN_RUNS)]
        row["loss_plain64"] = float(loss_x)
        row["rule"] = ("float64 element-wise against the largest error of "
                       "3 plain float32 runs in different sum orders "
                       "(gnn_check.grad_excess)")
        row["excess"] = gnn_check.grad_excess(g_k, g_x, plains)
        row["planted_fault_excess"] = gnn_check.grad_excess(g_f, g_x, plains)
        del g_x, g_k, g_p, g_f, plains, c_params, c_graph
    row["check_seconds"] = t_check.seconds
    row["zero_loss_cell"] = degenerate
    gc.collect()
    torch.cuda.empty_cache()
    if row["check_launches"] != per_step:
        raise AssertionError(f"{what}: {row['check_launches']} segment_mm "
                             f"launches in a forward and backward, not "
                             f"{per_step}")
    if not row["excess"] <= 1.0:
        raise AssertionError(f"{what}: gradients {row['excess']} times the "
                             f"rule")
    if fault_must_show and not degenerate \
            and not row["planted_fault_excess"] > 1.0:
        raise AssertionError(f"{what}: the planted backward fault reads "
                             f"{row['planted_fault_excess']}, not above 1")

    losses = []
    torch.cuda.synchronize()
    smod.segment_mm_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, opt, loss, stats = cell.step_fn(params, opt, graph)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses.append(loss)
    torch.cuda.synchronize()
    row["sync_debug_step_launches"] = smod.segment_mm_cuda.launches
    torch.cuda.reset_peak_memory_stats(dev)
    smod.segment_mm_cuda.launches = 0
    secs = []
    for _ in range(TRAIN_STEPS - 1):
        with Timer() as t:
            params, opt, loss, stats = cell.step_fn(params, opt, graph)
            torch.cuda.synchronize()
        secs.append(t.seconds)
        losses.append(loss)
    launches = smod.segment_mm_cuda.launches
    losses = torch.stack(losses).tolist()
    row.update({"steps_timed": len(secs),
                "seconds_median": float(np.median(secs)),
                "seconds_min": min(secs), "seconds_max": max(secs),
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "segmm_launches": launches,
                "segmm_launches_per_step": launches / len(secs),
                "losses": losses, "grad_norm_last": float(
                    stats["grad_norm"]), "lr_last": float(stats["lr"])})
    if launches != per_step * len(secs) \
            or row["sync_debug_step_launches"] != per_step:
        raise AssertionError(f"{what}: {launches} segment_mm launches in "
                             f"{len(secs)} steps, not {per_step} each")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: losses {losses}")
    falls = (all(v == 0.0 for v in losses) if degenerate
             else losses[-1] < losses[0])
    if not falls:
        raise AssertionError(f"{what}: the loss did not fall over "
                             f"{TRAIN_STEPS} steps: {losses}")
    del params, opt
    return row


def fit_train_cut(torch, dev, arch, shape, make) -> dict:
    """The most (a multiple of ``TRAIN_CUT_STEP``) nodes or seeds at which
    the plain path's float32 step fits the free memory less
    ``TRAIN_MARGIN``, from a linear fit of its peak at the two sizes of
    ``TRAIN_FIT`` (``make(size)`` gives the cell and its graph). The peak
    is the allocator's reserved bytes, not the allocated ones: the blocks
    a step frees and cannot reuse count too (a fit on the allocated peak
    left 13.4 GiB of them in the way of gatedgcn's check at its cut)."""
    from repro_torch.common import Timer

    peaks = []
    with Timer() as t_fit:
        for size in TRAIN_FIT[shape.name]:
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_reserved(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            cell, graph = make(size)
            params, opt = cell.init(0)
            cell.step_fn(params, opt, graph, impl="ref")
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_reserved(dev) - base)
            del cell, graph, params, opt
        free = free_bytes(torch, dev)
    (s1, s2), (p1, p2) = TRAIN_FIT[shape.name], peaks
    per = (p2 - p1) / (s2 - s1)
    fixed = p1 - per * s1
    step = TRAIN_CUT_STEP[shape.name]
    full = shape.n_nodes if shape.name == "ogb_products" else \
        shape.batch_nodes
    cut = min(full, int((free - TRAIN_MARGIN - fixed) / per) // step * step)
    if cut < s2:
        raise AssertionError(f"{arch} x {shape.name}: the fit leaves {cut}, "
                             f"fewer than it was measured at")
    what = "n_nodes" if shape.name == "ogb_products" else "batch_nodes"
    return {what: cut, "of": full, "fit_sizes": list(TRAIN_FIT[shape.name]),
            "fit_peaks": peaks, "fit_bytes_per_unit": per,
            "fit_fixed_bytes": fixed, "free_bytes": free,
            "margin_bytes": TRAIN_MARGIN, "fit_seconds": t_fit.seconds,
            "why": f"the most {what} (a multiple of {step}) at which the "
                   f"plain path's float32 step, the cell's largest run, "
                   f"fits in the free memory less the margin, from a "
                   f"linear fit of its peak reserved bytes at two sizes"}


def gnn_train_phases(torch, dev, ogb_batch, mb_arrays) -> tuple:
    """Phases 17-18; returns the ``segment_mm`` launches of each training
    cell's timed steps and the backward row of the kernel table."""
    from repro_torch.common import Timer
    from repro_torch.config import GNN_SHAPES
    from repro_torch.data.pipeline import DataCursor, gnn_minibatch_batch
    from repro_torch.graph.sampler import NeighborSampler
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = {s.name: s for s in GNN_SHAPES}
    files = mb_arrays["files"]
    host = {"ogb": ogb_batch, "ogb_labels_7": ogb_batch["labels"],
            "ogb_labels_3": np.load(files["ogb_labels_3"])}
    mb = shapes["minibatch_lg"]
    with Timer() as t_up:
        table = {"x": torch.from_numpy(np.load(files["mb_x"])).to(dev),
                 "pos": torch.from_numpy(np.load(files["mb_pos"])).to(dev)}
        mb_labels = {c: torch.from_numpy(np.load(
            files[f"mb_labels_{c}"])).to(dev) for c in (7, 3, 1)}
        indptr, srcs = np.load(files["mb_indptr"]), np.load(files["mb_srcs"])
        torch.cuda.synchronize()
    emit({"phase": "gnn_train_arrays", "minibatch_lg_nodes": mb.n_nodes,
          "minibatch_lg_edges": int(srcs.shape[0]),
          "worker_batch_seconds": mb_arrays["batch_seconds"],
          "sampler_csr_seconds": mb_arrays["csr_seconds"],
          "load_and_upload_seconds": t_up.seconds,
          "resident_table_bytes": int(table["x"].numel() * 4)})
    launches, backward = {}, None

    def minibatch(cell, step, sampler):
        """The cell's graph of step ``step`` (the table on the card, only
        the ids and edges uploaded), the sampler's host seconds and the
        layouts' (``cell.graph``)."""
        tab = dict(table, labels=mb_labels[cell.cfg.d_out])
        shape = dataclasses.replace(mb, batch_nodes=cell.arg_shapes[
            "seed_slots"][0][0])
        with Timer() as t_s:
            b = gnn_minibatch_batch(cell.cfg, shape, sampler, tab,
                                    DataCursor(step=step))
            torch.cuda.synchronize()
        b = {k: v for k, v in b.items() if k in cell.arg_shapes}
        with Timer() as t_l:
            graph = cell.graph(b)
            torch.cuda.synchronize()
        return graph, t_s.seconds, t_l.seconds

    for arch, cell_shapes in TRAIN_CELLS.items():
        for shape_name in cell_shapes:
            shape = shapes[shape_name]
            extra, cut = {}, None
            if (arch, shape_name) in TRAIN_CUT:
                if shape_name == "ogb_products":
                    def make(size):
                        n_e = int(ogb_subgraph(ogb_batch, size).sum())
                        c = build_cell(arch, shape_name, device=dev,
                                       n_nodes=size, n_edges=n_e)
                        return c, c.graph(train_batch(c, shape, host))
                else:
                    def make(size):
                        c = build_cell(arch, shape_name, device=dev,
                                       batch_nodes=size)
                        return c, minibatch(c, 0, NeighborSampler.from_csr(
                            indptr, srcs, mb.fanout, seed=0))[0]
                cut = fit_train_cut(torch, dev, arch, shape, make)
                key = "n_nodes" if shape_name == "ogb_products" else \
                    "batch_nodes"
                if shape_name == "ogb_products":
                    cut["n_edges"] = int(ogb_subgraph(
                        ogb_batch, cut["n_nodes"]).sum())
                    extra = {k: cut[k] for k in ("n_nodes", "n_edges")}
                else:
                    extra = {"batch_nodes": cut["batch_nodes"]}
            cell = build_cell(arch, shape_name, device=dev, **extra)
            if shape.kind == "minibatch":
                sampler = NeighborSampler.from_csr(indptr, srcs, mb.fanout,
                                                   seed=0)
                graph, s_s, s_l = minibatch(cell, 0, sampler)
                setup = {"sample_seconds": [s_s], "layouts_seconds": [s_l]}
                for i in range(1, MB_BATCHES):
                    g, s1, s2 = minibatch(cell, i, sampler)
                    setup["sample_seconds"].append(s1)
                    setup["layouts_seconds"].append(s2)
                    del g
            else:
                b = train_batch(cell, shape, host)
                with Timer() as t_l:
                    graph = cell.graph(b)
                    torch.cuda.synchronize()
                setup = {"resident_and_layouts_seconds": t_l.seconds}
                del b
            if arch == "gcn-cora" and shape_name == "ogb_products":
                backward = {d: backward_launch(
                    torch, dev, graph["layout_t"], graph["x"].shape[0],
                    gnn.gcn_norm(graph["layout"], cell.cfg.norm)[1][
                        graph["layout_t"].perm].contiguous(), d, 20)
                    for d in (cell.cfg.d_hidden, cell.cfg.d_out)}
                emit({"phase": "segmm_backward", "shape": "ogb_products",
                      "layout": "layout_t of gcn-cora's graph "
                                "(transpose_layout)",
                      "coefficients": "gcn-cora's sym coefficients, "
                                      "carried by layout_t.perm",
                      **{f"d{d}": r for d, r in backward.items()}})
            if cut is not None and shape.kind == "minibatch":
                # the transposes at the uncut shape's sizes (E K = 8.8 M
                # one-item rows), which the cut step does not reach
                full = build_cell(arch, shape_name, device=dev)
                g_full = minibatch(full, 0, NeighborSampler.from_csr(
                    indptr, srcs, mb.fanout, seed=0))[0]
                setup["backward_launches_uncut"] = backward_launches(
                    torch, dev, full.cfg, g_full, 3)
                del full, g_full
                gc.collect()
                torch.cuda.empty_cache()
            check = None
            if cut is not None:
                step = TRAIN_CUT_STEP[shape_name]
                check = make(max(step, cut[key] // 4 // step * step))
            small = shape_name in ("molecule", "full_graph_sm")
            row = train_cell(torch, dev, cell, graph, small, check)
            del check
            row["backward_launches"] = backward_launches(
                torch, dev, cell.cfg, graph, 20 if small else 5)
            n_nodes = graph["x"].shape[0]
            step_s = row["seconds_median"]
            if shape.kind == "batched_graphs":
                rate = {"graphs_s": shape.n_graphs / step_s}
            elif shape.kind == "minibatch":
                rate = {"seeds_s": cell.arg_shapes["seed_slots"][0][0]
                        / step_s}
            else:
                rate = {"nodes_s": n_nodes / step_s}
            launches[f"{arch} {shape_name}"] = row["segmm_launches"]
            emit({"phase": "gnn_train", "arch": arch, "shape": shape_name,
                  "nodes": n_nodes, "edges": int(graph["src"].numel()),
                  "d_feat": int(graph["x"].shape[1]),
                  "cut": cut, "note": cell.note, **setup, **rate, **row})
            del graph, cell
            gc.collect()
            torch.cuda.empty_cache()
    del table, mb_labels
    gc.collect()
    torch.cuda.empty_cache()
    return launches, backward


FLASH_BWD_SEQ = 4096            # the training cell's length
FLASH_BWD_ITERS = 10            # timed launches of each backward timing
FLASH_LSE_ATOL = 1e-4           # the forward's lse against the plain one's
LM_TRAIN_STEPS = 10             # steps of the LM training cell on one batch
LM_TRAIN_BATCH = 4              # its batch rows (of train_4k's 256)
LM_TRAIN_BATCHES = (LM_TRAIN_BATCH, 2, 1)  # tried in turn until 2 layers fit
LM_TRAIN_FIT = (2, 4)           # depths the memory fit steps at
LM_TRAIN_MARGIN = 4 << 30       # bytes kept free beside the fitted peak
LM_GRAD_REL = 5e-2              # per-leaf rule of the gradient check
# phase 20b's archs and the two depths each one's memory fit steps at
# (mistral-nemo's peak at 2 and 4 layers grew 2.5 GB a layer where 17
# layers took 3.4: its fit steps deeper; mixtral's 4 layers alone hold
# about 70 GB of training state)
LM_FAMILY_TRAIN = {"mistral-nemo-12b": (4, 8), "qwen1.5-32b": (2, 4),
                   "moonshot-v1-16b-a3b": (2, 4), "mixtral-8x7b": (1, 2)}
LM_FAMILY_TRAIN_STEPS = 4       # steps of each of those cells on one batch
LM_FAMILY_CHECK_LAYERS = 2      # the gradient check's depth
MOE_FAULT_ARCH = "moonshot-v1-16b-a3b"  # where the planted fault is read
MOE_FAULT_LAYER = 0             # the layer whose dispatch it detaches
PROFILE_TRAIN_LAYERS = 16       # the --profile training step's depth
LAUNCHER_STEPS = 3              # the launcher's steps at the cut depth


def flash_bwd_bound_ms(B, Hq, Hkv, S, D, causal, window) -> tuple:
    """Least time for one attention backward on these shapes: the useful
    flops, 2.5 times the forward's (10 D a pair and query head: S, dP, dV,
    dK and dQ; no recompute charged), over the bf16 tensor-core peak, or
    the bytes of q, k, v, o, dO and lse read once and dq, dk, dv written
    once over HBM; the larger, and which of the two bounds it."""
    flops = 10 * D * Hq * B * unmasked_pairs(S, S, causal, window)
    nbytes = (2 * D * (3 * B * Hq * S + 2 * B * Hkv * S) + 4 * B * Hq * S
              + 2 * D * (B * Hq * S + 2 * B * Hkv * S))
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def flash_backward_phase(torch, dev) -> dict:
    """Phase 19 (``flash_backward``): the forward kernel's lse against the
    plain forward's, and the backward kernel against the float64 plain
    backward, over ``cases.GRAD_CASES`` and at gemma2-9b's,
    mistral-nemo-12b's, qwen1.5-32b's and moonshot-v1-16b-a3b's training
    shapes (the last two MHA), where it is also timed; returns the
    ``backward_*`` fields of the flash attention row.

    The backward is checked twice a case: from the plain forward's ``o``
    and ``lse`` (so the check does not lean on the forward kernel; the
    planted faults and the bit-equal launches are read there), and from
    the forward kernel's, as the training path chains them. The phase
    fails if ptxas reports a spill in any backward entry; each timed row
    also holds each launch's ms alone (``launch_ms``)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.config import get_arch
    from repro_torch.kernels.flash_attention import blocked, cases
    from repro_torch.kernels.flash_attention import kernel as fmod

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    names = ("dq", "dk", "dv")

    def forwards(label, q, k, v, kw):
        """The forward kernel's ``(o, lse)`` and the plain forward's (o
        rounded to q's dtype, lse float32); fails unless the kernel's lse
        is within ``FLASH_LSE_ATOL`` of the plain one on every row with a
        valid key and -1e30 on the others. Also returns that error."""
        o, lse = fmod.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        o_p, lse_p = blocked.mef_forward(q, k, v, **kw)
        o_p, lse_p = o_p.to(q.dtype), lse_p.float().contiguous()
        live = lse_p > -1e29
        err = (float((lse[live] - lse_p[live]).abs().max())
               if bool(live.any()) else 0.0)
        dead = bool((lse[~live] == -1e30).all())
        if not (err <= FLASH_LSE_ATOL and dead):
            raise AssertionError(f"flash forward's lse at {label}: "
                                 f"{err} from the plain lse (allowed "
                                 f"{FLASH_LSE_ATOL}); rows with no valid "
                                 f"key at -1e30: {dead}")
        return o, lse, o_p, lse_p, err

    def check(label, q, k, v, o, lse, do, kw, faults=False):
        """The backward kernel from ``(o, lse)`` against the float64 plain
        backward from the same: per-output excess, largest error, the
        planted faults' excess (if asked), the gradients, finite."""
        got = fmod.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        ref = cases.grad_reference(q, k, v, o, lse, do, **kw)
        excess = {n: cases.grad_excess(g, ref[n], ref["a_" + n])
                  for n, g in zip(names, got)}
        err = max(float((g.double() - ref[n]).abs().max())
                  for n, g in zip(names, got))
        planted = {}
        for fault in (cases.GRAD_FAULTS if faults else ()):
            bad = cases.grad_reference(q, k, v, o, lse, do, drop=fault, **kw)
            planted[fault] = max(cases.grad_excess(bad[n], ref[n],
                                                   ref["a_" + n])
                                 for n in names)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if not (max(excess.values()) <= 1.0 and finite
                and all(x > 1.0 for x in planted.values())):
            raise AssertionError(f"flash backward {label}: excess {excess}, "
                                 f"faults {planted}, finite {finite}")
        return excess, err, planted, got

    def bwd_launch_ms(q, k, v, o, lse, do, kw):
        """Each of the backward's three launches alone (CUDA events over
        ``FLASH_BWD_ITERS`` launches; dK/dV and dQ after one delta launch),
        so that the row says which launch sets the pace."""
        run, _ = fmod.flash_attention_bwd_launcher(q, k, v, o, lse, do, **kw)
        run(fmod.BWD_DELTA)
        return {name: time_ms(torch, lambda b=bit: run(b), FLASH_BWD_ITERS)
                for name, bit in (("flash_bwd_delta", fmod.BWD_DELTA),
                                  ("flash_bwd_dkdv_wgmma", fmod.BWD_DKDV),
                                  ("flash_bwd_dq_wgmma", fmod.BWD_DQ))}

    worst_excess, worst_fault, worst_err, worst_lse = 0.0, math.inf, 0.0, 0.0
    for name, case in cases.GRAD_CASES.items():
        B, Hq, Hkv, Sq, Skv, D, *_, qs = case
        q, k, v, do = (randn(B, Hq, Sq, D, scale=qs), randn(B, Hkv, Skv, D),
                       randn(B, Hkv, Skv, D), randn(B, Hq, Sq, D))
        kw = cases.case_kwargs(case, dev)
        o, lse, o_p, lse_p, lse_err = forwards(name, q, k, v, kw)
        excess_p, err_p, faults, got = check(f"{name} from the plain "
                                             f"forward", q, k, v, o_p,
                                             lse_p, do, kw, faults=True)
        again = fmod.flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        excess, err, _, _ = check(f"{name} from the forward kernel", q, k,
                                  v, o, lse, do, kw)
        emit({"phase": "flash_backward", "case": name,
              "shape": [B, Hq, Hkv, Sq, Skv, D], "causal": kw["causal"],
              "window": kw["window"], "softcap": kw["softcap"],
              "lse_max_abs_err": lse_err,
              "excess_from_plain_forward": excess_p,
              "excess_from_forward_kernel": excess,
              "planted_fault_excess": faults,
              "max_abs_err": max(err, err_p),
              "two_launches_bit_equal": same})
        if not same:
            raise AssertionError(f"flash backward {name}: two launches "
                                 f"differ")
        worst_excess = max(worst_excess, *excess.values(), *excess_p.values())
        worst_fault = min(worst_fault, min(faults.values()))
        worst_err = max(worst_err, err, err_p)
        worst_lse = max(worst_lse, lse_err)
        del q, k, v, do, o, lse, o_p, lse_p, got, again

    ptxas = {f"{entry}<{d}>": ptxas_entry(fmod.NAME, fmod.SOURCES,
                                          fmod.EXTRA_FLAGS,
                                          f"{entry}ILi{d}E")
             for d in (256, 128) for entry in ("flash_bwd_dkdv_wgmma",
                                               "flash_bwd_dq_wgmma",
                                               "flash_bwd_delta")}
    spilled = {key: r for key, r in ptxas.items()
               if not r or r.get("spill_stores") or r.get("spill_loads")}
    if spilled:
        raise AssertionError(f"flash backward: ptxas reports spills (or no "
                             f"entry) in {spilled}")
    gemma, nemo = get_arch("gemma2-9b"), get_arch("mistral-nemo-12b")
    qwen, moon = get_arch("qwen1.5-32b"), get_arch("moonshot-v1-16b-a3b")
    # qwen's and moonshot's heads are MHA (group 1): the dK/dV block walks
    # one head's query tiles
    shapes = (("gemma2-9b global", gemma, 0, True),
              ("gemma2-9b local", gemma, gemma.sliding_window, False),
              ("mistral-nemo-12b", nemo, nemo.sliding_window, True),
              ("qwen1.5-32b", qwen, qwen.sliding_window, True),
              ("moonshot-v1-16b-a3b", moon, moon.sliding_window, True))
    S = FLASH_BWD_SEQ
    timed = {}
    for label, c, window, library in shapes:
        Hq, Hkv, D = c.n_heads, c.n_kv_heads, c.head_dim
        cap = c.attn_logit_softcap
        q, k, v, do = (randn(1, Hq, S, D), randn(1, Hkv, S, D),
                       randn(1, Hkv, S, D), randn(1, Hq, S, D))
        kw = dict(causal=True, window=window, softcap=cap)
        o, lse, o_p, lse_p, lse_err = forwards(label, q, k, v, kw)
        excess_p = check(f"at {label} from the plain forward", q, k, v,
                         o_p, lse_p, do, kw)[0]
        excess = check(f"at {label} from the forward kernel", q, k, v, o,
                       lse, do, kw)[0]
        worst_excess = max(worst_excess, *excess.values(), *excess_p.values())
        worst_lse = max(worst_lse, lse_err)
        del o_p, lse_p
        torch.cuda.empty_cache()
        bound, by, flops = flash_bwd_bound_ms(1, Hq, Hkv, S, D, True,
                                              window)
        row = {"phase": "flash_backward_timed", "shape_of": label,
               "shape": [1, Hq, Hkv, S, S, D], "window": window,
               "softcap": cap, "lse_max_abs_err": lse_err,
               "excess_from_plain_forward": excess_p,
               "excess_from_forward_kernel": excess,
               "ms": time_ms(torch, lambda: fmod.flash_attention_bwd_cuda(
                   q, k, v, o, lse, do, **kw), FLASH_BWD_ITERS),
               "launch_ms": bwd_launch_ms(q, k, v, o, lse, do, kw),
               "forward_ms": time_ms(torch, lambda: fmod.flash_attention_cuda(
                   q, k, v, return_lse=True, **kw), FLASH_BWD_ITERS),
               "plain_ms": time_ms(torch, lambda: blocked.mef_backward(
                   q, k, v, o, lse, do, **kw), 2, warmup=1),
               "plain": "blocked.mef_backward (float32, kv blocks of 512)",
               "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9,
               "ptxas": {key: r for key, r in ptxas.items()
                         if key.endswith(f"<{D}>")}}
        row["tflop_s"] = flops / row["ms"] / 1e9
        row["bound_share"] = bound / row["ms"]
        row["library_ms"] = None
        if library:
            # SDPA's backward, flash backend forced, computes causal
            # attention without softcap or window over k and v expanded to
            # Hq heads (their gradients not summed over the group); the
            # kernel at the same function, in turns with it
            kk, vv = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, kk, vv))
            o2, lse2 = fmod.flash_attention_cuda(q, k, v, causal=True,
                                                 return_lse=True)

            def kernel_same():
                fmod.flash_attention_bwd_cuda(q, k, v, o2, lse2, do,
                                              causal=True)

            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    qg, kg, vg, is_causal=True)

                def sdpa_bwd():
                    torch.autograd.grad(out, (qg, kg, vg), do,
                                        retain_graph=True)

                t = [time_ms(torch, kernel_same, FLASH_BWD_ITERS),
                     time_ms(torch, sdpa_bwd, FLASH_BWD_ITERS),
                     time_ms(torch, sdpa_bwd, FLASH_BWD_ITERS),
                     time_ms(torch, kernel_same, FLASH_BWD_ITERS)]
            row.update({
                "library": "scaled_dot_product_attention's backward, "
                           "SDPBackend.FLASH_ATTENTION (forced), causal",
                "library_ms": (t[1] + t[2]) / 2,
                "kernel_ms_beside_library": (t[0] + t[3]) / 2})
            row["kernel_vs_library"] = (row["library_ms"]
                                        / row["kernel_ms_beside_library"])
            del kk, vv, qg, kg, vg, out, o2, lse2
        timed[label] = row
        emit(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

    g, n = timed["gemma2-9b global"], timed["mistral-nemo-12b"]
    return {"backward": "flash_bwd_delta, then flash_bwd_dkdv_wgmma (a "
                        "block per key tile, 128 keys at D 128 and 64 at D "
                        "256, walks the 64-row query tiles of the group's "
                        "heads; at D 256 one consumer does S^T, P and dV, "
                        "the other dP^T, dS and dK) and flash_bwd_dq_wgmma "
                        "(a block per 128 or 64 query rows walks its 64-key "
                        "tiles); wgmma bf16 fed by a TMA ring under "
                        "mbarriers, warp-specialised; no atomics",
            "backward_source": "src/repro_torch/kernels/flash_attention/"
                               "csrc/flash_attention.cu",
            "backward_replaces": "no TPU kernel: the reference trains "
                                 "through attention_mef's jnp custom VJP "
                                 "(src/repro/kernels/flash_attention/"
                                 "ops.py:189)",
            "backward_shape": "gemma2-9b global layer at S 4,096 (B 1, Hq "
                              "16, Hkv 8, D 256, softcap 50)",
            "backward_ms": g["ms"], "backward_plain_ms": g["plain_ms"],
            "backward_bound_ms": g["bound_ms"],
            "backward_bound_by": g["bound_by"],
            "backward_library_ms": g["library_ms"],
            "backward_kernel_ms_beside_library":
                g["kernel_ms_beside_library"],
            "backward_launch_ms": g["launch_ms"],
            "backward_local_ms": timed["gemma2-9b local"]["ms"],
            "backward_d128_ms": n["ms"], "backward_d128_plain_ms":
                n["plain_ms"], "backward_d128_bound_ms": n["bound_ms"],
            "backward_d128_library_ms": n["library_ms"],
            "backward_d128_kernel_ms_beside_library":
                n["kernel_ms_beside_library"],
            "backward_d128_launch_ms": n["launch_ms"],
            "backward_mha": {label: {key: timed[label][key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "kernel_ms_beside_library", "launch_ms",
                "tflop_s", "bound_share")}
                for label in ("qwen1.5-32b", "moonshot-v1-16b-a3b")},
            "backward_tflop_s": g["tflop_s"], "backward_ptxas": ptxas,
            "backward_excess": worst_excess,
            "backward_planted_fault_excess": worst_fault,
            "backward_max_abs_err": worst_err,
            "forward_lse_max_abs_err": worst_lse}


def arch_at_depth(name: str, layers: int, smoke: bool = False,
                  arch: str = "gemma2-9b"):
    """``get_arch`` with ``arch`` cut to ``layers`` at full width (the seam
    ``launch.steps`` and ``launch.train`` look the arch up through)."""
    from repro_torch.config import get_arch

    full = get_arch(name, smoke)
    if name == arch and not smoke:
        return dataclasses.replace(full, n_layers=layers)
    return full


def leaf_rel_l2(torch, a, b, chunk: int = 1 << 26) -> float:
    """||a - b|| / ||b|| of one leaf in float64 sums over float32 chunks."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for i in range(0, b.numel(), chunk):
        x, y = a[i:i + chunk].float(), b[i:i + chunk].float()
        num += float(((x - y) ** 2).sum(dtype=torch.float64))
        den += float((y * y).sum(dtype=torch.float64))
    return (num / den) ** 0.5 if den else (0.0 if num == 0 else math.inf)


class _TorchView:
    """``torch`` as ``models/transformer.py`` sees it, with ``bmm``
    replaced."""

    def __init__(self, torch, bmm):
        self._torch, self.bmm = torch, bmm

    def __getattr__(self, name):
        return getattr(self._torch, name)


class RoutePin:
    """Wraps ``transformer.moe_route`` (and, through ``torch.bmm`` as
    ``transformer`` sees it, the expert products) for the gradient check of
    an MoE training step; the package has no such knob. While
    ``pinned`` is None it records each layer's experts, call by call (the
    forward's, then remat's recompute in the backward). Once ``pinned``
    holds a layer's experts, each call routes there, with the gates taken
    from that pass's own probabilities and renormalised, and the aux loss
    from the pinned top-1, as ``moe_route`` does; the tokens whose own top k
    differ are counted by layer, on the device. With ``detach_layer`` set,
    that layer's dispatched activations enter the expert products detached
    (the planted fault)."""

    def __init__(self, torch, tf, params, cfg):
        self.torch, self.tf, self.cfg = torch, tf, cfg
        self.real = tf.moe_route
        router = params["layers"]["router"]
        self.layer_of = {router[i].data_ptr(): i
                         for i in range(cfg.n_layers)}
        self.calls, self.moved = {}, {}
        self.pinned = self.detach_layer = self.current = None

    def route(self, h, router, cfg):
        probs, gates, experts, aux = self.real(h, router, cfg)
        layer = self.current = self.layer_of[router.data_ptr()]
        if self.pinned is None:
            self.calls.setdefault(layer, []).append(experts)
            return probs, gates, experts, aux
        pin = self.pinned[layer]
        if layer not in self.moved:
            self.moved[layer] = (experts.sort(dim=-1)[0]
                                 != pin.sort(dim=-1)[0]).any(dim=-1).sum()
        torch = self.torch
        g = probs.gather(-1, pin)
        g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
        first = pin[..., :1] == torch.arange(cfg.n_experts, device=h.device)
        aux = cfg.n_experts * torch.sum(first.to(probs.dtype).mean(
            dim=(0, 1)) * probs.mean(dim=(0, 1)))
        return probs, g, pin, aux

    def bmm(self, a, b):
        if (self.current == self.detach_layer
                and a.shape[-1] == self.cfg.d_model):
            a = a.detach()      # the dispatched activations (x_disp's view)
        return self.torch.bmm(a, b)

    def __enter__(self):
        self.tf.moe_route = self.route
        self.tf.torch = _TorchView(self.torch, self.bmm)
        return self

    def __exit__(self, *exc):
        self.tf.moe_route = self.real
        self.tf.torch = self.torch


def lm_train_arch(torch, dev, arch: str, fit: tuple, n_steps: int,
                  phase: str, even: bool = False, check_layers: int = 0,
                  fault_layer=None) -> dict:
    """One LM arch's ``train_4k`` cell at full width through
    ``build_cell``, cut in depth (and, where fewer than 2 layers fit at
    batch ``LM_TRAIN_BATCH``, in batch) to what the card holds; emits its
    ``phase`` row and returns its depth, batch and launch counts.

    The depth: one step's ``max_memory_reserved`` at the two depths of
    ``fit``, linear in the layers, the deepest count (even, with ``even``)
    whose fitted peak leaves ``LM_TRAIN_MARGIN`` of the free memory; one
    layer (two with ``even``) less, and the steps run again, while a step
    runs out of memory (the allocator's cache fragments past the fit).
    Then ``n_steps`` steps on one batch, step 1 under sync debug mode
    "error", steps 2 on timed; exactly 2L forward and L backward flash
    launches a step, and the loss falling. Then the first step's
    gradients again from the same seed, the kernels against the plain
    attention (``attention_mef``) per leaf under ``LM_GRAD_REL``, without
    optimizer state, at ``check_layers`` (0: the trained depth). An MoE
    arch's check pins the routing (``RoutePin``): the plain pass routes
    as the kernel pass's forward did, and remat's recompute in the kernel
    pass must route as its forward; with ``fault_layer``, that layer's
    dispatched activations detached must read above the rule."""
    from functools import partial

    from repro_torch.common import Timer
    from repro_torch.config import LM_SHAPES, MoEConfig, get_arch
    from repro_torch.data.pipeline import DataCursor, LMTokenPipeline
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    full = get_arch(arch)
    is_moe = isinstance(full, MoEConfig)
    spec = {s.name: s for s in LM_SHAPES}["train_4k"]
    S, unit = spec.seq_len, 2 if even else 1

    def cell_at(layers, B):
        steps.get_arch = partial(arch_at_depth, layers=layers, arch=arch)
        try:
            return steps.build_cell(arch, "train_4k", device=dev, batch=B,
                                    seq_len=S)
        finally:
            steps.get_arch = get_arch

    with Timer() as t_fit:
        for B in LM_TRAIN_BATCHES:
            batch_np = LMTokenPipeline(full, dataclasses.replace(
                spec, global_batch=B), seed=0).batch(DataCursor())
            peaks = {}
            for layers in fit:
                cell = cell_at(layers, B)
                free_bytes(torch, dev)
                torch.cuda.reset_peak_memory_stats(dev)
                params, opt = cell.init(0)
                params, opt, loss, _ = cell.step_fn(params, opt,
                                                    cell.inputs(batch_np))
                torch.cuda.synchronize()
                peaks[layers] = torch.cuda.max_memory_reserved(dev)
                del params, opt, loss, cell
            l0, l1 = fit
            per_layer = (peaks[l1] - peaks[l0]) / (l1 - l0)
            base = peaks[l0] - l0 * per_layer
            free = free_bytes(torch, dev)
            layers = min(full.n_layers, int(
                (free - LM_TRAIN_MARGIN - base) // per_layer) // unit * unit)
            if layers >= 2:
                break
        else:
            raise AssertionError(f"{phase} {arch}: 2 layers fit at no batch "
                                 f"of {LM_TRAIN_BATCHES} in {free} free "
                                 f"bytes (peaks {peaks})")
    fit_layers = layers

    # -- the main path: n_steps steps, the counts set to 0 before --------
    def run_steps(cell, batch):
        params, opt = cell.init(0)
        torch.cuda.synchronize()
        fmod.flash_attention_cuda.launches = 0
        fmod.flash_attention_bwd_cuda.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, opt, loss, _ = cell.step_fn(params, opt, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses, secs = [loss], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(n_steps - 1):
            with Timer() as t:
                params, opt, loss, _ = cell.step_fn(params, opt, batch)
                torch.cuda.synchronize()
            secs.append(t.seconds)
            losses.append(loss)
        n = sum(p.numel() for p in adamw.tree_leaves(params))
        return n, torch.stack(losses).tolist(), secs

    out_of_memory = []
    while True:
        cell = cell_at(layers, B)
        batch = cell.inputs(batch_np)
        try:
            n_params, losses, secs = run_steps(cell, batch)
            break
        except torch.OutOfMemoryError:
            if layers - unit < 2:
                raise
        out_of_memory.append(layers)
        free_bytes(torch, dev)
        layers -= unit
    fwd = fmod.flash_attention_cuda.launches
    bwd = fmod.flash_attention_bwd_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    med = float(np.median(secs))
    cfg = cell.cfg
    cell.note = "; ".join(x for x in (
        f"layers {layers} of {full.n_layers}", cell.note) if x)
    free_bytes(torch, dev)

    def grads(p0, c, attn_impl):
        p = adamw.tree_map(lambda t: t.detach().requires_grad_(), p0)
        loss = tf.lm_loss(p, batch, c, attn_impl=attn_impl)
        loss.backward()
        return float(loss.detach()), steps._leaf_paths(
            adamw.tree_map(lambda t: t.grad, p))

    def rel_by_leaf(ga, gb):
        return {path: leaf_rel_l2(torch, a, b)
                for (path, a), (_, b) in zip(ga, gb)}

    # the first step's gradients (the same seed), the kernels against the
    # plain attention, without optimizer state
    chk_layers = min(layers, check_layers or layers)
    moe, fault = None, None
    with Timer() as t_check:
        chk_cfg = dataclasses.replace(cfg, n_layers=chk_layers)
        params = tf.init_params(chk_cfg, seed=0, device=dev)
        pin = RoutePin(torch, tf, params, chk_cfg) if is_moe else None
        with pin or contextlib.nullcontext():
            loss_k, g_k = grads(params, chk_cfg, "auto")
            if pin:
                # remat's recompute routes as the forward did; the forward's
                # experts pin the plain pass
                calls = [pin.calls.get(i, []) for i in range(chk_layers)]
                recompute_equal = [len(c) == 2 and torch.equal(c[0], c[1])
                                   for c in calls]
                pin.pinned = {i: c[0] for i, c in enumerate(calls)}
                T, k = B * S, cfg.top_k
                cap = tf.moe_capacity(T, cfg)
                dropped = sum(int((~tf.moe_dispatch(
                    e, torch.ones(e.shape, device=dev), cap,
                    cfg.n_experts)[3]).sum()) for e in pin.pinned.values())
            loss_p, g_p = grads(params, chk_cfg, "blocked")
            rels = rel_by_leaf(g_k, g_p)
            del g_k
            if fault_layer is not None:
                pin.detach_layer = fault_layer
                loss_f, g_f = grads(params, chk_cfg, "auto")
                fault = {"layer": fault_layer, "what": "the layer's "
                         "dispatched activations detached (x_disp)",
                         "per_leaf": rel_by_leaf(g_f, g_p), "loss": loss_f}
                fault["worst"] = max(fault["per_leaf"].values())
                del g_f
        del g_p
        if pin:
            moe = {"routing": "pinned: the plain pass routes to the kernel "
                              "pass's forward choices, gates from its own "
                              "probabilities",
                   "plain_pass_would_reroute_tokens_by_layer": [
                       int(pin.moved[i]) for i in range(chk_layers)],
                   "recompute_routes_as_forward_by_layer": recompute_equal,
                   "capacity": cap, "pairs_per_layer": T * k,
                   "dropped_pairs_first_step": dropped,
                   "dropped_share_first_step":
                       dropped / (chk_layers * T * k)}
        del pin, params, batch
        gc.collect()
        torch.cuda.empty_cache()
    worst = max(rels.values())
    row = {"phase": phase, "arch": cfg.name, "shape": "train_4k",
           "note": cell.note, "layers": layers, "batch": B, "seq_len": S,
           "cuts": {"layers": [layers, full.n_layers],
                    "batch": [B, spec.global_batch],
                    "seq_len": [S, spec.seq_len]},
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
           "window": cfg.sliding_window, "qkv_bias": cfg.qkv_bias,
           "params": n_params, "fit_layers": list(fit),
           "fit_peaks_reserved": peaks, "fit_free_bytes": free,
           "fitted_depth": fit_layers, "out_of_memory_at": out_of_memory,
           "fit_seconds": t_fit.seconds, "steps": n_steps,
           "seconds_median": med, "seconds_min": min(secs),
           "seconds_max": max(secs), "tok_s": B * S / med,
           "model_flops": cell.model_flops,
           "model_tflop_s": cell.model_flops / med / 1e12,
           "peak_bytes": peak, "flash_forward_launches": fwd,
           "flash_backward_launches": bwd,
           "forward_launches_per_step": fwd / n_steps,
           "backward_launches_per_step": bwd / n_steps,
           "sync_debug_error_first_step": True, "losses": losses,
           "grad_check": {"plain": "attention_mef (attn_impl=blocked)",
                          "rule": f"per-leaf relative L2 <= {LM_GRAD_REL}",
                          "layers": chk_layers, "worst": worst,
                          "loss_kernel_is_step1_loss": loss_k == losses[0],
                          "loss_kernel": loss_k, "loss_plain": loss_p,
                          "per_leaf": rels, "moe": moe,
                          "planted_fault": fault},
           "check_seconds": t_check.seconds}
    emit(row)
    if not (worst <= LM_GRAD_REL and math.isfinite(loss_k)
            and abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
            and (moe is None
                 or all(moe["recompute_routes_as_forward_by_layer"]))
            and (fault is None or fault["worst"] > LM_GRAD_REL)):
        raise AssertionError(f"{phase} {arch} gradients: loss {loss_k} "
                             f"against {loss_p}, per-leaf relative L2 "
                             f"{rels}; MoE {moe}; planted fault {fault}")
    if fwd != 2 * layers * n_steps or bwd != layers * n_steps:
        raise AssertionError(f"{phase} {arch}: {fwd} forward and {bwd} "
                             f"backward launches in {n_steps} steps of "
                             f"{layers} layers")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"{phase} {arch}: the loss did not fall: "
                             f"{losses}")
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": layers, "batch": B, "forward": fwd, "backward": bwd,
            "seconds_median": med}


def lm_train_phase(torch, dev) -> dict:
    """Phase 20 (``lm_train``): gemma2-9b's ``train_4k`` cell at full width,
    cut in depth (even: its layers alternate local and global) and batch
    to what the card holds; returns its depth, batch and launch counts."""
    return lm_train_arch(torch, dev, "gemma2-9b", LM_TRAIN_FIT,
                         LM_TRAIN_STEPS, "lm_train", even=True)


def lm_family_train_phase(torch, dev) -> dict:
    """Phase 20b (``lm_family_train``): the ``train_4k`` cell of each arch
    of ``LM_FAMILY_TRAIN`` as phase 20 runs gemma2-9b's, the MoE archs
    through the dispatch's gradient with the routing pinned for the check
    (and, on ``MOE_FAULT_ARCH``, the planted fault); returns each arch's
    depth, batch and launch counts."""
    return {arch: lm_train_arch(
        torch, dev, arch, fit, LM_FAMILY_TRAIN_STEPS, "lm_family_train",
        check_layers=LM_FAMILY_CHECK_LAYERS,
        fault_layer=MOE_FAULT_LAYER if arch == MOE_FAULT_ARCH else None)
        for arch, fit in LM_FAMILY_TRAIN.items()}


def lm_train_launcher_phase(torch, dev, cuts: dict) -> dict:
    """Phase 21 (``lm_train_launcher``): ``launch/train.py`` at phase 20's
    depth and batch for gemma2-9b, and at phase 20b's for its default
    arch (mistral-nemo-12b, no ``--arch``), ``LAUNCHER_STEPS`` steps each
    without a save (``cuts``: arch -> phase 20's or 20b's result); then at
    gemma2-9b's smoke config (in bf16 at head dim 128, the backward
    kernel's) a save at step 2, a real SIGTERM and ``--resume``, against an
    uninterrupted run; returns the flash launch counts of the full-width
    runs, by arch."""
    from functools import partial

    from repro_torch.config import get_arch
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.launch import train as trainer

    ck = tempfile.mkdtemp(prefix="lm_train_ckpt_")
    counts = {}
    try:
        default = trainer.parse_args([]).arch
        for arch, cut in cuts.items():
            layers, batch = cut["layers"], cut["batch"]
            fmod.flash_attention_cuda.launches = 0
            fmod.flash_attention_bwd_cuda.launches = 0
            trainer.get_arch = partial(arch_at_depth, layers=layers,
                                       arch=arch)
            res = trainer.train(trainer.parse_args(
                ([] if arch == default else ["--arch", arch])
                + ["--steps", str(LAUNCHER_STEPS),
                   "--seq-len", str(FLASH_BWD_SEQ), "--batch", str(batch),
                   "--ckpt-every", str(10 ** 9), "--log-every",
                   str(10 ** 9), "--ckpt-dir", os.path.join(ck, "full"),
                   "--device", str(dev)]))
            fwd = fmod.flash_attention_cuda.launches
            bwd = fmod.flash_attention_bwd_cuda.launches
            counts[arch] = {"forward": fwd, "backward": bwd}
            gc.collect()
            torch.cuda.empty_cache()
            emit({"phase": "lm_train_launcher", "run": "full width", **res,
                  "launcher_default_arch": arch == default,
                  "layers": layers, "batch": batch,
                  "flash_forward_launches": fwd,
                  "flash_backward_launches": bwd,
                  "saved_files": os.listdir(ck)})
            if not (res["arch"] == get_arch(arch).name and res["exit"] == 0
                    and res["steps_run"] == LAUNCHER_STEPS
                    and not res["saved"] and not os.listdir(ck)
                    and all(math.isfinite(x) for x in res["losses"])
                    and fwd == 2 * layers * LAUNCHER_STEPS
                    and bwd == layers * LAUNCHER_STEPS):
                raise AssertionError(f"lm_train_launcher at full width: "
                                     f"{res}, {fwd} and {bwd} launches")

        smoke_cfg = dataclasses.replace(get_arch("gemma2-9b", smoke=True),
                                        dtype="bfloat16", d_head=128)

        def smoke_arch(name, smoke=False):
            return (smoke_cfg if name == "gemma2-9b" and smoke
                    else get_arch(name, smoke))

        trainer.get_arch = smoke_arch
        base = ["--arch", "gemma2-9b", "--smoke", "--steps", "4",
                "--seq-len", "128", "--batch", "4", "--ckpt-every", "2",
                "--device", str(dev)]
        whole = trainer.train(trainer.parse_args(
            base + ["--ckpt-dir", os.path.join(ck, "a")]))
        first = trainer.train(trainer.parse_args(
            base + ["--ckpt-dir", os.path.join(ck, "b"),
                    "--preempt-after", "2"]))
        rest = trainer.train(trainer.parse_args(
            base + ["--ckpt-dir", os.path.join(ck, "b"), "--resume"]))
        worst, bit_equal = 0.0, True
        a4, b4 = (pathlib.Path(ck, d, "step_00000004") for d in "ab")
        for f in sorted(a4.glob("*.npy")):
            x, y = np.load(f), np.load(b4 / f.name)
            bit_equal &= x.tobytes() == y.tobytes()
            if x.dtype.kind == "V":     # bf16 words
                x, y = (torch.from_numpy(np.ascontiguousarray(z).view(
                    np.int16)).view(torch.bfloat16).float().numpy()
                        for z in (x, y))
            den = float(np.linalg.norm(x.astype(np.float64)))
            num = float(np.linalg.norm(x.astype(np.float64)
                                       - y.astype(np.float64)))
            worst = max(worst, num / den if den else num)
        losses = first["losses"] + rest["losses"]
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, whole["losses"]))
        row = {"phase": "lm_train_launcher", "run": "smoke, preempted and "
               "resumed", "config": "gemma2-9b smoke in bf16 at head dim 128",
               "uninterrupted_losses": whole["losses"],
               "interrupted_losses": first["losses"],
               "resumed_losses": rest["losses"],
               "first_exit": first["exit"], "resumed_from":
                   rest["resumed_from"], "cursor": rest["cursor"],
               "saved": [first["saved"], rest["saved"]],
               "step4_bit_equal": bit_equal,
               "step4_worst_rel_l2": worst, "loss_worst_rel": loss_rel}
        emit(row)
        # equal up to the order in which the card sums a repeated token's
        # embedding gradient (index_put_'s accumulation)
        if not (first["exit"] == 75 and first["saved"] == [2]
                and rest["exit"] == 0 and rest["resumed_from"] == 2
                and rest["cursor"]["step"] == 4 and worst <= 1e-3
                and loss_rel <= 1e-3):
            raise AssertionError(f"lm_train_launcher resume: {row}")
    finally:
        trainer.get_arch = get_arch
        shutil.rmtree(ck, ignore_errors=True)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False; this script "
                     "measures the CUDA port and has no CPU mode", 2)
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        return _fail(f"no src/repro_torch beside {__file__}; run it from a "
                     "checkout of the repository", 3)

    from scipy.sparse.csgraph import shortest_path

    from repro_torch import guard
    from repro_torch.common import GraphEngineConfig, Timer
    from repro_torch.core import (CascadeEstimator, ClusterQuotientEstimator,
                                  DeltaSteppingEstimator,
                                  DynamicQuotientEstimator, IntervalEstimator,
                                  open_session, tau_for)
    from repro_torch.core import autotune as at
    from repro_torch.core.session import _pad_edges
    from repro_torch.launch import serve
    from repro_torch.core import state as st
    from repro_torch.core.cluster import cluster
    from repro_torch.core.engine import (hashed_uniforms, oneshot_budget,
                                         oneshot_centers)
    from repro_torch.checkpoint import latest_step
    from repro_torch.config import get_arch
    from repro_torch.graph import (GraphStore, road_like, social_like,
                                   to_scipy_csr)
    from repro_torch.launch import diameter as diameter_launcher
    from repro_torch.launch.steps import build_cell
    from repro_torch.runtime.fault import (EXIT_PREEMPTED, Preempted,
                                           PreemptionGuard)
    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_relax import kernel as kmod
    from repro_torch.kernels.edge_relax import megakernel as mk
    from repro_torch.kernels.edge_relax.ops import (build_relax_graph,
                                                    edge_relax,
                                                    edge_relax_plain)
    from repro_torch.kernels.cin import kernel as cmod
    from repro_torch.kernels.flash_attention import kernel as fmod
    from repro_torch.kernels.segment_mm import kernel as smod

    # phase 3c's 2^24-node graph is made by a worker process while the
    # build and the phases before it run
    paper_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    paper_job = paper_pool.submit(graph_job, PAPER_GRAPH_NODES, 0)
    # so are phase 18's minibatch_lg graph and its sampler's CSR, into a
    # directory removed at the end
    mb_dir = tempfile.mkdtemp(prefix="gnn_train_")
    mb_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    mb_job = mb_pool.submit(minibatch_job, mb_dir)

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # each phase group's wall seconds, printed as it ends and again before
    # the kernel table
    group_seconds = {}
    marks = [time.perf_counter()]

    def group_done(name):
        marks.append(time.perf_counter())
        group_seconds[name] = marks[-1] - marks[-2]
        emit({"phase": "group_seconds", "group": name,
              "seconds": group_seconds[name]})

    # and each graph phase's inside the graph group, so that a cut can be
    # chosen by what each costs
    graph_group = "main (graph phases 1-3c)"
    graph_phase_seconds = {}
    graph_marks = []

    def graph_phase_done(name):
        start = graph_marks[-1] if graph_marks else marks[-1]
        graph_marks.append(time.perf_counter())
        graph_phase_seconds[name] = graph_marks[-1] - start
        emit({"phase": "group_seconds", "group": graph_group,
              "graph_phase": name, "seconds": graph_phase_seconds[name]})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # -- build: one nvcc per kernel, all started together ---------------------
    builds = ((kmod.NAME, kmod.SOURCES, (), kmod.load_library),
              (kmod.MEGA_NAME, kmod.MEGA_SOURCES, (), kmod.load_mega_library),
              (fmod.NAME, fmod.SOURCES, fmod.EXTRA_FLAGS, fmod.load_library),
              (cmod.NAME, cmod.SOURCES, (), cmod.load_library),
              (smod.NAME, smod.SOURCES, (), smod.load_library))

    def timed_load(load):
        with Timer() as tb:
            load()
        return tb.seconds

    with ThreadPoolExecutor(len(builds)) as pool:
        seconds = list(pool.map(timed_load, [b[3] for b in builds]))
    for (name, sources, flags, _), secs in zip(builds, seconds):
        log = _build.library_path(name, sources, flags).with_suffix(".log")
        emit({"phase": "build", "kernel": name, "seconds": secs,
              "ptxas": ptxas_entries(log.read_text()) if log.exists()
              else []})
    group_done("build")

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
    # hubs: a 100,000-edge in-row (one block), out-row, both; rows of
    # exactly the long-row threshold and one past it
    for hub in ("in", "out", "both"):
        src, dst, w, n = star_edges(hub != "out", hub != "in")
        compare(f"star {hub} 100000", build_relax_graph(src, dst, w, n, dev),
                star_planes(n), 64)
    t = kmod.LONG_ROW
    src, dst, w, n = degree_rows([t, t + 1, t - 1, t + 1, t, 2 * t + 3, 1, 0],
                                 seed=5)
    for delta in (1, 40, BIG):
        compare(f"rows of {t} and {t + 1} edges", build_relax_graph(
            src, dst, w, n, dev), random_planes(n, 20, seed=6), delta)
    social = social_like(20, seed=0)
    g = build_relax_graph(social.src, social.dst, social.weight,
                          social.n_nodes, dev)
    wmax = int(social.weight.max())
    rmat_planes = random_planes(social.n_nodes, wmax, seed=1)
    rmat_delta = int(rng.integers(1, 2 * wmax))
    rmat_relax_row = compare("rmat social_like(20)", g, rmat_planes,
                             rmat_delta, iters=10)
    # its hub row alone: the longest in-row's edges on a graph of the hub
    # and its sources only (renumbered), so that the packing pass covers
    # those nodes and not all 1,048,576
    hub = int(g.long_rows[0])
    lo, hi = int(g.row_ptr[hub]), int(g.row_ptr[hub + 1])
    hub_src = g.src[lo:hi].to(torch.int64)
    nodes = torch.unique(torch.cat([hub_src, hub_src.new_tensor([hub])]))
    sub_src = torch.searchsorted(nodes, hub_src).to(torch.int32)
    sub_dst = torch.searchsorted(nodes, g.dst[lo:hi].to(torch.int64)).to(
        torch.int32)
    keep = nodes.cpu().numpy()
    compare(f"rmat hub row alone ({hi - lo} edges, {keep.shape[0]} nodes)",
            build_relax_graph(sub_src, sub_dst, g.w[lo:hi], keep.shape[0],
                              dev),
            tuple(x[keep] for x in rmat_planes), rmat_delta, iters=50)
    del g, social

    graph_phase_done("1 kernel vs plain")

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
        # a frontier of 5% of the rows: superstep 0 from a marked list (the
        # half-full frontier above runs it over every row)
        sparse = torch.from_numpy(
            (r.random(n) < 0.05).astype(np.uint8)).to(dev)
        compare_mega(f"{name} sparse frontier K=8", g, (d, c, p),
                     (rw0, rc, rp), frozen, sparse,
                     mk.MegaParams(delta, 0, 4 * n, 0, 0), 8)

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
    for hub in ("in", "out", "both"):
        src, dst, w, n = star_edges(hub != "out", hub != "in")
        g = build_relax_graph(src, dst, w, n, dev)
        planes_np = star_planes(n)
        mega_cases(f"star {hub} 100000", g, planes_np, 64, seed=7)
        # only node 1 on the frontier: node 0 changes in superstep 0, and
        # its out-list (a block's) in superstep 1
        tp = [torch.from_numpy(x).to(dev) for x in planes_np]
        only1 = torch.zeros(n, dtype=torch.uint8, device=dev)
        only1[1] = 1
        for k in (1, 2, 8):
            compare_mega(f"star {hub} 100000, front {{1}} K={k}", g, tp[:3],
                         tp[3:], tp[3] < BIG, only1,
                         mk.MegaParams(64, 0, 4 * n, 0, 0), k)
    src, dst, w, n = degree_rows([t, t + 1, t - 1, t + 1, t, 2 * t + 3, 1, 0],
                                 seed=5)
    mega_cases(f"rows of {t} and {t + 1} edges", build_relax_graph(
        src, dst, w, n, dev), random_planes(n, 20, seed=6), 40, seed=8)
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

    graph_phase_done("1b megakernel vs plain")

    # -- phase 2: the main path at full size ---------------------------------
    with Timer() as t:
        edges = road_like(CAL_NODES, seed=0)
    emit({"phase": "graph", "family": "road_like", "n": edges.n_nodes,
          "edges": edges.n_edges, "seconds": t.seconds})
    # phase 2i's update traces (host work) are made by two worker
    # processes while the phases before it run
    dyn_argv = ["--mode", "graph-diameter", "--graph-n", str(CAL_NODES),
                "--queries", "5", "--tau", "16", "--estimator", "dynamic",
                "--update-trace", "4", "--update-mix", "mixed",
                "--update-events", str(edges.n_edges // 200),
                "--bracket-rounds", "0", "--device", "cuda"]
    trace_pool = ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    trace_jobs = [trace_pool.submit(trace_job, CAL_NODES, s, dyn_argv)
                  for s in (0, 1)]

    def drive(session, estimator, fused: bool, what: str):
        """One query with both kernel counts set to 0 just before it and
        read just after; the wrappers' count must be the backend's."""
        torch.cuda.synchronize()
        kmod.edge_relax_cuda.launches = 0
        kmod.megakernel_cuda.launches = 0
        with Timer() as tt:
            res = session.estimate(estimator)
            torch.cuda.synchronize()
        relax_launches = kmod.edge_relax_cuda.launches
        mega_launches = kmod.megakernel_cuda.launches
        launches = mega_launches if fused else relax_launches
        other = relax_launches if fused else mega_launches
        pm = res.pipeline
        if launches != pm.kernel_launches or other != 0:
            raise AssertionError(
                f"{what}: wrappers counted edge_relax {relax_launches}, "
                f"megakernel {mega_launches}; the backend "
                f"{pm.kernel_launches}")
        return res, launches, tt.seconds

    kept = {}   # sessions later phases query again, by (phase, backend)

    def run_main(backend: str, cfg=None, tau=16, phase="main_path",
                 keep=False):
        cfg = cfg or GraphEngineConfig()
        fused = backend == "kernel" and cfg.fuse_supersteps > 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with Timer() as to:
            session = open_session(edges, cfg, backend=backend, tau=tau,
                                   device=dev)
        res, launches, query_s = drive(session, ClusterQuotientEstimator(),
                                       fused, f"{phase} {backend}")
        pm = res.pipeline
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
               "seconds": to.seconds + query_s,
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
        if keep:
            kept[phase, backend] = session
        else:
            session.close()
        return res, row, launches, graph

    res_k, row_k, launches, road_graph = run_main("kernel", keep=True)
    if launches <= 0:
        raise AssertionError("main path ran without launching edge_relax")
    if launches < row_k["supersteps"]:
        raise AssertionError("fewer kernel launches than supersteps")
    res_s, row_s, launches_s, _ = run_main("single", keep=True)
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

    def same_estimate(a, b) -> bool:
        """Every field of two estimates equal, the pipeline's counters
        included; only the host-clock seconds may differ."""
        pa, pb = (dataclasses.asdict(x.pipeline) for x in (a, b))
        timeless = [k for k in pa if not k.endswith("seconds")]
        return (all(getattr(a, f) == getattr(b, f) for f in ESTIMATE_FIELDS)
                and np.array_equal(a.quotient_ecc, b.quotient_ecc)
                and all(pa[k] == pb[k] for k in timeless))

    def cascade_row(res, phase, backend, fuse, tau, tau_solve, n_launch,
                    secs):
        pm = res.pipeline
        return {"phase": phase, "backend": backend, "fuse": fuse,
                "n": edges.n_nodes, "tau": tau, "tau_solve": tau_solve,
                "levels_run": pm.cascade_levels,
                "phi_approx": res.phi_approx, "radius": res.radius,
                "clusters": res.n_clusters,
                "level_table": [
                    {"level": i + 1, "clusters": k, "supersteps": st_,
                     "reads": r, "seconds": sec} for i, (k, st_, r, sec)
                    in enumerate(zip(pm.level_clusters, pm.level_supersteps,
                                     pm.level_syncs, pm.level_seconds))],
                "final_clusters": (pm.level_clusters[-1]
                                   if pm.level_clusters else res.n_clusters),
                "supersteps": res.growing_steps,
                "solve_supersteps": pm.solve_supersteps,
                "solve_dtype": "int64" if pm.solve_int64 else "int32",
                "kernel_launches": n_launch,
                "host_syncs": pm.total_host_syncs,
                "decompose_seconds": pm.decompose_seconds,
                "quotient_seconds": pm.quotient_seconds,
                "solve_seconds": pm.solve_seconds, "seconds": secs,
                "connected": res.connected}

    def cluster2_row(res, g, tau, fuse, n_launch, secs, backend="kernel"):
        pm = res.pipeline
        return {"phase": "cluster2", "backend": backend, "fuse": fuse,
                "n": g.n_nodes, "tau": tau, "phi_approx": res.phi_approx,
                "clusters": res.n_clusters, "radius": res.radius,
                "delta": res.delta_end, "stages": res.n_stages,
                "supersteps": res.growing_steps,
                "solve_supersteps": pm.solve_supersteps,
                "kernel_launches": n_launch,
                "kernel": ("megakernel" if fuse else "edge_relax"
                           if backend == "kernel" else None),
                "host_syncs": pm.total_host_syncs,
                "decompose_seconds": pm.decompose_seconds,
                "solve_seconds": pm.solve_seconds, "seconds": secs}

    launches_c2 = {}

    graph_phase_done("2 main path")

    # -- phase 2b: the same query through the fused megakernel ---------------
    res_f, row_f, launches_stages_fused, _ = run_main(
        "kernel", GraphEngineConfig(fuse_supersteps=8),
        phase="main_path_fused", keep=True)
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

    graph_phase_done("2b fused megakernel")

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

    graph_phase_done("2b' seed spread")

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

    graph_phase_done("2c one-shot")

    # -- phase 2d: the quotient cascade at full size --------------------------
    sess_k = kept["main_path", "kernel"]
    sess_s = kept["main_path", "single"]
    casc0, launches_casc0, secs = drive(sess_k, CascadeEstimator(levels=0),
                                        False, "cascade levels=0")
    if not (same_estimate(casc0, res_k) and same_decomposition(casc0, res_k)):
        raise AssertionError("cascade levels=0 differs from the flat estimate")
    emit({"phase": "cascade", "n": edges.n_nodes, "tau": 16, "levels": 0,
          "equal_to_flat": True, "phi_approx": casc0.phi_approx,
          "kernel_launches": launches_casc0, "seconds": secs})
    casc = {}
    for backend, sess in (("kernel", sess_k), ("single", sess_s)):
        res, n_launch, secs = drive(sess, CascadeEstimator(levels=2), False,
                                    f"cascade levels=2 {backend}")
        casc[backend] = res
        emit(cascade_row(res, "cascade", backend, 0, sess.tau,
                         sess.tau_solve, n_launch, secs))
        if backend == "kernel":
            launches_casc16 = n_launch
    ck, cs = casc["kernel"], casc["single"]
    if launches_casc16 <= 0 or launches_casc0 <= 0:
        raise AssertionError("the cascade ran level 0 without edge_relax")
    if ck.pipeline.solve_supersteps > row_k["solve_supersteps"]:
        raise AssertionError(
            f"cascade solve {ck.pipeline.solve_supersteps} supersteps > "
            f"flat {row_k['solve_supersteps']}")
    if (ck.phi_approx, ck.pipeline.level_clusters,
            ck.pipeline.level_supersteps) != (
            cs.phi_approx, cs.pipeline.level_clusters,
            cs.pipeline.level_supersteps):
        raise AssertionError("cascade: kernel and plain backends differ")
    if not ck.phi_approx >= ck.phi_quotient >= 0 or not ck.connected:
        raise AssertionError("cascade estimate malformed")
    emit({"phase": "cascade_parity", "phi_approx": ck.phi_approx,
          "level_clusters": ck.pipeline.level_clusters,
          "flat_solve_supersteps": row_k["solve_supersteps"],
          "cascade_solve_supersteps": ck.pipeline.solve_supersteps})
    casc16 = ck   # phase 2g's pooled seed-0 estimate must equal it
    del casc0, casc, cs
    # at the session default tau, fused; the flat solve is not run here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sess130 = open_session(edges, GraphEngineConfig(fuse_supersteps=8),
                           device=dev)
    res, launches_casc130, secs = drive(
        sess130, CascadeEstimator(levels=CASCADE_MAX_LEVELS), True,
        "cascade tau 130 fused")
    if launches_casc130 <= 0:
        raise AssertionError("the fused cascade ran without the megakernel")
    row = cascade_row(res, "cascade", "kernel", 8, sess130.tau,
                      sess130.tau_solve, launches_casc130, secs)
    row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    row["under_tau_solve"] = (row["final_clusters"] <= sess130.tau_solve)
    emit(row)
    if row["peak_bytes"] >= 80e9:
        raise AssertionError("the tau-130 cascade needed 80 GB")
    sess130.close()
    del res, sess130

    graph_phase_done("2d quotient cascade")

    # -- phase 2e: CLUSTER2 at full size, unfused and fused -------------------
    c2 = {}
    for fuse, sess in ((0, sess_k), (8, kept["main_path_fused", "kernel"])):
        res, n_launch, secs = drive(
            sess, ClusterQuotientEstimator(use_cluster2=True), fuse > 0,
            f"cluster2 fuse={fuse}")
        if n_launch <= 0:
            raise AssertionError(f"cluster2 fuse={fuse} launched no kernel")
        c2[fuse] = res
        launches_c2[fuse] = n_launch
        emit(cluster2_row(res, edges, sess.tau, fuse, n_launch, secs))
    if not same_decomposition(c2[0], c2[8]):
        raise AssertionError("cluster2: fused and unfused runs differ")
    emit({"phase": "cluster2_parity", "byte_identical": True,
          "phi_approx": c2[0].phi_approx, "clusters": c2[0].n_clusters})
    # phase telemetry queries phase 2's kernel session once more
    for key in [k for k in kept if k != ("main_path", "kernel")]:
        kept.pop(key).close()
    del c2, sess_k, sess_s
    e = road_like(65_536, seed=0)
    small = {}
    for backend in ("kernel", "single"):
        sess = open_session(e, backend=backend, device=dev)
        small[backend], n_launch, secs = drive(
            sess, ClusterQuotientEstimator(use_cluster2=True), False,
            f"cluster2 65536 {backend}")
        emit(cluster2_row(small[backend], e, sess.tau, 0, n_launch, secs,
                          backend=backend))
        sess.close()
    if not same_decomposition(small["kernel"], small["single"]):
        raise AssertionError("cluster2 at n=65536: kernel and plain differ")
    del small, e

    graph_phase_done("2e CLUSTER2")

    # -- phase telemetry: spans, the registry and the sync guard -------------
    from repro_torch.runtime import telemetry

    sess_t = kept.pop(("main_path", "kernel"))
    tracer = telemetry.Tracer()
    query_spans = {"engine.stage", "engine.finalize", "quotient.build",
                   "cascade.level", "quotient.solve"}
    # the sweep: a first query under sync debug mode "warn", each
    # synchronisation that bypasses guard.fetch recorded by source line
    _, query_syncs = sync_sites(
        lambda: sess_t.estimate(CascadeEstimator(levels=2)))
    tele = {}
    for traced in (False, True):
        torch.cuda.synchronize()
        # sync debug mode "error": a read that bypasses guard.fetch raises
        with (telemetry.tracing(tracer) if traced
              else contextlib.nullcontext()), \
                guard.measured_transfers("disallow") as meter, Timer() as tq:
            res = sess_t.estimate(CascadeEstimator(levels=2))
            torch.cuda.synchronize()
        if meter.transfers != res.pipeline.total_host_syncs:
            raise AssertionError(
                f"telemetry: {meter.transfers} reads measured, "
                f"{res.pipeline.total_host_syncs} counted (traced={traced})")
        tele[traced] = (res, meter.transfers, tq.seconds)
    (r_off, m_off, s_off), (r_on, m_on, s_on) = tele[False], tele[True]
    d_off, d_on = r_off.decomposition, r_on.decomposition
    if not (same_estimate(r_off, r_on) and same_decomposition(r_off, r_on)
            and d_off.final_c.tobytes() == d_on.final_c.tobytes()
            and d_off.final_pathw.tobytes() == d_on.final_pathw.tobytes()
            and r_off.pipeline.level_clusters == r_on.pipeline.level_clusters
            and r_off.pipeline.level_supersteps
            == r_on.pipeline.level_supersteps):
        raise AssertionError("telemetry: the traced query differs")
    if m_off != m_on or tracer.total_transfers() != m_on:
        raise AssertionError(
            f"telemetry: reads untraced {m_off}, traced {m_on}, attributed "
            f"{tracer.total_transfers()}")
    missing = query_spans - {s.name for s in tracer.spans}
    if missing:
        raise AssertionError(f"telemetry: no span {sorted(missing)}")
    n_query_spans = len(tracer.spans)
    attribution = tracer.attribution()
    query_attributed = tracer.total_transfers()
    # an update batch of phase 2i's seed-0 trace (the same graph): the
    # first enters dynamic mode, the second is traced
    batches = trace_jobs[0].result()[0]
    with Timer() as t_entry:
        _, entry_syncs = sync_sites(lambda: sess_t.apply_updates(batches[0]))
        torch.cuda.synchronize()
    dm = sess_t.dynamic.metrics
    before = dm.update_syncs + dm.engine_syncs
    with telemetry.tracing(tracer), \
            guard.measured_transfers("disallow") as meter, Timer() as tu:
        rep = sess_t.apply_updates(batches[1])
        torch.cuda.synchronize()
    update_reads = dm.update_syncs + dm.engine_syncs - before
    if meter.transfers != update_reads or update_reads <= 0:
        raise AssertionError(f"telemetry: update batch {meter.transfers} "
                             f"reads measured, {update_reads} counted")
    registry = telemetry.MetricsRegistry()
    registry.ingest(r_on.pipeline, "pipeline")
    registry.ingest(dm, "dynamic")
    registry.ingest(meter, "update.transfers")
    with tempfile.TemporaryDirectory(prefix="telemetry_") as td:
        written = telemetry.write_telemetry(td, tracer, registry)
        events = json.loads(pathlib.Path(written["trace"]).read_text())[
            "traceEvents"]
        files = sorted(os.listdir(td))
        spans_lines = len(pathlib.Path(written["jsonl"]).read_text()
                          .splitlines())
    if files != ["metrics.prom", "spans.jsonl", "trace.json"] \
            or len(events) != len(tracer.spans) \
            or spans_lines != len(tracer.spans) + 1:
        raise AssertionError(f"telemetry: wrote {files}, {len(events)} "
                             f"events for {len(tracer.spans)} spans")
    emit({"phase": "telemetry", "n": edges.n_nodes, "tau": sess_t.tau,
          "estimator": "cascade levels=2", "sync_debug_mode": "error",
          "query_spans": n_query_spans, "spans": len(tracer.spans),
          "span_counts": {k: [s.name for s in tracer.spans].count(k)
                          for k in sorted({s.name for s in tracer.spans})},
          "query_seconds_untraced": s_off, "query_seconds_traced": s_on,
          "traced_over_untraced": s_on / s_off,
          "query_reads": m_on, "query_attributed_reads": query_attributed,
          "update_attributed_reads": tracer.total_transfers()
          - query_attributed, "attribution": attribution,
          "phi_approx": r_on.phi_approx,
          "level_clusters": r_on.pipeline.level_clusters,
          "implicit_syncs": {"query": query_syncs,
                             "dynamic_entry_and_batch_0": entry_syncs},
          "update_action": rep.action, "update_reads": update_reads,
          "update_seconds": tu.seconds, "dynamic_entry_seconds":
          t_entry.seconds, "files": files})
    sess_t.close()
    del tele, r_off, r_on, d_off, d_on, sess_t, batches

    graph_phase_done("telemetry")

    # -- phase 2f: one host read after a launch ------------------------------
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    reads = []
    for i in range(220):
        torch.cuda.synchronize()
        with Timer() as tr:
            guard.fetch(one + i, reason="chip_smoke: host read")
        reads.append(tr.seconds)
    reads = np.sort(np.asarray(reads[20:]))
    host_read_s = float(np.median(reads))
    emit({"phase": "host_read", "reads": reads.shape[0],
          "median_s": host_read_s, "p10_s": float(reads[19]),
          "p90_s": float(reads[179]), "min_s": float(reads[0]),
          "autotune_host_sync_s": at._HOST_SYNC_S})

    graph_phase_done("2f host read")

    # -- phase 2g: graph serving at full size ---------------------------------
    serve_graphs = [edges, road_like(CAL_NODES, seed=1)]
    torch.cuda.synchronize()
    kmod.edge_relax_cuda.launches = 0
    kmod.megakernel_cuda.launches = 0
    served = serve.serve_graph_diameter(serve.parse_args([
        "--mode", "graph-diameter", "--batch", "2", "--graph-n",
        str(CAL_NODES), "--queries", "3", "--tau", "16", "--levels", "2",
        "--tau-solve", "1024", "--backend", "kernel", "--device", "cuda"]),
        graphs=serve_graphs)
    launches_serve = kmod.edge_relax_cuda.launches
    results = served.pop("results")
    emit({"phase": "graph_serve", "kernel_launches": launches_serve,
          **served})
    if served["failures"]:
        raise AssertionError(f"graph_serve: {served['failures']}")
    if served["warm_backend_builds"] or served["warm_edge_uploads"]:
        raise AssertionError("graph_serve: a warm round rebuilt or uploaded")
    if launches_serve <= 0 or kmod.megakernel_cuda.launches != 0 or \
            launches_serve != sum(r.pipeline.kernel_launches
                                  for _, _, r in results):
        raise AssertionError(f"graph_serve: {launches_serve} edge_relax "
                             "launches counted, not the queries'")
    by_graph = {}
    for i, _, r in results:
        by_graph.setdefault(i, []).append(r)
    for i, rounds in by_graph.items():
        if not all(same_estimate(r, rounds[0])
                   and same_decomposition(r, rounds[0]) for r in rounds):
            raise AssertionError(f"graph_serve: graph {i}'s rounds differ")
    if not (same_estimate(by_graph[0][0], casc16)
            and same_decomposition(by_graph[0][0], casc16)):
        raise AssertionError("graph_serve: the pooled seed-0 estimate "
                             "differs from phase cascade's")
    emit({"phase": "graph_serve_parity", "equal_to_cascade_phase": True,
          "phi_approx": casc16.phi_approx,
          "rounds_equal": True})
    del results, by_graph   # casc16 stays: phases 2k and 2l equal it

    graph_phase_done("2g graph serving")

    # -- phase 2h: autotuned serving ------------------------------------------
    e_pad = served["e_pad"]
    mirror = []
    for g in serve_graphs:
        padded = _pad_edges(g, e_pad)
        with Timer() as ts, guard.metered() as meter:
            at.compute_graph_stats(padded, dev)
        rec = at.derive_tuning(at.compute_graph_stats(padded, "cpu"),
                               device="cpu")
        mirror.append((rec, ts.seconds, meter.transfers))
        if rec.levels <= 0:
            raise AssertionError("graph_autotune: the record asks for the "
                                 "flat solve, which does not fit at tau "
                                 f"{rec.tau}")
        del padded
    at.clear_cache()
    torch.cuda.synchronize()
    kmod.edge_relax_cuda.launches = 0
    kmod.megakernel_cuda.launches = 0
    tuned = serve.serve_graph_diameter(serve.parse_args([
        "--mode", "graph-diameter", "--batch", "2", "--graph-n",
        str(CAL_NODES), "--queries", "2", "--autotune", "auto",
        "--engine-mode", "auto", "--backend", "kernel", "--device",
        "cuda"]), graphs=serve_graphs)
    launches_tuned = kmod.megakernel_cuda.launches
    results = tuned.pop("results")
    per_step = []
    for _, _, r in results:
        pm = r.pipeline
        steps0 = r.growing_steps - sum(pm.level_supersteps)
        per_step.append(pm.decompose_seconds / max(steps0, 1))
    emit({"phase": "graph_autotune", "kernel_launches": launches_tuned,
          "stats_pass": [{"seconds": s_, "reads": n_}
                         for _, s_, n_ in mirror],
          "host_mirror": [dataclasses.asdict(r_) for r_, _, _ in mirror],
          "seconds_per_level0_superstep": per_step,
          "levels_run": [r.pipeline.cascade_levels for _, _, r in results],
          **tuned})
    if tuned["failures"]:
        raise AssertionError(f"graph_autotune: {tuned['failures']}")
    for rec, (ref, _, _) in zip(tuned["tuning"], mirror):
        host = dataclasses.asdict(ref)
        for f in ("signature", "tau", "tau_solve", "levels", "delta_init",
                  "predicted_superstep_s", "mode"):
            if rec[f] != host[f]:
                raise AssertionError(f"graph_autotune: {f} {rec[f]} on the "
                                     f"card, {host[f]} on the host")
        if rec["fuse"] != mk.DEFAULT_K_FUSED:
            raise AssertionError(f"graph_autotune: fuse {rec['fuse']}")
    if launches_tuned <= 0 or kmod.edge_relax_cuda.launches != 0 or \
            launches_tuned != sum(r.pipeline.kernel_launches
                                  for _, _, r in results):
        raise AssertionError(f"graph_autotune: {launches_tuned} megakernel "
                             "launches counted, not the queries'")
    del results

    graph_phase_done("2h autotuned serving")

    # -- phase 2i: dynamic updates at full size -------------------------------
    dyn_args = serve.parse_args(dyn_argv + ["--batch", "2",
                                            "--backend", "kernel"])
    traces, trace_seconds = zip(*(j.result() for j in trace_jobs))
    trace_pool.shutdown()
    torch.cuda.synchronize()
    kmod.edge_relax_cuda.launches = 0
    kmod.megakernel_cuda.launches = 0
    dyn = serve.serve_graph_diameter(dyn_args, graphs=serve_graphs,
                                     traces=traces)
    launches_dyn = kmod.edge_relax_cuda.launches
    dyn_results = dyn.pop("results")
    for u in dyn["updates"]:
        emit({"phase": "graph_dynamic_batch", **u})
    emit({"phase": "graph_dynamic", "kernel_launches": launches_dyn,
          "trace_host_seconds": trace_seconds,
          "rebind_seconds": [u["rebind_seconds"] for u in dyn["updates"]],
          **{k: v for k, v in dyn.items() if k != "updates"}})
    if dyn["failures"]:
        raise AssertionError(f"graph_dynamic: {dyn['failures']}")
    if dyn["warm_backend_builds"] or dyn["warm_edge_uploads"]:
        raise AssertionError("graph_dynamic: a warm round rebuilt or "
                             "uploaded")
    if launches_dyn <= 0 or kmod.megakernel_cuda.launches != 0 or \
            launches_dyn != sum(dyn["backend_launches"]):
        raise AssertionError(f"graph_dynamic: {launches_dyn} edge_relax "
                             "launches counted, not the backends'")
    if dyn["update_batches"] != 8 or dyn["n"] != [CAL_NODES] * 2:
        raise AssertionError("graph_dynamic: not 4 batches on each CAL-size "
                             "graph")

    graph_phase_done("2i dynamic updates")

    # -- phase 2j: the dynamic path, kernel against plain --------------------
    def timeless(rows):
        return [{k: v for k, v in r.items() if not k.endswith("seconds")}
                for r in rows]

    plain_args = serve.parse_args(dyn_argv + ["--batch", "1",
                                              "--backend", "single"])
    plain = serve.serve_graph_diameter(plain_args, graphs=serve_graphs[:1],
                                       traces=traces[:1], e_pad=dyn["e_pad"])
    plain_results = plain.pop("results")
    if plain["failures"]:
        raise AssertionError(f"graph_dynamic_parity: {plain['failures']}")
    if timeless([u for u in dyn["updates"] if u["graph"] == 0]) \
            != timeless(plain["updates"]) \
            or dyn["dynamic_metrics"][0] != plain["dynamic_metrics"][0] \
            or timeless(dyn["final_brackets"][:1]) \
            != timeless(plain["final_brackets"]):
        raise AssertionError("graph_dynamic_parity: the kernel and plain "
                             "replays of seed 0 differ")
    for a, b in zip([r for i, _, r in dyn_results if i == 0],
                    [r for _, _, r in plain_results]):
        if not (same_estimate(a, b) and same_decomposition(a, b)):
            raise AssertionError("graph_dynamic_parity: a seed-0 estimate "
                                 "differs between kernel and plain")
    del dyn_results, plain_results, traces

    # a delete-mix trace at 65,536 nodes: repair for two batches, then
    # rebuild (rebuild_fraction 0), fused, unfused and plain
    small = road_like(65_536, seed=0)
    del_args = serve.parse_args(["--mode", "graph-diameter",
                                 "--update-trace", "4", "--update-mix",
                                 "delete"])
    small_trace = serve.update_traces([small], del_args)[0]
    replays = {}
    for name, backend, fuse in (("kernel", "kernel", 0),
                                ("fused", "kernel", 8),
                                ("single", "single", 0)):
        torch.cuda.synchronize()
        kmod.edge_relax_cuda.launches = 0
        kmod.megakernel_cuda.launches = 0
        sess = open_session(small, GraphEngineConfig(fuse_supersteps=fuse),
                            backend=backend, tau=16, device=dev,
                            rebuild_fraction=1.0)
        ests = [sess.estimate(DynamicQuotientEstimator())]
        reps = []
        with Timer() as tr:
            for b_idx, batch in enumerate(small_trace):
                if b_idx == 2:
                    sess.rebuild_fraction = 0.0
                reps.append(sess.apply_updates(batch))
                ests.append(sess.estimate())
            torch.cuda.synchronize()
        dm = dataclasses.asdict(sess.dynamic.metrics)
        replays[name] = (reps, dm, ests, kmod.edge_relax_cuda.launches,
                         kmod.megakernel_cuda.launches, tr.seconds)
        sess.close()
    base = replays["single"]
    for name in ("kernel", "fused"):
        reps, dm, ests = replays[name][:3]
        same_dm = all(dm[k] == base[1][k] for k in dm
                      if k != "engine_syncs" or name == "kernel")
        if timeless([dataclasses.asdict(r) for r in reps]) \
                != timeless([dataclasses.asdict(r) for r in base[0]]) \
                or not same_dm or not all(
                    same_estimate(a, b) and same_decomposition(a, b)
                    for a, b in zip(ests, base[2])):
            raise AssertionError(f"graph_dynamic_parity: {name} differs "
                                 "from plain at n=65536")
    actions = [r.action for r in base[0]]
    if "repair" not in actions or "rebuild" not in actions:
        raise AssertionError(f"graph_dynamic_parity: actions {actions}")
    launches_dyn_small = replays["kernel"][3]
    launches_dyn_fused = replays["fused"][4]
    if launches_dyn_small <= 0 or launches_dyn_fused <= 0 \
            or replays["kernel"][4] or replays["fused"][3]:
        raise AssertionError("graph_dynamic_parity: a replay at n=65536 "
                             "missed its kernel")

    # the same trace's brackets on road_like(4_096) against scipy's exact
    tiny = road_like(4_096, seed=0)
    tiny_trace = serve.update_traces([tiny], del_args)[0]
    sess = open_session(tiny, backend="kernel", device=dev)
    brackets = []
    for batch in tiny_trace:
        sess.apply_updates(batch)
        iv = sess.estimate(IntervalEstimator())
        d = shortest_path(to_scipy_csr(sess.edges), method="D",
                          directed=False)
        exact = int(d[np.isfinite(d)].max())
        if not iv.lower <= exact <= iv.upper:
            raise AssertionError(f"graph_dynamic_parity: scipy exact {exact} "
                                 f"outside [{iv.lower}, {iv.upper}]")
        brackets.append([iv.lower, exact, iv.upper])
    launches_dyn_tiny = sess.backend.launches
    sess.close()
    emit({"phase": "graph_dynamic_parity", "seed0_kernel_equals_plain": True,
          "n65536_actions": actions,
          "n65536_equal": ["kernel", "fused", "single"],
          "n65536_seconds": {k: v[5] for k, v in replays.items()},
          "n65536_supersteps": [r.supersteps for r in base[0]],
          "n65536_dead_nodes": [r.dead_nodes for r in base[0]],
          "n65536_launches": {"edge_relax": launches_dyn_small,
                              "megakernel": launches_dyn_fused},
          "n65536_engine_syncs": {k: v[1]["engine_syncs"]
                                  for k, v in replays.items()},
          "n4096_brackets": brackets,
          "n4096_launches": launches_dyn_tiny})
    del small, small_trace, replays, base, tiny, tiny_trace, serve_graphs

    graph_phase_done("2j dynamic kernel vs plain")

    # -- phase 2k: kill and resume at full size --------------------------------
    def same_query(a, b) -> bool:
        """The estimate's fields, final planes, quotient eccentricities and
        cascade lists equal; the read counts may differ (a resumed run
        reads less, a fused one otherwise)."""
        pa, pb = a.pipeline, b.pipeline
        return (all(getattr(a, f) == getattr(b, f) for f in ESTIMATE_FIELDS)
                and np.array_equal(a.quotient_ecc, b.quotient_ecc)
                and same_decomposition(a, b)
                and (pa.level_clusters, pa.level_supersteps,
                     pa.solve_supersteps) == (pb.level_clusters,
                                              pb.level_supersteps,
                                              pb.solve_supersteps))

    casc_est = CascadeEstimator(levels=2, tau_solve=1024)
    launches_resume = {}
    for fuse in (0, 8):
        cfg = GraphEngineConfig(fuse_supersteps=fuse)
        with tempfile.TemporaryDirectory() as d:
            pg = PreemptionGuard()
            sess = open_session(edges, cfg, tau=16, device=dev,
                                checkpoint_dir=d, guard=pg)
            sess.checkpointer.preempt_after_stage = 2
            torch.cuda.synchronize()
            kmod.edge_relax_cuda.launches = 0
            kmod.megakernel_cuda.launches = 0
            killed_at = None
            with Timer() as tk:
                try:
                    with pg:   # the guard only around the query it kills
                        sess.estimate(casc_est)
                except Preempted as p:
                    killed_at = p.stage
            killed = sess.checkpointer
            killed_launches = (kmod.megakernel_cuda.launches if fuse
                               else kmod.edge_relax_cuda.launches)
            if killed_at != 2 or killed.saves < 1 or latest_step(d) != 2:
                raise AssertionError(f"preempt_resume fuse={fuse}: the kill "
                                     f"gave stage {killed_at}, "
                                     f"{killed.saves} saves")
            sess.close()
            sess = open_session(edges, cfg, tau=16, device=dev,
                                checkpoint_dir=d, resume=True,
                                guard=PreemptionGuard())
            with guard.metered() as meter:
                res, n_launch, secs = drive(sess, casc_est, fuse > 0,
                                            f"preempt_resume fuse={fuse}")
            ck = sess.checkpointer
            pm = res.pipeline
            if ck.restores != 1:
                raise AssertionError(f"preempt_resume fuse={fuse}: the "
                                     "resume restored nothing")
            if not same_query(res, casc16):
                raise AssertionError(f"preempt_resume fuse={fuse}: the "
                                     "resumed query differs from the "
                                     "uninterrupted one")
            if any(x.startswith("step_") for x in os.listdir(d)):
                raise AssertionError("preempt_resume: steps left behind")
            if meter.transfers != pm.total_host_syncs + pm.checkpoint_syncs:
                raise AssertionError("preempt_resume: reads not counted")
            if killed_launches <= 0 or n_launch <= 0:
                raise AssertionError(f"preempt_resume fuse={fuse}: no launch")
            launches_resume[fuse] = killed_launches + n_launch
            emit({"phase": "preempt_resume", "fuse": fuse, "tau": 16,
                  "n": edges.n_nodes, "killed_at_stage": killed_at,
                  "killed_seconds": tk.seconds,
                  "killed_launches": killed_launches,
                  "saves_before_kill": killed.saves,
                  "stage_seconds": killed.stage_seconds + ck.stage_seconds,
                  "save_seconds": killed.save_seconds + ck.save_seconds,
                  "save_bytes": killed.save_bytes + ck.save_bytes,
                  "resumed_seconds": secs, "resumed_launches": n_launch,
                  "restores": ck.restores, "saves_after_resume": ck.saves,
                  "checkpoint_syncs": pm.checkpoint_syncs,
                  "host_syncs": pm.total_host_syncs,
                  "measured_reads": meter.transfers,
                  "phi_approx": res.phi_approx,
                  "clusters": res.n_clusters,
                  "equal_to_uninterrupted": True})
            sess.close()
    # the serve launcher killed by a real SIGTERM in a subprocess, then
    # resumed (the pooled CAL query of phase 2g's seed 0)
    serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve",
                 "--mode", "graph-diameter", "--batch", "1", "--graph-n",
                 str(CAL_NODES), "--queries", "1", "--tau", "16", "--levels",
                 "2", "--tau-solve", "1024", "--backend", "kernel",
                 "--device", "cuda"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as d:
        runs = {}
        for what, extra in (("killed", ["--preempt-after", "2"]),
                            ("resumed", ["--resume"])):
            with Timer() as tr:
                proc = subprocess.run(serve_cmd + ["--checkpoint-dir", d]
                                      + extra, capture_output=True,
                                      text=True, env=env, cwd=ROOT,
                                      timeout=600)
            runs[what] = (proc, tr.seconds)
        killed, resumed = runs["killed"][0], runs["resumed"][0]
        if killed.returncode != EXIT_PREEMPTED:
            raise AssertionError(f"preempt_resume serve: the killed run "
                                 f"exited {killed.returncode}: "
                                 f"{killed.stderr[-2000:]}")
        if resumed.returncode != 0:
            raise AssertionError(f"preempt_resume serve: the resumed run "
                                 f"exited {resumed.returncode}: "
                                 f"{resumed.stderr[-2000:]}")
        served = json.loads(resumed.stdout.strip().splitlines()[-1])
        q = served["per_query"][0]
        if (q["phi_approx"], q["clusters"]) != (casc16.phi_approx,
                                                casc16.n_clusters) \
                or served["checkpoint"][0]["restores"] != 1 \
                or served["failures"]:
            raise AssertionError("preempt_resume serve: the resumed "
                                 f"estimate {q} differs")
    emit({"phase": "preempt_resume_serve", "killed_exit": killed.returncode,
          "resumed_exit": resumed.returncode,
          "process_seconds": {k: v[1] for k, v in runs.items()},
          "resumed": {k: served[k] for k in (
              "checkpoint", "transfers", "counted_host_syncs",
              "backend_launches", "cold_seconds")},
          "phi_approx": q["phi_approx"], "clusters": q["clusters"],
          "equal_to_uninterrupted": True})
    del runs, served

    graph_phase_done("2k kill and resume")

    # -- phase 2l: GraphStore, spill and the quickstart example ---------------
    # the diameter launcher over 4 compressed shards, on phase 2's graph
    # (its build_graph would make road_like(CAL_NODES, seed=0) again)
    buf = io.StringIO()
    real_build = diameter_launcher.build_graph
    diameter_launcher.build_graph = lambda kind, n, seed: edges
    torch.cuda.synchronize()
    kmod.edge_relax_cuda.launches = 0
    kmod.megakernel_cuda.launches = 0
    try:
        with contextlib.redirect_stdout(buf):
            rc = diameter_launcher.main([
                "--n", str(CAL_NODES), "--tau", "16", "--levels", "2",
                "--tau-solve", "1024", "--shards", "4", "--compress",
                "--backend", "kernel", "--device", "cuda"])
    finally:
        diameter_launcher.build_graph = real_build
    launches_store = kmod.edge_relax_cuda.launches
    sharded = json.loads(buf.getvalue().strip().splitlines()[-1])
    pc = casc16.pipeline
    flat = {"phi_approx": casc16.phi_approx, "radius": casc16.radius,
            "clusters": casc16.n_clusters, "stages": casc16.n_stages,
            "supersteps": casc16.growing_steps,
            "solve_supersteps": pc.solve_supersteps,
            "level_clusters": pc.level_clusters,
            "level_supersteps": pc.level_supersteps}
    if rc != 0 or {k: sharded[k] for k in flat} != flat \
            or launches_store != sharded["kernel_launches"] \
            or launches_store <= 0:
        raise AssertionError(f"graph_store: --shards 4 --compress gave "
                             f"{sharded}, the flat run {flat}")
    # a store-backed session: spill, then the next query unspills
    store = GraphStore(edges, n_shards=4, device=dev)
    sess = open_session(None, store=store, tau=16)
    res, n1, secs1 = drive(sess, casc_est, False, "graph_store session")
    del res
    gc.collect()
    torch.cuda.synchronize()
    mem_resident = torch.cuda.memory_allocated(dev)
    m = sess.metrics
    builds, uploads = m.backend_builds, m.edge_uploads
    with Timer() as t_spill:
        sess.spill()
        gc.collect()
        torch.cuda.synchronize()
    mem_spilled = torch.cuda.memory_allocated(dev)
    res, n2, secs2 = drive(sess, casc_est, False, "graph_store unspilled")
    if not mem_spilled < mem_resident:
        raise AssertionError("graph_store: spill freed no device memory")
    if (m.backend_builds, m.edge_uploads) != (builds + 1, uploads + 1) \
            or not same_query(res, casc16) or sess.spilled:
        raise AssertionError("graph_store: the unspilled query differs")
    launches_store += n1 + n2
    sess.close()
    del res, sess, store
    # the quickstart example on the card
    buf = io.StringIO()
    quickstart = runpy.run_path(str(ROOT / "examples" /
                                    "quickstart_torch.py"))
    with contextlib.redirect_stdout(buf):
        rc = quickstart["main"](["--device", "cuda"])
    lines = buf.getvalue().splitlines()
    if rc != 0 or not lines or "conservative: True" not in lines[-1]:
        raise AssertionError(f"quickstart_torch: {lines}")
    emit({"phase": "graph_store", "n": edges.n_nodes, "tau": 16,
          "launcher": sharded, "equal_to_flat": True,
          "store_session_seconds": [secs1, secs2],
          "memory_allocated_resident": mem_resident,
          "memory_allocated_spilled": mem_spilled,
          "spill_seconds": t_spill.seconds,
          "builds_uploads_after_unspill": [m.backend_builds, m.edge_uploads],
          "kernel_launches": launches_store, "quickstart": lines})
    del casc16

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

    graph_phase_done("2l GraphStore")

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

    graph_phase_done("3 certified bracket")

    # -- phase 3b: the paper's competitor on the same session (Table 3) -------
    # Bellman-Ford's supersteps grow linearly with n on road_like, so the
    # road graph is cut to SSSP_ROAD_NODES; RMAT social_like(20) at its
    # size
    sssp_launches = {}
    for name, e in ((f"road_like({SSSP_ROAD_NODES})",
                     road_like(SSSP_ROAD_NODES, seed=0)),
                    ("rmat social_like(20)", social_like(20, seed=0))):
        sess = open_session(e, tau=16, device=dev)
        ests = {}
        for key, est in (
                ("cluster", ClusterQuotientEstimator()),
                ("cascade", CascadeEstimator(levels=2, tau_solve=32)),
                ("bellman_ford", DeltaSteppingEstimator(seed=7)),
                ("delta_stepping", DeltaSteppingEstimator(
                    seed=7, delta=max(int(e.weight.mean()), 1)))):
            res, n_launch, secs = drive(sess, est, False, f"sssp {name} {key}")
            ests[key] = res
            pm = res.pipeline
            row = {"phase": "sssp", "graph": name, "n": e.n_nodes,
                   "edges": e.n_edges, "estimator": key, "tau": sess.tau,
                   "lower": res.lower, "upper": res.upper,
                   "phi_approx": res.phi_approx,
                   "supersteps": res.growing_steps,
                   "host_syncs": pm.total_host_syncs,
                   "kernel_launches": n_launch, "seconds": secs,
                   "connected": res.connected}
            if key in ("bellman_ford", "delta_stepping"):
                row.update(delta=res.delta_end,
                           ms_per_superstep=secs * 1e3 / max(
                               res.growing_steps, 1))
            else:
                sssp_launches[f"{name} {key}"] = n_launch
                if n_launch <= 0:
                    raise AssertionError(f"sssp {name} {key}: no launch")
                row.update(clusters=res.n_clusters,
                           solve_supersteps=pm.solve_supersteps,
                           level_clusters=pm.level_clusters)
            emit(row)
        bf, dstep = ests["bellman_ford"], ests["delta_stepping"]
        if not np.array_equal(bf.dist, dstep.dist):
            raise AssertionError(f"sssp {name}: Bellman-Ford and "
                                 "Δ-stepping distances differ")
        for key in ("cluster", "cascade"):
            if not bf.lower <= ests[key].phi_approx:
                raise AssertionError(f"sssp {name}: lower {bf.lower} > "
                                     f"{key} {ests[key].phi_approx}")
        emit({"phase": "sssp_parity", "graph": name, "equal_planes": True,
              "sssp_lower": bf.lower, "sssp_upper": bf.upper,
              "bf_supersteps": bf.growing_steps,
              "delta_stepping_supersteps": dstep.growing_steps,
              "cluster_growing_steps": ests["cluster"].growing_steps,
              "round_ratio": bf.growing_steps
              / max(ests["cluster"].growing_steps, 1)})
        sess.close()
        del ests, bf, dstep, e

    graph_phase_done("3b competitor (Table 3)")

    # -- phase 3c: the paper-graph cell and a query at roads-USA scale --------
    edges24, gen_seconds = paper_job.result()
    paper_pool.shutdown()
    emit({"phase": "graph", "family": "road_like", "n": edges24.n_nodes,
          "edges": edges24.n_edges, "seconds": gen_seconds,
          "made_by": "worker process"})
    cell = build_cell("paper-graph", "n16M", avg_degree=6, device=dev)
    inputs = cell.inputs(edges24)
    masked = cell.n_edges - int(inputs["edge_mask"].sum())
    torch.cuda.synchronize()
    kmod.edge_relax_cuda.launches = 0
    be_k = cell.backend(inputs, "kernel")
    s0 = cell.state(be_k)
    sk, gk = cell.step_fn(s0, be_k)
    torch.cuda.synchronize()
    launches_cell = kmod.edge_relax_cuda.launches
    be_s = cell.backend(inputs, "single")
    ss, gs_plain = cell.step_fn(cell.state(be_s), be_s)
    fields = [f.name for f in dataclasses.fields(sk)]
    if launches_cell != 1 or not all(torch.equal(getattr(sk, f),
                                                 getattr(ss, f))
                                     for f in fields) \
            or (gk.steps, gk.reached) != (gs_plain.steps, gs_plain.reached):
        raise AssertionError(f"paper_graph cell: {launches_cell} launches; "
                             f"the kernel superstep ({gk}) differs from the "
                             f"plain one ({gs_plain})")
    del be_s, ss, sk
    rw0, rc, rp, frozen24 = st.relay_planes(s0)
    cell_row = compare("paper-graph n16M cell", be_k.graph,
                       [x.cpu().numpy() for x in (s0.d, s0.c, s0.pathw, rw0,
                                                  rc, rp)], 1 << 20,
                       iters=20)
    # the megakernel at this size, against its plain version from the
    # same stage-0 planes: the query's first grow call (Δ = the mean
    # weight, the stop variant, its half target and num_it, fuse 8) and
    # a complete-variant call at the cell's Δ, whose frontier spans the
    # graph for all 8 supersteps (timed)
    n24 = cell.n_nodes
    tau24 = tau_for(n24)
    half24 = max((n24 + 1) // 2 - int(s0.is_center[:n24].sum()), 0)
    front24 = torch.ones(s0.n, dtype=torch.uint8, device=dev)
    mega24 = [compare_mega(
        f"paper-graph n16M stage 0, {name}", be_k.graph,
        (s0.d, s0.c, s0.pathw), (rw0, rc, rp), frozen24, front24,
        mk.MegaParams(delta, half, max(2 * n24 // tau24, 8), 0, stop), 8,
        iters=iters)
        for name, delta, half, stop, iters in (
            ("query's first grow", max(int(edges24.weight.mean()), 1),
             half24, 1, 0),
            ("complete", 1 << 20, 0, 0, 5))]
    emit({"phase": "paper_graph_cell", "cell": cell.shape,
          "n": cell.n_nodes, "edge_slots": cell.n_edges,
          "real_edges": edges24.n_edges, "masked_edges": masked,
          "planes_equal": True, "reached": gk.reached,
          "kernel_launches": launches_cell, "ms": cell_row["ms"],
          "plain_ms": cell_row["plain_ms"],
          "bound_ms": cell_row["bound_ms"],
          "megakernel_equal": True,
          "megakernel_executed": [r["executed"] for r in mega24],
          "megakernel_ms": mega24[1]["ms"],
          "megakernel_plain_ms": mega24[1]["plain_ms"],
          "megakernel_bound_ms": mega24[1]["bound_ms"]})
    del be_k, inputs, s0, rw0, rc, rp, frozen24, front24, cell
    gc.collect()
    torch.cuda.empty_cache()
    # the full config's query: tau_for(2^24), fused 8, the cascade, and a
    # checkpoint at every stage boundary
    cfg24 = dataclasses.replace(get_arch("paper-graph"), fuse_supersteps=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as d:
        with Timer() as t_open:
            sess24 = open_session(edges24, cfg24, tau_solve=1024, device=dev,
                                  checkpoint_dir=d)
        with guard.metered() as meter:
            res24, launches24, secs24 = drive(
                sess24, CascadeEstimator(levels=2, tau_solve=1024), True,
                "paper_graph query")
        ck = sess24.checkpointer
        pm = res24.pipeline
        left = [x for x in os.listdir(d) if x.startswith("step_")]
    row24 = {"phase": "paper_graph", "n": edges24.n_nodes,
             "edges": edges24.n_edges, "tau": sess24.tau,
             "tau_solve": sess24.tau_solve, "fuse": 8,
             "open_seconds": t_open.seconds, "query_seconds": secs24,
             "phi_approx": res24.phi_approx, "radius": res24.radius,
             "clusters": res24.n_clusters,
             "level_clusters": pm.level_clusters,
             "level_supersteps": pm.level_supersteps,
             "stages": res24.n_stages, "supersteps": res24.growing_steps,
             "solve_supersteps": pm.solve_supersteps,
             "kernel_launches": launches24,
             "host_syncs": pm.total_host_syncs,
             "checkpoint_syncs": pm.checkpoint_syncs,
             "measured_reads": meter.transfers, "saves": ck.saves,
             "save_seconds": ck.save_seconds, "save_bytes": ck.save_bytes,
             "stage_seconds": ck.stage_seconds,
             "decompose_seconds": pm.decompose_seconds,
             "quotient_seconds": pm.quotient_seconds,
             "solve_seconds": pm.solve_seconds,
             "peak_bytes": torch.cuda.max_memory_allocated(dev),
             "connected": res24.connected}
    emit(row24)
    if sess24.tau != tau_for(PAPER_GRAPH_NODES) or launches24 <= 0 \
            or meter.transfers != pm.total_host_syncs + pm.checkpoint_syncs \
            or ck.saves < 1 or left or not res24.connected \
            or not res24.phi_approx >= res24.phi_quotient >= 0:
        raise AssertionError(f"paper_graph: {row24}")
    sess24.close()
    del sess24, res24, edges24
    gc.collect()
    torch.cuda.empty_cache()

    # -- phases 4-6: flash attention and the LM at full width -----------------
    del res_k, res_s, res_f, oneshot, dk, ds, fc, mask, start, b
    gc.collect()
    torch.cuda.empty_cache()
    graph_phase_done("3c paper-graph cell")
    group_done(graph_group)
    flash_row = lm_phases(torch, dev)
    group_done("lm_phases")
    gc.collect()
    torch.cuda.empty_cache()
    family = lm_family_phases(torch, dev)
    group_done("lm_family_phases")
    flash_row["launches"] += sum(v["prefill"] for v in family.values())
    flash_row["launches_by_path"].update(
        {f"prefill {arch}": v["prefill"] for arch, v in family.items()})

    # -- phases 7-10: CIN and xDeepFM serving at full width -------------------
    gc.collect()
    torch.cuda.empty_cache()
    cin_row = recsys_phases(torch, dev)
    group_done("recsys_phases")

    # -- phases 10b-10c: the CIN's gradient kernels and xDeepFM training ---
    gc.collect()
    torch.cuda.empty_cache()
    grad_rows = cin_backward_phase(torch, dev)
    group_done("cin_backward_phase")
    train_launches = recsys_train_phase(torch, dev)
    group_done("recsys_train_phase")
    cin_row["launches"] += train_launches["forward"]
    cin_row["launches_by_path"]["recsys_train"] = train_launches["forward"]
    l2 = {w: grad_rows[("layer2", w)] for w in ("dx", "dw")}
    cin_row.update({
        "backward": "cin_dx_wgmma (dxk and dx0 in one launch, reassociated "
                    "around U = dy W; 3xTF32) and cin_dw_wgmma (3xTF32, Z "
                    "in registers against dy split by cin_split_dy, K parts "
                    "summed in order)",
        "backward_sources": {
            "cin_dx_wgmma": "src/repro_torch/kernels/cin/csrc/cin.cu",
            "cin_dw_wgmma": "src/repro_torch/kernels/cin/csrc/cin.cu"},
        "backward_replaces": "no TPU kernel: the reference trains through "
                             "the plain einsums (src/repro/kernels/cin/"
                             "ref.py)",
        "backward_launches": sum(train_launches[w] for w in ("dx", "dw")),
        "backward_launches_by_kernel": {
            w: train_launches[w] for w in ("dx", "dw")},
        "backward_shape": "an H-200 layer of train_batch (B 65,536, m 39, "
                          "H 200, H2 200, D 10): dx + dW",
        "backward_ms": sum(r["ms"] for r in l2.values()),
        "backward_bound_ms": sum(r["bound_ms"] for r in l2.values()),
        "backward_fma_bound_ms": sum(r["fma_bound_ms"]
                                     for r in l2.values()),
        "backward_old_route_dx_ms": l2["dx"]["old_route_ms"],
        "backward_b16384_ms": sum(r["b16384_ms"] for r in l2.values()),
        "backward_plain_ms": sum(r["b16384_plain_ms"] for r in l2.values()),
        "backward_library_ms": sum(r["b16384_library_ms"]
                                   for r in l2.values()),
        "backward_plain_and_library_at": "B 16,384 (their intermediates "
                                         "fit)",
        "backward_excess": max(r["excess"] for r in grad_rows.values()),
        "backward_planted_fault_excess": min(
            r["planted_fault_excess"] for r in grad_rows.values()),
        "backward_kernels": {f"{layer} {w}": {
            k: r[k] for k in ("ms", "bound_ms", "bound_by", "fma_bound_ms",
                              "bound_share", "tflop_s", "excess",
                              "planted_fault_excess", "max_abs_err",
                              "b16384_ms", "b16384_bound_ms",
                              "b16384_plain_ms", "b16384_library_ms",
                              "old_route_ms", "b16384_old_route_ms",
                              "ptxas")
            if k in r}
            for (layer, w), r in grad_rows.items()}})

    # -- phases 11-13: segment_mm and gcn-cora inference ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    segmm_row, ogb_batch = gnn_phases(torch, dev)
    group_done("gnn_phases")

    # -- phases 14-16: gatedgcn, meshgraphnet and equiformer-v2 ---------------
    gc.collect()
    torch.cuda.empty_cache()
    kinds, kinds_timed = gnn_kinds_phases(torch, dev, ogb_batch)
    group_done("gnn_kinds_phases")
    segmm_row["launches"] += sum(kinds.values())
    segmm_row["launches_by_path"].update(kinds)
    segmm_row["gnn_kinds_layouts"] = kinds_timed

    # -- phases 17-18: segment_mm's gradient and GNN training ----------------
    gc.collect()
    torch.cuda.empty_cache()
    try:
        train, backward = gnn_train_phases(torch, dev, ogb_batch,
                                           mb_job.result())
    finally:
        mb_pool.shutdown()
        shutil.rmtree(mb_dir, ignore_errors=True)
    del ogb_batch
    group_done("gnn_train_phases")
    segmm_row["launches"] += sum(train.values())
    segmm_row["launches_by_path"].update(
        {f"train {k}": v for k, v in train.items()})
    b16, b7 = backward[16], backward[7]
    segmm_row.update({
        "backward": "the gradient in x: the same kernel over "
                    "transpose_layout (one launch per forward launch)",
        "backward_launches": sum(train.values()) // 2,
        "backward_shape": f"ogb_products layout_t ({b16['rows']} rows, "
                          f"{b16['items']} items), D 16",
        "backward_ms": b16["ms"], "backward_plain_ms": b16["plain_ms"],
        "backward_bound_ms": b16["bound_ms"],
        "backward_library_ms": b16["library_ms"],
        "backward_excess": b16["excess"],
        "backward_d7_ms": b7["ms"], "backward_d7_plain_ms": b7["plain_ms"],
        "backward_d7_bound_ms": b7["bound_ms"],
        "backward_d7_library_ms": b7["library_ms"],
        "max_abs_err": max(segmm_row["max_abs_err"], b16["max_abs_err"],
                           b7["max_abs_err"])})

    # -- phases 19-21: the flash attention backward and LM training ---------
    gc.collect()
    torch.cuda.empty_cache()
    flash_row.update(flash_backward_phase(torch, dev))
    group_done("flash_backward_phase")
    lm_train = lm_train_phase(torch, dev)
    group_done("lm_train_phase")
    family_train = lm_family_train_phase(torch, dev)
    group_done("lm_family_train_phase")
    default_arch = "mistral-nemo-12b"    # launch/train.py's default
    lm_launcher = lm_train_launcher_phase(
        torch, dev, {"gemma2-9b": lm_train,
                     default_arch: family_train[default_arch]})
    group_done("lm_train_launcher_phase")
    runs = {"lm_train": lm_train,
            **{f"lm_family_train {arch}": r
               for arch, r in family_train.items()},
            **{f"lm_train_launcher {arch}": r
               for arch, r in lm_launcher.items()}}
    flash_row["launches"] += sum(r["forward"] for r in runs.values())
    flash_row["launches_by_path"].update(
        {path: r["forward"] for path, r in runs.items()})
    flash_row["backward_launches"] = sum(r["backward"]
                                         for r in runs.values())
    flash_row["backward_launches_by_path"] = {
        path: r["backward"] for path, r in runs.items()}
    flash_row["backward_launches_per_training_step"] = {
        "gemma2-9b": lm_train["backward"] // LM_TRAIN_STEPS,
        **{arch: r["backward"] // LM_FAMILY_TRAIN_STEPS
           for arch, r in family_train.items()}}
    emit({"phase": "group_seconds_total", "groups": group_seconds,
          "graph_phases": graph_phase_seconds,
          "script_seconds": time.perf_counter() - marks[0]})

    emit({"kernels": [{
        "name": "edge_relax", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_relax/csrc/edge_relax.cu",
        "replaces": "src/repro/kernels/edge_relax/kernel.py:78",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "rmat_ms": rmat_relax_row["ms"],
        "rmat_plain_ms": rmat_relax_row["plain_ms"],
        "rmat_bound_ms": rmat_relax_row["bound_ms"],
        "launches_by_path": {"stages_unfused": launches,
                             "oneshot_unfused": launches_oneshot_unfused,
                             "cascade_tau16": launches_casc16,
                             "cluster2_unfused": launches_c2[0],
                             "graph_serve": launches_serve,
                             "graph_dynamic": launches_dyn,
                             "graph_dynamic_parity_65536":
                                 launches_dyn_small,
                             "graph_dynamic_parity_4096": launches_dyn_tiny,
                             "preempt_resume_unfused": launches_resume[0],
                             "graph_store": launches_store,
                             "paper_graph_cell": launches_cell,
                             **{f"sssp {k}": v
                                for k, v in sssp_launches.items()}},
        "paper_graph_cell_ms": cell_row["ms"],
        "paper_graph_cell_plain_ms": cell_row["plain_ms"],
        "paper_graph_cell_bound_ms": cell_row["bound_ms"],
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
        "rmat_bound_ms": rmat_row["bound_ms"],
        "launches_by_path": {"stages_fused": launches_stages_fused,
                             "oneshot_fused": launches_oneshot_fused,
                             "cascade_tau130_fused": launches_casc130,
                             "cluster2_fused": launches_c2[8],
                             "graph_autotune": launches_tuned,
                             "graph_dynamic_parity_65536_fused":
                                 launches_dyn_fused,
                             "preempt_resume_fused": launches_resume[8],
                             "paper_graph_query": launches24},
        "paper_graph_ms": mega24[1]["ms"],
        "paper_graph_plain_ms": mega24[1]["plain_ms"],
        "paper_graph_bound_ms": mega24[1]["bound_ms"],
    }, flash_row, cin_row, segmm_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(profile_paths() if sys.argv[1:] == ["--profile"] else main())
