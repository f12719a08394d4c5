"""Dynamic graphs: incremental updates on resident sessions, the port of
the JAX package's ``core/dynamic.py``.

A session absorbs edge insertions, reweights and deletions in place
(``apply_updates``) and repairs its decomposition from the certificates it
already holds: each node's ``final_pathw`` is the weight of a real path
from its center, and the quotient's weights are built from those.

  * insertions / weight decreases: distances only shrink, so every
    certificate stays valid; a monotone tightening relax
    (``backend.grow``, ``complete`` variant) propagates the improvements.
    Every prefix of it is certified, so ``tighten_cap`` bounds its
    supersteps without giving anything up.
  * deletions / weight increases: one edge sweep rebuilds the WITNESS
    FOREST (``_forest_repair``): each non-center picks an in-cluster
    parent of strictly smaller old ``pathw`` (acyclic, rooted at the
    centers) minimizing ``pathw[u] + w`` under the current weights, and
    pointer doubling (O(log n) node-local rounds) re-derives every
    certificate along the forest. Nodes whose chain no longer reaches a
    center are DEAD: a confined regrow re-attaches them from the alive
    boundary through the same engine relax, and what stays unreached
    becomes a singleton cluster (Alg. 1's own rule for uncovered nodes).
    When the dead fraction exceeds ``session.rebuild_fraction`` the
    session decomposes again from scratch.

Dirty tracking is node-granular: ``ensure_dynamic`` recertifies the first
decomposition through the forest once (and after every rebuild), so that
every certificate is witnessed by an in-cluster parent and later dead sets
stay proportional to the update. The quotient is refreshed incrementally
(``core/quotient.quotient_update_device``): only the (cluster, cluster)
keys that touch a dirty cluster are recomputed.

On the card every repair step is a ``backend.grow`` call: on
``KernelBackend`` the ``edge_relax`` kernel (or the megakernel with
``fuse > 0``) over the CSR that ``KernelBackend.rebind`` rebuilds from the
store after each flushed batch. The forest sweep, the pointer doubling,
the finalize pass and the quotient merge are plain PyTorch, as the
reference's are plain ``jnp``.

Host reads: ``DynamicMetrics.update_syncs`` counts the reads the
reference counts (one per packed plane fetch and per dead-node count);
``engine_syncs`` counts the rest, which the reference's jitted loops do
not make: the engine's chunk or launch reads in every full decomposition
and repair grow, and a rebuild's recertify fetch. The kernel backend's
``rebind`` reads nothing: the store keeps each node's in-degree on the
host, which gives the CSR's long rows.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import (Timer, get_logger, next_multiple,
                                to_device)
from repro_torch.core.engine import Decomposition
from repro_torch.core.state import INF, EngineState
from repro_torch.graph.segment_ops import segment_min_triple
from repro_torch.graph.storage import EdgeStore
from repro_torch.graph.structures import MAX_WEIGHT
from repro_torch.runtime import telemetry

log = get_logger("repro_torch.dynamic")

# Δ for the repair relaxation: the engine's max_delta clip (2^30), so the
# candidate adds stay inside int32
_REPAIR_DELTA = 2**30
# superstep cap of the repair relaxation (the fixpoint ends it far sooner)
_REPAIR_NUM_IT = 2**30
# default superstep cap of the insert/decrease tightening relax
DEFAULT_TIGHTEN_CAP = 8
# dirty-incident quotient slices are padded to a multiple of this, as the
# reference pads them for its compile buckets
DIRTY_EDGE_BUCKET = 256


def _i32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32).reshape(-1)


@dataclass
class UpdateBatch:
    """One batch of edge mutations, in DIRECTED triples.

      * insert (u, v, w): a new key adds the edge; an existing key keeps
        ``min(old, w)`` (a heavier parallel edge is a no-op).
      * reweight (u, v, w): SETS the weight; the key must exist.
      * delete (u, v): removes the key; it must exist.

    The constructors emit both directions by default (``symmetric=True``).
    """

    insert_src: np.ndarray = field(default_factory=lambda: _i32([]))
    insert_dst: np.ndarray = field(default_factory=lambda: _i32([]))
    insert_weight: np.ndarray = field(default_factory=lambda: _i32([]))
    reweight_src: np.ndarray = field(default_factory=lambda: _i32([]))
    reweight_dst: np.ndarray = field(default_factory=lambda: _i32([]))
    reweight_weight: np.ndarray = field(default_factory=lambda: _i32([]))
    delete_src: np.ndarray = field(default_factory=lambda: _i32([]))
    delete_dst: np.ndarray = field(default_factory=lambda: _i32([]))

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, _i32(getattr(self, f.name)))
        if not (len(self.insert_src) == len(self.insert_dst)
                == len(self.insert_weight)):
            raise ValueError("insert arrays length mismatch")
        if not (len(self.reweight_src) == len(self.reweight_dst)
                == len(self.reweight_weight)):
            raise ValueError("reweight arrays length mismatch")
        if len(self.delete_src) != len(self.delete_dst):
            raise ValueError("delete arrays length mismatch")
        for w in (self.insert_weight, self.reweight_weight):
            if len(w) and (w.min() < 1 or w.max() > int(MAX_WEIGHT)):
                raise ValueError("update weights must be in [1, 2^30)")

    @property
    def n_events(self) -> int:
        return (len(self.insert_src) + len(self.reweight_src)
                + len(self.delete_src))

    @staticmethod
    def _sym(u, v, w=None):
        u, v = _i32(u), _i32(v)
        uu, vv = np.concatenate([u, v]), np.concatenate([v, u])
        if w is None:
            return uu, vv
        w = _i32(w)
        return uu, vv, np.concatenate([w, w])

    @classmethod
    def inserts(cls, u, v, w, *, symmetric: bool = True) -> "UpdateBatch":
        if symmetric:
            u, v, w = cls._sym(u, v, w)
        return cls(insert_src=u, insert_dst=v, insert_weight=w)

    @classmethod
    def reweights(cls, u, v, w, *, symmetric: bool = True) -> "UpdateBatch":
        if symmetric:
            u, v, w = cls._sym(u, v, w)
        return cls(reweight_src=u, reweight_dst=v, reweight_weight=w)

    @classmethod
    def deletes(cls, u, v, *, symmetric: bool = True) -> "UpdateBatch":
        if symmetric:
            u, v = cls._sym(u, v)
        return cls(delete_src=u, delete_dst=v)

    @staticmethod
    def merge(batches) -> "UpdateBatch":
        """Concatenate several batches into one (applied in order)."""
        batches = list(batches)
        return UpdateBatch(**{
            f.name: (np.concatenate([getattr(b, f.name) for b in batches])
                     if batches else _i32([]))
            for f in dataclasses.fields(UpdateBatch)})


@dataclass
class DynamicMetrics:
    """Cost accounting over a session's whole update stream. Every field
    but the last is the reference's, counted as it counts them."""

    batches: int = 0
    inserts: int = 0          # effective new keys
    decreases: int = 0        # weight shrank (incl. insert-on-existing)
    increases: int = 0        # weight grew
    deletes: int = 0
    noop_events: int = 0      # e.g. inserting a heavier parallel edge
    relax_batches: int = 0    # decrease-only batches (frontier relax)
    repair_batches: int = 0   # forest recertify + confined regrow batches
    full_rebuilds: int = 0    # rebuild_fraction exceeded
    update_supersteps: int = 0   # edge sweeps: forest sweep + regrow + tighten
    pointer_rounds: int = 0      # node-local doubling rounds (no edge traffic)
    rebuild_supersteps: int = 0  # growing steps inside full rebuilds
    update_syncs: int = 0        # host reads the reference counts
    store_uploads: int = 0       # whole edge-array placements (build/growth)
    store_scatters: int = 0      # in-place scatter rounds
    baseline_supersteps: int = 0  # growing steps of the last FULL
                                  # decomposition (the rebuild comparator)
    engine_syncs: int = 0     # the other host reads (module docstring)

    @property
    def amortized_supersteps(self) -> float:
        """Update supersteps per applied batch, rebuild steps included."""
        total = self.update_supersteps + self.rebuild_supersteps
        return total / max(self.batches, 1)


@dataclass
class UpdateReport:
    """What one ``apply_updates`` call did."""

    action: str               # "noop" | "relax" | "repair" | "rebuild"
    inserts: int
    decreases: int
    increases: int
    deletes: int
    noops: int
    dirty_fraction: float     # dead certificates / n (delete path)
    supersteps: int           # edge sweeps this batch (forest+regrow+tighten)
    pointer_rounds: int       # node-local doubling rounds this batch
    dead_nodes: int           # certificates the witness forest could not root
    new_singletons: int       # nodes no center could reach again
    cluster_set_changed: bool
    seconds: float


@dataclass
class DynamicState:
    """Per-session dynamic bookkeeping (made by ``ensure_dynamic``)."""

    store: EdgeStore
    dec: Decomposition
    metrics: DynamicMetrics = field(default_factory=DynamicMetrics)
    # cached device quotient of (store, dec) and its read counters
    dq: Optional[object] = None
    dq_counters: Optional[Tuple[int, int, int, int]] = None
    # center ids whose (cluster, cluster) quotient keys must be recomputed
    dirty_centers: Set[int] = field(default_factory=set)
    quotient_stale: bool = True   # a full quotient pass is needed
    # cached solve (phi_quotient, ecc, connected, supersteps)
    solution: Optional[Tuple[int, np.ndarray, bool, int]] = None


# ---------------------------------------------------------------------------
# the witness forest and the repair states (plain PyTorch on the device)
# ---------------------------------------------------------------------------


def _forest_repair(src, dst, w, fc, fp, *, n: int, k_rounds: int):
    """Witness-forest recertification: ONE edge sweep and ``k_rounds``
    node-local pointer-doubling rounds.

    Every non-center v picks a parent u over its in-cluster edges with
    ``fp[u] < fp[v]`` (strict descent in the OLD certificates, so the
    forest is acyclic and rooted at the fp = 0 centers), minimizing
    ``(fp[u] + w, u)`` under the CURRENT weights; doubling then sums each
    node's weight to its root, saturating at 2^30. A node is DEAD when its
    chain reaches no center or saturates. Returns (alive bool [n], fp_new
    int32 [n], INF where dead)."""
    big = 2**30
    ids = torch.arange(n, dtype=torch.int32, device=fc.device)
    is_center = fc == ids
    si, di = src.to(torch.int64), dst.to(torch.int64)
    fp_s = fp[si]
    adm = ((fc[si] == fc[di]) & (fp_s < fp[di]) & (src != dst)
           & (fp_s < big) & (w < big))
    val = torch.where(adm, torch.where(adm, fp_s, 0) + w, INF)
    v_min, parent, pw = segment_min_triple(val, src, w, dst, n)
    has_parent = (v_min < INF) & ~is_center
    parent = torch.where(has_parent, parent, ids)
    acc = torch.where(has_parent, pw, 0)
    for _ in range(k_rounds):
        pl = parent.to(torch.int64)
        ap = acc[pl]
        # BIG - a never underflows (a >= 0), so the test catches
        # a + ap >= BIG without an int32 overflow
        acc = torch.where((acc >= big) | (ap >= big - acc), big, acc + ap)
        parent = parent[pl]
    rooted = is_center[parent.to(torch.int64)] & (acc < big)
    alive = is_center | (has_parent & rooted)
    fp_new = torch.where(is_center, 0, torch.where(alive, acc, INF))
    return alive, fp_new.to(torch.int32)


def _repair_state(fc, fp, alive, n: int, *, confine: bool) -> EngineState:
    """EngineState for the repair relax: d == pathw == the certificates
    (INF on dead nodes), centers frozen at 0, no covered relays.

    With ``confine=True`` every ALIVE node is frozen too: alive nodes feed
    candidates but only dead nodes receive, so the wave stays inside the
    dead region."""
    ids = torch.arange(n, dtype=torch.int32, device=fc.device)
    fc_r = torch.where(alive, fc, INF)
    fp_r = torch.where(alive, fp, INF)
    z = torch.zeros(n, dtype=torch.int32, device=fc.device)
    f = torch.zeros(n, dtype=torch.bool, device=fc.device)
    frozen = alive if confine else (fc == ids) & alive
    return EngineState(d=fp_r, c=fc_r, pathw=fp_r, final_c=fc_r,
                       final_pathw=fp_r, offset=z, covered=f,
                       is_center=frozen)


def _finalize_repair(state: EngineState, *, n: int):
    """Unreached nodes become singleton clusters (c = self, pathw = 0).
    Returns (c, pathw, n_singletons as a 0-dim int32 tensor)."""
    ids = torch.arange(n, dtype=torch.int32, device=state.c.device)
    dead = state.pathw >= INF
    c = torch.where(dead, ids, state.c)
    p = torch.where(dead, 0, state.pathw).to(torch.int32)
    return c, p, dead.sum().to(torch.int32)


# ---------------------------------------------------------------------------
# session plumbing
# ---------------------------------------------------------------------------


def _grow(session, state: EngineState, cap: Optional[int],
          m: DynamicMetrics):
    """One ``complete`` grow of the repair relax on the session's backend
    (the kernels on the card); its host reads go to ``engine_syncs``."""
    num_it = _REPAIR_NUM_IT if cap is None else int(cap)
    state, stats = session.backend.grow(state, _REPAIR_DELTA, 0, num_it,
                                        "complete")
    m.engine_syncs += stats.syncs
    return state, stats.steps


def _full_decomposition(session, m: DynamicMetrics) -> Decomposition:
    """One full decomposition with the session's own defaults, on the
    backend (which ``rebind`` has pointed at the store)."""
    from repro_torch.core.cluster import cluster

    cfg = session.cfg
    delta0 = session.resolve_delta_init(cfg.delta_init)
    dec = cluster(
        session.edges, session.tau, gamma=cfg.gamma, variant=cfg.variant,
        delta_init=str(delta0), seed=cfg.seed, max_stages=cfg.max_stages,
        max_steps_per_phase=cfg.max_steps_per_phase,
        backend=session.backend, uniform_fn=session.uniform_fn,
        mode=cfg.mode, deterministic=cfg.deterministic)
    m.engine_syncs += dec.metrics.host_syncs + dec.metrics.finalize_syncs
    return dec


def _pointer_rounds(n: int) -> int:
    return int(math.ceil(math.log2(max(n, 2)))) + 1


def _recertify(session, dec: Decomposition,
               m: DynamicMetrics) -> Tuple[Decomposition, int, int]:
    """Reroute every certificate through the witness forest and a
    confined regrow, so each node's ``(c, pathw)`` is witnessed by an
    in-cluster parent edge (the engine's "stop" variant does not
    guarantee it). Returns (dec, edge_sweeps, pointer_rounds)."""
    n = session.n_nodes
    if n == 0 or dec.final_c_dev is None:
        return dec, 0, 0
    with telemetry.span("dynamic.recertify", n=n) as sp:
        src, dst, w = session.flat_device_edges()
        rounds = _pointer_rounds(n)
        alive, fp_base = _forest_repair(src, dst, w, dec.final_c_dev,
                                        dec.final_pathw_dev, n=n,
                                        k_rounds=rounds)
        state = _repair_state(dec.final_c_dev, fp_base, alive, n,
                              confine=True)
        state, grow_steps = _grow(session, state, None, m)
        c_dev, p_dev, n_single = _finalize_repair(state, n=n)
        fc, fp, singles = _fetch_repair_planes(c_dev, p_dev, (n_single,))
        sp.set(pointer_rounds=rounds, supersteps=1 + grow_steps,
               singletons=singles)
    if singles:
        log.info("recertify: %d unreachable nodes became singletons", singles)
    dec = _make_decomposition(dec, fc, fp, c_dev, p_dev, 0,
                              dec.n_clusters + singles)
    return dec, 1 + grow_steps, rounds


def ensure_dynamic(session) -> DynamicState:
    """Switch a session into dynamic mode, once: build an ``EdgeStore``
    from the resident graph (pool padding self-loops become free
    capacity), or take a store-backed session's own store, rebind the backend to it, decompose, and recertify the
    decomposition through the witness forest.

    The reference builds a single-shard ``GraphStore`` here; with one
    shard and no centers its slots are exactly ``EdgeStore``'s, so the
    port builds an ``EdgeStore``."""
    st = session._dynamic
    if st is not None:
        return st
    session._check_open()
    # a store-backed session keeps ITS store (its checkpoint seam stays
    # live under updates)
    store = session.store
    if store is None:
        store = EdgeStore(session.edges, device=session.device)
    else:
        store.ensure_device()
    session.backend.rebind(store.src, store.dst, store.weight,
                           store.in_degree)
    # the host mirror turns lazy (materialized from the store on access);
    # the edge count tracks the store (the build drops self-loops and
    # min-coalesces duplicates)
    session._edges, session._edges_fn = None, store.edge_list
    session._n_edges = store.n_edges
    session._delta_stats = None
    session._max_weight = None
    m = DynamicMetrics()
    dec = _full_decomposition(session, m)
    st = DynamicState(store=store, dec=dec, metrics=m)
    m.baseline_supersteps = dec.growing_steps
    m.store_uploads = store.uploads
    session._dynamic = st
    dec, boot_sweeps, _ = _recertify(session, dec, m)
    st.dec = dec
    m.update_syncs += 1
    log.info("dynamic mode: %d nodes, %d edges (capacity %d), baseline "
             "decomposition %d supersteps (+%d recertify sweeps)",
             session.n_nodes, store.n_edges, store.capacity,
             dec.growing_steps, boot_sweeps)
    return st


# ---------------------------------------------------------------------------
# classification and application
# ---------------------------------------------------------------------------


@dataclass
class _Plan:
    inserts: int = 0
    decreases: int = 0
    increases: int = 0
    deletes: int = 0
    noops: int = 0
    touched: List[int] = field(default_factory=list)   # any change

    @property
    def has_decrease(self) -> bool:
        return self.inserts + self.decreases > 0

    @property
    def has_increase(self) -> bool:
        return self.increases + self.deletes > 0


def _stage_events(store: EdgeStore, batch: UpdateBatch) -> _Plan:
    """Validate, classify and stage every event on the host store.

    Validation runs BEFORE any mutation, so a bad batch leaves the store
    untouched. Reweights and deletes refer to the pre-batch edge set; a key
    may appear in at most one of them per batch."""
    mutated = []
    for u, v, kind in [
        *((int(u), int(v), "reweight") for u, v in
          zip(batch.reweight_src, batch.reweight_dst)),
        *((int(u), int(v), "delete") for u, v in
          zip(batch.delete_src, batch.delete_dst)),
    ]:
        store._check_endpoint(u, v)
        if store.lookup(u, v) is None:
            raise ValueError(f"{kind} of missing edge ({u}, {v})")
        mutated.append((u, v))
    if len(set(mutated)) != len(mutated):
        raise ValueError(
            "a directed edge key may appear in at most one reweight/delete "
            "per batch (apply sequential changes in separate batches)")
    for u, v in zip(batch.insert_src, batch.insert_dst):
        store._check_endpoint(int(u), int(v))

    plan = _Plan()
    for u, v, w in zip(batch.insert_src.tolist(), batch.insert_dst.tolist(),
                       batch.insert_weight.tolist()):
        if u == v:
            plan.noops += 1      # self-loops are inert by construction
            continue
        old = store.lookup(u, v)
        if old is None:
            store.set_edge(u, v, w)
            plan.inserts += 1
        elif w < old:
            store.set_edge(u, v, w)
            plan.decreases += 1
        else:
            plan.noops += 1      # min-coalesce: heavier parallel edge
            continue
        plan.touched += (u, v)
    for u, v, w in zip(batch.reweight_src.tolist(),
                       batch.reweight_dst.tolist(),
                       batch.reweight_weight.tolist()):
        old = store.lookup(u, v)
        if w == old:
            plan.noops += 1
            continue
        store.set_edge(u, v, w)
        plan.touched += (u, v)
        if w < old:
            plan.decreases += 1
        else:
            plan.increases += 1
    for u, v in zip(batch.delete_src.tolist(), batch.delete_dst.tolist()):
        store.delete_edge(u, v)
        plan.deletes += 1
        plan.touched += (u, v)
    return plan


def _fetch_repair_planes(c_dev, p_dev, scalars) -> Tuple:
    """ONE packed device-to-host read of the repaired planes and int32
    0-dim stats. Returns (c, pathw, *stats as ints)."""
    n = int(c_dev.shape[0])
    packed = guard.fetch(torch.cat(
        [c_dev, p_dev] + [s.to(torch.int32).reshape(1) for s in scalars]),
        reason="dynamic repair: packed planes + int32 stats")
    return (packed[:n], packed[n:2 * n], *map(int, packed[2 * n:]))


def _make_decomposition(prev: Decomposition, fc, fp, fc_dev, fp_dev,
                        steps: int, n_clusters: int) -> Decomposition:
    return dataclasses.replace(
        prev, final_c=fc, final_pathw=fp,
        radius=int(fp.max()) if len(fp) else 0, n_clusters=n_clusters,
        growing_steps=prev.growing_steps + steps,
        final_c_dev=fc_dev, final_pathw_dev=fp_dev, metrics=None)


def apply_updates(session, batch: UpdateBatch, *,
                  tighten_cap: Optional[int] = DEFAULT_TIGHTEN_CAP,
                  regrow_cap: Optional[int] = None) -> UpdateReport:
    """Apply one ``UpdateBatch`` to a resident session in place: stage and
    scatter the mutations, rebind the backend, pick the repair from the
    event mix and the dead fraction, repair the decomposition on the
    device, and record which quotient keys the next query must refresh.

    ``tighten_cap`` bounds the insert/decrease tightening relax (None =
    to the fixpoint, 0 = skip); ``regrow_cap`` bounds the confined regrow
    the same way (dead nodes it does not reach become singletons). Both
    keep every bound certified.
    """
    session._check_open()
    st = ensure_dynamic(session)
    store, m = st.store, st.metrics
    n = session.n_nodes

    with Timer() as t:
        plan = _stage_events(store, batch)
        changed = plan.inserts + plan.decreases + plan.increases + plan.deletes
        m.batches += 1
        m.inserts += plan.inserts
        m.decreases += plan.decreases
        m.increases += plan.increases
        m.deletes += plan.deletes
        m.noop_events += plan.noops
        if changed == 0:
            return UpdateReport(
                action="noop", inserts=0, decreases=0, increases=0,
                deletes=0, noops=plan.noops, dirty_fraction=0.0,
                supersteps=0, pointer_rounds=0, dead_nodes=0,
                new_singletons=0, cluster_set_changed=False,
                seconds=t.seconds)

        store.flush()
        session.backend.rebind(store.src, store.dst, store.weight,
                               store.in_degree)
        m.store_uploads = store.uploads
        m.store_scatters = store.scatters
        # the host caches of the mutated graph: the mirror re-materializes
        # on access; the edge count must track the store now
        session._edges = None
        session._n_edges = store.n_edges
        session._max_weight = None
        session._delta_stats = None

        old_dec = st.dec
        old_fc, old_fp = old_dec.final_c, old_dec.final_pathw
        fc_dev, fp_dev = old_dec.final_c_dev, old_dec.final_pathw_dev
        action = "relax"
        dirty_fraction = 0.0
        rounds = dead = singles = 0
        steps = 0
        alive, fp_base = None, fp_dev

        if plan.has_increase:
            # the witness forest absorbs every weight increase in place;
            # only true orphans come out dead, and their fraction picks
            # repair or rebuild
            rounds = _pointer_rounds(n)
            with telemetry.span("dynamic.forest_repair", n=n,
                                pointer_rounds=rounds) as sp:
                alive, fp_base = _forest_repair(
                    store.src, store.dst, store.weight, fc_dev, fp_dev, n=n,
                    k_rounds=rounds)
                dead = int(guard.fetch(
                    (~alive).sum(),
                    reason="dynamic: dead-node count picks repair vs "
                           "rebuild"))
                sp.set(dead=dead)
            m.update_syncs += 1
            m.update_supersteps += 1   # the parent-selection edge sweep
            m.pointer_rounds += rounds
            steps += 1
            dirty_fraction = dead / max(n, 1)
            action = ("rebuild" if dirty_fraction > session.rebuild_fraction
                      else "repair")
        if action == "rebuild":
            with telemetry.span("dynamic.rebuild", n=n,
                                dirty_fraction=dirty_fraction) as sp:
                dec = _full_decomposition(session, m)
                m.full_rebuilds += 1
                m.rebuild_supersteps += dec.growing_steps
                m.baseline_supersteps = dec.growing_steps
                # a fresh decomposition is not forest-witnessed: recertify
                dec, r_sweeps, r_rounds = _recertify(session, dec, m)
                sp.set(supersteps=dec.growing_steps + r_sweeps)
            m.engine_syncs += 1
            m.update_supersteps += r_sweeps
            m.pointer_rounds += r_rounds
            steps += r_sweeps
            rounds += r_rounds
        else:
            grow_steps = 0
            if action == "repair":
                # confined regrow from the alive boundary; the wave cannot
                # leave the dead region
                with telemetry.span("dynamic.regrow", n=n, dead=dead,
                                    cap=regrow_cap):
                    state = _repair_state(fc_dev, fp_base, alive, n,
                                          confine=True)
                    state, grow_steps = _grow(session, state, regrow_cap, m)
            else:
                state = _repair_state(
                    fc_dev, fp_base,
                    torch.ones(n, dtype=torch.bool, device=fc_dev.device), n,
                    confine=False)
            tighten_steps = 0
            if plan.has_decrease and tighten_cap != 0:
                # a monotone relax whose every prefix is certified, so the
                # cap bounds the cost without giving anything up
                with telemetry.span("dynamic.relax", n=n, cap=tighten_cap):
                    state = state.replace(is_center=state.pathw == 0)
                    state, tighten_steps = _grow(session, state, tighten_cap,
                                                 m)
            with telemetry.span("dynamic.finalize", n=n) as sp:
                c_dev, p_dev, n_single = _finalize_repair(state, n=n)
                fc, fp, singles = _fetch_repair_planes(c_dev, p_dev,
                                                       (n_single,))
                sp.set(supersteps=grow_steps + tighten_steps,
                       singletons=singles)
            m.update_syncs += 1
            steps += grow_steps + tighten_steps
            m.update_supersteps += grow_steps + tighten_steps
            if action == "repair":
                m.repair_batches += 1
            else:
                m.relax_batches += 1
            dec = _make_decomposition(old_dec, fc, fp, c_dev, p_dev, steps,
                                      old_dec.n_clusters + singles)

        # the cluster SET changes only on a rebuild or when singletons were
        # minted (a center keeps fc == self: it is frozen in every relax)
        cluster_set_changed = action == "rebuild" or singles > 0
        if cluster_set_changed:
            st.quotient_stale = True
            st.dirty_centers.clear()
        else:
            moved = (old_fc != dec.final_c) | (old_fp != dec.final_pathw)
            touched = np.unique(np.asarray(plan.touched, np.int64))
            dirty = set(np.unique(old_fc[moved]).tolist())
            dirty |= set(np.unique(dec.final_c[moved]).tolist())
            dirty |= set(np.unique(dec.final_c[touched]).tolist())
            dirty |= set(np.unique(old_fc[touched]).tolist())
            st.dirty_centers |= dirty
        st.solution = None
        st.dec = dec

    log.info("update batch: %s (+%d/-%d edges, %d reweights) sweeps=%d "
             "pointer_rounds=%d dead=%d singletons=%d dirty=%.3f in %.3fs",
             action, plan.inserts, plan.deletes,
             plan.decreases + plan.increases, steps, rounds, dead, singles,
             dirty_fraction, t.seconds)
    return UpdateReport(
        action=action, inserts=plan.inserts, decreases=plan.decreases,
        increases=plan.increases, deletes=plan.deletes, noops=plan.noops,
        dirty_fraction=dirty_fraction, supersteps=steps,
        pointer_rounds=rounds, dead_nodes=dead, new_singletons=singles,
        cluster_set_changed=cluster_set_changed, seconds=t.seconds)


# ---------------------------------------------------------------------------
# the query side: the quotient solve over the maintained state
# ---------------------------------------------------------------------------


def _dirty_incident_slice(store: EdgeStore, fc: np.ndarray,
                          dirty_ids: np.ndarray):
    """Host gather of the edges whose (cluster, cluster) key touches a
    dirty cluster, padded to a ``DIRTY_EDGE_BUCKET`` multiple with inert
    ``0 -> 0, w = 1`` slots (never cross edges, so the quotient pass needs
    no mask). Returns device (src, dst, w) and the real edge count."""
    dirty = np.zeros(len(fc) + 1, bool)
    dirty[dirty_ids] = True
    sel = store.valid & (dirty[fc[store.h_src]] | dirty[fc[store.h_dst]])
    idx = np.flatnonzero(sel)
    e_pad = next_multiple(max(len(idx), 1), DIRTY_EDGE_BUCKET)
    src = np.zeros(e_pad, np.int32)
    dst = np.zeros(e_pad, np.int32)
    w = np.ones(e_pad, np.int32)
    src[: len(idx)] = store.h_src[idx]
    dst[: len(idx)] = store.h_dst[idx]
    w[: len(idx)] = store.h_weight[idx]
    dev = store.device
    return (to_device(src, dev), to_device(dst, dev), to_device(w, dev),
            len(idx))


def solve_session_quotient(session, pm) -> Tuple[int, np.ndarray, bool]:
    """(phi_quotient, eccentricities, connected) of the maintained
    decomposition. The cached quotient is refreshed incrementally (only
    the keys of clusters dirtied since the last solve are recomputed) and
    the result is cached until the next update."""
    from repro_torch.core.quotient import (_quotient_kernel,
                                           fetch_quotient_counters,
                                           quotient_update_device,
                                           solve_device_quotient)

    st = session._dynamic
    dec, store = st.dec, st.store
    if st.solution is not None and not st.quotient_stale \
            and not st.dirty_centers:
        phi_q, ecc, connected, steps = st.solution
        pm.solve_supersteps = steps
        return phi_q, ecc, connected

    n = session.n_nodes
    if n == 0 or store.n_edges == 0:
        k = dec.n_clusters
        st.solution = (0, np.zeros(k, np.int64), k <= 1, 0)
        st.quotient_stale = False
        st.dirty_centers.clear()
        return 0, np.zeros(k, np.int64), k <= 1

    with Timer() as t, telemetry.span("quotient.build", dynamic=True) as sp:
        if st.dq is None or st.quotient_stale or st.dq_counters is None:
            dq = _quotient_kernel(*session.flat_device_edges(),
                                  dec.final_c_dev, dec.final_pathw_dev, n=n)
            sp.set(incremental=False)
        else:
            dirty_ids = np.fromiter(  # det: ids only scatter into boolean masks
                st.dirty_centers, np.int64, count=len(st.dirty_centers))
            sub_src, sub_dst, sub_w, _ = _dirty_incident_slice(
                store, dec.final_c, dirty_ids)
            dq = quotient_update_device(
                st.dq, st.dq_counters[1], (sub_src, sub_dst, sub_w),
                dec.final_c_dev, dec.final_pathw_dev, dirty_ids, n)
            sp.set(incremental=True, dirty_centers=len(dirty_ids))
        k, mq, wmax, wsum = fetch_quotient_counters(dq)
        sp.set(clusters=k, edges=mq)
    pm.quotient_seconds += t.seconds
    pm.quotient_syncs += 1
    pm.n_quotient_edges = mq
    st.dq, st.dq_counters = dq, (k, mq, wmax, wsum)
    st.quotient_stale = False
    st.dirty_centers.clear()
    if k <= 1:
        st.solution = (0, np.zeros(k, np.int64), True, 0)
        return 0, np.zeros(k, np.int64), True
    with Timer() as t, telemetry.span("quotient.solve", dynamic=True,
                                      clusters=k) as sp:
        sol = solve_device_quotient(dq, k, mq, wmax)
        sp.set(supersteps=sol.supersteps)
    pm.solve_seconds += t.seconds
    pm.solve_syncs += sol.reads
    pm.solve_supersteps = sol.supersteps
    pm.solve_int64 = int(sol.dtype == "int64")
    ecc = np.asarray(sol.ecc, np.int64)
    st.solution = (sol.diameter, ecc, sol.connected, sol.supersteps)
    return sol.diameter, ecc, sol.connected
